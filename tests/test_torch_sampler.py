"""The port's samplers (``rten_tpu_torch/generate/sampler.py``) against the
JAX package's on the CPU. The two random streams differ, so sampled ids are
not compared; what is held: greedy equivalences give the reference's ids
exactly (ties planted, the lowest index wins), the empirical distributions
of 20,000 seeded draws lie within total-variation distance 0.03 of the
reference's (drawn over split keys), no id outside the top-k or nucleus
set is ever drawn, and a seed repeats its draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rten_tpu.generate import sampler as js
from rten_tpu_torch.generate import sampler as ps
from rten_tpu_torch.utils.topk import ordered_top_k

V = 32
DRAWS = 20_000
TV_TOL = 0.03
# (temperature, top_k, top_p) rows of one PerRequestSampler batch.
PER_REQUEST_ROWS = [(1.0, 0, 1.0), (0.7, 5, 1.0), (1.3, 0, 0.8),
                    (0.9, 10, 0.6)]
TOP_K = [(1, 1.0), (4, 1.0), (8, 0.6), (32, 1.4)]        # (k, temperature)
TOP_P = [(0.9, 1.0), (0.7, 1.5), (0.99, 1.3), (0.8, 2.0)]  # (p, temperature)


def _logits(seed, rows=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, V)) * 2.0).astype(np.float32)


def _tied(seed, rows=6):
    """Rows whose maximum is planted at two or three indices, the lowest
    not first in the row's order of appearance after a shuffle."""
    x = _logits(seed, rows)
    rng = np.random.default_rng(seed + 1)
    for r in range(rows):
        idx = np.sort(rng.choice(V, size=2 + r % 2, replace=False))
        x[r, idx] = x[r].max() + 1.0
    return x


def _hist(ids):
    return np.bincount(np.asarray(ids).reshape(-1), minlength=V) / ids.size


def _tv(a, b):
    return 0.5 * np.abs(a - b).sum()


def _port_draws(sample, row, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.from_numpy(np.tile(row, (DRAWS, 1)))
    return sample(x, gen).numpy()


def _ref_draws(sample, row, seed=0):
    keys = jax.random.split(jax.random.PRNGKey(seed), DRAWS)
    return np.asarray(jax.jit(jax.vmap(lambda k: sample(k, jnp.asarray(
        row)[None])[0]))(keys))


def _nucleus(row, temp, top_k, top_p, max_k=V):
    """The ids the reference's PerRequestSampler may draw for one row: its
    rule in numpy (stable descending order, the k cut, then the smallest
    prefix reaching top_p)."""
    order = np.argsort(-row, kind="stable")[:max_k]
    k = max_k if top_k <= 0 else int(min(top_k, max_k))
    scaled = row[order[:k]] / max(temp, 1e-6)
    p = np.exp(scaled - scaled.max())
    p /= p.sum()
    keep = (np.cumsum(p) - p) < top_p
    return set(order[:k][keep].tolist())


# -- greedy equivalences -------------------------------------------------------

def test_greedy_equivalences_with_ties():
    """temperature <= 0, top_k = 1 and a tiny top_p each give the
    reference's ids exactly, the lowest index among tied maxima."""
    x = _tied(0)
    lowest = [int(np.flatnonzero(r == r.max())[0]) for r in x]
    n = x.shape[0]
    knobs = {"greedy": ([0.0] * n, [0] * n, [1.0] * n),
             "negative temperature": ([-1.0] * n, [7] * n, [0.5] * n),
             "top_k 1": ([1.0] * n, [1] * n, [1.0] * n),
             "tiny top_p": ([0.8] * n, [0] * n, [1e-6] * n)}
    key = jax.random.PRNGKey(3)
    gen = torch.Generator().manual_seed(3)
    for name, (t, k, p) in knobs.items():
        want = np.asarray(js.PerRequestSampler(max_k=16).sample(
            key, jnp.asarray(x), jnp.asarray(t, jnp.float32),
            jnp.asarray(k, jnp.float32), jnp.asarray(p, jnp.float32)))
        got = ps.PerRequestSampler(max_k=16).sample(
            torch.from_numpy(x), *(torch.tensor(a, dtype=torch.float32)
                                   for a in (t, k, p)),
            generator=gen).numpy()
        assert got.tolist() == want.tolist() == lowest, name
    for pair in ((js.ArgMaxSampler(), ps.ArgMaxSampler()),
                 (js.TopKSampler(k=1), ps.TopKSampler(k=1)),
                 (js.TopKSampler(k=5, temperature=0.0),
                  ps.TopKSampler(k=5, temperature=0.0)),
                 (js.TopPSampler(p=0.5, temperature=0.0),
                  ps.TopPSampler(p=0.5, temperature=0.0))):
        want = np.asarray(pair[0].sample(key, jnp.asarray(x)))
        got = pair[1].sample(torch.from_numpy(x), generator=gen).numpy()
        assert got.tolist() == want.tolist() == lowest, pair[1]
    assert ps.PerRequestSampler(max_k=16).sample(
        torch.from_numpy(x), torch.zeros(n), torch.zeros(n),
        torch.ones(n)).dtype == torch.int32


def test_top_k_candidates_keep_lax_top_k_order():
    """Equal logits at the k-th place: the candidates are lax.top_k's,
    lowest index first."""
    x = np.zeros((2, V), np.float32)
    x[0, [5, 9, 30]] = 1.0
    x[1, ::3] = 2.0
    for k in (1, 2, 4, 11):
        want = jax.lax.top_k(jnp.asarray(x), k)
        got = ordered_top_k(torch.from_numpy(x), k)
        assert got[1].tolist() == np.asarray(want[1]).tolist()
        assert got[0].tolist() == np.asarray(want[0]).tolist()


@pytest.mark.parametrize("case", ["signed_zeros_and_inf", "gpt2_vocab_ties"])
def test_top_k_matches_lax_top_k(case):
    """``ordered_top_k`` gives lax.top_k's values and indices: +0.0 above
    -0.0 and -inf last, and at GPT-2's vocabulary with many equal logits
    around the 64th place (path (K)'s candidate count)."""
    if case == "signed_zeros_and_inf":
        x = np.array([[0.0, -0.0, 1.0, -np.inf, 0.0, -0.0, -np.inf, -1.0]],
                     np.float32)
        ks = (1, 3, 5, 8)
    else:
        rng = np.random.default_rng(3)
        x = (np.round(rng.standard_normal((4, 50257)) * 4) / 4).astype(
            np.float32)
        ks = (64,)
    for k in ks:
        want = jax.lax.top_k(jnp.asarray(x), k)
        got = ordered_top_k(torch.from_numpy(x), k)
        assert got[1].tolist() == np.asarray(want[1]).tolist()
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        assert np.array_equal(np.signbit(got[0].numpy()),
                              np.signbit(np.asarray(want[0])))


# -- distributions -------------------------------------------------------------

def test_per_request_distribution_matches_reference():
    """Four knob rows in one batch (greedy and stochastic rows mix through
    per-row tensors): per row, the port's and the reference's empirical
    distributions within TV 0.03, and only nucleus ids drawn."""
    x = _logits(1)
    rows = len(PER_REQUEST_ROWS)
    t, k, p = (np.asarray([r[i] for r in PER_REQUEST_ROWS], np.float32)
               for i in range(3))
    gen = torch.Generator().manual_seed(0)
    got = ps.PerRequestSampler(max_k=V).sample(
        torch.from_numpy(np.repeat(x, DRAWS, axis=0)),
        *(torch.from_numpy(np.repeat(a, DRAWS)) for a in (t, k, p)),
        generator=gen).numpy().reshape(rows, DRAWS)
    ref = js.PerRequestSampler(max_k=V)
    for r in range(rows):
        want = _ref_draws(
            lambda key, lg: ref.sample(key, lg, jnp.asarray(t[r:r + 1]),
                                       jnp.asarray(k[r:r + 1]),
                                       jnp.asarray(p[r:r + 1])), x[r])
        allowed = _nucleus(x[r], t[r], k[r], p[r])
        assert set(np.unique(got[r]).tolist()) <= allowed, r
        assert set(np.unique(want).tolist()) <= allowed, r
        assert _tv(_hist(got[r]), _hist(want)) < TV_TOL, r


@pytest.mark.parametrize("k,temp", TOP_K)
def test_top_k_distribution_matches_reference(k, temp):
    x = _logits(2)[0]
    got = _port_draws(ps.TopKSampler(k=k, temperature=temp).sample, x)
    want = _ref_draws(js.TopKSampler(k=k, temperature=temp).sample, x)
    allowed = set(np.argsort(-x, kind="stable")[:k].tolist())
    assert set(np.unique(got).tolist()) <= allowed
    assert _tv(_hist(got), _hist(want)) < TV_TOL


@pytest.mark.parametrize("p,temp", TOP_P)
def test_top_p_distribution_matches_reference(p, temp):
    x = _logits(3)[0]
    got = _port_draws(ps.TopPSampler(p=p, temperature=temp).sample, x)
    want = _ref_draws(js.TopPSampler(p=p, temperature=temp).sample, x)
    allowed = _nucleus(x, temp, 0, p)
    assert set(np.unique(got).tolist()) <= allowed
    assert set(np.unique(want).tolist()) <= allowed
    assert _tv(_hist(got), _hist(want)) < TV_TOL


# -- seeds ---------------------------------------------------------------------

def test_same_seed_same_ids():
    x = torch.from_numpy(np.tile(_logits(4), (64, 1)))
    n = x.shape[0]
    knobs = (torch.full((n,), 1.1), torch.full((n,), 20.0),
             torch.full((n,), 0.9))
    samplers = [lambda g: ps.PerRequestSampler(16).sample(x, *knobs,
                                                        generator=g),
                lambda g: ps.TopKSampler(k=10).sample(x, generator=g),
                lambda g: ps.TopPSampler(p=0.8).sample(x, generator=g)]
    for draw in samplers:
        a = draw(torch.Generator().manual_seed(11))
        b = draw(torch.Generator().manual_seed(11))
        c = draw(torch.Generator().manual_seed(12))
        assert torch.equal(a, b)
        assert not torch.equal(a, c)
