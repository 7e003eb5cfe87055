"""The port's chunked verify step (``TransformerLM.verify_step``, on the CPU
with the kernels' plain versions) against the JAX package's (CPU backend,
Pallas in interpret mode) at the reference's own test shapes
(``tests/test_speculative.py``), and its rollback property on the port
alone."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_spec import CONFIGS, build_models

# Verify logits with f32 weights: the reference test's tolerance
# (test_speculative.py:47). An int8 cache quantizes the same values bit for
# bit in both packages and its attention sums in f32, so it is held to the
# same bound (the gap here is about 1e-6).
VERIFY_LOGIT_TOL = 2e-4
CAP = 64


@pytest.fixture(scope="module", params=list(CONFIGS))
def models(request):
    return build_models(CONFIGS[request.param])


def _filled_caches(jm, pm, b, rng, **kw):
    """The reference's and the port's caches holding the same random K/V
    in every layer over the whole capacity (written with ``position=0``,
    so the int8 caches quantize the same values)."""
    cfg = pm.config
    jc = jm.new_cache(b, CAP, **kw)
    pc = pm.new_cache(b, CAP, device="cpu", **kw)
    for layer in range(cfg.n_layers):
        k, v = (rng.standard_normal((b, cfg.n_kv_heads, CAP, cfg.head_dim))
                .astype(np.float32) for _ in range(2))
        jc = jc.append(layer, jnp.asarray(k), jnp.asarray(v), position=0)
        pc = pc.append(layer, torch.from_numpy(k), torch.from_numpy(v),
                       position=0)
    return jc, pc


@pytest.mark.parametrize("cache,b", [("f32", 2), ("f32", 4), ("int8", 4)])
def test_verify_step_logits_match_reference(models, cache, b):
    """verify_step's logits against the reference's on caches at ragged
    depths (batch 2 takes the fused kernel, batch 4 the grouped one with
    group 2), f32 weights, on an f32 and an int8 cache (the kernel tests
    hold both entries on bf16, f32 and int8 caches); the lengths come back
    unchanged."""
    jm, pm, jps, pps = models
    kw = dict(quantized=cache == "int8")
    rng = np.random.default_rng(4 + b)
    jc, pc = _filled_caches(jm, pm, b, rng, **kw)
    extra = rng.integers(0, 128, (b, 4))
    lens = np.resize(np.array([4, 7, 5, 1], np.int32), b)
    ref, jc = jm.verify_step(jps["f32"], jnp.asarray(extra, jnp.int32),
                             jc.with_lengths(jnp.asarray(lens)))
    out, pc = pm.verify_step(pps["f32"], torch.from_numpy(extra),
                             pc.with_lengths(lens))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=VERIFY_LOGIT_TOL)
    np.testing.assert_array_equal(pc.lengths.numpy(), lens)
    np.testing.assert_array_equal(np.asarray(jc.lengths), lens)


def test_verify_step_partial_rollback_consistent(models):
    """After a verify step whose chunk is accepted only in part (lengths
    advanced by 1 of 4), a decode step gives the logits of plain decoding
    that never saw the rejected tail (test_speculative.py:52-81)."""
    _, pm, _, pps = models
    pp = pps["f32"]
    rng = np.random.default_rng(1)
    prompt = torch.from_numpy(rng.integers(0, 128, (1, 6)))
    good = torch.from_numpy(rng.integers(0, 128, (1, 1)))
    junk = torch.from_numpy(rng.integers(0, 128, (1, 3)))
    follow = torch.tensor([3])

    cache = pm.new_cache(1, CAP, device="cpu")
    _, cache = pm.prefill(pp, prompt, cache)
    _, cache = pm.verify_step(pp, torch.cat([good, junk], dim=1), cache)
    cache = cache.with_lengths(cache.lengths + 1)
    logits_a, _ = pm.decode_step(pp, follow, cache)

    cache2 = pm.new_cache(1, CAP, device="cpu")
    _, cache2 = pm.prefill(pp, prompt, cache2)
    _, cache2 = pm.decode_step(pp, good[:, 0], cache2)
    logits_b, _ = pm.decode_step(pp, follow, cache2)
    np.testing.assert_allclose(logits_a.numpy(), logits_b.numpy(), rtol=0,
                               atol=VERIFY_LOGIT_TOL)
