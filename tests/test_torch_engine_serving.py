"""The serving options of the port's engine against the JAX package's, on
the CPU at tiny shapes with the same weights (made from a seed and carried
across by ``params_from_numpy``): the prefix cache (the tests of
``tests/test_engine.py:400-460``, tokens and ``prefix_hits`` equal to the
reference engine's, and the suffix prefill's logits), logprobs,
``cache="auto"``, ``log_stats_every``, per-request sampling in a mixed
batch and ``submit``'s bucket check."""

import json

import jax
import numpy as np
import pytest

from rten_tpu.generate.engine import ServingEngine as JServingEngine
from rten_tpu.generate.sampler import PerRequestSampler as JPerRequestSampler
from rten_tpu.generate.sampler import SamplingParams as JSamplingParams
from rten_tpu.models import transformer as jtr
from rten_tpu_torch.generate.engine import ServingEngine
from rten_tpu_torch.generate.sampler import (PerRequestSampler,
                                             SamplingParams)
from rten_tpu_torch.models import (TransformerConfig, TransformerLM,
                                   params_from_numpy)

# Rows of 2 heads of 64 (128 values): an int8 cache takes the tail window.
TAIL_CFG = dict(n_heads=2, d_model=128)
# Logprobs: the same f32 logits in both packages, summed in other orders.
LOGPROB_TOL = 1e-5
# Suffix-prefill logits: f32 weights, f32 sums in other orders.
F32_LOGIT_TOL = 1e-4
# int8 weights or an int8 cache: a bf16 rounding may flip between the
# packages (tests/test_torch_model.py:LOGIT_TOL).
LOGIT_TOL = 1e-2


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _build(seed, quantize, **cfg):
    jm = jtr.TransformerLM(jtr.TransformerConfig.tiny_test(**cfg))
    jp = jm.init_params(jax.random.PRNGKey(seed))
    if quantize:
        jp = jtr.quantize_weights(jp, "int8")
    pm = TransformerLM(TransformerConfig.tiny_test(**cfg))
    return jm, jp, pm, params_from_numpy(_np_tree(jp), device="cpu")


@pytest.fixture(scope="module")
def f32():
    return _build(0, False)


@pytest.fixture(scope="module")
def int8_tail():
    return _build(5, True, **TAIL_CFG)


def _pair(models, **kw):
    """(reference engine, port engine) over the same weights."""
    jm, jp, pm, pp = models
    jkw = dict(kw)
    if isinstance(kw.get("sampler"), PerRequestSampler):
        jkw["sampler"] = JPerRequestSampler(max_k=kw["sampler"].max_k)
    return JServingEngine(jm, jp, **jkw), ServingEngine(pm, pp, device="cpu",
                                                        **kw)


# -- prefix cache (tests/test_engine.py:400-460) -------------------------------

@pytest.mark.parametrize("which", ["f32", "int8_tail"])
def test_prefix_cache_exact_parity(which, request):
    """Hits and a miss in one generate: the port's tokens and prefix_hits
    equal the reference's warm engine; with f32 weights they also equal a
    cold prefill (the reference's exact-parity case); on int8 + tail the
    warm path is held to the reference's warm path only."""
    models = request.getfixturevalue(which)
    kw = dict(max_batch=4, capacity=64, prefill_buckets=(8, 16))
    if which == "int8_tail":
        kw["cache"] = "auto"
    system = [7, 3, 9, 9, 2, 1]
    prompts = [system + [11, 12], system + [4], [5, 6, 7]]  # 2 hits, 1 miss
    ref, eng = _pair(models, **kw)
    assert eng._tail_flush == ref._tail_flush == (16 if kw.get("cache")
                                                  else 0)
    ref.register_prefix(system)
    eng.register_prefix(system)
    want = ref.generate(prompts, max_new_tokens=6)
    got = eng.generate(prompts, max_new_tokens=6, burst=4)
    assert got == want
    assert eng.stats()["prefix_hits"] == ref.stats()["prefix_hits"] == 2
    if which == "f32":
        cold = ServingEngine(models[2], models[3], device="cpu", **kw)
        assert cold.generate(prompts, max_new_tokens=6) == got


def test_prefix_cache_fragment_reusable(f32):
    """The stored fragment survives hits: two sequential hits on the same
    prefix give identical results, the reference's."""
    system = [2, 4, 6, 8]
    ref, eng = _pair(f32, max_batch=1, capacity=64, prefill_buckets=(8,))
    for e in (ref, eng):
        e.register_prefix(system)
    outs = [eng.generate([system + [1]], max_new_tokens=5) for _ in range(2)]
    assert outs[0] == outs[1] == ref.generate([system + [1]],
                                              max_new_tokens=5)
    assert eng.stats()["prefix_hits"] == 2


def test_prefix_cache_longest_match(f32):
    _, eng = _pair(f32, max_batch=1, capacity=64, prefill_buckets=(8, 16))
    eng.register_prefix([1, 2])
    eng.register_prefix([1, 2, 3, 4])
    assert eng._match_prefix([1, 2, 3, 4, 5])[0] == (1, 2, 3, 4)
    # An exactly equal prompt is not a hit (no suffix to prefill).
    assert eng._match_prefix([1, 2, 3, 4])[0] == (1, 2)
    assert eng._match_prefix([9, 1, 2]) is None


def test_prefix_cache_with_sampling_params(f32):
    """A hit under the per-request sampler with no sampling params decodes
    greedily, as a cold prefill does, and as the reference's hit does."""
    system = [3, 1, 4, 1, 5]
    kw = dict(max_batch=1, capacity=64, prefill_buckets=(8,),
              sampler=PerRequestSampler(max_k=16))
    ref, eng = _pair(f32, **kw)
    cold = ServingEngine(f32[2], f32[3], device="cpu", **kw)
    r0 = cold.submit(system + [9], max_new_tokens=5)
    cold.run()
    for e in (ref, eng):
        e.register_prefix(system)
    r1, r2 = (e.submit(system + [9], max_new_tokens=5) for e in (eng, ref))
    eng.run()
    ref.run()
    assert r1.tokens == r0.tokens == r2.tokens


@pytest.mark.parametrize("which", ["f32", "int8_tail"])
def test_suffix_prefill_logits_equal_reference(which, request):
    """The suffix prefill (a chunked forward over a 16-token bucket at the
    fragment's depth: two slices of the verify kernel's 8 queries) gives
    the reference's last-token logits and cache lengths."""
    jm, jp, pm, pp = models = request.getfixturevalue(which)
    kw = dict(max_batch=2, capacity=64, prefill_buckets=(16,))
    if which == "int8_tail":
        kw["cache"] = "auto"
    ref, eng = _pair(models, **kw)
    system = list(range(3, 14))
    suffix = [40, 41, 42, 7, 7]
    for e in (ref, eng):
        e.register_prefix(system)
    tok = np.zeros((1, 16), np.int32)
    tok[0, :len(suffix)] = suffix
    slens = np.asarray([len(suffix)], np.int32)
    want, jcache = ref._suffix_prefill(jp, jax.numpy.asarray(tok),
                                       ref._prefixes[0][1],
                                       jax.numpy.asarray(len(system),
                                                         jax.numpy.int32),
                                       jax.numpy.asarray(slens))
    got, cache = eng._suffix_prefill(tok.astype(np.int64),
                                     eng._prefixes[0][1], len(system), slens)
    tol = F32_LOGIT_TOL if which == "f32" else LOGIT_TOL
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=tol)
    assert cache.lengths.tolist() == np.asarray(jcache.lengths).tolist() \
        == [len(system) + len(suffix)]


# -- submit's bucket check ----------------------------------------------------

def test_submit_bucket_check_with_and_without_a_covering_prefix(f32):
    """A prompt longer than the largest bucket is refused, as the
    reference refuses it; once a prefix covers all but a bucket of it, it
    is accepted and served, with the reference's tokens."""
    system = list(range(1, 13))
    prompt = system + list(range(20, 28))                # 20 > bucket 16
    ref, eng = _pair(f32, max_batch=2, capacity=64, prefill_buckets=(8, 16))
    for e in (ref, eng):
        with pytest.raises(ValueError, match="largest prefill bucket"):
            e.submit(prompt, max_new_tokens=4)
        e.register_prefix(system)
    r_port, r_ref = (e.submit(prompt, max_new_tokens=4) for e in (eng, ref))
    eng.run(burst=2)
    ref.run()
    assert r_port.tokens == r_ref.tokens and len(r_port.tokens) == 4
    assert eng.stats()["prefix_hits"] == 1
    # A prefix that leaves more than a bucket uncovered does not help.
    with pytest.raises(ValueError, match="register a covering prefix"):
        eng.submit(system[:4] + list(range(30, 47)), max_new_tokens=2)


# -- logprobs -----------------------------------------------------------------

@pytest.mark.parametrize("which,burst", [("f32", 1), ("f32", 3),
                                         ("int8_tail", 4)])
def test_logprobs_equal_reference(which, burst, request):
    """Each emitted token's log-probability (admission and decode, steps
    and bursts) within 1e-5 of the reference's, with the same tokens."""
    models = request.getfixturevalue(which)
    kw = dict(max_batch=2, capacity=64, prefill_buckets=(16,),
              logprobs=True)
    if which == "int8_tail":
        kw["cache"] = "auto"
    ref, eng = _pair(models, **kw)
    assert not eng._fused_head
    prompts = ([3, 1, 4, 1, 5], [9, 2, 6])
    reqs = [(e.submit(p, max_new_tokens=6) for p in prompts)
            for e in (eng, ref)]
    mine, theirs = list(reqs[0]), list(reqs[1])
    eng.run(burst=burst)
    ref.run(burst=burst)
    for a, b in zip(mine, theirs):
        assert a.tokens == b.tokens
        assert len(a.logprobs) == 6 and all(v <= 0.0 for v in a.logprobs)
        np.testing.assert_allclose(a.logprobs, b.logprobs, rtol=0,
                                   atol=LOGPROB_TOL)


# -- cache="auto" ----------------------------------------------------------------

AUTO_CONFIGS = {
    "tiny": dict(),
    "tail_rows": TAIL_CFG,
    "no_pallas": dict(use_pallas=False),
    "gqa_rope": dict(n_heads=4, kv_heads=2, pos="rope", norm="rmsnorm",
                     act="swiglu", tie_embeddings=False),
}


@pytest.mark.parametrize("capacity", [64, 66, 96, 2048])
@pytest.mark.parametrize("config", list(AUTO_CONFIGS))
def test_cache_auto_resolves_as_reference(config, capacity):
    """cache="auto" (and each explicit policy) resolves to the reference's
    storage and tail window for the same configuration and capacity."""
    cfg = AUTO_CONFIGS[config]
    jm = jtr.TransformerLM(jtr.TransformerConfig.tiny_test(**cfg))
    pm = TransformerLM(TransformerConfig.tiny_test(**cfg))
    jp = jtr.quantize_weights(jm.init_params(jax.random.PRNGKey(0)), "int8")
    pp = params_from_numpy(_np_tree(jp), device="cpu")
    # The reference's int8 cache needs a capacity of a multiple of 4 (its
    # token-packed rows); "auto" checks that before it picks int8.
    policies = ("auto", "bf16", "f32") + (("int8",) if capacity % 4 == 0
                                          else ())
    for policy in policies:
        kw = dict(max_batch=4, capacity=capacity, prefill_buckets=(16,),
                  cache=policy)
        ref = JServingEngine(jm, jp, **kw)
        eng = ServingEngine(pm, pp, device="cpu", **kw)
        assert (eng.quantized_cache, eng.cache_dtype, eng._tail_flush) == (
            ref.quantized_cache, ref.cache_dtype, ref._tail_flush), policy
        assert eng.cache.quantized == eng.quantized_cache


def test_cache_policy_refusals(f32):
    _, _, pm, pp = f32
    with pytest.raises(ValueError, match="either cache="):
        ServingEngine(pm, pp, cache="int8", quantized_cache=True,
                      device="cpu")
    with pytest.raises(ValueError, match="cache='fp8'"):
        ServingEngine(pm, pp, cache="fp8", device="cpu")


# -- log_stats_every ----------------------------------------------------------

def test_log_stats_every_lines_carry_reference_keys(f32, capsys):
    """Every N bursts a JSON line {"engine_stats": stats()} on stderr,
    with the reference's keys."""
    lines = {}
    for name, e in zip(("ref", "port"),
                       _pair(f32, max_batch=2, capacity=64,
                             prefill_buckets=(16,), log_stats_every=2)):
        e.generate([[1, 2, 3], [4, 5]], max_new_tokens=7, burst=2)
        lines[name] = [json.loads(line) for line in
                       capsys.readouterr().err.splitlines()
                       if line.startswith('{"engine_stats"')]
    assert len(lines["port"]) == len(lines["ref"]) >= 1
    for a, b in zip(lines["port"], lines["ref"]):
        assert set(a["engine_stats"]) == set(b["engine_stats"])
        for k in ("submitted", "completed", "tokens", "bursts",
                  "decode_steps", "prefix_hits"):
            assert a["engine_stats"][k] == b["engine_stats"][k], k


# -- per-request sampling -----------------------------------------------------

def test_mixed_batch_greedy_rows_equal_reference(f32):
    """Greedy requests (no params, temperature 0, top_k 1, a tiny top_p)
    batched with hot stochastic ones give the reference's greedy tokens;
    the stochastic ones stay in the vocabulary, and a seed repeats them."""
    kw = dict(max_batch=4, capacity=64, prefill_buckets=(16,),
              sampler=PerRequestSampler(max_k=16))
    ref, _ = _pair(f32, **kw)
    prompt = [11, 12, 13]
    want = ref.submit(prompt, max_new_tokens=6)
    ref.run(burst=3)
    runs = []
    for _ in range(2):
        eng = ServingEngine(f32[2], f32[3], device="cpu", seed=7, **kw)
        greedy = [eng.submit(prompt, 6, sampling=sp) for sp in (
            None, SamplingParams(temperature=0.0),
            SamplingParams(temperature=1.0, top_k=1),
            SamplingParams(temperature=0.8, top_p=1e-6))]
        hot = [eng.submit(prompt, 6, sampling=SamplingParams(1.5, 8, 0.95))
               for _ in range(3)]
        eng.run(burst=3)
        assert all(r.tokens == want.tokens for r in greedy)
        assert all(len(r.tokens) == 6 and all(0 <= t < 128 for t in r.tokens)
                   for r in hot)
        runs.append([r.tokens for r in hot])
    assert runs[0] == runs[1]
    # A greedy request of the reference in its own mixed batch agrees.
    ref2, _ = _pair(f32, **kw)
    mixed = [ref2.submit(prompt, 6, sampling=JSamplingParams(1.5, 8, 0.95)),
             ref2.submit(prompt, 6, sampling=JSamplingParams(0.0))]
    ref2.run(burst=3)
    assert mixed[1].tokens == want.tokens


def test_fused_head_only_when_greedy_without_logprobs(int8_tail):
    _, _, pm, pp = int8_tail
    kw = dict(max_batch=4, capacity=64, device="cpu")
    assert ServingEngine(pm, pp, **kw)._fused_head
    assert not ServingEngine(pm, pp, sampler=PerRequestSampler(),
                             **kw)._fused_head
    assert not ServingEngine(pm, pp, logprobs=True, **kw)._fused_head
