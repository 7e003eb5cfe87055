"""Parity of the port's GPT-2 model, KV cache and serving engine
(``rten_tpu_torch``, on the CPU with the kernels' plain versions) against
the JAX package (CPU backend, Pallas in interpret mode) on the same
weights and inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rten_tpu.generate.engine import ServingEngine as JServingEngine
from rten_tpu.models import transformer as jtr
from rten_tpu_torch.generate import PagedKVCache, ServingEngine
from rten_tpu_torch.models import (QuantWeight, TransformerConfig,
                                   TransformerLM, linear, params_from_numpy,
                                   quantize_weights)
from rten_tpu_torch.models import transformer as ptr

# Small GPT-2-family config whose cache rows (2 heads of 64) take the tail
# window, as GPT-2-small's do.
CFG = dict(n_heads=2, d_model=128)
# Teacher-forced logits of the two packages: the same int8 weights and
# bf16-rounded operands, f32 sums taken in other orders, so a bf16
# rounding of an activation may flip between them; 1e-2 bounds that at
# these logit scales (|logits| ~ 0.5).
LOGIT_TOL = 1e-2


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree, prefix=""):
    """{path: array} over dicts and lists, QuantWeights as data/scales."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}/{i}"))
        return out
    if hasattr(tree, "scales"):
        n = tree.n or np.asarray(tree.data).shape[1]
        return {f"{prefix}.data": np.asarray(tree.data)[:, :n],
                f"{prefix}.scales": np.asarray(tree.scales)[:n]}
    return {prefix: np.asarray(tree)}


@pytest.fixture(scope="module")
def models():
    """The JAX and port models with the same int8 weights (seed 3)."""
    jm = jtr.TransformerLM(jtr.TransformerConfig.tiny_test(**CFG))
    jp = jtr.quantize_weights(jm.init_params(jax.random.PRNGKey(3)))
    pm = TransformerLM(TransformerConfig.tiny_test(**CFG))
    pp = params_from_numpy(_np_tree(jp), device="cpu")
    return jm, jp, pm, pp


# -- weights ------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_init_params_equals_reference(seed):
    """The port draws the JAX package's numpy default_rng(seed) stream in
    its order, so init_params(s) == init_params(PRNGKey(s)) exactly."""
    jm = jtr.TransformerLM(jtr.TransformerConfig.tiny_test(**CFG))
    ref = _leaves(jm.init_params(jax.random.PRNGKey(seed)))
    out = _leaves(TransformerLM(TransformerConfig.tiny_test(**CFG))
                  .init_params(seed, device="cpu"))
    assert out.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)


def test_quantize_weights_and_params_from_numpy_equal_reference():
    """quantize_weights gives the reference's int8 data and scales,
    including the separate lm_head from embed.T; params_from_numpy carries
    the reference's quantized tree across to the same values, with the
    head's columns padded to a multiple of 8."""
    cfg = dict(CFG, vocab_size=300)
    jm = jtr.TransformerLM(jtr.TransformerConfig.tiny_test(**cfg))
    ref_tree = jtr.quantize_weights(jm.init_params(jax.random.PRNGKey(1)))
    ref = _leaves(ref_tree)
    pm = TransformerLM(TransformerConfig.tiny_test(**cfg))
    mine = quantize_weights(pm.init_params(1, device="cpu"))
    carried = params_from_numpy(_np_tree(ref_tree), device="cpu")
    for tree in (mine, carried):
        head = tree["lm_head"]
        assert isinstance(head, QuantWeight) and head.n == 300
        assert head.data.shape == (128, 304) and head.data.is_contiguous()
        out = _leaves(tree)
        assert out.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(out[k], ref[k], err_msg=k)


# -- linear -------------------------------------------------------------------

def _qweight(rng, k, n):
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.02
    jw = jtr.quantize_weights({"w": w})["w"]
    return jw, params_from_numpy({"w": _np_tree(jw)}, device="cpu")["w"]


@pytest.mark.parametrize("m,regime", [
    (8, "bf16"), (64, "bf16"), (8, "weight_only"), (64, "weight_only"),
    (65, "int8"), (65, "int8_padded_head")])
def test_linear_int8_regimes_match_reference(m, regime, monkeypatch):
    """The three int8 regimes of linear (transformer.py:165-230): M <= 64
    with a small weight (bf16 dot), M <= 64 with a weight at or over the
    size threshold (the weight-only kernel; the threshold is lowered in
    both packages so a small weight takes it), and M > 64 (per-tensor
    int8 activations over the whole group, int8 x int8), the last also
    on a head whose N = 300 is padded to 304 for the int8 product."""
    rng = np.random.default_rng(m)
    k, n = 96, 300 if regime == "int8_padded_head" else 160
    jw, pw = _qweight(rng, k, n)
    bias = rng.standard_normal(n).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    if regime == "weight_only":
        monkeypatch.setattr(jtr, "_WO_PALLAS_MIN_ELEMENTS", k * n)
        monkeypatch.setattr(ptr, "WO_KERNEL_MIN_ELEMENTS", k * n)
    calls = {"wo": 0, "int8": 0}
    for name, key in (("matmul_int8_wo", "wo"), ("matmul_int8", "int8")):
        real = getattr(ptr, name)

        def spy(*a, _real=real, _key=key):
            calls[_key] += 1
            return _real(*a)
        monkeypatch.setattr(ptr, name, spy)
    ref = np.asarray(jtr.linear(jnp.asarray(x), jw, jnp.asarray(bias)))
    out = linear(torch.from_numpy(x), pw, torch.from_numpy(bias)).numpy()
    assert out.shape == (m, n)
    assert calls == {"wo": int(regime == "weight_only"),
                     "int8": int(m > 64)}
    if m > 64:
        # int32 accumulation is exact and the epilogue is the same f32
        # arithmetic: bit for bit.
        np.testing.assert_array_equal(out, ref)
    else:
        # Same bf16 operands, f32 sums in another order.
        np.testing.assert_allclose(out, ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


def test_linear_takes_weight_only_kernel_from_8m_elements(monkeypatch):
    """At the real threshold (8M weight elements, the LM head's regime)
    an M <= 64 linear takes the weight-only kernel; one element less
    stays on the bf16 dot."""
    calls = []
    monkeypatch.setattr(ptr, "matmul_int8_wo",
                        lambda *a: calls.append(1) or torch.zeros(
                            a[0].shape[0], a[1].shape[1]))
    x = torch.ones((8, 64))
    for n, expect in ((131072, 1), (131071, 0)):
        calls.clear()
        w = QuantWeight("int8", torch.zeros((64, n + (-n) % 8),
                                            dtype=torch.int8),
                        torch.ones(n + (-n) % 8), n)
        assert linear(x, w).shape == (8, n)
        assert len(calls) == expect


# -- the slice: decode steps through the int8 tail cache ----------------------

def _prefilled(jm, jp, pm, pp, rng, b, p, cap, rows):
    tokens = rng.integers(1, 128, (b, p))
    jc = jm.new_cache(b, cap, quantized=True, tail_window=rows)
    pc = pm.new_cache(b, cap, quantized=True, tail_window=rows,
                      device="cpu")
    jl, jc = jm.prefill(jp, jnp.asarray(tokens, jnp.int32), jc)
    pl, pc = pm.prefill(pp, torch.from_numpy(tokens), pc)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=0,
                               atol=LOGIT_TOL)
    lens = np.full(b, p, np.int32)
    return jc.with_lengths(jnp.asarray(lens)), pc.with_lengths(lens)


def test_decode_step_logits_match_reference_across_flushes(models):
    """Teacher-forced decode with int8 weights and the int8 + tail cache:
    every step's logits against the JAX package's, through a full-window
    flush (t = R) and a partial one (t = 3), with the window fill equal
    after each step."""
    jm, jp, pm, pp = models
    b, rows = 4, 8
    rng = np.random.default_rng(5)
    jc, pc = _prefilled(jm, jp, pm, pp, rng, b, 5, 64, rows)
    tok = rng.integers(1, 128, b)
    worst = 0.0
    for step in range(12):
        jl, jc = jm.decode_step(jp, jnp.asarray(tok, jnp.int32), jc)
        pl, pc = pm.decode_step(pp, torch.tensor(tok), pc)
        assert pc.tail_count == int(jc.tail_count)
        worst = max(worst, float(np.abs(pl.numpy() - np.asarray(jl)).max()))
        if step in (rows - 1, rows + 2):        # flush t = 8, then t = 3
            t = pc.tail_count
            jc, pc = jc.flush_tail(t), pc.flush_tail(t)
            np.testing.assert_array_equal(pc.lengths.numpy(),
                                          np.asarray(jc.lengths))
        tok = np.asarray(jnp.argmax(jl, axis=-1))
    print(f"worst teacher-forced logit difference {worst:.3e}")
    assert worst < LOGIT_TOL, worst


def test_tail_count_advances_once_per_step(models):
    """The window slot advances once per step, after every layer has
    appended (kv_cache.py:605-617): each layer writes the same slot, and
    every step's logits stay within int8-KV rounding of a float-cache
    forward on every window depth, including the last layer's (the trap
    pinned by tests/test_engine.py::test_tail_decode_step_logits_match_
    float)."""
    _, _, pm, pp = models
    b, p, cap, rows = 4, 5, 64, 8
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(1, 128, (b, p)))
    tc = pm.new_cache(b, cap, quantized=True, tail_window=rows,
                      device="cpu")
    fc = pm.new_cache(b, cap, device="cpu")
    _, tc = pm.prefill(pp, tokens, tc)
    _, fc = pm.prefill(pp, tokens, fc)
    tc, fc = tc.with_lengths([p] * b), fc.with_lengths([p] * b)
    tok = torch.from_numpy(rng.integers(1, 128, b))
    for step in range(rows - 1):
        lt, tc = pm.decode_step(pp, tok, tc)
        lf, fc = pm.decode_step(pp, tok, fc)
        assert tc.tail_count == step + 1
        row = torch.cat([t[:, step] for t in tc.tail])
        assert row.abs().sum() > 0 and torch.equal(
            torch.cat([t[:, step + 1] for t in tc.tail]),
            torch.zeros_like(row))
        assert (lt - lf).abs().max() < 0.05, step
        tok = lt.argmax(-1)
    tc = tc.flush_tail(tc.tail_count)
    lt, tc = pm.decode_step(pp, tok, tc)
    lf, fc = pm.decode_step(pp, tok, fc)
    assert tc.tail_count == 1 and (lt - lf).abs().max() < 0.05


def test_tail_cache_refuses_other_readers(models):
    """Only the tail kernel reads a tail cache (transformer.py:426-431)."""
    _, _, pm, pp = models
    cache = pm.new_cache(2, 64, quantized=True, tail_window=8,
                         device="cpu")
    q = torch.zeros((2, 2, 64))
    with pytest.raises(ValueError, match="tail"):
        ptr._cache_decode_attn(pm.config, q, cache, 0)


# -- the engine ---------------------------------------------------------------

def _reference_margins(jm, jp, prompt, generated):
    """Top-2 logit margin of the JAX model at each generated position,
    teacher-forced without a cache."""
    seq = jnp.asarray([list(prompt) + list(generated)], jnp.int32)
    logits = np.asarray(jm.forward(jp, seq)[0][0])
    top = np.sort(logits[len(prompt) - 1:-1], axis=-1)
    return top[:, -1] - top[:, -2]


@pytest.mark.parametrize("burst", [1, 5])
def test_oversubscribed_engine_tokens_match_reference(models, burst):
    """6 prompts through 4 slots with an 8-row tail window and 20 new
    tokens each (slots recycle, windows flush inside and between bursts):
    the greedy tokens equal the JAX engine's wherever the reference's
    top-2 margin exceeds LOGIT_TOL."""
    jm, jp, pm, pp = models
    prompts = [[1, 2, 3], [4, 5, 6, 7], [9, 10], [11, 3, 2], [5, 5], [7]]
    kw = dict(max_batch=4, capacity=64, prefill_buckets=(16,),
              quantized_cache=True, tail_window=8)
    ref = JServingEngine(jm, jp, **kw).generate(prompts, 20, burst=burst)
    eng = ServingEngine(pm, pp, device="cpu", **kw)
    out = eng.generate(prompts, 20, burst=burst)
    assert eng._tail_flush == 8
    for prompt, r, o in zip(prompts, ref, out):
        assert len(o) == len(r) == 20
        c = next((i for i in range(20) if r[i] != o[i]), 20)
        if c < 20:
            margin = _reference_margins(jm, jp, prompt, r)[c]
            assert margin < LOGIT_TOL, (prompt, c, margin)
    st = eng.stats()
    assert st["completed"] == st["submitted"] == 6
    assert st["tokens"] == 6 * 19


def test_engine_tail_gate_matches_reference(models):
    """The engine's tail-window gate gives the reference's outcome for the
    configurations these tests and the serving path build."""
    jm, jp, pm, pp = models
    cases = [dict(max_batch=4, capacity=64), dict(max_batch=8, capacity=128),
             dict(max_batch=3, capacity=64), dict(max_batch=4, capacity=96),
             dict(max_batch=4, capacity=2048),
             dict(max_batch=4, capacity=2112)]
    for kw in cases:
        for quant in (True, False):
            ref = JServingEngine(jm, jp, prefill_buckets=(16,),
                                 quantized_cache=quant, **kw)._tail_flush
            got = ServingEngine(pm, pp, prefill_buckets=(16,),
                                quantized_cache=quant, device="cpu",
                                **kw)._tail_flush
            assert got == ref, (kw, quant)
    narrow = dict(n_heads=4, d_model=64)          # rows of 64 lanes: no tail
    jn = jtr.TransformerLM(jtr.TransformerConfig.tiny_test(**narrow))
    pn = TransformerLM(TransformerConfig.tiny_test(**narrow))
    jpn = jtr.quantize_weights(jn.init_params(jax.random.PRNGKey(0)))
    ppn = params_from_numpy(_np_tree(jpn), device="cpu")
    assert (JServingEngine(jn, jpn, max_batch=4, capacity=64,
                           quantized_cache=True)._tail_flush
            == ServingEngine(pn, ppn, max_batch=4, capacity=64,
                             quantized_cache=True,
                             device="cpu")._tail_flush == 0)


# Configurations where the reference gate's E-matrix and long-capacity
# terms decide (engine.py:260-279): (config, max_batch, capacity, whether
# the reference serves a tail).
GATE_CASES = {
    # E = 24 * 64 * 1280 * 4 B = 7.9 MB > 4 MB: no tail.
    "e_matrix": (dict(n_heads=20, d_model=1280, d_ff=64, n_layers=1), 4, 64,
                 False),
    # Capacity 12,288 at d 64, batch 16: a multiple of 128, the modeled
    # buffers fit, so a tail (beyond the old kernel's shared-memory row).
    "long_capacity": (dict(n_layers=1, **CFG), 16, 12288, True),
}


@pytest.mark.parametrize("case", list(GATE_CASES))
def test_engine_tail_gate_long_capacity_and_e_matrix(case):
    """The gate's E-matrix limit and its long-capacity terms give the
    reference's outcome: both engines built side by side pick the same
    tail window (random weights, one layer, vocabulary 128)."""
    kw, batch, cap, tail = GATE_CASES[case]
    jm = jtr.TransformerLM(jtr.TransformerConfig.tiny_test(**kw))
    jp = jtr.quantize_weights(jm.init_params(jax.random.PRNGKey(0)))
    pm = TransformerLM(TransformerConfig.tiny_test(**kw))
    pp = params_from_numpy(_np_tree(jp), device="cpu")
    engine_kw = dict(max_batch=batch, capacity=cap, prefill_buckets=(16,),
                     quantized_cache=True)
    ref = JServingEngine(jm, jp, **engine_kw)._tail_flush
    got = ServingEngine(pm, pp, device="cpu", **engine_kw)._tail_flush
    assert ref == (16 if tail else 0)
    assert got == ref


def test_unported_features_raise(models):
    _, _, pm, pp = models
    for kw in (dict(n_experts=4), dict(scan_layers=True),
               dict(dtype="bfloat16")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TransformerLM(TransformerConfig.tiny_test(**kw))
    # Ported since: the fused append and the exact-q grouped int8 mode.
    for kw in (dict(fused_append=True), dict(quant_int8_scores=False)):
        TransformerLM(TransformerConfig.tiny_test(**kw))
    for kw in (dict(mesh=object()), dict(spec_draft=2)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ServingEngine(pm, pp, max_batch=4, capacity=64, device="cpu",
                          **kw)
    # Paged caches are ported; page pools partitioned over a mesh are not.
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PagedKVCache.make_allocator(8, partitions=2)
    # Chunked verify is ported on contiguous caches, not on paged ones.
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pm.verify_step(pp, torch.zeros((2, 3), dtype=torch.int64),
                       pm.new_paged_cache(2, 64, 16, 9, device="cpu"))
