"""Parity of the port's float-cache and no-tail int8 decode paths
(``rten_tpu_torch`` on the CPU, where the kernels' plain versions run)
against the JAX package (CPU backend, Pallas in interpret mode), on inputs
drawn with numpy: the kernels ``kv_append`` (``cache_append``),
``kv_append_int8`` (``cache_append_quant``), ``decode_attn_float``
(``flash_decode_grouped`` / ``flash_decode_fused``) and ``decode_attn_int8``
(``flash_decode_flat`` without a tail), then the model and the engine on
those caches."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rten_tpu.generate.engine import ServingEngine as JServingEngine
from rten_tpu.generate.kv_cache import KVCache as JKVCache
from rten_tpu.kernels.attention import (flash_decode_flat,
                                        flash_decode_fused,
                                        flash_decode_grouped,
                                        flash_decode_stream)
from rten_tpu.kernels.cache import cache_append, cache_append_quant
from rten_tpu.models import transformer as jtr
from rten_tpu_torch.generate import ServingEngine
from rten_tpu_torch.kernels import attention as at
from rten_tpu_torch.kernels import cache as kc
from rten_tpu_torch.models import (TransformerConfig, TransformerLM,
                                   params_from_numpy)
from rten_tpu_torch.models import transformer as ptr
from test_torch_cuda import (NUMERICS_CASES, fused_kv, numerics_case,
                             numerics_ok, rows_view)
from test_torch_kernels import port_layout

B, KVH, D, CAP = 4, 2, 64, 64
F = KVH * D
# Small GPT-2-family config whose rows (2 heads of 64) are 128 lanes wide,
# so the reference takes its Pallas append kernels, as GPT-2-small does.
CFG = dict(n_heads=2, d_model=128)
# Teacher-forced logits with f32 weights on a float cache: the same f32
# arithmetic in both packages, sums in other orders (|logits| ~ 0.5).
F32_LOGIT_TOL = 1e-4
# int8 weights or an int8 cache: a bf16 rounding of an activation may flip
# between the packages (tests/test_torch_model.py:LOGIT_TOL).
LOGIT_TOL = 1e-2
# decode_attn_float against the reference: both sum in f32 in other orders.
FLOAT_ATTN_REL_TOL = 1e-5
# decode_attn_int8: both round the output to bf16 after f32 sums in other
# orders, so they may land one bf16 step apart; two steps of max |out|.
INT8_ATTN_REL_TOL = 2.0 ** -6

JDTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _t(a):
    return torch.from_numpy(np.array(a))


def _np32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _kv_rows(rng, b=B):
    """New K/V [B, KVH, 1, D] at mixed magnitudes, one all-zero head."""
    k, v = (rng.standard_normal((b, KVH, 1, D)).astype(np.float32)
            * np.exp(rng.uniform(-4, 3, (b, KVH, 1, 1))).astype(np.float32)
            for _ in range(2))
    k[1, 0] = 0.0
    return k, v


# -- K5: kv_append against cache_append ---------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_append_plain_bit_exact_against_cache_append(dtype):
    """The float decode append writes the reference's row at
    min(lengths, cap - 1) bit for bit, for f32 and bf16 caches, including
    slots at and past capacity."""
    rng = np.random.default_rng(40)
    buf = rng.standard_normal((B, CAP, 2, F)).astype(np.float32)
    jbuf = jnp.asarray(buf, JDTYPES[dtype])
    k, v = _kv_rows(rng)
    lengths = np.array([0, 17, CAP - 1, CAP + 5], np.int32)
    packed = np.stack([k.transpose(0, 2, 1, 3).reshape(B, 1, F),
                       v.transpose(0, 2, 1, 3).reshape(B, 1, F)], axis=2)
    (ref,) = cache_append(jnp.minimum(jnp.asarray(lengths), CAP - 1),
                          (jbuf,),
                          (jnp.asarray(packed).astype(JDTYPES[dtype]),))
    port = _t(_np32(jbuf)).to(TDTYPES[dtype])
    kc.kv_append(port, rows_view(_t(k)), rows_view(_t(v)), _t(lengths))
    np.testing.assert_array_equal(port.float().numpy(), _np32(ref))


# -- K7: kv_append_int8 against _quantize_tokens + cache_append_quant ---------

@pytest.mark.parametrize("masked", [False, True])
def test_kv_append_int8_plain_bit_exact_against_cache_append_quant(masked):
    """The int8 decode append, read back through the port's layout, equals
    the reference's bytes and scales bit for bit, including a slot past
    capacity and, with ``masked``, a sequence at pos -1 that writes
    nothing."""
    rng = np.random.default_rng(41 + masked)
    jc = JKVCache.create(B, 1, KVH, CAP, D, quantized=True)
    pre = [rng.standard_normal((B, KVH, CAP, D)).astype(np.float32)
           for _ in range(2)]
    jc = jc.append(0, jnp.asarray(pre[0]), jnp.asarray(pre[1]), position=0)
    k, v = _kv_rows(rng)
    pos = np.array([-1 if masked else 0, 5, CAP - 1, CAP + 3], np.int32)
    bytes_kv, srows = jc._pack(jnp.asarray(k), jnp.asarray(v))
    # The reference's callers clamp to cap - 1 (kv_cache.py:188).
    jpos = np.where(pos < 0, pos, np.minimum(pos, CAP - 1))
    new_kv, new_s = cache_append_quant(jnp.asarray(jpos), jc.kv[0],
                                       jc.quant_scales[0], bytes_kv, srows,
                                       masked=masked)
    ref = dataclasses.replace(jc, kv=[new_kv], quant_scales=[new_s])
    kv, scales = port_layout(jc, 0)
    kc.kv_append_int8(kv, scales, rows_view(_t(k)), rows_view(_t(v)),
                      _t(pos), masked=masked)
    ref_kv, ref_scales = port_layout(ref, 0)
    assert torch.equal(kv, ref_kv)
    assert torch.equal(scales, ref_scales)
    if masked:
        assert torch.equal(kv[0], port_layout(jc, 0)[0][0])
    assert scales[1, 5, 0, 0].item() == 1.0       # the all-zero head


# -- K6: decode_attn_float against flash_decode_grouped / fused ---------------

def _float_case(rng, b, h, kvh, cap, dtype):
    q = rng.standard_normal((b, h, D)).astype(np.float32)
    kv = rng.standard_normal((b, cap, 2, kvh * D)).astype(np.float32)
    lengths = np.resize(np.array([1, cap, 37, 2, cap - 1], np.int32), b)
    jkv = jnp.asarray(kv, JDTYPES[dtype])
    return q, jkv, lengths, _t(_np32(jkv)).to(TDTYPES[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,b,group,h,kvh", [
    ("grouped", 4, 2, 4, 2), ("grouped", 8, 4, 4, 2),
    ("grouped", 4, 2, 2, 2), ("fused", 1, 0, 4, 2), ("fused", 3, 0, 4, 2)])
def test_decode_attn_float_plain_matches_reference(kind, b, group, h, kvh,
                                                   dtype):
    """The plain K6 against flash_decode_grouped (groups 2 and 4) and
    flash_decode_fused (batch 1 and 3, where no group divides the batch),
    GQA and plain heads, f32 and bf16 caches, lengths 1 through cap."""
    rng = np.random.default_rng(50 + b + h)
    cap = 128
    q, jkv, lengths, pkv = _float_case(rng, b, h, kvh, cap, dtype)
    if kind == "grouped":
        ref = flash_decode_grouped(jnp.asarray(q), jkv, jnp.asarray(lengths),
                                   kvh, group=group, block_k=32)
    else:
        ref = flash_decode_fused(jnp.asarray(q), jkv, jnp.asarray(lengths),
                                 kvh, block_k=32)
    ref = np.asarray(ref)
    out = at.decode_attn_float(_t(q), pkv, _t(lengths))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=FLOAT_ATTN_REL_TOL * np.abs(ref).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kvh", [(4, 4, 2), (3, 2, 2)])
def test_decode_attn_float_plain_matches_flash_decode_stream(b, h, kvh,
                                                             dtype):
    """decode_attn="stream" on a float cache reaches K6: the plain K6
    against flash_decode_stream (one program per sequence, blocks of 64
    streamed) holds at K6's tolerance, with GQA and lengths 1 through
    cap, on f32 and bf16 caches, so the route stays."""
    rng = np.random.default_rng(70 + b + h)
    cap = 128
    q, jkv, lengths, pkv = _float_case(rng, b, h, kvh, cap, dtype)
    ref = np.asarray(flash_decode_stream(jnp.asarray(q), jkv,
                                         jnp.asarray(lengths), kvh,
                                         block_k=64))
    out = at.decode_attn_float(_t(q), pkv, _t(lengths))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=FLOAT_ATTN_REL_TOL * np.abs(ref).max())


@pytest.mark.parametrize("name", NUMERICS_CASES)
def test_decode_attn_float_plain_numerics(name):
    """The online-softmax stress cases of tests/test_numerics.py at their
    bounds against fp64: mixed 2^±24 magnitudes and exact score ties
    within 512 ULP or 1e-4 relative, an underflowing tail within 64 ULP."""
    q, k, v, lengths, max_ulp, rel = numerics_case(name)
    got = at.decode_attn_float(
        _t(np.asarray(q, np.float32)), _t(fused_kv(k, v)),
        _t(lengths.astype(np.int32))).numpy()
    numerics_ok(got, q, k, v, lengths, max_ulp, rel)


# -- K1': decode_attn_int8 against flash_decode_flat without a tail -----------

def test_decode_attn_int8_plain_matches_flash_decode_flat():
    """The plain K1' against flash_decode_flat(int8, tail=None, q_bf16)
    with GQA, lengths 1 through cap."""
    rng = np.random.default_rng(60)
    jc = JKVCache.create(B, 1, KVH, CAP, D, quantized=True)
    pre = [rng.standard_normal((B, KVH, CAP, D)).astype(np.float32)
           for _ in range(2)]
    jc = jc.append(0, jnp.asarray(pre[0]), jnp.asarray(pre[1]), position=0)
    h = 4                                      # two query heads per kv head
    q = rng.standard_normal((B, h, D)).astype(np.float32)
    lens = np.array([1, CAP, 29, CAP - 1], np.int32)
    ref = np.asarray(flash_decode_flat(
        jnp.asarray(q), jc.kv[0], jnp.asarray(lens), KVH, group=2,
        block_k=64, kv_scales=jc.quant_scales[0], q_bf16=True))
    kv, scales = port_layout(jc, 0)
    out = at.decode_attn_int8(_t(q), kv, scales, _t(lens))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=INT8_ATTN_REL_TOL * np.abs(ref).max())


@pytest.mark.parametrize("wrapper,args", [
    (kc.kv_append, lambda: (
        torch.zeros((B, CAP, 2, F)), torch.zeros((B, KVH, 1, D)),
        torch.zeros((B, KVH, 1, D)), torch.ones(B, dtype=torch.int32))),
    (kc.kv_append_int8, lambda: (
        torch.zeros((B, CAP, 2, F), dtype=torch.int8),
        torch.ones((B, CAP, 2, KVH), dtype=torch.bfloat16),
        torch.zeros((B, KVH, 1, D)), torch.zeros((B, KVH, 1, D)),
        torch.ones(B, dtype=torch.int32))),
    (at.decode_attn_float, lambda: (
        torch.zeros((B, 4, D)), torch.zeros((B, CAP, 2, F)),
        torch.ones(B, dtype=torch.int32))),
    (at.decode_attn_int8, lambda: (
        torch.zeros((B, 4, D)), torch.zeros((B, CAP, 2, F), dtype=torch.int8),
        torch.ones((B, CAP, 2, KVH), dtype=torch.bfloat16),
        torch.ones(B, dtype=torch.int32))),
    # The paged kernels: a pool of 9 pages of 8 tokens, 2 pages per row.
    (kc.kv_append_paged, lambda: (
        torch.zeros((9, 8, 2, F)), torch.zeros((B, KVH, 1, D)),
        torch.zeros((B, KVH, 1, D)),
        torch.arange(1, 2 * B + 1, dtype=torch.int32).reshape(B, 2),
        torch.ones(B, dtype=torch.int32))),
    (kc.kv_append_paged_int8, lambda: (
        torch.zeros((9, 8, 2, F), dtype=torch.int8),
        torch.ones((9, 8, 2, KVH), dtype=torch.bfloat16),
        torch.zeros((B, KVH, 1, D)), torch.zeros((B, KVH, 1, D)),
        torch.arange(1, 2 * B + 1, dtype=torch.int32).reshape(B, 2),
        torch.ones(B, dtype=torch.int32))),
    (at.decode_attn_paged, lambda: (
        torch.zeros((B, 4, D)), torch.zeros((9, 8, 2, F)),
        torch.arange(1, 2 * B + 1, dtype=torch.int32).reshape(B, 2),
        torch.ones(B, dtype=torch.int32))),
    (at.decode_attn_paged_grid, lambda: (
        torch.zeros((B, 4, D)), torch.zeros((9, 8, 2, F)),
        torch.arange(1, 2 * B + 1, dtype=torch.int32).reshape(B, 2),
        torch.ones(B, dtype=torch.int32))),
    (at.decode_attn_paged_int8, lambda: (
        torch.zeros((B, 4, D)), torch.zeros((9, 8, 2, F), dtype=torch.int8),
        torch.ones((9, 8, 2, KVH), dtype=torch.bfloat16),
        torch.arange(1, 2 * B + 1, dtype=torch.int32).reshape(B, 2),
        torch.ones(B, dtype=torch.int32))),
])
def test_new_wrappers_never_fall_back_off_the_cpu(wrapper, args):
    """A wrapper runs its plain version only for CPU tensors: tensors on
    another device (meta here), or on mixed devices, raise instead."""
    cpu_args = args()
    before = wrapper.launches
    wrapper(*cpu_args)                       # plain version, no launch
    assert wrapper.launches == before
    meta = [a.to("meta") for a in cpu_args]
    with pytest.raises(ValueError):
        wrapper(*meta)
    mixed = list(cpu_args)
    mixed[0] = meta[0]
    with pytest.raises(ValueError):
        wrapper(*mixed)


# -- the model ----------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    """The JAX and port models with the same f32 weights (seed 3) and the
    same int8 weights quantized from them."""
    jm = jtr.TransformerLM(jtr.TransformerConfig.tiny_test(**CFG))
    jp = jm.init_params(jax.random.PRNGKey(3))
    jq = jtr.quantize_weights(jp)
    pm = TransformerLM(TransformerConfig.tiny_test(**CFG))
    return (jm, pm, {"f32": jp, "int8": jq},
            {"f32": params_from_numpy(_np_tree(jp), device="cpu"),
             "int8": params_from_numpy(_np_tree(jq), device="cpu")})


CACHES = {  # name: (weights, new_cache kwargs, logit tolerance)
    "f32": ("f32", dict(), F32_LOGIT_TOL),
    "bf16": ("f32", dict(cache_dtype="bfloat16"), F32_LOGIT_TOL),
    "int8_no_tail": ("int8", dict(quantized=True), LOGIT_TOL),
}


@pytest.mark.parametrize("cache", list(CACHES))
def test_decode_step_logits_match_reference(models, cache):
    """Teacher-forced decode from a prefilled cache: every step's logits
    against the JAX package's, on an f32 cache and a bf16 cache (an
    unquantized f32 tree carried across by params_from_numpy) and on an
    int8 cache without a tail (int8 weights), with slots at ragged depths.
    (Appends past capacity are held bit-exact at the kernel level above.)"""
    jm, pm, jps, pps = models
    weights, kw, tol = CACHES[cache]
    jp, pp = jps[weights], pps[weights]
    b, p, cap = 4, 5, 32
    rng = np.random.default_rng(7)
    tokens = rng.integers(1, 128, (b, p))
    jc = jm.new_cache(b, cap, **kw)
    pc = pm.new_cache(b, cap, device="cpu", **kw)
    jl, jc = jm.prefill(jp, jnp.asarray(tokens, jnp.int32), jc)
    pl, pc = pm.prefill(pp, torch.from_numpy(tokens), pc)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=0, atol=tol)
    lens = np.array([p, 3, 1, p], np.int32)
    jc, pc = jc.with_lengths(jnp.asarray(lens)), pc.with_lengths(lens)
    tok = rng.integers(1, 128, b)
    worst = 0.0
    for _ in range(12):
        jl, jc = jm.decode_step(jp, jnp.asarray(tok, jnp.int32), jc)
        pl, pc = pm.decode_step(pp, torch.tensor(tok), pc)
        worst = max(worst, float(np.abs(pl.numpy() - np.asarray(jl)).max()))
        tok = np.asarray(jnp.argmax(jl, axis=-1))
    np.testing.assert_array_equal(pc.lengths.numpy(), np.asarray(jc.lengths))
    print(f"{cache}: worst teacher-forced logit difference {worst:.3e}")
    assert worst < tol, worst


def test_decode_dispatch_follows_the_reference(models, monkeypatch):
    """Which wrapper a decode step reaches: a float cache → K6 at any
    batch, with decode_attn "auto" or "stream"; with "flat" at a batch with
    a group in (8, 4, 2) → K8 (the reference takes the float mode of
    flash_decode_flat there; tests/test_torch_flat_float.py holds the rule
    against the reference's) and K6 at the other batches (the reference's
    grouped/fused float kernels); an int8
    cache without a tail at a batch with a flat group → K1'; with no flat
    group → G2 (flash_decode_fused); decode_attn "grouped" → G1 with int8
    scores at this short capacity, "fused" and "stream" → G2
    (tests/test_torch_mistral.py holds the whole rule against the
    reference's)."""
    _, _, _, pps = models
    calls = []
    for name in ("decode_attn_float", "decode_attn_flat_float",
                 "decode_attn_int8", "decode_attn_grouped_int8",
                 "decode_attn_fused_int8"):
        real = getattr(ptr, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append(_name + (".scores" if kw.get("int8_scores")
                                  else ""))
            return _real(*a, **kw)
        monkeypatch.setattr(ptr, name, spy)

    def step(pm, weights, b, **kw):
        calls.clear()
        cache = pm.new_cache(b, 32, device="cpu", **kw)
        pm.decode_step(pps[weights], torch.ones(b, dtype=torch.int64), cache)
        return set(calls)

    pm = TransformerLM(TransformerConfig.tiny_test(**CFG))
    for b in (1, 3, 4):
        assert step(pm, "f32", b) == {"decode_attn_float"}
        assert step(pm, "f32", b, cache_dtype="bfloat16") == {
            "decode_attn_float"}
    assert step(pm, "int8", 4, quantized=True) == {"decode_attn_int8"}
    assert step(pm, "int8", 3, quantized=True) == {"decode_attn_fused_int8"}
    for kind, want in (("grouped", "decode_attn_grouped_int8.scores"),
                       ("fused", "decode_attn_fused_int8"),
                       ("stream", "decode_attn_fused_int8")):
        pk = TransformerLM(TransformerConfig.tiny_test(decode_attn=kind,
                                                       **CFG))
        assert step(pk, "int8", 4, quantized=True) == {want}
    stream = TransformerLM(TransformerConfig.tiny_test(decode_attn="stream",
                                                       **CFG))
    flat = TransformerLM(TransformerConfig.tiny_test(decode_attn="flat",
                                                     **CFG))
    for b in (1, 3, 4):
        assert step(stream, "f32", b) == {"decode_attn_float"}
    for b in (1, 3):
        assert step(flat, "f32", b) == {"decode_attn_float"}
    for kw in (dict(), dict(cache_dtype="bfloat16")):
        assert step(flat, "f32", 4, **kw) == {"decode_attn_flat_float"}
    assert step(flat, "int8", 4, quantized=True) == {"decode_attn_int8"}


# -- the engine ---------------------------------------------------------------

def _reference_margins(jm, jp, prompt, generated):
    """Top-2 logit margin of the JAX model at each generated position,
    teacher-forced without a cache."""
    seq = jnp.asarray([list(prompt) + list(generated)], jnp.int32)
    logits = np.asarray(jm.forward(jp, seq)[0][0])
    top = np.sort(logits[len(prompt) - 1:-1], axis=-1)
    return top[:, -1] - top[:, -2]


ENGINES = {  # name: (weights, engine kwargs, margin tolerance)
    "f32": ("f32", dict(), F32_LOGIT_TOL),
    "bf16": ("int8", dict(cache_dtype="bfloat16"), LOGIT_TOL),
    "int8_no_tail": ("int8", dict(quantized_cache=True, tail_window=0),
                     LOGIT_TOL),
}


@pytest.mark.parametrize("cache", list(ENGINES))
def test_oversubscribed_engine_tokens_match_reference(models, cache):
    """6 prompts through 4 slots, 20 new tokens each in bursts of 4 (slots
    recycle): the port's greedy tokens equal the JAX engine's wherever the
    reference's top-2 margin exceeds the tolerance, on an f32 cache (f32
    weights), a bf16 cache and an int8 cache without a tail (int8
    weights)."""
    jm, pm, jps, pps = models
    weights, kw, tol = ENGINES[cache]
    prompts = [[1, 2, 3], [4, 5, 6, 7], [9, 10], [11, 3, 2], [5, 5], [7]]
    kw = dict(max_batch=4, capacity=64, prefill_buckets=(16,), **kw)
    ref = JServingEngine(jm, jps[weights], **kw).generate(prompts, 20,
                                                          burst=4)
    eng = ServingEngine(pm, pps[weights], device="cpu", **kw)
    out = eng.generate(prompts, 20, burst=4)
    assert eng._tail_flush == 0
    differ = 0
    for prompt, r, o in zip(prompts, ref, out):
        assert len(o) == len(r) == 20
        c = next((i for i in range(20) if r[i] != o[i]), 20)
        if c < 20:
            differ += 1
            margin = _reference_margins(jm, jps[weights], prompt, r)[c]
            assert margin < tol, (prompt, c, margin)
    print(f"{cache}: {differ} of {len(prompts)} requests differ after a "
          f"near tie")
    st = eng.stats()
    assert st["completed"] == st["submitted"] == 6
    assert st["tokens"] == 6 * 19
