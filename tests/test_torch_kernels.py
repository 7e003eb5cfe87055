"""Parity of the port's kernels (their plain PyTorch versions, which CPU
tensors take) against the JAX package's kernels on the CPU (Pallas in
interpret mode), on inputs drawn with numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rten_tpu.generate.kv_cache import (KVCache as JKVCache,
                                        unpack_bf16_rows,
                                        unpack_int8_tokens)
from rten_tpu.kernels import gemm as jgemm
from rten_tpu.kernels.attention import flash_decode_flat
from rten_tpu_torch.generate.kv_cache import KVCache
from rten_tpu_torch.kernels import attention as at
from rten_tpu_torch.kernels import cache as kc
from rten_tpu_torch.kernels import gemm as pg

B, KVH, D, CAP = 4, 2, 64, 64
F = KVH * D


def _t(a):
    return torch.from_numpy(np.array(a))


def port_layout(jcache, layer):
    """The JAX cache's token-packed int32 rows and pair-packed bf16 scale
    rows, read back into the port's int8 [B, cap, 2, F] and bf16
    [B, cap, 2, KVH] layout."""
    kvh = jcache.kv_heads
    buf = jcache.kv[layer]
    k = np.asarray(unpack_int8_tokens(buf[:, :, 0]))
    v = np.asarray(unpack_int8_tokens(buf[:, :, 1]))
    s = np.asarray(unpack_bf16_rows(jcache.quant_scales[layer][:, :, 0]))
    kv = np.stack([k, v], axis=2).astype(np.int8)
    scales = np.stack([s[..., :kvh], s[..., 64:64 + kvh]], axis=2)
    return _t(kv), _t(scales).to(torch.bfloat16)


def _prefilled(rng, prompt_lens, rows, n_layers=1):
    """A JAX tail cache and the port's, filled as the engine fills them: a
    prefilled admission group inserted slot by slot (the reference's carry
    rows are initialised by that insert)."""
    t = max(prompt_lens)
    jg = JKVCache.create(B, n_layers, KVH, CAP, D, quantized=True)
    pg_ = KVCache.create(B, n_layers, KVH, CAP, D, quantized=True,
                         device="cpu")
    for layer in range(n_layers):
        k = rng.standard_normal((B, KVH, t, D)).astype(np.float32)
        v = rng.standard_normal((B, KVH, t, D)).astype(np.float32)
        jg = jg.append(layer, jnp.asarray(k), jnp.asarray(v), position=0)
        pg_ = pg_.append(layer, _t(k), _t(v), position=0)
    jc = JKVCache.create(B, n_layers, KVH, CAP, D, quantized=True,
                         tail_window=rows)
    pc = KVCache.create(B, n_layers, KVH, CAP, D, quantized=True,
                        tail_window=rows, device="cpu")
    for b, n in enumerate(prompt_lens):
        jc = jc.insert_sequence(jg, b, n, src_slot=b)
        pc = pc.insert_sequence(pg_, b, n, src_slot=b)
    return jc, pc


@pytest.mark.parametrize("depth", range(8))
def test_decode_attn_plain_matches_flash_decode_flat(depth):
    """The plain K1 against flash_decode_flat(int8 + tail, q_bf16) at every
    window depth 0..R-1 (the model passes lengths + 1 and depth + 1)."""
    rows = 8
    rng = np.random.default_rng(depth)
    prompt_lens = [1, 17, 40, CAP - rows - 1]
    jc, _ = _prefilled(rng, prompt_lens, rows)
    tail = rng.standard_normal((B, rows, 2, F)).astype(np.float32)
    tail_bf16 = jnp.asarray(tail, jnp.bfloat16)
    h = 4                                      # two query heads per kv head
    q = rng.standard_normal((B, h, D)).astype(np.float32)
    lens = np.asarray(prompt_lens, np.int32) + depth     # window included
    ref = flash_decode_flat(
        jnp.asarray(q), jc.kv[0], jnp.asarray(lens + 1), KVH, group=2,
        block_k=64, kv_scales=jc.quant_scales[0], tail=tail_bf16,
        tail_count=depth + 1, q_bf16=True)
    kv, scales = port_layout(jc, 0)
    out = at.decode_attn_int8_tail(
        _t(q), kv, scales, _t(lens + 1),
        _t(np.asarray(tail_bf16.astype(jnp.float32))).to(torch.bfloat16),
        depth + 1)
    # Both round the output to bf16 after f32 sums taken in different
    # orders: allow two bf16 steps of the largest output.
    ref = np.asarray(ref)
    tol = 2.0 ** -6 * np.abs(ref).max()
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=tol)


def _decode_rows(rng, n):
    return [(rng.standard_normal((B, KVH, 1, D)).astype(np.float32),
             rng.standard_normal((B, KVH, 1, D)).astype(np.float32))
            for _ in range(n)]


@pytest.mark.parametrize("t", range(1, 17))
def test_flush_tail_bit_exact(t):
    """flush_tail(t) for every t in 1..16 (the reference's partial-flush
    token drop was at t % 4 != 0): after t decode appends, the flushed
    cache's dequantized values and lengths equal the JAX package's bit for
    bit, including a sequence that ran past capacity (offsets clamp)."""
    rng = np.random.default_rng(100 + t)
    prompt_lens = [3, 9, 30, CAP - 2]
    jc, pc = _prefilled(rng, prompt_lens, 16)
    for k, v in _decode_rows(rng, t):
        jc = jc.append(0, jnp.asarray(k), jnp.asarray(v)).advance(1)
        pc = pc.append(0, _t(k), _t(v)).advance(1)
    assert int(jc.tail_count) == pc.tail_count == t
    before = [[x.clone() for x in pc.layer_kv(0)]]
    jc = jax.jit(lambda c: c.flush_tail(t))(jc)
    pc = pc.flush_tail(t)
    assert pc.tail_count == 0 == int(jc.tail_count)
    lengths = pc.lengths.numpy()
    np.testing.assert_array_equal(lengths, np.asarray(jc.lengths))
    offs = np.clip(lengths - t, 0, CAP - t)
    for layer in range(1):
        for jx, px, old in zip(jc.layer_kv(layer), pc.layer_kv(layer),
                               before[layer]):
            jx, px = np.asarray(jx), px.numpy()
            for b in range(B):
                if lengths[b] <= CAP:
                    np.testing.assert_array_equal(px[b, :, :lengths[b]],
                                                  jx[b, :, :lengths[b]])
                    continue
                # A slot that ran past capacity (finished, still
                # decoding): the window lands at cap - t in both. The
                # reference's carry-row fast path (t % 4 == 0) also
                # rewrites the row before the window with its carry row
                # there; the port leaves those tokens as they were.
                np.testing.assert_array_equal(px[b, :, offs[b]:],
                                              jx[b, :, offs[b]:])
                np.testing.assert_array_equal(px[b, :, :offs[b]],
                                              old[b, :, :offs[b]].numpy())


def test_tail_flush_plain_matches_quantize_tokens_rules():
    """The flush writes exactly the quantizer's bytes and scales at
    clip(lengths - t, 0, cap - t), an all-zero head taking scale 1.0."""
    rng = np.random.default_rng(7)
    t, rows = 5, 8
    tail = _t(rng.standard_normal((B, rows, 2, F)).astype(np.float32)).to(
        torch.bfloat16)
    tail[1, 2, 0, :D] = 0
    kv = torch.zeros((B, CAP, 2, F), dtype=torch.int8)
    scales = torch.ones((B, CAP, 2, KVH), dtype=torch.bfloat16)
    lengths = torch.tensor([2, t, 40, CAP + 3], dtype=torch.int32)
    kc.tail_flush_int8(tail, kv, scales, lengths, t)
    from rten_tpu.generate.kv_cache import _quantize_tokens
    x = np.asarray(tail[:, :t].float().numpy()).reshape(B, t, 2, KVH, D)
    q, s = _quantize_tokens(jnp.asarray(x))
    q, s = np.asarray(q), np.asarray(s.astype(jnp.float32))
    for b, off in enumerate(np.clip(lengths.numpy() - t, 0, CAP - t)):
        np.testing.assert_array_equal(
            kv[b, off:off + t].numpy(), q[b].reshape(t, 2, F))
        np.testing.assert_array_equal(
            scales[b, off:off + t].float().numpy(), s[b])
    assert scales[1, 2, 0, 0].item() == 1.0


def _int8_weight(rng, k, n):
    from rten_tpu.kernels.quant import abs_max_quantize_int8
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.02
    return abs_max_quantize_int8(w, axis=0)


@pytest.mark.parametrize("m", [1, 8, 64])
def test_head_argmax_plain_matches_matmul_argmax_int8(m):
    rng = np.random.default_rng(m)
    k, n = 96, 300
    q, s = _int8_weight(rng, k, n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    ref = np.asarray(jgemm.matmul_argmax_int8(jnp.asarray(x),
                                              jnp.asarray(q),
                                              jnp.asarray(s), block_n=128))
    qp, sp = pg.pad_cols(_t(q), _t(s))
    out = pg.head_argmax_int8(_t(x), qp, sp, n_valid=n)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)


def test_head_argmax_tie_across_vocab_tiles_takes_lowest_index():
    """Column 200 (second 128-wide tile) duplicates column 5 (first tile)
    and both beat every other column: the lowest index wins on both sides;
    padding columns past n_valid never win, however large."""
    rng = np.random.default_rng(11)
    k, n = 64, 256
    q, s = _int8_weight(rng, k, n)
    x = np.abs(rng.standard_normal((4, k))).astype(np.float32)
    q[:, 5] = 127
    q[:, 200] = 127
    s[5] = s[200] = 1.0
    ref = np.asarray(jgemm.matmul_argmax_int8(jnp.asarray(x),
                                              jnp.asarray(q),
                                              jnp.asarray(s), block_n=128))
    assert (ref == 5).all()
    out = pg.head_argmax_int8(_t(x), _t(q), _t(s))
    np.testing.assert_array_equal(out.numpy(), ref)
    q_pad = np.concatenate([q, np.full((k, 8), 127, np.int8)], axis=1)
    s_pad = np.concatenate([s, np.full(8, 10.0, np.float32)])
    out = pg.head_argmax_int8(_t(x), _t(q_pad), _t(s_pad), n_valid=n)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("m", [1, 8, 64])
def test_matmul_wo_plain_matches_weight_only(m):
    rng = np.random.default_rng(20 + m)
    k, n = 128, 200
    q, s = _int8_weight(rng, k, n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    ref = np.asarray(jgemm.matmul_int8_weight_only(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(s)))
    out = pg.matmul_int8_wo(_t(x), _t(q), _t(s))
    # Same bf16 operands and f32 accumulation; sums in other orders.
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_matmul_int8_matches_xla_dot():
    rng = np.random.default_rng(3)
    x = rng.integers(-127, 128, (80, 64)).astype(np.int8)
    w = rng.integers(-127, 128, (64, 48)).astype(np.int8)
    ws = rng.random(48).astype(np.float32)
    ref = np.asarray(jgemm.matmul_int8(jnp.asarray(x), jnp.asarray(w),
                                       jnp.float32(0.03), jnp.asarray(ws)))
    out = pg.matmul_int8(_t(x), _t(w), torch.tensor(0.03), _t(ws))
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("wrapper,args", [
    (at.decode_attn_int8_tail, lambda: (
        torch.zeros((B, 4, D)), torch.zeros((B, CAP, 2, F), dtype=torch.int8),
        torch.ones((B, CAP, 2, KVH), dtype=torch.bfloat16),
        torch.ones(B, dtype=torch.int32),
        torch.zeros((B, 8, 2, F), dtype=torch.bfloat16), 1)),
    (kc.tail_flush_int8, lambda: (
        torch.zeros((B, 8, 2, F), dtype=torch.bfloat16),
        torch.zeros((B, CAP, 2, F), dtype=torch.int8),
        torch.ones((B, CAP, 2, KVH), dtype=torch.bfloat16),
        torch.ones(B, dtype=torch.int32), 1)),
    (pg.matmul_int8_wo, lambda: (
        torch.zeros((4, 16)), torch.zeros((16, 8), dtype=torch.int8),
        torch.ones(8))),
    (pg.head_argmax_int8, lambda: (
        torch.zeros((4, 16)), torch.zeros((16, 8), dtype=torch.int8),
        torch.ones(8))),
])
def test_wrapper_never_falls_back_off_the_cpu(wrapper, args):
    """A wrapper runs its plain version only for CPU tensors: tensors on
    another device (meta here), or on mixed devices, raise instead."""
    cpu_args = args()
    before = wrapper.launches
    wrapper(*cpu_args)                       # plain version, no launch
    assert wrapper.launches == before
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a
            for a in cpu_args]
    with pytest.raises(ValueError):
        wrapper(*meta)
    mixed = list(cpu_args)
    mixed[0] = meta[0]
    with pytest.raises(ValueError):
        wrapper(*mixed)


def test_decode_attn_plain_rejects_bad_shapes():
    with pytest.raises(ValueError):
        at.decode_attn_int8_tail(
            torch.zeros((B, 4, D)), torch.zeros((B, CAP, 2, F)),
            torch.ones((B, CAP, 2, KVH), dtype=torch.bfloat16),
            torch.ones(B, dtype=torch.int32),
            torch.zeros((B, 8, 2, F), dtype=torch.bfloat16), 1)


# -- kernels/quant.py ---------------------------------------------------------

def _kv_rows(rng):
    """K/V-like rows [B, T, KVH, D] at mixed magnitudes, with one all-zero
    head (scale 1.0) and values that sit on bf16 grid points."""
    x = rng.standard_normal((B, 6, KVH, D)).astype(np.float32)
    x *= np.exp(rng.uniform(-6, 4, (B, 6, KVH, 1))).astype(np.float32)
    x[1, 2, 0] = 0.0
    x[2] = np.asarray(jnp.asarray(x[2], jnp.bfloat16).astype(jnp.float32))
    return x


def test_quantize_tokens_bit_exact_against_reference():
    from rten_tpu.generate.kv_cache import _quantize_tokens
    from rten_tpu_torch.kernels.quant import quantize_tokens
    x = _kv_rows(np.random.default_rng(30))
    ref_q, ref_s = _quantize_tokens(jnp.asarray(x))
    q, s = quantize_tokens(_t(x))
    assert q.dtype == torch.int8 and s.dtype == torch.bfloat16
    np.testing.assert_array_equal(q.numpy(), np.asarray(ref_q))
    np.testing.assert_array_equal(s.float().numpy(),
                                  np.asarray(ref_s.astype(jnp.float32)))
    assert s[1, 2, 0].item() == 1.0


@pytest.mark.parametrize("axis", [0, 1])
def test_abs_max_quantize_int8_bit_exact_against_reference(axis):
    from rten_tpu.kernels import quant as jq
    from rten_tpu_torch.kernels.quant import abs_max_quantize_int8
    w = np.random.default_rng(31 + axis).standard_normal(
        (48, 40)).astype(np.float32) * 0.02
    if axis == 0:
        w[:, 3] = 0.0
    else:
        w[3] = 0.0
    ref_q, ref_s = jq.abs_max_quantize_int8(w, axis=axis)
    q, s = abs_max_quantize_int8(_t(w), axis=axis)
    np.testing.assert_array_equal(q.numpy(), ref_q)
    np.testing.assert_array_equal(s.numpy(), ref_s)


def test_onnx_quantize_dequantize_dynamic_match_reference():
    from rten_tpu.kernels import quant as jq
    from rten_tpu_torch.kernels import quant as pq
    rng = np.random.default_rng(32)
    x = rng.standard_normal((6, 5)).astype(np.float32) * 3
    scale = np.asarray([0.02, 0.5, 0.031, 1.0, 0.07], np.float32)
    zp = np.asarray([0, 3, -2, 10, -128], np.int8)
    for args in ((0.05,), (scale, zp)):
        axis = 1 if len(args) == 2 else None
        ref = np.asarray(jq.quantize(x, *args, axis=axis))
        out = pq.quantize(_t(x), *[_t(a) if isinstance(a, np.ndarray)
                                   else a for a in args], axis=axis)
        np.testing.assert_array_equal(out.numpy(), ref)
        ref_dq = np.asarray(jq.dequantize(ref, *args, axis=axis))
        out_dq = pq.dequantize(out, *[_t(a) if isinstance(a, np.ndarray)
                                      else a for a in args], axis=axis)
        np.testing.assert_array_equal(out_dq.numpy(), ref_dq)
    for r, o in zip(jq.dynamic_quantize(x), pq.dynamic_quantize(_t(x))):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
