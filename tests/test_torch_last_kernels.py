"""Parity of the port's last kernel-level entries against their reference
functions on the CPU (the port's plain versions, the reference's Pallas
kernels in interpret mode), on inputs drawn with numpy:

* ``decode_attn_int8_partials`` against ``flash_decode_flat(partials=True)``
  with ``q_bf16`` on and off, and the two-shard merge of
  tests/test_attention.py:780-825; and its design, the KV-group kernel's
  walk in its partials modes at ``rows_plan``'s launch of both timed
  shapes (chunks, warps, ring tiles, the splits' merge, the unnormalized
  emit), redone in torch against the same reference;
* K9 (``decode_attn_split_kv``) against ``flash_decode`` at its kernel's
  shapes and at a shape it sends to ``_attn_reference``, lengths 0
  included; and K9's design, the KV-group kernel's walk over separate K
  and V planes (the ``Planes`` addressing, the chunks, warps and ring
  tiles of ``rows_plan``, the splits' merge), redone in torch against
  ``flash_decode`` on f32 and bf16 planes;
* ``decode_attn_native_dots`` and ``decode_attn_grouped_int8(pv_int8=True)``
  against ``flash_decode_grouped`` in the same modes, at the reference
  tests' shapes (tests/test_attention.py:440-487) and at a batch where the
  reference falls back to its fused kernel;
* M1 (``matmul_int8_tiled``) bit for bit against ``matmul_int8_pallas``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rten_tpu.generate.kv_cache import KVCache as JKVCache
from rten_tpu.kernels import gemm as jgemm
from rten_tpu.kernels.attention import (flash_decode, flash_decode_flat,
                                        flash_decode_grouped)
from rten_tpu_torch.kernels import attention as at
from rten_tpu_torch.kernels import gemm as pg
from test_torch_kernels import port_layout
from test_torch_spec_kernels import _merge as _merge_states
from test_torch_spec_kernels import _tile_rows, _warp_walk

# The reference tests' shapes (tests/test_attention.py:440-487, 780-825).
B, H, KVH, D, CAP = 4, 8, 4, 32, 128
LENS = np.array([5, 127, 64, 1], np.int32)
# Both packages sum in f32 in other orders (an exact softmax against an
# online one over blocks): a few f32 roundings of outputs of order 1.
REL_TOL = 1e-5
# The partials merge of tests/test_attention.py:825.
MERGE_RTOL = 2e-5
# q_bf16 rounds the partials accumulator (or the merged output) to bf16: an
# element whose f32 sums straddle a rounding boundary lands one bf16 step
# apart, at most 2^-7 of its value.
BF16_STEP = 2.0 ** -7


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(out, ref, tol=REL_TOL):
    ref = np.asarray(ref)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=tol * np.abs(ref).max())


def _int8_cache(seed, b=B, cap=CAP):
    """q [b, H, D] and an int8 cache filled through the reference's
    quantizing append, in its layout and in the port's."""
    rng = np.random.default_rng(seed)
    jc = JKVCache.create(b, 1, KVH, cap, D, quantized=True)
    rows = [(rng.standard_normal((b, KVH, cap, D))
             * np.exp(rng.uniform(-1, 1, (b, KVH, 1, 1)))).astype(np.float32)
            for _ in range(2)]
    jc = jc.append(0, jnp.asarray(rows[0]), jnp.asarray(rows[1]), position=0)
    q = rng.standard_normal((b, H, D)).astype(np.float32)
    kv, scales = port_layout(jc, 0)
    return q, jc, kv, scales


def _shard(jc, kv, scales, s, half):
    """Capacity shard s of [s * half, (s + 1) * half): the reference's
    cache rows (packed 4 tokens an int32 row, scales 2 a row) and the
    port's."""
    jkv = jc.kv[0][:, s * half // 4:(s + 1) * half // 4]
    jsc = jc.quant_scales[0][:, s * half // 2:(s + 1) * half // 2]
    sl = slice(s * half, (s + 1) * half)
    return (jkv, jsc, kv[:, sl].contiguous(), scales[:, sl].contiguous())


def _merge(parts, d):
    """The online-softmax merge of capacity shards, in f64: out =
    sum acc exp(m - M) / sum l exp(m - M)."""
    accs = [np.asarray(p[..., :d], np.float64) for p in parts]
    ms = [np.asarray(p[..., d], np.float64) for p in parts]
    ls = [np.asarray(p[..., d + 1], np.float64) for p in parts]
    m_g = np.maximum.reduce(ms)
    w = [np.exp(m - m_g) for m in ms]
    num = sum(a * wi[..., None] for a, wi in zip(accs, w))
    den = sum(li * wi for li, wi in zip(ls, w))
    return num / np.maximum(den, 1e-30)[..., None]


# -- partials -----------------------------------------------------------------

@pytest.mark.parametrize("q_bf16", [False, True])
def test_partials_plain_matches_flash_decode_flat(q_bf16):
    """Per capacity shard (two of 64 rows), the plain partials against
    flash_decode_flat(partials=True, group 2, block 64): m and l within
    f32 roundings, acc within 1e-5 of max |acc| (q_bf16 off) or one bf16
    step of each element (on), on every (sequence, head) with a token in
    the shard; a shard with no token of a sequence emits acc 0, m -1e30
    and l 0 (the reference's acc and l differ there: its masked keys take
    exp(0)), so those rows are compared after the merge, which weighs them
    by 0: the port's merged shards against the unsharded kernel at the
    merge's rtol 2e-5 (q_bf16 off), or against the reference's merged
    shards within one bf16 step of each shard's acc (on: each shard
    rounded its acc, and the unsharded kernel rounds its output
    instead)."""
    q, jc, kv, scales = _int8_cache(41)
    half = CAP // 2
    ports, refs = [], []
    for s in range(2):
        jkv, jsc, pkv, psc = _shard(jc, kv, scales, s, half)
        lens = np.clip(LENS - s * half, 0, half).astype(np.int32)
        ref = np.asarray(flash_decode_flat(
            jnp.asarray(q), jkv, jnp.asarray(lens), KVH, block_k=64,
            group=2, kv_scales=jsc, q_bf16=q_bf16, partials=True))
        out = at.decode_attn_int8_partials(_t(q), pkv, psc, _t(lens),
                                           q_bf16=q_bf16)
        assert out.dtype == torch.float32 and out.shape == (B, H, D + 2)
        out = out.numpy()
        live = lens > 0
        assert (out[~live, :, :D] == 0).all() and (out[~live, :, D + 1]
                                                    == 0).all()
        assert (out[~live, :, D] == -1e30).all()
        o, r = out[live], ref[live]
        np.testing.assert_allclose(o[..., D], r[..., D], rtol=1e-6)
        np.testing.assert_allclose(o[..., D + 1], r[..., D + 1], rtol=1e-5)
        err = np.abs(o[..., :D] - r[..., :D])
        if q_bf16:
            assert (err <= BF16_STEP * np.abs(r[..., :D])).all()
        else:
            assert err.max() <= REL_TOL * np.abs(r[..., :D]).max()
        ports.append(out)
        refs.append(ref)
    got = _merge(ports, D)
    if q_bf16:
        want = _merge(refs, D)
        mags = [np.concatenate([np.abs(p[..., :D]), p[..., D:]], axis=-1)
                for p in refs]
        bound = BF16_STEP * _merge(mags, D) + 1e-6 * np.abs(want).max()
        assert (np.abs(got - want) <= bound).all()
    else:
        full = np.asarray(flash_decode_flat(
            jnp.asarray(q), jc.kv[0], jnp.asarray(LENS), KVH, block_k=64,
            group=2, kv_scales=jc.quant_scales[0]))
        np.testing.assert_allclose(got, full, rtol=MERGE_RTOL,
                                   atol=1e-6 * np.abs(full).max())


def _partials_walk(q, kv, scales, lengths, plan, q_bf16):
    """decode_attn_int8_partials as the KV-group kernel computes it at
    ``plan`` (its partials modes): q rounded to bf16 as it enters with
    ``q_bf16``; each block of up to 8 query heads of a KV head walks its
    chunks (``kv_group_chunks`` over min(max(lengths, 0), cap), whole
    16-row units) a 64-row int8 ring tile at a time, each row group of
    warps taking every n_rg-th step of 4 rows, scores ((q . k8) * scale) *
    k_scale and p * v_scale weighing V; the warps' and then the splits'
    (m, l, acc) merge as the cluster merges them (m = -inf weighs 0), and
    the emit writes the unnormalized acc (rounded to bf16 with ``q_bf16``),
    m (-1e30 where no row was live) and l."""
    b, h, d = q.shape
    cap, kvh = kv.shape[1], kv.shape[3] // d
    rep, per = h // kvh, plan["heads_per_warp"] * plan["head_groups"]
    n_rg = plan["warps"] // plan["head_groups"]
    tile = _tile_rows(d, 1)
    scale = 1.0 / math.sqrt(d)
    x = kv.reshape(b, cap, 2, kvh, d).to(torch.float32)
    sf = scales.to(torch.float32)
    qq = q.to(torch.bfloat16).to(torch.float32) if q_bf16 else q
    out = torch.zeros((b, h, d + 2))
    for bi in range(b):
        n = min(max(int(lengths[bi]), 0), cap)
        for kh in range(kvh):
            k, v = x[bi, :, 0, kh], x[bi, :, 1, kh]
            ks, vs = sf[bi, :, 0, kh], sf[bi, :, 1, kh]
            for r0 in range(0, rep, per):
                heads = range(r0, min(r0 + per, rep))
                qr = torch.stack([qq[bi, kh * rep + r] for r in heads])
                lim = torch.full((len(heads),), n)
                states = []
                for c0, c1 in at.kv_group_chunks(n, plan["splits"],
                                                 plan["unit"]):
                    tiles = [range(t0, min(t0 + tile, c1))
                             for t0 in range(c0, c1, tile)]
                    states.append(_merge_states([_warp_walk(
                        qr, k, v, ks, vs,
                        [[t for t in tr if ((t - tr[0]) // 4) % n_rg == rg]
                         for tr in tiles], lim, scale, False)
                        for rg in range(n_rg)]))
                m, l, acc = _merge_states(states)
                if q_bf16:
                    acc = acc.to(torch.bfloat16).to(torch.float32)
                m = torch.where(m == -math.inf, torch.full_like(m, -1e30), m)
                for j, r in enumerate(heads):
                    out[bi, kh * rep + r] = torch.cat(
                        [acc[j], m[j:j + 1], l[j:j + 1]])
    return out


# (heads, KV heads, capacity; the timed shape whose rows_plan the walk
# takes: B, capacity) at head_dim 64: GPT-2's 12 heads (path (B)'s plan at
# B 256, capacity 512: one split of 4 warps, one head a warp) and
# TinyLlama's 32 over 4 (its plan at B 16, capacity 2048: 4 splits of 8
# warps, 8 heads a block).
PARTIALS_WALKS = [(12, 12, 128, 256, 512), (32, 4, 256, 16, 2048)]


@pytest.mark.parametrize("q_bf16", [False, True])
@pytest.mark.parametrize("h,kvh,cap,plan_b,plan_cap", PARTIALS_WALKS,
                         ids=str)
def test_partials_walk_on_the_kv_group_kernel_matches_flash_decode_flat(
        h, kvh, cap, plan_b, plan_cap, q_bf16):
    """The partials mode's design, the KV-group walk at rows_plan's launch
    of each timed shape (chunks of whole units, the splits merged as the
    cluster merges them, the unnormalized state emitted), redone in torch
    against flash_decode_flat(partials=True, group 2, block 64) on one
    int8 cache: m within 1e-6 of its own size plus 1e-6 of the largest
    |m| (a score of 0.05 sums terms of order 1 in another order at head_dim
    64), l within 1e-5 relative, acc within 1e-5 of max |acc|
    (q_bf16 off) or one bf16 step of each element (on), on every
    (sequence, head) with a row; a sequence of length 0 emits acc 0, m
    -1e30 (the reference's m there too) and l 0. The plain version at the
    same inputs agrees with the walk the same way."""
    b, d = 4, 64
    plan = at.rows_plan(plan_b, h, kvh, plan_cap, d)
    want = ((1, 4, 1, 1) if h == kvh else (4, 8, 4, 2))
    assert (plan["splits"], plan["warps"], plan["heads_per_warp"],
            plan["head_groups"]) == want
    rng = np.random.default_rng(h + cap)
    jc = JKVCache.create(b, 1, kvh, cap, d, quantized=True)
    rows = [(rng.standard_normal((b, kvh, cap, d))
             * np.exp(rng.uniform(-1, 1, (b, kvh, 1, 1)))).astype(np.float32)
            for _ in range(2)]
    jc = jc.append(0, jnp.asarray(rows[0]), jnp.asarray(rows[1]), position=0)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kv, scales = port_layout(jc, 0)
    lens = np.array([0, 1, cap // 3 + 5, cap], np.int32)
    ref = np.asarray(flash_decode_flat(
        jnp.asarray(q), jc.kv[0], jnp.asarray(lens), kvh, block_k=64,
        group=2, kv_scales=jc.quant_scales[0], q_bf16=q_bf16, partials=True))
    walk = _partials_walk(_t(q), kv, scales, _t(lens), plan, q_bf16)
    plain = at.decode_attn_int8_partials(_t(q), kv, scales, _t(lens),
                                         q_bf16=q_bf16)
    for out in (walk.numpy(), plain.numpy()):
        assert out.shape == (b, h, d + 2)
        assert (out[0, :, :d] == 0).all() and (out[0, :, d + 1] == 0).all()
        assert (out[0, :, d] == -1e30).all() and (ref[0, :, d] == -1e30).all()
        o, r = out[1:], ref[1:]
        np.testing.assert_allclose(o[..., d], r[..., d], rtol=1e-6,
                                   atol=1e-6 * np.abs(r[..., d]).max())
        np.testing.assert_allclose(o[..., d + 1], r[..., d + 1], rtol=1e-5)
        err = np.abs(o[..., :d] - r[..., :d])
        if q_bf16:
            assert (err <= BF16_STEP * np.abs(r[..., :d])).all()
        else:
            assert err.max() <= REL_TOL * np.abs(r[..., :d]).max()


@pytest.mark.parametrize("b,cap", [(3, 128), (4, 96)])
def test_partials_raises_where_the_reference_raises(b, cap):
    """No group (batch 3) or a capacity the block does not divide (96):
    flash_decode_flat(partials=True) raises, and so does the port."""
    q, jc, kv, scales = _int8_cache(43, b=b, cap=cap)
    lens = np.ones(b, np.int32)
    with pytest.raises(ValueError, match="partials"):
        flash_decode_flat(jnp.asarray(q), jc.kv[0], jnp.asarray(lens), KVH,
                          block_k=64, group=2, kv_scales=jc.quant_scales[0],
                          partials=True)
    with pytest.raises(ValueError, match="unsupported|no flat group"):
        at.decode_attn_int8_partials(_t(q), kv, scales, _t(lens))


# -- K9 against flash_decode --------------------------------------------------

@pytest.mark.parametrize("s,d,kernel", [(512, 128, True), (200, 64, False)])
def test_split_kv_plain_matches_flash_decode(s, d, kernel):
    """K9 against flash_decode (block 256, GQA 2:1, f32): at S 512 and
    d 128 the reference runs its kernel, at S 200 and d 64 its
    _attn_reference; lengths 0 (zeros from the kernel, the mean of V from
    the plain path), 1, S and past S."""
    rng = np.random.default_rng(s + d)
    b, h, kvh = 4, 4, 2
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, kvh, s, d)).astype(np.float32)
    v = rng.standard_normal((b, kvh, s, d)).astype(np.float32)
    lengths = np.array([0, 1, s, s + 7], np.int32)
    assert at.split_kv_takes_kernel(s, d) == kernel
    ref = np.asarray(flash_decode(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(lengths)))
    out = at.decode_attn_split_kv(_t(q), _t(k), _t(v), _t(lengths))
    _close(out, ref)
    if kernel:
        assert (out[0] == 0).all()
    else:
        mean = v[0].mean(axis=1).repeat(h // kvh, axis=0)
        np.testing.assert_allclose(out[0].numpy(), mean, rtol=0, atol=1e-5)


def _planes_walk(q, k, v, lengths, plan):
    """K9 as the KV-group kernel computes it at ``plan``: the ``Planes``
    addressing reads row t of sequence b and KV head kh at element (b * KVH
    * S + t + kh * S) * D of the flat K plane and of the flat V plane;
    each block of up to 8 (4 above head_dim 128) query heads of a KV head
    walks its chunks (``kv_group_chunks`` over min(max(lengths, 0), S))
    a ring tile at a time, each row group of warps taking every n_rg-th
    step of 4 rows; the warps' and then the splits' (m, l, acc) merge with
    m = -inf weighing 0, and out = acc / max(l, 1e-30)."""
    b, h, d = q.shape
    kvh, s = k.shape[1], k.shape[2]
    rep, per = h // kvh, plan["heads_per_warp"] * plan["head_groups"]
    n_rg = plan["warps"] // plan["head_groups"]
    tile = _tile_rows(d, k.element_size())
    scale = 1.0 / math.sqrt(d)
    kf, vf = (x.reshape(-1).to(torch.float32) for x in (k, v))
    cols = torch.arange(d)
    out = torch.zeros_like(q)
    for bi in range(b):
        n = min(max(int(lengths[bi]), 0), s)
        for kh in range(kvh):
            rows = (bi * kvh * s + torch.arange(n) + kh * s) * d
            kk, vv = kf[rows[:, None] + cols], vf[rows[:, None] + cols]
            for r0 in range(0, rep, per):
                heads = range(r0, min(r0 + per, rep))
                qr = torch.stack([q[bi, kh * rep + r] for r in heads])
                lim = torch.full((len(heads),), n)
                states = []
                for c0, c1 in at.kv_group_chunks(n, plan["splits"],
                                                 plan["unit"]):
                    tiles = [range(t0, min(t0 + tile, c1))
                             for t0 in range(c0, c1, tile)]
                    states.append(_merge_states([_warp_walk(
                        qr, kk, vv, None, None,
                        [[t for t in tr if ((t - tr[0]) // 4) % n_rg == rg]
                         for tr in tiles], lim, scale, False)
                        for rg in range(n_rg)]))
                _, l, acc = _merge_states(states)
                o = acc / torch.clamp(l, min=1e-30)[:, None]
                for j, r in enumerate(heads):
                    out[bi, kh * rep + r] = o[j]
    return out


# (head_dim, S, splits, warps; None: the plan's) of K9's walk. GQA 4:1 at
# B 4 and S 512: the plan takes 8 splits of 8 warps; also 2 splits of 4
# warps and one unsplit launch.
PLANES_CASES = [(128, 512, None, None), (256, 512, None, None),
                (128, 512, 2, 4), (256, 256, 1, 8)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,s,splits,warps", PLANES_CASES, ids=str)
def test_split_kv_walk_over_planes_matches_flash_decode(d, s, splits, warps,
                                                        dtype):
    """K9's design at rows_plan (and at other splits and warps) over f32
    and bf16 planes matches flash_decode (block 256, GQA 4:1) within 1e-5
    of max |out|, lengths 0 (zeros), 1, S/3 and past S; the plain version
    too."""
    rng = np.random.default_rng(1200 + d + s + (splits or 0))
    b, h, kvh = 4, 8, 2
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    jk, jv = (jnp.asarray(rng.standard_normal((b, kvh, s, d)), jdt)
              for _ in range(2))
    lengths = np.array([0, 1, s // 3, s + 7], np.int32)
    assert at.split_kv_takes_kernel(s, d)
    ref = np.asarray(flash_decode(jnp.asarray(q), jk, jv,
                                  jnp.asarray(lengths)))
    k, v = (_t(np.asarray(x.astype(jnp.float32))).to(getattr(torch, dtype))
            for x in (jk, jv))
    plan = at.rows_plan(b, h, kvh, s, d, splits, warps)
    if splits is None:
        assert (plan["splits"], plan["warps"]) == (8, 8)
    out = _planes_walk(_t(q), k, v, _t(lengths), plan)
    _close(out, ref)
    assert (out[0] == 0).all()
    _close(at.decode_attn_split_kv(_t(q), k, v, _t(lengths)), ref)


# -- native_dots and pv_int8 against flash_decode_grouped ---------------------

@pytest.mark.parametrize("b", [B, 3])
def test_native_dots_plain_matches_flash_decode_grouped(b):
    """decode_attn_native_dots against flash_decode_grouped(native_dots,
    group 2, block 64) on a bf16 cache (q and p round to bf16), and at
    batch 3, where the reference drops the mode for its fused kernel."""
    rng = np.random.default_rng(13 + b)
    q = rng.standard_normal((b, H, D)).astype(np.float32)
    jkv = jnp.asarray(rng.standard_normal((b, CAP, 2, KVH * D)),
                      jnp.bfloat16)
    lens = np.resize(LENS, b)
    ref = flash_decode_grouped(jnp.asarray(q), jkv, jnp.asarray(lens), KVH,
                               block_k=64, group=2, native_dots=True)
    pkv = _t(np.asarray(jkv.astype(jnp.float32))).to(torch.bfloat16)
    out = at.decode_attn_native_dots(_t(q), pkv, _t(lens), block_k=64,
                                     group=2)
    _close(out, ref)
    k6 = at.decode_attn_float(_t(q), pkv, _t(lens))
    same = torch.equal(out, k6)
    assert same == (b == 3)          # the mode rounds unless dropped


@pytest.mark.parametrize("b,int8_scores", [(B, False), (B, True), (3, True)])
def test_pv_int8_plain_matches_flash_decode_grouped(b, int8_scores):
    """decode_attn_grouped_int8(pv_int8=True) against
    flash_decode_grouped(pv_int8=True, group 2, block 64) with exact q and
    with int8 scores, and at batch 3, where the reference drops both modes
    for its exact fused kernel (the port's G2)."""
    q, jc, kv, scales = _int8_cache(17 + b, b=b)
    lens = np.resize(LENS, b)
    ref = flash_decode_grouped(jnp.asarray(q), jc.kv[0], jnp.asarray(lens),
                               KVH, block_k=64, group=2,
                               kv_scales=jc.quant_scales[0],
                               int8_scores=int8_scores, pv_int8=True)
    out = at.decode_attn_grouped_int8(_t(q), kv, scales, _t(lens),
                                      int8_scores=int8_scores,
                                      pv_int8=True, block_k=64, group=2)
    _close(out, ref)
    fused = at.decode_attn_fused_int8(_t(q), kv, scales, _t(lens))
    assert torch.equal(out, fused) == (b == 3)


# -- M1 against matmul_int8_pallas --------------------------------------------

@pytest.mark.parametrize("m,k,n,x_scale,blocks", [
    (50, 130, 140, 0.07, {}),
    (300, 1100, 520, 1.0, dict(block_m=128, block_n=256, block_k=256))])
def test_matmul_int8_tiled_plain_bit_exact(m, k, n, x_scale, blocks):
    """The plain M1 equals matmul_int8_pallas bit for bit at
    tests/test_quantized.py's shapes (any M, N, K; the reference pads them
    to its tiles), and the int32 sums equal an int64 product."""
    rng = np.random.default_rng(m)
    x = rng.integers(-127, 128, (m, k)).astype(np.int8)
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    ws = (np.abs(rng.standard_normal(n)) + 0.01).astype(np.float32)
    ref = np.asarray(jgemm.matmul_int8_pallas(
        jnp.asarray(x), jnp.asarray(w), x_scale, jnp.asarray(ws), **blocks))
    out = pg.matmul_int8_tiled(_t(x), _t(w), x_scale, _t(ws))
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), ref)
    acc = x.astype(np.int64) @ w.astype(np.int64)
    want = (acc.astype(np.float32) * np.float32(x_scale)) * ws[None, :]
    np.testing.assert_array_equal(out.numpy(), want)
