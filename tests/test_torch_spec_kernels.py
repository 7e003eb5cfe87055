"""Parity of the speculative path's cache and attention pieces
(``rten_tpu_torch`` on the CPU, where the kernels' plain versions run)
against the JAX package (CPU backend, Pallas in interpret mode), on inputs
drawn with numpy: ``verify_attn_grouped`` and ``verify_attn_fused`` (V1)
against ``flash_verify_grouped`` and ``flash_verify_fused`` on float and
int8 caches, V1's arithmetic on the KV-group kernel (splits, warps, tiles,
per-row causal limits) redone in torch against the same reference, and
the chunked append at per-sequence depths against the reference's
``KVCache.append``."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rten_tpu.generate.kv_cache import KVCache as JKVCache
from rten_tpu.kernels.attention import (flash_verify_fused,
                                        flash_verify_grouped)
from rten_tpu_torch.generate.kv_cache import KVCache
from rten_tpu_torch.kernels import attention as at
from test_torch_kernels import port_layout

KVH, D = 2, 64
# A capacity that both reference kernels' blocks divide (grouped 64, fused
# 128), so their Pallas bodies run instead of the jnp fallback.
CAP = 128
# Float mode: both sum in f32 in other orders (an online softmax over
# blocks against the plain two-pass softmax): 1e-5 of max |out|, K6's.
FLOAT_REL_TOL = 1e-5
# Int8 mode: the int8 bytes and bf16 scales are exact in f32 and nothing is
# rounded to bf16, so the same f32 order argument holds: K6's 1e-5 is kept
# (the largest gap over these cases is 2.2e-7 of max |out| in float mode
# and 1.9e-7 in int8 mode).
INT8_REL_TOL = 1e-5

JDTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _t(a):
    return torch.from_numpy(np.array(a))


def _lengths(b, s):
    """Pre-chunk lengths that straddle 4-token boundaries, with one
    sequence whose chunk ends at the capacity."""
    return np.resize(np.array([0, 3, 4, 5, 37, CAP - s, 61, 64], np.int32),
                     b)


def _int8_cache(rng, b):
    """A reference int8 cache (token-packed rows, pair-packed scales) over
    the whole capacity, and the same values in the port's layout."""
    jc = JKVCache.create(b, 1, KVH, CAP, D, quantized=True)
    pre = [rng.standard_normal((b, KVH, CAP, D)).astype(np.float32)
           for _ in range(2)]
    jc = jc.append(0, jnp.asarray(pre[0]), jnp.asarray(pre[1]), position=0)
    kv, scales = port_layout(jc, 0)
    return jc.kv[0], jc.quant_scales[0], kv, scales


# (entry, batch, group): groups 4 and 2 for the grouped kernel, the batches
# with no group (3 and 1) for the fused one.
ENTRIES = [("grouped", 8, 4), ("grouped", 8, 2), ("fused", 3, 0),
           ("fused", 1, 0)]


@pytest.mark.parametrize("s", [1, 2, 4])
@pytest.mark.parametrize("mode", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("entry,b,group", ENTRIES)
def test_verify_attn_plain_matches_reference(entry, b, group, mode, s):
    """V1's plain versions against flash_verify_grouped (groups 4 and 2)
    and flash_verify_fused (batches 3 and 1) with GQA (4 query heads on 2
    kv heads), S 1, 2 and 4, ragged lengths, on f32, bf16 and int8
    caches."""
    rng = np.random.default_rng(100 + 10 * b + s + 3 * group)
    h = 4
    q = rng.standard_normal((b, s, h, D)).astype(np.float32)
    lengths = _lengths(b, s)
    if mode == "int8":
        jkv, jscales, kv, scales = _int8_cache(rng, b)
    else:
        raw = rng.standard_normal((b, CAP, 2, KVH * D)).astype(np.float32)
        jkv, jscales = jnp.asarray(raw, JDTYPES[mode]), None
        kv = _t(np.asarray(jkv.astype(jnp.float32))).to(TDTYPES[mode])
        scales = None
    if entry == "grouped":
        ref = flash_verify_grouped(jnp.asarray(q), jkv, jnp.asarray(lengths),
                                   KVH, group=group, kv_scales=jscales)
        wrapper = at.verify_attn_grouped
    else:
        ref = flash_verify_fused(jnp.asarray(q), jkv, jnp.asarray(lengths),
                                 KVH, kv_scales=jscales)
        wrapper = at.verify_attn_fused
    ref = np.asarray(ref)
    before = wrapper.launches
    out = wrapper(_t(q), kv, _t(lengths), scales)
    assert wrapper.launches == before             # the plain version ran
    assert out.shape == (b, s, h, D) and out.dtype == torch.float32
    tol = (INT8_REL_TOL if mode == "int8" else FLOAT_REL_TOL)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=tol * np.abs(ref).max())


def test_verify_attn_is_causal_within_the_chunk():
    """Query i reads rows below lengths + i + 1: a row written past it
    changes only the later queries' outputs."""
    rng = np.random.default_rng(7)
    b, s, h = 2, 4, 4
    q = _t(rng.standard_normal((b, s, h, D)).astype(np.float32))
    kv = _t(rng.standard_normal((b, CAP, 2, KVH * D)).astype(np.float32))
    lengths = _t(np.array([5, 20], np.int32))
    out = at.verify_attn_fused(q, kv, lengths)
    kv2 = kv.clone()
    kv2[:, 7] += 1.0                     # row 7: query 2 of sequence 0 on
    out2 = at.verify_attn_fused(q, kv2, lengths)
    assert torch.equal(out[0, :2], out2[0, :2])
    assert not torch.equal(out[0, 2:], out2[0, 2:])
    assert not torch.equal(out[1], out2[1])


@pytest.mark.parametrize("wrapper", [at.verify_attn_grouped,
                                     at.verify_attn_fused])
def test_verify_wrappers_never_fall_back_off_the_cpu(wrapper):
    """The plain version runs only for CPU tensors: meta tensors (another
    device) or mixed devices raise, in both modes; S above 8 raises."""
    b, s = 2, 3
    q = torch.zeros((b, s, 4, D))
    lengths = torch.ones(b, dtype=torch.int32)
    for kv, scales in (
            (torch.zeros((b, CAP, 2, KVH * D)), None),
            (torch.zeros((b, CAP, 2, KVH * D), dtype=torch.int8),
             torch.ones((b, CAP, 2, KVH), dtype=torch.bfloat16))):
        args = [q, kv, lengths] + ([] if scales is None else [scales])
        before = wrapper.launches
        wrapper(*args)
        assert wrapper.launches == before
        with pytest.raises(ValueError):
            wrapper(*[a.to("meta") for a in args])
        with pytest.raises(ValueError):
            wrapper(*([args[0].to("meta")] + args[1:]))
    with pytest.raises(ValueError, match="S=9"):
        wrapper(torch.zeros((b, 9, 4, D)), torch.zeros((b, CAP, 2, KVH * D)),
                lengths)


# -- V1 on the KV-group kernel: its arithmetic redone in torch --------------
# The kernel (csrc/decode_attn_kv_group.cuh over ChunkRows) serves the S x
# rep query rows (query i, head h; row i * rep + h) of a KV head in blocks
# of heads_per_warp x head_groups rows; a sequence's rows [0, min(len + S,
# cap)) split into the chunks of kv_group_chunks (16-row units); a split
# walks its chunk a ring tile at a time, and within a tile warp rg of a row
# group takes the rows r with (r // 4) % (warps / head_groups) == rg. Each
# warp keeps an online softmax per query row: the tile's max, one rescale
# where it grew, p = exp(s - m) with row t past query i's limit min(len + i
# + 1, cap) scored -inf, and p taken as 0 while m is still -inf. The warps'
# and then the splits' states merge, a state with m = -inf weighing 0. The
# helpers below redo that on the CPU so that the split design is held
# against the reference here; the card tests hold the kernel to the plain
# version.

def _tile_rows(d, elt):
    """decode_attn_kv_group.cuh's tile_rows: the rows of a ring stage."""
    if elt == 1:
        return 64 if d <= 128 else 32
    rows = (32 if elt == 4 else 64) * 64 // (1 << (d - 1).bit_length())
    return max(rows, 16)


def _merge(states):
    """States (m [R], l [R], acc [R, D]) merged; m = -inf weighs 0."""
    m = torch.stack([st[0] for st in states])
    mx = m.amax(dim=0)
    w = torch.where(mx == -math.inf, torch.zeros_like(m), torch.exp(m - mx))
    l = (w * torch.stack([st[1] for st in states])).sum(dim=0)
    acc = (w[..., None] * torch.stack([st[2] for st in states])).sum(dim=0)
    return mx, l, acc


def _warp_walk(qr, k, v, ks, vs, t_rows, lim, scale, guard):
    """One warp's online softmax over its rows of one chunk, tile by tile
    (``t_rows``: the row indices of each tile it takes)."""
    r = qr.shape[0]
    m = torch.full((r,), -math.inf)
    l = torch.zeros(r)
    acc = torch.zeros_like(qr)
    for rows in t_rows:
        if not rows:
            continue
        t = torch.tensor(rows)
        sc = (qr @ k[t].T) * scale
        if ks is not None:
            sc = sc * ks[t]
        sc = sc.masked_fill(t[None, :] >= lim[:, None], -math.inf)
        mx = sc.amax(dim=1)
        grow = mx > m
        alpha = torch.where(grow, torch.exp(m - mx), torch.ones_like(m))
        m = torch.where(grow, mx, m)
        p = torch.exp(sc - m[:, None])
        if guard:
            p = torch.where((m == -math.inf)[:, None], torch.zeros_like(p), p)
        l = l * alpha + p.sum(dim=1)
        if vs is not None:
            p = p * vs[t]
        acc = acc * alpha[:, None] + p @ v[t]
    return m, l, acc


def _kv_group_verify(q, kv, lengths, scales, plan, guard=True):
    """V1's output as the KV-group kernel computes it at ``plan``."""
    b, s, h, d = q.shape
    cap, kvh = kv.shape[1], kv.shape[3] // d
    rep, per = h // kvh, plan["heads_per_warp"] * plan["head_groups"]
    n_rg = plan["warps"] // plan["head_groups"]
    tile = _tile_rows(d, kv.element_size())
    scale = 1.0 / math.sqrt(d)
    x = kv.reshape(b, cap, 2, kvh, d).to(torch.float32)
    sf = None if scales is None else scales.to(torch.float32)
    out = torch.zeros_like(q)
    for bi in range(b):
        live = max(int(lengths[bi]), 0)
        n = min(live + s, cap)
        for kh in range(kvh):
            k, v = x[bi, :, 0, kh], x[bi, :, 1, kh]
            ks = None if sf is None else sf[bi, :, 0, kh]
            vs = None if sf is None else sf[bi, :, 1, kh]
            for r0 in range(0, s * rep, per):
                rows = range(r0, min(r0 + per, s * rep))
                qr = torch.stack([q[bi, r // rep, kh * rep + r % rep]
                                  for r in rows])
                lim = torch.tensor([min(live + r // rep + 1, cap)
                                    for r in rows])
                splits = []
                for c0, c1 in at.kv_group_chunks(n, plan["splits"],
                                                 plan["unit"]):
                    tiles = [range(t0, min(t0 + tile, c1))
                             for t0 in range(c0, c1, tile)]
                    splits.append(_merge([_warp_walk(
                        qr, k, v, ks, vs,
                        [[t for t in tr if ((t - tr[0]) // 4) % n_rg == rg]
                         for tr in tiles], lim, scale, guard)
                        for rg in range(n_rg)]))
                _, l, acc = _merge(splits)
                o = acc / torch.clamp(l, min=1e-30)[:, None]
                for j, r in enumerate(rows):
                    out[bi, r // rep, kh * rep + r % rep] = o[j]
    return out


# (entry, batch, group, heads, S, pre-chunk lengths, splits, warps; None:
# the plan's): a length 0 at S 1 (the plan's 8 splits, seven of them
# empty); S 8 over 2 KV heads of 4 query heads (blocks of 8 rows: queries
# 0-1 and 2-3 ... apart) with a sequence of 12 rows before its chunk in 2
# splits, the second (rows 16-19) past every query of the first block, and
# a chunk ending at the capacity; the plan's launch at (G)'s S 4; 8 splits
# of 8 warps over short and long sequences.
SPLIT_CASES = [
    ("fused", 1, 0, 4, 1, [0], None, None),
    ("fused", 3, 0, 8, 8, [12, 0, CAP - 8], 2, 4),
    ("grouped", 8, 4, 4, 4, None, None, None),
    ("grouped", 8, 2, 8, 8, [12, 12, 3, 60, CAP - 8, 0, 30, 31], 8, 8),
]


def _split_case(entry, b, group, h, s, lens, mode, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, D)).astype(np.float32)
    lengths = np.asarray(lens if lens else _lengths(b, s), np.int32)
    if mode == "int8":
        jkv, jscales, kv, scales = _int8_cache(rng, b)
    else:
        raw = rng.standard_normal((b, CAP, 2, KVH * D)).astype(np.float32)
        jkv, jscales = jnp.asarray(raw, JDTYPES[mode]), None
        kv = _t(np.asarray(jkv.astype(jnp.float32))).to(TDTYPES[mode])
        scales = None
    if entry == "grouped":
        ref = flash_verify_grouped(jnp.asarray(q), jkv, jnp.asarray(lengths),
                                   KVH, group=group, kv_scales=jscales)
    else:
        ref = flash_verify_fused(jnp.asarray(q), jkv, jnp.asarray(lengths),
                                 KVH, kv_scales=jscales)
    return _t(q), kv, _t(lengths), scales, np.asarray(ref)


@pytest.mark.parametrize("mode", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("case", SPLIT_CASES, ids=str)
def test_kv_group_verify_arithmetic_matches_reference(case, mode):
    """V1's split design (chunks of verify_plan, warps, ring tiles, per-row
    limits, merges with m = -inf weighing 0) against flash_verify_grouped
    and flash_verify_fused, within the plain version's 1e-5 of max |out|;
    a query row with no live row in a split or a warp gets no weight, and a
    sequence's outputs stay finite."""
    entry, b, group, h, s, lens, splits, warps = case
    q, kv, lengths, scales, ref = _split_case(entry, b, group, h, s, lens,
                                              mode, 300 + b + s)
    plan = at.verify_plan(b, s, h, KVH, CAP, D, splits, warps)
    out = _kv_group_verify(q, kv, lengths, scales, plan)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=FLOAT_REL_TOL * np.abs(ref).max())


def test_kv_group_verify_needs_its_minus_inf_guard():
    """Without the guard (p = 0 while a query row's m is -inf) a warp whose
    first rows lie past a query's limit gives exp(-inf + inf) = NaN: the
    case with a split past every query of a block turns NaN, so the guard
    is needed and the test above can fail."""
    entry, b, group, h, s, lens, splits, warps = SPLIT_CASES[1]
    q, kv, lengths, scales, _ = _split_case(entry, b, group, h, s, lens,
                                            "float32", 300 + b + s)
    plan = at.verify_plan(b, s, h, KVH, CAP, D, splits, warps)
    assert torch.isfinite(_kv_group_verify(q, kv, lengths, scales,
                                           plan)).all()
    out = _kv_group_verify(q, kv, lengths, scales, plan, guard=False)
    assert torch.isnan(out[0]).any()


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("t", [2, 4, 5])
def test_chunked_append_bit_exact_against_reference(kind, t):
    """A chunk of T tokens appended at per-sequence depths equals the
    reference's ``KVCache.append(position=None)`` bit for bit (f32, bf16
    and int8 caches; int8 read back through the port's layout), with one
    sequence at cap - T + 1 and one past capacity, where the start clamps
    to cap - T, and depths that straddle 4-token rows."""
    rng = np.random.default_rng(200 + t)
    b = 6
    quant = kind == "int8"
    dtype = None if quant else JDTYPES[kind]
    kw = dict(quantized=True) if quant else dict(dtype=dtype)
    jc = JKVCache.create(b, 1, KVH, CAP, D, **kw)
    pc = KVCache.create(b, 1, KVH, CAP, D, quantized=quant,
                        dtype=torch.float32 if quant else TDTYPES[kind],
                        device="cpu")
    pre = [rng.standard_normal((b, KVH, CAP, D)).astype(np.float32)
           for _ in range(2)]
    jc = jc.append(0, jnp.asarray(pre[0]), jnp.asarray(pre[1]), position=0)
    pc = pc.append(0, _t(pre[0]), _t(pre[1]), position=0)
    lengths = np.array([0, 3, 6, 37, CAP - t + 1, CAP + 5], np.int32)
    jc = jc.with_lengths(jnp.asarray(lengths))
    pc = pc.with_lengths(lengths)
    k, v = (rng.standard_normal((b, KVH, t, D)).astype(np.float32)
            * np.exp(rng.uniform(-3, 3, (b, KVH, t, 1))).astype(np.float32)
            for _ in range(2))
    k[1, 0, 0] = 0.0                     # an all-zero head: scale 1.0
    jc = jc.append(0, jnp.asarray(k), jnp.asarray(v))
    pc = pc.append(0, _t(k), _t(v))
    if quant:
        ref_kv, ref_scales = port_layout(jc, 0)
        assert torch.equal(pc.kv[0], ref_kv)
        assert torch.equal(pc.scales[0], ref_scales)
    else:
        ref = np.asarray(jc.kv[0].astype(jnp.float32))
        np.testing.assert_array_equal(pc.kv[0].float().numpy(), ref)
    np.testing.assert_array_equal(pc.lengths.numpy(), lengths)
