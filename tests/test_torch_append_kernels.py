"""The arithmetic of the float decode kernels on the KV-group kernel and of
the int8 decode appends, redone in torch on the CPU and held against the
JAX package (CPU backend, Pallas in interpret mode), on inputs drawn with
numpy:

* A1 (``decode_attn_grouped_append``) on the KV-group kernel: the cache
  write of split 0 of each (sequence, KV head), row n - 1 staged from the
  new row rounded to the cache dtype (never read from the cache), the
  chunks of ``rows_plan``, warps and ring tiles, and the splits' (m, l,
  acc) merged with m = -inf weighing 0, against
  ``flash_decode_grouped_append`` on f32 and bf16 caches;
* K6 (``decode_attn_float``) on the KV-group kernel in its exact mode: the
  same walk without the write, against ``flash_decode_grouped``,
  ``flash_decode_fused`` and ``flash_decode_stream`` on f32 and bf16
  caches;
* K7 (``kv_append_int8``): its eight-lane quantizer (a lane's absmax over
  its values, then three shuffles within the row's eight lanes), in the
  wide and the narrow lane layouts, bit for bit against
  ``_quantize_tokens``;
* P2 (``kv_append_paged_int8``): K7's kernel through the page table (the
  length, then the table entry at its page, then the quantized row stored
  lane by lane), bit for bit against the reference's paged decode append
  (``_quantize_tokens``, then ``paged_append_quant``);
* K5 (``kv_append``) and P1 (``kv_append_paged``): the same kernel body
  with its float row policy (each lane's values packed into 32-bit words,
  bf16 by pairs, and stored in 16- or 8-byte stores, or value by value in
  the narrow layout), through a position or the page table, bit for bit
  against ``cache_append`` and ``paged_append``;
* K3 (``tail_flush_int8``): the same kernel body over the bf16 tail
  window's first t rows (16-byte loads of bf16, the length, the int8
  policy's quantizer, 8- or 16-byte word stores at the window's offset
  clip(lengths - t, 0, cap - t)), wide and narrow, head_dim 64, 128 and
  96, bit for bit against the reference's ``flush_tail`` and
  ``_quantize_tokens``.

The card tests (tests/test_torch_cuda.py) hold the kernels to their plain
versions; these hold the kernels' design to the reference."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rten_tpu.generate.kv_cache import KVCache as JKVCache
from rten_tpu.generate.kv_cache import _quantize_tokens
from rten_tpu.generate.paged_cache import PagedKVCache as JPagedKVCache
from rten_tpu.kernels.cache import cache_append, paged_append
from rten_tpu.kernels.attention import (flash_decode_fused,
                                        flash_decode_grouped,
                                        flash_decode_grouped_append,
                                        flash_decode_stream)
from rten_tpu_torch.kernels import attention as at
from rten_tpu_torch.kernels import cache as kc
from test_torch_kernels import port_layout
from test_torch_paged import _pools, _with
from test_torch_spec_kernels import _merge, _tile_rows, _warp_walk

# -- A1 on the KV-group kernel ------------------------------------------------

# GQA 4:1 at the reference's group 2 and block 64.
B, H, KVH, CAP = 4, 8, 2, 128
# Both sum in f32 in other orders (an online softmax over ring tiles,
# warps and splits against the reference's over 64-row blocks): 1e-5 of
# max |out|, the plain version's tolerance.
REL_TOL = 1e-5
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _kv_group_float(q, kv, lengths, plan, new=None):
    """K6 (``new`` None) or A1 (``new``: the new rows [B, 2, KVH*D] in the
    cache dtype) as the KV-group kernel computes them at ``plan``: each
    block of up to 8 query heads of a KV head walks its chunks
    (``kv_group_chunks``) a ring tile at a time, each row group of warps
    taking every n_rg-th step of 4 rows; the warps' and then the splits'
    (m, l, acc) merge with m = -inf weighing 0. Returns (out, the cache
    after A1's write; K6's is the cache given). A1's cache reads are the
    cache given: row n - 1 of each sequence comes from the new row, so the
    result cannot depend on the order of write and read."""
    b, h, d = q.shape
    cap, kvh = kv.shape[1], kv.shape[3] // d
    rep, per = h // kvh, plan["heads_per_warp"] * plan["head_groups"]
    n_rg = plan["warps"] // plan["head_groups"]
    tile = _tile_rows(d, kv.element_size())
    scale = 1.0 / math.sqrt(d)
    written = kv.clone()
    out = torch.zeros_like(q)
    for bi in range(b):
        n = min(max(int(lengths[bi]), 0), cap)
        pos = min(max(int(lengths[bi]) - 1, 0), cap - 1)
        rows = kv[bi].clone()
        if new is not None and n:
            rows[n - 1] = new[bi]          # staged from the new row
        x = rows.reshape(cap, 2, kvh, d).to(torch.float32)
        for kh in range(kvh):
            if new is not None:
                # Split 0 of the first head block writes the KV head's
                # slice.
                sl = slice(kh * d, (kh + 1) * d)
                written[bi, pos, :, sl] = new[bi, :, sl]
            kk, vv = x[:, 0, kh], x[:, 1, kh]
            for r0 in range(0, rep, per):
                heads = range(r0, min(r0 + per, rep))
                qr = torch.stack([q[bi, kh * rep + r] for r in heads])
                lim = torch.full((len(heads),), n)
                states = []
                for c0, c1 in at.kv_group_chunks(n, plan["splits"],
                                                 plan["unit"]):
                    tiles = [range(t0, min(t0 + tile, c1))
                             for t0 in range(c0, c1, tile)]
                    states.append(_merge([_warp_walk(
                        qr, kk, vv, None, None,
                        [[t for t in tr if ((t - tr[0]) // 4) % n_rg == rg]
                         for tr in tiles], lim, scale, False)
                        for rg in range(n_rg)]))
                _, l, acc = _merge(states)
                o = acc / torch.clamp(l, min=1e-30)[:, None]
                for j, r in enumerate(heads):
                    out[bi, kh * rep + r] = o[j]
    return out, written


def _kv_group_append(q, kv, k, v, lengths, plan):
    """A1 as the KV-group kernel computes it at ``plan``: returns (out, the
    cache after the write)."""
    b, kvh, _, d = k.shape
    new = torch.stack([k.reshape(b, kvh * d), v.reshape(b, kvh * d)],
                      dim=1).to(kv.dtype)                  # [B, 2, KVH*D]
    return _kv_group_float(q, kv, lengths, plan, new)


# (lengths counting the new token, head_dim, splits, warps; None: the
# plan's). The plan's launch at B 4 takes 8 splits of 16-row units, so a
# sequence of 45 rows leaves splits 3-7 without a row; a length 0 (row 0
# written, zeros out) and one past the capacity (the last row written and
# read); 3 splits of 4 warps, 1 of 8, and 2 and 5 splits at head_dim 64.
APPEND_CASES = [
    ([0, CAP + 5, 45, CAP - 3], 128, None, None),
    ([1, 17, CAP, 64], 128, 3, 4),
    ([33, 0, 2, CAP + 1], 128, 1, 8),
    ([CAP + 9, 45, 16, 0], 64, None, None),
    ([5, CAP, 97, 48], 64, 2, 4),
    ([64, 65, 1, 31], 64, 5, 8),
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", APPEND_CASES, ids=str)
def test_kv_group_append_arithmetic_matches_reference(case, dtype):
    """A1's design against flash_decode_grouped_append: the written cache
    bit for bit, the output within 1e-5 of max |out|, finite, zeros where
    the length is 0. The reference reads no row past its capacity and
    weighs a length-0 sequence's masked block uniformly, so it runs at
    lengths clipped to [1, cap]: the same write position and, for every
    length >= 1, the same rows; a length 0 is held to the port's contract
    (zeros) instead."""
    lens, d, splits, warps = case
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(500 + APPEND_CASES.index(case))
    kv0 = rng.standard_normal((B, CAP, 2, KVH * d)).astype(np.float32)
    q = rng.standard_normal((B, H, d)).astype(np.float32)
    k, v = (rng.standard_normal((B, KVH, 1, d)).astype(np.float32) * 3
            for _ in range(2))
    lengths = np.array(lens, np.int32)
    new_rows = np.stack([k.reshape(B, -1), v.reshape(B, -1)], 1)[:, None]
    ref, ref_kv = flash_decode_grouped_append(
        jnp.asarray(q), jnp.asarray(kv0).astype(jdt),
        jnp.asarray(new_rows), jnp.asarray(np.clip(lengths, 1, CAP)), KVH,
        block_k=64, group=2)
    ref = np.asarray(ref)
    kv = torch.from_numpy(kv0).to(tdt)
    plan = at.rows_plan(B, H, KVH, CAP, d, splits, warps)
    out, written = _kv_group_append(torch.from_numpy(q), kv,
                                    torch.from_numpy(k), torch.from_numpy(v),
                                    torch.from_numpy(lengths), plan)
    np.testing.assert_array_equal(
        written.to(torch.float32).numpy(),
        np.asarray(ref_kv.astype(jnp.float32)))
    assert torch.isfinite(out).all()
    live = lengths > 0
    assert not out[~live].any()
    np.testing.assert_allclose(out[live].numpy(), ref[live], rtol=0,
                               atol=REL_TOL * np.abs(ref[live]).max())


def test_kv_group_append_plan_leaves_a_split_without_rows():
    """The first case's plan really has empty splits and short ones, so
    the merge's m = -inf weighing 0 is exercised."""
    plan = at.rows_plan(B, H, KVH, CAP, 128)
    chunks = at.kv_group_chunks(45, plan["splits"], plan["unit"])
    assert plan["splits"] == 8 and (45, 45) in chunks
    assert chunks[0] == (0, 16)


# -- K6 on the KV-group kernel ------------------------------------------------

# (the reference, batch, heads, KV heads, head_dim, lengths, splits, warps;
# None: the plan's). MHA and GQA 4:1 at head_dim 64 and 128; the grouped
# kernel (group 2 divides the batch), the fused one (batch 1 and 3, no
# group) and the stream one; lengths 0 (zeros), 1, the capacity and past
# it. The plan at batch 4 and 3 takes 8 splits of 16-row units, so a
# sequence of 45 or 33 rows leaves splits without a row; 1 to 5 splits and
# 4 or 8 warps forced.
K6_CASES = [
    ("grouped", 4, 8, 2, 64, [0, CAP + 5, 45, CAP - 3], None, None),
    ("grouped", 4, 4, 4, 128, [1, 17, CAP, 64], 3, 4),
    ("fused", 3, 8, 2, 64, [33, 0, CAP + 1], None, None),
    ("fused", 1, 8, 2, 128, [CAP], 5, 8),
    ("stream", 4, 4, 1, 64, [5, CAP, 97, 1], 2, 8),
    ("stream", 3, 4, 4, 128, [0, 64, CAP + 9], 1, 4),
]


def _k6_reference(kind, q, kv, lengths, kvh):
    """The reference's float decode kernel ``kind`` at its block of 64."""
    args = (jnp.asarray(q), kv, jnp.asarray(lengths), kvh)
    if kind == "grouped":
        return flash_decode_grouped(*args, block_k=64, group=2)
    if kind == "fused":
        return flash_decode_fused(*args, block_k=64)
    return flash_decode_stream(*args, block_k=64)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", K6_CASES, ids=str)
def test_kv_group_float_arithmetic_matches_reference(case, dtype):
    """K6's design (the KV-group kernel's exact mode at ``rows_plan``)
    against flash_decode_grouped, flash_decode_fused and
    flash_decode_stream: the output within 1e-5 of max |out|, finite,
    zeros where the length is 0. The reference reads no row past its
    capacity and weighs a length-0 sequence's masked block uniformly, so
    it runs at lengths clipped to [1, cap]: the same rows for every length
    >= 1; a length 0 is held to the port's contract (zeros) instead."""
    kind, b, h, kvh, d, lens, splits, warps = case
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(600 + K6_CASES.index(case))
    kv0 = rng.standard_normal((b, CAP, 2, kvh * d)).astype(np.float32)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    lengths = np.array(lens, np.int32)
    jkv = jnp.asarray(kv0).astype(jdt)
    ref = np.asarray(_k6_reference(kind, q, jkv, np.clip(lengths, 1, CAP),
                                   kvh))
    kv = torch.from_numpy(kv0).to(tdt)
    plan = at.rows_plan(b, h, kvh, CAP, d, splits, warps)
    out, _ = _kv_group_float(torch.from_numpy(q), kv,
                             torch.from_numpy(lengths), plan)
    assert torch.isfinite(out).all()
    live = lengths > 0
    assert not out[~live].any()
    np.testing.assert_allclose(out[live].numpy(), ref[live], rtol=0,
                               atol=REL_TOL * np.abs(ref[live]).max())


def test_kv_group_float_plans_leave_splits_without_rows():
    """The plans of the first and third K6 cases split into 8 chunks of
    16-row units, so their 45- and 33-row sequences leave splits without a
    row (the merge's m = -inf weighing 0 is exercised) and their
    capacity-long ones fill every split; the fused case's batch of 3 is
    the reference's fused fallback."""
    for b, h, kvh, n in ((4, 8, 2, 45), (3, 8, 2, 33)):
        plan = at.rows_plan(b, h, kvh, CAP, 64)
        assert plan["splits"] == 8 and plan["unit"] == 16
        chunks = at.kv_group_chunks(n, plan["splits"], plan["unit"])
        assert (n, n) in chunks and chunks[0] == (0, 16)
        assert all(c1 > c0 for c0, c1 in at.kv_group_chunks(
            CAP, plan["splits"], plan["unit"]))
    assert at.float_decode_kernel(3, 8, 64, 2, CAP) == ("fused", 0)
    assert at.float_decode_kernel(4, 8, 64, 2, CAP) == ("grouped", 2)


# -- K7's eight-lane quantizer ------------------------------------------------

def _lanes8_quantize(x, wide):
    """K7's quantizer on rows x [N, D] (f32): each of a row's eight lanes
    takes the absmax of its values (wide: D / 8 contiguous values; narrow:
    ceil(D / 8) of them, the last lanes fewer or none), then three
    shuffles (xor 1, 2, 4) combine the lanes' partials; scale =
    bf16(absmax / 127), 1 where it is 0; q = clip(rint(x / f32(scale)),
    -127, 127). Returns (q int8 [N, D], scale bf16 [N])."""
    n, d = x.shape
    per = d // 8 if wide else -(-d // 8)
    part = torch.zeros((n, 8))
    for lane in range(8):
        vals = x[:, lane * per:min(d, (lane + 1) * per)].abs()
        if vals.shape[1]:
            part[:, lane] = torch.maximum(part[:, lane], vals.amax(dim=1))
    for o in (1, 2, 4):
        part = torch.maximum(part, part[:, torch.arange(8) ^ o])
    assert (part == part[:, :1]).all()
    amax = part[:, 0]
    scale = torch.where(amax == 0, torch.ones_like(amax),
                        amax / 127.0).to(torch.bfloat16)
    sf = scale.to(torch.float32)[:, None]
    q = torch.clamp(torch.round(x / sf), -127, 127).to(torch.int8)
    return q, scale


def _crafted_rows(d, seed):
    """Rows at mixed magnitudes, an all-zero row, rows whose absmax is 127
    x a bf16 scale exactly (so x / scale is exact) holding values at
    rounding ties (k + 0.5) x scale, +-0 and +-127 x scale, and rows whose
    scale a reciprocal multiply would round otherwise."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((12, d))
         * np.exp(rng.uniform(-6, 6, (12, 1)))).astype(np.float32)
    x[1] = 0.0
    for i, sf in enumerate((0.0078125, 0.01171875, 3.25, 1.5e-3), start=2):
        sf = float(np.float32(torch.tensor(sf).to(torch.bfloat16).item()))
        ties = (rng.integers(-126, 126, d) + 0.5) * sf
        ties[0], ties[-1] = 127 * sf, -127 * sf
        ties[1 % d] = 0.0
        ties[2 % d] = -0.0
        x[i] = ties.astype(np.float32)
    x[6, :] = np.float32(-0.0)
    x[7, 0] = 1e-30
    flips = _scale_flips(rng, 4)
    x[8:] = rng.uniform(-0.9, 0.9, (4, d)).astype(np.float32) * flips[:, None]
    x[8:, -1] = flips
    return x


def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16).to(torch.float32).numpy()


def _scale_flips(rng, n):
    """n absmaxes a whose scale bf16(a / 127) a multiply by the f32
    reciprocal of 127 would round to the other bf16 neighbour: a within an
    ulp of 127 x a bf16 midpoint."""
    s = _bf16(rng.uniform(0.01, 4.0, 20000))
    mid = s + np.float32(2.0) ** (np.floor(np.log2(s)) - 8).astype(np.float32)
    a0 = (mid.astype(np.float64) * 127).astype(np.float32)
    a = np.concatenate([np.nextafter(a0, np.float32(np.inf)), a0,
                        np.nextafter(a0, np.float32(0))])
    flip = a[_bf16(a / np.float32(127))
             != _bf16(a * (np.float32(1) / np.float32(127)))]
    assert len(flip) >= n
    return flip[:n]


@pytest.mark.parametrize("d,wide", [(32, True), (64, True), (128, True),
                                    (96, True), (256, True), (16, False),
                                    (80, False), (12, False), (3, False),
                                    (64, False)])
def test_eight_lane_quantizer_bit_exact_against_quantize_tokens(d, wide):
    """K7's quantizer in the lane layout of its wide instance (D / 8
    contiguous values a lane: head_dim 64 and 128 on the card, and here
    other multiples of 8 too) or its narrow one (any head_dim) equals the
    reference's ``_quantize_tokens`` bit for bit: the max is exact in any
    order, and the division and rounding are IEEE."""
    x = _crafted_rows(d, 700 + d)
    q, scale = _lanes8_quantize(torch.from_numpy(x), wide)
    jq, js = _quantize_tokens(jnp.asarray(x)[None, :, None, :])
    np.testing.assert_array_equal(q.numpy(),
                                  np.asarray(jq)[0, :, 0].astype(np.int8))
    assert torch.equal(scale.view(torch.int16), torch.from_numpy(
        np.array(js)[0, :, 0].view(np.int16)))
    assert (q[1] == 0).all() and scale[1].item() == 1.0
    assert q[2:6].abs().max().item() == 127


# -- P2: K7's kernel through the page table -----------------------------------

PAGE, MAX_PAGES, N_PAGES = 8, 4, 24
# Lengths before the append: mid-page, at a page boundary, at a page's
# last row, a finished slot past capacity (the last page), a slot whose
# page at its length is unmapped (page 0, offset 2), and a released slot
# (table row -1: page 0, offset 5); the mapped pages of each row.
P2_LENGTHS = [3, PAGE, 2 * PAGE - 1, MAX_PAGES * PAGE + 3, PAGE + 2, 5]
P2_MAPPED = [1, 2, 2, 4, 1, 0]


def _p2_table(rng):
    ids = list(rng.permutation(np.arange(1, N_PAGES)))
    table = np.full((len(P2_MAPPED), MAX_PAGES), -1, np.int32)
    for i, n in enumerate(P2_MAPPED):
        table[i, :n] = [ids.pop() for _ in range(n)]
    return table


def _paged_row(b, table, lengths, page):
    """``PagedSlots``' row of sequence b: page index min(len // page, P -
    1), id max(entry, 0), offset len % page, len = max(length, 0)."""
    length = max(int(lengths[b]), 0)
    pid = max(int(table[b, min(length // page, table.shape[1] - 1)]), 0)
    return pid * page + length % page


def _lanes8_paged_append(pool, scales, k, v, table, lengths, wide):
    """P2 as its kernel runs, in place: each (sequence, plane, KV head) row
    in eight lanes (:func:`_lanes8_quantize`'s layout); the lane's source
    values, then the length, then the table entry at the length's page
    (page index min(len // page, P - 1), id max(entry, 0), offset len %
    page, len = max(length, 0)), the row quantized, and each lane's bytes
    stored at its values' offsets, the scale by the row's first lane."""
    b, kvh, _, d = k.shape
    page = pool.shape[1]
    per = d // 8 if wide else -(-d // 8)
    x = torch.stack([k[:, :, 0], v[:, :, 0]], dim=1).reshape(-1, d)
    q, s = _lanes8_quantize(x, wide)
    for r in range(x.shape[0]):
        bi, plane, h = r // (2 * kvh), (r // kvh) % 2, r % kvh
        pid, off = divmod(_paged_row(bi, table, lengths, page), page)
        for lane in range(8):
            lo, hi = min(d, lane * per), min(d, (lane + 1) * per)
            pool[pid, off, plane, h * d + lo:h * d + hi] = q[r, lo:hi]
        scales[pid, off, plane, h] = s[r]


@pytest.mark.parametrize("kvh,d,wide", [(2, 128, True), (2, 128, False),
                                        (2, 64, True), (8, 16, False)])
def test_eight_lane_paged_append_bit_exact_against_paged_append_quant(
        kvh, d, wide):
    """P2's design (K7's eight-lane kernel with the PagedSlots addressing,
    its wide and narrow layouts, head_dim 16 to 128) writes the bytes and
    scales of the reference's paged decode append (``_quantize_tokens``,
    then ``paged_append_quant``) bit for bit over the whole pool: an
    all-zero head (scale 1.0, bytes 0), a finished slot past capacity into
    its last page, an unmapped page and a released slot into page 0; the
    plain version too."""
    rng = np.random.default_rng(800 + d + wide)
    b = len(P2_LENGTHS)
    table = _p2_table(rng)
    lengths = np.array(P2_LENGTHS, np.int32)
    jc = JPagedKVCache.create(1, N_PAGES, PAGE, kvh, d, b, MAX_PAGES,
                              quantized=True)
    # Pages 1-18 filled by a prefill of 3 pages a sequence first, so most
    # rows the append writes held other bytes and scales.
    pre_table = np.full((b, MAX_PAGES), -1, np.int32)
    pre_table[:, :3] = np.arange(1, 3 * b + 1).reshape(b, 3)
    jc = _with(jc, table=pre_table)
    pre = (rng.standard_normal((b, kvh, 3 * PAGE, d)).astype(np.float32))
    jc = jc.append(0, jnp.asarray(pre), jnp.asarray(pre[:, :, ::-1]),
                   position=0)
    jc = _with(jc, table=table, lengths=lengths)
    pool, scales = _pools(jc)
    k, v = (rng.standard_normal((b, kvh, 1, d)).astype(np.float32)
            * np.exp(rng.uniform(-3, 3, (b, kvh, 1, 1))).astype(np.float32)
            for _ in range(2))
    k[0, 1] = 0.0                          # an all-zero head
    jc = jc.append(0, jnp.asarray(k), jnp.asarray(v))
    want_pool, want_scales = _pools(jc)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    tt, tl = torch.from_numpy(table), torch.from_numpy(lengths)
    got_pool, got_scales = pool.clone(), scales.clone()
    _lanes8_paged_append(got_pool, got_scales, tk, tv, tt, tl, wide)
    assert torch.equal(got_pool, want_pool)
    assert torch.equal(got_scales.view(torch.int16),
                       want_scales.view(torch.int16))
    assert not torch.equal(got_pool, pool)
    page0 = max(int(table[0, 0]), 0)
    assert got_scales[page0, 3, 0, 1].item() == 1.0
    assert not got_pool[page0, 3, 0, d:2 * d].any()
    plain_pool, plain_scales = pool.clone(), scales.clone()
    kc.kv_append_paged_int8_plain(plain_pool, plain_scales, tk, tv, tt, tl)
    assert torch.equal(plain_pool, want_pool)
    assert torch.equal(plain_scales, want_scales)


# -- K5 and P1: the same kernel body with its float row policy ---------------

def _lane_words(vals, dtype):
    """A lane's values as the float policy packs them into 32-bit words:
    f32 bits, or bf16 (round to nearest even) by pairs, the first value in
    the low half."""
    if dtype == torch.float32:
        return vals.view(torch.int32)
    bits = vals.to(torch.bfloat16).view(torch.int16).to(torch.int32) & 0xFFFF
    return bits[0::2] | (bits[1::2] << 16)


def _lanes8_float_append(kv, k, v, row_of, wide):
    """K5 and P1 as their kernel runs, in place on ``kv`` (the cache or
    pool as rows [R, 2, KVH*D], f32 or bf16): each (sequence, plane, KV
    head) row in eight lanes, each lane's values (wide: D / 8 contiguous
    ones; narrow: ceil(D / 8), the last lanes fewer or none) stored at the
    row ``row_of(b)`` gives; wide, as the lane's words (:func:`_lane_words`)
    in 16-byte stores, or 8-byte ones where the lane has fewer bytes, each
    aligned to its size; narrow, value by value, bf16 rounded to nearest
    even."""
    b, kvh, _, d = k.shape
    size = kv.element_size()
    per = d // 8 if wide else -(-d // 8)
    x = torch.stack([k[:, :, 0], v[:, :, 0]], dim=1).reshape(-1, d)
    flat = kv.view(torch.uint8)
    for r in range(x.shape[0]):
        bi, plane, h = r // (2 * kvh), (r // kvh) % 2, r % kvh
        row = row_of(bi)
        for lane in range(8):
            lo, hi = min(d, lane * per), min(d, (lane + 1) * per)
            if wide:
                data = _lane_words(x[r, lo:hi], kv.dtype).view(torch.uint8)
                store = 16 if len(data) % 16 == 0 else 8
                at = (((row * 2 + plane) * kvh + h) * d + lo) * size
                assert len(data) % store == 0 and at % store == 0
                flat[row, plane, (h * d + lo) * size:(h * d + hi) * size] = (
                    data)
            else:
                kv[row, plane, h * d + lo:h * d + hi] = x[r, lo:hi].to(
                    kv.dtype)


def _bits(x):
    return x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32)


def _float_rows(rng, b, kvh, d):
    """New K/V [B, KVH, 1, D] at mixed magnitudes, with values at bf16
    rounding ties (to even: down and up), -0.0 and an f32 subnormal."""
    k, v = (rng.standard_normal((b, kvh, 1, d)).astype(np.float32)
            * np.exp(rng.uniform(-3, 3, (b, kvh, 1, 1))).astype(np.float32)
            for _ in range(2))
    k[0, 0, 0, :4] = [1 + 2.0 ** -8, 1 + 3 * 2.0 ** -8, -0.0, 2.0 ** -140]
    return k, v


# (KV heads, head_dim, layout): the wide layout at head_dim 64 and 128 (the
# kernel's wide instance), the narrow one there and at 16.
FLOAT_APPEND_SHAPES = [(2, 128, True), (2, 128, False), (3, 64, True),
                       (3, 64, False), (3, 16, False)]
K5_CAP = 24
# Lengths before the append: empty, mid-cache, the last row, at capacity and
# a finished slot past it (both clamp to the last row), mid-cache.
K5_LENGTHS = [0, 5, K5_CAP - 1, K5_CAP, K5_CAP + 9, 17]


@pytest.mark.parametrize("kvh,d,wide", FLOAT_APPEND_SHAPES, ids=str)
@pytest.mark.parametrize("addr,dtype", [("positions", "float32"),
                                        ("positions", "bfloat16"),
                                        ("paged", "float32")])
def test_eight_lane_float_append_bit_exact_against_reference(addr, dtype,
                                                             kvh, d, wide):
    """K5 and P1 in their kernel's lane layout (the float row policy, wide
    and narrow, head_dim 16 to 128) write the reference's rows bit for bit
    over the whole cache or pool: K5 (``Positions``, f32 and bf16 caches)
    against ``cache_append`` at min(lengths, cap - 1), a length 0 and
    finished slots at and past capacity included; P1 (``PagedSlots``, an
    f32 pool) against ``paged_append`` at the reference's page and offset,
    with P2's edge rows (a slot past capacity into its last page, an
    unmapped page and a released slot into page 0). The plain versions
    too."""
    rng = np.random.default_rng(900 + d + kvh + wide)
    jdt, tdt = DTYPES[dtype]
    b, f = 6, kvh * d
    k, v = _float_rows(rng, b, kvh, d)
    packed = np.stack([k.transpose(0, 2, 1, 3).reshape(b, 1, f),
                       v.transpose(0, 2, 1, 3).reshape(b, 1, f)], axis=2)
    news = (jnp.asarray(packed).astype(jdt),)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    if addr == "positions":
        lengths = np.array(K5_LENGTHS, np.int32)
        jbuf = jnp.asarray(rng.standard_normal((b, K5_CAP, 2, f)), jdt)
        (ref,) = cache_append(jnp.minimum(jnp.asarray(lengths), K5_CAP - 1),
                              (jbuf,), news)
        row_of = lambda bi: bi * K5_CAP + min(max(int(lengths[bi]), 0),
                                              K5_CAP - 1)
        plain = lambda kv: kc.kv_append_plain(kv, tk, tv,
                                              torch.from_numpy(lengths))
    else:
        table, lengths = _p2_table(rng), np.array(P2_LENGTHS, np.int32)
        b = len(lengths)
        jbuf = jnp.asarray(rng.standard_normal((N_PAGES, PAGE, 2, f)), jdt)
        idx = np.minimum(lengths // PAGE, MAX_PAGES - 1)
        ids = np.maximum(table[np.arange(b), idx], 0).astype(np.int32)
        (ref,) = paged_append(jnp.asarray(ids),
                              jnp.asarray(lengths % PAGE), (jbuf,), news)
        row_of = lambda bi: _paged_row(bi, table, lengths, PAGE)
        plain = lambda kv: kc.kv_append_paged_plain(
            kv, tk, tv, torch.from_numpy(table), torch.from_numpy(lengths))
    before = torch.from_numpy(np.array(jbuf.astype(jnp.float32))).to(tdt)
    want = torch.from_numpy(np.array(ref.astype(jnp.float32))).to(tdt)
    got = before.clone()
    _lanes8_float_append(got.view(-1, 2, f), tk, tv, row_of, wide)
    assert torch.equal(_bits(got), _bits(want))
    assert not torch.equal(got, before)
    got = before.clone()
    plain(got)
    assert torch.equal(_bits(got), _bits(want))


# -- K3: the flush on the same kernel body ------------------------------------

FLUSH_B, FLUSH_KVH, FLUSH_R, FLUSH_CAP = 5, 2, 16, 32
# (head_dim, the window a view 2 bytes past a 16-byte boundary, the
# instance): the wide instance at head_dim 64 and 128, the narrow one at
# 96 and on the misaligned window.
FLUSH_LAYOUTS = [(64, False, True), (128, False, True), (96, False, False),
                 (64, True, False)]


def _flush_lengths(t):
    """Lengths counting the t window tokens: below t (the offset clamps to
    0), exactly t, mid-cache, at capacity and past it (both clamp to
    cap - t)."""
    return np.array([max(t - 1, 0), t, 19, FLUSH_CAP, FLUSH_CAP + 7],
                    np.int32)


def _lanes8_flush(flat, base, shape, kv, scales, lengths, t, wide):
    """K3 as its kernel runs, in place, byte by byte: source row r of the
    [B, t, 2, KVH] rows is (b, j, plane, h), its D bf16 values at element
    base + ((b * R + j) * 2 + plane) * F + h * D of ``flat`` (the window
    [B, R, 2, F] of ``shape``, ``base`` elements into its buffer); lane
    slot loads its values (wide: D / 8 of them in 16-byte loads, which
    must be aligned; narrow: ceil(D / 8), the last lanes fewer or none),
    the row is quantized as the int8 policy does, and the lane stores its
    bytes at row b * cap + clip(lengths[b] - t, 0, cap - t) + j (wide: one
    word of D / 8 bytes, little-endian 32-bit words, aligned; narrow: byte
    by byte), the scale from lane 0."""
    b, rows, _, f = shape
    cap, kvh = kv.shape[1], scales.shape[3]
    d = f // kvh
    per = d // 8 if wide else -(-d // 8)
    out = kv.view(-1)
    for r in range(b * t * 2 * kvh):
        h, plane = r % kvh, (r // kvh) % 2
        bi, j = divmod(r // (2 * kvh), t)
        src = base + ((bi * rows + j) * 2 + plane) * f + h * d
        lanes = [(min(d, s * per), min(d, (s + 1) * per)) for s in range(8)]
        x = torch.zeros(d)
        for lo, hi in lanes:
            if wide:
                assert 2 * (src + lo) % 16 == 0 and (hi - lo) * 2 % 16 == 0
            x[lo:hi] = flat[src + lo:src + hi].to(torch.float32)
        q, scale = _lanes8_quantize(x[None], wide)
        off = min(max(int(lengths[bi]) - t, 0), cap - t)
        at = ((bi * cap + off + j) * 2 + plane) * kvh + h
        dst = at * d
        for lo, hi in lanes:
            if wide:
                assert (dst + lo) % (hi - lo) == 0
                words = q[0, lo:hi].numpy().view(np.uint8).view("<u4")
                out[dst + lo:dst + hi] = torch.from_numpy(
                    words.view(np.uint8).view(np.int8).copy())
            else:
                out[dst + lo:dst + hi] = q[0, lo:hi]
        scales.view(-1)[at] = scale[0]


def _flush_window(rng, t, d):
    """A window [B, R, 2, F] (f32, bf16 values) of rows at mixed
    magnitudes, with an all-zero head and a head of tiny absmax among the
    flushed rows."""
    f = FLUSH_KVH * d
    tail = (rng.standard_normal((FLUSH_B, FLUSH_R, 2, f))
            * np.exp(rng.uniform(-4, 4, (FLUSH_B, FLUSH_R, 2, 1))))
    tail[0, 0, 1, :d] = 0.0                # all-zero head: scale 1.0
    tail[1, t - 1, 0, d:] = 0.0            # tiny absmax
    tail[1, t - 1, 0, d + 3] = 1e-30
    return _bf16(tail.astype(np.float32))


def _flush_view(tail, misaligned):
    """The window as a bf16 torch view of its own buffer, ``base`` elements
    (1 if misaligned, else 0) into it: (flat buffer, base, view)."""
    base = int(misaligned)
    flat = torch.zeros(tail.size + 8, dtype=torch.bfloat16)
    flat[base:base + tail.size] = torch.from_numpy(tail.reshape(-1))
    return flat, base, flat[base:base + tail.size].view(tail.shape)


def _window_rows(lengths, t):
    """bool [B, cap]: the rows the flush writes."""
    off = np.clip(lengths - t, 0, FLUSH_CAP - t)
    rows = np.arange(FLUSH_CAP)[None, :]
    return torch.from_numpy((rows >= off[:, None])
                            & (rows < off[:, None] + t))


@pytest.mark.parametrize("d,misaligned,wide", FLUSH_LAYOUTS)
@pytest.mark.parametrize("t", [1, 5, 16])
def test_eight_lane_flush_bit_exact_against_flush_tail(t, d, misaligned,
                                                       wide):
    """K3's design (the appends' eight-lane body over the bf16 window's
    first t rows, wide at head_dim 64 and 128 on aligned rows, narrow at
    96 and on a misaligned window) writes the rows of the reference's
    ``flush_tail(t)`` (jitted, CPU) bit for bit at t 1, 5 (a partial flush
    of an R 16 window) and 16, with lengths below t, at capacity and past
    it; it leaves every other row as it was, and the plain version writes
    the same cache."""
    rng = np.random.default_rng(1000 + 7 * t + d + misaligned)
    b, kvh, f = FLUSH_B, FLUSH_KVH, FLUSH_KVH * d
    lengths = _flush_lengths(t)
    full = JKVCache.create(b, 1, kvh, FLUSH_CAP, d, quantized=True)
    full = full.append(0, *(jnp.asarray(
        rng.standard_normal((b, kvh, FLUSH_CAP, d)).astype(np.float32))
        for _ in range(2)), position=0)
    tail = _flush_window(rng, t, d)
    jc = dataclasses.replace(
        JKVCache.create(b, 1, kvh, FLUSH_CAP, d, quantized=True,
                        tail_window=FLUSH_R),
        kv=full.kv, quant_scales=full.quant_scales,
        lengths=jnp.asarray(lengths),
        tail=[jnp.asarray(tail, jnp.bfloat16)],
        tail_count=jnp.asarray(t, jnp.int32))
    before, before_s = port_layout(jc, 0)
    want, want_s = port_layout(jax.jit(lambda c: c.flush_tail(t))(jc), 0)
    flat, base, view = _flush_view(tail, misaligned)
    assert kc.tail_flush_wide(d, view, before) == wide
    got, got_s = before.clone(), before_s.clone()
    _lanes8_flush(flat, base, view.shape, got, got_s,
                  torch.from_numpy(lengths), t, wide)
    rows = _window_rows(lengths, t)
    assert torch.equal(got[rows], want[rows])
    assert torch.equal(got_s[rows].view(torch.int16),
                       want_s[rows].view(torch.int16))
    assert torch.equal(got[~rows], before[~rows])
    assert torch.equal(got_s[~rows], before_s[~rows])
    plain, plain_s = before.clone(), before_s.clone()
    kc.tail_flush_int8_plain(view, plain, plain_s, torch.from_numpy(lengths),
                             t)
    assert torch.equal(plain, got) and torch.equal(plain_s, got_s)


@pytest.mark.parametrize("wide", [True, False])
@pytest.mark.parametrize("t", range(1, 17))
def test_eight_lane_flush_quantizer_bit_exact_against_quantize_tokens(t,
                                                                      wide):
    """For every t in 1..16 of an R 16 window at head_dim 64, K3's lane
    layout stores at each sequence's window offset the bytes and scales of
    the reference's ``_quantize_tokens`` on the window's first t rows, an
    all-zero head (bytes 0, scale 1.0) and a tiny absmax included."""
    rng = np.random.default_rng(1100 + t + 50 * wide)
    d = 64
    b, kvh, f = FLUSH_B, FLUSH_KVH, FLUSH_KVH * d
    lengths = _flush_lengths(t)
    tail = _flush_window(rng, t, d)
    kv = torch.from_numpy(rng.integers(-127, 128, (b, FLUSH_CAP, 2, f),
                                       dtype=np.int8))
    scales = torch.from_numpy(rng.uniform(0.01, 1.0, (b, FLUSH_CAP, 2, kvh))
                              .astype(np.float32)).to(torch.bfloat16)
    flat, base, view = _flush_view(tail, False)
    got, got_s = kv.clone(), scales.clone()
    _lanes8_flush(flat, base, view.shape, got, got_s,
                  torch.from_numpy(lengths), t, wide)
    x = jnp.asarray(tail[:, :t]).reshape(b, t, 2, kvh, d)
    jq, js = _quantize_tokens(x.reshape(b, t * 2, kvh, d))
    want = torch.from_numpy(np.asarray(jq).astype(np.int8)).reshape(
        b, t, 2, f)
    want_s = torch.from_numpy(np.array(js).view(np.int16)).reshape(
        b, t, 2, kvh)
    rows = _window_rows(lengths, t)
    assert torch.equal(got[rows], want.reshape(-1, 2, f))
    assert torch.equal(got_s[rows].view(torch.int16),
                       want_s.reshape(-1, 2, kvh))
    assert torch.equal(got[~rows], kv[~rows])
    assert torch.equal(got_s[~rows], scales[~rows])
    zero = got[0, min(max(int(lengths[0]) - t, 0), FLUSH_CAP - t), 1, :d]
    assert not zero.any()
