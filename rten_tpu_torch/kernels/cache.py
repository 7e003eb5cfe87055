"""KV-cache write kernels.

* ``tail_flush_int8`` (CUDA, ``csrc/tail_flush_int8.cu``, K3) stands in
  for both ``rten_tpu/kernels/cache.py::cache_flush_rows`` (:511) and
  ``::cache_flush_quant`` (:370) together with the quantization that
  ``rten_tpu/generate/kv_cache.py::flush_tail`` runs in XLA before them.
* ``kv_append`` (CUDA, ``csrc/kv_append.cu``) replaces ``cache_append``
  (:32): the float-cache decode append.
* ``kv_append_int8`` (CUDA, ``csrc/kv_append_int8.cu``) replaces
  ``cache_append_quant`` (:148) together with the XLA quantization before
  it (``kv_cache.py::_quantize_tokens``): the int8 decode append without a
  tail window.
* ``kv_append_paged`` and ``kv_append_paged_int8`` (CUDA,
  ``csrc/kv_append_paged.cu``) replace ``paged_append`` (:94) and
  ``paged_append_quant`` (:280, with the quantization before it): the
  decode appends into a block-paged pool, page and offset resolved from
  the page table inside the kernel.

The four decode appends and the flush run one kernel body
(``csrc/kv_append.cuh``: eight lanes a row) over a source (the new f32
rows, or the bf16 window's first t rows) with a float or an int8 row
policy, through a position, the page table or the flush's window offset,
in its wide or narrow instance by :func:`kv_append_wide` (the flush:
:func:`tail_flush_wide`).

The cache layout is the port's byte-addressable one (int8
``[B, cap, 2, KVH*D]``, bf16 scales ``[B, cap, 2, KVH]``; pools
``[n_pages, page, ...]`` alike), so the flush writes any depth t in 1..R
and the int8 appends store single bytes: there are no packed rows to merge
into. Every writer updates the cache in place.
"""

from __future__ import annotations

import torch

from . import _build
from .quant import quantize_tokens


def _check(tail, kv, scales, lengths, t):
    name = "tail_flush_int8"
    b, rows, planes, f = tail.shape
    cap, kvh = kv.shape[1], scales.shape[-1]
    _build.require(planes == 2 and tail.dtype == torch.bfloat16, name,
                   "tail must be bf16 [B, R, 2, F]")
    _build.require(kv.shape == (b, cap, 2, f) and kv.dtype == torch.int8,
                   name, "kv must be int8 [B, cap, 2, F]")
    _build.require(scales.shape == (b, cap, 2, kvh)
                   and scales.dtype == torch.bfloat16 and f % kvh == 0,
                   name, "scales must be bf16 [B, cap, 2, KVH]")
    _build.require(lengths.shape == (b,) and lengths.dtype == torch.int32,
                   name, "lengths must be int32 [B]")
    _build.require(1 <= t <= min(rows, cap), name,
                   f"t={t} outside 1..min(R, cap)")
    return b, rows, cap, kvh, f // kvh


def tail_flush_int8_plain(tail, kv, scales, lengths, t):
    """Plain PyTorch version of the flush (same contract, in place)."""
    b, _, cap, kvh, d = _check(tail, kv, scales, lengths, t)
    rows = tail[:, :t].to(torch.float32).reshape(b, t, 2, kvh, d)
    q, s = quantize_tokens(rows)
    offs = torch.clamp(lengths.to(torch.int64) - t, 0, cap - t)
    idx = offs[:, None] + torch.arange(t, device=kv.device)[None, :]
    bidx = torch.arange(b, device=kv.device)[:, None]
    kv[bidx, idx] = q.reshape(b, t, 2, kvh * d)
    scales[bidx, idx] = s


def tail_flush_int8(tail, kv, scales, lengths, t):
    """Quantize tail rows ``[0, t)`` of every sequence per (token, head)
    and write them into ``kv``/``scales`` in place at token offsets
    ``clip(lengths - t, 0, cap - t)``.

    tail bf16 [B, R, 2, KVH*D]; kv int8 [B, cap, 2, KVH*D]; scales bf16
    [B, cap, 2, KVH]; lengths int32 [B] (they already count the t tail
    tokens). CPU tensors take the plain version; CUDA tensors launch the
    kernel (the decode appends' eight-lane body over the window's rows,
    :func:`tail_flush_wide` picks its instance) or raise."""
    t = int(t)
    if _build.on_cpu("tail_flush_int8", tail, kv, scales, lengths):
        return tail_flush_int8_plain(tail, kv, scales, lengths, t)
    b, rows, cap, kvh, d = _check(tail, kv, scales, lengths, t)
    _build.require(all(x.is_contiguous() for x in (tail, kv, scales,
                                                   lengths)),
                   "tail_flush_int8", "tensors must be contiguous")
    fn = _build.function("tail_flush_int8", "tail_flush_int8",
                         "ppppiiiiiiip")
    err = fn(tail.data_ptr(), kv.data_ptr(), scales.data_ptr(),
             lengths.data_ptr(), b, rows, cap, kvh, d, t,
             int(tail_flush_wide(d, tail, kv)), _build.stream())
    _build.check(err, "tail_flush_int8")
    tail_flush_int8.launches += 1


tail_flush_int8.launches = 0


def tail_flush_wide(d, tail, kv):
    """Whether the flush (K3, the decode appends' kernel body over the
    window's rows) takes its wide instance: head_dim 64 or 128 (D / 8
    values a lane: one or two 16-byte loads of bf16, one 8- or 16-byte
    store of int8) and the window and the cache 16-byte aligned (the
    contiguous rows' strides, whole multiples of D, then are too). Else
    its narrow instance (scalar loads and stores) serves the call: every
    head_dim, any alignment."""
    return (d in (64, 128) and tail.data_ptr() % 16 == 0
            and kv.data_ptr() % 16 == 0)


def _rows(x, b, f):
    """k or v [B, KVH, 1, D] as f32 rows [B, F] with unit inner stride (a
    view of the model's fused QKV output where possible)."""
    x = x.reshape(b, f)
    return x if x.stride(1) == 1 else x.contiguous()


def _check_append(name, kv, k, v, lengths, dtypes):
    b, kvh, t, d = k.shape
    _build.require(t == 1 and v.shape == k.shape
                   and k.dtype == v.dtype == torch.float32, name,
                   "k and v must be f32 [B, KVH, 1, D]")
    _build.require(kv.dim() == 4 and kv.shape[0] == b and kv.shape[2] == 2
                   and kv.shape[3] == kvh * d and kv.dtype in dtypes, name,
                   f"kv must be {dtypes} [B, cap, 2, KVH*D]")
    _build.require(lengths.shape == (b,) and lengths.dtype == torch.int32,
                   name, "lengths must be int32 [B]")
    return b, kv.shape[1], kvh, d


FLOAT_CACHE_DTYPES = (torch.float32, torch.bfloat16)


def kv_append_wide(d, kv, kr, vr):
    """Whether a decode append (K5, P1, K7 and P2: one kernel body) takes
    its wide instance: head_dim 64 or 128 (every preset's but the small
    test configuration's 16; D / 8 values a lane: 16-byte loads, and
    stores of whole 8- or 16-byte words at the cache's element size of 1,
    2 or 4 bytes), the f32 rows ``kr``/``vr`` and the cache or pool ``kv``
    16-byte aligned (data pointers, and the rows' strides in whole 16-byte
    units; the cache's own rows, whole multiples of a lane's D / 8
    elements, always are). Else its narrow instance (scalar loads and
    stores) serves the call: every head_dim, any alignment."""
    return (d in (64, 128) and kv.data_ptr() % 16 == 0
            and all(x.data_ptr() % 16 == 0 and x.stride(0) % 4 == 0
                    for x in (kr, vr)))


def kv_append_plain(kv, k, v, lengths):
    """Plain PyTorch version of the float append (same contract, in
    place)."""
    b, cap, kvh, d = _check_append("kv_append", kv, k, v, lengths,
                                   FLOAT_CACHE_DTYPES)
    rows = torch.stack([k.reshape(b, kvh * d), v.reshape(b, kvh * d)],
                       dim=1).to(kv.dtype)
    pos = torch.clamp(lengths.to(torch.int64), 0, cap - 1)
    kv[torch.arange(b, device=kv.device), pos] = rows


def kv_append(kv, k, v, lengths):
    """Write each sequence's new K/V as one token row into a float cache,
    in place, at ``clamp(lengths, 0, cap - 1)`` (finished slots keep
    decoding past capacity).

    kv f32 or bf16 [B, cap, 2, KVH*D]; k, v f32 [B, KVH, 1, D] (strided
    views are fine); lengths int32 [B]. A bf16 cache rounds to nearest
    even, as ``Tensor.to(torch.bfloat16)`` does. CPU tensors take the
    plain version; CUDA tensors launch the kernel (eight lanes a row; its
    wide or narrow instance by :func:`kv_append_wide`) or raise."""
    name = "kv_append"
    if _build.on_cpu(name, kv, k, v, lengths):
        return kv_append_plain(kv, k, v, lengths)
    b, cap, kvh, d = _check_append(name, kv, k, v, lengths,
                                   FLOAT_CACHE_DTYPES)
    _build.require(kv.is_contiguous() and lengths.is_contiguous(), name,
                   "kv and lengths must be contiguous")
    kr, vr = _rows(k, b, kvh * d), _rows(v, b, kvh * d)
    fn = _build.function(name, name, "ppiippiiiiiip")
    err = fn(kr.data_ptr(), vr.data_ptr(), kr.stride(0), vr.stride(0),
             kv.data_ptr(), lengths.data_ptr(), b, cap, kvh, d,
             int(kv.dtype == torch.bfloat16),
             int(kv_append_wide(d, kv, kr, vr)), _build.stream())
    _build.check(err, name)
    kv_append.launches += 1


kv_append.launches = 0


def _check_append_int8(kv, scales, k, v, pos):
    name = "kv_append_int8"
    b, cap, kvh, d = _check_append(name, kv, k, v, pos, (torch.int8,))
    _build.require(scales.shape == (b, cap, 2, kvh)
                   and scales.dtype == torch.bfloat16, name,
                   "scales must be bf16 [B, cap, 2, KVH]")
    return b, cap, kvh, d


def kv_append_int8_plain(kv, scales, k, v, pos, masked=False):
    """Plain PyTorch version of the int8 append (same contract, in
    place)."""
    b, cap, kvh, d = _check_append_int8(kv, scales, k, v, pos)
    x = torch.stack([k[:, :, 0], v[:, :, 0]], dim=1)        # [B, 2, KVH, D]
    q, s = quantize_tokens(x)
    p = pos.to(torch.int64)
    keep = p >= 0 if masked else torch.ones_like(p, dtype=torch.bool)
    bidx = torch.arange(b, device=kv.device)[keep]
    p = torch.clamp(p[keep], 0, cap - 1)
    kv[bidx, p] = q[keep].reshape(-1, 2, kvh * d)
    scales[bidx, p] = s[keep]


def kv_append_int8(kv, scales, k, v, pos, masked=False):
    """Quantize each sequence's new K/V per (plane, head) and write the
    int8 bytes and bf16 scales into the int8 cache, in place, at
    ``min(pos, cap - 1)`` — the quantizer of ``_quantize_tokens`` bit for
    bit. With ``masked`` a sequence whose ``pos`` is negative writes
    nothing; without it ``pos`` also clamps to >= 0.

    kv int8 [B, cap, 2, KVH*D]; scales bf16 [B, cap, 2, KVH]; k, v f32
    [B, KVH, 1, D] (strided views are fine); pos int32 [B] (the cache
    lengths). CPU tensors take the plain version; CUDA tensors launch the
    kernel (eight lanes a row; its wide or narrow instance by
    :func:`kv_append_wide`) or raise."""
    name = "kv_append_int8"
    if _build.on_cpu(name, kv, scales, k, v, pos):
        return kv_append_int8_plain(kv, scales, k, v, pos, masked)
    b, cap, kvh, d = _check_append_int8(kv, scales, k, v, pos)
    _build.require(all(x.is_contiguous() for x in (kv, scales, pos)), name,
                   "kv, scales and pos must be contiguous")
    kr, vr = _rows(k, b, kvh * d), _rows(v, b, kvh * d)
    fn = _build.function(name, name, "ppiipppiiiiiip")
    err = fn(kr.data_ptr(), vr.data_ptr(), kr.stride(0), vr.stride(0),
             kv.data_ptr(), scales.data_ptr(), pos.data_ptr(), b, cap, kvh,
             d, int(bool(masked)), int(kv_append_wide(d, kv, kr, vr)),
             _build.stream())
    _build.check(err, name)
    kv_append_int8.launches += 1


kv_append_int8.launches = 0


def paged_slots(table, lengths, page):
    """Where each sequence's decode append lands in a block-paged pool
    (``rten_tpu/generate/paged_cache.py:177-187``): page id
    ``max(table[b, min(len // page, P - 1)], 0)`` (an unmapped entry
    writes into page 0, the allocator's garbage page) and offset
    ``len % page``, with ``len = max(lengths[b], 0)``. Returns int64
    (ids, offsets) [B]."""
    lens = lengths.to(torch.int64).clamp(min=0)
    idx = torch.clamp(lens // page, max=table.shape[1] - 1)
    ids = table.to(torch.int64).gather(1, idx[:, None])[:, 0].clamp(min=0)
    return ids, lens % page


def _check_paged(name, pool, k, v, table, lengths, dtypes):
    b, kvh, t, d = k.shape
    _build.require(t == 1 and v.shape == k.shape
                   and k.dtype == v.dtype == torch.float32, name,
                   "k and v must be f32 [B, KVH, 1, D]")
    _build.require(pool.dim() == 4 and pool.shape[2] == 2
                   and pool.shape[3] == kvh * d and pool.dtype in dtypes,
                   name, f"pool must be {dtypes} [n_pages, page, 2, KVH*D]")
    _build.require(table.dim() == 2 and table.shape[0] == b
                   and table.dtype == torch.int32, name,
                   "table must be int32 [B, max_pages]")
    _build.require(lengths.shape == (b,) and lengths.dtype == torch.int32,
                   name, "lengths must be int32 [B]")
    return b, pool.shape[1], table.shape[1], kvh, d


def kv_append_paged_plain(pool, k, v, table, lengths):
    """Plain PyTorch version of the paged float append (same contract, in
    place)."""
    b, page, _, kvh, d = _check_paged("kv_append_paged", pool, k, v, table,
                                      lengths, FLOAT_CACHE_DTYPES)
    ids, offs = paged_slots(table, lengths, page)
    pool[ids, offs] = torch.stack([k.reshape(b, kvh * d),
                                   v.reshape(b, kvh * d)],
                                  dim=1).to(pool.dtype)


def kv_append_paged(pool, k, v, table, lengths):
    """Write each sequence's new K/V as one token row into a float block-
    paged pool, in place, at the page and offset of :func:`paged_slots`.

    pool f32 or bf16 (rounded to nearest even, as ``kv_append``)
    [n_pages, page, 2, KVH*D]; k, v f32 [B, KVH, 1, D] (strided
    views are fine); table int32 [B, P] (-1 = unmapped); lengths int32
    [B]. CPU tensors take the plain version; CUDA tensors launch the
    kernel (``kv_append``'s, eight lanes a row, the row's page read from
    the table after the source loads; its wide or narrow instance by
    :func:`kv_append_wide`) or raise."""
    name = "kv_append_paged"
    if _build.on_cpu(name, pool, k, v, table, lengths):
        return kv_append_paged_plain(pool, k, v, table, lengths)
    b, page, n_p, kvh, d = _check_paged(name, pool, k, v, table, lengths,
                                        FLOAT_CACHE_DTYPES)
    _build.require(all(x.is_contiguous() for x in (pool, table, lengths)),
                   name, "pool, table and lengths must be contiguous")
    kr, vr = _rows(k, b, kvh * d), _rows(v, b, kvh * d)
    fn = _build.function(name, name, "ppiipppiiiiiiip")
    err = fn(kr.data_ptr(), vr.data_ptr(), kr.stride(0), vr.stride(0),
             pool.data_ptr(), table.data_ptr(), lengths.data_ptr(), b, page,
             n_p, kvh, d, int(pool.dtype == torch.bfloat16),
             int(kv_append_wide(d, pool, kr, vr)), _build.stream())
    _build.check(err, name)
    kv_append_paged.launches += 1


kv_append_paged.launches = 0


def _check_paged_int8(pool, scales, k, v, table, lengths):
    name = "kv_append_paged_int8"
    b, page, n_p, kvh, d = _check_paged(name, pool, k, v, table, lengths,
                                        (torch.int8,))
    _build.require(scales.shape == (pool.shape[0], page, 2, kvh)
                   and scales.dtype == torch.bfloat16, name,
                   "scales must be bf16 [n_pages, page, 2, KVH]")
    return b, page, n_p, kvh, d


def kv_append_paged_int8_plain(pool, scales, k, v, table, lengths):
    """Plain PyTorch version of the paged int8 append (same contract, in
    place)."""
    b, page, _, kvh, d = _check_paged_int8(pool, scales, k, v, table,
                                           lengths)
    q, s = quantize_tokens(torch.stack([k[:, :, 0], v[:, :, 0]], dim=1))
    ids, offs = paged_slots(table, lengths, page)
    pool[ids, offs] = q.reshape(b, 2, kvh * d)
    scales[ids, offs] = s


def kv_append_paged_int8(pool, scales, k, v, table, lengths):
    """Quantize each sequence's new K/V per (plane, head) and write the
    int8 bytes and bf16 scales into a block-paged int8 pool, in place, at
    the page and offset of :func:`paged_slots` — the quantizer of
    ``_quantize_tokens`` bit for bit.

    pool int8 [n_pages, page, 2, KVH*D]; scales bf16 [n_pages, page, 2,
    KVH]; k, v f32 [B, KVH, 1, D] (strided views are fine); table int32
    [B, P]; lengths int32 [B]. CPU tensors take the plain version; CUDA
    tensors launch the kernel (``kv_append_int8``'s, eight lanes a row,
    the row's page read from the table while the row is quantized; its
    wide or narrow instance by :func:`kv_append_wide`) or raise."""
    name = "kv_append_paged_int8"
    if _build.on_cpu(name, pool, scales, k, v, table, lengths):
        return kv_append_paged_int8_plain(pool, scales, k, v, table, lengths)
    b, page, n_p, kvh, d = _check_paged_int8(pool, scales, k, v, table,
                                             lengths)
    _build.require(all(x.is_contiguous()
                       for x in (pool, scales, table, lengths)), name,
                   "pool, scales, table and lengths must be contiguous")
    kr, vr = _rows(k, b, kvh * d), _rows(v, b, kvh * d)
    fn = _build.function("kv_append_paged", name, "ppiippppiiiiiip")
    err = fn(kr.data_ptr(), vr.data_ptr(), kr.stride(0), vr.stride(0),
             pool.data_ptr(), scales.data_ptr(), table.data_ptr(),
             lengths.data_ptr(), b, page, n_p, kvh, d,
             int(kv_append_wide(d, pool, kr, vr)), _build.stream())
    _build.check(err, name)
    kv_append_paged_int8.launches += 1


kv_append_paged_int8.launches = 0
