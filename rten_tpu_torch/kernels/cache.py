"""KV-cache write kernels.

``tail_flush_int8`` (CUDA, ``csrc/tail_flush_int8.cu``) stands in for both
``rten_tpu/kernels/cache.py::cache_flush_rows`` (:511) and
``::cache_flush_quant`` (:370) together with the quantization that
``rten_tpu/generate/kv_cache.py::flush_tail`` runs in XLA before them.
The cache layout is the port's byte-addressable one (int8
``[B, cap, 2, KVH*D]``, bf16 scales ``[B, cap, 2, KVH]``), so one kernel
writes any depth t in 1..R: there are no packed rows to merge into.
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
    kernel or raise."""
    t = int(t)
    if _build.on_cpu("tail_flush_int8", tail, kv, scales, lengths):
        return tail_flush_int8_plain(tail, kv, scales, lengths, t)
    b, rows, cap, kvh, d = _check(tail, kv, scales, lengths, t)
    _build.require(all(x.is_contiguous() for x in (tail, kv, scales,
                                                   lengths)),
                   "tail_flush_int8", "tensors must be contiguous")
    fn = _build.function("tail_flush_int8", "tail_flush_int8",
                         "ppppiiiiiip")
    err = fn(tail.data_ptr(), kv.data_ptr(), scales.data_ptr(),
             lengths.data_ptr(), b, rows, cap, kvh, d, t, _build.stream())
    _build.check(err, "tail_flush_int8")
    tail_flush_int8.launches += 1


tail_flush_int8.launches = 0
