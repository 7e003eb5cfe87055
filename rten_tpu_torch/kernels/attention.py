"""Attention for the serving path.

* ``attn_reference`` ports ``rten_tpu/kernels/attention.py::_attn_reference``
  (:58-69). GPT-2 prefill (head_dim 64) never reaches the Pallas
  ``flash_attention`` there (``attention.py:125`` sends d % 128 != 0 to the
  reference), so plain matmul + softmax is the faithful port.
* ``decode_attn_int8_tail`` (CUDA, ``csrc/decode_attn_int8_tail.cu``)
  replaces ``flash_decode_flat`` (:1715) in its int8 + tail mode with
  ``q_bf16=True``: packed int8 tokens dequantized by per-(token, head)
  bf16 scales, then the bf16 tail window, q and the output rounded to bf16.
"""

from __future__ import annotations

import math

import torch

from . import _build

NEG_INF = -1e30


def attn_reference(q, k, v, causal, scale, lengths=None):
    """q [B, H, Sq, D], k/v [B, H, Sk, D] → [B, H, Sq, D]. Masked scores
    take -1e30 as in the reference (a fully masked row stays finite)."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    s_q, s_k = q.shape[2], k.shape[2]
    if causal:
        mask = torch.ones((s_q, s_k), dtype=torch.bool,
                          device=q.device).tril(s_k - s_q)
        scores = scores.masked_fill(~mask, NEG_INF)
    if lengths is not None:
        kmask = (torch.arange(s_k, device=q.device)[None, :]
                 < lengths.to(q.device)[:, None])
        scores = scores.masked_fill(~kmask[:, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def fits_shared_memory(head_dim, capacity, window):
    """Whether the kernel's shared memory (q, one score per cached and
    window token, one partial per thread, all f32) fits the 48 KB a block
    gets without opting in to more."""
    return 4 * (head_dim + capacity + window + 128) <= 48 * 1024


def _check(q, kv, scales, lengths, tail, tail_count):
    name = "decode_attn_int8_tail"
    b, h, d = q.shape
    _build.require(q.dtype == torch.float32, name, "q must be f32 [B, H, D]")
    _build.require(kv.dim() == 4 and kv.shape[0] == b and kv.shape[2] == 2
                   and kv.dtype == torch.int8, name,
                   "kv must be int8 [B, cap, 2, KVH*D]")
    cap, f = kv.shape[1], kv.shape[3]
    _build.require(f % d == 0, name, "kv row width must be KVH*D")
    kvh = f // d
    _build.require(h % kvh == 0, name, "heads must be a multiple of KVH")
    _build.require(scales.shape == (b, cap, 2, kvh)
                   and scales.dtype == torch.bfloat16, name,
                   "scales must be bf16 [B, cap, 2, KVH]")
    _build.require(tail.dim() == 4 and tail.shape[0] == b
                   and tail.shape[2:] == (2, f)
                   and tail.dtype == torch.bfloat16, name,
                   "tail must be bf16 [B, R, 2, KVH*D]")
    _build.require(lengths.shape == (b,) and lengths.dtype == torch.int32,
                   name, "lengths must be int32 [B]")
    # The model passes the window fill + 1 (the current token is in the
    # window), so every sequence has a token to attend to.
    _build.require(1 <= tail_count <= tail.shape[1], name,
                   f"tail_count={tail_count} outside 1..R")
    return b, h, d, kvh, cap, tail.shape[1]


def decode_attn_int8_tail_plain(q, kv, scales, lengths, tail, tail_count,
                                scale=None):
    """Plain PyTorch version of the kernel (same contract)."""
    b, h, d, kvh, cap, rows = _check(q, kv, scales, lengths, tail,
                                     tail_count)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    rep = h // kvh
    qb = q.to(torch.bfloat16).to(torch.float32)
    kq = kv.reshape(b, cap, 2, kvh, d).to(torch.float32)
    sf = scales.to(torch.float32)                          # [B, cap, 2, KVH]
    kf = kq[:, :, 0].repeat_interleave(rep, dim=2)         # [B, cap, H, D]
    vf = kq[:, :, 1].repeat_interleave(rep, dim=2)
    ks = sf[:, :, 0].repeat_interleave(rep, dim=2)         # [B, cap, H]
    vs = sf[:, :, 1].repeat_interleave(rep, dim=2)
    tl = tail[:, :tail_count].to(torch.float32).reshape(
        b, tail_count, 2, kvh, d).repeat_interleave(rep, dim=3)
    s_p = torch.einsum("bhd,bchd->bhc", qb, kf) * scale * ks.transpose(1, 2)
    s_t = torch.einsum("bhd,bthd->bht", qb, tl[:, :, 0]) * scale
    n_packed = torch.clamp(lengths.to(torch.int64) - tail_count, 0, cap)
    valid = (torch.arange(cap, device=q.device)[None, :]
             < n_packed[:, None])                         # [B, cap]
    s_p = s_p.masked_fill(~valid[:, None, :], -math.inf)
    scores = torch.cat([s_p, s_t], dim=-1)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    p_p = p[..., :cap] * vs.transpose(1, 2)
    acc = (torch.einsum("bhc,bchd->bhd", p_p, vf)
           + torch.einsum("bht,bthd->bhd", p[..., cap:], tl[:, :, 1]))
    out = acc / torch.clamp(l, min=1e-30)
    return out.to(torch.bfloat16).to(torch.float32)


def decode_attn_int8_tail(q, kv, scales, lengths, tail, tail_count,
                          scale=None):
    """Decode attention for one query per sequence.

    q f32 [B, H, D]; kv int8 [B, cap, 2, KVH*D] (plane 0 K, plane 1 V);
    scales bf16 [B, cap, 2, KVH]; lengths int32 [B] counting every token
    including the tail ones; tail bf16 [B, R, 2, KVH*D]; ``tail_count`` a
    host int in 1..R (the window fill including the current token, the
    same for every sequence). Reads packed tokens
    ``[0, lengths - tail_count)`` then tail rows ``[0, tail_count)``.
    Returns f32 [B, H, D] holding bf16 values. CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    tail_count = int(tail_count)
    name = "decode_attn_int8_tail"
    if _build.on_cpu(name, q, kv, scales, lengths, tail):
        return decode_attn_int8_tail_plain(q, kv, scales, lengths, tail,
                                           tail_count, scale)
    b, h, d, kvh, cap, rows = _check(q, kv, scales, lengths, tail,
                                     tail_count)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    _build.require(d % 16 == 0 and 128 % d == 0, name,
                   f"head_dim {d} must divide 128 and be a multiple of 16")
    _build.require(fits_shared_memory(d, cap, rows), name,
                   f"capacity {cap} + window {rows} exceed shared memory")
    _build.require(all(x.is_contiguous() for x in (q, kv, scales, lengths,
                                                   tail)), name,
                   "tensors must be contiguous")
    out = torch.empty_like(q)
    fn = _build.function(name, name, "ppppppiiiiiiifp")
    err = fn(q.data_ptr(), kv.data_ptr(), scales.data_ptr(),
             lengths.data_ptr(), tail.data_ptr(), out.data_ptr(), b, h, kvh,
             d, cap, rows, tail_count, float(scale), _build.stream())
    _build.check(err, name)
    decode_attn_int8_tail.launches += 1
    return out


decode_attn_int8_tail.launches = 0
