"""Attention for the serving path.

* ``attn_reference`` ports ``rten_tpu/kernels/attention.py::_attn_reference``
  (:58-69): the prefill attention of every shape that the reference's
  ``flash_attention`` sends to its plain path (``attention.py:125-131``;
  :func:`flash_attention_takes`), head_dim 64 among them.
* ``flash_attention`` (CUDA, ``csrc/prefill_attn.cu``, F1) replaces
  ``flash_attention`` (:118): blockwise attention with an online softmax
  at f32 accuracy (split-TF32 tensor-core products), at head_dim 128.
* ``decode_attn_int8_tail`` (CUDA, ``csrc/decode_attn_int8_tail.cu``)
  replaces ``flash_decode_flat`` (:1715) in its int8 + tail mode:
  packed int8 tokens dequantized by per-(token, head) bf16 scales, then
  the bf16 tail window; with ``q_bf16`` (the default) q and the output
  rounded to bf16, without it (``RTEN_FLAT_QBF16=0``) both exact.
* ``decode_attn_int8`` launches the same kernel without a tail: it
  replaces ``flash_decode_flat`` in its int8 mode without a tail
  (``tail=None``). It has a launch count of its own; both count per
  ``q_bf16`` mode too ("bf16", "exact").
* ``decode_attn_int8_partials`` (CUDA, ``csrc/decode_attn_grouped_int8.cu``
  on the KV-group kernel in its partials modes, at :func:`rows_plan`)
  replaces ``flash_decode_flat(partials=True)``: the unnormalized state for
  a merge across capacity shards, with q rounded to bf16 or exact.
* ``decode_attn_float`` (CUDA, ``csrc/decode_attn_float.cu``, K6, on the
  KV-group kernel of ``csrc/decode_attn_kv_group.cuh`` in its exact mode)
  replaces ``flash_decode_grouped`` (:1039), ``flash_decode_fused`` (:318)
  and ``flash_decode_stream`` (:542) on float caches: f32 q, an f32 or
  bf16 cache read as f32, f32 sums and output. ``decode_attn_flat_float``
  (K8, the same source and kernel in its flat mode) replaces
  ``flash_decode_flat``'s float mode (:1715, ``q_bf16``) with its
  roundings. ``decode_attn_native_dots`` (a kernel of its own in the same
  source) adds the roundings of ``flash_decode_grouped``'s
  ``native_dots``.
* ``decode_attn_split_kv`` (CUDA, ``csrc/decode_attn_split.cu``, K9, the
  KV-group kernel in its exact mode over separate K and V planes, at
  :func:`rows_plan`) replaces ``flash_decode`` (:2647).
* ``decode_attn_paged`` and ``decode_attn_paged_grid`` (P3 and its grid
  mode, f32 pools) and ``decode_attn_paged_int8`` (P3i) (CUDA,
  ``csrc/decode_attn_paged.cu``, on the KV-group kernel of
  ``csrc/decode_attn_kv_group.cuh``: one block per KV head for its whole
  query group, rows staged in shared memory a tile at a time) replace
  ``flash_decode_paged_grouped`` (:2272) in its float and int8 modes and
  ``flash_decode_paged`` (:2573): decode attention over a block-paged
  pool through the page table.
* ``verify_attn_grouped`` and ``verify_attn_fused`` (CUDA,
  ``csrc/verify_attn.cu`` on the KV-group kernel, one kernel, V1) replace
  ``flash_verify_grouped`` (:1957) and ``flash_verify_fused`` (:2394): S
  speculative-verify queries per sequence, causal within the chunk, over
  a float or int8 cache; a block serves the S x rep (query, head) rows of
  a KV head's group (:func:`verify_plan`).
* ``decode_attn_grouped_int8`` (G1) and ``decode_attn_fused_int8`` (G2)
  (CUDA, ``csrc/decode_attn_grouped_int8.cu``) replace the int8 modes of
  ``flash_decode_grouped`` (:1039; exact q, and ``int8_scores``) and
  ``flash_decode_fused`` (:318): one query per sequence over an int8
  cache, q and the output in f32; with ``pv_int8`` the P.V dot runs on
  row-quantized probabilities, as the reference's ``pv_int8``. G1 without
  ``pv_int8`` and G2 run P3i's KV-group kernel on contiguous rows;
  ``pv_int8`` runs a block walk.
* ``decode_attn_grouped_append`` (CUDA, ``csrc/decode_attn_append.cu``, A1,
  on the KV-group kernel with the write fused) replaces
  ``flash_decode_grouped_append`` (:976): the float-cache decode append and
  the grouped float decode in one launch.

:func:`int8_decode_kernel` is the reference's choice among K1', G1 and G2
for an int8 cache without a tail window, :func:`float_decode_kernel` its
choice between K8 and K6 for a float cache.
"""

from __future__ import annotations

import math
import os

import torch

from . import _build
from .cache import FLOAT_CACHE_DTYPES, _rows

NEG_INF = -1e30


def attn_reference(q, k, v, causal, scale, lengths=None):
    """q [B, H, Sq, D], k/v [B, H, Sk, D] → [B, H, Sq, D]. Masked scores
    take -1e30 as in the reference (a fully masked row stays finite).
    Inputs below f32 (bf16 compute) take the softmax as ``jax.nn.softmax``
    computes it in their dtype: exp(s - max) rounded, then divided by its
    sum (``torch.softmax`` would round only its f32 result)."""
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
    if scores.dtype == torch.float32:
        probs = torch.softmax(scores, dim=-1)
    else:
        e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
        probs = e / e.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


# The int8 kernel aims for this many blocks: with fewer (head, sequence)
# pairs, each sequence's tokens split into chunks of about INT8_MIN_CHUNK
# or more that blocks of their own read, merged by a second launch.
INT8_TARGET_BLOCKS = 4096
INT8_MIN_CHUNK = 128


def int8_chunks(batch, heads, n_max):
    """(chunk, splits) of the int8 kernel for sequences of up to ``n_max``
    tokens (capacity plus window rows): the tokens of a sequence split
    into ``splits`` chunks of ``chunk`` tokens, a multiple of the 64 that
    one pass of the block's four warps covers."""
    n_max = max(n_max, 1)
    splits = max(1, min(-(-n_max // INT8_MIN_CHUNK),
                        INT8_TARGET_BLOCKS // max(batch * heads, 1)))
    per_split = -(-n_max // splits)
    chunk = -(-per_split // 64) * 64
    return chunk, -(-n_max // chunk)


def flat_group_for(batch):
    """The reference's flat-kernel group width for an int8 batch
    (``rten_tpu/models/transformer.py:355-360``); 0 means the batch has no
    group, so the reference takes neither the tail window nor the flat
    kernel."""
    return next((g for g in (16, 8, 4, 2)
                 if batch % g == 0 and batch >= 2 * g), 0)


# The reference's flat kernel fits its buffers to a TPU core's memory
# (transformer.py:339-363, attention.py:1752-1773, engine.py:241-279); the
# port copies that arithmetic as a rule, so both packages pick the same
# kernel, and so the same numerics, for a configuration. It is no limit of
# the port's kernels.
FLAT_VMEM_BUDGET = 13 * 1024 * 1024
E_MATRIX_BUDGET = 4 * 1024 * 1024


def flat_q_bf16():
    """``RTEN_FLAT_QBF16`` as the reference reads it, at call time
    (transformer.py:394, :411-413, :441; engine.py:266-268): q rounded to
    bf16 in every ``flash_decode_flat`` call unless it is "0"."""
    return os.environ.get("RTEN_FLAT_QBF16", "1") != "0"


def flat_long_ctx():
    """``RTEN_FLAT_LONGCTX`` as the reference reads it, at call time
    (transformer.py:411-413, engine.py:268): long-capacity int8 caches go
    to the flat kernel unless it is "0" (they need ``flat_q_bf16`` too).

    The reference's other flat knobs stay unread: ``RTEN_FLAT_DYNQ`` and
    ``RTEN_FLAT_QSTREAM`` choose how the TPU kernel moves q into its
    VMEM, ``RTEN_FLUSH_CARRY`` how its window flush carries rows, and
    ``RTEN_ABLATE_TAIL_ROUND`` is a profiling ablation whose output is
    wrong by design."""
    return os.environ.get("RTEN_FLAT_LONGCTX", "1") != "0"


def flat_vmem_bytes(heads, head_dim, kvh, group, block_k, window):
    """The reference's ``flat_vmem_bytes`` with ``q_bf16``
    (transformer.py:339-352)."""
    f_tot = kvh * head_dim
    hp8 = -(-heads // 8) * 8
    return (2 * group * (block_k // 4) * 2 * f_tot * 4
            + 2 * group * (block_k // 2) * 128 * 4
            + group * hp8 * f_tot * 4
            + group * window * 2 * f_tot * 2
            + 2 * hp8 * group * 128 * 4
            + hp8 * head_dim * f_tot * 2)


def _grouped_or_fused(batch, group, cap, block_k, int8_scores, quant=True):
    """``flash_decode_grouped``'s own fallback (attention.py:1062-1065):
    the fused kernel when the batch does not divide by the group or the
    capacity by the block (or, on an int8 cache, the block by 4)."""
    block_k = min(block_k, cap)
    if batch % group or cap % block_k or quant and block_k % 4:
        return "fused", 0
    return ("grouped_scores" if int8_scores else "grouped"), group


def int8_decode_kernel(batch, heads, head_dim, kvh, cap, decode_attn="auto",
                       quant_int8_scores=True):
    """The kernel that the reference's decode dispatch runs for one query
    per sequence over an int8 cache without a tail window, and its group:
    ("flat", g) → K1' (``flash_decode_flat``, q rounded to bf16);
    ("flat_exact", g) → K1' with exact q (``RTEN_FLAT_QBF16=0``);
    ("grouped", g) → G1 with exact q and ("grouped_scores", g) → G1 with
    ``int8_scores`` (``flash_decode_grouped``); ("fused", 0) → G2
    (``flash_decode_fused``). The port's kernels have no group: it is
    returned so tests can hold the choice to the reference's.
    ``RTEN_FLAT_QBF16`` and ``RTEN_FLAT_LONGCTX`` are read at call time,
    as the reference reads them."""
    kind = decode_attn
    if kind == "stream":
        kind = "fused"                  # transformer.py:379-380
    long_ctx = cap >= 2048              # :381
    group = flat_group_for(batch)       # :382
    blk = 128 if long_ctx else 64       # :383
    q_bf16 = flat_q_bf16()
    if kind == "auto":
        # :396-417: long capacities take the flat kernel only with both
        # knobs on.
        flat_long = (long_ctx and flat_long_ctx() and q_bf16
                     and cap % blk == 0)
        kind = ("flat" if group and (not long_ctx or flat_long)
                else "grouped" if group else "fused")
    if kind == "flat" and long_ctx and batch % 8 == 0 and batch >= 16:
        group = 8                       # :418-425
    if kind == "flat" and group:
        # :440-451: with q_bf16, widen to 32 where the modeled buffers fit
        # (no window).
        if q_bf16 and batch % 32 == 0 and batch >= 64 and group < 32 and \
                flat_vmem_bytes(heads, head_dim, kvh, 32, blk, 0) \
                <= FLAT_VMEM_BUDGET:
            group = 32
        # flash_decode_flat (attention.py:1752-1773): the E matrix
        # round8(H)·D·KVH·D (bf16 with q_bf16, else f32) must fit 4 MB,
        # the batch divide by the group, the capacity by the block and the
        # block by 4; otherwise grouped with exact q (int8_scores off),
        # whose own fallback is fused.
        block_k = min(blk, cap)
        e_bytes = (-(-heads // 8) * 8 * head_dim * kvh * head_dim
                   * (2 if q_bf16 else 4))
        if (batch % group == 0 and cap % block_k == 0 and block_k % 4 == 0
                and e_bytes <= E_MATRIX_BUDGET):
            return ("flat" if q_bf16 else "flat_exact"), group
        return _grouped_or_fused(batch, group, cap, block_k, False)
    if kind in ("grouped", "flat"):
        # :480-486: int8_scores below group 16 at short capacities.
        return _grouped_or_fused(
            batch, group or 8, cap, blk,
            group < 16 and not long_ctx and quant_int8_scores)
    return "fused", 0                   # :491-492


def float_decode_kernel(batch, heads, head_dim, kvh, cap, decode_attn="auto"):
    """The kernel that the reference's decode dispatch runs for one query
    per sequence over a float (f32 or bf16) cache, and its group
    (``_pallas_decode_attn``, transformer.py:366-492, reading
    ``RTEN_FLAT_QBF16`` at call time): ("flat", g) → K8
    (``flash_decode_flat``'s float mode, q rounded to bf16); ("flat_exact",
    g) → that mode with exact q (``RTEN_FLAT_QBF16=0``), whose arithmetic
    is K6's; ("grouped", g), ("fused", 0) and ("stream", 0) → K6, which has
    the numerics of all three. The float path has no group widening and no
    long-capacity group 8 (:418-425 and :440-451 are for int8 caches)."""
    group = group_for(batch)            # :382, float groups
    blk = 128 if cap >= 2048 else 64    # :381-383
    kind = decode_attn
    if kind == "auto":                  # :415-417: float caches stay grouped
        kind = "grouped" if group else "fused"
    if kind == "flat" and group:
        # flash_decode_flat (attention.py:1752-1773): the E matrix
        # round8(H)·D·KVH·D (bf16 with q_bf16, else f32) must fit 4 MB and
        # the capacity divide by the block; otherwise grouped, whose own
        # fallback is fused.
        q_bf16 = flat_q_bf16()
        block_k = min(blk, cap)
        e_bytes = (-(-heads // 8) * 8 * head_dim * kvh * head_dim
                   * (2 if q_bf16 else 4))
        if cap % block_k == 0 and e_bytes <= E_MATRIX_BUDGET:
            return ("flat" if q_bf16 else "flat_exact"), group
        return _grouped_or_fused(batch, group, cap, block_k, False, False)
    if kind in ("grouped", "flat"):     # :480-486
        return _grouped_or_fused(batch, group or 8, cap, blk, False, False)
    return kind, 0                      # "fused", "stream"


def _check(name, q, kv, scales, lengths, tail, tail_count):
    """Shapes of the int8 kernel's arguments; ``tail`` None is the no-tail
    mode (``tail_count`` 0, no window rows)."""
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
    _build.require(lengths.shape == (b,) and lengths.dtype == torch.int32,
                   name, "lengths must be int32 [B]")
    if tail is None:
        _build.require(tail_count == 0, name, "no tail: tail_count must be 0")
        return b, h, d, kvh, cap, 0
    _build.require(tail.dim() == 4 and tail.shape[0] == b
                   and tail.shape[2:] == (2, f)
                   and tail.dtype == torch.bfloat16, name,
                   "tail must be bf16 [B, R, 2, KVH*D]")
    # The model passes the window fill + 1 (the current token is in the
    # window), so every sequence has a token to attend to.
    _build.require(1 <= tail_count <= tail.shape[1], name,
                   f"tail_count={tail_count} outside 1..R")
    return b, h, d, kvh, cap, tail.shape[1]


def _int8_flat_state(q, kv, scales, lengths, tail, tail_count, scale,
                     q_bf16):
    """The int8 kernel's arithmetic in plain PyTorch: (acc, m, l) of one
    query per (sequence, head) over the packed tokens and the tail rows,
    acc = sum p * v_scale * v and l = sum p against the global max m (-inf
    where a sequence has no token, whose acc and l are 0)."""
    b, h, d, kvh, cap, rows = _check("decode_attn_int8_tail", q, kv, scales,
                                     lengths, tail, tail_count)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    rep = h // kvh
    qb = _bf16(q) if q_bf16 else q
    kq = kv.reshape(b, cap, 2, kvh, d).to(torch.float32)
    sf = scales.to(torch.float32)                          # [B, cap, 2, KVH]
    kf = kq[:, :, 0].repeat_interleave(rep, dim=2)         # [B, cap, H, D]
    vf = kq[:, :, 1].repeat_interleave(rep, dim=2)
    ks = sf[:, :, 0].repeat_interleave(rep, dim=2)         # [B, cap, H]
    vs = sf[:, :, 1].repeat_interleave(rep, dim=2)
    tl = (torch.zeros((b, 0, 2, kvh, d), device=q.device) if tail is None
          else tail[:, :tail_count].to(torch.float32).reshape(
              b, tail_count, 2, kvh, d)).repeat_interleave(rep, dim=3)
    s_p = torch.einsum("bhd,bchd->bhc", qb, kf) * scale * ks.transpose(1, 2)
    s_t = torch.einsum("bhd,bthd->bht", qb, tl[:, :, 0]) * scale
    n_packed = torch.clamp(lengths.to(torch.int64) - tail_count, 0, cap)
    valid = (torch.arange(cap, device=q.device)[None, :]
             < n_packed[:, None])                         # [B, cap]
    s_p = s_p.masked_fill(~valid[:, None, :], -math.inf)
    scores = torch.cat([s_p, s_t], dim=-1)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - torch.where(torch.isfinite(m), m,
                                       torch.zeros_like(m)))  # no token
    l = p.sum(dim=-1, keepdim=True)
    p_p = p[..., :cap] * vs.transpose(1, 2)
    acc = (torch.einsum("bhc,bchd->bhd", p_p, vf)
           + torch.einsum("bht,bthd->bhd", p[..., cap:], tl[:, :, 1]))
    return acc, m, l


def _bf16(x):
    """x rounded to bf16 (nearest even), kept in f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def decode_attn_int8_tail_plain(q, kv, scales, lengths, tail=None,
                                tail_count=0, scale=None, q_bf16=True):
    """Plain PyTorch version of the kernel (same contract); ``tail`` None
    is the no-tail mode of ``decode_attn_int8``."""
    acc, _, l = _int8_flat_state(q, kv, scales, lengths, tail, tail_count,
                                 scale, q_bf16)
    out = acc / torch.clamp(l, min=1e-30)
    return _bf16(out) if q_bf16 else out


def _launch_int8(wrapper, q, kv, scales, lengths, tail, tail_count, scale,
                 q_bf16):
    """The int8 kernel on CUDA tensors, with or without the tail, q rounded
    to bf16 or exact; counts the launch on ``wrapper``, and per mode
    ("bf16", "exact") in its ``mode_launches``."""
    name = wrapper.__name__
    b, h, d, kvh, cap, rows = _check(name, q, kv, scales, lengths, tail,
                                     tail_count)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    _build.require(d in (64, 128), name, f"head_dim {d} must be 64 or 128")
    tensors = (q, kv, scales, lengths) + (() if tail is None else (tail,))
    _build.require(all(x.is_contiguous() for x in tensors), name,
                   "tensors must be contiguous")
    out = torch.empty_like(q)
    chunk, splits = int8_chunks(b, h, cap + rows)
    part = (torch.empty((b, h, splits, d + 2), dtype=torch.float32,
                        device=q.device) if splits > 1 else None)
    fn = _build.function("decode_attn_int8_tail", "decode_attn_int8_tail",
                         "pppppppiiiiiiiiiifp")
    err = fn(q.data_ptr(), kv.data_ptr(), scales.data_ptr(),
             lengths.data_ptr(), None if tail is None else tail.data_ptr(),
             out.data_ptr(), None if part is None else part.data_ptr(), b,
             h, kvh, d, cap, rows, tail_count, chunk, splits, int(q_bf16),
             float(scale), _build.stream())
    _build.check(err, name)
    wrapper.launches += 1
    wrapper.mode_launches["bf16" if q_bf16 else "exact"] += 1
    return out


def decode_attn_int8_tail(q, kv, scales, lengths, tail, tail_count,
                          scale=None, q_bf16=True):
    """Decode attention for one query per sequence.

    q f32 [B, H, D]; kv int8 [B, cap, 2, KVH*D] (plane 0 K, plane 1 V);
    scales bf16 [B, cap, 2, KVH]; lengths int32 [B] counting every token
    including the tail ones; tail bf16 [B, R, 2, KVH*D]; ``tail_count`` a
    host int in 1..R (the window fill including the current token, the
    same for every sequence). Reads packed tokens
    ``[0, lengths - tail_count)`` then tail rows ``[0, tail_count)``.
    Returns f32 [B, H, D] holding bf16 values; with ``q_bf16=False``
    (``flash_decode_flat(q_bf16=False)``, ``RTEN_FLAT_QBF16=0``) q enters
    exact and the output is not rounded. CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    tail_count = int(tail_count)
    if _build.on_cpu("decode_attn_int8_tail", q, kv, scales, lengths, tail):
        return decode_attn_int8_tail_plain(q, kv, scales, lengths, tail,
                                           tail_count, scale, q_bf16)
    return _launch_int8(decode_attn_int8_tail, q, kv, scales, lengths, tail,
                        tail_count, scale, q_bf16)


decode_attn_int8_tail.launches = 0
decode_attn_int8_tail.mode_launches = {"bf16": 0, "exact": 0}


def decode_attn_int8_plain(q, kv, scales, lengths, scale=None, q_bf16=True):
    """Plain PyTorch version of ``decode_attn_int8`` (same contract)."""
    return decode_attn_int8_tail_plain(q, kv, scales, lengths, None, 0,
                                       scale, q_bf16)


def decode_attn_int8(q, kv, scales, lengths, scale=None, q_bf16=True):
    """Decode attention over an int8 cache without a tail window: the
    tail kernel's contract with no window rows. Reads tokens
    ``[0, min(lengths, cap))``; q and the output are rounded to bf16, or
    with ``q_bf16=False`` both stay exact. Returns f32 [B, H, D]. CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if _build.on_cpu("decode_attn_int8", q, kv, scales, lengths):
        return decode_attn_int8_plain(q, kv, scales, lengths, scale, q_bf16)
    return _launch_int8(decode_attn_int8, q, kv, scales, lengths, None, 0,
                        scale, q_bf16)


decode_attn_int8.launches = 0
decode_attn_int8.mode_launches = {"bf16": 0, "exact": 0}


def int8_partials_check(batch, heads, head_dim, kvh, cap, q_bf16=True):
    """Raise where the reference's partials decode raises: its caller's
    flat group (``flat_group_for``, transformer.py:384-395, which asserts
    one) and block (128 at capacity >= 2048, else 64), then
    ``flash_decode_flat``'s shape rule (attention.py:1752-1762): the
    capacity divides by the block, the block by 4, and the E matrix (bf16
    with ``q_bf16``, else f32) fits 4 MB (the group divides the batch by
    construction)."""
    name = "decode_attn_int8_partials"
    group = flat_group_for(batch)
    _build.require(group > 0, name, f"batch {batch} has no flat group")
    block_k = min(128 if cap >= 2048 else 64, cap)
    e_bytes = (-(-heads // 8) * 8 * head_dim * kvh * head_dim
               * (2 if q_bf16 else 4))
    _build.require(not (cap % block_k or block_k % 4
                        or e_bytes > E_MATRIX_BUDGET), name,
                   f"shape unsupported (b={batch}, group={group}, "
                   f"cap={cap}, block_k={block_k}, E {e_bytes} bytes)")


def decode_attn_int8_partials_plain(q, kv, scales, lengths, q_bf16=True,
                                    scale=None):
    """Plain PyTorch version of ``decode_attn_int8_partials`` (same
    contract)."""
    b, h, d = q.shape
    int8_partials_check(b, h, d, kv.shape[3] // d, kv.shape[1], q_bf16)
    acc, m, l = _int8_flat_state(q, kv, scales, lengths, None, 0, scale,
                                 q_bf16)
    m = torch.where(torch.isfinite(m), m, torch.full_like(m, NEG_INF))
    return torch.cat([_bf16(acc) if q_bf16 else acc, m, l], dim=-1)


def decode_attn_int8_partials(q, kv, scales, lengths, q_bf16=True,
                              scale=None):
    """The partials mode of ``flash_decode_flat`` (attention.py:1745-1751,
    1628-1656, 1897-1913): decode attention over an int8 cache without a
    tail, returned unnormalized for a merge across capacity shards.

    Arguments as ``decode_attn_int8``; ``q_bf16`` rounds q to bf16 (the
    seq-sharded caller's default) or keeps it exact. Returns f32
    [B, H, D + 2]: lanes 0..D-1 the accumulator sum p * v_scale * v
    (rounded to bf16 with ``q_bf16``), lane D the max score m, lane D + 1
    the sum l of p = exp(score - m). A sequence with no token (lengths <=
    0) returns acc 0, m = -1e30 and l 0, which weigh nothing in the merge
    out = sum acc exp(m - M) / sum l exp(m - M) (the reference returns
    other acc and l there, which its merge weighs by 0 as well). Raises at
    the shapes where the reference raises (:func:`int8_partials_check`).
    The kernel: the KV-group kernel in its partials mode at
    :func:`rows_plan` (one CUDA kernel a call: the splits merge in their
    cluster; head_dim 64 or 128). CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    name = "decode_attn_int8_partials"
    if _build.on_cpu(name, q, kv, scales, lengths):
        return decode_attn_int8_partials_plain(q, kv, scales, lengths,
                                               q_bf16, scale)
    b, h, d = q.shape
    int8_partials_check(b, h, d, kv.shape[3] // d, kv.shape[1], q_bf16)
    return _launch_grouped_int8_rows(q, kv, scales, lengths, False, scale,
                                     wrapper=decode_attn_int8_partials,
                                     q_bf16=q_bf16)


decode_attn_int8_partials.launches = 0


def _check_float(q, kv, lengths, name="decode_attn_float"):
    b, h, d = q.shape
    _build.require(q.dtype == torch.float32, name, "q must be f32 [B, H, D]")
    _build.require(kv.dim() == 4 and kv.shape[0] == b and kv.shape[2] == 2
                   and kv.dtype in FLOAT_CACHE_DTYPES, name,
                   "kv must be f32 or bf16 [B, cap, 2, KVH*D]")
    cap, f = kv.shape[1], kv.shape[3]
    _build.require(f % d == 0 and h % (f // d) == 0, name,
                   "kv row width must be KVH*D with H a multiple of KVH")
    _build.require(lengths.shape == (b,) and lengths.dtype == torch.int32,
                   name, "lengths must be int32 [B]")
    return b, h, d, f // d, cap


def _softmax_attend(q, k, v, valid, scale, ks=None, vs=None):
    """One query per sequence, an exact two-pass softmax in f32: q
    [B, H, D], k/v [B, cap, H, D], valid bool [B, cap]. With int8 scales
    ks/vs [B, H, cap] the scores are multiplied by ks and p by vs after
    the sum l (the reference's int8 paged numerics). Zeros where no token
    is valid."""
    s = torch.einsum("bhd,bchd->bhc", q, k) * scale
    if ks is not None:
        s = s * ks
    s = s.masked_fill(~valid[:, None, :], -math.inf)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))  # no token
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if vs is not None:
        p = p * vs
    return torch.einsum("bhc,bchd->bhd", p, v) / torch.clamp(l, min=1e-30)


def _live(lengths, cap):
    """bool [B, cap]: token t of sequence b is below its length."""
    return (torch.arange(cap, device=lengths.device)[None, :]
            < lengths.to(torch.int64)[:, None])


def _float_plain(name, q, kv, lengths, scale, flat=False):
    """The float kernel's contract in plain PyTorch, an exact two-pass
    softmax in f32; ``flat`` (K8) rounds q and every K element to bf16
    before the score dot and the output to bf16."""
    b, h, d, kvh, cap = _check_float(q, kv, lengths, name)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    rep = h // kvh
    x = kv.reshape(b, cap, 2, kvh, d).to(torch.float32)
    k = x[:, :, 0].repeat_interleave(rep, dim=2)           # [B, cap, H, D]
    v = x[:, :, 1].repeat_interleave(rep, dim=2)
    if flat:
        q, k = _bf16(q), _bf16(k)
    out = _softmax_attend(q, k, v, _live(lengths, cap), scale)
    return _bf16(out) if flat else out


def _launch_rows_float(wrapper, q, kv, lengths, scale, plan=None):
    """K6 (``decode_attn_float``) or K8 (``decode_attn_flat_float``) on CUDA
    tensors: the KV-group kernel over the float cache in the wrapper's mode
    (the C entry of the wrapper's name in ``csrc/decode_attn_float.cu``) at
    ``plan`` (default :func:`rows_plan`'s); counts the launch on
    ``wrapper``."""
    name = wrapper.__name__
    b, h, d, kvh, cap = _check_float(q, kv, lengths, name)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    _kv_group_head_dim(name, d)
    plan = plan or rows_plan(b, h, kvh, cap, d)
    _check_kv_group(name, (q, kv, lengths), plan)
    out = torch.empty_like(q)
    fn = _build.function("decode_attn_float", name, "ppppiiiiiiiiiiifp")
    err = fn(q.data_ptr(), kv.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             b, h, kvh, d, cap, int(kv.dtype == torch.bfloat16),
             plan["splits"], plan["unit"], plan["heads_per_warp"],
             plan["head_groups"], plan["warps"], float(scale),
             _build.stream())
    _build.check(err, name)
    wrapper.launches += 1
    return out


def decode_attn_float_plain(q, kv, lengths, scale=None):
    """Plain PyTorch version of ``decode_attn_float`` (same contract): an
    exact two-pass softmax in f32."""
    return _float_plain("decode_attn_float", q, kv, lengths, scale)


def decode_attn_float(q, kv, lengths, scale=None):
    """Decode attention for one query per sequence over a float cache: the
    contract of ``flash_decode_grouped`` (attention.py:1039), of
    ``flash_decode_fused`` (:318) and of ``flash_decode_stream`` (:542) in
    their float modes.

    q f32 [B, H, D]; kv f32 or bf16 [B, cap, 2, KVH*D] (plane 0 K, plane 1
    V); lengths int32 [B]. Reads tokens ``[0, min(max(lengths, 0), cap))``;
    scores, softmax and sums in f32. Returns f32 [B, H, D] (zeros where a
    length is 0). CPU tensors take the plain version; CUDA tensors launch
    the kernel (the KV-group kernel in its exact mode, a block per KV head
    for up to 8 query heads of its group, :func:`rows_plan`; head_dim 64 to
    256 in steps of 64; the cache 16-byte aligned) or raise."""
    if _build.on_cpu("decode_attn_float", q, kv, lengths):
        return decode_attn_float_plain(q, kv, lengths, scale)
    return _launch_rows_float(decode_attn_float, q, kv, lengths, scale)


decode_attn_float.launches = 0


def decode_attn_flat_float_plain(q, kv, lengths, scale=None):
    """Plain PyTorch version of ``decode_attn_flat_float`` (same
    contract)."""
    return _float_plain("decode_attn_flat_float", q, kv, lengths, scale,
                        flat=True)


def decode_attn_flat_float(q, kv, lengths, scale=None):
    """Decode attention over a float cache with the numerics of
    ``flash_decode_flat``'s float mode (attention.py:1715,
    ``_decode_flat_kernel``) under ``q_bf16`` (``RTEN_FLAT_QBF16``, on by
    default): q enters rounded to bf16, every K element is cast to bf16
    before the score dot (``kblk.astype(qx.dtype)``, so an f32 cache's K
    rounds too), the softmax and P.V run in f32 on V as stored, and the
    normalized output is rounded to bf16 (its cast before the one-hot
    compaction dot), returned as f32. The reference's exact mode
    (``q_bf16=False``) is ``decode_attn_float``'s arithmetic.

    Arguments, reads and the no-token rule as ``decode_attn_float``. The
    reference's choice of this mode is :func:`float_decode_kernel`. CPU
    tensors take the plain version; CUDA tensors launch the kernel (the
    KV-group kernel in its flat mode, a block per KV head for up to 8
    query heads of its group, :func:`rows_plan`; head_dim 64 to 256 in
    steps of 64) or raise."""
    if _build.on_cpu("decode_attn_flat_float", q, kv, lengths):
        return decode_attn_flat_float_plain(q, kv, lengths, scale)
    return _launch_rows_float(decode_attn_flat_float, q, kv, lengths,
                              scale)


decode_attn_flat_float.launches = 0


def _native_block(b, cap, block_k, group):
    """The block of ``flash_decode_grouped`` (min(block_k, cap)), or 0 where
    its own fallback (attention.py:1062-1065) drops ``native_dots`` for the
    exact fused kernel."""
    if _grouped_or_fused(b, group, cap, block_k, False, False)[0] == "fused":
        return 0
    return min(block_k, cap)


def decode_attn_native_dots_plain(q, kv, lengths, block_k=64, group=8,
                                  scale=None):
    """Plain PyTorch version of ``decode_attn_native_dots`` (same
    contract)."""
    name = "decode_attn_native_dots"
    blk = _native_block(q.shape[0], kv.shape[1], block_k, group)
    if not blk:
        return decode_attn_float_plain(q, kv, lengths, scale)
    b, h, d, kvh, cap = _check_float(q, kv, lengths, name)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    n = min(-(-_live_rows(lengths, cap) // blk) * blk, cap)  # whole blocks
    x = kv[:, :n].reshape(b, n, 2, kvh, d).to(torch.float32)
    qn = q.to(kv.dtype).to(torch.float32).reshape(b, kvh, h // kvh, d)
    s = torch.einsum("bgrd,bngd->bgrn", qn, x[:, :, 0]) * scale
    return _attend_blocks(s, x[:, :, 1], lengths, blk, p_dtype=kv.dtype)


def decode_attn_native_dots(q, kv, lengths, block_k=64, group=8, scale=None):
    """``flash_decode_grouped``'s float mode with ``native_dots``
    (attention.py:1145, 653-685): q cast to the cache dtype before the
    score dot and p cast to it before P.V (the sum l takes the unrounded
    p), both dots summing in f32. The reference rounds p = exp(s - m_i)
    with m_i its running max after each block of min(``block_k``, cap)
    rows, so this does too (:func:`_attend_blocks`). On a bf16 cache q and
    p round to bf16; on an f32 cache this is ``decode_attn_float``'s
    arithmetic. Where the reference's grouped kernel falls back to the
    fused one (the batch does not divide by ``group`` or the capacity by
    the block), native_dots is dropped and this returns
    ``decode_attn_float`` (K6, counted there).

    Arguments as ``decode_attn_float``. CPU tensors take the plain version;
    CUDA tensors launch the kernel (on a bf16 cache the KV-group kernel in
    its native mode at :func:`block_plan`'s one-split launch, on an f32
    cache K6's launch; head_dim 64 to 256 in steps of 64) or raise."""
    name = "decode_attn_native_dots"
    if _build.on_cpu(name, q, kv, lengths):
        return decode_attn_native_dots_plain(q, kv, lengths, block_k, group,
                                             scale)
    blk = _native_block(q.shape[0], kv.shape[1], block_k, group)
    if not blk:
        return decode_attn_float(q, kv, lengths, scale)
    return _launch_native_dots(q, kv, lengths, blk, scale)


def _launch_native_dots(q, kv, lengths, blk, scale, plan=None):
    """native_dots over reference blocks of ``blk`` rows on CUDA tensors, at
    ``plan`` (default: :func:`block_plan`'s one split on a bf16 cache,
    :func:`rows_plan`'s on an f32 one); counts the launch."""
    name = "decode_attn_native_dots"
    b, h, d, kvh, cap = _check_float(q, kv, lengths, name)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    _kv_group_head_dim(name, d)
    bf16 = kv.dtype == torch.bfloat16
    plan = plan or (block_plan(b, h, kvh, cap, blk, d, native=True)
                    if bf16 else rows_plan(b, h, kvh, cap, d))
    _check_kv_group(name, (q, kv, lengths), plan)
    _build.require(not bf16 or (plan["splits"], plan["unit"]) == (1, blk),
                   name, f"native_dots takes one split of whole blocks of "
                   f"{blk} rows (its rounding of p depends on the max from "
                   f"row 0), got {plan['splits']} split(s) of "
                   f"{plan['unit']}-row units")
    out = torch.empty_like(q)
    fn = _build.function("decode_attn_float", name, "ppppiiiiiiiiiiifp")
    err = fn(q.data_ptr(), kv.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             b, h, kvh, d, cap, int(bf16), plan["splits"], plan["unit"],
             plan["heads_per_warp"], plan["head_groups"], plan["warps"],
             float(scale), _build.stream())
    _build.check(err, name)
    decode_attn_native_dots.launches += 1
    return out


decode_attn_native_dots.launches = 0


# -- K9: single-query decode over separate K and V caches ---------------------

SPLIT_KV_BLOCK = 256               # flash_decode's block_k (its default)


def split_kv_takes_kernel(s, d):
    """Whether the reference's ``flash_decode`` (at its default block_k)
    runs its kernel at these shapes (attention.py:2660): S >= block_k,
    S % block_k == 0 and d % 128 == 0; every other shape takes
    ``_attn_reference``."""
    return s >= SPLIT_KV_BLOCK and s % SPLIT_KV_BLOCK == 0 and d % 128 == 0


def _check_split(q, k_cache, v_cache, lengths):
    name = "decode_attn_split_kv"
    b, h, d = q.shape
    _build.require(q.dtype == torch.float32, name, "q must be f32 [B, H, D]")
    _build.require(k_cache.dim() == 4 and k_cache.shape[0] == b
                   and k_cache.shape[3] == d
                   and v_cache.shape == k_cache.shape
                   and k_cache.dtype == v_cache.dtype
                   and k_cache.dtype in FLOAT_CACHE_DTYPES, name,
                   "k_cache and v_cache must be f32 or bf16 [B, KVH, S, D]")
    kvh, s = k_cache.shape[1], k_cache.shape[2]
    _build.require(h % kvh == 0, name, "heads must be a multiple of KVH")
    _build.require(lengths.shape == (b,) and lengths.dtype == torch.int32,
                   name, "lengths must be int32 [B]")
    return b, h, d, kvh, s


def decode_attn_split_kv_plain(q, k_cache, v_cache, lengths, scale=None):
    """Plain PyTorch version of ``decode_attn_split_kv`` (same contract:
    the kernel's arithmetic at the kernel's shapes, ``attn_reference``
    elsewhere)."""
    b, h, d, kvh, s = _check_split(q, k_cache, v_cache, lengths)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    rep = h // kvh
    k = k_cache.to(torch.float32).repeat_interleave(rep, dim=1)
    v = v_cache.to(torch.float32).repeat_interleave(rep, dim=1)
    if not split_kv_takes_kernel(s, d):
        return attn_reference(q[:, :, None], k, v, False, scale,
                              lengths)[:, :, 0]
    return _softmax_attend(q, k.transpose(1, 2), v.transpose(1, 2),
                           _live(lengths, s), scale)


def _launch_split_kv(q, k_cache, v_cache, lengths, scale, plan=None):
    """K9 on CUDA tensors at a kernel shape: the KV-group kernel in its
    exact mode over the two planes (``csrc/decode_attn_split.cu``) at
    ``plan`` (default :func:`rows_plan`'s); counts the launch."""
    name = "decode_attn_split_kv"
    b, h, d, kvh, s = _check_split(q, k_cache, v_cache, lengths)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    _build.require(d in (128, 256), name, f"head_dim {d}: the kernel takes "
                   f"128 or 256")
    plan = plan or rows_plan(b, h, kvh, s, d)
    _check_kv_group(name, (q, k_cache, v_cache, lengths), plan)
    _build.require(v_cache.data_ptr() % 16 == 0, name,
                   "v_cache must be 16-byte aligned (16-byte copies)")
    out = torch.empty_like(q)
    fn = _build.function("decode_attn_split", name, "pppppiiiiiiiiiiifp")
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             lengths.data_ptr(), out.data_ptr(), b, h, kvh, d, s,
             int(k_cache.dtype == torch.bfloat16), plan["splits"],
             plan["unit"], plan["heads_per_warp"], plan["head_groups"],
             plan["warps"], float(scale), _build.stream())
    _build.check(err, name)
    decode_attn_split_kv.launches += 1
    return out


def decode_attn_split_kv(q, k_cache, v_cache, lengths, scale=None):
    """Single-step decode attention over separate caches, the contract of
    the reference's ``flash_decode`` (attention.py:2647): q f32 [B, H, D];
    k_cache, v_cache f32 or bf16 [B, KVH, S, D] (H a multiple of KVH);
    lengths int32 [B]. Returns f32 [B, H, D].

    The reference's own choice is copied: at S >= 256, S % 256 == 0 and
    d % 128 == 0 (:func:`split_kv_takes_kernel`) its kernel runs —
    here K9: rows t < min(lengths, S), f32 scores, softmax and sums, zeros
    where lengths <= 0 (every block is skipped); at every other shape its
    ``_attn_reference`` runs (``attn_reference`` here, on either device,
    no launch): masked scores take -1e30, so lengths 0 gives the mean of
    V over all S rows. CPU tensors take the plain version; CUDA tensors at
    the kernel's shapes launch the kernel (the KV-group kernel in its exact
    mode, a block per KV head for up to 8 query heads of its group,
    :func:`rows_plan`; head_dim 128 or 256; both planes 16-byte aligned)
    or raise."""
    name = "decode_attn_split_kv"
    if _build.on_cpu(name, q, k_cache, v_cache, lengths):
        return decode_attn_split_kv_plain(q, k_cache, v_cache, lengths,
                                          scale)
    _, _, d, _, s = _check_split(q, k_cache, v_cache, lengths)
    if not split_kv_takes_kernel(s, d):
        return decode_attn_split_kv_plain(q, k_cache, v_cache, lengths,
                                          scale)
    return _launch_split_kv(q, k_cache, v_cache, lengths, scale)


decode_attn_split_kv.launches = 0


def group_for(batch):
    """The reference's group width in (8, 4, 2) for a batch: paged decode
    (``rten_tpu/models/transformer.py:504-505``), chunked verify (:757-758)
    and the float mode of the flat kernel (:358); 0 means the batch has no
    group."""
    return next((g for g in (8, 4, 2) if batch % g == 0 and batch >= 2 * g),
                0)


def _check_paged(name, q, pool, scales, table, lengths):
    """Shapes of the paged kernels' arguments; ``scales`` None is a float
    pool (f32, or bf16 under bf16 compute)."""
    b, h, d = q.shape
    _build.require(q.dtype == torch.float32, name, "q must be f32 [B, H, D]")
    dtypes = FLOAT_CACHE_DTYPES if scales is None else (torch.int8,)
    _build.require(pool.dim() == 4 and pool.shape[2] == 2
                   and pool.dtype in dtypes, name,
                   f"pool must be {dtypes} [n_pages, page, 2, KVH*D]")
    n_pages, page, _, f = pool.shape
    _build.require(f % d == 0 and h % (f // d) == 0, name,
                   "pool row width must be KVH*D with H a multiple of KVH")
    kvh = f // d
    if scales is not None:
        _build.require(scales.shape == (n_pages, page, 2, kvh)
                       and scales.dtype == torch.bfloat16, name,
                       "scales must be bf16 [n_pages, page, 2, KVH]")
    _build.require(table.dim() == 2 and table.shape[0] == b
                   and table.dtype == torch.int32, name,
                   "table must be int32 [B, max_pages]")
    _build.require(lengths.shape == (b,) and lengths.dtype == torch.int32,
                   name, "lengths must be int32 [B]")
    return b, h, d, kvh, page, table.shape[1]


def _paged_plain(name, q, pool, scales, table, lengths, scale,
                 mask_unmapped):
    """The paged kernels' contract in plain PyTorch: the pages gathered
    into [B, P*page] token rows (unmapped ids read page 0), then
    :func:`_softmax_attend` over tokens ``[0, min(lengths, P*page))``;
    ``mask_unmapped`` also masks the tokens of unmapped pages."""
    b, h, d, kvh, page, n_p = _check_paged(name, q, pool, scales, table,
                                           lengths)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    rep, cap = h // kvh, n_p * page
    ids = table.to(torch.int64)
    safe = ids.clamp(min=0)
    x = pool[safe].reshape(b, cap, 2, kvh, d).to(torch.float32)
    k = x[:, :, 0].repeat_interleave(rep, dim=2)           # [B, cap, H, D]
    v = x[:, :, 1].repeat_interleave(rep, dim=2)
    ks = vs = None
    if scales is not None:
        sf = scales[safe].reshape(b, cap, 2, kvh).to(torch.float32)
        ks = sf[:, :, 0].repeat_interleave(rep, dim=2).transpose(1, 2)
        vs = sf[:, :, 1].repeat_interleave(rep, dim=2).transpose(1, 2)
    valid = _live(lengths, cap)
    if mask_unmapped:
        valid &= (ids >= 0).repeat_interleave(page, dim=1)
    return _softmax_attend(q, k, v, valid, scale, ks, vs)


# -- the KV-group kernel: one block per (sequence, KV head[, split]) ---------
# csrc/decode_attn_kv_group.cuh moves its rows a tile at a time through a
# ring of stages in shared memory and serves every query row of the KV
# head's group from it: P3i (int8 pool), P3 and its grid mode (f32 pool), G1
# with pv_int8 or without and G2 (contiguous int8 rows), K6, K8, A1 and
# native_dots (contiguous f32 or bf16 rows; A1 writes the new row too), K9
# (separate f32 or bf16 K and V planes) and V1 (contiguous f32, bf16 or
# int8 rows; S x rep query rows a group). A
# sequence splits into chunks (one thread-block cluster, merged in the same
# launch) only where B x KVH leaves the card short of this many blocks, and
# a launch of at most two blocks an SM gives each block 8 warps, not 4.
# At path (H)'s G1 (128 pairs) 2 splits of 8 warps took 0.0238 ms against
# 0.0283-0.0353 for 4 warps at 1-4 splits; at path (D)'s P3i (3072 blocks)
# 4 warps took 0.0400 against 0.0473 for 8; over f32 and bf16 rows 4 warps
# were within 1% of 8 or faster at 3072 blocks ((E), (I), (I-bf16)) and 8
# warps 7% faster at TinyLlama's K8 (256 blocks) (python -m
# rten_tpu_torch.tools.kv_group_variants, H100 80GB HBM3, 700 W).
KV_GROUP_TARGET_BLOCKS = 256
KV_GROUP_WIDE_BLOCKS = 2 * 132
KV_GROUP_MAX_SPLITS = 8            # a cluster's portable size
KV_GROUP_MAX_IDS = 256             # page ids a paged block stages
KV_GROUP_UNIT = 16                 # the chunk unit of contiguous rows


def _pow2_at_least(n):
    return 1 << max(n - 1, 0).bit_length()


def kv_group_heads(rep, head_dim):
    """(query rows a warp serves, row groups of warps a block) for a group
    of ``rep`` query rows (the query heads of a KV head, or a verify
    chunk's S x rep pairs): a warp's q and accumulators hold at most 32
    values a lane (head_dim / 8 a row), a block at most 4 row groups and 8
    rows (4 above head_dim 128); a larger group takes more blocks. These
    are the tilings ``decode_attn_kv_group.cuh`` builds."""
    w = min(256 // head_dim, _pow2_at_least(rep))
    return w, min(4, 8 // w, _pow2_at_least(-(-rep // w)))


def kv_group_chunks(n, splits, unit):
    """The rows [c0, c1) of each split of a sequence with ``n`` live rows,
    as the kernel computes them: chunks of ceil(n / splits) rows rounded up
    to whole units, the last ones short or empty."""
    per = -(-n // splits)
    chunk = -(-per // unit) * unit
    out = []
    for s in range(splits):
        c0 = min(n, s * chunk)
        out.append((c0, min(n, c0 + chunk)))
    return out


def _kv_group_plan(batch, heads, kvh, head_dim, unit, most_units, fewest,
                   splits, warps, per_sm=2):
    """The plan's choice with ``per_sm`` 8-warp blocks an SM (2, or 1 where
    a block's registers allow one): splits up to per_sm / 2 x
    KV_GROUP_TARGET_BLOCKS blocks, 8 warps up to per_sm / 2 x
    KV_GROUP_WIDE_BLOCKS."""
    rep = heads // kvh
    w, groups = kv_group_heads(rep, head_dim)
    pairs = batch * kvh * -(-rep // (w * groups))
    most = max(1, min(KV_GROUP_MAX_SPLITS, most_units))
    if splits is None:
        target = KV_GROUP_TARGET_BLOCKS * per_sm // 2
        splits = max(fewest, min(most, -(-target // max(pairs, 1))))
    wide = KV_GROUP_WIDE_BLOCKS * per_sm // 2
    return dict(splits=splits, unit=unit, fewest=fewest, most=most,
                blocks=pairs * splits, heads_per_warp=w, head_groups=groups,
                warps=warps or (8 if pairs * splits <= wide else 4))


def paged_plan(batch, heads, kvh, page, max_pages, head_dim=64, splits=None,
               warps=None):
    """The launch of the KV-group kernel over a paged pool (P3i's int8 one,
    P3's f32 one): one block per (sequence, KV head, split) for up to 8
    query heads of the KV head's group (4 above head_dim 128;
    :func:`kv_group_heads`); ``splits`` chunks of whole pages a sequence
    (``kv_group_chunks`` with unit = page), more than one only where the
    blocks fall short of KV_GROUP_TARGET_BLOCKS, and at least enough that a
    chunk holds at most KV_GROUP_MAX_IDS page ids. One CUDA kernel a call
    (the splits merge inside their cluster); no scratch. The kernel sizes
    its ring from the element type. ``splits`` and ``warps`` override the
    choice (tests and measurement)."""
    fewest = -(-max_pages // KV_GROUP_MAX_IDS)
    return _kv_group_plan(batch, heads, kvh, head_dim, page, max_pages,
                          fewest, splits, warps)


def rows_plan(batch, heads, kvh, cap, head_dim=128, splits=None, warps=None):
    """The launch of the KV-group kernel over a contiguous cache (G1's int8
    rows, exact q or int8 scores, without ``pv_int8``, and G2's; K6's, K8's
    and A1's f32 or bf16 rows; K9's separate f32 or bf16 planes, ``cap``
    their S): the plan of :func:`paged_plan` with chunks of whole
    KV_GROUP_UNIT-row units."""
    return _kv_group_plan(batch, heads, kvh, head_dim, KV_GROUP_UNIT,
                          -(-cap // KV_GROUP_UNIT), 1, splits, warps)


def block_plan(batch, heads, kvh, cap, block, head_dim=128, splits=None,
               warps=None, native=False):
    """The launch of the KV-group kernel in a block mode (``native_dots`` on
    a bf16 cache, ``pv_int8``: one max per reference block of ``block``
    rows, counted from row 0, for the whole head group): :func:`rows_plan`'s
    plan with chunks of whole blocks, so no block crosses a split.
    ``native`` (``native_dots``: its bf16 rounding of p depends on the
    prefix max from row 0, which a later split cannot know) allows one
    split only. ``pv_int8`` at a tiling whose warps hold 32 values a lane
    per array (q, the accumulators and the block's integer sums) takes
    over 128 registers a thread, so one 8-warp block fits an SM, not two:
    its targets of blocks halve."""
    w, _ = kv_group_heads(heads // kvh, head_dim)
    per_sm = 1 if not native and w * head_dim // 8 == 32 else 2
    most = 1 if native else -(-cap // block)
    return _kv_group_plan(batch, heads, kvh, head_dim, block, most, 1,
                          splits, warps, per_sm)


def verify_plan(batch, s, heads, kvh, cap, head_dim=64, splits=None,
                warps=None):
    """The launch of the KV-group kernel for V1 (``verify_attn_grouped`` and
    ``verify_attn_fused``, f32, bf16 or int8 rows): :func:`rows_plan`'s
    plan for a group of S x rep query rows (query i, head h; row i * rep +
    h), each with its own causal limit. A sequence's chunks cover rows
    ``[0, min(lengths + S, cap))`` (``kv_group_chunks``)."""
    return rows_plan(batch, s * heads, kvh, cap, head_dim, splits, warps)


def _check_kv_group(name, tensors, plan):
    """The refusals of the KV-group kernel at ``plan``, before any build;
    ``tensors`` (q, the cache or pool, ...)."""
    _build.require(all(x.is_contiguous() for x in tensors), name,
                   "tensors must be contiguous")
    _build.require(tensors[1].data_ptr() % 16 == 0, name,
                   "the cache must be 16-byte aligned (16-byte copies)")
    _build.require(plan["fewest"] <= plan["splits"] <= plan["most"], name,
                   f"splits must lie in [{plan['fewest']}, {plan['most']}] "
                   f"(at most {KV_GROUP_MAX_SPLITS} chunks of at most "
                   f"{KV_GROUP_MAX_IDS} pages), got {plan['splits']}")
    _build.require(plan["warps"] in (4, 8), name,
                   f"warps must be 4 or 8, got {plan['warps']}")


def _kv_group_head_dim(name, d):
    _build.require(d in (64, 128, 192, 256), name,
                   f"head_dim {d} must be one of (64, 128, 192, 256)")


def _launch_paged(wrapper, q, pool, table, lengths, scale, mask_unmapped,
                  plan=None):
    """P3 (``mask_unmapped`` False) or its grid mode (True) on CUDA tensors:
    the KV-group kernel over an f32 or bf16 pool at ``plan`` (default
    :func:`paged_plan`'s); counts the launch on ``wrapper``."""
    name = wrapper.__name__
    b, h, d, kvh, page, n_p = _check_paged(name, q, pool, None, table,
                                           lengths)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    _kv_group_head_dim(name, d)
    plan = plan or paged_plan(b, h, kvh, page, n_p, d)
    _check_kv_group(name, (q, pool, table, lengths), plan)
    out = torch.empty_like(q)
    fn = _build.function("decode_attn_paged", "decode_attn_paged",
                         "pppppiiiiiiiiiiiifp")
    err = fn(q.data_ptr(), pool.data_ptr(), table.data_ptr(),
             lengths.data_ptr(), out.data_ptr(), b, h, kvh, d, page, n_p,
             int(mask_unmapped), int(pool.dtype == torch.bfloat16),
             plan["splits"], plan["heads_per_warp"],
             plan["head_groups"], plan["warps"], float(scale),
             _build.stream())
    _build.check(err, name)
    wrapper.launches += 1
    return out


def _launch_paged_int8(q, pool, scales, table, lengths, scale, plan=None):
    """P3i's kernel on CUDA tensors at ``plan`` (default
    :func:`paged_plan`'s); counts the launch."""
    name = "decode_attn_paged_int8"
    b, h, d, kvh, page, n_p = _check_paged(name, q, pool, scales, table,
                                           lengths)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    _kv_group_head_dim(name, d)
    plan = plan or paged_plan(b, h, kvh, page, n_p, d)
    _check_kv_group(name, (q, pool, scales, table, lengths), plan)
    out = torch.empty_like(q)
    fn = _build.function("decode_attn_paged", "decode_attn_paged_int8",
                         "ppppppiiiiiiiiiifp")
    err = fn(q.data_ptr(), pool.data_ptr(), scales.data_ptr(),
             table.data_ptr(), lengths.data_ptr(), out.data_ptr(), b, h, kvh,
             d, page, n_p, plan["splits"], plan["heads_per_warp"],
             plan["head_groups"], plan["warps"], float(scale),
             _build.stream())
    _build.check(err, name)
    decode_attn_paged_int8.launches += 1
    return out


def decode_attn_paged_plain(q, pool, table, lengths, scale=None):
    """Plain PyTorch version of ``decode_attn_paged`` (same contract)."""
    return _paged_plain("decode_attn_paged", q, pool, None, table, lengths,
                        scale, False)


def decode_attn_paged(q, pool, table, lengths, scale=None):
    """Decode attention for one query per sequence over a float block-paged
    pool — the contract of ``flash_decode_paged_grouped``'s float mode.

    q f32 [B, H, D]; pool f32 or bf16 (its values widened exactly)
    [n_pages, page, 2, KVH*D]; table int32
    [B, P] page ids; lengths int32 [B]. Token t of sequence b is read at
    ``pool[table[b, t // page], t % page]`` for t < min(lengths, P*page);
    like the reference's grouped kernel, an unmapped (-1) page inside the
    length reads pool page 0 (only a released slot has one, and the engine
    discards its rows). Returns f32 [B, H, D]. CPU tensors take the plain
    version; CUDA tensors launch the kernel (the KV-group kernel, a block
    per KV head for up to 8 query heads of its group, :func:`paged_plan`;
    head_dim 64 to 256 in steps of 64) or raise."""
    name = "decode_attn_paged"
    if _build.on_cpu(name, q, pool, table, lengths):
        return decode_attn_paged_plain(q, pool, table, lengths, scale)
    return _launch_paged(decode_attn_paged, q, pool, table, lengths, scale,
                         False)


decode_attn_paged.launches = 0


def decode_attn_paged_grid_plain(q, pool, table, lengths, scale=None):
    """Plain PyTorch version of ``decode_attn_paged_grid`` (same
    contract)."""
    return _paged_plain("decode_attn_paged_grid", q, pool, None, table,
                        lengths, scale, True)


def decode_attn_paged_grid(q, pool, table, lengths, scale=None):
    """``decode_attn_paged`` with ``flash_decode_paged``'s rule for an
    unmapped page inside the length: its tokens are masked (a sequence
    with no mapped token gets zeros). The kernel of ``decode_attn_paged``,
    with a launch count of its own. CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise."""
    name = "decode_attn_paged_grid"
    if _build.on_cpu(name, q, pool, table, lengths):
        return decode_attn_paged_grid_plain(q, pool, table, lengths, scale)
    return _launch_paged(decode_attn_paged_grid, q, pool, table, lengths,
                         scale, True)


decode_attn_paged_grid.launches = 0


def decode_attn_paged_int8_plain(q, pool, scales, table, lengths,
                                 scale=None):
    """Plain PyTorch version of ``decode_attn_paged_int8`` (same
    contract)."""
    return _paged_plain("decode_attn_paged_int8", q, pool, scales, table,
                        lengths, scale, False)


def decode_attn_paged_int8(q, pool, scales, table, lengths, scale=None):
    """Decode attention over an int8 block-paged pool — the contract of
    ``flash_decode_paged_grouped``'s int8 mode (attention.py:2157-2255):
    score = ((q . k_int8) * scale) * k_scale, the softmax sum over the
    unscaled p, V weighted by p * v_scale; q and the output stay f32 (no
    bf16 rounding, unlike ``decode_attn_int8``). Addressing as
    ``decode_attn_paged``.

    pool int8 [n_pages, page, 2, KVH*D]; scales bf16 [n_pages, page, 2,
    KVH]; the rest as ``decode_attn_paged``. CPU tensors take the plain
    version; CUDA tensors launch the kernel (head_dim 64, 128, 192 or
    256) or raise."""
    name = "decode_attn_paged_int8"
    if _build.on_cpu(name, q, pool, scales, table, lengths):
        return decode_attn_paged_int8_plain(q, pool, scales, table, lengths,
                                            scale)
    return _launch_paged_int8(q, pool, scales, table, lengths, scale)


decode_attn_paged_int8.launches = 0


VERIFY_MAX_S = 8                   # verify chunk: the last token + 7 drafts


def _check_verify(name, q, kv, scales, lengths):
    """Shapes of the verify kernel's arguments; ``scales`` None is a float
    cache."""
    _build.require(q.dim() == 4 and q.dtype == torch.float32, name,
                   "q must be f32 [B, S, H, D]")
    b, s, h, d = q.shape
    _build.require(1 <= s <= VERIFY_MAX_S, name,
                   f"S={s} outside 1..{VERIFY_MAX_S}")
    dtypes = FLOAT_CACHE_DTYPES if scales is None else (torch.int8,)
    _build.require(kv.dim() == 4 and kv.shape[0] == b and kv.shape[2] == 2
                   and kv.dtype in dtypes, name,
                   "kv must be [B, cap, 2, KVH*D], f32 or bf16 (int8 with "
                   "scales)")
    cap, f = kv.shape[1], kv.shape[3]
    _build.require(f % d == 0 and h % (f // d) == 0, name,
                   "kv row width must be KVH*D with H a multiple of KVH")
    kvh = f // d
    if scales is not None:
        _build.require(scales.shape == (b, cap, 2, kvh)
                       and scales.dtype == torch.bfloat16, name,
                       "scales must be bf16 [B, cap, 2, KVH]")
    _build.require(lengths.shape == (b,) and lengths.dtype == torch.int32,
                   name, "lengths must be int32 [B]")
    return b, s, h, d, kvh, cap


def _verify_plain(name, q, kv, scales, lengths, scale):
    """The verify contract in plain PyTorch (the reference's
    ``_chunk_reference`` with the int8 rule): query i of sequence b reads
    rows ``t < lengths[b] + i + 1``; an exact two-pass softmax in f32."""
    b, s, h, d, kvh, cap = _check_verify(name, q, kv, scales, lengths)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    rep = h // kvh
    x = kv.reshape(b, cap, 2, kvh, d).to(torch.float32)
    k = x[:, :, 0].repeat_interleave(rep, dim=2)           # [B, cap, H, D]
    v = x[:, :, 1].repeat_interleave(rep, dim=2)
    sc = torch.einsum("bshd,bchd->bhsc", q, k) * scale
    if scales is not None:
        sf = scales.to(torch.float32).repeat_interleave(rep, dim=3)
        sc = sc * sf[:, :, 0].transpose(1, 2)[:, :, None, :]
    limit = (lengths.to(torch.int64)[:, None] + 1
             + torch.arange(s, device=q.device)[None, :])   # [B, S]
    valid = torch.arange(cap, device=q.device)[None, None, :] < limit[..., None]
    sc = sc.masked_fill(~valid[:, None], -math.inf)
    m = sc.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))  # no row
    p = torch.exp(sc - m)
    l = p.sum(dim=-1, keepdim=True)
    if scales is not None:
        p = p * sf[:, :, 1].transpose(1, 2)[:, :, None, :]
    out = torch.einsum("bhsc,bchd->bhsd", p, v) / torch.clamp(l, min=1e-30)
    return out.transpose(1, 2).contiguous()


def _launch_verify(wrapper, q, kv, scales, lengths, scale, plan=None):
    """V1 on CUDA tensors in both modes: the KV-group kernel at ``plan``
    (default :func:`verify_plan`'s); counts the launch on ``wrapper`` and
    in its mode."""
    name = wrapper.__name__
    b, s, h, d, kvh, cap = _check_verify(name, q, kv, scales, lengths)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    _build.require(d in (64, 128), name,
                   f"head_dim {d} must be one of (64, 128)")
    plan = plan or verify_plan(b, s, h, kvh, cap, d)
    _check_kv_group(name, (q, kv, lengths) + (
        () if scales is None else (scales,)), plan)
    out = torch.empty_like(q)
    kind = 2 if scales is not None else int(kv.dtype == torch.bfloat16)
    fn = _build.function("verify_attn", "verify_attn",
                         "pppppiiiiiiiiiiiifp")
    err = fn(q.data_ptr(), kv.data_ptr(),
             None if scales is None else scales.data_ptr(),
             lengths.data_ptr(), out.data_ptr(), b, s, h, kvh, d, cap, kind,
             plan["splits"], plan["unit"], plan["heads_per_warp"],
             plan["head_groups"], plan["warps"], float(scale),
             _build.stream())
    _build.check(err, name)
    wrapper.launches += 1
    wrapper.mode_launches["float" if scales is None else "int8"] += 1
    return out


def verify_attn_grouped_plain(q, kv, lengths, scales=None, scale=None):
    """Plain PyTorch version of ``verify_attn_grouped`` (same contract)."""
    return _verify_plain("verify_attn_grouped", q, kv, scales, lengths,
                         scale)


def verify_attn_grouped(q, kv, lengths, scales=None, scale=None):
    """Chunked-verify attention, the contract of ``flash_verify_grouped``
    (the reference takes it for a batch with a group in (8, 4, 2)).

    q f32 [B, S, H, D], S <= 8, at positions ``lengths .. lengths + S - 1``
    (the chunk is already appended); kv [B, cap, 2, KVH*D] f32 or bf16, or
    int8 with ``scales`` bf16 [B, cap, 2, KVH] (the int8 mode: score =
    ((q . k_int8) * scale) * k_scale, the softmax sum over the unscaled p,
    V weighted by p * v_scale); lengths int32 [B], the counts before the
    chunk. Query i reads rows ``t < min(lengths + i + 1, cap)``; scores,
    softmax and sums in f32, no bf16 rounding. Returns f32 [B, S, H, D].
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise (the KV-group kernel, :func:`verify_plan`; head_dim 64 or 128).
    Launches count in ``launches`` and per mode in ``mode_launches``."""
    name = "verify_attn_grouped"
    extra = () if scales is None else (scales,)
    if _build.on_cpu(name, q, kv, lengths, *extra):
        return verify_attn_grouped_plain(q, kv, lengths, scales, scale)
    return _launch_verify(verify_attn_grouped, q, kv, scales, lengths, scale)


verify_attn_grouped.launches = 0
verify_attn_grouped.mode_launches = {"float": 0, "int8": 0}


def verify_attn_fused_plain(q, kv, lengths, scales=None, scale=None):
    """Plain PyTorch version of ``verify_attn_fused`` (same contract)."""
    return _verify_plain("verify_attn_fused", q, kv, scales, lengths, scale)


def verify_attn_fused(q, kv, lengths, scales=None, scale=None):
    """``verify_attn_grouped``'s contract for the batches the reference
    sends to ``flash_verify_fused`` (no group: 1-3 and odd). The kernel of
    ``verify_attn_grouped``, with launch counts of its own."""
    name = "verify_attn_fused"
    extra = () if scales is None else (scales,)
    if _build.on_cpu(name, q, kv, lengths, *extra):
        return verify_attn_fused_plain(q, kv, lengths, scales, scale)
    return _launch_verify(verify_attn_fused, q, kv, scales, lengths, scale)


verify_attn_fused.launches = 0
verify_attn_fused.mode_launches = {"float": 0, "int8": 0}


# -- F1: prefill attention ----------------------------------------------------

FLASH_BLOCK = 128                  # the reference's block_q and block_k


def flash_attention_takes(s_q, s_k, d):
    """Whether the reference's ``flash_attention`` runs its kernel at these
    shapes (attention.py:125-131): d % 128 == 0, s_q >= 8, s_k >= 128 and
    both lengths divide by their block, min(128, s). Every other shape
    takes ``attn_reference``."""
    return (s_q >= 8 and s_k >= FLASH_BLOCK and d % 128 == 0
            and s_q % min(FLASH_BLOCK, s_q) == 0
            and s_k % min(FLASH_BLOCK, s_k) == 0)


def _check_flash(q, k, v):
    name = "flash_attention"
    _build.require(q.dim() == 4 and q.dtype == torch.float32, name,
                   "q must be f32 [B, H, S, D]")
    _build.require(k.shape == q.shape and v.shape == q.shape
                   and k.dtype == v.dtype == torch.float32, name,
                   "k and v must be f32 of q's shape [B, H, S, D]")
    _build.require(flash_attention_takes(q.shape[2], k.shape[2],
                                         q.shape[3]), name,
                   f"shape {tuple(q.shape)} is one the reference sends to "
                   f"attn_reference (flash_attention_takes)")
    return q.shape


def flash_attention_plain(q, k, v, causal=True, scale=None):
    """Plain PyTorch version of ``flash_attention`` (same contract): the
    reference's ``_attn_reference`` arithmetic."""
    d = _check_flash(q, k, v)[3]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    return attn_reference(q, k, v, causal, scale)


def flash_attention(q, k, v, causal=True, scale=None):
    """Self-attention of S queries over S keys, the contract of the
    reference's ``flash_attention`` kernel: q, k, v f32 [B, H, S, D] (k and
    v already repeated to H heads), query i reads keys j <= i when
    ``causal``; scores, online softmax and sums in f32, out = acc /
    max(l, 1e-30). Only at the shapes of :func:`flash_attention_takes`;
    the kernel takes d = 128. Returns f32 [B, H, S, D]. CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise."""
    name = "flash_attention"
    if _build.on_cpu(name, q, k, v):
        return flash_attention_plain(q, k, v, causal, scale)
    b, h, s, d = _check_flash(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    _build.require(d == 128, name, f"head_dim {d}: the kernel takes 128")
    _build.require(all(x.is_contiguous() for x in (q, k, v)), name,
                   "tensors must be contiguous")
    out = torch.empty_like(q)
    fn = _build.function("prefill_attn", "prefill_attn", "ppppiiiiifp")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h,
             s, d, int(bool(causal)), float(scale), _build.stream())
    _build.check(err, name)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


# -- G1 and G2: single-query decode over an int8 cache ------------------------

def quantize_q_rows(q):
    """The reference's row quantization of q for ``int8_scores``
    (attention.py:1102-1106): per (sequence, head) absmax / 127, 1.0 where
    the row is 0, q8 = clip(round_half_even(q / scale), -127, 127).
    q f32 [..., D] → (q8 f32 [..., D] holding integers, scale f32 [...])."""
    absmax = q.abs().amax(dim=-1)
    qs = torch.where(absmax == 0, torch.ones_like(absmax),
                     absmax / torch.full_like(absmax, 127.0))
    return torch.clamp(torch.round(q / qs[..., None]), -127, 127), qs


def _check_int8_decode(name, q, kv, scales, lengths):
    b, h, d = q.shape
    _build.require(q.dtype == torch.float32, name, "q must be f32 [B, H, D]")
    _build.require(kv.dim() == 4 and kv.shape[0] == b and kv.shape[2] == 2
                   and kv.dtype == torch.int8, name,
                   "kv must be int8 [B, cap, 2, KVH*D]")
    cap, f = kv.shape[1], kv.shape[3]
    _build.require(f % d == 0 and h % (f // d) == 0, name,
                   "kv row width must be KVH*D with H a multiple of KVH")
    kvh = f // d
    _build.require(scales.shape == (b, cap, 2, kvh)
                   and scales.dtype == torch.bfloat16, name,
                   "scales must be bf16 [B, cap, 2, KVH]")
    _build.require(lengths.shape == (b,) and lengths.dtype == torch.int32,
                   name, "lengths must be int32 [B]")
    return b, h, d, kvh, cap


def _live_rows(lengths, cap):
    """The rows any sequence reads, min(max(lengths), cap) (a host read;
    the plain versions read no more of the cache than that)."""
    return min(max(int(lengths.max()), 0), cap) if lengths.numel() else 0


def int8_score_dots_plain(q, kv, lengths):
    """The integer score dots of ``int8_scores``: sum_d q8[b, h, d] *
    k8[b, t, kv head of h, d] as int32 [B, H, cap] for t < min(lengths,
    cap), 0 elsewhere. Taken in f32 and exact: every partial sum is an
    integer of magnitude below 127 * 127 * D < 2^24 (D <= 1024)."""
    b, h, d = q.shape
    cap, kvh = kv.shape[1], kv.shape[3] // d
    n = _live_rows(lengths, cap)
    q8, _ = quantize_q_rows(q)
    k8 = kv[:, :n, 0].reshape(b, n, kvh, d).to(torch.float32)
    dots = torch.einsum("bgrd,bngd->bgrn", q8.reshape(b, kvh, h // kvh, d),
                        k8).reshape(b, h, n)
    dots = dots.masked_fill(~_live(lengths, n)[:, None, :], 0)
    out = torch.zeros((b, h, cap), dtype=torch.int32, device=q.device)
    out[:, :, :n] = dots.to(torch.int32)
    return out


def _attend_live(s, v, lengths, v_scale=None):
    """An exact two-pass softmax in f32 over the live rows, grouped by KV
    head (no repeated K/V): scores s [B, KVH, rep, n], V rows v [B, n, KVH,
    D]; with int8 scales v_scale [B, KVH, 1, n] weighs p after the sum l.
    Returns [B, KVH * rep, D], zeros where a length is 0."""
    b, kvh, rep, n = s.shape
    if n == 0:                                  # no sequence has a row
        return s.new_zeros((b, kvh * rep, v.shape[-1]))
    s = s.masked_fill(~_live(lengths, n)[:, None, None, :], -math.inf)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))  # no token
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if v_scale is not None:
        p = p * v_scale
    out = torch.einsum("bgrn,bngd->bgrd", p, v)
    return (out / torch.clamp(l, min=1e-30)).reshape(b, kvh * rep, -1)


def _int8_decode_plain(name, q, kv, scales, lengths, scale, int8_scores,
                       pv_block=0):
    """The int8 decode contract of G1 and G2 in plain PyTorch, over the
    live rows only: exact q, s = ((q . k8) * scale) * k_scale, or with
    ``int8_scores`` s = (f32(q8 . k8) * (q_scale * scale)) * k_scale; then
    :func:`_attend_live` with V weighted by p * v_scale, or with
    ``pv_block`` (> 0) :func:`_attend_blocks` over blocks of that many
    rows."""
    b, h, d, kvh, cap = _check_int8_decode(name, q, kv, scales, lengths)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    rep, n = h // kvh, _live_rows(lengths, cap)
    if pv_block:
        n = min(-(-n // pv_block) * pv_block, cap)   # whole blocks
    x = kv[:, :n].reshape(b, n, 2, kvh, d).to(torch.float32)
    sf = scales[:, :n].to(torch.float32).permute(0, 3, 2, 1)  # [B,KVH,2,n]
    if int8_scores:
        q8, qs = quantize_q_rows(q)
        s = torch.einsum("bgrd,bngd->bgrn", q8.reshape(b, kvh, rep, d),
                         x[:, :, 0])
        s = s * (qs * scale).reshape(b, kvh, rep, 1)
    else:
        s = torch.einsum("bgrd,bngd->bgrn", q.reshape(b, kvh, rep, d),
                         x[:, :, 0]) * scale
    if pv_block:
        return _attend_blocks(s * sf[:, :, None, 0], x[:, :, 1], lengths,
                              pv_block, v_scale=sf[:, :, None, 1])
    return _attend_live(s * sf[:, :, None, 0], x[:, :, 1], lengths,
                        sf[:, :, None, 1])


def _attend_blocks(s, v, lengths, block_k, v_scale=None, p_dtype=None):
    """An f32 softmax over the live rows as the reference's grouped kernels
    walk them, block by block of ``block_k`` rows, for the modes whose
    arithmetic depends on the block: scores s [B, KVH, rep, n] (n a
    multiple of the block), V rows v [B, n, KVH, D] as f32. Per block i,
    m_i is the running max after it, p = exp(s - m_i) and l_i = sum p;
    ``p_dtype`` (``native_dots``): acc_i = sum p' v with p' = p rounded to
    that dtype; ``v_scale`` [B, KVH, 1, n] (``pv_int8``, attention.py:
    825-837): pm = p * v_scale, pq = max(max pm, 1e-30) / 127, p8 =
    round_half_even(pm / pq) and acc_i = f32(sum p8 v8) * pq. The blocks
    combine as acc = sum acc_i exp(m_i - m), l = sum l_i exp(m_i - m).
    Returns [B, KVH * rep, D], zeros where a length is 0."""
    b, kvh, rep, n = s.shape
    if n == 0:                                  # no sequence has a row
        return s.new_zeros((b, kvh * rep, v.shape[-1]))
    nb = n // block_k
    s = s.masked_fill(~_live(lengths, n)[:, None, None, :], -math.inf)
    s = s.reshape(b, kvh, rep, nb, block_k)
    m_i = torch.cummax(s.amax(dim=-1), dim=-1).values       # [B,KVH,rep,nb]
    m_i = torch.where(torch.isfinite(m_i), m_i, torch.zeros_like(m_i))
    p = torch.exp(s - m_i[..., None])
    l_i = p.sum(dim=-1)
    vb = v.reshape(b, nb, block_k, kvh, -1)
    if v_scale is None:
        acc_i = torch.einsum("bgrik,bikgd->bgrid",
                             p.to(p_dtype).to(torch.float32), vb)
    else:
        pm = p * v_scale.reshape(b, kvh, 1, nb, block_k)
        pq = torch.clamp(pm.amax(dim=-1), min=1e-30)
        pq = pq / torch.full_like(pq, 127.0)
        p8 = torch.round(pm / pq[..., None])
        acc_i = torch.einsum("bgrik,bikgd->bgrid", p8, vb) * pq[..., None]
    w = torch.exp(m_i - m_i[..., -1:])
    acc = (acc_i * w[..., None]).sum(dim=3)
    l = (l_i * w).sum(dim=-1, keepdim=True)
    return (acc / torch.clamp(l, min=1e-30)).reshape(b, kvh * rep, -1)


# The block of pv_int8: its integer sum of p8 * v8 (|p8| <= 127, |v8| <=
# 128) stays below 2^24, exact in f32, as the reference's int32 dot.
PV_INT8_MAX_BLOCK = 1024


def _launch_pv_int8(q, kv, scales, lengths, int8_scores, scale, pv_block,
                    plan=None):
    """G1's ``pv_int8`` mode over blocks of ``pv_block`` rows (either score
    mode) on CUDA tensors: the KV-group kernel at ``plan`` (default
    :func:`block_plan`'s); counts the launch in its mode."""
    name = "decode_attn_grouped_int8"
    _build.require(pv_block <= PV_INT8_MAX_BLOCK, name,
                   f"pv_int8 block {pv_block}: the kernel takes <= "
                   f"{PV_INT8_MAX_BLOCK} (an exact f32 sum of p8 * v8)")
    b, h, d, kvh, cap = _check_int8_decode(name, q, kv, scales, lengths)
    plan = plan or block_plan(b, h, kvh, cap, pv_block, d)
    return _launch_grouped_int8_rows(q, kv, scales, lengths, int8_scores,
                                     scale, plan=plan, pv_block=pv_block)


def _launch_grouped_int8_rows(q, kv, scales, lengths, int8_scores, scale,
                              dots=None, plan=None, wrapper=None,
                              pv_block=0, q_bf16=False):
    """G1 (both score modes; with ``pv_block`` its ``pv_int8`` mode over
    blocks of that many rows, at a :func:`block_plan` whose unit is the
    block) or, with ``wrapper`` ``decode_attn_fused_int8``, G2 (exact q),
    or with ``wrapper`` ``decode_attn_int8_partials`` the partials mode
    (exact q, rounded to bf16 with ``q_bf16``; out f32 [B, H, D + 2]) on
    CUDA tensors: the KV-group kernel at ``plan`` (default
    :func:`rows_plan`'s); counts the launch on the wrapper and, for G1, in
    its mode. ``dots`` (int32 [B, H, cap], tests only) receives the
    integer score dots of ``int8_scores`` without ``pv_int8``."""
    wrapper = wrapper or decode_attn_grouped_int8
    name = wrapper.__name__
    partials = wrapper is decode_attn_int8_partials
    b, h, d, kvh, cap = _check_int8_decode(name, q, kv, scales, lengths)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    _build.require(d in (64, 128), name,
                   f"head_dim {d} must be one of (64, 128)")
    plan = plan or rows_plan(b, h, kvh, cap, d)
    _check_kv_group(name, (q, kv, scales, lengths), plan)
    _build.require(not pv_block or plan["unit"] == pv_block, name,
                   f"pv_int8's chunks are whole blocks of {pv_block} rows, "
                   f"got a unit of {plan['unit']}")
    if dots is not None:
        _build.require(int8_scores and not pv_block
                       and dots.shape == (b, h, cap)
                       and dots.dtype == torch.int32
                       and dots.is_contiguous(), name,
                       "dots must be int32 [B, H, cap], int8_scores "
                       "without pv_int8 only")
    out = (torch.empty((b, h, d + 2), dtype=torch.float32, device=q.device)
           if partials else torch.empty_like(q))
    mode = ((5 if q_bf16 else 4) if partials
            else int(bool(int8_scores)) | (2 if pv_block else 0))
    fn = _build.function("decode_attn_grouped_int8",
                         "decode_attn_grouped_int8_rows",
                         "ppppppiiiiiiiiiiifp")
    err = fn(q.data_ptr(), kv.data_ptr(), scales.data_ptr(),
             lengths.data_ptr(), out.data_ptr(),
             None if dots is None else dots.data_ptr(), b, h, kvh, d, cap,
             mode, plan["splits"], plan["unit"], plan["heads_per_warp"],
             plan["head_groups"], plan["warps"], float(scale),
             _build.stream())
    _build.check(err, name)
    wrapper.launches += 1
    if wrapper is decode_attn_grouped_int8:
        wrapper.mode_launches[("pv_int8." if pv_block else "")
                              + ("int8_scores" if int8_scores
                                 else "exact")] += 1
    return out


def _pv_block(name, b, cap, pv_int8, block_k, group):
    """The ``pv_int8`` block of ``flash_decode_grouped`` (min(block_k,
    cap)), or 0 without ``pv_int8``; "fused" where its own fallback
    (attention.py:1062-1065) drops the mode for the exact fused kernel."""
    if not pv_int8:
        return 0
    _build.require(group > 0 and block_k > 0, name,
                   "pv_int8 needs a group and a block")
    if _grouped_or_fused(b, group, cap, block_k, False)[0] == "fused":
        return "fused"
    return min(block_k, cap)


def decode_attn_grouped_int8_plain(q, kv, scales, lengths, int8_scores=False,
                                   scale=None, pv_int8=False, block_k=64,
                                   group=8):
    """Plain PyTorch version of ``decode_attn_grouped_int8`` (same
    contract)."""
    name = "decode_attn_grouped_int8"
    blk = _pv_block(name, q.shape[0], kv.shape[1], pv_int8, block_k, group)
    if blk == "fused":
        return decode_attn_fused_int8_plain(q, kv, scales, lengths, scale)
    return _int8_decode_plain(name, q, kv, scales, lengths, scale,
                              int8_scores, blk)


def decode_attn_grouped_int8(q, kv, scales, lengths, int8_scores=False,
                             scale=None, dots=None, pv_int8=False,
                             block_k=64, group=8):
    """Decode attention for one query per sequence over an int8 cache, the
    contract of ``flash_decode_grouped``'s int8 modes
    (``_decode_grouped_quant_kernel``, attention.py:710).

    q f32 [B, H, D]; kv int8 [B, cap, 2, KVH*D] (plane 0 K, plane 1 V);
    scales bf16 [B, cap, 2, KVH] per (token, plane, head); lengths int32 [B]
    counting the current token. Reads rows ``[0, min(lengths, cap))``.
    Exact q: score = ((q . k8) * scale) * k_scale. ``int8_scores``: q
    row-quantized per (sequence, head) (:func:`quantize_q_rows`) and score =
    (f32(int32 q8 . k8) * (q_scale * scale)) * k_scale. Then an f32
    softmax whose sum l takes the unscaled p, V weighted by p * v_scale;
    out = acc / max(l, 1e-30), f32 [B, H, D].

    ``pv_int8`` (either score mode): P.V runs on probabilities
    row-quantized per block of min(``block_k``, cap) rows, as the
    reference's (:func:`_attend_blocks`, attention.py:825-837). With it,
    ``block_k`` and ``group`` are the reference's own and its fallback is
    copied: where the batch does not divide by ``group``, the capacity by
    the block or the block by 4, the reference drops ``pv_int8`` and
    ``int8_scores`` for the exact fused kernel, and this returns
    ``decode_attn_fused_int8`` (counted there). Without ``pv_int8`` the
    caller has made that choice (:func:`int8_decode_kernel`). A block
    serves up to 8 query heads of a KV head's group (:func:`rows_plan`;
    with ``pv_int8`` :func:`block_plan`, blocks of at most
    PV_INT8_MAX_BLOCK rows). head_dim 64 or 128. CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise. Launches count
    in ``launches`` and per mode in
    ``mode_launches`` ("exact", "int8_scores", "pv_int8.exact",
    "pv_int8.int8_scores")."""
    name = "decode_attn_grouped_int8"
    if _build.on_cpu(name, q, kv, scales, lengths):
        return decode_attn_grouped_int8_plain(q, kv, scales, lengths,
                                              int8_scores, scale, pv_int8,
                                              block_k, group)
    blk = _pv_block(name, q.shape[0], kv.shape[1], pv_int8, block_k, group)
    if blk == "fused":
        return decode_attn_fused_int8(q, kv, scales, lengths, scale)
    if blk:
        _build.require(dots is None, name,
                       "dots: int8_scores without pv_int8")
        return _launch_pv_int8(q, kv, scales, lengths, int8_scores, scale,
                               blk)
    return _launch_grouped_int8_rows(q, kv, scales, lengths, int8_scores,
                                     scale, dots)


decode_attn_grouped_int8.launches = 0
decode_attn_grouped_int8.mode_launches = {
    "exact": 0, "int8_scores": 0, "pv_int8.exact": 0,
    "pv_int8.int8_scores": 0}


def decode_attn_fused_int8_plain(q, kv, scales, lengths, scale=None):
    """Plain PyTorch version of ``decode_attn_fused_int8`` (same
    contract)."""
    return _int8_decode_plain("decode_attn_fused_int8", q, kv, scales,
                              lengths, scale, False)


def decode_attn_fused_int8(q, kv, scales, lengths, scale=None):
    """``decode_attn_grouped_int8``'s exact-q contract for the batches and
    capacities the reference sends to ``flash_decode_fused``'s int8 mode
    (attention.py:318; no group, or a capacity that does not divide by the
    block). G1's exact-q launch (the KV-group kernel at
    :func:`rows_plan`'s choice), with a launch count of its own. CPU
    tensors take the plain version; CUDA tensors launch the kernel (head_dim
    64 or 128) or raise."""
    name = "decode_attn_fused_int8"
    if _build.on_cpu(name, q, kv, scales, lengths):
        return decode_attn_fused_int8_plain(q, kv, scales, lengths, scale)
    return _launch_grouped_int8_rows(q, kv, scales, lengths, False, scale,
                                     wrapper=decode_attn_fused_int8)


decode_attn_fused_int8.launches = 0


# -- A1: float decode with the cache append fused -----------------------------

def _check_append_attn(q, kv, k, v, lengths):
    name = "decode_attn_grouped_append"
    b, h, d = q.shape
    _build.require(q.dtype == torch.float32, name, "q must be f32 [B, H, D]")
    _build.require(kv.dim() == 4 and kv.shape[0] == b and kv.shape[2] == 2
                   and kv.dtype in FLOAT_CACHE_DTYPES, name,
                   "kv must be f32 or bf16 [B, cap, 2, KVH*D]")
    cap, f = kv.shape[1], kv.shape[3]
    _build.require(f % d == 0 and h % (f // d) == 0, name,
                   "kv row width must be KVH*D with H a multiple of KVH")
    kvh = f // d
    _build.require(k.shape == v.shape == (b, kvh, 1, d)
                   and k.dtype == v.dtype == torch.float32, name,
                   "k and v must be f32 [B, KVH, 1, D]")
    _build.require(lengths.shape == (b,) and lengths.dtype == torch.int32,
                   name, "lengths must be int32 [B]")
    return b, h, d, kvh, cap


def decode_attn_grouped_append_plain(q, kv, k, v, lengths, scale=None):
    """Plain PyTorch version of ``decode_attn_grouped_append`` (same
    contract, the cache written in place): K5's write, then K6's contract
    over the live rows (:func:`_attend_live`)."""
    b, h, d, kvh, cap = _check_append_attn(q, kv, k, v, lengths)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    rows = torch.stack([k.reshape(b, kvh * d), v.reshape(b, kvh * d)],
                       dim=1).to(kv.dtype)
    pos = torch.clamp(lengths.to(torch.int64) - 1, 0, cap - 1)
    kv[torch.arange(b, device=kv.device), pos] = rows
    n = _live_rows(lengths, cap)
    x = kv[:, :n].reshape(b, n, 2, kvh, d).to(torch.float32)
    s = torch.einsum("bgrd,bngd->bgrn", q.reshape(b, kvh, h // kvh, d),
                     x[:, :, 0]) * scale
    return _attend_live(s, x[:, :, 1], lengths)


def decode_attn_grouped_append(q, kv, k, v, lengths, scale=None):
    """The contract of ``flash_decode_grouped_append`` (attention.py:976):
    write each sequence's new K/V row, cast to the cache dtype (bf16 by
    round to nearest even), in place at ``clip(lengths - 1, 0, cap - 1)``,
    then decode attention over the updated cache as ``decode_attn_float``.

    q f32 [B, H, D]; kv f32 or bf16 [B, cap, 2, KVH*D]; k, v f32
    [B, KVH, 1, D] (strided views are fine); lengths int32 [B] counting the
    new token. Returns f32 [B, H, D]. CPU tensors take the plain version;
    CUDA tensors launch the kernel (the KV-group kernel with the append
    fused, a block per KV head for up to 8 query heads of its group,
    :func:`rows_plan`; head_dim 64 or 128; the new rows' data pointers and
    row strides 16-byte aligned, as the model's views of its qkv output
    are) or raise."""
    name = "decode_attn_grouped_append"
    if _build.on_cpu(name, q, kv, k, v, lengths):
        return decode_attn_grouped_append_plain(q, kv, k, v, lengths, scale)
    return _launch_grouped_append(q, kv, k, v, lengths, scale)


def _launch_grouped_append(q, kv, k, v, lengths, scale, plan=None):
    """A1 on CUDA tensors: the KV-group kernel over the float cache with
    the write fused, at ``plan`` (default :func:`rows_plan`'s); counts the
    launch."""
    name = "decode_attn_grouped_append"
    b, h, d, kvh, cap = _check_append_attn(q, kv, k, v, lengths)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    _build.require(d in (64, 128), name, f"head_dim {d} must be 64 or 128")
    plan = plan or rows_plan(b, h, kvh, cap, d)
    _check_kv_group(name, (q, kv, lengths), plan)
    kr, vr = _rows(k, b, kvh * d), _rows(v, b, kvh * d)
    _build.require(all(x.data_ptr() % 16 == 0 and x.stride(0) % 4 == 0
                       for x in (kr, vr)), name,
                   "the new rows must be 16-byte aligned, pointers and row "
                   "strides (16-byte loads)")
    out = torch.empty_like(q)
    fn = _build.function("decode_attn_append", "decode_attn_append",
                         "ppppiippiiiiiiiiiiifp")
    err = fn(q.data_ptr(), kv.data_ptr(), kr.data_ptr(), vr.data_ptr(),
             kr.stride(0), vr.stride(0), lengths.data_ptr(), out.data_ptr(),
             b, h, kvh, d, cap, int(kv.dtype == torch.bfloat16),
             plan["splits"], plan["unit"], plan["heads_per_warp"],
             plan["head_groups"], plan["warps"], float(scale),
             _build.stream())
    _build.check(err, name)
    decode_attn_grouped_append.launches += 1
    return out


decode_attn_grouped_append.launches = 0
