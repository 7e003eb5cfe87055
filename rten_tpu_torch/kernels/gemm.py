"""Quantized GEMMs of the serving path.

* ``matmul_int8`` ports ``rten_tpu/kernels/gemm.py::matmul_int8`` (:72-89),
  which the JAX package leaves to an XLA dot outside any Pallas kernel:
  here ``torch._int_mm`` (exact int32 accumulation) and the same f32
  epilogue, x_scale * w_scale[col].
* ``matmul_int8_tiled`` (CUDA, ``csrc/matmul_int8.cu``, M1: ``wgmma`` s8
  over a TMA-fed ring, tiled by :func:`matmul_int8_plan`) replaces
  ``matmul_int8_pallas`` (:93), the Pallas twin of ``matmul_int8`` with
  the epilogue (f32(acc) * x_scale) * w_scale[col]. No path calls it (the
  model keeps ``matmul_int8``, whose epilogue order differs).
* ``head_argmax_int8`` (CUDA, ``csrc/head_argmax_int8.cu``) replaces
  ``matmul_argmax_int8`` (:268); :func:`head_argmax_plan` sizes its tiles
  and scratch.
* ``matmul_int8_wo`` (CUDA, the same source and tiles with a store
  epilogue) replaces ``matmul_int8_weight_only`` (:173);
  :func:`matmul_int8_wo_plan` sizes its scratch.
* ``matmul_int4_words`` (CUDA, ``csrc/matmul_int4.cu``) replaces
  ``matmul_int4_words`` (:430) in its bf16 dot mode, and
  ``matmul_int4_words_int8`` (CUDA, ``csrc/matmul_int4_int8dot.cu``, sized
  by :func:`int4_int8_plan`) in its int8 dot mode; ``matmul_int4``
  (``csrc/matmul_int4.cu``) replaces ``matmul_int4`` (:517). The two share
  one kernel template, tiled by :func:`int4_bf16_plan`. Each computes
  the reference's formula on its packed layout, not ``x @ dequant(w)``: see
  the plain versions.

The two int8-weight kernels read W in 8-byte pieces, so their weights have
N % 8 == 0; ``pad_cols`` pads an int8 weight's columns once, at quantize
time, and the callers slice the output (or pass ``n_valid`` to the argmax
head).
"""

from __future__ import annotations

import functools

import torch

from . import _build
from .quant import INT4_GROUP, unpack_int4, unpack_int4_words


def pad_cols(q, scales, multiple=8):
    """Pad int8 weight columns [K, N] (and their scales [N]) with zero
    columns of scale 1.0 up to a multiple of ``multiple``; the results are
    contiguous, as the kernels require."""
    pad = (-q.shape[1]) % multiple
    if pad:
        q = torch.nn.functional.pad(q, (0, pad))
        scales = torch.nn.functional.pad(scales, (0, pad), value=1.0)
    return q.contiguous(), scales.contiguous()


def matmul_int8(x, w, x_scale, w_scales):
    """int8 ``x`` [M, K] × int8 ``w`` [K, N] → f32 [M, N], scaled by
    ``x_scale`` (scalar tensor) and ``w_scales`` [N]. On CUDA,
    ``torch._int_mm`` needs M > 16 and K, N multiples of 8; anything else
    raises."""
    m, k = x.shape
    n = w.shape[1]
    if x.device.type == "cuda":
        _build.require(m > 16 and k % 8 == 0 and n % 8 == 0, "matmul_int8",
                       f"torch._int_mm on CUDA needs M > 16 and K, N "
                       f"multiples of 8 (got {m}x{k}x{n})")
    acc = torch._int_mm(x.contiguous(), w)
    scale = x_scale.to(torch.float32) * w_scales.to(torch.float32)
    return acc.to(torch.float32) * scale[None, :]


def _check_int8_tiled(x, w, x_scale, w_scales):
    name = "matmul_int8_tiled"
    _build.require(x.dim() == 2 and w.dim() == 2 and x.shape[1] == w.shape[0]
                   and x.dtype == w.dtype == torch.int8, name,
                   "x and w must be int8 [M, K] and [K, N]")
    n = w.shape[1]
    _build.require(w_scales.shape == (n,), name, "w_scales must be [N]")
    xs = torch.as_tensor(x_scale, dtype=torch.float32, device=x.device)
    _build.require(xs.numel() == 1, name, "x_scale must be a scalar")
    return xs.reshape(1), w_scales.to(torch.float32)


def matmul_int8_tiled_plain(x, w, x_scale, w_scales):
    """Plain PyTorch version of ``matmul_int8_tiled`` (same contract): the
    int32 sum taken exactly in f64 (every partial sum is an integer below
    2^53), then the f32 epilogue in the reference's order."""
    xs, ws = _check_int8_tiled(x, w, x_scale, w_scales)
    acc = (x.to(torch.float64) @ w.to(torch.float64)).to(torch.int32)
    return acc.to(torch.float32) * xs * ws[None, :]


# M1's tiles (csrc/matmul_int8.cu): a block owns M1_ROWS rows (two
# consumer warpgroups of 64) and 128 or 64 columns, and walks its K split
# M1_DEPTH at a time; the K splits of a tile form one cluster. A split
# keeps at least M1_MIN_SPLIT_TILES K tiles (shorter walks lose to the
# merge what they gain: GPT-2's O at M 256, 6 K tiles, reads no faster in
# 2 or 4 splits), and splits come in powers of two (an earlier plan's 5
# split clusters read slower than 4 at M 256); see PERF.md §6, measured by
# python -m rten_tpu_torch.tools.kv_group_variants, its m1 section.
M1_ROWS = 128
M1_DEPTH = 128
M1_MAX_SPLITS = 8
M1_MIN_SPLIT_TILES = 4
H100_SMS = 132


def matmul_int8_plan(m, k, n, sm_count=H100_SMS, splits=None):
    """M1's launch: output tiles of M1_ROWS x ``bn`` (128 columns where the
    tiles fill the card's SMs, else 64). Where the tiles leave SMs idle, the
    K tiles (M1_DEPTH deep) of each output tile split over a power of two
    of blocks of one cluster, up to M1_MAX_SPLITS, at least
    M1_MIN_SPLIT_TILES K tiles each, as many as fit in one wave of one block
    an SM: one tile a block, summed exactly through distributed shared
    memory before the one f32 epilogue. Unsplit, ``workers`` blocks (one an
    SM at most) take the tiles in turn. ``loader``: "tma" (tensor-map
    copies; K and N multiples of 16, which the tensor map's row stride
    needs; the wrapper also needs 16-byte aligned x and w) or "regs"
    (masked loads into the same layouts, any shape). ``splits`` overrides
    the choice (tests)."""
    m_tiles = -(-m // M1_ROWS)
    bn = 128 if m_tiles * -(-n // 128) >= sm_count else 64
    n_tiles = -(-n // bn)
    k_tiles = -(-k // M1_DEPTH)
    tiles = m_tiles * n_tiles
    most = max(1, min(M1_MAX_SPLITS, k_tiles))
    if splits is None:
        fit = min(M1_MAX_SPLITS, k_tiles // M1_MIN_SPLIT_TILES,
                  sm_count // max(tiles, 1))
        splits = 1 << max(fit, 1).bit_length() - 1
    workers = tiles if splits > 1 else min(tiles, sm_count)
    return dict(bn=bn, splits=splits, most=most, m_tiles=m_tiles,
                n_tiles=n_tiles, k_tiles=k_tiles, tiles=tiles,
                workers=workers, blocks=workers * splits,
                loader="tma" if k > 0 and k % 16 == 0 and n % 16 == 0
                else "regs")


def matmul_int8_tiled(x, w, x_scale, w_scales):
    """int8 ``x`` [M, K] × int8 ``w`` [K, N] → f32 [M, N], the contract of
    ``matmul_int8_pallas`` (gemm.py:93-135): int32 accumulation, then
    ``(f32(acc) * x_scale) * w_scales[col]`` in f32, in that order
    (``matmul_int8`` multiplies by ``x_scale * w_scales`` instead). Any M,
    N and K: the reference pads M to 32 and N and K to 128 with zeros,
    which changes no sum. ``x_scale`` a Python float or a one-element
    tensor; ``w_scales`` [N]. Bit-exact by construction. The kernel at
    :func:`matmul_int8_plan`'s launch streams x and W by tensor-map copies
    where K and N are multiples of 16 and both start 16-byte aligned, and
    loads them with masked register loads otherwise (one kernel template,
    the loader chosen by shape). CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    name = "matmul_int8_tiled"
    if _build.on_cpu(name, x, w, w_scales):
        return matmul_int8_tiled_plain(x, w, x_scale, w_scales)
    return _launch_int8_tiled(x, w, x_scale, w_scales)


def _launch_int8_tiled(x, w, x_scale, w_scales, plan=None):
    """M1 on CUDA tensors at ``plan`` (default :func:`matmul_int8_plan`'s
    for the device; its loader dropped to "regs" where x or w is not
    16-byte aligned); counts the launch."""
    name = "matmul_int8_tiled"
    xs, ws = _check_int8_tiled(x, w, x_scale, w_scales)
    _build.require(x.is_contiguous() and w.is_contiguous(), name,
                   "x and w must be contiguous")
    m, k = x.shape
    n = w.shape[1]
    if plan is not None:
        _build.require(1 <= plan["splits"] <= plan["most"], name,
                       f"splits must lie in [1, {plan['most']}], got "
                       f"{plan['splits']}")
    fn = _build.function("matmul_int8", "matmul_int8", "pppppiiiiiiip")
    plan = plan or matmul_int8_plan(m, k, n, _sm_count(x.device))
    ws = ws.contiguous()
    if ws.data_ptr() % 16:
        ws = ws.clone()
    tma = (plan["loader"] == "tma" and x.data_ptr() % 16 == 0
           and w.data_ptr() % 16 == 0)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    _build.check(fn(x.data_ptr(), w.data_ptr(), xs.data_ptr(), ws.data_ptr(),
                    out.data_ptr(), m, n, k, plan["bn"], plan["splits"],
                    plan["workers"], int(tma), _build.stream()), name)
    matmul_int8_tiled.launches += 1
    return out


matmul_int8_tiled.launches = 0


def _check_wo(name, x, w, scales):
    _build.require(x.dim() == 2 and x.dtype == torch.float32, name,
                   "x must be f32 [M, K]")
    _build.require(w.dim() == 2 and w.shape[0] == x.shape[1]
                   and w.dtype == torch.int8, name, "w must be int8 [K, N]")
    _build.require(scales.shape == (w.shape[1],)
                   and scales.dtype == torch.float32, name,
                   "scales must be f32 [N]")


def _check_kernel(name, x, w, scales):
    _build.require(w.shape[1] % 8 == 0, name,
                   "N must be a multiple of 8 (pad_cols at quantize time)")
    _build.require(all(t.is_contiguous() for t in (x, w, scales))
                   and w.data_ptr() % 16 == 0, name,
                   "tensors must be contiguous and W 16-byte aligned")


def matmul_int8_wo_plain(x, w, scales):
    """Plain PyTorch version of ``matmul_int8_wo``: bf16-rounded x and the
    exactly converted weight multiplied in f32, scales after the sum."""
    _check_wo("matmul_int8_wo", x, w, scales)
    xb = x.to(torch.bfloat16).to(torch.float32)
    return (xb @ w.to(torch.float32)) * scales[None, :]


def matmul_int8_wo(x, w, scales):
    """f32 ``x`` [M, K] × int8 ``w`` [K, N] × per-column ``scales`` [N] →
    f32 [M, N]: bf16 x, exact bf16 weights, f32 accumulation, scales after
    the sum. CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise."""
    name = "matmul_int8_wo"
    if _build.on_cpu(name, x, w, scales):
        return matmul_int8_wo_plain(x, w, scales)
    _check_wo(name, x, w, scales)
    _check_kernel(name, x, w, scales)
    m, k = x.shape
    n = w.shape[1]
    plan = matmul_int8_wo_plan(m, k, n)
    (xb,), _buf = _scratch(plan["sizes"], x.device)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    fn = _build.function("head_argmax_int8", name, "pppppiiiip")
    err = fn(x.data_ptr(), w.data_ptr(), scales.data_ptr(), xb,
             out.data_ptr(), m, k, n, plan["cfg"], _build.stream())
    _build.check(err, name)
    matmul_int8_wo.launches += 1
    return out


matmul_int8_wo.launches = 0


def head_argmax_int8_plain(x, w, scales, n_valid=None):
    """Plain PyTorch version of ``head_argmax_int8``: the logits of
    :func:`matmul_int8_wo_plain`, then the first maximal index."""
    n_valid = w.shape[1] if n_valid is None else n_valid
    logits = matmul_int8_wo_plain(x, w, scales)[:, :n_valid]
    return torch.argmax(logits, dim=-1).to(torch.int32)


# The fused head's tiles (csrc/head_argmax_int8.cu): (largest M, rows of a
# row block, columns of a vocabulary slab), first match; the kernel's config
# is the index.
_HEAD_TILES = ((32, 32, 256), (64, 64, 128), (128, 128, 192),
               (None, 256, 192))
_HEAD_BK = 64            # K rows per pipeline stage: x is padded to it


def head_argmax_plan(m, k, n):
    """The fused head's launch at M rows, K, N columns: the tile config,
    its row block and slab, their counts, the padded bf16 copy of x
    ([m_pad, k_pad]) and the scratch bytes (that copy, then the f32 and
    int32 partials [M, slabs])."""
    cfg = next(i for i, (top, _, _) in enumerate(_HEAD_TILES)
               if top is None or m <= top)
    _, rows, slab = _HEAD_TILES[cfg]
    row_blocks, slabs = -(-m // rows), -(-n // slab)
    m_pad, k_pad = row_blocks * rows, -(-k // _HEAD_BK) * _HEAD_BK
    sizes = (2 * m_pad * k_pad, 4 * m * slabs, 4 * m * slabs)
    return dict(cfg=cfg, rows=rows, slab=slab, row_blocks=row_blocks,
                slabs=slabs, m_pad=m_pad, k_pad=k_pad, sizes=sizes)


def matmul_int8_wo_plan(m, k, n):
    """K4's launch: the fused head's tile at M rows (K4 runs on K2's
    tiles), and one scratch buffer, the padded bf16 copy of x; no
    partials (the store epilogue writes the logits)."""
    plan = head_argmax_plan(m, k, n)
    plan["sizes"] = plan["sizes"][:1]
    return plan


def _scratch(sizes, device):
    """One uint8 allocation holding buffers of ``sizes`` bytes, each
    16-byte aligned; returns their addresses and the tensor."""
    offsets = [0]
    for size in sizes:
        offsets.append(offsets[-1] + -(-size // 16) * 16)
    buf = torch.empty(max(offsets[-1], 16), dtype=torch.uint8, device=device)
    return [buf.data_ptr() + o for o in offsets[:-1]], buf


def head_argmax_int8(x, w, scales, n_valid=None):
    """Greedy LM head: ``argmax(x @ (w * scales))`` over the first
    ``n_valid`` columns (default all), ties to the lowest index, without
    materialising the [M, N] logits. Returns int32 [M]. CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise."""
    name = "head_argmax_int8"
    n_valid = w.shape[1] if n_valid is None else int(n_valid)
    if _build.on_cpu(name, x, w, scales):
        return head_argmax_int8_plain(x, w, scales, n_valid)
    _check_wo(name, x, w, scales)
    _check_kernel(name, x, w, scales)
    _build.require(0 < n_valid <= w.shape[1], name, "n_valid out of range")
    m, k = x.shape
    n = w.shape[1]
    plan = head_argmax_plan(m, k, n)
    (xb, part_val, part_idx), _buf = _scratch(plan["sizes"], x.device)
    out = torch.empty((m,), dtype=torch.int32, device=x.device)
    fn = _build.function(name, name, "pppppppiiiiip")
    err = fn(x.data_ptr(), w.data_ptr(), scales.data_ptr(), xb, part_val,
             part_idx, out.data_ptr(), m, k, n, n_valid, plan["cfg"],
             _build.stream())
    _build.check(err, name)
    head_argmax_int8.launches += 1
    return out


head_argmax_int8.launches = 0


# -- group-wise int4 weights --------------------------------------------------

_INT4_MODES = {"matmul_int4_words": 0, "matmul_int4": 2}
_SM_COUNT: dict = {}

# Q1 and Q2 (csrc/matmul_int4.cu). Decode tile: a block owns 256 output
# columns, 16 x ms rows and one K split of whole groups, its weights
# streamed through a ring of 64-row stages; a tile's splits form one
# thread-block cluster. Prefill tile: 128 rows x 256 columns a block, K
# stages of 64.
_INT4_TILE_N = 256
_INT4_DECODE_MAX_M = 64      # M above this takes the prefill tile
_INT4_SPLIT_ROWS = 256       # K rows a decode split aims at (4 stages)
_INT4_BLOCKS_PER_SM = 2      # resident blocks: the splits fill one wave
_INT4_MAX_SPLITS = 16        # the largest cluster
_INT4_GROUP_MULTIPLE = 64    # the x chunk of a partial sum; a prefill stage
_INT4_XPAD = 16              # f32 pad of a staged x row (at most)
_INT4_STAGE = 64 * 128       # bytes of a ring stage: 64 K rows of W
_INT4_MAX_RING = 16
_INT4_SMEM_LIMIT = 232448    # dynamic shared memory a block may use
_INT4_SMEM_TWO = 115712      # ... with two blocks resident on an SM
_INT4_PREFILL_ROWS = 128
_INT4_PREFILL_SMEM = 1024 + 4 * (128 * 64 * 2 + 64 * 128 + 256 * 4) \
    + 2 * 64 * 256 * 2


def _align16(n):
    return -(-n // 16) * 16


def _int4_decode_smem(ms, gmax, group, splits, ring):
    """Shared memory of the decode tile (csrc/matmul_int4.cu::dec_smem):
    1 KB to align the weight ring of ``ring`` stages, the barriers, the
    split's scales, its f32 x rows (padded), its chunk sums and, with
    splits, the push buffer of the cluster's split-K sum."""
    rows = 16 * ms
    share = -(-(rows * _INT4_TILE_N // 4) // splits)
    return (1024 + _align16(8 * (1 + 2 * _INT4_MAX_RING))
            + gmax * _INT4_TILE_N * 4
            + _align16(rows * (gmax * group + _INT4_XPAD) * 4)
            + _align16(rows * (gmax * group // 64) * 4)
            + ring * _INT4_STAGE
            + (splits * share * 16 if splits > 1 else 0))


def _int4_ring(ms, gmax, group, splits):
    """Ring stages of the decode tile: every stage of a split where that
    fits (at most ``_INT4_MAX_RING``), as many as leave room for two blocks
    an SM, at least 2 (or the split's stages); None where even that does
    not fit."""
    stages = gmax * group // 64
    base = _int4_decode_smem(ms, gmax, group, splits, 0)
    low = min(2, stages)
    if base + low * _INT4_STAGE > _INT4_SMEM_LIMIT:
        return None
    room = (_INT4_SMEM_TWO if base + low * _INT4_STAGE <= _INT4_SMEM_TWO
            else _INT4_SMEM_LIMIT) - base
    return max(low, min(_INT4_MAX_RING, stages, room // _INT4_STAGE))


@functools.lru_cache(maxsize=4096)
def int4_bf16_plan(m, k, n, group, sm_count, splits=None):
    """The launch of Q1 / Q2 at M rows, K, N columns and ``group``
    (cached: a decode step asks for the same few plans every time, and the
    host-bound step would pay tens of microseconds for each; the returned
    dict is shared and is not to be modified).

    * ``tile="decode"`` at M <= 64 (bound by bytes), one launch: m16 slabs
      per row tile ``ms`` (1 at M <= 16, else 2), the tile counts, the K
      splits (enough that a split spans ``_INT4_SPLIT_ROWS`` K rows, no
      more than one wave of ``_INT4_BLOCKS_PER_SM`` blocks per SM holds,
      at most one per group and ``_INT4_MAX_SPLITS``, at least ``fewest``,
      enough that a split's shared memory fits, and raised to ``pair``, the
      fewest that leave room for two blocks an SM, where the count chosen
      would not, unless ``splits`` is given), each split's group range
      ``bounds`` as the kernel computes it, the stages of its weight ring
      (``ring``: all of a split's where they fit beside two blocks an SM),
      the block's shared memory, and no scratch.
    * ``tile="prefill"`` at M > 64, or where no split count up to the
      largest cluster fits a split in shared memory: row blocks of 128, one
      split, and the scratch of the prep launch: bf16 x [m_pad, K] and the
      f32 group sums [m_pad, K / group].

    ``sizes`` lists the scratch buffers' bytes."""
    n_groups, n_tiles = k // group, n // _INT4_TILE_N
    top = min(n_groups, _INT4_MAX_SPLITS)
    if m <= _INT4_DECODE_MAX_M:
        ms = 1 if m <= 16 else 2
        rows = 16 * ms
        m_tiles = -(-m // rows)

        def ring(s):
            return _int4_ring(ms, -(-n_groups // s), group, s)

        def smem(s):
            return _int4_decode_smem(ms, -(-n_groups // s), group, s,
                                     ring(s))

        fewest = next((s for s in range(1, top + 1)
                       if ring(s) is not None), None)
        if fewest is not None:
            # The fewest splits that leave room for two blocks an SM.
            pair = next((s for s in range(fewest, top + 1)
                         if smem(s) <= _INT4_SMEM_TWO), None)
            if splits is None:
                enough = -(-k // _INT4_SPLIT_ROWS)
                one_wave = (_INT4_BLOCKS_PER_SM * sm_count
                            // (m_tiles * n_tiles))
                splits = max(fewest, min(top, enough, one_wave))
                if smem(splits) > _INT4_SMEM_TWO and pair is not None:
                    splits = max(splits, pair)
            gmax = -(-n_groups // splits)
            stages = ring(splits) or 0
            return dict(tile="decode", ms=ms, rows=rows, m_tiles=m_tiles,
                        n_tiles=n_tiles, splits=splits, fewest=fewest,
                        top=top, m_pad=m_tiles * rows,
                        bounds=[z * n_groups // splits
                                for z in range(splits + 1)],
                        pair=pair, ring=stages,
                        smem=_int4_decode_smem(ms, gmax, group, splits,
                                               stages), sizes=())
    rows = _INT4_PREFILL_ROWS
    m_tiles = -(-m // rows)
    m_pad = m_tiles * rows
    return dict(tile="prefill", ms=rows // 16, rows=rows, m_tiles=m_tiles,
                n_tiles=n_tiles, splits=1 if splits is None else splits,
                fewest=1, top=1, pair=1, m_pad=m_pad, bounds=[0, n_groups],
                ring=0, smem=_INT4_PREFILL_SMEM,
                sizes=(2 * m_pad * k, 4 * m_pad * n_groups))


def _check_int4(name, x, w, scales, group):
    """Shapes of the int4 GEMMs: x f32 [M, K]; w int32 words [K/4, N/2]
    (``matmul_int4_words*``) or uint8 tile-planar bytes [K, N/2]
    (``matmul_int4``); scales f32 [K / group, N]; N a multiple of 256."""
    words = name != "matmul_int4"
    _build.require(x.dim() == 2 and x.dtype == torch.float32, name,
                   "x must be f32 [M, K]")
    dtype = torch.int32 if words else torch.uint8
    _build.require(w.dim() == 2 and w.dtype == dtype, name,
                   f"w must be {dtype} [K{'/4' if words else ''}, N/2]")
    m = x.shape[0]
    k, n = w.shape[0] * (4 if words else 1), 2 * w.shape[1]
    _build.require(x.shape[1] == k, name,
                   f"contraction mismatch {x.shape[1]} vs {k}")
    _build.require(n % 256 == 0, name, f"N = {n} must be a multiple of 256")
    _build.require(group > 0 and k % group == 0, name,
                   f"K = {k} must be a multiple of the group {group}")
    _build.require(scales.shape == (k // group, n)
                   and scales.dtype == torch.float32, name,
                   "scales must be f32 [K / group, N]")
    return m, k, n


def _grouped_bf16(q, scales, group):
    """bf16(bf16(q) * bf16(scale)) per (K-group, column): the reference
    kernels' weight tile, q [K, N] exact in bf16 (gemm.py:349-350,405-406),
    returned in f32."""
    k, n = q.shape
    w = (q.to(torch.bfloat16).reshape(k // group, group, n)
         * scales.to(torch.bfloat16)[:, None, :])
    return w.reshape(k, n).to(torch.float32)


def _offset_correction(xsum, scales):
    """The zero-point term -8 * sum_g xsum[m, g] * scales[g, n] of the
    offset-binary word layout (gemm.py:384-386)."""
    return (xsum @ scales) * -8.0


def matmul_int4_words_plain(x, words, scales, group=INT4_GROUP,
                            dot_mode="bf16"):
    """Plain PyTorch version of the word-packed int4 GEMM, the reference's
    formula (gemm.py:378-425,457-478,510-511) with u = q + 8 in [0, 15]:

    * ``"bf16"``: sum_k bf16(x) * bf16(bf16(u) * bf16(s)) in f32, plus the
      correction of the group sums of the unrounded f32 x;
    * ``"int8"``: x row-quantized (scale absmax / 127, 1 where 0; xq =
      clamp(round_half_even(x / scale), -127, 127)), one exact integer dot
      of xq with u per group times the f32 s, summed over groups in f32,
      plus the correction of the quantized group sums, times the row
      scale.

    Integer dots are taken in f32, exact: every partial sum is an integer
    below 127 * 15 * group < 2^24."""
    name = ("matmul_int4_words" if dot_mode == "bf16"
            else "matmul_int4_words_int8")
    _build.require(dot_mode in ("bf16", "int8"), name,
                   f"dot_mode must be 'bf16' or 'int8', got {dot_mode!r}")
    m, k, n = _check_int4(name, x, words, scales, group)
    g = k // group
    u = unpack_int4_words(words).to(torch.float32) + 8.0
    if dot_mode == "bf16":
        main = x.to(torch.bfloat16).to(torch.float32) @ _grouped_bf16(
            u, scales, group)
        return _offset_correction(x.reshape(m, g, group).sum(-1),
                                  scales) + main
    absmax = x.abs().amax(dim=1, keepdim=True)
    # A tensor divisor: CUDA divides by a Python scalar through its
    # reciprocal, which can round the scale one step away from the CPU's
    # (and the kernel's) IEEE division and flip an xq.
    xscale = torch.where(absmax == 0, torch.ones_like(absmax),
                         absmax / torch.full_like(absmax, 127.0))
    xq = torch.clamp(torch.round(x / xscale), -127, 127).reshape(m, g, group)
    acc = torch.bmm(xq.transpose(0, 1), u.reshape(g, group, n))  # [G, M, N]
    main = (acc * scales[:, None, :]).sum(0)
    return (_offset_correction(xq.sum(-1), scales) + main) * xscale


def matmul_int4_plain(x, packed, scales, group=INT4_GROUP):
    """Plain PyTorch version of ``matmul_int4``: signed q = nibble - 8 of
    the tile-planar bytes, sum_k bf16(x) * bf16(bf16(q) * bf16(s)) in f32
    (gemm.py:319-357)."""
    _check_int4("matmul_int4", x, packed, scales, group)
    q = unpack_int4(packed).to(torch.float32)
    return x.to(torch.bfloat16).to(torch.float32) @ _grouped_bf16(
        q, scales, group)


def _aligned(t):
    """``t`` itself where it starts on a 16-byte boundary, else a copy that
    does (the kernels read x and the scales 16 bytes at a time)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch_int4(wrapper, x, w, scales, group, splits=None):
    """Q1 or Q2 (``csrc/matmul_int4.cu``, the wrapper's mode) on CUDA
    tensors, tiled by :func:`int4_bf16_plan` (``splits`` overrides the
    decode tile's, for tests); counts the launch on ``wrapper``."""
    name = wrapper.__name__
    m, k, n = _check_int4(name, x, w, scales, group)
    _build.require(group % _INT4_GROUP_MULTIPLE == 0, name,
                   f"the group must be a multiple of {_INT4_GROUP_MULTIPLE}")
    _build.require(all(t.is_contiguous() for t in (x, w, scales))
                   and w.data_ptr() % 16 == 0, name,
                   "tensors must be contiguous and w 16-byte aligned")
    if splits is not None:
        _build.require(splits >= 1, name, "splits must lie in [1, 16]")
        plan = int4_bf16_plan(m, k, n, group, 0, splits)
        _build.require(plan["fewest"] <= splits <= plan["top"], name,
                       f"splits must lie in [{plan['fewest']}, "
                       f"{plan['top']}] for the {plan['tile']} tile")
    fn = _build.function("matmul_int4", "matmul_int4", "ppppppiiiiiiiiip")
    if splits is None:
        plan = int4_bf16_plan(m, k, n, group, _sm_count(x.device))
    (xb, xsum), _buf = (_scratch(plan["sizes"], x.device)
                        if plan["sizes"] else ((None, None), None))
    x, scales = _aligned(x), _aligned(scales)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    err = fn(x.data_ptr(), w.data_ptr(), scales.data_ptr(), xb, xsum,
             out.data_ptr(), m, k, n, group, _INT4_MODES[name],
             int(plan["tile"] == "prefill"), plan["ms"], plan["splits"],
             plan["ring"], _build.stream())
    _build.check(err, name)
    wrapper.launches += 1
    return out


# Q1' (csrc/matmul_int4_int8dot.cu): a block owns 256 output columns, 16 x
# ms rows and one K split of whole groups; K steps of 32. A tile's splits
# form one thread-block cluster.
_Q1P_TILE_N = 256
_Q1P_KSTEP = 32
_Q1P_BLOCKS_PER_SM = 2   # resident blocks: the splits fill one such wave
_Q1P_BATCH = 8           # K steps of weights a warp loads before its MMAs
_Q1P_MAX_SPLITS = 16     # the largest cluster
_Q1P_MAX_SPLIT_GROUPS = 16   # groups a split may span (its xq in smem)


def int4_int8_plan(m, k, n, group, sm_count, splits=None):
    """The launch of Q1' at M rows, K, N columns: m16 slabs per row
    tile (``ms``: 1 at M <= 16, else 2), the tile counts, the K splits
    (enough that a warp's share is one batch of ``_Q1P_BATCH`` K steps, no
    more than one wave of ``_Q1P_BLOCKS_PER_SM`` blocks per SM holds, at
    most one per group and ``_Q1P_MAX_SPLITS``, at least enough that none
    spans more than ``_Q1P_MAX_SPLIT_GROUPS``, unless ``splits`` is given),
    each split's
    group range ``bounds`` as the kernel computes it, and the scratch bytes:
    xq in fragment order [m_pad, K] and the row scales [m_pad]."""
    ms = 1 if m <= 16 else 2
    rows = 16 * ms
    m_tiles, n_tiles, n_groups = -(-m // rows), n // _Q1P_TILE_N, k // group
    if splits is None:
        one_batch = -(-(k // _Q1P_KSTEP) // _Q1P_BATCH)
        one_wave = _Q1P_BLOCKS_PER_SM * sm_count // (m_tiles * n_tiles)
        splits = max(_int4_int8_fewest_splits(n_groups), 1,
                     min(n_groups, _Q1P_MAX_SPLITS, one_batch, one_wave))
    m_pad = m_tiles * rows
    return dict(ms=ms, rows=rows, m_tiles=m_tiles, n_tiles=n_tiles,
                splits=splits, m_pad=m_pad,
                bounds=[z * n_groups // splits for z in range(splits + 1)],
                sizes=(m_pad * k, 4 * m_pad))


def _int4_int8_fewest_splits(n_groups):
    return -(-n_groups // _Q1P_MAX_SPLIT_GROUPS)


def _sm_count(device):
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SM_COUNT[idx]


def _launch_int4_int8(x, words, scales, group, splits=None):
    """Q1' on CUDA tensors (``splits`` overrides the plan's, for tests);
    counts the launch on :func:`matmul_int4_words_int8`."""
    name = "matmul_int4_words_int8"
    m, k, n = _check_int4(name, x, words, scales, group)
    _build.require(group % _Q1P_KSTEP == 0, name,
                   f"the group must be a multiple of {_Q1P_KSTEP}")
    _build.require(all(t.is_contiguous() and t.data_ptr() % 16 == 0
                       for t in (x, words, scales)), name,
                   "tensors must be contiguous and 16-byte aligned")
    n_groups = k // group
    fewest = _int4_int8_fewest_splits(n_groups)
    _build.require(fewest <= min(n_groups, _Q1P_MAX_SPLITS), name,
                   f"K / group = {n_groups} groups need more than "
                   f"{_Q1P_MAX_SPLITS} splits")
    top = min(n_groups, _Q1P_MAX_SPLITS)
    _build.require(splits is None or fewest <= splits <= top, name,
                   f"splits must lie in [{fewest}, {top}]")
    fn = _build.function("matmul_int4_int8dot", "matmul_int4_int8dot",
                         "ppppppiiiiiip")
    plan = int4_int8_plan(m, k, n, group,
                          _sm_count(x.device) if splits is None else 0,
                          splits)
    (xqf, xscale), _buf = _scratch(plan["sizes"], x.device)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    err = fn(x.data_ptr(), words.data_ptr(), scales.data_ptr(), xqf, xscale,
             out.data_ptr(), m, k, n, group, plan["ms"], plan["splits"],
             _build.stream())
    _build.check(err, name)
    matmul_int4_words_int8.launches += 1
    return out


def matmul_int4_words(x, words, scales, group=INT4_GROUP):
    """f32 ``x`` [M, K] × word-packed group-wise int4 ``words`` int32
    [K/4, N/2] with ``scales`` f32 [K / group, N] → f32 [M, N], in the bf16
    dot mode (see :func:`matmul_int4_words_plain`). CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise."""
    if _build.on_cpu("matmul_int4_words", x, words, scales):
        return matmul_int4_words_plain(x, words, scales, group, "bf16")
    return _launch_int4(matmul_int4_words, x, words, scales, group)


matmul_int4_words.launches = 0


def matmul_int4_words_int8(x, words, scales, group=INT4_GROUP):
    """:func:`matmul_int4_words` in the int8 dot mode (the reference's
    ``dot_mode="int8"``), on a kernel of its own (the group a multiple of
    32). CPU tensors take the plain version; CUDA tensors launch the kernel
    or raise."""
    if _build.on_cpu("matmul_int4_words_int8", x, words, scales):
        return matmul_int4_words_plain(x, words, scales, group, "int8")
    return _launch_int4_int8(x, words, scales, group)


matmul_int4_words_int8.launches = 0


def matmul_int4(x, packed, scales, group=INT4_GROUP):
    """f32 ``x`` [M, K] × tile-planar byte-packed group-wise int4
    ``packed`` uint8 [K, N/2] with ``scales`` f32 [K / group, N] → f32
    [M, N] (see :func:`matmul_int4_plain`). CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    if _build.on_cpu("matmul_int4", x, packed, scales):
        return matmul_int4_plain(x, packed, scales, group)
    return _launch_int4(matmul_int4, x, packed, scales, group)


matmul_int4.launches = 0
