"""Quantization math of ``rten_tpu/kernels/quant.py`` (int8 and the
group-wise int4 layouts) plus the per-(token, head) KV quantizer of
``rten_tpu/generate/kv_cache.py::_quantize_tokens``.

Every division here is an IEEE float32 division and every rounding is
round-half-even (``torch.round``), so the results match the reference bit
for bit on both devices. The divisor is always a tensor: CUDA PyTorch
divides a tensor by a Python float through a multiply by its reciprocal,
which can land one rounding step away from the quotient, while tensor by
tensor division is IEEE on the CPU and on the card alike.
"""

from __future__ import annotations

import torch


def quantize(x, scale, zero_point=None, dtype=torch.int8, axis=None):
    """ONNX QuantizeLinear: y = saturate(round(x / scale) + zero_point).
    ``scale``/``zero_point`` may be scalars or per-axis vectors (then
    ``axis`` selects the broadcast axis)."""
    x = torch.as_tensor(x)
    scale = torch.as_tensor(scale, dtype=x.dtype, device=x.device)
    if zero_point is not None:
        zero_point = torch.as_tensor(zero_point, device=x.device)
    if axis is not None and scale.ndim == 1:
        shape = [1] * x.ndim
        shape[axis] = -1
        scale = scale.reshape(shape)
        if zero_point is not None:
            zero_point = zero_point.reshape(shape)
    y = torch.round(x / scale)
    if zero_point is not None:
        y = y + zero_point.to(y.dtype)
    info = torch.iinfo(dtype)
    return torch.clamp(y, info.min, info.max).to(dtype)


def dequantize(q, scale, zero_point=None, axis=None):
    """ONNX DequantizeLinear: y = (q - zero_point) * scale."""
    q32 = torch.as_tensor(q).to(torch.int32)
    scale = torch.as_tensor(scale, dtype=torch.float32, device=q32.device)
    if zero_point is not None:
        zero_point = torch.as_tensor(zero_point,
                                     device=q32.device).to(torch.int32)
    if axis is not None and scale.ndim == 1:
        shape = [1] * q32.ndim
        shape[axis] = -1
        scale = scale.reshape(shape)
        if zero_point is not None:
            zero_point = zero_point.reshape(shape)
    if zero_point is not None:
        q32 = q32 - zero_point
    return q32.to(torch.float32) * scale


def dynamic_quantize(x):
    """ONNX DynamicQuantizeLinear: uint8 quantization with range-derived
    scale/zero-point (zero always exactly representable).
    Returns (y_uint8, scale, zero_point_uint8)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    x_min = torch.clamp(x.min(), max=0.0)
    x_max = torch.clamp(x.max(), min=0.0)
    scale = (x_max - x_min) / torch.full_like(x_max, 255.0)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    zp = torch.clamp(torch.round(-x_min / scale), 0, 255).to(torch.uint8)
    y = torch.clamp(torch.round(x / scale) + zp.to(torch.float32), 0, 255)
    return y.to(torch.uint8), scale, zp


def abs_max_quantize_int8(w, axis=0):
    """Symmetric per-channel int8 (weights): scale = absmax/127 along
    ``axis`` (the contraction axis). Returns (q_int8, scales f32)."""
    w = torch.as_tensor(w).to(torch.float32)
    absmax = w.abs().amax(dim=axis, keepdim=True)
    scales = torch.where(absmax == 0, torch.ones_like(absmax),
                         absmax / torch.full_like(absmax, 127.0))
    q = torch.clamp(torch.round(w / scales), -127, 127).to(torch.int8)
    return q, scales.squeeze(axis)


def quantize_tokens(x):
    """Per-(token, head) symmetric int8 over the last axis (head_dim):
    absmax, then scale = bf16(absmax / 127) with 1.0 where absmax == 0,
    then q = clamp(round_half_even(x / f32(scale)), -127, 127).
    x: [..., D] float → (q int8 [..., D], scales bf16 [...])."""
    x = x.to(torch.float32)
    absmax = x.abs().amax(dim=-1)
    scale = torch.where(absmax == 0, torch.ones_like(absmax),
                        absmax / torch.full_like(absmax, 127.0)
                        ).to(torch.bfloat16)
    q = torch.clamp(torch.round(x / scale.to(torch.float32)[..., None]),
                    -127, 127).to(torch.int8)
    return q, scale


INT4_GROUP = 128       # default K-group of the group-wise int4 scales
INT4_PACK_TILE = 256   # column tile of the tile-planar nibble packing


def pack_int4(q, tile=INT4_PACK_TILE):
    """Tile-planar bytes: int values in [-8, 7] along the last axis (a
    multiple of ``tile``) stored offset-binary (q + 8); within each tile,
    byte j holds column j in its low nibble and column j + tile/2 in its
    high nibble. Returns uint8 [..., N/2]."""
    q = torch.as_tensor(q)
    n = q.shape[-1]
    if n % tile:
        raise ValueError(f"last dim {n} must be a multiple of {tile}")
    u = (q.to(torch.int32) + 8).reshape(*q.shape[:-1], n // tile, tile)
    packed = u[..., :tile // 2] | (u[..., tile // 2:] << 4)
    return packed.reshape(*q.shape[:-1], n // 2).to(torch.uint8)


def unpack_int4(packed, tile=INT4_PACK_TILE):
    """Inverse of :func:`pack_int4`: int8 values in [-8, 7], last axis
    doubled."""
    p = torch.as_tensor(packed).to(torch.int32)
    half = tile // 2
    n_half = p.shape[-1]
    p = p.reshape(*p.shape[:-1], n_half // half, half)
    out = torch.cat([(p & 0xF) - 8, (p >> 4) - 8], dim=-1)
    return out.reshape(*out.shape[:-2], n_half * 2).to(torch.int8)


def _int4_groupwise(w, group, k_multiple):
    """Pad w [K, N] (K to ``k_multiple``, N to the pack tile) and quantize
    per (K-group, column): scale = absmax / 7 (1.0 where absmax is 0),
    q = clamp(round_half_even(w / scale), -8, 7). Returns (q int8 [Kp, Np],
    scales f32 [Kp / group, Np])."""
    w = torch.as_tensor(w).to(torch.float32)
    k, n = w.shape
    k_pad, n_pad = (-k) % k_multiple, (-n) % INT4_PACK_TILE
    if k_pad or n_pad:
        w = torch.nn.functional.pad(w, (0, n_pad, 0, k_pad))
        k, n = w.shape
    grouped = w.reshape(k // group, group, n)
    absmax = grouped.abs().amax(dim=1, keepdim=True)
    scales = torch.where(absmax == 0, torch.ones_like(absmax),
                         absmax / torch.full_like(absmax, 7.0))
    q = torch.clamp(torch.round(grouped / scales), -8, 7).to(torch.int8)
    return q.reshape(k, n), scales[:, 0, :]


def quantize_int4_groupwise(w, group=INT4_GROUP):
    """Group-wise symmetric int4 of a weight [K, N] in the tile-planar byte
    layout; K pads to a multiple of ``group``, N to the pack tile. Returns
    (packed uint8 [K, N/2], scales f32 [K / group, N])."""
    q, scales = _int4_groupwise(w, group, group)
    return pack_int4(q), scales


def dequantize_int4_groupwise(packed, scales, group=INT4_GROUP):
    """q * scale in f32 for the byte layout: [K, N]."""
    q = unpack_int4(packed).to(torch.float32)
    return q * torch.as_tensor(scales).repeat_interleave(group, dim=0)


def pack_int4_words(q, tile=INT4_PACK_TILE):
    """Word layout: the tile-planar bytes of :func:`pack_int4`, four
    consecutive K rows little-endian in one int32 (byte i of word r holds
    K row 4r + i). q [K, N] with K % 4 == 0 and N % tile == 0. Returns
    int32 [K/4, N/2]."""
    q = torch.as_tensor(q)
    k, n = q.shape
    if k % 4:
        raise ValueError(f"K = {k} must be a multiple of 4")
    byte = pack_int4(q, tile).to(torch.int64).reshape(k // 4, 4, n // 2)
    words = (byte[:, 0] | (byte[:, 1] << 8) | (byte[:, 2] << 16)
             | (byte[:, 3] << 24))
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32)


def unpack_int4_words(words, tile=INT4_PACK_TILE):
    """Inverse of :func:`pack_int4_words`: int8 values in [-8, 7],
    [K, N]."""
    w = torch.as_tensor(words).to(torch.int32)
    r, n_half = w.shape
    bytes_ = torch.stack([(w >> (8 * i)) & 0xFF for i in range(4)],
                         dim=1).reshape(4 * r, n_half)
    return unpack_int4(bytes_, tile)


def quantize_int4_words(w, group=INT4_GROUP):
    """Group-wise symmetric int4 of a weight [K, N] in the word layout; K
    pads to a multiple of ``group`` (and of 4), N to the pack tile. Returns
    (words int32 [K/4, N/2], scales f32 [K / group, N])."""
    q, scales = _int4_groupwise(w, group, max(group, 4))
    return pack_int4_words(q), scales


def dequantize_int4_words(words, scales, group=INT4_GROUP):
    """q * scale in f32 for the word layout: [K, N]."""
    q = unpack_int4_words(words).to(torch.float32)
    k, n = q.shape
    return (q.reshape(k // group, group, n)
            * torch.as_tensor(scales)[:, None, :]).reshape(k, n)
