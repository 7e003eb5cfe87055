"""Quantized operators (ONNX QDQ/QLinear semantics): QuantizeLinear /
DequantizeLinear / DynamicQuantizeLinear / MatMulInteger / QLinearMatMul /
QLinearConv / ConvInteger, plus Silu.

The torch counterpart of ``rten_tpu/ops/quantized.py``, bit for bit: every
integer product is exact, as the reference's int32 accumulators are.

* int8 × int8 products run on ``torch._int_mm`` (:func:`int_mm`), with the
  operands padded to the shapes it takes on CUDA (M > 16 rows, K and N
  multiples of 8) and the result sliced back, so no shape the reference
  takes raises.
* PyTorch has no integer conv on CUDA, and an f32 conv is not exact (|acc|
  reaches 4608·255·127 ≈ 1.5e8 > 2^24 at ResNet-50's 3×3×512 convs).
  ConvInteger with int8 weights and no weight zero point runs as im2col
  (``F.unfold`` in f16, which holds every 8-bit value exactly) plus
  :func:`int_mm`, with the reference's zero-point shift (its native path,
  ops/quantized.py:204-220, 241-249): uint8 x becomes int8 by ``x ^ 0x80``
  (x - 128), the zero-padded conv of that, minus (zp - 128) times the conv
  of ones over the real taps, so padding contributes 0 exactly as the
  reference's subtract-then-pad path's does.
* Where the weights carry a zero point, the conv is grouped, or an operand
  does not fit int8, the product runs in f64, exact below 2^53 (cuDNN off,
  so no transform-based algorithm touches it), and wraps to int32.

The reference's ``RTEN_CONVINT_NATIVE`` knob chooses between two exact XLA
lowerings on the TPU; both give these results, so the port does not read
it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import quant as q
from .common import pad_spatial
from .conv import conv_geometry
from .registry import register


def _axis_scale(scale, zero_point, x_ndim, axis):
    if scale.ndim == 0 or scale.numel() == 1:
        return scale.reshape(()), (None if zero_point is None
                                   else zero_point.reshape(()))
    shape = [1] * x_ndim
    shape[axis] = -1
    zp = None if zero_point is None else zero_point.reshape(shape)
    return scale.reshape(shape), zp


def _requantize(y, zp):
    """round(y) already taken: add the zero point, clip to its type's
    range and cast (uint8 without a zero point)."""
    dtype = zp.dtype if zp is not None else torch.uint8
    if zp is not None:
        y = y + zp.to(torch.float32)
    info = torch.iinfo(dtype)
    return torch.clamp(y, info.min, info.max).to(dtype)


@register("QuantizeLinear")
def quantize_linear(ctx, attrs, x, y_scale, y_zero_point=None):
    axis = int(attrs.get("axis", 1))
    if axis < 0:
        axis += x.ndim
    scale, zp = _axis_scale(y_scale, y_zero_point, x.ndim, axis)
    return _requantize(torch.round(x / scale), zp)


@register("DequantizeLinear")
def dequantize_linear(ctx, attrs, x, x_scale, x_zero_point=None):
    axis = int(attrs.get("axis", 1))
    if axis < 0:
        axis += x.ndim
    scale, zp = _axis_scale(x_scale, x_zero_point, x.ndim, axis)
    x32 = x.to(torch.int32)
    if zp is not None:
        x32 = x32 - zp.to(torch.int32)
    return x32.to(torch.float32) * scale


@register("DynamicQuantizeLinear")
def dynamic_quantize_linear(ctx, attrs, x):
    y, scale, zp = q.dynamic_quantize(x)
    return y, scale.reshape(()), zp.reshape(())


def _zp_is_zero(zp):
    """The reference's test: no zero point, or a host array of zeros. A
    tensor is a device value, which the reference's traced lowering cannot
    inspect either."""
    if zp is None:
        return True
    if isinstance(zp, (np.ndarray, np.generic)):
        return not np.any(np.asarray(zp))
    return False


def int_mm(a, b):
    """Exact int8 ``a`` [M, K] × int8 ``b`` [K, N] → int32 [M, N] on
    ``torch._int_mm``: M padded with zero rows to more than 16, K and N with
    zeros to multiples of 8 (the shapes it takes on CUDA), then sliced."""
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = max(m, 17), -(-k // 8) * 8, -(-n // 8) * 8
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        b = F.pad(b, (0, np_ - n, 0, kp - k))
    return torch._int_mm(a.contiguous(), b.contiguous())[:m, :n]


def _as_int8(x, zp):
    """(int8 x, the zero point left to subtract as an int32 tensor or None):
    uint8 x shifted by the top-bit flip (x ^ 0x80 read as int8 is x - 128),
    with the 128 folded into the zero point."""
    if x.dtype == torch.uint8:
        xn = torch.bitwise_xor(x, 0x80).view(torch.int8)
        zp32 = zp.to(torch.int32) if zp is not None else torch.zeros(
            (), dtype=torch.int32, device=x.device)
        return xn, zp32 - 128
    if zp is None or _zp_is_zero(zp):
        return x, None
    return x, torch.as_tensor(zp, device=x.device).to(torch.int32)


def _f64_exact(fn, *xs):
    """An integer product computed in f64 (exact below 2^53) with cuDNN
    off, wrapped to int32."""
    with torch.backends.cudnn.flags(enabled=False):
        out = fn(*(x.to(torch.float64) for x in xs))
    return out.round().to(torch.int64).to(torch.int32)


def _minus_zp(x, zp):
    return x if zp is None else x.to(torch.int32) - torch.as_tensor(
        zp, device=x.device).to(torch.int32)


def _int8_ok(x, w, w_zp):
    return (w.dtype == torch.int8 and w_zp is None
            and x.dtype in (torch.int8, torch.uint8))


def int_matmul(a, b, a_zp=None, b_zp=None):
    """(a - a_zp) @ (b - b_zp) exactly, int32: int8 operands on
    :func:`int_mm` (a's zero point corrected on the accumulator by the
    column sums of b), anything else in f64."""
    if _int8_ok(a, b, b_zp) and b.ndim == 2 and a.ndim >= 2:
        lead = a.shape[:-1]
        an, zp = _as_int8(a, a_zp)
        acc = int_mm(an.reshape(-1, a.shape[-1]), b)
        if zp is not None:
            acc = acc - zp * b.to(torch.int32).sum(0, dtype=torch.int32)
        return acc.reshape(*lead, b.shape[1])
    return _f64_exact(torch.matmul, _minus_zp(a, a_zp), _minus_zp(b, b_zp))


@register("MatMulInteger")
def matmul_integer(ctx, attrs, a, b, a_zero_point=None, b_zero_point=None):
    """int8/uint8 matmul with int32 accumulation (ONNX MatMulInteger)."""
    if (a.ndim == 2 and b.ndim == 2 and _zp_is_zero(a_zero_point)
            and _zp_is_zero(b_zero_point)
            and a.dtype == torch.int8 and b.dtype == torch.int8):
        # The reference's int8 GEMM path (matmul_int8 with unit scales):
        # its f32 result, back to int32, is kept for bit parity (it rounds
        # accumulators above 2^24).
        return (int_mm(a, b).to(torch.float32) * 1.0).to(torch.int32)
    return int_matmul(a, b, a_zero_point, b_zero_point)


@register("QLinearMatMul")
def qlinear_matmul(ctx, attrs, a, a_scale, a_zp, b, b_scale, b_zp,
                   y_scale, y_zp):
    """Quantized matmul: integer product, dequant, requant."""
    if (a.ndim == 2 and b.ndim == 2 and _zp_is_zero(a_zp)
            and _zp_is_zero(b_zp) and a.dtype == torch.int8
            and b.dtype == torch.int8 and a_scale.numel() == 1):
        b_scales = torch.broadcast_to(b_scale.reshape(-1), (b.shape[1],))
        scale = (a_scale.reshape(()).to(torch.float32)
                 * b_scales.to(torch.float32))
        out_f32 = int_mm(a, b).to(torch.float32) * scale[None, :]
    else:
        acc = int_matmul(a, b, a_zp, b_zp)
        out_f32 = acc.to(torch.float32) * a_scale * b_scale
    return _requantize(torch.round(out_f32 / y_scale), y_zp)


def _conv_im2col(x, w, strides, dilations, pads):
    """Exact int8 conv, int32 [N, O, H', W']: zero-padded x unfolded in f16
    (1×1 kernels: strided slices), times the flattened weights on
    :func:`int_mm`."""
    n, c = x.shape[:2]
    o, _, kh, kw = w.shape
    xp = pad_spatial(x, pads)
    (sh, sw), (dh, dw) = strides, dilations
    oh = (xp.shape[2] - ((kh - 1) * dh + 1)) // sh + 1
    ow = (xp.shape[3] - ((kw - 1) * dw + 1)) // sw + 1
    if kh == kw == 1:
        cols = xp[:, :, ::sh, ::sw][:, :, :oh, :ow].permute(0, 2, 3, 1)
        cols = cols.reshape(n * oh * ow, c)
    else:
        cols = F.unfold(xp.to(torch.float16), (kh, kw), dilation=(dh, dw),
                        stride=(sh, sw)).to(torch.int8)
        cols = cols.transpose(1, 2).reshape(n * oh * ow, c * kh * kw)
    acc = int_mm(cols, w.reshape(o, -1).t())
    return acc.reshape(n, oh, ow, o).permute(0, 3, 1, 2)


def conv_int_acc(x, w, x_zp, w_zp, strides, dilations, groups, pads):
    """conv(x - x_zp, w - w_zp) over 4-D x and w with zero padding of the
    shifted input, exact, int32."""
    if _int8_ok(x, w, w_zp) and groups == 1:
        xn, zp = _as_int8(x, x_zp)
        acc = _conv_im2col(xn, w, strides, dilations, pads)
        if zp is not None:
            ones = torch.ones((1,) + tuple(x.shape[1:]), dtype=torch.int8,
                              device=x.device)
            acc = acc - zp * _conv_im2col(ones, w, strides, dilations, pads)
        return acc
    return _f64_exact(
        lambda xd, wd: F.conv2d(pad_spatial(xd, pads), wd, None, strides, 0,
                                dilations, groups),
        _minus_zp(x, x_zp), _minus_zp(w, w_zp))


@register("QLinearConv")
def qlinear_conv(ctx, attrs, x, x_scale, x_zp, w, w_scale, w_zp,
                 y_scale, y_zp, b=None):
    """Quantized conv: int32 conv accumulation with scales applied at the
    output, then requantization. Bias is int32 at scale x_scale*w_scale
    (ONNX spec)."""
    x4, w4, strides, dilations, groups, pads, squeeze_h = conv_geometry(
        attrs, x, w, "QLinearConv")
    acc = conv_int_acc(x4, w4, x_zp, w_zp, strides, dilations, groups, pads)
    if b is not None:
        acc = acc + b.to(torch.int32).reshape(1, -1, 1, 1)
    w_s = w_scale
    if w_s.ndim == 1:         # per-output-channel
        w_s = w_s.reshape(1, -1, 1, 1)
    out_f32 = acc.to(torch.float32) * x_scale * w_s
    out = _requantize(torch.round(out_f32 / y_scale), y_zp)
    return out[:, :, 0, :] if squeeze_h else out


@register("Silu")
def silu(ctx, attrs, x):
    return x * torch.sigmoid(x)


@register("ConvInteger")
def conv_integer(ctx, attrs, x, w, x_zero_point=None, w_zero_point=None):
    """int8/uint8 conv with int32 accumulation (ONNX ConvInteger): the
    integer half of a weight-only quantized conv — callers rescale the
    int32 output by x_scale*w_scale."""
    x4, w4, strides, dilations, groups, pads, squeeze_h = conv_geometry(
        attrs, x, w, "ConvInteger")
    acc = conv_int_acc(x4, w4, x_zero_point, w_zero_point, strides,
                       dilations, groups, pads)
    return acc[:, :, 0, :] if squeeze_h else acc
