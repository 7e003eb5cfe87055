"""Int8 quantization math (the int8 half of ``rten_tpu/kernels/quant.py``)
plus the per-(token, head) KV quantizer of
``rten_tpu/generate/kv_cache.py::_quantize_tokens``.

Every division here is an IEEE float32 division (never a multiply by a
reciprocal) and every rounding is round-half-even (``torch.round``), so
the results match the reference bit for bit.
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
    scale = (x_max - x_min) / 255.0
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
                         absmax / 127.0)
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
                        absmax / 127.0).to(torch.bfloat16)
    q = torch.clamp(torch.round(x / scale.to(torch.float32)[..., None]),
                    -127, 127).to(torch.int8)
    return q, scale
