"""Normalization ops: BatchNormalization, InstanceNormalization,
LayerNormalization, Softmax, LogSoftmax.

The torch counterpart of ``rten_tpu/ops/norm.py`` (reference
``src/ops/norm.rs``), with the reference's formulas term for term.
"""

from __future__ import annotations

import torch

from .common import normalize_axis
from .registry import register


def _channel(p, x):
    shape = [1] * x.ndim
    shape[1] = x.shape[1]
    return p.reshape(shape)


@register("BatchNormalization")
def batch_norm(ctx, attrs, x, scale, bias, mean, var):
    eps = float(attrs.get("epsilon", 1e-5))
    # Params are per-channel (axis 1, NCHW).
    inv = torch.rsqrt(_channel(var, x) + eps)
    return (x - _channel(mean, x)) * inv * _channel(scale, x) \
        + _channel(bias, x)


def _mean_var(x, axes):
    mean = torch.mean(x, dim=axes, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=axes, keepdim=True)
    return mean, var


@register("InstanceNormalization")
def instance_norm(ctx, attrs, x, scale, bias):
    eps = float(attrs.get("epsilon", 1e-5))
    axes = tuple(range(2, x.ndim))  # spatial dims of NC...
    mean, var = _mean_var(x, axes)
    return ((x - mean) * torch.rsqrt(var + eps) * _channel(scale, x)
            + _channel(bias, x))


@register("LayerNormalization")
def layer_norm(ctx, attrs, x, scale, bias=None):
    eps = float(attrs.get("epsilon", 1e-5))
    axis = int(attrs.get("axis", -1))
    if axis < 0:
        axis += x.ndim
    axes = tuple(range(axis, x.ndim))
    mean, var = _mean_var(x, axes)
    out = (x - mean) * torch.rsqrt(var + eps) * scale
    if bias is not None:
        out = out + bias
    return out


@register("Softmax")
def softmax(ctx, attrs, x):
    axis = normalize_axis(int(attrs.get("axis", -1)), x.ndim)
    return torch.softmax(x, dim=axis)


@register("LogSoftmax")
def log_softmax(ctx, attrs, x):
    axis = normalize_axis(int(attrs.get("axis", -1)), x.ndim)
    return torch.log_softmax(x, dim=axis)
