"""Pooling ops: AveragePool, MaxPool, GlobalAveragePool.

The torch counterpart of ``rten_tpu/ops/pool.py`` (reference
``src/ops/pooling.rs``), which reduces windows over explicitly padded
input (``lax.reduce_window``): here the input is padded first (-inf for
max, 0 for the average's sum, so pads may be asymmetric or wider than half
the window) and torch pools with padding 0. 1-D pools are lifted to 2-D
with unit height.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import attr_ints, pad_spatial, resolve_pads
from .registry import OpError, register


def _pool_params(attrs, x):
    kernel = attr_ints(attrs, "kernel_size")
    if kernel is None:
        raise OpError("Pool", "missing kernel_size")
    n_spatial = len(kernel)
    strides = attr_ints(attrs, "strides") or [1] * n_spatial
    pads = resolve_pads(attrs, n_spatial, x.shape[2:], kernel, strides)
    return kernel, strides, pads


def _lifted(attrs, x):
    """(x as 4-D, kernel, strides, pads, whether to drop the unit
    height)."""
    squeeze_h = x.ndim == 3
    kernel, strides, pads = _pool_params(attrs, x)
    if squeeze_h:
        x = x[:, :, None, :]
        kernel, strides, pads = [1] + kernel, [1] + strides, [(0, 0)] + pads
    return x, kernel, strides, pads, squeeze_h


@register("MaxPool")
def max_pool(ctx, attrs, x):
    x, kernel, strides, pads, squeeze_h = _lifted(attrs, x)
    if x.is_floating_point():
        out = F.max_pool2d(pad_spatial(x, pads, -math.inf), kernel, strides)
    else:
        # int32 values are exact in f64 (CUDA has no integer max pool).
        low = float(torch.iinfo(torch.int32).min)
        out = F.max_pool2d(pad_spatial(x.to(torch.float64), pads, low),
                           kernel, strides).to(x.dtype)
    return out[:, :, 0, :] if squeeze_h else out


def _window_sum(x, kernel, strides, pads):
    """The sum of each window of the zero-padded input (the reference's
    ``reduce_window(add)``): an average pool without a divisor."""
    return F.avg_pool2d(pad_spatial(x, pads), kernel, strides,
                        divisor_override=1)


@register("AveragePool")
def average_pool(ctx, attrs, x):
    x, kernel, strides, pads, squeeze_h = _lifted(attrs, x)
    include_pad = bool(attrs.get("count_include_pad", False))
    total = _window_sum(x, kernel, strides, pads)
    if include_pad or all(p == (0, 0) for p in pads):
        # A tensor divisor: CUDA turns a division by a Python float into
        # a multiply by its reciprocal.
        out = total / torch.full_like(total, float(kernel[0] * kernel[1]))
    else:
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                          device=x.device)
        counts = _window_sum(ones, kernel, strides, pads)[0, 0]
        out = total / counts
    return out[:, :, 0, :] if squeeze_h else out


@register("GlobalAveragePool")
def global_average_pool(ctx, attrs, x):
    axes = tuple(range(2, x.ndim))
    return torch.mean(x, dim=axes, keepdim=True)
