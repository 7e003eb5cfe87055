"""Reduction ops: ArgMax/ArgMin, CumSum, NonZero, Reduce*, TopK.

The torch counterpart of ``rten_tpu/ops/reduce.py`` (reference
``src/ops/reduce.rs``). NonZero is data-dependent (its output shape
depends on values): the executor hands it numpy arrays on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from .common import normalize_axis, static_int
from .registry import OpError, register


def _argreduce(name, fn):
    @register(name)
    def op(ctx, attrs, x):
        axis = normalize_axis(int(attrs.get("axis", 0)), x.ndim)
        keep = bool(attrs.get("keep_dims", True)) if "keep_dims" in attrs else True
        # First index of the extreme value, as jnp.argmax/argmin return.
        out = fn(x, dim=axis, keepdim=keep).to(torch.int32)
        return out
    op.__name__ = name.lower()
    return op


_argreduce("ArgMax", torch.argmax)
_argreduce("ArgMin", torch.argmin)


@register("CumSum", static=(1,))
def cumsum(ctx, attrs, x, axis):
    return torch.cumsum(x, dim=static_int(axis), dtype=x.dtype)


@register("NonZero", data_dependent=True)
def nonzero(ctx, attrs, x):
    # Host-side only: output shape is value-dependent. Returns [rank, n]
    # int32, matching ONNX/reference.
    arr = np.asarray(x)
    return np.stack(np.nonzero(arr)).astype(np.int32)


def _reduce(name, fn, finalize=None, prepare=None):
    @register(name, static=(1,))
    def op(ctx, attrs, x, axes_input=None):
        axes = attrs.get("axes")
        if axes_input is not None:
            axes = axes_input
        if axes is not None:
            axes = tuple(normalize_axis(int(a), x.ndim)
                         for a in np.asarray(axes).reshape(-1))
            if not axes:
                axes = None
        keep = bool(attrs.get("keep_dims", True)) if "keep_dims" in attrs else True
        if axes is None:
            axes = tuple(range(x.ndim))
        if prepare is not None:
            x = prepare(x)
        out = fn(x, axes, keep)
        if finalize is not None:
            out = finalize(out)
        return out
    op.__name__ = name.lower()
    return op


def _sum(x, axes, keep):
    # jnp.sum keeps int32 for int32 input; torch.sum would widen to int64.
    return torch.sum(x, dim=axes, keepdim=keep, dtype=x.dtype)


def _prod(x, axes, keep):
    for a in sorted(axes, reverse=True):
        x = torch.prod(x, dim=a, keepdim=keep, dtype=x.dtype)
    return x


def _mean(x, axes, keep):
    return torch.mean(x if x.is_floating_point() else x.to(torch.float32),
                      dim=axes, keepdim=keep)


_reduce("ReduceSum", _sum)
_reduce("ReduceMean", _mean)
_reduce("ReduceMin", lambda x, axes, keep: torch.amin(x, dim=axes,
                                                      keepdim=keep))
_reduce("ReduceMax", lambda x, axes, keep: torch.amax(x, dim=axes,
                                                      keepdim=keep))
_reduce("ReduceProd", _prod)
_reduce("ReduceL2", _sum, prepare=torch.square, finalize=torch.sqrt)
_reduce("ReduceSumSquare", _sum, prepare=torch.square)


@register("TopK", static=(1,))
def topk(ctx, attrs, x, k):
    kk = static_int(k)
    axis = int(attrs.get("axis", -1))
    axis = normalize_axis(axis, x.ndim)
    largest = bool(attrs.get("largest", True)) if "largest" in attrs else True
    if kk > x.shape[axis]:
        raise OpError("TopK", f"k={kk} exceeds axis size {x.shape[axis]}")
    moved = torch.movedim(x, axis, -1)
    # lax.top_k keeps the lower index first among equal values: a stable
    # descending sort does too.
    key = moved if largest else -moved
    order = torch.sort(key, dim=-1, descending=True, stable=True).indices
    indices = order[..., :kk]
    values = torch.gather(moved, -1, indices)
    values = torch.movedim(values, -1, axis)
    indices = torch.movedim(indices, -1, axis).to(torch.int32)
    return values, indices
