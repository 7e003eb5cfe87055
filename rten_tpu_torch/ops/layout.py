"""Shape/layout operators: Reshape, Flatten, Squeeze, Unsqueeze, Transpose,
Expand, Shape, Size, Concat, Split, Slice, Pad, Tile, Trilu.

The torch counterpart of ``rten_tpu/ops/layout.py`` (reference
``src/ops/layout.rs``, ``concat.rs``, ``slice.rs``, ``pad.rs``,
``trilu.rs``). Shape-valued operands (Reshape's target shape, Slice
bounds, ...) are static numpy values; ``Shape``/``Size`` *produce* static
numpy values, so shape-computation chains stay on the host and never wait
for the card.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .common import normalize_axis, static_ints
from .registry import OpError, register


@register("Reshape", static=(1,))
def reshape(ctx, attrs, x, shape):
    target = static_ints(shape)
    allow_zero = bool(attrs.get("allow_zero", False))
    out = []
    for i, d in enumerate(target):
        if d == 0 and not allow_zero:
            if i >= x.ndim:
                raise OpError("Reshape", "0-dim beyond input rank")
            out.append(x.shape[i])
        else:
            out.append(d)
    if out.count(-1) > 1:
        raise OpError("Reshape", "multiple -1 dims")
    return torch.reshape(x, out)


@register("Flatten")
def flatten(ctx, attrs, x):
    axis = int(attrs.get("axis", 1))
    if axis < 0:
        axis += x.ndim
    lead = int(np.prod(x.shape[:axis], dtype=np.int64)) if axis else 1
    return torch.reshape(x, (lead, -1))


@register("Squeeze", static=(1,))
def squeeze(ctx, attrs, x, axes=None):
    if axes is None:
        return torch.squeeze(x)
    dims = [normalize_axis(a, x.ndim) for a in static_ints(axes)]
    for d in dims:
        if x.shape[d] != 1:
            raise OpError("Squeeze", f"dim {d} has size {x.shape[d]}, not 1")
    return torch.squeeze(x, dim=tuple(dims))


@register("Unsqueeze", static=(1,))
def unsqueeze(ctx, attrs, x, axes):
    out_rank = x.ndim + len(static_ints(axes))
    dims = sorted((a + out_rank) if a < 0 else a for a in static_ints(axes))
    for d in dims:
        x = torch.unsqueeze(x, d)
    return x


@register("Transpose")
def transpose(ctx, attrs, x):
    perm = attrs.get("perm")
    if perm is None:
        return x.permute(*reversed(range(x.ndim)))
    return x.permute(*[int(p) for p in np.asarray(perm).reshape(-1)])


@register("Expand", static=(1,))
def expand(ctx, attrs, x, shape):
    target = static_ints(shape)
    out_shape = np.broadcast_shapes(tuple(x.shape), tuple(target))
    return torch.broadcast_to(x, out_shape)


@register("Shape")
def shape_op(ctx, attrs, x):
    # Static output: shape chains constant-fold on the host.
    return np.asarray(tuple(x.shape), dtype=np.int32)


@register("Size")
def size_op(ctx, attrs, x):
    return np.asarray(int(np.prod(tuple(x.shape), dtype=np.int64)),
                      dtype=np.int32)


@register("Concat")
def concat(ctx, attrs, *xs):
    axis = int(attrs.get("axis", 0))
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return torch.cat([x.to(dt) for x in xs], dim=axis)


@register("Split", static=(1,))
def split(ctx, attrs, x, split_sizes=None):
    axis = normalize_axis(int(attrs.get("axis", 0)), x.ndim)
    n_out = ctx.n_outputs
    if split_sizes is None:
        size = x.shape[axis]
        base = -(-size // n_out)  # ceil, ONNX spec for uneven default split
        sizes = []
        remaining = size
        for _ in range(n_out):
            sizes.append(min(base, remaining))
            remaining -= sizes[-1]
    else:
        sizes = static_ints(split_sizes)
    return tuple(torch.split(x, sizes, dim=axis))


@register("Slice", static=(1, 2, 3, 4))
def slice_(ctx, attrs, x, starts, ends, axes=None, steps=None):
    starts = static_ints(starts)
    ends = static_ints(ends)
    axes = static_ints(axes) if axes is not None else list(range(len(starts)))
    steps = static_ints(steps) if steps is not None else [1] * len(starts)
    for start, end, axis, step in zip(starts, ends, axes, steps):
        axis = normalize_axis(axis, x.ndim)
        size = x.shape[axis]
        # ONNX clamps out-of-range bounds; INT_MAX/INT_MIN mean "to the end".
        if step > 0:
            start = min(max(start + size if start < 0 else start, 0), size)
            end = min(max(end + size if end < 0 else end, 0), size)
            x = x.narrow(axis, start, max(end - start, 0))
            if step > 1:
                idx = [slice(None)] * x.ndim
                idx[axis] = slice(None, None, step)
                x = x[tuple(idx)]
        else:
            start = min(max(start + size if start < 0 else start, 0), size - 1)
            # ONNX: negative end counts from the back FIRST (end += size),
            # THEN clamps to [-1, size-1]; a post-adjust -1 (end < -size,
            # or INT_MIN) means "through index 0 inclusive".
            end = end + size if end < 0 else end
            end = min(max(end, -1), size)
            # torch has no negative steps: gather the indices.
            idx = torch.arange(start, end, step, device=x.device)
            x = x.index_select(axis, idx)
    return x


@register("Pad", static=(1,))
def pad(ctx, attrs, x, pads, value=None):
    p = static_ints(pads)
    n = x.ndim
    if len(p) != 2 * n:
        raise OpError("Pad", f"expected {2*n} pad values, got {len(p)}")
    widths = [(p[i], p[n + i]) for i in range(n)]
    mode = int(attrs.get("mode", 0))     # PadMode enum (schema)
    if mode:
        name = {1: "reflect", 2: "edge", 3: "wrap"}.get(mode)
        if name is None:
            raise OpError("Pad", f"unknown mode {mode}")
        out = x
        for axis, (lo, hi) in enumerate(widths):
            if lo or hi:
                out = _pad_axis(out, axis, lo, hi, name)
        return out
    fill = 0 if value is None else value.reshape(()).to(x.dtype).item()
    flat = []
    for lo, hi in reversed(widths):
        flat += [lo, hi]
    return F.pad(x, flat, value=fill)


def _pad_axis(x, axis, lo, hi, mode):
    """numpy's reflect / edge / wrap padding of one axis, by gathering."""
    size = x.shape[axis]
    i = torch.arange(-lo, size + hi, device=x.device)
    if mode == "edge":
        i = i.clamp(0, size - 1)
    elif mode == "wrap":
        i = torch.remainder(i, size)
    else:                                    # reflect (no edge repeat)
        period = 2 * (size - 1) if size > 1 else 1
        i = torch.remainder(i, period)
        i = torch.where(i >= size, period - i, i)
    return x.index_select(axis, i)


@register("Tile", static=(1,))
def tile(ctx, attrs, x, repeats):
    return torch.tile(x, tuple(static_ints(repeats)))


@register("Trilu", static=(1,))
def trilu(ctx, attrs, x, k=None):
    upper = bool(attrs.get("upper", False))
    kk = 0 if k is None else static_ints(k)[0]
    if upper:
        return torch.triu(x, kk)
    return torch.tril(x, kk)
