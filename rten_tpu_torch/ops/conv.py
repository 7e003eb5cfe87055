"""Conv / ConvTranspose.

The torch counterpart of ``rten_tpu/ops/conv.py``, whose lowering is XLA's
``conv_general_dilated`` in f32. Here cuDNN (or the CPU's conv) runs the
same geometry with TF32 off: the call sits inside
:func:`~.common.full_f32`, which sets ``torch.backends.cudnn.allow_tf32``
(True by default) and ``torch.backends.cuda.matmul.allow_tf32`` to False
for the call and restores the caller's settings after it. Asymmetric pads
are applied to the input first; the bias is added after the conv, as the
reference adds it. 1-D convs are lifted to 2-D with a unit height.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import (AUTOPAD_NOTSET, AUTOPAD_SAME, AUTOPAD_SAME_LOWER,
                     attr_ints, full_f32, pad_spatial, resolve_pads,
                     same_pads)
from .registry import OpError, register


def _lift_1d(x, w):
    """[N,C,W] → [N,C,1,W] (and kernel likewise)."""
    return x[:, :, None, :], w[:, :, None, :]


def conv_geometry(attrs, x, w, op="Conv"):
    """(x and w as 4-D, strides, dilations, groups, per-dim (lo, hi) pads,
    whether to drop the unit height) of a Conv-like op, as the reference
    resolves them."""
    squeeze_h = False
    if x.ndim == 3:
        x, w = _lift_1d(x, w)
        squeeze_h = True
    if x.ndim != 4:
        raise OpError(op, f"unsupported input rank {x.ndim}")
    kernel = w.shape[2:]
    strides = attr_ints(attrs, "strides") or []
    dilations = attr_ints(attrs, "dilations") or []
    groups = int(attrs.get("groups") or 1)
    if squeeze_h:
        strides = [1, strides[0] if strides else 1]
        dilations = [1, dilations[0] if dilations else 1]
        pads = [(0, 0),
                _pads_1d(attrs, x.shape[3], kernel[1], strides[1],
                         dilations[1])]
    else:
        strides = strides or [1, 1]
        dilations = dilations or [1, 1]
        pads = resolve_pads(attrs, 2, x.shape[2:], kernel, strides,
                            dilations)
    return x, w, strides, dilations, groups, pads, squeeze_h


@register("Conv")
def conv(ctx, attrs, x, w, b=None):
    x, w, strides, dilations, groups, pads, squeeze_h = conv_geometry(
        attrs, x, w)
    with full_f32():
        out = F.conv2d(pad_spatial(x.to(torch.float32), pads),
                       w.to(torch.float32), None, strides, 0, dilations,
                       groups)
    if b is not None:
        out = out + b.reshape(1, -1, 1, 1)
    if squeeze_h:
        out = out[:, :, 0, :]
    return out


def _pads_1d(attrs, in_size, kernel, stride, dilation):
    auto = attrs.get("auto_pad", AUTOPAD_NOTSET)
    if auto in (AUTOPAD_SAME, AUTOPAD_SAME_LOWER):
        return same_pads(in_size, stride, kernel, dilation,
                         lower=auto == AUTOPAD_SAME_LOWER)
    pads = attr_ints(attrs, "pads")
    if pads is None:
        return (0, 0)
    if len(pads) == 2:
        return (pads[0], pads[1])
    raise OpError("Conv", "1-D conv expects 2 pad values")


@register("ConvTranspose")
def conv_transpose(ctx, attrs, x, w, b=None):
    squeeze_h = False
    if x.ndim == 3:
        x, w = _lift_1d(x, w)
        squeeze_h = True
    if x.ndim != 4:
        raise OpError("ConvTranspose", f"unsupported input rank {x.ndim}")
    n_spatial = 2

    def spatial(name, default):
        v = attr_ints(attrs, name)
        if v is None:
            return [default] * n_spatial
        v = [int(i) for i in v]
        if squeeze_h:
            return [default, v[-1]]
        return v

    strides = spatial("strides", 1)
    dilations = spatial("dilations", 1)
    out_pad = spatial("output_padding", 0)
    groups = int(attrs.get("groups") or 1)
    kernel = w.shape[2:]
    k_eff = [(kernel[i] - 1) * dilations[i] + 1 for i in range(n_spatial)]
    auto = attrs.get("auto_pad", AUTOPAD_NOTSET)
    if auto in (AUTOPAD_SAME, AUTOPAD_SAME_LOWER):
        pads = []
        for i in range(n_spatial):
            total = max(0, k_eff[i] - strides[i])
            lo = total // 2
            pads.append((total - lo, lo) if auto == AUTOPAD_SAME_LOWER
                        else (lo, total - lo))
    else:
        p = attr_ints(attrs, "pads")
        if p is None:
            pads = [(0, 0)] * n_spatial
        elif len(p) == 2 and squeeze_h:
            pads = [(0, 0), (p[0], p[1])]
        elif len(p) == 2 * n_spatial:
            pads = [(p[i], p[n_spatial + i]) for i in range(n_spatial)]
        else:
            raise OpError("ConvTranspose", "bad pads length")
    c_in = w.shape[0]
    if c_in % groups:
        raise OpError("ConvTranspose", f"groups {groups} !| C_in {c_in}")
    # The full transposed conv is (in - 1) * stride + k_eff wide; ONNX pads
    # crop it (lo at the start, hi at the end) and output_padding extends
    # the end, where the reference's fractionally-strided conv reads only
    # zero-padded input.
    with full_f32():
        full = F.conv_transpose2d(x.to(torch.float32), w.to(torch.float32),
                                  None, strides, 0, 0, groups, dilations)
    out = full
    for axis, (lo, hi) in zip((2, 3), pads):
        size = full.shape[axis] - lo - hi + out_pad[axis - 2]
        keep = min(size, full.shape[axis] - lo)
        out = out.narrow(axis, lo, keep)
        if size > keep:
            extra = list(out.shape)
            extra[axis] = size - keep
            out = torch.cat([out, out.new_zeros(extra)], dim=axis)
    if b is not None:
        out = out + b.reshape(1, -1, 1, 1)
    if squeeze_h:
        out = out[:, :, 0, :]
    return out
