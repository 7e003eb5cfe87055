"""Shared helpers for operator lowerings: attribute decoding, padding
arithmetic, dtype coercion conventions.

The torch counterpart of ``rten_tpu/ops/common.py``. Dtype conventions
follow the reference's i32-only integer world (``rten-convert`` coerces
i64/bool→i32): comparison and logical ops produce int32, boolean-consuming
ops accept int32. The reference runs JAX without 64-bit types, so a 64-bit
host array becomes 32-bit on the way to the device (:func:`to_tensor`).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..fmt import schema

AUTOPAD_SAME = schema.ENUMS["AutoPad"].index("Same")
AUTOPAD_NOTSET = schema.ENUMS["AutoPad"].index("NotSet")
AUTOPAD_SAME_LOWER = schema.ENUMS["AutoPad"].index("SameLower")

# JAX without x64 keeps 32-bit types: numpy's 64-bit ones narrow on entry.
_NARROW = {np.dtype(np.int64): np.int32, np.dtype(np.uint64): np.uint32,
           np.dtype(np.float64): np.float32}


def to_tensor(x, device):
    """A host value (numpy array or scalar) as a tensor on ``device``, with
    64-bit types narrowed to 32 bits as ``jnp.asarray`` narrows them."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    arr = np.asarray(x)
    narrow = _NARROW.get(arr.dtype)
    if narrow is not None:
        arr = arr.astype(narrow)
    if not (arr.flags.c_contiguous and arr.flags.writeable):
        arr = np.array(arr)         # e.g. a read-only view of the file
    return torch.from_numpy(arr).to(device)


def as_bool(x):
    """Interpret an int32 0/1 tensor as boolean."""
    return x != 0


def bool_out(x):
    """Encode a boolean tensor as int32 (reference convention)."""
    return x.to(torch.int32)


def static_ints(x) -> list[int]:
    """A static (numpy) operand as a list of python ints."""
    return [int(v) for v in np.asarray(x).reshape(-1)]


def static_int(x) -> int:
    arr = np.asarray(x).reshape(-1)
    return int(arr[0])


def attr_ints(attrs, key, default=None):
    v = attrs.get(key)
    if v is None:
        return default
    return [int(x) for x in np.asarray(v).reshape(-1)]


def normalize_axis(axis: int, rank: int) -> int:
    if axis < 0:
        axis += rank
    if not (0 <= axis < rank):
        raise ValueError(f"axis {axis} out of range for rank {rank}")
    return axis


def same_pads(in_size: int, stride: int, kernel: int, dilation: int = 1,
              lower: bool = False):
    """SAME padding: output size = ceil(in/stride). ``lower=False`` is
    ONNX SAME_UPPER (excess padding at the end; the reference's
    AutoPad::Same); ``lower=True`` is SAME_LOWER (excess at the start)."""
    out_size = -(-in_size // stride)
    eff_kernel = (kernel - 1) * dilation + 1
    total = max(0, (out_size - 1) * stride + eff_kernel - in_size)
    lo = total // 2
    if lower:
        return total - lo, lo
    return lo, total - lo


def resolve_pads(attrs, n_spatial: int, in_sizes, kernel, strides,
                 dilations=None):
    """Per-spatial-dim (lo, hi) padding from attrs (auto_pad / pads).

    ``pads`` wire layout is ONNX-style [x1_begin, x2_begin, ..., x1_end, ...]
    i.e. [top, left, bottom, right] for 2-D, [left, right] for 1-D
    (reference ``schema.fbs`` ConvAttrs comment).
    """
    dilations = dilations or [1] * n_spatial
    # Decoded file attrs always carry auto_pad (schema default). For
    # hand-built attrs the absent key means NOTSET (the ONNX default).
    auto = attrs.get("auto_pad", AUTOPAD_NOTSET)
    if auto in (AUTOPAD_SAME, AUTOPAD_SAME_LOWER):
        return [same_pads(in_sizes[i], strides[i], kernel[i], dilations[i],
                          lower=auto == AUTOPAD_SAME_LOWER)
                for i in range(n_spatial)]
    pads = attr_ints(attrs, "pads")
    if pads is None:
        return [(0, 0)] * n_spatial
    if len(pads) != 2 * n_spatial:
        raise ValueError(f"expected {2*n_spatial} pad values, got {len(pads)}")
    return [(pads[i], pads[n_spatial + i]) for i in range(n_spatial)]


def pad_spatial(x, pads, value=0.0):
    """``x`` [N, C, H, W] padded by per-dim (lo, hi) ``pads`` (H then W)
    with ``value``; asymmetric pads are why the convs and pools pad here
    and call torch with padding 0."""
    (t, b), (l, r) = pads
    if not (t or b or l or r):
        return x
    return torch.nn.functional.pad(x, (l, r, t, b), value=value)


@contextlib.contextmanager
def full_f32():
    """f32 products as the reference computes them: TF32 off for cuBLAS and
    cuDNN while the block runs (both default to allowing it on some
    installs; ``torch.backends.cudnn.allow_tf32`` defaults to True), and
    the caller's settings restored after it."""
    cudnn = torch.backends.cudnn
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic,
                         allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
