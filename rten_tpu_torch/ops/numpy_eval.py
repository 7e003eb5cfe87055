"""Numpy evaluators for fold-common operators.

A copy of ``rten_tpu/ops/numpy_eval.py``. Load-time constant folding
(weight dequant chains, shape arithmetic) stays on the host: ops in this
table evaluate with pure numpy when all inputs are static; anything not
listed runs its torch lowering on CPU tensors and the result goes back to
numpy.

Semantics mirror the lowerings (i32 bool convention, trunc division).
"""

from __future__ import annotations

import numpy as np

from ..fmt import schema


def _dequantize_linear(attrs, x, scale, zp=None):
    axis = int(attrs.get("axis", 1))
    x32 = x.astype(np.int32)
    scale = np.asarray(scale, np.float32)
    if scale.ndim == 1 and scale.size > 1:
        shape = [1] * x32.ndim
        shape[axis if axis >= 0 else axis + x32.ndim] = -1
        scale = scale.reshape(shape)
        if zp is not None:
            zp = np.asarray(zp, np.int32).reshape(shape)
    if zp is not None:
        x32 = x32 - np.asarray(zp, np.int32)
    return x32.astype(np.float32) * scale


def _quantize_linear(attrs, x, scale, zp=None):
    axis = int(attrs.get("axis", 1))
    scale = np.asarray(scale, np.float32)
    dtype = zp.dtype if zp is not None else np.uint8
    if scale.ndim == 1 and scale.size > 1:
        shape = [1] * x.ndim
        shape[axis if axis >= 0 else axis + x.ndim] = -1
        scale = scale.reshape(shape)
        if zp is not None:
            zp = np.asarray(zp).reshape(shape)
    y = np.round(x / scale)
    if zp is not None:
        y = y + zp.astype(np.float32)
    info = np.iinfo(dtype)
    return np.clip(y, info.min, info.max).astype(dtype)


def _cast(attrs, x):
    to = int(attrs.get("to", 0))
    if schema.ENUMS["DataType"][to] == "Int32":
        return x.astype(np.int32)
    return x.astype(np.float32)


def _transpose(attrs, x):
    perm = attrs.get("perm")
    if perm is None:
        return np.transpose(x)
    return np.transpose(x, [int(p) for p in np.asarray(perm).reshape(-1)])


def _concat(attrs, *xs):
    return np.concatenate(xs, axis=int(attrs.get("axis", 0)))


def _gather(attrs, x, idx):
    axis = int(attrs.get("axis", 0))
    idx = np.where(idx < 0, idx + x.shape[axis], idx)
    return np.take(x, idx, axis=axis)


def _unsqueeze(attrs, x, axes):
    out_rank = x.ndim + axes.size
    dims = sorted((int(a) + out_rank) if a < 0 else int(a)
                  for a in axes.reshape(-1))
    return np.expand_dims(x, axis=tuple(dims))


def _squeeze(attrs, x, axes=None):
    if axes is None:
        return np.squeeze(x)
    dims = tuple(int(a) if a >= 0 else int(a) + x.ndim
                 for a in axes.reshape(-1))
    return np.squeeze(x, axis=dims)


NUMPY_EVAL = {
    "DequantizeLinear": _dequantize_linear,
    "QuantizeLinear": _quantize_linear,
    "Cast": _cast,
    "Transpose": _transpose,
    "Concat": _concat,
    "Gather": _gather,
    "Unsqueeze": _unsqueeze,
    "Squeeze": _squeeze,
    "Identity": lambda attrs, x: x,
    "Add": lambda attrs, a, b: a + b,
    "Sub": lambda attrs, a, b: a - b,
    "Mul": lambda attrs, a, b: a * b,
    "Neg": lambda attrs, x: -x,
    "Sqrt": lambda attrs, x: np.sqrt(x),
    "Reciprocal": lambda attrs, x: (1.0 / x).astype(x.dtype)
    if np.issubdtype(x.dtype, np.floating) else 1 // x,
    "Relu": lambda attrs, x: np.maximum(x, 0),
}


def try_numpy_eval(op_type, attrs, args):
    """Evaluate on host if supported; returns (True, result) or
    (False, None)."""
    fn = NUMPY_EVAL.get(op_type)
    if fn is None:
        return False, None
    np_args = [None if a is None else np.asarray(a) for a in args]
    try:
        return True, fn(attrs, *[a for a in np_args])
    except Exception:
        return False, None
