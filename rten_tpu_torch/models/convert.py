"""Carry a parameter tree across from the JAX package, given as numpy.

The port never imports the JAX ``QuantWeight``: a quantized entry is any
object with ``kind``, ``data``, ``scales`` and ``n`` attributes (duck
typing) and becomes the port's
:class:`~rten_tpu_torch.models.transformer.QuantWeight`: int8 data with
its columns padded to a multiple of 8 as the port's kernels require, or
group-wise int4 (int32 words or uint8 bytes, f32 scales, ``group``) as it
is, its N already a multiple of 256.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.gemm import pad_cols
from .transformer import QuantWeight


def _is_quant(obj) -> bool:
    return all(hasattr(obj, a) for a in ("kind", "data", "scales", "n"))


def params_from_numpy(tree, device="cuda"):
    """Dicts and lists are walked; numpy arrays become tensors on
    ``device``; quantized records become ``QuantWeight``s. Anything else
    passes through unchanged."""
    dev = resolve_device(device)

    def tensor(a):
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    def walk(obj):
        if isinstance(obj, dict):
            return {k: walk(v) for k, v in obj.items()}
        if isinstance(obj, list):
            return [walk(v) for v in obj]
        if _is_quant(obj):
            if obj.kind == "int4":
                data = np.asarray(obj.data)
                if data.dtype not in (np.int32, np.uint8):
                    raise ValueError(f"int4 data must be int32 words or "
                                     f"uint8 bytes, got {data.dtype}")
                return QuantWeight(
                    "int4", tensor(data),
                    tensor(np.asarray(obj.scales, dtype=np.float32)),
                    int(obj.n) or 2 * data.shape[1], int(obj.group))
            if obj.kind != "int8":
                raise ValueError(f"unknown quantized kind {obj.kind!r}")
            data = tensor(np.asarray(obj.data, dtype=np.int8))
            scales = tensor(np.asarray(obj.scales, dtype=np.float32))
            data, scales = pad_cols(data, scales)
            return QuantWeight("int8", data, scales,
                               int(obj.n) or data.shape[1])
        if isinstance(obj, np.ndarray):
            return tensor(obj)
        return obj

    return walk(tree)


def resnet_params_from_numpy(params, device="cuda"):
    """A ResNet weights dict (name → numpy array, as the reference's
    ``ResNet.init_params`` gives it) as f32 tensors on ``device`` for
    :meth:`~rten_tpu_torch.models.resnet.ResNet.forward`."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(dev)
            for k, v in params.items()}
