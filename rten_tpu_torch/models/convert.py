"""Carry a parameter tree across from the JAX package, given as numpy.

The port never imports the JAX ``QuantWeight``: a quantized entry is any
object with ``kind``, ``data``, ``scales`` and ``n`` attributes (duck
typing), whose int8 data and scales become the port's
:class:`~rten_tpu_torch.models.transformer.QuantWeight`, columns padded to
a multiple of 8 as the port's kernels require.
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
    ``device``; quantized records become int8 ``QuantWeight``s. Anything
    else passes through unchanged."""
    dev = resolve_device(device)

    def tensor(a):
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    def walk(obj):
        if isinstance(obj, dict):
            return {k: walk(v) for k, v in obj.items()}
        if isinstance(obj, list):
            return [walk(v) for v in obj]
        if _is_quant(obj):
            if obj.kind != "int8":
                raise NotImplementedError(
                    f"{obj.kind} weights are not ported yet (ROADMAP.md "
                    f"Queue 1 item 11)")
            data = tensor(np.asarray(obj.data, dtype=np.int8))
            scales = tensor(np.asarray(obj.scales, dtype=np.float32))
            data, scales = pad_cols(data, scales)
            return QuantWeight("int8", data, scales,
                               int(obj.n) or data.shape[1])
        if isinstance(obj, np.ndarray):
            return tensor(obj)
        return obj

    return walk(tree)
