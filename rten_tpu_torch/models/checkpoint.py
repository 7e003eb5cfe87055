"""Parameter checkpoints as one ``.npz`` (port of
``rten_tpu/models/checkpoint.py``), interchangeable with the JAX
package's files in both directions.

Keys flatten the tree with ``/`` separators (list items as ``[i]``); a
``QuantWeight`` leaf expands to ``<path>#q{kind,group,n}/data`` and
``.../scales``. The port pads an int8 weight's columns to a multiple of 8
(:func:`~rten_tpu_torch.kernels.gemm.pad_cols`); a file holds the
reference's unpadded ``data`` [..., K, n] and ``scales`` [..., n], so the
JAX package reads a port file bit for bit, and the port pads again on
load. int4 records carry over as they are.
"""

from __future__ import annotations

import re
from types import SimpleNamespace

import numpy as np
import torch

from .convert import params_from_numpy
from .transformer import QuantWeight


def _array(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _flatten(tree, prefix, out):
    if isinstance(tree, dict):
        for key, value in tree.items():
            _flatten(value, f"{prefix}{key}/", out)
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            _flatten(value, f"{prefix}[{i}]/", out)
    elif isinstance(tree, QuantWeight):
        tag = f"{prefix[:-1]}#q{{{tree.kind},{tree.group},{tree.n}}}/"
        data, scales = _array(tree.data), _array(tree.scales)
        if tree.kind == "int8" and tree.n:
            data, scales = data[..., :tree.n], scales[..., :tree.n]
        out[tag + "data"] = np.ascontiguousarray(data)
        out[tag + "scales"] = np.ascontiguousarray(scales)
    elif tree is None:
        pass
    else:
        out[prefix[:-1]] = _array(tree)


def save_params(path, params):
    """Write ``params`` (tensors on any device, ``QuantWeight`` leaves,
    nested dicts and lists) to ``path`` as the reference's ``.npz``."""
    flat: dict[str, np.ndarray] = {}
    _flatten(params, "", flat)
    np.savez(path, **flat)


_QTAG = re.compile(r"^(.*)#q\{(\w+),(\d+),(\d+)\}$")


def load_params(path, device="cuda") -> dict:
    """A file of :func:`save_params` or of the reference's as the port's
    tree on ``device`` (int8 records padded again)."""
    data = np.load(path, allow_pickle=False)
    tree: dict = {}
    quant: dict[str, dict] = {}
    for key in data.files:
        parts = key.split("/")
        m = _QTAG.match("/".join(parts[:-1]))
        if m:
            base, kind, group, n = m.groups()
            rec = quant.setdefault(base, {"kind": kind, "group": int(group),
                                          "n": int(n)})
            rec[parts[-1]] = data[key]
            continue
        _insert(tree, parts, data[key])
    for base, rec in quant.items():
        _insert(tree, base.split("/"), SimpleNamespace(**rec))
    return params_from_numpy(_listify(tree), device)


def _insert(tree, parts, value):
    node = tree
    for part in parts[:-1]:
        node = node.setdefault(part, {})
    node[parts[-1]] = value


_IDX = re.compile(r"^\[(\d+)\]$")


def _listify(node):
    """Convert {'[0]': ..., '[1]': ...} dicts back into lists."""
    if not isinstance(node, dict):
        return node
    out = {k: _listify(v) for k, v in node.items()}
    if out and all(_IDX.match(k) for k in out):
        return [out[f"[{i}]"] for i in range(len(out))]
    return out
