"""Operator registry: op-type name → lowering function + metadata.

A copy of ``rten_tpu/ops/registry.py`` (the reference's ``Operator`` trait
+ ``OpRegistry``, ``src/ops/mod.rs:821-913``, ``src/op_registry.rs``):
each ONNX-equivalent operator is a lowering function
``fn(ctx, attrs, *inputs) -> tensor | tuple`` over ``torch``. The port's
executor (:mod:`rten_tpu_torch.runtime.executor`) runs them one by one in
topological order.

Metadata per op:

* ``static``: input indices whose *values* must be known on the host
  (shape-like operands: Reshape's shape, Slice's starts/ends, ...). The
  executor feeds these as numpy arrays resolved from constants or
  statically-propagated values.
* ``data_dependent``: output shape depends on input *values* (NonZero):
  the executor hands such ops numpy arrays.
* ``random``: consumes PRNG state (``ctx.rng()``).

Only the op modules ported so far register (:func:`ensure_registered`);
an op type of a module still to port raises :class:`OpError` naming its
ROADMAP item.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable


@dataclass
class OpSpec:
    name: str
    fn: Callable
    static: tuple = ()
    data_dependent: bool = False
    random: bool = False
    has_subgraph: bool = False


OPS: dict[str, OpSpec] = {}


def register(name, static=(), data_dependent=False, random=False,
             has_subgraph=False):
    def deco(fn):
        OPS[name] = OpSpec(name, fn, tuple(static), data_dependent, random,
                           has_subgraph)
        return fn
    return deco


class OpError(ValueError):
    """Operator input/attribute validation error (analog of the
    reference's ``OpError``, ``src/ops/mod.rs:666-686``)."""

    def __init__(self, op_name, message):
        super().__init__(f"{op_name}: {message}")
        self.op_name = op_name


# The reference's op modules that the port has not ported yet, with their
# op types: a graph that uses one raises naming the ROADMAP item.
NOT_PORTED = {
    "control_flow": ("If",),
    "gather": ("Gather", "GatherElements", "GatherND", "ScatterElements",
               "ScatterND", "OneHot"),
    "generate": ("ConstantOfShape", "Range", "RandomUniform",
                 "RandomUniformLike", "RandomNormal", "RandomNormalLike"),
    "nms": ("NonMaxSuppression",),
    "resize": ("Resize",),
    "rnn": ("GRU", "LSTM"),
}


def get_op(name: str) -> OpSpec:
    spec = OPS.get(name)
    if spec is None:
        module = next((m for m, names in NOT_PORTED.items()
                       if name in names), None)
        if module is not None:
            raise OpError(name, "not ported yet: ROADMAP.md Queue 1, graph "
                          f"runtime: ops/{module}.py")
        raise OpError(name, "operator not registered")
    return spec


def ensure_registered():
    """Import the ported op modules so their @register decorators run."""
    from . import (conv, elementwise, layout, matmul,  # noqa: F401
                   norm, pool, quantized, reduce)
