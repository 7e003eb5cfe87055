"""Expression-pattern DSL over the graph IR.

Analog of the reference's ``src/optimize/pattern_matcher.rs``: build
operator-tree patterns with symbols and match them against producing
subgraphs, yielding symbol bindings. Used by optimizer fusions (QDQ →
quantized matmul, transpose-into-matmul).

Example::

    x = Symbol("x")
    pat = Op("Mul", Op("Sigmoid", x), x)       # silu(x) = x * sigmoid(x)
    bindings = pat.match(graph, node_id)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .graph import ConstantNode, Graph, OperatorNode


class Pattern:
    def match(self, graph: Graph, value_id: int,
              bindings: Optional[dict] = None) -> Optional[dict]:
        raise NotImplementedError

    # Operator sugar mirrors the reference's overloading.
    def __mul__(self, other):
        return Op("Mul", self, _as_pattern(other))

    def __add__(self, other):
        return Op("Add", self, _as_pattern(other))

    def __sub__(self, other):
        return Op("Sub", self, _as_pattern(other))

    def __truediv__(self, other):
        return Op("Div", self, _as_pattern(other))


def _as_pattern(x) -> Pattern:
    if isinstance(x, Pattern):
        return x
    return Const(value=x)


@dataclass
class Symbol(Pattern):
    """Matches any value; same symbol must bind the same value id."""
    name: str

    def match(self, graph, value_id, bindings=None):
        bindings = dict(bindings or {})
        if self.name in bindings and bindings[self.name] != value_id:
            return None
        bindings[self.name] = value_id
        return bindings


@dataclass
class Const(Pattern):
    """Matches a Constant node; optionally a specific scalar value and/or
    binds the node id to ``name``."""
    name: Optional[str] = None
    value: Optional[float] = None

    def match(self, graph, value_id, bindings=None):
        bindings = dict(bindings or {})
        node = graph.nodes[value_id]
        if not isinstance(node.data, ConstantNode):
            return None
        if self.value is not None:
            arr = node.data.array
            if arr.size != 1 or abs(float(arr.reshape(-1)[0])
                                    - self.value) > 1e-6:
                return None
        if self.name:
            if self.name in bindings and bindings[self.name] != value_id:
                return None
            bindings[self.name] = value_id
        return bindings


@dataclass
class Op(Pattern):
    """Matches a value produced by an operator of ``op_type`` whose inputs
    match the sub-patterns (order-sensitive; ``commutative=True`` also
    tries the swap for two-input ops). Binds the operator node id under
    ``bind`` if given."""
    op_type: str
    inputs: tuple = ()
    bind: Optional[str] = None
    commutative: bool = False

    def __init__(self, op_type, *inputs, bind=None, commutative=False):
        self.op_type = op_type
        self.inputs = tuple(_as_pattern(i) for i in inputs)
        self.bind = bind
        self.commutative = commutative

    def match(self, graph, value_id, bindings=None):
        bindings = dict(bindings or {})
        op_id = graph.producer_of(value_id)
        if op_id is None:
            return None
        op: OperatorNode = graph.nodes[op_id].data
        if op.op_type != self.op_type:
            return None
        real = [i for i in op.inputs if i is not None]
        orders = [real]
        if self.commutative and len(real) == 2:
            orders.append([real[1], real[0]])
        for order in orders:
            if len(order) < len(self.inputs):
                continue
            trial = dict(bindings)
            ok = True
            for sub, inp in zip(self.inputs, order):
                trial2 = sub.match(graph, inp, trial)
                if trial2 is None:
                    ok = False
                    break
                trial = trial2
            if ok:
                if self.bind:
                    trial[f"op:{self.bind}"] = op_id
                trial.setdefault("op:root", op_id)
                return trial
        return None


def find_matches(graph: Graph, pattern: Pattern):
    """All (value_id, bindings) where an operator output matches."""
    out = []
    for op_id in graph.operator_ids():
        op = graph.nodes[op_id].data
        if not isinstance(op, OperatorNode):
            continue
        for value_id in op.outputs:
            if value_id is None:
                continue
            bindings = pattern.match(graph, value_id)
            if bindings is not None:
                bindings = dict(bindings)
                bindings["op:root"] = op_id
                out.append((value_id, bindings))
                break
    return out
