"""Dataflow-graph IR.

The in-memory analog of the reference's ``src/graph.rs`` graph: three node
kinds (operator / constant / value), named nodes, graph inputs/outputs, and
capture lists for subgraphs (``If`` branches). Unlike the reference's
interpreter-oriented design, this IR exists to be *lowered*; the port's
runtime walks a topological plan and runs each operator's torch lowering
(see :mod:`rten_tpu_torch.runtime.executor`). A copy of
``rten_tpu/ir/graph.py``.

Plan construction mirrors ``Graph::create_plan`` (reference
``src/graph.rs:1256-1345``): a reverse DFS from the requested outputs over
operator dependencies.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Union

import numpy as np


@dataclass
class ValueNode:
    """A runtime tensor value (graph input or operator output).

    ``shape`` entries are ints for fixed dims, strings for symbolic dims,
    or the whole shape may be None when unknown.
    """
    shape: Optional[list[Union[int, str]]] = None


@dataclass
class ConstantNode:
    array: np.ndarray = None


@dataclass
class OperatorNode:
    op_type: str
    attrs: dict = field(default_factory=dict)
    inputs: list[Optional[int]] = field(default_factory=list)   # None = absent optional
    outputs: list[Optional[int]] = field(default_factory=list)
    subgraphs: dict = field(default_factory=dict)  # e.g. {"then_branch": Graph}


@dataclass
class Node:
    name: Optional[str]
    data: Union[ValueNode, ConstantNode, OperatorNode]


class Graph:
    def __init__(self):
        self.nodes: list[Node] = []
        self.inputs: list[int] = []
        self.outputs: list[int] = []
        self.captures: list[int] = []
        self._name_to_id: dict[str, int] = {}
        # node id -> producing operator node id
        self._producer: dict[int, int] = {}

    # -- construction ------------------------------------------------------

    def _add(self, name, data) -> int:
        node_id = len(self.nodes)
        self.nodes.append(Node(name, data))
        if name is not None and name not in self._name_to_id:
            self._name_to_id[name] = node_id
        return node_id

    def add_value(self, name=None, shape=None) -> int:
        return self._add(name, ValueNode(shape))

    def add_constant(self, name, array) -> int:
        return self._add(name, ConstantNode(np.asarray(array)))

    def add_operator(self, name, op_type, inputs, outputs, attrs=None,
                     subgraphs=None) -> int:
        op = OperatorNode(op_type, attrs or {}, list(inputs), list(outputs),
                          subgraphs or {})
        op_id = self._add(name, op)
        for out in op.outputs:
            if out is not None:
                self._producer[out] = op_id
        return op_id

    # -- queries -----------------------------------------------------------

    def node_id(self, name: str) -> Optional[int]:
        return self._name_to_id.get(name)

    def node(self, node_id: int) -> Node:
        return self.nodes[node_id]

    def producer_of(self, value_id: int) -> Optional[int]:
        return self._producer.get(value_id)

    def operator_ids(self):
        return [i for i, n in enumerate(self.nodes)
                if isinstance(n.data, OperatorNode)]

    def input_names(self):
        return [self.nodes[i].name for i in self.inputs]

    def output_names(self):
        return [self.nodes[i].name for i in self.outputs]

    def num_params(self) -> int:
        return sum(int(n.data.array.size) for n in self.nodes
                   if isinstance(n.data, ConstantNode))

    # -- mutation (optimizer support; the reference's GraphMutator) --------

    def replace_value_uses(self, old_id: int, new_id: int):
        """Point every operator input (and graph output) at ``new_id``
        instead of ``old_id``."""
        for node in self.nodes:
            if isinstance(node.data, OperatorNode):
                node.data.inputs = [new_id if i == old_id else i
                                    for i in node.data.inputs]
        self.outputs = [new_id if o == old_id else o for o in self.outputs]

    # -- planning ----------------------------------------------------------

    def plan(self, input_ids=None, output_ids=None) -> list[int]:
        """Topologically-ordered operator ids needed to compute
        ``output_ids`` from ``input_ids`` (+ constants + captures)."""
        if input_ids is None:
            input_ids = self.inputs
        if output_ids is None:
            output_ids = self.outputs
        available = set(input_ids) | set(self.captures)
        for i, n in enumerate(self.nodes):
            if isinstance(n.data, ConstantNode):
                available.add(i)

        order: list[int] = []
        visiting: set[int] = set()
        done: set[int] = set()

        def visit(value_id):
            if value_id in available or value_id in done:
                return
            op_id = self._producer.get(value_id)
            if op_id is None:
                name = self.nodes[value_id].name
                raise ValueError(
                    f"value {value_id} ({name!r}) is not an input, constant, "
                    f"capture or operator output")
            if op_id in visiting:
                raise ValueError("cycle detected in graph")
            if op_id in done:
                done.add(value_id)
                return
            visiting.add(op_id)
            op = self.nodes[op_id].data
            for dep in op.inputs:
                if dep is not None:
                    visit(dep)
            # Subgraph captures are also dependencies of the If operator.
            for sub in op.subgraphs.values():
                for cap in sub.captures:
                    cap_name = sub.nodes[cap].name
                    outer = self.node_id(cap_name) if cap_name else None
                    if outer is not None:
                        visit(outer)
            visiting.discard(op_id)
            done.add(op_id)
            for out in op.outputs:
                if out is not None:
                    done.add(out)
            order.append(op_id)

        # Iterative wrapper to avoid Python recursion limits on deep graphs.
        import sys
        limit = sys.getrecursionlimit()
        needed = len(self.nodes) + 100
        if needed > limit:
            sys.setrecursionlimit(needed)
        try:
            for out in output_ids:
                visit(out)
        finally:
            if needed > limit:
                sys.setrecursionlimit(limit)
        return order

    def value_refcounts(self, plan_ops, output_ids):
        """How many times each value id is consumed (for donation/liveness
        bookkeeping in eager mode)."""
        counts: dict[int, int] = {}
        for op_id in plan_ops:
            for dep in self.nodes[op_id].data.inputs:
                if dep is not None:
                    counts[dep] = counts.get(dep, 0) + 1
        for out in output_ids:
            counts[out] = counts.get(out, 0) + 1
        return counts


def graph_from_model_file(mf) -> Graph:
    """Build a Graph IR from a parsed `.rten` ModelFile
    (:mod:`rten_tpu_torch.fmt.container`). Recurses into If subgraphs."""
    from ..fmt import schema

    def build(graph_dict) -> Graph:
        g = Graph()
        nodes = graph_dict.get("nodes") or []
        for nd in nodes:
            name = nd.get("name")
            kind, payload = nd["data"]
            if kind == "ValueNode":
                dims = payload.get("shape")
                shape = None
                if dims is not None:
                    shape = [d["name"] if d.get("name") else int(d["value"])
                             for d in dims]
                g.add_value(name, shape)
            elif kind == "ConstantNode":
                g.add_constant(name, mf.constant_array(payload))
            elif kind == "OperatorNode":
                op_type = schema.OP_TYPES[payload["type"]]
                attrs_union = payload.get("attrs")
                attrs = {}
                subgraphs = {}
                if attrs_union is not None:
                    _, attrs = attrs_union
                    attrs = dict(attrs)
                    for key in ("then_branch", "else_branch"):
                        if isinstance(attrs.get(key), dict):
                            subgraphs[key] = build(attrs.pop(key))
                inputs = [None if i < 0 else int(i)
                          for i in (payload.get("inputs")
                                    if payload.get("inputs") is not None else [])]
                outputs = [None if o < 0 else int(o)
                           for o in (payload.get("outputs")
                                     if payload.get("outputs") is not None else [])]
                g.add_operator(name, op_type, inputs, outputs, attrs, subgraphs)
            else:
                raise ValueError(f"unknown node kind {kind}")
        g.inputs = [int(i) for i in (graph_dict.get("inputs")
                                     if graph_dict.get("inputs") is not None else [])]
        g.outputs = [int(o) for o in (graph_dict.get("outputs")
                                      if graph_dict.get("outputs") is not None else [])]
        caps = graph_dict.get("captures")
        g.captures = [int(c) for c in caps] if caps is not None else []
        return g

    return build(mf.model["graph"])
