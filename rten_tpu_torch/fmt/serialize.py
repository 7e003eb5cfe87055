"""Graph IR → `.rten` serialization (inverse of
``ir.graph.graph_from_model_file``): lets optimizer/quantizer passes
rewrite a graph and persist the result."""

from __future__ import annotations

import numpy as np

from ..ir.graph import ConstantNode, Graph, OperatorNode, ValueNode
from . import schema
from .model_builder import ATTRS_TABLE_FOR_OP, ModelBuilder


def graph_to_builder(graph: Graph, mb: ModelBuilder | None = None,
                     builder=None):
    """Append all nodes of ``graph`` into a GraphBuilder, preserving node
    ids (the IR keeps dense ids, so order is identity)."""
    mb = mb or ModelBuilder()
    g = builder if builder is not None else mb.graph
    for node_id, node in enumerate(graph.nodes):
        data = node.data
        if isinstance(data, ValueNode):
            new_id = g.add_value(node.name, data.shape)
        elif isinstance(data, ConstantNode):
            new_id = g.add_constant(node.name, data.array)
        elif isinstance(data, OperatorNode):
            attrs = _encode_attrs(mb, data)
            payload = {
                "type": schema.OP_TYPE_ID[data.op_type],
                "attrs": attrs,
                "inputs": np.asarray(
                    [-1 if i is None else i for i in data.inputs], np.int32),
                "outputs": np.asarray(
                    [-1 if o is None else o for o in data.outputs], np.int32),
            }
            new_id = g._add_node(node.name, "OperatorNode", payload)
        else:
            raise TypeError(type(data))
        assert new_id == node_id
    g.inputs = list(graph.inputs)
    g.outputs = list(graph.outputs)
    g.captures = list(graph.captures)
    return mb


def _encode_attrs(mb: ModelBuilder, op: OperatorNode):
    table = ATTRS_TABLE_FOR_OP.get(op.op_type)
    attrs = {k: v for k, v in op.attrs.items() if v is not None}
    if op.subgraphs:
        attrs = dict(attrs)
        for key, sub in op.subgraphs.items():
            sub_builder = mb.subgraph()
            graph_to_builder(sub, mb, builder=sub_builder)
            attrs[key] = sub_builder.to_dict()
    if not attrs or table is None:
        return None
    # Keep only fields the schema table knows (decoded attrs may carry
    # every field with defaults — that's fine, they round-trip).
    valid = {f[0] for f in schema.TABLES[table]}
    attrs = {k: v for k, v in attrs.items() if k in valid}
    return (table, attrs) if attrs else None


def save_graph(path, graph: Graph, metadata: dict | None = None):
    mb = graph_to_builder(graph)
    mb.metadata = metadata
    mb.save(path)


def graph_to_bytes(graph: Graph, metadata: dict | None = None) -> bytes:
    mb = graph_to_builder(graph)
    mb.metadata = metadata
    return mb.to_bytes()
