"""Programmatic `.rten` model construction.

The analog of the reference's ``src/model_builder.rs`` (used there to
synthesize a model containing every operator for load-path tests) plus the
serialization half of ``rten-convert``: build graphs in Python, serialize
them to the RTen container format.
"""

from __future__ import annotations

import numpy as np

from . import container, schema

# Which attrs-union member each operator uses (None = no attrs). Shared
# attrs follow the schema comments: ArgMin→ArgMaxAttrs, Reduce*→
# ReduceMeanAttrs, InstanceNormalization→BatchNormalizationAttrs,
# GatherElements→GatherAttrs, LogSoftmax→SoftmaxAttrs.
ATTRS_TABLE_FOR_OP: dict[str, str] = {
    "ArgMax": "ArgMaxAttrs", "ArgMin": "ArgMaxAttrs",
    "AveragePool": "AveragePoolAttrs",
    "BatchNormalization": "BatchNormalizationAttrs",
    "InstanceNormalization": "BatchNormalizationAttrs",
    "Cast": "CastAttrs", "Concat": "ConcatAttrs",
    "ConstantOfShape": "ConstantOfShapeAttrs",
    "Conv": "ConvAttrs", "ConvTranspose": "ConvTransposeAttrs",
    "Einsum": "EinsumAttrs", "Elu": "EluAttrs", "Flatten": "FlattenAttrs",
    "Gather": "GatherAttrs", "GatherElements": "GatherAttrs",
    "GatherND": "GatherNDAttrs", "Gelu": "GeluAttrs", "Gemm": "GemmAttrs",
    "GRU": "GRUAttrs", "HardSigmoid": "HardSigmoidAttrs", "If": "IfAttrs",
    "LayerNormalization": "LayerNormalizationAttrs",
    "LeakyRelu": "LeakyReluAttrs", "LSTM": "LSTMAttrs",
    "MaxPool": "MaxPoolAttrs", "Mod": "ModAttrs",
    "NonMaxSuppression": "NonMaxSuppressionAttrs", "OneHot": "OneHotAttrs",
    "RandomNormal": "RandomNormalAttrs",
    "RandomNormalLike": "RandomNormalLikeAttrs",
    "RandomUniform": "RandomUniformAttrs",
    "RandomUniformLike": "RandomUniformLikeAttrs",
    "ReduceMean": "ReduceMeanAttrs", "ReduceL2": "ReduceMeanAttrs",
    "ReduceProd": "ReduceMeanAttrs", "ReduceSum": "ReduceMeanAttrs",
    "ReduceMin": "ReduceMeanAttrs", "ReduceMax": "ReduceMeanAttrs",
    "ReduceSumSquare": "ReduceMeanAttrs",
    "Reshape": "ReshapeAttrs", "Resize": "ResizeAttrs",
    "ScatterElements": "ScatterElementsAttrs", "ScatterND": "ScatterNDAttrs",
    "Softmax": "SoftmaxAttrs", "LogSoftmax": "SoftmaxAttrs",
    "QuantizeLinear": "QuantizeLinearAttrs",
    "DequantizeLinear": "QuantizeLinearAttrs",
    "QLinearConv": "QLinearConvAttrs",
    "ConvInteger": "QLinearConvAttrs",
    "FusedSDPA": "FusedSDPAAttrs", "Pad": "PadAttrs",
    "Split": "SplitAttrs", "TopK": "TopKAttrs",
    "Transpose": "TransposeAttrs", "Trilu": "TriluAttrs",
}


class GraphBuilder:
    """Builds one Graph (the model's root graph or an If-branch subgraph)."""

    def __init__(self, model_builder: "ModelBuilder"):
        self._mb = model_builder
        self.nodes: list[dict] = []
        self.inputs: list[int] = []
        self.outputs: list[int] = []
        self.captures: list[int] = []

    def _add_node(self, name, kind, payload) -> int:
        node_id = len(self.nodes)
        self.nodes.append({"name": name, "data": (kind, payload)})
        return node_id

    def add_value(self, name=None, shape=None) -> int:
        """``shape`` entries may be ints (fixed dims) or strings (symbolic)."""
        dims = None
        if shape is not None:
            dims = []
            for d in shape:
                if isinstance(d, str):
                    dims.append({"value": 0, "name": d})
                else:
                    dims.append({"value": int(d), "name": None})
        return self._add_node(name, "ValueNode", {"shape": dims})

    def add_constant(self, name, array, external=None) -> int:
        array = np.asarray(array)
        if array.dtype in (np.int64, bool):
            array = array.astype(np.int32)
        if array.dtype == np.float64:
            array = array.astype(np.float32)
        if array.dtype == np.float32:
            dtype_code, member = container.DTYPE_FLOAT32, "FloatData"
        elif array.dtype == np.int32:
            dtype_code, member = container.DTYPE_INT32, "IntData"
        elif array.dtype == np.int8:
            dtype_code, member = container.DTYPE_INT8, None
        elif array.dtype == np.uint8:
            dtype_code, member = container.DTYPE_UINT8, None
        else:
            raise ValueError(f"unsupported constant dtype {array.dtype}")
        if member is None:
            external = True  # int8/uint8 have no inline representation
        elif external is None:
            external = array.size >= 16  # small tensors inline, rest external
        payload = {"shape": np.asarray(array.shape, dtype=np.uint32),
                   "dtype": dtype_code}
        if external:
            payload["data_offset"] = self._mb.tensor_data.add(array)
        else:
            payload["data"] = (member, {"data": array.reshape(-1)})
        return self._add_node(name, "ConstantNode", payload)

    def add_operator(self, op_type, inputs, attrs=None, outputs=None,
                     output_shapes=None, name=None,
                     output_names=None) -> int | list[int]:
        """Add an operator plus its output ValueNodes.

        ``inputs``: node ids (None for a missing optional input).
        ``output_names``: explicit names for the output value nodes (the
        names runtime callers look up); defaults derive from ``name``.
        Returns the single output node id, or a list if ``outputs`` > 1.
        """
        if op_type not in schema.OP_TYPE_ID:
            raise ValueError(f"unknown operator type {op_type}")
        n_out = outputs if outputs is not None else 1
        out_ids = []
        for i in range(n_out):
            if output_names is not None:
                out_name = output_names[i]
            elif name is not None and n_out == 1:
                out_name = name
            elif name or n_out > 1:
                out_name = f"{name or op_type}_out{i}"
            else:
                out_name = None
            shape = output_shapes[i] if output_shapes else None
            out_ids.append(self.add_value(out_name, shape))
        attrs_union = None
        if attrs:
            table = ATTRS_TABLE_FOR_OP.get(op_type)
            if table is None:
                raise ValueError(f"{op_type} takes no attributes")
            attrs_union = (table, self._encode_attrs(table, attrs))
        op = {
            "type": schema.OP_TYPE_ID[op_type],
            "attrs": attrs_union,
            "inputs": np.asarray([-1 if i is None else i for i in inputs],
                                 dtype=np.int32),
            "outputs": np.asarray(out_ids, dtype=np.int32),
        }
        self._add_node(name or None, "OperatorNode", op)
        return out_ids[0] if n_out == 1 else out_ids

    def _encode_attrs(self, table, attrs: dict) -> dict:
        valid = {f[0] for f in schema.TABLES[table]}
        unknown = set(attrs) - valid
        if unknown:
            raise ValueError(f"unknown attrs {unknown} for {table}")
        out = dict(attrs)
        # Friendly encodings for union-valued / subgraph attrs.
        if table == "ConstantOfShapeAttrs" and "value" in out:
            v = out["value"]
            if not isinstance(v, tuple):
                if isinstance(v, (int, np.integer)):
                    v = ("IntScalar", {"value": int(v)})
                else:
                    v = ("FloatScalar", {"value": float(v)})
            out["value"] = v
        if table == "IfAttrs":
            for key in ("then_branch", "else_branch"):
                branch = out.get(key)
                if isinstance(branch, GraphBuilder):
                    out[key] = branch.to_dict()
        return out

    def to_dict(self) -> dict:
        return {
            "nodes": self.nodes,
            "inputs": np.asarray(self.inputs, dtype=np.uint32),
            "outputs": np.asarray(self.outputs, dtype=np.uint32),
            "captures": (np.asarray(self.captures, dtype=np.uint32)
                         if self.captures else None),
        }


class ModelBuilder:
    def __init__(self):
        self.tensor_data = container.TensorDataBuilder()
        self.graph = GraphBuilder(self)
        self.metadata: dict | None = None

    def subgraph(self) -> GraphBuilder:
        return GraphBuilder(self)

    def to_model_dict(self) -> dict:
        return {
            "schema_version": 1,
            "graph": self.graph.to_dict(),
            "metadata": self.metadata,
        }

    def to_bytes(self) -> bytes:
        return container.save_bytes(self.to_model_dict(),
                                    self.tensor_data.to_bytes())

    def save(self, path):
        with open(path, "wb") as f:
            f.write(self.to_bytes())
