"""RTen model schema, declared as data.

This mirrors the reference FlatBuffers schema (``src/schema.fbs`` in the
reference repo) so that ``.rten`` files load unchanged, but instead of
flatc-generated accessor classes the schema is a plain declaration that a
generic reader/writer (:mod:`rten_tpu_torch.fmt.flatbuf`) interprets.

Field slots follow FlatBuffers' assignment rule: fields take consecutive
slots in declaration order, and a union field consumes two slots
(type byte + value offset).
"""

from __future__ import annotations


from . import flatbuf as fb

# --------------------------------------------------------------------------
# Enums (names in declaration order; value == index). Storage is ubyte
# unless listed in ENUM_STORAGE.
# --------------------------------------------------------------------------

ENUMS: dict[str, list[str]] = {
    "OperatorType": [
        "Add", "ArgMin", "ArgMax", "AveragePool", "BatchNormalization",
        "Cast", "Clip", "Concat", "ConstantOfShape", "Conv", "ConvTranspose",
        "Cos", "CumSum", "Div", "Equal", "Erf", "Expand", "Flatten", "Gather",
        "Gemm", "GlobalAveragePool", "Greater", "GRU", "Identity",
        "LeakyRelu", "Less", "LessOrEqual", "Log", "LogSoftmax", "LSTM",
        "MatMul", "MaxPool", "Mod", "Mul", "Pad", "Pow", "Range",
        "ReduceMean", "ReduceL2", "Relu", "Reshape", "Resize", "Shape",
        "Sigmoid", "Sin", "Slice", "Split", "Sqrt", "Squeeze", "Softmax",
        "Sub", "Tanh", "Transpose", "Unsqueeze", "Where",
        # Appended operators (binary compatibility preserved).
        "ReduceProd", "ReduceSum", "ReduceMin", "ReduceMax", "NonZero",
        "ScatterElements", "Tile", "Not", "Abs", "Max", "Mean", "Min", "Sum",
        "OneHot", "Round", "Floor", "Ceil", "Reciprocal", "TopK", "Neg",
        "Exp", "GreaterOrEqual", "Size", "Tan", "Acos", "Asin", "Atan",
        "InstanceNormalization", "HardSigmoid", "HardSwish", "And", "Or",
        "Xor", "Trilu", "ScatterND", "NonMaxSuppression", "Sign",
        "GatherElements", "LayerNormalization", "ReduceSumSquare",
        "RandomUniform", "Elu", "RandomUniformLike", "RandomNormal",
        "RandomNormalLike", "Softplus", "GatherND", "Gelu", "Einsum", "If",
        # rten_tpu extension operators, appended per the schema's own
        # binary-compatibility policy ("New operators ... appended here").
        # These cover the quantized-inference surface (ONNX QDQ/QLinear
        # ops) that the north star adds on top of the reference.
        "QuantizeLinear", "DequantizeLinear", "DynamicQuantizeLinear",
        "MatMulInteger", "QLinearMatMul", "QLinearConv", "Silu",
        "ConvInteger", "FusedSDPA",
    ],
    "RNNDirection": ["Forward", "Reverse", "Bidirectional"],
    "AutoPad": ["Same", "NotSet", "SameLower"],  # SameLower appended (rten_tpu extension: exact ONNX SAME_LOWER, extra pad at the start)
    "DataType": ["Int32", "Float"],
    "CoordTransformMode": ["HalfPixel", "Asymmetric", "AlignCorners"],
    "NearestMode": ["Floor", "Ceil", "RoundPreferFloor", "RoundPreferCeil"],
    "ResizeMode": ["Nearest", "Linear"],
    "NMSBoxOrder": ["TopLeftBottomRight", "CenterWidthHeight"],
    "PadMode": ["Constant", "Reflect", "Edge", "Wrap"],
    "ScatterReduction": ["None", "Add", "Mul", "Min", "Max"],
    # Int8/UInt8 are rten_tpu extensions (appended) for quantized weights.
    "ConstantDataType": ["Int32", "Float32", "Int8", "UInt8"],
}

ENUM_STORAGE = {"ConstantDataType": "u16"}  # everything else is u8

OP_TYPES = ENUMS["OperatorType"]
OP_TYPE_ID = {name: i for i, name in enumerate(OP_TYPES)}

# --------------------------------------------------------------------------
# Unions (member table names in declaration order; wire value is 1-based,
# 0 = NONE).
# --------------------------------------------------------------------------

UNIONS: dict[str, list[str]] = {
    "OperatorAttrs": [
        "ArgMaxAttrs", "AveragePoolAttrs", "BatchNormalizationAttrs",
        "CastAttrs", "ConcatAttrs", "ConstantOfShapeAttrs", "ConvAttrs",
        "ConvTransposeAttrs", "FlattenAttrs", "GatherAttrs", "GemmAttrs",
        "GRUAttrs", "LeakyReluAttrs", "LSTMAttrs", "MaxPoolAttrs",
        "ReduceMeanAttrs", "ReshapeAttrs", "ResizeAttrs", "SplitAttrs",
        "SoftmaxAttrs", "TransposeAttrs",
        # Appended attrs.
        "ModAttrs", "ScatterElementsAttrs", "OneHotAttrs", "TopKAttrs",
        "HardSigmoidAttrs", "TriluAttrs", "ScatterNDAttrs",
        "NonMaxSuppressionAttrs", "LayerNormalizationAttrs",
        "RandomUniformAttrs", "EluAttrs", "RandomUniformLikeAttrs",
        "RandomNormalAttrs", "RandomNormalLikeAttrs", "GatherNDAttrs",
        "GeluAttrs", "EinsumAttrs", "IfAttrs",
        # rten_tpu extension attrs (appended).
        "QuantizeLinearAttrs", "QLinearConvAttrs", "FusedSDPAAttrs",
        "PadAttrs",
    ],
    "Scalar": ["IntScalar", "FloatScalar"],
    "NodeKind": ["OperatorNode", "ConstantNode", "ValueNode"],
    "ConstantData": ["FloatData", "IntData"],
}

# --------------------------------------------------------------------------
# Tables: name -> [(field_name, type, default)].
# Types: scalar kinds from flatbuf, "enum:<E>", "str", "[<scalar>]",
# "table:<T>", "[table:<T>]", "union:<U>". default None means "optional
# scalar" (null default in the schema) for scalars, or simply absent.
# --------------------------------------------------------------------------

TABLES: dict[str, list[tuple[str, str, object]]] = {
    "ArgMaxAttrs": [("axis", "i32", 0), ("keep_dims", "bool", False)],
    "AveragePoolAttrs": [
        ("kernel_size", "[u32]", None), ("auto_pad", "enum:AutoPad", 0),
        ("pads", "[u32]", None), ("strides", "[u32]", None),
        ("count_include_pad", "bool", False),
    ],
    "BatchNormalizationAttrs": [("epsilon", "f32", 0.0)],
    "CastAttrs": [("to", "enum:DataType", 0)],
    "ConcatAttrs": [("axis", "i32", 0)],
    "IntScalar": [("value", "i32", 0)],
    "FloatScalar": [("value", "f32", 0.0)],
    "ConstantOfShapeAttrs": [("value", "union:Scalar", None)],
    "ConvAttrs": [
        ("auto_pad", "enum:AutoPad", 0), ("pads", "[u32]", None),
        ("groups", "u32", 0), ("strides", "[u32]", None),
        ("dilations", "[u32]", None),
    ],
    "ConvTransposeAttrs": [
        ("strides", "[u32]", None), ("auto_pad", "enum:AutoPad", 1),
        ("pads", "[u32]", None),
        # Appended (rten_tpu extensions; absent in old files -> defaults).
        ("groups", "u32", 0), ("dilations", "[u32]", None),
        ("output_padding", "[u32]", None),
    ],
    "EinsumAttrs": [("equation", "str", None)],
    "EluAttrs": [("alpha", "f32", 0.0)],
    "FlattenAttrs": [("axis", "i32", 0)],
    "LayerNormalizationAttrs": [("axis", "i32", 0), ("epsilon", "f32", 0.0)],
    "GatherAttrs": [("axis", "i32", 0)],
    "GatherNDAttrs": [("batch_dims", "i32", 0)],
    "GeluAttrs": [],
    "GemmAttrs": [
        ("alpha", "f32", 0.0), ("beta", "f32", 0.0),
        ("transpose_a", "bool", False), ("transpose_b", "bool", False),
    ],
    "GRUAttrs": [
        ("direction", "enum:RNNDirection", 0), ("hidden_size", "u32", 0),
        ("linear_before_reset", "bool", False),
    ],
    "HardSigmoidAttrs": [("alpha", "f32", 0.0), ("beta", "f32", 0.0)],
    "IfAttrs": [
        ("then_branch", "table:Graph", None), ("else_branch", "table:Graph", None),
    ],
    "LeakyReluAttrs": [("alpha", "f32", 0.0)],
    "LSTMAttrs": [
        ("direction", "enum:RNNDirection", 0), ("hidden_size", "u32", 0),
    ],
    "MaxPoolAttrs": [
        ("kernel_size", "[u32]", None), ("auto_pad", "enum:AutoPad", 0),
        ("pads", "[u32]", None), ("strides", "[u32]", None),
    ],
    "ModAttrs": [("fmod", "bool", False)],
    "NonMaxSuppressionAttrs": [("box_order", "enum:NMSBoxOrder", 0)],
    "OneHotAttrs": [("axis", "i32", 0)],
    "RandomNormalAttrs": [
        ("mean", "f32", 0.0), ("scale", "f32", 0.0), ("seed", "f32", None),
        ("shape", "[u32]", None),
    ],
    "RandomNormalLikeAttrs": [
        ("mean", "f32", 0.0), ("scale", "f32", 0.0), ("seed", "f32", None),
    ],
    "RandomUniformAttrs": [
        ("shape", "[u32]", None), ("high", "f32", 0.0), ("low", "f32", 0.0),
        ("seed", "f32", None),
    ],
    "RandomUniformLikeAttrs": [
        ("high", "f32", 0.0), ("low", "f32", 0.0), ("seed", "f32", None),
    ],
    "ReduceMeanAttrs": [("axes", "[i32]", None), ("keep_dims", "bool", False)],
    "ReshapeAttrs": [("allow_zero", "bool", False)],
    "ResizeAttrs": [
        ("mode", "enum:ResizeMode", 0),
        ("coord_mode", "enum:CoordTransformMode", 0),
        ("nearest_mode", "enum:NearestMode", 0),
    ],
    "ScatterElementsAttrs": [
        ("axis", "i32", 0), ("reduction", "enum:ScatterReduction", 0),
    ],
    "ScatterNDAttrs": [("reduction", "enum:ScatterReduction", 0)],
    "SoftmaxAttrs": [("axis", "i32", 0)],
    "SplitAttrs": [("axis", "i32", 0)],
    "TopKAttrs": [
        ("axis", "i32", 0), ("largest", "bool", False), ("sorted", "bool", False),
    ],
    "TransposeAttrs": [("perm", "[u32]", None)],
    "TriluAttrs": [("upper", "bool", False)],
    # rten_tpu extension attrs.
    "QuantizeLinearAttrs": [("axis", "i32", 1)],   # also for DequantizeLinear
    # Fused scaled-dot-product attention (optimizer rewrite,
    # ir/optimize.py::fuse_attention).
    "FusedSDPAAttrs": [("scale", "f32", 1.0), ("causal", "i32", 0)],
    "PadAttrs": [("mode", "enum:PadMode", 0)],
    "QLinearConvAttrs": [
        ("auto_pad", "enum:AutoPad", 0), ("pads", "[u32]", None),
        ("groups", "u32", 0), ("strides", "[u32]", None),
        ("dilations", "[u32]", None),
    ],
    "OperatorNode": [
        ("type", "enum:OperatorType", 0), ("attrs", "union:OperatorAttrs", None),
        ("inputs", "[i32]", None), ("outputs", "[i32]", None),
    ],
    "FloatData": [("data", "[f32]", None)],
    "IntData": [("data", "[i32]", None)],
    "ConstantNode": [
        ("shape", "[u32]", None), ("data", "union:ConstantData", None),
        ("dtype", "enum:ConstantDataType", None), ("data_offset", "u64", None),
    ],
    "Dim": [("value", "u32", 0), ("name", "str", None)],
    "ValueNode": [("shape", "[table:Dim]", None)],
    "Node": [("name", "str", None), ("data", "union:NodeKind", None)],
    "Graph": [
        ("nodes", "[table:Node]", None), ("inputs", "[u32]", None),
        ("outputs", "[u32]", None), ("captures", "[u32]", None),
    ],
    "Metadata": [
        ("onnx_hash", "str", None), ("description", "str", None),
        ("license", "str", None), ("commit", "str", None),
        ("code_repository", "str", None), ("model_repository", "str", None),
        ("run_id", "str", None), ("run_url", "str", None),
    ],
    "Model": [
        ("schema_version", "i32", 0), ("graph", "table:Graph", None),
        ("metadata", "table:Metadata", None),
    ],
}

FILE_IDENTIFIER = b"RTEN"


def _slots(table_name):
    """(field_name, type, default, slot) for each field; unions use two
    consecutive slots."""
    out = []
    slot = 0
    for name, ftype, default in TABLES[table_name]:
        out.append((name, ftype, default, slot))
        slot += 2 if ftype.startswith("union:") else 1
    return out


_SLOT_CACHE = {name: _slots(name) for name in TABLES}


# --------------------------------------------------------------------------
# Reading
# --------------------------------------------------------------------------

def read_table(buf, pos, table_name) -> dict:
    """Decode the table at ``pos`` into a plain dict. Scalar vectors come
    back as zero-copy numpy arrays; unions as ``(member_name, value_dict)``
    tuples; enums as ints."""
    out = {}
    for name, ftype, default, slot in _SLOT_CACHE[table_name]:
        if ftype.startswith("union:"):
            members = UNIONS[ftype[6:]]
            type_val = fb.table_scalar(buf, pos, slot, "u8", 0)
            if type_val == 0:
                out[name] = None
                continue
            fpos = fb.field_pos(buf, pos, slot + 1)
            member = members[type_val - 1]
            out[name] = (member, read_table(buf, fb.indirect(buf, fpos), member))
        elif ftype.startswith("enum:"):
            kind = ENUM_STORAGE.get(ftype[5:], "u8")
            out[name] = fb.table_scalar(buf, pos, slot, kind, default)
        elif ftype == "str":
            out[name] = fb.table_string(buf, pos, slot, default)
        elif ftype.startswith("[table:"):
            member = ftype[7:-1]
            vpos = fb.table_vector_pos(buf, pos, slot)
            if vpos is None:
                out[name] = None
            else:
                out[name] = [read_table(buf, p, member)
                             for p in fb.offset_vector(buf, vpos)]
        elif ftype.startswith("["):
            vpos = fb.table_vector_pos(buf, pos, slot)
            out[name] = None if vpos is None else fb.scalar_vector(buf, vpos, ftype[1:-1])
        elif ftype.startswith("table:"):
            fpos = fb.field_pos(buf, pos, slot)
            if fpos is None:
                out[name] = None
            else:
                out[name] = read_table(buf, fb.indirect(buf, fpos), ftype[6:])
        else:  # scalar
            out[name] = fb.table_scalar(buf, pos, slot, ftype, default)
    return out


def read_model(buf, base=0) -> dict:
    """Decode a Model root from a FlatBuffers region starting at ``base``."""
    ident = bytes(buf[base + 4:base + 8])
    if ident != FILE_IDENTIFIER:
        raise ValueError(f"bad file identifier {ident!r}; expected b'RTEN'")
    return read_table(buf, fb.root_table(buf, base), "Model")


# --------------------------------------------------------------------------
# Writing
# --------------------------------------------------------------------------

def write_table(builder: fb.Builder, table_name, values: dict) -> int:
    """Serialize ``values`` (same shape as :func:`read_table` output) as
    ``table_name``; returns the builder offset."""
    # Pass 1: build all child objects (offsets must exist before the table
    # itself is opened).
    offsets = {}
    for name, ftype, default, slot in _SLOT_CACHE[table_name]:
        val = values.get(name)
        if val is None:
            continue
        if ftype.startswith("union:"):
            member, member_vals = val
            offsets[name] = write_table(builder, member, member_vals)
        elif ftype == "str":
            offsets[name] = builder.string(val)
        elif ftype.startswith("[table:"):
            member = ftype[7:-1]
            child = [write_table(builder, member, v) for v in val]
            offsets[name] = builder.offset_vector(child)
        elif ftype.startswith("["):
            offsets[name] = builder.scalar_vector(ftype[1:-1], val)
        elif ftype.startswith("table:"):
            offsets[name] = write_table(builder, ftype[6:], val)
    # Pass 2: the table itself.
    builder.start_table()
    for name, ftype, default, slot in _SLOT_CACHE[table_name]:
        val = values.get(name)
        if ftype.startswith("union:"):
            if val is not None:
                member, _ = val
                type_val = 1 + UNIONS[ftype[6:]].index(member)
                builder.add_scalar(slot, "u8", type_val, 0)
                builder.add_offset(slot + 1, offsets[name])
        elif ftype.startswith("enum:"):
            kind = ENUM_STORAGE.get(ftype[5:], "u8")
            builder.add_scalar(slot, kind, val, default)
        elif name in offsets:
            builder.add_offset(slot, offsets[name])
        elif not (ftype == "str" or ftype.startswith("[") or ftype.startswith("table:")):
            builder.add_scalar(slot, ftype, val, default)
    return builder.end_table()


def write_model(model: dict) -> bytes:
    builder = fb.Builder()
    root = write_table(builder, "Model", model)
    return builder.finish(root, FILE_IDENTIFIER)
