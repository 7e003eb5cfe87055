"""Post-training quantization of `.rten` graphs: rewrite f32 weights into
int8 QDQ form (the north-star "MobileNetV3 + DETR with INT8 QDQ" path).

For every MatMul/Gemm whose B operand is a constant (and every Conv
weight), the f32 constant is replaced by an int8 constant + per-channel
scales + a DequantizeLinear node. At load time ``fuse_dequant_matmul``
collapses DQ→MatMul into MatMulInteger, and DQ→Conv into
DynamicQuantizeLinear → ConvInteger → rescale. A copy of
``rten_tpu/ir/quantize_graph.py``; the per-channel quantizer is the port's
``kernels/quant.py::abs_max_quantize_int8`` on CPU tensors, whose bytes
equal the reference's numpy quantizer's.

Usage::

    python -m rten_tpu_torch.ir.quantize_graph model.rten model_int8.rten
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import quant
from .graph import ConstantNode, Graph, OperatorNode


def abs_max_quantize_int8(w, axis=0):
    """The port's quantizer on the host: (q int8, scales f32) as numpy."""
    q, scales = quant.abs_max_quantize_int8(torch.from_numpy(
        np.array(w, dtype=np.float32)), axis=axis)
    return q.numpy(), scales.numpy()


def quantize_graph_weights(graph: Graph, min_elements=1024) -> int:
    """Rewrite constant weights of MatMul/Gemm/Conv to int8 QDQ in place.
    Returns number of weights quantized."""
    count = 0
    for op_id in list(graph.operator_ids()):
        op = graph.nodes[op_id].data
        if not isinstance(op, OperatorNode):
            continue
        if op.op_type in ("MatMul", "Gemm"):
            weight_idx, axis = 1, 1     # [K, N], per-column
            if op.op_type == "Gemm" and op.attrs.get("transpose_b"):
                axis = 0                # [N, K], per-row
        elif op.op_type == "Conv":
            weight_idx, axis = 1, 0     # [O, I, kh, kw], per-output-channel
        else:
            continue
        if weight_idx >= len(op.inputs) or op.inputs[weight_idx] is None:
            continue
        w_id = op.inputs[weight_idx]
        w_node = graph.nodes[w_id].data
        if not isinstance(w_node, ConstantNode):
            continue
        w = np.asarray(w_node.array)
        if w.dtype != np.float32 or w.size < min_elements:
            continue

        if op.op_type == "Conv":
            flat = w.reshape(w.shape[0], -1)            # [O, I*kh*kw]
            q, scales = abs_max_quantize_int8(flat.T, axis=0)
            q = q.T.reshape(w.shape)
            dq_axis = 0
        else:
            reduce_axis = 1 - axis
            q, scales = abs_max_quantize_int8(w, axis=reduce_axis)
            dq_axis = axis

        base = graph.nodes[w_id].name or f"w{w_id}"
        q_id = graph.add_constant(f"{base}.q", q.astype(np.int8))
        s_id = graph.add_constant(f"{base}.scale",
                                  scales.astype(np.float32))
        dq_out = graph.add_value(f"{base}.dq")
        graph.add_operator(None, "DequantizeLinear", [q_id, s_id],
                           [dq_out], {"axis": dq_axis})
        op.inputs[weight_idx] = dq_out
        count += 1
    strip_dead_constants(graph)
    return count


def strip_dead_constants(graph: Graph) -> int:
    """Replace constants no longer referenced by any operator/output with
    inert ValueNodes (ids stay stable; serialization drops the payload)."""
    from .graph import ValueNode

    used: set[int] = set(graph.outputs)
    for op_id in graph.operator_ids():
        op = graph.nodes[op_id].data
        used.update(i for i in op.inputs if i is not None)
    removed = 0
    for node_id, node in enumerate(graph.nodes):
        if isinstance(node.data, ConstantNode) and node_id not in used:
            node.data = ValueNode(None)
            removed += 1
    return removed


def main(argv=None):
    import sys

    from ..fmt import container
    from ..fmt.serialize import save_graph
    from .graph import graph_from_model_file

    args = argv if argv is not None else sys.argv[1:]
    if len(args) < 1:
        print("usage: python -m rten_tpu_torch.ir.quantize_graph model.rten "
              "[model_int8.rten]")
        return 1
    src = args[0]
    dst = args[1] if len(args) > 1 else src.replace(".rten", "_int8.rten")
    mf = container.load_file(src)
    graph = graph_from_model_file(mf)
    n = quantize_graph_weights(graph)
    save_graph(dst, graph,
               metadata={"description": f"int8 QDQ ({n} weights quantized)"})
    print(f"quantized {n} weights -> {dst}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
