"""Graph optimizer: load-time passes over the IR.

A copy of ``rten_tpu/ir/optimize.py`` on the port's executor: the same
passes in the same order, so a graph optimizes to the same op sequence in
both packages. Analog of the reference's ``GraphOptimizer``
(``src/optimize.rs:286-297``). The passes:

* constant propagation (evaluate the zero-input computable prefix and
  replace it with Constant nodes) — shrinks graphs and turns shape
  operands static (reference ``src/optimize.rs:301-327``);
* dead-node pruning;
* (for quantized graphs) dequant→matmul fusion happens at lowering time
  in the kernels layer, keyed by pattern matches from
  :mod:`rten_tpu_torch.ir.pattern`.
"""

from __future__ import annotations

import numpy as np

from .graph import ConstantNode, Graph, OperatorNode, ValueNode


def propagate_constants(graph: Graph) -> int:
    """Evaluate every operator whose inputs are all constants and replace
    its outputs with Constant nodes. Returns number of ops folded."""
    from ..runtime.executor import GraphExecutor, to_numpy

    # No inputs: every value it computes derives from constants and stays
    # on the host, so the executor never needs the card.
    executor = GraphExecutor(graph, device="cpu")
    try:
        values = executor.partial_run({}, graph.outputs)
    except Exception:
        return 0
    folded = 0
    for node_id, value in values.items():
        node = graph.nodes[node_id]
        if isinstance(node.data, ConstantNode):
            continue
        arr = to_numpy(value)
        producer = graph.producer_of(node_id)
        graph.nodes[node_id].data = ConstantNode(arr)
        if producer is not None:
            folded += 1
        graph._producer.pop(node_id, None)
    return folded


def prune_dead_nodes(graph: Graph) -> int:
    """Detach operator nodes not needed for the graph outputs. Node ids
    stay stable (nodes become inert), mirroring how the reference's plan
    simply never visits them."""
    try:
        plan = set(graph.plan(graph.inputs, graph.outputs))
    except ValueError:
        return 0
    removed = 0
    for i, node in enumerate(graph.nodes):
        if isinstance(node.data, OperatorNode) and i not in plan:
            for out in node.data.outputs:
                if out is not None and graph._producer.get(out) == i:
                    graph._producer.pop(out, None)
            node.data = ValueNode(None)
            removed += 1
    return removed


def fuse_silu(graph: Graph) -> int:
    """x * sigmoid(x) → Silu (reference ``fuse_silu``,
    src/optimize.rs:381-400)."""
    from .pattern import Op, Symbol, find_matches

    x = Symbol("x")
    pattern = Op("Mul", Op("Sigmoid", x), x, commutative=True)
    fused = 0
    for value_id, bindings in find_matches(graph, pattern):
        root = bindings["op:root"]
        out = graph.add_value(f"silu_{value_id}")
        graph.add_operator(None, "Silu", [bindings["x"]], [out])
        graph.replace_value_uses(value_id, out)
        fused += 1
    return fused


def fuse_dequant_matmul(graph: Graph) -> int:
    """MatMul(DequantizeLinear(a), DequantizeLinear(b)) →
    MatMulInteger + Cast + scale multiply — the dequant-into-matmul
    rewrite from the north star: int8 operands reach the MXU directly and
    only the int32 accumulator is dequantized."""
    from .pattern import Op, Symbol, find_matches

    pattern = Op("MatMul",
                 Op("DequantizeLinear", Symbol("a_q"), Symbol("a_s"),
                    Symbol("a_zp"), bind="dq_a"),
                 Op("DequantizeLinear", Symbol("b_q"), Symbol("b_s"),
                    Symbol("b_zp"), bind="dq_b"))
    short = Op("MatMul",
               Op("DequantizeLinear", Symbol("a_q"), Symbol("a_s"),
                  bind="dq_a"),
               Op("DequantizeLinear", Symbol("b_q"), Symbol("b_s"),
                  bind="dq_b"))
    fused = 0
    fused_roots: set = set()
    matches = find_matches(graph, pattern) or []
    matched_roots = {b["op:root"] for _, b in matches}
    for value_id, b in matches + [
            (v, bb) for v, bb in find_matches(graph, short)
            if bb["op:root"] not in matched_roots]:
        fused_roots.add(b["op:root"])
        # Per-axis dequant on the activation side is rare; both scalar and
        # vector scales broadcast correctly through the Mul below.
        acc = graph.add_value(f"qmm_acc_{value_id}")
        graph.add_operator(None, "MatMulInteger",
                           [b["a_q"], b["b_q"], b.get("a_zp"),
                            b.get("b_zp")], [acc])
        acc_f = graph.add_value(f"qmm_f_{value_id}")
        graph.add_operator(None, "Cast", [acc], [acc_f], {"to": 1})
        scale = graph.add_value(f"qmm_s_{value_id}")
        graph.add_operator(None, "Mul", [b["a_s"], b["b_s"]], [scale])
        out = graph.add_value(f"qmm_out_{value_id}")
        graph.add_operator(None, "Mul", [acc_f, scale], [out])
        graph.replace_value_uses(value_id, out)
        fused += 1

    # Weight-only QDQ (MatMul(x_f32, DQ(w_q, w_s))): insert dynamic
    # activation quantization — the ONNX dynamic-int8 pattern (BERT
    # config): DynQuant(x) → MatMulInteger → rescale.
    wo_pattern = Op("MatMul", Symbol("x"),
                    Op("DequantizeLinear", Symbol("b_q"), Symbol("b_s"),
                       bind="dq_b"))
    for value_id, b in find_matches(graph, wo_pattern):
        from .graph import ConstantNode
        if b["op:root"] in fused_roots:
            continue   # already rewritten by the two-sided pass
        if not isinstance(graph.nodes[b["b_q"]].data, ConstantNode):
            continue
        x_q = graph.add_value(f"wq_xq_{value_id}")
        x_s = graph.add_value(f"wq_xs_{value_id}")
        x_zp = graph.add_value(f"wq_xzp_{value_id}")
        graph.add_operator(None, "DynamicQuantizeLinear", [b["x"]],
                           [x_q, x_s, x_zp])
        acc = graph.add_value(f"wq_acc_{value_id}")
        graph.add_operator(None, "MatMulInteger",
                           [x_q, b["b_q"], x_zp, None], [acc])
        acc_f = graph.add_value(f"wq_f_{value_id}")
        graph.add_operator(None, "Cast", [acc], [acc_f], {"to": 1})
        scale = graph.add_value(f"wq_s_{value_id}")
        graph.add_operator(None, "Mul", [x_s, b["b_s"]], [scale])
        out = graph.add_value(f"wq_out_{value_id}")
        graph.add_operator(None, "Mul", [acc_f, scale], [out])
        graph.replace_value_uses(value_id, out)
        fused += 1
    return fused


def fuse_dequant_conv(graph: Graph) -> int:
    """Conv(x, DQ(w_q, w_s), b?) → rescale(ConvInteger(DynQuant(x), w_q))
    (+ bias): int8 activations × int8 weights on the conv path — measured
    3.5× faster than f32 conv for ResNet-50 on v5e (BASELINE.md), so on
    by default for QDQ graphs; disable via ``optimize(int_conv=False)``."""
    from .pattern import Op, Symbol, find_matches

    pattern = Op("Conv", Symbol("x"),
                 Op("DequantizeLinear", Symbol("w_q"), Symbol("w_s"),
                    bind="dq"))
    fused = 0
    for value_id, b in find_matches(graph, pattern):
        w_node = graph.nodes[b["w_q"]].data
        s_node = graph.nodes[b["w_s"]].data
        if not isinstance(w_node, ConstantNode) or \
                not isinstance(s_node, ConstantNode):
            continue
        conv_id = b["op:root"]
        conv = graph.nodes[conv_id].data
        bias_id = conv.inputs[2] if len(conv.inputs) > 2 else None

        x_q = graph.add_value(f"qc_xq_{value_id}")
        x_s = graph.add_value(f"qc_xs_{value_id}")
        x_zp = graph.add_value(f"qc_xzp_{value_id}")
        graph.add_operator(None, "DynamicQuantizeLinear", [b["x"]],
                           [x_q, x_s, x_zp])
        acc = graph.add_value(f"qc_acc_{value_id}")
        graph.add_operator(None, "ConvInteger",
                           [x_q, b["w_q"], x_zp, None], [acc],
                           dict(conv.attrs))
        acc_f = graph.add_value(f"qc_f_{value_id}")
        graph.add_operator(None, "Cast", [acc], [acc_f], {"to": 1})
        # Per-output-channel scales broadcast over NCHW.
        ws = np.asarray(s_node.array).reshape(1, -1, 1, 1)
        ws_id = graph.add_constant(f"qc_ws_{value_id}", ws)
        scale = graph.add_value(f"qc_s_{value_id}")
        graph.add_operator(None, "Mul", [x_s, ws_id], [scale])
        out = graph.add_value(f"qc_out_{value_id}")
        graph.add_operator(None, "Mul", [acc_f, scale], [out])
        if bias_id is not None:
            bias_arr = graph.nodes[bias_id].data
            if isinstance(bias_arr, ConstantNode):
                b4 = graph.add_constant(
                    f"qc_b_{value_id}",
                    np.asarray(bias_arr.array).reshape(1, -1, 1, 1))
            else:
                b4 = bias_id
            final = graph.add_value(f"qc_ob_{value_id}")
            graph.add_operator(None, "Add", [out, b4], [final])
            out = final
        graph.replace_value_uses(value_id, out)
        fused += 1
    return fused


def _is_causal_mask(arr) -> bool:
    """True for an additive causal mask: zeros on/below the diagonal,
    large negatives strictly above (any broadcast leading dims)."""
    a = np.asarray(arr, np.float32)
    if a.ndim < 2 or a.shape[-1] != a.shape[-2]:
        return False
    a = a.reshape(-1, a.shape[-2], a.shape[-1])
    n = a.shape[-1]
    tril = np.tril(np.ones((n, n), bool))
    return bool(np.all(a[:, tril] == 0.0)
                and (n < 2 or np.all(a[:, ~tril] <= -1e4)))


def fuse_attention(graph: Graph) -> int:
    """MatMul(Softmax(MatMul(q, kᵀ)·scale (+ mask)), v) → FusedSDPA.

    The reference executes attention as the generic op chain its ONNX
    graph spells out (materialized [S, S] scores — SURVEY.md §5); this
    rewrite routes the whole pattern through one op whose lowering uses
    the flash-attention kernel (F1) for prefill-scale maskless shapes and
    the plain op chain otherwise. A constant additive
    causal mask is recognized and becomes ``causal=1`` (mask dropped),
    which keeps the flash path available for decoder-style graphs."""
    from .pattern import Op, Symbol, find_matches

    qk = Op("MatMul", Symbol("q"), Symbol("kt"), bind="qk")
    variants = [
        ("div+mask", Op("MatMul", Op("Softmax", Op(
            "Add", Op("Div", qk, Symbol("c")), Symbol("m"),
            commutative=True), bind="sm"), Symbol("v"))),
        ("mul+mask", Op("MatMul", Op("Softmax", Op(
            "Add", Op("Mul", qk, Symbol("c"), commutative=True),
            Symbol("m"), commutative=True), bind="sm"), Symbol("v"))),
        ("div", Op("MatMul", Op("Softmax", Op("Div", qk, Symbol("c")),
                                bind="sm"), Symbol("v"))),
        ("mul", Op("MatMul", Op("Softmax", Op("Mul", qk, Symbol("c"),
                                              commutative=True),
                                bind="sm"), Symbol("v"))),
        ("mask", Op("MatMul", Op("Softmax", Op(
            "Add", qk, Symbol("m"), commutative=True), bind="sm"),
            Symbol("v"))),
        ("plain", Op("MatMul", Op("Softmax", qk, bind="sm"),
                     Symbol("v"))),
    ]

    def const_scalar(vid):
        node = graph.nodes[vid].data
        if isinstance(node, ConstantNode) and np.asarray(
                node.array).size == 1:
            return float(np.asarray(node.array).reshape(()))
        return None

    fused = 0
    done: set = set()
    for kind, pattern in variants:
        for value_id, b in find_matches(graph, pattern):
            root = b["op:root"]
            if root in done:
                continue
            sm_attrs = graph.nodes[b["op:sm"]].data.attrs or {}
            if sm_attrs.get("axis", -1) not in (-1, 3):
                continue   # softmax not over the key dim
            scale = 1.0
            if "c" in b:
                c = const_scalar(b["c"])
                if c is None or c == 0.0:
                    continue
                scale = 1.0 / c if kind.startswith("div") else c
            mask_id = b.get("m")
            causal = 0
            if mask_id is not None:
                m_node = graph.nodes[mask_id].data
                if isinstance(m_node, ConstantNode) and \
                        _is_causal_mask(m_node.array):
                    causal, mask_id = 1, None
            done.add(root)
            out = graph.add_value(f"sdpa_{value_id}")
            graph.add_operator(None, "FusedSDPA",
                               [b["q"], b["kt"], b["v"], mask_id], [out],
                               {"scale": scale, "causal": causal})
            graph.replace_value_uses(value_id, out)
            fused += 1
    return fused


def optimize(graph: Graph, int_conv: bool = True) -> Graph:
    # Dequant fusion must precede constant propagation: DQ(q_const, s_const)
    # would otherwise fold back into an f32 constant and the MatMulInteger
    # rewrite (and the int8 storage saving) would be lost.
    fuse_dequant_matmul(graph)
    if int_conv:
        fuse_dequant_conv(graph)
    propagate_constants(graph)
    fuse_silu(graph)
    fuse_attention(graph)
    prune_dead_nodes(graph)
    from .quantize_graph import strip_dead_constants
    strip_dead_constants(graph)
    return graph
