"""The port's graph runtime (``rten_tpu_torch.runtime``) on the CPU: the
reference's plan, partial-run, constant-folding and pruning cases
(tests/test_runtime.py) on the port's executor; the load-time optimizer's
INT8 rewrite against the reference's op sequence; ResNet (18 layers, 10
classes, 32 px, batch 2) through ``Model.run`` against ``rten_tpu.Model``
in f32 (rtol = atol = 1e-3, tests/test_models.py's tolerance) and INT8
(logits within 1e-2 of max |logit|, the same top-1 except where the
reference's top-2 margin is below that); the native forward; and the CLI
with ``--device cpu``."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rten_tpu import Model as JModel
from rten_tpu.fmt import container as jcontainer
from rten_tpu.fmt.serialize import graph_to_bytes as j_graph_to_bytes
from rten_tpu.ir.graph import graph_from_model_file as j_graph_from_file
from rten_tpu.ir.quantize_graph import quantize_graph_weights as j_quantize
from rten_tpu.models.resnet import ResNet as JResNet
from rten_tpu.models.resnet import ResNetConfig as JResNetConfig
from rten_tpu_torch.fmt.model_builder import ModelBuilder
from rten_tpu_torch.ir import optimize as opt
from rten_tpu_torch.ir.graph import ConstantNode, Graph
from rten_tpu_torch.models import (ResNet, ResNetConfig,
                                   resnet_params_from_numpy)
from rten_tpu_torch.ops.registry import OpError
from rten_tpu_torch.runtime import Model, RunOptions, RunTiming
from rten_tpu_torch.runtime.executor import GraphExecutor, is_static
from rten_tpu_torch.runtime.model import RunError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL = 1e-3           # tests/test_models.py:36
INT8_REL_TOL = 1e-2      # of max |logit|
CFG = dict(depth=18, n_classes=10)
BATCH, PX = 2, 32


def randf(*shape):
    return np.random.RandomState(7).randn(*shape).astype(np.float32)


def run(ex, inputs, **kw):
    return [o.numpy() for o in ex.run(inputs, **kw)]


def _mlp_graph():
    g = Graph()
    x = g.add_value("x")
    w1 = g.add_constant("w1", randf(4, 8))
    w2 = g.add_constant("w2", randf(8, 2))
    h = g.add_value("h")
    hr = g.add_value("hr")
    out = g.add_value("out")
    g.add_operator("mm1", "MatMul", [x, w1], [h])
    g.add_operator("relu", "Relu", [h], [hr])
    g.add_operator("mm2", "MatMul", [hr, w2], [out])
    g.inputs, g.outputs = [x], [out]
    return g


# -- the reference's executor cases -------------------------------------------

def test_plan_topological_order():
    g = _mlp_graph()
    assert [g.nodes[i].name for i in g.plan()] == ["mm1", "relu", "mm2"]


def test_plan_partial_outputs():
    g = _mlp_graph()
    plan = g.plan(output_ids=[g.node_id("hr")])
    assert [g.nodes[i].name for i in plan] == ["mm1", "relu"]


def test_plan_missing_input_errors():
    g = _mlp_graph()
    with pytest.raises(ValueError, match="not an input"):
        g.plan(input_ids=[], output_ids=g.outputs)


def test_run_matches_numpy():
    g = _mlp_graph()
    x = randf(3, 4)
    (out,) = run(GraphExecutor(g, "cpu"), {g.node_id("x"): x})
    w1, w2 = (g.nodes[g.node_id(n)].data.array for n in ("w1", "w2"))
    np.testing.assert_allclose(out, np.maximum(x @ w1, 0) @ w2, rtol=1e-5,
                               atol=1e-5)


def test_static_shape_chain_stays_on_the_host():
    """Shape → Slice → Concat → Reshape: every value of the chain stays a
    numpy array (no device value, so no wait for the card), and the
    reshape of the device input takes it."""
    g = Graph()
    x = g.add_value("x")
    shp, dim0, tgt, out = (g.add_value(n) for n in ("shp", "dim0", "tgt",
                                                      "out"))
    starts = g.add_constant("starts", np.array([0], np.int32))
    ends = g.add_constant("ends", np.array([1], np.int32))
    rest = g.add_constant("rest", np.array([-1], np.int32))
    g.add_operator("shape", "Shape", [x], [shp])
    g.add_operator("slice", "Slice", [shp, starts, ends], [dim0])
    g.add_operator("concat", "Concat", [dim0, rest], [tgt], {"axis": 0})
    g.add_operator("reshape", "Reshape", [x, tgt], [out])
    g.inputs, g.outputs = [x], [out]
    ex = GraphExecutor(g, "cpu")
    env = ex._env({x: torch.from_numpy(randf(3, 4, 5))})
    ex._eval_plan(g, env, g.plan())
    assert all(is_static(env[v]) for v in (shp, dim0, tgt))
    assert tuple(env[out].shape) == (3, 20)


def test_data_dependent_op_runs_on_the_host():
    g = Graph()
    x = g.add_value("x")
    nz = g.add_value("nz")
    out = g.add_value("out")
    g.add_operator("nonzero", "NonZero", [x], [nz])
    g.add_operator("cast", "Cast", [nz], [out], {"to": 1})
    g.inputs, g.outputs = [x], [out]
    (out_v,) = run(GraphExecutor(g, "cpu"),
                   {x: np.array([[1, 0], [0, 2]], np.float32)})
    np.testing.assert_array_equal(out_v, [[0, 1], [0, 1]])


def test_partial_run_constant_prefix():
    """partial_run with a subset of inputs computes the loop-invariant
    prefix (the generator's constant-input caching pattern)."""
    g = Graph()
    a = g.add_value("a")
    b = g.add_value("b")
    w = g.add_constant("w", randf(4, 4))
    a_proj = g.add_value("a_proj")
    summed = g.add_value("summed")
    g.add_operator("proj", "MatMul", [a, w], [a_proj])
    g.add_operator("add", "Add", [a_proj, b], [summed])
    g.inputs, g.outputs = [a, b], [summed]
    a_in = randf(2, 4)
    frontier = GraphExecutor(g, "cpu").partial_run({a: a_in})
    assert set(frontier) == {g.node_id("a_proj")}
    np.testing.assert_allclose(np.asarray(frontier[g.node_id("a_proj")]),
                               a_in @ np.asarray(g.nodes[w].data.array),
                               rtol=1e-5, atol=1e-5)


def test_optimizer_constant_propagation():
    g = Graph()
    x = g.add_value("x")
    c1 = g.add_constant("c1", np.float32([1, 2, 3]))
    c2 = g.add_constant("c2", np.float32([10, 20, 30]))
    csum = g.add_value("csum")
    out = g.add_value("out")
    g.add_operator("addc", "Add", [c1, c2], [csum])
    g.add_operator("addx", "Add", [x, csum], [out])
    g.inputs, g.outputs = [x], [out]
    assert opt.propagate_constants(g) == 1
    assert isinstance(g.nodes[csum].data, ConstantNode)
    np.testing.assert_allclose(g.nodes[csum].data.array, [11, 22, 33])
    (out_v,) = run(GraphExecutor(g, "cpu"), {x: np.float32([1, 1, 1])})
    np.testing.assert_allclose(out_v, [12, 23, 34])


def test_constant_propagation_runs_lowerings_on_the_host():
    """An all-constant op outside the numpy table (a Conv) folds through
    its torch lowering on CPU tensors into a numpy constant."""
    g = Graph()
    x = g.add_value("x")
    c = g.add_constant("c", randf(1, 2, 4, 4))
    w = g.add_constant("w", randf(3, 2, 3, 3))
    folded, out = g.add_value("folded"), g.add_value("out")
    g.add_operator("conv", "Conv", [c, w], [folded])
    g.add_operator("add", "Add", [x, folded], [out])
    g.inputs, g.outputs = [x], [out]
    assert opt.propagate_constants(g) == 1
    arr = g.nodes[folded].data.array
    assert isinstance(arr, np.ndarray) and arr.shape == (1, 3, 2, 2)


def test_prune_dead_nodes():
    g = _mlp_graph()
    dead_out = g.add_value("dead_out")
    g.add_operator("dead", "Relu", [g.node_id("x")], [dead_out])
    assert opt.prune_dead_nodes(g) == 1
    (out,) = run(GraphExecutor(g, "cpu"), {g.node_id("x"): randf(2, 4)})
    assert out.shape == (2, 2)


def test_run_timing_table(capsys):
    g = _mlp_graph()
    ex = GraphExecutor(g, "cpu")
    ex.run({g.node_id("x"): randf(3, 4)}, options=RunOptions(timing=True))
    out = capsys.readouterr().out
    assert "MatMul" in out and "TOTAL" in out
    timing = ex.last_timing
    assert isinstance(timing, RunTiming) and len(timing.records) == 3
    assert 0 < timing.op_seconds() <= timing.total


def _relu_model_bytes():
    mb = ModelBuilder()
    g = mb.graph
    x = g.add_value("x")
    out = g.add_operator("Relu", [x], name="relu")
    g.inputs, g.outputs = [x], [out]
    return mb.to_bytes()


def test_env_timing_flag(monkeypatch, capsys):
    model = Model.load(_relu_model_bytes(), device="cpu")
    monkeypatch.setenv("RTEN_TPU_TIMING", "sort=name")
    model.run({"x": np.float32([[1, -1]])})
    assert "Relu" in capsys.readouterr().out


def test_missing_input_error_message():
    mb = ModelBuilder()
    g = mb.graph
    a = g.add_value("a")
    b = g.add_value("b")
    out = g.add_operator("Add", [a, b], name="sum")
    g.inputs, g.outputs = [a, b], [out]
    model = Model.load(mb.to_bytes(), device="cpu")
    with pytest.raises(RunError, match="missing model inputs.*'b'"):
        model.run({"a": np.float32([1.0])})
    with pytest.raises(KeyError, match="no node named"):
        model.run({"a": np.float32([1.0]), "nope": np.float32([2.0])})


def test_numpy_eval_matches_torch_lowerings():
    """Every op of the host-folding table agrees with the port's torch
    lowering of it, dtype included."""
    from rten_tpu_torch.ops.numpy_eval import NUMPY_EVAL, try_numpy_eval
    from rten_tpu_torch.ops.registry import ensure_registered, get_op
    from rten_tpu_torch.runtime.executor import _Ctx

    ensure_registered()
    rng = np.random.RandomState(0)
    f = rng.randn(3, 4).astype(np.float32)
    cases = {
        "DequantizeLinear": ([rng.randint(-127, 128, (3, 4)).astype(np.int8),
                              np.float32(0.05), np.int8(3)], {"axis": 1}),
        "QuantizeLinear": ([f, np.float32(0.1), np.int8(0)], {"axis": 1}),
        "Cast": ([f * 7], {"to": 0}),
        "Transpose": ([f], {"perm": [1, 0]}),
        "Concat": ([f, f], {"axis": 1}),
        "Unsqueeze": ([f, np.asarray([0], np.int32)], {}),
        "Squeeze": ([f[None], np.asarray([0], np.int32)], {}),
        "Identity": ([f], {}),
        "Add": ([f, f], {}),
        "Sub": ([f, f * 2], {}),
        "Mul": ([f, f], {}),
        "Neg": ([f], {}),
        "Sqrt": ([np.abs(f)], {}),
        "Reciprocal": ([f + 3], {}),
        "Relu": ([f], {}),
    }
    # Gather's lowering is not ported (ROADMAP Queue 1); its host folding
    # is, and folds like the reference's.
    assert set(NUMPY_EVAL) - set(cases) == {"Gather"}
    for op_type, (args, attrs) in cases.items():
        handled, np_out = try_numpy_eval(op_type, attrs, args)
        assert handled, op_type
        spec = get_op(op_type)
        out = spec.fn(_Ctx(1), attrs, *[
            np.asarray(a) if i in spec.static else torch.from_numpy(
                np.array(a)) for i, a in enumerate(args)]).numpy()
        np.testing.assert_allclose(np.asarray(np_out), out, rtol=1e-6,
                                   atol=1e-6, err_msg=op_type)
        assert np.asarray(np_out).dtype == out.dtype, op_type


def test_constants_move_once():
    """A weight constant read by a device op is moved to the device once
    and reused across runs."""
    mb = ModelBuilder()
    g = mb.graph
    x = g.add_value("x", shape=[2, 16])
    w = g.add_constant("w", randf(16, 16))
    out = g.add_operator("MatMul", [x, w])
    g.inputs, g.outputs = [x], [out]
    model = Model.load(mb.to_bytes(), device="cpu")
    xin = randf(2, 16)
    a = model.run_one(xin)
    cache = model.executor._const_device
    assert cache
    first = {k: id(v) for k, v in cache.items()}
    b = model.run_one(xin)
    assert torch.equal(a, b)
    assert first == {k: id(v) for k, v in cache.items()}


def test_unported_op_raises_naming_roadmap():
    g = Graph()
    x = g.add_value("x")
    idx = g.add_constant("idx", np.array([1, 0], np.int32))
    out = g.add_value("out")
    g.add_operator("gather", "Gather", [x, idx], [out], {"axis": 0})
    g.inputs, g.outputs = [x], [out]
    with pytest.raises(OpError, match="ROADMAP.md Queue 1.*ops/gather.py"):
        GraphExecutor(g, "cpu").run({x: randf(2, 3)})


# -- ResNet: the slice's path --------------------------------------------------

def _quantized(data, container, from_file, quantize, to_bytes):
    graph = from_file(container.load_bytes(data))
    quantize(graph)
    return to_bytes(graph)


@pytest.fixture(scope="module")
def resnet():
    """ResNet-18 (10 classes) at 32 px: numpy weights, the reference's f32
    and INT8 `.rten` bytes (bench_vision's build), both packages' models
    and an input batch."""
    net = JResNet(JResNetConfig(**CFG))
    params = net.init_params(None)
    f32 = net.build_rten(params, input_shape=(BATCH, 3, PX, PX)).to_bytes()
    int8 = _quantized(f32, jcontainer, j_graph_from_file, j_quantize,
                      j_graph_to_bytes)
    x = np.random.RandomState(3).rand(BATCH, 3, PX, PX).astype(np.float32)
    out = {"params": params, "x": x}
    for name, data in (("f32", f32), ("int8", int8)):
        ref = JModel.load(data)
        port = Model.load(data, device="cpu")
        out[name] = dict(bytes=data, ref=ref, port=port,
                         ref_out=np.asarray(ref.run_one(x)),
                         port_out=port.run_one(x).numpy())
    return out


def _op_types(model):
    return [model.graph.nodes[i].data.op_type for i in model.graph.plan()]


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_optimized_graph_has_the_reference_op_sequence(resnet, kind):
    got, ref = resnet[kind]["port"], resnet[kind]["ref"]
    assert _op_types(got) == _op_types(ref)
    if kind == "int8":
        # Every Conv became DynamicQuantizeLinear → ConvInteger → Cast →
        # Mul (ir/optimize.py:156-208).
        ops = _op_types(got)
        assert "Conv" not in ops and ops.count("ConvInteger") == 20
        assert ops.count("DynamicQuantizeLinear") == 20


def test_resnet_f32_matches_reference(resnet):
    r = resnet["f32"]
    np.testing.assert_allclose(r["port_out"], r["ref_out"], rtol=F32_TOL,
                               atol=F32_TOL)


def test_resnet_int8_matches_reference(resnet):
    r = resnet["int8"]
    ref, got = r["ref_out"], r["port_out"]
    assert np.abs(got - ref).max() <= INT8_REL_TOL * np.abs(ref).max()
    top2 = np.sort(ref, axis=1)[:, -2:]
    margin = top2[:, 1] - top2[:, 0]
    same = got.argmax(1) == ref.argmax(1)
    assert np.all(same | (margin < INT8_REL_TOL * np.abs(ref).max()))


def test_resnet_conv_integer_accumulators_bit_exact(resnet):
    """The int32 accumulators of the first three ConvInteger nodes, read as
    outputs of both packages' INT8 models."""
    port, ref = resnet["int8"]["port"], resnet["int8"]["ref"]
    ids = [op.outputs[0] for op in (port.graph.nodes[i].data
                                    for i in port.graph.plan())
           if op.op_type == "ConvInteger"][:3]
    x = resnet["x"]
    got = port.run({port.input_ids()[0]: x}, outputs=ids)
    want = ref.run({ref.input_ids()[0]: x}, outputs=ids)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_resnet_native_forward_matches_graph(resnet):
    net = ResNet(ResNetConfig(**CFG))
    params = resnet_params_from_numpy(resnet["params"], device="cpu")
    out = net.forward(params, torch.from_numpy(resnet["x"])).numpy()
    np.testing.assert_allclose(out, resnet["f32"]["ref_out"], rtol=F32_TOL,
                               atol=F32_TOL)


def test_fused_sdpa_graph_runs_flash_attention(monkeypatch):
    """MatMul → Mul → Softmax → MatMul at S 256, D 128 fuses to FusedSDPA,
    which takes F1's wrapper (its plain version on the CPU)."""
    from rten_tpu_torch.kernels import attention as at
    data = sdpa_model_bytes(1, 2, 256, 128)
    model = Model.load(data, device="cpu")
    assert _op_types(model) == ["FusedSDPA"]
    rng = np.random.RandomState(5)
    q, k, v = (rng.randn(1, 2, 256, 128).astype(np.float32)
               for _ in range(3))
    calls = []
    real = at.flash_attention_plain

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(at, "flash_attention_plain", spy)
    out = model.run({"q": q, "kt": k.transpose(0, 1, 3, 2).copy(),
                     "v": v})[0].numpy()
    assert calls == [(1, 2, 256, 128)]
    s = q @ k.transpose(0, 1, 3, 2) / np.sqrt(128)
    p = np.exp(s - s.max(-1, keepdims=True))
    want = (p / p.sum(-1, keepdims=True)) @ v
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-4)


def sdpa_model_bytes(b, h, s, d):
    """softmax(q @ kt * d^-0.5) @ v as a `.rten` graph."""
    mb = ModelBuilder()
    g = mb.graph
    q = g.add_value("q", shape=[b, h, s, d])
    kt = g.add_value("kt", shape=[b, h, d, s])
    v = g.add_value("v", shape=[b, h, s, d])
    c = g.add_constant("scale", np.float32(1.0 / np.sqrt(d)))
    qk = g.add_operator("MatMul", [q, kt], name="qk")
    scaled = g.add_operator("Mul", [qk, c], name="scaled")
    probs = g.add_operator("Softmax", [scaled], attrs={"axis": -1},
                           name="probs")
    out = g.add_operator("MatMul", [probs, v], name="out")
    g.inputs, g.outputs = [q, kt, v], [out]
    return mb.to_bytes()


# -- the CLI -------------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_model(tmp_path_factory):
    mb = ModelBuilder()
    g = mb.graph
    x = g.add_value("input", shape=["batch", 8])
    w = g.add_constant("w", np.random.RandomState(0)
                       .randn(8, 4).astype(np.float32))
    y = g.add_operator("MatMul", [x, w], name="mm")
    out = g.add_operator("Softmax", [y], attrs={"axis": -1}, name="sm")
    g.inputs, g.outputs = [x], [out]
    path = tmp_path_factory.mktemp("cli") / "model.rten"
    mb.save(path)
    return str(path)


def _run_cli(*args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "-m", "rten_tpu_torch.cli", *args],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)


def test_cli_runs_on_the_cpu(cli_model):
    proc = _run_cli(cli_model, "--device", "cpu", "--size", "batch=3",
                    "-n", "2", "--timing")
    assert proc.returncode == 0, proc.stderr
    assert "on cpu" in proc.stdout and "Parameters: 32" in proc.stdout
    assert "shape [3, 4]" in proc.stdout
    assert "Run time over 2 iters" in proc.stdout
    assert "MatMul" in proc.stdout and "TOTAL" in proc.stdout


def test_cli_inspect(cli_model):
    proc = _run_cli(cli_model, "--device", "cpu", "--inspect")
    assert proc.returncode == 0, proc.stderr
    assert "MatMul" in proc.stdout and "Softmax" in proc.stdout
