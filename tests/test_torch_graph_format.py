"""The port's `.rten` format layer (``rten_tpu_torch.fmt``, ``ir``): it reads
the JAX package's bytes to the same graph, and the two packages write
byte-identical files from the same numpy weights, before and after
``quantize_graph_weights`` (ResNet-18, 10 classes, 32 px, and a graph with
every attrs table the ported ops use). The port's native reader is built
into its own directory and reads the same graph as its Python reader."""

import numpy as np
import pytest

from rten_tpu.fmt import container as jcontainer
from rten_tpu.fmt.model_builder import ModelBuilder as JModelBuilder
from rten_tpu.fmt.serialize import graph_to_bytes as j_graph_to_bytes
from rten_tpu.ir.graph import graph_from_model_file as j_graph_from_file
from rten_tpu.ir.quantize_graph import quantize_graph_weights as j_quantize
from rten_tpu.models.resnet import ResNet as JResNet
from rten_tpu.models.resnet import ResNetConfig as JResNetConfig
from rten_tpu_torch.fmt import container, native_loader
from rten_tpu_torch.fmt.header import Header, detect_version
from rten_tpu_torch.fmt.model_builder import ModelBuilder
from rten_tpu_torch.fmt.serialize import graph_to_bytes
from rten_tpu_torch.ir.graph import graph_from_model_file
from rten_tpu_torch.ir.quantize_graph import quantize_graph_weights
from rten_tpu_torch.models.resnet import ResNet, ResNetConfig

CFG = dict(depth=18, n_classes=10)


@pytest.fixture(scope="module")
def resnet_bytes():
    """(reference bytes, port bytes) of ResNet-18 from the same weights."""
    params = JResNet(JResNetConfig(**CFG)).init_params(None)
    ref = JResNet(JResNetConfig(**CFG)).build_rten(
        params, input_shape=(2, 3, 32, 32)).to_bytes()
    got = ResNet(ResNetConfig(**CFG)).build_rten(
        params, input_shape=(2, 3, 32, 32)).to_bytes()
    return ref, got


def _ops_model(builder_cls):
    """A model with an operator of each attrs table the ported modules
    read (conv, pool, norm, reduce, layout, cast, gemm, softmax, ...)."""
    rng = np.random.RandomState(1)
    mb = builder_cls()
    g = mb.graph
    x = g.add_value("x", shape=["batch", 3, 8, 8])
    w = g.add_constant("w", rng.randn(4, 3, 3, 3).astype(np.float32))
    c = g.add_operator("Conv", [x, w, None], attrs={
        "auto_pad": 1, "pads": [1, 0, 1, 2], "strides": [2, 1],
        "groups": 1, "dilations": [1, 2]}, name="conv")
    p = g.add_operator("MaxPool", [c], attrs={
        "kernel_size": [2, 2], "strides": [1, 1], "pads": [0, 0, 1, 1],
        "auto_pad": 1}, name="pool")
    n = g.add_operator("LayerNormalization", [p, g.add_constant(
        "s", np.ones(1, np.float32))], attrs={"axis": -1, "epsilon": 1e-6},
        name="ln")
    r = g.add_operator("ReduceMean", [n], attrs={"axes": [2, 3],
                                                 "keep_dims": 0}, name="rm")
    t = g.add_operator("Transpose", [r], attrs={"perm": [1, 0]}, name="t")
    k = g.add_operator("Cast", [t], attrs={"to": 1}, name="cast")
    s = g.add_operator("Softmax", [k], attrs={"axis": 0}, name="sm")
    a = g.add_operator("ArgMax", [s], attrs={"axis": 0, "keep_dims": 1},
                       name="am")
    g.inputs, g.outputs = [x], [s, a]
    mb.metadata = {"description": "ops", "license": "MIT"}
    return mb.to_bytes()


def test_resnet_bytes_identical(resnet_bytes):
    ref, got = resnet_bytes
    assert got == ref


def test_quantized_bytes_identical(resnet_bytes):
    ref, got = resnet_bytes
    jg = j_graph_from_file(jcontainer.load_bytes(ref))
    pg = graph_from_model_file(container.load_bytes(got))
    assert quantize_graph_weights(pg) == j_quantize(jg) == 21
    assert graph_to_bytes(pg) == j_graph_to_bytes(jg)


def test_ops_model_bytes_identical():
    assert _ops_model(ModelBuilder) == _ops_model(JModelBuilder)


def _graph_summary(graph):
    out = []
    for node in graph.nodes:
        d = node.data
        kind = type(d).__name__          # each package has its own classes
        if kind == "OperatorNode":
            attrs = {k: np.asarray(v).tolist() if not isinstance(v, str)
                     else v for k, v in d.attrs.items()}
            out.append(("op", node.name, d.op_type, attrs, d.inputs,
                        d.outputs))
        elif kind == "ConstantNode":
            out.append(("const", node.name, d.array.dtype.str,
                        d.array.shape, d.array.tobytes()))
        else:
            assert kind == "ValueNode"
            out.append(("value", node.name, d.shape))
    return out, graph.inputs, graph.outputs


@pytest.mark.parametrize("which", ["resnet", "ops"])
def test_port_reads_the_reference_bytes(resnet_bytes, which):
    """The reference's file, read by each package: the same nodes, attrs,
    constants (dtype, shape, bytes), inputs and outputs, and metadata."""
    data = resnet_bytes[0] if which == "resnet" else _ops_model(JModelBuilder)
    pm = container.load_bytes(data)
    jm = jcontainer.load_bytes(data)
    assert _graph_summary(graph_from_model_file(pm)) == \
        _graph_summary(j_graph_from_file(jm))
    assert pm.model.get("metadata") == jm.model.get("metadata")
    assert detect_version(data) == 2
    assert Header.from_buf(data).tensor_data_offset > 0


def test_native_reader_builds_into_the_port_and_matches(resnet_bytes):
    """The C++ reader (native/rten_reader.cpp) built into the port's build
    directory, not the reference's library path, reads the graph the
    Python reader reads."""
    assert native_loader.build()
    assert "rten_tpu_torch" in native_loader._LIB_PATH
    assert native_loader.available(auto_build=False)
    data = resnet_bytes[1]
    parsed = native_loader.read_model_json(data)
    native = native_loader.graph_from_native(data, parsed)
    python = graph_from_model_file(container.load_bytes(data))
    assert _graph_summary(native) == _graph_summary(python)


def test_file_roundtrip(tmp_path, resnet_bytes):
    path = tmp_path / "m.rten"
    path.write_bytes(resnet_bytes[1])
    for mmap in (True, False):
        mf = container.load_file(str(path), use_mmap=mmap)
        assert _graph_summary(graph_from_model_file(mf)) == _graph_summary(
            graph_from_model_file(container.load_bytes(resnet_bytes[1])))
