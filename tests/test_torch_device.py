"""The port stands alone and runs on the card by default: it imports
neither ``jax`` nor ``rten_tpu``, its entry points default to CUDA, and
without a card they raise instead of running on the CPU."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from rten_tpu_torch import resolve_device
from rten_tpu_torch.generate import KVCache, PagedKVCache, ServingEngine
from rten_tpu_torch.kernels import KERNELS, _build
from rten_tpu_torch.models import (TransformerConfig, TransformerLM,
                                   params_from_numpy, quantize_weights)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_neither_jax_nor_rten_tpu():
    """Every module of the package, imported in a fresh interpreter (this
    process has jax loaded by the test setup), leaves jax and rten_tpu out
    of sys.modules."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import rten_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            rten_tpu_torch.__path__, "rten_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "rten_tpu"))
        print(len(names), bad)
        assert len(names) >= 14 and not bad, bad
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the card-less "
                    "behaviour")


def test_entry_points_default_to_cuda_and_raise_without_card(no_card):
    model = TransformerLM(TransformerConfig.tiny_test(n_heads=2,
                                                      d_model=128))
    params = quantize_weights(model.init_params(0, device="cpu"))
    for call in (
            lambda: resolve_device(),
            lambda: model.init_params(0),
            lambda: model.new_cache(4, 64, quantized=True, tail_window=8),
            lambda: model.new_paged_cache(4, 64, 8, 33, quantized=True),
            lambda: params_from_numpy({"w": np.zeros((2, 2), np.float32)}),
            lambda: ServingEngine(model, params, max_batch=4, capacity=64,
                                  quantized_cache=True),
            lambda: ServingEngine(model, params, max_batch=4, capacity=64,
                                  quantized_cache=True, device="cuda"),
            lambda: ServingEngine(model, params, max_batch=4, capacity=64,
                                  quantized_cache=True, paged=True,
                                  page_size=8)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_cache_constructors_default_to_cuda_and_raise_without_card(
        no_card):
    """KVCache.create and PagedKVCache.create put their buffers on the
    card unless asked for the CPU: without a card the default raises
    instead of running on the CPU, and device="cpu" builds there."""
    for create, args in ((KVCache.create, (2, 1, 2, 16, 64)),
                         (PagedKVCache.create, (1, 5, 8, 2, 64, 2, 2))):
        for quantized in (False, True):
            with pytest.raises(RuntimeError, match="CUDA"):
                create(*args, quantized=quantized)
            cache = create(*args, quantized=quantized, device="cpu")
            assert cache.lengths.device.type == "cpu"


def _kernel_args():
    b, cap, rows, kvh, d = 2, 64, 8, 2, 64
    f = kvh * d
    kv = torch.zeros((b, cap, 2, f), dtype=torch.int8)
    scales = torch.ones((b, cap, 2, kvh), dtype=torch.bfloat16)
    tail = torch.zeros((b, rows, 2, f), dtype=torch.bfloat16)
    lengths = torch.ones(b, dtype=torch.int32)
    x = torch.zeros((4, 32))
    w = torch.zeros((32, 16), dtype=torch.int8)
    s = torch.ones(16)
    q = torch.zeros((b, 4, d))
    k = torch.zeros((b, kvh, 1, d))
    pool = torch.zeros((5, 8, 2, f), dtype=torch.int8)
    pscales = torch.ones((5, 8, 2, kvh), dtype=torch.bfloat16)
    table = torch.arange(1, 5, dtype=torch.int32).reshape(b, 2)
    # Group-wise int4: K 128 (one group), N 256 (one pack tile).
    x4, s4 = torch.zeros((4, 128)), torch.ones((1, 256))
    words = torch.zeros((32, 128), dtype=torch.int32)
    return {"decode_attn_int8_tail": (q, kv, scales, lengths, tail, 1),
            "head_argmax_int8": (x, w, s),
            "tail_flush_int8": (tail, kv, scales, lengths, 1),
            "matmul_int8_wo": (x, w, s),
            "kv_append": (torch.zeros((b, cap, 2, f)), k, k, lengths),
            "decode_attn_float": (q, torch.zeros((b, cap, 2, f)), lengths),
            "kv_append_int8": (kv, scales, k, k, lengths),
            "decode_attn_int8": (q, kv, scales, lengths),
            # Paged pools of b * 2 + 1 pages of 8 tokens, 2 pages per row.
            "kv_append_paged": (torch.zeros((5, 8, 2, f)), k, k, table,
                                lengths),
            "kv_append_paged_int8": (pool, pscales, k, k, table, lengths),
            "decode_attn_paged": (q, torch.zeros((5, 8, 2, f)), table,
                                  lengths),
            "decode_attn_paged_grid": (q, torch.zeros((5, 8, 2, f)), table,
                                       lengths),
            "decode_attn_paged_int8": (q, pool, pscales, table, lengths),
            "matmul_int4_words": (x4, words, s4),
            "matmul_int4_words_int8": (x4, words, s4),
            "matmul_int4": (x4, torch.zeros((128, 128), dtype=torch.uint8),
                            s4),
            # Chunked verify: 3 queries per sequence, int8 mode.
            "verify_attn_grouped": (torch.zeros((b, 3, 4, d)), kv, lengths,
                                    scales),
            "verify_attn_fused": (torch.zeros((b, 3, 4, d)), kv, lengths,
                                  scales),
            # Prefill attention at a shape its kernel takes (d 128, S 128).
            "flash_attention": tuple(torch.zeros((1, 2, 128, 128))
                                     for _ in range(3)),
            "decode_attn_grouped_int8": (q, kv, scales, lengths),
            "decode_attn_fused_int8": (q, kv, scales, lengths),
            "decode_attn_grouped_append": (q, torch.zeros((b, cap, 2, f)),
                                           k, k, lengths),
            "decode_attn_flat_float": (q, torch.zeros((b, cap, 2, f)),
                                       lengths),
            # Batch 4: a batch of 2 has no flat group, so it would raise.
            "decode_attn_int8_partials": (
                torch.zeros((4, 4, d)),
                torch.zeros((4, cap, 2, f), dtype=torch.int8),
                torch.ones((4, cap, 2, kvh), dtype=torch.bfloat16),
                torch.ones(4, dtype=torch.int32)),
            # Separate planes at a shape the kernel takes (d 128, S 256).
            "decode_attn_split_kv": (torch.zeros((b, 4, 128)),
                                     torch.zeros((b, kvh, 256, 128)),
                                     torch.zeros((b, kvh, 256, 128)),
                                     lengths),
            # Block 64, group 2: no fallback to the fused kernel.
            "decode_attn_native_dots": (q, torch.zeros((b, cap, 2, f)),
                                        lengths, 64, 2),
            "matmul_int8_tiled": (torch.zeros((4, 32), dtype=torch.int8), w,
                                  1.0, s)}


@pytest.mark.parametrize("kernel", KERNELS, ids=lambda k: k.__name__)
def test_kernel_wrapper_on_cuda_raises_without_card(kernel, no_card,
                                                    monkeypatch):
    """A wrapper given CUDA tensors (simulated: the dispatch rule is told
    they are not on the CPU) goes to its kernel, and building or loading
    the kernel without a card raises; nothing falls back to the plain
    version and no launch is counted."""
    monkeypatch.setattr(_build, "on_cpu", lambda name, *tensors: False)
    before = kernel.launches
    with pytest.raises(RuntimeError, match="CUDA device"):
        kernel(*_kernel_args()[kernel.__name__])
    assert kernel.launches == before


def test_graph_runtime_defaults_to_cuda_and_raises_without_card(
        no_card, tmp_path):
    """Model.load / load_file / Model(graph) / GraphExecutor and the CLI
    put a graph on the card unless asked for the CPU: without a card they
    raise (the CLI exits non-zero naming CUDA), and device="cpu" runs."""
    from rten_tpu_torch.fmt.model_builder import ModelBuilder
    from rten_tpu_torch.ir.graph import graph_from_model_file
    from rten_tpu_torch.fmt import container
    from rten_tpu_torch.runtime import GraphExecutor, Model, ModelOptions

    mb = ModelBuilder()
    g = mb.graph
    x = g.add_value("x", shape=[2, 3])
    out = g.add_operator("Relu", [x], name="relu")
    g.inputs, g.outputs = [x], [out]
    data = mb.to_bytes()
    path = tmp_path / "relu.rten"
    path.write_bytes(data)
    graph = graph_from_model_file(container.load_bytes(data))
    for call in (lambda: Model.load(data),
                 lambda: Model.load_file(str(path)),
                 lambda: Model.load(data, ModelOptions(device="cuda")),
                 lambda: Model(graph),
                 lambda: GraphExecutor(graph)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    model = Model.load(data, device="cpu")
    got = model.run_one(np.float32([[1, -2, 3], [-4, 5, -6]]))
    assert got.device.type == "cpu"
    assert got.tolist() == [[1, 0, 3], [0, 5, 0]]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-m", "rten_tpu_torch.cli",
                          str(path)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and "CUDA" in res.stderr


def test_no_source_of_the_port_imports_jax_or_rten_tpu():
    """A grep over every Python file of the package and chip_smoke.py: no
    import line names jax, jaxlib or rten_tpu (rten_tpu_torch is the
    port itself)."""
    import re
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|rten_tpu)\b",
                         re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "rten_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    assert len(files) > 40
    bad = [f for f in files if pattern.search(open(f).read())]
    assert not bad, bad
