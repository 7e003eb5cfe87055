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
from rten_tpu_torch.generate import ServingEngine
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
            lambda: params_from_numpy({"w": np.zeros((2, 2), np.float32)}),
            lambda: ServingEngine(model, params, max_batch=4, capacity=64,
                                  quantized_cache=True),
            lambda: ServingEngine(model, params, max_batch=4, capacity=64,
                                  quantized_cache=True, device="cuda")):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


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
    return {"decode_attn_int8_tail": (torch.zeros((b, 4, d)), kv, scales,
                                      lengths, tail, 1),
            "head_argmax_int8": (x, w, s),
            "tail_flush_int8": (tail, kv, scales, lengths, 1),
            "matmul_int8_wo": (x, w, s)}


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
