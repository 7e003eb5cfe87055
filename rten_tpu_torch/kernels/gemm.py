"""Quantized GEMMs of the serving path.

* ``matmul_int8`` ports ``rten_tpu/kernels/gemm.py::matmul_int8`` (:72-89),
  which the JAX package leaves to an XLA dot outside any Pallas kernel:
  here ``torch._int_mm`` (exact int32 accumulation) and the same f32
  epilogue, x_scale * w_scale[col].
* ``matmul_int8_wo`` (CUDA, ``csrc/matmul_int8_wo.cu``) replaces
  ``matmul_int8_weight_only`` (:173).
* ``head_argmax_int8`` (CUDA, ``csrc/head_argmax_int8.cu``) replaces
  ``matmul_argmax_int8`` (:268).

The two kernels read W as 8-byte vectors, so their weights have N % 8 == 0;
``pad_cols`` pads an int8 weight's columns once, at quantize time, and the
callers slice the output (or pass ``n_valid`` to the argmax head).
"""

from __future__ import annotations

import torch

from . import _build


def pad_cols(q, scales, multiple=8):
    """Pad int8 weight columns [K, N] (and their scales [N]) with zero
    columns of scale 1.0 up to a multiple of ``multiple``; the results are
    contiguous, as the kernels require."""
    pad = (-q.shape[1]) % multiple
    if pad:
        q = torch.nn.functional.pad(q, (0, pad))
        scales = torch.nn.functional.pad(scales, (0, pad), value=1.0)
    return q.contiguous(), scales.contiguous()


def matmul_int8(x, w, x_scale, w_scales):
    """int8 ``x`` [M, K] × int8 ``w`` [K, N] → f32 [M, N], scaled by
    ``x_scale`` (scalar tensor) and ``w_scales`` [N]. On CUDA,
    ``torch._int_mm`` needs M > 16 and K, N multiples of 8; anything else
    raises."""
    m, k = x.shape
    n = w.shape[1]
    if x.device.type == "cuda":
        _build.require(m > 16 and k % 8 == 0 and n % 8 == 0, "matmul_int8",
                       f"torch._int_mm on CUDA needs M > 16 and K, N "
                       f"multiples of 8 (got {m}x{k}x{n})")
    acc = torch._int_mm(x.contiguous(), w)
    scale = x_scale.to(torch.float32) * w_scales.to(torch.float32)
    return acc.to(torch.float32) * scale[None, :]


def _check_wo(name, x, w, scales):
    _build.require(x.dim() == 2 and x.dtype == torch.float32, name,
                   "x must be f32 [M, K]")
    _build.require(w.dim() == 2 and w.shape[0] == x.shape[1]
                   and w.dtype == torch.int8, name, "w must be int8 [K, N]")
    _build.require(scales.shape == (w.shape[1],)
                   and scales.dtype == torch.float32, name,
                   "scales must be f32 [N]")


def _check_kernel(name, x, w, scales):
    _build.require(w.shape[1] % 8 == 0, name,
                   "N must be a multiple of 8 (pad_cols at quantize time)")
    _build.require(all(t.is_contiguous() for t in (x, w, scales))
                   and w.data_ptr() % 16 == 0, name,
                   "tensors must be contiguous and W 16-byte aligned")


def matmul_int8_wo_plain(x, w, scales):
    """Plain PyTorch version of ``matmul_int8_wo``: bf16-rounded x and the
    exactly converted weight multiplied in f32, scales after the sum."""
    _check_wo("matmul_int8_wo", x, w, scales)
    xb = x.to(torch.bfloat16).to(torch.float32)
    return (xb @ w.to(torch.float32)) * scales[None, :]


def matmul_int8_wo(x, w, scales):
    """f32 ``x`` [M, K] × int8 ``w`` [K, N] × per-column ``scales`` [N] →
    f32 [M, N]: bf16 x, exact bf16 weights, f32 accumulation, scales after
    the sum. CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise."""
    name = "matmul_int8_wo"
    if _build.on_cpu(name, x, w, scales):
        return matmul_int8_wo_plain(x, w, scales)
    _check_wo(name, x, w, scales)
    _check_kernel(name, x, w, scales)
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    fn = _build.function(name, name, "ppppiiip")
    err = fn(x.data_ptr(), w.data_ptr(), scales.data_ptr(), out.data_ptr(),
             m, k, n, _build.stream())
    _build.check(err, name)
    matmul_int8_wo.launches += 1
    return out


matmul_int8_wo.launches = 0


def head_argmax_int8_plain(x, w, scales, n_valid=None):
    """Plain PyTorch version of ``head_argmax_int8``: the logits of
    :func:`matmul_int8_wo_plain`, then the first maximal index."""
    n_valid = w.shape[1] if n_valid is None else n_valid
    logits = matmul_int8_wo_plain(x, w, scales)[:, :n_valid]
    return torch.argmax(logits, dim=-1).to(torch.int32)


def head_argmax_int8(x, w, scales, n_valid=None):
    """Greedy LM head: ``argmax(x @ (w * scales))`` over the first
    ``n_valid`` columns (default all), ties to the lowest index, without
    materialising the [M, N] logits. Returns int32 [M]. CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise."""
    name = "head_argmax_int8"
    n_valid = w.shape[1] if n_valid is None else int(n_valid)
    if _build.on_cpu(name, x, w, scales):
        return head_argmax_int8_plain(x, w, scales, n_valid)
    _check_wo(name, x, w, scales)
    _check_kernel(name, x, w, scales)
    _build.require(0 < n_valid <= w.shape[1], name, "n_valid out of range")
    m, k = x.shape
    n = w.shape[1]
    n_tiles = -(-n // 64)
    part_val = torch.empty((m, n_tiles), dtype=torch.float32,
                           device=x.device)
    part_idx = torch.empty((m, n_tiles), dtype=torch.int32, device=x.device)
    out = torch.empty((m,), dtype=torch.int32, device=x.device)
    fn = _build.function(name, name, "ppppppiiiip")
    err = fn(x.data_ptr(), w.data_ptr(), scales.data_ptr(),
             part_val.data_ptr(), part_idx.data_ptr(), out.data_ptr(), m, k,
             n, n_valid, _build.stream())
    _build.check(err, name)
    head_argmax_int8.launches += 1
    return out


head_argmax_int8.launches = 0
