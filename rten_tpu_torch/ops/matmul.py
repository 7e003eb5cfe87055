"""MatMul / Gemm / Einsum / FusedSDPA.

The torch counterpart of ``rten_tpu/ops/matmul.py``. Batch broadcasting
follows numpy matmul semantics (reference ``src/ops/matmul.rs:194-206``).
f32 products run with TF32 off (:func:`~.common.full_f32`), as the
reference's f32 ``dot_general`` sums in f32. Integer products are exact:
CUDA has no int32 matmul, so they run in f64 (exact below 2^53) and wrap
to int32 as the reference's int32 accumulator does.

``FusedSDPA`` sends 4-D maskless float attention at prefill lengths to the
flash-attention kernel F1 (``kernels.attention.flash_attention``,
``csrc/prefill_attn.cu``) under the reference's condition, and to the
plain op chain otherwise.
"""

from __future__ import annotations

import torch

from ..kernels import attention as attn
from .common import full_f32
from .registry import OpError, register


def _int_exact(fn, *xs):
    """An integer product computed exactly in f64, wrapped to int32."""
    out = fn(*(x.to(torch.float64) for x in xs))
    return out.round().to(torch.int64).to(torch.int32)


def _product(fn, *xs):
    if xs[0].is_floating_point():
        with full_f32():
            return fn(*(x.to(torch.float32) for x in xs))
    return _int_exact(fn, *xs)


@register("MatMul")
def matmul(ctx, attrs, a, b):
    if a.ndim < 1 or b.ndim < 1:
        raise OpError("MatMul", "inputs must have rank >= 1")
    return _product(torch.matmul, a, b)


@register("Gemm")
def gemm(ctx, attrs, a, b, c=None):
    alpha = float(attrs.get("alpha", 1.0))
    beta = float(attrs.get("beta", 1.0))
    if attrs.get("transpose_a"):
        a = a.T
    if attrs.get("transpose_b"):
        b = b.T
    out = _product(torch.matmul, a, b)
    if alpha != 1.0:
        out = alpha * out
    if c is not None and beta != 0.0:
        out = out + (beta * c if beta != 1.0 else c)
    return out


@register("Einsum")
def einsum(ctx, attrs, *xs):
    equation = attrs.get("equation")
    if not equation:
        raise OpError("Einsum", "missing equation")
    eq = equation.replace(" ", "")
    return _product(lambda *ys: torch.einsum(eq, *ys), *xs)


def sdpa_takes_flash(q, kt, v, mask):
    """The reference's condition for its flash kernel (ops/matmul.py:68-70):
    4-D maskless float inputs, self-attention lengths of at least 256 in
    steps of 128, and a value width equal to the head width."""
    s_q, d = q.shape[-2], q.shape[-1]
    s_k = kt.shape[-1]
    return (mask is None and q.ndim == 4 and v.shape[-1] == d
            and s_q == s_k and s_q >= 256 and s_q % 128 == 0
            and q.is_floating_point())


@register("FusedSDPA")
def fused_sdpa(ctx, attrs, q, kt, v, mask=None):
    """Fused scaled-dot-product attention (optimizer rewrite of the
    MatMul→scale→mask→Softmax→MatMul chain, ir/optimize.py).

    q [..., S_q, D], kt [..., D, S_k] (the graph's already-transposed K),
    v [..., S_k, Dv]; additive ``mask`` broadcastable over the scores.
    Where :func:`sdpa_takes_flash` holds, the reference's
    ``flash_attention``: F1 (``kernels.attention.flash_attention``) at the
    shapes its kernel takes (``flash_attention_takes``), its plain
    arithmetic (``attn_reference``) at the others, as the reference's
    kernel falls back; everything else is the plain chain."""
    scale = float(attrs.get("scale", 1.0))
    causal = bool(attrs.get("causal", 0))
    s_q, d = q.shape[-2], q.shape[-1]
    s_k = kt.shape[-1]
    if sdpa_takes_flash(q, kt, v, mask):
        qf = q.to(torch.float32).contiguous()
        k = kt.transpose(-1, -2).to(torch.float32).contiguous()
        vf = v.to(torch.float32).contiguous()
        if attn.flash_attention_takes(s_q, s_k, d):
            out = attn.flash_attention(qf, k, vf, causal=causal, scale=scale)
        else:
            with full_f32():
                out = attn.attn_reference(qf, k, vf, causal, scale)
        return out.to(q.dtype)
    with full_f32():
        scores = torch.matmul(q.to(torch.float32), kt.to(torch.float32)) \
            * scale
        if causal:
            cm = torch.tril(torch.ones((s_q, s_k), dtype=torch.bool,
                                       device=q.device), s_k - s_q)
            scores = torch.where(cm, scores,
                                 torch.full_like(scores, -1e30))
        if mask is not None:
            scores = scores + mask
        probs = torch.softmax(scores, dim=-1)
        return torch.matmul(probs.to(q.dtype).to(torch.float32),
                            v.to(torch.float32)).to(q.dtype)
