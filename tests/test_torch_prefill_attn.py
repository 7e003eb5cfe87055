"""Parity of the port's prefill attention (``rten_tpu_torch`` on the CPU,
where F1's plain version runs) against the JAX package's
``flash_attention`` (CPU backend, Pallas in interpret mode), on inputs drawn
with numpy: causal and not, one and several query blocks at head_dim 128,
and the shapes the reference sends to its plain path, which stay on
``attn_reference`` in the port's dispatch too."""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rten_tpu.kernels.attention import _attn_reference, flash_attention
from rten_tpu_torch.kernels import attention as at
from rten_tpu_torch.models import TransformerConfig, TransformerLM
from rten_tpu_torch.models import transformer as ptr

# F1's plain version against the Pallas kernel: both sum in f32 (one
# exact softmax against an online one over blocks of 128), so they differ
# by a few f32 roundings of outputs of order 1: 1e-5 of max |out|.
REL_TOL = 1e-5


def _qkv(rng, b, h, s, d):
    """q, k, v [B, H, S, D] f32 with mixed per-head magnitudes."""
    return [(rng.standard_normal((b, h, s, d))
             * np.exp(rng.uniform(-1, 1, (b, h, 1, 1)))).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s", [(2, 128), (1, 256)])
def test_flash_attention_plain_matches_reference_kernel(b, s, causal):
    """d = 128, H = 2: one query block (S 128) and two (S 256), causal and
    not; the reference runs its Pallas kernel at these shapes."""
    rng = np.random.default_rng(s + int(causal))
    q, k, v = _qkv(rng, b, 2, s, 128)
    assert at.flash_attention_takes(s, s, 128)
    ref = np.asarray(flash_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=causal))
    out = at.flash_attention(*map(torch.from_numpy, (q, k, v)),
                             causal=causal)
    assert out.dtype == torch.float32 and out.shape == q.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=REL_TOL * np.abs(ref).max())


# -- F1's arithmetic on the card: split TF32 ---------------------------------
# The kernel (csrc/prefill_attn.cu) splits every f32 operand of its two
# products into hi = tf32(a) and lo = tf32(a - hi) and sums hi*hi and, apart,
# lo*hi + hi*lo on the tensor cores, per 32-key tile. The helpers below redo
# that arithmetic in torch on the CPU (a product of two TF32 values is exact
# in f32), inside the kernel's blockwise online softmax, so that the design
# is held against the reference here; the card tests hold the kernel to it.

def _tf32(x):
    """cvt.rna.tf32.f32: the f32 magnitude rounded to 10 mantissa bits,
    ties away from zero, by integer operations on the bits (half an ulp
    of TF32 added to the magnitude's bits, the 13 low bits cleared)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split_mm(a, b, terms):
    """a @ b with TF32 operands: hi*hi plus, summed apart, lo*hi + hi*lo
    (terms 3), or hi*hi alone (terms 1)."""
    ah, bh = _tf32(a), _tf32(b)
    if terms == 1:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return ah @ bh + (al @ bh + ah @ bl)


def _split_tf32_flash(q, k, v, causal, terms, block_q=64, block_k=32):
    """The kernel's attention: 64-query tiles, 32-key tiles, the running
    max from -1e30, masked scores -1e30, the output folded per key tile as
    o * alpha + P V, out = o / max(l, 1e-30)."""
    s, d = q.shape[2], q.shape[3]
    scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    rows = torch.arange(block_q)[:, None]
    for q0 in range(0, s, block_q):
        qt = q[:, :, q0:q0 + block_q]
        m = torch.full(qt.shape[:3] + (1,), -1e30)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qt)
        n_k = (q0 + block_q) // block_k if causal else s // block_k
        for kt in range(n_k):
            k0 = kt * block_k
            kb, vb = k[:, :, k0:k0 + block_k], v[:, :, k0:k0 + block_k]
            sc = _split_mm(qt, kb.transpose(-1, -2), terms) * scale
            if causal:
                keys = k0 + torch.arange(block_k)[None, :]
                sc = sc.masked_fill(keys > q0 + rows, -1e30)
            m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(sc - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + _split_mm(p, vb, terms)
            m = m_new
        out[:, :, q0:q0 + block_q] = acc / torch.clamp_min(l, 1e-30)
    return out


@functools.lru_cache(maxsize=None)
def _reference_case(b, s, causal):
    """Inputs and the JAX package's flash_attention (interpret mode)."""
    rng = np.random.default_rng(100 + s + int(causal))
    q, k, v = _qkv(rng, b, 2, s, 128)
    ref = np.asarray(flash_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=causal))
    return q, k, v, ref


SPLIT_CASES = [(2, 128, True), (2, 128, False), (1, 256, True),
               (1, 256, False)]


@pytest.mark.parametrize("b,s,causal", SPLIT_CASES)
def test_split_tf32_attention_matches_reference_kernel(b, s, causal):
    """Three TF32 products per f32 product keep the reference's f32
    arithmetic: within REL_TOL of the JAX package's flash_attention."""
    q, k, v, ref = _reference_case(b, s, causal)
    out = _split_tf32_flash(*map(torch.from_numpy, (q, k, v)), causal, 3)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=REL_TOL * np.abs(ref).max())


@pytest.mark.parametrize("b,s,causal", SPLIT_CASES)
def test_one_tf32_product_misses_the_tolerance(b, s, causal):
    """One TF32 product (hi*hi, ~2^-11 of each product) changes the
    reference's arithmetic by far more than REL_TOL: the split is needed,
    and the test above can fail."""
    q, k, v, ref = _reference_case(b, s, causal)
    out = _split_tf32_flash(*map(torch.from_numpy, (q, k, v)), causal, 1)
    err = np.abs(out.numpy() - ref).max()
    assert err > 10 * REL_TOL * np.abs(ref).max()


def test_split_tf32_row_below_the_mask_value_is_zero():
    """A query whose every score lies below -1e30 (as a fully masked row
    looks to the kernel): the reference kernel's running max starts at
    -1e30, so its probabilities are 0 and its output 0 / 1e-30 = 0; the
    split arithmetic gives the same, and the other rows still agree."""
    rng = np.random.default_rng(7)
    q, k, v = _qkv(rng, 1, 2, 128, 128)
    k[..., 0] = 1.0 + np.abs(k[..., 0])
    q[0, 1, 5] = 0.0
    q[0, 1, 5, 0] = -1e32
    ref = np.asarray(flash_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=False))
    assert not ref[0, 1, 5].any()
    out = _split_tf32_flash(*map(torch.from_numpy, (q, k, v)), False, 3)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=REL_TOL * np.abs(ref).max())


@pytest.mark.parametrize("s,d", [(64, 128), (8, 128), (128, 64),
                                 (192, 128), (130, 128)])
def test_fallback_shapes_stay_on_attn_reference(s, d):
    """Prompts under 128 tokens, head_dim 64 and lengths that do not divide
    by the block: the reference's flash_attention returns its plain
    ``_attn_reference`` there, the port's rule refuses the kernel, and the
    port's attn_reference agrees with the reference's plain path."""
    rng = np.random.default_rng(s * d)
    q, k, v = _qkv(rng, 1, 2, s, d)
    assert not at.flash_attention_takes(s, s, d)
    scale = 1.0 / np.sqrt(d)
    ref = np.asarray(flash_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=True))
    plain = np.asarray(_attn_reference(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), True, scale))
    # (jit fuses the plain path otherwise than an eager call: f32 roundings)
    np.testing.assert_allclose(ref, plain, rtol=0,
                               atol=REL_TOL * np.abs(ref).max())
    out = at.attn_reference(*map(torch.from_numpy, (q, k, v)), True, scale)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=REL_TOL * np.abs(ref).max())
    with pytest.raises(ValueError, match="flash_attention_takes"):
        at.flash_attention(*map(torch.from_numpy, (q, k, v)))


def test_flash_attention_refuses_bad_arguments():
    """Other dtypes, mismatched shapes and other devices raise; there is
    no fallback off the CPU."""
    q = torch.zeros((1, 2, 128, 128))
    with pytest.raises(ValueError):
        at.flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(ValueError):
        at.flash_attention(q, q[:, :1], q)
    with pytest.raises(ValueError, match="all on"):
        at.flash_attention(q, q.to("meta"), q)


@pytest.mark.parametrize("prompt,d_model,n_heads,takes", [
    (128, 256, 2, True),      # d 128, S 128: flash_attention
    (64, 256, 2, False),      # S under 128
    (128, 256, 4, False),     # d 64
])
def test_prefill_dispatch_follows_the_reference(monkeypatch, prompt,
                                                d_model, n_heads, takes):
    """Which prefill attention a forward reaches: flash_attention where
    the reference's kernel runs (once per layer), attn_reference
    elsewhere."""
    calls = []
    for name in ("flash_attention", "attn_reference"):
        real = getattr(ptr, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(ptr, name, spy)
    cfg = TransformerConfig.mixtral(
        n_experts=0, n_layers=2, d_model=d_model, n_heads=n_heads,
        kv_heads=1, d_ff=64, vocab_size=32)
    model = TransformerLM(cfg)
    params = model.init_params(0, device="cpu")
    tokens = torch.zeros((1, prompt), dtype=torch.int64)
    model.forward(params, tokens)
    want = "flash_attention" if takes else "attn_reference"
    assert calls == [want] * 2
