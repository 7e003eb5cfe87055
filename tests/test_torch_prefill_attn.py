"""Parity of the port's prefill attention (``rten_tpu_torch`` on the CPU,
where F1's plain version runs) against the JAX package's
``flash_attention`` (CPU backend, Pallas in interpret mode), on inputs drawn
with numpy: causal and not, one and several query blocks at head_dim 128,
and the shapes the reference sends to its plain path, which stay on
``attn_reference`` in the port's dispatch too."""

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
