"""The decode dispatch knobs ``RTEN_FLAT_QBF16`` and ``RTEN_FLAT_LONGCTX``:
the port reads them at call time, as the JAX package does, and makes its
choice with each set to "0" in turn.

* ``int8_decode_kernel`` and ``float_decode_kernel`` against the kernel and
  the q rounding that the reference's ``_pallas_decode_attn`` reaches,
  traced abstractly with its entry points spied, over a grid of batch x
  capacity (x ``decode_attn`` on float caches);
* the engine's tail gate against the reference engine's over batch x
  capacity x cache kind;
* K1's and K1''s exact-q mode (``q_bf16=False``) in its plain version
  against ``flash_decode_flat(q_bf16=False)`` in interpret mode, with and
  without the tail window, and the model routing a no-tail int8 cache to
  it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rten_tpu.generate.engine import ServingEngine as JServingEngine
from rten_tpu.generate.kv_cache import KVCache as JKVCache
from rten_tpu.kernels import attention as ja
from rten_tpu.kernels.attention import flash_decode_flat
from rten_tpu.models import transformer as jtr
from rten_tpu_torch.generate import ServingEngine
from rten_tpu_torch.kernels import attention as at
from rten_tpu_torch.models import TransformerConfig, TransformerLM
from rten_tpu_torch.models import transformer as ptr
from test_torch_kernels import _prefilled, port_layout

B, KVH, D, CAP = 4, 2, 64, 64
F = KVH * D
KNOBS = ("RTEN_FLAT_QBF16", "RTEN_FLAT_LONGCTX")
# Exact q: both packages keep q, the sums and the output in f32 and sum in
# other orders.
EXACT_REL_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _reference_choice(b, h, d, kvh, cap, decode_attn, quantized,
                      int8_scores=True):
    """(kind, group) that the reference's _pallas_decode_attn reaches under
    the current environment: the last spied entry point names the kernel,
    and ``flash_decode_flat``'s ``q_bf16`` names "flat" or "flat_exact"."""
    calls = []
    names = ("flash_decode_flat", "flash_decode_grouped",
             "flash_decode_fused", "flash_decode_stream")
    real = {n: getattr(ja, n) for n in names}

    def spy(name):
        def call(*a, **kw):
            calls.append((name, kw.get("group"), kw.get("int8_scores"),
                          kw.get("q_bf16")))
            if name in ("flash_decode_fused", "flash_decode_stream"):
                return jnp.zeros(a[0].shape, a[0].dtype)
            return real[name].__wrapped__(*a, **kw)    # unjitted: traced
        return call

    cfg = jtr.TransformerConfig.mixtral(
        n_experts=0, n_layers=1, n_heads=h, kv_heads=kvh, d_model=h * d,
        decode_attn=decode_attn, quant_int8_scores=int8_scores)
    cache = jax.eval_shape(lambda: JKVCache.create(b, 1, kvh, cap, d,
                                                   quantized=quantized))
    q = jax.ShapeDtypeStruct((b, h, d), jnp.float32)
    try:
        for n in names:
            setattr(ja, n, spy(n))
        jtr.flash_decode_fused = ja.flash_decode_fused
        jax.eval_shape(lambda c, x: jtr._pallas_decode_attn(cfg, x, c, 0,
                                                            kvh), cache, q)
    finally:
        for n in names:
            setattr(ja, n, real[n])
        jtr.flash_decode_fused = real["flash_decode_fused"]
    name, group, scores, q_bf16 = calls[-1]
    if name == "flash_decode_flat":
        # The flat kernel's own fallback (to grouped) shows as a later
        # call, so a flat last call ran flat.
        kind = "flat" if q_bf16 else "flat_exact"
    else:
        kind = {"flash_decode_fused": "fused", "flash_decode_stream": "stream",
                "flash_decode_grouped": ("grouped_scores" if scores
                                         else "grouped")}[name]
    return kind, group or 0


# (batch, heads, head_dim, kv heads): GPT-2-small's heads, TinyLlama's GQA
# and Mistral-7B's, whose f32 E matrix (16.8 MB) and bf16 one (8.4 MB)
# both miss 4 MB.
HEADS = [(12, 64, 12), (32, 64, 4), (32, 128, 8)]
BATCHES = [3, 16, 64, 256]
CAPS = [128, 1024, 2048, 2112, 4096]


@pytest.mark.parametrize("knob", KNOBS)
@pytest.mark.parametrize("heads", HEADS, ids=str)
@pytest.mark.parametrize("decode_attn", ["auto", "flat"])
def test_int8_decode_kernel_reads_the_knobs(monkeypatch, knob, heads,
                                            decode_attn):
    """int8 caches without a tail: batch x capacity with one knob "0"."""
    monkeypatch.setenv(knob, "0")
    h, d, kvh = heads
    for b in BATCHES:
        for cap in CAPS:
            case = (b, h, d, kvh, cap, decode_attn)
            assert at.int8_decode_kernel(*case) == \
                _reference_choice(*case, True), case


@pytest.mark.parametrize("knob", KNOBS)
@pytest.mark.parametrize("heads", HEADS, ids=str)
def test_float_decode_kernel_reads_the_knobs(monkeypatch, knob, heads):
    """Float caches with ``decode_attn="flat"`` (auto stays grouped):
    batch x capacity with one knob "0"."""
    monkeypatch.setenv(knob, "0")
    h, d, kvh = heads
    for b in BATCHES:
        for cap in CAPS:
            case = (b, h, d, kvh, cap, "flat")
            got = at.float_decode_kernel(*case)
            assert got == _reference_choice(*case, False), case


def test_default_knobs_keep_the_rounded_modes(monkeypatch):
    """Unset and "1" are the defaults: q rounded to bf16, long capacities
    flat; "0" turns each off at the next call, with no import between."""
    case = (16, 32, 64, 4, 4096)
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)
    assert at.int8_decode_kernel(*case) == ("flat", 8)
    monkeypatch.setenv("RTEN_FLAT_QBF16", "1")
    assert at.int8_decode_kernel(*case) == ("flat", 8)
    monkeypatch.setenv("RTEN_FLAT_LONGCTX", "0")
    assert at.int8_decode_kernel(*case) == ("grouped", 8)
    monkeypatch.setenv("RTEN_FLAT_LONGCTX", "1")
    monkeypatch.setenv("RTEN_FLAT_QBF16", "0")
    assert at.int8_decode_kernel(*case) == ("grouped", 8)
    assert at.int8_decode_kernel(16, 32, 64, 4, 1024) == ("flat_exact", 8)


@pytest.mark.parametrize("knob", (None,) + KNOBS)
@pytest.mark.parametrize("quant", [True, False])
def test_tail_gate_reads_the_knobs(monkeypatch, knob, quant):
    """The engine's tail gate against the reference engine's at TinyLlama's
    width over batch x capacity, with no knob set or one knob "0". The gate
    reads the config only: one layer and placeholder weights do."""
    if knob:
        monkeypatch.setenv(knob, "0")
    cfg = dict(n_layers=1, vocab_size=256)
    jm = jtr.TransformerLM(jtr.TransformerConfig.tiny_llama(**cfg))
    pm = TransformerLM(TransformerConfig.tiny_llama(**cfg))
    seen = set()
    for b in (3, 16, 32):
        for cap in (512, 2048, 4096):
            kw = dict(max_batch=b, capacity=cap, quantized_cache=quant)
            ref = JServingEngine(jm, {"embed": jnp.zeros((1, 1))},
                                 **kw)._tail_flush
            got = ServingEngine(pm, {"embed": torch.zeros((1, 1))},
                                device="cpu", **kw)._tail_flush
            assert got == ref, (b, cap)
            seen.add((cap >= 2048, got))
    # The grid reaches both answers where the knob lets long caches in.
    if quant and knob is None:
        assert (True, 16) in seen and (False, 16) in seen
    if quant and knob:
        assert (True, 16) not in seen and (False, 16) in seen


@pytest.mark.parametrize("depth", [0, 5])
def test_tail_kernel_exact_q_plain_matches_flash_decode_flat(depth):
    """K1's exact-q plain version against flash_decode_flat(int8 + tail,
    q_bf16=False): q, the sums and the output stay f32."""
    rows = 8
    rng = np.random.default_rng(400 + depth)
    prompt_lens = [1, 17, 40, CAP - rows - 1]
    jc, _ = _prefilled(rng, prompt_lens, rows)
    tail = rng.standard_normal((B, rows, 2, F)).astype(np.float32)
    tail_bf16 = jnp.asarray(tail, jnp.bfloat16)
    q = rng.standard_normal((B, 4, D)).astype(np.float32)
    lens = np.asarray(prompt_lens, np.int32) + depth
    ref = np.asarray(flash_decode_flat(
        jnp.asarray(q), jc.kv[0], jnp.asarray(lens + 1), KVH, group=2,
        block_k=64, kv_scales=jc.quant_scales[0], tail=tail_bf16,
        tail_count=depth + 1, q_bf16=False))
    kv, scales = port_layout(jc, 0)
    ptail = _t(np.asarray(tail_bf16.astype(jnp.float32))).to(torch.bfloat16)
    out = at.decode_attn_int8_tail(_t(q), kv, scales, _t(lens + 1), ptail,
                                   depth + 1, q_bf16=False)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=EXACT_REL_TOL * np.abs(ref).max())
    # The rounded mode differs from the exact reference by more than that.
    rounded = at.decode_attn_int8_tail(_t(q), kv, scales, _t(lens + 1),
                                       ptail, depth + 1).numpy()
    assert np.abs(rounded - ref).max() > EXACT_REL_TOL * np.abs(ref).max()


def test_no_tail_exact_q_plain_matches_flash_decode_flat():
    """K1''s exact-q plain version against flash_decode_flat(int8,
    tail=None, q_bf16=False), lengths 0 through cap."""
    rng = np.random.default_rng(410)
    jc = JKVCache.create(B, 1, KVH, CAP, D, quantized=True)
    pre = [rng.standard_normal((B, KVH, CAP, D)).astype(np.float32)
           for _ in range(2)]
    jc = jc.append(0, jnp.asarray(pre[0]), jnp.asarray(pre[1]), position=0)
    q = rng.standard_normal((B, 4, D)).astype(np.float32)
    lens = np.array([1, CAP, 29, CAP - 1], np.int32)
    ref = np.asarray(flash_decode_flat(
        jnp.asarray(q), jc.kv[0], jnp.asarray(lens), KVH, group=2,
        block_k=64, kv_scales=jc.quant_scales[0], q_bf16=False))
    kv, scales = port_layout(jc, 0)
    out = at.decode_attn_int8(_t(q), kv, scales, _t(lens), q_bf16=False)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=EXACT_REL_TOL * np.abs(ref).max())


@pytest.mark.parametrize("qbf16", ["1", "0"])
def test_model_sends_the_mode_the_knob_names(monkeypatch, qbf16):
    """A no-tail int8 cache at a flat shape: the model calls K1' with
    q_bf16 as ``RTEN_FLAT_QBF16`` says, read at the call."""
    monkeypatch.setenv("RTEN_FLAT_QBF16", qbf16)
    seen = []
    real = ptr.decode_attn_int8

    def spy(*a, **kw):
        seen.append(kw.get("q_bf16", True))
        return real(*a, **kw)

    monkeypatch.setattr(ptr, "decode_attn_int8", spy)
    cfg = TransformerConfig.tiny_test(n_layers=1, n_heads=2, d_model=128)
    model = TransformerLM(cfg)
    cache = model.new_cache(4, 128, quantized=True, device="cpu")
    q3 = torch.randn((4, 2, 64))
    out = ptr._cache_decode_attn(cfg, q3, cache, 0)
    assert out.shape == (4, 2, 64) and seen == [qbf16 == "1"]
