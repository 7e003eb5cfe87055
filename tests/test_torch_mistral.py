"""Parity of the port's head_dim-128 serving path (Mistral-7B's shape,
``TransformerConfig.mixtral(n_experts=0)``) against the JAX package on the
CPU, where the port's kernels run their plain versions and the reference's
Pallas kernels run in interpret mode, on inputs drawn with numpy:

* G1 (``decode_attn_grouped_int8``) against ``flash_decode_grouped`` in
  both ``int8_scores`` modes, G2 (``decode_attn_fused_int8``) against
  ``flash_decode_fused`` and A1 (``decode_attn_grouped_append``) against
  ``flash_decode_grouped_append``, with GQA 4:1 at d = 128;
* the int8 decode dispatch (``int8_decode_kernel``) against the kernels
  the reference's own dispatch calls, and its repair: an int8 cache whose
  capacity the flat kernel's block does not divide;
* a small d = 128 model: prefill logits and engine tokens (its
  teacher-forced decode logits on each kernel are in
  tests/test_torch_mistral_decode.py); and decode at Mistral's head
  shape.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rten_tpu.generate.engine import ServingEngine as JServingEngine
from rten_tpu.generate.kv_cache import KVCache as JKVCache
from rten_tpu.kernels import attention as ja
from rten_tpu.kernels.attention import (flash_decode_fused,
                                        flash_decode_grouped,
                                        flash_decode_grouped_append)
from rten_tpu.models import transformer as jtr
from rten_tpu_torch.generate import ServingEngine, kv_cache
from rten_tpu_torch.kernels import attention as at
from rten_tpu_torch.kernels import cache as kc
from rten_tpu_torch.models import (QuantWeight, TransformerConfig,
                                   TransformerLM, params_from_numpy,
                                   quantize_weights)
from rten_tpu_torch.models import transformer as ptr
from test_torch_kernels import port_layout

B, H, KVH, D, CAP = 4, 8, 2, 128, 128      # GQA 4:1 at head_dim 128
LENS = np.array([1, CAP, 45, CAP - 3], np.int32)
# The kernels' plain versions against the reference's kernels: both sum in
# f32 (an exact softmax against an online one over blocks), so they differ
# by a few f32 roundings of outputs of order 1: 1e-5 of max |out|.
REL_TOL = 1e-5
# Teacher-forced logits with f32 weights: the same f32 arithmetic in both
# packages in other orders and the same int8 cache bytes (|logits| ~ 1).
F32_LOGIT_TOL = 1e-5
# K1' rounds q and its output to bf16 (tests/test_torch_decode_paths.py).
FLAT_LOGIT_TOL = 1e-2
# The small d = 128 model (Mistral's family at width 256, GQA 2:1).
SMALL = dict(n_experts=0, n_layers=2, d_model=256, n_heads=2, kv_heads=1,
             d_ff=256, vocab_size=128)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _int8_case(seed, b=B, cap=CAP):
    """q [b, H, D] and a prefilled int8 cache in the reference's layout
    and in the port's, rows at mixed per-head magnitudes."""
    rng = np.random.default_rng(seed)
    jc = JKVCache.create(b, 1, KVH, cap, D, quantized=True)
    pre = [(rng.standard_normal((b, KVH, cap, D))
            * np.exp(rng.uniform(-2, 2, (b, KVH, 1, 1)))).astype(np.float32)
           for _ in range(2)]
    jc = jc.append(0, jnp.asarray(pre[0]), jnp.asarray(pre[1]), position=0)
    q = rng.standard_normal((b, H, D)).astype(np.float32)
    kv, scales = port_layout(jc, 0)
    return q, jc, kv, scales


def _close(out, ref, tol=REL_TOL):
    ref = np.asarray(ref)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=tol * np.abs(ref).max())


# -- G1, G2 and A1 against the reference's kernels ----------------------------

@pytest.mark.parametrize("int8_scores", [False, True])
def test_grouped_int8_plain_matches_flash_decode_grouped(int8_scores):
    """G1 in both score modes against flash_decode_grouped(kv_scales) at
    group 2 and block 64, lengths 1 through cap."""
    q, jc, kv, scales = _int8_case(80 + int8_scores)
    ref = flash_decode_grouped(jnp.asarray(q), jc.kv[0], jnp.asarray(LENS),
                               KVH, group=2, block_k=64,
                               kv_scales=jc.quant_scales[0],
                               int8_scores=int8_scores)
    _close(at.decode_attn_grouped_int8(_t(q), kv, scales, _t(LENS),
                                       int8_scores=int8_scores), ref)


def test_int8_scores_quantization_and_dots_are_exact():
    """The row quantization of q equals the reference's (attention.py:
    1102-1106) bit for bit, ties to even and an all-zero row included, and
    the plain integer dots equal an int64 sum."""
    q, _, kv, _ = _int8_case(82)
    q[1, 3] = 0.0                                   # scale 1.0
    q[2, 0, :4] = [2.0, 1.0, -1.0, 0.5]             # x / scale = 63.5: tie
    q[2, 0, 4:] = 0.25
    qj = jnp.asarray(q)
    qsc = jnp.max(jnp.abs(qj), axis=-1, keepdims=True)
    qsc = jnp.where(qsc == 0, 1.0, qsc / 127.0)
    ref8 = np.asarray(jnp.clip(jnp.round(qj / qsc), -127, 127))
    q8, qs = at.quantize_q_rows(_t(q))
    np.testing.assert_array_equal(q8.numpy(), ref8)
    np.testing.assert_array_equal(qs.numpy(), np.asarray(qsc)[..., 0])
    assert q8[2, 0, 1] == 64                        # 63.5 rounds to even
    dots = at.int8_score_dots_plain(_t(q), kv, _t(LENS)).numpy()
    k8 = kv.numpy()[:, :, 0].reshape(B, CAP, KVH, D).astype(np.int64)
    want = np.einsum("bgrd,bngd->bgrn",
                     ref8.astype(np.int64).reshape(B, KVH, H // KVH, D),
                     k8).reshape(B, H, CAP)
    want *= np.arange(CAP)[None, None, :] < LENS[:, None, None]
    np.testing.assert_array_equal(dots, want)


@pytest.mark.parametrize("b,cap", [(3, 128), (1, 96), (3, 160)])
def test_fused_int8_plain_matches_flash_decode_fused(b, cap):
    """G2 against flash_decode_fused(kv_scales): one block of the capacity
    (128), a capacity that is its own block (96) and a ragged one (160,
    the reference's dequantized plain path)."""
    q, jc, kv, scales = _int8_case(90 + cap, b=b, cap=cap)
    lens = np.array([1, cap, 45][:b], np.int32)
    ref = flash_decode_fused(jnp.asarray(q), jc.kv[0], jnp.asarray(lens),
                             KVH, kv_scales=jc.quant_scales[0])
    _close(at.decode_attn_fused_int8(_t(q), kv, scales, _t(lens)), ref)


@pytest.mark.parametrize("entry", ["fused", "exact", "int8_scores",
                                   "pv_int8"])
def test_int8_decode_plain_gives_zeros_without_a_live_row(entry):
    """A batch whose every length is 0 (no sequence has a row yet): G2's
    and G1's plain versions, pv_int8 included, return zeros, as the
    kernels and flash_decode_fused do, instead of reducing over no row."""
    q, jc, kv, scales = _int8_case(95, b=2)
    lens = np.zeros(2, np.int32)
    if entry == "fused":
        out = at.decode_attn_fused_int8(_t(q), kv, scales, _t(lens))
        ref = np.asarray(flash_decode_fused(
            jnp.asarray(q), jc.kv[0], jnp.asarray(lens), KVH,
            kv_scales=jc.quant_scales[0]))
        assert not ref.any()
    else:
        out = at.decode_attn_grouped_int8(
            _t(q), kv, scales, _t(lens), int8_scores=entry == "int8_scores",
            pv_int8=entry == "pv_int8", group=2)
    assert out.shape == (2, H, D) and not out.any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_append_plain_matches_flash_decode_grouped_append(dtype):
    """A1 against flash_decode_grouped_append at group 2 and block 64: the
    cache after the write bit for bit, the output within 1e-5 of max
    |out|; lengths count the new token, the first at row 0 and one at the
    last row."""
    rng = np.random.default_rng(95)
    kv0 = rng.standard_normal((B, CAP, 2, KVH * D)).astype(np.float32)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, KVH, 1, D)).astype(np.float32) * 3
            for _ in range(2))
    new_rows = np.stack([k.reshape(B, -1), v.reshape(B, -1)], 1)[:, None]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    ref, ref_kv = flash_decode_grouped_append(
        jnp.asarray(q), jnp.asarray(kv0).astype(jdt), jnp.asarray(new_rows),
        jnp.asarray(LENS), KVH, block_k=64, group=2)
    pkv = torch.from_numpy(kv0).to(getattr(torch, dtype))
    out = at.decode_attn_grouped_append(_t(q), pkv, _t(k), _t(v), _t(LENS))
    np.testing.assert_array_equal(pkv.to(torch.float32).numpy(),
                                  _np32(ref_kv))
    _close(out, ref)
    # The write is K5's, bit for bit.
    k5 = torch.from_numpy(kv0).to(getattr(torch, dtype))
    kc.kv_append(k5, _t(k), _t(v), _t(LENS - 1))
    assert torch.equal(k5, pkv)


# -- the int8 decode dispatch -------------------------------------------------

def _reference_choice(b, h, d, kvh, cap, decode_attn, quant_int8_scores):
    """(kernel, group) that the reference's _pallas_decode_attn reaches,
    traced abstractly (jax.eval_shape) with its three int8 entry points
    spied: the last call names the kernel that runs."""
    calls = []
    names = ("flash_decode_flat", "flash_decode_grouped", "flash_decode_fused")
    real = {n: getattr(ja, n) for n in names}

    def spy(name):
        def call(*a, **kw):
            calls.append((name, kw.get("group"), kw.get("int8_scores")))
            if name == "flash_decode_fused":
                return jnp.zeros(a[0].shape, a[0].dtype)
            return real[name].__wrapped__(*a, **kw)    # unjitted: traced
        return call

    cfg = jtr.TransformerConfig.mixtral(
        n_experts=0, n_layers=1, n_heads=h, kv_heads=kvh, d_model=h * d,
        decode_attn=decode_attn, quant_int8_scores=quant_int8_scores)
    cache = jax.eval_shape(lambda: JKVCache.create(b, 1, kvh, cap, d,
                                                   quantized=True))
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
    name, group, scores = calls[-1]
    kind = {"flash_decode_flat": "flat", "flash_decode_fused": "fused",
            "flash_decode_grouped": ("grouped_scores" if scores
                                     else "grouped")}[name]
    return kind, group or 0


# (batch, heads, head_dim, kv heads, capacity, decode_attn, int8_scores)
DISPATCH = [
    (16, 32, 128, 8, 4096, "auto", True),      # (H): E 8.4 MB > 4 MB
    (16, 32, 128, 8, 4096, "flat", True),
    (3, 32, 128, 8, 4096, "auto", True),       # (H-fused)
    (16, 32, 128, 8, 1024, "grouped", True),   # (H-scores)
    (16, 32, 128, 8, 1024, "grouped", False),
    (16, 32, 128, 8, 1024, "auto", True),
    (4, 2, 64, 2, 96, "auto", True),           # block 64 ∤ 96: fused
    (4, 2, 64, 2, 160, "auto", True),
    (4, 2, 64, 2, 128, "auto", True),          # K1'
    (4, 2, 128, 1, 2048, "grouped", True),     # long: exact q
    (4, 2, 64, 2, 2112, "auto", True),         # long, 128 ∤ cap
    (2, 2, 64, 2, 128, "auto", True),          # no group
    (4, 2, 64, 2, 128, "fused", True),
    (4, 2, 64, 2, 128, "stream", True),
    (32, 2, 128, 1, 128, "grouped", True),     # group 16: exact q
    (256, 12, 64, 12, 512, "auto", True),      # GPT-2 (B): group 32
    (64, 12, 64, 12, 2048, "auto", True),      # long: group 8, then 32
    (16, 32, 64, 4, 2048, "auto", True),       # TinyLlama without a tail
]


@pytest.mark.parametrize("case", DISPATCH, ids=str)
def test_int8_decode_kernel_follows_the_reference(case):
    assert at.int8_decode_kernel(*case) == _reference_choice(*case)


# -- the model ----------------------------------------------------------------

def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def small():
    """The small d = 128 model in both packages with the same f32 weights
    (seed 5)."""
    jm = jtr.TransformerLM(jtr.TransformerConfig.mixtral(**SMALL))
    jp = jm.init_params(jax.random.PRNGKey(5))
    return jm, jp, params_from_numpy(_np_tree(jp), device="cpu")


def _spy(monkeypatch, names):
    calls = []
    for name in names:
        real = getattr(ptr, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append((_name, kw.get("int8_scores", False)))
            return _real(*a, **kw)
        monkeypatch.setattr(ptr, name, spy)
    return calls


def _teacher_forced(jm, pm, jp, pp, b, cap, kw, steps=3, seed=7):
    """Prefill 5-token prompts, set ragged depths, then ``steps``
    teacher-forced decode steps in both packages; the worst logit
    difference over the steps."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, 128, (b, 5))
    jc = jm.new_cache(b, cap, **kw)
    pc = pm.new_cache(b, cap, device="cpu", **kw)
    _, jc = jm.prefill(jp, jnp.asarray(tokens, jnp.int32), jc)
    _, pc = pm.prefill(pp, torch.from_numpy(tokens), pc)
    lens = np.array([5, 3, 1, 4, 2][:b], np.int32)
    jc, pc = jc.with_lengths(jnp.asarray(lens)), pc.with_lengths(lens)
    tok = rng.integers(1, 128, b)
    worst = 0.0
    for _ in range(steps):
        jl, jc = jm.decode_step(jp, jnp.asarray(tok, jnp.int32), jc)
        pl, pc = pm.decode_step(pp, torch.tensor(tok), pc)
        worst = max(worst, float(np.abs(pl.numpy() - np.asarray(jl)).max()))
        tok = np.asarray(jnp.argmax(jl, axis=-1))
    np.testing.assert_array_equal(pc.lengths.numpy(), np.asarray(jc.lengths))
    return worst


@pytest.mark.parametrize("cap", [96, 160])
def test_int8_cache_at_a_ragged_capacity_matches_reference(cap,
                                                           monkeypatch):
    """The repaired dispatch: at capacities the flat kernel's block (64)
    does not divide, the reference falls back from flash_decode_flat to
    grouped and then to flash_decode_fused with exact q; the port now runs
    G2 there, not K1' (which rounds q and its output to bf16 and differed
    by 1.4e-3), so teacher-forced logits agree within 1e-5."""
    cfg = dict(n_heads=2, d_model=128)
    jm = jtr.TransformerLM(jtr.TransformerConfig.tiny_test(**cfg))
    jp = jm.init_params(jax.random.PRNGKey(3))
    pm = TransformerLM(TransformerConfig.tiny_test(**cfg))
    pp = params_from_numpy(_np_tree(jp), device="cpu")
    calls = _spy(monkeypatch, ("decode_attn_int8", "decode_attn_fused_int8"))
    worst = _teacher_forced(jm, pm, jp, pp, 4, cap, dict(quantized=True))
    print(f"capacity {cap}: worst teacher-forced logit difference "
          f"{worst:.3e}")
    assert {c[0] for c in calls} == {"decode_attn_fused_int8"}
    assert worst < F32_LOGIT_TOL, worst


def test_prefill_logits_at_bucket_128_match_reference(small, monkeypatch):
    """Prefill of two 128-token prompts through flash_attention (once per
    layer) into an int8 cache: last-token logits against the reference's."""
    jm, jp, pp = small
    pm = TransformerLM(TransformerConfig.mixtral(**SMALL))
    calls = _spy(monkeypatch, ("flash_attention", "attn_reference"))
    tokens = np.random.default_rng(11).integers(1, 128, (2, 128))
    jl, _ = jm.prefill(jp, jnp.asarray(tokens, jnp.int32),
                       jm.new_cache(2, 256, quantized=True))
    pl, _ = pm.prefill(pp, torch.from_numpy(tokens),
                       pm.new_cache(2, 256, quantized=True, device="cpu"))
    assert [c[0] for c in calls] == ["flash_attention"] * 2
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=0,
                               atol=1e-4)


def _reference_margins(jm, jp, prompt, generated):
    seq = jnp.asarray([list(prompt) + list(generated)], jnp.int32)
    logits = np.asarray(jm.forward(jp, seq)[0][0])
    top = np.sort(logits[len(prompt) - 1:-1], axis=-1)
    return top[:, -1] - top[:, -2]


def test_engine_tokens_match_reference(small, monkeypatch):
    """Three requests with prompts of up to 128 tokens (one prefill bucket
    of 128: flash_attention) through three slots (no group: G2 each decode
    step): the port's greedy tokens equal the reference engine's wherever
    the reference's top-2 margin exceeds the f32 tolerance."""
    jm, jp, pp = small
    pm = TransformerLM(TransformerConfig.mixtral(**SMALL))
    rng = np.random.default_rng(13)
    prompts = [list(rng.integers(1, 128, n)) for n in (128, 100, 77)]
    kw = dict(max_batch=3, capacity=256, prefill_buckets=(128,),
              quantized_cache=True)
    ref = JServingEngine(jm, jp, **kw).generate(prompts, 8, burst=4)
    calls = _spy(monkeypatch, ("flash_attention", "decode_attn_fused_int8"))
    eng = ServingEngine(pm, pp, device="cpu", **kw)
    out = eng.generate(prompts, 8, burst=4)
    assert eng._tail_flush == 0
    assert {c[0] for c in calls} == {"flash_attention",
                                     "decode_attn_fused_int8"}
    for prompt, r, o in zip(prompts, ref, out):
        assert len(o) == len(r) == 8
        c = next((i for i in range(8) if r[i] != o[i]), 8)
        if c < 8:
            margin = _reference_margins(jm, jp, prompt, r)[c]
            assert margin < 1e-4, (c, margin)


# -- Mistral-7B's head shape --------------------------------------------------

def test_init_int4_params_has_the_quantized_layout():
    """The int4 weights drawn layer by layer (the draw of chip_smoke.py's
    Mistral-7B path) have the layout of quantize_weights(init_params(),
    "int4"), the same for a seed and another for another seed; a model
    outside the Llama family raises."""
    model = TransformerLM(TransformerConfig.mixtral(**SMALL))
    want = quantize_weights(model.init_params(0, device="cpu"), "int4")
    got = model.init_int4_params(0, device="cpu")
    again = model.init_int4_params(0, device="cpu")
    other = model.init_int4_params(1, device="cpu")

    def leaves(p):
        out = {k: v for k, v in p.items() if k != "layers"}
        for i, layer in enumerate(p["layers"]):
            out.update({f"{i}.{k}": v for k, v in layer.items()})
        return out

    w, g, a, o = map(leaves, (want, got, again, other))
    assert g.keys() == w.keys()
    for k, x in g.items():
        y = w[k]
        if isinstance(y, QuantWeight):
            assert (x.kind, x.n, x.group) == (y.kind, y.n, y.group), k
            assert x.data.shape == y.data.shape, k
            assert x.data.dtype == y.data.dtype, k
            assert x.scales.shape == y.scales.shape, k
            assert torch.equal(x.data, a[k].data), k
            assert not torch.equal(x.data, o[k].data), k
        else:
            assert x.shape == y.shape and x.dtype == y.dtype, k
    logits, _ = model.forward(got, torch.zeros((1, 8), dtype=torch.int64))
    assert torch.isfinite(logits).all()
    with pytest.raises(ValueError, match="Llama-family"):
        TransformerLM(TransformerConfig.tiny_test()).init_int4_params(
            0, device="cpu")


@pytest.fixture(scope="module")
def mistral_head():
    """Mistral-7B's attention shape (d_model 4096, 32 query heads over 8
    KV heads of 128) with one layer, a tiny MLP and vocabulary."""
    model = TransformerLM(TransformerConfig.mixtral(
        n_experts=0, n_layers=1, d_ff=64, vocab_size=32))
    return model, model.init_params(0, device="cpu")


def test_mistral_head_shape_decodes_through_grouped_int8(mistral_head,
                                                         monkeypatch):
    """Batch 16 on an int8 cache of capacity 4096: the engine's tail gate
    refuses the window (the reference's E term, 32 x 128 x 1024 x 4 B =
    16.8 MB, is over its 4 MB), and a decode step reaches G1 with exact q
    (the reference's flat kernel falls back to grouped: its bf16 E matrix
    is 8.4 MB), never K1'."""
    model, params = mistral_head
    eng = ServingEngine(model, params, max_batch=16, capacity=4096,
                        prefill_buckets=(16,), quantized_cache=True,
                        device="cpu")
    assert eng._tail_flush == 0
    assert 32 * 128 * 8 * 128 * 4 > at.E_MATRIX_BUDGET
    calls = _spy(monkeypatch, ("decode_attn_int8", "decode_attn_grouped_int8",
                               "decode_attn_fused_int8"))
    out = eng.generate([[1, 2, 3]], max_new_tokens=2)
    assert len(out[0]) == 2
    assert calls == [("decode_attn_grouped_int8", False)]


def test_mistral_head_shape_fused_append_reaches_the_model(mistral_head,
                                                           monkeypatch):
    """fused_append in the config reaches the decode step through the
    engine: on a bf16 cache at batch 16 and capacity 4096 each step calls
    A1 once per layer, and the append kernel K5 does not run."""
    model, params = mistral_head
    fused = TransformerLM(TransformerConfig.mixtral(
        n_experts=0, n_layers=1, d_ff=64, vocab_size=32, fused_append=True))
    eng = ServingEngine(fused, params, max_batch=16, capacity=4096,
                        prefill_buckets=(16,), cache_dtype="bfloat16",
                        device="cpu")
    calls = _spy(monkeypatch, ("decode_attn_grouped_append",
                               "decode_attn_float"))
    appends = []
    monkeypatch.setattr(kv_cache, "kv_append", lambda *a: appends.append(a))
    out = eng.generate([[1, 2, 3]], max_new_tokens=3)
    assert len(out[0]) == 3 and not appends
    assert calls == [("decode_attn_grouped_append", False)] * 2
