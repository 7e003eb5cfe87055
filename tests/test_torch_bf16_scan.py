"""bf16 compute (``dtype="bfloat16"``) and ``scan_layers`` in the port, on
the CPU, against the JAX package (CPU backend, Pallas in interpret mode):
``tests/test_engine.py``'s bf16 and scan tests (bf16 against f32, the cache
dtype following the compute dtype, scan against the loop for forward,
prefill and decode, the engine with ``scan_layers``) on the port and
against the reference; the int8 activation quantization under bf16 bit
for bit; the float linear's promotion; the plain versions of F1, G1, K6,
K1, K2 and K4 on bf16 inputs, outputs rounded as the reference's kernel
bodies write them; and whole models under bf16 on every cache kind."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rten_tpu.generate.engine import ServingEngine as JServingEngine
from rten_tpu.generate.kv_cache import KVCache as JKVCache
from rten_tpu.kernels import gemm as jgemm
from rten_tpu.kernels.attention import (flash_attention, flash_decode_flat,
                                        flash_decode_grouped)
from rten_tpu.models import transformer as jtr
from rten_tpu_torch.generate import ServingEngine
from rten_tpu_torch.generate.kv_cache import KVCache
from rten_tpu_torch.kernels import attention as at
from rten_tpu_torch.kernels import gemm as pg
from rten_tpu_torch.models import (TransformerConfig, TransformerLM,
                                   params_from_numpy, quantize_weights,
                                   stack_layer_params)
from rten_tpu_torch.models import transformer as ptr
from test_torch_kernels import _prefilled, port_layout

# One bf16 step (2^-8 relative) of the largest output: both packages round
# the same f32 value to bf16, computed from sums in other orders, so an
# element may land one step apart.
BF16_STEP = 2.0 ** -8
# Logits under bf16 compute (|logits| up to ~1.4): the hidden states are
# bf16, so an f32 value one ulp apart between the packages (cos, sin and
# exp are other implementations: 5-8% of the RoPE table's entries differ by
# an ulp) flips a bf16 rounding now and then, and the bf16 attention scores
# and softmax carry each flip on. Measured worst (the print below): 3e-7
# where a bias keeps the residual in f32 (GPT-2), 8.3e-3 on the Llama
# family (a bf16 residual); tolerance twice that.
BF16_LOGIT_TOL = 1.6e-2
# int8 weights under bf16 compute: an activation one bf16 step apart may
# also quantize one int8 step apart (the M > 64 products): 2.8e-2
# measured; tolerance about twice that.
BF16_INT8_LOGIT_TOL = 6e-2
# The same at GPT-2-small's width and depth (12 layers of 768), batch 64 x
# 8-token prompts on the int8 + tail cache: the flips pass through 12
# per-tensor quantizations of 512 rows; 8.98e-2 measured (the prefill).
# Tolerance: chip_smoke.py's BF16_PATH_LOGIT_TOL for the same path card
# against CPU, which this gap between two CPU implementations witnesses.
GPT2_BF16_INT8_LOGIT_TOL = 0.15


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bf16(rng, shape, scale=1.0):
    """A random array rounded to bf16, as (jax bf16, torch f32 widened)."""
    x = jnp.asarray(rng.standard_normal(shape).astype(np.float32) * scale,
                    jnp.bfloat16)
    return x, _t(np.asarray(x.astype(jnp.float32)))


def _one_step(out, ref):
    """``out`` (the port's f32 kernel output) rounded to bf16 as the
    reference's body writes ``o_ref``, within one bf16 step of max |ref|."""
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    got = out.to(torch.bfloat16).to(torch.float32).numpy()
    err = float(np.abs(got - ref).max())
    assert err <= BF16_STEP * np.abs(ref).max(), err


# -- the rules of bf16 compute ------------------------------------------------

@pytest.mark.parametrize("m,k", [(65, 64), (256, 200), (100, 768)])
def test_int8_activation_quantization_under_bf16_is_bit_exact(m, k,
                                                              monkeypatch):
    """At M > 64 the reference quantizes a bf16 x in bf16: absmax,
    absmax / 127 and x / x_scale each rounded to bf16 (transformer.py:
    184-190). The port's xq and x_scale equal its bit for bit; quantizing
    the widened x in f32 instead gives other bytes."""
    rng = np.random.default_rng(m + k)
    jx, x = _bf16(rng, (m, k))
    w = rng.standard_normal((k, 40)).astype(np.float32) * 0.02
    jw = jtr.quantize_weights({"w": jnp.asarray(w)})["w"]
    pw = quantize_weights({"w": _t(w)})["w"]
    seen = {}

    def spy(key, real):
        def f(xq, wq, x_scale, w_scales):
            seen[key] = (np.asarray(xq), np.asarray(jnp.asarray(x_scale)
                                                   .astype(jnp.float32))
                         if key == "ref" else x_scale.float().numpy())
            return real(xq, wq, x_scale, w_scales)
        return f

    monkeypatch.setattr(jtr.gk, "matmul_int8",
                        spy("ref", jtr.gk.matmul_int8))
    monkeypatch.setattr(ptr, "matmul_int8", spy("port", ptr.matmul_int8))
    want = jtr.linear(jx, jw)
    got = ptr.linear(x.to(torch.bfloat16), pw)
    np.testing.assert_array_equal(seen["port"][0], seen["ref"][0])
    np.testing.assert_array_equal(seen["port"][1], seen["ref"][1])
    assert got.dtype == torch.bfloat16
    _one_step(got.float(), want)
    xf = x.abs().amax() / 127.0
    f32_q = torch.clamp(torch.round(x / xf), -127, 127).to(torch.int8)
    assert not np.array_equal(f32_q.numpy(), seen["port"][0])


def test_float_linear_promotes_to_f32():
    """A bf16 x against an f32 weight multiplies in f32 (the reference's
    ``matmul(x, w, preferred_element_type=f32)`` promotes), then rounds to
    bf16; a bias adds in f32 as in the reference (bf16 + f32 is f32)."""
    rng = np.random.default_rng(4)
    jx, x = _bf16(rng, (6, 96))
    w = rng.standard_normal((96, 50)).astype(np.float32)
    bias = rng.standard_normal(50).astype(np.float32)
    want = jtr.linear(jx, jnp.asarray(w))
    got = ptr.linear(x.to(torch.bfloat16), _t(w))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _one_step(got.float(), want)
    exact = (x.double() @ _t(w).double()).to(torch.bfloat16).float()
    w_bf16 = (x @ _t(w).to(torch.bfloat16).float()).to(torch.bfloat16)
    assert (got.float() - exact).abs().max() <= BF16_STEP * exact.abs().max()
    assert not torch.equal(got, w_bf16)     # the weight is not rounded
    got_b = ptr.linear(x.to(torch.bfloat16), _t(w), _t(bias))
    want_b = jtr.linear(jx, jnp.asarray(w), jnp.asarray(bias))
    assert got_b.dtype == torch.float32 and want_b.dtype == jnp.float32
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), atol=1e-5)


# -- the kernels' plain versions on bf16 inputs -------------------------------

def test_f1_plain_on_bf16_inputs():
    """F1 (flash_attention, d 128, S 128, causal) on bf16 q, k, v: the
    port's kernel takes them widened (exact) and its f32 output rounded to
    bf16 equals the reference's bf16 output within one step."""
    rng = np.random.default_rng(1)
    (jq, q), (jk, k), (jv, v) = [_bf16(rng, (2, 2, 128, 128))
                                 for _ in range(3)]
    ref = flash_attention(jq, jk, jv, causal=True)
    assert ref.dtype == jnp.bfloat16
    _one_step(at.flash_attention(q, k, v, causal=True), ref)


B, H, KVH, D, CAP = 4, 4, 2, 64, 64
LENS = np.array([1, 17, 40, CAP], np.int32)


def test_g1_plain_on_bf16_q():
    """G1 (decode_attn_grouped_int8, exact q) on a bf16 q: the reference's
    int8 K block cast to q's dtype (bf16) holds the same integers."""
    rng = np.random.default_rng(2)
    jc = JKVCache.create(B, 1, KVH, CAP, D, quantized=True)
    pre = [rng.standard_normal((B, KVH, CAP, D)).astype(np.float32)
           for _ in range(2)]
    jc = jc.append(0, jnp.asarray(pre[0]), jnp.asarray(pre[1]), position=0)
    kv, scales = port_layout(jc, 0)
    jq, q = _bf16(rng, (B, H, D))
    ref = flash_decode_grouped(jq, jc.kv[0], jnp.asarray(LENS), KVH,
                               group=2, block_k=64,
                               kv_scales=jc.quant_scales[0],
                               int8_scores=False)
    assert ref.dtype == jnp.bfloat16
    _one_step(at.decode_attn_grouped_int8(q, kv, scales, _t(LENS)), ref)


def test_k6_plain_on_bf16_q_and_cache():
    """K6 (decode_attn_float) on a bf16 q over a bf16 cache."""
    rng = np.random.default_rng(3)
    jq, q = _bf16(rng, (B, H, D))
    jkv, kv = _bf16(rng, (B, CAP, 2, KVH * D))
    ref = flash_decode_grouped(jq, jkv, jnp.asarray(LENS), KVH, group=2,
                               block_k=32)
    assert ref.dtype == jnp.bfloat16
    _one_step(at.decode_attn_float(q, kv.to(torch.bfloat16), _t(LENS)), ref)


def test_k1_plain_on_bf16_q():
    """K1 (decode_attn_int8_tail, q rounded to bf16) on a bf16 q."""
    rows = 8
    rng = np.random.default_rng(5)
    lens = [1, 17, 40, CAP - rows - 1]
    jc, pc = _prefilled(rng, lens, rows)
    jtail, tail = _bf16(rng, (B, rows, 2, KVH * D))
    jq, q = _bf16(rng, (B, H, D))
    n = np.asarray(lens, np.int32) + 3
    ref = flash_decode_flat(jq, jc.kv[0], jnp.asarray(n + 1), KVH, group=2,
                            block_k=64, kv_scales=jc.quant_scales[0],
                            tail=jtail, tail_count=4, q_bf16=True)
    assert ref.dtype == jnp.bfloat16
    kv, scales = port_layout(jc, 0)
    out = at.decode_attn_int8_tail(q, kv, scales, _t(n + 1),
                                   tail.to(torch.bfloat16), 4)
    _one_step(out, ref)


@pytest.mark.parametrize("m", [1, 16, 64])
def test_k2_k4_plain_on_bf16_x(m):
    """K2 (head_argmax_int8) and K4 (matmul_int8_wo) on a bf16 x: both
    packages' kernels round x to bf16 first, so the widened x gives the
    reference's argmax and its f32 product."""
    from rten_tpu.kernels.quant import abs_max_quantize_int8
    rng = np.random.default_rng(m)
    w = rng.standard_normal((128, 300)).astype(np.float32) * 0.02
    q, s = abs_max_quantize_int8(w, axis=0)
    jx, x = _bf16(rng, (m, 128))
    ref = jgemm.matmul_argmax_int8(jx, jnp.asarray(q), jnp.asarray(s),
                                   block_n=128)
    qp, sp = pg.pad_cols(_t(q), _t(s))
    np.testing.assert_array_equal(
        pg.head_argmax_int8(x, qp, sp, n_valid=300).numpy(), np.asarray(ref))
    ref = np.asarray(jgemm.matmul_int8_weight_only(jx, jnp.asarray(q),
                                                   jnp.asarray(s)))
    out = pg.matmul_int8_wo(x, qp, sp)[:, :300]
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


# -- bf16 compute through the model -------------------------------------------

LLAMA = dict(vocab_size=128, n_layers=2, n_heads=4, kv_heads=2, d_model=256,
             d_ff=512, max_seq_len=128)
CONFIGS = {"gpt2": lambda m, **kw: m.TransformerConfig.tiny_test(**kw),
           "llama": lambda m, **kw: m.TransformerConfig.tiny_llama(**LLAMA,
                                                                  **kw)}


@pytest.fixture(scope="module")
def bf16_models():
    """Both packages' bf16 models of each family with the reference's f32
    weights (seed 4) and its int8 tree."""
    out = {}
    for name, make in CONFIGS.items():
        jm = jtr.TransformerLM(make(jtr, dtype="bfloat16"))
        jp = jm.init_params(jax.random.PRNGKey(4))
        jq = jtr.quantize_weights(jp, "int8")
        pm = TransformerLM(make(ptr, dtype="bfloat16"))
        out[name] = (jm, pm, {"f32": jp, "int8": jq},
                     {"f32": params_from_numpy(_np_tree(jp), device="cpu"),
                      "int8": params_from_numpy(_np_tree(jq), device="cpu")})
    return out


def _caches(jm, pm, kind, b, cap):
    if kind == "paged":
        pages = b * (cap // 16)
        return (jm.new_paged_cache(b, cap, 16, pages, identity_table=True),
                pm.new_paged_cache(b, cap, 16, pages, identity_table=True,
                                   device="cpu"))
    kw = {"default": {}, "int8": dict(quantized=True),
          "int8_tail": dict(quantized=True, tail_window=16)}[kind]
    return jm.new_cache(b, cap, **kw), pm.new_cache(b, cap, device="cpu",
                                                    **kw)


@pytest.mark.parametrize("family,weights,cache", [
    ("gpt2", "f32", "default"), ("gpt2", "f32", "paged"),
    ("gpt2", "int8", "default"), ("llama", "f32", "default"),
    ("llama", "int8", "int8_tail"), ("llama", "int8", "int8"),
    ("llama", "f32", "paged")])
def test_bf16_prefill_and_decode_match_reference(bf16_models, family,
                                                 weights, cache):
    """Prefill of 4 x 24 tokens (T 96 > 64: the int8 activation
    quantization in bf16) and 3 teacher-forced decode steps under bf16
    compute, on the default cache (bf16), int8 with and without the tail
    window and a bf16 paged pool: logits against the reference's."""
    jm, pm, jps, pps = bf16_models[family]
    jp, pp = jps[weights], pps[weights]
    b, cap = 4, 64
    jc, pc = _caches(jm, pm, cache, b, cap)
    if cache in ("default", "paged"):
        assert (pc.pools if cache == "paged" else pc.kv)[0].dtype == \
            torch.bfloat16
    rng = np.random.default_rng(9)
    tokens = rng.integers(1, 128, (b, 24))
    jl, jc = jm.prefill(jp, jnp.asarray(tokens, jnp.int32), jc)
    pl, pc = pm.prefill(pp, torch.from_numpy(tokens), pc)
    tol = BF16_LOGIT_TOL if weights == "f32" else BF16_INT8_LOGIT_TOL
    worst = float(np.abs(pl.numpy() - np.asarray(jl)).max())
    tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1))
    for _ in range(3):
        jl, jc = jm.decode_step(jp, jnp.asarray(tok, jnp.int32), jc)
        pl, pc = pm.decode_step(pp, _t(tok), pc)
        assert pl.dtype == torch.float32
        worst = max(worst, float(np.abs(pl.numpy() - np.asarray(jl)).max()))
        tok = np.asarray(jnp.argmax(jl, axis=-1))
    print(f"{family} {weights} {cache}: worst logit difference {worst:.3e}")
    assert worst <= tol, worst


def test_bf16_int8_tail_gap_at_gpt2_width():
    """chip_smoke.py's path (L-bf16) on the CPU in both packages:
    GPT-2-small with int8 weights (seed 0) under bf16 compute, a prefill
    of 64 x 8 tokens on an int8 cache with the 16-token tail, then 3
    greedy decode steps: logits within GPT2_BF16_INT8_LOGIT_TOL."""
    jm = jtr.TransformerLM(jtr.TransformerConfig.gpt2(dtype="bfloat16"))
    jp = jtr.quantize_weights(jm.init_params(jax.random.PRNGKey(0)), "int8")
    pm = TransformerLM(TransformerConfig.gpt2(dtype="bfloat16"))
    pp = params_from_numpy(_np_tree(jp), device="cpu")
    tokens = np.random.RandomState(1).randint(0, 50257, (64, 8))
    jc = jm.new_cache(64, 128, quantized=True, tail_window=16)
    pc = pm.new_cache(64, 128, quantized=True, tail_window=16, device="cpu")
    jl, jc = jm.prefill(jp, jnp.asarray(tokens, jnp.int32), jc)
    pl, pc = pm.prefill(pp, torch.from_numpy(tokens), pc)
    gaps = [float(np.abs(pl.numpy() - np.asarray(jl)).max())]
    tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1))
    for _ in range(3):
        jl, jc = jm.decode_step(jp, jnp.asarray(tok, jnp.int32), jc)
        pl, pc = pm.decode_step(pp, _t(tok), pc)
        gaps.append(float(np.abs(pl.numpy() - np.asarray(jl)).max()))
        tok = np.asarray(jnp.argmax(jl, axis=-1))
    print(f"GPT-2-small int8 + tail under bf16: logit differences "
          f"(prefill, 3 decode steps) {gaps}")
    assert max(gaps) <= GPT2_BF16_INT8_LOGIT_TOL, gaps


def test_engine_bfloat16_mode():
    """tests/test_engine.py's bf16 test on the port: bf16 compute tracks
    the f32 model's logits (rtol / atol 0.05), logits stay f32, the cache
    dtype follows the compute dtype, the engine generates; and the bf16
    logits equal the reference's bf16 logits within BF16_LOGIT_TOL."""
    jm16 = jtr.TransformerLM(jtr.TransformerConfig.tiny_test(dtype="bfloat16"))
    jp = jtr.TransformerLM(jtr.TransformerConfig.tiny_test()).init_params(
        jax.random.PRNGKey(0))
    m32 = TransformerLM(TransformerConfig.tiny_test())
    m16 = TransformerLM(TransformerConfig.tiny_test(dtype="bfloat16"))
    params = params_from_numpy(_np_tree(jp), device="cpu")
    tokens = torch.tensor([[5, 9, 11]])
    l32, _ = m32.forward(params, tokens)
    l16, _ = m16.forward(params, tokens)
    assert l16.dtype == torch.float32
    np.testing.assert_allclose(l16.numpy(), l32.numpy(), rtol=0.05,
                               atol=0.05)
    ref, _ = jm16.forward(jp, jnp.asarray(tokens.numpy(), jnp.int32))
    assert float(np.abs(l16.numpy() - np.asarray(ref)).max()) \
        <= BF16_LOGIT_TOL
    cache = m16.new_cache(1, 16, device="cpu")
    assert cache.kv[0].dtype == torch.bfloat16
    assert m16.new_paged_cache(1, 16, 16, 2, device="cpu").pools[0].dtype \
        == torch.bfloat16
    assert m32.new_cache(1, 16, device="cpu").kv[0].dtype == torch.float32
    eng = ServingEngine(m16, params, max_batch=1, capacity=32,
                        prefill_buckets=(8,), device="cpu")
    outs = eng.generate([[5, 9, 11]], max_new_tokens=4)
    assert len(outs[0]) == 4
    jeng = JServingEngine(jm16, jp, max_batch=1, capacity=32,
                          prefill_buckets=(8,))
    assert outs == jeng.generate([[5, 9, 11]], max_new_tokens=4)


# -- scan_layers --------------------------------------------------------------

@pytest.fixture(scope="module")
def scan_models():
    """3-layer tiny_test models, loop and scan, in both packages with the
    reference's weights (seed 0)."""
    cfgs = (dict(n_layers=3), dict(n_layers=3, scan_layers=True))
    jms = [jtr.TransformerLM(jtr.TransformerConfig.tiny_test(**c))
           for c in cfgs]
    pms = [TransformerLM(TransformerConfig.tiny_test(**c)) for c in cfgs]
    jp = jms[0].init_params(jax.random.PRNGKey(0))
    return jms, pms, jp, params_from_numpy(_np_tree(jp), device="cpu")


def test_scan_layers_matches_loop(scan_models):
    """tests/test_engine.py's scan test on the port, held tighter: the
    scan path walks the same layers over a stacked cache, so forward,
    prefill and a decode step equal the loop's exactly; each also matches
    the reference's scan within 1e-5."""
    (jl_, js), (m_loop, m_scan), jp, params = scan_models
    tokens = torch.tensor([[3, 7, 11, 2]])
    jt = jnp.asarray(tokens.numpy(), jnp.int32)
    l1, _ = m_loop.forward(params, tokens)
    l2, _ = m_scan.forward(params, tokens)
    assert torch.equal(l1, l2)
    np.testing.assert_allclose(l2.numpy(), np.asarray(js.forward(jp, jt)[0]),
                               atol=1e-5)
    c_loop = m_loop.new_cache(1, 16, device="cpu")
    c_scan = m_scan.new_cache(1, 16, device="cpu")
    assert c_scan.stacked and not c_loop.stacked
    assert c_scan.kv.shape == (3, 1, 16, 2, 64)
    p1, c_loop = m_loop.prefill(params, tokens, c_loop)
    p2, c_scan = m_scan.prefill(params, tokens, c_scan)
    assert torch.equal(p1, p2)
    jc = js.new_cache(1, 16)
    jpre, jc = js.prefill(jp, jt, jc)
    np.testing.assert_allclose(p2.numpy(), np.asarray(jpre), atol=1e-5)
    for layer in range(3):
        assert torch.equal(c_scan.kv[layer], c_loop.kv[layer])
    nxt = torch.argmax(p1[:, -1], -1)
    d1, _ = m_loop.decode_step(params, nxt, c_loop)
    d2, _ = m_scan.decode_step(params, nxt, c_scan)
    assert torch.equal(d1, d2)
    jd, _ = js.decode_step(jp, jnp.asarray(nxt.numpy(), jnp.int32), jc)
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd), atol=1e-5)


@pytest.mark.parametrize("weights", ["f32", "int8"])
def test_stacked_params_match_the_layer_list(scan_models, weights):
    """stack_layer_params stacks every leaf (a QuantWeight's data and
    scales) on a leading layer axis; the scan model walks the stacks to the
    list's logits exactly."""
    _, (m_loop, m_scan), _, params = scan_models
    if weights == "int8":
        params = quantize_weights(params, "int8")
    stacked = {**params, "layers": stack_layer_params(params["layers"])}
    w = stacked["layers"]["wqkv"]
    assert (w.data if weights == "int8" else w).shape[0] == 3
    tokens = torch.tensor([[3, 7, 11, 2], [1, 2, 3, 4]])
    want, _ = m_loop.forward(params, tokens)
    got, cache = m_scan.forward(stacked, tokens,
                                m_scan.new_cache(2, 8, device="cpu"))
    assert torch.equal(got, want)


def test_stacked_cache_rules(scan_models, monkeypatch):
    """A stacked cache is float only (the reference asserts; the port
    raises ValueError); a scan model refuses an unstacked cache, as the
    reference does; a stacked decode step appends through the float
    append (K5) and never fuses the append (the reference's fused-append
    rule excludes stacked caches)."""
    jms, (m_loop, m_scan), jp, params = scan_models
    with pytest.raises(ValueError, match="stacked"):
        KVCache.create(1, 2, 1, 8, 4, quantized=True, stacked=True,
                       device="cpu")
    with pytest.raises(AssertionError):
        JKVCache.create(1, 2, 1, 8, 4, quantized=True, stacked=True)
    tokens = torch.tensor([[3, 7]])
    with pytest.raises(ValueError, match="stacked KV cache"):
        m_scan.forward(params, tokens, m_loop.new_cache(1, 8, device="cpu"))
    with pytest.raises(ValueError, match="stacked KV cache"):
        jms[1].forward(jp, jnp.asarray(tokens.numpy(), jnp.int32),
                       jms[0].new_cache(1, 8))
    cfg = TransformerConfig.tiny_test(n_layers=3, scan_layers=True,
                                      fused_append=True, n_heads=2,
                                      d_model=128)
    cache = TransformerLM(cfg).new_cache(4, 64, device="cpu")
    assert not ptr._fused_append_takes(cfg, cache, 4, 1, False)
    unstacked = TransformerLM(cfg).new_cache(4, 64, device="cpu")
    unstacked = KVCache(list(unstacked.kv), unstacked.lengths, None, 2, 64)
    assert ptr._fused_append_takes(cfg, unstacked, 4, 1, False)
    calls = []
    real = ptr.KVCache.append

    def spy(self, layer, k, v, position=None):
        calls.append((self.stacked, position))
        return real(self, layer, k, v, position)
    monkeypatch.setattr(ptr.KVCache, "append", spy)
    c = m_scan.new_cache(1, 8, device="cpu")
    _, c = m_scan.prefill(params, tokens, c)
    m_scan.decode_step(params, torch.tensor([5]), c)
    assert calls == [(True, 0)] * 3 + [(True, None)] * 3


def test_engine_with_scan_layers(scan_models):
    """tests/test_engine.py's scan engine test on the port: greedy tokens
    equal the loop model's sequential greedy, and the reference's scan
    engine's; ``cache="auto"`` resolves a scan model to a stacked bf16
    cache, as the reference's engine does, and serves the same tokens as
    the reference's."""
    jms, (m_loop, m_scan), jp, params = scan_models
    kw = dict(max_batch=2, capacity=64, prefill_buckets=(16,))
    prompts = [[1, 2, 3], [9, 4]]
    eng = ServingEngine(m_scan, params, device="cpu", **kw)
    assert eng.cache.stacked
    outs = eng.generate(prompts, max_new_tokens=5)
    for prompt, out in zip(prompts, outs):
        toks = list(prompt)
        for _ in range(5):
            logits, _ = m_loop.forward(params, torch.tensor([toks]))
            toks.append(int(torch.argmax(logits[0, -1])))
        assert out == toks[len(prompt):]
    assert outs == JServingEngine(jms[1], jp, **kw).generate(
        prompts, max_new_tokens=5)
    auto = ServingEngine(m_scan, params, device="cpu", cache="auto", **kw)
    assert auto.cache.stacked and auto.cache.kv.dtype == torch.bfloat16
    jauto = JServingEngine(jms[1], jp, cache="auto", **kw)
    assert jauto.cache.stacked and jauto.cache.kv.dtype == jnp.bfloat16
    assert auto.generate(prompts, max_new_tokens=5) == jauto.generate(
        prompts, max_new_tokens=5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_float_pools_pass_their_dtype_to_the_kernels(monkeypatch,
                                                           dtype):
    """On CUDA (simulated) P3, its grid mode and P1 take an f32 or a bf16
    pool (bf16 compute's) and pass its dtype to their C entries (the bf16
    flag after mask_unmapped, and before P1's instance)."""
    from test_torch_kernel_plans import _recorded
    from rten_tpu_torch.kernels import cache as kc
    calls = _recorded(monkeypatch)
    b, h, kvh, d, page, max_pages = 2, 4, 2, 64, 8, 4
    pool = torch.zeros((b * max_pages + 1, page, 2, kvh * d), dtype=dtype)
    table = torch.arange(1, b * max_pages + 1, dtype=torch.int32).reshape(
        b, max_pages)
    lengths = torch.full((b,), 5, dtype=torch.int32)
    q = torch.zeros((b, h, d))
    at.decode_attn_paged(q, pool, table, lengths)
    at.decode_attn_paged_grid(q, pool, table, lengths)
    k = torch.zeros((b, kvh, 1, d))
    kc.kv_append_paged(pool, k, k, table, lengths)
    flag = int(dtype == torch.bfloat16)
    assert [c[0] for c in calls] == ["decode_attn_paged"] * 2 + [
        "kv_append_paged"]
    assert [c[1][11:13] for c in calls[:2]] == [(0, flag), (1, flag)]
    assert calls[2][1][7:14] == (b, page, max_pages, kvh, d, flag, 1)
