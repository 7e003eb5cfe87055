"""The port's Mixture-of-Experts block (``rten_tpu_torch/models/moe.py``) and
the Mixtral-class model (``TransformerConfig.tiny_moe()`` widths) on the CPU
against the JAX package (``rten_tpu/models/moe.py``, CPU backend), on the
same weights carried across by ``params_from_numpy``: ``tests/test_moe.py``
one for one (routing, dense against ragged for both activations, a
per-token loop reference, prefill against decode, int8 experts, the serving
engine; its two mesh tests wait for ``parallel/``), each test also held
against the reference's ``moe_mlp`` or ``TransformerLM.forward``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rten_tpu.generate.engine import ServingEngine as JServingEngine
from rten_tpu.models import moe as jmoe
from rten_tpu.models import transformer as jtr
from rten_tpu_torch.generate import ServingEngine
from rten_tpu_torch.models import (QuantWeight, TransformerConfig,
                                   TransformerLM, params_from_numpy,
                                   quantize_weights)
from rten_tpu_torch.models import moe as pmoe

rng = np.random.RandomState(7)

# f32 experts: the same f32 products, sums in other orders (|y| ~ 1 on
# the models; up to ~30 on _moe_layer's stacks, hence a relative bound for
# moe_mlp: 7e-7 of max |y| observed).
F32_TOL = 1e-5
F32_REL = 4e-6
# Outputs in bf16 (bf16 compute): one step of bf16 at the largest |y|
# (2^-8 relative), where an f32 sum in another order flips a rounding.
BF16_REL = 2.0 ** -7
# Whole-model logits (|logits| ~ 0.6): f32 3e-6 observed, bf16 one or two
# steps of bf16 at 0.5-1 (2^-8 each): the hidden state is bf16 and its
# flips carry into the head.
MODEL_TOL = {"float32": 1e-5, "bfloat16": 8e-3}


def _moe_layer(d=16, f=24, e=4, act="swiglu", seed=0):
    """tests/test_moe.py's layer, as numpy."""
    r = np.random.RandomState(seed)
    layer = {"router": r.randn(d, e).astype(np.float32),
             "w_up": r.randn(e, d, f).astype(np.float32) * 0.3,
             "w_down": r.randn(e, f, d).astype(np.float32) * 0.3}
    if act == "swiglu":
        layer["w_gate"] = r.randn(e, d, f).astype(np.float32) * 0.3
    else:
        layer["b_up"] = r.randn(e, f).astype(np.float32) * 0.1
        layer["b_down"] = r.randn(e, d).astype(np.float32) * 0.1
    return layer


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch(tree):
    return params_from_numpy(tree, device="cpu")


def _close(got, want, dtype):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    tol = (F32_REL if dtype == "float32" else BF16_REL) * float(
        np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol, (err, tol)


# -- routing ------------------------------------------------------------------

def test_route_topk_matches_hf_convention():
    """Softmax over all experts, top 2, renormalized: the HF convention
    (torch.topk on the CPU) and the reference's route_topk."""
    logits = rng.randn(10, 6).astype(np.float32)
    w, idx = pmoe.route_topk(torch.from_numpy(logits), 2)
    tw = torch.softmax(torch.tensor(logits), dim=-1)
    tw, tidx = torch.topk(tw, 2, dim=-1)
    tw = tw / tw.sum(-1, keepdim=True)
    np.testing.assert_array_equal(idx.numpy(), tidx.numpy())
    np.testing.assert_allclose(w.numpy(), tw.numpy(), rtol=1e-6)
    jw, jidx = jmoe.route_topk(jnp.asarray(logits), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert idx.dtype == torch.int32
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_route_topk_ties_go_to_the_lowest_index(k):
    """Equal probabilities rank by ascending expert index, as lax.top_k
    orders them: rows of equal logits, and rows with planted ties below
    and at the k-th place."""
    logits = np.zeros((4, 6), np.float32)
    logits[1] = [0.5, 1.0, 1.0, 0.5, 1.0, 0.0]
    logits[2] = [2.0, 0.0, 1.0, 1.0, 1.0, 1.0]
    logits[3] = [-1.0, 3.0, -1.0, 3.0, -1.0, 3.0]
    w, idx = pmoe.route_topk(torch.from_numpy(logits), k)
    jw, jidx = jmoe.route_topk(jnp.asarray(logits), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6)


def test_combine_matrix_matches_reference():
    idx = rng.randint(0, 5, (7, 2)).astype(np.int32)
    w = rng.rand(7, 2).astype(np.float32)
    got = pmoe.combine_matrix(torch.from_numpy(idx), torch.from_numpy(w), 5)
    want = jmoe.combine_matrix(jnp.asarray(idx), jnp.asarray(w), 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the two paths ------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_dense_vs_ragged_parity(act, dtype):
    """The dense and the ragged path agree (T 33, 4 experts, top 2), and
    each equals the reference's same path: float stacks rounded to the
    compute dtype, every product with an f32 result."""
    d, f, e, k, t = 16, 24, 4, 2, 33
    layer = _moe_layer(d, f, e, act)
    x2 = rng.randn(t, d).astype(np.float32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = getattr(torch, dtype)
    jl, tl = _jax(layer), _torch(layer)
    jw, jidx = jmoe.route_topk(jnp.asarray(x2) @ jl["router"], k)
    w, idx = pmoe.route_topk(torch.from_numpy(x2) @ tl["router"], k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    dense = pmoe._moe_dense(torch.from_numpy(x2),
                            pmoe.combine_matrix(idx, w, e), tl, act, tdt)
    ragged = pmoe._moe_ragged(torch.from_numpy(x2), w, idx, tl, act, e, tdt)
    assert dense.dtype == ragged.dtype == torch.float32
    np.testing.assert_allclose(dense.numpy(), ragged.numpy(), rtol=1e-4,
                               atol=1e-5)
    jdense = jmoe._moe_dense(jnp.asarray(x2),
                             jmoe.combine_matrix(jidx, jw, e), jl, act, jdt)
    jragged = jmoe._moe_ragged(jnp.asarray(x2), jw, jidx, jl, act, e, jdt)
    # f32 results of bf16-valued operands: f32 sums in other orders.
    np.testing.assert_allclose(dense.numpy(), np.asarray(jdense), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(ragged.numpy(), np.asarray(jragged),
                               rtol=1e-4, atol=1e-5)


def test_moe_vs_loop_reference():
    """moe_mlp against a per-token loop over the selected experts (numpy),
    and against the reference's moe_mlp."""
    d, f, e, k, t = 8, 12, 4, 2, 9
    layer = _moe_layer(d, f, e, "swiglu", seed=3)
    x2 = rng.randn(t, d).astype(np.float32)
    cfg = TransformerConfig.tiny_moe(d_model=d, d_ff=f, n_experts=e,
                                     experts_per_token=k)
    got = pmoe.moe_mlp(torch.from_numpy(x2), _torch(layer), cfg).numpy()

    logits = x2 @ layer["router"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    want = np.zeros_like(x2)
    for i in range(t):
        top = np.argsort(-probs[i], kind="stable")[:k]
        w = probs[i][top] / probs[i][top].sum()
        for we, ei in zip(w, top):
            g = x2[i] @ layer["w_gate"][ei]
            h = g / (1 + np.exp(-g)) * (x2[i] @ layer["w_up"][ei])
            want[i] += we * (h @ layer["w_down"][ei])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    jcfg = jtr.TransformerConfig.tiny_moe(d_model=d, d_ff=f, n_experts=e,
                                          experts_per_token=k)
    ref = jmoe.moe_mlp(jnp.asarray(x2), _jax(layer), jcfg)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("t", [9, 65])
@pytest.mark.parametrize("impl", ["auto", "dense", "ragged"])
@pytest.mark.parametrize("experts", ["float", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_mlp_matches_reference(dtype, experts, impl, t):
    """moe_mlp at tiny_moe's widths against the reference's: both
    activations' dtypes, float and int8 expert stacks, every impl, T on
    both sides of the auto rule's 64; the path it took (impl_counts) is
    the reference's rule: ragged only for float stacks with "ragged", or
    "auto" above 64 tokens."""
    kw = dict(dtype=dtype, moe_impl=impl)
    cfg, jcfg = (TransformerConfig.tiny_moe(**kw),
                 jtr.TransformerConfig.tiny_moe(**kw))
    layer = _moe_layer(cfg.d_model, cfg.d_ff, cfg.n_experts, seed=5)
    if experts == "int8":
        jlayer = jtr.quantize_weights(_jax(layer), "int8")
    else:
        jlayer = _jax(layer)
    tlayer = _torch(_np_tree(jlayer))
    x = rng.randn(t, cfg.d_model).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16"
                               else jnp.float32)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    pmoe.impl_counts.clear()
    got = pmoe.moe_mlp(tx, tlayer, cfg)
    ragged = experts == "float" and (impl == "ragged"
                                     or (impl == "auto" and t > 64))
    assert dict(pmoe.impl_counts) == {"ragged" if ragged else "dense": 1}
    want = jmoe.moe_mlp(jx, jlayer, jcfg)
    assert got.dtype == getattr(torch, dtype) and got.shape == tx.shape
    _close(got.to(torch.float32).numpy(), want, dtype)


# -- the model ----------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_moe():
    """The JAX and port tiny_moe models with the reference's weights (seed
    0), f32 and int8 (quantized by the reference), carried across."""
    jm = jtr.TransformerLM(jtr.TransformerConfig.tiny_moe())
    jp = jm.init_params(jax.random.PRNGKey(0))
    jq = jtr.quantize_weights(jp, "int8")
    return jm, jp, jq, {"f32": _torch(_np_tree(jp)),
                        "int8": _torch(_np_tree(jq))}


def test_init_params_equals_reference(tiny_moe):
    """init_params draws router and expert stacks in the reference's numpy
    order: seed 0 gives its tree, key for key and value for value."""
    _, jp, _, pps = tiny_moe
    got = TransformerLM(TransformerConfig.tiny_moe()).init_params(
        0, device="cpu")
    assert got.keys() == pps["f32"].keys()
    for a, b in zip(got["layers"], pps["f32"]["layers"]):
        assert a.keys() == b.keys()
        assert a["w_up"].shape == (4, 64, 96) and a["router"].shape == (64, 4)
        for key in a:
            assert torch.equal(a[key], b[key]), key
    for key in ("embed", "lm_head", "ln_f_scale"):
        assert torch.equal(got[key], pps["f32"][key])


def test_gelu_experts_init_params_equals_reference():
    """The GELU branch (biased stacks) of the expert draw."""
    kw = dict(act="gelu", norm="layernorm", pos="learned", n_layers=1)
    jp = jtr.TransformerLM(jtr.TransformerConfig.tiny_moe(**kw)).init_params(
        jax.random.PRNGKey(2))
    got = TransformerLM(TransformerConfig.tiny_moe(**kw)).init_params(
        2, device="cpu")
    want = _torch(_np_tree(jp))
    for key in want["layers"][0]:
        assert torch.equal(got["layers"][0][key], want["layers"][0][key]), key


@pytest.mark.parametrize("impl", ["auto", "ragged"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_forward_matches_reference(tiny_moe, dtype, impl):
    """The whole tiny_moe model's logits against the reference's, f32 and
    bf16 compute; prefill of 2 x 40 tokens (T 80 > 64: "auto" takes the
    ragged path)."""
    _, jp, _, pps = tiny_moe
    kw = dict(dtype=dtype, moe_impl=impl)
    jm = jtr.TransformerLM(jtr.TransformerConfig.tiny_moe(**kw))
    pm = TransformerLM(TransformerConfig.tiny_moe(**kw))
    ids = rng.randint(0, 128, (2, 40))
    want, _ = jm.forward(jp, jnp.asarray(ids, jnp.int32))
    pmoe.impl_counts.clear()
    got, _ = pm.forward(pps["f32"], torch.from_numpy(ids))
    assert pmoe.impl_counts == {"ragged": 2}
    assert got.dtype == torch.float32
    err = float(np.abs(got.numpy() - np.asarray(want)).max())
    assert err <= MODEL_TOL[dtype], err


def test_moe_prefill_decode_consistency(tiny_moe):
    """Cached prefill + decode steps match the uncached full forward (as
    tests/test_moe.py), and each step matches the reference's."""
    jm, jp, _, pps = tiny_moe
    pm = TransformerLM(TransformerConfig.tiny_moe())
    params = pps["f32"]
    ids = rng.randint(0, 128, (2, 12)).astype(np.int64)
    full, _ = pm.forward(params, torch.from_numpy(ids))
    cache = pm.new_cache(2, capacity=32, device="cpu")
    jcache = jm.new_cache(2, capacity=32)
    logits, cache = pm.prefill(params, torch.from_numpy(ids[:, :8]), cache)
    jlogits, jcache = jm.prefill(jp, jnp.asarray(ids[:, :8], jnp.int32),
                                 jcache)
    np.testing.assert_allclose(logits.numpy(), full[:, :8].numpy(),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=F32_TOL)
    for s in range(8, 12):
        step, cache = pm.decode_step(params, torch.from_numpy(ids[:, s]),
                                     cache)
        jstep, jcache = jm.decode_step(jp, jnp.asarray(ids[:, s], jnp.int32),
                                       jcache)
        np.testing.assert_allclose(step.numpy(), full[:, s].numpy(),
                                   rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(step.numpy(), np.asarray(jstep),
                                   atol=F32_TOL)


def test_quantized_experts(tiny_moe):
    """quantize_weights: expert stacks int8 per expert and output channel
    (data [E, K, N], scales [E, N]) bit for bit as the reference's, the
    router float; the int8 model's logits near the f32 model's (as
    tests/test_moe.py) and equal to the reference's int8 model's."""
    jm, jp, jq, pps = tiny_moe
    cfg = TransformerConfig.tiny_moe()
    pm = TransformerLM(cfg)
    got_q = quantize_weights(pps["f32"], "int8")
    l0, jl0 = got_q["layers"][0], jq["layers"][0]
    for key in ("w_gate", "w_up", "w_down"):
        assert isinstance(l0[key], QuantWeight) and l0[key].kind == "int8"
        assert l0[key].data.shape == np.asarray(jl0[key].data).shape
        np.testing.assert_array_equal(l0[key].data.numpy(),
                                      np.asarray(jl0[key].data))
        np.testing.assert_array_equal(l0[key].scales.numpy(),
                                      np.asarray(jl0[key].scales))
        assert l0[key].n == jl0[key].n
    assert l0["w_up"].data.shape == (4, cfg.d_model, cfg.d_ff)
    assert not isinstance(l0["router"], QuantWeight)
    ids = rng.randint(0, 128, (2, 8))
    want, _ = pm.forward(pps["f32"], torch.from_numpy(ids))
    got, _ = pm.forward(got_q, torch.from_numpy(ids))
    assert float((got - want).abs().max()) < 0.15
    ref, _ = jm.forward(jq, jnp.asarray(ids, jnp.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=F32_TOL)


def test_int4_leaves_expert_stacks_float(tiny_moe):
    """int4 quantizes the attention linears and leaves expert stacks (and
    the router) float, as the reference does."""
    _, jp, _, pps = tiny_moe
    got = quantize_weights(pps["f32"], "int4")["layers"][0]
    want = jtr.quantize_weights(jp, "int4")["layers"][0]
    assert isinstance(got["wqkv"], QuantWeight)
    for key in ("w_gate", "w_up", "w_down", "router"):
        assert isinstance(got[key], torch.Tensor)
        assert not isinstance(want[key], jtr.QuantWeight)
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


def test_init_int8_params_quantizes_every_stack():
    """The card's draw for MoE: every projection, the head and each
    expert stack int8, the router f32, shapes as the reference's
    quantize_weights gives them; int4 refuses expert stacks (they would
    stay float)."""
    cfg = TransformerConfig.tiny_moe(n_layers=1)
    params = TransformerLM(cfg).init_int8_params(0, device="cpu")
    layer = params["layers"][0]
    for key, shape in (("w_gate", (4, 64, 96)), ("w_up", (4, 64, 96)),
                       ("w_down", (4, 96, 64))):
        w = layer[key]
        assert w.kind == "int8" and w.data.shape == shape
        assert w.scales.shape == (4, shape[2]) and w.n == shape[2]
    assert layer["router"].dtype == torch.float32
    assert params["lm_head"].kind == "int8" and layer["wqkv"].kind == "int8"
    logits, _ = TransformerLM(cfg).forward(
        params, torch.zeros((1, 4), dtype=torch.int64))
    assert torch.isfinite(logits).all()
    with pytest.raises(ValueError, match="float"):
        TransformerLM(cfg).init_int4_params(0, device="cpu")


# -- serving ------------------------------------------------------------------

@pytest.mark.parametrize("weights", ["f32", "int8"])
def test_moe_serving_engine(tiny_moe, weights):
    """The continuous-batching engine drives the MoE model end to end: the
    port's greedy tokens equal the sequential greedy reference of the
    port's own forward (as tests/test_moe.py) and the reference engine's
    tokens on the same weights (int8: experts through the dense path)."""
    jm, jp, jq, pps = tiny_moe
    pm = TransformerLM(TransformerConfig.tiny_moe())
    params = pps[weights]
    kw = dict(max_batch=2, capacity=64, prefill_buckets=(16,))
    prompts = [[1, 2, 3], [4, 5, 6, 7]]
    outs = ServingEngine(pm, params, device="cpu", **kw).generate(
        prompts, max_new_tokens=5)
    if weights == "f32":
        for prompt, out in zip(prompts, outs):
            toks = list(prompt)
            for _ in range(5):
                logits, _ = pm.forward(params, torch.tensor([toks]))
                toks.append(int(torch.argmax(logits[0, -1])))
            assert out == toks[len(prompt):]
    ref = JServingEngine(jm, {"f32": jp, "int8": jq}[weights], **kw)
    assert outs == ref.generate(prompts, max_new_tokens=5)
