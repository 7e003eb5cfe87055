"""Parity of the port's Llama family (RoPE, RMSNorm, SwiGLU, grouped-query
attention, untied head) with group-wise int4 weights (``rten_tpu_torch`` on
the CPU, where the kernels' plain versions run) against the JAX package
(CPU backend, Pallas in interpret mode), on the same weights and inputs:
the model, the int4 records, the int8 + tail cache with GQA, and the
serving engine."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rten_tpu.generate.engine import ServingEngine as JServingEngine
from rten_tpu.models import transformer as jtr
from rten_tpu_torch.generate import ServingEngine
from rten_tpu_torch.models import (QuantWeight, TransformerConfig,
                                   TransformerLM, params_from_numpy,
                                   quantize_weights)
from rten_tpu_torch.models import transformer as ptr

# A small TinyLlama: 4 query heads over 2 KV heads of 64, so the cache rows
# are 128 lanes wide and the int8 cache takes the tail window, as
# TinyLlama's 4 KV heads of 64 do.
CFG = dict(vocab_size=256, n_layers=2, n_heads=4, kv_heads=2, d_model=256,
           d_ff=512, max_seq_len=128)
# f32 weights: the same f32 arithmetic in both packages, sums in other
# orders (|logits| ~ 1).
F32_LOGIT_TOL = 1e-4
# int4 weights, teacher-forced. Fed the reference's own input, each linear
# of the port agrees with the reference's to LINEAR_REL_TOL
# (test_int4_linears_agree_on_the_references_inputs); the logits part only
# where f32 sums in other orders flip a bf16 rounding of an activation. The
# word layout's formula does not cancel such a flip: it moves every output
# of the row the same way, by 2^-8 |x| bf16(u s) with u = q + 8 >= 0 (RMS
# about 8.4, against |q| about 2.6 in the byte layout), and each RMSNorm
# (residual rms ~0.03) magnifies it, so every later linear's input holds
# more flips. Measured on this model's prefill (the tests below print
# it): bf16 flips at the second layer's w_gate input, 77% of the elements
# for words against 6% for bytes; logits apart by 0.030 (words), 0.013
# (words, int8 dot) and 0.0026 (bytes). Tolerance: twice the words gap,
# four times the bytes gap.
INT4_LOGIT_TOL = {"words": 0.06, "words_int8": 0.06, "bytes": 1e-2}
# One linear on identical inputs: the same formula, f32 sums in other
# orders over K <= 512 terms, far below one bf16 step (2^-8).
LINEAR_REL_TOL = 2.0 ** -16
# Decode at M <= 64 on this width takes the dequantized bf16 dot in both
# packages (no offset term), so a flip moves an output by 2^-8 |x q s|
# only, as with int8 weights (tests/test_torch_model.py:LOGIT_TOL).
DECODE_LOGIT_TOL = 1e-2
KERNEL_OF = {"words": "matmul_int4_words",
             "words_int8": "matmul_int4_words_int8", "bytes": "matmul_int4"}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree, prefix=""):
    """{path: array} over dicts and lists; quantized records as their
    data, scales, group and n."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}/{i}"))
        return out
    if hasattr(tree, "scales"):
        leaves = {f"{prefix}.kind": np.asarray(tree.kind),
                  f"{prefix}.n": np.asarray(tree.n)}
        if tree.kind == "int8":       # the port pads int8 columns to 8
            return {**leaves, f"{prefix}.data": np.asarray(
                tree.data)[:, :tree.n], f"{prefix}.scales": np.asarray(
                tree.scales)[:tree.n]}
        return {**leaves, f"{prefix}.data": np.asarray(tree.data),
                f"{prefix}.scales": np.asarray(tree.scales),
                f"{prefix}.group": np.asarray(tree.group)}
    return {prefix: np.asarray(tree)}


def _assert_trees_equal(out, ref):
    out, ref = _leaves(out), _leaves(ref)
    assert out.keys() == ref.keys()
    for k in ref:
        assert out[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)


@pytest.fixture(scope="module")
def models():
    """The JAX and port Llama models with the same f32 weights (seed 3) and
    the int4 trees quantized from them by the reference (words and bytes),
    carried across by params_from_numpy."""
    jm = jtr.TransformerLM(jtr.TransformerConfig.tiny_llama(**CFG))
    jp = jm.init_params(jax.random.PRNGKey(3))
    pm = TransformerLM(TransformerConfig.tiny_llama(**CFG))
    jps = {"f32": jp,
           "words": jtr.quantize_weights(jp, "int4"),
           "bytes": jtr.quantize_weights(jp, "int4", int4_packing="bytes")}
    jps["words_int8"] = jps["words"]
    pps = {k: params_from_numpy(_np_tree(v), device="cpu")
           for k, v in jps.items()}
    return jm, pm, jps, pps


def _dot_mode(monkeypatch, weights):
    """RTEN_INT4_DOT for both packages, as the reference reads it."""
    if weights == "words_int8":
        monkeypatch.setenv("RTEN_INT4_DOT", "int8")
    else:
        monkeypatch.delenv("RTEN_INT4_DOT", raising=False)


def _spy_kernels(monkeypatch):
    """Count the int4 kernel wrappers that the port's linear reaches."""
    calls = {name: 0 for name in KERNEL_OF.values()}
    for name in calls:
        real = getattr(ptr, name)

        def spy(*a, _real=real, _name=name):
            calls[_name] += 1
            return _real(*a)
        monkeypatch.setattr(ptr, name, spy)
    return calls


# -- weights ------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_init_params_equals_reference(seed):
    """The Llama branches of init_params draw the reference's numpy
    default_rng(seed) stream in its order (no pos_embed or biases, the
    untied lm_head after embed, per layer wqkv, wo, w_gate, w_up, w_down):
    the same keys and values."""
    jm = jtr.TransformerLM(jtr.TransformerConfig.tiny_llama(**CFG))
    pm = TransformerLM(TransformerConfig.tiny_llama(**CFG))
    _assert_trees_equal(pm.init_params(seed, device="cpu"),
                        jm.init_params(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("packing", ["words", "bytes"])
def test_int4_records_equal_reference(models, packing):
    """quantize_weights(..., "int4") gives the reference's records bit for
    bit (int32 words [K/4, N/2] or uint8 bytes [K, N/2], f32 scales
    [K/128, N], group, logical n), the untied head int4 too;
    params_from_numpy carries the reference's tree to the same records."""
    jm, pm, jps, pps = models
    mine = quantize_weights(pm.init_params(3, device="cpu"), "int4",
                            int4_packing=packing)
    head = mine["lm_head"]
    assert isinstance(head, QuantWeight) and head.kind == "int4"
    assert head.data.dtype == (torch.int32 if packing == "words"
                               else torch.uint8)
    _assert_trees_equal(mine, jps[packing])
    _assert_trees_equal(pps[packing], jps[packing])


def test_tied_model_keeps_an_int8_head_under_int4():
    """A tied model's separate lm_head stays int8 per channel under int4
    weights (transformer.py:291-295); its other linears are int4."""
    cfg = dict(n_heads=2, d_model=128, vocab_size=300)
    jm = jtr.TransformerLM(jtr.TransformerConfig.tiny_test(**cfg))
    ref = jtr.quantize_weights(jm.init_params(jax.random.PRNGKey(1)), "int4")
    pm = TransformerLM(TransformerConfig.tiny_test(**cfg))
    mine = quantize_weights(pm.init_params(1, device="cpu"), "int4")
    assert mine["lm_head"].kind == "int8"
    assert mine["layers"][0]["wqkv"].kind == "int4"
    _assert_trees_equal(mine, ref)


# -- the model ----------------------------------------------------------------

def test_f32_logits_match_reference(models):
    """f32 weights: a cacheless forward, then prefill and decode on an f32
    cache with slots at ragged depths, so RoPE runs at positions past each
    prompt; every step's logits within F32_LOGIT_TOL."""
    jm, pm, jps, pps = models
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 256, (3, 9))
    jl, _ = jm.forward(jps["f32"], jnp.asarray(tokens, jnp.int32))
    pl, _ = pm.forward(pps["f32"], torch.from_numpy(tokens))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=0,
                               atol=F32_LOGIT_TOL)
    jc, pc = jm.new_cache(3, 32), pm.new_cache(3, 32, device="cpu")
    _, jc = jm.prefill(jps["f32"], jnp.asarray(tokens, jnp.int32), jc)
    _, pc = pm.prefill(pps["f32"], torch.from_numpy(tokens), pc)
    lens = np.array([9, 4, 1], np.int32)
    jc, pc = jc.with_lengths(jnp.asarray(lens)), pc.with_lengths(lens)
    tok = rng.integers(0, 256, 3)
    for _ in range(6):
        jl, jc = jm.decode_step(jps["f32"], jnp.asarray(tok, jnp.int32), jc)
        pl, pc = pm.decode_step(pps["f32"], torch.tensor(tok), pc)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=0,
                                   atol=F32_LOGIT_TOL)
        tok = np.asarray(jnp.argmax(jl, axis=-1))


def test_rope_positions_are_unclamped():
    """Decode positions are the cache lengths, unclamped: a slot past
    max_seq_len rotates by its own position (the learned-position clamp
    applies to the GPT-2 gather only), as the reference's _rope does."""
    pos = torch.tensor([[5], [300]])
    cos, sin = ptr._rope_tables(pos, 64, 1e4)
    x = np.random.default_rng(0).standard_normal((2, 4, 1, 64)).astype(
        np.float32)
    ref = np.asarray(jtr._rope(jnp.asarray(x), jnp.asarray(pos.numpy()),
                               1e4))
    np.testing.assert_allclose(ptr._rope(torch.from_numpy(x), cos,
                                         sin).numpy(), ref, rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("weights", ["words", "words_int8", "bytes"])
def test_int4_forward_matches_reference(models, weights, monkeypatch):
    """int4 weights in both packings and both dot modes: a prefill of
    8 x 12 tokens (M = 96 > 64) takes the layout's kernel wrapper for every
    linear and the head, as the reference takes its Pallas kernel; decode
    steps (M = 8) stay on the dequantized bf16 dot at this width. Logits of
    both within INT4_LOGIT_TOL of the reference's."""
    jm, pm, jps, pps = models
    _dot_mode(monkeypatch, weights)
    calls = _spy_kernels(monkeypatch)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 256, (8, 12))
    jc, pc = jm.new_cache(8, 32), pm.new_cache(8, 32, device="cpu")
    jl, jc = jm.prefill(jps[weights], jnp.asarray(tokens, jnp.int32), jc)
    pl, pc = pm.prefill(pps[weights], torch.from_numpy(tokens), pc)
    n_linears = 5 * CFG["n_layers"] + 1
    assert calls == {name: n_linears * (name == KERNEL_OF[weights])
                     for name in calls}
    worst = float(np.abs(pl.numpy() - np.asarray(jl)).max())
    jc, pc = jc.with_lengths(jnp.full(8, 12)), pc.with_lengths([12] * 8)
    tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1))
    for _ in range(3):
        jl, jc = jm.decode_step(jps[weights], jnp.asarray(tok, jnp.int32), jc)
        pl, pc = pm.decode_step(pps[weights], torch.tensor(tok), pc)
        worst = max(worst, float(np.abs(pl.numpy() - np.asarray(jl)).max()))
        tok = np.asarray(jnp.argmax(jl, axis=-1))
    assert calls[KERNEL_OF[weights]] == n_linears
    print(f"{weights}: worst logit difference {worst:.3e}")
    assert worst < INT4_LOGIT_TOL[weights], worst


@pytest.mark.parametrize("weights", ["words", "words_int8", "bytes"])
def test_int4_linears_agree_on_the_references_inputs(models, weights,
                                                     monkeypatch):
    """Every int4 linear of the reference's prefill forward (M = 96, the
    kernel route), fed to the port's linear on the same record: within
    LINEAR_REL_TOL of the reference's output. So the forward's logit gap
    (INT4_LOGIT_TOL) comes from activation roundings that flip between
    the packages, not from the linears. Prints, per linear, the share of
    its input's bf16 roundings that differ between the two forwards."""
    jm, pm, jps, pps = models
    _dot_mode(monkeypatch, weights)
    seen = {"ref": [], "port": []}
    port_linear = ptr.linear

    def recorder(real, key):
        def record(x, w, bias=None):
            y = real(x, w, bias)
            seen[key].append((np.array(x), np.array(y)))
            return y
        return record
    monkeypatch.setattr(jtr, "linear", recorder(jtr.linear, "ref"))
    monkeypatch.setattr(ptr, "linear", recorder(port_linear, "port"))
    tokens = np.random.default_rng(1).integers(0, 256, (8, 12))
    jm.forward(jps[weights], jnp.asarray(tokens, jnp.int32))
    pm.forward(pps[weights], torch.from_numpy(tokens))
    p = pps[weights]
    names = [(i, name) for i in range(CFG["n_layers"])
             for name in ("wqkv", "wo", "w_gate", "w_up", "w_down")]
    records = [p["layers"][i][name] for i, name in names]
    names.append(("", "lm_head"))
    records.append(p["lm_head"])
    assert len(seen["ref"]) == len(seen["port"]) == len(records)
    for (i, name), w, (x, y), (xp, _) in zip(names, records, seen["ref"],
                                             seen["port"]):
        out = port_linear(torch.from_numpy(x), w).numpy()
        assert np.abs(out - y).max() <= LINEAR_REL_TOL * np.abs(y).max()
        bf16 = [torch.from_numpy(a).to(torch.bfloat16) for a in (x, xp)]
        flips = (bf16[0] != bf16[1]).float().mean().item()
        print(f"{weights} {name}{i}: input bf16 flips {100 * flips:.1f}%")


def test_int4_decode_through_the_tail_cache_matches_reference(models):
    """Word-packed int4 weights, the int8 cache with an 8-row bf16 window
    and 4 query heads over 2 KV heads: teacher-forced decode steps through
    a full-window flush and a partial one, logits within DECODE_LOGIT_TOL
    of the reference's at every step."""
    jm, pm, jps, pps = models
    b, p, cap, rows = 4, 5, 64, 8
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 256, (b, p))
    jc = jm.new_cache(b, cap, quantized=True, tail_window=rows)
    pc = pm.new_cache(b, cap, quantized=True, tail_window=rows,
                      device="cpu")
    _, jc = jm.prefill(jps["words"], jnp.asarray(tokens, jnp.int32), jc)
    _, pc = pm.prefill(pps["words"], torch.from_numpy(tokens), pc)
    lens = np.full(b, p, np.int32)
    jc, pc = jc.with_lengths(jnp.asarray(lens)), pc.with_lengths(lens)
    tok = rng.integers(0, 256, b)
    worst = 0.0
    for step in range(12):
        jl, jc = jm.decode_step(jps["words"], jnp.asarray(tok, jnp.int32),
                                jc)
        pl, pc = pm.decode_step(pps["words"], torch.tensor(tok), pc)
        assert pc.tail_count == int(jc.tail_count)
        worst = max(worst, float(np.abs(pl.numpy() - np.asarray(jl)).max()))
        if step in (rows - 1, rows + 2):          # flush t = 8, then t = 3
            t = pc.tail_count
            jc, pc = jc.flush_tail(t), pc.flush_tail(t)
        tok = np.asarray(jnp.argmax(jl, axis=-1))
    print(f"worst teacher-forced logit difference {worst:.3e}")
    assert worst < DECODE_LOGIT_TOL, worst


# -- the engine ---------------------------------------------------------------

def _reference_margins(jm, jp, prompt, generated):
    """Top-2 logit margin of the JAX model at each generated position,
    teacher-forced without a cache."""
    seq = jnp.asarray([list(prompt) + list(generated)], jnp.int32)
    logits = np.asarray(jm.forward(jp, seq)[0][0])
    top = np.sort(logits[len(prompt) - 1:-1], axis=-1)
    return top[:, -1] - top[:, -2]


PROMPTS = [[1, 2, 3], [4, 5, 6, 7], [9, 10], [11, 3, 2], [5, 5], [7]]


@pytest.mark.parametrize("weights", ["words", "bytes"])
def test_int4_engine_tokens_equal_reference_on_f32_cache(models, weights):
    """6 prompts through 4 slots, 20 greedy tokens each in bursts of 4
    (slots recycle) on an f32 cache: token for token the JAX engine's
    (tests/test_engine.py:31's rule for float caches)."""
    jm, pm, jps, pps = models
    kw = dict(max_batch=4, capacity=64, prefill_buckets=(16,))
    ref = JServingEngine(jm, jps[weights], **kw).generate(PROMPTS, 20,
                                                          burst=4)
    eng = ServingEngine(pm, pps[weights], device="cpu", **kw)
    assert eng.generate(PROMPTS, 20, burst=4) == ref
    st = eng.stats()
    assert st["completed"] == st["submitted"] == 6


@pytest.mark.parametrize("weights", ["words", "words_int8"])
def test_int4_engine_on_int8_tail_cache_matches_reference(models, weights,
                                                          monkeypatch):
    """The serving configuration at small width: word-packed int4, an int8
    cache with the 16-row tail the gate picks, 4 slots, bucket-32 admission
    groups (prefill M = 128 > 64 takes the kernel wrapper), in both dot
    modes (RTEN_INT4_DOT set for both packages). Greedy tokens equal the
    JAX engine's wherever the reference's top-2 margin exceeds the words
    tolerance (tests/test_engine.py:688 bounds tail-cache logits)."""
    jm, pm, jps, pps = models
    _dot_mode(monkeypatch, weights)
    calls = _spy_kernels(monkeypatch)
    prompts = PROMPTS[:4] + [[13] * 20, [2, 4, 6, 8] * 4]
    kw = dict(max_batch=4, capacity=64, prefill_buckets=(32,),
              quantized_cache=True)
    ref = JServingEngine(jm, jps[weights], **kw).generate(prompts, 20,
                                                          burst=5)
    eng = ServingEngine(pm, pps[weights], device="cpu", **kw)
    out = eng.generate(prompts, 20, burst=5)
    assert eng._tail_flush == 16
    assert calls[KERNEL_OF[weights]] > 0
    tol = INT4_LOGIT_TOL[weights]
    for prompt, r, o in zip(prompts, ref, out):
        assert len(o) == len(r) == 20
        c = next((i for i in range(20) if r[i] != o[i]), 20)
        if c < 20:
            margin = _reference_margins(jm, jps[weights], prompt, r)[c]
            assert margin < tol, (prompt, c, margin)
    assert eng.stats()["completed"] == 6


def test_tail_window_at_tinyllama_serving_shape():
    """At TinyLlama's width (32 heads over 4 KV heads of 64) and the
    serving settings (max_batch=16, capacity=2048, an int8 cache) both
    engines pick the 16-row tail window; without the int8 cache, none. The
    gate reads the config only, so one layer and placeholder weights
    do."""
    cfg = dict(n_layers=1, vocab_size=256)
    jm = jtr.TransformerLM(jtr.TransformerConfig.tiny_llama(**cfg))
    pm = TransformerLM(TransformerConfig.tiny_llama(**cfg))
    for quant in (True, False):
        kw = dict(max_batch=16, capacity=2048, quantized_cache=quant)
        ref = JServingEngine(jm, {"embed": jnp.zeros((1, 1))},
                             **kw)._tail_flush
        got = ServingEngine(pm, {"embed": torch.zeros((1, 1))},
                            device="cpu", **kw)._tail_flush
        assert got == ref == (16 if quant else 0)
