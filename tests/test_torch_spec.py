"""Parity of the port's speculative decoding (``rten_tpu_torch`` on the CPU,
with the kernels' plain versions) against the JAX package (CPU backend,
Pallas in interpret mode) at the reference's own test shapes
(``tests/test_speculative.py``: ``tiny_test()`` and its GQA variant with
RoPE): n-gram drafting, the speculative engine's tokens, the verify
dispatch and what raises. The verify step's logits are held in
``tests/test_torch_spec_model.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rten_tpu.generate.engine import ServingEngine as JServingEngine
from rten_tpu.generate.speculative import ngram_draft as jngram_draft
from rten_tpu.models import transformer as jtr
from rten_tpu_torch.generate import ServingEngine
from rten_tpu_torch.generate.speculative import ngram_draft
from rten_tpu_torch.models import (TransformerConfig, TransformerLM,
                                   params_from_numpy)
from rten_tpu_torch.models import transformer as ptr

CONFIGS = {"gpt2": dict(),
           "gqa": dict(pos="rope", norm="rmsnorm", act="swiglu", kv_heads=2)}
# int8 weights: a bf16 rounding of an activation may flip between the
# packages (tests/test_torch_model.py:LOGIT_TOL); a token may differ only
# after a step whose reference top-2 margin is below this.
INT8_MARGIN_TOL = 1e-2


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", params=list(CONFIGS))
def models(request):
    return build_models(CONFIGS[request.param])


def build_models(kw):
    """The JAX and port models of one config with the same weights
    (``PRNGKey(0)``): f32 and int8."""
    jm = jtr.TransformerLM(jtr.TransformerConfig.tiny_test(**kw))
    jp = jm.init_params(jax.random.PRNGKey(0))
    jq = jtr.quantize_weights(jp)
    pm = TransformerLM(TransformerConfig.tiny_test(**kw))
    return (jm, pm, {"f32": jp, "int8": jq},
            {"f32": params_from_numpy(_np_tree(jp), device="cpu"),
             "int8": params_from_numpy(_np_tree(jq), device="cpu")})


# -- n-gram drafting ----------------------------------------------------------

# (valid prefix, cap, hist_len, n, k, expected) from test_speculative.py:87-118.
DRAFT_CASES = [
    ([5, 6, 9, 9, 5, 6, 7, 5, 6], 16, 9, 2, 3, [7, 5, 6]),   # the last match
    ([1, 2, 3, 4, 5], 10, 5, 2, 2, [5, 5]),                  # no match
    ([4, 1, 2, 9, 1, 2], 12, 6, 2, 3, [9, 1, 2]),            # garbage past
    ([1, 2, 8, 1, 2], 10, 5, 2, 3, [8, 1, 2]),               # window clipped
]


@pytest.mark.parametrize("case", range(len(DRAFT_CASES)))
def test_ngram_draft_reference_cases(case):
    prefix, cap, hist_len, n, k, want = DRAFT_CASES[case]
    for fill in (0, 7):                  # the drafts ignore the garbage
        hist = np.full((1, cap), fill, np.int32)
        hist[0, :len(prefix)] = prefix
        got = ngram_draft(torch.from_numpy(hist), torch.tensor([hist_len]),
                          n, k)
        assert got.dtype == torch.int32
        assert got.tolist() == [want]


@pytest.mark.parametrize("n,k", [(2, 3), (3, 3), (3, 1), (1, 4)])
def test_ngram_draft_matches_reference_on_random_histories(n, k):
    """Random histories over a small alphabet (so matches are frequent),
    lengths 1..cap and garbage past each length: the port's drafts equal
    the reference's."""
    rng = np.random.default_rng(10 * n + k)
    b, cap = 64, 40
    hist = rng.integers(0, 4, (b, cap)).astype(np.int32)
    hist_len = rng.integers(1, cap + 1, b).astype(np.int32)
    hist_len[:3] = [1, n, cap]
    ref = np.asarray(jngram_draft(jnp.asarray(hist), jnp.asarray(hist_len),
                                  n, k))
    got = ngram_draft(torch.from_numpy(hist), torch.from_numpy(hist_len), n,
                      k)
    np.testing.assert_array_equal(got.numpy(), ref)


# -- the engine ---------------------------------------------------------------

def _spec(pm, pp, **kw):
    return ServingEngine(pm, pp, device="cpu", spec_adaptive=False,
                         **{"prefill_buckets": (16,), **kw})


def _jspec(jm, jp, **kw):
    return JServingEngine(jm, jp, spec_adaptive=False,
                          **{"prefill_buckets": (16,), **kw})


def test_spec_engine_matches_plain_greedy_and_reference(models):
    """f32 weights, f32 cache: the speculative engine emits exactly the
    port's plain greedy tokens and the reference's speculative tokens
    (test_speculative.py:132-144)."""
    jm, pm, jps, pps = models
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8], [9, 10]]
    kw = dict(max_batch=4, capacity=64)
    plain = ServingEngine(pm, pps["f32"], device="cpu", prefill_buckets=(16,),
                          **kw).generate(prompts, max_new_tokens=10)
    eng = _spec(pm, pps["f32"], spec_draft=3, spec_ngram=2, **kw)
    got = eng.generate(prompts, max_new_tokens=10, burst=2)
    ref = _jspec(jm, jps["f32"], spec_draft=3, spec_ngram=2,
                 **kw).generate(prompts, max_new_tokens=10, burst=2)
    assert got == plain == ref
    st = eng.stats()
    assert st["spec_adaptive"] is False and st["spec_on"] is True
    assert st["tokens"] == 3 * 9 and st["spec_steps"] == st["decode_steps"]


def test_spec_engine_oversubscribed_slots(models):
    """5 requests through 2 slots (slots recycle): tokens equal the port's
    plain engine's and the reference's speculative engine's
    (test_speculative.py:147-154)."""
    jm, pm, jps, pps = models
    prompts = [[i + 1, i + 2, i + 3] for i in range(5)]
    kw = dict(max_batch=2, capacity=64)
    plain = ServingEngine(pm, pps["f32"], device="cpu", prefill_buckets=(16,),
                          **kw).generate(prompts, max_new_tokens=6)
    got = _spec(pm, pps["f32"], spec_draft=2, spec_ngram=2, **kw).generate(
        prompts, max_new_tokens=6, burst=2)
    ref = _jspec(jm, jps["f32"], spec_draft=2, spec_ngram=2, **kw).generate(
        prompts, max_new_tokens=6, burst=2)
    assert got == plain == ref


def test_spec_engine_stop_tokens(models):
    """A stop token ends a request inside a speculative step
    (test_speculative.py:157-164)."""
    _, pm, _, pps = models
    plain = ServingEngine(pm, pps["f32"], device="cpu", max_batch=2,
                          capacity=64, prefill_buckets=(16,))
    first = plain.generate([[1, 2]], max_new_tokens=2)[0][1]
    out = _spec(pm, pps["f32"], max_batch=2, capacity=64,
                spec_draft=2).generate([[1, 2]], max_new_tokens=10,
                                       stop_ids=(first,))[0]
    assert out[-1] == first and len(out) <= 10
    assert first not in out[:-1]


def test_spec_acceptance_on_repetitive_prompt(models):
    """A prompt that already loops (the model's own greedy stream) lets
    the drafts land: fewer engine steps than tokens, and the plain greedy
    tokens (test_speculative.py:167-181)."""
    _, pm, _, pps = models
    plain = ServingEngine(pm, pps["f32"], device="cpu", max_batch=1,
                          capacity=128, prefill_buckets=(32,))
    seed = plain.generate([[1, 2]], max_new_tokens=12)[0]
    prompt = [1, 2] + seed
    want = plain.generate([prompt], max_new_tokens=12)[0]
    eng = _spec(pm, pps["f32"], max_batch=1, capacity=128,
                prefill_buckets=(32,), spec_draft=3, spec_ngram=2)
    req = eng.submit(prompt, max_new_tokens=12)
    eng.run(burst=1)
    assert req.tokens == want
    assert eng.counters["decode_steps"] < len(req.tokens) - 1


def test_plain_steps_keep_the_speculative_history(models):
    """Plain steps and bursts on a speculative engine write their tokens
    into the history (engine.py:585-605), so a speculative burst after
    them verifies after the right token: the stream is plain greedy's."""
    _, pm, _, pps = models
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8]]
    kw = dict(max_batch=2, capacity=64)
    want = ServingEngine(pm, pps["f32"], device="cpu", prefill_buckets=(16,),
                         **kw).generate(prompts, max_new_tokens=12)
    eng = _spec(pm, pps["f32"], spec_draft=3, **kw)
    reqs = [eng.submit(p, max_new_tokens=12) for p in prompts]
    eng.step()
    eng.step_burst(3)
    while eng._pending():
        eng.step_spec_burst(2)
    assert [r.tokens for r in reqs] == want


def _reference_margins(jm, jp, prompt, generated):
    """Top-2 logit margin of the JAX model at each generated position,
    teacher-forced without a cache."""
    seq = jnp.asarray([list(prompt) + list(generated)], jnp.int32)
    logits = np.asarray(jm.forward(jp, seq)[0][0])
    top = np.sort(logits[len(prompt) - 1:-1], axis=-1)
    return top[:, -1] - top[:, -2]


@pytest.mark.parametrize("quantized", [False, True])
def test_spec_engine_int8_weights_match_reference(models, quantized):
    """int8 weights on an f32 cache and on an int8 cache: the port's
    speculative tokens equal the reference's, except after a step whose
    reference top-2 margin is below INT8_MARGIN_TOL (exactness against
    plain decoding is no property of the reference here: at M = B*S > 64
    the activation scale spans the chunk)."""
    jm, pm, jps, pps = models
    prompts = [[1, 2, 3, 1, 2, 3, 1, 2], [5, 6, 5, 6, 5, 6], [9, 10],
               [11, 3, 2], [7]]
    kw = dict(max_batch=4, capacity=64, spec_draft=3,
              quantized_cache=quantized)
    eng = _spec(pm, pps["int8"], **kw)
    got = eng.generate(prompts, max_new_tokens=12, burst=3)
    ref = _jspec(jm, jps["int8"], **kw).generate(prompts, max_new_tokens=12,
                                                 burst=3)
    assert eng._tail_flush == 0
    for prompt, r, o in zip(prompts, ref, got):
        assert len(o) == len(r) == 12
        c = next((i for i in range(12) if r[i] != o[i]), 12)
        if c < 12:
            margin = _reference_margins(jm, jps["int8"], prompt, r)[c]
            assert margin < INT8_MARGIN_TOL, (prompt, c, margin)


def test_spec_k_ladder(models):
    """The draft-length ladder of always-draft mode
    (test_speculative.py:281-296)."""
    _, pm, _, pps = models
    eng = _spec(pm, pps["f32"], max_batch=2, capacity=64, spec_draft=3)
    assert eng._spec_k == 3
    for tps, k in ((1.2, 2), (1.0, 1), (1.0, 1), (1.9, 2)):
        eng._spec_tps = tps
        eng._adapt_k()
        assert eng._spec_k == k
    assert eng.stats()["spec_k"] == 2


# -- dispatch and what raises -------------------------------------------------

def test_verify_dispatch_follows_the_reference(models, monkeypatch):
    """Which wrapper a verify step reaches (transformer.py:757-771): a
    batch with a group in (8, 4, 2) and decode_attn "auto" or "grouped" →
    verify_attn_grouped, every other batch or kind → verify_attn_fused,
    both on float and int8 caches; a one-token chunk is a decode step."""
    _, pm, _, pps = models
    calls = []
    for name in ("verify_attn_grouped", "verify_attn_fused",
                 "decode_attn_float"):
        real = getattr(ptr, name)

        def spy(*a, _real=real, _name=name):
            # (wrapper, int8 mode): the verify wrappers' 4th argument is
            # the scales.
            calls.append((_name, len(a) > 3 and a[3] is not None))
            return _real(*a)
        monkeypatch.setattr(ptr, name, spy)

    def verify(model, b, s=3, **kw):
        calls.clear()
        cache = model.new_cache(b, 32, device="cpu", **kw)
        model.verify_step(pps["f32"], torch.ones((b, s), dtype=torch.int64),
                          cache)
        return set(calls)

    cfg = pm.config
    for b, grouped in ((8, True), (4, True), (2, False), (3, False),
                       (1, False)):
        name = "verify_attn_grouped" if grouped else "verify_attn_fused"
        assert verify(pm, b) == {(name, False)}
        assert verify(pm, b, quantized=True) == {(name, True)}
    for kind, name in (("grouped", "verify_attn_grouped"),
                       ("fused", "verify_attn_fused"),
                       ("stream", "verify_attn_fused"),
                       ("flat", "verify_attn_fused")):
        pk = TransformerLM(dataclasses.replace(cfg, decode_attn=kind))
        assert verify(pk, 8) == {(name, False)}
    assert verify(pm, 4, s=1) == {("decode_attn_float", False)}


def test_speculative_raises_where_the_reference_does_not_serve(models):
    """spec_adaptive True and the reference's default "auto" (the gate, not
    ported) raise naming ROADMAP; so does chunked verify on a paged cache.
    A paged speculative engine, a tail window with speculation and a
    verify step on a tail cache raise; an int8 speculative engine picks no
    tail."""
    _, pm, _, pps = models
    pp = pps["f32"]
    for adaptive in (True, "auto"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ServingEngine(pm, pp, max_batch=4, capacity=64, device="cpu",
                          spec_draft=3, spec_adaptive=adaptive)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pm.verify_step(pp, torch.zeros((2, 3), dtype=torch.int64),
                       pm.new_paged_cache(2, 64, 16, 9, device="cpu"))
    with pytest.raises(ValueError, match="contiguous"):
        _spec(pm, pp, max_batch=4, capacity=64, spec_draft=3, paged=True)
    with pytest.raises(ValueError, match="spec_draft"):
        _spec(pm, pp, max_batch=4, capacity=64, spec_draft=3,
              quantized_cache=True, tail_window=16)
    with pytest.raises(ValueError, match="tail window"):
        pm.verify_step(pp, torch.zeros((4, 3), dtype=torch.int64),
                       pm.new_cache(4, 64, quantized=True, tail_window=8,
                                    device="cpu"))
    assert _spec(pm, pp, max_batch=4, capacity=64, spec_draft=3,
                 quantized_cache=True)._tail_flush == 0
