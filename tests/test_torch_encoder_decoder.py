"""The port's encoder-decoder (``rten_tpu_torch/models/encoder_decoder.py``,
Whisper-class) against the JAX package's on the CPU, where the port's
kernels run their plain versions and the reference's Pallas kernels run in
interpret mode, at ``tiny_test()`` sizes with numpy-drawn inputs:

* ``encode`` (the linear projection and Whisper's conv frontend),
  ``cross_kv`` and ``decode`` logits, cached against a full forward;
* ``generate``'s greedy tokens on f32 and int8 caches, bursts equal to
  the stepwise loop (``max_tokens`` and ``eos_token`` truncation too);
* the decode dispatch (:func:`decode_attn_choice`) against the kernel the
  reference's decoder reaches, traced with ``jax.eval_shape`` and spied
  entry points, at batches 2, 8 and 32 and capacities 448 and 512, and
  the port's decode launching the kernel it names;
* ``log_mel_spectrogram`` bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rten_tpu.generate.kv_cache import KVCache as JKVCache
from rten_tpu.kernels import attention as ja
from rten_tpu.models import encoder_decoder as jed
from rten_tpu_torch.models import encoder_decoder as ped

# Encoder outputs and logits: the same f32 arithmetic in other orders
# (LayerNorm-scaled outputs and logits of order 1): 1e-5.
TOL = 1e-5
SRC_LEN = {False: 24, True: 40}        # 40 frames → 20 after the conv


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module", params=[False, True], ids=["linear", "conv"])
def models(request):
    """Both packages' models at tiny_test() with the same weights (seed 0)
    and a batch of features: the linear frontend, or Whisper's convs."""
    conv = request.param
    jm = jed.EncoderDecoderLM(jed.EncoderDecoderConfig.tiny_test(
        conv_frontend=conv))
    pm = ped.EncoderDecoderLM(ped.EncoderDecoderConfig.tiny_test(
        conv_frontend=conv))
    feats = np.random.default_rng(0).standard_normal(
        (2, SRC_LEN[conv], 16)).astype(np.float32)
    return (jm, jm.init_params(jax.random.PRNGKey(0)), pm,
            pm.init_params(0, device="cpu"), feats)


def test_init_params_draw_the_reference_weights(models):
    jm, jp, pm, pp, _ = models
    flat_j = jax.tree_util.tree_leaves(jp)
    flat_p = jax.tree_util.tree_leaves(pp)
    assert len(flat_j) == len(flat_p)
    for a, b in zip(flat_j, flat_p):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_encode_and_cross_kv_match_reference(models):
    jm, jp, pm, pp, feats = models
    jmem = jm.encode(jp, jnp.asarray(feats))
    pmem = pm.encode(pp, _t(feats))
    assert pmem.shape == jmem.shape
    np.testing.assert_allclose(pmem.numpy(), np.asarray(jmem), rtol=0,
                               atol=TOL)
    for (jk, jv), (pk, pv) in zip(jm.cross_kv(jp, jmem),
                                  pm.cross_kv(pp, _t(jmem))):
        np.testing.assert_allclose(pk.numpy(), np.asarray(jk), rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=0,
                                   atol=TOL)


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_decode_logits_match_reference_and_full_forward(models, quantized):
    """A 4-token prefill into the cache, then 3 one-token steps: each step's
    logits against the reference's (tolerance TOL; the int8 cache holds the
    same bytes in both packages) and, on the f32 cache, against the
    uncached forward of the whole sequence (no cache: attention within
    the chunk, the same arithmetic)."""
    jm, jp, pm, pp, feats = models
    jcross = jm.cross_kv(jp, jm.encode(jp, jnp.asarray(feats)))
    pcross = pm.cross_kv(pp, pm.encode(pp, _t(feats)))
    tokens = np.random.default_rng(1).integers(0, 64, (2, 7))
    jc = jm.new_cache(2, quantized=quantized)
    pc = pm.new_cache(2, quantized=quantized, device="cpu")
    jl, jc = jm.decode(jp, jnp.asarray(tokens[:, :4], jnp.int32), jcross, jc)
    pl, pc = pm.decode(pp, _t(tokens[:, :4]), pcross, pc)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=0, atol=TOL)
    steps = [pl[:, -1]]
    for i in range(4, 7):
        jl, jc = jm.decode(jp, jnp.asarray(tokens[:, i:i + 1], jnp.int32),
                           jcross, jc)
        pl, pc = pm.decode(pp, _t(tokens[:, i:i + 1]), pcross, pc)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=0,
                                   atol=TOL)
        steps.append(pl[:, -1])
    assert pc.lengths.tolist() == [7, 7]
    if not quantized:
        full, none = pm.decode(pp, _t(tokens), pcross, None)
        assert none is None
        np.testing.assert_allclose(torch.stack(steps, 1).numpy(),
                                   full[:, 3:].numpy(), rtol=0, atol=TOL)


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_use_pallas_false_matches_reference(quantized):
    """``use_pallas=False``: attention over the dequantized cache through
    the plain reference path in both packages (encoder_decoder.py:228-232),
    no decode kernel; prefill and two decode steps within TOL."""
    cfg = dict(use_pallas=False)
    jm = jed.EncoderDecoderLM(jed.EncoderDecoderConfig.tiny_test(**cfg))
    pm = ped.EncoderDecoderLM(ped.EncoderDecoderConfig.tiny_test(**cfg))
    jp, pp = jm.init_params(None), pm.init_params(0, device="cpu")
    feats = np.random.default_rng(4).standard_normal(
        (2, 12, 16)).astype(np.float32)
    jcross = jm.cross_kv(jp, jm.encode(jp, jnp.asarray(feats)))
    pcross = pm.cross_kv(pp, pm.encode(pp, _t(feats)))
    jc = jm.new_cache(2, quantized=quantized)
    pc = pm.new_cache(2, quantized=quantized, device="cpu")
    tokens = np.random.default_rng(5).integers(0, 64, (2, 5))
    for chunk in (tokens[:, :3], tokens[:, 3:4], tokens[:, 4:5]):
        jl, jc = jm.decode(jp, jnp.asarray(chunk, jnp.int32), jcross, jc)
        pl, pc = pm.decode(pp, _t(chunk), pcross, pc)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=0,
                                   atol=TOL)


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_generate_tokens_match_reference(models, quantized):
    jm, jp, pm, pp, feats = models
    want = jm.generate(jp, jnp.asarray(feats), 1, max_tokens=10,
                       quantized_cache=quantized)
    got = pm.generate(pp, _t(feats), 1, max_tokens=10,
                      quantized_cache=quantized)
    assert got.dtype == np.int32 and got.shape == (2, 10)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("max_tokens", [1, 7, 10])
@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_burst_generate_equals_stepwise(models, quantized, max_tokens):
    """burst=3 runs whole bursts and drops the overshoot on the host: the
    tokens equal the stepwise loop's (and, at 10 tokens, the reference's
    burst loop's; its stepwise tokens are held by the test above)."""
    jm, jp, pm, pp, feats = models
    step = pm.generate(pp, _t(feats), 1, max_tokens=max_tokens,
                       quantized_cache=quantized)
    burst = pm.generate(pp, _t(feats), 1, max_tokens=max_tokens,
                        quantized_cache=quantized, burst=3)
    assert burst.shape == (2, max_tokens)
    np.testing.assert_array_equal(burst, step)
    if max_tokens == 10:
        np.testing.assert_array_equal(burst, jm.generate(
            jp, jnp.asarray(feats), 1, max_tokens=max_tokens,
            quantized_cache=quantized, burst=3))


def test_burst_generate_stops_at_eos_as_stepwise(models):
    """A step whose tokens are all ``eos_token`` ends generation
    mid-burst, as in the stepwise loop; eos is a token that every row
    emits at one step of the free run where there is one."""
    jm, jp, pm, pp, feats = models
    free = pm.generate(pp, _t(feats), 1, max_tokens=10)
    same = [i for i in range(10) if (free[:, i] == free[0, i]).all()]
    eos = int(free[0, same[len(same) // 2]]) if same else -1
    step = pm.generate(pp, _t(feats), 1, max_tokens=10, eos_token=eos)
    burst = pm.generate(pp, _t(feats), 1, max_tokens=10, eos_token=eos,
                        burst=4)
    np.testing.assert_array_equal(burst, step)
    np.testing.assert_array_equal(burst, jm.generate(
        jp, jnp.asarray(feats), 1, max_tokens=10, eos_token=eos, burst=4))


# -- the decode dispatch ------------------------------------------------------

def _reference_choice(b, cap, quantized, h=4, d=16):
    """(kind, group) that the reference's one-token decode reaches
    (encoder_decoder.py:210-240, then flash_decode_grouped's fallback),
    traced abstractly with its entry points spied: the last call names
    the kernel that runs."""
    calls = []
    real = {n: getattr(ja, n) for n in ("flash_decode_grouped",
                                        "flash_decode_fused")}

    def spy(name):
        def call(*a, **kw):
            calls.append((name, kw.get("group"), kw.get("int8_scores")))
            if name == "flash_decode_fused":
                return jnp.zeros(a[0].shape, a[0].dtype)
            return real[name].__wrapped__(*a, **kw)
        return call

    cfg = jed.EncoderDecoderConfig.tiny_test(n_dec_layers=1, n_heads=h,
                                             d_model=h * d)
    model = jed.EncoderDecoderLM(cfg)
    params = jax.eval_shape(lambda: model.init_params(None))
    cache = jax.eval_shape(lambda: JKVCache.create(b, 1, h, cap, d,
                                                   quantized=quantized))
    cross = [(jax.ShapeDtypeStruct((b, h, 8, d), jnp.float32),) * 2]
    tokens = jax.ShapeDtypeStruct((b, 1), jnp.int32)
    try:
        ja.flash_decode_grouped = spy("flash_decode_grouped")
        ja.flash_decode_fused = spy("flash_decode_fused")
        jed.flash_decode_fused = ja.flash_decode_fused
        jax.eval_shape(lambda p, t, c, x: model.decode(p, t, c, x), params,
                       tokens, cross, cache)
    finally:
        for n, f in real.items():
            setattr(ja, n, f)
        jed.flash_decode_fused = real["flash_decode_fused"]
    name, group, scores = calls[-1]
    if name == "flash_decode_fused":
        return "fused", 0
    return ("grouped_scores" if scores else "grouped"), group


DISPATCH = [(b, cap, q) for b in (2, 8, 32) for cap in (448, 512)
            for q in (False, True)]


@pytest.mark.parametrize("b,cap,quantized", DISPATCH, ids=str)
def test_decode_dispatch_follows_the_reference(b, cap, quantized):
    assert ped.decode_attn_choice(b, cap, quantized) == \
        _reference_choice(b, cap, quantized)


def test_whisper_batch_8_dispatch():
    """(M)'s kernels at batch 8: G2 on an int8 cache of capacity 448 (the
    block 128 does not divide it), G1 with int8 scores at 512 (group 4),
    K6's grouped float mode at 448 (block 64 divides it)."""
    assert ped.decode_attn_choice(8, 448, True) == ("fused", 0)
    assert ped.decode_attn_choice(8, 512, True) == ("grouped_scores", 4)
    assert ped.decode_attn_choice(8, 448, False) == ("grouped", 4)
    assert ped.decode_attn_choice(32, 512, True) == ("grouped", 16)


WRAPPERS = ("decode_attn_float", "decode_attn_fused_int8",
            "decode_attn_grouped_int8", "kv_append", "kv_append_int8")


@pytest.mark.parametrize("b,cap,quantized", [
    (8, 448, False), (8, 448, True), (8, 512, True), (2, 32, True),
    (32, 512, True)], ids=str)
def test_decode_step_calls_the_chosen_kernel(b, cap, quantized,
                                             monkeypatch):
    """One decode step of the port launches, once a layer, the append and
    the attention kernel that decode_attn_choice names, with int8 scores
    where it says so; the output is finite."""
    from rten_tpu_torch.generate import kv_cache
    calls = []

    def spy(mod, name):
        real = getattr(mod, name)

        def call(*a, **kw):
            calls.append((name, kw.get("int8_scores", False)))
            return real(*a, **kw)
        monkeypatch.setattr(mod, name, call)

    for name in WRAPPERS[:3]:
        spy(ped, name)
    for name in WRAPPERS[3:]:
        spy(kv_cache, name)
    cfg = ped.EncoderDecoderConfig.tiny_test(max_target_len=cap)
    pm = ped.EncoderDecoderLM(cfg)
    pp = pm.init_params(0, device="cpu")
    feats = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (b, 12, 16)).astype(np.float32))
    cross = pm.cross_kv(pp, pm.encode(pp, feats))
    cache = pm.new_cache(b, quantized=quantized, device="cpu")
    logits, _ = pm.decode(pp, torch.ones((b, 1), dtype=torch.int64), cross,
                          cache)
    assert torch.isfinite(logits).all()
    kind, _ = ped.decode_attn_choice(b, cap, quantized)
    attend = ("decode_attn_float" if not quantized
              else "decode_attn_fused_int8" if kind == "fused"
              else "decode_attn_grouped_int8")
    append = "kv_append_int8" if quantized else "kv_append"
    scores = kind == "grouped_scores"
    assert sorted(calls) == sorted([(append, False)] * 2
                                   + [(attend, scores)] * 2)


def test_log_mel_spectrogram_bit_for_bit():
    rng = np.random.default_rng(3)
    audio = (0.3 * np.sin(np.arange(16000) * 0.05)
             + 0.01 * rng.standard_normal(16000)).astype(np.float32)
    for n_mels in (16, 80):
        want = jed.log_mel_spectrogram(audio, n_mels=n_mels)
        got = ped.log_mel_spectrogram(audio, n_mels=n_mels)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want)


def test_port_modules_import_no_jax():
    """The port's new modules import neither jax nor the JAX package."""
    import inspect
    import re

    from rten_tpu_torch import ctc
    from rten_tpu_torch.models import (bert, checkpoint, encoder_decoder,
                                       hf_loader, sam, segmentation, tts,
                                       vit)
    pattern = re.compile(r"^\s*(from|import)\s+(jax|rten_tpu)\b(?!_torch)",
                         re.M)
    for mod in (ctc, bert, checkpoint, encoder_decoder, hf_loader, sam,
                segmentation, tts, vit):
        assert not pattern.search(inspect.getsource(mod)), mod.__name__
