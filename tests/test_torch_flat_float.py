"""Parity of the port's ``decode_attn="flat"`` path on float caches against
the JAX package on the CPU (the port's kernels run their plain versions,
the reference's Pallas kernels interpret mode), on inputs drawn with
numpy:

* K8 (``decode_attn_flat_float``) against ``flash_decode_flat``'s float
  mode (``q_bf16``, the reference's default) on f32 and bf16 caches with
  and without GQA, and K6 (``decode_attn_float``) failing the same
  criterion, so the path needs K8; K6 against the exact mode
  (``q_bf16=False``), which it meets;
* the float decode rule (``float_decode_kernel``) against the kernels the
  reference's own dispatch calls, the E-matrix and capacity fallbacks
  included;
* a small GPT-2-family model with ``decode_attn="flat"`` on f32 and bf16
  caches: teacher-forced decode logits and greedy engine tokens.
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
from rten_tpu_torch.models import (TransformerConfig, TransformerLM,
                                   params_from_numpy)
from rten_tpu_torch.models import transformer as ptr

D, CAP = 64, 128
# K8 against flash_decode_flat: both sum in f32 in other orders, so at
# least 99.9% of the elements agree within 2e-5 of max |out|; with q_bf16
# both round the output to bf16, so an element whose f32 sums straddle a
# rounding boundary lands one bf16 step apart: every element within one
# step of the reference's value, 2^-7 |ref| (a step is 2^-8 to 2^-7 of the
# value; one such flip in 4096 elements, 0.0051 |ref|, shows at GQA 4:1
# below). Without q_bf16 nothing is rounded: every element within 2e-5 of
# max |out|.
ELEM_TOL = 2e-5
SHARE = 0.999
BF16_STEP = 2.0 ** -7
# Teacher-forced logits with f32 weights: K8 rounds q, K and its output to
# bf16 like the reference, so a rounding might flip between the packages
# (tests/test_torch_decode_paths.py allows K1' 1e-2 for that); here the
# logits hold at the f32 bound of that file, 1e-4 (measured 1.3e-6 on an
# f32 cache, 8.3e-7 on a bf16 one).
F32_LOGIT_TOL = 1e-4
# The small GPT-2-family model: one layer (the reference's interpret-mode
# compile takes most of this file's time), two heads of 64, rows 128 lanes
# wide.
CFG = dict(n_layers=1, n_heads=2, d_model=128, decode_attn="flat")

JDTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _share_close(out, ref):
    """The share of elements within ELEM_TOL of max |ref|."""
    return float((np.abs(out - ref) <= ELEM_TOL * np.abs(ref).max()).mean())


# -- K8 against flash_decode_flat's float mode --------------------------------

# (batch, heads, kv heads, cache dtype, q_bf16): each of 12 heads (GPT-2's
# count) and GQA 4:1 meets each cache dtype and each q_bf16 mode once.
FLAT_CASES = [(16, 12, 12, "float32", True), (16, 12, 12, "bfloat16", False),
              (8, 8, 2, "float32", False), (8, 8, 2, "bfloat16", True),
              (8, 8, 2, "float32", True)]


@pytest.mark.parametrize("b,h,kvh,dtype,q_bf16", FLAT_CASES, ids=str)
def test_flat_float_plain_matches_flash_decode_flat(b, h, kvh, dtype,
                                                    q_bf16):
    """The plain K8 (with q_bf16) or K6 (without: the reference's exact
    mode) against flash_decode_flat(float cache, group 2, block 64),
    lengths 1 through cap; K6 at the same inputs misses the 99.9%
    criterion where q_bf16 rounds (K rounds to bf16 even on an f32 cache),
    and meets it where it does not."""
    rng = np.random.default_rng(b + h + (dtype == "bfloat16"))
    q = rng.standard_normal((b, h, D)).astype(np.float32)
    jkv = jnp.asarray(rng.standard_normal((b, CAP, 2, kvh * D)),
                      JDTYPES[dtype])
    lengths = rng.integers(1, CAP + 1, b).astype(np.int32)
    lengths[:2] = (1, CAP)
    ref = np.asarray(flash_decode_flat(jnp.asarray(q), jkv,
                                       jnp.asarray(lengths), kvh, group=2,
                                       block_k=64, q_bf16=q_bf16))
    pkv = _t(np.asarray(jkv.astype(jnp.float32))).to(TDTYPES[dtype])
    attend = at.decode_attn_flat_float if q_bf16 else at.decode_attn_float
    out = attend(_t(q), pkv, _t(lengths))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    out = out.numpy()
    share = _share_close(out, ref)
    assert share >= SHARE, share
    err = np.abs(out - ref)
    if q_bf16:
        assert (err <= BF16_STEP * np.abs(ref)).all(), (
            err / np.abs(ref)).max()
    else:
        assert err.max() <= ELEM_TOL * np.abs(ref).max(), err.max()
    k6 = at.decode_attn_float(_t(q), pkv, _t(lengths)).numpy()
    k6_share = _share_close(k6, ref)
    print(f"{dtype} B {b} H {h}/{kvh} q_bf16 {q_bf16}: K8 {share:.4f} "
          f"within, max err {err.max():.3e}; K6 {k6_share:.4f}")
    assert (k6_share < SHARE) == q_bf16, k6_share


def test_flat_float_roundings():
    """What the mode rounds, on a hand-made case: q and every K element to
    bf16 before the score dot (an f32 cache's K too), V used as stored, and
    the output to bf16."""
    rng = np.random.default_rng(3)
    b, h, kvh = 2, 2, 1
    q = _t(rng.standard_normal((b, h, D)).astype(np.float32))
    kv = _t(rng.standard_normal((b, 16, 2, kvh * D)).astype(np.float32))
    lengths = torch.tensor([16, 5], dtype=torch.int32)
    out = at.decode_attn_flat_float(q, kv, lengths)
    bf = kv.clone()
    bf[:, :, 0] = bf[:, :, 0].to(torch.bfloat16).to(torch.float32)
    want = at.decode_attn_float(q.to(torch.bfloat16).to(torch.float32), bf,
                                lengths).to(torch.bfloat16)
    assert torch.equal(out, want.to(torch.float32))


# -- the float decode rule against the reference's dispatch -------------------

def _reference_choice(b, h, d, kvh, cap, decode_attn):
    """The kernel the reference's ``_pallas_decode_attn`` calls for a float
    cache at these shapes, traced with jax.eval_shape and its Pallas entry
    points spied: the last call names the kernel that runs."""
    calls = []
    names = ("flash_decode_flat", "flash_decode_grouped",
             "flash_decode_fused", "flash_decode_stream")
    real = {n: getattr(ja, n) for n in names}

    def spy(name):
        def call(*a, **kw):
            calls.append((name, kw.get("group")))
            if name in ("flash_decode_fused", "flash_decode_stream"):
                return jnp.zeros(a[0].shape, a[0].dtype)
            return real[name].__wrapped__(*a, **kw)    # unjitted: traced
        return call

    cfg = jtr.TransformerConfig.tiny_test(
        n_layers=1, n_heads=h, kv_heads=kvh, d_model=h * d,
        decode_attn=decode_attn)
    cache = jax.eval_shape(lambda: JKVCache.create(b, 1, kvh, cap, d))
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
    name, group = calls[-1]
    kind = {"flash_decode_flat": "flat", "flash_decode_fused": "fused",
            "flash_decode_grouped": "grouped",
            "flash_decode_stream": "stream"}[name]
    return kind, group or 0


# (batch, heads, head_dim, kv heads, capacity, decode_attn)
DISPATCH = [
    (256, 12, 64, 12, 512, "flat"),      # path (I): GPT-2-small, E 1.6 MB
    (16, 32, 64, 4, 2048, "flat"),       # TinyLlama's shape, block 128
    (16, 32, 128, 8, 4096, "flat"),      # Mistral's: E 8.4 MB > 4 MB
    (4, 2, 64, 2, 96, "flat"),           # block 64 ∤ 96: grouped → fused
    (16, 2, 64, 2, 2112, "flat"),        # long, 128 ∤ 2112
    (3, 2, 64, 2, 128, "flat"),          # no group: grouped → fused
    (8, 4, 64, 2, 32, "flat"),           # capacity below the block
    (256, 12, 64, 12, 512, "auto"),      # float caches stay grouped
    (3, 2, 64, 2, 128, "auto"),
    (4, 2, 64, 2, 128, "grouped"),
    (4, 2, 64, 2, 128, "stream"),
]


@pytest.mark.parametrize("case", DISPATCH, ids=str)
def test_float_decode_kernel_follows_the_reference(case):
    assert at.float_decode_kernel(*case) == _reference_choice(*case)


# -- the model and the engine -------------------------------------------------

@pytest.fixture(scope="module")
def models():
    """The JAX and port models with decode_attn "flat" and the same f32
    weights (seed 3)."""
    jm = jtr.TransformerLM(jtr.TransformerConfig.tiny_test(**CFG))
    jp = jm.init_params(jax.random.PRNGKey(3))
    pm = TransformerLM(TransformerConfig.tiny_test(**CFG))
    return jm, pm, jp, params_from_numpy(_np_tree(jp), device="cpu")


def _spy(monkeypatch):
    calls = []
    for name in ("decode_attn_flat_float", "decode_attn_float"):
        real = getattr(ptr, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(ptr, name, spy)
    return calls


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flat_decode_logits_match_reference(models, dtype, monkeypatch):
    """Teacher-forced decode from a prefilled cache at batch 4 (group 2),
    slots at ragged depths: every step's logits against the JAX package's
    with decode_attn "flat", on an f32 and a bf16 cache; every step takes
    K8."""
    jm, pm, jp, pp = models
    calls = _spy(monkeypatch)
    b, p, cap = 4, 5, 32
    kw = dict(cache_dtype=dtype)
    rng = np.random.default_rng(7)
    tokens = rng.integers(1, 128, (b, p))
    jc = jm.new_cache(b, cap, **kw)
    pc = pm.new_cache(b, cap, device="cpu", **kw)
    _, jc = jm.prefill(jp, jnp.asarray(tokens, jnp.int32), jc)
    _, pc = pm.prefill(pp, torch.from_numpy(tokens), pc)
    lens = np.array([p, 3, 1, p], np.int32)
    jc, pc = jc.with_lengths(jnp.asarray(lens)), pc.with_lengths(lens)
    tok = rng.integers(1, 128, b)
    worst = 0.0
    for _ in range(6):
        jl, jc = jm.decode_step(jp, jnp.asarray(tok, jnp.int32), jc)
        pl, pc = pm.decode_step(pp, torch.tensor(tok), pc)
        worst = max(worst, float(np.abs(pl.numpy() - np.asarray(jl)).max()))
        tok = np.asarray(jnp.argmax(jl, axis=-1))
    np.testing.assert_array_equal(pc.lengths.numpy(), np.asarray(jc.lengths))
    print(f"{dtype}: worst teacher-forced logit difference {worst:.3e}")
    assert set(calls) == {"decode_attn_flat_float"}
    assert worst < F32_LOGIT_TOL, worst


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flat_engine_tokens_match_reference(models, dtype, monkeypatch):
    """6 prompts through 4 slots (group 2), 12 new tokens each in bursts of
    4, slots recycling: with decode_attn "flat" the port's greedy tokens
    equal the JAX engine's on an f32 and a bf16 cache, every decode step
    through K8."""
    jm, pm, jp, pp = models
    calls = _spy(monkeypatch)
    prompts = [[1, 2, 3], [4, 5, 6, 7], [9, 10], [11, 3, 2], [5, 5], [7]]
    kw = dict(max_batch=4, capacity=64, prefill_buckets=(16,),
              cache_dtype=dtype)
    ref = JServingEngine(jm, jp, **kw).generate(prompts, 12, burst=4)
    eng = ServingEngine(pm, pp, device="cpu", **kw)
    out = eng.generate(prompts, 12, burst=4)
    assert eng._tail_flush == 0
    assert out == ref
    assert set(calls) == {"decode_attn_flat_float"}
