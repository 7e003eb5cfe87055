"""Parity of the speculative path's cache and attention pieces
(``rten_tpu_torch`` on the CPU, where the kernels' plain versions run)
against the JAX package (CPU backend, Pallas in interpret mode), on inputs
drawn with numpy: ``verify_attn_grouped`` and ``verify_attn_fused`` (V1)
against ``flash_verify_grouped`` and ``flash_verify_fused`` on float and
int8 caches, and the chunked append at per-sequence depths against the
reference's ``KVCache.append``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rten_tpu.generate.kv_cache import KVCache as JKVCache
from rten_tpu.kernels.attention import (flash_verify_fused,
                                        flash_verify_grouped)
from rten_tpu_torch.generate.kv_cache import KVCache
from rten_tpu_torch.kernels import attention as at
from test_torch_kernels import port_layout

KVH, D = 2, 64
# A capacity that both reference kernels' blocks divide (grouped 64, fused
# 128), so their Pallas bodies run instead of the jnp fallback.
CAP = 128
# Float mode: both sum in f32 in other orders (an online softmax over
# blocks against the plain two-pass softmax): 1e-5 of max |out|, K6's.
FLOAT_REL_TOL = 1e-5
# Int8 mode: the int8 bytes and bf16 scales are exact in f32 and nothing is
# rounded to bf16, so the same f32 order argument holds: K6's 1e-5 is kept
# (the largest gap over these cases is 2.2e-7 of max |out| in float mode
# and 1.9e-7 in int8 mode).
INT8_REL_TOL = 1e-5

JDTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _t(a):
    return torch.from_numpy(np.array(a))


def _lengths(b, s):
    """Pre-chunk lengths that straddle 4-token boundaries, with one
    sequence whose chunk ends at the capacity."""
    return np.resize(np.array([0, 3, 4, 5, 37, CAP - s, 61, 64], np.int32),
                     b)


def _int8_cache(rng, b):
    """A reference int8 cache (token-packed rows, pair-packed scales) over
    the whole capacity, and the same values in the port's layout."""
    jc = JKVCache.create(b, 1, KVH, CAP, D, quantized=True)
    pre = [rng.standard_normal((b, KVH, CAP, D)).astype(np.float32)
           for _ in range(2)]
    jc = jc.append(0, jnp.asarray(pre[0]), jnp.asarray(pre[1]), position=0)
    kv, scales = port_layout(jc, 0)
    return jc.kv[0], jc.quant_scales[0], kv, scales


# (entry, batch, group): groups 4 and 2 for the grouped kernel, the batches
# with no group (3 and 1) for the fused one.
ENTRIES = [("grouped", 8, 4), ("grouped", 8, 2), ("fused", 3, 0),
           ("fused", 1, 0)]


@pytest.mark.parametrize("s", [1, 2, 4])
@pytest.mark.parametrize("mode", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("entry,b,group", ENTRIES)
def test_verify_attn_plain_matches_reference(entry, b, group, mode, s):
    """V1's plain versions against flash_verify_grouped (groups 4 and 2)
    and flash_verify_fused (batches 3 and 1) with GQA (4 query heads on 2
    kv heads), S 1, 2 and 4, ragged lengths, on f32, bf16 and int8
    caches."""
    rng = np.random.default_rng(100 + 10 * b + s + 3 * group)
    h = 4
    q = rng.standard_normal((b, s, h, D)).astype(np.float32)
    lengths = _lengths(b, s)
    if mode == "int8":
        jkv, jscales, kv, scales = _int8_cache(rng, b)
    else:
        raw = rng.standard_normal((b, CAP, 2, KVH * D)).astype(np.float32)
        jkv, jscales = jnp.asarray(raw, JDTYPES[mode]), None
        kv = _t(np.asarray(jkv.astype(jnp.float32))).to(TDTYPES[mode])
        scales = None
    if entry == "grouped":
        ref = flash_verify_grouped(jnp.asarray(q), jkv, jnp.asarray(lengths),
                                   KVH, group=group, kv_scales=jscales)
        wrapper = at.verify_attn_grouped
    else:
        ref = flash_verify_fused(jnp.asarray(q), jkv, jnp.asarray(lengths),
                                 KVH, kv_scales=jscales)
        wrapper = at.verify_attn_fused
    ref = np.asarray(ref)
    before = wrapper.launches
    out = wrapper(_t(q), kv, _t(lengths), scales)
    assert wrapper.launches == before             # the plain version ran
    assert out.shape == (b, s, h, D) and out.dtype == torch.float32
    tol = (INT8_REL_TOL if mode == "int8" else FLOAT_REL_TOL)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=tol * np.abs(ref).max())


def test_verify_attn_is_causal_within_the_chunk():
    """Query i reads rows below lengths + i + 1: a row written past it
    changes only the later queries' outputs."""
    rng = np.random.default_rng(7)
    b, s, h = 2, 4, 4
    q = _t(rng.standard_normal((b, s, h, D)).astype(np.float32))
    kv = _t(rng.standard_normal((b, CAP, 2, KVH * D)).astype(np.float32))
    lengths = _t(np.array([5, 20], np.int32))
    out = at.verify_attn_fused(q, kv, lengths)
    kv2 = kv.clone()
    kv2[:, 7] += 1.0                     # row 7: query 2 of sequence 0 on
    out2 = at.verify_attn_fused(q, kv2, lengths)
    assert torch.equal(out[0, :2], out2[0, :2])
    assert not torch.equal(out[0, 2:], out2[0, 2:])
    assert not torch.equal(out[1], out2[1])


@pytest.mark.parametrize("wrapper", [at.verify_attn_grouped,
                                     at.verify_attn_fused])
def test_verify_wrappers_never_fall_back_off_the_cpu(wrapper):
    """The plain version runs only for CPU tensors: meta tensors (another
    device) or mixed devices raise, in both modes; S above 8 raises."""
    b, s = 2, 3
    q = torch.zeros((b, s, 4, D))
    lengths = torch.ones(b, dtype=torch.int32)
    for kv, scales in (
            (torch.zeros((b, CAP, 2, KVH * D)), None),
            (torch.zeros((b, CAP, 2, KVH * D), dtype=torch.int8),
             torch.ones((b, CAP, 2, KVH), dtype=torch.bfloat16))):
        args = [q, kv, lengths] + ([] if scales is None else [scales])
        before = wrapper.launches
        wrapper(*args)
        assert wrapper.launches == before
        with pytest.raises(ValueError):
            wrapper(*[a.to("meta") for a in args])
        with pytest.raises(ValueError):
            wrapper(*([args[0].to("meta")] + args[1:]))
    with pytest.raises(ValueError, match="S=9"):
        wrapper(torch.zeros((b, 9, 4, D)), torch.zeros((b, CAP, 2, KVH * D)),
                lengths)


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("t", [2, 4, 5])
def test_chunked_append_bit_exact_against_reference(kind, t):
    """A chunk of T tokens appended at per-sequence depths equals the
    reference's ``KVCache.append(position=None)`` bit for bit (f32, bf16
    and int8 caches; int8 read back through the port's layout), with one
    sequence at cap - T + 1 and one past capacity, where the start clamps
    to cap - T, and depths that straddle 4-token rows."""
    rng = np.random.default_rng(200 + t)
    b = 6
    quant = kind == "int8"
    dtype = None if quant else JDTYPES[kind]
    kw = dict(quantized=True) if quant else dict(dtype=dtype)
    jc = JKVCache.create(b, 1, KVH, CAP, D, **kw)
    pc = KVCache.create(b, 1, KVH, CAP, D, quantized=quant,
                        dtype=torch.float32 if quant else TDTYPES[kind],
                        device="cpu")
    pre = [rng.standard_normal((b, KVH, CAP, D)).astype(np.float32)
           for _ in range(2)]
    jc = jc.append(0, jnp.asarray(pre[0]), jnp.asarray(pre[1]), position=0)
    pc = pc.append(0, _t(pre[0]), _t(pre[1]), position=0)
    lengths = np.array([0, 3, 6, 37, CAP - t + 1, CAP + 5], np.int32)
    jc = jc.with_lengths(jnp.asarray(lengths))
    pc = pc.with_lengths(lengths)
    k, v = (rng.standard_normal((b, KVH, t, D)).astype(np.float32)
            * np.exp(rng.uniform(-3, 3, (b, KVH, t, 1))).astype(np.float32)
            for _ in range(2))
    k[1, 0, 0] = 0.0                     # an all-zero head: scale 1.0
    jc = jc.append(0, jnp.asarray(k), jnp.asarray(v))
    pc = pc.append(0, _t(k), _t(v))
    if quant:
        ref_kv, ref_scales = port_layout(jc, 0)
        assert torch.equal(pc.kv[0], ref_kv)
        assert torch.equal(pc.scales[0], ref_scales)
    else:
        ref = np.asarray(jc.kv[0].astype(jnp.float32))
        np.testing.assert_array_equal(pc.kv[0].float().numpy(), ref)
    np.testing.assert_array_equal(pc.lengths.numpy(), lengths)
