"""Parity of the port's group-wise int4 quantization and int4 GEMMs (their
plain PyTorch versions, which CPU tensors take) against the JAX package on
the CPU (Pallas in interpret mode), on inputs drawn with numpy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rten_tpu.kernels import gemm as jgemm
from rten_tpu.kernels import quant as jquant
from rten_tpu_torch.kernels import _build
from rten_tpu_torch.kernels import gemm as pg
from rten_tpu_torch.kernels import quant as pquant


def _t(a):
    return torch.from_numpy(np.array(a))


# -- quantization helpers: bit for bit ---------------------------------------

@pytest.mark.parametrize("shape", [(320, 300), (256, 512), (130, 256)])
@pytest.mark.parametrize("layout", ["words", "groupwise"])
def test_int4_quantize_and_dequantize_bit_exact(shape, layout):
    """quantize_int4_{words,groupwise} give the reference's packed data and
    scales bit for bit, K padded to the group and N to 256 included (an
    all-zero column group takes scale 1.0); the dequantized weights are
    equal too."""
    rng = np.random.default_rng(shape[0])
    w = rng.standard_normal(shape).astype(np.float32)
    w[:, 7] = 0
    quant = f"quantize_int4_{layout}"
    deq = f"dequantize_int4_{layout}"
    ref_p, ref_s = getattr(jquant, quant)(w)
    out_p, out_s = getattr(pquant, quant)(_t(w))
    assert out_p.dtype == (torch.int32 if layout == "words" else torch.uint8)
    np.testing.assert_array_equal(out_p.numpy(), np.asarray(ref_p))
    np.testing.assert_array_equal(out_s.numpy(), np.asarray(ref_s))
    np.testing.assert_array_equal(
        getattr(pquant, deq)(out_p, out_s).numpy(),
        np.asarray(getattr(jquant, deq)(jnp.asarray(ref_p),
                                        jnp.asarray(ref_s))))


@pytest.mark.parametrize("layout", ["words", "bytes"])
def test_int4_pack_round_trips_match_reference(layout):
    """pack/unpack of both layouts equal the reference's and invert each
    other on every value in [-8, 7]."""
    rng = np.random.default_rng(1)
    q = rng.integers(-8, 8, (64, 512)).astype(np.int8)
    if layout == "words":
        ref = jquant.pack_int4_words(q)
        out = pquant.pack_int4_words(_t(q))
        back, ref_back = (pquant.unpack_int4_words(out),
                          jquant.unpack_int4_words(ref))
    else:
        ref = jquant.pack_int4(q)
        out = pquant.pack_int4(_t(q))
        back, ref_back = pquant.unpack_int4(out), jquant.unpack_int4(ref)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(back.numpy(), q)
    np.testing.assert_array_equal(np.asarray(ref_back), q)


# -- the plain GEMMs against the reference kernels ----------------------------

def _case(m, k, n, seed, layout):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.02).astype(np.float32)
    quant = (jquant.quantize_int4_words if layout == "words"
             else jquant.quantize_int4_groupwise)
    packed, scales = (np.asarray(a) for a in quant(w))
    return x, packed, scales


def _bound(x, packed, scales, mode):
    """|Δ| <= 2^-20 x (sum of the magnitudes of every f32 term), in integer
    units times the row scale for the int8 mode: both sides compute the
    same formula from the same bf16 / int8 operands, and differ only in
    the order of f32 additions (K <= 2048 terms, each addition a 2^-24
    relative rounding; 2^-20 leaves room for sqrt-growth, not for any other
    error). The reference test's own bound is 2^-7 relative and up."""
    k = x.shape[1]
    group = k // scales.shape[0]
    s_rows = np.repeat(scales, group, axis=0)
    if mode == "bytes":
        q = np.asarray(jquant.unpack_int4(packed), np.float32)
        return 2.0 ** -20 * (np.abs(x) @ (np.abs(q) * s_rows))
    u = np.asarray(jquant.unpack_int4_words(packed), np.float32) + 8
    gsum = np.abs(x.reshape(x.shape[0], -1, group).sum(-1))
    if mode == "bf16":
        return 2.0 ** -20 * (np.abs(x) @ (u * s_rows) + 8 * gsum @ scales)
    absmax = np.abs(x).max(axis=1, keepdims=True)
    xscale = np.where(absmax == 0, 1.0, absmax / 127.0).astype(np.float32)
    xq = np.clip(np.round(x / xscale), -127, 127)
    qsum = np.abs(xq.reshape(x.shape[0], -1, group).sum(-1))
    return 2.0 ** -20 * (np.abs(xq) @ (u * s_rows) + 8 * qsum @ scales) \
        * xscale


# (M, K, block_k): one K block; several (block_k 1024 at K = 2048); a K
# that pads to the block (640 with 512); M not a multiple of 8; M > 64.
SHAPES = [(9, 256, 512), (13, 2048, 1024), (5, 640, 512), (100, 640, 512)]


@pytest.mark.parametrize("m,k,block_k", SHAPES)
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_matmul_int4_words_plain_matches_reference(m, k, block_k, mode):
    x, words, scales = _case(m, k, 512, m + k, "words")
    ref = np.asarray(jgemm.matmul_int4_words(
        jnp.asarray(x), jnp.asarray(words), jnp.asarray(scales),
        block_k=block_k, dot_mode=mode))
    out = pg.matmul_int4_words_plain(_t(x), _t(words), _t(scales),
                                     dot_mode=mode).numpy()
    assert out.shape == (m, 512)
    assert (np.abs(out - ref) <= _bound(x, words, scales, mode)).all()


@pytest.mark.parametrize("m,k,block_k", SHAPES)
def test_matmul_int4_plain_matches_reference(m, k, block_k):
    x, packed, scales = _case(m, k, 256, m * k, "bytes")
    ref = np.asarray(jgemm.matmul_int4(
        jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scales),
        block_k=block_k))
    out = pg.matmul_int4_plain(_t(x), _t(packed), _t(scales)).numpy()
    assert (np.abs(out - ref) <= _bound(x, packed, scales, "bytes")).all()


def test_int4_words_formula_is_not_the_dequantized_product():
    """The word kernel rounds u * s (not q * s) to bf16 and corrects with
    the unrounded x, so it differs from bf16(x) @ bf16(q * s) by more than
    the summation-order bound: the port follows the reference's formula."""
    x, words, scales = _case(8, 256, 256, 4, "words")
    wq = np.asarray(jquant.dequantize_int4_words(words, scales))
    naive = (np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
             @ np.asarray(jnp.asarray(wq, jnp.bfloat16), np.float32))
    out = pg.matmul_int4_words_plain(_t(x), _t(words), _t(scales)).numpy()
    bound = _bound(x, words, scales, "bf16")
    assert (np.abs(out - naive) > bound).any()


@pytest.mark.parametrize("wrapper,layout", [
    (pg.matmul_int4_words, "words"), (pg.matmul_int4_words_int8, "words"),
    (pg.matmul_int4, "bytes")], ids=["words", "words_int8", "bytes"])
def test_int4_wrappers_never_fall_back_off_the_cpu(wrapper, layout):
    """A wrapper runs its plain version only for CPU tensors: tensors on
    another device (meta here), or on mixed devices, raise instead, and no
    launch is counted."""
    x, packed, scales = (_t(a) for a in _case(4, 128, 256, 0, layout))
    before = wrapper.launches
    assert wrapper(x, packed, scales).shape == (4, 256)
    assert wrapper.launches == before
    with pytest.raises(ValueError):
        wrapper(x.to("meta"), packed.to("meta"), scales.to("meta"))
    with pytest.raises(ValueError):
        wrapper(x.to("meta"), packed, scales)


@pytest.mark.parametrize("bad", ["n", "group", "dtype", "contraction"])
def test_int4_wrappers_reject_bad_shapes(bad):
    x, words, scales = (_t(a) for a in _case(4, 256, 256, 0, "words"))
    args, kw = (x, words, scales), {}
    if bad == "n":
        args = (x, words[:, :64], scales[:, :128])
    elif bad == "group":
        kw = dict(group=96)
    elif bad == "dtype":
        args = (x, words.to(torch.uint8), scales)
    else:
        args = (x[:, :128], words, scales)
    with pytest.raises(ValueError):
        pg.matmul_int4_words(*args, **kw)


def test_int4_kernel_refuses_a_group_it_does_not_tile(monkeypatch):
    """On CUDA (simulated) a group that is not a multiple of the kernel's
    64-deep K step raises before any build or launch."""
    monkeypatch.setattr(_build, "on_cpu", lambda name, *tensors: False)
    x, words, _ = (_t(a) for a in _case(4, 128, 256, 0, "words"))
    s32 = torch.ones((4, 256))
    with pytest.raises(ValueError, match="multiple of 64"):
        pg.matmul_int4_words(x, words, s32, group=32)
