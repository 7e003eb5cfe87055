"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small and ragged shapes (chip_smoke.py holds them at the serving path's
shapes). Marked ``cuda``; without a card every test skips. The stress
cases of tests/test_numerics.py live here too (``numerics_case``), so the
CPU parity tests and the card tests share them.

This file imports no jax, so it also runs where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from rten_tpu_torch.generate import ServingEngine
from rten_tpu_torch.kernels import attention as at
from rten_tpu_torch.kernels import cache as kc
from rten_tpu_torch.kernels import gemm as pg
from rten_tpu_torch.kernels.quant import (abs_max_quantize_int8,
                                          dynamic_quantize, pack_int4,
                                          pack_int4_words,
                                          quantize_int4_groupwise,
                                          quantize_int4_words,
                                          quantize_tokens, unpack_int4,
                                          unpack_int4_words)
from rten_tpu_torch.models import (QuantWeight, TransformerConfig,
                                   TransformerLM, quantize_weights)
from rten_tpu_torch.models import transformer as ptr
from rten_tpu_torch.models.transformer import linear

NUMERICS_CASES = ("extreme_exponents", "score_ties", "underflow_tail")

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _cache(gen, b, cap, rows, kvh, d):
    f = kvh * d
    kv = torch.randint(-127, 128, (b, cap, 2, f), device="cuda",
                       dtype=torch.int8, generator=gen)
    scales = (0.01 + 0.02 * torch.rand((b, cap, 2, kvh), device="cuda",
                                       generator=gen)).to(torch.bfloat16)
    tail = torch.randn((b, rows, 2, f), device="cuda",
                       generator=gen).to(torch.bfloat16)
    return kv, scales, tail


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("tail_count", [1, 5, 8])
def test_decode_attn_kernel_matches_plain(gen, d, tail_count):
    """GQA (4 query heads on 2 kv heads), lengths from below the window
    fill to past capacity (both clamp), window fills 1..R."""
    b, h, kvh, cap, rows = 6, 4, 2, 64, 8
    kv, scales, tail = _cache(gen, b, cap, rows, kvh, d)
    q = torch.randn((b, h, d), device="cuda", generator=gen)
    lengths = torch.tensor([0, 1, 17, 40, cap + tail_count, cap + 30],
                           dtype=torch.int32, device="cuda")
    args = (q, kv, scales, lengths, tail, tail_count)
    before = at.decode_attn_int8_tail.launches
    out = at.decode_attn_int8_tail(*args)
    ref = at.decode_attn_int8_tail_plain(*args)
    torch.cuda.synchronize()
    assert at.decode_attn_int8_tail.launches == before + 1
    assert torch.isfinite(out).all()
    # Outputs rounded to bf16 after f32 sums in other orders: two bf16
    # steps of the largest output.
    tol = 2.0 ** -6 * ref.abs().max().item()
    assert (out - ref).abs().max().item() <= tol


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("tail_count", [0, 1, 5])
def test_decode_attn_exact_q_kernel_matches_plain(gen, d, tail_count):
    """K1's and K1''s exact-q mode (``RTEN_FLAT_QBF16=0``): q, the sums and
    the output stay f32, so the kernel meets its plain version within
    1e-5 of max |out|, with the window (fills 1 and 5) and without it (0),
    one chunk and several (capacity 4096)."""
    for b, cap, lens in ((6, 64, [0, 1, 17, 40, 64 + tail_count, 94]),
                         (2, 4096, [4000, 4096 + tail_count])):
        kv, scales, tail = _cache(gen, b, cap, 8, 2, d)
        q = torch.randn((b, 4, d), device="cuda", generator=gen)
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        if tail_count:
            wrapper, args = at.decode_attn_int8_tail, (q, kv, scales, lengths,
                                                       tail, tail_count)
            plain = at.decode_attn_int8_tail_plain
        else:
            wrapper, args = at.decode_attn_int8, (q, kv, scales, lengths)
            plain = at.decode_attn_int8_plain
        before = wrapper.mode_launches["exact"]
        out = wrapper(*args, q_bf16=False)
        ref = plain(*args, q_bf16=False)
        torch.cuda.synchronize()
        assert wrapper.mode_launches["exact"] == before + 1
        assert torch.isfinite(out).all()
        err = (out - ref).abs().max().item()
        assert err <= 1e-5 * ref.abs().max().item()
        # Exact: the rounded mode's output is not within that.
        rounded = wrapper(*args)
        assert (rounded - ref).abs().max().item() > err


# (head_dim, the window a misaligned view, the instance): the wide
# instance at head_dim 64 and 128, the narrow one at 96 and on a window
# that starts 2 bytes past a 16-byte boundary.
FLUSH_LAYOUTS = [(64, False, True), (128, False, True), (96, False, False),
                 (64, True, False)]


@pytest.mark.parametrize("d,misaligned,wide", FLUSH_LAYOUTS)
@pytest.mark.parametrize("t", range(1, 17))
def test_tail_flush_kernel_bit_exact(gen, t, d, misaligned, wide):
    """K3 bit for bit against its plain version: every t in 1..16 of an R
    16 window (t < R: the partial flushes before admissions), an all-zero
    head, a tiny absmax, lengths below t, at and past capacity, in its
    wide and narrow instances; one launch counted, and at t 5 and 16 one
    CUDA kernel a call."""
    b, cap, rows, kvh = 8, 64, 16, 2
    kv, scales, tail = _cache(gen, b, cap, rows, kvh, d)
    if misaligned:
        flat = torch.empty(tail.numel() + 8, dtype=tail.dtype,
                           device="cuda")
        tail = flat[1:1 + tail.numel()].view(tail.shape).copy_(tail)
    tail[0, 0, 1, :d] = 0                  # all-zero head: scale 1.0
    tail[1, 0, 0, :d] = 1e-30              # tiny absmax
    lengths = torch.tensor([t, t + 1, 0, 5, 31, cap, cap + 5, 2 * cap],
                           dtype=torch.int32, device="cuda")
    assert kc.tail_flush_wide(d, tail, kv) == wide
    kv1, s1, kv2, s2 = kv.clone(), scales.clone(), kv.clone(), scales.clone()
    before = kc.tail_flush_int8.launches
    kc.tail_flush_int8(tail, kv1, s1, lengths, t)
    kc.tail_flush_int8_plain(tail, kv2, s2, lengths, t)
    torch.cuda.synchronize()
    assert kc.tail_flush_int8.launches == before + 1
    assert torch.equal(kv1, kv2) and torch.equal(s1, s2)
    if t in (5, 16):
        assert _cuda_kernels_a_call(
            lambda: kc.tail_flush_int8(tail, kv1, s1, lengths, t)) == 1


def _weights(gen, k, n):
    w = 0.02 * torch.randn((k, n), device="cuda", generator=gen)
    return pg.pad_cols(*abs_max_quantize_int8(w, axis=0))


@pytest.mark.parametrize("m", [1, 7, 64, 100])
def test_matmul_wo_kernel_matches_plain(gen, m):
    k, n = 80, 200                          # ragged K and N tiles
    w, s = _weights(gen, k, n)
    x = torch.randn((m, k), device="cuda", generator=gen)
    out = pg.matmul_int8_wo(x, w, s)
    ref = pg.matmul_int8_wo_plain(x, w, s)
    torch.cuda.synchronize()
    # Same bf16 operands and f32 accumulation, sums in other orders.
    tol = 2.0 ** -8 * ref.abs().max().item()
    assert (out - ref).abs().max().item() <= tol


@pytest.mark.parametrize("m", [1, 32, 64, 100])
def test_matmul_wo_kernel_at_the_main_path_shape(gen, m):
    """K4 on K2's tiles at GPT-2's padded LM head (K 768, N 50264): M 1, 32
    ((G)'s verify head), 64 (the largest admission group) on the register
    tile, 100 on the wgmma tile; every column stored, one launch a call."""
    w, s = _weights(gen, 768, 50257)
    x = torch.randn((m, 768), device="cuda", generator=gen)
    before = pg.matmul_int8_wo.launches
    out = pg.matmul_int8_wo(x, w, s)
    ref = pg.matmul_int8_wo_plain(x, w, s)
    torch.cuda.synchronize()
    assert pg.matmul_int8_wo.launches == before + 1
    assert out.shape == (m, 50264) and torch.isfinite(out).all()
    tol = 2.0 ** -8 * ref.abs().max().item()
    assert (out - ref).abs().max().item() <= tol


@pytest.mark.parametrize("m", [16, 64, 100])
def test_matmul_wo_kernel_is_deterministic(gen, m):
    """Two calls on the same inputs give the same bits (no atomics, a
    fixed summation order)."""
    w, s = _weights(gen, 768, 50257)
    x = torch.randn((m, 768), device="cuda", generator=gen)
    a = pg.matmul_int8_wo(x, w, s)
    b = pg.matmul_int8_wo(x, w, s)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("m", [1, 3, 65, 130])
def test_head_argmax_kernel_matches_plain(gen, m):
    k, n = 80, 1000
    w, s = _weights(gen, k, n)
    x = torch.randn((m, k), device="cuda", generator=gen)
    idx = pg.head_argmax_int8(x, w, s, n_valid=n)
    ref = pg.head_argmax_int8_plain(x, w, s, n_valid=n)
    logits = pg.matmul_int8_wo_plain(x, w, s)[:, :n]
    torch.cuda.synchronize()
    top = logits.topk(2, dim=-1).values
    near = (top[:, 0] - top[:, 1]) < 1e-3
    assert ((idx == ref) | near).all()


def test_head_argmax_kernel_ties_go_to_the_lowest_index(gen):
    """Columns that tie for the maximum in two warps of the first
    vocabulary slab (64 columns a warp), in the next slab and in a later
    one, at the tile the kernel takes for these rows: the lowest wins; the
    padding columns past n_valid (995 is padded to 1000) never win,
    however large."""
    k, n, m = 64, 995, 4
    slab = pg.head_argmax_plan(m, k, 1000)["slab"]
    tied = (5, 64 + 6, slab + 7, 3 * slab + 4)
    assert tied[-1] < n and len({c // slab for c in tied}) == 3
    w, s = _weights(gen, k, n)
    x = torch.rand((m, k), device="cuda", generator=gen)
    for c in tied:
        w[:, c] = 127
        s[c] = 1.0
    assert w.shape[1] == 1000
    w[:, n:] = 127
    s[n:] = 100.0
    idx = pg.head_argmax_int8(x, w, s, n_valid=n)
    torch.cuda.synchronize()
    assert idx.tolist() == [5] * m


@pytest.mark.parametrize("m", [1, 3, 65, 130, 256, 300])
def test_head_argmax_kernel_at_the_main_path_shape(gen, m):
    """GPT-2's padded LM head (K 768, N 50264) with n_valid 50257 inside
    the last vocabulary slab, at every tile of the kernel (M 1 to past one
    256-row block): indices equal the plain version's except on rows whose
    top-2 margin is below 1e-3; one launch a call."""
    k, n_valid = 768, 50257
    w, s = _weights(gen, k, n_valid)
    plan = pg.head_argmax_plan(m, k, w.shape[1])
    assert (plan["slabs"] - 1) * plan["slab"] < n_valid
    x = torch.randn((m, k), device="cuda", generator=gen)
    before = pg.head_argmax_int8.launches
    idx = pg.head_argmax_int8(x, w, s, n_valid=n_valid)
    ref = pg.head_argmax_int8_plain(x, w, s, n_valid=n_valid)
    logits = pg.matmul_int8_wo_plain(x, w, s)[:, :n_valid]
    torch.cuda.synchronize()
    assert pg.head_argmax_int8.launches == before + 1
    assert idx.shape == (m,) and int(idx.max()) < n_valid
    top = logits.topk(2, dim=-1).values
    near = (top[:, 0] - top[:, 1]) < 1e-3
    assert ((idx == ref) | near).all()


def test_decode_steps_on_the_card_match_the_cpu(gen):
    """Teacher-forced decode through every kernel of the serving path
    (tail window, flush, fused head) on the card against the same model
    on the CPU, where the plain versions run: logits heads and fused
    argmax heads each on a cache of their own."""
    model = TransformerLM(TransformerConfig.tiny_test(n_heads=2,
                                                      d_model=128))
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(1, 128, (4, 5)))
    params, caches = {}, {}
    for dev in ("cpu", "cuda"):
        params[dev] = quantize_weights(model.init_params(3, device=dev))
        for head in ("logits", "argmax"):
            c = model.new_cache(4, 64, quantized=True, tail_window=8,
                                device=dev)
            _, c = model.prefill(params[dev], prompt.to(dev), c)
            caches[dev, head] = c.with_lengths([5] * 4)
    tok = torch.from_numpy(rng.integers(1, 128, 4))
    for step in range(11):
        logits, nxt = {}, {}
        for dev in ("cpu", "cuda"):
            lg, caches[dev, "logits"] = model.decode_step(
                params[dev], tok.to(dev), caches[dev, "logits"])
            nxt[dev], caches[dev, "argmax"] = model.decode_step_argmax(
                params[dev], tok.to(dev), caches[dev, "argmax"])
            logits[dev], nxt[dev] = lg.cpu(), nxt[dev].cpu()
            for head in ("logits", "argmax"):
                if caches[dev, head].tail_count == 8:
                    caches[dev, head] = caches[dev, head].flush_tail(8)
        assert (logits["cuda"] - logits["cpu"]).abs().max() < 1e-2, step
        top = logits["cpu"].topk(2, dim=-1).values
        near = (top[:, 0] - top[:, 1]) < 1e-2
        for got in (nxt["cuda"], nxt["cpu"]):
            assert ((got == logits["cpu"].argmax(-1)) | near).all(), step
        tok = logits["cpu"].argmax(-1)


# -- float-cache and no-tail int8 decode --------------------------------------

def numerics_case(name):
    """The three decode cases of tests/test_numerics.py, with their bounds:
    (q, k, v [B, H, cap, D] in f64, lengths, max ULP, relative escape)."""
    b, h, cap, d = 4, 2, 128, 64
    if name == "extreme_exponents":
        rng = np.random.RandomState(1)
        mags = 2.0 ** rng.uniform(-24, 24, (b, h, cap, 1))
        k = rng.randn(b, h, cap, d) * mags
        v = rng.randn(b, h, cap, d)
        q = rng.randn(b, h, d).astype(np.float32)
        return q, k, v, np.array([1, 31, 32, cap]), 512, 1e-4
    if name == "score_ties":
        rng = np.random.RandomState(2)
        k = np.tile(rng.randn(b, h, 1, d), (1, 1, cap, 1))
        v = rng.randn(b, h, cap, d)
        q = rng.randn(b, h, d)
        return q, k, v, np.array([cap, cap - 1, 33, 2]), 512, 1e-4
    assert name == "underflow_tail"
    rng = np.random.RandomState(3)
    k = rng.randn(b, h, cap, d) * 0.01
    dom = rng.randint(0, 30, b)
    q = rng.randn(b, h, d)
    for i in range(b):
        k[i, :, dom[i]] = 40 * q[i] / np.linalg.norm(q[i], axis=-1,
                                                     keepdims=True)
    v = rng.randn(b, h, cap, d)
    return q, k, v, np.full(b, 31), 64, 1e-4


def fused_kv(k, v):
    """[B, H, cap, D] K and V → the token-major f32 [B, cap, 2, H*D]
    cache."""
    b, h, cap, d = k.shape
    return np.stack([k.transpose(0, 2, 1, 3).reshape(b, cap, h * d),
                     v.transpose(0, 2, 1, 3).reshape(b, cap, h * d)],
                    axis=2).astype(np.float32)


def numerics_ok(got, q, k, v, lengths, max_ulp, rel):
    """Assert tests/test_numerics.py's bound: per element, within
    ``max_ulp`` f32 ULPs of the fp64 attention or within ``rel`` of it."""
    q, k, v = (np.asarray(x, np.float64) for x in (q, k, v))
    want = np.zeros(q.shape)
    for i in range(q.shape[0]):
        sc = (np.einsum("hd,hkd->hk", q[i], k[i, :, :lengths[i]])
              / np.sqrt(q.shape[-1]))
        p = np.exp(sc - sc.max(axis=1, keepdims=True))
        want[i] = np.einsum("hk,hkd->hd", p / p.sum(axis=1, keepdims=True),
                            v[i, :, :lengths[i]])

    def key(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    got = np.asarray(got, np.float32)
    assert np.isfinite(got).all()
    ulp = np.abs(key(got) - key(want.astype(np.float32)))
    relerr = np.abs(got - want) / (np.abs(want) + 1e-300)
    assert ((ulp <= max_ulp) | (relerr <= rel)).all(), (ulp.max(),
                                                         relerr.max())


def rows_view(x, offset=0):
    """x [B, KVH, 1, D] as the model hands it over: a strided view into a
    fused [B, 1, 3F] projection output (with ``offset`` 1, one f32 element
    later in a row one longer: neither the rows nor their stride 16-byte
    aligned)."""
    b, kvh, _, d = x.shape
    f = kvh * d
    qkv = torch.zeros((b, 1, 3 * f + offset), device=x.device)
    qkv[:, 0, f + offset:2 * f + offset] = x.reshape(b, f)
    return qkv[..., f + offset:2 * f + offset].reshape(
        b, 1, kvh, d).transpose(1, 2)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("b,kvh", [(6, 3), (1, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kv_append_kernel_bit_exact(gen, dtype, b, kvh, d, offset):
    """K5 (K7's kernel body, float rows) against its plain version bit for
    bit on f32 and bf16 caches: the wide instance (head_dim 64 and 128 on
    aligned rows) and the narrow one (head_dim 16, and rows_view's offset
    1: neither the rows nor their stride 16-byte aligned), at batches whose
    36 or 4 rows do not fill a block of 16, lengths 0 to past capacity; one
    launch counted and one CUDA kernel a call."""
    cap = 64
    kv = torch.randn((b, cap, 2, kvh * d), device="cuda",
                     generator=gen).to(dtype)
    k = rows_view(torch.randn((b, kvh, 1, d), device="cuda", generator=gen),
                  offset)
    v = rows_view(torch.randn((b, kvh, 1, d), device="cuda", generator=gen),
                  offset)
    lengths = torch.tensor([0, 1, 17, cap - 1, cap, cap + 9][-b:],
                           dtype=torch.int32, device="cuda")
    assert kc.kv_append_wide(d, kv, k.reshape(b, -1), v.reshape(b, -1)) == (
        d in (64, 128) and offset == 0)
    kv1, kv2 = kv.clone(), kv.clone()
    before = kc.kv_append.launches
    kc.kv_append(kv1, k, v, lengths)
    kc.kv_append_plain(kv2, k, v, lengths)
    torch.cuda.synchronize()
    assert kc.kv_append.launches == before + 1
    assert torch.equal(kv1, kv2) and not torch.equal(kv1, kv)
    assert _cuda_kernels_a_call(lambda: kc.kv_append(kv1, k, v,
                                                     lengths)) == 1


# K7's shapes (batch, KV heads, head_dim, row offset): path (B)'s heads at
# batch 8, path (H)'s (8 KV heads of 128) at batch 16 and 1, batches whose
# rows do not fill a block of 16 rows (3 x 2 x 2 = 12, 5 x 2 x 3 = 30), and
# the narrow instance: head_dim 16 (the small test configs) and 80, and
# head_dim 64 with unaligned rows.
K7_SHAPES = [(8, 2, 64, 0), (16, 8, 128, 0), (1, 8, 128, 0), (3, 2, 64, 0),
             (5, 3, 128, 0), (4, 2, 16, 0), (3, 2, 80, 0), (6, 2, 64, 1)]


def _k7_positions(b, cap, masked):
    """Positions from negative (masked: nothing written) through past the
    capacity (clamped), rotated so that batch 1 takes a live one."""
    pos = [1, 5, 31, cap - 1, cap, cap + 5, 2 * cap, -1 if masked else 0]
    return torch.tensor(np.resize(pos, b), dtype=torch.int32, device="cuda")


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,kvh,d,offset", K7_SHAPES, ids=str)
def test_kv_append_int8_kernel_bit_exact(gen, masked, b, kvh, d, offset):
    """K7 against its plain version bit for bit (bytes and scales), both
    ``masked`` modes, wide and narrow instances; one launch counted and one
    CUDA kernel a call."""
    cap = 64
    kv, scales, _ = _cache(gen, b, cap, 1, kvh, d)
    x = torch.randn((b, kvh, 1, d), device="cuda", generator=gen)
    x = x * torch.exp(4 * torch.rand((b, kvh, 1, 1), device="cuda",
                                     generator=gen) - 3)
    x[0, min(1, kvh - 1)] = 0              # all-zero head: scale 1.0
    x[-1, 0] = 1e-30                       # tiny absmax
    k, v = rows_view(x, offset), rows_view(x.flip(0), offset)
    pos = _k7_positions(b, cap, masked)
    kv1, s1, kv2, s2 = kv.clone(), scales.clone(), kv.clone(), scales.clone()
    before = kc.kv_append_int8.launches
    kc.kv_append_int8(kv1, s1, k, v, pos, masked=masked)
    kc.kv_append_int8_plain(kv2, s2, k, v, pos, masked=masked)
    torch.cuda.synchronize()
    assert kc.kv_append_int8.launches == before + 1
    assert torch.equal(kv1, kv2) and torch.equal(s1, s2)
    if masked:
        off = (pos < 0).nonzero()[:, 0]
        assert torch.equal(kv1[off], kv[off])
        assert torch.equal(s1[off], scales[off])
    assert _cuda_kernels_a_call(
        lambda: kc.kv_append_int8(kv1, s1, k, v, pos, masked=masked)) == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kvh,d,cap", [
    (6, 4, 2, 64, 64), (1, 12, 12, 64, 512), (3, 8, 2, 128, 96),
    (5, 2, 1, 256, 40), (4, 4, 4, 64, 2048)])
def test_decode_attn_float_kernel_matches_plain(gen, dtype, b, h, kvh, d,
                                                cap):
    """GQA and plain heads, head_dim 64-256, batch 1 and odd batches (no
    block layout assumes a group), lengths 0 through past capacity, and a
    2048-token cache (no shared-memory limit on capacity)."""
    q = torch.randn((b, h, d), device="cuda", generator=gen)
    kv = torch.randn((b, cap, 2, kvh * d), device="cuda",
                     generator=gen).to(dtype)
    lengths = torch.tensor([1, cap, 0, 37, cap + 9, cap - 1][:b],
                           dtype=torch.int32, device="cuda")
    before = at.decode_attn_float.launches
    out = at.decode_attn_float(q, kv, lengths)
    ref = at.decode_attn_float_plain(q, kv, lengths)
    torch.cuda.synchronize()
    assert at.decode_attn_float.launches == before + 1
    assert torch.isfinite(out).all()
    # f32 sums in other orders (online softmax per warp against an exact
    # two-pass softmax): 1e-5 of the largest output.
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


# K6's plan shapes (batch, heads, KV heads, capacity): paths (A) and (C),
# batch 3 (the reference's fused fallback: 8 splits at head_dim 64) and
# TinyLlama's GQA (32 query heads over 4 KV heads: 4 splits of 8 warps).
K6_PLAN_SHAPES = [(256, 12, 12, 512), (3, 12, 12, 512), (16, 32, 4, 2048)]


@pytest.mark.parametrize("shape", K6_PLAN_SHAPES, ids=str)
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attn_float_kernel_at_its_plan_shapes(gen, dtype, d, shape):
    """K6 on the KV-group kernel at its plan's shapes and head_dim 64, 128
    and 256, f32 and bf16 caches: ragged lengths from 0 (zeros) through
    the capacity and past it, within 1e-5 of max |out| of the plain
    version; one launch counted and one CUDA kernel a call."""
    b, h, kvh, cap = shape
    q = torch.randn((b, h, d), device="cuda", generator=gen)
    kv = torch.randn((b, cap, 2, kvh * d), device="cuda",
                     generator=gen).to(dtype)
    lengths = torch.randint(1, cap + 40, (b,), device="cuda", generator=gen,
                            dtype=torch.int32)
    lengths[:3] = torch.tensor([0, cap + 9, cap], dtype=torch.int32)[:b]
    before = at.decode_attn_float.launches
    out = at.decode_attn_float(q, kv, lengths)
    ref = at.decode_attn_float_plain(q, kv, lengths)
    torch.cuda.synchronize()
    assert at.decode_attn_float.launches == before + 1
    assert torch.isfinite(out).all()
    assert not out[0].any()
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    assert _cuda_kernels_a_call(
        lambda: at.decode_attn_float(q, kv, lengths)) == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attn_float_kernel_refuses_an_unaligned_cache(gen, dtype):
    """K6 stages rows by 16-byte copies: a cache that does not start on a
    16-byte boundary raises before any launch; the same cache aligned
    runs."""
    b, h, kvh, d, cap = 2, 4, 2, 64, 32
    q = torch.randn((b, h, d), device="cuda", generator=gen)
    n = b * cap * 2 * kvh * d
    flat = torch.zeros(n + 8, device="cuda", dtype=dtype)
    lengths = torch.tensor([5, cap], dtype=torch.int32, device="cuda")
    before = at.decode_attn_float.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        at.decode_attn_float(q, flat[1:n + 1].view(b, cap, 2, kvh * d),
                             lengths)
    assert at.decode_attn_float.launches == before
    out = at.decode_attn_float(q, flat[8:].view(b, cap, 2, kvh * d), lengths)
    assert at.decode_attn_float.launches == before + 1
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("name", NUMERICS_CASES)
def test_decode_attn_float_kernel_numerics(gen, name):
    """tests/test_numerics.py's online-softmax stress cases on the card, at
    the reference's own bounds against fp64."""
    q, k, v, lengths, max_ulp, rel = numerics_case(name)
    got = at.decode_attn_float(
        torch.from_numpy(np.asarray(q, np.float32)).cuda(),
        torch.from_numpy(fused_kv(k, v)).cuda(),
        torch.from_numpy(lengths.astype(np.int32)).cuda())
    numerics_ok(got.cpu().numpy(), q, k, v, lengths, max_ulp, rel)


@pytest.mark.parametrize("d", [64, 128])
def test_decode_attn_int8_kernel_matches_plain(gen, d):
    """The no-tail mode of the int8 kernel: GQA, lengths 1 through past
    capacity, its own launch count."""
    b, h, kvh, cap = 6, 4, 2, 64
    kv, scales, _ = _cache(gen, b, cap, 1, kvh, d)
    q = torch.randn((b, h, d), device="cuda", generator=gen)
    lengths = torch.tensor([1, 2, 17, 40, cap, cap + 30],
                           dtype=torch.int32, device="cuda")
    before = (at.decode_attn_int8.launches,
              at.decode_attn_int8_tail.launches)
    out = at.decode_attn_int8(q, kv, scales, lengths)
    ref = at.decode_attn_int8_plain(q, kv, scales, lengths)
    torch.cuda.synchronize()
    assert (at.decode_attn_int8.launches,
            at.decode_attn_int8_tail.launches) == (before[0] + 1, before[1])
    assert torch.isfinite(out).all()
    tol = 2.0 ** -6 * ref.abs().max().item()
    assert (out - ref).abs().max().item() <= tol


@pytest.mark.parametrize("cache,tol", [
    ("f32", 1e-4), ("bf16", 1e-4), ("int8_no_tail", 1e-2)])
def test_decode_steps_without_tail_match_the_cpu(gen, cache, tol):
    """Teacher-forced decode through K5/K6 (f32 weights on an f32 or bf16
    cache) and K7/K1' (int8 weights on an int8 cache without a tail) on
    the card against the same model on the CPU. f32 throughout (TF32
    off) agrees to 1e-4; int8 weights carry bf16 roundings that may flip,
    1e-2 as on the tail path."""
    model = TransformerLM(TransformerConfig.tiny_test(n_heads=2,
                                                      d_model=128))
    kw = {"f32": {}, "bf16": dict(cache_dtype="bfloat16"),
          "int8_no_tail": dict(quantized=True)}[cache]
    rng = np.random.default_rng(1)
    prompt = torch.from_numpy(rng.integers(1, 128, (4, 5)))
    params, caches = {}, {}
    for dev in ("cpu", "cuda"):
        params[dev] = model.init_params(3, device=dev)
        if cache == "int8_no_tail":
            params[dev] = quantize_weights(params[dev])
        c = model.new_cache(4, 64, device=dev, **kw)
        _, c = model.prefill(params[dev], prompt.to(dev), c)
        caches[dev] = c.with_lengths([5, 3, 1, 5])
    tok = torch.from_numpy(rng.integers(1, 128, 4))
    for step in range(12):
        logits = {}
        for dev in ("cpu", "cuda"):
            lg, caches[dev] = model.decode_step(params[dev], tok.to(dev),
                                                caches[dev])
            logits[dev] = lg.cpu()
        assert (logits["cuda"] - logits["cpu"]).abs().max() < tol, step
        tok = logits["cpu"].argmax(-1)


def test_int8_cache_without_a_flat_group_raises_on_the_card(gen):
    """On the card an int8 cache without a tail decodes through K7 and K1'
    at a batch with a flat group (4); at batch 3, where it used to raise,
    it now takes the reference's fused int8 kernel, G2, and its logits
    match the CPU's plain versions."""
    model = TransformerLM(TransformerConfig.tiny_test(n_heads=2,
                                                      d_model=128))
    params = quantize_weights(model.init_params(3, device="cuda"))
    n_layers = model.config.n_layers
    before = (kc.kv_append_int8.launches, at.decode_attn_int8.launches,
              at.decode_attn_fused_int8.launches)
    cache = model.new_cache(4, 64, quantized=True, device="cuda")
    model.decode_step(params, torch.ones(4, dtype=torch.int64,
                                         device="cuda"), cache)
    assert (kc.kv_append_int8.launches, at.decode_attn_int8.launches) == (
        before[0] + n_layers, before[1] + n_layers)
    logits = {}
    for dev in ("cuda", "cpu"):
        p = params if dev == "cuda" else quantize_weights(
            model.init_params(3, device="cpu"))
        cache = model.new_cache(3, 64, quantized=True, device=dev)
        logits[dev], _ = model.decode_step(
            p, torch.ones(3, dtype=torch.int64, device=dev), cache)
    assert at.decode_attn_int8.launches == before[1] + n_layers
    assert at.decode_attn_fused_int8.launches == before[2] + n_layers
    # int8 weights: bf16 roundings of activations may flip (as above).
    assert (logits["cuda"].cpu() - logits["cpu"]).abs().max() < 1e-2


# -- block-paged pools --------------------------------------------------------

PAGE = 8


def _paged_table(b, max_pages, mapped, n_pages, seed=0):
    """int32 [B, max_pages] on the card: ``mapped[i]`` scrambled pages for
    row i (drawn without replacement from 1..n_pages-1), the rest -1."""
    ids = list(np.random.default_rng(seed).permutation(np.arange(1, n_pages)))
    table = np.full((b, max_pages), -1, np.int32)
    for i, n in enumerate(mapped):
        table[i, :n] = [ids.pop() for _ in range(n)]
    return torch.from_numpy(table).cuda()


# Rows: mid-page, at a page boundary, at a page's last row, past capacity
# (the last page), past its mapped pages (an unmapped entry: page 0,
# offset 2) and released (table row -1: page 0, offset 5).
APPEND_LENGTHS = [3, PAGE, 2 * PAGE - 1, 4 * PAGE + 1, 3 * PAGE + 2, 5]
APPEND_MAPPED = [1, 2, 2, 4, 2, 0]


# (KV heads, head_dim, row offset, an all-zero head): P2's wide instance
# at 3 heads of 64 and 2 of 128, with and without the zero head; the narrow
# one at head_dim 16 (the small test configs) and 80, and on unaligned
# rows (rows_view's offset 1).
PAGED_APPEND_SHAPES = [(3, 64, 0, True), (3, 64, 0, False), (2, 128, 0, True),
                       (8, 16, 0, True), (3, 80, 0, True), (3, 64, 1, True),
                       (2, 128, 1, False)]


@pytest.mark.parametrize("kvh,d,offset,zero_head", PAGED_APPEND_SHAPES,
                         ids=str)
@pytest.mark.parametrize("quantized", [False, True])
def test_kv_append_paged_kernels_bit_exact(gen, quantized, kvh, d, offset,
                                           zero_head):
    """P1 and P2 against their plain versions bit for bit (P2: bytes and
    scales; both through K7's kernel body in its wide or narrow instance);
    one launch counted and one CUDA kernel a call."""
    b, n_pages, max_pages = 6, 20, 4
    table = _paged_table(b, max_pages, APPEND_MAPPED, n_pages)
    lengths = torch.tensor(APPEND_LENGTHS, dtype=torch.int32, device="cuda")
    x = torch.randn((b, kvh, 1, d), device="cuda", generator=gen)
    x = x * torch.exp(4 * torch.rand((b, kvh, 1, 1), device="cuda",
                                     generator=gen) - 3)
    if zero_head:
        x[0, 1] = 0                        # all-zero head: scale 1.0
    k, v = rows_view(x, offset), rows_view(x.flip(0), offset)
    if quantized:
        pool = torch.randint(-127, 128, (n_pages, PAGE, 2, kvh * d),
                             device="cuda", dtype=torch.int8, generator=gen)
        scales = torch.rand((n_pages, PAGE, 2, kvh), device="cuda",
                            generator=gen).to(torch.bfloat16)
        p1, s1, p2, s2 = pool.clone(), scales.clone(), pool.clone(), \
            scales.clone()
        before = kc.kv_append_paged_int8.launches
        kc.kv_append_paged_int8(p1, s1, k, v, table, lengths)
        kc.kv_append_paged_int8_plain(p2, s2, k, v, table, lengths)
        torch.cuda.synchronize()
        assert kc.kv_append_paged_int8.launches == before + 1
        assert torch.equal(p1, p2) and torch.equal(s1, s2)
        assert _cuda_kernels_a_call(lambda: kc.kv_append_paged_int8(
            p1, s1, k, v, table, lengths)) == 1
    else:
        pool = torch.randn((n_pages, PAGE, 2, kvh * d), device="cuda",
                           generator=gen)
        p1, p2 = pool.clone(), pool.clone()
        before = kc.kv_append_paged.launches
        kc.kv_append_paged(p1, k, v, table, lengths)
        kc.kv_append_paged_plain(p2, k, v, table, lengths)
        torch.cuda.synchronize()
        assert kc.kv_append_paged.launches == before + 1
        assert torch.equal(p1, p2)
        assert torch.equal(p1[0, 5, 0], k[5].reshape(-1))   # released row
        assert torch.equal(p1[0, 2, 1], v[4].reshape(-1))   # past its pages
        assert _cuda_kernels_a_call(lambda: kc.kv_append_paged(
            p1, k, v, table, lengths)) == 1


# Rows: one token, a whole page, three pages less one, past its two mapped
# pages (an unmapped page inside the length: the grouped modes read page 0,
# the grid masks it), released (no mapped page), empty, a page less one, a
# page and one, the capacity, and past it.
ATTN_LENGTHS = [1, PAGE, 3 * PAGE - 1, 3 * PAGE + 4, 5, 0, PAGE - 1,
                PAGE + 1, 4 * PAGE, 4 * PAGE + 3]
ATTN_MAPPED = [1, 1, 3, 2, 0, 0, 1, 2, 4, 4]


@pytest.mark.parametrize("d", [64, 128, 192, 256])
@pytest.mark.parametrize("h,kvh", [(4, 2), (4, 4), (8, 2), (16, 1)])
@pytest.mark.parametrize("mode,splits,warps", [
    ("grouped", None, None), ("grid", None, None), ("int8", None, None),
    ("int8", 1, None), ("int8", 3, 4), ("grouped", 1, None),
    ("grouped", 3, 4), ("grid", 1, 8), ("grid", 2, 4)])
def test_decode_attn_paged_kernels_match_plain(gen, mode, splits, warps, h,
                                               kvh, d):
    """P3, its grid mode and P3i (the KV-group kernel on an f32 or int8
    pool) at groups 1, 2, 4 and 16 (two blocks of 8 heads a KV head, four
    of 4 above head_dim 128) and head_dim 64 to 256; also with their
    sequences split into 1, 2 or 3 chunks of whole pages through the
    launcher's plan (the plan's own split here is 4 or more: so few
    (sequence, KV head) pairs fall short of its target; so few blocks
    take 8 warps each), and with 4 or 8 warps a block."""
    b, n_pages, max_pages = len(ATTN_LENGTHS), 48, 4
    f = kvh * d
    table = _paged_table(b, max_pages, ATTN_MAPPED, n_pages, seed=1)
    lengths = torch.tensor(ATTN_LENGTHS, dtype=torch.int32, device="cuda")
    q = torch.randn((b, h, d), device="cuda", generator=gen)
    wrapper = {"grouped": at.decode_attn_paged,
               "grid": at.decode_attn_paged_grid,
               "int8": at.decode_attn_paged_int8}[mode]
    if mode == "int8":
        pool, scales, _ = _cache(gen, n_pages, PAGE, 1, kvh, d)
        args = (q, pool, scales, table, lengths)
    else:
        pool = torch.randn((n_pages, PAGE, 2, f), device="cuda",
                           generator=gen)
        args = (q, pool, table, lengths)
    plain = getattr(at, wrapper.__name__ + "_plain")
    before = {w: w.launches for w in (at.decode_attn_paged,
                                      at.decode_attn_paged_grid,
                                      at.decode_attn_paged_int8)}
    if splits or warps:
        plan = at.paged_plan(b, h, kvh, PAGE, max_pages, d, splits, warps)
        if mode == "int8":
            out = at._launch_paged_int8(*args, None, plan)
        else:
            out = at._launch_paged(wrapper, *args, None, mode == "grid",
                                   plan)
    else:
        out = wrapper(*args)
    ref = plain(*args)
    torch.cuda.synchronize()
    assert {w: w.launches - n for w, n in before.items()} == {
        w: int(w is wrapper) for w in before}
    assert torch.isfinite(out).all()
    # f32 throughout (an online softmax per warp against an exact
    # two-pass softmax): 1e-5 of the largest output, as K6.
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    assert (out[5] == 0).all()
    if mode == "grid":
        assert (out[4] == 0).all()


@pytest.mark.parametrize("splits", [None, 2, 4])
@pytest.mark.parametrize("d", [64, 256])
def test_decode_attn_paged_grid_masks_whole_splits(gen, d, splits):
    """The grid mode where whole chunks of a sequence are unmapped pages
    inside its length: their splits see no live row (m = -inf, l = 0) and
    the cluster's merge weighs them 0; a sequence with no mapped page gets
    zeros, and nothing is NaN."""
    b, h, kvh, max_pages, n_pages = 4, 8, 2, 8, 40
    ids = iter(np.random.default_rng(3).permutation(np.arange(1, n_pages)))
    table = np.full((b, max_pages), -1, np.int32)
    table[0, 4:] = [next(ids) for _ in range(4)]   # the first half unmapped
    table[1, :4] = [next(ids) for _ in range(4)]   # the second half
    table[2, 2:6] = [next(ids) for _ in range(4)]  # the middle only
    table = torch.from_numpy(table).cuda()         # row 3: none mapped
    lengths = torch.tensor([8 * PAGE, 8 * PAGE - 3, 7 * PAGE, 6 * PAGE],
                           dtype=torch.int32, device="cuda")
    q = torch.randn((b, h, d), device="cuda", generator=gen)
    pool = torch.randn((n_pages, PAGE, 2, kvh * d), device="cuda",
                       generator=gen)
    plan = at.paged_plan(b, h, kvh, PAGE, max_pages, d, splits)
    out = at._launch_paged(at.decode_attn_paged_grid, q, pool, table,
                           lengths, None, True, plan)
    ref = at.decode_attn_paged_grid_plain(q, pool, table, lengths)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    assert (out[3] == 0).all() and (out[:3] != 0).any(dim=-1).all()


@pytest.mark.parametrize("splits", [None, 2, 8])
def test_decode_attn_paged_int8_stages_many_page_ids(gen, splits):
    """P3i over 600 pages of 8 a sequence: a chunk holds at most 256 page
    ids, so the plan splits into at least 3 chunks, and a plan of fewer
    raises before any launch."""
    b, h, kvh, d, max_pages = 3, 8, 2, 64, 600
    n_pages = b * max_pages + 1
    table = _paged_table(b, max_pages, [600, 400, 250], n_pages, seed=2)
    lengths = torch.tensor([600 * PAGE, 400 * PAGE - 3, 250 * PAGE + 9],
                           dtype=torch.int32, device="cuda")
    q = torch.randn((b, h, d), device="cuda", generator=gen)
    pool, scales, _ = _cache(gen, n_pages, PAGE, 1, kvh, d)
    args = (q, pool, scales, table, lengths)
    plan = at.paged_plan(b, h, kvh, PAGE, max_pages, d, splits)
    if splits == 2:
        with pytest.raises(ValueError, match="splits must lie"):
            at._launch_paged_int8(*args, None, plan)
        return
    out = at._launch_paged_int8(*args, None, plan)
    ref = at.decode_attn_paged_int8_plain(*args)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.parametrize("weights,b", [("f32", 4), ("f32", 3),
                                       ("int8", 4), ("int8", 3)])
def test_paged_decode_steps_match_the_cpu(gen, weights, b):
    """Teacher-forced decode on a paged cache through P1/P3 (f32 weights,
    batch 4 grouped, batch 3 grid) and P2/P3i (int8 weights, batch 4; at
    batch 3 the gathered reference) on the card against the same model on
    the CPU: f32 agrees to 1e-4, int8 weights to 1e-2."""
    model = TransformerLM(TransformerConfig.tiny_test(n_heads=2,
                                                      d_model=128))
    quantized, tol = weights == "int8", (1e-2 if weights == "int8"
                                         else 1e-4)
    rng = np.random.default_rng(2)
    prompt = torch.from_numpy(rng.integers(1, 128, (b, 5)))
    params, caches = {}, {}
    n_layers = model.config.n_layers
    for dev in ("cpu", "cuda"):
        params[dev] = model.init_params(3, device=dev)
        if quantized:
            params[dev] = quantize_weights(params[dev])
        c = model.new_paged_cache(b, 32, PAGE, 4 * b, identity_table=True,
                                  quantized=quantized, device=dev)
        _, c = model.prefill(params[dev], prompt.to(dev), c)
        caches[dev] = c.with_lengths([5, 3, 1, 5][:b])
    before = {w: w.launches for w in (kc.kv_append_paged,
                                      kc.kv_append_paged_int8,
                                      at.decode_attn_paged,
                                      at.decode_attn_paged_grid,
                                      at.decode_attn_paged_int8)}
    tok = torch.from_numpy(rng.integers(1, 128, b))
    for step in range(12):
        logits = {}
        for dev in ("cpu", "cuda"):
            lg, caches[dev] = model.decode_step(params[dev], tok.to(dev),
                                                caches[dev])
            logits[dev] = lg.cpu()
        assert (logits["cuda"] - logits["cpu"]).abs().max() < tol, step
        tok = logits["cpu"].argmax(-1)
    attn = {("f32", 4): at.decode_attn_paged,
            ("f32", 3): at.decode_attn_paged_grid,
            ("int8", 4): at.decode_attn_paged_int8}.get((weights, b))
    append = kc.kv_append_paged_int8 if quantized else kc.kv_append_paged
    launched = {w: w.launches - n for w, n in before.items()}
    assert launched == {w: 12 * n_layers * (w in (attn, append))
                        for w in before}


# -- group-wise int4 GEMMs ----------------------------------------------------

INT4_KERNELS = {"words": (pg.matmul_int4_words, "bf16"),
                "words_int8": (pg.matmul_int4_words_int8, "int8"),
                "bytes": (pg.matmul_int4, None)}


def int4_case(make, mode, m, k, n, group=128):
    """x [M, K] and a quantized 0.02-scale weight [K, N] in ``mode``'s
    layout (groups of ``group`` K rows), on the device of ``make`` (a
    torch.Generator), as the kernel's arguments."""
    dev = make.device
    x = torch.randn((m, k), device=dev, generator=make)
    w = 0.02 * torch.randn((k, n), device=dev, generator=make)
    if mode == "bytes":
        packed, scales = quantize_int4_groupwise(w, group)
    else:
        packed, scales = quantize_int4_words(w, group)
    return x, packed, scales


def int4_bound(x, packed, scales, mode):
    """The bound of the kernel's and the plain version's difference: 2^-16
    of the sum of the magnitudes of every f32 term (2^8 roundings of 2^-24
    each; chip_smoke.py's INT4_REL_TOL, for K up to 5632 terms), in integer
    units times the row scale for the int8 mode."""
    k = x.shape[1]
    group = k // scales.shape[0]
    s_rows = scales.repeat_interleave(group, dim=0)
    if mode == "bytes":
        q = unpack_int4(packed).float()
        return 2.0 ** -16 * (x.abs() @ (q.abs() * s_rows))
    u = unpack_int4_words(packed).float() + 8
    xs = x.reshape(x.shape[0], -1, group).sum(-1).abs()
    if mode == "words":
        return 2.0 ** -16 * (x.abs() @ (u * s_rows) + 8 * xs @ scales)
    absmax = x.abs().amax(dim=1, keepdim=True)
    xscale = torch.where(absmax == 0, torch.ones_like(absmax), absmax / 127)
    xq = torch.clamp(torch.round(x / xscale), -127, 127)
    xqs = xq.reshape(x.shape[0], -1, group).sum(-1).abs()
    return 2.0 ** -16 * (xq.abs() @ (u * s_rows) + 8 * xqs @ scales) * xscale


@pytest.mark.parametrize("mode", list(INT4_KERNELS))
@pytest.mark.parametrize("m,k,n", [(1, 128, 256), (7, 640, 512),
                                   (16, 2048, 2560), (100, 384, 768),
                                   (130, 2048, 1024)])
def test_int4_kernels_match_plain(gen, mode, m, k, n):
    """Q1 (words, bf16 dot), Q1' (words, int8 dot) and Q2 (bytes) against
    their plain versions: one group and many, M from 1 to past one row
    tile, several K splits. Both sum f32 terms in different orders."""
    wrapper, dot = INT4_KERNELS[mode]
    x, packed, scales = int4_case(gen, mode, m, k, n)
    before = wrapper.launches
    out = wrapper(x, packed, scales)
    if mode == "bytes":
        ref = pg.matmul_int4_plain(x, packed, scales)
    else:
        ref = pg.matmul_int4_words_plain(x, packed, scales, dot_mode=dot)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert out.shape == (m, n) and torch.isfinite(out).all()
    bound = int4_bound(x, packed, scales, mode)
    assert ((out - ref).abs() <= bound + 1e-30).all(), \
        ((out - ref).abs() / bound).max().item()


# TinyLlama's int4 weights (K, N) at decode M 16, and w_gate at the prefill
# M 1024; with the plan's splits and with a count that does not divide the
# groups evenly (None: the plan's).
INT4_INT8_CASES = [(16, 2048, 2560, None), (16, 2048, 2048, None),
                   (16, 2048, 5632, None), (16, 5632, 2048, None),
                   (16, 2048, 32000, None), (1024, 2048, 5632, None),
                   (16, 2048, 2560, 3), (16, 2048, 2048, 7),
                   (16, 2048, 5632, 5), (16, 5632, 2048, 5),
                   (16, 2048, 32000, 3), (1024, 2048, 5632, 3)]


@pytest.mark.parametrize("m,k,n,splits", INT4_INT8_CASES, ids=str)
def test_int4_int8_kernel_at_tinyllama_shapes(gen, m, k, n, splits):
    """Q1' against its plain version at every TinyLlama weight shape at
    decode and at prefill, split as planned and unevenly (the cluster's
    split-K sum); one launch a call."""
    x, words, scales = int4_case(gen, "words_int8", m, k, n)
    plan = pg.int4_int8_plan(m, k, n, 128, 132, splits)
    g = k // 128
    assert splits is None or g % plan["splits"]
    before = pg.matmul_int4_words_int8.launches
    out = pg._launch_int4_int8(x, words, scales, 128, splits)
    ref = pg.matmul_int4_words_plain(x, words, scales, dot_mode="int8")
    torch.cuda.synchronize()
    assert pg.matmul_int4_words_int8.launches == before + 1
    bound = int4_bound(x, words, scales, "words_int8")
    assert torch.isfinite(out).all()
    assert ((out - ref).abs() <= bound + 1e-30).all(), \
        ((out - ref).abs() / bound).max().item()


@pytest.mark.parametrize("m,k,n,splits", [(16, 2048, 2560, None),
                                          (16, 5632, 2048, 5),
                                          (100, 384, 768, 1),
                                          (1024, 2048, 5632, None)],
                         ids=str)
def test_int4_int8_kernel_is_deterministic(gen, m, k, n, splits):
    """Two calls on the same inputs agree bit for bit: the split-K sum
    runs in split order, with no atomics on the values."""
    x, words, scales = int4_case(gen, "words_int8", m, k, n)
    first = pg._launch_int4_int8(x, words, scales, 128, splits)
    second = pg._launch_int4_int8(x, words, scales, 128, splits)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("mode", list(INT4_KERNELS))
def test_int4_kernels_refuse_mixed_devices(gen, mode):
    """CUDA activations with CPU weights raise; nothing falls back."""
    wrapper, _ = INT4_KERNELS[mode]
    x, packed, scales = int4_case(gen, mode, 4, 128, 256)
    before = wrapper.launches
    with pytest.raises(ValueError, match="all on"):
        wrapper(x, packed.cpu(), scales.cpu())
    assert wrapper.launches == before


# -- the int8 kernel at long capacities, chunked verify -----------------------

@pytest.mark.parametrize("tail_count", [0, 5])
@pytest.mark.parametrize("b,h,kvh,cap", [(4, 12, 12, 12288),
                                         (4, 4, 4, 16384),
                                         (2, 4, 2, 512)])
def test_int8_kernel_past_the_old_capacity_limit(gen, b, h, kvh, cap,
                                                 tail_count):
    """K1 (with a window) and K1' (``tail_count`` 0) against their plain
    versions at capacities above the 12,080 tokens that one shared-memory
    score row allowed, where each sequence splits into chunks read by
    blocks of their own (and at capacity 512, batch 2, where it splits
    too); lengths 0 through past capacity."""
    d, rows = 64, 8
    kv, scales, tail = _cache(gen, b, cap, rows, kvh, d)
    q = torch.randn((b, h, d), device="cuda", generator=gen)
    lengths = torch.tensor([cap + tail_count, 12200 % cap + tail_count, 0,
                            cap - 1][:b], dtype=torch.int32, device="cuda")
    chunk, splits = at.int8_chunks(b, h, cap + (rows if tail_count else 0))
    assert splits > 1
    if tail_count:
        wrapper, args = at.decode_attn_int8_tail, (q, kv, scales, lengths,
                                                   tail, tail_count)
    else:
        wrapper, args = at.decode_attn_int8, (q, kv, scales, lengths)
    before = wrapper.launches
    out = wrapper(*args)
    ref = getattr(at, wrapper.__name__ + "_plain")(*args)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert torch.isfinite(out).all()
    tol = 2.0 ** -6 * ref.abs().max().item()
    assert (out - ref).abs().max().item() <= tol


def _verify_case(gen, b, s, h, kvh, d, cap, mode, lens=None):
    q = torch.randn((b, s, h, d), device="cuda", generator=gen)
    if mode == "int8":
        kv, scales, _ = _cache(gen, b, cap, 1, kvh, d)
    else:
        kv = torch.randn((b, cap, 2, kvh * d), device="cuda",
                         generator=gen).to(getattr(torch, mode))
        scales = None
    lens = lens or [cap - s, 0, 5, 37, 3, 61, 62, 64][:b]
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return q, kv, lengths, scales


# (batch, S, heads, kv heads, head_dim, capacity[, splits, warps[,
# lengths]]): S 1 to 8, GQA and plain heads, head_dim 64 and 128, a chunk
# that ends at the capacity, lengths 0 and ragged at the plan's launch;
# then the plan forced to 1-8 splits of 4 or 8 warps at S 1-8, and at S 8
# with 4 query heads a KV head of 128 (4 blocks of 2 queries x 4 heads) a
# sequence of 14 rows before its chunk in 2 splits: the second, rows 16-21,
# lies past every query of the first block (limits 15 and 16).
VERIFY_CASES = [
    (8, 4, 12, 12, 64, 128), (3, 1, 4, 2, 64, 96), (1, 8, 4, 2, 128, 64),
    (5, 5, 8, 2, 128, 2048), (2, 2, 2, 1, 64, 40),
    (8, 1, 4, 2, 64, 96, 1, 8), (8, 2, 12, 12, 64, 128, 2, 4),
    (8, 3, 8, 2, 128, 200, 3, 8), (8, 4, 16, 4, 128, 64, 4, 4),
    (8, 5, 4, 4, 64, 300, 5, 8), (8, 6, 8, 2, 64, 128, 6, 4),
    (8, 7, 2, 1, 128, 128, 7, 8), (8, 8, 12, 12, 64, 2048, 8, 4),
    (8, 8, 8, 2, 128, 64, 2, 8, [14, 0, 15, 16, 30, 31, 46, 64]),
    (4, 8, 8, 2, 128, 64, 2, 4, [14, 14, 0, 56]),
]


@pytest.mark.parametrize("mode", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("case", VERIFY_CASES, ids=str)
def test_verify_attn_kernels_match_plain(gen, case, mode):
    """V1 through both entries against the plain version (VERIFY_CASES), on
    f32, bf16 and int8 caches, at the plan's launch or a forced one. Each
    entry counts its launches in its mode."""
    b, s, h, kvh, d, cap, *opt = case
    splits, warps, lens = list(opt) + [None, None, None][len(opt):]
    q, kv, lengths, scales = _verify_case(gen, b, s, h, kvh, d, cap, mode,
                                          lens)
    ref = at.verify_attn_grouped_plain(q, kv, lengths, scales)
    key = "float" if scales is None else "int8"
    for wrapper in (at.verify_attn_grouped, at.verify_attn_fused):
        before = (wrapper.launches, dict(wrapper.mode_launches))
        if splits:
            plan = at.verify_plan(b, s, h, kvh, cap, d, splits, warps)
            assert plan["splits"] == splits
            out = at._launch_verify(wrapper, q, kv, scales, lengths, None,
                                    plan)
        else:
            out = wrapper(q, kv, lengths, scales)
        torch.cuda.synchronize()
        assert wrapper.launches == before[0] + 1
        assert wrapper.mode_launches[key] == before[1][key] + 1
        assert out.shape == (b, s, h, d) and torch.isfinite(out).all()
        # f32 sums in other orders (online softmaxes per warp and split
        # against an exact two-pass softmax), nothing rounded to bf16:
        # K6's 1e-5.
        assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.parametrize("mode", ["bfloat16", "int8"])
def test_verify_attn_kernels_are_one_launch(gen, mode):
    """Both V1 entries launch one CUDA kernel a call, split (batch 3: 8
    splits merged in their cluster) or not."""
    for b in (3, 8):
        q, kv, lengths, scales = _verify_case(gen, b, 4, 12, 12, 64, 2048,
                                              mode)
        assert at.verify_plan(b, 4, 12, 12, 2048, 64)["splits"] > 1
        for wrapper in (at.verify_attn_grouped, at.verify_attn_fused):
            assert _cuda_kernels_a_call(
                lambda: wrapper(q, kv, lengths, scales)) == 1


@pytest.mark.parametrize("b", [4, 3])
def test_speculative_engine_on_the_card_matches_the_cpu(gen, b):
    """The speculative engine (f32 weights, f32 cache) on the card gives
    the CPU's tokens and the card's plain greedy tokens; batch 4 verifies
    through verify_attn_grouped, batch 3 through verify_attn_fused."""
    model = TransformerLM(TransformerConfig.tiny_test(n_heads=2,
                                                      d_model=128))
    prompts = [[1, 2, 3, 1, 2, 3, 1], [4, 5, 6, 7], [9, 10, 9, 10], [8]][:b]
    outs = {}
    before = (at.verify_attn_grouped.launches, at.verify_attn_fused.launches)
    for dev in ("cpu", "cuda"):
        params = model.init_params(3, device=dev)
        kw = dict(max_batch=b, capacity=64, prefill_buckets=(16,),
                  device=dev)
        outs[dev] = ServingEngine(model, params, spec_draft=3,
                                  spec_adaptive=False, **kw).generate(
            prompts, max_new_tokens=12, burst=3)
        if dev == "cuda":
            outs["plain"] = ServingEngine(model, params, **kw).generate(
                prompts, max_new_tokens=12)
    assert outs["cuda"] == outs["cpu"] == outs["plain"]
    grouped = at.verify_attn_grouped.launches - before[0]
    fused = at.verify_attn_fused.launches - before[1]
    assert (grouped > 0, fused > 0) == (b == 4, b == 3)


# -- F1, G1, G2 and A1 (head_dim 128, Mistral-7B's path) ----------------------

# F1, G1, G2 and A1 sum in f32 with nothing rounded to bf16, as K6: a few f32
# roundings of outputs of order 1, 1e-5 of max |out|.
F32_REL_TOL = 1e-5


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,s", [(2, 4, 128), (1, 2, 384),
                                   (16, 32, 512)])
def test_flash_attention_kernel_matches_plain(gen, b, h, s, causal):
    """F1 against attn_reference's arithmetic, one to eight query tiles,
    at the prefill shape of Mistral-7B's path (B 16, 32 heads, S 512)."""
    q, k, v = (torch.randn((b, h, s, 128), device="cuda", generator=gen)
               for _ in range(3))
    before = at.flash_attention.launches
    out = at.flash_attention(q, k, v, causal=causal)
    ref = at.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert at.flash_attention.launches == before + 1
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= (
        F32_REL_TOL * ref.abs().max().item())


def _assert_per_head(out, ref, rel=F32_REL_TOL):
    """Every (b, h) head within ``rel`` of its own max |out|."""
    err = (out - ref).abs().amax(dim=(2, 3))
    assert (err <= rel * ref.abs().amax(dim=(2, 3))).all(), err.max()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,s", [(1, 2, 2048), (2, 4, 1024), (4, 16, 768),
                                   (8, 64, 128), (1, 4, 256)])
def test_flash_attention_kernel_across_lengths_and_heads(gen, b, h, s,
                                                         causal):
    """F1's split-TF32 products at S 128 to 2048 and 2 to 512 heads, each
    head within 1e-5 of its max |out| of the plain version."""
    q, k, v = (torch.randn((b, h, s, 128), device="cuda", generator=gen)
               for _ in range(3))
    out = at.flash_attention(q, k, v, causal=causal)
    ref = at.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    _assert_per_head(out, ref)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel_at_scaled_heads(gen, causal):
    """q, k and v of head e scaled by 2^e, 2^-e and 2^e, e from -8 to 8:
    every operand of the hi/lo split moves its exponent by up to 8 while the
    scores stay of order 1 (scores of order 2^16 would make f32 attention
    itself ill-conditioned: one f32 rounding of a score then moves its
    probability by ~2^-8); each head within 1e-5 of its own max |out|."""
    b, h, s = 2, 9, 256
    e = torch.arange(-8, 9, 2, device="cuda",
                     dtype=torch.float32).reshape(1, h, 1, 1)
    q, k, v = (torch.randn((b, h, s, 128), device="cuda", generator=gen)
               * torch.exp2(sign * e) for sign in (1, -1, 1))
    out = at.flash_attention(q, k, v, causal=causal)
    ref = at.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    _assert_per_head(out, ref)


def test_flash_attention_kernel_row_below_the_mask_value(gen):
    """A query whose every score lies below -1e30, as a fully masked row
    looks to the kernel: the reference kernel gives 0 there (its running
    max starts at -1e30; tests/test_torch_prefill_attn.py holds that
    against the JAX package), where the plain softmax would not; the
    other rows agree with the plain version."""
    b, h, s = 1, 2, 256
    q, k, v = (torch.randn((b, h, s, 128), device="cuda", generator=gen)
               for _ in range(3))
    k[..., 0] = 1.0 + k[..., 0].abs()
    q[0, 1, 5] = 0.0
    q[0, 1, 5, 0] = -1e32
    out = at.flash_attention(q, k, v, causal=False)
    ref = at.flash_attention_plain(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert not out[0, 1, 5].any()
    ref[0, 1, 5] = 0.0
    assert (out - ref).abs().max().item() <= (
        F32_REL_TOL * ref.abs().max().item())


# -- RoPE tables on the card --------------------------------------------------

def _ulps(a, b):
    """The largest distance in f32 ulps between same-signed a and b."""
    return (a.cpu().view(torch.int32).long()
            - b.cpu().view(torch.int32).long()).abs().max().item()


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("d", [80, 96])
def test_rope_tables_on_the_card_match_the_cpu(gen, d, theta):
    """Head dims whose half (40, 48) is no power of two, where a multiply
    by f32(1 / half) rounds 7 and 15 of the exponents -i / half otherwise
    than the division. The card's freqs are the card's pow of the CPU's
    exponents, bit for bit, so they lie within the one ulp by which the
    card's powf and the CPU's pow may differ on equal inputs, where the
    reciprocal's exponents, amplified by ln(theta), moved them further.
    cos and sin are not compared with the CPU's bit for bit: CUDA's cosf
    and sinf and the CPU's differ in the last bit on some equal inputs."""
    half = d // 2
    i = torch.arange(half, dtype=torch.float32)
    exponent = -i / torch.full_like(i, half)      # the reference's division
    reciprocal = -i * (1 / torch.full_like(i, half))
    assert int((reciprocal != exponent).sum()) == {40: 7, 48: 15}[half]
    f_cpu = ptr._rope_freqs(d, theta, "cpu")
    f_gpu = ptr._rope_freqs(d, theta, "cuda")
    assert _same_bits(f_gpu, theta ** exponent.cuda())
    assert _ulps(f_gpu, f_cpu) <= 1
    pos = torch.arange(4096, device="cuda").reshape(2, 2048)
    cos, sin = ptr._rope_tables(pos, d, theta)
    angles = pos.to(torch.float32)[:, None, :, None] * f_gpu
    assert _same_bits(cos, torch.cos(angles))
    assert _same_bits(sin, torch.sin(angles))


def _int8_cache(gen, b, cap, kvh, d):
    kv = torch.randint(-127, 128, (b, cap, 2, kvh * d), device="cuda",
                       dtype=torch.int8, generator=gen)
    scales = (0.01 + 0.02 * torch.rand((b, cap, 2, kvh), device="cuda",
                                       generator=gen)).to(torch.bfloat16)
    return kv, scales


# (batch, heads, kv heads, head_dim, capacity, lengths[, splits[,
# warps]]): ragged small shapes at groups 1, 2, 4, 8, 12 and 16 (a length
# 0, one past capacity; above 8 a KV head takes two blocks), every length from 0 to past the capacity with G1's
# sequences in 1, 2, 3, 5 or 8 chunks (every chunk and 64-row tile
# boundary +- 1), G1's blocks of 4 and 8 warps, and the path's
# (Mistral-7B, B 16 at capacity 4096 and 1024, B 3; lives 512-576).
INT8_DECODE_CASES = [
    (4, 8, 2, 128, 96, [0, 1, 96, 140]),
    (3, 4, 4, 64, 64, [5, 64, 33]),
    (6, 4, 2, 64, 200, [0, 1, 63, 64, 65, 200]),
    (4, 16, 2, 128, 256, [1, 129, 255, 256]),
    (3, 32, 4, 64, 300, [17, 299, 301]),
    (3, 8, 8, 128, 160, [0, 127, 160]),
    (4, 12, 1, 128, 96, [0, 1, 96, 140]),
    (3, 32, 2, 64, 300, [17, 299, 301]),
    (4, 24, 2, 128, 200, [1, 64, 65, 200], 3),
    (140, 8, 2, 64, 136, range(140), 3),
    (140, 8, 2, 128, 136, range(140), 8),
    (140, 8, 2, 64, 136, range(140), 5, 8),
    (140, 16, 2, 128, 136, range(140), 2, 8),
    (140, 8, 2, 128, 300, range(0, 560, 4), 1, 8),
    (140, 8, 2, 64, 300, range(0, 560, 4), 2, 4),
    (16, 32, 8, 128, 1024, list(range(512, 576, 4)), 2, 4),
    (16, 32, 8, 128, 1024, list(range(512, 576, 4)), 4, 8),
    (16, 32, 8, 128, 4096, list(range(512, 576, 4))),
    (16, 32, 8, 128, 1024, list(range(512, 576, 4))),
    (3, 32, 8, 128, 4096, [512, 544, 576]),
]


@pytest.mark.parametrize("case", INT8_DECODE_CASES, ids=str)
@pytest.mark.parametrize("entry", ["exact", "int8_scores", "fused"])
def test_int8_decode_kernels_match_plain(gen, entry, case):
    """G1 in both score modes and G2 against their plain versions; with
    int8 scores the kernel's int32 dots equal the plain ones bit for
    bit."""
    b, h, kvh, d, cap, lens, *opt = case
    splits, warps = list(opt) + [None, None][len(opt):]
    kv, scales = _int8_cache(gen, b, cap, kvh, d)
    q = torch.randn((b, h, d), device="cuda", generator=gen) * 2
    q[0, 0] = 0                                     # an all-zero q row
    lengths = torch.tensor(list(lens), dtype=torch.int32, device="cuda")
    scores = entry == "int8_scores"
    if entry == "fused":
        wrapper = at.decode_attn_fused_int8
        out = wrapper(q, kv, scales, lengths)
        ref = at.decode_attn_fused_int8_plain(q, kv, scales, lengths)
    else:
        wrapper = at.decode_attn_grouped_int8
        dots = torch.full((b, h, cap), -1, dtype=torch.int32, device="cuda")
        before = wrapper.mode_launches[entry]
        dots = dots if scores else None
        if splits or warps:
            out = at._launch_grouped_int8_rows(
                q, kv, scales, lengths, scores, None, dots,
                at.rows_plan(b, h, kvh, cap, d, splits, warps))
        else:
            out = wrapper(q, kv, scales, lengths, int8_scores=scores,
                          dots=dots)
        ref = at.decode_attn_grouped_int8_plain(q, kv, scales, lengths,
                                                int8_scores=scores)
        assert wrapper.mode_launches[entry] == before + 1
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= (
        F32_REL_TOL * ref.abs().max().item())
    if scores:
        want = at.int8_score_dots_plain(q, kv, lengths)
        live = (torch.arange(cap, device="cuda")[None, None, :]
                < lengths.clamp(max=cap)[:, None, None])
        assert torch.equal(torch.where(live, dots, 0), want)


@pytest.mark.parametrize("b,cap,lens", [
    (1, 100, [0]), (1, 4095, [4100]), (2, 77, [0, 90]),
    (3, 4100, [0, 576, 4107]), (3, 1000, [1, 999, 1000])])
def test_fused_int8_kernel_takes_ragged_capacities(gen, b, cap, lens):
    """G2 (the KV-group kernel, exact q) at batches 1-3 and Mistral-7B's
    head shape over capacities no block divides, with lengths 0 and past
    the capacity: against its plain version, one launch counted and one
    CUDA kernel a call."""
    h, kvh, d = 32, 8, 128
    kv, scales = _int8_cache(gen, b, cap, kvh, d)
    q = torch.randn((b, h, d), device="cuda", generator=gen)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    before = at.decode_attn_fused_int8.launches
    out = at.decode_attn_fused_int8(q, kv, scales, lengths)
    ref = at.decode_attn_fused_int8_plain(q, kv, scales, lengths)
    torch.cuda.synchronize()
    assert at.decode_attn_fused_int8.launches == before + 1
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= (
        F32_REL_TOL * ref.abs().max().item())
    assert not out[lengths == 0].any()
    assert _cuda_kernels_a_call(
        lambda: at.decode_attn_fused_int8(q, kv, scales, lengths)) == 1


# A1's cases (batch, heads, KV heads, head_dim, capacity, lengths counting
# the new token, splits, warps; None: rows_plan's): lengths from 0 (row 0
# written, zeros out) to past capacity (the last row); 4 splits where the
# length-1 sequence leaves three without a row, 8 of 8 warps with a
# sequence in one split; and path (H-append)'s shape at the plan and at
# every split count of 4 and 8 warps.
H_APPEND_LENS = list(range(512, 576, 4))
APPEND_CASES = ([(4, 8, 2, 128, 64, [0, 1, 64, 90], None, None),
                 (3, 4, 4, 64, 128, [7, 128, 1], None, None),
                 (16, 32, 8, 128, 4096, H_APPEND_LENS, None, None),
                 (4, 8, 2, 128, 64, [0, 1, 64, 90], 4, 4),
                 (3, 4, 4, 64, 128, [7, 128, 0], 8, 8)]
                + [(16, 32, 8, 128, 4096, H_APPEND_LENS, splits, warps)
                   for splits in range(1, 9) for warps in (4, 8)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kvh,d,cap,lens,splits,warps", APPEND_CASES,
                         ids=str)
def test_grouped_append_kernel_matches_plain(gen, dtype, b, h, kvh, d, cap,
                                             lens, splits, warps):
    """A1 (the KV-group kernel with the write fused) against K5 + K6's
    contract: the written cache bit for bit (K5's write too), the output
    within 1e-5 of max |out|; lengths count the new token, from 0 (row 0
    written, zeros out) to past capacity (the last row); k and v are
    strided views, as the model passes them; the plan's launch or one
    forced through the launcher; one launch counted and one CUDA kernel a
    call."""
    kv = torch.randn((b, cap, 2, kvh * d), device="cuda",
                     generator=gen).to(dtype)
    q = torch.randn((b, h, d), device="cuda", generator=gen)
    qkv = torch.randn((b, 1, 3 * kvh * d), device="cuda", generator=gen)
    k = qkv[..., :kvh * d].reshape(b, 1, kvh, d).transpose(1, 2)
    v = qkv[..., kvh * d:2 * kvh * d].reshape(b, 1, kvh, d).transpose(1, 2)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    kv1, kv2, kv3 = kv.clone(), kv.clone(), kv.clone()
    if splits or warps:
        plan = at.rows_plan(b, h, kvh, cap, d, splits, warps)
        call = lambda: at._launch_grouped_append(q, kv1, k, v, lengths,
                                                 None, plan)
    else:
        call = lambda: at.decode_attn_grouped_append(q, kv1, k, v, lengths)
    before = at.decode_attn_grouped_append.launches
    out = call()
    ref = at.decode_attn_grouped_append_plain(q, kv2, k, v, lengths)
    kc.kv_append(kv3, k, v, lengths - 1)
    torch.cuda.synchronize()
    assert at.decode_attn_grouped_append.launches == before + 1
    assert torch.equal(kv1, kv2) and torch.equal(kv1, kv3)
    assert torch.isfinite(out).all()
    assert not out[lengths == 0].any()
    assert (out - ref).abs().max().item() <= (
        F32_REL_TOL * ref.abs().max().item())
    assert _cuda_kernels_a_call(call) == 1


# -- the last four TPU functions: K8, partials, K9, native_dots, pv_int8, M1 --

def _float_kv(gen, b, cap, kvh, d, dtype):
    return torch.randn((b, cap, 2, kvh * d), device="cuda",
                       generator=gen).to(dtype)


# chip_smoke.py's criteria for the kernels whose job is a rounding. K8 and
# the partials mode with q_bf16 round the output to bf16 after K6's f32
# sums: every element within one bf16 step of its own value plus K6's
# 1e-5 of max |out|, and at least 99.9% within 2e-5 of max |out|, which the
# unrounded kernel misses. native_dots and pv_int8 round every
# probability: at least 99% of the elements within 1e-5 of max |out|,
# which the kernel without the mode misses, and none past one flipped
# rounding of one probability. Their batches hold 512 heads, so a flip in
# one head moves the share by 0.2% at most.
BF16_STEP = 2.0 ** -7
ROUND_ELEM_TOL, ROUND_SHARE = 2e-5, 0.999
FLIP_SHARE = 0.99


def _share_within(out, ref, rel):
    return (out - ref).abs().le(rel * ref.abs().max()).float().mean().item()


def _assert_rounded(out, ref, unrounded):
    err = (out - ref).abs()
    assert (err <= BF16_STEP * ref.abs() + 1e-5 * ref.abs().max()).all()
    assert _share_within(out, ref, ROUND_ELEM_TOL) >= ROUND_SHARE
    if unrounded is not None:
        assert _share_within(unrounded, ref, ROUND_ELEM_TOL) < ROUND_SHARE


def _assert_flips(out, ref, tol, without):
    assert (out - ref).abs().max().item() <= tol
    assert _share_within(out, ref, 1e-5) >= FLIP_SHARE
    assert _share_within(without, ref, 1e-5) < FLIP_SHARE


def _lengths(pattern, b):
    return torch.tensor(pattern, dtype=torch.int32,
                        device="cuda").repeat(b // len(pattern))


# Lengths 0 (zeros), 1, a 16-row unit - 1, + 0 and + 1, ragged, the
# capacity less one, the capacity and past it.
FLAT_LENGTHS = [0, 1, 15, 16, 17, 33, 95, 96, 105, 64]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128, 192, 256])
@pytest.mark.parametrize("h,kvh,splits,warps", [
    (4, 2, None, None), (8, 8, None, None), (16, 2, None, None),
    (32, 2, None, None), (8, 1, 3, None), (4, 2, 6, 4), (16, 1, 2, 8),
    (4, 4, 1, 4)])
def test_flat_float_kernel_matches_plain(gen, d, dtype, h, kvh, splits,
                                         warps):
    """K8 (the KV-group kernel in its flat mode) at groups 1, 2, 8 and 16
    and head_dim 64 to 256, with the plan's splits and with 1, 2, 3 or 6
    chunks of whole 16-row units and 4 or 8 warps forced through the
    launcher's plan: both versions round the output to bf16 (the criterion
    above), and K6 at the same inputs misses its share."""
    b, cap = 40, 96
    q = torch.randn((b, h, d), device="cuda", generator=gen)
    kv = _float_kv(gen, b, cap, kvh, d, dtype)
    lengths = _lengths(FLAT_LENGTHS, b)
    before = at.decode_attn_flat_float.launches
    if splits or warps:
        out = at._launch_rows_float(
            at.decode_attn_flat_float, q, kv, lengths, None,
            at.rows_plan(b, h, kvh, cap, d, splits, warps))
    else:
        out = at.decode_attn_flat_float(q, kv, lengths)
    ref = at.decode_attn_flat_float_plain(q, kv, lengths)
    assert at.decode_attn_flat_float.launches == before + 1
    _assert_rounded(out, ref, at.decode_attn_float(q, kv, lengths))
    assert (out[0] == 0).all()


def _cuda_kernels_a_call(fn, calls=3):
    """The CUDA kernels one call of ``fn`` launches, by the profiler's
    device events (the most of up to ten sessions, until one counts a
    whole number a call: the profiler can lose a kernel, never adds
    one)."""
    from torch.profiler import DeviceType, ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    most = 0
    for _ in range(10):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        most = max(most, sum(1 for e in prof.events()
                             if e.device_type == DeviceType.CUDA))
        if most and most % calls == 0:
            break
    return most / calls


def test_kv_group_float_kernels_are_one_launch(gen):
    """P3, its grid mode (split into chunks merged in their cluster) and K8
    (split, f32 and bf16) launch one CUDA kernel a call."""
    b, h, kvh, d, max_pages, n_pages = 3, 8, 2, 64, 4, 16
    table = _paged_table(b, max_pages, [4, 2, 3], n_pages, seed=4)
    lengths = torch.tensor([4 * PAGE, 2 * PAGE - 1, 3 * PAGE],
                           dtype=torch.int32, device="cuda")
    q = torch.randn((b, h, d), device="cuda", generator=gen)
    pool = torch.randn((n_pages, PAGE, 2, kvh * d), device="cuda",
                       generator=gen)
    assert at.paged_plan(b, h, kvh, PAGE, max_pages, d)["splits"] > 1
    calls = [lambda: at.decode_attn_paged(q, pool, table, lengths),
             lambda: at.decode_attn_paged_grid(q, pool, table, lengths)]
    lived = lengths.clamp(max=64)
    for dtype in (torch.float32, torch.bfloat16):
        kv = _float_kv(gen, b, 64, kvh, d, dtype)
        calls.append(lambda kv=kv: at.decode_attn_flat_float(q, kv, lived))
    for fn in calls:
        assert _cuda_kernels_a_call(fn) == 1


@pytest.mark.parametrize("q_bf16", [True, False])
@pytest.mark.parametrize("h,kvh,d,cap", [(4, 2, 64, 128), (4, 2, 128, 4096),
                                         (32, 4, 64, 2048)])
def test_partials_kernel_matches_plain(gen, h, kvh, d, cap, q_bf16):
    """The partials mode (the KV-group kernel at rows_plan, its sequences
    split into chunks merged in their cluster; at TinyLlama's 32 query
    heads over 4 KV heads, capacity 2048, 4 splits of 8 heads a block),
    lengths 0 (acc 0, m -1e30, l 0) through capacity, one CUDA kernel a
    call; acc with q_bf16 held as K8's output."""
    b = 16
    assert at.rows_plan(b, h, kvh, cap, d)["splits"] > 1
    kv, scales, _ = _cache(gen, b, cap, 1, kvh, d)
    q = torch.randn((b, h, d), device="cuda", generator=gen)
    lengths = _lengths([0, 1, cap // 3, cap], b)
    out = at.decode_attn_int8_partials(q, kv, scales, lengths, q_bf16)
    ref = at.decode_attn_int8_partials_plain(q, kv, scales, lengths, q_bf16)
    if q_bf16:
        _assert_rounded(out[..., :d], ref[..., :d], None)
    else:
        assert ((out[..., :d] - ref[..., :d]).abs().max()
                <= 1e-5 * ref[..., :d].abs().max())
    full = lengths > 0
    for lane in (d, d + 1):      # m and l, within 1e-5 of their largest
        live = ref[full, :, lane]
        assert ((out[full, :, lane] - live).abs().max()
                <= 1e-5 * live.abs().max())
    assert ((out[~full, :, d] == -1e30).all()
            and (out[~full, :, d + 1] == 0).all()
            and (out[~full, :, :d] == 0).all())
    assert _cuda_kernels_a_call(lambda: at.decode_attn_int8_partials(
        q, kv, scales, lengths, q_bf16)) == 1


# (B, H, KVH, head_dim, S): GQA 4:1 at the reference's kernel shapes, and
# path (H)'s head shape (32 query heads over 8 KV heads of 128).
SPLIT_KV_SHAPES = [(4, 8, 2, 128, 256), (4, 8, 2, 256, 512),
                   (4, 32, 8, 128, 1024)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kvh,d,s", SPLIT_KV_SHAPES)
def test_split_kv_kernel_matches_plain(gen, b, h, kvh, d, s, dtype):
    """K9 (the KV-group kernel over separate planes, split into chunks
    merged in their cluster) at the reference's kernel shapes, lengths 0
    (zeros) through past S, one CUDA kernel a call; at a shape the
    reference sends to its plain path the wrapper launches nothing."""
    assert at.rows_plan(b, h, kvh, s, d)["splits"] > 1
    q = torch.randn((b, h, d), device="cuda", generator=gen)
    k, v = (torch.randn((b, kvh, s, d), device="cuda", generator=gen)
            .to(dtype) for _ in range(2))
    lengths = torch.tensor([0, 1, s // 3, s + 5], dtype=torch.int32,
                           device="cuda")
    before = at.decode_attn_split_kv.launches
    out = at.decode_attn_split_kv(q, k, v, lengths)
    ref = at.decode_attn_split_kv_plain(q, k, v, lengths)
    assert at.decode_attn_split_kv.launches == before + 1
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()
    assert (out[0] == 0).all()
    assert _cuda_kernels_a_call(
        lambda: at.decode_attn_split_kv(q, k, v, lengths)) == 1
    before = at.decode_attn_split_kv.launches
    q64 = torch.randn((b, h, 64), device="cuda", generator=gen)
    k64 = k[..., :64].contiguous()
    at.decode_attn_split_kv(q64, k64, k64, lengths)
    assert at.decode_attn_split_kv.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,block_k", [(64, 64), (128, 32)])
def test_native_dots_kernel_matches_plain(gen, d, block_k, dtype):
    """native_dots at group 2, lengths 1 through capacity: on a bf16 cache
    a bf16 rounding of p may flip between the versions (the criterion
    above, with chip_smoke.py's NATIVE_STEP of max |V| per flip, and K6
    missing the share); on an f32 cache it is K6's arithmetic (K6's
    tolerance)."""
    b, h, kvh, cap = 128, 4, 2, 256
    q = torch.randn((b, h, d), device="cuda", generator=gen)
    kv = _float_kv(gen, b, cap, kvh, d, dtype)
    lengths = _lengths([1, 70, 200, cap], b)
    kw = dict(block_k=block_k, group=2)
    before = at.decode_attn_native_dots.launches
    out = at.decode_attn_native_dots(q, kv, lengths, **kw)
    ref = at.decode_attn_native_dots_plain(q, kv, lengths, **kw)
    assert at.decode_attn_native_dots.launches == before + 1
    if dtype == torch.bfloat16:
        _assert_flips(out, ref, 2.0 ** -7 * kv[:, :, 1].abs().max().item(),
                      at.decode_attn_float(q, kv, lengths))
    else:
        assert ((out - ref).abs().max().item()
                <= 1e-5 * ref.abs().max().item())


@pytest.mark.parametrize("int8_scores", [False, True])
@pytest.mark.parametrize("d,block_k", [(64, 64), (128, 128)])
def test_pv_int8_kernel_matches_plain(gen, d, block_k, int8_scores):
    """G1's pv_int8 mode at group 2, lengths 1 through capacity: an int8
    step of one probability may flip between the versions (the criterion
    above, with chip_smoke.py's PV_INT8_STEP per flip, and G1 without
    pv_int8 missing the share)."""
    b, h, kvh, cap = 128, 4, 2, 512
    kv, scales, _ = _cache(gen, b, cap, 1, kvh, d)
    q = torch.randn((b, h, d), device="cuda", generator=gen)
    lengths = _lengths([1, 65, 300, cap], b)
    kw = dict(int8_scores=int8_scores, pv_int8=True, block_k=block_k,
              group=2)
    mode = "pv_int8." + ("int8_scores" if int8_scores else "exact")
    before = at.decode_attn_grouped_int8.mode_launches[mode]
    out = at.decode_attn_grouped_int8(q, kv, scales, lengths, **kw)
    ref = at.decode_attn_grouped_int8_plain(q, kv, scales, lengths, **kw)
    assert at.decode_attn_grouped_int8.mode_launches[mode] == before + 1
    g1 = at.decode_attn_grouped_int8(q, kv, scales, lengths,
                                     int8_scores=int8_scores)
    _assert_flips(out, ref, scales[:, :, 1].float().max().item(), g1)


# The block modes on the KV-group kernel (native_dots on a bf16 cache,
# pv_int8): (head_dim, block, heads, KV heads) at capacity 384. A block
# shorter than a ring tile (32, 48: the tile holds one block, partly), one
# as long (64 at head_dim 64), blocks spanning two or more tiles (128 at
# head_dim 64; 64, 96 and 128 at head_dim 128, whose bf16 tile is 32 rows;
# 128 of int8) and one that is not a power of two (48, 96); GQA groups of
# 1, 4 and 8.
BLOCK_CASES = [(64, 32, 4, 4), (64, 48, 8, 2), (64, 64, 8, 1),
               (64, 128, 8, 2), (128, 64, 4, 4), (128, 96, 8, 1),
               (128, 128, 8, 2)]
BLOCK_CAP = 384


def _block_lengths(block, b):
    """Lengths 0, 1, one row into the second and into the third block (a
    last block with one live row), 200 and the capacity, repeated."""
    return _lengths([0, 1, block + 1, 2 * block + 1, 200, BLOCK_CAP], b)


@pytest.mark.parametrize("d,block,h,kvh", BLOCK_CASES, ids=str)
def test_native_dots_kernel_block_cases(gen, d, block, h, kvh):
    """native_dots on a bf16 cache at BLOCK_CASES: one split (the plan
    refuses two), the flip criterion against the plain version with K6
    missing its share, and one CUDA kernel a call."""
    b = 96
    q = torch.randn((b, h, d), device="cuda", generator=gen)
    kv = _float_kv(gen, b, BLOCK_CAP, kvh, d, torch.bfloat16)
    lengths = _block_lengths(block, b)
    kw = dict(block_k=block, group=2)
    plan = at.block_plan(b, h, kvh, BLOCK_CAP, block, d, native=True)
    assert plan["splits"] == 1 and plan["unit"] == block
    before = at.decode_attn_native_dots.launches
    out = at.decode_attn_native_dots(q, kv, lengths, **kw)
    ref = at.decode_attn_native_dots_plain(q, kv, lengths, **kw)
    assert at.decode_attn_native_dots.launches == before + 1
    _assert_flips(out, ref, 2.0 ** -7 * kv[:, :, 1].abs().max().item(),
                  at.decode_attn_float(q, kv, lengths))
    assert (out[0::6] == 0).all()
    assert _cuda_kernels_a_call(
        lambda: at.decode_attn_native_dots(q, kv, lengths, **kw)) == 1
    with pytest.raises(ValueError, match="native_dots takes one split"):
        at._launch_native_dots(q, kv, lengths, block, None, at.block_plan(
            b, h, kvh, BLOCK_CAP, block, d, splits=2))


@pytest.mark.parametrize("int8_scores", [False, True])
@pytest.mark.parametrize("splits", [None, 2])
@pytest.mark.parametrize("d,block,h,kvh", BLOCK_CASES, ids=str)
def test_pv_int8_kernel_block_cases(gen, d, block, h, kvh, splits,
                                    int8_scores):
    """pv_int8 at BLOCK_CASES, at the plan's splits and at two (lengths 200
    and the capacity cross the split; every chunk whole blocks): the flip
    criterion against the plain version with G1 without pv_int8 missing
    its share, the launch counted in its mode, one CUDA kernel a call."""
    b = 96
    kv, scales, _ = _cache(gen, b, BLOCK_CAP, 1, kvh, d)
    q = torch.randn((b, h, d), device="cuda", generator=gen)
    lengths = _block_lengths(block, b)
    plan = at.block_plan(b, h, kvh, BLOCK_CAP, block, d, splits)
    assert plan["unit"] == block
    if splits:
        (_, c), (c0, c1) = at.kv_group_chunks(200, splits, block)
        assert c == c0 and c0 % block == 0 and 0 < c0 < c1
    mode = "pv_int8." + ("int8_scores" if int8_scores else "exact")
    call = lambda: at._launch_pv_int8(q, kv, scales, lengths, int8_scores,
                                      None, block, plan)
    before = at.decode_attn_grouped_int8.mode_launches[mode]
    out = call()
    ref = at.decode_attn_grouped_int8_plain(
        q, kv, scales, lengths, int8_scores=int8_scores, pv_int8=True,
        block_k=block, group=2)
    assert at.decode_attn_grouped_int8.mode_launches[mode] == before + 1
    g1 = at.decode_attn_grouped_int8(q, kv, scales, lengths,
                                     int8_scores=int8_scores)
    _assert_flips(out, ref, scales[:, :, 1].float().max().item(), g1)
    assert (out[0::6] == 0).all()
    assert _cuda_kernels_a_call(call) == 1


# GPT-2-small's linears (K, N): QKV, O, MLP up, MLP down.
M1_GPT2 = [(768, 2304), (768, 768), (768, 3072), (3072, 768)]


@pytest.mark.parametrize("m,k,n,splits", [
    (1, 1, 1, None), (17, 33, 65, None), (64, 768, 768, None),
    (300, 1100, 520, None), (96, 40, 130, None), (300, 1100, 520, 8),
    (200, 768, 768, 6), (4096, 1100, 520, None), (4096, 768, 768, 2)]
    + [(m, k, n, None) for m in (256, 4096) for k, n in M1_GPT2])
def test_matmul_int8_tiled_kernel_bit_exact(gen, m, k, n, splits):
    """M1 bit for bit against its plain version at ragged shapes (the
    masked loader, 64- and 128-column tiles) and at GPT-2's linears at M
    256 and 4096 (tensor-map copies; at M 256 O and down split K over a
    cluster), and with K split over 8 (ragged), 6 or 2 (128-column tiles)
    blocks, with the scale as a float and as a one-element tensor; two
    calls give the same bits."""
    x = torch.randint(-127, 128, (m, k), device="cuda", dtype=torch.int8,
                      generator=gen)
    w = torch.randint(-127, 128, (k, n), device="cuda", dtype=torch.int8,
                      generator=gen)
    ws = 0.001 + torch.rand(n, device="cuda", generator=gen)
    plan = pg.matmul_int8_plan(m, k, n, pg._sm_count(x.device), splits)
    assert plan["loader"] == ("tma" if k % 16 == 0 and n % 16 == 0
                              else "regs")
    for xs in (0.07, torch.tensor(0.0173, device="cuda")):
        out = pg._launch_int8_tiled(x, w, xs, ws, plan)
        assert torch.equal(out, pg.matmul_int8_tiled_plain(x, w, xs, ws))
        assert torch.equal(out, pg._launch_int8_tiled(x, w, xs, ws, plan))
    if splits is None:
        assert torch.equal(pg.matmul_int8_tiled(x, w, 0.07, ws),
                           pg.matmul_int8_tiled_plain(x, w, 0.07, ws))


# -- IEEE division on the card ----------------------------------------------
# CUDA PyTorch divides a tensor by a Python float through a multiply by its
# reciprocal; the port divides by a tensor instead, so the card's quantizers
# give the CPU's bits. Each case below places values where a * f32(1 / d)
# and a / d differ in f32 (found with numpy from a seed) as the absmax that
# is divided; on the CPU both forms were already IEEE.

def _reciprocal_misses(d, n, seed, lo=0.25, hi=8.0):
    """n f32 values a in [lo, hi) with a * f32(1 / d) != a / d in f32."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(lo, hi, 200 * n).astype(np.float32)
    miss = a[a * (np.float32(1) / np.float32(d)) != a / np.float32(d)]
    assert len(miss) >= n
    return torch.from_numpy(miss[:n].copy())


def _with_absmax(shape, absmax, axis, seed):
    """Values of magnitude below 0.9 ``absmax`` with ``absmax`` [...]
    itself placed (with a random sign) once along ``axis`` of each slice;
    numpy from a seed."""
    rng = np.random.default_rng(seed)
    moved = list(shape)
    moved.append(moved.pop(axis))
    a = absmax.reshape(-1, 1)
    flat = torch.from_numpy(rng.uniform(-0.9, 0.9, (a.shape[0], moved[-1])
                                        ).astype(np.float32)) * a
    sign = torch.from_numpy(rng.choice([-1.0, 1.0], a.shape[0]).astype(
        np.float32))
    at_ = torch.from_numpy(rng.integers(0, moved[-1], a.shape[0]))
    flat[torch.arange(a.shape[0]), at_] = sign * a[:, 0]
    return flat.reshape(moved).movedim(-1, axis).contiguous()


def _same_bits(a, b):
    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return a.dtype == b.dtype and torch.equal(a, b)


def test_abs_max_quantize_int8_on_the_card_matches_the_cpu(gen):
    absmax = _reciprocal_misses(127.0, 64, seed=1)
    w = _with_absmax((16, 64), absmax, axis=0, seed=2)
    q_cpu, s_cpu = abs_max_quantize_int8(w, axis=0)
    q_gpu, s_gpu = abs_max_quantize_int8(w.cuda(), axis=0)
    assert _same_bits(s_gpu, s_cpu) and _same_bits(q_gpu, q_cpu)


def test_quantize_tokens_on_the_card_matches_the_cpu(gen):
    absmax = _reciprocal_misses(127.0, 6 * 4, seed=3)
    x = _with_absmax((6, 4, 64), absmax, axis=2, seed=4)
    q_cpu, s_cpu = quantize_tokens(x)
    q_gpu, s_gpu = quantize_tokens(x.cuda())
    assert _same_bits(s_gpu, s_cpu) and _same_bits(q_gpu, q_cpu)


@pytest.mark.parametrize("layout", ["words", "bytes"])
@pytest.mark.parametrize("crafted", [True, False])
def test_int4_quantizers_on_the_card_match_the_cpu(gen, layout, crafted):
    """Group scales absmax / 7 (crafted absmax, and random 0.02-scale
    weights) and the packed nibbles, card against CPU, bit for bit."""
    k, n, group = 512, 512, 128
    if crafted:
        absmax = _reciprocal_misses(7.0, (k // group) * n, seed=5,
                                    lo=0.01, hi=0.1)
        w = _with_absmax((k // group, group, n), absmax.reshape(-1, n),
                         axis=1, seed=6).reshape(k, n)
    else:
        w = torch.from_numpy((0.02 * np.random.default_rng(7).standard_normal(
            (k, n))).astype(np.float32))
    make = quantize_int4_words if layout == "words" else \
        quantize_int4_groupwise
    p_cpu, s_cpu = make(w, group)
    p_gpu, s_gpu = make(w.cuda(), group)
    assert _same_bits(s_gpu, s_cpu) and _same_bits(p_gpu, p_cpu)


def test_dynamic_quantize_on_the_card_matches_the_cpu(gen):
    for i, top in enumerate(_reciprocal_misses(255.0, 8, seed=8).tolist()):
        x = torch.from_numpy(np.random.default_rng(9 + i).uniform(
            0.0, top, 1000).astype(np.float32))
        x[17] = top
        for a, b in zip(dynamic_quantize(x.cuda()), dynamic_quantize(x)):
            assert _same_bits(a, b)


def test_quantize_q_rows_on_the_card_matches_the_cpu(gen):
    """G1's q quantization for its int8 scores."""
    absmax = _reciprocal_misses(127.0, 4 * 8, seed=10)
    q = _with_absmax((4, 8, 128), absmax, axis=2, seed=11)
    for a, b in zip(at.quantize_q_rows(q.cuda()), at.quantize_q_rows(q)):
        assert _same_bits(a, b)


def test_int8_activations_on_the_card_match_the_cpu(gen):
    """The model's per-tensor int8 activation scale at M > 64 (the int8 x
    int8 linear): the whole linear, card against CPU, bit for bit."""
    w = torch.from_numpy((0.02 * np.random.default_rng(12).standard_normal(
        (256, 128))).astype(np.float32))
    qw = QuantWeight("int8", *pg.pad_cols(*abs_max_quantize_int8(w)), 128)
    for i, top in enumerate(_reciprocal_misses(127.0, 4, seed=13).tolist()):
        x = torch.from_numpy(np.random.default_rng(14 + i).uniform(
            -0.2, 0.2, (80, 256)).astype(np.float32))
        x[5, 9] = -top
        gpu_w = QuantWeight("int8", qw.data.cuda(), qw.scales.cuda(), 128)
        assert _same_bits(linear(x.cuda(), gpu_w), linear(x, qw))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,kvh,d,offset", K7_SHAPES, ids=str)
def test_kv_append_int8_kernel_bit_exact_at_crafted_scales(gen, masked, b,
                                                           kvh, d, offset):
    """K7 against its plain version where the reciprocal form would round
    a row's scale the other way (plain and kernel both IEEE now), at K7's
    shapes and both ``masked`` modes."""
    cap = 64
    kv, scales, _ = _cache(gen, b, cap, 1, kvh, d)
    x = _with_absmax((b, kvh, 1, d), _reciprocal_misses(127.0, b * kvh, 15),
                     axis=3, seed=16).cuda()
    k, v = rows_view(x, offset), rows_view(x.flip(0), offset)
    pos = _k7_positions(b, cap, masked)
    kv1, s1, kv2, s2 = kv.clone(), scales.clone(), kv.clone(), scales.clone()
    kc.kv_append_int8(kv1, s1, k, v, pos, masked=masked)
    kc.kv_append_int8_plain(kv2, s2, k, v, pos, masked=masked)
    torch.cuda.synchronize()
    assert torch.equal(kv1, kv2) and torch.equal(s1, s2)


# -- Q1 and Q2: both tiles ---------------------------------------------------

INT4_BF16 = {"words": pg.matmul_int4_words, "bytes": pg.matmul_int4}
# One pack tile, and TinyLlama's int4 weights (K, N).
INT4_BF16_SHAPES = [(512, 256), (2048, 2560), (2048, 2048), (2048, 5632),
                    (5632, 2048), (2048, 32000)]


def _int4_bf16_plain(layout, x, packed, scales, group):
    if layout == "words":
        return pg.matmul_int4_words_plain(x, packed, scales, group, "bf16")
    return pg.matmul_int4_plain(x, packed, scales, group)


@pytest.mark.parametrize("group", [64, 128])
@pytest.mark.parametrize("k,n", INT4_BF16_SHAPES, ids=str)
@pytest.mark.parametrize("m", [1, 5, 16, 17, 64, 65, 1024])
@pytest.mark.parametrize("layout", list(INT4_BF16))
def test_int4_bf16_kernels_match_plain_on_both_tiles(gen, layout, m, k, n,
                                                     group):
    """Q1 (words) and Q2 (bytes) against their plain versions at decode
    (M <= 64) and prefill (M > 64) M, one launch counted a call."""
    wrapper = INT4_BF16[layout]
    x, packed, scales = int4_case(gen, layout, m, k, n, group)
    before = wrapper.launches
    out = wrapper(x, packed, scales, group)
    ref = _int4_bf16_plain(layout, x, packed, scales, group)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert out.shape == (m, n) and torch.isfinite(out).all()
    bound = int4_bound(x, packed, scales, layout)
    assert ((out - ref).abs() <= bound + 1e-30).all(), \
        ((out - ref).abs() / bound).max().item()


@pytest.mark.parametrize("m,k,n,splits", [(16, 2048, 2560, None),
                                          (16, 2048, 2560, 3),
                                          (16, 5632, 2048, 16),
                                          (40, 2048, 5632, 5),
                                          (1, 512, 256, 1),
                                          (100, 384, 768, None),
                                          (1024, 2048, 5632, None)],
                         ids=str)
@pytest.mark.parametrize("layout", list(INT4_BF16))
def test_int4_bf16_kernels_are_deterministic(gen, layout, m, k, n, splits):
    """Two calls on the same inputs agree bit for bit (the split-K sum in
    split order, no atomics), and uneven splits agree with the plain
    version."""
    wrapper = INT4_BF16[layout]
    x, packed, scales = int4_case(gen, layout, m, k, n)
    first = pg._launch_int4(wrapper, x, packed, scales, 128, splits)
    second = pg._launch_int4(wrapper, x, packed, scales, 128, splits)
    ref = _int4_bf16_plain(layout, x, packed, scales, 128)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    bound = int4_bound(x, packed, scales, layout)
    assert ((first - ref).abs() <= bound + 1e-30).all()


@pytest.mark.parametrize("m", [16, 100])
@pytest.mark.parametrize("layout", list(INT4_BF16))
def test_int4_bf16_kernels_take_unaligned_inputs(gen, layout, m):
    """Contiguous x and scales that do not start on a 16-byte boundary
    (the kernels read them 16 bytes at a time): the wrapper copies them,
    as the old kernel took them, and the result is the aligned one's."""
    x, packed, scales = int4_case(gen, layout, m, 512, 256)
    xs = torch.empty(x.numel() + 1, device="cuda")[1:].view(x.shape)
    ss = torch.empty(scales.numel() + 1, device="cuda")[1:].view(
        scales.shape)
    xs.copy_(x)
    ss.copy_(scales)
    assert xs.data_ptr() % 16 and ss.data_ptr() % 16 and xs.is_contiguous()
    out = INT4_BF16[layout](xs, packed, ss)
    ref = INT4_BF16[layout](x, packed, scales)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


def _one_hot_rows(m, k, step=37):
    """x [m, k] with row i one-hot (1.0) at K row (step * i) % k."""
    x = torch.zeros((m, k), device="cuda")
    rows = (step * torch.arange(m, device="cuda")) % k
    x[torch.arange(m, device="cuda"), rows] = 1.0
    return x, rows


@pytest.mark.parametrize("m", [64, 128])
@pytest.mark.parametrize("layout", list(INT4_BF16))
def test_int4_bf16_nibble_times_scale_is_exact(gen, layout, m):
    """Every nibble (all 16 values in every group) times a sweep of scales
    (2^-30 .. 2^10, all mantissas): a one-hot x reads back one weight row
    per output row, bf16(bf16(q) * bf16(s)) bit for bit against
    ``_grouped_bf16`` (Q2) and the plain formula (Q1), on the decode (M 64)
    and prefill (M 128) tiles."""
    k, n, group = 256, 512, 64
    rng = np.random.default_rng(17)
    q = torch.from_numpy(rng.integers(-8, 8, (k, n)).astype(np.int8))
    q[:16, :] = torch.arange(-8, 8, dtype=torch.int8)[:, None]
    scales = torch.from_numpy((2.0 ** rng.uniform(-30, 10, (k // group, n))
                               ).astype(np.float32))
    q, scales = q.cuda(), scales.cuda()
    packed = pack_int4_words(q) if layout == "words" else pack_int4(q)
    x, rows = _one_hot_rows(m, k)
    out = INT4_BF16[layout](x, packed, scales, group)
    ref = _int4_bf16_plain(layout, x, packed, scales, group)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    if layout == "bytes":
        assert torch.equal(out, pg._grouped_bf16(q.float(), scales,
                                                 group)[rows])


@pytest.mark.parametrize("m", [16, 64, 200])
@pytest.mark.parametrize("layout", list(INT4_BF16))
def test_int4_bf16_k_order_of_a_and_b_agree(gen, layout, m):
    """One-hot x against one-hot weights (column j holds 7 at one K row,
    0 elsewhere): output (i, j) is nonzero exactly where x's K row is the
    column's, so any mismatch between the K order of the A fragments and
    of the B words shows."""
    k, n, group = 128, 256, 64
    hot = (torch.arange(n, device="cuda") * 5) % k
    q = torch.zeros((k, n), dtype=torch.int8, device="cuda")
    q[hot, torch.arange(n, device="cuda")] = 7
    scales = torch.ones((k // group, n), device="cuda")
    packed = pack_int4_words(q) if layout == "words" else pack_int4(q)
    x, rows = _one_hot_rows(m, k, step=3)
    out = INT4_BF16[layout](x, packed, scales, group)
    ref = _int4_bf16_plain(layout, x, packed, scales, group)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    expect = 7.0 * (rows[:, None] == hot[None, :]).float()
    assert torch.equal(out, expect)


# -- bf16 compute, bf16 paged pools and the MoE block ------------------------

def _bf16_valued(shape, gen):
    """f32 tensors on the card holding bf16 values: the model's bf16
    activations as the kernels take them, widened (exactly) to f32."""
    return torch.randn(shape, device="cuda", generator=gen).to(
        torch.bfloat16).float()


def _within_a_bf16_step(out, ref):
    """Outputs the model rounds to bf16 (the reference's kernels write
    bf16 under bf16 compute): within one bf16 step of the largest."""
    got = out.to(torch.bfloat16).float()
    want = ref.to(torch.bfloat16).float()
    assert (got - want).abs().max().item() <= 2.0 ** -8 * want.abs().max(
        ).item()


@pytest.mark.parametrize("kernel", ["F1", "G1", "K7", "K4", "K2"])
def test_kernels_on_bf16_compute_inputs_match_plain(gen, kernel):
    """F1, G1, K7, K4 and K2 at Mixtral's head shape (32 query heads over 8
    KV heads of 128) and width, on bf16-valued inputs: F1 and G1 within a
    bf16 step of their plain versions once rounded as the model rounds
    them, K7's bytes and scales and K2's argmax bit for bit, K4 within
    1e-5 of its largest output."""
    if kernel == "F1":
        q, k, v = (_bf16_valued((2, 32, 128, 128), gen) for _ in range(3))
        _within_a_bf16_step(at.flash_attention(q, k, v, causal=True),
                            at.flash_attention_plain(q, k, v, causal=True))
    elif kernel == "G1":
        b, cap = 16, 1024
        kv, scales, _ = _cache(gen, b, cap, 1, 8, 128)
        q = _bf16_valued((b, 32, 128), gen)
        lengths = torch.randint(1, cap + 1, (b,), device="cuda",
                                dtype=torch.int32, generator=gen)
        _within_a_bf16_step(
            at.decode_attn_grouped_int8(q, kv, scales, lengths),
            at.decode_attn_grouped_int8_plain(q, kv, scales, lengths))
    elif kernel == "K7":
        b, cap = 16, 64
        x = _bf16_valued((b, 8, 1, 128), gen)
        kv = torch.zeros((b, cap, 2, 1024), dtype=torch.int8, device="cuda")
        scales = torch.ones((b, cap, 2, 8), dtype=torch.bfloat16,
                            device="cuda")
        pos = torch.arange(b, dtype=torch.int32, device="cuda") * 3
        k1, s1, k2, s2 = kv.clone(), scales.clone(), kv.clone(), \
            scales.clone()
        kc.kv_append_int8(k1, s1, x, x.flip(0), pos)
        kc.kv_append_int8_plain(k2, s2, x, x.flip(0), pos)
        torch.cuda.synchronize()
        assert torch.equal(k1, k2) and torch.equal(s1, s2)
    else:
        w, s = abs_max_quantize_int8(0.02 * torch.randn(
            (4096, 6144), device="cuda", generator=gen), axis=0)
        x = _bf16_valued((16, 4096), gen)
        if kernel == "K4":
            out = pg.matmul_int8_wo(x, w, s)
            ref = pg.matmul_int8_wo_plain(x, w, s)
            torch.cuda.synchronize()
            assert (out - ref).abs().max().item() <= (
                1e-5 * ref.abs().max().item())
        else:
            assert torch.equal(pg.head_argmax_int8(x, w, s),
                               pg.head_argmax_int8_plain(x, w, s))


@pytest.mark.parametrize("mode", ["append", "grouped", "grid"])
@pytest.mark.parametrize("d", [64, 128])
def test_bf16_paged_pools_match_plain(gen, mode, d):
    """A bf16 paged pool (bf16 compute): P1 writes rows rounded to bf16
    bit for bit as its plain version; P3 and its grid mode read the pool's
    values widened, within 1e-5 of the plain version's largest output."""
    append = mode == "append"
    lens, mapped = ((APPEND_LENGTHS, APPEND_MAPPED) if append
                    else (ATTN_LENGTHS, ATTN_MAPPED))
    b, kvh, n_pages, max_pages = len(lens), 2, 48, 4
    table = _paged_table(b, max_pages, mapped, n_pages, seed=1)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    pool = torch.randn((n_pages, PAGE, 2, kvh * d), device="cuda",
                       generator=gen).to(torch.bfloat16)
    if append:
        # APPEND_LENGTHS: no two sequences write the same row (rows that
        # resolve to one row of page 0 race, as the kernel's contract says).
        x = torch.randn((b, kvh, 1, d), device="cuda", generator=gen)
        p1, p2 = pool.clone(), pool.clone()
        kc.kv_append_paged(p1, x, x.flip(0), table, lengths)
        kc.kv_append_paged_plain(p2, x, x.flip(0), table, lengths)
        torch.cuda.synchronize()
        assert torch.equal(p1, p2)
        return
    wrapper = {"grouped": at.decode_attn_paged,
               "grid": at.decode_attn_paged_grid}[mode]
    q = torch.randn((b, 8, d), device="cuda", generator=gen)
    before = wrapper.launches
    out = wrapper(q, pool, table, lengths)
    ref = getattr(at, wrapper.__name__ + "_plain")(q, pool, table, lengths)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.parametrize("experts,t", [("int8", 16), ("float", 128)])
def test_moe_mlp_on_the_card_matches_the_cpu(gen, experts, t):
    """moe_mlp at Mixtral's width (d 4096, d_ff 14336, 8 experts, top 2)
    for one layer under bf16 compute: int8 stacks at decode size (the
    dense path) and float stacks at 128 tokens (the ragged path), the same
    weights and input on the card and the CPU, outputs within two bf16
    steps of the largest (f32 sums in other orders, then the bf16
    rounding)."""
    from rten_tpu_torch.models import moe
    cfg = TransformerConfig.mixtral(n_layers=1, dtype="bfloat16")
    layer = TransformerLM(cfg).init_int8_params(0, device="cuda")[
        "layers"][0]
    if experts == "float":
        for key in ("w_gate", "w_up", "w_down"):
            w = layer[key]
            layer[key] = w.data.float() * w.scales[:, None, :]
    layer = {k: layer[k] for k in ("router", "w_gate", "w_up", "w_down")}
    x = torch.randn((t, 4096), device="cuda", generator=gen).to(
        torch.bfloat16)
    moe.impl_counts.clear()
    out = moe.moe_mlp(x, layer, cfg)
    cpu_layer = {k: (v.cpu() if isinstance(v, torch.Tensor) else QuantWeight(
        v.kind, v.data.cpu(), v.scales.cpu(), v.n, v.group))
                 for k, v in layer.items()}
    ref = moe.moe_mlp(x.cpu(), cpu_layer, cfg)
    assert moe.impl_counts == {
        "dense" if experts == "int8" else "ragged": 2}
    assert out.dtype == torch.bfloat16
    err = (out.cpu().float() - ref.float()).abs().max().item()
    assert err <= 2.0 ** -7 * ref.float().abs().max().item(), err


def test_bf16_int8_activations_on_the_card_match_the_cpu(gen, monkeypatch):
    """Under bf16 compute the int8 x int8 linear (M > 64) quantizes its
    bf16 activations in bf16 (absmax / 127 and x / x_scale each rounded):
    the card's int8 activations, their scale and the linear's bf16 output
    equal the CPU's bit for bit."""
    seen = {}
    real = ptr.matmul_int8

    def spy(xq, w, x_scale, w_scales):
        seen[xq.device.type] = (xq.cpu(), x_scale.cpu())
        return real(xq, w, x_scale, w_scales)

    monkeypatch.setattr(ptr, "matmul_int8", spy)
    w = torch.from_numpy((0.02 * np.random.default_rng(12).standard_normal(
        (256, 128))).astype(np.float32))
    qw = QuantWeight("int8", *pg.pad_cols(*abs_max_quantize_int8(w)), 128)
    gpu_w = QuantWeight("int8", qw.data.cuda(), qw.scales.cuda(), 128)
    for seed in range(4):
        x = torch.from_numpy(np.random.default_rng(20 + seed).standard_normal(
            (80, 256)).astype(np.float32)).to(torch.bfloat16)
        out = linear(x.cuda(), gpu_w)
        ref = linear(x, qw)
        assert out.dtype == torch.bfloat16
        assert _same_bits(seen["cuda"][0], seen["cpu"][0])
        assert _same_bits(seen["cuda"][1], seen["cpu"][1])
        assert _same_bits(out, ref)


# -- Whisper's decode (encoder_decoder.py's dispatch) -------------------------

WHISPER_CASES = [("fused", 448, True), ("grouped_scores", 512, True),
                 ("grouped", 448, False)]


@pytest.mark.parametrize("kind,cap,quantized", WHISPER_CASES, ids=str)
def test_whisper_shape_decode_kernels_match_plain(gen, kind, cap, quantized):
    """G2, G1 with int8 scores and K6 at Whisper-small's decode shape (B 8,
    12 heads of 64, lives 1-64 of capacity 448 or 512), each as the model's
    dispatch names it, one launch a call, within 1e-5 of max |out| of its
    plain version (f32 sums in other orders)."""
    from rten_tpu_torch.models.encoder_decoder import decode_attn_choice
    b, h, d = 8, 12, 64
    assert decode_attn_choice(b, cap, quantized)[0] == kind
    q = torch.randn((b, h, d), device="cuda", generator=gen)
    lengths = torch.randint(1, 65, (b,), device="cuda", generator=gen,
                            dtype=torch.int32)
    if quantized:
        kv, scales, _ = _cache(gen, b, cap, 1, h, d)
        wrapper = (at.decode_attn_fused_int8 if kind == "fused"
                   else at.decode_attn_grouped_int8)
        plain = (at.decode_attn_fused_int8_plain if kind == "fused"
                 else at.decode_attn_grouped_int8_plain)
        args = (q, kv, scales, lengths)
        kw = {} if kind == "fused" else dict(int8_scores=True)
    else:
        kv = torch.randn((b, cap, 2, h * d), device="cuda", generator=gen)
        wrapper, plain = at.decode_attn_float, at.decode_attn_float_plain
        args, kw = (q, kv, lengths), {}
    before = wrapper.launches
    out = wrapper(*args, **kw)
    ref = plain(*args, **kw)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


def _whisper_decode_step(model, dev, quantized):
    """One decode step of ``model`` at batch 8 on ``dev`` after encoding
    seeded features: (logits on the CPU, the kernels it launched)."""
    from rten_tpu_torch import kernels
    params = model.init_params(0, device=dev)
    feats = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (8, 12, 16)).astype(np.float32)).to(dev)
    cross = model.cross_kv(params, model.encode(params, feats))
    cache = model.new_cache(8, quantized=quantized, device=dev)
    kernels.reset_launch_counts()
    logits, _ = model.decode(params, torch.ones((8, 1), dtype=torch.int64,
                                                device=dev), cross, cache)
    return logits.cpu(), {k: n for k, n in kernels.launch_counts().items()
                          if n}


@pytest.mark.parametrize("kind,cap,quantized", WHISPER_CASES, ids=str)
def test_whisper_decode_step_launches_its_kernels(gen, kind, cap, quantized):
    """One decode step of a 2-layer encoder-decoder with 2 heads of 64 at
    batch 8 launches the append (K5 or K7) and the attention kernel that
    the dispatch names once a layer, and no other kernel; its logits are
    within 1e-4 of the same step on the CPU (plain versions)."""
    from rten_tpu_torch.models import (EncoderDecoderConfig,
                                       EncoderDecoderLM)
    model = EncoderDecoderLM(EncoderDecoderConfig.tiny_test(
        n_heads=2, d_model=128, max_target_len=cap))
    card, counts = _whisper_decode_step(model, "cuda", quantized)
    cpu, none = _whisper_decode_step(model, "cpu", quantized)
    assert none == {}
    attend = {"fused": "decode_attn_fused_int8",
              "grouped_scores": "decode_attn_grouped_int8",
              "grouped": "decode_attn_float"}[kind]
    modes = ({attend + ".int8_scores": 2} if kind == "grouped_scores"
             else {})
    append = "kv_append_int8" if quantized else "kv_append"
    assert counts == {append: 2, attend: 2, **modes}
    err = (card - cpu).abs().max().item()
    assert err <= 1e-4, err
