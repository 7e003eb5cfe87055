"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small and ragged shapes (chip_smoke.py holds them at the serving path's
shapes). Marked ``cuda``; without a card every test skips.

This file imports no jax, so it also runs where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from rten_tpu_torch.kernels import attention as at
from rten_tpu_torch.kernels import cache as kc
from rten_tpu_torch.kernels import gemm as pg
from rten_tpu_torch.kernels.quant import abs_max_quantize_int8
from rten_tpu_torch.models import (TransformerConfig, TransformerLM,
                                   quantize_weights)

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


@pytest.mark.parametrize("t", range(1, 17))
def test_tail_flush_kernel_bit_exact(gen, t):
    b, cap, rows, kvh, d = 8, 64, 16, 2, 64
    kv, scales, tail = _cache(gen, b, cap, rows, kvh, d)
    tail[0, 0, 1, :d] = 0                  # all-zero head: scale 1.0
    tail[1, 0, 0, :d] = 1e-30              # tiny absmax
    lengths = torch.tensor([t, t + 1, 0, 5, 31, cap, cap + 5, 2 * cap],
                           dtype=torch.int32, device="cuda")
    kv1, s1, kv2, s2 = kv.clone(), scales.clone(), kv.clone(), scales.clone()
    kc.tail_flush_int8(tail, kv1, s1, lengths, t)
    kc.tail_flush_int8_plain(tail, kv2, s2, lengths, t)
    torch.cuda.synchronize()
    assert torch.equal(kv1, kv2) and torch.equal(s1, s2)


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
    """Columns 5 and 70 (two 64-wide vocabulary tiles) and 900 tie for
    the maximum: index 5 wins; the padding columns past n_valid (995 is
    padded to 1000) never win, however large."""
    k, n = 64, 995
    w, s = _weights(gen, k, n)
    x = torch.rand((4, k), device="cuda", generator=gen)
    for c in (5, 70, 900):
        w[:, c] = 127
        s[c] = 1.0
    assert w.shape[1] == 1000
    w[:, n:] = 127
    s[n:] = 100.0
    idx = pg.head_argmax_int8(x, w, s, n_valid=n)
    torch.cuda.synchronize()
    assert idx.tolist() == [5] * 4


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
