#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (``rten_tpu_torch``).

Run from the repository root on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. Device: requires CUDA, prints the card's name and power limit
   (nvidia-smi) and turns TF32 off.
2. Build: compiles every CUDA kernel from ``rten_tpu_torch/csrc`` (parallel
   nvcc) and prints the build time and ptxas reports.
3. Kernels: each kernel against its plain PyTorch version on the card at
   the serving path's shapes (GPT-2-small, batch 256, capacity 512, tail
   window 16), with CUDA-event timings (cold L2, warm median) of the
   kernel, the plain version and, where one PyTorch call computes the same
   function, that call; plus each kernel's lower bound from its bytes and
   operations.
4. Main path: GPT-2-small with int8 weights (``init_params(0)``), an int8
   KV cache with the 16-token bf16 tail, ``ServingEngine`` at batch 256,
   capacity 512, 64-token prompts, greedy; 320 requests of 48 new tokens
   in bursts of 21, so slots are recycled and the 64 leftover requests are
   admitted as one group. Every kernel's launch count must be > 0. Then
   decode at a full batch: one burst timed on the host clock and one
   traced by torch.profiler (time by kernel, the card's busy share).
5. Card against CPU: the same weights, 8 requests of 8 tokens x 16 new
   tokens, on the card and with ``device="cpu"`` (plain versions), with
   the fused argmax head and with recorded logits; logits must agree
   within a stated tolerance and greedy tokens must match except after a
   near-tie step.

Prints a ``{"kernels": [...]}`` JSON line, then as the last line
``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from rten_tpu_torch import kernels
from rten_tpu_torch.generate import ArgMaxSampler, ServingEngine
from rten_tpu_torch.kernels import _build
from rten_tpu_torch.kernels import attention as at
from rten_tpu_torch.kernels import cache as kc
from rten_tpu_torch.kernels import gemm
from rten_tpu_torch.kernels.quant import abs_max_quantize_int8
from rten_tpu_torch.models import (QuantWeight, TransformerConfig,
                                   TransformerLM, quantize_weights)

# Published H100 SXM peaks (NVIDIA data sheet, dense): the lower bounds.
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOP_S = 989e12
REPS = 20

# Tolerances (kernel against its plain version on the same inputs):
# K1 rounds its output to bf16 like the plain version, and the two sum in
# different orders in f32, so they may land one bf16 step apart; allow two
# steps of the largest output (2^-6 relative to max |out|).
K1_REL_TOL = 2.0 ** -6
# K2: identical indices, except rows whose plain top-2 margin is below
# 1e-3 (a different f32 summation order can swap near-ties).
K2_MARGIN_TOL = 1e-3
# K4: the same bf16-rounded operands and f32 accumulation; only the
# summation order differs, far below one bf16 step (2^-8) of max |out|.
K4_REL_TOL = 2.0 ** -8
# Card against CPU through the whole model, on 8-token prompts so every
# linear stays in the row-wise bf16 / weight-only regime (M <= 64): f32
# sums in another order flip bf16 roundings of activations, which random
# GPT-2 weights carry through 12 layers to the logits at the 1e-2 scale,
# so the two devices' logits must agree to 5e-2, and a token may differ
# only after a step whose CPU top-2 margin is below twice that. (At M > 64
# a per-tensor int8 activation scale spreads such a flip over the whole
# batch; that regime is held to exact int32 agreement by
# check_int8_matmul.)
PATH_LOGIT_TOL = 5e-2


def check(ok, what):
    """Fail the run (an exception, so no later phase and no result line)."""
    if not ok:
        raise RuntimeError(what)


def bound_ms(n_bytes, flops=0.0):
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_BF16_FLOP_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


class Timer:
    """Median time of single calls with CUDA events, after warm-up, with
    the 50 MB L2 evicted before each call (the serving path reaches each
    kernel with the rest of a decode step in between)."""

    def __init__(self):
        self.scrub = torch.empty(64 * 1024 * 1024, dtype=torch.int32,
                                 device="cuda")

    def __call__(self, fn, reps=REPS):
        for _ in range(3):
            fn()
        times = []
        for _ in range(reps):
            self.scrub.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return sorted(times)[len(times) // 2]


def check_decode_attn(timer):
    b, h, d, cap, rows, tc = 256, 12, 64, 512, 16, 9
    f = h * d
    g = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn((b, h, d), device="cuda", generator=g)
    kv = torch.randint(-127, 128, (b, cap, 2, f), device="cuda",
                       dtype=torch.int8, generator=g)
    scales = (0.002 + 0.01 * torch.rand((b, cap, 2, h), device="cuda",
                                        generator=g)).to(torch.bfloat16)
    tail = torch.randn((b, rows, 2, f), device="cuda",
                       generator=g).to(torch.bfloat16)
    # Lengths as the model passes them (cache lengths + 1, window fill
    # + 1) at live lengths of the main path, prompt 64 up to 64 + 96.
    lengths = torch.randint(64 + tc, 160 + tc, (b,), device="cuda",
                            generator=g, dtype=torch.int32)
    args = (q, kv, scales, lengths, tail, tc)
    out = at.decode_attn_int8_tail(*args)
    ref = at.decode_attn_int8_tail_plain(*args)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    tol = K1_REL_TOL * ref.abs().max().item()
    print(f"decode_attn_int8_tail: max_abs_err {err:.3e} (tol {tol:.3e})")
    check(bool(torch.isfinite(out).all()) and err <= tol, "K1 disagrees")
    n_packed = (lengths - tc).clamp(0, cap).to(torch.float64).sum().item()
    n_bytes = (n_packed * (2 * f + 2 * h * 2) + b * tc * 2 * f * 2
               + 2 * q.numel() * 4 + b * 4)
    flops = 4.0 * (n_packed + b * tc) * h * d
    bms, by = bound_ms(n_bytes, flops)
    return dict(name="decode_attn_int8_tail",
                source="rten_tpu_torch/csrc/decode_attn_int8_tail.cu",
                replaces="rten_tpu/kernels/attention.py:1715",
                max_abs_err=err, ms=timer(lambda: at.decode_attn_int8_tail(
                    *args)),
                plain_ms=timer(lambda: at.decode_attn_int8_tail_plain(
                    *args)),
                bound_ms=bms, bound_by=by, library_ms=None)


def check_int8_matmul():
    """The int8 x int8 product of the M > 64 linears (torch._int_mm, not a
    kernel of this repository) on the card against the CPU at the main
    path's prefill QKV shape: int32 accumulation is exact, so the f32
    results must be identical."""
    g = torch.Generator().manual_seed(6)
    x = torch.randint(-127, 128, (256 * 64, 768), dtype=torch.int8,
                      generator=g)
    w = torch.randint(-127, 128, (768, 2304), dtype=torch.int8, generator=g)
    xs = torch.tensor(0.031)
    ws = 0.001 * torch.rand(2304, generator=g)
    cpu = gemm.matmul_int8(x, w, xs, ws)
    card = gemm.matmul_int8(x.cuda(), w.cuda(), xs.cuda(), ws.cuda()).cpu()
    print(f"matmul_int8 (torch._int_mm): card == cpu "
          f"{torch.equal(card, cpu)}")
    check(torch.equal(card, cpu), "int8 x int8 product differs")


def _head_weights(k, n):
    g = torch.Generator(device="cuda").manual_seed(2)
    w = 0.02 * torch.randn((k, n), device="cuda", generator=g)
    q, s = abs_max_quantize_int8(w, axis=0)
    q, s = gemm.pad_cols(q, s)
    w_dq = (q[:, :n].to(torch.float32) * s[None, :n]).to(torch.bfloat16)
    return q, s, w_dq


def check_head_argmax(timer, w, s, w_dq, n):
    m, k = 256, w.shape[0]
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((m, k), device="cuda", generator=g)
    idx = gemm.head_argmax_int8(x, w, s, n_valid=n)
    logits = gemm.matmul_int8_wo_plain(x, w, s)[:, :n]
    ref = gemm.head_argmax_int8_plain(x, w, s, n_valid=n)
    torch.cuda.synchronize()
    top2 = torch.topk(logits, 2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    rows = torch.arange(m, device="cuda")
    regret = (logits[rows, ref.long()] - logits[rows, idx.long()]).abs()
    bad = (idx != ref) & (margin >= K2_MARGIN_TOL)
    near = int(((idx != ref) & ~bad).sum().item())
    print(f"head_argmax_int8: {int((idx != ref).sum())} of {m} indices "
          f"differ, {near} of them at a margin below {K2_MARGIN_TOL}")
    check(not bad.any(), "K2 disagrees above the margin tolerance")
    n_bytes = k * n + 4 * n + 4 * m * k + 4 * m
    bms, by = bound_ms(n_bytes, 2.0 * m * k * n)
    xb = x.to(torch.bfloat16)
    return dict(name="head_argmax_int8",
                source="rten_tpu_torch/csrc/head_argmax_int8.cu",
                replaces="rten_tpu/kernels/gemm.py:268",
                max_abs_err=regret.max().item(),
                ms=timer(lambda: gemm.head_argmax_int8(x, w, s, n_valid=n)),
                plain_ms=timer(lambda: gemm.head_argmax_int8_plain(
                    x, w, s, n_valid=n)),
                bound_ms=bms, bound_by=by,
                library_ms=timer(lambda: torch.matmul(xb, w_dq).argmax(-1)))


def check_matmul_wo(timer, w, s, w_dq, n):
    m, k = 64, w.shape[0]
    g = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn((m, k), device="cuda", generator=g)
    out = gemm.matmul_int8_wo(x, w, s)[:, :n]
    ref = gemm.matmul_int8_wo_plain(x, w, s)[:, :n]
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    tol = K4_REL_TOL * ref.abs().max().item()
    print(f"matmul_int8_wo: max_abs_err {err:.3e} (tol {tol:.3e})")
    check(err <= tol, "K4 disagrees")
    n_bytes = k * n + 4 * n + 4 * m * k + 4 * m * n
    bms, by = bound_ms(n_bytes, 2.0 * m * k * n)
    xb = x.to(torch.bfloat16)
    return dict(name="matmul_int8_wo",
                source="rten_tpu_torch/csrc/matmul_int8_wo.cu",
                replaces="rten_tpu/kernels/gemm.py:173",
                max_abs_err=err,
                ms=timer(lambda: gemm.matmul_int8_wo(x, w, s)),
                plain_ms=timer(lambda: gemm.matmul_int8_wo_plain(x, w, s)),
                bound_ms=bms, bound_by=by,
                library_ms=timer(lambda: torch.matmul(xb, w_dq)))


def check_tail_flush(timer):
    b, rows, cap, kvh, d, t = 256, 16, 512, 12, 64, 16
    f = kvh * d
    g = torch.Generator(device="cuda").manual_seed(5)
    tail = torch.randn((b, rows, 2, f), device="cuda",
                       generator=g).to(torch.bfloat16)
    tail[0, 0, 0, :d] = 0          # an all-zero head takes scale 1.0
    kv = torch.randint(-127, 128, (b, cap, 2, f), device="cuda",
                       dtype=torch.int8, generator=g)
    scales = torch.rand((b, cap, 2, kvh), device="cuda",
                        generator=g).to(torch.bfloat16)
    lengths = torch.randint(t, 160, (b,), device="cuda", generator=g,
                            dtype=torch.int32)
    lengths[1] = cap + 7           # a finished slot past capacity: clamps
    kv1, s1, kv2, s2 = kv.clone(), scales.clone(), kv.clone(), scales.clone()
    kc.tail_flush_int8(tail, kv1, s1, lengths, t)
    kc.tail_flush_int8_plain(tail, kv2, s2, lengths, t)
    torch.cuda.synchronize()
    err = max((kv1.int() - kv2.int()).abs().max().item(),
              (s1.float() - s2.float()).abs().max().item())
    print(f"tail_flush_int8: max_abs_err {err} (bit-exact required)")
    check(torch.equal(kv1, kv2) and torch.equal(s1, s2), "K3 not bit-exact")
    n_bytes = b * t * 2 * f * 2 + b * t * 2 * f + b * t * 2 * kvh * 2 + b * 4
    bms, by = bound_ms(n_bytes)
    return dict(name="tail_flush_int8",
                source="rten_tpu_torch/csrc/tail_flush_int8.cu",
                replaces="rten_tpu/kernels/cache.py:370,511",
                max_abs_err=err,
                ms=timer(lambda: kc.tail_flush_int8(tail, kv1, s1, lengths,
                                                    t)),
                plain_ms=timer(lambda: kc.tail_flush_int8_plain(
                    tail, kv2, s2, lengths, t)),
                bound_ms=bms, bound_by=by, library_ms=None)


def to_device(params, device):
    """The parameter tree (tensors and int8 QuantWeights) on ``device``."""
    if isinstance(params, dict):
        return {k: to_device(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [to_device(v, device) for v in params]
    if isinstance(params, QuantWeight):
        return QuantWeight(params.kind, params.data.to(device),
                           params.scales.to(device), params.n)
    return params.to(device)


def main_path(model, params, n_requests, new_tokens, burst,
              device="cuda"):
    """Serve ``n_requests`` random 64-token prompts at batch 256 / capacity
    512 and return (engine, requests, wall seconds)."""
    engine = ServingEngine(model, params, max_batch=256, capacity=512,
                           prefill_buckets=(64,), quantized_cache=True,
                           device=device)
    check(engine._tail_flush == 16, "the tail window is off")
    rng = np.random.RandomState(0)
    reqs = [engine.submit(rng.randint(0, model.config.vocab_size, 64),
                          max_new_tokens=new_tokens)
            for _ in range(n_requests)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.run(burst=burst)
    torch.cuda.synchronize()
    return engine, reqs, time.perf_counter() - t0


def profile_decode(model, params, steps=16):
    """Decode at a full batch of 256 (after an admission and a warm-up
    burst): one burst of ``steps`` steps timed on the host clock, then one
    more traced by torch.profiler for the card's busy share (the sum of
    its kernels' time over the traced wall time) and the kernels that
    take the most device time."""
    engine = ServingEngine(model, params, max_batch=256, capacity=512,
                           prefill_buckets=(64,), quantized_cache=True)
    rng = np.random.RandomState(2)
    for _ in range(256):
        engine.submit(rng.randint(0, model.config.vocab_size, 64),
                      max_new_tokens=5 + 2 * steps)
    engine.step_burst(5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.step_burst(steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"decode at batch 256: {1e3 * wall / steps:.3f} ms per step, "
          f"{256 * steps / wall:.1f} tokens/s")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.step_burst(steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    on_card = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy_s = sum(e.self_device_time_total for e in on_card) / 1e6
    print(f"decode at batch 256 under the profiler: "
          f"{1e3 * wall / steps:.3f} ms per step; card busy {busy_s:.4f} s "
          f"of {wall:.4f} s ({100 * busy_s / wall:.1f}%)")
    for e in on_card[:20]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  "
              f"{e.key[:90]}")


def card_against_cpu(model, params_gpu, device="cuda"):
    """Greedy tokens of 8 requests on the card and on the CPU, each with
    the fused argmax head and with logits + argmax (recording the logits),
    compared step by step."""

    class Recorder(ArgMaxSampler):
        """Greedy, keeping every call's logits rows."""

        def __init__(self):
            self.logits = []

        def sample(self, logits):
            self.logits.append(logits.cpu().numpy())
            return super().sample(logits)

    rng = np.random.RandomState(1)
    prompts = [list(rng.randint(0, model.config.vocab_size, 8))
               for _ in range(8)]
    params_cpu = to_device(params_gpu, "cpu")

    def serve(params, dev, recorder=None):
        kw = dict(sampler=recorder, fused_head=False) if recorder else {}
        eng = ServingEngine(model, params, max_batch=8, capacity=512,
                            prefill_buckets=(8,), quantized_cache=True,
                            device=dev, **kw)
        return eng.generate(prompts, max_new_tokens=16, burst=6)

    card_fused, cpu_fused = serve(params_gpu, device), serve(params_cpu,
                                                             "cpu")
    rec_card, rec_cpu = Recorder(), Recorder()
    card, cpu = serve(params_gpu, device, rec_card), serve(params_cpu, "cpu",
                                                           rec_cpu)
    check(all(len(t) == 16 for t in card_fused + cpu_fused + card + cpu),
          "a request got the wrong number of tokens")

    def compare(a_runs, b_runs, rec, tol, what):
        """Index of the first differing token per request; a difference
        must follow a step whose recorded top-2 margin is below ``tol``.
        One admission group of 8 in request order and 8 decode slots, so
        rec.logits[c][i] is the step that produced request i's token c."""
        first = []
        for i, (a, b) in enumerate(zip(a_runs, b_runs)):
            c = next((c for c in range(len(a)) if a[c] != b[c]), len(a))
            first.append(c)
            if c < len(a):
                top = np.sort(rec.logits[c][i])[-2:]
                margin = float(top[1] - top[0])
                print(f"{what}: request {i} first differs at token {c}, "
                      f"top-2 margin {margin:.3e} (tol {tol:.1e})")
                check(margin < tol, f"{what}: differ above the tolerance")
        return first

    compare(card_fused, card, rec_card, K2_MARGIN_TOL,
            "card fused head vs logits head")
    compare(cpu_fused, cpu, rec_cpu, K2_MARGIN_TOL,
            "cpu fused head vs logits head")
    first = compare(card, cpu, rec_cpu, 2 * PATH_LOGIT_TOL, "card vs cpu")
    # Logits rows computed from identical histories on both devices.
    dev = max(float(np.abs(rec_card.logits[c][i] - rec_cpu.logits[c][i])
                    .max())
              for i in range(len(card)) for c in range(min(first[i] + 1,
                                                             16)))
    print(f"card vs cpu: {sum(len(t) for t in card)} tokens, "
          f"{sum(f < 16 for f in first)} near-tie divergences, max logit "
          f"difference {dev:.3e} (tol {PATH_LOGIT_TOL:.1e})")
    check(dev < PATH_LOGIT_TOL, "card and cpu logits disagree")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")

    build_s = _build.build_all(verbose=True)
    print(f"build: {build_s:.1f} s")

    check_int8_matmul()
    timer = Timer()
    k_head, n_vocab = 768, 50257
    w, s, w_dq = _head_weights(k_head, n_vocab)
    results = [check_decode_attn(timer),
               check_head_argmax(timer, w, s, w_dq, n_vocab),
               check_tail_flush(timer),
               check_matmul_wo(timer, w, s, w_dq, n_vocab)]
    del w, s, w_dq
    for r in results:
        print(f"{r['name']}: kernel_ms {r['ms']:.4f} plain_ms "
              f"{r['plain_ms']:.4f} bound_ms {r['bound_ms']:.4f} "
              f"({r['bound_by']}) library_ms {r['library_ms']}")

    model = TransformerLM(TransformerConfig.gpt2())
    t0 = time.perf_counter()
    params = quantize_weights(model.init_params(0, device="cuda"))
    print(f"GPT-2-small int8 weights: {time.perf_counter() - t0:.1f} s")
    # Warm-up serve (allocator, cuBLAS handles), then the measured run.
    main_path(model, params, 256, 4, 21)
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    engine, reqs, wall = main_path(model, params, 320, 48, 21)
    launches = {k.__name__: k.launches for k in kernels.KERNELS}
    st = engine.stats()
    check(all(len(r.tokens) == 48 and r.done for r in reqs),
          "a request did not complete with 48 tokens")
    check(all(0 <= t < model.config.vocab_size for r in reqs
              for t in r.tokens), "a token lies outside the vocabulary")
    print(f"main path: {len(reqs)} requests, {st['decode_steps']} decode "
          f"steps, {st['tokens']} decode tokens in {wall:.3f} s = "
          f"{st['tokens'] / wall:.1f} decode tokens/s; p50 TTFT "
          f"{st.get('ttft_p50_ms')} ms; launches {launches}")
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the path never launched: {launches}")
    del engine
    profile_decode(model, params)

    card_against_cpu(model, params)

    for r in results:
        r["route"] = "cuda"
        r["launches"] = launches[r["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in results]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
