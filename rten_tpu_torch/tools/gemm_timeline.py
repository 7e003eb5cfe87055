"""Device timeline of one cold call of the quantized GEMM kernels.

For each of TinyLlama's int4 weight shapes at decode M 16 the int8-dot
GEMM (``matmul_int4_words_int8``), the bf16-dot GEMMs on words
(``matmul_int4_words``, Q1) and on bytes (``matmul_int4``, Q2), and the
bf16 ``torch.matmul`` they are held against; the same at the prefill M 1024
of w_gate (Q1 and Q2 take their prefill tile there: a prep launch and the
GEMM); then the fused int8 head (``head_argmax_int8``) and its library
call (bf16 ``matmul`` + ``argmax``) at GPT-2's head, M 256. Each call runs as
``chip_smoke.py`` times it: the 50 MB L2 evicted, the card asleep for about
a millisecond, then the call. Prints every CUDA kernel of the call with its
start and end in microseconds after the sleep ends, so the launches of a
call, their overlap and the gaps between them can be read off.

    python -m rten_tpu_torch.tools.gemm_timeline

Needs one NVIDIA card; without one it exits non-zero.
"""

from __future__ import annotations

import subprocess
import sys

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from rten_tpu_torch.kernels import _build, gemm
from rten_tpu_torch.kernels import quant as qt

SLEEP_CYCLES = 2_000_000          # about 1 ms at the H100's clocks
TINYLLAMA = (("wqkv", 2048, 2560), ("wo", 2048, 2048),
             ("w_gate/w_up", 2048, 5632), ("w_down", 5632, 2048),
             ("head", 2048, 32000))


def timeline(scrub, fn, rounds=3):
    """The kernels of the last of ``rounds`` cold calls of ``fn``: (name,
    start us, end us) after the sleep kernel's end."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(rounds):
            scrub.zero_()
            torch.cuda._sleep(SLEEP_CYCLES)
            fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    last = max(i for i, e in enumerate(events)
               if "sleep" in e.name.lower() or "spin" in e.name.lower())
    t0 = events[last].time_range.end
    return [(short(e.name), e.time_range.start - t0, e.time_range.end - t0)
            for e in events[last + 1:]]


def short(name):
    """A kernel's name without its namespace, template arguments and
    parameters."""
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return name.split("(")[0].split("<")[0].split("::")[-1].strip()[:40]


def show(label, spans):
    end = max(stop for _, _, stop in spans)
    print(f"{label}: ends at {end:.1f} us; "
          + "; ".join(f"{name} {a:.1f}-{b:.1f}" for name, a, b in spans),
          flush=True)


def main():
    if not torch.cuda.is_available():
        print("gemm_timeline: no CUDA device available", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    scrub = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(14)
    shapes = [(name, 16, k, n) for name, k, n in TINYLLAMA]
    shapes.append(("w_gate prefill", 1024, 2048, 5632))
    for name, m, k, n in shapes:
        w = 0.02 * torch.randn((k, n), device="cuda", generator=g)
        x = torch.randn((m, k), device="cuda", generator=g)
        words, scales = qt.quantize_int4_words(w)
        packed, _ = qt.quantize_int4_groupwise(w)
        w_dq = qt.dequantize_int4_words(words, scales).to(torch.bfloat16)
        xb = x.to(torch.bfloat16)
        show(f"{name} M {m} matmul_int4_words_int8",
             timeline(scrub, lambda: gemm.matmul_int4_words_int8(
                 x, words, scales)))
        show(f"{name} M {m} matmul_int4_words",
             timeline(scrub, lambda: gemm.matmul_int4_words(
                 x, words, scales)))
        show(f"{name} M {m} matmul_int4",
             timeline(scrub, lambda: gemm.matmul_int4(x, packed, scales)))
        show(f"{name} M {m} bf16 matmul",
             timeline(scrub, lambda: torch.matmul(xb, w_dq)))
    k, n_valid = 768, 50257
    w = 0.02 * torch.randn((k, n_valid), device="cuda", generator=g)
    q, s = gemm.pad_cols(*qt.abs_max_quantize_int8(w, axis=0))
    w_dq = (q[:, :n_valid].float() * s[None, :n_valid]).to(torch.bfloat16)
    x = torch.randn((256, k), device="cuda", generator=g)
    xb = x.to(torch.bfloat16)
    show("GPT-2 head M 256 head_argmax_int8",
         timeline(scrub, lambda: gemm.head_argmax_int8(x, q, s,
                                                       n_valid=n_valid)))
    show("GPT-2 head M 256 bf16 matmul + argmax",
         timeline(scrub, lambda: torch.matmul(xb, w_dq).argmax(-1)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
