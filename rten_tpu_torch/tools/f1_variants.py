"""F1 (``csrc/prefill_attn.cu``) against variants of its own source, on one
card in one call: what each design choice of the split-TF32 kernel buys.

Each variant is the shipped source with a few lines replaced, built by its
own ``nvcc`` (all started together) into ``rten_tpu_torch/build/
f1_variants/`` and called through ``ctypes`` as the wrapper calls F1:

* ``shipped``: the kernel as it is;
* ``cvt_rna``: hi and lo by ``cvt.rna.tf32.f32`` instead of the integer
  rounding (the same bits);
* ``one_accumulator``: the three products of every f32 product summed into
  one accumulator, and P V summed across key tiles in one accumulator
  (the output rescaled by alpha first), instead of hi*hi apart from the
  small terms and a sum per 32-key tile folded in f32;
* ``key16``: 16-key tiles, three blocks an SM;
* ``one_tf32``: hi*hi alone (not f32 accuracy: a floor of the time).

For each: the worst per-head error against ``flash_attention_plain`` over
a few shapes, as a share of 1e-5 of the head's max |out| (F1's tolerance),
and the device time at path (H)'s prefill (B 16, 32 heads of 128, S 512,
causal; cold L2, warm median), in two rounds, beside f32
``scaled_dot_product_attention``.

    python -m rten_tpu_torch.tools.f1_variants

Needs one NVIDIA card and nvcc; without a card it exits non-zero.
"""

from __future__ import annotations

import ctypes
import math
import subprocess
import sys

import torch

from rten_tpu_torch.kernels import _build
from rten_tpu_torch.kernels import attention as at

SLEEP_CYCLES = 2_000_000          # about 1 ms at the H100's clocks
REPS = 20
REL_TOL = 1e-5
OUT = _build.BUILD_DIR / "f1_variants"

RNA_INT = "  return (__float_as_uint(a) + 0x1000u) & 0xFFFFE000u;\n"
RNA_CVT = ("  uint32_t r;\n"
           "  asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : \"=r\"(r) : \"f\"(a));\n"
           "  return r;\n")
SMALL = ("  mma_tf32(small, al, bh0, bh1);\n"
         "  mma_tf32(small, ah, bl0, bl1);\n")
TB_INIT = "        for (int e = 0; e < 4; ++e) tb[i][e] = ts[i][e] = 0.0f;\n"
FOLD = ("          o[kW * a + i][e] = fmaf(o[kW * a + i][e], alpha[e >> 1],\n"
        "                                  __fadd_rn(tb[i][e], ts[i][e]));\n")
VARIANTS = {
    "shipped": [],
    "cvt_rna": [(RNA_INT, RNA_CVT)],
    "one_accumulator": [
        (SMALL, SMALL.replace("small", "big")),
        (TB_INIT, "        for (int e = 0; e < 4; ++e) {\n"
                  "          tb[i][e] = o[kW * a + i][e] * alpha[e >> 1];\n"
                  "          ts[i][e] = 0.0f;\n"
                  "        }\n"),
        (FOLD, "          o[kW * a + i][e] = tb[i][e];\n")],
    "key16": [("kBK = 32", "kBK = 16"),
              ("__launch_bounds__(kThreads, 2)",
               "__launch_bounds__(kThreads, 3)")],
    "one_tf32": [(SMALL, "")],
}
CASES = ((1, 2, 2048, False), (1, 2, 2048, True), (16, 32, 512, False),
         (16, 32, 512, True), (8, 64, 128, False))


def build():
    """Every variant's library, one nvcc each, all started together."""
    source = (_build.CSRC / "prefill_attn.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, patches in VARIANTS.items():
        text = source
        for old, new in patches:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the source no longer holds "
                                   f"{old!r} once")
            text = text.replace(old, new)
        src = OUT / f"{name}.cu"
        src.write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", str(OUT / f"lib{name}.so"), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        regs = [line.split(":", 1)[1].strip() for line in out.splitlines()
                if "registers" in line]
        print(f"{name}: {'; '.join(regs)}", flush=True)
        fn = ctypes.CDLL(str(OUT / f"lib{name}.so")).prefill_attn
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def call(fn, q, k, v, causal):
    b, h, s, d = q.shape
    out = torch.empty_like(q)
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    out.data_ptr(), b, h, s, d, int(causal),
                    1.0 / math.sqrt(d), _build.stream()), "prefill_attn")
    return out


def device_ms(scrub, fn):
    """Median device time of one call, L2 evicted, as chip_smoke.py times
    kernels."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(REPS):
        scrub.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def main():
    if not torch.cuda.is_available():
        print("f1_variants: no CUDA device available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    fns = build()
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for b, h, s, causal in CASES:
        q, k, v = (torch.randn((b, h, s, 128), device="cuda", generator=g)
                   for _ in range(3))
        cases.append((f"B {b} H {h} S {s}{' causal' if causal else ''}",
                      q, k, v, causal,
                      at.flash_attention_plain(q, k, v, causal=causal)))
    for name, fn in fns.items():
        worst = []
        for label, q, k, v, causal, ref in cases:
            err = (call(fn, q, k, v, causal) - ref).abs().amax(dim=(2, 3))
            share = err / (REL_TOL * ref.abs().amax(dim=(2, 3)))
            worst.append(f"{label} {share.max().item():.3f}")
        print(f"{name}: worst |err| / (1e-5 max |out|) per head: "
              + ", ".join(worst), flush=True)
    del cases
    scrub = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device="cuda")
    q, k, v = (torch.randn((16, 32, 512, 128), device="cuda", generator=g)
               for _ in range(3))
    for rnd in range(2):
        line = [f"{name} "
                f"{device_ms(scrub, lambda: call(fn, q, k, v, True)):.4f}"
                for name, fn in fns.items()]
        lib = device_ms(scrub, lambda: torch.nn.functional.
                        scaled_dot_product_attention(q, k, v, is_causal=True))
        print(f"round {rnd}, ms at B 16, 32 heads of 128, S 512, causal: "
              + ", ".join(line) + f", f32 scaled_dot_product_attention "
              f"{lib:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
