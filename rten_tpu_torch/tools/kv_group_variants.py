"""P3i and G1 (the KV-group kernel, ``csrc/decode_attn_kv_group.cuh``) at
their serving paths' shapes, against their own launch choices and the
designs they replaced, on one card in one call:

* P3i (``decode_attn_paged_int8``) at path (D)'s shapes (B 256, 12 heads
  of 64, pages of 64, capacity 512, lives 65-176 over scrambled pages)
  with its sequences in 1 (the plan's choice) and 2 chunks and blocks of
  4 or 8 warps, beside P3
  (``decode_attn_paged``, K6's kernel) on an f32 pool of the same shape;
* G1 exact q (``decode_attn_grouped_int8``) at path (H)'s shapes (B 16, 32
  heads over 8 KV heads of 128, capacity 4096, lives 512-576) with 1, 2, 4
  and 8 chunks and blocks of 4 or 8 warps, beside V1's kernel at S = 1 on
  the same inputs (``decode_attn_fused_int8``: G1's kernel before this
  design), and G1's int8 scores at the plan's launch.

Each line: the device time (CUDA events, cold L2, warm median), its share
of the byte bound, and the error against the plain version as a share of
1e-5 of max |out| (the kernels' tolerance), in two rounds.

Then the same two kernels (P3i and G1 at the plan's launch) built from
variants of ``decode_attn_kv_group.cuh``, each by its own ``nvcc`` (all
started together) into ``rten_tpu_torch/build/kv_group_variants/``, to
see where the time goes: ``no_walk`` (the rows are staged but never
computed: the copies and the block's fixed costs), ``no_copies`` (the
walk over stale shared memory: the arithmetic and the fixed costs) and
``step_softmax`` (the walk before its three passes: a softmax step per
row) and ``dense_steps`` (every step of a partial tile computed, its dead
rows masked). The first two compute garbage, so their error is not held. Each
variant is timed twice: after the scrub that ``chip_smoke.py``'s timer
runs (zeroing 256 MB, which leaves the 50 MB L2 full of dirty lines that
the kernel's reads must first write back), and after a read of the same
256 MB (the L2 cold and clean).

    python -m rten_tpu_torch.tools.kv_group_variants

Needs one NVIDIA card and nvcc; without a card it exits non-zero.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys

import torch

from rten_tpu_torch.kernels import _build
from rten_tpu_torch.kernels import attention as at

SLEEP_CYCLES = 2_000_000          # about 1 ms at the H100's clocks
REPS = 20
REL_TOL = 1e-5
PEAK_BYTES_S = 3.35e12
OUT = _build.BUILD_DIR / "kv_group_variants"
HEADER = "decode_attn_kv_group.cuh"
TILE = "    const int t0 = c0 + j * kTile, rows = min(kTile, c1 - t0);\n"
COPIES = ("        cp_async16(buf + r * d + 16 * vq, src);\n"
          "        cp_async16(buf + kPlane + r * d + 16 * vq, src + f);\n")
WALK_END = "    if (j + 1 < tiles) put_scale(j + 1, next);\n"
# The walk before its three passes: a softmax step per row (two shuffles,
# a branch and an exp chained into every row).
STEP_WALK = """    const int t0 = c0 + j * kTile, rows = min(kTile, c1 - t0);
    const int8_t* ks8 = reinterpret_cast<const int8_t*>(buf);
    const int8_t* vs8 = ks8 + kPlane;
    const float* ksc = reinterpret_cast<const float*>(buf + 2 * kPlane);
    const float* vsc = ksc + kTile;
    constexpr int kStep = 4 * kRG;
    for (int r0 = 4 * rg; r0 < rows; r0 += kStep) {
      const int r = r0 + grp;
      const bool live = r < rows;
      uint32_t kw[kWords];
      words<kDpl>(ks8 + r * d + col, kw);
      float s[kHpw];
      float kf[kDpl];
#pragma unroll
      for (int w = 0; w < kWords; ++w) s8x4_to_f32(kw[w], kf + 4 * w);
#pragma unroll
      for (int j2 = 0; j2 < kHpw; ++j2) {
        float dot = 0.0f;
#pragma unroll
        for (int i = 0; i < kDpl; ++i) dot += qv[j2][i] * kf[i];
#pragma unroll
        for (int o = 1; o < kLanes; o <<= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        s[j2] = dot * scale;
      }
      const float ksr = ksc[r], vsr = vsc[r];
      float pv[kHpw];
#pragma unroll
      for (int j2 = 0; j2 < kHpw; ++j2) {
        const float sv = live ? s[j2] * ksr : -INFINITY;
        float mx = sv;
#pragma unroll
        for (int o = kLanes; o < 32; o <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        if (mx > m[j2]) {
          const float alpha = expf(m[j2] - mx);
          l[j2] *= alpha;
#pragma unroll
          for (int i = 0; i < kDpl; ++i) acc[j2][i] *= alpha;
          m[j2] = mx;
        }
        const float p = expf(sv - m[j2]);
        l[j2] += p;
        pv[j2] = p * vsr;
      }
      uint32_t vw[kWords];
      words<kDpl>(vs8 + r * d + col, vw);
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        float vf[4];
        s8x4_to_f32(vw[w], vf);
#pragma unroll
        for (int j2 = 0; j2 < kHpw; ++j2)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[j2][4 * w + i] += pv[j2] * vf[i];
      }
    }
"""
VARIANTS = {
    "shipped": [],
    "no_walk": [(TILE, TILE.replace("rows = min", "rows = 0 * min"))],
    "no_copies": [(COPIES, "")],
    "step_softmax": [("walk", STEP_WALK)],
    "dense_steps": [("    auto on = [&](int k) { return kFull || (k * kRG + rg) "
                     "* 4 < rows; };\n",
                     "    auto on = [&](int k) { return true; };\n")],
}
HELD = ("shipped", "step_softmax", "dense_steps")


def device_ms(scrub, fn, clean=False):
    """Median device time of ``fn`` after evicting the L2: by zeroing
    ``scrub`` (chip_smoke.py's timer: the L2 is left dirty), or with
    ``clean`` by reading it."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(REPS):
        if clean:
            scrub.sum()
        else:
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


def paged_inputs(g, quant):
    b, h, d, page, max_pages = 256, 12, 64, 64, 8
    f = h * d
    n_pages = b * max_pages + 1
    q = torch.randn((b, h, d), device="cuda", generator=g)
    lengths = torch.randint(65, 177, (b,), device="cuda", generator=g,
                            dtype=torch.int32)
    if quant:
        pool = torch.randint(-127, 128, (n_pages, page, 2, f),
                             device="cuda", dtype=torch.int8, generator=g)
        scales = (0.002 + 0.01 * torch.rand((n_pages, page, 2, h),
                                            device="cuda", generator=g)
                  ).to(torch.bfloat16)
    else:
        pool = torch.randn((n_pages, page, 2, f), device="cuda",
                           generator=g)
        scales = None
    ids = 1 + torch.randperm(n_pages - 1, device="cuda", generator=g)
    table = ids[:b * max_pages].reshape(b, max_pages).to(torch.int32)
    mapped = (lengths.to(torch.int64) + page - 1) // page
    table[torch.arange(max_pages, device="cuda")[None, :]
          >= mapped[:, None]] = -1
    row = 2 * f * (1 if quant else 4) + (2 * h * 2 if quant else 0)
    n_bytes = lengths.double().sum().item() * row + 2 * q.numel() * 4
    return q, pool, scales, table.contiguous(), lengths, n_bytes


def grouped_inputs(g):
    b, h, kvh, d, cap = 16, 32, 8, 128, 4096
    kv = torch.randint(-127, 128, (b, cap, 2, kvh * d), device="cuda",
                       dtype=torch.int8, generator=g)
    scales = (0.002 + 0.01 * torch.rand((b, cap, 2, kvh), device="cuda",
                                        generator=g)).to(torch.bfloat16)
    q = torch.randn((b, h, d), device="cuda", generator=g)
    lengths = torch.randint(512, 577, (b,), device="cuda", generator=g,
                            dtype=torch.int32)
    row = 2 * kvh * d + 2 * kvh * 2
    n_bytes = lengths.double().sum().item() * row + 2 * q.numel() * 4
    return q, kv, scales, lengths, n_bytes


def report(scrub, label, fn, ref, n_bytes, rounds, clean=True):
    out = fn()
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item() / (REL_TOL * ref.abs().max().item())
    bound = n_bytes / PEAK_BYTES_S * 1e3
    times = [device_ms(scrub, fn) for _ in range(rounds)]
    line = (f"{label:46s} " + " / ".join(f"{t:.4f}" for t in times)
            + f" ms ({bound / min(times):.2f} of {bound:.4f})")
    if clean:
        times = [device_ms(scrub, fn, True) for _ in range(rounds)]
        line += ("; clean L2 " + " / ".join(f"{t:.4f}" for t in times)
                 + f" ms ({bound / min(times):.2f})")
    print(f"{line}; error {err:.3f} of the tolerance", flush=True)
    return err


def build_variants():
    """Every variant's P3i and G1 libraries, one nvcc each, all started
    together; returns {variant: (P3i function, G1 function)}."""
    header = (_build.CSRC / HEADER).read_text()
    procs = {}
    for name, patches in VARIANTS.items():
        text = header
        for old, new in patches:
            if old == "walk":  # the tile walk, from its first line to its end
                old = text[text.index(TILE):text.index(WALK_END)]
            if old not in text:
                raise RuntimeError(f"{name}: the header no longer holds "
                                   f"{old!r}")
            text = text.replace(old, new)
        src = OUT / name
        src.mkdir(parents=True, exist_ok=True)
        for f in _build.CSRC.glob("*.cuh"):
            shutil.copy(f, src / f.name)
        (src / HEADER).write_text(text)
        for lib in ("decode_attn_paged", "decode_attn_grouped_int8"):
            shutil.copy(_build.CSRC / f"{lib}.cu", src / f"{lib}.cu")
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src), "-o",
                   str(src / f"lib{lib}.so"), str(src / f"{lib}.cu")]
            procs[name, lib] = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
    for key, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{out}")
    fns = {}
    for name in VARIANTS:
        paged = ctypes.CDLL(str(OUT / name / "libdecode_attn_paged.so"))
        rows = ctypes.CDLL(str(OUT / name /
                               "libdecode_attn_grouped_int8.so"))
        fp, fr = paged.decode_attn_paged_int8, \
            rows.decode_attn_grouped_int8_rows
        fp.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [
            ctypes.c_float, ctypes.c_void_p]
        fr.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + [
            ctypes.c_float, ctypes.c_void_p]
        fp.restype = fr.restype = ctypes.c_int
        fns[name] = (fp, fr)
    return fns


def call_paged(fn, q, pool, scales, table, lengths):
    b, h, d = q.shape
    n_pages, page, _, f = pool.shape
    out = torch.empty_like(q)
    plan = at.paged_int8_plan(b, h, f // d, page, table.shape[1], d)
    _build.check(fn(q.data_ptr(), pool.data_ptr(), scales.data_ptr(),
                    table.data_ptr(), lengths.data_ptr(), out.data_ptr(), b,
                    h, f // d, d, page, table.shape[1], plan["splits"],
                    plan["heads_per_warp"], plan["head_groups"],
                    plan["warps"], 1.0 / d ** 0.5, _build.stream()),
                  "P3i variant")
    return out


def call_rows(fn, q, kv, scales, lengths):
    b, h, d = q.shape
    cap, kvh = kv.shape[1], kv.shape[3] // d
    out = torch.empty_like(q)
    plan = at.grouped_int8_plan(b, h, kvh, cap, d)
    _build.check(fn(q.data_ptr(), kv.data_ptr(), scales.data_ptr(),
                    lengths.data_ptr(), out.data_ptr(), None, b, h, kvh, d,
                    cap, 0, plan["splits"], plan["unit"],
                    plan["heads_per_warp"], plan["head_groups"],
                    plan["warps"], 1.0 / d ** 0.5, _build.stream()),
                  "G1 variant")
    return out


def main():
    if not torch.cuda.is_available():
        print("kv_group_variants: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    _build.build_all()
    scrub = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(13)
    worst = 0.0
    q, pool, scales, table, lengths, n_bytes = paged_inputs(g, True)
    args = (q, pool, scales, table, lengths)
    ref = at.decode_attn_paged_int8_plain(*args)
    print("P3i at path (D)'s shapes (ms in two rounds):")
    for splits, warps in ((None, 4), (None, 8), (2, 4), (2, 8)):
        plan = at.paged_int8_plan(256, 12, 12, 64, 8, 64, splits, warps)
        worst = max(worst, report(
            scrub, f"  decode_attn_paged_int8 splits {plan['splits']}"
            f"{' (plan)' if splits is None else ''}, {warps} warps",
            lambda: at._launch_paged_int8(*args, None, plan), ref,
            n_bytes, 2))
    qf, poolf, _, tablef, lengthsf, n_bytes_f = paged_inputs(g, False)
    argsf = (qf, poolf, tablef, lengthsf)
    report(scrub, "  decode_attn_paged (P3, f32 pool, K6's kernel)",
           lambda: at.decode_attn_paged(*argsf),
           at.decode_attn_paged_plain(*argsf), n_bytes_f, 2)

    q, kv, scales, lengths, n_bytes = grouped_inputs(g)
    args = (q, kv, scales, lengths)
    ref = at.decode_attn_grouped_int8_plain(*args)
    plan = at.grouped_int8_plan(16, 32, 8, 4096)
    print(f"G1 exact q at path (H)'s shapes (plan: {plan['splits']} "
          f"splits of {plan['warps']} warps):")
    for splits in (1, 2, 4, 8):
        for warps in (4, 8):
            plan = at.grouped_int8_plan(16, 32, 8, 4096, 128, splits, warps)
            worst = max(worst, report(
                scrub, f"  G1 splits {splits}, {warps} warps",
                lambda: at._launch_grouped_int8_rows(*args, False, None,
                                                     plan=plan),
                ref, n_bytes, 2))
    report(scrub, "  V1's kernel at S = 1 (decode_attn_fused_int8)",
           lambda: at.decode_attn_fused_int8(*args), ref, n_bytes, 2)
    ref = at.decode_attn_grouped_int8_plain(*args, int8_scores=True)
    worst = max(worst, report(
        scrub, "  G1 int8 scores (plan)",
        lambda: at.decode_attn_grouped_int8(*args, int8_scores=True), ref,
        n_bytes, 2))

    fns = build_variants()
    g = torch.Generator(device="cuda").manual_seed(13)
    p_args = paged_inputs(g, True)
    p_ref = at.decode_attn_paged_int8_plain(*p_args[:5])
    r_args = grouped_inputs(g)
    r_ref = at.decode_attn_grouped_int8_plain(*r_args[:4])
    print("variants of decode_attn_kv_group.cuh at the plan's launch:")
    for name, (fp, fr) in fns.items():
        for label, fn, ref, n_bytes in (
                ("P3i", lambda: call_paged(fp, *p_args[:5]), p_ref,
                 p_args[5]),
                ("G1", lambda: call_rows(fr, *r_args[:4]), r_ref,
                 r_args[4])):
            err = report(scrub, f"  {name}: {label}", fn, ref, n_bytes, 2,
                         clean=True)
            if name in HELD:
                worst = max(worst, err)
    print(f"worst error {worst:.3f} of the tolerance")
    return 0 if worst <= 1.0 else 1


if __name__ == "__main__":
    sys.exit(main())
