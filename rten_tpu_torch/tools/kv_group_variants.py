"""The KV-group kernel (``csrc/decode_attn_kv_group.cuh``) at its serving
paths' shapes, against its own launch choices and the designs it replaced,
and K7, P2, K5, P1 and K3 against variants of their sources, on one card
in one call.

Float rows:

* P3 (``decode_attn_paged``) at path (E)'s shapes (B 256, 12 heads of 64,
  an f32 pool of pages of 64, capacity 512, lives 65-176 over scrambled
  pages), its grid mode (``decode_attn_paged_grid``) at batch 3 with a
  page of each sequence unmapped, K8 (``decode_attn_flat_float``) at path
  (I)'s (B 256, 12 heads of 64, an f32 cache of capacity 512, lives
  65-176), at (I-bf16)'s (the same on a bf16 cache) and at TinyLlama's
  (B 16, 32 heads over 4 KV heads, capacity 2048, lives 65-1999), and K6
  (``decode_attn_float``) at path (A)'s (the shape of (I)), at (C)'s (the
  same on a bf16 cache), at batch 3 (the reference's fused fallback) and
  at TinyLlama's;
* each at the float ring's tilings: tiles of 16, 32 and 64 rows at head_dim
  64 in 2 or 3 stages (the header's kF32Rows, kBf16Rows and kFloatStages,
  each tiling built from a copy of the header with that line patched, one
  ``nvcc`` a library, all started together), with blocks of 4 or 8 warps;
  a split launch (the grid mode, K6 at batch 3, TinyLlama's K6 and K8)
  also at half and twice its splits.

int8 rows:

* P3i (``decode_attn_paged_int8``) at path (D)'s shapes (path (E)'s on an
  int8 pool) with its sequences in 1 (the plan's choice) and 2 chunks and
  blocks of 4 or 8 warps;
* G1 exact q (``decode_attn_grouped_int8``) at path (H)'s shapes (B 16, 32
  heads over 8 KV heads of 128, capacity 4096, lives 512-576) with 1, 2, 4
  and 8 chunks and blocks of 4 or 8 warps, and G1's int8 scores at the
  plan's launch;
* then P3i and G1 at the plan's launch built from variants of the header,
  to see where the time goes: ``no_walk`` (the rows are staged but never
  computed: the copies and the block's fixed costs), ``no_copies`` (the
  walk over stale shared memory: the arithmetic and the fixed costs),
  ``step_softmax`` (the walk before its three passes: a softmax step per
  row) and ``dense_steps`` (every step of a partial tile computed, its dead
  rows masked). The first two compute garbage, so their error is not held.

Verify and G2 (``--skip verify`` leaves them out):

* V1 (``verify_attn_grouped``, ``verify_attn_fused``: S x rep query rows
  a block) at path (G)'s shapes (B 8, S 4, 12 heads of 64, capacity 2048,
  lives 64-320) on a bf16 cache and on an int8 one ((G-int8)), and at the
  batch of 3 that takes the fused entry, with 1-8 splits and blocks of 4
  or 8 warps; (G)'s bf16 case also at the plan's launch for S 1, 2 and 8;
* G2 (``decode_attn_fused_int8``) at path (H-fused)'s shapes (B 3, 32
  heads over 8 KV heads of 128, capacity 4096, lives 512-576) with 1-8
  splits and blocks of 4 or 8 warps;
* then V1 at (G) and (G-int8) and G2 at the plan's launch built from the
  header's ``no_walk`` and ``no_copies`` variants; V1 at (G) with the
  lives of the traced burst of ``chip_smoke.py`` (64-85 rows); and the
  timer's floor: a one-element fill, timed as the kernels are.

A1 (``--skip append`` leaves it out):

* A1 (``decode_attn_grouped_append``: the decode append fused) at path
  (H-append)'s shapes (B 16, 32 heads over 8 KV heads of 128, capacity
  4096, lives 512-576, k and v views of one qkv row) on a bf16 cache and
  on an f32 one, with 1-8 splits and blocks of 4 or 8 warps; its error is
  held on the output and its cache write bit for bit against the plain
  version's.

K7 (``--skip k7`` leaves it out):

* K7 (``kv_append_int8``) at ``chip_smoke.py``'s (B) and (H) cases, with
  its inputs and its timer (imported from it, so the times are the ones it
  prints), each also without its all-zero head and with the model's new
  rows and positions (k and v views of one [B, 1, (H + 2 KVH) D] qkv row,
  positions 64-576), built from variants of its source: ``shipped``,
  ``one_warp_a_row`` (the design before, as it was launched: one warp a
  row through its one-warp quantizer, 256 threads a block, the source
  loads after the branch on the position), ``position_first`` (the shipped
  kernel with its source loads issued after the position has arrived),
  ``no_divide`` (each value multiplied by the scale: wrong bytes, the
  divisions' cost), ``divide_zeros`` (an all-zero row divided as any
  other: IEEE division takes its slow path for a zero dividend) and
  ``select_zeros`` (no test of the row; each zero divided as 1.0, its
  result selected away) and ``lanes16`` (sixteen lanes a row: half the
  values and divisions a lane). Each time in two rounds of turns; each
  variant but ``no_divide`` held bit for bit against the plain version.

P2 (``--skip p2`` leaves it out):

* P2 (``kv_append_paged_int8``) at ``chip_smoke.py``'s (D) case, with and
  without its all-zero head (its inputs and timer, imported from it),
  built as shipped and as the design before (``one_warp_a_row``: one warp
  a row through its one-warp quantizer, 256 threads a block), each bit
  for bit against the plain version, in two rounds of turns with
  ``chip_smoke.py``'s timer.

K5 and P1 (``--skip fappend`` leaves them out):

* K5 (``kv_append``) at ``chip_smoke.py``'s (A) and (C) inputs (f32 and
  bf16 caches) and P1 (``kv_append_paged``) at its (E) inputs (its inputs
  and timer, imported from it), built from variants of their sources:
  ``shipped`` (the decode appends' kernel body of ``csrc/kv_append.cuh``
  with its float row policy, eight lanes a row), ``one_thread_an_element``
  (the design before, as it was launched: a thread an element in blocks
  of 256, each loading the position, or the length and the table entry
  behind it, before its value), ``lanes4`` and ``lanes16`` (four or
  sixteen lanes a row: twice or half the values a lane) and
  ``unguarded_loads`` (every lane loads, as K3's window rows do); each in
  two rounds of turns, held bit for bit against the plain version.

K3 and K9 (``--skip flush``, ``--skip k9`` leave them out):

* K3 (``tail_flush_int8``) at ``chip_smoke.py``'s inputs (its int8 + tail
  shape, B 256, 12 heads of 64, capacity 512, and TinyLlama's, B 16, 4 KV
  heads, capacity 2048), each at t 16 and at t 5 of the 16-row window,
  built as shipped (the decode appends' kernel body over the window's
  rows), as the design before (``one_warp_a_row``: one warp a row, the
  one-warp quantizer, 256 threads a block), with the row id of five
  divisions (``five_divisions``), with its loads guarded by the lane's
  row as the f32 sources' are (``guarded_loads``) and with each value
  multiplied by the scale (``no_divide``: wrong bytes, the divisions'
  cost); two rounds of turns with ``chip_smoke.py``'s timer, each but
  ``no_divide`` bit for bit against the plain version;
* K9 (``decode_attn_split_kv``) at ``chip_smoke.py``'s inputs (path (H)'s
  head shape, f32 and bf16 planes of S 4096, lives 512-576) at 1, 2, 4
  and 8 splits and blocks of 4 or 8 warps, each held to 1e-5 of max
  |out| against the plain version.

native_dots and pv_int8 (``--skip native``, ``--skip pv8`` leave them
out):

* native_dots (``decode_attn_native_dots``: the KV-group kernel's native
  mode, one split of whole 64-row blocks) at ``chip_smoke.py``'s inputs
  (path (C)'s shapes on a bf16 cache) and pv_int8
  (``decode_attn_grouped_int8(pv_int8=True)``, exact q and int8 scores:
  its pv_int8 modes at ``block_plan``) at its (H) inputs, with its timer;
  with ``--parent CHECKOUT`` each in turns (parent, change, change,
  parent) with the checkout's kernel, built from its sources (the design
  before: ``decode_attn_native_dots`` and ``decode_attn_pv_int8`` of its
  own signatures, where its source has them); native_dots at 4 and 8
  warps and pv_int8 at 1-8 splits x 4/8 warps. Each held to
  ``chip_smoke.py``'s flip criterion (no element past one flipped
  rounding, 99% within 1e-5 of max |out|).

The partials mode and M1 (``--skip partials``, ``--skip m1`` leave them
out):

* the partials mode (``decode_attn_int8_partials``: the KV-group kernel in
  its partials modes at ``rows_plan``) at ``chip_smoke.py``'s inputs and
  timer (path (B)'s shape, q_bf16 on and off, and TinyLlama's), with
  ``--parent`` in turns with the checkout's kernel (the design before: the
  kernel of K1 and K1' in its partials mode, through its own C entry); K1
  and K1' at path (B)'s shape against the checkout's (their source lost
  the partials mode); the partials at TinyLlama's shape at 1-8 splits x
  4/8 warps.
  Held to ``chip_smoke.py``'s criterion;
* M1 (``matmul_int8_tiled``: ``wgmma`` s8 over a TMA-fed ring) at
  GPT-2-small's four linears at M 256 and 4096, with ``--parent`` in turns
  with the checkout's kernel (the design before: ``mma.sync``), beside
  ``torch._int_mm`` and the epilogue; at M 256 also with 64- and
  128-column tiles and 1-8 K splits, at M 4096 with a block a tile
  (not persistent); held bit for bit; then variants of its source
  (``M1_VARIANTS``: three stages, a thread's two transpose units in turn,
  one stage's products kept in flight, and, with wrong results, no
  transpose or no wgmma) in two rounds of turns.

Each line: the device time (CUDA events, cold L2, warm median) in two
rounds, its share of the byte bound, and the error against the plain
version as a share of its tolerance (1e-5 of max |out|; K8, whose output is
rounded to bf16: the share of elements off by more than 2e-5 of max |out|,
against 0.001). The int8 variants are timed twice: after the scrub that
``chip_smoke.py``'s timer runs (zeroing 256 MB, which leaves the 50 MB L2
full of dirty lines that the kernel's reads must first write back), and
after a read of the same 256 MB (the L2 cold and clean).

    python -m rten_tpu_torch.tools.kv_group_variants \
        [--skip int8|float|verify|append|k7|p2|fappend|flush|k9|native|pv8|
                partials|m1]
        [--parent CHECKOUT]

Builds go to ``rten_tpu_torch/build/kv_group_variants/``. Needs one NVIDIA
card and nvcc; without a card it exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from rten_tpu_torch.kernels import _build
from rten_tpu_torch.kernels import attention as at
from rten_tpu_torch.kernels import cache as kc

SLEEP_CYCLES = 2_000_000          # about 1 ms at the H100's clocks
REPS = 20
REL_TOL = 1e-5
ROUND_ELEM_TOL, ROUND_SHARE = 2e-5, 0.999
PEAK_BYTES_S = 3.35e12
OUT = _build.BUILD_DIR / "kv_group_variants"
HEADER = "decode_attn_kv_group.cuh"
# The float ring's tilings: (rows at head_dim 64, stages), and the header's
# line that sets the shipped one.
FLOAT_TILINGS = [(rows, stages) for stages in (2, 3)
                 for rows in (16, 32, 64)]
FLOAT_RING = re.compile(r"constexpr int kF32Rows = \d+, kBf16Rows = \d+, "
                        r"kFloatStages = \d+;")
TILE = "    const int t0 = c0 + j * kTile, rows = min(kTile, c1 - t0);\n"
COPIES = ("          cp_async16(dst, k_at(addr, kv, row, kh, f, d) + e);\n"
          "          if (!kBlock || sp.pass == passes - 1)\n"
          "            cp_async16(dst + kPlane, v_at(addr, kv, row, kh, f, d)"
          " + e);\n")
WALK_END = ("    if (j + kStages - 1 < tiles) put_scale(j + kStages - 1, "
            "next);\n")
# The int8 walk before its three passes: a softmax step per row (two
# shuffles, a branch and an exp chained into every row).
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
      words<kDpl>(ks8 + r * d + slot * kDpl, kw);
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
      words<kDpl>(vs8 + r * d + slot * kDpl, vw);
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
# The designs before of K7, P2 and K3 quantized a row with one warp: each
# lane takes every 32nd value for the absmax and again to quantize, and
# stores single bytes (every value divided, zeros too).
ONE_WARP_QUANTIZE = """template <typename In>
__device__ inline void one_warp_quantize(const In* __restrict__ src,
                                         int8_t* __restrict__ dst,
                                         __nv_bfloat16* __restrict__ scale,
                                         int d) {
  const int lane = threadIdx.x & 31;
  float amax = 0.0f;
  for (int i = lane; i < d; i += 32)
    amax = fmaxf(amax, fabsf(kvquant::to_float(src[i])));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const __nv_bfloat16 sb = kvquant::row_scale(amax);
  const float sf = __bfloat162float(sb);
  for (int i = lane; i < d; i += 32)
    dst[i] = (int8_t)kvquant::quantize_value(kvquant::to_float(src[i]), sf);
  if (lane == 0) *scale = sb;
}

"""
# K7's design before: one warp a (sequence, plane, head) row, the position
# read first and its branch taken before the source row is loaded.
ONE_WARP_A_ROW = ONE_WARP_QUANTIZE + """__global__ void one_warp_a_row(
    const float* __restrict__ k, const float* __restrict__ v, int k_stride,
    int v_stride, int8_t* __restrict__ kv, __nv_bfloat16* __restrict__ scales,
    const int* __restrict__ pos_in, int batch, int cap, int kvh, int d,
    int masked) {
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (warp >= (long long)batch * 2 * kvh) return;
  const int h = (int)(warp % kvh);
  const int plane = (int)((warp / kvh) % 2);
  const int b = (int)(warp / (2 * kvh));
  const int p = pos_in[b];
  if (masked && p < 0) return;
  const int pos = min(max(p, 0), cap - 1);
  const long long f = (long long)kvh * d;
  const float* src = plane == 0 ? k + (long long)b * k_stride
                                : v + (long long)b * v_stride;
  const long long row = ((long long)b * cap + pos) * 2 + plane;
  one_warp_quantize(src + (long long)h * d,
                    kv + row * f + (long long)h * d,
                    scales + row * kvh + h, d);
}

"""
K7_SOURCE = "kv_append.cuh"
K7_ENTRY = "  const kvappend::Positions addr{(const int*)pos, cap, masked};\n"
K7_LOADS = "  if constexpr (kDpl > 0) {\n    float x[kDpl];\n"
K7_ZERO_ROW = """  if (amax == 0.0f) {
#pragma unroll
    for (int j = 0; j < kDpl / 4; ++j) w[j] = 0;
    return __float2bfloat16_rn(1.0f);
  }
"""
K7_VARIANTS = {
    "shipped": [],
    "one_warp_a_row": [
        ("kv_append_int8.cu", 'extern "C" int kv_append_int8(',
         ONE_WARP_A_ROW + 'extern "C" int kv_append_int8('),
        ("kv_append_int8.cu", K7_ENTRY,
         "  one_warp_a_row<<<(unsigned)((batch * 2LL * kvh * 32 + 255) / "
         "256), 256, 0,\n      (cudaStream_t)stream>>>((const float*)k, "
         "(const float*)v, k_stride,\n      v_stride, (int8_t*)kv, "
         "(__nv_bfloat16*)scales, (const int*)pos, batch,\n      cap, kvh, "
         "d, masked);\n  return (int)cudaGetLastError();\n" + K7_ENTRY)],
    "position_first": [
        (K7_SOURCE, K7_LOADS,
         "  if ((on ? addr.locate(b) : 0) < -(1 << 30)) return;\n"
         + K7_LOADS)],
    "no_divide": [("kv_quant.cuh", "rintf(__fdiv_rn(x, sf))",
                   "rintf(x * sf)")],
    "divide_zeros": [("kv_quant.cuh", K7_ZERO_ROW, "")],
    "lanes16": [
        (K7_SOURCE, "constexpr int kLanes = 8;", "constexpr int kLanes = 16;"),
        ("kv_quant.cuh", "  for (int o = 1; o < 8; o <<= 1)",
         "  for (int o = 1; o < 16; o <<= 1)")],
    "select_zeros": [
        ("kv_quant.cuh", K7_ZERO_ROW, ""),
        ("kv_quant.cuh", "  return (int)fminf(fmaxf(rintf(__fdiv_rn(x, sf))",
         "  return x == 0.0f ? 0 : (int)fminf(fmaxf(rintf(__fdiv_rn("
         "x == 0.0f ? 1.0f : x, sf))")],
}


# P2's design before: one warp a (sequence, plane, head) row through the
# one-warp quantizer, its source loads behind the chain length -> table,
# 256 threads a block.
P2_SOURCE = "kv_append_paged.cu"
P2_ONE_WARP_A_ROW = ONE_WARP_QUANTIZE + """__global__ void one_warp_a_row(
    const float* __restrict__ k, const float* __restrict__ v, int k_stride,
    int v_stride, int8_t* __restrict__ pool,
    __nv_bfloat16* __restrict__ scales, const int* __restrict__ table,
    const int* __restrict__ lengths, int batch, int page, int max_pages,
    int kvh, int d) {
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (warp >= (long long)batch * 2 * kvh) return;
  const int h = (int)(warp % kvh);
  const int plane = (int)((warp / kvh) % 2);
  const int b = (int)(warp / (2 * kvh));
  const long long f = (long long)kvh * d;
  const float* src = plane == 0 ? k + (long long)b * k_stride
                                : v + (long long)b * v_stride;
  const kvappend::PagedSlots addr{table, lengths, page, max_pages};
  const long long row = addr.row(b, addr.locate(b)) * 2 + plane;
  one_warp_quantize(src + (long long)h * d,
                    pool + row * f + (long long)h * d,
                    scales + row * kvh + h, d);
}

"""
P2_ENTRY = ("  const kvappend::Int8Rows rows{(int8_t*)pool, "
            "(__nv_bfloat16*)scales};\n")
P2_VARIANTS = {
    "shipped": [],
    "one_warp_a_row": [
        (P2_SOURCE, 'extern "C" int kv_append_paged_int8(',
         P2_ONE_WARP_A_ROW + 'extern "C" int kv_append_paged_int8('),
        (P2_SOURCE, P2_ENTRY,
         "  one_warp_a_row<<<(unsigned)((batch * 2LL * kvh * 32 + 255) / "
         "256), 256, 0,\n      (cudaStream_t)stream>>>((const float*)k, "
         "(const float*)v, k_stride,\n      v_stride, (int8_t*)pool, "
         "(__nv_bfloat16*)scales, (const int*)table,\n      (const int*)"
         "lengths, batch, page, max_pages, kvh, d);\n  return "
         "(int)cudaGetLastError();\n" + P2_ENTRY)],
}
# K5's and P1's design before: one thread an element of the [B, 2, F] rows
# in blocks of 256, each thread loading the position (P1: the length and
# the table entry behind it) before its value.
K5_ONE_THREAD = """namespace {

__device__ inline void store(float* dst, float x) { *dst = x; }
__device__ inline void store(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void kv_append_kernel(const float* __restrict__ k,
                                 const float* __restrict__ v, int k_stride,
                                 int v_stride, T* __restrict__ cache,
                                 const int* __restrict__ lengths, int batch,
                                 int cap, int f) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)batch * 2 * f) return;
  const int c = (int)(i % f);
  const int plane = (int)((i / f) % 2);
  const int b = (int)(i / (2LL * f));
  const int pos = min(max(lengths[b], 0), cap - 1);
  const float x = plane == 0 ? k[(long long)b * k_stride + c]
                             : v[(long long)b * v_stride + c];
  store(cache + (((long long)b * cap + pos) * 2 + plane) * f + c, x);
}

int one_thread_an_element(const void* k, const void* v, int k_stride,
                          int v_stride, void* cache, const void* lengths,
                          int batch, int cap, int f, int bf16,
                          void* stream) {
  const long long grid = ((long long)batch * 2 * f + 255) / 256;
  if (grid > 0 && bf16)
    kv_append_kernel<<<(unsigned)grid, 256, 0, (cudaStream_t)stream>>>(
        (const float*)k, (const float*)v, k_stride, v_stride,
        (__nv_bfloat16*)cache, (const int*)lengths, batch, cap, f);
  else if (grid > 0)
    kv_append_kernel<<<(unsigned)grid, 256, 0, (cudaStream_t)stream>>>(
        (const float*)k, (const float*)v, k_stride, v_stride,
        (float*)cache, (const int*)lengths, batch, cap, f);
  return (int)cudaGetLastError();
}

}  // namespace

"""
P1_ONE_THREAD = """namespace {

__global__ void kv_append_paged_kernel(const float* __restrict__ k,
                                       const float* __restrict__ v,
                                       int k_stride, int v_stride,
                                       float* __restrict__ pool,
                                       const int* __restrict__ table,
                                       const int* __restrict__ lengths,
                                       int batch, int page, int max_pages,
                                       int f) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)batch * 2 * f) return;
  const int c = (int)(i % f);
  const int plane = (int)((i / f) % 2);
  const int b = (int)(i / (2LL * f));
  const kvappend::PagedSlots addr{table, lengths, page, max_pages};
  const long long r = addr.row(b, addr.locate(b));
  pool[(r * 2 + plane) * f + c] = plane == 0 ? k[(long long)b * k_stride + c]
                                             : v[(long long)b * v_stride + c];
}

int one_thread_an_element(const void* k, const void* v, int k_stride,
                          int v_stride, void* pool, const void* table,
                          const void* lengths, int batch, int page,
                          int max_pages, int f, void* stream) {
  const long long grid = ((long long)batch * 2 * f + 255) / 256;
  if (grid > 0)
    kv_append_paged_kernel<<<(unsigned)grid, 256, 0,
                             (cudaStream_t)stream>>>(
        (const float*)k, (const float*)v, k_stride, v_stride, (float*)pool,
        (const int*)table, (const int*)lengths, batch, page, max_pages, f);
  return (int)cudaGetLastError();
}

}  // namespace

"""
K5_ENTRY = "  const kvappend::Positions addr{(const int*)lengths, cap, 0};\n"
P1_ENTRY = ("  return (int)kvappend::launch(src, kvappend::FloatRows<float>{"
            "(float*)pool},\n")
FAPPEND_VARIANTS = {
    "shipped": [],
    "one_thread_an_element": [
        ("kv_append.cu", 'extern "C" int kv_append(',
         K5_ONE_THREAD + 'extern "C" int kv_append('),
        ("kv_append.cu", K5_ENTRY,
         "  return one_thread_an_element(k, v, k_stride, v_stride, cache, "
         "lengths,\n      batch, cap, kvh * d, bf16, stream);\n" + K5_ENTRY),
        ("kv_append_paged.cu", 'extern "C" int kv_append_paged(',
         P1_ONE_THREAD + 'extern "C" int kv_append_paged('),
        ("kv_append_paged.cu", P1_ENTRY,
         "  return one_thread_an_element(k, v, k_stride, v_stride, pool, "
         "table,\n      lengths, batch, page, max_pages, kvh * d, stream);\n"
         + P1_ENTRY)],
    "lanes4": [(K7_SOURCE, "constexpr int kLanes = 8;",
                "constexpr int kLanes = 4;")],
    # Every lane loads, as K3's window rows do.
    "unguarded_loads": [
        (K7_SOURCE, "      const float4 q = on ? __ldg(reinterpret_cast<const "
         "float4*>(p) + c)\n                          : make_float4(0.0f, "
         "0.0f, 0.0f, 0.0f);\n", "      const float4 q = __ldg("
         "reinterpret_cast<const float4*>(p) + c);\n")],
    "lanes16": [(K7_SOURCE, "constexpr int kLanes = 8;",
                 "constexpr int kLanes = 16;")],
}


# K3's design before: one warp a (sequence, token, plane, head) row of the
# window through the one-warp quantizer, 256 threads a block.
FLUSH_ONE_WARP = ONE_WARP_QUANTIZE + """__global__ void one_warp_a_row(
    const __nv_bfloat16* __restrict__ tail, int8_t* __restrict__ kv,
    __nv_bfloat16* __restrict__ scales, const int* __restrict__ lengths,
    int batch, int rows, int cap, int kvh, int d, int t) {
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (warp >= (long long)batch * t * 2 * kvh) return;
  const int h = (int)(warp % kvh);
  long long rest = warp / kvh;
  const int plane = (int)(rest % 2);
  rest /= 2;
  const int j = (int)(rest % t);
  const int b = (int)(rest / t);
  const long long f = (long long)kvh * d;
  const __nv_bfloat16* src =
      tail + (((long long)b * rows + j) * 2 + plane) * f + (long long)h * d;
  const int off = min(max(lengths[b] - t, 0), cap - t);
  const long long row = ((long long)b * cap + off + j) * 2 + plane;
  one_warp_quantize(src, kv + row * f + (long long)h * d,
                    scales + row * kvh + h, d);
}

"""
FLUSH_ENTRY = ("  const kvappend::WindowRows src{(const __nv_bfloat16*)tail, "
               "rows, t, batch};\n")
# K3 with the row id of five divisions (as first built), with its loads
# guarded as the f32 sources' are, and with each value multiplied by the
# scale (wrong bytes: the divisions' cost).
FLUSH_ID = ("    const long long q = r / kvh, bj = q >> 1, b = bj / t;\n"
            "    return {(int)b, (int)(bj - b * t), (int)(q & 1), "
            "(int)(r - q * kvh)};\n")
BF16_LOAD = ("      const uint4 q = __ldg(reinterpret_cast<const uint4*>(p) + "
             "c);\n")
FLUSH_VARIANTS = {
    "shipped": [],
    "five_divisions": [
        (K7_SOURCE, FLUSH_ID,
         "    const long long bj = r / (2 * kvh);\n    return {(int)(bj / t), "
         "(int)(bj % t), (int)((r / kvh) % 2),\n            (int)(r % kvh)};"
         "\n")],
    "guarded_loads": [
        (K7_SOURCE, "  __device__ void load(const __nv_bfloat16* p, bool, "
         "float* x) const {", "  __device__ void load(const __nv_bfloat16* p, "
         "bool on, float* x) const {"),
        (K7_SOURCE, BF16_LOAD, BF16_LOAD.replace(
            "__ldg(", "on ? __ldg(").replace(
            ";\n", "\n                      : make_uint4(0, 0, 0, 0);\n"))],
    "no_divide": [("kv_quant.cuh", "rintf(__fdiv_rn(x, sf))",
                   "rintf(x * sf)")],
    "one_warp_a_row": [
        ("tail_flush_int8.cu", 'extern "C" int tail_flush_int8(',
         FLUSH_ONE_WARP + 'extern "C" int tail_flush_int8('),
        ("tail_flush_int8.cu", FLUSH_ENTRY,
         "  one_warp_a_row<<<(unsigned)((batch * (long long)t * 2 * kvh * "
         "32 + 255) / 256),\n      256, 0, (cudaStream_t)stream>>>("
         "(const __nv_bfloat16*)tail, (int8_t*)kv,\n      "
         "(__nv_bfloat16*)scales, (const int*)lengths, batch, rows, cap, "
         "kvh, d, t);\n  return (int)cudaGetLastError();\n" + FLUSH_ENTRY)],
}


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


def _nvcc(src_dir, lib, out_dir):
    out_dir.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src_dir),
           "-o", str(out_dir / f"lib{lib}.so"), str(src_dir / f"{lib}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _wait(procs):
    for key, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{out}")


@contextlib.contextmanager
def library(lib, path):
    """The launchers of ``kernels/attention.py`` call the entries of the
    library at ``path`` instead of the shipped ``lib``."""
    dll = ctypes.CDLL(str(path))
    shipped = _build.function

    def function(lib_name, symbol, argtypes):
        if lib_name != lib:
            return shipped(lib_name, symbol, argtypes)
        return _entry(dll, symbol, argtypes)

    _build.function = function
    try:
        yield
    finally:
        _build.function = shipped


def _entry(dll, symbol, argtypes):
    fn = getattr(dll, symbol)
    fn.argtypes = [{"p": ctypes.c_void_p, "i": ctypes.c_int,
                    "f": ctypes.c_float}[c] for c in argtypes]
    fn.restype = ctypes.c_int
    return fn


def paged_inputs(g, quant, b=256, unmapped=False):
    """(E)'s or (D)'s inputs at batch ``b``; ``unmapped`` unmaps the second
    page of each sequence (the grid mode masks its rows)."""
    h, d, page, max_pages = 12, 64, 64, 8
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
    live = lengths.double()
    if unmapped:
        table[:, 1] = -1
        live = live - (lengths - page).clamp(0, page).double()
    row = 2 * f * (1 if quant else 4) + (2 * h * 2 if quant else 0)
    n_bytes = live.sum().item() * row + 2 * q.numel() * 4
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


def flat_inputs(g, dtype, b=256, h=12, kvh=12, cap=512, lives=(65, 177)):
    d = 64
    q = torch.randn((b, h, d), device="cuda", generator=g)
    kv = torch.randn((b, cap, 2, kvh * d), device="cuda",
                     generator=g).to(dtype)
    lengths = torch.randint(lives[0], lives[1], (b,), device="cuda",
                            generator=g, dtype=torch.int32)
    row = 2 * kvh * d * kv.element_size()
    n_bytes = lengths.double().sum().item() * row + 2 * q.numel() * 4
    return q, kv, lengths, n_bytes


def held_error(out, ref, rounded):
    """The error as a share of the kernel's tolerance (<= 1 passes)."""
    err = (out - ref).abs()
    top = ref.abs().max().item()
    if rounded:
        off = err.gt(ROUND_ELEM_TOL * top).float().mean().item()
        return off / (1.0 - ROUND_SHARE)
    return err.max().item() / (REL_TOL * top)


def report(scrub, label, fn, ref, n_bytes, rounds=2, clean=False,
           rounded=False):
    out = fn()
    torch.cuda.synchronize()
    err = held_error(out, ref, rounded)
    bound = n_bytes / PEAK_BYTES_S * 1e3
    times = [device_ms(scrub, fn) for _ in range(rounds)]
    line = (f"{label:52s} " + " / ".join(f"{t:.4f}" for t in times)
            + f" ms ({bound / min(times):.2f} of {bound:.4f})")
    if clean:
        times = [device_ms(scrub, fn, True) for _ in range(rounds)]
        line += ("; clean L2 " + " / ".join(f"{t:.4f}" for t in times)
                 + f" ms ({bound / min(times):.2f})")
    print(f"{line}; error {err:.3f} of the tolerance", flush=True)
    return err


def float_cases(g):
    """(label, launcher(plan), plan(splits, warps), plain output, bytes,
    rounded, library) of the float paths."""
    cases = []
    for label, b, unmapped in (("P3 at (E)", 256, False),
                               ("grid mode at batch 3", 3, True)):
        q, pool, _, table, lengths, n_bytes = paged_inputs(g, False, b,
                                                           unmapped)
        args = (q, pool, table, lengths)
        grid = label.startswith("grid")
        wrapper = at.decode_attn_paged_grid if grid else at.decode_attn_paged
        plain = (at.decode_attn_paged_grid_plain if grid
                 else at.decode_attn_paged_plain)
        cases.append((
            label,
            lambda plan, args=args, w=wrapper, m=grid: at._launch_paged(
                w, *args, None, m, plan),
            lambda s, w, b=b: at.paged_plan(b, 12, 12, 64, 8, 64, s, w),
            plain(*args), n_bytes, False, "decode_attn_paged"))
    tiny = dict(b=16, h=32, kvh=4, cap=2048, lives=(65, 2000))
    for label, dtype, shape in (
            ("K8 f32 at (I)", torch.float32, {}),
            ("K8 bf16 at (I-bf16)", torch.bfloat16, {}),
            ("K8 f32 at TinyLlama's shape", torch.float32, tiny),
            ("K6 f32 at (A)", torch.float32, {}),
            ("K6 bf16 at (C)", torch.bfloat16, {}),
            ("K6 f32 at batch 3", torch.float32, dict(b=3)),
            ("K6 f32 at TinyLlama's shape", torch.float32, tiny)):
        q, kv, lengths, n_bytes = flat_inputs(g, dtype, **shape)
        args = (q, kv, lengths)
        b, h, d = q.shape
        kvh, cap = kv.shape[3] // d, kv.shape[1]
        flat = label.startswith("K8")
        wrapper = at.decode_attn_flat_float if flat else at.decode_attn_float
        plain = getattr(at, wrapper.__name__ + "_plain")
        cases.append((
            label,
            lambda plan, args=args, w=wrapper: at._launch_rows_float(
                w, *args, None, plan),
            lambda s, w, b=b, h=h, kvh=kvh, cap=cap: at.rows_plan(
                b, h, kvh, cap, 64, s, w),
            plain(*args), n_bytes, flat, "decode_attn_float"))
    return cases


def float_section(scrub):
    """The float paths at every ring tiling and warp count; returns the
    worst held error."""
    header = (_build.CSRC / HEADER).read_text()
    ring = FLOAT_RING.search(header)
    if ring is None:
        raise RuntimeError("the header no longer sets the float ring in "
                           "one line")
    dirs = build_patched(
        {f"float_{rows}x{stages}": [(ring.group(0), (
            f"constexpr int kF32Rows = {rows}, kBf16Rows = {rows}, "
            f"kFloatStages = {stages};"))]
         for rows, stages in FLOAT_TILINGS},
        ("decode_attn_paged", "decode_attn_float"))
    worst = 0.0
    g = torch.Generator(device="cuda").manual_seed(13)
    for label, launch, plan_of, ref, n_bytes, rounded, lib in float_cases(g):
        plan = plan_of(None, None)
        print(f"{label} (plan: {plan['splits']} split(s) of {plan['warps']} "
              f"warps, {plan['heads_per_warp']} head(s) a warp in "
              f"{plan['head_groups']} group(s), {plan['blocks']} blocks):",
              flush=True)
        for rows, stages in FLOAT_TILINGS:
            src = dirs[f"float_{rows}x{stages}"]
            with library(lib, src / f"lib{lib}.so"):
                for warps in (4, 8):
                    p = plan_of(None, warps)
                    worst = max(worst, report(
                        scrub, f"  {stages} x {rows} rows, {warps} "
                        f"warps{' (plan)' if warps == plan['warps'] else ''}",
                        lambda p=p: launch(p), ref, n_bytes,
                        rounded=rounded))
        # A split launch against half and twice its splits (shipped ring).
        if plan["splits"] > 1:
            for splits in sorted({plan["splits"] // 2,
                                  min(2 * plan["splits"], plan["most"])}
                                 - {plan["splits"]}):
                p = plan_of(splits, None)
                worst = max(worst, report(
                    scrub, f"  {splits} splits, {p['warps']} warps",
                    lambda p=p: launch(p), ref, n_bytes, rounded=rounded))
    return worst


def build_patched(variants, libs):
    """Each variant ({name: [patch, ...]}: ``(old, new)`` in the header,
    ``old`` "walk" for the int8 tile walk, or ``(file, old, new)`` in that
    file of csrc) with the libraries ``libs``, one nvcc each, all started
    together; returns {name: directory}."""
    procs, dirs = {}, {}
    for name, patches in variants.items():
        src = OUT / name
        src.mkdir(parents=True, exist_ok=True)
        for f in [*_build.CSRC.glob("*.cuh"),
                  *(_build.CSRC / f"{lib}.cu" for lib in libs)]:
            shutil.copy(f, src / f.name)
        for patch in patches:
            file, old, new = patch if len(patch) == 3 else (HEADER, *patch)
            text = (src / file).read_text()
            if old == "walk":  # the tile walk, from its first line to its end
                old = text[text.index(TILE):text.index(WALK_END)]
            if old not in text:
                raise RuntimeError(f"{name}: {file} no longer holds {old!r}")
            (src / file).write_text(text.replace(old, new))
        for lib in libs:
            procs[name, lib] = _nvcc(src, lib, src)
        dirs[name] = src
    _wait(procs)
    return dirs


def int8_section(scrub):
    g = torch.Generator(device="cuda").manual_seed(13)
    worst = 0.0
    q, pool, scales, table, lengths, n_bytes = paged_inputs(g, True)
    args = (q, pool, scales, table, lengths)
    ref = at.decode_attn_paged_int8_plain(*args)
    print("P3i at path (D)'s shapes (ms in two rounds):")
    for splits, warps in ((None, 4), (None, 8), (2, 4), (2, 8)):
        plan = at.paged_plan(256, 12, 12, 64, 8, 64, splits, warps)
        worst = max(worst, report(
            scrub, f"  decode_attn_paged_int8 splits {plan['splits']}"
            f"{' (plan)' if splits is None else ''}, {warps} warps",
            lambda: at._launch_paged_int8(*args, None, plan), ref,
            n_bytes, clean=True))

    q, kv, scales, lengths, n_bytes = grouped_inputs(g)
    args = (q, kv, scales, lengths)
    ref = at.decode_attn_grouped_int8_plain(*args)
    plan = at.rows_plan(16, 32, 8, 4096)
    print(f"G1 exact q at path (H)'s shapes (plan: {plan['splits']} "
          f"splits of {plan['warps']} warps):")
    for splits in (1, 2, 4, 8):
        for warps in (4, 8):
            plan = at.rows_plan(16, 32, 8, 4096, 128, splits, warps)
            worst = max(worst, report(
                scrub, f"  G1 splits {splits}, {warps} warps",
                lambda: at._launch_grouped_int8_rows(*args, False, None,
                                                     plan=plan),
                ref, n_bytes, clean=True))
    ref = at.decode_attn_grouped_int8_plain(*args, int8_scores=True)
    worst = max(worst, report(
        scrub, "  G1 int8 scores (plan)",
        lambda: at.decode_attn_grouped_int8(*args, int8_scores=True), ref,
        n_bytes, clean=True))

    dirs = build_patched(VARIANTS, ("decode_attn_paged",
                                    "decode_attn_grouped_int8"))
    g = torch.Generator(device="cuda").manual_seed(13)
    p_args = paged_inputs(g, True)
    p_ref = at.decode_attn_paged_int8_plain(*p_args[:5])
    r_args = grouped_inputs(g)
    r_ref = at.decode_attn_grouped_int8_plain(*r_args[:4])
    print("variants of decode_attn_kv_group.cuh at the plan's launch:")
    for name, src in dirs.items():
        for label, lib, fn, ref, n_bytes in (
                ("P3i", "decode_attn_paged",
                 lambda: at._launch_paged_int8(*p_args[:5], None), p_ref,
                 p_args[5]),
                ("G1", "decode_attn_grouped_int8",
                 lambda: at._launch_grouped_int8_rows(*r_args[:4], False,
                                                      None),
                 r_ref, r_args[4])):
            with library(lib, src / f"lib{lib}.so"):
                err = report(scrub, f"  {name}: {label}", fn, ref, n_bytes,
                             clean=True)
            if name in HELD:
                worst = max(worst, err)
    return worst


def verify_inputs(g, mode, b, s=4, h=12, d=64, cap=2048, lives=(64, 321)):
    """Path (G)'s verify inputs (a bf16 cache, or ``mode`` "int8") at batch
    ``b``, and the bytes of the rows the chunk's queries read (each once),
    q and the output."""
    f = h * d
    q = torch.randn((b, s, h, d), device="cuda", generator=g)
    lengths = torch.randint(lives[0], lives[1], (b,), device="cuda",
                            generator=g, dtype=torch.int32)
    if mode == "int8":
        kv = torch.randint(-127, 128, (b, cap, 2, f), device="cuda",
                           dtype=torch.int8, generator=g)
        scales = (0.002 + 0.01 * torch.rand((b, cap, 2, h), device="cuda",
                                            generator=g)).to(torch.bfloat16)
        row = 2 * f + 2 * h * 2
    else:
        kv = torch.randn((b, cap, 2, f), device="cuda",
                         generator=g).to(torch.bfloat16)
        scales, row = None, 2 * f * 2
    rows = (lengths.double() + s).clamp(max=cap).sum().item()
    return q, kv, lengths, scales, rows * row + 2 * q.numel() * 4


def verify_section(scrub):
    """V1 at (G), (G-int8) and batch 3, G2 at (H-fused): every split count
    and both warp counts; returns the worst held error."""
    g = torch.Generator(device="cuda").manual_seed(15)
    worst = 0.0
    for label, mode, b in (("V1 float at (G)", "bf16", 8),
                           ("V1 int8 at (G-int8)", "int8", 8),
                           ("V1 float at batch 3", "bf16", 3),
                           ("V1 int8 at batch 3", "int8", 3)):
        q, kv, lengths, scales, n_bytes = verify_inputs(g, mode, b)
        wrapper = at.verify_attn_grouped if b == 8 else at.verify_attn_fused
        ref = at.verify_attn_grouped_plain(q, kv, lengths, scales)
        plan = at.verify_plan(b, 4, 12, 12, 2048, 64)
        print(f"{label} (plan: {plan['splits']} split(s) of "
              f"{plan['warps']} warps, {plan['heads_per_warp']} row(s) a "
              f"warp in {plan['head_groups']} group(s), {plan['blocks']} "
              f"blocks):", flush=True)
        for splits in range(1, 9):
            for warps in (4, 8):
                p = at.verify_plan(b, 4, 12, 12, 2048, 64, splits, warps)
                mark = " (plan)" if (splits, warps) == (
                    plan["splits"], plan["warps"]) else ""
                worst = max(worst, report(
                    scrub, f"  {splits} splits, {warps} warps{mark}",
                    lambda p=p: at._launch_verify(
                        wrapper, q, kv, scales, lengths, None, p),
                    ref, n_bytes, clean=True))
    g = torch.Generator(device="cuda").manual_seed(16)
    for s in (1, 2, 8):
        q, kv, lengths, scales, n_bytes = verify_inputs(g, "bf16", 8, s)
        ref = at.verify_attn_grouped_plain(q, kv, lengths, scales)
        plan = at.verify_plan(8, s, 12, 12, 2048, 64)
        worst = max(worst, report(
            scrub, f"V1 float at (G), S {s} (plan: {plan['splits']} splits "
            f"of {plan['warps']} warps, {plan['heads_per_warp']} x "
            f"{plan['head_groups']} rows)",
            lambda: at.verify_attn_grouped(q, kv, lengths, scales), ref,
            n_bytes, clean=True))

    b, h, kvh, d, cap = 3, 32, 8, 128, 4096
    kv = torch.randint(-127, 128, (b, cap, 2, kvh * d), device="cuda",
                       dtype=torch.int8, generator=g)
    scales = (0.002 + 0.01 * torch.rand((b, cap, 2, kvh), device="cuda",
                                        generator=g)).to(torch.bfloat16)
    q = torch.randn((b, h, d), device="cuda", generator=g)
    lengths = torch.randint(512, 577, (b,), device="cuda", generator=g,
                            dtype=torch.int32)
    n_bytes = (lengths.double().sum().item() * (2 * kvh * d + 2 * kvh * 2)
               + 2 * q.numel() * 4)
    args = (q, kv, scales, lengths)
    ref = at.decode_attn_fused_int8_plain(*args)
    plan = at.rows_plan(b, h, kvh, cap, d)
    print(f"G2 at (H-fused) (plan: {plan['splits']} splits of "
          f"{plan['warps']} warps, {plan['blocks']} blocks):", flush=True)
    for splits in range(1, 9):
        for warps in (4, 8):
            p = at.rows_plan(b, h, kvh, cap, d, splits, warps)
            mark = " (plan)" if (splits, warps) == (
                plan["splits"], plan["warps"]) else ""
            worst = max(worst, report(
                scrub, f"  {splits} splits, {warps} warps{mark}",
                lambda p=p: at._launch_grouped_int8_rows(
                    *args, False, None, plan=p,
                    wrapper=at.decode_attn_fused_int8),
                ref, n_bytes, clean=True))

    g = torch.Generator(device="cuda").manual_seed(17)
    cases = []
    for label, mode in (("V1 float at (G)", "bf16"),
                        ("V1 int8 at (G-int8)", "int8")):
        v_q, v_kv, v_len, v_sc, v_bytes = verify_inputs(g, mode, 8)
        cases.append((label, "verify_attn",
                      lambda v=(v_q, v_kv, v_len, v_sc):
                      at.verify_attn_grouped(*v),
                      at.verify_attn_grouped_plain(v_q, v_kv, v_len, v_sc),
                      v_bytes))
    cases.append(("G2 at (H-fused)", "decode_attn_grouped_int8",
                  lambda: at.decode_attn_fused_int8(*args), ref, n_bytes))
    dirs = build_patched({k: VARIANTS[k] for k in ("shipped", "no_walk",
                                                    "no_copies")},
                         ("verify_attn", "decode_attn_grouped_int8"))
    print("variants of decode_attn_kv_group.cuh at the plan's launch:")
    for name, src in dirs.items():
        for label, lib, fn, c_ref, c_bytes in cases:
            with library(lib, src / f"lib{lib}.so"):
                err = report(scrub, f"  {name}: {label}", fn, c_ref,
                             c_bytes, clean=True)
            if name in HELD:
                worst = max(worst, err)
    q, kv, lengths, scales, n_bytes = verify_inputs(g, "bf16", 8,
                                                    lives=(64, 86))
    worst = max(worst, report(
        scrub, "V1 float at (G), lives 64-85 (plan)",
        lambda: at.verify_attn_grouped(q, kv, lengths, scales),
        at.verify_attn_grouped_plain(q, kv, lengths, scales), n_bytes,
        clean=True))
    one = torch.zeros(1, device="cuda")
    times = [device_ms(scrub, lambda: one.fill_(1.0)) for _ in range(2)]
    print(f"the timer's floor, a one-element fill: "
          + " / ".join(f"{t:.4f}" for t in times) + " ms", flush=True)
    return worst


def append_section(scrub):
    """A1 at (H-append) on a bf16 and an f32 cache: every split count and
    both warp counts, each launch's cache write held bit for bit against
    the plain version's; returns the worst held error."""
    g = torch.Generator(device="cuda").manual_seed(18)
    b, h, kvh, d, cap = 16, 32, 8, 128, 4096
    f = kvh * d
    q = torch.randn((b, h, d), device="cuda", generator=g)
    qkv = torch.randn((b, 1, (h + 2 * kvh) * d), device="cuda", generator=g)
    k = qkv[..., h * d:h * d + f].reshape(b, 1, kvh, d).transpose(1, 2)
    v = qkv[..., h * d + f:].reshape(b, 1, kvh, d).transpose(1, 2)
    lengths = torch.randint(512, 577, (b,), device="cuda", generator=g,
                            dtype=torch.int32)
    plan = at.rows_plan(b, h, kvh, cap, d)
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        kv = torch.randn((b, cap, 2, f), device="cuda",
                         generator=g).to(dtype)
        want = kv.clone()
        ref = at.decode_attn_grouped_append_plain(q, want, k, v, lengths)
        elt = kv.element_size()
        n_bytes = ((lengths - 1).double().sum().item() * 2 * f * elt
                   + 2 * q.numel() * 4 + b * 2 * f * (4 + elt))
        print(f"A1 at (H-append), {str(dtype).split('.')[-1]} cache (plan: "
              f"{plan['splits']} splits of {plan['warps']} warps, "
              f"{plan['heads_per_warp']} row(s) a warp in "
              f"{plan['head_groups']} group(s), {plan['blocks']} blocks):",
              flush=True)
        for splits in range(1, 9):
            for warps in (4, 8):
                p = at.rows_plan(b, h, kvh, cap, d, splits, warps)
                mark = " (plan)" if (splits, warps) == (
                    plan["splits"], plan["warps"]) else ""
                got = kv.clone()
                worst = max(worst, report(
                    scrub, f"  {splits} splits, {warps} warps{mark}",
                    lambda p=p, got=got: at._launch_grouped_append(
                        q, got, k, v, lengths, None, p),
                    ref, n_bytes, clean=True))
                if not torch.equal(got, want):
                    print("    the cache write differs from the plain "
                          "version's", flush=True)
                    worst = float("inf")
    return worst


def _chip_smoke():
    """``chip_smoke.py`` of this checkout, for its inputs and its timer."""
    sys.path.insert(0, str(_build.CSRC.parents[1]))
    import chip_smoke
    return chip_smoke


def _k7_cases():
    """K7's inputs: chip_smoke.py's (B) and (H) cases, each also without
    its all-zero head and with the model's new rows and positions in their
    place; [(label, (k, v, pos, kv, scales))] and chip_smoke.py's timer."""
    cs = _chip_smoke()
    g = torch.Generator(device="cuda").manual_seed(19)
    cases = []
    for name, shape, seed, h in (("(B)", cs.K7_B_SHAPE, 8, 12),
                                 ("(H)", cs.K7_H_SHAPE, 9, cs.H_HEADS)):
        k, v, pos, kv, scales = cs.kv_append_int8_inputs(*shape, False, seed)
        b, kvh, d, cap = shape[:4]
        f = kvh * d
        nz = k.clone()
        nz[0, 0] = torch.randn(nz[0, 0].shape, device="cuda", generator=g)
        qkv = torch.randn((b, 1, (h + 2 * kvh) * d), device="cuda",
                          generator=g)
        mk, mv = (qkv[..., h * d + i * f:h * d + (i + 1) * f]
                  .reshape(b, 1, kvh, d).transpose(1, 2) for i in (0, 1))
        mpos = torch.randint(64, 577, (b,), device="cuda", generator=g,
                             dtype=torch.int32)
        cases += [(f"chip_smoke.py's {name}", (k, v, pos, kv, scales)),
                  (f"{name} without the zero head", (nz, v, pos, kv, scales)),
                  (f"{name}, the model's rows and positions",
                   (mk, mv, mpos, kv, scales))]
    return cases, cs.Timer()


def _turns(lib, dirs, label, cases, timer):
    """Each variant's library (``dirs``: {name: directory}) in two rounds
    of turns on each case ((case label, reset, call, held): ``reset()``
    restores what the call writes, ``call()`` runs the wrapper, ``held()``
    after it says whether its result is the plain version's, None where
    the variant is not held); prints one line a case and returns 0, or inf
    if a held variant's result differs."""
    worst = 0.0
    for case, reset, call, held in cases:
        times = {name: [] for name in dirs}
        for _ in range(2):
            for name, src in dirs.items():
                with library(lib, src / f"lib{lib}.so"):
                    reset()
                    call()
                    ok = held(name)
                    times[name].append(timer(call))
                if ok is False:
                    print(f"  {name} at {case}: not held to the plain "
                          f"version", flush=True)
                    worst = float("inf")
        print(f"{label} at {case}: " + ", ".join(
            f"{name} " + " / ".join(f"{t:.4f}" for t in ts)
            for name, ts in times.items()) + " ms", flush=True)
    return worst


def k7_section():
    """K7's variants at chip_smoke.py's cases and the model's rows and
    positions, in two rounds of turns, with chip_smoke.py's timer; returns
    0, or inf if a held variant's bytes or scales differ from the plain
    version's."""
    dirs = build_patched(K7_VARIANTS, ("kv_append_int8",))
    cases, timer = _k7_cases()
    turns = []
    for label, (k, v, pos, kv, scales) in cases:
        want, want_s = kv.clone(), scales.clone()
        kc.kv_append_int8_plain(want, want_s, k, v, pos)
        got, got_s = kv.clone(), scales.clone()
        turns.append((
            label,
            lambda kv=kv, scales=scales, got=got, got_s=got_s: (
                got.copy_(kv), got_s.copy_(scales)),
            lambda k=k, v=v, pos=pos, got=got, got_s=got_s:
                kc.kv_append_int8(got, got_s, k, v, pos),
            lambda name, got=got, got_s=got_s, want=want, want_s=want_s:
                None if name == "no_divide" else
                torch.equal(got, want) and torch.equal(got_s, want_s)))
    return _turns("kv_append_int8", dirs, "K7", turns, timer)


def p2_section():
    """P2 (``kv_append_paged_int8``) at chip_smoke.py's (D) case, with and
    without its all-zero head, as shipped and as the design before
    (``one_warp_a_row``), in two rounds of turns with chip_smoke.py's
    timer, each held bit for bit; returns 0, or inf if one differs."""
    dirs = build_patched(P2_VARIANTS, ("kv_append_paged",))
    cs = _chip_smoke()
    turns = []
    for label, zero in (("chip_smoke.py's (D)", True),
                        ("(D) without the zero head", False)):
        k, v, lengths, pool, scales, table = cs.kv_append_paged_inputs(
            True, zero)
        want, want_s = pool.clone(), scales.clone()
        kc.kv_append_paged_int8_plain(want, want_s, k, v, table, lengths)
        got, got_s = pool.clone(), scales.clone()
        turns.append((
            label,
            lambda pool=pool, scales=scales, got=got, got_s=got_s: (
                got.copy_(pool), got_s.copy_(scales)),
            lambda k=k, v=v, t=table, n=lengths, got=got, got_s=got_s:
                kc.kv_append_paged_int8(got, got_s, k, v, t, n),
            lambda name, got=got, got_s=got_s, want=want, want_s=want_s:
                torch.equal(got, want) and torch.equal(got_s, want_s)))
    return _turns("kv_append_paged", dirs, "P2", turns, cs.Timer())


def fappend_section():
    """K5 (``kv_append``) at chip_smoke.py's (A) and (C) inputs (f32 and
    bf16 caches) and P1 (``kv_append_paged``) at its (E) inputs, as
    shipped, as the design before (``one_thread_an_element``) and at four
    and sixteen lanes a row (``lanes4``, ``lanes16``), in two rounds of
    turns with chip_smoke.py's timer, each bit for bit against the plain
    version; returns 0, or inf if one differs."""
    dirs = build_patched(FAPPEND_VARIANTS, ("kv_append", "kv_append_paged"))
    cs = _chip_smoke()
    timer = cs.Timer()
    k, v, lengths, caches = cs.kv_append_inputs()
    turns = []
    for (dtype, kv), path in zip(caches, ("(A)", "(C)")):
        want, got = kv.clone(), kv.clone()
        kc.kv_append_plain(want, k, v, lengths)
        turns.append((
            f"chip_smoke.py's {path} ({str(dtype)[6:]} cache)",
            lambda kv=kv, got=got: got.copy_(kv),
            lambda got=got: kc.kv_append(got, k, v, lengths),
            lambda name, got=got, want=want: torch.equal(got, want)))
    worst = _turns("kv_append", dirs, "K5", turns, timer)
    pk, pv, plen, pool, _, table = cs.kv_append_paged_inputs(False)
    want, got = pool.clone(), pool.clone()
    kc.kv_append_paged_plain(want, pk, pv, table, plen)
    turns = [("chip_smoke.py's (E)", lambda: got.copy_(pool),
              lambda: kc.kv_append_paged(got, pk, pv, table, plen),
              lambda name: torch.equal(got, want))]
    return max(worst, _turns("kv_append_paged", dirs, "P1", turns, timer))


def flush_section():
    """K3 (``tail_flush_int8``) at chip_smoke.py's two shapes, t 16 and t 5
    of its 16-row window, as shipped, as the design before
    (``one_warp_a_row``) and at FLUSH_VARIANTS' other variants, in two
    rounds of turns with chip_smoke.py's timer, each but ``no_divide``
    bit for bit against the plain version; returns 0, or inf if one
    differs."""
    dirs = build_patched(FLUSH_VARIANTS, ("tail_flush_int8",))
    cs = _chip_smoke()
    turns = []
    for label, shape in (("int8 + tail shape", {}),
                         ("TinyLlama shape", dict(b=16, kvh=4, cap=2048,
                                                  live=(16, 2000)))):
        tail, kv, scales, lengths = cs.tail_flush_inputs(**shape)
        for t in (16, 5):
            want, want_s = kv.clone(), scales.clone()
            kc.tail_flush_int8_plain(tail, want, want_s, lengths, t)
            got, got_s = kv.clone(), scales.clone()
            turns.append((
                f"chip_smoke.py's {label}, t {t}",
                lambda kv=kv, scales=scales, got=got, got_s=got_s: (
                    got.copy_(kv), got_s.copy_(scales)),
                lambda tail=tail, n=lengths, t=t, got=got, got_s=got_s:
                    kc.tail_flush_int8(tail, got, got_s, n, t),
                lambda name, got=got, got_s=got_s, want=want, want_s=want_s:
                    None if name == "no_divide" else
                    torch.equal(got, want) and torch.equal(got_s, want_s)))
    return _turns("tail_flush_int8", dirs, "K3", turns, cs.Timer())


def k9_section(scrub):
    """K9 (``decode_attn_split_kv``) at chip_smoke.py's inputs on f32 and
    bf16 planes at 1, 2, 4 and 8 splits and blocks of 4 or 8 warps, each
    held to 1e-5 of max |out|; returns the worst held error."""
    q, planes, lengths = _chip_smoke().split_kv_inputs()
    b, h, d = q.shape
    kvh, s = planes[0].shape[1:3]
    rows = lengths.clamp(max=s).double().sum().item()
    plan = at.rows_plan(b, h, kvh, s, d)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        k, v = (x.to(dtype) for x in planes)
        ref = at.decode_attn_split_kv_plain(q, k, v, lengths)
        n_bytes = (rows * 2 * kvh * d * k.element_size()
                   + 2 * q.numel() * 4 + b * 4)
        print(f"K9 on {str(dtype)[6:]} planes at path (H)'s head shape "
              f"(plan: {plan['splits']} splits of {plan['warps']} warps):",
              flush=True)
        for splits in (1, 2, 4, 8):
            for warps in (4, 8):
                p = at.rows_plan(b, h, kvh, s, d, splits, warps)
                mine = (splits, warps) == (plan["splits"], plan["warps"])
                worst = max(worst, report(
                    scrub, f"  K9 splits {splits}, {warps} warps"
                    f"{' (plan)' if mine else ''}",
                    lambda p=p: at._launch_split_kv(q, k, v, lengths, None,
                                                    p),
                    ref, n_bytes))
    return worst


FLIP_SHARE = 0.99


def flip_error(out, ref, step):
    """A rounding mode's error as a share of its tolerance (<= 1 passes):
    chip_smoke.py's criterion, no element past one flipped rounding
    (``step``) and FLIP_SHARE of the elements within 1e-5 of max |out|."""
    err = (out - ref).abs()
    share = err.le(REL_TOL * ref.abs().max()).float().mean().item()
    return max(err.max().item() / step,
               (1.0 - share) / (1.0 - FLIP_SHARE))


def _parent_entry(parent, lib, symbol, argtypes, marker):
    """The C entry ``symbol`` of ``lib`` built from the checkout
    ``parent``'s sources, or None where that source lacks ``marker`` (the
    design before's kernel)."""
    src = parent / "rten_tpu_torch" / "csrc"
    if marker not in (src / f"{lib}.cu").read_text():
        return None
    out = OUT / "parent"
    _wait({lib: _nvcc(src, lib, out)})
    return _entry(ctypes.CDLL(str(out / f"lib{lib}.so")), symbol, argtypes)


def _in_turns(label, calls, timer):
    """Each call ({name: (call, held)}) timed in turns: for a parent and
    this tree, parent, change, change, parent; returns the worst held
    error."""
    names = list(calls)
    order = names + names[::-1]
    times, worst = {name: [] for name in names}, 0.0
    for name in order:
        call, held = calls[name]
        out = call()
        torch.cuda.synchronize()
        worst = max(worst, held(out))
        times[name].append(timer(call))
    print(f"{label}: " + ", ".join(
        f"{name} " + " / ".join(f"{t:.4f}" for t in ts)
        for name, ts in times.items()) + " ms; held error "
        f"{worst:.3f} of the tolerance", flush=True)
    return worst


def native_section(parent):
    """native_dots at chip_smoke.py's inputs ((C)'s shapes, bf16 cache,
    block 64) and timer: this tree's kernel and, with ``parent``, the
    parent's in turns (parent, change, change, parent); then this tree's
    at 4 and 8 warps (one split). Each held to chip_smoke.py's criterion;
    returns the worst held error."""
    cs = _chip_smoke()
    timer = cs.Timer()
    q, kv, lengths = cs.native_dots_inputs()
    b, h, d = q.shape
    cap, kvh = kv.shape[1], kv.shape[3] // d
    ref = at.decode_attn_native_dots_plain(q, kv, lengths)
    step = cs.NATIVE_STEP * kv[:, :, 1].abs().max().item()
    held = lambda out: flip_error(out, ref, step)
    calls = {}
    old = parent and _parent_entry(parent, "decode_attn_float",
                                   "decode_attn_native_dots",
                                   "ppppiiiiiiifp", "native_dots_kernel")
    if old:
        def before():
            out = torch.empty_like(q)
            _build.check(old(q.data_ptr(), kv.data_ptr(), lengths.data_ptr(),
                             out.data_ptr(), b, h, kvh, d, cap, 1, 64,
                             1.0 / d ** 0.5, _build.stream()),
                         "the parent's native_dots")
            return out
        calls["parent"] = (before, held)
    calls["change"] = (lambda: at.decode_attn_native_dots(q, kv, lengths),
                       held)
    worst = _in_turns("native_dots at (C)'s shape", calls, timer)
    for warps in (4, 8):
        plan = at.block_plan(b, h, kvh, cap, 64, d, warps=warps,
                             native=True)
        worst = max(worst, _in_turns(
            f"  native_dots, 1 split, {warps} warps", {"change": (
                lambda p=plan: at._launch_native_dots(q, kv, lengths, 64,
                                                      None, p), held)},
            timer))
    return worst


def pv8_section(parent):
    """G1's pv_int8 at chip_smoke.py's inputs ((H)'s shapes, block 64) and
    timer, exact q and int8 scores: this tree's kernel and, with
    ``parent``, the parent's in turns (parent, change, change, parent);
    then this tree's at 1, 2, 4 and 8 splits and 4 or 8 warps. Each held
    to chip_smoke.py's criterion; returns the worst held error."""
    cs = _chip_smoke()
    timer = cs.Timer()
    q, kv, scales, lengths = cs.pv_int8_inputs()
    b, h, d = q.shape
    cap, kvh = kv.shape[1], kv.shape[3] // d
    step = cs.PV_INT8_STEP * scales[:, :, 1].float().max().item() * 127
    old = parent and _parent_entry(parent, "decode_attn_grouped_int8",
                                   "decode_attn_pv_int8", "pppppiiiiiiifp",
                                   "pv_int8_kernel")
    worst = 0.0
    for scores in (False, True):
        kw = dict(int8_scores=scores, pv_int8=True)
        ref = at.decode_attn_grouped_int8_plain(q, kv, scales, lengths, **kw)
        held = lambda out, ref=ref: flip_error(out, ref, step)
        calls = {}
        if old:
            def before(scores=scores):
                out = torch.empty_like(q)
                _build.check(old(q.data_ptr(), kv.data_ptr(),
                                 scales.data_ptr(), lengths.data_ptr(),
                                 out.data_ptr(), b, h, kvh, d, cap,
                                 int(scores), 64, 1.0 / d ** 0.5,
                                 _build.stream()), "the parent's pv_int8")
                return out
            calls["parent"] = (before, held)
        calls["change"] = (lambda kw=kw: at.decode_attn_grouped_int8(
            q, kv, scales, lengths, **kw), held)
        mode = "int8 scores" if scores else "exact q"
        worst = max(worst, _in_turns(f"pv_int8 ({mode}) at (H)'s shape",
                                     calls, timer))
        plan = at.block_plan(b, h, kvh, cap, 64, d)
        for splits in (1, 2, 4, 8):
            for warps in (4, 8):
                p = at.block_plan(b, h, kvh, cap, 64, d, splits, warps)
                mine = (splits, warps) == (plan["splits"], plan["warps"])
                worst = max(worst, _in_turns(
                    f"  pv_int8 ({mode}), {splits} splits, {warps} warps"
                    f"{' (plan)' if mine else ''}", {"change": (
                        lambda p=p, scores=scores: at._launch_pv_int8(
                            q, kv, scales, lengths, scores, None, 64, p),
                        held)}, timer))
    return worst


def partials_error(out, ref, d, q_bf16):
    """The partials mode's error as a share of chip_smoke.py's tolerance
    (<= 1 passes): m and l within 1e-5 of their largest, acc within 1e-5 of
    max |acc| (exact q) or, rounded to bf16, every element within one bf16
    step of its value plus 1e-5 of max |acc| and 99.9% within 2e-5."""
    def rel(sl):
        return ((out[..., sl] - ref[..., sl]).abs().max().item()
                / ref[..., sl].abs().max().item() / REL_TOL)
    worst = max(rel(d), rel(d + 1))
    acc, racc = out[..., :d], ref[..., :d]
    if not q_bf16:
        return max(worst, rel(slice(0, d)))
    top = racc.abs().max().item()
    err = (acc - racc).abs()
    over = (err - 2.0 ** -7 * racc.abs()).max().item() / (REL_TOL * top)
    share = err.le(2e-5 * top).float().mean().item()
    return max(worst, over, (1.0 - share) / 0.001)


def partials_section(parent):
    """The partials mode at chip_smoke.py's inputs and timer (path (B)'s
    shape with q_bf16 on and off, TinyLlama's with q_bf16): this tree's
    kernel (the KV-group kernel at rows_plan) and, with ``parent``, the
    parent's in turns (parent, change, change, parent: the design before,
    the kernel of K1 and K1' in its partials mode through its own C entry,
    with its scratch and second launch where it splits); then K1 (window
    fill 9 of 16) and K1' at path (B)'s shape, whose source lost the
    partials mode, against the parent's the same way, and K1' at V1's
    decode shapes (B 8 and 3, capacity 2048); and the partials at
    TinyLlama's shape at 1-8 splits x 4/8 warps. Returns the worst held
    error."""
    cs = _chip_smoke()
    timer = cs.Timer()
    old = parent and _parent_entry(parent, "decode_attn_int8_tail",
                                   "decode_attn_int8_tail",
                                   "pppppppiiiiiiiiiiifp", "int partials")
    worst = 0.0
    for shape, q_bf16 in (("b", True), ("b", False), ("gqa", True)):
        q, kv, scales, lengths = cs.partials_inputs(
            **cs.PARTIALS_SHAPES[shape])
        b, h, d = q.shape
        cap, kvh = kv.shape[1], kv.shape[3] // d
        ref = at.decode_attn_int8_partials_plain(q, kv, scales, lengths,
                                                 q_bf16)
        held = lambda out, ref=ref, q_bf16=q_bf16: partials_error(
            out, ref, d, q_bf16)
        calls = {}
        if old:
            def before(q=q, kv=kv, scales=scales, lengths=lengths,
                       q_bf16=q_bf16):
                b, h, d = q.shape
                chunk, splits = at.int8_chunks(b, h, kv.shape[1])
                out = torch.empty((b, h, d + 2), device="cuda")
                part = (torch.empty((b, h, splits, d + 2), device="cuda")
                        if splits > 1 else None)
                _build.check(old(
                    q.data_ptr(), kv.data_ptr(), scales.data_ptr(),
                    lengths.data_ptr(), None, out.data_ptr(),
                    None if part is None else part.data_ptr(), b, h,
                    kv.shape[3] // d, d, kv.shape[1], 0, 0, chunk, splits, 1,
                    int(q_bf16), 1.0 / d ** 0.5, _build.stream()),
                    "the parent's partials")
                return out
            calls["parent"] = (before, held)
        calls["change"] = (
            lambda q=q, kv=kv, scales=scales, lengths=lengths, q_bf16=q_bf16:
            at.decode_attn_int8_partials(q, kv, scales, lengths, q_bf16),
            held)
        worst = max(worst, _in_turns(
            f"partials (q_bf16 {q_bf16}) at B {b}, H {h} over {kvh}, "
            f"capacity {cap}", calls, timer))
    # K1 and K1' against the parent's source: at path (B)'s shape, and K1'
    # at V1's decode shapes (chip_smoke.py's decode_ms: B 8 and B 3, a split
    # launch and the merge), two rounds of turns each.
    g = torch.Generator(device="cuda").manual_seed(33)
    k1_cases = [("K1", cs.PARTIALS_SHAPES["b"], True),
                ("K1'", cs.PARTIALS_SHAPES["b"], False)]
    k1_cases += [("K1'", dict(b=b, h=12, kvh=12, cap=2048, lives=(65, 322)),
                  False) for b in (8, 3)]
    for name, shape, with_tail in k1_cases:
        q, kv, scales, lengths = cs.partials_inputs(**shape)
        b, h, d = q.shape
        cap, kvh = kv.shape[1], kv.shape[3] // d
        window = (torch.randn((b, 16, 2, kvh * d), device="cuda",
                              generator=g).to(torch.bfloat16)
                  if with_tail else None)
        count, rows = (9, 16) if with_tail else (0, 0)
        ref = at.decode_attn_int8_tail_plain(q, kv, scales, lengths, window,
                                             count)
        held = lambda out, ref=ref: ((out - ref).abs().max().item()
                                     / ref.abs().max().item()
                                     / cs.K1_REL_TOL)
        calls = {}
        if old:
            def before(q=q, kv=kv, scales=scales, lengths=lengths,
                       window=window, count=count, rows=rows):
                b, h, d = q.shape
                cap, kvh = kv.shape[1], kv.shape[3] // d
                chunk, splits = at.int8_chunks(b, h, cap + rows)
                out = torch.empty_like(q)
                part = (torch.empty((b, h, splits, d + 2), device="cuda")
                        if splits > 1 else None)
                _build.check(old(
                    q.data_ptr(), kv.data_ptr(), scales.data_ptr(),
                    lengths.data_ptr(),
                    None if window is None else window.data_ptr(),
                    out.data_ptr(), None if part is None else part.data_ptr(),
                    b, h, kvh, d, cap, rows, count, chunk, splits, 0, 1,
                    1.0 / d ** 0.5, _build.stream()), f"the parent's {name}")
                return out
            calls["parent"] = (before, held)
        calls["change"] = (
            (lambda q=q, kv=kv, scales=scales, lengths=lengths, w=window:
             at.decode_attn_int8_tail(q, kv, scales, lengths, w, 9))
            if with_tail else
            (lambda q=q, kv=kv, scales=scales, lengths=lengths:
             at.decode_attn_int8(q, kv, scales, lengths)), held)
        for _ in range(2):
            worst = max(worst, _in_turns(
                f"{name} at B {b}, H {h}, capacity {cap}", calls, timer))
    q, kv, scales, lengths = cs.partials_inputs(**cs.PARTIALS_SHAPES["gqa"])
    b, h, d = q.shape
    cap, kvh = kv.shape[1], kv.shape[3] // d
    ref = at.decode_attn_int8_partials_plain(q, kv, scales, lengths, True)
    held = lambda out: partials_error(out, ref, d, True)
    plan = at.rows_plan(b, h, kvh, cap, d)
    for splits in (1, 2, 4, 8):
        for warps in (4, 8):
            p = at.rows_plan(b, h, kvh, cap, d, splits, warps)
            mine = (splits, warps) == (plan["splits"], plan["warps"])
            worst = max(worst, _in_turns(
                f"  partials at TinyLlama's shape, {splits} splits, {warps} "
                f"warps{' (plan)' if mine else ''}", {"change": (
                    lambda p=p: at._launch_grouped_int8_rows(
                        q, kv, scales, lengths, False, None, plan=p,
                        wrapper=at.decode_attn_int8_partials, q_bf16=True),
                    held)},
                timer))
    return worst


# M1's variants (csrc/matmul_int8.cu), each a patch of the shipped source:
# where the steady state's time goes at M 4096.
M1_SRC = "matmul_int8.cu"
M1_UNITS = ("        for (int it = 0; it < (BK / 16) * QUADS / TRANSPOSERS; "
            "++it) {\n")
M1_RELEASE = ("        wgmma_wait<0>();\n"
              "        if (lane == 0) mbar_arrive(empty(s));\n      }\n")
M1_VARIANTS = {
    "shipped": [],
    # Three stages, not four.
    "stages3": [(M1_SRC, "constexpr int STAGES = 4;",
                 "constexpr int STAGES = 3;")],
    # A thread's units of a stage one after the other (the first design).
    "units_in_turn": [(M1_SRC, "#pragma unroll\n" + M1_UNITS,
                       "#pragma unroll 1\n" + M1_UNITS)],
    # One stage's products in flight: the stage before released once the
    # next stage's are issued.
    "group_in_flight": [(M1_SRC, M1_RELEASE,
                         "        wgmma_wait<1>();\n"
                         "        if (i > 0 && lane == 0) "
                         "mbar_arrive(empty((g - 1) % STAGES));\n      }\n"
                         "      wgmma_wait<0>();\n"
                         "      if (nt > 0 && lane == 0) "
                         "mbar_arrive(empty((g - 1) % STAGES));\n")],
    # No transpose (wrong results): the copies, the barriers and wgmma.
    "no_transpose": [(M1_SRC, M1_UNITS,
                      "        for (int it = 0; it < 0; ++it) {\n")],
    # No wgmma (wrong results): the copies, the transpose and the epilogue.
    "no_wgmma": [(M1_SRC, "for (int kk = 0; kk < BK / 32; ++kk) {",
                  "for (int kk = 0; kk < 0; ++kk) {")],
}


def m1_variants(timer):
    """M1's source variants (M1_VARIANTS) at GPT-2's up and down linears at
    M 4096 and at M 256, two rounds of turns with chip_smoke.py's timer;
    each but no_transpose and no_wgmma held bit for bit. Returns 0, or inf
    if a held variant's result differs."""
    from rten_tpu_torch.kernels import gemm
    dirs = build_patched(M1_VARIANTS, ["matmul_int8"])
    g = torch.Generator(device="cuda").manual_seed(37)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = []
    for m, k, n in ((4096, 768, 3072), (4096, 3072, 768), (256, 768, 2304),
                    (256, 3072, 768)):
        x = torch.randint(-127, 128, (m, k), device="cuda",
                          dtype=torch.int8, generator=g)
        w = torch.randint(-127, 128, (k, n), device="cuda",
                          dtype=torch.int8, generator=g)
        ws = 0.001 + 0.01 * torch.rand(n, device="cuda", generator=g)
        xs = torch.tensor([0.0173], device="cuda")
        ref = gemm.matmul_int8_tiled_plain(x, w, xs, ws)
        plan = gemm.matmul_int8_plan(m, k, n, sms)
        got = {}

        def call(x=x, w=w, ws=ws, plan=plan, got=got):
            got["out"] = gemm._launch_int8_tiled(x, w, xs, ws, plan)

        def held(name, ref=ref, got=got):
            if name in ("no_transpose", "no_wgmma"):
                return None
            torch.cuda.synchronize()
            return torch.equal(got["out"], ref)

        cases.append((f"M {m}, K {k}, N {n}", lambda: None, call, held))
    # Each variant once on each case, named before it runs: a fault is
    # reported at the next synchronize, and ends the process.
    for name, src in dirs.items():
        print(f"M1's variant {name}: checking", flush=True)
        with library("matmul_int8", src / "libmatmul_int8.so"):
            for case, _, call, held in cases:
                call()
                torch.cuda.synchronize()
                if held(name) is False:
                    print(f"  {name} at {case}: not held to the plain "
                          f"version", flush=True)
    return _turns("matmul_int8", dirs, "M1's variants", cases, timer)


def m1_section(parent):
    """M1 (``matmul_int8_tiled``) at chip_smoke.py's GPT-2 linears (M 256
    and 4096) and timer, bit for bit: this tree's kernel and, with
    ``parent``, the parent's (the design before, mma.sync through its own C
    entry) in turns (parent, change, change, parent), beside the library
    call (``torch._int_mm`` and the epilogue); then this tree's at M 256
    with 64- and 128-column tiles and 1-8 K splits, and at M 4096 with a
    block a tile instead of one an SM walking the tiles; then the source's
    variants (:func:`m1_variants`). Returns 0, or inf if a result is not
    the plain version's bits."""
    from rten_tpu_torch.kernels import gemm
    cs = _chip_smoke()
    timer = cs.Timer()
    old = parent and _parent_entry(parent, "matmul_int8", "matmul_int8",
                                   "pppppiiip", "mma.sync.aligned.m16n8k32")
    g = torch.Generator(device="cuda").manual_seed(36)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    worst = 0.0
    for m in (256, 4096):
        for k, n in cs.GPT2_LINEARS:
            x = torch.randint(-127, 128, (m, k), device="cuda",
                              dtype=torch.int8, generator=g)
            w = torch.randint(-127, 128, (k, n), device="cuda",
                              dtype=torch.int8, generator=g)
            ws = 0.001 + 0.01 * torch.rand(n, device="cuda", generator=g)
            xs = torch.tensor([0.0173], device="cuda")
            ref = gemm.matmul_int8_tiled_plain(x, w, xs, ws)
            held = lambda out, ref=ref: 0.0 if torch.equal(out, ref)                 else float("inf")
            calls = {}
            if old:
                def before(x=x, w=w, ws=ws, m=m, k=k, n=n):
                    out = torch.empty((m, n), device="cuda")
                    _build.check(old(x.data_ptr(), w.data_ptr(),
                                     xs.data_ptr(), ws.data_ptr(),
                                     out.data_ptr(), m, n, k,
                                     _build.stream()), "the parent's M1")
                    return out
                calls["parent"] = (before, held)
            calls["change"] = (lambda x=x, w=w, ws=ws: gemm.matmul_int8_tiled(
                x, w, xs, ws), held)
            calls["library"] = (lambda x=x, w=w, ws=ws: torch._int_mm(x, w).to(
                torch.float32) * xs * ws[None, :], lambda out: 0.0)
            plan = gemm.matmul_int8_plan(m, k, n, sms)
            worst = max(worst, _in_turns(
                f"M1 at M {m}, K {k}, N {n} ({plan['bn']}-column tiles, "
                f"{plan['splits']} split(s), {plan['blocks']} blocks)", calls,
                timer))
            if m != 256:
                worst = max(worst, _in_turns(
                    f"  M1 at M {m}, K {k}, N {n}, a block a tile ("
                    f"{plan['tiles']} blocks, not {plan['workers']} in turn)",
                    {"change": (lambda x=x, w=w, ws=ws, p=dict(
                        plan, workers=plan["tiles"]): gemm._launch_int8_tiled(
                            x, w, xs, ws, p), held)}, timer))
                continue
            for bn in (64, 128):
                for splits in (1, 2, 4, 8):
                    p = gemm.matmul_int8_plan(m, k, n, sms, splits)
                    if splits > p["most"]:
                        continue
                    p = dict(p, bn=bn)
                    mine = (bn, splits) == (plan["bn"], plan["splits"])
                    worst = max(worst, _in_turns(
                        f"  M1 at M {m}, K {k}, N {n}, {bn}-column tiles, "
                        f"{splits} split(s){' (plan)' if mine else ''}",
                        {"change": (lambda x=x, w=w, ws=ws, p=p:
                                    gemm._launch_int8_tiled(x, w, xs, ws, p),
                                    held)}, timer))
    return max(worst, m1_variants(timer))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--skip",
                        choices=("int8", "float", "verify", "append",
                                 "k7", "p2", "fappend", "flush", "k9",
                                 "native", "pv8", "partials", "m1"),
                        action="append",
                        default=[], help="leave a section out")
    parser.add_argument("--parent", type=Path, default=None,
                        help="a checkout whose native_dots, pv_int8, "
                        "partials, K1, K1' and M1 kernels the native, pv8, "
                        "partials and m1 sections time in turns")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("kv_group_variants: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    _build.build_all()
    scrub = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device="cuda")
    worst = 0.0
    if "float" not in args.skip:
        worst = max(worst, float_section(scrub))
    if "int8" not in args.skip:
        worst = max(worst, int8_section(scrub))
    if "verify" not in args.skip:
        worst = max(worst, verify_section(scrub))
    if "append" not in args.skip:
        worst = max(worst, append_section(scrub))
    if "k7" not in args.skip:
        worst = max(worst, k7_section())
    if "p2" not in args.skip:
        worst = max(worst, p2_section())
    if "fappend" not in args.skip:
        worst = max(worst, fappend_section())
    if "flush" not in args.skip:
        worst = max(worst, flush_section())
    if "k9" not in args.skip:
        worst = max(worst, k9_section(scrub))
    if "native" not in args.skip:
        worst = max(worst, native_section(args.parent))
    if "pv8" not in args.skip:
        worst = max(worst, pv8_section(args.parent))
    if "partials" not in args.skip:
        worst = max(worst, partials_section(args.parent))
    if "m1" not in args.skip:
        worst = max(worst, m1_section(args.parent))
    print(f"worst error {worst:.3f} of the tolerance")
    return 0 if worst <= 1.0 else 1


if __name__ == "__main__":
    sys.exit(main())
