// Row layout helpers of the decode attention kernels. The eight-lanes-a-row
// layout (kLanesPerTok lanes share a token row, each holding D / 8 values)
// serves the int8 kernel (decode_attn_int8_tail.cu: its four-warp block,
// kWarps and kThreads, and load_row) and, through its conventions, the
// KV-group kernel (decode_attn_kv_group.cuh: P3i, P3 and its grid mode,
// G1 with pv_int8 or without, G2, K6, K8, native_dots, V1, A1 and K9), whose
// kFlat and kNative modes round with bf16_round.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace decode_attn {

constexpr int kWarps = 4, kThreads = 32 * kWarps;

__device__ inline float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The row layout of the int8 kernel (decode_attn_int8_tail.cu): eight
// lanes share a token row, each holding kDpl = d / 8 values (8 or 16), so
// one warp load covers four rows.
constexpr int kLanesPerTok = 8;
constexpr int kTokPerLoad = 32 / kLanesPerTok;

// kDpl consecutive values of a row as f32, in 8- to 64-byte vector loads.
template <int kDpl>
__device__ inline void load_row(const int8_t* p, float* x) {
  static_assert(kDpl == 8 || kDpl == 16, "8 or 16 values a lane");
  if constexpr (kDpl == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = (float)v[i];
  } else {
    const int4 raw = *reinterpret_cast<const int4*>(p);
    const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 16; ++i) x[i] = (float)v[i];
  }
}

template <int kDpl>
__device__ inline void load_row(const __nv_bfloat16* p, float* x) {
#pragma unroll
  for (int c = 0; c < kDpl / 8; ++c) {
    const int4 raw = *reinterpret_cast<const int4*>(p + 8 * c);
    const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) x[8 * c + i] = __bfloat162float(v[i]);
  }
}

}  // namespace decode_attn
