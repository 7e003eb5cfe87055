// Per-(token, plane, head) symmetric int8 quantization of one head row in
// eight lanes (four rows a warp, the values in registers):
// quantize_row_lanes8, the arithmetic of kv_append.cuh's int8 row policy
// (K3: bf16 window rows, K7 and P2: f32 decode rows), and its helpers
// row_scale and quantize_value (the policy's narrow instance). They compute
//
//   absmax over the row (shuffles within the row's eight lanes),
//   scale = bf16_rn(absmax / 127), or 1.0 where absmax == 0,
//   q = clamp(rint(x / f32(scale)), -127, 127)
//
// bit for bit with kv_cache.py::_quantize_tokens: IEEE division
// (__fdiv_rn) and round-half-even (rintf). A file that includes this must
// not be compiled with -use_fast_math.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace kvquant {

__device__ inline float to_float(float x) { return x; }
__device__ inline float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The scale of a row of absmax amax, and value x quantized with the
// scale's f32 value sf.
__device__ inline __nv_bfloat16 row_scale(float amax) {
  return __float2bfloat16_rn(amax == 0.0f ? 1.0f : __fdiv_rn(amax, 127.0f));
}
__device__ inline int quantize_value(float x, float sf) {
  return (int)fminf(fmaxf(rintf(__fdiv_rn(x, sf)), -127.0f), 127.0f);
}

// Eight lanes a row: lane slot (lane % 8) holds x[0, kDpl), values slot *
// kDpl .. of the row (so the row has 8 * kDpl values). The absmax takes
// three shuffles within the row's eight lanes, so all 32 lanes of the
// warp must call it, four rows at once. Packs the lane's bytes into
// w[kDpl / 4] (byte i of word j is value 4j + i) and returns the row's
// scale. The max is exact in any order, so the scale and the bytes are
// _quantize_tokens' bit for bit.
template <int kDpl>
__device__ inline __nv_bfloat16 quantize_row_lanes8(const float* x,
                                                    uint32_t* w) {
  static_assert(kDpl % 4 == 0, "whole words a lane");
  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < kDpl; ++i) amax = fmaxf(amax, fabsf(x[i]));
#pragma unroll
  for (int o = 1; o < 8; o <<= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  // An all-zero row divides nothing: IEEE division takes its slow path for
  // a zero dividend, and one such head among 256 rows cost K7 0.0017 ms at
  // path (H)'s shape on an H100 (PERF.md). Its bytes are 0, its scale 1.0.
  if (amax == 0.0f) {
#pragma unroll
    for (int j = 0; j < kDpl / 4; ++j) w[j] = 0;
    return __float2bfloat16_rn(1.0f);
  }
  const __nv_bfloat16 sb = row_scale(amax);
  const float sf = __bfloat162float(sb);
#pragma unroll
  for (int j = 0; j < kDpl / 4; ++j) {
    uint32_t word = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      word |= ((uint32_t)quantize_value(x[4 * j + i], sf) & 0xffu)
              << (8 * i);
    w[j] = word;
  }
  return sb;
}

}  // namespace kvquant
