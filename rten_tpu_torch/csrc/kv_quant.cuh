// Per-(token, plane, head) symmetric int8 quantization of one head row,
// shared by tail_flush_int8.cu (bf16 window rows) and kv_append_int8.cu
// (f32 decode rows). One warp quantizes one row of d values:
//
//   absmax over the row (warp shuffles),
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

// All 32 lanes of the warp must call it. Writes dst[0, d) and, from lane
// 0, *scale.
template <typename In>
__device__ inline void quantize_row(const In* __restrict__ src,
                                    int8_t* __restrict__ dst,
                                    __nv_bfloat16* __restrict__ scale,
                                    int d) {
  const int lane = threadIdx.x & 31;
  float amax = 0.0f;
  for (int i = lane; i < d; i += 32)
    amax = fmaxf(amax, fabsf(to_float(src[i])));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const __nv_bfloat16 sb =
      __float2bfloat16_rn(amax == 0.0f ? 1.0f : __fdiv_rn(amax, 127.0f));
  const float sf = __bfloat162float(sb);
  for (int i = lane; i < d; i += 32) {
    const float q = rintf(__fdiv_rn(to_float(src[i]), sf));
    dst[i] = (int8_t)fminf(fmaxf(q, -127.0f), 127.0f);
  }
  if (lane == 0) *scale = sb;
}

}  // namespace kvquant
