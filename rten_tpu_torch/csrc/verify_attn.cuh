// quantize_q: the KV-group kernel's row quantization of q in its
// int8-scores modes (decode_attn_kv_group.cuh: G1 with int8 scores, with
// pv_int8 or without), on the eight-lanes-a-row layout of decode_attn.cuh. The file kept its name from V1's first kernel; V1, G1,
// G2 and A1 now run on the KV-group kernel.
#pragma once
#include "decode_attn.cuh"

namespace verify_rows {

using decode_attn::kLanesPerTok;

// kScores: the row quantization of q, the eight lanes of a row each
// holding kDpl of its values: qs = absmax / 127 (1 where the row is 0), q8 =
// clip(rint(q / qs), -127, 127) packed into kDpl / 4 words; returns qs.
template <int kDpl>
__device__ inline float quantize_q(const float* qv, int* qw) {
  float amax = 0.0f;
#pragma unroll
  for (int j = 0; j < kDpl; ++j) amax = fmaxf(amax, fabsf(qv[j]));
#pragma unroll
  for (int o = 1; o < kLanesPerTok; o <<= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float qs = amax == 0.0f ? 1.0f : amax / 127.0f;
#pragma unroll
  for (int w = 0; w < kDpl / 4; ++w) {
    unsigned word = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x =
          fminf(fmaxf(rintf(qv[4 * w + i] / qs), -127.0f), 127.0f);
      word |= ((unsigned)(int)x & 0xffu) << (8 * i);
    }
    qw[w] = (int)word;
  }
  return qs;
}

}  // namespace verify_rows
