// Helpers of the int8 decode walks, eight lanes a row (the row layout of
// decode_attn.cuh): the score modes, quantize_q (kScores: q row-quantized in
// the kernel) and load_words, used by the KV-group kernel
// (decode_attn_kv_group.cuh) and decode_attn_grouped_int8.cu's pv_int8 walk.
// The file kept its name from V1's first kernel; V1, G1, G2 and A1 now run
// on the KV-group kernel.
#pragma once
#include "decode_attn.cuh"

namespace verify_rows {

using decode_attn::kLanesPerTok;

// The score modes of the int8 walks: exact q, or q row-quantized
// (quantize_q) with int32 dots.
enum Mode { kExact = 1, kScores = 2 };

// kDpl int8 values as kDpl / 4 packed words (byte i of word w = value
// 4w + i), in one 8- or 16-byte load.
template <int kDpl>
__device__ inline void load_words(const int8_t* p, int* w) {
  if constexpr (kDpl == 8) {
    const int2 raw = *reinterpret_cast<const int2*>(p);
    w[0] = raw.x;
    w[1] = raw.y;
  } else {
    const int4 raw = *reinterpret_cast<const int4*>(p);
    w[0] = raw.x;
    w[1] = raw.y;
    w[2] = raw.z;
    w[3] = raw.w;
  }
}

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
