// Single-query decode attention over a contiguous float cache [B, cap, 2,
// KVH*D] (f32 or bf16) with the cache append fused, one block of four warps
// per (sequence, query head), eight lanes a row (the row layout of
// decode_attn.cuh): the kernel of decode_attn_append.cu (A1). V1 (verify),
// G1 and G2 left it for the KV-group kernel (decode_attn_kv_group.cuh);
// the helpers quantize_q and load_words and the score modes below serve
// that kernel and decode_attn_grouped_int8.cu's pv_int8 walk.
//
// Contract: query head h of sequence b (kv head h / (H / KVH)) reads rows
// t < n = min(max(lengths[b], 0), cap) (lengths count the new token); a
// sequence with lengths 0 gets zeros. q f32 [B, H, D], out f32 [B, H, D].
// The cache is read as f32: s_t = (q . k_t) * scale, out = sum_t p_t v_t /
// max(sum_t p_t, 1e-30) in f32 with p_t = exp(s_t - max s). The new K/V
// row (f32 rows new_k/new_v [B, KVH*D] with row strides k_stride/v_stride)
// is cast to the cache dtype (bf16 rounds to nearest even) and written at
// pos = clip(lengths - 1, 0, cap - 1) by the first query head of each kv
// head; every block reads row n - 1 = pos from the new row itself, never
// from the cache, so no block waits for the write.
//
// Design: a warp owns every fourth pass of kTokPerLoad * kUnroll rows; the
// eight lanes of a row each hold d / 8 values from one vector load, reduce
// the row's dot by shuffles and keep an online softmax in registers, so the
// score row never sits in shared memory and capacity is unlimited. The
// warps' states merge once at the end through shared memory.
#pragma once
#include "decode_attn.cuh"

namespace verify_rows {

using decode_attn::kLanesPerTok;
using decode_attn::kThreads;
using decode_attn::kTokPerLoad;
using decode_attn::kWarps;
using decode_attn::load_row;

// The score modes of the int8 walks: exact q, or q row-quantized
// (quantize_q) with int32 dots.
enum Mode { kExact = 1, kScores = 2 };

__device__ inline float round_to(float x, float*) { return x; }
__device__ inline float round_to(float x, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ inline void store(float* dst, float x) { *dst = x; }
__device__ inline void store(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16_rn(x);
}

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

template <typename T, int kDpl>
__global__ void __launch_bounds__(kThreads)
    append_kernel(const float* __restrict__ q, T* __restrict__ kv,
                  const float* __restrict__ new_k,
                  const float* __restrict__ new_v, int k_stride,
                  int v_stride, const int* __restrict__ lengths,
                  float* __restrict__ out, int heads, int kvh, int cap,
                  float scale) {
  constexpr int d = kLanesPerTok * kDpl;
  constexpr int kUnroll = kDpl == 8 ? 4 : 2;       // row loads per pass
  constexpr int kWarpTok = kTokPerLoad * kUnroll;  // rows per warp pass
  __shared__ float m_s[kWarps], l_s[kWarps];
  __shared__ float acc_s[kWarps][d];
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane / kLanesPerTok, col = (lane % kLanesPerTok) * kDpl;
  const int rep = heads / kvh, kh = h / rep;
  const long long f = (long long)kvh * d;
  const int len = max(lengths[b], 0);
  const int n = min(len, cap);  // rows the query reads

  float qv[kDpl], acc[kDpl];
  float m = -INFINITY, l = 0.0f;
  const float* qrow = q + ((long long)b * heads + h) * d + col;
#pragma unroll
  for (int j = 0; j < kDpl; ++j) {
    qv[j] = qrow[j];
    acc[j] = 0.0f;
  }

  T* rows = kv + (long long)b * cap * 2 * f;
  const float* nk = new_k + (long long)b * k_stride + (long long)kh * d;
  const float* nv = new_v + (long long)b * v_stride + (long long)kh * d;
  if (h % rep == 0) {
    const int pos = min(max(len - 1, 0), cap - 1);
    T* dst = rows + (long long)pos * 2 * f + (long long)kh * d;
    for (int i = threadIdx.x; i < d; i += kThreads) {
      store(dst + i, nk[i]);
      store(dst + f + i, nv[i]);
    }
  }

  const T* base = rows + (long long)kh * d + col;
  for (int t0 = warp * kWarpTok; t0 < n; t0 += kWarps * kWarpTok) {
    float kk[kUnroll][kDpl], vv[kUnroll][kDpl];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u * kTokPerLoad + grp;
#pragma unroll
      for (int j = 0; j < kDpl; ++j) kk[u][j] = vv[u][j] = 0.0f;
      if (t >= n) continue;
      if (t == n - 1) {
#pragma unroll
        for (int j = 0; j < kDpl; ++j) {
          kk[u][j] = round_to(nk[col + j], (T*)nullptr);
          vv[u][j] = round_to(nv[col + j], (T*)nullptr);
        }
        continue;
      }
      const T* r = base + (long long)t * 2 * f;
      load_row<kDpl>(r, kk[u]);
      load_row<kDpl>(r + f, vv[u]);
    }
    float sc[kUnroll];
    float tile_max = -INFINITY;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u * kTokPerLoad + grp;
      float dot = 0.0f;
#pragma unroll
      for (int j = 0; j < kDpl; ++j) dot += qv[j] * kk[u][j];
#pragma unroll
      for (int o = 1; o < kLanesPerTok; o <<= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      sc[u] = t < n ? dot * scale : -INFINITY;
      tile_max = fmaxf(tile_max, sc[u]);
    }
#pragma unroll
    for (int o = kLanesPerTok; o < 32; o <<= 1)
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, o));
    // Row t0 < n is live, so m_new is finite but for scores of -inf.
    const float m_new = fmaxf(m, tile_max);
    if (m_new == -INFINITY) continue;
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int j = 0; j < kDpl; ++j) acc[j] *= alpha;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float p = expf(sc[u] - m_new);
      l += p;
#pragma unroll
      for (int j = 0; j < kDpl; ++j) acc[j] += p * vv[u][j];
    }
    m = m_new;
  }

  // Sum l and acc over the warp's four row groups (m is warp-uniform),
  // then merge the warps through shared memory.
#pragma unroll
  for (int o = kLanesPerTok; o < 32; o <<= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, o);
#pragma unroll
    for (int j = 0; j < kDpl; ++j)
      acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], o);
  }
  if (lane == 0) {
    m_s[warp] = m;
    l_s[warp] = l;
  }
  if (grp == 0) {
#pragma unroll
    for (int j = 0; j < kDpl; ++j) acc_s[warp][col + j] = acc[j];
  }
  __syncthreads();
  // A warp that saw no live row has m = -inf and weighs exp(-inf) = 0; a
  // sequence with no live row gets zeros.
  float mx = -INFINITY;
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w]);
  for (int c = threadIdx.x; c < d; c += kThreads) {
    float sum = 0.0f, o = 0.0f;
    if (mx != -INFINITY) {
      for (int w = 0; w < kWarps; ++w) {
        const float cw = expf(m_s[w] - mx);
        sum += l_s[w] * cw;
        o += acc_s[w][c] * cw;
      }
    }
    out[((long long)b * heads + h) * d + c] = o / fmaxf(sum, 1e-30f);
  }
}

template <typename T>
cudaError_t launch_append(const void* q, void* kv, const void* new_k,
                          const void* new_v, int k_stride, int v_stride,
                          const void* lengths, void* out, int batch,
                          int heads, int kvh, int d, int cap, float scale,
                          cudaStream_t stream) {
  if (d != 64 && d != 128) return cudaErrorInvalidValue;
  if (batch > 0 && heads > 0) {
    const dim3 grid(heads, batch);
    if (d == 64)
      append_kernel<T, 8><<<grid, kThreads, 0, stream>>>(
          (const float*)q, (T*)kv, (const float*)new_k, (const float*)new_v,
          k_stride, v_stride, (const int*)lengths, (float*)out, heads, kvh,
          cap, scale);
    else
      append_kernel<T, 16><<<grid, kThreads, 0, stream>>>(
          (const float*)q, (T*)kv, (const float*)new_k, (const float*)new_v,
          k_stride, v_stride, (const int*)lengths, (float*)out, heads, kvh,
          cap, scale);
  }
  return cudaGetLastError();
}

}  // namespace verify_rows
