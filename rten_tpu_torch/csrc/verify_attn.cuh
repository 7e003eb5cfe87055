// Attention for a few queries per sequence over contiguous token rows [B,
// cap, 2, KVH*D], one block of four warps per (sequence, query head), eight
// lanes a row (the row layout of decode_attn.cuh). The kernel of
// verify_attn.cu (V1: S <= 8 verify queries over a float or int8 cache),
// decode_attn_grouped_int8.cu (G1 and G2: one query over an int8 cache,
// exact q or int8 scores; G1's pv_int8 mode has a walk of its own there,
// sharing quantize_q) and decode_attn_append.cu (A1: one query over a
// float cache whose new row the kernel writes).
//
// Contract: query i of sequence b and head h (kv head h / (H / KVH)) sits
// at position p_i = max(lengths[b], 0) - shift + i and reads rows t <
// min(p_i + 1, cap). Verify passes the lengths before the chunk (shift 0);
// decode passes lengths that count the current token (shift 1, S = 1), so
// it reads min(lengths, cap) rows and a sequence with lengths 0 gets
// zeros. q f32 [B, S, H, D], out f32 [B, S, H, D].
// kFloat: a float cache read as f32, s_t = (q . k_t) * scale.
// kExact: an int8 cache with bf16 scales [B, cap, 2, KVH] per (token, plane,
//   head), s_t = ((q . k8_t) * scale) * k_scale_t.
// kScores (S = 1): the same cache with q row-quantized in the kernel, qs =
//   absmax(q) / 127 (1 where the row is 0), q8 = clip(rint(q / qs), -127,
//   127) (IEEE division, ties to even), and s_t = (f32(int32 q8 . k8_t) *
//   (qs * scale)) * k_scale_t; with `dots` the int32 sums [B, H, cap] are
//   stored too.
// Then out = sum_t p_t w_t v_t / max(sum_t p_t, 1e-30) in f32 with p_t =
// exp(s_t - max s), w_t = v_scale_t on an int8 cache and 1 on a float one.
// kAppend (kFloat, S = 1): the new K/V row (f32 rows new_k/new_v [B,
// KVH*D] with row strides k_stride/v_stride) is cast to the cache dtype
// (bf16 rounds to nearest even) and written at pos = clip(lengths - 1, 0,
// cap - 1) by the first query head of each kv head; every block reads row
// min(lengths, cap) - 1 = pos from the new row itself, never from the
// cache, so no block waits for the write.
//
// Design: a warp owns every fourth pass of kTokPerLoad * kUnroll rows; the
// eight lanes of a row each hold d / 8 values from one vector load, reduce
// the row's dot by shuffles (int32 __dp4a sums in kScores), and keep S
// online softmaxes in registers. The per-query causal limit is a compare
// per (query, row), so the score rows never sit in shared memory and
// capacity is unlimited. The warps' states merge once at the end through
// shared memory.
#pragma once
#include "decode_attn.cuh"

namespace verify_rows {

using decode_attn::kLanesPerTok;
using decode_attn::kThreads;
using decode_attn::kTokPerLoad;
using decode_attn::kWarps;
using decode_attn::load_row;

enum Mode { kFloat = 0, kExact = 1, kScores = 2 };

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

template <typename T, int kMode, bool kAppend, int kS, int kDpl>
__global__ void __launch_bounds__(kThreads)
    kernel(const float* __restrict__ q, T* __restrict__ kv,
           const __nv_bfloat16* __restrict__ scales,
           const float* __restrict__ new_k, const float* __restrict__ new_v,
           int k_stride, int v_stride, const int* __restrict__ lengths,
           float* __restrict__ out, int* __restrict__ dots, int s, int shift,
           int heads, int kvh, int cap, float scale) {
  constexpr int d = kLanesPerTok * kDpl;
  constexpr bool kQuant = kMode != kFloat;
  constexpr int kUnroll = kDpl == 8 ? 4 : 2;       // row loads per pass
  constexpr int kWarpTok = kTokPerLoad * kUnroll;  // rows per warp pass
  constexpr int kWords = kDpl / 4;
  static_assert(!(kAppend && kQuant), "the append is for float caches");
  static_assert(kS == 1 || (kMode != kScores && !kAppend),
                "int8 scores and the append take one query");
  __shared__ float m_s[kWarps][kS], l_s[kWarps][kS];
  __shared__ float acc_s[kWarps][kS][d];
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane / kLanesPerTok, col = (lane % kLanesPerTok) * kDpl;
  const int rep = heads / kvh, kh = h / rep;
  const long long f = (long long)kvh * d;
  const int len = max(lengths[b], 0);
  const int pos0 = len - shift;      // position of query 0
  const int n = min(pos0 + s, cap);  // rows that some query reads

  float qv[kS][kDpl], acc[kS][kDpl], m[kS], l[kS];
#pragma unroll
  for (int i = 0; i < kS; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
    const float* qrow = q + (((long long)b * s + i) * heads + h) * d + col;
#pragma unroll
    for (int j = 0; j < kDpl; ++j) {
      qv[i][j] = i < s ? qrow[j] : 0.0f;
      acc[i][j] = 0.0f;
    }
  }
  int qw[kWords];
  float qscale = scale;  // kScores: qs * scale, the reference's order
  if constexpr (kMode == kScores)
    qscale = quantize_q<kDpl>(qv[0], qw) * scale;

  T* rows = kv + (long long)b * cap * 2 * f;
  const float* nk = nullptr;
  const float* nv = nullptr;
  if constexpr (kAppend) {
    nk = new_k + (long long)b * k_stride + (long long)kh * d;
    nv = new_v + (long long)b * v_stride + (long long)kh * d;
    if (h % rep == 0) {
      const int pos = min(max(len - 1, 0), cap - 1);
      T* dst = rows + (long long)pos * 2 * f + (long long)kh * d;
      for (int i = threadIdx.x; i < d; i += kThreads) {
        store(dst + i, nk[i]);
        store(dst + f + i, nv[i]);
      }
    }
  }

  const T* base = rows + (long long)kh * d + col;
  for (int t0 = warp * kWarpTok; t0 < n; t0 += kWarps * kWarpTok) {
    float ks[kUnroll], vs[kUnroll];
    float kk[kUnroll][kDpl], vv[kUnroll][kDpl];
    int kwd[kUnroll][kWords];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u * kTokPerLoad + grp;
      ks[u] = vs[u] = 0.0f;
#pragma unroll
      for (int w = 0; w < kWords; ++w) kwd[u][w] = 0;
#pragma unroll
      for (int j = 0; j < kDpl; ++j) kk[u][j] = vv[u][j] = 0.0f;
      if (t >= n) continue;
      const T* r = base + (long long)t * 2 * f;
      if constexpr (kQuant) {
        const __nv_bfloat16* sr =
            scales + ((long long)b * cap + t) * 2 * kvh + kh;
        ks[u] = __bfloat162float(sr[0]);
        vs[u] = __bfloat162float(sr[kvh]);
      }
      if constexpr (kAppend) {
        if (t == n - 1) {
#pragma unroll
          for (int j = 0; j < kDpl; ++j) {
            kk[u][j] = round_to(nk[col + j], (T*)nullptr);
            vv[u][j] = round_to(nv[col + j], (T*)nullptr);
          }
          continue;
        }
      }
      if constexpr (kMode == kScores)
        load_words<kDpl>(reinterpret_cast<const int8_t*>(r), kwd[u]);
      else
        load_row<kDpl>(r, kk[u]);
      load_row<kDpl>(r + f, vv[u]);
    }
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      if (i >= s) continue;  // uniform across the block
      // Query i sees rows below its position + 1 (causal within a chunk).
      const int lim = min(pos0 + i + 1, cap);
      float sc[kUnroll];
      float tile_max = -INFINITY;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = t0 + u * kTokPerLoad + grp;
        float sv;
        if constexpr (kMode == kScores) {
          int dot = 0;
#pragma unroll
          for (int w = 0; w < kWords; ++w)
            dot = __dp4a(qw[w], kwd[u][w], dot);
#pragma unroll
          for (int o = 1; o < kLanesPerTok; o <<= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, o);
          if (dots != nullptr && lane % kLanesPerTok == 0 && t < n)
            dots[((long long)b * heads + h) * cap + t] = dot;
          sv = (float)dot * qscale * ks[u];
        } else {
          float dot = 0.0f;
#pragma unroll
          for (int j = 0; j < kDpl; ++j) dot += qv[i][j] * kk[u][j];
#pragma unroll
          for (int o = 1; o < kLanesPerTok; o <<= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, o);
          sv = kQuant ? dot * scale * ks[u] : dot * scale;
        }
        sc[u] = t < lim ? sv : -INFINITY;
        tile_max = fmaxf(tile_max, sc[u]);
      }
#pragma unroll
      for (int o = kLanesPerTok; o < 32; o <<= 1)
        tile_max =
            fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, o));
      // A warp may reach rows past this query's limit before any live
      // row of it: keep m = -inf until one is live (warp-uniform).
      const float m_new = fmaxf(m[i], tile_max);
      if (m_new == -INFINITY) continue;
      const float alpha = expf(m[i] - m_new);
      l[i] *= alpha;
#pragma unroll
      for (int j = 0; j < kDpl; ++j) acc[i][j] *= alpha;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float p = expf(sc[u] - m_new);
        l[i] += p;
        const float pv = kQuant ? p * vs[u] : p;
#pragma unroll
        for (int j = 0; j < kDpl; ++j) acc[i][j] += pv * vv[u][j];
      }
      m[i] = m_new;
    }
  }

  // Sum each query's partial l and acc over the warp's four row groups (m
  // is warp-uniform), then merge the warps through shared memory.
#pragma unroll
  for (int i = 0; i < kS; ++i) {
    if (i >= s) continue;
#pragma unroll
    for (int o = kLanesPerTok; o < 32; o <<= 1) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], o);
#pragma unroll
      for (int j = 0; j < kDpl; ++j)
        acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], o);
    }
    if (lane == 0) {
      m_s[warp][i] = m[i];
      l_s[warp][i] = l[i];
    }
    if (grp == 0) {
#pragma unroll
      for (int j = 0; j < kDpl; ++j) acc_s[warp][i][col + j] = acc[i][j];
    }
  }
  __syncthreads();
  // A warp that saw no live row of a query has m = -inf and weighs
  // exp(-inf) = 0; a query with no live row gets zeros.
  for (int idx = threadIdx.x; idx < s * d; idx += kThreads) {
    const int i = idx / d, c = idx % d;
    float mx = -INFINITY;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w][i]);
    float sum = 0.0f, o = 0.0f;
    if (mx != -INFINITY) {
      for (int w = 0; w < kWarps; ++w) {
        const float cw = expf(m_s[w][i] - mx);
        sum += l_s[w][i] * cw;
        o += acc_s[w][i][c] * cw;
      }
    }
    out[(((long long)b * s + i) * heads + h) * d + c] = o / fmaxf(sum, 1e-30f);
  }
}

template <typename T, int kMode, bool kAppend, int kS>
cudaError_t launch(const void* q, void* kv, const void* scales,
                   const void* new_k, const void* new_v, int k_stride,
                   int v_stride, const void* lengths, void* out, void* dots,
                   int batch, int s, int shift, int heads, int kvh, int d,
                   int cap, float scale, cudaStream_t stream) {
  if (d != 64 && d != 128) return cudaErrorInvalidValue;
  if (batch > 0 && heads > 0) {
    const dim3 grid(heads, batch);
    if (d == 64)
      kernel<T, kMode, kAppend, kS, 8><<<grid, kThreads, 0, stream>>>(
          (const float*)q, (T*)kv, (const __nv_bfloat16*)scales,
          (const float*)new_k, (const float*)new_v, k_stride, v_stride,
          (const int*)lengths, (float*)out, (int*)dots, s, shift, heads, kvh,
          cap, scale);
    else
      kernel<T, kMode, kAppend, kS, 16><<<grid, kThreads, 0, stream>>>(
          (const float*)q, (T*)kv, (const __nv_bfloat16*)scales,
          (const float*)new_k, (const float*)new_v, k_stride, v_stride,
          (const int*)lengths, (float*)out, (int*)dots, s, shift, heads, kvh,
          cap, scale);
  }
  return cudaGetLastError();
}

// One query per sequence at lengths - 1 (lengths count the current token).
template <typename T, int kMode, bool kAppend>
cudaError_t launch_decode(const void* q, void* kv, const void* scales,
                          const void* new_k, const void* new_v, int k_stride,
                          int v_stride, const void* lengths, void* out,
                          void* dots, int batch, int heads, int kvh, int d,
                          int cap, float scale, cudaStream_t stream) {
  return launch<T, kMode, kAppend, 1>(q, kv, scales, new_k, new_v, k_stride,
                                      v_stride, lengths, out, dots, batch, 1,
                                      1, heads, kvh, d, cap, scale, stream);
}

}  // namespace verify_rows
