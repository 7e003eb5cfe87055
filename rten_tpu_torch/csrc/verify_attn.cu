// Chunked-verify attention for speculative decoding (V1): S queries per
// sequence over a contiguous float (f32 or bf16) or int8 KV cache.
//
// Replaces: rten_tpu/kernels/attention.py::flash_verify_grouped (kernels
// _decode_grouped_kernel and _decode_grouped_quant_kernel with chunk_s > 0)
// and ::flash_verify_fused (_decode_fused_kernel with chunk_s > 0). The two
// differ only in how the TPU grid batches sequences (G per program, or one
// program per (sequence, block)); the block-diagonal q rows, the one-hot
// scale selectors, the token-packed int32 rows and the clamped index maps
// exist for the MXU and Mosaic's DMA rules. One kernel serves both entries
// here, at any batch.
//
// Contract: q f32 [B, S, H, D] (S <= 8) at absolute positions
// lengths[b] .. lengths[b] + S - 1 (the chunk is already appended); query i
// of sequence b and head h (kv head h / (H / KVH)) reads cache rows
// t < min(lengths[b] + i + 1, cap). A float cache is read as f32:
// score_t = (q . k_t) * scale, out = sum_t p_t v_t / max(sum_t p_t, 1e-30).
// An int8 cache with bf16 scales [B, cap, 2, KVH] per (token, plane, head)
// follows the reference's int8 rule: score_t = ((q . k_t) * scale) *
// k_scale_t, the sum l takes the unscaled p_t, and V is weighted by
// p_t * v_scale_t. q and the output stay f32 (no bf16 rounding). Output
// f32 [B, S, H, D].
//
// Bound on the H100: bytes. A verify step should cost about one decode
// step: each block reads its head's live K/V rows once for all S queries.
// At batch 8, 12 heads of 64, lives 64-320 and a bf16 cache that is about
// 8 * 192 * 2 * 768 * 2 bytes = 4.7 MB per layer (1.4 us at 3.35 TB/s).
// Design: one block of four warps per (sequence, head). Eight lanes share
// a token row, each holding d / 8 dims in one vector load, so a warp load
// covers four rows (decode_attn.cuh's row layout, as the int8 kernel's);
// each warp keeps S online softmaxes in registers, and the per-query
// causal limit is a compare per (query, row), so the score rows never sit
// in shared memory and capacity is unlimited. The warps' states merge
// once at the end through shared memory.
#include "decode_attn.cuh"

namespace {

using decode_attn::kLanesPerTok;
using decode_attn::kThreads;
using decode_attn::kTokPerLoad;
using decode_attn::kWarps;
using decode_attn::load_row;

template <typename T, bool kQuant, int kS, int kDpl>
__global__ void verify_kernel(const float* __restrict__ q,
                              const T* __restrict__ kv,
                              const __nv_bfloat16* __restrict__ scales,
                              const int* __restrict__ lengths,
                              float* __restrict__ out, int s, int heads,
                              int kvh, int cap, float scale) {
  constexpr int d = kLanesPerTok * kDpl;
  constexpr int kUnroll = kDpl == 8 ? 4 : 2;      // row loads per pass
  constexpr int kWarpTok = kTokPerLoad * kUnroll;  // rows per warp pass
  __shared__ float m_s[kWarps][kS], l_s[kWarps][kS];
  __shared__ float acc_s[kWarps][kS][d];
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane / kLanesPerTok, col = (lane % kLanesPerTok) * kDpl;
  const int kh = h / (heads / kvh);
  const long long f = (long long)kvh * d;
  const int len0 = max(lengths[b], 0);
  const int n = min(len0 + s, cap);  // rows that some query reads

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

  const T* base = kv + (long long)kh * d + col;
  for (int t0 = warp * kWarpTok; t0 < n; t0 += kWarps * kWarpTok) {
    float ks[kUnroll], vs[kUnroll];
    float kk[kUnroll][kDpl], vv[kUnroll][kDpl];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u * kTokPerLoad + grp;
      ks[u] = vs[u] = 0.0f;
      if (t < n) {
        const long long r = (long long)b * cap + t;
        if (kQuant) {
          const __nv_bfloat16* sr = scales + r * 2 * kvh + kh;
          ks[u] = __bfloat162float(sr[0]);
          vs[u] = __bfloat162float(sr[kvh]);
        }
        load_row<kDpl>(base + r * 2 * f, kk[u]);
        load_row<kDpl>(base + r * 2 * f + f, vv[u]);
      } else {
#pragma unroll
        for (int j = 0; j < kDpl; ++j) kk[u][j] = vv[u][j] = 0.0f;
      }
    }
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      if (i >= s) continue;  // uniform across the block
      // Query i sees rows below lengths + i + 1 (causal within the chunk).
      const int lim = min(len0 + i + 1, cap);
      float sc[kUnroll];
      float tile_max = -INFINITY;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float dot = 0.0f;
#pragma unroll
        for (int j = 0; j < kDpl; ++j) dot += qv[i][j] * kk[u][j];
#pragma unroll
        for (int o = 1; o < kLanesPerTok; o <<= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        const bool live = t0 + u * kTokPerLoad + grp < lim;
        if (kQuant)
          sc[u] = live ? dot * scale * ks[u] : -INFINITY;
        else
          sc[u] = live ? dot * scale : -INFINITY;
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
  // exp(-inf) = 0.
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

template <typename T, bool kQuant, int kS>
void launch_s(const void* q, const void* kv, const void* scales,
              const void* lengths, void* out, int batch, int s, int heads,
              int kvh, int d, int cap, float scale, cudaStream_t stream) {
  dim3 grid(heads, batch);
  if (d == 64) {
    verify_kernel<T, kQuant, kS, 8><<<grid, kThreads, 0, stream>>>(
        (const float*)q, (const T*)kv, (const __nv_bfloat16*)scales,
        (const int*)lengths, (float*)out, s, heads, kvh, cap, scale);
  } else {
    verify_kernel<T, kQuant, kS, 16><<<grid, kThreads, 0, stream>>>(
        (const float*)q, (const T*)kv, (const __nv_bfloat16*)scales,
        (const int*)lengths, (float*)out, s, heads, kvh, cap, scale);
  }
}

template <typename T, bool kQuant>
void launch(const void* q, const void* kv, const void* scales,
            const void* lengths, void* out, int batch, int s, int heads,
            int kvh, int d, int cap, float scale, cudaStream_t stream) {
  if (s <= 4)
    launch_s<T, kQuant, 4>(q, kv, scales, lengths, out, batch, s, heads, kvh,
                           d, cap, scale, stream);
  else
    launch_s<T, kQuant, 8>(q, kv, scales, lengths, out, batch, s, heads, kvh,
                           d, cap, scale, stream);
}

}  // namespace

// kind: 0 f32 cache, 1 bf16 cache, 2 int8 cache with bf16 scales. The
// wrapper checks d in {64, 128} and 1 <= s <= 8.
extern "C" int verify_attn(const void* q, const void* kv, const void* scales,
                           const void* lengths, void* out, int batch, int s,
                           int heads, int kvh, int d, int cap, int kind,
                           float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (batch > 0) {
    if (kind == 0)
      launch<float, false>(q, kv, scales, lengths, out, batch, s, heads, kvh,
                           d, cap, scale, st);
    else if (kind == 1)
      launch<__nv_bfloat16, false>(q, kv, scales, lengths, out, batch, s,
                                   heads, kvh, d, cap, scale, st);
    else
      launch<int8_t, true>(q, kv, scales, lengths, out, batch, s, heads, kvh,
                           d, cap, scale, st);
  }
  return (int)cudaGetLastError();
}
