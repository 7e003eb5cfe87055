// Single-query decode attention, one block of four warps per (sequence,
// query head): the kernel of decode_attn_split.cu (K9: separate K and V
// planes), its one user. The row layout helpers below (eight lanes a row)
// serve the int8 kernel (decode_attn_int8_tail.cu), G1's pv_int8 walk and
// the KV-group kernel (decode_attn_kv_group.cuh: P3i, P3 and its grid
// mode, G1, G2, K6, K8, V1 and A1); bf16_round and load2 serve
// decode_attn_float.cu's native_dots kernel too.
//
// Contract: for sequence b and query head h (kv head h / (H / KVH)),
// n = min(max(lengths[b], 0), capacity) tokens are read, token t from the
// row that the addressing gives (Split: [b, kv head, t] of separate
// [B, KVH, S, D] K and V planes). The planes are read as f32; score_t =
// (q . k_t) * scale, out = sum_t p_t v_t / max(sum_t p_t, 1e-30); a
// sequence with no live token gets zeros.
//
// Design: a warp owns every fourth tile of 4 tokens; each lane holds two
// adjacent dims of every 64, so a warp reads a head's K and V rows as
// contiguous segments and the 8 row loads of a tile are in flight together.
// Each warp keeps an online softmax (running max, sum and accumulator in
// registers), so the score row never needs shared memory and capacity is
// unlimited; the four warp states merge once at the end through shared
// memory. Every query head of a group reads the group's rows again.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace decode_attn {

constexpr int kWarps = 4, kThreads = 32 * kWarps;
constexpr int kTok = 4;            // tokens per warp tile
constexpr int kMaxJ = 4;           // head_dim <= 64 * kMaxJ
constexpr int kMaxD = 64 * kMaxJ;

__device__ inline float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ inline float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ inline float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// The row layout of the int8 kernel (decode_attn_int8_tail.cu) and G1's
// pv_int8 walk: eight lanes share a token row, each holding kDpl = d / 8
// values (8 or 16), so one warp load covers four rows.
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

// Each addressing gives token t of sequence b a row r; kv head kh of that
// row starts r * row_stride + kh * head_stride elements into the K plane's
// pointer, and at the same offset into the V plane's.

// Token rows of separate K and V planes [B, KVH, S, D].
struct Split {
  int cap;                            // S
  long long row_stride, head_stride;  // D, S * D
  long long seq_rows;                 // KVH * S
  __device__ int capacity() const { return cap; }
  __device__ long long row(int b, int t) const { return b * seq_rows + t; }
};

template <typename T, typename Addr>
__global__ void kernel(const float* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const int* __restrict__ lengths,
                       float* __restrict__ out, int heads, int kvh, int d,
                       Addr addr, float scale) {
  __shared__ float m_s[kWarps], l_s[kWarps];
  __shared__ float acc_s[kWarps][kMaxD];
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kh = h / (heads / kvh);
  const int nj = d / 64;
  const int n = min(max(lengths[b], 0), addr.capacity());

  const float* qrow = q + ((long long)b * heads + h) * d + 2 * lane;
  float2 qv[kMaxJ];
#pragma unroll
  for (int j = 0; j < kMaxJ; ++j)
    qv[j] = j < nj ? load2(qrow + 64 * j) : make_float2(0.0f, 0.0f);

  float m = -INFINITY, l = 0.0f;
  float2 acc[kMaxJ];
#pragma unroll
  for (int j = 0; j < kMaxJ; ++j) acc[j] = make_float2(0.0f, 0.0f);

  const long long head = (long long)kh * addr.head_stride + 2 * lane;
  for (int t0 = warp * kTok; t0 < n; t0 += kWarps * kTok) {
    float s[kTok];
    bool live[kTok];
    float2 vv[kTok][kMaxJ];
#pragma unroll
    for (int u = 0; u < kTok; ++u) {
      const int t = t0 + u;
      const long long r = t < n ? addr.row(b, t) : -1;
      live[u] = r >= 0;
      float dot = 0.0f;
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j) {
        vv[u][j] = make_float2(0.0f, 0.0f);
        if (j < nj && live[u]) {
          const long long o = r * addr.row_stride + head + 64 * j;
          const float2 kk = load2(k + o);
          vv[u][j] = load2(v + o);
          dot += qv[j].x * kk.x + qv[j].y * kk.y;
        }
      }
      s[u] = dot;
    }
    float tile_max = -INFINITY;
#pragma unroll
    for (int u = 0; u < kTok; ++u) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        s[u] += __shfl_xor_sync(0xffffffffu, s[u], o);
      s[u] = live[u] ? s[u] * scale : -INFINITY;
      tile_max = fmaxf(tile_max, s[u]);
    }
    // Token t0 < n is live, so tile_max is finite and the first tile's
    // alpha is exp(-inf) = 0.
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) {
      acc[j].x *= alpha;
      acc[j].y *= alpha;
    }
#pragma unroll
    for (int u = 0; u < kTok; ++u) {
      const float p = expf(s[u] - m_new);
      l += p;
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j) {
        acc[j].x += p * vv[u][j].x;
        acc[j].y += p * vv[u][j].y;
      }
    }
    m = m_new;
  }

  if (lane == 0) {
    m_s[warp] = m;
    l_s[warp] = l;
  }
#pragma unroll
  for (int j = 0; j < kMaxJ; ++j) {
    if (j < nj) {
      acc_s[warp][64 * j + 2 * lane] = acc[j].x;
      acc_s[warp][64 * j + 2 * lane + 1] = acc[j].y;
    }
  }
  __syncthreads();
  // Merge the warps' online-softmax states; a warp that saw no live token
  // has m = -inf and weighs exp(-inf) = 0.
  float mx = -INFINITY;
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w]);
  for (int i = threadIdx.x; i < d; i += kThreads) {
    float sum = 0.0f, o = 0.0f;
    if (mx != -INFINITY) {
      for (int w = 0; w < kWarps; ++w) {
        const float c = expf(m_s[w] - mx);
        sum += l_s[w] * c;
        o += acc_s[w][i] * c;
      }
    }
    const float y = o / fmaxf(sum, 1e-30f);
    out[((long long)b * heads + h) * d + i] = y;
  }
}

}  // namespace decode_attn
