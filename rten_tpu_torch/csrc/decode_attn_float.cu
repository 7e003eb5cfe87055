// Single-query decode attention over a float (f32 or bf16) KV cache.
//
// Replaces: rten_tpu/kernels/attention.py::flash_decode_grouped (kernel
// _decode_grouped_kernel) and ::flash_decode_fused (kernel
// _decode_fused_kernel) in their float-cache mode with native_dots off.
// The two differ only in how the TPU grid batches sequences (G sequences
// per program to hide the MXU's op latency, or one program per (sequence,
// block)); the block-diagonal q and the one-hot head extraction exist for
// the MXU. One kernel serves both here, at any batch.
//
// Contract: for sequence b and query head h (kv head h / (H / KVH)),
// n = min(lengths[b], cap) tokens are read; score_t = (q . k_t) * scale in
// f32 (a bf16 cache is read as f32), softmax over t < n in f32,
// out = sum_t p_t v_t / max(sum_t p_t, 1e-30), f32. A sequence with
// n = 0 gets zeros.
//
// Bound on the H100: bytes. At batch 256, 12 heads of 64 and a live
// length L it reads B*L*2*768*4 bytes of an f32 cache per layer (about
// 189 MB, 56 us, at L = 120; half that for bf16); the arithmetic is
// 4 flops per element read (0.5 flop per byte in f32). Design: one block
// of four warps per (sequence, head). A warp owns every fourth tile of 4
// tokens; each lane holds two adjacent dims of every 64, so a warp reads
// a head's K and V rows as contiguous 256-byte (f32) segments, and the 8
// row loads of a tile are in flight together. Each warp keeps an online
// softmax (running max, sum and accumulator in registers), so the score
// row never needs shared memory and capacity is unlimited; the four warp
// states merge once at the end through shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4, kThreads = 32 * kWarps;
constexpr int kTok = 4;            // tokens per warp tile
constexpr int kMaxJ = 4;           // head_dim <= 64 * kMaxJ
constexpr int kMaxD = 64 * kMaxJ;

__device__ inline float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ inline float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename T>
__global__ void decode_attn_float_kernel(const float* __restrict__ q,
                                         const T* __restrict__ kv,
                                         const int* __restrict__ lengths,
                                         float* __restrict__ out, int heads,
                                         int kvh, int d, int cap,
                                         float scale) {
  __shared__ float m_s[kWarps], l_s[kWarps];
  __shared__ float acc_s[kWarps][kMaxD];
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kh = h / (heads / kvh);
  const int nj = d / 64;
  const long long f = (long long)kvh * d;
  const int n = min(max(lengths[b], 0), cap);

  const float* qrow = q + ((long long)b * heads + h) * d + 2 * lane;
  float2 qv[kMaxJ];
#pragma unroll
  for (int j = 0; j < kMaxJ; ++j)
    qv[j] = j < nj ? load2(qrow + 64 * j) : make_float2(0.0f, 0.0f);

  float m = -INFINITY, l = 0.0f;
  float2 acc[kMaxJ];
#pragma unroll
  for (int j = 0; j < kMaxJ; ++j) acc[j] = make_float2(0.0f, 0.0f);

  const T* base = kv + (long long)b * cap * 2 * f + (long long)kh * d +
                  2 * lane;
  for (int t0 = warp * kTok; t0 < n; t0 += kWarps * kTok) {
    float s[kTok];
    float2 vv[kTok][kMaxJ];
#pragma unroll
    for (int u = 0; u < kTok; ++u) {
      const int t = t0 + u;
      float dot = 0.0f;
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j) {
        vv[u][j] = make_float2(0.0f, 0.0f);
        if (j < nj && t < n) {
          const T* krow = base + (long long)t * 2 * f + 64 * j;
          const float2 kk = load2(krow);
          vv[u][j] = load2(krow + f);
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
      s[u] = t0 + u < n ? s[u] * scale : -INFINITY;
      tile_max = fmaxf(tile_max, s[u]);
    }
    // Token t0 < n is live, so tile_max is finite; the first tile's
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
  // Merge the warps' online-softmax states; a warp that saw no token has
  // m = -inf and weighs exp(-inf) = 0.
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
    out[((long long)b * heads + h) * d + i] = o / fmaxf(sum, 1e-30f);
  }
}

}  // namespace

extern "C" int decode_attn_float(const void* q, const void* kv,
                                 const void* lengths, void* out, int batch,
                                 int heads, int kvh, int d, int cap,
                                 int bf16, float scale, void* stream) {
  dim3 grid(heads, batch);
  if (batch > 0) {
    if (bf16) {
      decode_attn_float_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
          (const float*)q, (const __nv_bfloat16*)kv, (const int*)lengths,
          (float*)out, heads, kvh, d, cap, scale);
    } else {
      decode_attn_float_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
          (const float*)q, (const float*)kv, (const int*)lengths,
          (float*)out, heads, kvh, d, cap, scale);
    }
  }
  return (int)cudaGetLastError();
}
