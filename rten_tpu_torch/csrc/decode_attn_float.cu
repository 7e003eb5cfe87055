// Single-query decode attention over a float (f32 or bf16) KV cache: K6
// and its flat mode K8 (both the KV-group kernel of decode_attn_kv_group.cuh
// on contiguous rows, in its exact and its flat mode) and the native_dots
// mode (a kernel of its own below, on the row layout of decode_attn.cuh).
//
// Replaces:
// - K6: rten_tpu/kernels/attention.py::flash_decode_grouped (kernel
//   _decode_grouped_kernel) and ::flash_decode_fused (kernel
//   _decode_fused_kernel) in their float-cache mode with native_dots off,
//   and ::flash_decode_stream (kernel _decode_stream_kernel, the same f32
//   numerics). The three differ only in how the TPU grid batches
//   sequences (G sequences per program to hide the MXU's op latency, one
//   program per (sequence, block), or one per sequence with its own DMA
//   loop); the block-diagonal q and the one-hot head extraction exist for
//   the MXU. One kernel serves all three here, at any batch.
// - K8: ::flash_decode_flat in its float mode (kernel _decode_flat_kernel)
//   with q_bf16: q enters rounded to bf16, every K element is cast to q's
//   dtype (bf16) before the score dot, P.V runs in f32 on V as stored, and
//   the normalized output is rounded to bf16 (the cast before the bf16
//   one-hot compaction dot). The whole-batch program, its continuous DMA
//   pipeline and the E-matrix head expansion exist for the TPU.
// - native_dots: ::flash_decode_grouped with native_dots (q cast to the
//   cache dtype, P cast to the cache dtype before P.V, f32 sums): on a bf16
//   cache q and P round to bf16; on an f32 cache it is K6. The reference
//   rounds p = exp(s - m_i) with m_i its running max after block i of
//   block_k keys, so the rounding depends on m_i: the kernel takes the same
//   m_i (three passes: the block maxima, their running max, then
//   p_t = bf16(exp(s_t - m_i)) weighted by exp(m_i - m_last) in f32).
//
// Contract: for sequence b and query head h (kv head h / (H / KVH)),
// n = min(max(lengths[b], 0), cap) tokens are read; score_t = (q . k_t) *
// scale in f32 (a bf16 cache is read as f32), softmax over t < n in f32,
// out = sum_t p_t v_t / max(sum_t p_t, 1e-30), f32, with the roundings of
// the mode. A sequence with n = 0 gets zeros.
//
// Bound on the H100: bytes. At batch 256, 12 heads of 64 and a live
// length L it reads B*L*2*768*4 bytes of an f32 cache per layer (about
// 189 MB, 56 us, at L = 120; half that for bf16); the arithmetic is
// 4 flops per element read (0.5 flop per byte in f32). The roundings of
// K8 and native_dots add a few instructions per element and no bytes.
// Design: K6 and K8 run the KV-group kernel (one block per (sequence, KV
// head, split) for the whole query group, rows staged in shared memory by
// cp.async, splits merged in a cluster), at the launch of rows_plan. The
// kernel K6 ran before (one block of four warps per (sequence, query
// head), rows loaded straight from device memory, no staging) read each
// row once per query head, 8 times at TinyLlama's group of 8 (0.295 ms
// there against a 0.010 bound), and launched B x H blocks at small
// batches. native_dots reads K twice (the first pass only for the
// block maxima, kept in shared memory: at most kMaxBlocks blocks).
#include "decode_attn.cuh"
#include "decode_attn_kv_group.cuh"

namespace {

// K6 (kExact) or K8 (kFlat) on a contiguous f32 or bf16 cache.
template <int kMode>
int launch_rows(const void* q, const void* kv, const void* lengths,
                void* out, int batch, int heads, int kvh, int d, int cap,
                int bf16, int splits, int unit, int hpw, int hg, int warps,
                float scale, void* stream) {
  using kv_group::launch;
  const kv_group::Rows addr{cap};
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(bf16 ? launch<__nv_bfloat16, kv_group::Rows, kMode, true>(
                          q, kv, nullptr, lengths, out, nullptr, batch,
                          heads, kvh, d, addr, splits, unit, hpw, hg, warps,
                          scale, st)
                    : launch<float, kv_group::Rows, kMode, true>(
                          q, kv, nullptr, lengths, out, nullptr, batch,
                          heads, kvh, d, addr, splits, unit, hpw, hg, warps,
                          scale, st));
}

constexpr int kMaxBlocks = 512;   // capacity / block_k for native_dots

// x rounded to the cache dtype (a no-op for f32).
__device__ inline float to_cache(float x, const float*) { return x; }
__device__ inline float to_cache(float x, const __nv_bfloat16*) {
  return decode_attn::bf16_round(x);
}

// native_dots: see the header comment. Tile walk and lane layout of
// decode_attn.cuh (a warp owns every fourth tile of 4 tokens, a lane two
// adjacent dims of every 64); block_k % 4 == 0 keeps a tile in one block.
template <typename T>
__global__ void native_dots_kernel(const float* __restrict__ q,
                                   const T* __restrict__ kv,
                                   const int* __restrict__ lengths,
                                   float* __restrict__ out, int heads,
                                   int kvh, int d, int cap, int block_k,
                                   float scale) {
  using namespace decode_attn;
  __shared__ float bmax_s[kWarps][kMaxBlocks];
  __shared__ float l_s[kWarps];
  __shared__ float acc_s[kWarps][kMaxD];
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kh = h / (heads / kvh);
  const int nj = d / 64;
  const long long f = (long long)kvh * d;
  const int n = min(max(lengths[b], 0), cap);
  const int nb = (n + block_k - 1) / block_k;
  float* orow = out + ((long long)b * heads + h) * d;
  if (n == 0) {
    for (int i = threadIdx.x; i < d; i += kThreads) orow[i] = 0.0f;
    return;
  }

  const float* qrow = q + ((long long)b * heads + h) * d + 2 * lane;
  float2 qv[kMaxJ];
#pragma unroll
  for (int j = 0; j < kMaxJ; ++j) {
    const float2 x = j < nj ? load2(qrow + 64 * j) : make_float2(0.0f, 0.0f);
    qv[j] = make_float2(to_cache(x.x, kv), to_cache(x.y, kv));
  }
  const T* base = kv + (long long)b * cap * 2 * f + (long long)kh * d +
                  2 * lane;
  // The score of row t, reduced over the warp (every lane gets it).
  auto score = [&](int t) {
    float dot = 0.0f;
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) {
      if (j < nj) {
        const float2 kk = load2(base + (long long)t * 2 * f + 64 * j);
        dot += qv[j].x * kk.x + qv[j].y * kk.y;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, o);
    return dot * scale;
  };

  // Pass 1: each warp's max score per block.
  for (int i = lane; i < nb; i += 32) bmax_s[warp][i] = -INFINITY;
  __syncwarp();
  for (int t0 = warp * kTok; t0 < n; t0 += kWarps * kTok) {
    float tile_max = -INFINITY;
#pragma unroll
    for (int u = 0; u < kTok; ++u) {
      const int t = t0 + u;
      const float s = score(min(t, n - 1));
      if (t < n) tile_max = fmaxf(tile_max, s);
    }
    if (lane == 0) {
      float* bm = &bmax_s[warp][t0 / block_k];
      *bm = fmaxf(*bm, tile_max);
    }
  }
  __syncthreads();
  // Pass 2: the running max m_i after each block, in bmax_s[0].
  if (threadIdx.x == 0) {
    float run = -INFINITY;
    for (int i = 0; i < nb; ++i) {
      for (int w = 0; w < kWarps; ++w) run = fmaxf(run, bmax_s[w][i]);
      bmax_s[0][i] = run;
    }
  }
  __syncthreads();
  const float m_last = bmax_s[0][nb - 1];

  // Pass 3: p_t = exp(s_t - m_i), rounded to the cache dtype for P.V,
  // both weighted by exp(m_i - m_last).
  float l = 0.0f;
  float2 acc[kMaxJ];
#pragma unroll
  for (int j = 0; j < kMaxJ; ++j) acc[j] = make_float2(0.0f, 0.0f);
  for (int t0 = warp * kTok; t0 < n; t0 += kWarps * kTok) {
    const float m_i = bmax_s[0][t0 / block_k];
    const float c = expf(m_i - m_last);
#pragma unroll
    for (int u = 0; u < kTok; ++u) {
      const int t = t0 + u;
      const float s = score(min(t, n - 1));
      if (t >= n) continue;
      const float p = expf(s - m_i);
      l += p * c;
      const float pv = to_cache(p, kv) * c;
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j) {
        if (j < nj) {
          const float2 vv = load2(base + (long long)t * 2 * f + f + 64 * j);
          acc[j].x += pv * vv.x;
          acc[j].y += pv * vv.y;
        }
      }
    }
  }
  if (lane == 0) l_s[warp] = l;
#pragma unroll
  for (int j = 0; j < kMaxJ; ++j) {
    if (j < nj) {
      acc_s[warp][64 * j + 2 * lane] = acc[j].x;
      acc_s[warp][64 * j + 2 * lane + 1] = acc[j].y;
    }
  }
  __syncthreads();
  float sum = 0.0f;
  for (int w = 0; w < kWarps; ++w) sum += l_s[w];
  for (int i = threadIdx.x; i < d; i += kThreads) {
    float o = 0.0f;
    for (int w = 0; w < kWarps; ++w) o += acc_s[w][i];
    orow[i] = o / fmaxf(sum, 1e-30f);
  }
}

}  // namespace

// K6 (kv_group::kExact) and K8 (kv_group::kFlat: flash_decode_flat's
// float mode with q_bf16), each at the launch of rows_plan: `splits`
// chunks a sequence (1 to 8, one cluster) of whole `unit`-row units; hpw
// query heads a warp, hg head groups, warps 4 or 8 a block
// (kv_group::launch). bf16: 0 f32 cache, 1 bf16 cache. d 64 to 256 in
// steps of 64. The wrapper checks shapes, contiguity and 16-byte alignment
// of the cache.
extern "C" int decode_attn_float(const void* q, const void* kv,
                                 const void* lengths, void* out, int batch,
                                 int heads, int kvh, int d, int cap,
                                 int bf16, int splits, int unit, int hpw,
                                 int hg, int warps, float scale,
                                 void* stream) {
  return launch_rows<kv_group::kExact>(q, kv, lengths, out, batch, heads,
                                       kvh, d, cap, bf16, splits, unit, hpw,
                                       hg, warps, scale, stream);
}

extern "C" int decode_attn_flat_float(const void* q, const void* kv,
                                      const void* lengths, void* out,
                                      int batch, int heads, int kvh, int d,
                                      int cap, int bf16, int splits,
                                      int unit, int hpw, int hg, int warps,
                                      float scale, void* stream) {
  return launch_rows<kv_group::kFlat>(q, kv, lengths, out, batch, heads,
                                      kvh, d, cap, bf16, splits, unit, hpw,
                                      hg, warps, scale, stream);
}

// native_dots over blocks of block_k rows (on an f32 cache the roundings
// are no-ops). The wrapper checks d % 64 == 0, d <= 256, block_k % 4 == 0
// and cap / block_k <= kMaxBlocks.
extern "C" int decode_attn_native_dots(const void* q, const void* kv,
                                       const void* lengths, void* out,
                                       int batch, int heads, int kvh, int d,
                                       int cap, int bf16, int block_k,
                                       float scale, void* stream) {
  if (block_k <= 0 || block_k % decode_attn::kTok ||
      (cap + block_k - 1) / block_k > kMaxBlocks)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(heads, batch);
  if (batch > 0) {
    if (bf16)
      native_dots_kernel<__nv_bfloat16>
          <<<grid, decode_attn::kThreads, 0, st>>>(
              (const float*)q, (const __nv_bfloat16*)kv, (const int*)lengths,
              (float*)out, heads, kvh, d, cap, block_k, scale);
    else
      native_dots_kernel<float><<<grid, decode_attn::kThreads, 0, st>>>(
          (const float*)q, (const float*)kv, (const int*)lengths,
          (float*)out, heads, kvh, d, cap, block_k, scale);
  }
  return (int)cudaGetLastError();
}
