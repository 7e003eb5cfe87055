// Single-query decode attention over an int8 KV cache (G1, and G2 through
// a wrapper of its own), q and the output in f32.
//
// Replaces: rten_tpu/kernels/attention.py::flash_decode_grouped in its int8
// modes (kernel _decode_grouped_quant_kernel: exact q and int8_scores, each
// with or without pv_int8) and ::flash_decode_fused in its int8 mode
// (_decode_fused_kernel with scales). The two differ only in how the TPU
// grid batches sequences; the block-diagonal q rows, the one-hot scale
// selectors and the token-packed int32 rows exist for the MXU and Mosaic.
//
// Contract: decode_attn_kv_group.cuh over contiguous rows (lengths count
// the query), modes kExact and kScores. In kScores the integer dots are
// exact (int32 __dp4a sums), and `dots` (int32 [B, H, cap], may be null)
// receives them for t < min(lengths, cap).
// pv_int8 (the reference's P.V as an int8 x int8 dot, attention.py:
// 825-837): per block of block_k rows (the reference's blocks, row 0 of
// the cache first) and query head, p_t = exp(s_t - m) with m the running
// max after the block, l += sum p_t, pm_t = p_t * v_scale_t, pq =
// max(max_t pm_t, 1e-30) / 127, p8_t = rint(pm_t / pq) (IEEE division,
// ties to even), and acc = acc * alpha + f32(sum_t p8_t v8_t) * pq.
//
// Bound on the H100: bytes. At batch 16, 32 query heads over 8 KV heads of
// 128 (Mistral-7B) and lives 512-576 a layer reads about 16 * 544 * 2 * 1040
// bytes of int8 rows and scales, 18 MB, 5.4 us at 3.35 TB/s. The exact-q
// arithmetic, about 8 f32 FMAs a group of 4 heads and one exact convert
// (a byte permute and a subtract) per int8 element, is about 4-5 us of the
// card's instruction rate at that shape: as long as the bytes, so the
// design keeps both low.
// Design of G1 without pv_int8 (decode_attn_grouped_int8_rows): the kernel
// of decode_attn_kv_group.cuh, one block per (sequence, KV head, split):
// the group's four query heads share each row, which crosses from device
// memory once through a 2-stage ring of 64-row tiles (16-byte cp.async);
// at d 128 a warp holds two heads' q and accumulators, and two head groups
// of warps read each staged row from shared memory. B x KVH = 128 blocks
// would leave the walk of 512-576 rows to one block an SM, so
// rows_plan splits each sequence into 2 chunks of whole 16-row
// units (one cluster, merged through distributed shared memory in the
// same launch) and gives each of the 256 blocks 8 warps. The design before
// (one block per query head, every head reading the KV head's rows, no
// split) took 0.043 ms here; int8 scores share the walk
// with __dp4a dots.
// G2 (decode_attn_fused_int8: exact q at the batches and capacities the
// reference sends to its fused kernel) is the same launch at rows_plan's
// choice: at (H-fused), batch 3, 24 (sequence, KV head) pairs in 8 splits.
// pv_int8 needs the row max over whole reference blocks, so it walks
// blocks instead: each warp owns every fourth block, scores its rows into
// shared memory (one row's eight lanes a dot), then takes p, the
// scale-folded p and their row max lane-strided over the block, and sums
// p8 * v8 exactly in f32 (integers below 2^24) before the one multiply by
// pq.
#include "decode_attn_kv_group.cuh"
#include "verify_attn.cuh"

namespace {

using decode_attn::kLanesPerTok;
using decode_attn::kThreads;
using decode_attn::kTokPerLoad;
using decode_attn::kWarps;
using decode_attn::load_row;

constexpr int kMaxBlock = 256;  // the largest block_k the wrapper passes

template <int kMode, int kDpl>
__global__ void __launch_bounds__(kThreads)
    pv_int8_kernel(const float* __restrict__ q, const int8_t* __restrict__ kv,
                   const __nv_bfloat16* __restrict__ scales,
                   const int* __restrict__ lengths, float* __restrict__ out,
                   int heads, int kvh, int cap, int block_k, float scale) {
  constexpr int d = kLanesPerTok * kDpl;
  constexpr int kWords = kDpl / 4;
  __shared__ float p_s[kWarps][kMaxBlock];
  __shared__ float m_s[kWarps], l_s[kWarps];
  __shared__ float acc_s[kWarps][d];
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane / kLanesPerTok, col = (lane % kLanesPerTok) * kDpl;
  const int kh = h / (heads / kvh);
  const long long f = (long long)kvh * d;
  const int n = min(max(lengths[b], 0), cap);

  float qv[kDpl], acc[kDpl];
  const float* qrow = q + ((long long)b * heads + h) * d + col;
#pragma unroll
  for (int j = 0; j < kDpl; ++j) {
    qv[j] = qrow[j];
    acc[j] = 0.0f;
  }
  int qw[kWords];
  float qscale = scale;  // kScores: qs * scale, the reference's order
  if constexpr (kMode == verify_rows::kScores)
    qscale = verify_rows::quantize_q<kDpl>(qv, qw) * scale;
  float m = -INFINITY, l = 0.0f;

  const int8_t* rows = kv + (long long)b * cap * 2 * f + (long long)kh * d;
  const __nv_bfloat16* srows = scales + (long long)b * cap * 2 * kvh + kh;
  float* ps = p_s[warp];
  for (int t0 = warp * block_k; t0 < n; t0 += kWarps * block_k) {
    const int t1 = min(t0 + block_k, n);
    // Scores of the block's rows (block_k % 4 == 0, so every row group of
    // the warp runs the same count and the shuffles stay converged).
    float bmax = -INFINITY;
    for (int i = grp; i < block_k; i += kTokPerLoad) {
      const int t = t0 + i;
      const bool live = t < t1;
      float sv;
      if constexpr (kMode == verify_rows::kScores) {
        int kw[kWords];
#pragma unroll
        for (int w = 0; w < kWords; ++w) kw[w] = 0;
        if (live)
          verify_rows::load_words<kDpl>(rows + (long long)t * 2 * f + col,
                                        kw);
        int dot = 0;
#pragma unroll
        for (int w = 0; w < kWords; ++w) dot = __dp4a(qw[w], kw[w], dot);
#pragma unroll
        for (int o = 1; o < kLanesPerTok; o <<= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        sv = (float)dot * qscale;
      } else {
        float kk[kDpl];
#pragma unroll
        for (int j = 0; j < kDpl; ++j) kk[j] = 0.0f;
        if (live) load_row<kDpl>(rows + (long long)t * 2 * f + col, kk);
        float dot = 0.0f;
#pragma unroll
        for (int j = 0; j < kDpl; ++j) dot += qv[j] * kk[j];
#pragma unroll
        for (int o = 1; o < kLanesPerTok; o <<= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        sv = dot * scale;
      }
      sv = live ? sv * __bfloat162float(srows[(long long)t * 2 * kvh])
                : -INFINITY;
      if (lane % kLanesPerTok == 0) ps[i] = sv;
      bmax = fmaxf(bmax, sv);
    }
#pragma unroll
    for (int o = kLanesPerTok; o < 32; o <<= 1)
      bmax = fmaxf(bmax, __shfl_xor_sync(0xffffffffu, bmax, o));
    // Row t0 < n is live, so m_new is finite (the first alpha is 0).
    const float m_new = fmaxf(m, bmax);
    const float alpha = expf(m - m_new);
    __syncwarp();
    // p, its sum and the scale-folded p with its row max, lane-strided.
    float lsum = 0.0f, rmax = 0.0f;
    for (int i = lane; i < block_k; i += 32) {
      const int t = t0 + i;
      float pm = 0.0f;
      if (t < t1) {
        const float p = expf(ps[i] - m_new);
        lsum += p;
        pm = p * __bfloat162float(srows[(long long)t * 2 * kvh + kvh]);
      }
      ps[i] = pm;
      rmax = fmaxf(rmax, pm);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lsum += __shfl_xor_sync(0xffffffffu, lsum, o);
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, o));
    }
    const float pq = fmaxf(rmax, 1e-30f) / 127.0f;
    __syncwarp();
    // sum_t p8_t v8_t: integer products and sums below 2^24, exact in f32.
    float pv[kDpl];
#pragma unroll
    for (int j = 0; j < kDpl; ++j) pv[j] = 0.0f;
    for (int i = grp; i < block_k; i += kTokPerLoad) {
      const int t = t0 + i;
      if (t >= t1) continue;
      const float p8 = rintf(ps[i] / pq);
      float vv[kDpl];
      load_row<kDpl>(rows + (long long)t * 2 * f + f + col, vv);
#pragma unroll
      for (int j = 0; j < kDpl; ++j) pv[j] += p8 * vv[j];
    }
#pragma unroll
    for (int o = kLanesPerTok; o < 32; o <<= 1) {
#pragma unroll
      for (int j = 0; j < kDpl; ++j)
        pv[j] += __shfl_xor_sync(0xffffffffu, pv[j], o);
    }
    l = l * alpha + lsum;
#pragma unroll
    for (int j = 0; j < kDpl; ++j) acc[j] = acc[j] * alpha + pv[j] * pq;
    m = m_new;
    __syncwarp();
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
  // A warp that owned no live block has m = -inf and weighs exp(-inf) = 0;
  // a sequence with no live row gets zeros.
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

template <int kMode>
cudaError_t launch_pv_int8(const void* q, const void* kv, const void* scales,
                           const void* lengths, void* out, int batch,
                           int heads, int kvh, int d, int cap, int block_k,
                           float scale, cudaStream_t stream) {
  if ((d != 64 && d != 128) || block_k <= 0 || block_k > kMaxBlock ||
      block_k % kTokPerLoad)
    return cudaErrorInvalidValue;
  if (batch > 0 && heads > 0) {
    const dim3 grid(heads, batch);
    if (d == 64)
      pv_int8_kernel<kMode, 8><<<grid, kThreads, 0, stream>>>(
          (const float*)q, (const int8_t*)kv, (const __nv_bfloat16*)scales,
          (const int*)lengths, (float*)out, heads, kvh, cap, block_k, scale);
    else
      pv_int8_kernel<kMode, 16><<<grid, kThreads, 0, stream>>>(
          (const float*)q, (const int8_t*)kv, (const __nv_bfloat16*)scales,
          (const int*)lengths, (float*)out, heads, kvh, cap, block_k, scale);
  }
  return cudaGetLastError();
}

}  // namespace

// pv_int8 in either score mode (int8_scores 1: row-quantized q): the walk
// over blocks of block_k rows. The wrapper checks d in {64, 128}, shapes
// and contiguity.
extern "C" int decode_attn_pv_int8(const void* q, const void* kv,
                                   const void* scales, const void* lengths,
                                   void* out, int batch, int heads, int kvh,
                                   int d, int cap, int int8_scores,
                                   int block_k, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(int8_scores
                   ? launch_pv_int8<verify_rows::kScores>(
                         q, kv, scales, lengths, out, batch, heads, kvh, d,
                         cap, block_k, scale, st)
                   : launch_pv_int8<verify_rows::kExact>(
                         q, kv, scales, lengths, out, batch, heads, kvh, d,
                         cap, block_k, scale, st));
}

// G1 without pv_int8 and G2, the launch of rows_plan: int8_scores 0 exact q
// (kExact), 1 row-quantized q (kScores, `dots` int32 [B, H, cap] or null);
// `splits` chunks a sequence (1 to 8, one cluster) of whole `unit`-row
// units; hpw query heads a warp, hg head groups, warps 4 or 8 a block
// (kv_group::launch). d 64 or 128, as the design before took. The
// wrapper checks shapes, contiguity and 16-byte alignment.
extern "C" int decode_attn_grouped_int8_rows(
    const void* q, const void* kv, const void* scales, const void* lengths,
    void* out, void* dots, int batch, int heads, int kvh, int d, int cap,
    int int8_scores, int splits, int unit, int hpw, int hg, int warps,
    float scale, void* stream) {
  using kv_group::launch;
  const kv_group::Rows addr{cap};
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(int8_scores
                   ? launch<int8_t, kv_group::Rows, kv_group::kScores,
                            false>(q, kv, scales, lengths, out, dots, batch,
                                   heads, kvh, d, addr, splits, unit, hpw,
                                   hg, warps, scale, st)
                   : launch<int8_t, kv_group::Rows, kv_group::kExact,
                            false>(q, kv, scales, lengths, out, nullptr,
                                   batch, heads, kvh, d, addr, splits, unit,
                                   hpw, hg, warps, scale, st));
}
