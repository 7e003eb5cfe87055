// Single-query decode attention over the int8 KV cache, with or without
// the bf16 tail window.
//
// Replaces: rten_tpu/kernels/attention.py::flash_decode_flat in its int8
// modes (body _decode_flat_quant_kernel, tail round at
// attention.py:1600-1626): int8 + tail, and int8 without a tail
// (tail = nullptr, rows = tail_count = 0; the tail pointer is then never
// read), each with q_bf16 (q and the output rounded to bf16, the
// reference's default) or with exact q (RTEN_FLAT_QBF16=0: q, the dots and
// the output stay f32, as the reference's f32 E matrix at HIGHEST precision
// keeps them). Its partials mode runs on the KV-group kernel
// (decode_attn_grouped_int8.cu). The TPU kernel's one-hot E-matrix head
// expansion, token-packed int32 rows and packed scale rows exist for the TPU's matrix unit and DMA
// rules; here each block simply indexes its head's bytes.
//
// Contract: for sequence b and query head h (kv head h / (H / KVH)):
//   packed tokens [0, min(lengths[b] - tail_count, cap)) are read from kv
//   (int8) dequantized by the per-(token, head) bf16 scales, then tail
//   rows [0, tail_count) from the bf16 window;
//   score = (bf16(q) . k) * scale * k_scale, softmax in f32 (l sums the
//   unscaled p, V is weighted by p * v_scale),
//   out = bf16(sum p * v_scale * v / sum p), returned as f32;
//   with q_bf16 = 0, q enters exact and out = sum p * v_scale * v / sum p.
//
// Bound on the H100: bytes. At batch 256, 12 heads of 64 and a live length
// L it reads B*L*(2*768 + 48) bytes of int8 rows and scales plus the
// 12.6 MB tail window per layer (about 64 MB, 19 us, at L = 128; without
// the tail, about 52 MB, 15 us); the arithmetic is 4 flops per byte.
// Design: a block of four warps per (head, sequence, chunk). Eight lanes
// share a token row, each holding d / 8 dims (one 8- or 16-byte load of
// int8, 16 or 32 bytes of the bf16 window), so one warp load covers four
// tokens and a warp pass sixteen; the dot reduces over the eight lanes.
// Each warp keeps an online softmax (running max, sum and accumulator in
// registers), so no score row sits in shared memory and capacity is
// unlimited; the warps' states merge once at the end. A sequence's tokens
// (packed, then window) split into ``splits`` chunks, one block per
// (head, sequence, chunk), so a long sequence is read by many SMs at once:
// with one chunk the block writes the output, otherwise it writes its
// state (acc, m, l) and a second launch merges the chunks and rounds to
// bf16.
#include "decode_attn.cuh"

namespace {

using decode_attn::kLanesPerTok;
using decode_attn::kThreads;
using decode_attn::kTokPerLoad;
using decode_attn::bf16_round;
using decode_attn::kWarps;
using decode_attn::load_row;

constexpr int kUnroll = 4;                        // loads per warp pass
constexpr int kWarpTok = kTokPerLoad * kUnroll;   // tokens per warp pass

// The (acc, l) state of one (sequence, head), normalized, and rounded to
// bf16 with q_bf16.
__device__ inline float emit(float o, float sum, int q_bf16) {
  const float x = o / fmaxf(sum, 1e-30f);
  return q_bf16 ? bf16_round(x) : x;
}

template <int kDpl>
__global__ void decode_attn_int8_tail_kernel(
    const float* __restrict__ q, const int8_t* __restrict__ kv,
    const __nv_bfloat16* __restrict__ scales, const int* __restrict__ lengths,
    const __nv_bfloat16* __restrict__ tail, float* __restrict__ out,
    float* __restrict__ part, int heads, int kvh, int cap, int rows,
    int tail_count, float scale, int chunk, int q_bf16) {
  constexpr int d = kLanesPerTok * kDpl;
  __shared__ float m_s[kWarps], l_s[kWarps];
  __shared__ float acc_s[kWarps][d];
  const int h = blockIdx.x, b = blockIdx.y, sp = blockIdx.z;
  const int splits = gridDim.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane / kLanesPerTok, col = (lane % kLanesPerTok) * kDpl;
  const int kh = h / (heads / kvh);
  const long long f = (long long)kvh * d;
  const int n_packed = min(max(lengths[b] - tail_count, 0), cap);
  const int n = n_packed + min(max(tail_count, 0), rows);
  const int start = sp * chunk, end = min(n, start + chunk);

  float qv[kDpl], acc[kDpl];
  const float* qrow = q + ((long long)b * heads + h) * d + col;
#pragma unroll
  for (int i = 0; i < kDpl; ++i) {
    qv[i] = q_bf16 ? bf16_round(qrow[i]) : qrow[i];
    acc[i] = 0.0f;
  }
  float m = -INFINITY, l = 0.0f;

  const int8_t* kbase = kv + (long long)kh * d + col;
  const __nv_bfloat16* tbase =
      tail == nullptr ? nullptr : tail + (long long)kh * d + col;
  for (int t0 = start + warp * kWarpTok; t0 < end;
       t0 += kWarps * kWarpTok) {
    float s[kUnroll], ks[kUnroll], vs[kUnroll];
    float vv[kUnroll][kDpl];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u * kTokPerLoad + grp;
      float kk[kDpl];
      // Window rows take no scale: multiplying by 1.0 is exact.
      ks[u] = vs[u] = 1.0f;
      if (t < end && t < n_packed) {
        const long long r = (long long)b * cap + t;
        const __nv_bfloat16* sr = scales + r * 2 * kvh + kh;
        ks[u] = __bfloat162float(sr[0]);
        vs[u] = __bfloat162float(sr[kvh]);
        load_row<kDpl>(kbase + r * 2 * f, kk);
        load_row<kDpl>(kbase + r * 2 * f + f, vv[u]);
      } else if (t < end) {
        const long long r = (long long)b * rows + (t - n_packed);
        load_row<kDpl>(tbase + r * 2 * f, kk);
        load_row<kDpl>(tbase + r * 2 * f + f, vv[u]);
      } else {
#pragma unroll
        for (int i = 0; i < kDpl; ++i) kk[i] = vv[u][i] = 0.0f;
      }
      float dot = 0.0f;
#pragma unroll
      for (int i = 0; i < kDpl; ++i) dot += qv[i] * kk[i];
      s[u] = dot;
    }
    float tile_max = -INFINITY;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int o = 1; o < kLanesPerTok; o <<= 1)
        s[u] += __shfl_xor_sync(0xffffffffu, s[u], o);
      s[u] = t0 + u * kTokPerLoad + grp < end ? s[u] * scale * ks[u]
                                               : -INFINITY;
      tile_max = fmaxf(tile_max, s[u]);
    }
    // The max over the warp's four token groups; token t0 < end is live,
    // so it is finite and the first pass's alpha is exp(-inf) = 0.
#pragma unroll
    for (int o = kLanesPerTok; o < 32; o <<= 1)
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, o));
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < kDpl; ++i) acc[i] *= alpha;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float p = expf(s[u] - m_new);
      l += p;
      const float pv = p * vs[u];
#pragma unroll
      for (int i = 0; i < kDpl; ++i) acc[i] += pv * vv[u][i];
    }
    m = m_new;
  }
  // Sum the four token groups' partial l and acc (m is warp-uniform).
#pragma unroll
  for (int o = kLanesPerTok; o < 32; o <<= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, o);
#pragma unroll
    for (int i = 0; i < kDpl; ++i)
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
  }
  if (lane == 0) {
    m_s[warp] = m;
    l_s[warp] = l;
  }
  if (grp == 0) {
#pragma unroll
    for (int i = 0; i < kDpl; ++i) acc_s[warp][col + i] = acc[i];
  }
  __syncthreads();
  // Merge the warps' states; a warp that saw no token has m = -inf and
  // weighs exp(-inf) = 0 (a chunk with no token keeps m = -inf, l = 0).
  float mx = -INFINITY;
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w]);
  float sum = 0.0f;
  if (mx != -INFINITY)
    for (int w = 0; w < kWarps; ++w) sum += l_s[w] * expf(m_s[w] - mx);
  for (int i = threadIdx.x; i < d; i += kThreads) {
    float o = 0.0f;
    if (mx != -INFINITY)
      for (int w = 0; w < kWarps; ++w) o += acc_s[w][i] * expf(m_s[w] - mx);
    if (splits == 1) {
      out[((long long)b * heads + h) * d + i] = emit(o, sum, q_bf16);
    } else {
      float* pr = part + (((long long)b * heads + h) * splits + sp) * (d + 2);
      pr[i] = o;
      if (i == 0) {
        pr[d] = mx;
        pr[d + 1] = sum;
      }
    }
  }
}

// Merges the chunks' states of one (head, sequence) and emits them.
__global__ void merge_chunks_kernel(const float* __restrict__ part,
                                    float* __restrict__ out, int heads,
                                    int d, int splits, int q_bf16) {
  const int h = blockIdx.x, b = blockIdx.y;
  const float* pr = part + ((long long)b * heads + h) * splits * (d + 2);
  float mx = -INFINITY;
  for (int c = 0; c < splits; ++c) mx = fmaxf(mx, pr[c * (d + 2) + d]);
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    float sum = 0.0f, o = 0.0f;
    if (mx != -INFINITY) {
      for (int c = 0; c < splits; ++c) {
        const float* pc = pr + c * (d + 2);
        const float w = expf(pc[d] - mx);
        sum += pc[d + 1] * w;
        o += pc[i] * w;
      }
    }
    out[((long long)b * heads + h) * d + i] = emit(o, sum, q_bf16);
  }
}

}  // namespace

// ``part``: f32 scratch [B, H, splits, D + 2] when splits > 1 (else
// unused); ``chunk``: tokens per split; ``q_bf16``: 1 rounds q and the
// output to bf16, 0 keeps both exact. The wrapper checks d in {64, 128}.
extern "C" int decode_attn_int8_tail(const void* q, const void* kv,
                                     const void* scales, const void* lengths,
                                     const void* tail, void* out, void* part,
                                     int batch, int heads, int kvh, int d,
                                     int cap, int rows, int tail_count,
                                     int chunk, int splits, int q_bf16,
                                     float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (batch > 0) {
    const dim3 grid(heads, batch, splits);
    if (d == 64) {
      decode_attn_int8_tail_kernel<8><<<grid, kThreads, 0, st>>>(
          (const float*)q, (const int8_t*)kv, (const __nv_bfloat16*)scales,
          (const int*)lengths, (const __nv_bfloat16*)tail, (float*)out,
          (float*)part, heads, kvh, cap, rows, tail_count, scale, chunk,
          q_bf16);
    } else {
      decode_attn_int8_tail_kernel<16><<<grid, kThreads, 0, st>>>(
          (const float*)q, (const int8_t*)kv, (const __nv_bfloat16*)scales,
          (const int*)lengths, (const __nv_bfloat16*)tail, (float*)out,
          (float*)part, heads, kvh, cap, rows, tail_count, scale, chunk,
          q_bf16);
    }
    if (splits > 1) {
      const int err = (int)cudaGetLastError();
      if (err) return err;
      merge_chunks_kernel<<<dim3(heads, batch), d, 0, st>>>(
          (const float*)part, (float*)out, heads, d, splits, q_bf16);
    }
  }
  return (int)cudaGetLastError();
}
