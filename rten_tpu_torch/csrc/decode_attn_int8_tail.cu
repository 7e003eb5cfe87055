// Single-query decode attention over the int8 KV cache plus the bf16 tail
// window.
//
// Replaces: rten_tpu/kernels/attention.py::flash_decode_flat in its
// int8 + tail mode (body _decode_flat_quant_kernel, tail round at
// attention.py:1600-1626). The TPU kernel's one-hot E-matrix head
// expansion, token-packed int32 rows and packed scale rows exist for the
// TPU's matrix unit and DMA rules; here each block simply indexes its
// head's bytes.
//
// Contract: for sequence b and query head h (kv head h / (H / KVH)):
//   packed tokens [0, min(lengths[b] - tail_count, cap)) are read from kv
//   (int8) dequantized by the per-(token, head) bf16 scales, then tail
//   rows [0, tail_count) from the bf16 window;
//   score = (bf16(q) . k) * scale * k_scale, softmax in f32,
//   out = bf16(sum p * v_scale * v / sum p), returned as f32.
//
// Bound on the H100: bytes. At batch 256, 12 heads of 64 and a live length
// L it reads B*L*(2*768 + 48) bytes of int8 rows and scales plus the
// 12.6 MB tail window per layer (about 64 MB, 19 us, at L = 128); the
// arithmetic is 4 flops per byte. Design: one block of 128 threads per
// (sequence, head). Pass 1: each thread scores whole tokens (16-byte row
// loads, q broadcast from shared memory) into a shared score row. Pass 2:
// block max and exp-sum. Pass 3: threads split as (dim, token group) so a
// warp reads a contiguous V row segment; partial sums meet in shared
// memory. Exact two-pass softmax instead of the TPU's online softmax: the
// whole score row (cap + R floats) fits in shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ float block_reduce(float v, bool is_max, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    float other = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? fmaxf(v, other) : v + other;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < kThreads / 32; ++w)
    v = is_max ? fmaxf(v, red[w]) : v + red[w];
  return v;
}

__global__ void decode_attn_int8_tail_kernel(
    const float* __restrict__ q, const int8_t* __restrict__ kv,
    const __nv_bfloat16* __restrict__ scales, const int* __restrict__ lengths,
    const __nv_bfloat16* __restrict__ tail, float* __restrict__ out,
    int heads, int kvh, int d, int cap, int rows, int tail_count,
    float scale) {
  extern __shared__ float smem[];
  __shared__ float red[kThreads / 32];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int kh = h / (heads / kvh);
  const long long f = (long long)kvh * d;
  float* q_s = smem;               // [d] bf16-rounded q
  float* p_s = smem + d;           // [cap + rows] scores, then weights
  float* acc_s = p_s + cap + rows; // [kThreads] partial outputs

  const float* qrow = q + ((long long)b * heads + h) * d;
  for (int i = tid; i < d; i += kThreads)
    q_s[i] = __bfloat162float(__float2bfloat16_rn(qrow[i]));
  const int n_packed = min(max(lengths[b] - tail_count, 0), cap);
  const int n_tail = min(max(tail_count, 0), rows);
  const int n = n_packed + n_tail;
  __syncthreads();

  // Pass 1: scores, one token per thread.
  for (int t = tid; t < n; t += kThreads) {
    float dot = 0.0f;
    if (t < n_packed) {
      const long long row = ((long long)b * cap + t) * 2;  // plane 0 = K
      const int4* kr = reinterpret_cast<const int4*>(kv + row * f + kh * d);
      for (int c = 0; c < d / 16; ++c) {
        const int4 raw = kr[c];
        const int8_t* bytes = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
        for (int e = 0; e < 16; ++e) dot += q_s[c * 16 + e] * (float)bytes[e];
      }
      dot = dot * scale * __bfloat162float(scales[row * kvh + kh]);
    } else {
      const long long row = ((long long)b * rows + (t - n_packed)) * 2;
      const int4* tr =
          reinterpret_cast<const int4*>(tail + row * f + kh * d);
      for (int c = 0; c < d / 8; ++c) {
        const int4 raw = tr[c];
        const __nv_bfloat16* vals =
            reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dot += q_s[c * 8 + e] * __bfloat162float(vals[e]);
      }
      dot = dot * scale;
    }
    p_s[t] = dot;
  }
  __syncthreads();

  // Pass 2: softmax weights; packed tokens fold in their V scale.
  float m = -INFINITY;
  for (int t = tid; t < n; t += kThreads) m = fmaxf(m, p_s[t]);
  m = block_reduce(m, true, red);
  float l = 0.0f;
  for (int t = tid; t < n; t += kThreads) {
    const float p = expf(p_s[t] - m);
    l += p;
    p_s[t] = t < n_packed
        ? p * __bfloat162float(
                  scales[(((long long)b * cap + t) * 2 + 1) * kvh + kh])
        : p;
  }
  l = block_reduce(l, false, red);  // its barriers also publish p_s

  // Pass 3: out[i] = sum_t p_s[t] * v[t][i], threads as (dim, group).
  const int groups = kThreads / d;
  const int i = tid % d, g = tid / d;
  float acc = 0.0f;
  if (g < groups) {
    for (int t = g; t < n; t += groups) {
      float v;
      if (t < n_packed) {
        v = (float)kv[(((long long)b * cap + t) * 2 + 1) * f + kh * d + i];
      } else {
        v = __bfloat162float(
            tail[(((long long)b * rows + (t - n_packed)) * 2 + 1) * f +
                 kh * d + i]);
      }
      acc += p_s[t] * v;
    }
  }
  acc_s[tid] = acc;
  __syncthreads();
  if (tid < d) {
    float sum = 0.0f;
    for (int gg = 0; gg < groups; ++gg) sum += acc_s[gg * d + tid];
    const float o = sum / fmaxf(l, 1e-30f);
    out[((long long)b * heads + h) * d + tid] =
        __bfloat162float(__float2bfloat16_rn(o));
  }
}

}  // namespace

extern "C" int decode_attn_int8_tail(const void* q, const void* kv,
                                     const void* scales, const void* lengths,
                                     const void* tail, void* out, int batch,
                                     int heads, int kvh, int d, int cap,
                                     int rows, int tail_count, float scale,
                                     void* stream) {
  const size_t smem = sizeof(float) * ((size_t)d + cap + rows + kThreads);
  dim3 grid(heads, batch);
  if (batch > 0) {
    decode_attn_int8_tail_kernel<<<grid, kThreads, smem,
                                   (cudaStream_t)stream>>>(
        (const float*)q, (const int8_t*)kv, (const __nv_bfloat16*)scales,
        (const int*)lengths, (const __nv_bfloat16*)tail, (float*)out, heads,
        kvh, d, cap, rows, tail_count, scale);
  }
  return (int)cudaGetLastError();
}
