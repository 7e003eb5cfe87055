// Prefill self-attention (F1): blockwise attention with an online softmax,
// in f32 throughout.
//
// Replaces: rten_tpu/kernels/attention.py::flash_attention (kernel
// _flash_kernel) at the shapes where the reference runs its kernel (head
// dim a multiple of 128, S >= 128 a multiple of 128: prefill of a d = 128
// model, transformer.py:797). The wrapper takes d = 128.
//
// Contract: q, k, v f32 [B, H, S, D], contiguous (k and v already repeated
// to H heads). For query i of (b, h): s_ij = (q_i . k_j) * scale in f32,
// set to -1e30 where causal and j > i; the running max m (from -1e30), sum
// l and accumulator acc follow the online softmax over key tiles, and
// out_i = acc / max(l, 1e-30). A key tile wholly above the diagonal would
// add exp(-1e30 - m) = 0 to every sum, so causal blocks skip it.
//
// Bound on the H100: operations. A causal prefill does about 2*B*H*S^2*D
// FLOPs (two products of S^2/2 dot products of D) against 4*B*H*S*D*4
// bytes; at B 16, 32 heads, S 512, D 128 that is 34 GFLOP, 0.51 ms at the
// 67 TFLOP/s of f32 outside the tensor cores, and 0.54 GB, 0.16 ms. It
// stays in f32 (no TF32 or bf16 tensor-core product) so that it computes
// the reference's arithmetic. Design: one block of 256 threads per (b, h,
// 64 queries); the block's Q tile and one 64-key K and V tile at a time sit
// in dynamic shared memory (97 KB, two blocks an SM). Thread (ty, tx) of
// a 16 x 16 grid holds the scores of queries 4ty..4ty+3 against keys
// tx + 16j, so its K reads fall in distinct banks (rows padded to 132
// floats) and its Q reads are broadcast; the 16 threads of a query row
// reduce its max and sum with shuffles; the P tile goes through shared
// memory (over the dead K tile) into P.V, where each thread accumulates
// 4 queries x 8 dims. Query tiles run heaviest first.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kD = 128, kBQ = 64, kBK = 64, kThreads = 256;
constexpr int kKStride = kD + 4;  // K tile row stride (floats)
constexpr float kNegInf = -1e30f;
constexpr int kSmemBytes = (kBQ * kD + kBK * kKStride + kBK * kD) * 4;

__global__ void __launch_bounds__(kThreads, 2)
    prefill_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ out,
                   int s, int causal, float scale) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kBQ][kD]
  float* ks = qs + kBQ * kD;                    // [kBK][kKStride]
  float* ps = ks;                               // [kBQ][kBK], after scores
  float* vs = ks + kBK * kKStride;              // [kBK][kD]
  const int qb = gridDim.x - 1 - blockIdx.x;    // heaviest tiles first
  const long long head =
      ((long long)blockIdx.z * gridDim.y + blockIdx.y) * s * kD;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = qb * kBQ;
  constexpr int kChunks = kD / 4;  // float4 per row

  for (int f = tid; f < kBQ * kChunks; f += kThreads) {
    const int r = f / kChunks, c = f % kChunks;
    reinterpret_cast<float4*>(qs + r * kD)[c] =
        reinterpret_cast<const float4*>(q + head + (long long)(q0 + r) * kD)[c];
  }
  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.0f;
  }

  const int nk = causal ? qb + 1 : s / kBK;  // kBK == kBQ
  for (int kb = 0; kb < nk; ++kb) {
    __syncthreads();  // the last P.V is done with ps (over ks) and vs
    const long long k0 = head + (long long)kb * kBK * kD;
    for (int f = tid; f < kBK * kChunks; f += kThreads) {
      const int r = f / kChunks, c = f % kChunks;
      *reinterpret_cast<float4*>(ks + r * kKStride + 4 * c) =
          reinterpret_cast<const float4*>(k + k0 + (long long)r * kD)[c];
      reinterpret_cast<float4*>(vs + r * kD)[c] =
          reinterpret_cast<const float4*>(v + k0 + (long long)r * kD)[c];
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
#pragma unroll 4
    for (int d0 = 0; d0 < kD; d0 += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (4 * ty + i) * kD + d0);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * kKStride +
                                                 d0);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = sc[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          sc[i][j] = fmaf(qv[i].w, kv[j].w, a);
        }
    }

    // Scale, mask the diagonal tile, and update each query row's softmax
    // state; the 16 threads of a row (one half-warp) reduce by shuffles.
    const bool diag = causal && kb == qb;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = sc[i][j] * scale;
        if (diag && tx + 16 * j > 4 * ty + i) x = kNegInf;
        sc[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int o = 1; o < 16; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = expf(sc[i][j] - m_new);
        psum += sc[i][j];
      }
#pragma unroll
      for (int o = 1; o < 16; o <<= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // every thread is done reading ks
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ps[(4 * ty + i) * kBK + tx + 16 * j] = sc[i][j];
    __syncthreads();

    // acc[i][c] += sum_t p[4ty + i][t] * v[t][dim c], dims 4tx..4tx+3 and
    // 64 + 4tx..64 + 4tx + 3.
#pragma unroll 2
    for (int t0 = 0; t0 < kBK; t0 += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = *reinterpret_cast<const float4*>(ps + (4 * ty + i) * kBK + t0);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 va =
            *reinterpret_cast<const float4*>(vs + (t0 + u) * kD + 4 * tx);
        const float4 vb =
            *reinterpret_cast<const float4*>(vs + (t0 + u) * kD + 64 + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = u == 0 ? p4[i].x
                          : u == 1 ? p4[i].y
                          : u == 2 ? p4[i].z
                                   : p4[i].w;
          acc[i][0] = fmaf(p, va.x, acc[i][0]);
          acc[i][1] = fmaf(p, va.y, acc[i][1]);
          acc[i][2] = fmaf(p, va.z, acc[i][2]);
          acc[i][3] = fmaf(p, va.w, acc[i][3]);
          acc[i][4] = fmaf(p, vb.x, acc[i][4]);
          acc[i][5] = fmaf(p, vb.y, acc[i][5]);
          acc[i][6] = fmaf(p, vb.z, acc[i][6]);
          acc[i][7] = fmaf(p, vb.w, acc[i][7]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float den = fmaxf(l[i], 1e-30f);
    float* orow = out + head + (long long)(q0 + 4 * ty + i) * kD;
    *reinterpret_cast<float4*>(orow + 4 * tx) =
        make_float4(acc[i][0] / den, acc[i][1] / den, acc[i][2] / den,
                    acc[i][3] / den);
    *reinterpret_cast<float4*>(orow + 64 + 4 * tx) =
        make_float4(acc[i][4] / den, acc[i][5] / den, acc[i][6] / den,
                    acc[i][7] / den);
  }
}

}  // namespace

// The wrapper checks d == 128 and S a multiple of 128 (so of the 64-row
// tiles), contiguity and f32.
extern "C" int prefill_attn(const void* q, const void* k, const void* v,
                            void* out, int batch, int heads, int s, int d,
                            int causal, float scale, void* stream) {
  if (d != kD || s % kBQ) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      prefill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  if (batch > 0 && heads > 0 && s > 0) {
    const dim3 grid(s / kBQ, heads, batch);
    prefill_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)out, s,
        causal, scale);
  }
  return (int)cudaGetLastError();
}
