// Group-wise int4 weight GEMMs: out[M, N] = x[M, K] (f32) x W[K, N], W in
// int4 with one f32 scale per (K-group, column).
//
// Replaces: rten_tpu/kernels/gemm.py::matmul_int4_words (kernel
// _int4w_kernel) in its bf16 dot mode, and gemm.py::matmul_int4 (kernel
// _int4_kernel); the int8 dot mode has a kernel of its own
// (matmul_int4_int8dot.cu). The formulas are the reference's, so greedy
// tokens follow it (u = nibble in [0, 15], q = u - 8, s = scale):
//   mode 0, words, bf16 dot:  sum_k bf16(x) * bf16(bf16(u) * bf16(s))
//                             - 8 * sum_g xsum[m, g] * s[g, n]
//                             (xsum: group sums of the unrounded f32 x);
//   mode 2, bytes:            sum_k bf16(x) * bf16(bf16(q) * bf16(s)).
// Layouts: words int32 [K/4, N/2], byte i of word r holds K row 4r + i;
// bytes uint8 [K, N/2]. In both, within each 256-column tile, byte j holds
// column j in its low nibble and column j + 128 in its high one.
//
// Bound on the H100: bytes at decode (M = 16: 0.5 B per weight, 32 flops
// per weight byte; TinyLlama's head is 32.8 MB, about 10 us at 3.35 TB/s),
// operations at prefill (M = 1024). The TPU kernel's sublane bitcast and
// 8-group block sizing exist for Mosaic and have no counterpart here.
// Design, simple first: three launches per call.
//   prep:   one block per row: x to bf16, and the group sums (mode 0).
//   gemm:   one block of 4 warps per 64 x 64 output tile and K split. The
//           64 columns are 32 packed byte columns (32 low nibbles, 32 high
//           ones), so the tile reads 128 contiguous bytes per word row. Per
//           64-deep K step the next step's packed weights, activations and
//           scales are loaded into registers while WMMA (16x16x16) runs on
//           the current one: bf16 operands, dequantized in shared memory,
//           with f32 accumulators. K is split so that the grid holds about
//           four blocks per SM even at decode, where N / 64 tiles alone
//           leave most SMs idle; each split writes its partial tile.
//   reduce: one thread per output: the correction term first (mode 0),
//           then the splits in order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int BM = 64, BN = 64, BK = 64, THREADS = 128;
constexpr int HALF = BN / 2;    // packed byte columns per tile
constexpr int LDH = 72;         // bf16 tiles: 144-byte rows
constexpr int LDC = 68;         // f32 / int32 result tile
constexpr int PREP_THREADS = 256;
enum Mode { WORDS_BF16 = 0, BYTES_BF16 = 2 };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(PREP_THREADS)
    prep_kernel(const float* __restrict__ x, void* __restrict__ xa,
                float* __restrict__ xsum, int K, int group, int mode) {
  const int m = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const float* row = x + (long long)m * K;
  const int G = K / group;
  for (int g = warp; g < G; g += PREP_THREADS / 32) {
    float s = 0.0f;
    for (int k = g * group + lane; k < (g + 1) * group; k += 32) {
      const float v = row[k];
      static_cast<__nv_bfloat16*>(xa)[(long long)m * K + k] =
          __float2bfloat16_rn(v);
      s += v;
    }
    s = warp_sum(s);
    if (lane == 0 && mode != BYTES_BF16) xsum[(long long)m * G + g] = s;
  }
}

// Registers of one K step: packed weights (16 bytes a thread), activations
// (32 bf16 a row half: four 16-byte vectors) and, for threads 0..63, the
// scale of tile column tid.
struct Step {
  int4 w;
  int4 a[4];
  float s;
};

template <int MODE>
__device__ __forceinline__ void load_step(
    Step& st, const void* __restrict__ xa, const void* __restrict__ w,
    const float* __restrict__ scales, int M, int K, int N, int group,
    int m0, int bc0, int col_lo, int col_hi, int k0) {
  const int tid = threadIdx.x;
  const int half_n = N / 2;
  if (MODE == BYTES_BF16) {
    const int r = tid >> 1, cb = (tid & 1) * 16;
    st.w = *reinterpret_cast<const int4*>(
        static_cast<const uint8_t*>(w) + (long long)(k0 + r) * half_n + bc0 +
        cb);
  } else {
    const int r = tid >> 3, cw = (tid & 7) * 4;
    st.w = *reinterpret_cast<const int4*>(
        static_cast<const int32_t*>(w) + (long long)(k0 / 4 + r) * half_n +
        bc0 + cw);
  }
  const int row = tid >> 1, part = tid & 1, gm = m0 + row;
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    st.a[v] = make_int4(0, 0, 0, 0);
    if (gm < M)
      st.a[v] = reinterpret_cast<const int4*>(
          static_cast<const __nv_bfloat16*>(xa) + (long long)gm * K + k0 +
          part * 32)[v];
  }
  if (tid < BN) {
    const int col = tid < HALF ? col_lo + tid : col_hi + tid - HALF;
    st.s = scales[(long long)(k0 / group) * N + col];
  }
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
    int4_gemm_kernel(const void* __restrict__ xa, const void* __restrict__ w,
                     const float* __restrict__ scales, float* __restrict__ ws,
                     int M, int K, int N, int group, int splits) {
  // A bf16 [BM][LDH] and B bf16 [BK][LDH], the f32 result tile [BM][LDC]
  // over both at the end; s_s the step's bf16 scales.
  constexpr int AB_BYTES = 2 * BM * LDH * 2;
  constexpr int C_BYTES = BM * LDC * 4;
  constexpr int SMEM = AB_BYTES > C_BYTES ? AB_BYTES : C_BYTES;
  __shared__ __align__(128) unsigned char smem[SMEM];
  __shared__ float s_s[BN];

  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int bc0 = blockIdx.x * HALF;              // first packed byte column
  const int col_lo = (bc0 / 128) * 256 + bc0 % 128;  // column of tile col 0
  const int col_hi = col_lo + 128;                   // of tile col HALF
  const int m0 = blockIdx.y * BM;
  const int G = K / group;
  const int z = blockIdx.z;
  const int k_begin = (int)((long long)z * G / splits) * group;
  const int k_end = (int)((long long)(z + 1) * G / splits) * group;
  const bool warp_live = m0 + wm * 32 < M;   // some row of the warp is real

  __nv_bfloat16* a_h = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* b_h = a_h + BM * LDH;
  float* c_f = reinterpret_cast<float*>(smem);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  Step cur, nxt;
  if (k_begin < k_end)
    load_step<MODE>(cur, xa, w, scales, M, K, N, group, m0, bc0, col_lo,
                    col_hi, k_begin);
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    // Activations and scales of this step into shared memory.
    const int row = tid >> 1, part = tid & 1;
#pragma unroll
    for (int v = 0; v < 4; ++v)
      *reinterpret_cast<int4*>(a_h + row * LDH + part * 32 + v * 8) =
          cur.a[v];
    if (tid < BN) s_s[tid] = __bfloat162float(__float2bfloat16_rn(cur.s));
    __syncthreads();
    if (k0 + BK < k_end)
      load_step<MODE>(nxt, xa, w, scales, M, K, N, group, m0, bc0, col_lo,
                      col_hi, k0 + BK);
    // Unpack this step's weights into the B tile.
    const uint32_t* words = reinterpret_cast<const uint32_t*>(&cur.w);
    if (MODE == BYTES_BF16) {
      const int r = tid >> 1, cb = (tid & 1) * 16;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const uint32_t byte = (words[e >> 2] >> (8 * (e & 3))) & 0xFFu;
        const int c = cb + e;
        b_h[r * LDH + c] = __float2bfloat16_rn(
            (float)((int)(byte & 0xFu) - 8) * s_s[c]);
        b_h[r * LDH + HALF + c] = __float2bfloat16_rn(
            (float)((int)(byte >> 4) - 8) * s_s[HALF + c]);
      }
    } else {
      const int r = tid >> 3, cw = (tid & 7) * 4;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = cw + i;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const uint32_t byte = (words[i] >> (8 * b)) & 0xFFu;
          const int kr = 4 * r + b;
          const uint32_t lo = byte & 0xFu, hi = byte >> 4;
          b_h[kr * LDH + c] = __float2bfloat16_rn((float)lo * s_s[c]);
          b_h[kr * LDH + HALF + c] =
              __float2bfloat16_rn((float)hi * s_s[HALF + c]);
        }
      }
    }
    __syncthreads();
    if (warp_live) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], a_h + (wm * 32 + i * 16) * LDH + kk,
                                 LDH);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], b_h + kk * LDH + wn * 32 + j * 16,
                                 LDH);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
    }
    __syncthreads();
    cur = nxt;
  }

  float* part_out = ws + (long long)z * M * N;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(c_f + (wm * 32 + i * 16) * LDC + wn * 32 +
                                  j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < BM * BN; e += THREADS) {
    const int r = e / BN, c = e % BN, gm = m0 + r;
    const int gcol = c < HALF ? col_lo + c : col_hi + c - HALF;
    if (gm < M) part_out[(long long)gm * N + gcol] = c_f[r * LDC + c];
  }
}

__global__ void reduce_kernel(const float* __restrict__ ws,
                              const float* __restrict__ xsum,
                              const float* __restrict__ scales,
                              float* __restrict__ out, int M, int N, int G,
                              int splits, int mode) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)M * N) return;
  const int m = (int)(idx / N), n = (int)(idx % N);
  float acc = 0.0f;
  if (mode == WORDS_BF16) {
    float c = 0.0f;
    for (int g = 0; g < G; ++g)
      c += xsum[(long long)m * G + g] * scales[(long long)g * N + n];
    acc = c * -8.0f;
  }
  for (int s = 0; s < splits; ++s) acc += ws[((long long)s * M + m) * N + n];
  out[idx] = acc;
}

}  // namespace

// mode 0 (words, bf16 dot) or 2 (bytes); any other mode is refused.
extern "C" int matmul_int4(const void* x, const void* w, const void* scales,
                           void* xa, void* xsum, void* ws, void* out, int M,
                           int K, int N, int group, int splits, int mode,
                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (mode != WORDS_BF16 && mode != BYTES_BF16)
    return (int)cudaErrorInvalidValue;
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  prep_kernel<<<M, PREP_THREADS, 0, st>>>((const float*)x, xa, (float*)xsum,
                                          K, group, mode);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(N / BN, (M + BM - 1) / BM, splits);
  const float* s = (const float*)scales;
  float* part = (float*)ws;
  if (mode == WORDS_BF16)
    int4_gemm_kernel<WORDS_BF16><<<grid, THREADS, 0, st>>>(
        xa, w, s, part, M, K, N, group, splits);
  else
    int4_gemm_kernel<BYTES_BF16><<<grid, THREADS, 0, st>>>(
        xa, w, s, part, M, K, N, group, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)M * N;
  reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      part, (const float*)xsum, s, (float*)out, M, N, K / group, splits,
      mode);
  return (int)cudaGetLastError();
}
