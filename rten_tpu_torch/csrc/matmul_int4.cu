// Group-wise int4 weight GEMMs: out[M, N] = x[M, K] (f32) x W[K, N], W in
// int4 with one f32 scale per (K-group, column).
//
// Replaces: rten_tpu/kernels/gemm.py::matmul_int4_words (kernel
// _int4w_kernel) in both dot modes, and gemm.py::matmul_int4 (kernel
// _int4_kernel). The formulas are the reference's, so greedy tokens follow
// it (u = nibble in [0, 15], q = u - 8, s = scale):
//   mode 0, words, bf16 dot:  sum_k bf16(x) * bf16(bf16(u) * bf16(s))
//                             - 8 * sum_g xsum[m, g] * s[g, n]
//                             (xsum: group sums of the unrounded f32 x);
//   mode 1, words, int8 dot:  x row-quantized to xq (scale absmax / 127);
//                             (sum_g int32(xq . u)_g * s[g, n]
//                              - 8 * sum_g xqsum[m, g] * s[g, n]) * xscale;
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
//   prep:   one block per row: x to bf16 (modes 0, 2) or to xq int8 with
//           its row scale (mode 1, IEEE division, rint), and the group sums.
//   gemm:   one block of 4 warps per 64 x 64 output tile and K split. The
//           64 columns are 32 packed byte columns (32 low nibbles, 32 high
//           ones), so the tile reads 128 contiguous bytes per word row. Per
//           64-deep K step the next step's packed weights, activations and
//           scales are loaded into registers while WMMA (16x16x16) runs on
//           the current one: bf16 operands with f32 accumulators (modes 0,
//           2, dequantized in shared memory), or int8 operands with int32
//           accumulators that are scaled into f32 at each group's end
//           (mode 1). K is split so that the grid holds about four blocks
//           per SM even at decode, where N / 64 tiles alone leave most SMs
//           idle; each split writes its partial tile.
//   reduce: one thread per output: the correction term first (modes 0, 1),
//           then the splits in order, then the row scale (mode 1).
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
enum Mode { WORDS_BF16 = 0, WORDS_INT8 = 1, BYTES_BF16 = 2 };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(PREP_THREADS)
    prep_kernel(const float* __restrict__ x, void* __restrict__ xa,
                float* __restrict__ xsum, float* __restrict__ xscale, int K,
                int group, int mode) {
  __shared__ float red[PREP_THREADS / 32];
  const int m = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const float* row = x + (long long)m * K;
  float scale = 1.0f;
  if (mode == WORDS_INT8) {
    float a = 0.0f;
    for (int k = tid; k < K; k += PREP_THREADS) a = fmaxf(a, fabsf(row[k]));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
    if (lane == 0) red[warp] = a;
    __syncthreads();
    a = red[0];
    for (int w = 1; w < PREP_THREADS / 32; ++w) a = fmaxf(a, red[w]);
    scale = a == 0.0f ? 1.0f : a / 127.0f;
    if (tid == 0) xscale[m] = scale;
  }
  const int G = K / group;
  for (int g = warp; g < G; g += PREP_THREADS / 32) {
    float s = 0.0f;
    for (int k = g * group + lane; k < (g + 1) * group; k += 32) {
      const float v = row[k];
      if (mode == WORDS_INT8) {
        const float q = fminf(fmaxf(rintf(v / scale), -127.0f), 127.0f);
        static_cast<int8_t*>(xa)[(long long)m * K + k] = (int8_t)q;
        s += q;
      } else {
        static_cast<__nv_bfloat16*>(xa)[(long long)m * K + k] =
            __float2bfloat16_rn(v);
        s += v;
      }
    }
    s = warp_sum(s);
    if (lane == 0 && mode != BYTES_BF16) xsum[(long long)m * G + g] = s;
  }
}

// Registers of one K step: packed weights (16 bytes a thread), activation
// bytes (64 bf16 or 32 int8 a row half: up to four 16-byte vectors) and,
// for threads 0..63, the scale of tile column tid.
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
  constexpr int VECS = MODE == WORDS_INT8 ? 2 : 4;
#pragma unroll
  for (int v = 0; v < VECS; ++v) {
    st.a[v] = make_int4(0, 0, 0, 0);
    if (gm < M) {
      const int4* src =
          MODE == WORDS_INT8
              ? reinterpret_cast<const int4*>(
                    static_cast<const int8_t*>(xa) + (long long)gm * K + k0 +
                    part * 32)
              : reinterpret_cast<const int4*>(
                    static_cast<const __nv_bfloat16*>(xa) +
                    (long long)gm * K + k0 + part * 32);
      st.a[v] = src[v];
    }
  }
  if (MODE != WORDS_INT8 && tid < BN) {
    const int col = tid < HALF ? col_lo + tid : col_hi + tid - HALF;
    st.s = scales[(long long)(k0 / group) * N + col];
  }
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
    int4_gemm_kernel(const void* __restrict__ xa, const void* __restrict__ w,
                     const float* __restrict__ scales, float* __restrict__ ws,
                     int M, int K, int N, int group, int splits) {
  // bf16 modes: A bf16 [BM][LDH] and B bf16 [BK][LDH], the f32 result
  // tile [BM][LDC] over both at the end; s_s the step's bf16 scales.
  // int8 mode: A int8 as [BK/16][BM][32] and B int8 as [BN/16][BK][32] (16
  // bytes used per 32-byte row, so every WMMA fragment starts 32-byte
  // aligned), and the int32 tile [BM][LDC] apart from them.
  constexpr int AB_BYTES = MODE == WORDS_INT8 ? 2 * (BK / 16) * BM * 32
                                               : 2 * BM * LDH * 2;
  constexpr int C_BYTES = BM * LDC * 4;
  constexpr int SMEM = MODE == WORDS_INT8
                           ? AB_BYTES + C_BYTES
                           : (AB_BYTES > C_BYTES ? AB_BYTES : C_BYTES);
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
  int8_t* a_8 = reinterpret_cast<int8_t*>(smem);
  int8_t* b_8 = a_8 + (BK / 16) * BM * 32;
  int* c_i = reinterpret_cast<int*>(smem + AB_BYTES);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc_i[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fill_fragment(acc[i][j], 0.0f);
      wmma::fill_fragment(acc_i[i][j], 0);
    }
  // int8 mode: this thread's 32 outputs, all in tile column tid % BN.
  float acc_f[BM * BN / THREADS];
#pragma unroll
  for (int i = 0; i < BM * BN / THREADS; ++i) acc_f[i] = 0.0f;
  const int my_col = tid % BN;
  const int my_gcol = my_col < HALF ? col_lo + my_col : col_hi + my_col - HALF;

  Step cur, nxt;
  if (k_begin < k_end)
    load_step<MODE>(cur, xa, w, scales, M, K, N, group, m0, bc0, col_lo,
                    col_hi, k_begin);
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    // Activations and scales of this step into shared memory.
    const int row = tid >> 1, part = tid & 1;
    if (MODE == WORDS_INT8) {
#pragma unroll
      for (int v = 0; v < 2; ++v)
        *reinterpret_cast<int4*>(a_8 + ((part * 2 + v) * BM + row) * 32) =
            cur.a[v];
    } else {
#pragma unroll
      for (int v = 0; v < 4; ++v)
        *reinterpret_cast<int4*>(a_h + row * LDH + part * 32 + v * 8) =
            cur.a[v];
      if (tid < BN) s_s[tid] = __bfloat162float(__float2bfloat16_rn(cur.s));
    }
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
          if (MODE == WORDS_INT8) {
            b_8[((c >> 4) * BK + kr) * 32 + (c & 15)] = (int8_t)lo;
            b_8[(((c + HALF) >> 4) * BK + kr) * 32 + ((c + HALF) & 15)] =
                (int8_t)hi;
          } else {
            b_h[kr * LDH + c] = __float2bfloat16_rn((float)lo * s_s[c]);
            b_h[kr * LDH + HALF + c] =
                __float2bfloat16_rn((float)hi * s_s[HALF + c]);
          }
        }
      }
    }
    __syncthreads();
    if (warp_live) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        if (MODE == WORDS_INT8) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                         wmma::row_major> fa[2];
          wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                         wmma::row_major> fb[2];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wmma::load_matrix_sync(
                fa[i], a_8 + ((kk / 16) * BM + wm * 32 + i * 16) * 32, 32);
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::load_matrix_sync(
                fb[j], b_8 + ((wn * 2 + j) * BK + kk) * 32, 32);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              wmma::mma_sync(acc_i[i][j], fa[i], fb[j], acc_i[i][j]);
        } else {
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
    }
    if (MODE == WORDS_INT8 && (k0 + BK) % group == 0) {
      // End of a group: its exact int32 dot times the f32 scale.
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::store_matrix_sync(
              c_i + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16, acc_i[i][j],
              LDC, wmma::mem_row_major);
          wmma::fill_fragment(acc_i[i][j], 0);
        }
      __syncthreads();
      const float s = scales[(long long)(k0 / group) * N + my_gcol];
#pragma unroll
      for (int i = 0; i < BM * BN / THREADS; ++i)
        acc_f[i] += (float)c_i[(tid / BN + i * (THREADS / BN)) * LDC +
                               my_col] * s;
    }
    __syncthreads();
    cur = nxt;
  }

  float* part_out = ws + (long long)z * M * N;
  if constexpr (MODE == WORDS_INT8) {
#pragma unroll
    for (int i = 0; i < BM * BN / THREADS; ++i) {
      const int gm = m0 + tid / BN + i * (THREADS / BN);
      if (gm < M) part_out[(long long)gm * N + my_gcol] = acc_f[i];
    }
  } else {
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
}

__global__ void reduce_kernel(const float* __restrict__ ws,
                              const float* __restrict__ xsum,
                              const float* __restrict__ scales,
                              const float* __restrict__ xscale,
                              float* __restrict__ out, int M, int N, int G,
                              int splits, int mode) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)M * N) return;
  const int m = (int)(idx / N), n = (int)(idx % N);
  float acc = 0.0f;
  if (mode != BYTES_BF16) {
    float c = 0.0f;
    for (int g = 0; g < G; ++g)
      c += xsum[(long long)m * G + g] * scales[(long long)g * N + n];
    acc = c * -8.0f;
  }
  for (int s = 0; s < splits; ++s) acc += ws[((long long)s * M + m) * N + n];
  if (mode == WORDS_INT8) acc *= xscale[m];
  out[idx] = acc;
}

}  // namespace

extern "C" int matmul_int4(const void* x, const void* w, const void* scales,
                           void* xa, void* xsum, void* xscale, void* ws,
                           void* out, int M, int K, int N, int group,
                           int splits, int mode, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  prep_kernel<<<M, PREP_THREADS, 0, st>>>((const float*)x, xa, (float*)xsum,
                                          (float*)xscale, K, group, mode);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(N / BN, (M + BM - 1) / BM, splits);
  const float* s = (const float*)scales;
  float* part = (float*)ws;
  if (mode == WORDS_BF16)
    int4_gemm_kernel<WORDS_BF16><<<grid, THREADS, 0, st>>>(
        xa, w, s, part, M, K, N, group, splits);
  else if (mode == WORDS_INT8)
    int4_gemm_kernel<WORDS_INT8><<<grid, THREADS, 0, st>>>(
        xa, w, s, part, M, K, N, group, splits);
  else
    int4_gemm_kernel<BYTES_BF16><<<grid, THREADS, 0, st>>>(
        xa, w, s, part, M, K, N, group, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)M * N;
  reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      part, (const float*)xsum, s, (const float*)xscale, (float*)out, M, N,
      K / group, splits, mode);
  return (int)cudaGetLastError();
}
