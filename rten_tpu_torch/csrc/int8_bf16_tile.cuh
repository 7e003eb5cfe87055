// Shared main loop of the int8-weight GEMM kernels (matmul_int8_wo.cu,
// head_argmax_int8.cu): one 64x64 output tile of x[M, K] (f32, rounded to
// bf16) times W[K, N] (int8, converted exactly to bf16), f32 accumulation
// on the tensor cores through WMMA (mma.sync, 16x16x16 bf16 fragments).
// Column scales are applied by the caller's epilogue, after the sum.
//
// Four warps per block, each owning a 32x32 quarter (2x2 fragments). Per
// 32-deep K step the block stages a 64x32 bf16 x tile and a 32x64 bf16 W
// tile in shared memory (W read as 8-byte vectors, so N must be a multiple
// of 8 and W 8-byte aligned; the wrappers pad the LM head's columns once,
// at quantize time). The finished tile lands in shared memory as f32 for
// the epilogue.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace int8tile {

constexpr int BM = 64, BN = 64, BK = 32, THREADS = 128;
constexpr int LDA = BK + 8;  // bf16 elements; rows stay 32-byte aligned
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;  // f32 elements

struct __align__(32) Smem {
  __nv_bfloat16 a[BM * LDA];
  __nv_bfloat16 b[BK * LDB];
  float c[BM * LDC];
};

// Computes the tile at rows [m0, m0 + BM) and columns [n0, n0 + BN) into
// s.c (rows or columns past M / N hold zeros). All threads must call it.
__device__ inline void mainloop(const float* __restrict__ x,
                                const int8_t* __restrict__ w, int M, int K,
                                int N, int m0, int n0, Smem& s) {
  using namespace nvcuda;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int ar = tid >> 1, ac = (tid & 1) * 16;  // x tile: 16 per thread
  const int br = tid >> 2, bc = (tid & 3) * 16;  // W tile: 16 per thread
  for (int k0 = 0; k0 < K; k0 += BK) {
    const int gm = m0 + ar;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int gk = k0 + ac + c;
      const float v = (gm < M && gk < K) ? x[(long long)gm * K + gk] : 0.0f;
      s.a[ar * LDA + ac + c] = __float2bfloat16_rn(v);
    }
    const int gk = k0 + br;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gn = n0 + bc + half * 8;
      int2 raw = make_int2(0, 0);
      if (gk < K && gn < N)
        raw = *reinterpret_cast<const int2*>(w + (long long)gk * N + gn);
      const int8_t* bytes = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        s.b[br * LDB + bc + half * 8 + e] =
            __float2bfloat16_rn((float)bytes[e]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], s.a + (wm * 32 + i * 16) * LDA + kk,
                               LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], s.b + kk * LDB + wn * 32 + j * 16,
                               LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(s.c + (wm * 32 + i * 16) * LDC + wn * 32 +
                                  j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
}

}  // namespace int8tile
