// Fused int8 LM head + argmax: idx[m] = argmax_n (bf16(x) @ bf16(W))[m, n]
// * col_scale[n] over n < n_valid, without materialising the logits.
//
// Replaces: rten_tpu/kernels/gemm.py::matmul_argmax_int8 (greedy decode
// head, reached through rten_tpu/models/transformer.py::decode_step_argmax).
//
// Bound on the H100: operations at batch 256. 2 * 256 * 768 * 50264 =
// 19.8 GFLOP, about 20 us at the 989 TFLOP/s bf16 tensor-core peak; the
// 38.6 MB weight alone needs 11.5 us. Design: pass 1 runs
// int8_bf16_tile.cuh's 64x64 WMMA tile per block and reduces each tile row
// to (max, first index) in shared memory, writing one partial per
// (row, vocab tile); pass 2 has one warp per row fold the partials. Both
// folds keep the lower index on equal values, so ties go to the lowest
// vocabulary index within and across tiles as in the reference
// (gemm.py:252-260). Columns at or past n_valid (the padding) are ignored.
#include <limits.h>
#include <math.h>

#include "int8_bf16_tile.cuh"

namespace {

__device__ inline void better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ inline void warp_fold(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    better(v, i, ov, oi);
  }
}

__global__ void __launch_bounds__(int8tile::THREADS)
    head_argmax_tile_kernel(const float* __restrict__ x,
                            const int8_t* __restrict__ w,
                            const float* __restrict__ scales,
                            float* __restrict__ part_val,
                            int* __restrict__ part_idx, int M, int K, int N,
                            int n_valid, int n_tiles) {
  using namespace int8tile;
  __shared__ __align__(32) unsigned char raw[sizeof(Smem)];
  Smem& s = *reinterpret_cast<Smem*>(raw);
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  mainloop(x, w, M, K, N, m0, n0, s);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int rr = 0; rr < BM / (THREADS / 32); ++rr) {
    const int r = warp * (BM / (THREADS / 32)) + rr;
    float v = -INFINITY;
    int i = INT_MAX;
    for (int c = lane; c < BN; c += 32) {
      const int gn = n0 + c;
      if (gn < n_valid) better(v, i, s.c[r * LDC + c] * scales[gn], gn);
    }
    warp_fold(v, i);
    const int gm = m0 + r;
    if (lane == 0 && gm < M) {
      part_val[(long long)gm * n_tiles + blockIdx.x] = v;
      part_idx[(long long)gm * n_tiles + blockIdx.x] = i;
    }
  }
}

__global__ void head_argmax_reduce_kernel(const float* __restrict__ part_val,
                                          const int* __restrict__ part_idx,
                                          int* __restrict__ out, int M,
                                          int n_tiles) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  float v = -INFINITY;
  int i = INT_MAX;
  for (int t = lane; t < n_tiles; t += 32)
    better(v, i, part_val[(long long)row * n_tiles + t],
           part_idx[(long long)row * n_tiles + t]);
  warp_fold(v, i);
  if (lane == 0) out[row] = i;
}

}  // namespace

extern "C" int head_argmax_int8(const void* x, const void* w,
                                const void* scales, void* part_val,
                                void* part_idx, void* out, int M, int K,
                                int N, int n_valid, void* stream) {
  using namespace int8tile;
  const int n_tiles = (N + BN - 1) / BN;
  if (M > 0 && N > 0) {
    dim3 grid(n_tiles, (M + BM - 1) / BM);
    head_argmax_tile_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const int8_t*)w, (const float*)scales,
        (float*)part_val, (int*)part_idx, M, K, N, n_valid, n_tiles);
    const int rows_per_block = 4;
    head_argmax_reduce_kernel<<<(M + rows_per_block - 1) / rows_per_block,
                                32 * rows_per_block, 0,
                                (cudaStream_t)stream>>>(
        (const float*)part_val, (const int*)part_idx, (int*)out, M, n_tiles);
  }
  return (int)cudaGetLastError();
}
