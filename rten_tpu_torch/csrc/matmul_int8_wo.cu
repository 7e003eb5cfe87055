// Weight-only int8 GEMM: out[M, N] = (bf16(x) @ bf16(W)) * col_scale, f32.
//
// Replaces: rten_tpu/kernels/gemm.py::matmul_int8_weight_only. On the
// serving path it runs the prefill LM head for admission groups of at most
// 64 rows (K = 768, N = 50257 padded to 50264), where the weight is over
// 8M elements (rten_tpu/models/transformer.py:179-182).
//
// Bound on the H100: bytes. At M = 64 the weight is 38.6 MB, about 11.5 us
// at 3.35 TB/s, against 4.9 GFLOP, about 5 us at the bf16 tensor-core peak.
// Design: int8_bf16_tile.cuh's 64x64 WMMA tile per block, so each weight
// byte is read from device memory by one block per 64 rows; the epilogue
// scales the f32 tile by the column scales and stores it. Numerics as the
// reference: bf16 x, exact bf16 weights, f32 accumulation, scales after
// the sum.
#include "int8_bf16_tile.cuh"

__global__ void __launch_bounds__(int8tile::THREADS)
    matmul_int8_wo_kernel(const float* __restrict__ x,
                          const int8_t* __restrict__ w,
                          const float* __restrict__ scales,
                          float* __restrict__ out, int M, int K, int N) {
  using namespace int8tile;
  __shared__ __align__(32) unsigned char raw[sizeof(Smem)];
  Smem& s = *reinterpret_cast<Smem*>(raw);
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  mainloop(x, w, M, K, N, m0, n0, s);
  for (int e = threadIdx.x; e < BM * BN; e += THREADS) {
    const int r = e / BN, c = e % BN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm < M && gn < N)
      out[(long long)gm * N + gn] = s.c[r * LDC + c] * scales[gn];
  }
}

extern "C" int matmul_int8_wo(const void* x, const void* w,
                              const void* scales, void* out, int M, int K,
                              int N, void* stream) {
  using namespace int8tile;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (M > 0 && N > 0) {
    matmul_int8_wo_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const int8_t*)w, (const float*)scales,
        (float*)out, M, K, N);
  }
  return (int)cudaGetLastError();
}
