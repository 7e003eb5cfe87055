// int8 x int8 GEMM with the per-tensor x per-channel dequant epilogue (M1).
//
// Replaces: rten_tpu/kernels/gemm.py::matmul_int8_pallas (kernel
// _int8_kernel, gemm.py:54-69): x int8 [M, K] times w int8 [K, N],
// accumulated in int32, then out = (f32(acc) * x_scale) * w_scales[n] in
// f32, in that order (the XLA matmul_int8 multiplies acc by the product
// x_scale * w_scales instead, so the two differ in the last bit). The TPU
// kernel pads M to 32 and N and K to 128 and carries the int32 tile in
// VMEM across the K grid axis; zero padding changes no sum, so here the
// block masks its ragged edges instead, and the result equals the
// unpadded product bit for bit.
//
// Bound on the H100: operations at large M (2 M N K int8 ops at the
// 1,979 TOP/s tensor-core peak), bytes at decode M (the weights, K N
// bytes). Design: the simple tensor-core kernel: a block of four warps
// owns a 64 x 64 output tile; each K step of 32 stages the x tile (K
// contiguous) and the w tile transposed to [n][k] in shared memory, and
// each warp runs mma.sync.m16n8k32 (s8 x s8 -> s32) over its 32 x 32
// quarter, accumulating in registers. No cp.async pipeline, no wgmma:
// later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 32;
constexpr int kThreads = 128;
constexpr int kStride = kBK + 16;  // shared row stride in bytes (16-aligned)

__device__ inline void mma_s8(int (&c)[4], const int (&a)[4],
                              const int (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes from src (zero past `left` valid bytes), as one vector load
// when all 16 are valid and aligned.
__device__ inline int4 load16(const int8_t* src, int left) {
  int4 v = make_int4(0, 0, 0, 0);
  if (left >= 16 && (reinterpret_cast<uintptr_t>(src) & 15) == 0)
    return *reinterpret_cast<const int4*>(src);
  int8_t* dst = reinterpret_cast<int8_t*>(&v);
  for (int i = 0; i < 16 && i < left; ++i) dst[i] = src[i];
  return v;
}

__global__ void __launch_bounds__(kThreads)
    matmul_int8_kernel(const int8_t* __restrict__ x,
                       const int8_t* __restrict__ w,
                       const float* __restrict__ x_scale,
                       const float* __restrict__ w_scales,
                       float* __restrict__ out, int m, int n, int k) {
  __shared__ __align__(16) int8_t a_s[kBM][kStride];  // x tile [m][k]
  __shared__ __align__(16) int8_t b_s[kBN][kStride];  // w tile [n][k]
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;

  // Staging: thread t copies 16 bytes of x row t / 2 and 16 bytes of w row
  // t / 4 (64 x 32 and 32 x 64 bytes a step).
  const int ar = threadIdx.x >> 1, ac = (threadIdx.x & 1) * 16;
  const int br = threadIdx.x >> 2, bc = (threadIdx.x & 3) * 16;
  for (int k0 = 0; k0 < k; k0 += kBK) {
    int4 av = make_int4(0, 0, 0, 0), bv = make_int4(0, 0, 0, 0);
    if (m0 + ar < m)
      av = load16(x + (long long)(m0 + ar) * k + k0 + ac, k - k0 - ac);
    if (k0 + br < k)
      bv = load16(w + (long long)(k0 + br) * n + n0 + bc, n - n0 - bc);
    *reinterpret_cast<int4*>(&a_s[ar][ac]) = av;
    const int8_t* bb = reinterpret_cast<const int8_t*>(&bv);
#pragma unroll
    for (int i = 0; i < 16; ++i) b_s[bc + i][br] = bb[i];
    __syncthreads();
    int a[2][4], bf[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int8_t* p = &a_s[wm + 16 * mi + g][4 * tig];
      a[mi][0] = *reinterpret_cast<const int*>(p);
      a[mi][1] = *reinterpret_cast<const int*>(p + 8 * kStride);
      a[mi][2] = *reinterpret_cast<const int*>(p + 16);
      a[mi][3] = *reinterpret_cast<const int*>(p + 8 * kStride + 16);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int8_t* p = &b_s[wn + 8 * ni + g][4 * tig];
      bf[ni][0] = *reinterpret_cast<const int*>(p);
      bf[ni][1] = *reinterpret_cast<const int*>(p + 16);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], bf[ni]);
    __syncthreads();
  }

  const float xs = *x_scale;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = m0 + wm + 16 * mi + g + (c >= 2 ? 8 : 0);
        const int col = n0 + wn + 8 * ni + 2 * tig + (c & 1);
        if (row < m && col < n)
          out[(long long)row * n + col] = __fmul_rn(
              __fmul_rn((float)acc[mi][ni][c], xs), w_scales[col]);
      }
    }
  }
}

}  // namespace

// x int8 [m, k], w int8 [k, n], x_scale f32 [1], w_scales f32 [n], out f32
// [m, n], all contiguous (the wrapper checks).
extern "C" int matmul_int8(const void* x, const void* w, const void* x_scale,
                           const void* w_scales, void* out, int m, int n,
                           int k, void* stream) {
  if (m > 0 && n > 0) {
    const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
    matmul_int8_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int8_t*)x, (const int8_t*)w, (const float*)x_scale,
        (const float*)w_scales, (float*)out, m, n, k);
  }
  return (int)cudaGetLastError();
}
