// The int8-weight LM head GEMM, bf16(x) @ bf16(W) * col_scale[n] with f32
// accumulation, and its two epilogues:
//   K2 head_argmax_int8: idx[m] = argmax over n < n_valid, without
//      materialising the logits.
//   K4 matmul_int8_wo: out[m, n] = the f32 logits, stored.
//
// Replaces: rten_tpu/kernels/gemm.py::matmul_argmax_int8 (K2, the greedy
// decode head, reached through rten_tpu/models/transformer.py::
// decode_step_argmax) and gemm.py::matmul_int8_weight_only (K4, the prefill
// LM head of admission groups of at most 64 rows and the verify head of
// speculative decoding, transformer.py:179-182).
//
// Bound on the H100: operations at batch 256 (2 * 256 * 768 * 50264 =
// 19.8 GFLOP, 20 us at the 989 TFLOP/s bf16 tensor-core peak), bytes at
// small batch (the 38.6 MB weight, 11.5 us at 3.35 TB/s; K4 also writes
// 4 * M * N bytes of logits, 12.9 MB at M 64).
//
// Design: both entries share the launches below, and differ only in the
// tile's epilogue (a template argument).
//   convert: x f32 -> bf16 once, zero-padded to [row blocks x BM, K_pad],
//            so the main loops copy x with 16-byte cp.async and mask
//            nothing.
//   tile:    one block per (row block, vocabulary slab); the row blocks of
//            one slab are adjacent in launch order, so W streams from HBM
//            once. The int8 -> bf16 conversion of W is exact (|w| <= 127).
//            At M > 64: a warpgroup per 64 rows (row blocks of 128 rows
//            up to M 128, of 256 above: the decode batch of 256 is one
//            block), 192-column slabs, wgmma.m64n192k16 with both operands
//            in shared memory. A 4-stage cp.async ring stages the x tile
//            (bf16, 128-byte swizzled, K-major) and the raw int8 W tile;
//            the block converts each W stage once into a double-buffered
//            bf16 tile (128-byte swizzled, N-major), stage kt + 1 while the
//            tensor cores run stage kt. x is what the blocks re-read from
//            L2 (once per slab), so the wide slab is the lever: 262 slabs
//            against 393 of 128 columns. At M <= 64: 8
//            warps of mma.sync.m16n8k16 over 128- or 256-column slabs, x by
//            ldmatrix; each lane reads 4 adjacent columns (one 32-bit word)
//            from each of its 4 K rows and converts them in registers, which
//            gives the B registers of 4 n8 tiles whose columns interleave
//            (n8 tile j holds columns 4c + j); the epilogue maps them back.
//            Argmax epilogue (K2): each row's (max, lowest index) of
//            acc * scale is folded in registers and across its quad by
//            shuffles (and, at M <= 64, across the slab's warps in shared
//            memory): one partial per (row, slab). Store epilogue (K4):
//            acc * scale straight from the registers to out; at M <= 64 a
//            lane's 4 interleaved n8 tiles hold 4 adjacent columns of a
//            row, one 16-byte store.
//   reduce:  (K2 only) one warp per row folds its partials.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int BK = 64;        // K rows per pipeline stage
constexpr int STAGES = 4;
constexpr int THREADS = 256;  // 8 warps
constexpr int WN = 64;        // columns per warp
constexpr int LDX = BK + 8;   // bf16 per x row in shared memory (144 B)

// 8 bytes, zero-filled past `bytes` (0 or 8) valid source bytes.
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The four signed bytes of w as exact floats: byte b of w ^ 0x80808080 is
// v + 128 in [0, 255]; under the exponent of 2^23 it reads 2^23 + v + 128.
__device__ __forceinline__ void s8x4_to_f32(uint32_t w, float (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.0f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.0f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.0f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.0f;
}

// Two floats as one bf16x2 register (round to nearest even), lo in the
// low half; exact for the weights' small integers.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_fold(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    better(v, i, ov, oi);
  }
}

// One thread per 8 elements of the padded bf16 copy of x (zeros outside
// [M, K]).
__global__ void x_to_bf16_kernel(const float* __restrict__ x,
                                 __nv_bfloat16* __restrict__ xb, int M,
                                 int K, int m_pad, int k_pad) {
  const int per_row = k_pad / 8;
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= (long long)m_pad * per_row) return;
  const int m = (int)(c / per_row), k0 = (int)(c % per_row) * 8;
  float v[8];
  const float* src = x + (long long)m * K + k0;
  if (m < M && k0 + 8 <= K &&
      (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const float4 lo = reinterpret_cast<const float4*>(src)[0];
    const float4 hi = reinterpret_cast<const float4*>(src)[1];
    v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
    v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = (m < M && k0 + e < K) ? src[e] : 0.0f;
  }
  *reinterpret_cast<uint4*>(xb + (long long)m * k_pad + k0) =
      make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                 pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

template <int WARPS_M>
struct TileShape {
  static constexpr int WARPS_N = 8 / WARPS_M;
  static constexpr int BM = WARPS_M * 16;       // rows of a row block
  static constexpr int BN = WARPS_N * WN;       // columns of a slab
  static constexpr int LDW = BN + 16;           // bytes per W row in smem
  static constexpr int X_STAGE = BM * LDX * 2;  // bytes
  static constexpr int W_STAGE = BK * LDW;      // bytes
  static constexpr int SMEM = STAGES * (X_STAGE + W_STAGE) + WARPS_N * BM * 8;
};

// Where a tile's epilogue writes: K2's partials [M, slabs] (argmax over
// the columns below n_valid), or K4's logits out [M, N] (n_valid == N).
struct Epilogue {
  float* part_val;
  int* part_idx;
  float* out;
  int n_valid;
  int slabs;
};

// Register path (M <= 64): block tile BM x BN; warp (wm, wn) owns one m16
// tile x 64 columns. LDW pads each W row by 16 bytes, so the lanes' 4-byte
// reads of rows 2*tig + {0, 1, 8, 9} at column 4*g fall in 32 distinct
// banks; LDX does the same for ldmatrix's 8 row addresses.
template <int WARPS_M, bool STORE>
__global__ void __launch_bounds__(THREADS)
    int8_head_tile_kernel(const __nv_bfloat16* __restrict__ xb,
                          const int8_t* __restrict__ w,
                          const float* __restrict__ scales, Epilogue ep,
                          int M, int K, int k_pad, int N) {
  using S = TileShape<WARPS_M>;
  constexpr int BM = S::BM, BN = S::BN, LDW = S::LDW;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* x_ring = smem;
  unsigned char* w_ring = smem + STAGES * S::X_STAGE;
  float* red_v = reinterpret_cast<float*>(w_ring + STAGES * S::W_STAGE);
  int* red_i = reinterpret_cast<int*>(red_v + S::WARPS_N * BM);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp / S::WARPS_N, wn = warp % S::WARPS_N;
  const int m0 = blockIdx.x * BM, slab = blockIdx.y, n0 = slab * BN;
  const int k_steps = k_pad / BK;

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * BK;
    __nv_bfloat16* xd =
        reinterpret_cast<__nv_bfloat16*>(x_ring + stage * S::X_STAGE);
#pragma unroll
    for (int c = tid; c < BM * (BK / 8); c += THREADS) {
      const int r = c / (BK / 8), q = c % (BK / 8);
      cp_async16(xd + r * LDX + q * 8,
                 xb + (long long)(m0 + r) * k_pad + k0 + q * 8);
    }
    int8_t* wd = reinterpret_cast<int8_t*>(w_ring + stage * S::W_STAGE);
#pragma unroll
    for (int c = tid; c < BK * (BN / 8); c += THREADS) {
      const int r = c / (BN / 8), q = c % (BN / 8);
      const int gk = k0 + r, gn = n0 + q * 8;
      const bool ok = gk < K && gn < N;
      cp_async8(wd + r * LDW + q * 8, ok ? w + (long long)gk * N + gn : w,
                ok ? 8 : 0);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[h][j][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < k_steps) load_stage(s, s);
    cp_commit();
  }
  for (int kt = 0; kt < k_steps; ++kt) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    const int nk = kt + STAGES - 1;
    if (nk < k_steps) load_stage(nk % STAGES, nk);
    cp_commit();
    const __nv_bfloat16* xt = reinterpret_cast<const __nv_bfloat16*>(
        x_ring + (kt % STAGES) * S::X_STAGE);
    const int8_t* wt =
        reinterpret_cast<const int8_t*>(w_ring + (kt % STAGES) * S::W_STAGE);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t b[2][4][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int8_t* p = wt + (kk + 2 * tig) * LDW + wn * WN + 32 * h + 4 * g;
        float f0[4], f1[4], f2[4], f3[4];
        s8x4_to_f32(*reinterpret_cast<const uint32_t*>(p), f0);
        s8x4_to_f32(*reinterpret_cast<const uint32_t*>(p + LDW), f1);
        s8x4_to_f32(*reinterpret_cast<const uint32_t*>(p + 8 * LDW), f2);
        s8x4_to_f32(*reinterpret_cast<const uint32_t*>(p + 9 * LDW), f3);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          b[h][j][0] = pack_bf16(f0[j], f1[j]);
          b[h][j][1] = pack_bf16(f2[j], f3[j]);
        }
      }
      uint32_t a[4];
      ldmatrix_x4(a, xt + (wm * 16 + (lane & 15)) * LDX + kk + (lane >> 4) * 8);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[h][j], a, b[h][j][0], b[h][j][1]);
    }
  }
  cp_wait<0>();

  // Accumulator e of n8 tile (h, j) sits at fragment column 2 * tig + (e & 1),
  // that is column n0 + wn * 64 + 32 h + 8 tig + 4 (e & 1) + j, row
  // g + 8 (e >> 1) of the warp's m16 tile.
  const int c0 = n0 + wn * WN + 8 * tig;
  const int n_valid = ep.n_valid;
  float sc[2][2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int o = 0; o < 2; ++o)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + 32 * h + 4 * o + j;
        sc[h][o][j] = col < n_valid ? scales[col] : 0.0f;
      }
  if constexpr (STORE) {
    // Columns c0 + 32 h + 4 o + 0..3 of a row: 16 bytes, in range or out
    // as a whole (N % 8 == 0).
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gm = m0 + wm * 16 + 8 * half + g;
      if (gm >= M) continue;
      float* orow = ep.out + (long long)gm * N;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int o = 0; o < 2; ++o) {
          const int col = c0 + 32 * h + 4 * o;
          if (col < N) {
            const int e = 2 * half + o;
            *reinterpret_cast<float4*>(orow + col) = make_float4(
                __fmul_rn(acc[h][0][e], sc[h][o][0]),
                __fmul_rn(acc[h][1][e], sc[h][o][1]),
                __fmul_rn(acc[h][2][e], sc[h][o][2]),
                __fmul_rn(acc[h][3][e], sc[h][o][3]));
          }
        }
    }
    return;
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float v = -INFINITY;
    int idx = INT_MAX;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int o = 0; o < 2; ++o)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = c0 + 32 * h + 4 * o + j;
          if (col < n_valid)
            better(v, idx, __fmul_rn(acc[h][j][2 * half + o], sc[h][o][j]),
                   col);
        }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, o);
      const int oi = __shfl_xor_sync(0xffffffffu, idx, o);
      better(v, idx, ov, oi);
    }
    if (tig == 0) {
      const int r = wm * 16 + 8 * half + g;
      red_v[wn * BM + r] = v;
      red_i[wn * BM + r] = idx;
    }
  }
  __syncthreads();
  for (int r = tid; r < BM; r += THREADS) {
    float v = red_v[r];
    int idx = red_i[r];
#pragma unroll
    for (int o = 1; o < S::WARPS_N; ++o)
      better(v, idx, red_v[o * BM + r], red_i[o * BM + r]);
    const int gm = m0 + r;
    if (gm < M) {
      ep.part_val[(long long)gm * ep.slabs + slab] = v;
      ep.part_idx[(long long)gm * ep.slabs + slab] = idx;
    }
  }
}

// ---- wgmma path (M > 64) -------------------------------------------------

constexpr int WG_BN = 192;  // columns of a slab: wgmma.m64n192k16

template <int WG>
struct WgShape {
  static constexpr int THREADS = 128 * WG;
  static constexpr int BM = 64 * WG;
  static constexpr int X_STAGE = BM * BK * 2;          // swizzled, no pad
  static constexpr int W_STAGE = BK * WG_BN;           // int8
  static constexpr int B_BUF = BK * WG_BN * 2;         // bf16, swizzled
  static constexpr int SMEM = SWIZZLE_ATOM + STAGES * (X_STAGE + W_STAGE) +
                              2 * B_BUF + WG_BN * 4;
};

// Warpgroup wg owns rows 64 wg .. 64 wg + 63 of the block and all 192
// columns. Shared memory: the x ring [stage][BM][64] (K-major: a row is one
// 128-byte swizzle row), the int8 W ring [stage][64][192], and the bf16 W
// tiles [2][3 column blocks of 64][64 k][64 n] (N-major: a k row of 64
// columns is one swizzle row; column blocks 8 KB apart).
template <int WG, bool STORE>
__global__ void __launch_bounds__(WgShape<WG>::THREADS, 1)
    int8_head_wgmma_kernel(const __nv_bfloat16* __restrict__ xb,
                           const int8_t* __restrict__ w,
                           const float* __restrict__ scales, Epilogue ep,
                           int M, int K, int k_pad, int N) {
  using S = WgShape<WG>;
  constexpr int NT = S::THREADS, BM = S::BM;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // The swizzle atoms need 1024-byte alignment.
  const uint32_t raw_addr = smem_u32(smem_raw);
  unsigned char* smem =
      smem_raw + ((SWIZZLE_ATOM - (raw_addr & (SWIZZLE_ATOM - 1))) &
                  (SWIZZLE_ATOM - 1));
  unsigned char* x_ring = smem;
  unsigned char* w_ring = x_ring + STAGES * S::X_STAGE;
  unsigned char* b_buf = w_ring + STAGES * S::W_STAGE;
  float* s_scale = reinterpret_cast<float*>(b_buf + 2 * S::B_BUF);

  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int warp_in_wg = (tid >> 5) & 3, g = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.x * BM, slab = blockIdx.y, n0 = slab * WG_BN;
  const int k_steps = k_pad / BK;
  const int n_valid = ep.n_valid;

  for (int c = tid; c < WG_BN; c += NT) {
    const int col = n0 + c;
    s_scale[c] = col < n_valid ? scales[col] : 0.0f;
  }

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * BK;
    unsigned char* xd = x_ring + stage * S::X_STAGE;
#pragma unroll
    for (int c = tid; c < BM * (BK / 8); c += NT) {
      const int r = c / (BK / 8), q = c % (BK / 8);
      cp_async16(xd + swz(r, q), xb + (long long)(m0 + r) * k_pad + k0 + q * 8);
    }
    int8_t* wd = reinterpret_cast<int8_t*>(w_ring + stage * S::W_STAGE);
    for (int c = tid; c < BK * (WG_BN / 8); c += NT) {
      const int r = c / (WG_BN / 8), q = c % (WG_BN / 8);
      const int gk = k0 + r, gn = n0 + q * 8;
      const bool ok = gk < K && gn < N;
      cp_async8(wd + r * WG_BN + q * 8, ok ? w + (long long)gk * N + gn : w,
                ok ? 8 : 0);
    }
  };
  // Stage kt's int8 W tile to bf16 in buffer b: 16 columns a chunk, each
  // half a swizzle chunk of its column block.
  auto convert = [&](int kt, int b) {
    const int8_t* wt = reinterpret_cast<const int8_t*>(
        w_ring + (kt % STAGES) * S::W_STAGE);
    unsigned char* bt = b_buf + b * S::B_BUF;
    for (int c = tid; c < BK * (WG_BN / 16); c += NT) {
      const int r = c / (WG_BN / 16), q = c % (WG_BN / 16);
      const uint4 v = *reinterpret_cast<const uint4*>(wt + r * WG_BN + 16 * q);
      const uint32_t words[4] = {v.x, v.y, v.z, v.w};
      uint32_t h[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float f[4];
        s8x4_to_f32(words[i], f);
        h[2 * i] = pack_bf16(f[0], f[1]);
        h[2 * i + 1] = pack_bf16(f[2], f[3]);
      }
      const int col = 16 * q, blk = col >> 6, chunk = (col & 63) >> 3;
      unsigned char* base = bt + blk * (BK * 128);
      *reinterpret_cast<uint4*>(base + swz(r, chunk)) =
          make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(base + swz(r, chunk + 1)) =
          make_uint4(h[4], h[5], h[6], h[7]);
    }
    fence_proxy_async();
  };

  float d[96];
#pragma unroll
  for (int i = 0; i < 96; ++i) d[i] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < k_steps) load_stage(s, s);
    cp_commit();
  }
  cp_wait<STAGES - 2>();
  __syncthreads();
  convert(0, 0);
  // Iteration kt: stages kt and kt + 1 have landed and buffer kt % 2 is
  // complete after the barrier; the tensor cores run stage kt while the
  // block converts stage kt + 1.
  for (int kt = 0; kt < k_steps; ++kt) {
    cp_wait<STAGES - 3>();
    fence_proxy_async();
    __syncthreads();
    const int nk = kt + STAGES - 1;
    if (nk < k_steps) load_stage(nk % STAGES, nk);
    cp_commit();
    const uint32_t xa = smem_u32(x_ring + (kt % STAGES) * S::X_STAGE) +
                        wg * 8 * SWIZZLE_ATOM;
    const uint32_t ba = smem_u32(b_buf + (kt & 1) * S::B_BUF);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_192(d, smem_desc(xa + 32 * kk, 16, SWIZZLE_ATOM),
                smem_desc(ba + 2 * SWIZZLE_ATOM * kk, BK * 128, SWIZZLE_ATOM));
    wgmma_commit();
    if (kt + 1 < k_steps) convert(kt + 1, (kt + 1) & 1);
    wgmma_wait<0>();
  }
  cp_wait<0>();

  // d[4 j + e]: row 16 warp_in_wg + g + 8 (e >> 1) of the warpgroup's 64,
  // column 8 j + 2 tig + (e & 1) of the slab. A row's 192 columns lie in
  // one quad.
  if constexpr (STORE) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gm = m0 + 64 * wg + 16 * warp_in_wg + 8 * half + g;
      if (gm >= M) continue;
      float* orow = ep.out + (long long)gm * N;
#pragma unroll
      for (int j = 0; j < WG_BN / 8; ++j) {
        const int c = 8 * j + 2 * tig, col = n0 + c;
        if (col < N)
          *reinterpret_cast<float2*>(orow + col) =
              make_float2(__fmul_rn(d[4 * j + 2 * half], s_scale[c]),
                          __fmul_rn(d[4 * j + 2 * half + 1], s_scale[c + 1]));
      }
    }
    return;
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float v = -INFINITY;
    int idx = INT_MAX;
#pragma unroll
    for (int j = 0; j < WG_BN / 8; ++j)
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        const int c = 8 * j + 2 * tig + o, col = n0 + c;
        if (col < n_valid)
          better(v, idx, __fmul_rn(d[4 * j + 2 * half + o], s_scale[c]), col);
      }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, o);
      const int oi = __shfl_xor_sync(0xffffffffu, idx, o);
      better(v, idx, ov, oi);
    }
    const int gm = m0 + 64 * wg + 16 * warp_in_wg + 8 * half + g;
    if (tig == 0 && gm < M) {
      ep.part_val[(long long)gm * ep.slabs + slab] = v;
      ep.part_idx[(long long)gm * ep.slabs + slab] = idx;
    }
  }
}

__global__ void head_argmax_reduce_kernel(const float* __restrict__ part_val,
                                          const int* __restrict__ part_idx,
                                          int* __restrict__ out, int M,
                                          int slabs) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  float v = -INFINITY;
  int i = INT_MAX;
  for (int t = lane; t < slabs; t += 32)
    better(v, i, part_val[(long long)row * slabs + t],
           part_idx[(long long)row * slabs + t]);
  warp_fold(v, i);
  if (lane == 0) out[row] = i;
}

constexpr int MAX_DEVICES = 64;

// Raises the kernel's dynamic shared memory limit once per device (a host
// call per launch would cost the host-bound decode step).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool (&done)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

template <int WARPS_M, bool STORE>
cudaError_t launch_tile(const __nv_bfloat16* xb, const int8_t* w,
                        const float* scales, const Epilogue& ep, int M,
                        int K, int k_pad, int N, cudaStream_t st) {
  using S = TileShape<WARPS_M>;
  static bool done[MAX_DEVICES];
  auto kernel = int8_head_tile_kernel<WARPS_M, STORE>;
  const cudaError_t err = allow_smem(kernel, S::SMEM, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + S::BM - 1) / S::BM, (N + S::BN - 1) / S::BN);
  kernel<<<grid, THREADS, S::SMEM, st>>>(xb, w, scales, ep, M, K, k_pad, N);
  return cudaGetLastError();
}

template <int WG, bool STORE>
cudaError_t launch_wgmma(const __nv_bfloat16* xb, const int8_t* w,
                         const float* scales, const Epilogue& ep, int M,
                         int K, int k_pad, int N, cudaStream_t st) {
  using S = WgShape<WG>;
  static bool done[MAX_DEVICES];
  auto kernel = int8_head_wgmma_kernel<WG, STORE>;
  const cudaError_t err = allow_smem(kernel, S::SMEM, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + S::BM - 1) / S::BM, (N + WG_BN - 1) / WG_BN);
  kernel<<<grid, S::THREADS, S::SMEM, st>>>(xb, w, scales, ep, M, K, k_pad,
                                            N);
  return cudaGetLastError();
}

// The tiles by config, as gemm.py::head_argmax_plan picks them:
// 0: BM 32, BN 256 (2 x 4 warps); 1: BM 64, BN 128 (4 x 2 warps);
// 2: BM 128, BN 192 (2 warpgroups); 3: BM 256, BN 192 (4 warpgroups).
constexpr int kBM[4] = {32, 64, 128, 256};
constexpr int kBN[4] = {256, 128, WG_BN, WG_BN};

// The convert launch, then the tile launch of config cfg with epilogue
// STORE.
template <bool STORE>
cudaError_t run_tiles(const void* x, const void* w, const void* scales,
                      void* xb, const Epilogue& ep, int M, int K, int N,
                      int cfg, cudaStream_t st) {
  const int m_pad = (M + kBM[cfg] - 1) / kBM[cfg] * kBM[cfg];
  const int k_pad = (K + BK - 1) / BK * BK;
  const long long chunks = (long long)m_pad * (k_pad / 8);
  x_to_bf16_kernel<<<(unsigned)((chunks + 255) / 256), 256, 0, st>>>(
      (const float*)x, (__nv_bfloat16*)xb, M, K, m_pad, k_pad);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const auto* xbp = (const __nv_bfloat16*)xb;
  const auto* wp = (const int8_t*)w;
  const auto* sp = (const float*)scales;
  switch (cfg) {
    case 0:
      return launch_tile<2, STORE>(xbp, wp, sp, ep, M, K, k_pad, N, st);
    case 1:
      return launch_tile<4, STORE>(xbp, wp, sp, ep, M, K, k_pad, N, st);
    case 2:
      return launch_wgmma<2, STORE>(xbp, wp, sp, ep, M, K, k_pad, N, st);
    default:
      return launch_wgmma<4, STORE>(xbp, wp, sp, ep, M, K, k_pad, N, st);
  }
}

}  // namespace

// x f32 [M, K]; w int8 [K, N] (N % 8 == 0, 16-byte aligned); scales f32
// [N]; xb bf16 scratch [m_pad, k_pad]; part_val / part_idx [M, slabs];
// out int32 [M]. cfg picks the tile (kBM, kBN above).
extern "C" int head_argmax_int8(const void* x, const void* w,
                                const void* scales, void* xb, void* part_val,
                                void* part_idx, void* out, int M, int K,
                                int N, int n_valid, int cfg, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  if (cfg < 0 || cfg > 3) return (int)cudaErrorInvalidValue;
  const int slabs = (N + kBN[cfg] - 1) / kBN[cfg];
  const Epilogue ep{(float*)part_val, (int*)part_idx, nullptr, n_valid,
                    slabs};
  const cudaError_t err =
      run_tiles<false>(x, w, scales, xb, ep, M, K, N, cfg, st);
  if (err != cudaSuccess) return (int)err;
  constexpr int rows_per_block = 4;
  head_argmax_reduce_kernel<<<(M + rows_per_block - 1) / rows_per_block,
                              32 * rows_per_block, 0, st>>>(
      (const float*)part_val, (const int*)part_idx, (int*)out, M, slabs);
  return (int)cudaGetLastError();
}

// K4: the same operands and tiles; out f32 [M, N] = acc * scales, every
// column stored.
extern "C" int matmul_int8_wo(const void* x, const void* w,
                              const void* scales, void* xb, void* out, int M,
                              int K, int N, int cfg, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  if (cfg < 0 || cfg > 3) return (int)cudaErrorInvalidValue;
  const Epilogue ep{nullptr, nullptr, (float*)out, N, 0};
  return (int)run_tiles<true>(x, w, scales, xb, ep, M, K, N, cfg, st);
}
