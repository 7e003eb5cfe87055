// int8 x int8 GEMM with the per-tensor x per-channel dequant epilogue (M1).
//
// Replaces: rten_tpu/kernels/gemm.py::matmul_int8_pallas (kernel
// _int8_kernel, gemm.py:54-69): x int8 [M, K] times w int8 [K, N],
// accumulated in int32, then out = (f32(acc) * x_scale) * w_scales[n] in
// f32, in that order (the XLA matmul_int8 multiplies acc by the product
// x_scale * w_scales instead, so the two differ in the last bit). The TPU
// kernel pads M to 32 and N and K to 128 and carries the int32 tile in
// VMEM across the K grid axis; zero padding changes no sum, so here the
// tiles past the edges read zeros (the tensor map's out-of-bounds fill, or
// the masked loader's), and the result equals the unpadded product bit for
// bit. Integer sums are exact in any order, so every call gives the same
// bits.
//
// Bound on the H100: operations at large M (2 M N K int8 operations at the
// 1,979 TOP/s tensor-core peak), bytes at decode M (the weights, K N bytes,
// and the f32 output).
//
// Design: wgmma.m64nNk32.s32.s8.s8 over tiles staged in shared memory. A
// block owns a 128-row x BN-column output tile (BN 128, or 64 where the
// plan needs more blocks) and one K split of whole 128-deep K tiles; its
// 13 warps are two consumer warpgroups (64 rows each, the s32 accumulators
// in registers), a transposer group of four warps and a producer warp.
// - A ring of 4 stages, each an x tile [128 m][128 k] (K-major, 128-byte
//   swizzled: the layout wgmma's descriptor names), the raw W tile [128
//   k][BN n] as it lies in memory (N-contiguous) and its transpose [BN
//   n][128 k] (K-major, 128-byte swizzled). Each stage has three
//   mbarriers: full (the copies landed), ready (the transpose is written)
//   and empty (the consumers' wgmma read it).
// - Loader kTma (x and W 16-byte aligned, K and N multiples of 16): the
//   producer warp's lane 0 streams both tiles by 2-D tensor-map copies
//   (TMA) into the ring, each stage once the consumers released it; the
//   x box lands 128-byte swizzled, W's raw box 128-byte swizzled at BN 128
//   and plain at BN 64. Loader kRegs (any other shape): the transposer
//   warps load both tiles with masked loads into the same layouts.
// - 8-bit wgmma operands are K-major on both sides, with no transpose bit,
//   so W is transposed in shared memory: a transposer thread takes a unit
//   of 16 k rows x 4 columns (16 four-byte loads, one per row), turns it
//   into 4 columns x 16 k (four 4 x 4 byte transposes by __byte_perm) and
//   stores each column's 16 bytes into its swizzled chunk. A warp's loads
//   cover whole 128-byte rows (no bank conflict; at BN 64, two rows of 64
//   bytes, 2-way); each lane rotates its unit's columns by (quad / 2) % 4
//   (one __byte_perm a word), so that the 8 lanes of a quarter-warp store
//   into 8 distinct 16-byte chunks of the swizzle. A thread's units of a
//   stage (two at BN 128) are unrolled, their loads in flight together.
// - The consumers wait for a stage's transpose, run four k32 wgmmas on it
//   and release the stage once they are done.
// - Without K splits the launch is persistent: one block an SM walks the
//   output tiles in turn, the ring's stages running on from tile to tile,
//   and each consumer warp converts its 16 rows of a tile, __fmul_rn(
//   __fmul_rn(f32(acc), x_scale), w_scales[col]), through a staging of its
//   own (32 columns a pass, so that a row's columns leave in float4s; no
//   block barrier), stored masked at the ragged edges, while the producer
//   and the transposers fill the ring for the next tile (fragment stores
//   straight from registers were slower).
// - With K splits (where the tiles leave SMs idle) a tile's splits form
//   one thread-block cluster: the s32 tile goes through shared memory
//   ([128][BN + 8]), and after one cluster barrier each block sums its
//   share of the tile over every split's shared memory (distributed shared
//   memory: exact int32 sums, no scratch and no atomics) and converts it
//   once.
// What bounds it (python -m rten_tpu_torch.tools.kv_group_variants, its m1
// section and M1_VARIANTS; numbers in PERF.md): at M 4096 the kernel
// without any wgmma, or without the transpose, takes most of the whole
// kernel's time, so not the tensor cores but the tiles' bytes: a 128 x 128
// tile re-reads its x rows and W columns from L2, 2 M N K / 128 bytes in
// all (151 MB at K 768, N 3072), beside the f32 output (50 MB there).
// Three stages, the transpose units in turn, or one stage's products kept
// in flight read slower. Larger tiles (two m64 wgmmas a warpgroup) or a
// cluster sharing the x tile by TMA multicast would cut those bytes;
// untried.
// The design before: four warps a 64 x 64 tile, synchronous loads,
// W transposed byte by byte into shared memory, mma.sync.m16n8k32.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int BM = 128;             // rows a block: two consumer warpgroups
constexpr int BK = 128;             // K a stage: one 128-byte swizzle row
constexpr int STAGES = 4;
constexpr int CONSUMERS = 256;      // warps 0-7
constexpr int TRANSPOSERS = 128;    // warps 8-11
constexpr int THREADS = CONSUMERS + TRANSPOSERS + 32;  // warp 12: producer
constexpr int MAX_SPLITS = 8;       // a cluster holds a tile's K splits
constexpr int SMEM_LIMIT = 232448;
enum Loader { kTma = 0, kRegs = 1 };

template <int BN>
struct Shape {
  static constexpr int A = BM * BK;            // x tile
  static constexpr int W = BK * BN;            // raw W tile
  static constexpr int B = BN * BK;            // transposed W tile
  static constexpr int STAGE = A + W + B;      // 1 KB multiples
  static constexpr int LDT = BN + 8;           // int32 epilogue row
  static constexpr int BARS = (3 * STAGES * 8 + 15) / 16 * 16;  // 16-aligned
  // A consumer warp's staging of 16 rows x PASS columns of s32 (rows of
  // PASS + 8: the fragment's int2 stores and the float4 reads both free
  // of bank conflicts), after the ring and its barriers.
  static constexpr int PASS = 32, LDP = PASS + 8;
  static constexpr int STAGING = CONSUMERS / 32 * 16 * LDP * 4;
  static constexpr int SMEM = SWIZZLE_ATOM + STAGES * STAGE + BARS + STAGING;
  static_assert(BM * LDT * 4 <= STAGES * STAGE, "the epilogue tile fits");
  static_assert((BK / 16) * (BN / 4) % TRANSPOSERS == 0,
                "every transposer takes as many units of a stage");
  static_assert(SMEM <= SMEM_LIMIT, "shared memory");
};

// Byte offset of element (k row r, column n) in a raw W tile: as the
// tensor map writes it, 128-byte swizzled rows at BN 128, plain 64-byte
// rows at BN 64.
template <int BN>
__device__ __forceinline__ int raw_off(int r, int n) {
  if constexpr (BN == 128)
    return r * 128 + ((((n >> 4) ^ (r & 7))) << 4) + (n & 15);
  else
    return r * BN + n;
}

// 16 bytes at p (zero past `left` valid bytes, or all where left <= 0),
// by the widest loads that the address and the count allow.
__device__ __forceinline__ uint4 load16(const int8_t* p, int left) {
  uint4 v = make_uint4(0, 0, 0, 0);
  if (left <= 0) return v;
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (left >= 16 && (a & 15) == 0) return *reinterpret_cast<const uint4*>(p);
  uint32_t w[4] = {0, 0, 0, 0};
  if (left >= 16 && (a & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = reinterpret_cast<const uint32_t*>(p)[i];
  } else {
    for (int i = 0; i < 16 && i < left; ++i)
      w[i >> 2] |= (uint32_t)(uint8_t)p[i] << (8 * (i & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <int BN, int LOADER>
__global__ void __launch_bounds__(THREADS, 1)
    matmul_int8_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap wmap,
                       const int8_t* __restrict__ x,
                       const int8_t* __restrict__ w,
                       const float* __restrict__ x_scale,
                       const float* __restrict__ w_scales,
                       float* __restrict__ out, int M, int N, int K,
                       int k_tiles, int n_tiles, int tiles) {
  using S = Shape<BN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw_addr = smem_u32(smem_raw);
  unsigned char* smem =
      smem_raw + ((SWIZZLE_ATOM - (raw_addr & (SWIZZLE_ATOM - 1))) &
                  (SWIZZLE_ATOM - 1));
  auto a_tile = [&](int s) { return smem + s * S::STAGE; };
  auto w_tile = [&](int s) { return smem + s * S::STAGE + S::A; };
  auto b_tile = [&](int s) { return smem + s * S::STAGE + S::A + S::W; };
  const uint32_t bars = smem_u32(smem + STAGES * S::STAGE);
  int* staging = reinterpret_cast<int*>(smem + STAGES * S::STAGE + S::BARS) +
                 (threadIdx.x >> 5) * 16 * S::LDP;  // consumer warps
  auto full = [&](int s) { return bars + 8 * s; };
  auto ready = [&](int s) { return bars + 8 * (STAGES + s); };
  auto empty = [&](int s) { return bars + 8 * (2 * STAGES + s); };

  // Output tiles t = blockIdx.y, blockIdx.y + gridDim.y, ..: one a block
  // with K splits (the cluster's), several (persistent) without. The ring's
  // stages and phases run on across a block's tiles (g counts its K tiles).
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int split = blockIdx.x, splits = gridDim.x;
  const int kt0 = (int)((long long)split * k_tiles / splits);
  const int nt = (int)((long long)(split + 1) * k_tiles / splits) - kt0;
  auto origin = [&](int t, int& m0, int& n0) {
    m0 = t / n_tiles * BM;
    n0 = t % n_tiles * BN;
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(ready(s), TRANSPOSERS);
      mbar_init(empty(s), CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int m0 = 0, n0 = 0;
  if (warp == (CONSUMERS + TRANSPOSERS) / 32) {
    // The producer: both tiles of K tile i into stage g % STAGES, once the
    // consumers have released the stage's previous fill.
    if (LOADER == kTma && lane == 0) {
      int g = 0;
      for (int t = blockIdx.y; t < tiles; t += gridDim.y) {
        origin(t, m0, n0);
        for (int i = 0; i < nt; ++i, ++g) {
          const int s = g % STAGES, k0 = (kt0 + i) * BK;
          if (g >= STAGES) mbar_wait(empty(s), (g / STAGES - 1) & 1);
          mbar_expect(full(s), S::A + S::W);
          tma_box(smem_u32(a_tile(s)), xmap, k0, m0, full(s));
          tma_box(smem_u32(w_tile(s)), wmap, n0, k0, full(s));
        }
      }
    }
  } else if (warp >= CONSUMERS / 32) {
    // The transposers: [k][n] -> [n][k] of each stage's W tile.
    const int tt = tid - CONSUMERS;
    int g = 0;
    for (int t = blockIdx.y; t < tiles; t += gridDim.y) {
      origin(t, m0, n0);
      for (int i = 0; i < nt; ++i, ++g) {
        const int s = g % STAGES;
        if constexpr (LOADER == kTma) {
          mbar_wait(full(s), (g / STAGES) & 1);
        } else {
          // The masked loader: x rows m0.., W rows k0.. into the layouts
          // the tensor maps would write, zeros past the edges.
          if (g >= STAGES) mbar_wait(empty(s), (g / STAGES - 1) & 1);
          const int k0 = (kt0 + i) * BK;
          for (int c = tt; c < BM * (BK / 16); c += TRANSPOSERS) {
            const int r = c / (BK / 16), q = c % (BK / 16);
            const int row = m0 + r, k = k0 + 16 * q;
            const uint4 v =
                row < M ? load16(x + (long long)row * K + k, K - k)
                        : make_uint4(0, 0, 0, 0);
            *reinterpret_cast<uint4*>(a_tile(s) + swz(r, q)) = v;
          }
          for (int c = tt; c < BK * (BN / 16); c += TRANSPOSERS) {
            const int r = c / (BN / 16), q = c % (BN / 16);
            const int kr = k0 + r, n = n0 + 16 * q;
            const uint4 v =
                kr < K ? load16(w + (long long)kr * N + n, N - n)
                       : make_uint4(0, 0, 0, 0);
            *reinterpret_cast<uint4*>(w_tile(s) + raw_off<BN>(r, 16 * q)) =
                v;
          }
          asm volatile("bar.sync 1, %0;\n" ::"n"(TRANSPOSERS) : "memory");
        }
        const unsigned char* wt = w_tile(s);
        unsigned char* bt = b_tile(s);
        constexpr int QUADS = BN / 4;
#pragma unroll
        for (int it = 0; it < (BK / 16) * QUADS / TRANSPOSERS; ++it) {
          const int u = tt + it * TRANSPOSERS;  // both units' loads in flight
          const int c = u / QUADS, q = u % QUADS;
          const int rot = (q >> 1) & 3;
          const uint32_t sel = (0x32103210u >> (4 * rot)) & 0xFFFFu;
          uint32_t r[16];
#pragma unroll
          for (int j = 0; j < 16; ++j)
            r[j] = __byte_perm(*reinterpret_cast<const uint32_t*>(
                                   wt + raw_off<BN>(16 * c + j, 4 * q)),
                               0, sel);
          // col[j][g4]: k rows 4 g4 .. 4 g4 + 3 of column slot j, which
          // holds column 4 q + (j + rot) % 4 of the tile.
          uint32_t col[4][4];
#pragma unroll
          for (int g4 = 0; g4 < 4; ++g4) {
            const uint32_t* r4 = r + 4 * g4;
            const uint32_t t0 = __byte_perm(r4[0], r4[1], 0x5140);
            const uint32_t t1 = __byte_perm(r4[2], r4[3], 0x5140);
            const uint32_t t2 = __byte_perm(r4[0], r4[1], 0x7362);
            const uint32_t t3 = __byte_perm(r4[2], r4[3], 0x7362);
            col[0][g4] = __byte_perm(t0, t1, 0x5410);
            col[1][g4] = __byte_perm(t0, t1, 0x7632);
            col[2][g4] = __byte_perm(t2, t3, 0x5410);
            col[3][g4] = __byte_perm(t2, t3, 0x7632);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n = 4 * q + ((j + rot) & 3);
            *reinterpret_cast<uint4*>(bt + swz(n, c)) =
                make_uint4(col[j][0], col[j][1], col[j][2], col[j][3]);
          }
        }
        fence_proxy_async();  // this thread's stores, before wgmma reads
        mbar_arrive(ready(s));
      }
    }
  }

  // The consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of a tile.
  // d[4 j + e]: row 16 (warp % 4) + lane / 4 + 8 (e / 2) of them, column
  // 8 j + 2 (lane % 4) + e % 2.
  int d[BN / 2];
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) d[j] = 0;
  const int wg = warp >> 2;
  const float xs = *x_scale;
  if (warp < CONSUMERS / 32) {
    int g = 0;
    for (int t = blockIdx.y; t < tiles; t += gridDim.y) {
      origin(t, m0, n0);
      for (int i = 0; i < nt; ++i, ++g) {
        const int s = g % STAGES, parity = (g / STAGES) & 1;
        mbar_wait(ready(s), parity);
        if (LOADER == kTma) mbar_wait(full(s), parity);  // x landed
        const uint32_t xa = smem_u32(a_tile(s)) + wg * 8 * SWIZZLE_ATOM;
        const uint32_t wb = smem_u32(b_tile(s));
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk) {
          const uint64_t da = smem_desc(xa + 32 * kk, 16, SWIZZLE_ATOM);
          const uint64_t db = smem_desc(wb + 32 * kk, 16, SWIZZLE_ATOM);
          if constexpr (BN == 128)
            wgmma_s8_128(d, da, db, i > 0 || kk > 0);
          else
            wgmma_s8_64(d, da, db, i > 0 || kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        if (lane == 0) mbar_arrive(empty(s));
      }
      if (splits > 1) break;  // the cluster's epilogue below
      // Without K splits, the epilogue while the producer and the
      // transposers fill the ring for the block's next tile: the warp's 16
      // rows PASS columns at a time through its staging, then a row's PASS
      // columns in float4s: (f32(acc) * x_scale) * w_scales[col], stored
      // masked at the ragged edges.
      const int row0 = m0 + 64 * wg + 16 * (warp & 3);
#pragma unroll
      for (int p = 0; p < BN / S::PASS; ++p) {
#pragma unroll
        for (int j = 0; j < S::PASS / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int jj = p * S::PASS / 8 + j;
            *reinterpret_cast<int2*>(staging +
                                     ((lane >> 2) + 8 * h) * S::LDP + 8 * j +
                                     2 * (lane & 3)) =
                make_int2(d[4 * jj + 2 * h], d[4 * jj + 2 * h + 1]);
          }
        __syncwarp();
        const int c = 4 * (lane & 7), col = n0 + p * S::PASS + c;
        const bool whole = col + 4 <= N && (N & 3) == 0;
        float4 ws = make_float4(0, 0, 0, 0);
        if (whole) {
          ws = *reinterpret_cast<const float4*>(w_scales + col);
        } else if (col < N) {
          ws.x = w_scales[col];
          if (col + 1 < N) ws.y = w_scales[col + 1];
          if (col + 2 < N) ws.z = w_scales[col + 2];
          if (col + 3 < N) ws.w = w_scales[col + 3];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = (lane >> 3) + 4 * i, row = row0 + r;
          const int4 a =
              *reinterpret_cast<const int4*>(staging + r * S::LDP + c);
          const float4 v =
              make_float4(__fmul_rn(__fmul_rn((float)a.x, xs), ws.x),
                          __fmul_rn(__fmul_rn((float)a.y, xs), ws.y),
                          __fmul_rn(__fmul_rn((float)a.z, xs), ws.z),
                          __fmul_rn(__fmul_rn((float)a.w, xs), ws.w));
          if (row >= M || col >= N) continue;
          float* o = out + (long long)row * N + col;
          if (whole) {
            *reinterpret_cast<float4*>(o) = v;
          } else {
            o[0] = v.x;
            if (col + 1 < N) o[1] = v.y;
            if (col + 2 < N) o[2] = v.z;
            if (col + 3 < N) o[3] = v.w;
          }
        }
        __syncwarp();  // the staging is read before the next pass writes
      }
    }
  }
  if (splits == 1) return;

  // K splits: one tile a block. Its s32 tile [BM][LDT] over the ring (free:
  // every copy consumed, every product done), then the cluster's sum.
  __syncthreads();
  origin(blockIdx.y, m0, n0);
  int* tile = reinterpret_cast<int*>(smem);
  if (warp < CONSUMERS / 32) {
    const int r0 = 64 * wg + 16 * (warp & 3) + (lane >> 2);
    const int c0 = 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<int2*>(tile + (r0 + 8 * h) * S::LDT + 8 * j + c0) =
            make_int2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  constexpr int VECS = BM * BN / 4;
  const int share = (VECS + splits - 1) / splits;
  const int v1 = min(VECS, (split + 1) * share);
  for (int v = split * share + tid; v < v1; v += THREADS) {
    const int r = v / (BN / 4), c = 4 * (v % (BN / 4));
    int4 a = *reinterpret_cast<const int4*>(tile + r * S::LDT + c);
    for (int z = 1; z < splits; ++z) {
      const int* other = cluster.map_shared_rank(tile, (split + z) % splits);
      const int4 b = *reinterpret_cast<const int4*>(other + r * S::LDT + c);
      a.x += b.x, a.y += b.y, a.z += b.z, a.w += b.w;
    }
    const int row = m0 + r, col = n0 + c;
    if (row >= M || col >= N) continue;
    float* o = out + (long long)row * N + col;
    const int acc[4] = {a.x, a.y, a.z, a.w};
    if (col + 4 <= N && (N & 3) == 0) {
      const float4 ws = *reinterpret_cast<const float4*>(w_scales + col);
      *reinterpret_cast<float4*>(o) =
          make_float4(__fmul_rn(__fmul_rn((float)acc[0], xs), ws.x),
                      __fmul_rn(__fmul_rn((float)acc[1], xs), ws.y),
                      __fmul_rn(__fmul_rn((float)acc[2], xs), ws.z),
                      __fmul_rn(__fmul_rn((float)acc[3], xs), ws.w));
    } else {
      for (int e = 0; e < 4 && col + e < N; ++e)
        o[e] = __fmul_rn(__fmul_rn((float)acc[e], xs), w_scales[col + e]);
    }
  }
  cluster.sync();  // no block leaves while another reads its tile
}

template <int BN, int LOADER>
cudaError_t launch(const int8_t* x, const int8_t* w, const float* x_scale,
                   const float* w_scales, float* out, int M, int N, int K,
                   int splits, int workers, cudaStream_t st) {
  CUtensorMap xmap = {}, wmap = {};
  cudaError_t err;
  if constexpr (LOADER == kTma) {
    err = tensor_map_2d(x, CU_TENSOR_MAP_DATA_TYPE_UINT8, (uint64_t)K,
                        (uint64_t)M, (uint64_t)K, BK, BM,
                        CU_TENSOR_MAP_SWIZZLE_128B, &xmap);
    if (err != cudaSuccess) return err;
    err = tensor_map_2d(w, CU_TENSOR_MAP_DATA_TYPE_UINT8, (uint64_t)N,
                        (uint64_t)K, (uint64_t)N, BN, BK,
                        BN == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                  : CU_TENSOR_MAP_SWIZZLE_NONE,
                        &wmap);
    if (err != cudaSuccess) return err;
  }
  auto kernel = matmul_int8_kernel<BN, LOADER>;
  // Set at every launch: a static guard would be per process, not per
  // device, and the call is cheap beside this kernel's work.
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Shape<BN>::SMEM);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  const int n_tiles = (N + BN - 1) / BN, tiles = (M + BM - 1) / BM * n_tiles;
  cfg.gridDim = dim3(splits, splits > 1 ? tiles : min(tiles, workers));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = Shape<BN>::SMEM;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, xmap, wmap, x, w, x_scale,
                            w_scales, out, M, N, K, (K + BK - 1) / BK,
                            n_tiles, tiles);
}

}  // namespace

// x int8 [m, k], w int8 [k, n], x_scale f32 [1], w_scales f32 [n], out f32
// [m, n], all contiguous (the wrapper checks). bn: 64 or 128 output
// columns a block; splits: 1 to min(8, ceil(k / 128)) K splits a tile, one
// cluster, one tile a block; without splits, `workers` blocks (at least 1)
// take the tiles in turn; tma: 1 streams both tiles by tensor-map copies
// (x and w 16-byte aligned, k and n multiples of 16), 0 takes the masked
// loader (any shape). Chosen by gemm.py::matmul_int8_plan.
extern "C" int matmul_int8(const void* x, const void* w, const void* x_scale,
                           const void* w_scales, void* out, int m, int n,
                           int k, int bn, int splits, int workers, int tma,
                           void* stream) {
  const int k_tiles = (k + BK - 1) / BK;
  if ((bn != 64 && bn != 128) || splits < 1 || splits > MAX_SPLITS ||
      (k > 0 && splits > k_tiles) || workers < 1 ||
      (tma && (k % 16 || n % 16 || reinterpret_cast<uintptr_t>(x) % 16 ||
               reinterpret_cast<uintptr_t>(w) % 16)))
    return (int)cudaErrorInvalidValue;
  if (m <= 0 || n <= 0) return (int)cudaGetLastError();
  const int8_t* xb = (const int8_t*)x;
  const int8_t* wb = (const int8_t*)w;
  const float* xs = (const float*)x_scale;
  const float* ws = (const float*)w_scales;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (bn == 128)
    err = tma ? launch<128, kTma>(xb, wb, xs, ws, o, m, n, k, splits,
                                  workers, st)
              : launch<128, kRegs>(xb, wb, xs, ws, o, m, n, k, splits,
                                   workers, st);
  else
    err = tma ? launch<64, kTma>(xb, wb, xs, ws, o, m, n, k, splits, workers,
                                 st)
              : launch<64, kRegs>(xb, wb, xs, ws, o, m, n, k, splits,
                                  workers, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
