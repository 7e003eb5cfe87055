// Word-packed group-wise int4 GEMM in the int8 dot mode (Q1'):
// out[M, N] = x[M, K] (f32) x W[K, N], W in int4 words with one f32 scale
// per (K-group, column).
//
// Replaces: rten_tpu/kernels/gemm.py::matmul_int4_words (kernel
// _int4w_kernel) with dot_mode="int8". The formula is the reference's, as
// gemm.py::matmul_int4_words_plain(..., dot_mode="int8") states it: x is
// row-quantized to xq (scale absmax / 127, 1 where 0; IEEE division, round
// half to even, clamp to +-127); each group's dot of xq with the weights is
// exact in int32, times its f32 scale, summed over groups; the zero-point
// term is added and the sum is multiplied by the row scale. Here the
// zero-point term is taken in int32 at each group end: the group's dot
// xq . u of the unsigned nibbles u = q + 8, minus 8 times the group's sum
// of xq, is xq . q exactly, and that integer is what the f32 scale
// multiplies. The sum is the same in integers; only the order of the f32
// additions differs, and the int4 tolerance counts both terms' magnitudes.
//
// Layout: words int32 [K/4, N/2]; byte i of word r holds K row 4r + i;
// within each 256-column tile, packed column j holds column j in its low
// nibble and column j + 128 in its high one. That is the register layout
// of mma.m16n8k32.s8's B operand, whose register holds 4 consecutive K rows
// of one column: w & 0x0F0F0F0F is column j's, (w >> 4) & 0x0F0F0F0F
// column j + 128's.
//
// Bound on the H100: bytes at decode (M 16: half a byte a weight;
// TinyLlama's head is 32.8 MB, 9.8 us at 3.35 TB/s), operations at
// prefill (M 1024: 2 M K N at the 1,979 TOP/s int8 tensor-core peak).
// Design, two launches:
//   prep: one block per row (rows padded to a whole row tile): absmax, the
//         row scale and xq, written in mma A-fragment order (one 16-byte
//         vector per lane, m16 slab and 32-deep K step). The GEMM is launched as its programmatic
//         dependent: its blocks request their first weights while the prep
//         runs, and wait for it before they read xq.
//   gemm: a block of 4 warps owns one 256-column tile (a warp 32 packed
//         columns, 64 outputs), a row tile of 16 x MS rows and one K split
//         of whole groups. A lane's 16-byte loads of 4 adjacent packed
//         columns from word rows 8s + tig and 8s + 4 + tig are the B
//         registers of 8 n8 tiles (w & 0x0F0F0F0F: 4 of low nibbles;
//         (w >> 4) & 0x0F0F0F0F: 4 of high ones); the weights never touch
//         shared memory, and each B register serves the MS m16 slabs. K
//         steps of weights are loaded in batches of P (8 KB of words a warp
//         in flight), all issued before the batch's first MMA: the loads of
//         one warp share one wait, so a ring refilled every step would wait
//         out a full load latency every step. The split's xq (in A-fragment
//         order: one conflict-free 16-byte read a lane, slab and step) and
//         its group scales are staged in shared memory once. Each lane adds
//         its A bytes per row with dp4a; at each group end the quad sums
//         them, and the int32 accumulators, less 8 x the row sums, are
//         scaled into f32 accumulators in registers. Split-K runs in a
//         thread-block cluster per tile (one block per split, up to 16):
//         each block stores every slice of its partial tile into the shared
//         memory of the block that owns the slice (distributed shared
//         memory) and, after one cluster barrier, sums its own slice in
//         split order and applies the row scale. The result is the same in
//         every run, and no partial goes through device memory. (Summing
//         the splits in the last block of each tile, found by an atomic
//         ticket, makes that one block read every split's partial tile from
//         L2, which took most of a decode call; pulling the partials from
//         the other blocks needs a second barrier and waits out each remote
//         read.)
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;      // 4 warps
constexpr int TILE_N = 256;       // output columns per block (128 packed)
constexpr int KSTEP = 32;         // K rows per mma step
constexpr int PREP_THREADS = 256;
constexpr int PREP_UNROLL = 4;    // float4 loads in flight per prep thread
constexpr int MAX_SPLITS = 16;        // a cluster holds a tile's splits
constexpr int MAX_SPLIT_GROUPS = 16;  // groups a split may span (smem)
constexpr int P = 8;                  // K steps of weights a warp batch
constexpr int MAX_DEVICES = 64;

// Programmatic dependent launch: the GEMM is launched while the prep runs
// and waits here before it reads anything the prep writes.
__device__ __forceinline__ void wait_for_prep() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void let_gemm_start() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// A 16-byte read-only load as volatile PTX, so that the compiler keeps a
// batch's loads ahead of the batch's MMAs (also volatile).
__device__ __forceinline__ int4 ld_nc(const void* p) {
  int4 v;
  asm volatile("ld.global.nc.v4.s32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const int4& a,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t word(const int4& v, int j) {
  return (uint32_t)(j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w);
}

// The low (hi = 0) or high nibble of each byte: 4 u values as s8.
__device__ __forceinline__ uint32_t nibbles(uint32_t w, int hi) {
  return (hi ? w >> 4 : w) & 0x0F0F0F0Fu;
}

// xq in A-fragment order: the 16 bytes of lane (g, tig) for m16 slab s and
// K step t sit at vector (s * KS + t) * 32 + 4 g + tig, as a0..a3 (rows g,
// g + 8 at K 4 tig..; the same at K 16 + 4 tig..).
__global__ void __launch_bounds__(PREP_THREADS)
    prep_kernel(const float* __restrict__ x, uint32_t* __restrict__ xqf,
                float* __restrict__ xscale, int M, int K) {
  __shared__ float red[PREP_THREADS / 32];
  let_gemm_start();
  const int m = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  // The row as float4 (K % 32 == 0; x 16-byte aligned), PREP_UNROLL
  // independent loads in flight per thread.
  const float4* row = reinterpret_cast<const float4*>(x + (long long)m * K);
  const int n4 = K / 4;
  float a = 0.0f;
  if (m < M)
    for (int i = tid; i < n4; i += PREP_UNROLL * PREP_THREADS) {
      float4 v[PREP_UNROLL];
#pragma unroll
      for (int u = 0; u < PREP_UNROLL; ++u) {
        const int j = i + u * PREP_THREADS;
        v[u] = j < n4 ? __ldg(row + j) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < PREP_UNROLL; ++u)
        a = fmaxf(a, fmaxf(fmaxf(fabsf(v[u].x), fabsf(v[u].y)),
                           fmaxf(fabsf(v[u].z), fabsf(v[u].w))));
    }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
  if (lane == 0) red[warp] = a;
  __syncthreads();
  a = red[0];
#pragma unroll
  for (int w = 1; w < PREP_THREADS / 32; ++w) a = fmaxf(a, red[w]);
  const float scale = a == 0.0f ? 1.0f : a / 127.0f;
  if (tid == 0) xscale[m] = scale;
  const int ks_count = K / KSTEP, slab = m >> 4, g = m & 7, hi_row = (m >> 3) & 1;
  for (int k4 = tid; k4 < n4; k4 += PREP_THREADS) {
    uint32_t packed = 0;
    if (m < M) {
      const float4 v4 = __ldg(row + k4);
      const float v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float q = fminf(fmaxf(rintf(v[e] / scale), -127.0f), 127.0f);
        packed |= ((uint32_t)(int)q & 0xFFu) << (8 * e);
      }
    }
    const int k = 4 * k4, t = k / KSTEP, kk = k % KSTEP;
    const int tq = (kk & 15) >> 2, reg = hi_row + 2 * (kk >> 4);
    xqf[(((long long)slab * ks_count + t) * 32 + 4 * g + tq) * 4 + reg] =
        packed;
  }
}

// Shared memory of the GEMM for a split of at most gmax groups: the group
// scales [gmax][TILE_N] f32, then xq [MS][gmax * spg][32] int4, then (with
// splits) the slices of this block's share of the tile that every split
// pushes [splits][per] float4, per = ceil(16 MS TILE_N / 4 / splits).
__host__ __device__ constexpr int share_vecs(int ms, int splits) {
  return (16 * ms * (TILE_N / 4) + splits - 1) / splits;
}

__host__ __device__ constexpr int push_offset(int ms, int gmax, int spg) {
  return gmax * TILE_N * 4 + ms * gmax * spg * 32 * 16;
}

__host__ __device__ constexpr int gemm_smem(int ms, int gmax, int spg,
                                            int splits) {
  return push_offset(ms, gmax, spg) +
         (splits > 1 ? splits * share_vecs(ms, splits) * 16 : 0);
}

template <int MS>
__global__ void __launch_bounds__(THREADS)
    int4w_int8_kernel(const int4* __restrict__ xqf,
                      const float* __restrict__ xscale,
                      const int* __restrict__ words,
                      const float* __restrict__ scales,
                      float* __restrict__ out, int M, int K, int N, int group,
                      int splits) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int mt = blockIdx.x, nt = blockIdx.y, z = blockIdx.z;
  const int n_groups = K / group, spg = group / KSTEP, ks_count = K / KSTEP;
  const int g_begin = (int)((long long)z * n_groups / splits);
  const int g_end = (int)((long long)(z + 1) * n_groups / splits);
  const int ks_begin = g_begin * spg, ks_end = g_end * spg;
  const int n_steps = ks_end - ks_begin;
  const int gmax = (n_groups + splits - 1) / splits;
  float* s_scale = reinterpret_cast<float*>(smem);           // [gmax][256]
  int4* s_xq = reinterpret_cast<int4*>(smem + gmax * TILE_N * 4);
  const long long half_n = N / 2;
  // B loads: packed columns pc .. pc + 3 of word rows 8 s + tig, 8 s + 4 + tig.
  const int* wbase = words + (long long)tig * half_n + nt * 128 + warp * 32 +
                     4 * g;
  // This lane's accumulators: n8 tile t = 4 hi + j (hi: high nibbles),
  // element e at row g + 8 (e >> 1) of its slab and column
  // col0 + 128 hi + 4 (e & 1) + j.
  const int col0 = nt * TILE_N + warp * 32 + 8 * tig;
  const int sc_col = warp * 32 + 8 * tig;  // col0 within the tile

  int4 bw[P][2];
  auto load_b = [&](int slot, int s) {
    const int* p = wbase + (long long)8 * s * half_n;
    bw[slot][0] = ld_nc(p);
    bw[slot][1] = ld_nc(p + 4 * half_n);
  };

  int acc[MS][8][4];
  float f[MS][8][4];
#pragma unroll
  for (int ms = 0; ms < MS; ++ms)
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[ms][t][e] = 0;
        f[ms][t][e] = 0.0f;
      }

  // The first batch of weights and the split's scales are requested
  // before the prep has ended; xq after it.
#pragma unroll
  for (int i = 0; i < P; ++i)
    if (ks_begin + i < ks_end) load_b(i, ks_begin + i);
  for (int c = tid; c < (g_end - g_begin) * (TILE_N / 4); c += THREADS) {
    const int gg = c / (TILE_N / 4), q = c % (TILE_N / 4);
    cp_async16(s_scale + gg * TILE_N + 4 * q,
               scales + (long long)(g_begin + gg) * N + nt * TILE_N + 4 * q);
  }
  wait_for_prep();
  for (int c = tid; c < MS * n_steps * 32; c += THREADS) {
    const int ms = c / (n_steps * 32), rest = c % (n_steps * 32);
    cp_async16(s_xq + c,
               xqf + ((long long)(mt * MS + ms) * ks_count + ks_begin) * 32 +
                   rest);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  int rsum[MS][2];  // this lane's share of the group's xq row sums
#pragma unroll
  for (int ms = 0; ms < MS; ++ms) rsum[ms][0] = rsum[ms][1] = 0;
  int in_group = 0, gi = 0;
  for (int s0 = ks_begin; s0 < ks_end; s0 += P) {
    if (s0 != ks_begin) {
#pragma unroll
      for (int i = 0; i < P; ++i)
        if (s0 + i < ks_end) load_b(i, s0 + i);
    }
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int s = s0 + i;
      if (s < ks_end) {
        int4 a[MS];
#pragma unroll
        for (int ms = 0; ms < MS; ++ms) {
          a[ms] = s_xq[(ms * n_steps + s - ks_begin) * 32 + lane];
          rsum[ms][0] = __dp4a(a[ms].x, 0x01010101, rsum[ms][0]);
          rsum[ms][0] = __dp4a(a[ms].z, 0x01010101, rsum[ms][0]);
          rsum[ms][1] = __dp4a(a[ms].y, 0x01010101, rsum[ms][1]);
          rsum[ms][1] = __dp4a(a[ms].w, 0x01010101, rsum[ms][1]);
        }
#pragma unroll
        for (int hi = 0; hi < 2; ++hi)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t b0 = nibbles(word(bw[i][0], j), hi);
            const uint32_t b1 = nibbles(word(bw[i][1], j), hi);
#pragma unroll
            for (int ms = 0; ms < MS; ++ms)
              mma_s8(acc[ms][4 * hi + j], a[ms], b0, b1);
          }
        if (++in_group == spg) {
          // Group end: xq . q = xq . u - 8 sum(xq), then the f32 scale.
          int r8[MS][2];
#pragma unroll
          for (int ms = 0; ms < MS; ++ms)
#pragma unroll
            for (int h8 = 0; h8 < 2; ++h8) {
              int r = rsum[ms][h8];
              r += __shfl_xor_sync(0xffffffffu, r, 1);
              r += __shfl_xor_sync(0xffffffffu, r, 2);
              r8[ms][h8] = 8 * r;
              rsum[ms][h8] = 0;
            }
          const float* sc = s_scale + gi * TILE_N + sc_col;
#pragma unroll
          for (int t = 0; t < 8; ++t)
#pragma unroll
            for (int o = 0; o < 2; ++o) {
              const float scale = sc[128 * (t >> 2) + 4 * o + (t & 3)];
#pragma unroll
              for (int ms = 0; ms < MS; ++ms)
#pragma unroll
                for (int h8 = 0; h8 < 2; ++h8) {
                  const int e = 2 * h8 + o;
                  f[ms][t][e] = fmaf((float)(acc[ms][t][e] - r8[ms][h8]),
                                     scale, f[ms][t][e]);
                  acc[ms][t][e] = 0;
                }
            }
          in_group = 0;
          ++gi;
        }
      }
    }
  }

  if (splits == 1) {
    // The result times the row scale, straight from the accumulators.
#pragma unroll
    for (int ms = 0; ms < MS; ++ms)
#pragma unroll
      for (int h8 = 0; h8 < 2; ++h8) {
        const int row = (mt * MS + ms) * 16 + g + 8 * h8;
        if (row >= M) continue;
        const float rs = xscale[row];
#pragma unroll
        for (int hi = 0; hi < 2; ++hi)
#pragma unroll
          for (int o = 0; o < 2; ++o) {
            float4 v;
            v.x = f[ms][4 * hi + 0][2 * h8 + o] * rs;
            v.y = f[ms][4 * hi + 1][2 * h8 + o] * rs;
            v.z = f[ms][4 * hi + 2][2 * h8 + o] * rs;
            v.w = f[ms][4 * hi + 3][2 * h8 + o] * rs;
            *reinterpret_cast<float4*>(out + (long long)row * N + col0 +
                                       128 * hi + 4 * o) = v;
          }
      }
    return;
  }

  // Split-K across the cluster (one block per split of this tile): block
  // b owns the b-th share of the tile's float4 vectors. Every block stores
  // each of its vectors into the owner's push buffer at [split][vector];
  // after one cluster barrier (release / acquire) each owner sums its share
  // in split order from its own shared memory and applies the row scale.
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int per = share_vecs(MS, splits);
  float4* push = reinterpret_cast<float4*>(smem + push_offset(MS, gmax, spg));
  const int rank = (int)cluster.block_rank();
#pragma unroll
  for (int ms = 0; ms < MS; ++ms)
#pragma unroll
    for (int h8 = 0; h8 < 2; ++h8) {
      const int r = ms * 16 + g + 8 * h8;
#pragma unroll
      for (int hi = 0; hi < 2; ++hi)
#pragma unroll
        for (int o = 0; o < 2; ++o) {
          float4 v;
          v.x = f[ms][4 * hi + 0][2 * h8 + o];
          v.y = f[ms][4 * hi + 1][2 * h8 + o];
          v.z = f[ms][4 * hi + 2][2 * h8 + o];
          v.w = f[ms][4 * hi + 3][2 * h8 + o];
          const int e = r * (TILE_N / 4) + (sc_col + 128 * hi + 4 * o) / 4;
          const int owner = e / per;
          float4* dst = cluster.map_shared_rank(push, owner);
          dst[rank * per + e - owner * per] = v;
        }
    }
  cluster.sync();
  const int row0 = mt * MS * 16;
  const int n_vec = MS * 16 * (TILE_N / 4);
  const int first = rank * per;
  const int last = min(n_vec, first + per);
  for (int e = first + tid; e < last; e += THREADS) {
    const int r = e / (TILE_N / 4), c = 4 * (e % (TILE_N / 4));
    if (row0 + r >= M) continue;
    float4 sum = push[e - first];
    for (int zz = 1; zz < splits; ++zz) {
      const float4 v = push[zz * per + e - first];
      sum.x += v.x, sum.y += v.y, sum.z += v.z, sum.w += v.w;
    }
    const float rs = xscale[row0 + r];
    sum.x *= rs, sum.y *= rs, sum.z *= rs, sum.w *= rs;
    *reinterpret_cast<float4*>(out + (long long)(row0 + r) * N +
                               nt * TILE_N + c) = sum;
  }
}

}  // namespace

// x f32 [M, K]; words int32 [K/4, N/2]; scales f32 [K / group, N]; out f32
// [M, N]; all contiguous and 16-byte aligned. Scratch, sized by
// gemm.py::int4_int8_plan: xqf int8 [m_pad, K] (fragment order) and xscale
// f32 [m_pad]. ms: m16 slabs per row tile (1 or 2); m_pad = m_tiles * 16 *
// ms. group % 32 == 0, N % 256 == 0, 1 <= splits <= min(K / group,
// MAX_SPLITS), and no split spans more than MAX_SPLIT_GROUPS groups.
extern "C" int matmul_int4_int8dot(const void* x, const void* words,
                                   const void* scales, void* xqf,
                                   void* xscale, void* out, int M, int K,
                                   int N, int group, int ms, int splits,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  if (group <= 0 || group % KSTEP || K % group || N % TILE_N ||
      (ms != 1 && ms != 2) || splits < 1 || splits > K / group ||
      splits > MAX_SPLITS ||
      (K / group + splits - 1) / splits > MAX_SPLIT_GROUPS)
    return (int)cudaErrorInvalidValue;
  const int m_tiles = (M + 16 * ms - 1) / (16 * ms);
  prep_kernel<<<m_tiles * 16 * ms, PREP_THREADS, 0, st>>>(
      (const float*)x, (uint32_t*)xqf, (float*)xscale, M, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto kernel = ms == 1 ? int4w_int8_kernel<1> : int4w_int8_kernel<2>;
  const int smem = gemm_smem(ms, (K / group + splits - 1) / splits,
                             group / KSTEP, splits);
  // The function attributes, raised once per device and kernel (a host
  // call per launch would cost the host-bound decode step).
  static int smem_set[MAX_DEVICES][2];
  static bool cluster_set[MAX_DEVICES][2];
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= MAX_DEVICES)
    return (int)(err != cudaSuccess ? err : cudaErrorInvalidDevice);
  if (smem > smem_set[dev][ms - 1]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev][ms - 1] = smem;
  }
  if (splits > 8 && !cluster_set[dev][ms - 1]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    cluster_set[dev][ms - 1] = true;
  }
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = 1;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = splits;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(m_tiles, N / TILE_N, splits);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, kernel, (const int4*)xqf,
                           (const float*)xscale, (const int*)words,
                           (const float*)scales, (float*)out, M, K, N, group,
                           splits);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
