// Group-wise int4 weight GEMMs: out[M, N] = x[M, K] (f32) x W[K, N], W in
// int4 with one f32 scale per (K-group, column).
//
// Replaces: rten_tpu/kernels/gemm.py::matmul_int4_words (kernel
// _int4w_kernel) in its bf16 dot mode (Q1), and gemm.py::matmul_int4 (kernel
// _int4_kernel, Q2); the int8 dot mode has a kernel of its own
// (matmul_int4_int8dot.cu). The formulas are the reference's, so greedy
// tokens follow it (u = nibble in [0, 15], q = u - 8, s = scale):
//   Q1, words:  sum_k bf16(x) * bf16(bf16(u) * bf16(s))
//               - 8 * sum_g xsum[m, g] * s[g, n]
//               (xsum: group sums of the unrounded f32 x);
//   Q2, bytes:  sum_k bf16(x) * bf16(bf16(q) * bf16(s)).
// Layouts: words int32 [K/4, N/2], byte i of word r holds K row 4r + i;
// bytes uint8 [K, N/2]. In both, within each 256-column tile, byte j holds
// column j in its low nibble and column j + 128 in its high one.
//
// One kernel template serves both: a weight-loader policy (words or bytes)
// and a correction flag (Q1). Downstream of the loader both share every
// line. A nibble becomes bf16 exactly as 0x4300 | u (bf16 128 + u); one
// fma.rn.bf16x2 then gives bf16(u * s) (Q1: (128 + u) s - 128 s, with
// -128 s exact) or, after an exact subtraction of 136, bf16(q * s) (Q2):
// one rounding of the exact product, as the reference's bf16 multiply.
// xsum is a fixed-order sum of 64-value chunk sums, so every call gives the
// same bits.
//
// Bound on the H100: bytes at decode (M 16: half a byte a weight; TinyLlama's
// head is 32.8 MB, about 10 us at 3.35 TB/s), operations at prefill (M 1024:
// 2 M K N at the 989 TFLOP/s bf16 tensor-core peak). The plan
// (gemm.py::int4_bf16_plan) picks the tile by M.
//
// Decode tile (M <= 64), one launch: a block of 4 consumer warps and one
// producer warp owns one 256-column tile (a consumer warp 32 packed columns,
// 64 outputs), 16 x MS rows and one K split of whole groups; a tile's splits
// form one thread-block cluster.
//   Weights: the producer's lane 0 streams the split's W through a ring of
//   8 KB stages (64 K rows of the tile) with 2-D tensor-map copies (TMA):
//   words, 4 boxes of 32 words x 16 word rows a stage; bytes, one box of
//   128 bytes x 64 rows; 128-byte swizzle. A ring holds every stage of a
//   split where that leaves room for two blocks an SM (up to 16: 128 KB),
//   else at least 2. Each stage has a full and an empty mbarrier. (Per-lane
//   register loads, and one bulk copy per 512- or 128-byte row, bounded
//   the stream: the copy unit takes one request at a time; see PERF.md.)
//   K order: mma.m16n8k16 bf16. A lane's 32-bit word holds K rows 4a..4a+3
//   of one packed column; in step 2p + e of a stage lane tig takes word row
//   a = Loader::row(p, e, tig), and its rows 4a, 4a+1 go to the MMA's k
//   slots 2tig, 2tig+1, rows 4a+2, 4a+3 to slots 2tig+8, 2tig+9. A is read
//   in the same order: x[g][4a .. 4a+1] is A register 0, [4a+2, 4a+3]
//   register 2 (rows g + 8: registers 1, 3), four adjacent values of one
//   row. The row order is the one whose reads of the swizzled stage (and,
//   with the x pad, of x) hit distinct banks; the sums do not depend on it.
//   A word gives the B registers of two n8 tiles (low and high nibbles);
//   bytes are read as 4 rows of 4 and transposed by prmt into the word form.
//   x and the split's scales come as bulk copies, one per row and group, on
//   their own barrier (f32 x, rounded to bf16 as A fragments are built), and
//   (Q1) the split's chunk sums of x are formed while the weights arrive.
//   Q1 adds -8 xsum s for its groups to its partial. Split-K: each block
//   stores every slice of its partial tile into the shared memory of the
//   block that owns the slice, one cluster barrier, then each owner sums its
//   slice in split order: no partial goes through device memory.
// Prefill tile (M > 64): a prep launch rounds x to bf16 (rows padded to the
// row block with zeros) and forms xsum (Q1); the GEMM is launched as its
// programmatic dependent and requests its first weights while the prep
// runs. A block of 2 warpgroups owns 128 rows and one 256-column tile. A
// 4-stage cp.async ring stages the x tile (bf16, 128-byte swizzled,
// K-major), the raw int4 W tile (8 KB) and its group's scales; the block
// converts each stage's W once into a double-buffered bf16 tile (128-byte
// swizzled, N-major; stage kt + 1 while the tensor cores run stage kt),
// which wgmma.m64n256k16 reads for all 128 rows. Q1's correction is added
// in the epilogue from the block's xsum rows.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int TILE_N = 256;       // output columns per block (128 packed)
constexpr int MAX_DEVICES = 64;
constexpr int SMEM_LIMIT = 232448;
enum Layout { WORDS = 0, BYTES = 1 };

// Programmatic dependent launch: the prefill GEMM is launched while the
// prep runs and waits here before it reads anything the prep writes.
__device__ __forceinline__ void wait_for_prep() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void let_gemm_start() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b,
                                               uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// Two floats as one bf16x2 register (round to nearest even), lo in the low
// half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

constexpr uint32_t BF16X2_ONE = 0x3F803F80u;      // 1.0, 1.0
constexpr uint32_t BF16X2_NEG128 = 0xC300C300u;   // -128.0, -128.0
constexpr uint32_t BF16X2_NEG136 = 0xC308C308u;   // -136.0, -136.0
constexpr uint32_t BF16X2_NEG0 = 0x80008000u;     // -0.0, -0.0

// The multipliers of one column pair: bf16(s) in each half, and (Q1)
// -128 bf16(s), exact.
struct Scale2 {
  uint32_t s, neg128;
};

__device__ __forceinline__ Scale2 scale2(float lo, float hi) {
  const uint32_t s = pack_bf16(lo, hi);
  return {s, fma_bf16x2(s, BF16X2_NEG128, BF16X2_NEG0)};
}

// The nibbles in bits 0-3 and 16-19 of t (the rest ignored) as bf16x2 of
// bf16(u * s) (CORR, Q1) or bf16((u - 8) * s) (Q2): 0x4300 | u is 128 + u,
// exact; one fma rounds the exact product once.
template <bool CORR>
__device__ __forceinline__ uint32_t dequant2(uint32_t t, const Scale2& sc) {
  const uint32_t magic = (t & 0x000F000Fu) | 0x43004300u;
  if (CORR) return fma_bf16x2(magic, sc.s, sc.neg128);
  const uint32_t q = fma_bf16x2(magic, BF16X2_ONE, BF16X2_NEG136);
  return fma_bf16x2(q, sc.s, BF16X2_NEG0);
}

__device__ __forceinline__ uint32_t word(const int4& v, int j) {
  return (uint32_t)(j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w);
}

// Sum of the 16 lanes of a half-warp, by a fixed xor tree (every lane of
// the warp must call it).
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float sum4(const float4& v) {
  return ((v.x + v.y) + v.z) + v.w;
}

// ---- decode tile ---------------------------------------------------------

constexpr int DEC_CONSUMERS = 128;  // 4 warps compute
constexpr int DEC_THREADS = 160;    // and one warp issues the copies
constexpr int KSTEP = 16;           // K rows per mma.m16n8k16
constexpr int SPS = 4;              // k16 steps per ring stage (64 K rows)
constexpr int MAX_RING = 16;        // ring stages
constexpr int MAX_SPLITS = 16;      // a cluster holds a tile's splits
constexpr int CHUNK = 64;           // x values per partial sum
// A ring stage is the tile's 64 K rows of W as the tensor map's boxes
// write them, 128-byte swizzled: words, 4 boxes (one per warp's 32 packed
// columns) of 16 word rows x 128 bytes; bytes, one box of 64 rows x 128
// bytes.
constexpr int STAGE = 64 * 128;
constexpr int BARRIERS = 1 + 2 * MAX_RING;  // x, full[ring], empty[ring]

// The weight-loader policies. A stage holds word rows a = 0..15 (K rows
// 4a .. 4a + 3 of the stage); in k16 step 2p + e of the stage lane tig
// takes word row row(p, e, tig), and A reads the same K rows, so the sums
// are the same whatever the order: it is chosen so that a warp's reads of
// the swizzled stage hit distinct banks. XPAD (f32) pads a staged x row so
// that the A reads of that order hit distinct banks too.
template <int LAYOUT>
struct Loader;

template <>
struct Loader<WORDS> {
  static constexpr int XPAD = 4;
  __device__ static int row(int p, int e, int tig) {
    return 8 * p + 2 * tig + e;
  }
  // Packed columns pc .. pc + 3 (pc = 32 warp + 4 g) of word row a: 16
  // bytes of warp's box.
  __device__ static int4 words(const unsigned char* stage, int a, int warp,
                               int g) {
    return *reinterpret_cast<const int4*>(stage + warp * 2048 + a * 128 +
                                          ((g ^ (a & 7)) << 4));
  }
};

template <>
struct Loader<BYTES> {
  static constexpr int XPAD = 16;
  __device__ static int row(int p, int e, int tig) {
    return 8 * p + tig + 4 * e;
  }
  // The same from byte rows 4a .. 4a + 3 (4 bytes each), transposed 4 x 4
  // by prmt: word j = byte j of rows 0..3.
  __device__ static int4 words(const unsigned char* stage, int a, int warp,
                               int g) {
    const int chunk = 2 * warp + (g >> 2), off = 4 * (g & 3);
    uint32_t r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int br = 4 * a + i;
      r[i] = *reinterpret_cast<const uint32_t*>(
          stage + br * 128 + ((chunk ^ (br & 7)) << 4) + off);
    }
    const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
    const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140);
    const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362);
    const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
    return make_int4(__byte_perm(t0, t1, 0x5410), __byte_perm(t0, t1, 0x7632),
                     __byte_perm(t2, t3, 0x5410),
                     __byte_perm(t2, t3, 0x7632));
  }
};

// Shared memory of the decode tile for a split of at most gmax groups, from
// the dynamic base: 1 KB of slack to align the ring (the tensor map's
// swizzle needs 1024-byte alignment), the ring [ring][STAGE], then the
// barriers, the group scales [gmax][TILE_N] f32, x [16 MS][gmax group +
// xpad] f32, the chunk sums [16 MS][gmax group / CHUNK] f32 and (with
// splits) the slices of this block's share of the tile that every split
// pushes [splits][per] float4, per = ceil(16 MS TILE_N / 4 / splits). All
// but the ring sit at fixed offsets from the base, the same in every block
// of a cluster.
__host__ __device__ constexpr int align16(int b) { return (b + 15) / 16 * 16; }

__host__ __device__ constexpr int share_vecs(int ms, int splits) {
  return (16 * ms * (TILE_N / 4) + splits - 1) / splits;
}

__host__ __device__ constexpr int dec_bar_offset(int ring) {
  return SWIZZLE_ATOM + ring * STAGE;
}

__host__ __device__ constexpr int dec_scale_offset(int ring) {
  return dec_bar_offset(ring) + align16(BARRIERS * 8);
}

__host__ __device__ constexpr int dec_x_offset(int ring, int gmax) {
  return dec_scale_offset(ring) + gmax * TILE_N * 4;
}

__host__ __device__ constexpr int dec_part_offset(int ring, int ms, int gmax,
                                                  int group, int xpad) {
  return dec_x_offset(ring, gmax) +
         align16(16 * ms * (gmax * group + xpad) * 4);
}

__host__ __device__ constexpr int dec_push_offset(int ring, int ms, int gmax,
                                                  int group, int xpad) {
  return dec_part_offset(ring, ms, gmax, group, xpad) +
         align16(16 * ms * (gmax * group / CHUNK) * 4);
}

__host__ __device__ constexpr int dec_smem(int ring, int ms, int gmax,
                                           int group, int xpad, int splits) {
  return dec_push_offset(ring, ms, gmax, group, xpad) +
         (splits > 1 ? splits * share_vecs(ms, splits) * 16 : 0);
}

template <int LAYOUT, bool CORR, int MS>
__global__ void __launch_bounds__(DEC_THREADS)
    int4_decode_kernel(const __grid_constant__ CUtensorMap wmap,
                       const float* __restrict__ x,
                       const float* __restrict__ scales,
                       float* __restrict__ out, int M, int K, int N,
                       int group, int splits, int ring) {
  using L = Loader<LAYOUT>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int mt = blockIdx.x, nt = blockIdx.y, z = blockIdx.z;
  const int n_groups = K / group;
  const int g_begin = (int)((long long)z * n_groups / splits);
  const int g_end = (int)((long long)(z + 1) * n_groups / splits);
  const int gmax = (n_groups + splits - 1) / splits;
  const int kb = g_begin * group, ks = (g_end - g_begin) * group;
  const int ldx = gmax * group + L::XPAD, cps = gmax * group / CHUNK;
  const int n_stages = ks / (KSTEP * SPS);
  const int row0 = mt * 16 * MS;
  const uint32_t base = smem_u32(smem);
  unsigned char* s_ring =
      smem + ((SWIZZLE_ATOM - (base & (SWIZZLE_ATOM - 1))) &
              (SWIZZLE_ATOM - 1));
  const uint32_t bars = base + dec_bar_offset(ring);
  float* s_scale = reinterpret_cast<float*>(smem + dec_scale_offset(ring));
  float* s_x = reinterpret_cast<float*>(smem + dec_x_offset(ring, gmax));
  float* s_part = reinterpret_cast<float*>(
      smem + dec_part_offset(ring, MS, gmax, group, L::XPAD));
  auto full = [&](int slot) { return bars + 8 * (1 + slot); };
  auto empty = [&](int slot) { return bars + 8 * (1 + MAX_RING + slot); };

  if (tid == 0) {
    mbar_init(bars, 1);
    for (int r = 0; r < ring; ++r) {
      mbar_init(full(r), 1);
      mbar_init(empty(r), DEC_CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == DEC_CONSUMERS / 32) {
    // The producer: the split's x rows (rows past M repeat row M - 1 and
    // are never stored) and scales, then the weights stage by stage into
    // the ring, each stage once the consumers have released its slot.
    if (lane == 0) {
      const int n_sc = g_end - g_begin;
      mbar_expect(bars, 16 * MS * ks * 4 + n_sc * TILE_N * 4);
      for (int r = 0; r < 16 * MS; ++r) {
        const int row = min(row0 + r, M - 1);
        bulk_copy(smem_u32(s_x + r * ldx), x + (long long)row * K + kb,
                  ks * 4, bars);
      }
      for (int gg = 0; gg < n_sc; ++gg)
        bulk_copy(smem_u32(s_scale + gg * TILE_N),
                  scales + (long long)(g_begin + gg) * N + nt * TILE_N,
                  TILE_N * 4, bars);
      for (int st = 0; st < n_stages; ++st) {
        const int slot = st % ring, fill = st / ring;
        if (fill > 0) mbar_wait(empty(slot), (fill - 1) & 1);
        mbar_expect(full(slot), STAGE);
        const uint32_t dst = smem_u32(s_ring + slot * STAGE);
        if (LAYOUT == WORDS) {
#pragma unroll
          for (int b = 0; b < 4; ++b)
            tma_box(dst + b * 2048, wmap, nt * 128 + 32 * b,
                    kb / 4 + 16 * st, full(slot));
        } else {
          tma_box(dst, wmap, nt * 128, kb + 64 * st, full(slot));
        }
      }
    }
    __syncwarp();
  }

  // This lane's accumulators: n8 tile t = 4 hi + j (hi: high nibbles),
  // element e at row g + 8 (e >> 1) of its slab and tile column sc_col +
  // 128 hi + 4 (e & 1) + j.
  const int sc_col = (warp & 3) * 32 + 8 * tig;
  float acc[MS][8][4];
#pragma unroll
  for (int ms = 0; ms < MS; ++ms)
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[ms][t][e] = 0.0f;

  if (warp < DEC_CONSUMERS / 32) {
    mbar_wait(bars, 0);
    if (CORR) {
      // The split's chunk sums, a thread a chunk (its 16 vectors summed in
      // an order rotated by the chunk, so that a warp's reads spread over
      // the banks; fixed), read after the barrier that ends the main loop.
      const int chunks = ks / CHUNK;
      for (int c = tid; c < 16 * MS * chunks; c += DEC_CONSUMERS) {
        const int r = c / chunks, ch = c % chunks;
        const float4* v =
            reinterpret_cast<const float4*>(s_x + r * ldx + ch * CHUNK);
        float sum = sum4(v[c & 15]);
#pragma unroll
        for (int l = 1; l < 16; ++l) sum += sum4(v[(c + l) & 15]);
        s_part[r * cps + ch] = sum;
      }
    }
    // The B side's columns: packed columns 32 warp + 4 g + j (j = 0..3).
    const int b_col = warp * 32 + 4 * g;
    Scale2 sc[2][4];
    const int stages_per_group = group / (KSTEP * SPS);
    for (int st = 0; st < n_stages; ++st) {
      const int slot = st % ring;
      mbar_wait(full(slot), (st / ring) & 1);
      const unsigned char* stage = s_ring + slot * STAGE;
      if (st % stages_per_group == 0) {
        const float* gs =
            s_scale + (st / stages_per_group) * TILE_N + b_col;
        const float4 lo = *reinterpret_cast<const float4*>(gs);
        const float4 hi = *reinterpret_cast<const float4*>(gs + 128);
        sc[0][0] = scale2(lo.x, lo.x), sc[0][1] = scale2(lo.y, lo.y);
        sc[0][2] = scale2(lo.z, lo.z), sc[0][3] = scale2(lo.w, lo.w);
        sc[1][0] = scale2(hi.x, hi.x), sc[1][1] = scale2(hi.y, hi.y);
        sc[1][2] = scale2(hi.z, hi.z), sc[1][3] = scale2(hi.w, hi.w);
      }
#pragma unroll
      for (int ss = 0; ss < SPS; ++ss) {
        const int a_row = L::row(ss >> 1, ss & 1, tig);
        uint32_t a[MS][4];
#pragma unroll
        for (int ms = 0; ms < MS; ++ms) {
          const float* p =
              s_x + (ms * 16 + g) * ldx + st * (KSTEP * SPS) + 4 * a_row;
          const float4 v0 = *reinterpret_cast<const float4*>(p);
          const float4 v1 = *reinterpret_cast<const float4*>(p + 8 * ldx);
          a[ms][0] = pack_bf16(v0.x, v0.y);
          a[ms][1] = pack_bf16(v1.x, v1.y);
          a[ms][2] = pack_bf16(v0.z, v0.w);
          a[ms][3] = pack_bf16(v1.z, v1.w);
        }
        const int4 wv = L::words(stage, a_row, warp, g);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t wj = word(wv, j);
          const uint32_t t01 = __byte_perm(wj, 0, 0x4140);  // rows 0, 1
          const uint32_t t23 = __byte_perm(wj, 0, 0x4342);  // rows 2, 3
          const uint32_t lo0 = dequant2<CORR>(t01, sc[0][j]);
          const uint32_t lo1 = dequant2<CORR>(t23, sc[0][j]);
          const uint32_t hi0 = dequant2<CORR>(t01 >> 4, sc[1][j]);
          const uint32_t hi1 = dequant2<CORR>(t23 >> 4, sc[1][j]);
#pragma unroll
          for (int ms = 0; ms < MS; ++ms) {
            mma_bf16(acc[ms][j], a[ms], lo0, lo1);
            mma_bf16(acc[ms][4 + j], a[ms], hi0, hi1);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(slot));
    }

    if (CORR) {
      // -8 xsum[m, g] s[g, n] for the split's groups, in f32 on the
      // partial.
      asm volatile("bar.sync 1, %0;\n" ::"n"(DEC_CONSUMERS) : "memory");
      const int cpg = group / CHUNK;
      for (int gi = 0; gi < g_end - g_begin; ++gi) {
        float xs[MS][2];
#pragma unroll
        for (int ms = 0; ms < MS; ++ms)
#pragma unroll
          for (int h8 = 0; h8 < 2; ++h8) {
            const float* part =
                s_part + (ms * 16 + g + 8 * h8) * cps + gi * cpg;
            float v = part[0];
            for (int c = 1; c < cpg; ++c) v += part[c];
            xs[ms][h8] = -8.0f * v;
          }
        const float* gs = s_scale + gi * TILE_N + sc_col;
#pragma unroll
        for (int t = 0; t < 8; ++t)
#pragma unroll
          for (int o = 0; o < 2; ++o) {
            const float s = gs[128 * (t >> 2) + 4 * o + (t & 3)];
#pragma unroll
            for (int ms = 0; ms < MS; ++ms)
#pragma unroll
              for (int h8 = 0; h8 < 2; ++h8)
                acc[ms][t][2 * h8 + o] =
                    fmaf(xs[ms][h8], s, acc[ms][t][2 * h8 + o]);
          }
      }
    }
  }

  const bool consumer = warp < DEC_CONSUMERS / 32;
  const int col0 = nt * TILE_N + sc_col;
  if (splits == 1) {
    if (!consumer) return;
#pragma unroll
    for (int ms = 0; ms < MS; ++ms)
#pragma unroll
      for (int h8 = 0; h8 < 2; ++h8) {
        const int row = row0 + ms * 16 + g + 8 * h8;
        if (row >= M) continue;
#pragma unroll
        for (int hi = 0; hi < 2; ++hi)
#pragma unroll
          for (int o = 0; o < 2; ++o) {
            float4 v;
            v.x = acc[ms][4 * hi + 0][2 * h8 + o];
            v.y = acc[ms][4 * hi + 1][2 * h8 + o];
            v.z = acc[ms][4 * hi + 2][2 * h8 + o];
            v.w = acc[ms][4 * hi + 3][2 * h8 + o];
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
  // in split order from its own shared memory.
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int per = share_vecs(MS, splits);
  float4* push = reinterpret_cast<float4*>(
      smem + dec_push_offset(ring, MS, gmax, group, L::XPAD));
  const int rank = (int)cluster.block_rank();
  if (consumer) {
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
            v.x = acc[ms][4 * hi + 0][2 * h8 + o];
            v.y = acc[ms][4 * hi + 1][2 * h8 + o];
            v.z = acc[ms][4 * hi + 2][2 * h8 + o];
            v.w = acc[ms][4 * hi + 3][2 * h8 + o];
            const int e = r * (TILE_N / 4) + (sc_col + 128 * hi + 4 * o) / 4;
            const int owner = e / per;
            float4* dst = cluster.map_shared_rank(push, owner);
            dst[rank * per + e - owner * per] = v;
          }
      }
  }
  cluster.sync();
  const int n_vec = MS * 16 * (TILE_N / 4);
  const int first = rank * per;
  const int last = min(n_vec, first + per);
  for (int e = first + tid; e < last; e += DEC_THREADS) {
    const int r = e / (TILE_N / 4), c = 4 * (e % (TILE_N / 4));
    if (row0 + r >= M) continue;
    float4 sum = push[e - first];
    for (int zz = 1; zz < splits; ++zz) {
      const float4 v = push[zz * per + e - first];
      sum.x += v.x, sum.y += v.y, sum.z += v.z, sum.w += v.w;
    }
    *reinterpret_cast<float4*>(out + (long long)(row0 + r) * N +
                               nt * TILE_N + c) = sum;
  }
}

// ---- prefill tile --------------------------------------------------------

constexpr int PF_BM = 128;        // rows per block: 2 warpgroups of 64
constexpr int PF_BK = 64;         // K rows per stage (the group's divisor)
constexpr int PF_STAGES = 4;
constexpr int PF_THREADS = 256;
constexpr int PF_X_STAGE = PF_BM * PF_BK * 2;   // bf16, swizzled
constexpr int PF_W_STAGE = PF_BK * 128;         // raw int4 (both layouts)
constexpr int PF_S_STAGE = TILE_N * 4;          // the stage's f32 scales
constexpr int PF_RING = PF_X_STAGE + PF_W_STAGE + PF_S_STAGE;
constexpr int PF_B_BUF = PF_BK * TILE_N * 2;    // bf16, 4 column blocks
constexpr int PF_SMEM = SWIZZLE_ATOM + PF_STAGES * PF_RING + 2 * PF_B_BUF;
constexpr int PF_CORR_GROUPS = 48;  // groups of the correction staged at once
static_assert(PF_CORR_GROUPS * (TILE_N + PF_BM) * 4 <= PF_STAGES * PF_RING,
              "the correction's staging must fit in the ring");

// One row of x to bf16 (rows past M: zeros) and, with xsum, its group sums:
// a warp per group, a half-warp per 64-value chunk, chunk sums in order.
__global__ void __launch_bounds__(256)
    int4_prep_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ xb,
                     float* __restrict__ xsum, int M, int K, int group) {
  let_gemm_start();
  const int m = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int half = lane >> 4, l16 = lane & 15;
  const int G = K / group, cpg = group / CHUNK;
  for (int gi = warp; gi < G; gi += 8) {
    float run = 0.0f;
    for (int ch = 0; ch < cpg; ch += 2) {
      const int c = ch + half;
      const long long k = (long long)gi * group + c * CHUNK + 4 * l16;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c < cpg) {
        if (m < M) v = __ldg(reinterpret_cast<const float4*>(x + m * (long long)K + k));
        *reinterpret_cast<uint2*>(xb + m * (long long)K + k) =
            make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
      }
      const float s = half_warp_sum(sum4(v));
      const float s0 = __shfl_sync(0xffffffffu, s, 0);
      const float s1 = __shfl_sync(0xffffffffu, s, 16);
      run = ch == 0 ? s0 : run + s0;
      if (ch + 1 < cpg) run += s1;
    }
    if (xsum != nullptr && lane == 0) xsum[(long long)m * G + gi] = run;
  }
}

// The conversion of one stage's raw W by thread tid: K rows 4 r4 .. 4 r4 + 3
// of the stage (r4 = tid / 16) and packed columns 8 qc .. 8 qc + 7 (qc = tid
// % 16). t[i][p] holds, in bits 0-7 and 16-23, the bytes of K row 4 r4 + i
// and packed columns 8 qc + 2 p, 8 qc + 2 p + 1.
template <int LAYOUT>
__device__ __forceinline__ void pf_pairs(const unsigned char* raw, int r4,
                                         int qc, uint32_t (&t)[4][4]) {
  if (LAYOUT == WORDS) {
    // [16 word rows][128 words]: 8 words of word row r4.
    const uint4* p = reinterpret_cast<const uint4*>(raw + r4 * 512 + 32 * qc);
    const uint4 a = p[0], b = p[1];
    const uint32_t wv[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int pp = 0; pp < 4; ++pp)
        t[i][pp] = __byte_perm(wv[2 * pp], wv[2 * pp + 1], i | ((4 + i) << 8));
  } else {
    // [64 rows][128 bytes]: 8 bytes of each of 4 rows.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint2 v =
          *reinterpret_cast<const uint2*>(raw + (4 * r4 + i) * 128 + 8 * qc);
      t[i][0] = __byte_perm(v.x, 0, 0x0100);
      t[i][1] = __byte_perm(v.x, 0, 0x0302);
      t[i][2] = __byte_perm(v.y, 0, 0x0100);
      t[i][3] = __byte_perm(v.y, 0, 0x0302);
    }
  }
}

// Warpgroup wg owns rows 64 wg .. 64 wg + 63 of the block and all 256
// columns. Shared memory: the ring [stage] of {x [128][64] bf16 (K-major: a
// row is one 128-byte swizzle row), raw W [8 KB], scales [256] f32}, then
// the bf16 W tiles [2][4 column blocks of 64][64 k][64 n] (N-major: a k row
// of 64 columns is one swizzle row; column blocks 8 KB apart). Column c of
// the tile is packed column c (low nibbles) for c < 128, packed column c -
// 128 (high nibbles) above: output column nt 256 + c either way.
template <int LAYOUT, bool CORR>
__global__ void __launch_bounds__(PF_THREADS, 1)
    int4_prefill_kernel(const __nv_bfloat16* __restrict__ xb,
                        const float* __restrict__ xsum,
                        const void* __restrict__ w,
                        const float* __restrict__ scales,
                        float* __restrict__ out, int M, int K, int N,
                        int group) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw_addr = smem_u32(smem_raw);
  unsigned char* smem =
      smem_raw + ((SWIZZLE_ATOM - (raw_addr & (SWIZZLE_ATOM - 1))) &
                  (SWIZZLE_ATOM - 1));
  unsigned char* ring = smem;
  unsigned char* b_buf = ring + PF_STAGES * PF_RING;

  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int warp_in_wg = (tid >> 5) & 3, g = lane >> 2, tig = lane & 3;
  const int nt = blockIdx.x, m0 = blockIdx.y * PF_BM;
  const int k_steps = K / PF_BK, half_n = N / 2;

  auto load_w = [&](int stage, int kt) {
    unsigned char* r = ring + stage * PF_RING;
    unsigned char* wd = r + PF_X_STAGE;
    for (int c = tid; c < PF_W_STAGE / 16; c += PF_THREADS) {
      if (LAYOUT == WORDS) {
        const int row = c >> 5, q = c & 31;
        cp_async16(wd + row * 512 + 16 * q,
                   static_cast<const int*>(w) +
                       (long long)(kt * (PF_BK / 4) + row) * half_n +
                       nt * 128 + 4 * q);
      } else {
        const int row = c >> 3, q = c & 7;
        cp_async16(wd + row * 128 + 16 * q,
                   static_cast<const uint8_t*>(w) +
                       (long long)(kt * PF_BK + row) * half_n + nt * 128 +
                       16 * q);
      }
    }
    float* sd = reinterpret_cast<float*>(wd + PF_W_STAGE);
    for (int c = tid; c < TILE_N / 4; c += PF_THREADS)
      cp_async16(sd + 4 * c, scales + (long long)(kt * PF_BK / group) * N +
                                 nt * TILE_N + 4 * c);
  };
  auto load_x = [&](int stage, int kt) {
    unsigned char* xd = ring + stage * PF_RING;
    for (int c = tid; c < PF_BM * (PF_BK / 8); c += PF_THREADS) {
      const int r = c >> 3, q = c & 7;
      cp_async16(xd + swz(r, q),
                 xb + (long long)(m0 + r) * K + kt * PF_BK + q * 8);
    }
  };
  // Stage kt's raw W to bf16 in buffer b.
  auto convert = [&](int kt, int b) {
    const unsigned char* r = ring + (kt % PF_STAGES) * PF_RING;
    const float* sd = reinterpret_cast<const float*>(r + PF_X_STAGE +
                                                     PF_W_STAGE);
    const int r4 = tid >> 4, qc = tid & 15;
    uint32_t t[4][4];
    pf_pairs<LAYOUT>(r + PF_X_STAGE, r4, qc, t);
    Scale2 sc[2][4];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const float4 a = *reinterpret_cast<const float4*>(sd + 128 * hi + 8 * qc);
      const float4 c = *reinterpret_cast<const float4*>(sd + 128 * hi + 8 * qc + 4);
      sc[hi][0] = scale2(a.x, a.y), sc[hi][1] = scale2(a.z, a.w);
      sc[hi][2] = scale2(c.x, c.y), sc[hi][3] = scale2(c.z, c.w);
    }
    unsigned char* bt = b_buf + b * PF_B_BUF;
    const int chunk = qc & 7, blk = qc >> 3;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = 4 * r4 + i;
      uint32_t lo[4], hi[4];
#pragma unroll
      for (int pp = 0; pp < 4; ++pp) {
        lo[pp] = dequant2<CORR>(t[i][pp], sc[0][pp]);
        hi[pp] = dequant2<CORR>(t[i][pp] >> 4, sc[1][pp]);
      }
      *reinterpret_cast<uint4*>(bt + blk * (PF_BK * 128) + swz(k, chunk)) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
      *reinterpret_cast<uint4*>(bt + (2 + blk) * (PF_BK * 128) +
                                swz(k, chunk)) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
    }
    fence_proxy_async();
  };

  float d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.0f;

  // The weights of the first stages are requested before the prep ends;
  // x after it. Groups: [W 0..2], [x 0], [x 1], [x 2], then one a step.
#pragma unroll
  for (int s = 0; s < PF_STAGES - 1; ++s)
    if (s < k_steps) load_w(s, s);
  cp_commit();
  wait_for_prep();
#pragma unroll
  for (int s = 0; s < PF_STAGES - 1; ++s) {
    if (s < k_steps) load_x(s, s);
    cp_commit();
  }
  cp_wait<PF_STAGES - 2>();
  __syncthreads();
  convert(0, 0);
  // Iteration kt: stages kt and kt + 1 have landed and buffer kt % 2 is
  // complete after the barrier; the tensor cores run stage kt while the
  // block converts stage kt + 1.
  for (int kt = 0; kt < k_steps; ++kt) {
    cp_wait<PF_STAGES - 3>();
    fence_proxy_async();
    __syncthreads();
    const int nk = kt + PF_STAGES - 1;
    if (nk < k_steps) {
      load_w(nk % PF_STAGES, nk);
      load_x(nk % PF_STAGES, nk);
    }
    cp_commit();
    const uint32_t xa = smem_u32(ring + (kt % PF_STAGES) * PF_RING) +
                        wg * 8 * SWIZZLE_ATOM;
    const uint32_t ba = smem_u32(b_buf + (kt & 1) * PF_B_BUF);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < PF_BK / 16; ++kk)
      wgmma_256(d, smem_desc(xa + 32 * kk, 16, SWIZZLE_ATOM),
                smem_desc(ba + 2 * SWIZZLE_ATOM * kk, PF_BK * 128,
                          SWIZZLE_ATOM));
    wgmma_commit();
    if (kt + 1 < k_steps) convert(kt + 1, (kt + 1) & 1);
    wgmma_wait<0>();
  }
  cp_wait<0>();

  // d[4 j + e]: row 16 warp_in_wg + g + 8 (e >> 1) of the warpgroup's 64,
  // tile column 8 j + 2 tig + (e & 1).
  const int r_lo = 64 * wg + 16 * warp_in_wg + g;
  if (CORR) {
    // -8 xsum[m, g] s[g, n] over every group, staged in the ring in slices
    // of PF_CORR_GROUPS groups: scales [groups][256], xsum [128][groups].
    const int G = K / group;
    float* s_sc = reinterpret_cast<float*>(ring);
    float* s_xs = s_sc + PF_CORR_GROUPS * TILE_N;
    for (int g0 = 0; g0 < G; g0 += PF_CORR_GROUPS) {
      const int gn = min(PF_CORR_GROUPS, G - g0);
      __syncthreads();
      for (int c = tid; c < gn * TILE_N; c += PF_THREADS)
        s_sc[c] = scales[(long long)(g0 + c / TILE_N) * N + nt * TILE_N +
                         c % TILE_N];
      for (int c = tid; c < PF_BM * gn; c += PF_THREADS)
        s_xs[c] = xsum[(long long)(m0 + c / gn) * G + g0 + c % gn];
      __syncthreads();
      for (int gi = 0; gi < gn; ++gi) {
        const float xs_lo = -8.0f * s_xs[r_lo * gn + gi];
        const float xs_hi = -8.0f * s_xs[(r_lo + 8) * gn + gi];
        const float* sc = s_sc + gi * TILE_N + 2 * tig;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const float2 s = *reinterpret_cast<const float2*>(sc + 8 * j);
          d[4 * j + 0] = fmaf(xs_lo, s.x, d[4 * j + 0]);
          d[4 * j + 1] = fmaf(xs_lo, s.y, d[4 * j + 1]);
          d[4 * j + 2] = fmaf(xs_hi, s.x, d[4 * j + 2]);
          d[4 * j + 3] = fmaf(xs_hi, s.y, d[4 * j + 3]);
        }
      }
    }
  }
#pragma unroll
  for (int h8 = 0; h8 < 2; ++h8) {
    const int row = m0 + r_lo + 8 * h8;
    if (row >= M) continue;
    float* o = out + (long long)row * N + nt * TILE_N + 2 * tig;
#pragma unroll
    for (int j = 0; j < 32; ++j)
      *reinterpret_cast<float2*>(o + 8 * j) =
          make_float2(d[4 * j + 2 * h8], d[4 * j + 2 * h8 + 1]);
  }
}

// The function attributes, raised once per device and kernel (a host call
// per launch would cost the host-bound decode step).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int (&done)[MAX_DEVICES],
                       int dev) {
  if (bytes > done[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    done[dev] = bytes;
  }
  return cudaSuccess;
}

// The weights' tensor map (words: uint32 [K/4, N/2], boxes of 32 words x
// 16 rows; bytes: uint8 [K, N/2], boxes of 128 bytes x 64 rows; 128-byte
// swizzle), encoded once per weight (tensor_map_2d's cache).
cudaError_t weight_map(const void* w, int K, int N, int layout,
                       CUtensorMap* map) {
  const bool words = layout == WORDS;
  return tensor_map_2d(
      w, words ? CU_TENSOR_MAP_DATA_TYPE_UINT32 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
      (uint64_t)N / 2, (uint64_t)(words ? K / 4 : K),
      (uint64_t)N / 2 * (words ? 4 : 1), words ? 32u : 128u,
      words ? 16u : 64u, CU_TENSOR_MAP_SWIZZLE_128B, map);
}

template <int LAYOUT, bool CORR, int MS>
cudaError_t launch_decode(const float* x, const void* w, const float* scales,
                          float* out, int M, int K, int N, int group,
                          int splits, int ring, int dev, cudaStream_t st) {
  static int smem_set[MAX_DEVICES];
  static bool cluster_set[MAX_DEVICES];
  auto kernel = int4_decode_kernel<LAYOUT, CORR, MS>;
  const int gmax = (K / group + splits - 1) / splits;
  const int smem =
      dec_smem(ring, MS, gmax, group, Loader<LAYOUT>::XPAD, splits);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  CUtensorMap map;
  cudaError_t err = weight_map(w, K, N, LAYOUT, &map);
  if (err != cudaSuccess) return err;
  err = allow_smem(kernel, smem, smem_set, dev);
  if (err != cudaSuccess) return err;
  if (splits > 8 && !cluster_set[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    cluster_set[dev] = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cudaLaunchConfig_t cfg = {};
  const int m_tiles = (M + 16 * MS - 1) / (16 * MS);
  cfg.gridDim = dim3(m_tiles, N / TILE_N, splits);
  cfg.blockDim = dim3(DEC_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, map, x, scales, out, M, K, N, group,
                            splits, ring);
}

template <int LAYOUT, bool CORR>
cudaError_t launch_prefill(const float* x, const void* w, const float* scales,
                           __nv_bfloat16* xb, float* xsum, float* out, int M,
                           int K, int N, int group, int dev, cudaStream_t st) {
  static int smem_set[MAX_DEVICES];
  const int m_tiles = (M + PF_BM - 1) / PF_BM;
  int4_prep_kernel<<<m_tiles * PF_BM, 256, 0, st>>>(x, xb,
                                                    CORR ? xsum : nullptr, M,
                                                    K, group);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto kernel = int4_prefill_kernel<LAYOUT, CORR>;
  err = allow_smem(kernel, PF_SMEM, smem_set, dev);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N / TILE_N, m_tiles);
  cfg.blockDim = dim3(PF_THREADS);
  cfg.dynamicSmemBytes = PF_SMEM;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, (const __nv_bfloat16*)xb,
                            (const float*)xsum, w, scales, out, M, K, N,
                            group);
}

}  // namespace

// x f32 [M, K]; w words int32 [K/4, N/2] (mode 0, Q1) or bytes uint8
// [K, N/2] (mode 2, Q2); scales f32 [K / group, N]; out f32 [M, N]; all
// contiguous and 16-byte aligned; group % 64 == 0, N % 256 == 0. tile 0
// (decode): ms (1 or 2) m16 slabs per row tile, splits in [1, min(K / group,
// MAX_SPLITS)], ring in [1, MAX_RING] stages, no scratch. tile 1 (prefill): scratch xb bf16 [m_pad, K] and
// (mode 0) xsum f32 [m_pad, K / group], m_pad = M rounded up to 128. Sized
// by gemm.py::int4_bf16_plan.
extern "C" int matmul_int4(const void* x, const void* w, const void* scales,
                           void* xb, void* xsum, void* out, int M, int K,
                           int N, int group, int mode, int tile, int ms,
                           int splits, int ring, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  if ((mode != 0 && mode != 2) || group <= 0 || group % CHUNK || K % group ||
      N % TILE_N || (tile != 0 && tile != 1))
    return (int)cudaErrorInvalidValue;
  if (tile == 0 && ((ms != 1 && ms != 2) || splits < 1 ||
                    splits > K / group || splits > MAX_SPLITS || ring < 1 ||
                    ring > MAX_RING))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= MAX_DEVICES)
    return (int)(err != cudaSuccess ? err : cudaErrorInvalidDevice);
  const float* xf = (const float*)x;
  const float* sf = (const float*)scales;
  float* of = (float*)out;
  if (tile == 0) {
    if (mode == 0)
      err = ms == 1 ? launch_decode<WORDS, true, 1>(xf, w, sf, of, M, K, N,
                                                    group, splits, ring, dev, st)
                    : launch_decode<WORDS, true, 2>(xf, w, sf, of, M, K, N,
                                                    group, splits, ring, dev, st);
    else
      err = ms == 1 ? launch_decode<BYTES, false, 1>(xf, w, sf, of, M, K, N,
                                                     group, splits, ring, dev, st)
                    : launch_decode<BYTES, false, 2>(xf, w, sf, of, M, K, N,
                                                     group, splits, ring, dev, st);
  } else {
    auto* xbp = (__nv_bfloat16*)xb;
    if (mode == 0)
      err = launch_prefill<WORDS, true>(xf, w, sf, xbp, (float*)xsum, of, M,
                                        K, N, group, dev, st);
    else
      err = launch_prefill<BYTES, false>(xf, w, sf, xbp, nullptr, of, M, K, N,
                                         group, dev, st);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
