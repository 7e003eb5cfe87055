// Decode attention with every query head of a KV head's group in one
// block, and chunked-verify attention with every (query, head) pair of the
// group in one block, over int8 rows with bf16 scales or over float rows
// (f32 or bf16): the kernel of decode_attn_paged.cu (P3i on an int8 pool,
// P3 and its grid mode on an f32 pool: rows through the page table), of
// decode_attn_grouped_int8.cu's G1 and G2 (contiguous int8 rows, exact q or
// int8 scores, and G1's pv_int8 in both), of decode_attn_float.cu's K6,
// K8 and native_dots (contiguous f32 or bf16 rows: exact, with
// flash_decode_flat's roundings, or with native_dots' on bf16 rows), of
// verify_attn.cu's V1 (S <= 8 verify
// queries a sequence over contiguous f32, bf16 or int8 rows), of
// decode_attn_append.cu's A1 (contiguous f32 or bf16 rows, the decode
// append written by the same launch), of decode_attn_split.cu's K9
// (separate f32 or bf16 K and V planes) and of decode_attn_grouped_int8.cu's
// partials entry (flash_decode_flat's seq-shard mode on int8 rows).
//
// Contract: for sequence b and KV head kh, query heads kh * rep .. kh * rep
// + rep - 1 (rep = H / KVH) read rows t < n = min(lengths[b], capacity),
// row t of sequence b from the row the addressing gives (Rows: [b, t] of a
// [B, cap, 2, KVH*D] cache; Pages: [table[b, t / page], t % page] of a
// [n_pages, page, 2, KVH*D] pool, an unmapped id (-1) reading pool page
// 0; MaskedPages: the same, but the rows of an unmapped page take no
// weight; Planes: [b, kh, t] of separate K and V planes [B, KVH, S, D]).
// q f32 [B, H, D], out f32 [B, H, D]. ChunkRows (Rows with S
// verify queries, kExact only): q and out [B, S, H, D], lengths count the
// rows before the chunk, and query i reads rows t < min(max(lengths[b], 0)
// + i + 1, cap). AppendRows (Rows with the decode append fused, float rows,
// kExact only): the new f32 rows new_k / new_v [B, KVH*D] (row strides in
// elements) are cast to the cache's type (bf16 rounds to nearest even) and
// written at pos = clip(lengths[b] - 1, 0, cap - 1), for every length, by
// one block per (sequence, KV head); row n - 1 (= pos whenever n >= 1) is
// staged from the new row, never read from the cache.
// int8 rows (T = int8_t) carry bf16 scales [.., 2, KVH] per (row, plane,
// KV head), and nothing is rounded to bf16:
// kExact: s_t = ((q . k8_t) * scale) * k_scale_t.
// kScores: q row-quantized in the kernel (verify_rows::quantize_q: qs =
//   absmax / 127, 1 where the row is 0; q8 = clip(rint(q / qs), -127, 127))
//   and s_t = (f32(int32 q8 . k8_t) * (qs * scale)) * k_scale_t; with
//   `dots` the int32 sums [B, H, cap] are stored for t < n.
// Then out = sum_t p_t v_scale_t v8_t / max(sum_t p_t, 1e-30), p_t =
// exp(s_t - max s): l takes the unscaled p, V is weighted by p * v_scale.
// Float rows (T = float or __nv_bfloat16), read as f32:
// kExact: s_t = (q . k_t) * scale, out = sum_t p_t v_t / max(sum_t p_t,
//   1e-30), all in f32.
// kFlat (flash_decode_flat's float mode with q_bf16): q is rounded to bf16
//   as it enters and every K element before the score dot (a bf16 cache's
//   are already), V is used as stored, and the normalized output is
//   rounded to bf16.
// The block modes (Rows only; `unit` = the reference block of R rows,
// counted from row 0): m_i is the max over rows 0 .. i R + R - 1 of the
// sequence (the running max after block i) and p_t = exp(s_t - m_i) for
// the rows of block i; l takes p. kNative (flash_decode_grouped's
// native_dots on bf16 rows): q is rounded to bf16 as it enters, the dots
// run in f32, and P V takes bf16(p) (out is not rounded). kPvExact and
// kPvScores (its pv_int8 with exact q or int8 scores): pm_t = p_t v_scale_t,
// pq = max(max over the block's live rows of pm, 1e-30) / 127, p8_t =
// rint(pm_t / pq) (IEEE division, ties to even), and block i adds
// f32(sum p8_t v8_t) pq, the integer sum exact in f32 (R <= 1024).
// A sequence with no live row (or, masked, no mapped live row) gets zeros.
// The partials modes (int8 rows, Rows only; flash_decode_flat(partials=
// True)): kPartExact's scores as kExact's, kPartBf16's with q rounded to
// bf16 as it enters; out f32 [B, H, D + 2] holds the unnormalized acc =
// sum_t p_t v_scale_t v8_t (rounded to bf16 in kPartBf16), m = max_t s_t
// (lane D) and l = sum_t p_t (lane D + 1), p_t = exp(s_t - m) against that
// global m after the splits' merge; a sequence with no live row emits acc
// 0, m = -1e30 and l 0.
//
// Bound on the H100: bytes. Each live row's K and V slices of one KV head
// (2 x D elements) and, for int8, its two bf16 scales are read once for the
// whole group; the arithmetic, about 4 f32 flops a query head and element
// (and one exact convert per int8 element), is as long as the int8 bytes
// at a group of 4 (G1 at path (H)) and a quarter of them at a group of 1
// (P3i at path (D)); over f32 rows it is 1 flop a byte at a group of 1 (P3
// at (E), K8 at (I)) against the card's 20 flops a byte. The block modes
// read the same bytes where a block fits a ring tile (K once more a pass
// before the last where it does not) and add, per tile, one or two
// exchanges between warps and, per row and query head, a bf16 rounding or
// a division and a rint.
//
// Design: one block of 4 or 8 warps per (sequence, KV head, split), so each
// row crosses from device memory once for a group of up to 8 query rows (4
// above D 128): the group's query heads, or a verify chunk's S x rep pairs
// (query i, head h), row i * rep + h; a larger group takes a block per 8
// (or 4) of its rows, each reading the rows. A verify row's causal limit is
// one compare per (query row, row) in the score pass.
// - Rows move a tile at a time through a ring of stages in shared memory by
//   16-byte cp.async copies: the tile's K and V slices are in flight
//   together, and the next tiles' while this one is computed. An int8 tile
//   is 64 rows (32 above D 128), 8 KB at D 64, in 2 stages; a float tile
//   is kF32Rows or kBf16Rows rows at D 64, fewer at a wider D (tile_rows),
//   in kFloatStages stages; a page then takes several tiles. The ring is
//   dynamic shared memory (the opt-in is set where the block's shared
//   memory passes 48 KB). The two bf16 scales of each int8 row are plain
//   loads sent with the copies and stored beside them after the current
//   tile's compute.
// - A paged block reads its chunk's page ids from the table once, into
//   shared memory, before any copy: one id a page, not one a row. With one
//   split every id of the sequence loads beside the length and q, so a
//   block waits on one round trip to device memory before its copies. A
//   masked block stages the raw ids, copies nothing for an unmapped page
//   and gives its rows no weight.
// - Compute reads the tile from shared memory on the eight-lanes-a-row
//   layout (decode_attn.cuh): each lane holds D / 8 values of a row (int8:
//   contiguous, in 8- or 16-byte loads, converted exactly by a byte permute
//   and one float subtract; f32 and bf16: the 16-byte chunks slot, slot +
//   8, .. of the row, so the eight lanes of a row read 128 contiguous bytes
//   at once, free of bank conflicts); the dot reduces over 8 lanes. A warp
//   serves kHpw query heads of the group with q and the accumulators in
//   registers (kHpw * D / 8 <= 32 values each), so a row read from shared
//   memory is used kHpw times; where the group has more heads, kHG head
//   groups of warps share each staged row. Each warp keeps an online
//   softmax per head and takes a tile in three passes: the scores of all
//   its rows of the tile (independent steps the scheduler interleaves), one
//   max and one rescale per head (skipped where the max did not grow: alpha
//   would be 1), then P V; a partial tile skips its dead steps, and a dead
//   float row's stale shared memory is never weighed.
// - AppendRows: the thread that owns a 16-byte piece of row n - 1 in a
//   stage loads its elements from new_k / new_v, rounds them to T and
//   stores them into the slot where the copy would have landed; the
//   stage's wait and barrier cover both kinds of store. So no block of the
//   launch reads row pos from device memory, and the write of split 0's
//   first head block (blockIdx.y % chunks == 0) races with nothing, however
//   many blocks stage the row; it goes through the addressing's own
//   pointer, so the read pointer's __restrict__ stays sound.
// - The block modes round p at a step set by the whole reference block,
//   whose rows lie on every warp of the head group. A block of at most a
//   tile's rows takes one tile (the stage holds it, partly if it is
//   shorter); a longer one takes its tiles once a pass: its max, (pv_int8)
//   its max of p * v_scale, then the walk, each pass scoring its rows again
//   from K (copied alone before the last pass). After a block's max pass
//   the group's warps exchange their maxima through shared memory under a
//   named barrier (bar.sync over the group's warps) and each takes the
//   same m_i; pv_int8 exchanges its maxima of pm the same way, and each
//   warp sums p8 * v8 into a block sum that enters acc once, times pq. So
//   every row of a block is scored before any of its p is rounded, and
//   every warp rounds under the same m_i and pq. native_dots runs one
//   split (its rounding depends on m_i, a max from row 0); pv_int8 keeps
//   the plan's splits of whole blocks (p8 does not depend on which m the
//   block's rows share).
// - A sequence splits into `splits` chunks of whole units (a page, 16
//   rows, or a reference block) only where B x KVH alone leaves the card
//   short of blocks; the
//   splits of a (sequence, KV head) form one thread-block cluster and merge
//   their (m, l, acc) through distributed shared memory after one cluster
//   barrier: one launch, no scratch. A launch of few blocks takes 8 warps
//   a block: the walk is bound by the latency of its warps, not by the
//   instruction rate.
// What bounds it (python -m rten_tpu_torch.tools.kv_group_variants): for
// the int8 rows the staged copies alone, without the walk, take 0.79-0.87
// of the whole kernel's time at both paths' shapes, the walk alone
// 0.66-0.84: each block's chain of round trips (length, ids, copies) and
// the few warps left to hide them, not the card's byte rate. Over f32 rows
// at 3072 blocks (P3, K8) it reaches 0.73 of the byte bound (the float
// ring's tilings: kF32Rows below).
#pragma once
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "verify_attn.cuh"

namespace kv_group {

namespace cg = cooperative_groups;

constexpr int kLanes = 8;        // lanes a row
constexpr int kMaxIds = 256;     // page ids a paged block stages
constexpr int kMaxSplits = 8;    // a cluster holds a sequence's splits
constexpr int kMaxSmem = 227 * 1024;
// Rows of a float ring stage at D 64 (halved for each doubling of D, at
// least 16) and the stages of a float ring. Tiles of 16, 32 and 64 rows in
// 2 or 3 stages read within 5% of each other at paths (E), (I) and
// (I-bf16), but 3 x 64 f32 rows (11% slower at (E), 44% at the grid mode's
// batch of 3); 16 rows were 22% slower at TinyLlama's K8, and a third stage
// gained nowhere (tools/kv_group_variants.py, which builds the others by
// patching this line).
constexpr int kF32Rows = 32, kBf16Rows = 64, kFloatStages = 2;

// kExact and kScores on int8 rows; kExact and kFlat on float rows. The
// block modes (Rows only) take one max per reference block of `unit` rows
// for the whole head group: kNative on bf16 rows (flash_decode_grouped's
// native_dots), kPvExact and kPvScores on int8 rows (its pv_int8, with exact
// q or int8 scores).
// kPartExact and kPartBf16 (int8 rows, Rows only) emit the unnormalized
// state of flash_decode_flat's partials mode, q exact or rounded to bf16.
enum Mode {
  kExact = 0, kScores = 1, kFlat = 2, kNative = 3, kPvExact = 4,
  kPvScores = 5, kPartExact = 6, kPartBf16 = 7
};

__host__ __device__ constexpr int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Rows a ring stage holds and the stages of the ring, for rows of D
// elements of elt bytes.
__host__ __device__ constexpr int tile_rows(int d, int elt) {
  if (elt == 1) return d <= 128 ? 64 : 32;
  const int r = (elt == 4 ? kF32Rows : kBf16Rows) * 64 / pow2_at_least(d);
  return r < 16 ? 16 : r;
}
__host__ __device__ constexpr int ring_stages(int elt) {
  return elt == 1 ? 2 : kFloatStages;
}

// The block's sizes for rows of T at D = 8 * kDpl: tile, stages, shared
// memory (the ring, which after the walk holds the warps' and the block's
// softmax states: it is sized to hold both).
template <typename T, int kDpl, int kHpw, int kHG, int kWarps>
struct Shape {
  static constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  static constexpr int d = kLanes * kDpl;
  static constexpr int kTile = tile_rows(d, sizeof(T));
  static constexpr int kStages = ring_stages(sizeof(T));
  static constexpr int kPlane = kTile * d * (int)sizeof(T);
  static constexpr int kStage = 2 * kPlane + (kInt8 ? 2 * kTile * 4 : 0);
  static constexpr int kHeads = kHG * kHpw;
  static constexpr int kMerge =
      4 * (2 * kWarps * kHpw + kWarps * kHpw * d + 2 * kHeads + kHeads * d);
  static constexpr int kSmem =
      kStages * kStage > kMerge ? kStages * kStage : kMerge;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// The four signed bytes of w as exact floats: byte b of w ^ 0x80808080 is
// v + 128 in [0, 255]; under the exponent of 2^23 it reads 2^23 + v + 128.
__device__ __forceinline__ void s8x4_to_f32(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.0f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.0f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.0f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.0f;
}

// Each addressing gives row t of sequence b a row index r, for t in the
// block's chunk [c0, c1), or -1 for a masked row, which is neither copied
// nor weighed; k_at and v_at (below) point at KV head kh's K and V slices
// of row r, D elements each. Rows, ChunkRows, AppendRows and the page
// tables index interleaved rows [rows, 2, KVH*D] (and [rows, 2, KVH] for
// the scales); Planes separate K and V planes.

// Each addressing also gives the query rows of a sequence and KV head: a
// decode step's are the group's rep query heads, q and out [B, H, D], and
// lengths count the query (rows t < min(lengths, cap)); a verify chunk's
// (ChunkRows) are below.

// A contiguous cache [B, cap, 2, KVH*D]: row b * cap + t.
struct Rows {
  static constexpr int kIds = 1;
  static constexpr bool kMasks = false;
  static constexpr bool kChunk = false;
  static constexpr bool kAppend = false;
  int cap;
  __host__ __device__ int queries() const { return 1; }
  __device__ int capacity() const { return cap; }
  __device__ void stage_ids(int*, int, int, int) const {}
  __device__ long long row(const int*, int b, int t, int) const {
    return (long long)b * cap + t;
  }
  __device__ bool live(const int*, int, int) const { return true; }
};

// A contiguous cache with a chunk of s >= 1 verify queries a sequence: q
// and out [B, s, H, D]; lengths count the rows before the chunk, and query
// i reads rows t < min(lengths + i + 1, cap). The
// group's query rows are the s x rep pairs (i, h), row i * rep + h, each
// with its own limit: a row past it scores -inf.
struct ChunkRows : Rows {
  static constexpr bool kChunk = true;
  int s;
  __host__ __device__ int queries() const { return s; }
};

// A contiguous float cache with the decode append fused: the new f32 rows
// new_k and new_v [B, KVH*D] (row strides ks and vs, in elements; 16-byte
// aligned, as the wrapper checks) and the cache again, writable.
template <typename T>
struct AppendRows : Rows {
  static constexpr bool kAppend = true;
  const float* new_k;
  const float* new_v;
  int ks, vs;
  T* cache;
  // The 16 bytes of T at element e of sequence b's new row of `plane`:
  // its f32 values rounded to T.
  __device__ uint4 piece(int b, int plane, int e) const {
    const float4* src = reinterpret_cast<const float4*>(
        plane == 0 ? new_k + (long long)b * ks + e
                   : new_v + (long long)b * vs + e);
    const float4 a = src[0];
    if constexpr (std::is_same<T, float>::value) {
      return make_uint4(__float_as_uint(a.x), __float_as_uint(a.y),
                        __float_as_uint(a.z), __float_as_uint(a.w));
    } else {
      const float4 c = src[1];
      return make_uint4(bf16x2(a.x, a.y), bf16x2(a.z, a.w),
                        bf16x2(c.x, c.y), bf16x2(c.z, c.w));
    }
  }
  static __device__ unsigned bf16x2(float lo, float hi) {
    return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
           (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16;
  }
};

// A block-paged pool [n_pages, page, 2, KVH*D] through the table [B,
// max_pages]: the chunk starts on a page boundary, and its page ids sit in
// shared memory, at most kMaxIds of them (the wrapper's plan splits to
// keep it so; with one split every id of the row, max_pages <= kMaxIds).
// kMask false clamps an id to >= 0 (an unmapped page reads pool page 0,
// the reference's grouped kernels); kMask true keeps it, and an unmapped
// page's rows are masked (its grid kernel).
template <bool kMask>
struct PageTable {
  static constexpr int kIds = kMaxIds;
  static constexpr bool kMasks = kMask;
  static constexpr bool kChunk = false;
  static constexpr bool kAppend = false;
  const int* table;
  int page, max_pages;
  __host__ __device__ int queries() const { return 1; }
  __device__ int capacity() const { return page * max_pages; }
  __device__ void stage_ids(int* ids, int b, int c0, int c1) const {
    const int p0 = c0 / page, np = (c1 - c0 + page - 1) / page;
    for (int i = threadIdx.x; i < np; i += blockDim.x) {
      const int id = table[(long long)b * max_pages + p0 + i];
      ids[i] = kMask ? id : max(id, 0);
    }
  }
  __device__ long long row(const int* ids, int, int t, int c0) const {
    const int id = ids[(t - c0) / page];
    return kMask && id < 0 ? -1 : (long long)id * page + t % page;
  }
  __device__ bool live(const int* ids, int t, int c0) const {
    return !kMask || ids[(t - c0) / page] >= 0;
  }
};
using Pages = PageTable<false>;
using MaskedPages = PageTable<true>;

// Separate K and V planes [B, KVH, S, D] (float rows only): row b * KVH *
// S + t; KV head kh's slices lie kh * S rows further, at the same offset
// of the K plane (the kernel's kv) and of the V plane v.
struct Planes {
  static constexpr int kIds = 1;
  static constexpr bool kMasks = false;
  static constexpr bool kChunk = false;
  static constexpr bool kAppend = false;
  int cap, kvh;                     // S, KVH
  const void* v;
  __host__ __device__ int queries() const { return 1; }
  __device__ int capacity() const { return cap; }
  __device__ void stage_ids(int*, int, int, int) const {}
  __device__ long long row(const int*, int b, int t, int) const {
    return (long long)b * kvh * cap + t;
  }
  __device__ bool live(const int*, int, int) const { return true; }
};

// KV head kh's K and V slices of row r: in interleaved rows [rows, 2, F]
// (F = KVH*D) the V slice lies F elements past the K slice; in separate
// planes both lie at (r + kh * S) * D, of the K plane (kv) and of the V
// plane.
template <typename T, typename Addr>
__device__ __forceinline__ const T* k_at(const Addr&, const T* kv,
                                         long long r, int kh, long long f,
                                         int d) {
  return kv + r * 2 * f + (long long)kh * d;
}
template <typename T, typename Addr>
__device__ __forceinline__ const T* v_at(const Addr& a, const T* kv,
                                         long long r, int kh, long long f,
                                         int d) {
  return k_at(a, kv, r, kh, f, d) + f;
}
template <typename T>
__device__ __forceinline__ const T* k_at(const Planes& a, const T* k,
                                         long long r, int kh, long long,
                                         int d) {
  return k + (r + (long long)kh * a.cap) * d;
}
template <typename T>
__device__ __forceinline__ const T* v_at(const Planes& a, const T*,
                                         long long r, int kh, long long,
                                         int d) {
  return static_cast<const T*>(a.v) + (r + (long long)kh * a.cap) * d;
}

// kDpl int8 values of shared memory as kDpl / 4 words, in 16-byte loads
// (kDpl 16 or 32) or 8-byte ones (kDpl 8 or 24).
template <int kDpl>
__device__ __forceinline__ void words(const int8_t* p, uint32_t* w) {
  if constexpr (kDpl % 16 == 0) {
#pragma unroll
    for (int i = 0; i < kDpl / 16; ++i) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[i];
      w[4 * i] = v.x;
      w[4 * i + 1] = v.y;
      w[4 * i + 2] = v.z;
      w[4 * i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kDpl / 8; ++i) {
      const uint2 v = reinterpret_cast<const uint2*>(p)[i];
      w[2 * i] = v.x;
      w[2 * i + 1] = v.y;
    }
  }
}

// Values per 16-byte chunk of a row: a lane holds kDpl contiguous int8
// values, or the float chunks slot, slot + 8, .. (value i of lane slot s is
// element elem(s, i) of the row).
template <typename T, int kDpl>
constexpr int kChunk =
    std::is_same<T, int8_t>::value ? kDpl : 16 / (int)sizeof(T);

template <typename T, int kDpl>
__device__ __forceinline__ int elem(int slot, int i) {
  constexpr int e = kChunk<T, kDpl>;
  return (i / e) * kLanes * e + slot * e + i % e;
}

// Lane slot's kDpl values of a row in shared memory, as f32.
template <int kDpl>
__device__ __forceinline__ void row_vals(const int8_t* row, int slot,
                                         float* x) {
  uint32_t w[kDpl / 4];
  words<kDpl>(row + slot * kDpl, w);
#pragma unroll
  for (int i = 0; i < kDpl / 4; ++i) s8x4_to_f32(w[i], x + 4 * i);
}
template <int kDpl>
__device__ __forceinline__ void row_vals(const float* row, int slot,
                                         float* x) {
#pragma unroll
  for (int c = 0; c < kDpl / 4; ++c) {
    const float4 v = reinterpret_cast<const float4*>(row)[c * kLanes + slot];
    x[4 * c] = v.x;
    x[4 * c + 1] = v.y;
    x[4 * c + 2] = v.z;
    x[4 * c + 3] = v.w;
  }
}
template <int kDpl>
__device__ __forceinline__ void row_vals(const __nv_bfloat16* row, int slot,
                                         float* x) {
#pragma unroll
  for (int c = 0; c < kDpl / 8; ++c) {
    const uint4 raw = reinterpret_cast<const uint4*>(row)[c * kLanes + slot];
    const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) x[8 * c + i] = __bfloat162float(v[i]);
  }
}

template <typename T, typename Addr, int kMode, int kDpl, int kHpw, int kHG,
          int kWarps>
__global__ void __launch_bounds__(32 * kWarps)
    kernel(const float* __restrict__ q, const T* __restrict__ kv,
           const __nv_bfloat16* __restrict__ scales,
           const int* __restrict__ lengths, float* __restrict__ out,
           int* __restrict__ dots, int heads, int kvh, Addr addr, int unit,
           float scale) {
  using S = Shape<T, kDpl, kHpw, kHG, kWarps>;
  constexpr bool kInt8 = S::kInt8;
  constexpr int d = S::d;
  constexpr int kTile = S::kTile, kStages = S::kStages;
  constexpr int kThreads = 32 * kWarps;
  constexpr int kWords = kDpl / 4;
  constexpr int kRG = kWarps / kHG;                // warps a head group
  constexpr int kSteps = (kTile + 4 * kRG - 1) / (4 * kRG);  // a warp's
  constexpr bool kDense = kTile % (4 * kRG) == 0;  // every step has rows
  constexpr int kVec = d * (int)sizeof(T) / 16;    // pieces of a row slice
  constexpr int kPieces = kTile * kVec;            // of a plane of a stage
  constexpr int kPlane = S::kPlane, kStage = S::kStage;
  constexpr int kHeads = S::kHeads;                // the block's, padded
  constexpr bool kQ8 = kMode == kScores || kMode == kPvScores;  // int8 q
  constexpr bool kPv = kMode == kPvExact || kMode == kPvScores;  // int8 p
  constexpr bool kBlock = kMode == kNative || kPv;  // a max per block
  constexpr bool kPart = kMode == kPartExact || kMode == kPartBf16;
  constexpr bool kRoundQ =                          // q rounded to bf16
      kMode == kFlat || kMode == kNative || kMode == kPartBf16;
  static_assert(kInt8 ? kMode != kFlat && kMode != kNative
                      : kMode == kExact || kMode == kFlat ||
                            (kMode == kNative &&
                             std::is_same<T, __nv_bfloat16>::value),
                "mode");
  static_assert(!kBlock || std::is_same<Addr, Rows>::value,
                "the block modes walk contiguous rows");
  static_assert(!kPart || (kInt8 && std::is_same<Addr, Rows>::value),
                "the partials modes walk contiguous int8 rows");
  static_assert(!(Addr::kChunk && kQ8),
                "a verify chunk has no int8-scores mode");
  static_assert(!Addr::kAppend || (!kInt8 && kMode == kExact),
                "the fused append writes float rows, exact mode");
  static_assert(!std::is_same<Addr, Planes>::value || !kInt8,
                "separate planes carry float rows");
  static_assert(kHG * kRG == kWarps && (!kInt8 || (kDense &&
                                                   kThreads >= 2 * kTile)),
                "tiling");
  static_assert(S::kMerge <= S::kSmem &&
                    S::kSmem + 4 * Addr::kIds <= kMaxSmem,
                "the merge state fits in the ring, the ring in the SM");
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ int ids[Addr::kIds];
  // The block modes' exchanges: each warp's block max, then (kPv) its max
  // of p * v_scale, per query row.
  __shared__ float xch[kBlock ? 2 * kWarps * kHpw : 1];

  // The block serves kHeads query rows of KV head kh's group from row h0
  // of the group on (a group of more rows takes more blocks, each reading
  // the rows again); nh of them are real. qrow(hl) is row hl's index into
  // the [.., D] rows of q and out.
  const int split = blockIdx.x, splits = gridDim.x, b = blockIdx.z;
  const int rep = heads / kvh, nq = addr.queries(), group = nq * rep;
  const int chunks = (group + kHeads - 1) / kHeads;
  const int kh = blockIdx.y / chunks;
  const int h0 = (blockIdx.y % chunks) * kHeads, nh = min(kHeads,
                                                         group - h0);
  auto qrow = [&](int hl) -> long long {
    const int r = h0 + hl;
    if constexpr (Addr::kChunk)
      return ((long long)b * nq + r / rep) * heads + kh * rep + r % rep;
    else
      return (long long)b * heads + kh * rep + r;
  };
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane / kLanes, slot = lane % kLanes;
  const int hg = warp % kHG, rg = warp / kHG;
  const long long f = (long long)kvh * d;

  // q of the warp's rows (a padded row reads the block's last q and
  // writes nothing) and a verify row's causal limit lim, and with one
  // split every page id of the sequence, loaded beside the length: none of
  // them waits for it.
  const int len = lengths[b];
  float qv[kHpw][kDpl];
  int lim[kHpw];
#pragma unroll
  for (int j = 0; j < kHpw; ++j) {
    const int hl = min(hg * kHpw + j, nh - 1);
    const float* qr = q + qrow(hl) * d;
    if constexpr (Addr::kChunk)
      lim[j] = min(max(len, 0) + (h0 + hl) / rep + 1, addr.capacity());
#pragma unroll
    for (int i = 0; i < kDpl; ++i) {
      qv[j][i] = qr[elem<T, kDpl>(slot, i)];
      if constexpr (kRoundQ) qv[j][i] = decode_attn::bf16_round(qv[j][i]);
    }
  }
  if (splits == 1) addr.stage_ids(ids, b, 0, addr.capacity());
  // The chunk: rows [c0, c1) of [0, n), whole units, one per split (a
  // verify chunk's n takes the rows of all its queries).
  const int n = min(max(len, 0) + (Addr::kChunk ? nq : 0), addr.capacity());
  const int per = (n + splits - 1) / splits;
  const int chunk = (per + unit - 1) / unit * unit;
  const int c0 = min(n, split * chunk), c1 = min(n, c0 + chunk);
  // The block modes' unit is the reference block (counted from row 0, so a
  // chunk holds whole blocks). A block of at most kTile rows takes one tile;
  // a longer one takes nseg tiles a pass, each pass over its rows again:
  // its max, (kPv) its max of p * v_scale, then the walk (K only but in the
  // last).
  const int nseg = kBlock ? (unit + kTile - 1) / kTile : 1;
  const int passes = nseg == 1 ? 1 : kPv ? 3 : 2;
  const int tiles = kBlock ? (c1 - c0 + unit - 1) / unit * passes * nseg
                           : (c1 - c0 + kTile - 1) / kTile;
  if (splits > 1) addr.stage_ids(ids, b, c0, c1);

  uint32_t qw[kHpw][kWords];
  float qscale[kHpw];
#pragma unroll
  for (int j = 0; j < kHpw; ++j) {
    qscale[j] = scale;
    if constexpr (kQ8)
      qscale[j] = verify_rows::quantize_q<kDpl>(qv[j], (int*)qw[j]) * scale;
  }
  float m[kHpw], l[kHpw], acc[kHpw][kDpl];
#pragma unroll
  for (int j = 0; j < kHpw; ++j) {
    m[j] = -INFINITY;
    l[j] = 0.0f;
#pragma unroll
    for (int i = 0; i < kDpl; ++i) acc[j][i] = 0.0f;
  }
  // The block modes' state per query row: the block's max so far over the
  // warp's rows, its max of p * v_scale, the block's step pq and its exact
  // integer sum of p8 * v8 (kPv).
  float bmax[kHpw], pmax[kHpw], pq[kHpw], pacc[kPv ? kHpw : 1][kDpl];
  if constexpr (kBlock) {
#pragma unroll
    for (int j = 0; j < kHpw; ++j) {
      bmax[j] = -INFINITY;
      pmax[j] = 0.0f;
      pq[j] = 1.0f;
#pragma unroll
      for (int i = 0; i < kDpl; ++i) pacc[kPv ? j : 0][i] = 0.0f;
    }
  }
  __syncthreads();  // the page ids

  // Tile j's rows [t0, t0 + rows) (rows may be <= 0 past the chunk's last
  // block), its pass and whether it is the block's last tile of the pass.
  struct Span {
    int t0, rows, pass;
    bool last;
  };
  auto span = [&](int j) -> Span {
    if constexpr (!kBlock) return Span{c0 + j * kTile, kTile, 0, true};
    const int i = j % (passes * nseg), seg = i % nseg;
    const int t0 = c0 + j / (passes * nseg) * unit + seg * kTile;
    return Span{t0, min(kTile, min(unit - seg * kTile, c1 - t0)), i / nseg,
                seg == nseg - 1};
  };
  // Every warp of head group hg takes the group's max of v (kHpw values a
  // warp) through x: one named barrier over the group's kRG warps. The
  // next write to x follows a block-wide barrier of the ring.
  auto exchange = [&](float* x, float* v) {
    if constexpr (kRG > 1) {
      if (lane == 0) {
#pragma unroll
        for (int j = 0; j < kHpw; ++j) x[warp * kHpw + j] = v[j];
      }
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + hg), "r"(32 * kRG)
                   : "memory");
#pragma unroll
      for (int j = 0; j < kHpw; ++j) {
        float r = -INFINITY;
#pragma unroll
        for (int x2 = 0; x2 < kRG; ++x2)
          r = fmaxf(r, x[(hg + kHG * x2) * kHpw + j]);
        v[j] = r;
      }
    }
  };

  // Tile j's K and V slices into stage j % kStages (one commit group per
  // tile and thread, empty past the chunk); for int8 returns this thread's
  // scale of the tile (row tid % kTile, plane tid / kTile; threads past 2
  // x kTile take none), stored by put_scale.
  auto stage = [&](int j) -> float {
    unsigned char* buf = ring + (j % kStages) * kStage;
    const Span sp = span(j);
    const int t0 = sp.t0;
#pragma unroll
    for (int p = 0; p < (kPieces + kThreads - 1) / kThreads; ++p) {
      const int e = tid + p * kThreads, r = e / kVec, vq = e % kVec;
      if ((kPieces % kThreads == 0 || e < kPieces) && t0 + r < c1 &&
          (!kBlock || r < sp.rows)) {
        const long long row = addr.row(ids, b, t0 + r, c0);
        unsigned char* dst = buf + r * d * (int)sizeof(T) + 16 * vq;
        bool fresh = false;  // row n - 1 of a fused append: the new row
        if constexpr (Addr::kAppend) {
          fresh = t0 + r == n - 1;
          if (fresh) {
            const int el = kh * d + vq * (16 / (int)sizeof(T));
            *reinterpret_cast<uint4*>(dst) = addr.piece(b, 0, el);
            *reinterpret_cast<uint4*>(dst + kPlane) = addr.piece(b, 1, el);
          }
        }
        if (!fresh && (!Addr::kMasks || row >= 0)) {
          const int e = vq * (16 / (int)sizeof(T));
          cp_async16(dst, k_at(addr, kv, row, kh, f, d) + e);
          if (!kBlock || sp.pass == passes - 1)
            cp_async16(dst + kPlane, v_at(addr, kv, row, kh, f, d) + e);
        }
      }
    }
    cp_async_commit();
    if constexpr (kInt8) {
      const int t = t0 + tid % kTile, plane = tid / kTile;
      return t < c1 && plane < 2 && (!kBlock || tid % kTile < sp.rows)
                 ? __bfloat162float(
                       scales[(addr.row(ids, b, t, c0) * 2 + plane) * kvh +
                              kh])
                 : 0.0f;
    }
    return 0.0f;
  };
  auto put_scale = [&](int j, float s) {
    if (kInt8 && tid < 2 * kTile)
      reinterpret_cast<float*>(ring + (j % kStages) * kStage +
                               2 * kPlane)[tid] = s;
  };

  // One tile's walk over stage buf (rows live rows from row t0; in the
  // block modes pass `pass` of its block, `last` on the block's last tile
  // of the pass): a full tile unrolls without a branch; a partial one skips
  // the steps past its rows (warp-uniform).
  auto walk = [&](auto full, const unsigned char* buf, int rows, int t0,
                  int pass, bool last) {
    constexpr bool kFull = decltype(full)::value && kDense;
    auto on = [&](int k) { return kFull || (k * kRG + rg) * 4 < rows; };
    const T* ks = reinterpret_cast<const T*>(buf);
    const T* vs = reinterpret_cast<const T*>(buf + kPlane);
    const float* ksc = reinterpret_cast<const float*>(buf + 2 * kPlane);
    const float* vsc = ksc + kTile;
    // The scores of the warp's rows: step k takes row (k * kRG + rg) * 4 +
    // grp, and the steps are independent of each other. A dead row (past
    // the tile's rows, or masked) scores -inf and, over float rows, adds
    // nothing of its stale V; a row past a verify query's limit scores -inf
    // for that query.
    float sc[kSteps][kHpw];
    bool dead[kSteps];
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      const int r = (k * kRG + rg) * 4 + grp;
      dead[k] = !((kFull || r < rows) && addr.live(ids, t0 + r, c0));
      if (!on(k)) {
#pragma unroll
        for (int j2 = 0; j2 < kHpw; ++j2) sc[k][j2] = -INFINITY;
        continue;
      }
      if constexpr (kQ8) {
        uint32_t kw[kWords];
        words<kDpl>(reinterpret_cast<const int8_t*>(ks) + r * d +
                        slot * kDpl,
                    kw);
#pragma unroll
        for (int j2 = 0; j2 < kHpw; ++j2) {
          int dot = 0;
#pragma unroll
          for (int w = 0; w < kWords; ++w)
            dot = __dp4a((int)qw[j2][w], (int)kw[w], dot);
#pragma unroll
          for (int o = 1; o < kLanes; o <<= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, o);
          const int hl = hg * kHpw + j2;
          if (dots != nullptr && slot == 0 && r < rows && hl < nh)
            dots[qrow(hl) * addr.capacity() + t0 + r] = dot;
          sc[k][j2] = (float)dot * qscale[j2];
        }
      } else {
        float kf[kDpl];
        row_vals<kDpl>(ks + r * d, slot, kf);
        if constexpr (kMode == kFlat && std::is_same<T, float>::value) {
#pragma unroll
          for (int i = 0; i < kDpl; ++i) kf[i] = decode_attn::bf16_round(
              kf[i]);
        }
#pragma unroll
        for (int j2 = 0; j2 < kHpw; ++j2) {
          float dot = 0.0f;
#pragma unroll
          for (int i = 0; i < kDpl; ++i) dot += qv[j2][i] * kf[i];
#pragma unroll
          for (int o = 1; o < kLanes; o <<= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, o);
          sc[k][j2] = dot * scale;
        }
      }
      if constexpr (kInt8) {
        const float ksr = ksc[r];
#pragma unroll
        for (int j2 = 0; j2 < kHpw; ++j2) sc[k][j2] *= ksr;
      }
#pragma unroll
      for (int j2 = 0; j2 < kHpw; ++j2)
        sc[k][j2] = dead[k] || (Addr::kChunk && t0 + r >= lim[j2])
                        ? -INFINITY
                        : sc[k][j2];
    }
    if constexpr (kBlock) {
      // Pass 0: the block's max over the warp's rows (-inf where it has
      // none); after the block's last tile of the pass the head group's
      // warps exchange it and each takes m_i = max(m, block max), one
      // rescale where it grew. So every row of the block is scored before
      // any p is rounded, and every warp rounds under the same m_i.
      if (pass == 0) {
#pragma unroll
        for (int j2 = 0; j2 < kHpw; ++j2) {
          float mx = sc[0][j2];
#pragma unroll
          for (int k = 1; k < kSteps; ++k) mx = fmaxf(mx, sc[k][j2]);
#pragma unroll
          for (int o = kLanes; o < 32; o <<= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
          bmax[j2] = fmaxf(bmax[j2], mx);
        }
        if (last) {
          exchange(xch, bmax);
#pragma unroll
          for (int j2 = 0; j2 < kHpw; ++j2) {
            if (bmax[j2] > m[j2]) {
              const float alpha = expf(m[j2] - bmax[j2]);
              l[j2] *= alpha;
#pragma unroll
              for (int i = 0; i < kDpl; ++i) acc[j2][i] *= alpha;
              m[j2] = bmax[j2];
            }
            bmax[j2] = -INFINITY;
          }
        }
      }
      // p = exp(s - m_i) in place (a dead row's is 0: the block's first
      // row is live, so m_i is finite). The walk's pass adds p to l and
      // keeps bf16(p) (kNative) or pm = p * v_scale (kPv); kPv's pq pass
      // (the walk's own where the block takes one tile) takes the block's
      // max of pm, exchanged like m_i: pq = max(that, 1e-30) / 127.
      const bool walk_pass = pass == passes - 1;
      const bool pq_pass = kPv && (passes == 1 || pass == 1);
      if (!walk_pass && !pq_pass) return;
#pragma unroll
      for (int j2 = 0; j2 < kHpw; ++j2) {
        float pm_max = 0.0f;
#pragma unroll
        for (int k = 0; k < kSteps; ++k) {
          if (!on(k)) continue;
          const float p = expf(sc[k][j2] - m[j2]);
          if (walk_pass) l[j2] += p;
          if constexpr (kPv) {
            sc[k][j2] = p * vsc[(k * kRG + rg) * 4 + grp];
            pm_max = fmaxf(pm_max, sc[k][j2]);
          } else {
            sc[k][j2] = decode_attn::bf16_round(p);
          }
        }
        if constexpr (kPv) {
          if (pq_pass) {
#pragma unroll
            for (int o = kLanes; o < 32; o <<= 1)
              pm_max =
                  fmaxf(pm_max, __shfl_xor_sync(0xffffffffu, pm_max, o));
            pmax[j2] = fmaxf(pmax[j2], pm_max);
          }
        }
      }
      if constexpr (kPv) {
        if (pq_pass && last) {
          exchange(xch + kWarps * kHpw, pmax);
#pragma unroll
          for (int j2 = 0; j2 < kHpw; ++j2) {
            pq[j2] = fmaxf(pmax[j2], 1e-30f) / 127.0f;
            pmax[j2] = 0.0f;
          }
        }
      }
      if (!walk_pass) return;
      // P V: bf16(p) v summed in f32 into acc (kNative); p8 = rint(pm / pq)
      // (IEEE division) times v8 summed exactly into the block's integer
      // sum, which enters acc once, times pq, after its last tile (kPv).
#pragma unroll
      for (int k = 0; k < kSteps; ++k) {
        if (!on(k)) continue;
        const int r = (k * kRG + rg) * 4 + grp;
        if constexpr (kPv) {
#pragma unroll
          for (int j2 = 0; j2 < kHpw; ++j2)
            sc[k][j2] = rintf(sc[k][j2] / pq[j2]);
          uint32_t vw[kWords];
          words<kDpl>(reinterpret_cast<const int8_t*>(vs) + r * d +
                          slot * kDpl,
                      vw);
#pragma unroll
          for (int w = 0; w < kWords; ++w) {
            float vf[4];
            s8x4_to_f32(vw[w], vf);
#pragma unroll
            for (int j2 = 0; j2 < kHpw; ++j2)
#pragma unroll
              for (int i = 0; i < 4; ++i)
                pacc[j2][4 * w + i] += sc[k][j2] * vf[i];
          }
        } else {
          float vf[kDpl];
          row_vals<kDpl>(vs + r * d, slot, vf);
#pragma unroll
          for (int i = 0; i < kDpl; ++i) vf[i] = dead[k] ? 0.0f : vf[i];
#pragma unroll
          for (int j2 = 0; j2 < kHpw; ++j2)
#pragma unroll
            for (int i = 0; i < kDpl; ++i) acc[j2][i] += sc[k][j2] * vf[i];
        }
      }
      if constexpr (kPv) {
        if (last) {
#pragma unroll
          for (int j2 = 0; j2 < kHpw; ++j2)
#pragma unroll
            for (int i = 0; i < kDpl; ++i) {
              acc[j2][i] += pacc[j2][i] * pq[j2];
              pacc[j2][i] = 0.0f;
            }
        }
      }
      return;
    }
    // Rows are a prefix of the tile: the warp has a row here iff its first
    // one is (warp-uniform). Then per query row the tile's max over the
    // warp's rows, one rescale where it grew, and p (times v_scale) in
    // place. A masked warp, or a verify query whose limit lies before the
    // warp's rows so far, may have seen no live row yet: its m stays -inf
    // and its p are 0 (exp(-inf - -inf) would be NaN).
    if (4 * rg < rows) {
#pragma unroll
      for (int j2 = 0; j2 < kHpw; ++j2) {
        float mx = sc[0][j2];
#pragma unroll
        for (int k = 1; k < kSteps; ++k) mx = fmaxf(mx, sc[k][j2]);
#pragma unroll
        for (int o = kLanes; o < 32; o <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        if (mx > m[j2]) {
          const float alpha = expf(m[j2] - mx);
          l[j2] *= alpha;
#pragma unroll
          for (int i = 0; i < kDpl; ++i) acc[j2][i] *= alpha;
          m[j2] = mx;
        }
#pragma unroll
        for (int k = 0; k < kSteps; ++k) {
          if (!on(k)) continue;
          float p = expf(sc[k][j2] - m[j2]);
          if constexpr (Addr::kMasks || Addr::kChunk)
            p = m[j2] == -INFINITY ? 0.0f : p;
          l[j2] += p;
          sc[k][j2] = kInt8 ? p * vsc[(k * kRG + rg) * 4 + grp] : p;
        }
      }
#pragma unroll
      for (int k = 0; k < kSteps; ++k) {
        if (!on(k)) continue;
        const int r = (k * kRG + rg) * 4 + grp;
        if constexpr (kInt8) {
          uint32_t vw[kWords];
          words<kDpl>(reinterpret_cast<const int8_t*>(vs) + r * d +
                          slot * kDpl,
                      vw);
#pragma unroll
          for (int w = 0; w < kWords; ++w) {
            float vf[4];
            s8x4_to_f32(vw[w], vf);
#pragma unroll
            for (int j2 = 0; j2 < kHpw; ++j2)
#pragma unroll
              for (int i = 0; i < 4; ++i)
                acc[j2][4 * w + i] += sc[k][j2] * vf[i];
          }
        } else {
          float vf[kDpl];
          row_vals<kDpl>(vs + r * d, slot, vf);
#pragma unroll
          for (int i = 0; i < kDpl; ++i) vf[i] = dead[k] ? 0.0f : vf[i];
#pragma unroll
          for (int j2 = 0; j2 < kHpw; ++j2)
#pragma unroll
            for (int i = 0; i < kDpl; ++i) acc[j2][i] += sc[k][j2] * vf[i];
        }
      }
    }
  };

  // The ring: tiles j + 1 .. j + kStages - 1 are in flight while tile j is
  // walked. The barrier at the top of iteration j lands tile j (its copies
  // waited for, its scales stored) and frees the stage of tile j - 1,
  // which tile j + kStages - 1 then fills; an int8 tile's scales land in
  // registers during the walk and are stored after it. (Four stages, three
  // tiles ahead, measured slower for G1 at path (H)'s shapes.)
#pragma unroll
  for (int j = 0; j + 1 < kStages; ++j) put_scale(j, stage(j));
  // The fused append, while the first tiles are in flight: KV head kh's
  // slice of both planes of the new row at pos, by one block.
  if constexpr (Addr::kAppend) {
    if (split == 0 && blockIdx.y % chunks == 0) {
      const int pos = min(max(len - 1, 0), addr.cap - 1);
      T* row = addr.cache + ((long long)b * addr.cap + pos) * 2 * f +
               (long long)kh * d;
      constexpr int kPer = 16 / (int)sizeof(T);  // elements a piece
      for (int e = tid; e < 2 * kVec; e += kThreads) {
        const int plane = e / kVec, el = (e % kVec) * kPer;
        *reinterpret_cast<uint4*>(row + plane * f + el) =
            addr.piece(b, plane, kh * d + el);
      }
    }
  }
  for (int j = 0; j < tiles; ++j) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile j's rows and scales; tile j - 1's stage free
    const float next = stage(j + kStages - 1);
    const unsigned char* buf = ring + (j % kStages) * kStage;
    if constexpr (kBlock) {
      const Span sp = span(j);
      if (sp.rows == kTile)
        walk(std::true_type(), buf, sp.rows, sp.t0, sp.pass, sp.last);
      else
        walk(std::false_type(), buf, sp.rows, sp.t0, sp.pass, sp.last);
      if (j + kStages <= tiles) put_scale(j + kStages - 1, next);
      continue;
    }
    const int t0 = c0 + j * kTile, rows = min(kTile, c1 - t0);
    if (rows == kTile)
      walk(std::true_type(), buf, rows, t0, 0, true);
    else
      walk(std::false_type(), buf, rows, t0, 0, true);
    if (j + kStages - 1 < tiles) put_scale(j + kStages - 1, next);
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring, every copy landed

  // Sum l and acc over the warp's four row groups (m is warp-uniform).
#pragma unroll
  for (int j = 0; j < kHpw; ++j) {
#pragma unroll
    for (int o = kLanes; o < 32; o <<= 1) {
      l[j] += __shfl_xor_sync(0xffffffffu, l[j], o);
#pragma unroll
      for (int i = 0; i < kDpl; ++i)
        acc[j][i] += __shfl_xor_sync(0xffffffffu, acc[j][i], o);
    }
  }
  // The warps' states, then the block's per head, in the ring.
  float* wm = reinterpret_cast<float*>(ring);  // [kWarps][kHpw]
  float* wl = wm + kWarps * kHpw;
  float* wacc = wl + kWarps * kHpw;           // [kWarps][kHpw][d]
  float* bm = wacc + kWarps * kHpw * d;       // [kHeads]
  float* bl = bm + kHeads;
  float* bacc = bl + kHeads;                  // [kHeads][d]
#pragma unroll
  for (int j = 0; j < kHpw; ++j) {
    if (lane == 0) {
      wm[warp * kHpw + j] = m[j];
      wl[warp * kHpw + j] = l[j];
    }
    if (grp == 0) {
#pragma unroll
      for (int i = 0; i < kDpl; ++i)
        wacc[(warp * kHpw + j) * d + elem<T, kDpl>(slot, i)] = acc[j][i];
    }
  }
  __syncthreads();
  // The normalized output, rounded to bf16 in kFlat; in the partials modes
  // the state of query row r against the global max mx: acc (rounded to
  // bf16 in kPartBf16) at column c, and with c 0 lanes D and D + 1, m
  // (-1e30, the reference's initial m, where no row was live) and l.
  auto result = [](float o, float sum) {
    const float y = o / fmaxf(sum, 1e-30f);
    return kMode == kFlat ? decode_attn::bf16_round(y) : y;
  };
  auto state = [&](long long r, int c, float o, float mx, float sum) {
    float* row = out + r * (d + 2);
    row[c] = kMode == kPartBf16 ? decode_attn::bf16_round(o) : o;
    if (c == 0) {
      row[d] = mx == -INFINITY ? -1e30f : mx;
      row[d + 1] = sum;
    }
  };
  // A warp (or a block) that saw no live row has m = -inf and weighs
  // exp(-inf) = 0; a head with no live row at all gets zeros.
  for (int e = tid; e < kHeads * d; e += kThreads) {
    const int hl = e / d, c = e % d, g = hl / kHpw, j = hl % kHpw;
    float mx = -INFINITY;
#pragma unroll
    for (int x = 0; x < kRG; ++x)
      mx = fmaxf(mx, wm[(g + kHG * x) * kHpw + j]);
    float sum = 0.0f, o = 0.0f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int x = 0; x < kRG; ++x) {
        const int w = (g + kHG * x) * kHpw + j;
        const float cw = expf(wm[w] - mx);
        sum += wl[w] * cw;
        o += wacc[w * d + c] * cw;
      }
    }
    if (splits == 1) {
      if constexpr (kPart) {
        if (hl < nh) state(qrow(hl), c, o, mx, sum);
      } else {
        if (hl < nh) out[qrow(hl) * d + c] = result(o, sum);
      }
    } else {
      bacc[hl * d + c] = o;
      if (c == 0) {
        bm[hl] = mx;
        bl[hl] = sum;
      }
    }
  }
  if (splits == 1) return;
  // The splits' states merge across the cluster: split s writes the s-th
  // share of the group's outputs from every split's shared memory. A split
  // with no live row has m = -inf and weighs 0; a head none of them saw
  // gets zeros.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int total = nh * d, share = (total + splits - 1) / splits;
  const int e1 = min(total, (split + 1) * share);
  for (int e = split * share + tid; e < e1; e += kThreads) {
    const int hl = e / d, c = e % d;
    float mx = -INFINITY;
    for (int s = 0; s < splits; ++s)
      mx = fmaxf(mx, cluster.map_shared_rank(bm, s)[hl]);
    float sum = 0.0f, o = 0.0f;
    if (mx != -INFINITY) {
      for (int s = 0; s < splits; ++s) {
        const float cw = expf(cluster.map_shared_rank(bm, s)[hl] - mx);
        sum += cluster.map_shared_rank(bl, s)[hl] * cw;
        o += cluster.map_shared_rank(bacc, s)[hl * d + c] * cw;
      }
    }
    if constexpr (kPart)
      state(qrow(hl), c, o, mx, sum);
    else
      out[qrow(hl) * d + c] = result(o, sum);
  }
  cluster.sync();  // no block leaves while another reads its state
}

template <typename T, typename Addr, int kMode, int kDpl, int kHpw, int kHG,
          int kWarps>
cudaError_t launch_one(const float* q, const T* kv,
                       const __nv_bfloat16* scales, const int* lengths,
                       float* out, int* dots, int batch, int heads, int kvh,
                       Addr addr, int splits, int unit, float scale,
                       cudaStream_t stream) {
  constexpr int kSmem = Shape<T, kDpl, kHpw, kHG, kWarps>::kSmem;
  auto fn = kernel<T, Addr, kMode, kDpl, kHpw, kHG, kWarps>;
  // Above 48 KB of shared memory (the ring and the static ids) a block
  // needs the opt-in. It is set at every such launch: a static guard would
  // be one object across every library that instantiates this template.
  if constexpr (kSmem + 4 * Addr::kIds > 48 * 1024) {
    const cudaError_t attr = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (attr != cudaSuccess) return attr;
  }
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = splits;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  const int chunks =
      (heads / kvh * addr.queries() + kHG * kHpw - 1) / (kHG * kHpw);
  cfg.gridDim = dim3(splits, kvh * chunks, batch);
  cfg.blockDim = dim3(32 * kWarps);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  cfg.attrs = attrs;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, fn, q, kv, scales, lengths, out, dots,
                            heads, kvh, addr, unit, scale);
}

// The caller's plan chooses the tiling: kHpw query heads a warp (q and
// the accumulators of kHpw heads hold kHpw * D / 8 values each, at most
// 32), kHG head groups of warps sharing each staged row (a block serves
// kHpw * kHG heads) and 4 or 8 warps; the ring is tile_rows x ring_stages
// for T at D. These are the tilings built; D above 128 only for kWide
// (P3i, P3, K6, K8 and K9: the per-head kernel these replaced took D up
// to 256). The wrapper checks
// shapes, contiguity, 16-byte alignment, a paged chunk's page ids and
// 1 <= splits <= kMaxSplits.
template <typename T, typename Addr, int kMode, bool kWide>
cudaError_t launch(const void* q, const void* kv, const void* scales,
                   const void* lengths, void* out, void* dots, int batch,
                   int heads, int kvh, int d, Addr addr, int splits, int unit,
                   int hpw, int hg, int warps, float scale,
                   cudaStream_t stream) {
  if (kvh < 1 || heads < kvh || heads % kvh || splits < 1 ||
      splits > kMaxSplits || unit < 1 || (warps != 4 && warps != 8))
    return cudaErrorInvalidValue;
  if (batch <= 0) return cudaGetLastError();
  const float* qf = (const float*)q;
  const T* rw = (const T*)kv;
  const __nv_bfloat16* sc = (const __nv_bfloat16*)scales;
  const int* len = (const int*)lengths;
  float* o = (float*)out;
  int* dt = (int*)dots;
#define KV_GROUP_TILING(D, HPW, HG)                                         \
  if (d == D && hpw == HPW && hg == HG)                                     \
    return warps == 4                                                       \
               ? launch_one<T, Addr, kMode, D / kLanes, HPW, HG, 4>(        \
                     qf, rw, sc, len, o, dt, batch, heads, kvh, addr,       \
                     splits, unit, scale, stream)                           \
               : launch_one<T, Addr, kMode, D / kLanes, HPW, HG, 8>(        \
                     qf, rw, sc, len, o, dt, batch, heads, kvh, addr,       \
                     splits, unit, scale, stream);
  KV_GROUP_TILING(64, 1, 1)
  KV_GROUP_TILING(64, 2, 1)
  KV_GROUP_TILING(64, 4, 1)
  KV_GROUP_TILING(64, 4, 2)
  KV_GROUP_TILING(128, 1, 1)
  KV_GROUP_TILING(128, 2, 1)
  KV_GROUP_TILING(128, 2, 2)
  KV_GROUP_TILING(128, 2, 4)
  if constexpr (kWide) {
    KV_GROUP_TILING(192, 1, 1)
    KV_GROUP_TILING(192, 1, 2)
    KV_GROUP_TILING(192, 1, 4)
    KV_GROUP_TILING(256, 1, 1)
    KV_GROUP_TILING(256, 1, 2)
    KV_GROUP_TILING(256, 1, 4)
  }
#undef KV_GROUP_TILING
  return cudaErrorInvalidValue;
}

}  // namespace kv_group
