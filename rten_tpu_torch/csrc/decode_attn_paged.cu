// Single-query decode attention over a block-paged KV pool.
//
// Replaces: rten_tpu/kernels/attention.py::flash_decode_paged_grouped in
// its float mode (kernel _decode_paged_grouped_kernel, P3) and its int8
// mode (kernel _decode_paged_grouped_quant_kernel, P3i), and
// ::flash_decode_paged (kernel _decode_paged_kernel, float pools, P3's grid
// mode). On the TPU the page table is a scalar-prefetch operand and each
// program DMAs whole pages of G sequences (grouped) or one page per grid
// step (grid) into VMEM; the block-diagonal q and the one-hot scale
// selector exist for the MXU. Here each block reads its own sequence's
// page ids from the table, so the pool is never gathered into a
// contiguous copy.
//
// Contract: pool f32, bf16 or int8 [n_pages, page, 2, KVH*D], int8 with bf16
// scales [n_pages, page, 2, KVH]; table int32 [B, max_pages] (-1 =
// unmapped); tokens [0, min(lengths[b], page * max_pages)) are read. An
// unmapped page inside the length is read from pool page 0 (mask_unmapped
// = 0, the grouped kernels, which clamp the id to >= 0) or masked
// (mask_unmapped = 1, the grid kernel; float pools only). Float pools: q
// and the output f32, nothing rounded (a bf16 pool's values widened
// exactly, as the reference's kblk.astype(q.dtype) reads them under bf16
// compute), score = (q . k) * scale,
// out = sum p v / max(sum p, 1e-30). The reference's int8 numerics: q and
// the output f32 without bf16 rounding, score = ((q . k_int8) * scale) *
// k_scale, l sums the unscaled p, and V is weighted by p * v_scale. A
// sequence with no live (or, masked, no mapped live) token gets zeros.
//
// Bound on the H100: bytes. At batch 256, 12 heads of 64 and a live
// length L it reads B*L*2*768 elements per layer: about 189 MB of an f32
// pool at L = 120 (56 us), 47 MB of int8 plus 1.5 MB of scales (15 us).
// The int8 arithmetic is about 4 flops and one convert per byte, 7 us of
// the card's f32 instruction rate at that shape; over f32 it is 1 flop a
// byte: bytes bound both.
// Design: decode_attn_kv_group.cuh, one block per (sequence, KV head) with
// every query head of the group, so each row is read once for the group;
// the block reads its page ids once into shared memory and moves its rows
// a tile at a time (int8: a page of 64 rows, 8 KB of K and V at D 64 plus
// 256 B of scales; f32: tile_rows of the header, a page in several tiles)
// through a cp.async ring, computing from shared memory on the
// eight-lanes-a-row layout. The per-head layout before it (one block per
// query head) gave a row to a lane as 8- or 2-byte loads, one
// dependent table read per token, and 4 tokens a warp in flight: P3i
// 0.189 ms against its 0.015 bound, P3 0.142 against 0.058. At a batch of
// 256, B x KVH = 3072 blocks fill the card, so one launch with no split
// (paged_plan); a batch too small for that (the grid mode's batch of 3)
// splits each sequence into chunks of whole pages, merged inside a
// thread-block cluster, still one launch.
#include "decode_attn_kv_group.cuh"

template <typename T, typename Addr>
static int paged_float(const void* q, const void* pool, const void* lengths,
                       void* out, int batch, int heads, int kvh, int d,
                       const Addr& addr, int splits, int page, int hpw,
                       int hg, int warps, float scale, cudaStream_t st) {
  return (int)kv_group::launch<T, Addr, kv_group::kExact, true>(
      q, pool, nullptr, lengths, out, nullptr, batch, heads, kvh, d, addr,
      splits, page, hpw, hg, warps, scale, st);
}

// P3 and its grid mode (mask_unmapped 1) on an f32 pool (bf16 0) or a bf16
// one (bf16 1), and P3i on an int8 one (with scales), at the launch of paged_plan: splits, the chunks
// a sequence (and KV head) splits into, each a whole number of pages (1 to
// 8, one cluster); hpw query heads a warp, hg head groups, warps 4 or 8 a
// block (kv_group::launch). d 64 to 256 in steps of 64, as the per-head
// kernel before it took. The wrapper checks that a chunk holds at
// most 256 pages, shapes, contiguity and 16-byte alignment.
extern "C" int decode_attn_paged(const void* q, const void* pool,
                                 const void* table, const void* lengths,
                                 void* out, int batch, int heads, int kvh,
                                 int d, int page, int max_pages,
                                 int mask_unmapped, int bf16, int splits,
                                 int hpw, int hg, int warps, float scale,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (mask_unmapped) {
    const kv_group::MaskedPages addr{(const int*)table, page, max_pages};
    return bf16 ? paged_float<__nv_bfloat16>(q, pool, lengths, out, batch,
                                             heads, kvh, d, addr, splits,
                                             page, hpw, hg, warps, scale, st)
                : paged_float<float>(q, pool, lengths, out, batch, heads,
                                     kvh, d, addr, splits, page, hpw, hg,
                                     warps, scale, st);
  }
  const kv_group::Pages addr{(const int*)table, page, max_pages};
  return bf16 ? paged_float<__nv_bfloat16>(q, pool, lengths, out, batch,
                                           heads, kvh, d, addr, splits, page,
                                           hpw, hg, warps, scale, st)
              : paged_float<float>(q, pool, lengths, out, batch, heads, kvh,
                                   d, addr, splits, page, hpw, hg, warps,
                                   scale, st);
}

extern "C" int decode_attn_paged_int8(const void* q, const void* pool,
                                      const void* scales, const void* table,
                                      const void* lengths, void* out,
                                      int batch, int heads, int kvh, int d,
                                      int page, int max_pages, int splits,
                                      int hpw, int hg, int warps, float scale,
                                      void* stream) {
  const kv_group::Pages addr{(const int*)table, page, max_pages};
  return (int)kv_group::launch<int8_t, kv_group::Pages, kv_group::kExact,
                               true>(
      q, pool, scales, lengths, out, nullptr, batch, heads, kvh, d, addr,
      splits, page, hpw, hg, warps, scale, (cudaStream_t)stream);
}
