// Single-query decode attention over an int8 KV cache (G1 with or without
// pv_int8, G2 through a wrapper of its own, and the partials mode of
// flash_decode_flat), q and the output in f32: the KV-group kernel of
// decode_attn_kv_group.cuh on contiguous rows.
//
// Replaces: rten_tpu/kernels/attention.py::flash_decode_grouped in its int8
// modes (kernel _decode_grouped_quant_kernel: exact q and int8_scores, each
// with or without pv_int8) and ::flash_decode_fused in its int8 mode
// (_decode_fused_kernel with scales). The two differ only in how the TPU
// grid batches sequences; the block-diagonal q rows, the one-hot scale
// selectors and the token-packed int32 rows exist for the MXU and Mosaic.
// The partials entry replaces flash_decode_flat(partials=True) (the mode
// at attention.py:1745-1751, its emit at :1628-1656, the f32 output at
// :1897-1913): the unnormalized state of a capacity shard for the
// seq-shard merge, q exact or rounded to bf16 (q_bf16, the acc rounded to
// bf16 too); the one-hot E-matrix head expansion exists for the MXU.
//
// Contract: decode_attn_kv_group.cuh over contiguous rows (lengths count
// the query), modes kExact and kScores, and with pv_int8 kPvExact and
// kPvScores. In the int8-scores modes the integer dots are exact (int32
// __dp4a sums), and without pv_int8 `dots` (int32 [B, H, cap], may be null)
// receives them for t < min(lengths, cap). pv_int8 (the reference's P.V as
// an int8 x int8 dot, attention.py:825-837): per reference block of
// block_k rows (row 0 of the cache first) and query head, p_t = exp(s_t -
// m) with m the running max after the block, l += sum p_t, pm_t = p_t *
// v_scale_t, pq = max(max_t pm_t, 1e-30) / 127, p8_t = rint(pm_t / pq)
// (IEEE division, ties to even), and acc = acc * alpha + f32(sum_t p8_t
// v8_t) * pq.
//
// Bound on the H100: bytes. At batch 16, 32 query heads over 8 KV heads of
// 128 (Mistral-7B) and lives 512-576 a layer reads about 16 * 544 * 2 * 1040
// bytes of int8 rows and scales, 18 MB, 5.4 us at 3.35 TB/s. The exact-q
// arithmetic, about 8 f32 FMAs a group of 4 heads and one exact convert
// (a byte permute and a subtract) per int8 element, is about 4-5 us of the
// card's instruction rate at that shape: as long as the bytes, so the
// design keeps both low. pv_int8 adds a division and a rint per row and
// query head, and two exchanges between warps per 64-row block.
// Design: one block per (sequence, KV head, split): the group's four
// query heads share each row, which crosses from device memory once
// through a 2-stage ring of 64-row tiles (16-byte cp.async); at d 128 a
// warp holds two heads' q and accumulators, and two head groups of warps
// read each staged row from shared memory. B x KVH = 128 blocks would
// leave the walk of 512-576 rows to one block an SM, so rows_plan splits
// each sequence into 2 chunks of whole 16-row units (one cluster, merged
// through distributed shared memory in the same launch) and gives each of
// the 256 blocks 8 warps. The design before (one block per query head,
// every head reading the KV head's rows, no split) took 0.043 ms here;
// int8 scores share the walk with __dp4a dots. G2
// (decode_attn_fused_int8: exact q at the batches and capacities the
// reference sends to its fused kernel) is the same launch at rows_plan's
// choice: at (H-fused), batch 3, 24 (sequence, KV head) pairs in 8 splits.
// pv_int8 runs the same walk in the kernel's block modes at block_plan's
// launch (chunks of whole reference blocks): a 64-row block is one tile,
// its maxima exchanged between the head group's warps; each warp keeps
// the block's integer sum of p8 * v8 beside its accumulators (D / 8 more
// registers a query head). Its kernel before (four warps per (sequence,
// query head), each owning every fourth block, rows read straight from
// device memory by every query head of the group) took 0.0931 ms exact
// and 0.0622 with int8 scores at path (H)'s shape.
// The partials modes (kPartExact, kPartBf16) are G1's exact walk with
// another emit: after the splits' cluster merge each (sequence, head)
// writes (acc, m, l) against the merged global m, so a merge across
// capacity shards outside the kernel weighs each shard by exp(m - M). At
// B 256, 12 heads of 64 (group 1) rows_plan gives 3,072 unsplit blocks of 4
// warps; at TinyLlama's 32 query heads over 4 (B 16, capacity 2048) 64
// (sequence, KV head) pairs of 8 heads take 4 splits of 8 warps. The
// design before ran the per-query-head kernel of K1 and K1'
// (decode_attn_int8_tail.cu): every query head of a group read the KV
// head's rows again with plain loads, and a split sequence took a second
// launch to merge through f32 scratch.
#include "decode_attn_kv_group.cuh"

// G1 and G2 at the launch of rows_plan, or G1's pv_int8 at block_plan's:
// mode bit 0 row-quantized q (int8 scores; `dots` int32 [B, H, cap] or null
// without pv_int8), bit 1 pv_int8 over reference blocks of `unit` rows;
// mode 4 and 5 the partials emit at rows_plan's launch, q exact (4) or
// rounded to bf16 (5), out f32 [B, H, D + 2];
// `splits` chunks a sequence (1 to 8, one cluster) of whole `unit`-row
// units; hpw query heads a warp, hg head groups, warps 4 or 8 a block
// (kv_group::launch). d 64 or 128, as the design before took. The wrapper
// checks shapes, contiguity and 16-byte alignment.
extern "C" int decode_attn_grouped_int8_rows(
    const void* q, const void* kv, const void* scales, const void* lengths,
    void* out, void* dots, int batch, int heads, int kvh, int d, int cap,
    int mode, int splits, int unit, int hpw, int hg, int warps, float scale,
    void* stream) {
  using kv_group::launch;
  using kv_group::Rows;
  const Rows addr{cap};
  cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case 0:
      return (int)launch<int8_t, Rows, kv_group::kExact, false>(
          q, kv, scales, lengths, out, nullptr, batch, heads, kvh, d, addr,
          splits, unit, hpw, hg, warps, scale, st);
    case 1:
      return (int)launch<int8_t, Rows, kv_group::kScores, false>(
          q, kv, scales, lengths, out, dots, batch, heads, kvh, d, addr,
          splits, unit, hpw, hg, warps, scale, st);
    case 2:
      return (int)launch<int8_t, Rows, kv_group::kPvExact, false>(
          q, kv, scales, lengths, out, nullptr, batch, heads, kvh, d, addr,
          splits, unit, hpw, hg, warps, scale, st);
    case 3:
      return (int)launch<int8_t, Rows, kv_group::kPvScores, false>(
          q, kv, scales, lengths, out, nullptr, batch, heads, kvh, d, addr,
          splits, unit, hpw, hg, warps, scale, st);
    case 4:
      return (int)launch<int8_t, Rows, kv_group::kPartExact, false>(
          q, kv, scales, lengths, out, nullptr, batch, heads, kvh, d, addr,
          splits, unit, hpw, hg, warps, scale, st);
    case 5:
      return (int)launch<int8_t, Rows, kv_group::kPartBf16, false>(
          q, kv, scales, lengths, out, nullptr, batch, heads, kvh, d, addr,
          splits, unit, hpw, hg, warps, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}
