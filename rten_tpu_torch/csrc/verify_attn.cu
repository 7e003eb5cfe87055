// Chunked-verify attention for speculative decoding (V1): S queries per
// sequence over a contiguous float (f32 or bf16) or int8 KV cache.
//
// Replaces: rten_tpu/kernels/attention.py::flash_verify_grouped (kernels
// _decode_grouped_kernel and _decode_grouped_quant_kernel with chunk_s > 0)
// and ::flash_verify_fused (_decode_fused_kernel with chunk_s > 0). The two
// differ only in how the TPU grid batches sequences (G per program, or one
// program per (sequence, block)); the block-diagonal q rows, the one-hot
// scale selectors, the token-packed int32 rows and the clamped index maps
// exist for the MXU and Mosaic's DMA rules. One kernel serves both entries
// here, at any batch.
//
// Contract: q f32 [B, S, H, D] (S <= 8) at absolute positions
// lengths[b] .. lengths[b] + S - 1 (the chunk is already appended); query i
// of sequence b and head h (kv head h / (H / KVH)) reads cache rows
// t < min(lengths[b] + i + 1, cap). A float cache is read as f32:
// score_t = (q . k_t) * scale, out = sum_t p_t v_t / max(sum_t p_t, 1e-30).
// An int8 cache with bf16 scales [B, cap, 2, KVH] per (token, plane, head)
// follows the reference's int8 rule: score_t = ((q . k_t) * scale) *
// k_scale_t, the sum l takes the unscaled p_t, and V is weighted by
// p_t * v_scale_t. q and the output stay f32 (no bf16 rounding). Output
// f32 [B, S, H, D].
//
// Bound on the H100: bytes. A verify step should cost about one decode
// step: each row of a KV head crosses from device memory once for all S
// queries of all its query heads. At batch 8, 12 heads of 64, lives 64-320
// and a bf16 cache that is about 8 * 192 * 2 * 768 * 2 bytes = 4.7 MB per
// layer (1.4 us at 3.35 TB/s).
// Design: the KV-group kernel (decode_attn_kv_group.cuh, ChunkRows): one
// block per (sequence, KV head, split) serves the S x rep query rows (i, h)
// of the KV head's group, up to 8 a block (4 at D 128: more take more
// blocks), from rows staged a tile at a time by cp.async; each query row
// keeps its own causal limit, and a sequence's splits merge in their
// cluster (verify_plan in kernels/attention.py picks splits, warps and the
// tiling). S takes any value 1-8 without a rebuild.
#include "decode_attn_kv_group.cuh"

// kind: 0 f32 cache, 1 bf16 cache, 2 int8 cache with bf16 scales. `splits`
// chunks a sequence (1 to 8, one cluster) of whole `unit`-row units; hpw
// query rows a warp, hg row groups, warps 4 or 8 a block (kv_group::launch).
// The wrapper checks d in {64, 128}, shapes, contiguity and 16-byte
// alignment.
extern "C" int verify_attn(const void* q, const void* kv, const void* scales,
                           const void* lengths, void* out, int batch, int s,
                           int heads, int kvh, int d, int cap, int kind,
                           int splits, int unit, int hpw, int hg, int warps,
                           float scale, void* stream) {
  using kv_group::ChunkRows;
  using kv_group::kExact;
  using kv_group::launch;
  if (s < 1 || kind < 0 || kind > 2) return (int)cudaErrorInvalidValue;
  const ChunkRows addr{{cap}, s};
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (kind == 0)
    err = launch<float, ChunkRows, kExact, false>(
        q, kv, nullptr, lengths, out, nullptr, batch, heads, kvh, d, addr,
        splits, unit, hpw, hg, warps, scale, st);
  else if (kind == 1)
    err = launch<__nv_bfloat16, ChunkRows, kExact, false>(
        q, kv, nullptr, lengths, out, nullptr, batch, heads, kvh, d, addr,
        splits, unit, hpw, hg, warps, scale, st);
  else
    err = launch<int8_t, ChunkRows, kExact, false>(
        q, kv, scales, lengths, out, nullptr, batch, heads, kvh, d, addr,
        splits, unit, hpw, hg, warps, scale, st);
  return (int)err;
}
