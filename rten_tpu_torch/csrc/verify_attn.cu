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
// step: each block reads its head's live K/V rows once for all S queries.
// At batch 8, 12 heads of 64, lives 64-320 and a bf16 cache that is about
// 8 * 192 * 2 * 768 * 2 bytes = 4.7 MB per layer (1.4 us at 3.35 TB/s).
// Design: verify_attn.cuh's kernel, one block of four warps per
// (sequence, head), instantiated for S <= 4 and S <= 8.
#include "verify_attn.cuh"

namespace {

template <typename T, int kMode>
cudaError_t launch_kind(const void* q, const void* kv, const void* scales,
                        const void* lengths, void* out, int batch, int s,
                        int heads, int kvh, int d, int cap, float scale,
                        cudaStream_t stream) {
  using verify_rows::launch;
  void* rows = const_cast<void*>(kv);
  if (s <= 4)
    return launch<T, kMode, false, 4>(q, rows, scales, nullptr, nullptr, 0,
                                      0, lengths, out, nullptr, batch, s, 0,
                                      heads, kvh, d, cap, scale, stream);
  return launch<T, kMode, false, 8>(q, rows, scales, nullptr, nullptr, 0, 0,
                                    lengths, out, nullptr, batch, s, 0,
                                    heads, kvh, d, cap, scale, stream);
}

}  // namespace

// kind: 0 f32 cache, 1 bf16 cache, 2 int8 cache with bf16 scales. The
// wrapper checks d in {64, 128} and 1 <= s <= 8.
extern "C" int verify_attn(const void* q, const void* kv, const void* scales,
                           const void* lengths, void* out, int batch, int s,
                           int heads, int kvh, int d, int cap, int kind,
                           float scale, void* stream) {
  using verify_rows::kExact;
  using verify_rows::kFloat;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (kind == 0)
    err = launch_kind<float, kFloat>(q, kv, scales, lengths, out, batch, s,
                                     heads, kvh, d, cap, scale, st);
  else if (kind == 1)
    err = launch_kind<__nv_bfloat16, kFloat>(q, kv, scales, lengths, out,
                                             batch, s, heads, kvh, d, cap,
                                             scale, st);
  else
    err = launch_kind<int8_t, kExact>(q, kv, scales, lengths, out, batch, s,
                                      heads, kvh, d, cap, scale, st);
  return (int)err;
}
