// Single-query decode attention over an int8 KV cache (G1, and G2 through
// a wrapper of its own), q and the output in f32.
//
// Replaces: rten_tpu/kernels/attention.py::flash_decode_grouped in its int8
// modes (kernel _decode_grouped_quant_kernel, exact q and int8_scores) and
// ::flash_decode_fused in its int8 mode (_decode_fused_kernel with scales).
// The two differ only in how the TPU grid batches sequences; the
// block-diagonal q rows, the one-hot scale selectors and the token-packed
// int32 rows exist for the MXU and Mosaic. One kernel serves both here.
//
// Contract: verify_attn.cuh at one query (lengths count it), modes kExact
// and kScores. In kScores the integer dots are exact (int32 __dp4a sums),
// and `dots` (int32 [B, H, cap], may be null) receives them for t <
// min(lengths, cap).
//
// Bound on the H100: bytes. At batch 16, 32 query heads over 8 KV heads of
// 128 (Mistral-7B) and lives 512-576 a layer reads about 16 * 544 * 2 * 1040
// bytes of int8 rows and scales, 18 MB, 5.4 us at 3.35 TB/s. Design: V1's
// kernel (verify_attn.cuh) at S = 1, one block per (sequence, query head):
// the four query heads of a KV head each read its rows (through L2 after
// the first), and the sequence is not split over blocks.
#include "verify_attn.cuh"

// int8_scores: 0 exact q (kExact), 1 row-quantized q (kScores). The
// wrapper checks d in {64, 128}, shapes and contiguity.
extern "C" int decode_attn_grouped_int8(const void* q, const void* kv,
                                        const void* scales,
                                        const void* lengths, void* out,
                                        void* dots, int batch, int heads,
                                        int kvh, int d, int cap,
                                        int int8_scores, float scale,
                                        void* stream) {
  using verify_rows::launch_decode;
  cudaStream_t st = (cudaStream_t)stream;
  void* rows = const_cast<void*>(kv);
  const cudaError_t err =
      int8_scores
          ? launch_decode<int8_t, verify_rows::kScores, false>(
                q, rows, scales, nullptr, nullptr, 0, 0, lengths, out, dots,
                batch, heads, kvh, d, cap, scale, st)
          : launch_decode<int8_t, verify_rows::kExact, false>(
                q, rows, scales, nullptr, nullptr, 0, 0, lengths, out,
                nullptr, batch, heads, kvh, d, cap, scale, st);
  return (int)err;
}
