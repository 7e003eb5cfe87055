// Decode attention over a float (f32 or bf16) KV cache with the decode
// append fused in (A1): the new K/V row is written into the cache and
// attended to in one launch.
//
// Replaces: rten_tpu/kernels/attention.py::flash_decode_grouped_append
// (kernel _decode_grouped_append_kernel), which DMAs each sequence's new
// row into the aliased cache at lengths - 1 and then streams the grouped
// float decode. It computes what K5 (kv_append.cu) followed by K6
// (decode_attn_float.cu) compute, without K5's launch.
//
// Contract: verify_attn.cuh's. The cache write is K5's, bit for bit (bf16
// rounds to nearest even); lengths count the new token, which sits at
// clip(lengths - 1, 0, cap - 1).
//
// Bound on the H100: bytes. At batch 16, 32 query heads over 8 KV heads of
// 128 and lives 512-576 a layer reads about 16 * 544 * 2 * 1024 * 2 bytes
// of a bf16 cache, 36 MB, 10.6 us at 3.35 TB/s (twice that for f32). Write
// ordering: the first query head of each KV head writes that head's slice
// of the row, and every block takes the row from new_k/new_v instead of the
// cache, so no block reads it before it is written (the TPU kernel waits
// on the write's DMA before fetching the block that holds it).
#include "verify_attn.cuh"

// bf16: 0 f32 cache, 1 bf16 cache. k_stride / v_stride: the row strides
// (elements) of the f32 new rows [B, KVH*D]. The wrapper checks d in
// {64, 128}, shapes and contiguity.
extern "C" int decode_attn_append(const void* q, void* kv, const void* k,
                                  const void* v, int k_stride, int v_stride,
                                  const void* lengths, void* out, int batch,
                                  int heads, int kvh, int d, int cap,
                                  int bf16, float scale, void* stream) {
  using verify_rows::launch_append;
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err =
      bf16 ? launch_append<__nv_bfloat16>(q, kv, k, v, k_stride, v_stride,
                                          lengths, out, batch, heads, kvh, d,
                                          cap, scale, st)
           : launch_append<float>(q, kv, k, v, k_stride, v_stride, lengths,
                                  out, batch, heads, kvh, d, cap, scale, st);
  return (int)err;
}
