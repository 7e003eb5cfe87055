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
// Contract: q f32 [B, H, D], out f32 [B, H, D]; query head h of sequence b
// (KV head h / (H / KVH)) reads rows t < n = min(max(lengths[b], 0), cap)
// (lengths count the new token) as f32: s_t = (q . k_t) * scale, out =
// sum_t p_t v_t / max(sum_t p_t, 1e-30), p_t = exp(s_t - max s). The new
// f32 rows [B, KVH*D] are cast to the cache dtype (bf16 rounds to nearest
// even: K5's write, bit for bit) and written at pos = clip(lengths - 1, 0,
// cap - 1), for every length; a sequence with lengths 0 still writes row 0
// and gets zeros.
//
// Bound on the H100: bytes. At batch 16, 32 query heads over 8 KV heads of
// 128 and lives 512-576 a layer reads about 16 * 544 * 2 * 1024 * 2 bytes
// of a bf16 cache, 36 MB, 10.6 us at 3.35 TB/s (twice that for f32).
// Design: the KV-group kernel (decode_attn_kv_group.cuh, AppendRows): one
// block per (sequence, KV head, split) for the KV head's whole query
// group, so each row crosses from device memory once for the group, tiles
// staged by cp.async, splits merged in their cluster. Row n - 1, which is
// pos whenever a row is read, is staged from the new row itself and never
// read from the cache, so the write by split 0 of each (sequence, KV head)
// races with no read (the TPU kernel waits on the write's DMA before
// fetching the block that holds it).
#include "decode_attn_kv_group.cuh"

// bf16: 0 f32 cache, 1 bf16 cache. k_stride / v_stride: the row strides
// (elements) of the f32 new rows [B, KVH*D]. `splits` chunks a sequence
// (1 to 8, one cluster) of whole `unit`-row units; hpw query heads a warp,
// hg head groups, warps 4 or 8 a block (kv_group::launch, at rows_plan).
// The wrapper checks d in {64, 128}, shapes, contiguity and 16-byte
// alignment of the cache and of the new rows (pointers and strides).
extern "C" int decode_attn_append(const void* q, void* kv, const void* k,
                                  const void* v, int k_stride, int v_stride,
                                  const void* lengths, void* out, int batch,
                                  int heads, int kvh, int d, int cap,
                                  int bf16, int splits, int unit, int hpw,
                                  int hg, int warps, float scale,
                                  void* stream) {
  using kv_group::AppendRows;
  using kv_group::kExact;
  using kv_group::launch;
  if (d != 64 && d != 128) return (int)cudaErrorInvalidValue;
  const float* nk = (const float*)k;
  const float* nv = (const float*)v;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (bf16) {
    const AppendRows<__nv_bfloat16> addr{
        {cap}, nk, nv, k_stride, v_stride, (__nv_bfloat16*)kv};
    err = launch<__nv_bfloat16, AppendRows<__nv_bfloat16>, kExact, false>(
        q, kv, nullptr, lengths, out, nullptr, batch, heads, kvh, d, addr,
        splits, unit, hpw, hg, warps, scale, st);
  } else {
    const AppendRows<float> addr{{cap}, nk, nv, k_stride, v_stride,
                                 (float*)kv};
    err = launch<float, AppendRows<float>, kExact, false>(
        q, kv, nullptr, lengths, out, nullptr, batch, heads, kvh, d, addr,
        splits, unit, hpw, hg, warps, scale, st);
  }
  return (int)err;
}
