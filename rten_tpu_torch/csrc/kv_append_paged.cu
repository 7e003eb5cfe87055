// Decode appends into a block-paged KV pool: each sequence's new K and V
// rows go to the pool page that its table maps at its length.
//
// Replaces: rten_tpu/kernels/cache.py::paged_append (P1, one row DMA per
// sequence into a float pool) and ::paged_append_quant (P2, a read-modify-
// write of one token-packed int32 row and one bf16-pair-packed scale row
// per sequence) together with the XLA quantization before it
// (rten_tpu/generate/kv_cache.py::_quantize_tokens). The reference resolves
// (page id, offset) in XLA before the call
// (rten_tpu/generate/paged_cache.py:177-187); here each lane resolves
// them from the table and the lengths itself, so an append is one launch.
//
// Contract: for sequence b with len = max(lengths[b], 0), the page index
// min(len / page, max_pages - 1) (finished slots keep decoding past
// capacity), page id max(table[b, index], 0) (an unmapped entry writes
// into page 0, the allocator's reserved garbage page) and offset
// len % page: pool[id, off, 0, :] = k[b, :], pool[id, off, 1, :] = v[b, :].
// k and v are f32 rows [B, KVH*D] with row strides k_stride / v_stride
// (elements). P1: an f32 pool, or a bf16 one (bf16 compute: each value
// rounded to nearest even, as K5 rounds). P2: an int8 pool [n_pages, page, 2, KVH*D]
// and bf16 scales [n_pages, page, 2, KVH], quantized per (plane, head) by
// kv_quant.cuh's quantize_row_lanes8, bit for bit with the reference's
// quantizer. Two sequences that resolve to the same row (dead slots in
// page 0) race; only garbage is written there.
//
// Bound on the H100: bytes. At batch 256, KVH*D = 768 it reads 1.6 MB of
// f32 rows and writes 1.6 MB (P1) or 0.4 MB and 12 KB of scales (P2), about
// 1 us at 3.35 TB/s; launch latency dominates. Design: kv_append.cuh's
// kernel (eight lanes a row, four rows a warp) with the PagedSlots
// addressing: each lane issues its source loads and the length's, then
// the table load at the length's page, and then stores its values (P1,
// the float row policy, as K5) or quantizes the row while the table load
// is in flight (P2, the int8 policy, as K7). The file must not be
// compiled with -use_fast_math.
#include "kv_append.cuh"

// wide (both entries): 1 for the wide instance (the wrapper checks d 64 or
// 128 and every row 16-byte aligned), 0 for the narrow one. bf16 (P1): 1
// for a bf16 pool, 0 for an f32 one.
extern "C" int kv_append_paged(const void* k, const void* v, int k_stride,
                               int v_stride, void* pool, const void* table,
                               const void* lengths, int batch, int page,
                               int max_pages, int kvh, int d, int bf16,
                               int wide, void* stream) {
  const kvappend::PagedSlots addr{(const int*)table, (const int*)lengths,
                                  page, max_pages};
  const kvappend::DecodeRows src{(const float*)k, (const float*)v, k_stride,
                                 v_stride, batch};
  if (bf16)
    return (int)kvappend::launch(
        src, kvappend::FloatRows<__nv_bfloat16>{(__nv_bfloat16*)pool}, kvh,
        d, wide, addr, (cudaStream_t)stream);
  return (int)kvappend::launch(src, kvappend::FloatRows<float>{(float*)pool},
                               kvh, d, wide, addr, (cudaStream_t)stream);
}

extern "C" int kv_append_paged_int8(const void* k, const void* v,
                                    int k_stride, int v_stride, void* pool,
                                    void* scales, const void* table,
                                    const void* lengths, int batch, int page,
                                    int max_pages, int kvh, int d, int wide,
                                    void* stream) {
  const kvappend::PagedSlots addr{(const int*)table, (const int*)lengths,
                                  page, max_pages};
  const kvappend::Int8Rows rows{(int8_t*)pool, (__nv_bfloat16*)scales};
  const kvappend::DecodeRows src{(const float*)k, (const float*)v, k_stride,
                                 v_stride, batch};
  return (int)kvappend::launch(src, rows, kvh, d, wide, addr,
                               (cudaStream_t)stream);
}
