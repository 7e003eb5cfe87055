// Decode append into the int8 KV cache: quantize each sequence's new K and
// V rows per (plane, head) and write the int8 bytes and bf16 scales at the
// sequence's own position.
//
// Replaces: rten_tpu/kernels/cache.py::cache_append_quant (a read-modify-
// write of one token-packed int32 row and one bf16-pair-packed scale row
// per sequence) together with the XLA quantization before it,
// rten_tpu/generate/kv_cache.py::_quantize_tokens. The card stores single
// bytes, so the token packing and its byte merge have no counterpart: each
// head's bytes and scale are plain stores.
//
// Contract: for sequence b, pos = min(pos_in[b], cap - 1) (finished slots
// keep decoding past capacity, kv_cache.py:188); with masked != 0 a
// sequence whose pos_in[b] < 0 writes nothing (the seq-shard owner rule of
// cache_append_quant), without it pos clamps to >= 0. k and v are f32 rows
// [B, KVH*D] with row strides k_stride / v_stride (elements).
//
// Bound on the H100: bytes. At batch 256, 12 heads of 64 it reads 1.6 MB of
// f32 rows and writes 0.4 MB of int8 and 12 KB of scales, under 1 us at
// 3.35 TB/s; at batch 16, 8 heads of 128 (Mistral-7B) it moves 0.2 MB.
// Launch and latency dominate: the time is one chain of round trips.
// Design: kv_append.cuh's kernel (eight lanes a row, four rows a warp,
// the source loads before the position's) with the int8 row policy and the
// Positions addressing; P2 (kv_append_paged.cu) is the same kernel through
// the page table, K5 and P1 run its float policy. The wide instance
// serves head_dim 64 and 128, every preset's but the small test one's;
// the narrow one every other head_dim or alignment. The file must not be
// compiled with -use_fast_math.
#include "kv_append.cuh"

// wide: 1 for the wide instance (the wrapper checks d 64 or 128 and every
// row 16-byte aligned), 0 for the narrow one.
extern "C" int kv_append_int8(const void* k, const void* v, int k_stride,
                              int v_stride, void* kv, void* scales,
                              const void* pos, int batch, int cap, int kvh,
                              int d, int masked, int wide, void* stream) {
  const kvappend::Positions addr{(const int*)pos, cap, masked};
  const kvappend::Int8Rows rows{(int8_t*)kv, (__nv_bfloat16*)scales};
  const kvappend::DecodeRows src{(const float*)k, (const float*)v, k_stride,
                                 v_stride, batch};
  return (int)kvappend::launch(src, rows, kvh, d, wide, addr,
                               (cudaStream_t)stream);
}
