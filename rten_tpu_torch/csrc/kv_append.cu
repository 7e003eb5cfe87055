// Decode append into a float KV cache: write each sequence's new K and V
// rows as one token row [2, KVH*D] at the sequence's own position.
//
// Replaces: rten_tpu/kernels/cache.py::cache_append (one DMA per sequence
// of the token-major row into the HBM cache, in place). The cache is
// updated in place, as the TPU kernel's aliased output is.
//
// Contract: for sequence b, pos = min(lengths[b], cap - 1), clamped to
// >= 0 (finished slots keep decoding past capacity, kv_cache.py:537);
// cache[b, pos, 0, :] = k[b, :] and cache[b, pos, 1, :] = v[b, :]. k and
// v are f32 rows [B, KVH*D] with row strides k_stride / v_stride
// (elements). A bf16 cache takes round-to-nearest-even, as
// Tensor.to(torch.bfloat16) does, so the write is bit-exact.
//
// Bound on the H100: bytes. At batch 256, KVH*D = 768 it reads 1.6 MB of
// f32 rows and writes 1.6 MB (f32 cache) or 0.8 MB (bf16), about 1 us at
// 3.35 TB/s; launch latency dominates: the time is one chain of round
// trips. Design: kv_append.cuh's kernel (eight lanes a (sequence, plane,
// KV head) row, 16-byte loads issued before the position's, 16-byte
// stores) with the float row policy and the Positions addressing, the
// body of every decode append (K7 and P2 quantize in it, P1 addresses
// through the page table). The wide instance serves head_dim 64 and 128
// on 16-byte aligned rows, the narrow one any other head_dim or alignment.
#include "kv_append.cuh"

// bf16: 1 for a bf16 cache, 0 for f32. wide: 1 for the wide instance (the
// wrapper checks d 64 or 128 and every row 16-byte aligned), 0 for the
// narrow one.
extern "C" int kv_append(const void* k, const void* v, int k_stride,
                         int v_stride, void* cache, const void* lengths,
                         int batch, int cap, int kvh, int d, int bf16,
                         int wide, void* stream) {
  const kvappend::Positions addr{(const int*)lengths, cap, 0};
  const kvappend::DecodeRows src{(const float*)k, (const float*)v, k_stride,
                                 v_stride, batch};
  if (bf16)
    return (int)kvappend::launch(
        src, kvappend::FloatRows<__nv_bfloat16>{(__nv_bfloat16*)cache}, kvh,
        d, wide, addr, (cudaStream_t)stream);
  return (int)kvappend::launch(src, kvappend::FloatRows<float>{(float*)cache},
                               kvh, d, wide, addr, (cudaStream_t)stream);
}
