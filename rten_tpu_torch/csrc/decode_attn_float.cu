// Single-query decode attention over a float (f32 or bf16) KV cache: K6,
// its flat mode K8 and the native_dots mode, all the KV-group kernel of
// decode_attn_kv_group.cuh on contiguous rows (its exact, flat and native
// modes).
//
// Replaces:
// - K6: rten_tpu/kernels/attention.py::flash_decode_grouped (kernel
//   _decode_grouped_kernel) and ::flash_decode_fused (kernel
//   _decode_fused_kernel) in their float-cache mode with native_dots off,
//   and ::flash_decode_stream (kernel _decode_stream_kernel, the same f32
//   numerics). The three differ only in how the TPU grid batches
//   sequences (G sequences per program to hide the MXU's op latency, one
//   program per (sequence, block), or one per sequence with its own DMA
//   loop); the block-diagonal q and the one-hot head extraction exist for
//   the MXU. One kernel serves all three here, at any batch.
// - K8: ::flash_decode_flat in its float mode (kernel _decode_flat_kernel)
//   with q_bf16: q enters rounded to bf16, every K element is cast to q's
//   dtype (bf16) before the score dot, P.V runs in f32 on V as stored, and
//   the normalized output is rounded to bf16 (the cast before the bf16
//   one-hot compaction dot). The whole-batch program, its continuous DMA
//   pipeline and the E-matrix head expansion exist for the TPU.
// - native_dots: ::flash_decode_grouped with native_dots (q cast to the
//   cache dtype, P cast to the cache dtype before P.V, f32 sums): on a bf16
//   cache q and P round to bf16 (the kernel's kNative mode); on an f32
//   cache every rounding is a no-op and it is K6's launch. The reference
//   rounds p = exp(s - m_i) with m_i its running max after block i of
//   block_k keys, so the kernel takes the same m_i: one max per block for
//   the whole head group, exchanged between its warps.
//
// Contract: for sequence b and query head h (kv head h / (H / KVH)),
// n = min(max(lengths[b], 0), cap) tokens are read; score_t = (q . k_t) *
// scale in f32 (a bf16 cache is read as f32), softmax over t < n in f32,
// out = sum_t p_t v_t / max(sum_t p_t, 1e-30), f32, with the roundings of
// the mode. A sequence with n = 0 gets zeros.
//
// Bound on the H100: bytes. At batch 256, 12 heads of 64 and a live
// length L it reads B*L*2*768*4 bytes of an f32 cache per layer (about
// 189 MB, 56 us, at L = 120; half that for bf16); the arithmetic is
// 4 flops per element read (0.5 flop per byte in f32). The roundings of
// K8 and native_dots add a few instructions per element and no bytes;
// native_dots' exchange adds a barrier of the head group's warps a block.
// Design: the KV-group kernel (one block per (sequence, KV head, split)
// for the whole query group, rows staged in shared memory by cp.async,
// splits merged in a cluster): K6 and K8 at the launch of rows_plan,
// native_dots at block_plan's (one split of whole reference blocks). The
// kernel K6 ran before (one block of four warps per (sequence, query
// head), rows loaded straight from device memory, no staging) read each
// row once per query head, 8 times at TinyLlama's group of 8 (0.295 ms
// there against a 0.010 bound), and launched B x H blocks at small
// batches; native_dots' kernel before it (the same four warps a query
// head) read K twice, once for the block maxima, and took their running
// max on one thread (0.1437 ms at path (C)'s shape).
#include "decode_attn_kv_group.cuh"

namespace {

// K6 (kExact) or K8 (kFlat) on a contiguous f32 or bf16 cache.
template <int kMode>
int launch_rows(const void* q, const void* kv, const void* lengths,
                void* out, int batch, int heads, int kvh, int d, int cap,
                int bf16, int splits, int unit, int hpw, int hg, int warps,
                float scale, void* stream) {
  using kv_group::launch;
  const kv_group::Rows addr{cap};
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(bf16 ? launch<__nv_bfloat16, kv_group::Rows, kMode, true>(
                          q, kv, nullptr, lengths, out, nullptr, batch,
                          heads, kvh, d, addr, splits, unit, hpw, hg, warps,
                          scale, st)
                    : launch<float, kv_group::Rows, kMode, true>(
                          q, kv, nullptr, lengths, out, nullptr, batch,
                          heads, kvh, d, addr, splits, unit, hpw, hg, warps,
                          scale, st));
}

}  // namespace

// K6 (kv_group::kExact) and K8 (kv_group::kFlat: flash_decode_flat's
// float mode with q_bf16), each at the launch of rows_plan: `splits`
// chunks a sequence (1 to 8, one cluster) of whole `unit`-row units; hpw
// query heads a warp, hg head groups, warps 4 or 8 a block
// (kv_group::launch). bf16: 0 f32 cache, 1 bf16 cache. d 64 to 256 in
// steps of 64. The wrapper checks shapes, contiguity and 16-byte alignment
// of the cache.
extern "C" int decode_attn_float(const void* q, const void* kv,
                                 const void* lengths, void* out, int batch,
                                 int heads, int kvh, int d, int cap,
                                 int bf16, int splits, int unit, int hpw,
                                 int hg, int warps, float scale,
                                 void* stream) {
  return launch_rows<kv_group::kExact>(q, kv, lengths, out, batch, heads,
                                       kvh, d, cap, bf16, splits, unit, hpw,
                                       hg, warps, scale, stream);
}

extern "C" int decode_attn_flat_float(const void* q, const void* kv,
                                      const void* lengths, void* out,
                                      int batch, int heads, int kvh, int d,
                                      int cap, int bf16, int splits,
                                      int unit, int hpw, int hg, int warps,
                                      float scale, void* stream) {
  return launch_rows<kv_group::kFlat>(q, kv, lengths, out, batch, heads,
                                      kvh, d, cap, bf16, splits, unit, hpw,
                                      hg, warps, scale, stream);
}

// native_dots over reference blocks of `unit` rows, at the launch of
// native_plan (one split; hpw, hg and warps as rows_plan's): on a bf16 cache
// the KV-group kernel in its kNative mode, on an f32 cache (where every
// rounding is a no-op) K6's launch in its exact mode, at the caller's
// rows_plan. Arguments and checks as decode_attn_float's.
extern "C" int decode_attn_native_dots(const void* q, const void* kv,
                                       const void* lengths, void* out,
                                       int batch, int heads, int kvh, int d,
                                       int cap, int bf16, int splits,
                                       int unit, int hpw, int hg, int warps,
                                       float scale, void* stream) {
  using kv_group::launch;
  const kv_group::Rows addr{cap};
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(bf16 ? launch<__nv_bfloat16, kv_group::Rows, kv_group::kNative,
                             true>(q, kv, nullptr, lengths, out, nullptr,
                                   batch, heads, kvh, d, addr, splits, unit,
                                   hpw, hg, warps, scale, st)
                    : launch<float, kv_group::Rows, kv_group::kExact, true>(
                          q, kv, nullptr, lengths, out, nullptr, batch,
                          heads, kvh, d, addr, splits, unit, hpw, hg, warps,
                          scale, st));
}
