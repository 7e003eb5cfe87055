// Single-query decode attention over a float (f32 or bf16) KV cache.
//
// Replaces: rten_tpu/kernels/attention.py::flash_decode_grouped (kernel
// _decode_grouped_kernel) and ::flash_decode_fused (kernel
// _decode_fused_kernel) in their float-cache mode with native_dots off.
// The two differ only in how the TPU grid batches sequences (G sequences
// per program to hide the MXU's op latency, or one program per (sequence,
// block)); the block-diagonal q and the one-hot head extraction exist for
// the MXU. One kernel serves both here, at any batch.
//
// Contract: for sequence b and query head h (kv head h / (H / KVH)),
// n = min(lengths[b], cap) tokens are read; score_t = (q . k_t) * scale in
// f32 (a bf16 cache is read as f32), softmax over t < n in f32,
// out = sum_t p_t v_t / max(sum_t p_t, 1e-30), f32. A sequence with
// n = 0 gets zeros.
//
// Bound on the H100: bytes. At batch 256, 12 heads of 64 and a live
// length L it reads B*L*2*768*4 bytes of an f32 cache per layer (about
// 189 MB, 56 us, at L = 120; half that for bf16); the arithmetic is
// 4 flops per element read (0.5 flop per byte in f32). Design: the kernel
// of decode_attn.cuh on contiguous rows (one block of four warps per
// (sequence, head), a per-warp online softmax in registers, one merge).
#include "decode_attn.cuh"

extern "C" int decode_attn_float(const void* q, const void* kv,
                                 const void* lengths, void* out, int batch,
                                 int heads, int kvh, int d, int cap,
                                 int bf16, float scale, void* stream) {
  using decode_attn::Contiguous;
  using decode_attn::kernel;
  dim3 grid(heads, batch);
  const Contiguous addr{cap};
  if (batch > 0) {
    if (bf16) {
      kernel<__nv_bfloat16, Contiguous, false>
          <<<grid, decode_attn::kThreads, 0, (cudaStream_t)stream>>>(
              (const float*)q, (const __nv_bfloat16*)kv, nullptr,
              (const int*)lengths, (float*)out, heads, kvh, d, addr, scale);
    } else {
      kernel<float, Contiguous, false>
          <<<grid, decode_attn::kThreads, 0, (cudaStream_t)stream>>>(
              (const float*)q, (const float*)kv, nullptr,
              (const int*)lengths, (float*)out, heads, kvh, d, addr, scale);
    }
  }
  return (int)cudaGetLastError();
}
