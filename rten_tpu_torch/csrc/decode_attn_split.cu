// Single-query decode attention over separate K and V caches (K9).
//
// Replaces: rten_tpu/kernels/attention.py::flash_decode (kernel
// _decode_kernel, attention.py:172): one query per sequence over padded
// [B, KVH, S, D] K and V planes with GQA, f32 scores, online softmax and
// sums, out = acc / max(l, 1e-30), so a sequence with lengths <= 0 gets
// zeros (every block is skipped). The TPU grid's (sequence, kv head,
// block) steps carry m/l/acc in VMEM scratch and fold the kv head's query
// rows into one MXU dot; the ragged clamp elides the DMA of blocks past
// the length. Here the kernel of decode_attn.cuh walks only the live rows.
//
// Contract: query head h of sequence b (kv head h / (H / KVH)) reads rows
// t < min(lengths[b], S) of K[b, kv head] and V[b, kv head]; f32 or bf16
// planes are read as f32. The wrapper sends the shapes where the reference
// takes its plain path (d % 128, S < block_k, S % block_k) to the plain
// attention, as the reference does.
//
// Bound on the H100: bytes. Each live row of K and V is read once per kv
// head: B * L * 2 * KVH * D elements (at B 16, 8 KV heads of 128 and L
// 544, 36 MB of f32, 10.6 us at 3.35 TB/s). Design: decode_attn.cuh's
// block of four warps per (sequence, query head) with the Split
// addressing (row stride D, head stride S * D).
#include "decode_attn.cuh"

// bf16: 0 f32 planes, 1 bf16 planes. The wrapper checks d % 64 == 0,
// d <= 256, shapes and contiguity.
extern "C" int decode_attn_split_kv(const void* q, const void* k,
                                    const void* v, const void* lengths,
                                    void* out, int batch, int heads, int kvh,
                                    int d, int s, int bf16, float scale,
                                    void* stream) {
  using decode_attn::kernel;
  using decode_attn::Split;
  const Split addr{s, d, (long long)s * d, (long long)kvh * s};
  const dim3 grid(heads, batch);
  cudaStream_t st = (cudaStream_t)stream;
  if (batch > 0) {
    if (bf16) {
      kernel<__nv_bfloat16, Split>
          <<<grid, decode_attn::kThreads, 0, st>>>(
              (const float*)q, (const __nv_bfloat16*)k,
              (const __nv_bfloat16*)v, (const int*)lengths,
              (float*)out, heads, kvh, d, addr, scale);
    } else {
      kernel<float, Split><<<grid, decode_attn::kThreads, 0, st>>>(
          (const float*)q, (const float*)k, (const float*)v,
          (const int*)lengths, (float*)out, heads, kvh, d, addr, scale);
    }
  }
  return (int)cudaGetLastError();
}
