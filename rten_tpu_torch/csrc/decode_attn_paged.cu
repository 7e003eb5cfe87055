// Single-query decode attention over a block-paged KV pool.
//
// Replaces: rten_tpu/kernels/attention.py::flash_decode_paged_grouped in
// its float mode (kernel _decode_paged_grouped_kernel) and its int8 mode
// (kernel _decode_paged_grouped_quant_kernel), and ::flash_decode_paged
// (kernel _decode_paged_kernel, float pools). On the TPU the page table is
// a scalar-prefetch operand and each program DMAs whole pages of G
// sequences (grouped) or one page per grid step (grid) into VMEM; the
// block-diagonal q and the one-hot scale selector exist for the MXU. Here
// each block resolves its own sequence's page ids from the table as it
// walks the tokens, so the pool is never gathered into a contiguous copy.
//
// Contract (decode_attn.cuh, Paged addressing): pool f32 or int8
// [n_pages, page, 2, KVH*D], int8 with bf16 scales [n_pages, page, 2, KVH];
// table int32 [B, max_pages] (-1 = unmapped); tokens [0, min(lengths[b],
// page * max_pages)) are read. An unmapped page inside the length is read
// from pool page 0 (mask_unmapped = 0, the grouped kernels, which clamp
// the id to >= 0) or masked (mask_unmapped = 1, the grid kernel). The
// reference's int8 numerics: q and the output f32 without bf16 rounding,
// score = ((q . k_int8) * scale) * k_scale, l sums the unscaled p, and V
// is weighted by p * v_scale.
//
// Bound on the H100: bytes. At batch 256, 12 heads of 64 and a live
// length L it reads B*L*2*768 elements per layer: about 189 MB of an f32
// pool at L = 120 (56 us), 47 MB of int8 plus 1.5 MB of scales (15 us).
// Design: K6's kernel (one block of four warps per (sequence, head), a
// per-warp online softmax in registers) on the paged addressing; the
// table entry of each token is a broadcast load that stays in L1 for the
// page's 64 tokens.
#include "decode_attn.cuh"

extern "C" int decode_attn_paged(const void* q, const void* pool,
                                 const void* scales, const void* table,
                                 const void* lengths, void* out, int batch,
                                 int heads, int kvh, int d, int page,
                                 int max_pages, int quant, int mask_unmapped,
                                 float scale, void* stream) {
  using decode_attn::kernel;
  using decode_attn::Paged;
  dim3 grid(heads, batch);
  const long long f = (long long)kvh * d;
  const Paged addr{(const int*)table, page, max_pages, mask_unmapped, 2 * f,
                   d};
  if (batch > 0) {
    if (quant) {
      const int8_t* rows = (const int8_t*)pool;
      kernel<int8_t, Paged, true>
          <<<grid, decode_attn::kThreads, 0, (cudaStream_t)stream>>>(
              (const float*)q, rows, rows + f, (const __nv_bfloat16*)scales,
              (const int*)lengths, (float*)out, heads, kvh, d, addr, scale);
    } else {
      const float* rows = (const float*)pool;
      kernel<float, Paged, false>
          <<<grid, decode_attn::kThreads, 0, (cudaStream_t)stream>>>(
              (const float*)q, rows, rows + f, nullptr, (const int*)lengths,
              (float*)out, heads, kvh, d, addr, scale);
    }
  }
  return (int)cudaGetLastError();
}
