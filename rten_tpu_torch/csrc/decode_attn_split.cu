// Single-query decode attention over separate K and V caches (K9).
//
// Replaces: rten_tpu/kernels/attention.py::flash_decode (kernel
// _decode_kernel, attention.py:172): one query per sequence over padded
// [B, KVH, S, D] K and V planes with GQA, f32 scores, online softmax and
// sums, out = acc / max(l, 1e-30), so a sequence with lengths <= 0 gets
// zeros (every block is skipped). The TPU grid's (sequence, kv head,
// block) steps carry m/l/acc in VMEM scratch and fold the kv head's query
// rows into one MXU dot; the ragged clamp elides the DMA of blocks past
// the length. Here the KV-group kernel walks only the live rows.
//
// Contract: query head h of sequence b (kv head h / (H / KVH)) reads rows
// t < min(lengths[b], S) of K[b, kv head] and V[b, kv head]; f32 or bf16
// planes are read as f32. The wrapper sends the shapes where the reference
// takes its plain path (d % 128, S < block_k, S % block_k) to the plain
// attention, as the reference does.
//
// Bound on the H100: bytes. Each live row of K and V is read once per kv
// head: B * L * 2 * KVH * D elements (at B 16, 8 KV heads of 128 and L
// 544, 17.8 M: 71 MB of f32, 0.021 ms at 3.35 TB/s; bf16 half that).
// Design: decode_attn_kv_group.cuh's kernel in its exact mode (K6's
// contract) with the Planes addressing: one block per (sequence, KV head,
// split) for the whole query group, the rows of both planes staged by
// cp.async through a ring in shared memory, splits merged in their
// cluster; one CUDA kernel a call, no scratch. The per-head kernel before
// it read each row once per query head, 4 times at a group of 4 (0.1411 ms
// at that shape, PERF.md).
#include "decode_attn_kv_group.cuh"

// At the launch of rows_plan (kernels/attention.py): `splits` chunks a
// sequence (1 to 8, one cluster) of whole `unit`-row units; hpw query
// heads a warp, hg head groups, warps 4 or 8 a block (kv_group::launch).
// bf16: 0 f32 planes, 1 bf16 planes. The wrapper checks d 128 or 256,
// shapes, contiguity and 16-byte alignment of both planes.
extern "C" int decode_attn_split_kv(const void* q, const void* k,
                                    const void* v, const void* lengths,
                                    void* out, int batch, int heads, int kvh,
                                    int d, int s, int bf16, int splits,
                                    int unit, int hpw, int hg, int warps,
                                    float scale, void* stream) {
  using kv_group::launch;
  const kv_group::Planes addr{s, kvh, v};
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(bf16 ? launch<__nv_bfloat16, kv_group::Planes,
                             kv_group::kExact, true>(
                          q, k, nullptr, lengths, out, nullptr, batch, heads,
                          kvh, d, addr, splits, unit, hpw, hg, warps, scale,
                          st)
                    : launch<float, kv_group::Planes, kv_group::kExact,
                             true>(q, k, nullptr, lengths, out, nullptr,
                                   batch, heads, kvh, d, addr, splits, unit,
                                   hpw, hg, warps, scale, st));
}
