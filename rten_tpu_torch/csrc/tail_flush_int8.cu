// Tail-window flush: quantize the first t rows of the bf16 tail window
// per (token, head) and write the int8 bytes and bf16 scales into the
// int8 KV cache at each sequence's own depth.
//
// Replaces: rten_tpu/kernels/cache.py::cache_flush_rows (whole-row writes
// with carry rows) and ::cache_flush_quant (window read-modify-write),
// plus the XLA quantization in rten_tpu/generate/kv_cache.py::flush_tail.
// On a byte-addressable card the int8 bytes are stored directly, so the
// token-packed rows, the carry rows and the shift funnel have no
// counterpart here.
//
// Contract: for sequence b and window token j < t (t <= R, the window's
// rows; partial flushes before admissions take t < R), off =
// clip(lengths[b] - t, 0, cap - t) (kv_cache.py:667; lengths count the t
// window tokens): kv[b, off + j, plane, h * D ..] and scales[b, off + j,
// plane, h] take tail[b, j, plane, h * D ..] quantized per (token, plane,
// head) as kv_cache.py::_quantize_tokens does, bit for bit.
//
// Bound on the H100: bytes. Per layer at t = 16, batch 256, 12 heads of 64
// it reads 12.6 MB of bf16 rows and writes 6.3 MB of int8 plus 0.2 MB of
// scales, about 6 us at 3.35 TB/s; there are no matrix operations. Design:
// kv_append.cuh's kernel, the body of every decode append, with the
// WindowRows source, the int8 row policy (K7's and P2's) and the Window
// addressing: eight lanes a (sequence, token, plane, head) row, four rows a
// warp; each lane issues its 16-byte loads of the window row (one at
// D 64, two at D 128), then the length, and quantizes while the length is
// in flight (no division for an all-zero head), then stores one 8- or
// 16-byte word and, from the row's first lane, the scale. The design
// before (one warp a row, 2-byte loads at a stride of 32 lanes twice,
// single-byte stores, a division for every value of an all-zero head) read
// 0.0454 ms at that shape (PERF.md). The wide instance serves head_dim 64
// and 128 on 16-byte aligned rows; the narrow one any other head_dim or
// alignment. The file must not be compiled with -use_fast_math.
#include "kv_append.cuh"

// rows: R of the window [B, R, 2, KVH*D]. wide: 1 for the wide instance
// (the wrapper checks d 64 or 128 and both tensors 16-byte aligned), 0 for
// the narrow one.
extern "C" int tail_flush_int8(const void* tail, void* kv, void* scales,
                               const void* lengths, int batch, int rows,
                               int cap, int kvh, int d, int t, int wide,
                               void* stream) {
  const kvappend::WindowRows src{(const __nv_bfloat16*)tail, rows, t, batch};
  const kvappend::Int8Rows dst{(int8_t*)kv, (__nv_bfloat16*)scales};
  const kvappend::Window addr{(const int*)lengths, cap, t};
  return (int)kvappend::launch(src, dst, kvh, d, wide, addr,
                               (cudaStream_t)stream);
}
