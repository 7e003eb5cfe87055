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
// Bound on the H100: bytes. Per layer at t = 16, batch 256, 12 heads of 64
// it reads 12.6 MB of bf16 rows and writes 6.3 MB of int8 plus 0.2 MB of
// scales, about 6 us at 3.35 TB/s; there are no matrix operations. Design:
// one warp per (sequence, token, plane, head) row of head_dim values, so a
// warp reads one contiguous bf16 row, reduces its absmax with shuffles and
// writes one contiguous int8 row; no shared memory, no second pass.
//
// Numerics: kv_quant.cuh, bit for bit with kv_cache.py::_quantize_tokens.
// The file must not be compiled with -use_fast_math.
#include "kv_quant.cuh"

__global__ void tail_flush_int8_kernel(
    const __nv_bfloat16* __restrict__ tail, int8_t* __restrict__ kv,
    __nv_bfloat16* __restrict__ scales, const int* __restrict__ lengths,
    int batch, int rows, int cap, int kvh, int d, int t) {
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = (long long)batch * t * 2 * kvh;
  if (warp >= n_warps) return;
  const int h = (int)(warp % kvh);
  long long rest = warp / kvh;
  const int plane = (int)(rest % 2);
  rest /= 2;
  const int j = (int)(rest % t);
  const int b = (int)(rest / t);
  const long long f = (long long)kvh * d;

  const __nv_bfloat16* src =
      tail + (((long long)b * rows + j) * 2 + plane) * f + (long long)h * d;
  // Offsets clamp exactly as kv_cache.py:667: clip(lengths - t, 0, cap - t).
  const int off = min(max(lengths[b] - t, 0), cap - t);
  const long long row = ((long long)b * cap + off + j) * 2 + plane;
  kvquant::quantize_row(src, kv + row * f + (long long)h * d,
                        scales + row * kvh + h, d);
}

extern "C" int tail_flush_int8(const void* tail, void* kv, void* scales,
                               const void* lengths, int batch, int rows,
                               int cap, int kvh, int d, int t,
                               void* stream) {
  const long long threads = (long long)batch * t * 2 * kvh * 32;
  const int block = 256;
  const long long grid = (threads + block - 1) / block;
  if (grid > 0) {
    tail_flush_int8_kernel<<<(unsigned)grid, block, 0,
                             (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)tail, (int8_t*)kv, (__nv_bfloat16*)scales,
        (const int*)lengths, batch, rows, cap, kvh, d, t);
  }
  return (int)cudaGetLastError();
}
