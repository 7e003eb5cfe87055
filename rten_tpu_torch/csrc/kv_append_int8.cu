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
// 3.35 TB/s; launch latency dominates. Design: one warp per (sequence,
// plane, head), the quantization routine of the tail flush (kv_quant.cuh),
// so the two int8 writers stay bit-identical to the reference and to each
// other. The file must not be compiled with -use_fast_math.
#include "kv_quant.cuh"

__global__ void kv_append_int8_kernel(
    const float* __restrict__ k, const float* __restrict__ v, int k_stride,
    int v_stride, int8_t* __restrict__ kv, __nv_bfloat16* __restrict__ scales,
    const int* __restrict__ pos_in, int batch, int cap, int kvh, int d,
    int masked) {
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (warp >= (long long)batch * 2 * kvh) return;
  const int h = (int)(warp % kvh);
  const int plane = (int)((warp / kvh) % 2);
  const int b = (int)(warp / (2 * kvh));
  const int p = pos_in[b];
  if (masked && p < 0) return;
  const int pos = min(max(p, 0), cap - 1);
  const long long f = (long long)kvh * d;
  const float* src = plane == 0 ? k + (long long)b * k_stride
                                : v + (long long)b * v_stride;
  const long long row = ((long long)b * cap + pos) * 2 + plane;
  kvquant::quantize_row(src + (long long)h * d,
                        kv + row * f + (long long)h * d,
                        scales + row * kvh + h, d);
}

extern "C" int kv_append_int8(const void* k, const void* v, int k_stride,
                              int v_stride, void* kv, void* scales,
                              const void* pos, int batch, int cap, int kvh,
                              int d, int masked, void* stream) {
  const long long threads = (long long)batch * 2 * kvh * 32;
  const int block = 256;
  const long long grid = (threads + block - 1) / block;
  if (grid > 0) {
    kv_append_int8_kernel<<<(unsigned)grid, block, 0,
                            (cudaStream_t)stream>>>(
        (const float*)k, (const float*)v, k_stride, v_stride, (int8_t*)kv,
        (__nv_bfloat16*)scales, (const int*)pos, batch, cap, kvh, d,
        masked);
  }
  return (int)cudaGetLastError();
}
