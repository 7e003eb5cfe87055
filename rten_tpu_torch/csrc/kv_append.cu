// Decode append into a float KV cache: write each sequence's new K and V
// rows as one token row [2, KVH*D] at the sequence's own position.
//
// Replaces: rten_tpu/kernels/cache.py::cache_append (one DMA per sequence
// of the token-major row into the HBM cache, in place). Here each thread
// moves one element; the cache is updated in place, as the TPU kernel's
// aliased output is.
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
// 3.35 TB/s; launch latency dominates. Design: one thread per element of
// the [B, 2, F] rows, consecutive threads on consecutive elements of one
// row, so reads and writes are coalesced.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ inline void store(float* dst, float x) { *dst = x; }
__device__ inline void store(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void kv_append_kernel(const float* __restrict__ k,
                                 const float* __restrict__ v, int k_stride,
                                 int v_stride, T* __restrict__ cache,
                                 const int* __restrict__ lengths, int batch,
                                 int cap, int f) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)batch * 2 * f) return;
  const int c = (int)(i % f);
  const int plane = (int)((i / f) % 2);
  const int b = (int)(i / (2LL * f));
  const int pos = min(max(lengths[b], 0), cap - 1);
  const float x = plane == 0 ? k[(long long)b * k_stride + c]
                             : v[(long long)b * v_stride + c];
  store(cache + (((long long)b * cap + pos) * 2 + plane) * f + c, x);
}

}  // namespace

extern "C" int kv_append(const void* k, const void* v, int k_stride,
                         int v_stride, void* cache, const void* lengths,
                         int batch, int cap, int f, int bf16,
                         void* stream) {
  const long long n = (long long)batch * 2 * f;
  const int block = 256;
  const long long grid = (n + block - 1) / block;
  if (grid > 0) {
    if (bf16) {
      kv_append_kernel<<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
          (const float*)k, (const float*)v, k_stride, v_stride,
          (__nv_bfloat16*)cache, (const int*)lengths, batch, cap, f);
    } else {
      kv_append_kernel<<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
          (const float*)k, (const float*)v, k_stride, v_stride,
          (float*)cache, (const int*)lengths, batch, cap, f);
    }
  }
  return (int)cudaGetLastError();
}
