// The mbarrier and tensor-memory-accelerator (TMA) helpers shared by the
// kernels that stream tiles with bulk copies (matmul_int4.cu's decode tile,
// matmul_int8.cu): barrier init, arrive (with an expected byte count),
// parity wait, 1-D bulk copies and 2-D tensor-map boxes into shared
// memory, and the host's cached encoding of a 2-D tensor map.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <tuple>

namespace {

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Waits for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// bytes (a multiple of 16) from global to shared memory, completing on bar.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The tensor map's box at (c0 inner, c1 outer) into shared memory.
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap& map,
                                        int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// A 2-D tensor map of bytes or words: dims {inner, outer} elements, the
// outer stride in bytes (a multiple of 16, the base 16-byte aligned), box
// {inner, outer}, the given swizzle; out-of-bounds elements read as zeros.
// Encoded once per argument set: a map depends only on them, so one found
// under the same key is the right one.
cudaError_t tensor_map_2d(const void* base, CUtensorMapDataType type,
                          uint64_t inner, uint64_t outer, uint64_t stride,
                          uint32_t box_inner, uint32_t box_outer,
                          CUtensorMapSwizzle swizzle, CUtensorMap* map) {
  using Key = std::tuple<const void*, int, uint64_t, uint64_t, uint64_t,
                         uint32_t, uint32_t, int>;
  static std::map<Key, CUtensorMap> cache;
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  const Key key{base, (int)type, inner, outer, stride, box_inner, box_outer,
                (int)swizzle};
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *map = hit->second;
    return cudaSuccess;
  }
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode),
        cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || encode == nullptr)
      return cudaErrorNotSupported;
  }
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {stride};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  if (encode(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  cache.emplace(key, *map);
  return cudaSuccess;
}

}  // namespace
