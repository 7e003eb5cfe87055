// The int8 decode append's kernel, one body for two addressings: K7
// (kv_append_int8.cu: a contiguous cache, the row at the sequence's
// position) and P2 (kv_append_paged.cu: a block-paged pool, the row
// through the page table).
//
// Contract: quantize each sequence's new K and V rows per (plane, KV head)
// as kvquant::quantize_row_lanes8 does (bit for bit with
// kv_cache.py::_quantize_tokens) and store the int8 bytes into
// kv[row, plane, h * d ..] of a [rows, 2, KVH*D] cache or pool and the
// bf16 scale into scales[row, plane, h] of its [rows, 2, KVH] scales, at
// the row the addressing gives (below); a row of -1 writes nothing. k and
// v are f32 rows [B, KVH*D] with row strides k_stride / v_stride
// (elements).
//
// Design: eight lanes a (sequence, plane, KV head) row, four rows a warp.
// Each lane first issues its loads of the row's f32 values (D / 8 of them,
// in 16-byte loads, into registers), then the load that locates the row
// (the position, or the length), then the dependent load if there is one
// (the page table's entry at the length's page), and quantizes the row
// while those are in flight (absmax by three shuffles within the row's
// lanes, an IEEE division a value, none for an all-zero row): nothing
// before the stores waits for the row's address. Then one 8- or 16-byte
// store a lane and the scale from the row's first lane. The wide instance
// serves head_dim 64 and 128 on 16-byte aligned rows; the narrow one any
// head_dim and alignment: each lane reads its D / 8 values (rounded up) by
// scalar loads, and quantizes and stores them byte by byte. A file that
// includes this must not be compiled with -use_fast_math.
#pragma once
#include "kv_quant.cuh"

namespace kvappend {

constexpr int kLanes = 8;      // lanes a row
// Threads a block: 16 rows of eight lanes. (B) has 6,144 rows (384 blocks,
// about three an SM in one wave), (H) 256 (16 blocks). Each block is one
// short chain of round trips, so the size matters little: 64 and 256
// timed within 0.0001 ms of 128 at both shapes (PERF.md).
constexpr int kBlock = 128;

// The addressings. locate(b) is the load that locates sequence b's row;
// row(b, x) turns its value x into the row index, or -1 for no write.

// K7: a contiguous cache [B, cap, 2, KVH*D]: row b * cap + min(pos, cap -
// 1) (finished slots keep decoding past capacity, kv_cache.py:188); with
// masked a negative position writes nothing (the seq-shard owner rule of
// cache_append_quant), without it the position clamps to >= 0.
struct Positions {
  const int* pos;
  int cap, masked;
  __device__ int locate(int b) const { return __ldg(pos + b); }
  __device__ long long row(int b, int p) const {
    if (masked && p < 0) return -1;
    return (long long)b * cap + min(max(p, 0), cap - 1);
  }
};

// P2 (and P1's float pool): a block-paged pool [n_pages, page, 2, KVH*D]
// through the table [B, max_pages]: with len = max(lengths[b], 0), page
// index min(len / page, max_pages - 1) (finished slots keep decoding past
// capacity), page id
// max(table[b, index], 0) (an unmapped entry writes into page 0, the
// allocator's garbage page) and offset len % page. Two sequences that
// resolve to the same row (dead slots in page 0) race; only garbage is
// written there.
struct PagedSlots {
  const int* table;
  const int* lengths;
  int page, max_pages;
  __device__ int locate(int b) const { return __ldg(lengths + b); }
  __device__ long long row(int b, int len) const {
    len = max(len, 0);
    const int idx = min(len / page, max_pages - 1);
    const int id = max(__ldg(table + (long long)b * max_pages + idx), 0);
    return (long long)id * page + len % page;
  }
};

// A lane's kDpl bytes (kDpl / 4 words) to p in one store; p is aligned to
// it (D, the head's offset and the lane's, slot * kDpl, are multiples).
template <int kDpl>
__device__ inline void store_words(int8_t* p, const uint32_t* w) {
  static_assert(kDpl == 8 || kDpl == 16, "head_dim 64 or 128");
  if constexpr (kDpl == 16)
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  else
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
}

// kDpl > 0: the wide instance, D = 8 * kDpl (64 or 128), rows 16-byte
// aligned; kDpl = 0: the narrow one, any D and alignment.
template <int kDpl, typename Addr>
__global__ void __launch_bounds__(kBlock)
    kernel(const float* __restrict__ k, const float* __restrict__ v,
           int k_stride, int v_stride, int8_t* __restrict__ kv,
           __nv_bfloat16* __restrict__ scales, int batch, int kvh, int d,
           Addr addr) {
  // Row r = (b, plane, h) of the [B, 2, KVH] rows; a lane past the last
  // row joins the shuffles and stores nothing.
  const long long r =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / kLanes;
  const int slot = threadIdx.x % kLanes;
  const bool on = r < (long long)batch * 2 * kvh;
  const int h = on ? (int)(r % kvh) : 0;
  const int plane = on ? (int)((r / kvh) % 2) : 0;
  const int b = on ? (int)(r / (2 * kvh)) : 0;
  const float* src = (plane == 0 ? k + (long long)b * k_stride
                                 : v + (long long)b * v_stride) +
                     (long long)h * d;
  // The narrow instance's values [lo, hi) of the row, D / 8 rounded up.
  const int per = (d + kLanes - 1) / kLanes;
  const int lo = min(d, slot * per), hi = on ? min(d, lo + per) : lo;
  // The source loads, then the row's address (its loads in flight), then
  // the arithmetic: nothing before the stores waits for the address.
  long long row;
  __nv_bfloat16 sb;
  uint32_t w[kDpl > 0 ? kDpl / 4 : 1];
  if constexpr (kDpl > 0) {
    float x[kDpl];
#pragma unroll
    for (int c = 0; c < kDpl / 4; ++c) {
      const float4 q = on ? __ldg(reinterpret_cast<const float4*>(
                                      src + slot * kDpl) + c)
                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      x[4 * c] = q.x;
      x[4 * c + 1] = q.y;
      x[4 * c + 2] = q.z;
      x[4 * c + 3] = q.w;
    }
    row = addr.row(b, addr.locate(b));
    sb = kvquant::quantize_row_lanes8<kDpl>(x, w);
  } else {
    float amax = 0.0f;
    for (int i = lo; i < hi; ++i) amax = fmaxf(amax, fabsf(__ldg(src + i)));
    row = addr.row(b, addr.locate(b));
#pragma unroll
    for (int o = 1; o < kLanes; o <<= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    sb = kvquant::row_scale(amax);
  }
  if (!on || row < 0) return;
  const long long at = row * 2 + plane;
  int8_t* dst = kv + at * kvh * d + (long long)h * d;
  if constexpr (kDpl > 0) {
    store_words<kDpl>(dst + slot * kDpl, w);
  } else {
    const float sf = __bfloat162float(sb);
    for (int i = lo; i < hi; ++i)
      dst[i] = (int8_t)kvquant::quantize_value(__ldg(src + i), sf);
  }
  if (slot == 0) scales[at * kvh + h] = sb;
}

// wide: 1 for the wide instance (the wrapper checks d 64 or 128 and every
// row 16-byte aligned), 0 for the narrow one.
template <typename Addr>
cudaError_t launch(const void* k, const void* v, int k_stride, int v_stride,
                   void* kv, void* scales, int batch, int kvh, int d,
                   int wide, Addr addr, cudaStream_t stream) {
  if (d < 1 || (wide && d != 64 && d != 128)) return cudaErrorInvalidValue;
  const long long threads = (long long)batch * 2 * kvh * kLanes;
  const long long grid = (threads + kBlock - 1) / kBlock;
  if (grid <= 0) return cudaGetLastError();
  const float* kf = (const float*)k;
  const float* vf = (const float*)v;
  int8_t* kv8 = (int8_t*)kv;
  __nv_bfloat16* sc = (__nv_bfloat16*)scales;
#define KV_APPEND_INT8(DPL)                                                 \
  kernel<DPL, Addr><<<(unsigned)grid, kBlock, 0, stream>>>(                 \
      kf, vf, k_stride, v_stride, kv8, sc, batch, kvh, d, addr)
  if (!wide)
    KV_APPEND_INT8(0);
  else if (d == 64)
    KV_APPEND_INT8(8);
  else
    KV_APPEND_INT8(16);
#undef KV_APPEND_INT8
  return cudaGetLastError();
}

}  // namespace kvappend
