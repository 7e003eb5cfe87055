// Every decode append's kernel: one body over two row policies and two
// addressings. K5 (kv_append.cu: a float cache, the row at the sequence's
// position), P1 (kv_append_paged.cu: a float pool, the row through the
// page table), K7 (kv_append_int8.cu: an int8 cache) and P2
// (kv_append_paged.cu: an int8 pool).
//
// Contract: write each sequence's new K and V rows, per (plane, KV head),
// into kv[row, plane, h * d ..] of a [rows, 2, KVH*D] cache or pool, at the
// row the addressing gives (below); a row of -1 writes nothing. k and v are
// f32 rows [B, KVH*D] with row strides k_stride / v_stride (elements). The
// float policy (FloatRows: f32 or bf16 caches) stores the values, a bf16
// cache rounded to nearest even as Tensor.to(torch.bfloat16) does. The
// int8 policy (Int8Rows) quantizes each row as
// kvquant::quantize_row_lanes8 does (bit for bit with
// kv_cache.py::_quantize_tokens) and stores the bytes and the bf16 scale
// into scales[row, plane, h] of its [rows, 2, KVH] scales.
//
// Design: eight lanes a (sequence, plane, KV head) row, four rows a warp.
// Each lane first issues its loads of the row's f32 values (D / 8 of them,
// in 16-byte loads, into registers), then the load that locates the row
// (the position, or the length), then the dependent load if there is one
// (the page table's entry at the length's page); nothing before the stores
// waits for the row's address. The int8 policy quantizes the row while the
// address is in flight (absmax by three shuffles within the row's lanes,
// an IEEE division a value, none for an all-zero row) and stores one 8- or
// 16-byte word a lane and the scale from the row's first lane; the float
// policy stores the lane's values as they came, in 16-byte stores (f32:
// two at D 64, four at D 128; bf16 packed by pairs: one at D 64, two at
// D 128). The wide instance serves head_dim 64 and 128 on 16-byte aligned
// rows; the narrow one any head_dim and alignment: each lane takes its
// D / 8 values (rounded up) by scalar loads and stores. A file that
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

// K5 and K7: a contiguous cache [B, cap, 2, KVH*D]: row b * cap + min(pos,
// cap - 1) (finished slots keep decoding past capacity, kv_cache.py:188);
// with masked a negative position writes nothing (the seq-shard owner rule
// of cache_append_quant), without it the position clamps to >= 0.
struct Positions {
  const int* pos;
  int cap, masked;
  __device__ int locate(int b) const { return __ldg(pos + b); }
  __device__ long long row(int b, int p) const {
    if (masked && p < 0) return -1;
    return (long long)b * cap + min(max(p, 0), cap - 1);
  }
};

// P1 and P2: a block-paged pool [n_pages, page, 2, KVH*D] through the
// table [B, max_pages]: with len = max(lengths[b], 0), page index
// min(len / page, max_pages - 1) (finished slots keep decoding past
// capacity), page id max(table[b, index], 0) (an unmapped entry writes
// into page 0, the allocator's garbage page) and offset len % page. Two
// sequences that resolve to the same row (dead slots in page 0) race; only
// garbage is written there.
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

// kBytes bytes of the words w to p: 16-byte stores where kBytes allows,
// else 8- or 4-byte ones; p is aligned to them (D, the head's offset and
// the lane's, slot * D / 8 values, are multiples of the lane's values).
template <int kBytes>
__device__ inline void store_words(void* p, const uint32_t* w) {
  static_assert(kBytes % 4 == 0, "whole words a lane");
  if constexpr (kBytes % 16 == 0) {
#pragma unroll
    for (int c = 0; c < kBytes / 16; ++c)
      reinterpret_cast<uint4*>(p)[c] =
          make_uint4(w[4 * c], w[4 * c + 1], w[4 * c + 2], w[4 * c + 3]);
  } else if constexpr (kBytes % 8 == 0) {
#pragma unroll
    for (int c = 0; c < kBytes / 8; ++c)
      reinterpret_cast<uint2*>(p)[c] = make_uint2(w[2 * c], w[2 * c + 1]);
  } else {
#pragma unroll
    for (int c = 0; c < kBytes / 4; ++c)
      reinterpret_cast<uint32_t*>(p)[c] = w[c];
  }
}

// The row policies: where and how a (row, plane, head) is written, at
// element offset at * kvh * d + h * d of the cache, at = row * 2 + plane.
// write is false for a lane past the last row and for a row of -1.
//   wide<kDpl>(x, ...): the lane's kDpl values x (the row's values
//     slot * kDpl ..) in registers. All 32 lanes of the warp call it.
//   first(src, lo, hi): the narrow instance's work before the address, on
//     the lane's values [lo, hi) of the row src.
//   narrow(src, lo, hi, part, ...): the rest, with first's result part.
//     All 32 lanes of the warp call it.

// K7 and P2: an int8 cache or pool and its bf16 scales.
struct Int8Rows {
  int8_t* kv;
  __nv_bfloat16* scales;
  template <int kDpl>
  __device__ void wide(const float* x, long long at, int h, int slot,
                       int kvh, int d, bool write) const {
    uint32_t w[kDpl / 4];
    const __nv_bfloat16 sb = kvquant::quantize_row_lanes8<kDpl>(x, w);
    if (!write) return;
    store_words<kDpl>(kv + at * kvh * d + (long long)h * d + slot * kDpl, w);
    if (slot == 0) scales[at * kvh + h] = sb;
  }
  // The lane's absmax.
  __device__ float first(const float* src, int lo, int hi) const {
    float amax = 0.0f;
    for (int i = lo; i < hi; ++i) amax = fmaxf(amax, fabsf(__ldg(src + i)));
    return amax;
  }
  __device__ void narrow(const float* src, int lo, int hi, float amax,
                         long long at, int h, int slot, int kvh, int d,
                         bool write) const {
#pragma unroll
    for (int o = 1; o < kLanes; o <<= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const __nv_bfloat16 sb = kvquant::row_scale(amax);
    if (!write) return;
    int8_t* dst = kv + at * kvh * d + (long long)h * d;
    const float sf = __bfloat162float(sb);
    for (int i = lo; i < hi; ++i)
      dst[i] = (int8_t)kvquant::quantize_value(__ldg(src + i), sf);
    if (slot == 0) scales[at * kvh + h] = sb;
  }
};

// K5 and P1: a float cache or pool, T float or __nv_bfloat16.
template <typename T>
struct FloatRows {
  T* kv;
  template <int kDpl>
  __device__ void wide(const float* x, long long at, int h, int slot,
                       int kvh, int d, bool write) const {
    if (!write) return;
    constexpr int kBytes = kDpl * (int)sizeof(T);
    uint32_t w[kBytes / 4];
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int i = 0; i < kDpl; ++i) w[i] = __float_as_uint(x[i]);
    } else {
#pragma unroll
      for (int i = 0; i < kDpl / 2; ++i) {
        const __nv_bfloat162 pair =
            __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
        w[i] = *reinterpret_cast<const uint32_t*>(&pair);
      }
    }
    store_words<kBytes>(kv + at * kvh * d + (long long)h * d + slot * kDpl,
                        w);
  }
  __device__ float first(const float*, int, int) const { return 0.0f; }
  __device__ void narrow(const float* src, int lo, int hi, float,
                         long long at, int h, int, int kvh, int d,
                         bool write) const {
    if (!write) return;
    T* dst = kv + at * kvh * d + (long long)h * d;
    for (int i = lo; i < hi; ++i) {
      if constexpr (sizeof(T) == 4)
        dst[i] = __ldg(src + i);
      else
        dst[i] = __float2bfloat16_rn(__ldg(src + i));
    }
  }
};

// kDpl > 0: the wide instance, D = kLanes * kDpl (64 or 128), rows 16-byte
// aligned; kDpl = 0: the narrow one, any D and alignment.
template <int kDpl, typename Rows, typename Addr>
__global__ void __launch_bounds__(kBlock)
    kernel(const float* __restrict__ k, const float* __restrict__ v,
           int k_stride, int v_stride, Rows rows, int batch, int kvh, int d,
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
  // the policy's arithmetic and stores.
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
    const long long row = addr.row(b, addr.locate(b));
    rows.template wide<kDpl>(x, row * 2 + plane, h, slot, kvh, d,
                             on && row >= 0);
  } else {
    const float part = rows.first(src, lo, hi);
    const long long row = addr.row(b, addr.locate(b));
    rows.narrow(src, lo, hi, part, row * 2 + plane, h, slot, kvh, d,
                on && row >= 0);
  }
}

// wide: 1 for the wide instance (the wrapper checks d 64 or 128 and every
// row 16-byte aligned), 0 for the narrow one.
template <typename Rows, typename Addr>
cudaError_t launch(const void* k, const void* v, int k_stride, int v_stride,
                   Rows rows, int batch, int kvh, int d, int wide, Addr addr,
                   cudaStream_t stream) {
  if (d < 1 || (wide && d != 64 && d != 128)) return cudaErrorInvalidValue;
  const long long threads = (long long)batch * 2 * kvh * kLanes;
  const long long grid = (threads + kBlock - 1) / kBlock;
  if (grid <= 0) return cudaGetLastError();
  const float* kf = (const float*)k;
  const float* vf = (const float*)v;
#define KV_APPEND(DPL)                                                      \
  kernel<DPL, Rows, Addr><<<(unsigned)grid, kBlock, 0, stream>>>(           \
      kf, vf, k_stride, v_stride, rows, batch, kvh, d, addr)
  if (!wide)
    KV_APPEND(0);
  else if (d == 64)
    KV_APPEND(64 / kLanes);
  else
    KV_APPEND(128 / kLanes);
#undef KV_APPEND
  return cudaGetLastError();
}

}  // namespace kvappend
