// Every int8 or float KV-cache writer's kernel: one body over two sources,
// two row policies and three addressings. K5 (kv_append.cu: a float cache,
// the row at the sequence's position), P1 (kv_append_paged.cu: a float
// pool, the row through the page table), K7 (kv_append_int8.cu: an int8
// cache), P2 (kv_append_paged.cu: an int8 pool) and K3 (tail_flush_int8.cu:
// the tail window's first t rows into an int8 cache).
//
// Contract: write each source row (sequence b, token j, plane, KV head h)
// into kv[row + j, plane, h * d ..] of a [rows, 2, KVH*D] cache or pool, at
// the row the addressing gives for sequence b (below); a row of -1 writes
// nothing. The sources: DecodeRows, each sequence's new K and V rows, f32
// [B, KVH*D] with row strides k_stride / v_stride (elements), token 0;
// WindowRows, tokens j < t of each sequence's bf16 tail window
// [B, R, 2, KVH*D]. The float policy (FloatRows: f32 or bf16 caches)
// stores the values, a bf16 cache rounded to nearest even as
// Tensor.to(torch.bfloat16) does. The int8 policy (Int8Rows) quantizes
// each row as kvquant::quantize_row_lanes8 does (bit for bit with
// kv_cache.py::_quantize_tokens) and stores the bytes and the bf16 scale
// into scales[row + j, plane, h] of its [rows, 2, KVH] scales.
//
// Design: eight lanes a source row, four rows a warp. Each lane first
// issues its loads of the row's values (D / 8 of them, in 16-byte loads:
// f32 four a load, bf16 eight, converted exactly to f32 in registers),
// then the load that locates the row (the position, or the length), then
// the dependent load if there is one (the page table's entry at the
// length's page); nothing before the stores waits for the row's address.
// The int8 policy quantizes the row while the address is in flight (absmax
// by three shuffles within the row's lanes, an IEEE division a value, none
// for an all-zero row) and stores one 8- or 16-byte word a lane and the
// scale from the row's first lane; the float policy stores the lane's
// values as they came, in 16-byte stores (f32: two at D 64, four at D 128;
// bf16 packed by pairs: one at D 64, two at D 128). The wide instance
// serves head_dim 64 and 128 on 16-byte aligned rows; the narrow one any
// head_dim and alignment: each lane takes its D / 8 values (rounded up) by
// scalar loads and stores. A file that includes this must not be compiled
// with -use_fast_math.
#pragma once
#include "kv_quant.cuh"

namespace kvappend {

constexpr int kLanes = 8;      // lanes a row
// Threads a block: 16 rows of eight lanes. (B) has 6,144 rows (384 blocks,
// about three an SM in one wave), (H) 256 (16 blocks). Each block is one
// short chain of round trips, so the size matters little: 64 and 256
// timed within 0.0001 ms of 128 at both shapes (PERF.md).
constexpr int kBlock = 128;

// The sources. A source has count(kvh) rows; row r is (sequence b, token
// j, plane, KV head h) (id), its D values start at ptr(id, kvh, d), and
// load<kDpl>(p, on, x) reads the lane's kDpl values at p (16-byte aligned)
// into x as f32, in 16-byte loads.
struct RowId {
  int b, j, plane, h;
};

// K5, P1, K7 and P2: each sequence's new f32 K and V rows, [B, 2, KVH]
// rows of token 0. A lane past the last row loads nothing: with the loads
// unguarded, the float policy (whose stores are the first use of x) read
// 5-6% slower for K5 and P1 at paths (A), (C) and (E) on an H100
// (PERF.md), as if the loads waited for the row's address.
struct DecodeRows {
  using T = float;
  const float* k;
  const float* v;
  int k_stride, v_stride, batch;
  __host__ __device__ long long count(int kvh) const {
    return (long long)batch * 2 * kvh;
  }
  __device__ RowId id(long long r, int kvh) const {
    const long long q = r / kvh;
    return {(int)(q >> 1), 0, (int)(q & 1), (int)(r - q * kvh)};
  }
  __device__ const float* ptr(RowId x, int, int d) const {
    return (x.plane == 0 ? k + (long long)x.b * k_stride
                         : v + (long long)x.b * v_stride) +
           (long long)x.h * d;
  }
  template <int kDpl>
  __device__ void load(const float* p, bool on, float* x) const {
#pragma unroll
    for (int c = 0; c < kDpl / 4; ++c) {
      const float4 q = on ? __ldg(reinterpret_cast<const float4*>(p) + c)
                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      x[4 * c] = q.x;
      x[4 * c + 1] = q.y;
      x[4 * c + 2] = q.z;
      x[4 * c + 3] = q.w;
    }
  }
};

// K3: tokens j < t of each sequence's bf16 tail window [B, R, 2, KVH*D]
// (R = rows), [B, t, 2, KVH] rows in the window's order. Every lane loads
// (one past the last row reads row 0): guarded as DecodeRows' loads, K3
// read 6% slower at the int8 + tail shape (PERF.md).
struct WindowRows {
  using T = __nv_bfloat16;
  const __nv_bfloat16* tail;
  int rows, t, batch;
  __host__ __device__ long long count(int kvh) const {
    return (long long)batch * t * 2 * kvh;
  }
  __device__ RowId id(long long r, int kvh) const {
    const long long q = r / kvh, bj = q >> 1, b = bj / t;
    return {(int)b, (int)(bj - b * t), (int)(q & 1), (int)(r - q * kvh)};
  }
  __device__ const __nv_bfloat16* ptr(RowId x, int kvh, int d) const {
    return tail + (((long long)x.b * rows + x.j) * 2 + x.plane) * kvh * d +
           (long long)x.h * d;
  }
  template <int kDpl>
  __device__ void load(const __nv_bfloat16* p, bool, float* x) const {
#pragma unroll
    for (int c = 0; c < kDpl / 8; ++c) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(p) + c);
      const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(v[i]);
        x[8 * c + 2 * i] = f.x;
        x[8 * c + 2 * i + 1] = f.y;
      }
    }
  }
};

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

// K3: a contiguous cache [B, cap, 2, KVH*D]; window token j of sequence b
// goes to row b * cap + clip(lengths[b] - t, 0, cap - t) + j
// (kv_cache.py:667): lengths count the t window tokens, a length below t
// clamps to 0 and a finished slot past capacity to cap - t.
struct Window {
  const int* lengths;
  int cap, t;
  __device__ int locate(int b) const { return __ldg(lengths + b); }
  __device__ long long row(int b, int len) const {
    return (long long)b * cap + min(max(len - t, 0), cap - t);
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
//     the lane's values [lo, hi) of the source row src (f32 or bf16).
//   narrow(src, lo, hi, part, ...): the rest, with first's result part.
//     All 32 lanes of the warp call it.

// K3, K7 and P2: an int8 cache or pool and its bf16 scales.
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
  template <typename In>
  __device__ float first(const In* src, int lo, int hi) const {
    float amax = 0.0f;
    for (int i = lo; i < hi; ++i)
      amax = fmaxf(amax, fabsf(kvquant::to_float(__ldg(src + i))));
    return amax;
  }
  template <typename In>
  __device__ void narrow(const In* src, int lo, int hi, float amax,
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
      dst[i] = (int8_t)kvquant::quantize_value(
          kvquant::to_float(__ldg(src + i)), sf);
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
  template <typename In>
  __device__ float first(const In*, int, int) const { return 0.0f; }
  template <typename In>
  __device__ void narrow(const In* src, int lo, int hi, float,
                         long long at, int h, int, int kvh, int d,
                         bool write) const {
    if (!write) return;
    T* dst = kv + at * kvh * d + (long long)h * d;
    for (int i = lo; i < hi; ++i) {
      const float x = kvquant::to_float(__ldg(src + i));
      if constexpr (sizeof(T) == 4)
        dst[i] = x;
      else
        dst[i] = __float2bfloat16_rn(x);
    }
  }
};

// kDpl > 0: the wide instance, D = kLanes * kDpl (64 or 128), rows 16-byte
// aligned; kDpl = 0: the narrow one, any D and alignment.
template <int kDpl, typename Src, typename Rows, typename Addr>
__global__ void __launch_bounds__(kBlock)
    kernel(Src source, Rows rows, int kvh, int d, Addr addr) {
  // Source row r; a lane past the last row takes row 0's address, joins
  // the shuffles and stores nothing.
  const long long r =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / kLanes;
  const int slot = threadIdx.x % kLanes;
  const bool on = r < source.count(kvh);
  const RowId id = source.id(on ? r : 0, kvh);
  const int b = id.b;
  const typename Src::T* src = source.ptr(id, kvh, d);
  // The narrow instance's values [lo, hi) of the row, D / 8 rounded up.
  const int per = (d + kLanes - 1) / kLanes;
  const int lo = min(d, slot * per), hi = on ? min(d, lo + per) : lo;
  // The source loads, then the row's address (its loads in flight), then
  // the policy's arithmetic and stores.
  if constexpr (kDpl > 0) {
    float x[kDpl];
    source.template load<kDpl>(src + slot * kDpl, on, x);
    const long long row = addr.row(b, addr.locate(b));
    rows.template wide<kDpl>(x, (row + id.j) * 2 + id.plane, id.h, slot,
                             kvh, d, on && row >= 0);
  } else {
    const float part = rows.first(src, lo, hi);
    const long long row = addr.row(b, addr.locate(b));
    rows.narrow(src, lo, hi, part, (row + id.j) * 2 + id.plane, id.h, slot,
                kvh, d, on && row >= 0);
  }
}

// wide: 1 for the wide instance (the wrapper checks d 64 or 128 and every
// row 16-byte aligned), 0 for the narrow one.
template <typename Src, typename Rows, typename Addr>
cudaError_t launch(Src source, Rows rows, int kvh, int d, int wide,
                   Addr addr, cudaStream_t stream) {
  if (d < 1 || (wide && d != 64 && d != 128)) return cudaErrorInvalidValue;
  const long long threads = source.count(kvh) * kLanes;
  const long long grid = (threads + kBlock - 1) / kBlock;
  if (grid <= 0) return cudaGetLastError();
#define KV_APPEND(DPL)                                                      \
  kernel<DPL, Src, Rows, Addr><<<(unsigned)grid, kBlock, 0, stream>>>(      \
      source, rows, kvh, d, addr)
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
