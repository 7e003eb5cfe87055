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
// 3.35 TB/s; at batch 16, 8 heads of 128 (Mistral-7B) it moves 0.2 MB.
// Launch and latency dominate: the time is one chain of round trips.
// Design: eight lanes a (sequence, plane, head) row, four rows a warp
// (kvquant::quantize_row_lanes8, the tail flush's arithmetic bit for bit).
// Each lane first issues its 16-byte loads of the row's f32 values (D / 8
// of them, in registers), then the load of the position, which only the
// stores need: the position is in flight while the row is quantized
// (absmax by three shuffles within the row's lanes, an IEEE division a
// value), and the chain is one round trip for both loads, the arithmetic,
// and the stores (D / 8 bytes a lane as one 8- or 16-byte store, the scale
// by the row's first lane). The design before ran one warp a row, and its
// source loads waited behind the branch on the position. The wide instance
// serves head_dim 64 and 128, every preset's but the small test one's.
// Where D is another, or a row is not 16-byte aligned, the same kernel
// takes its narrow instance: each lane reads its D / 8 values (rounded up)
// by scalar loads, and quantizes and stores them byte by byte. The file
// must not be compiled with -use_fast_math.
#include "kv_quant.cuh"

namespace {

constexpr int kLanes = 8;      // lanes a row
// Threads a block: 16 rows of eight lanes. (B) has 6,144 rows (384 blocks,
// about three an SM in one wave), (H) 256 (16 blocks). Each block is one
// short chain of round trips, so the size matters little: 64 and 256
// timed within 0.0001 ms of 128 at both shapes (PERF.md).
constexpr int kBlock = 128;

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
template <int kDpl>
__global__ void __launch_bounds__(kBlock) kv_append_int8_kernel(
    const float* __restrict__ k, const float* __restrict__ v, int k_stride,
    int v_stride, int8_t* __restrict__ kv, __nv_bfloat16* __restrict__ scales,
    const int* __restrict__ pos_in, int batch, int cap, int kvh, int d,
    int masked) {
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
  // The source loads, then the position's, then the arithmetic: nothing
  // before the stores waits for the position.
  int p;
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
    p = on ? __ldg(pos_in + b) : -1;
    sb = kvquant::quantize_row_lanes8<kDpl>(x, w);
  } else {
    float amax = 0.0f;
    for (int i = lo; i < hi; ++i) amax = fmaxf(amax, fabsf(__ldg(src + i)));
    p = on ? __ldg(pos_in + b) : -1;
#pragma unroll
    for (int o = 1; o < kLanes; o <<= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    sb = kvquant::row_scale(amax);
  }
  if (!on || (masked && p < 0)) return;
  const long long row =
      ((long long)b * cap + min(max(p, 0), cap - 1)) * 2 + plane;
  int8_t* dst = kv + row * kvh * d + (long long)h * d;
  if constexpr (kDpl > 0) {
    store_words<kDpl>(dst + slot * kDpl, w);
  } else {
    const float sf = __bfloat162float(sb);
    for (int i = lo; i < hi; ++i)
      dst[i] = (int8_t)kvquant::quantize_value(__ldg(src + i), sf);
  }
  if (slot == 0) scales[row * kvh + h] = sb;
}

}  // namespace

// wide: 1 for the wide instance (the wrapper checks d 64 or 128 and every
// row 16-byte aligned), 0 for the narrow one.
extern "C" int kv_append_int8(const void* k, const void* v, int k_stride,
                              int v_stride, void* kv, void* scales,
                              const void* pos, int batch, int cap, int kvh,
                              int d, int masked, int wide, void* stream) {
  if (d < 1 || (wide && d != 64 && d != 128))
    return (int)cudaErrorInvalidValue;
  const long long threads = (long long)batch * 2 * kvh * kLanes;
  const long long grid = (threads + kBlock - 1) / kBlock;
  if (grid <= 0) return (int)cudaGetLastError();
  const float* kf = (const float*)k;
  const float* vf = (const float*)v;
  int8_t* kv8 = (int8_t*)kv;
  __nv_bfloat16* sc = (__nv_bfloat16*)scales;
  const int* ps = (const int*)pos;
  cudaStream_t st = (cudaStream_t)stream;
#define KV_APPEND_INT8(DPL)                                                 \
  kv_append_int8_kernel<DPL><<<(unsigned)grid, kBlock, 0, st>>>(            \
      kf, vf, k_stride, v_stride, kv8, sc, ps, batch, cap, kvh, d, masked)
  if (!wide)
    KV_APPEND_INT8(0);
  else if (d == 64)
    KV_APPEND_INT8(8);
  else
    KV_APPEND_INT8(16);
#undef KV_APPEND_INT8
  return (int)cudaGetLastError();
}
