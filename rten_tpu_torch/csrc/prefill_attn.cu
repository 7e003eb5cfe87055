// Prefill self-attention (F1): blockwise attention with an online softmax,
// at f32 accuracy on the tensor cores (split TF32).
//
// Replaces: rten_tpu/kernels/attention.py::flash_attention (kernel
// _flash_kernel) at the shapes where the reference runs its kernel (head
// dim a multiple of 128, S >= 128 a multiple of 128: prefill of a d = 128
// model, transformer.py:797). The wrapper takes d = 128.
//
// Contract: q, k, v f32 [B, H, S, D], contiguous (k and v already repeated
// to H heads). For query i of (b, h): s_ij = (q_i . k_j) * scale in f32,
// set to -1e30 where causal and j > i; the running max m (from -1e30), sum
// l and accumulator acc follow the online softmax over key tiles, and
// out_i = acc / max(l, 1e-30). A key tile wholly above the diagonal would
// add exp(-1e30 - m) = 0 to every sum, so causal warps skip it.
//
// Bound on the H100: operations. A causal prefill does about 2*B*H*S^2*D
// FLOPs (two products of S^2/2 dot products of D); at B 16, 32 heads, S
// 512, D 128 that is 34.4 GFLOP: 0.51 ms at the 67 TFLOP/s of f32 outside
// the tensor cores, and three times that, 0.21 ms, at the 495 TFLOP/s of
// dense TF32 (below). The bytes, 4 * B*H*S*D * 4 = 0.54 GB, take 0.16 ms.
//
// Numerics: split TF32 ("3xTF32"). Every f32 operand a of both products is
// split into a = hi + lo, hi = rna(a), lo = rna(a - hi), where rna rounds
// to TF32 (10 mantissa bits) to nearest, ties away from zero, exactly as
// cvt.rna.tf32.f32 does; it is computed on the integer pipe (add half an
// ulp to the bits, clear 13), since cvt took 0.96 ms against 0.81 (times
// and shares here: `python -m rten_tpu_torch.tools.f1_variants` on an H100
// 80GB HBM3 at 700 W, B 16, 32 heads, S 512, causal). Each product is
// lo*hi + hi*lo + hi*hi through mma.sync m16n8k8 TF32: hi*hi into one
// accumulator, the small terms into another, added per tile; P V is summed
// per 32-key tile and folded into the output in f32 (o = o * alpha +
// tile), so no accumulator runs through more than 32 tensor-core steps,
// whose rounding is not f32's (one accumulator for each whole sum put S
// 2048 without a mask at 2.0x the 1e-5 tolerance, this layout at 0.25x).
// The dropped lo*lo term and lo's rounding are ~2^-22 of each product,
// f32's own rounding size; one TF32 product alone (~2^-11) would change
// the reference's arithmetic. These explicit TF32 instructions do not
// depend on PyTorch's allow_tf32 switches, which govern PyTorch's own
// matmuls only.
//
// Design (FlashAttention-2 ownership): one block of 4 warps per (b, h, 64
// queries), each warp owning 16 query rows, so a row's max and sum are
// quad shuffles and the probabilities P stay in registers between the two
// products. Query tiles run heaviest first (the grid's slowest dimension).
// Shared memory holds the f32 Q tile and a 2-stage cp.async ring of 32-key
// K and V tiles (105 KB, two blocks an SM); key tile kt + 1 loads while the
// warps compute on tile kt. Each warp splits the Q, K, V and P elements it
// reads, in registers. 16-key tiles with three blocks an SM took 0.84 ms
// against 0.81; hi*hi alone (one TF32 product, not f32 accuracy) 0.51: the
// two small products and their splits cost 0.3 ms, and the softmax and
// splits overlap the tensor cores little.
//
// Fragment orders. m16n8k8's A holds (row g, k t) in a0, (g + 8, t) in a1,
// (g, t + 4) in a2, (g + 8, t + 4) in a3, B holds (k t, col g) in b0 and
// (k t + 4, col g) in b1, C holds (g, 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1), for lane 4g + t. A sum's k order is free, so:
//   S = Q K^T: k steps 2c and 2c + 1 take dims 16c + 4t + {0, 1} and
//     16c + 4t + {2, 3}: one 16-byte read of Q's rows g and g + 8 and of
//     K's key row gives both steps' operands.
//   O = P V: k index t of key step j is key 8j + 2t and t + 4 is key
//     8j + 2t + 1, the keys of S's C registers, so S's C fragment is P's A
//     fragment as it stands. Column g of output tile 4a + i is dim
//     32a + 4g + i, so one 16-byte V read gives 4 tiles' B registers, and a
//     lane ends with dims 32a + 8t .. 32a + 8t + 7 of its rows.
// Row strides (floats) keep the 16-byte reads free of bank conflicts: Q and
// K 144 (rows g and g + 1 half a bank row apart), V 132 (rows 2t four banks
// x 2 apart).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 128, kBQ = 64, kBK = 32, kWarps = 4;
constexpr int kThreads = 32 * kWarps, kStages = 2;
constexpr int kNT = kBK / 8;   // n8 tiles of S, k8 steps of P V, a key tile
constexpr int kW = 4;          // output n8 tiles one 16-byte V read feeds
constexpr int kQStride = kD + 16, kKStride = kD + 16, kVStride = kD + 4;
constexpr int kQFloats = kBQ * kQStride;
constexpr int kKFloats = kBK * kKStride, kVFloats = kBK * kVStride;
constexpr int kSmemBytes = (kQFloats + kStages * (kKFloats + kVFloats)) * 4;
constexpr int kChunks = kD / 4;  // 16-byte chunks of a row
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// cvt.rna.tf32.f32: half a TF32 ulp added to the magnitude's bits, the 13
// low bits cleared.
__device__ __forceinline__ uint32_t rna_tf32(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xFFFFE000u;
}

// a = hi + lo, both TF32.
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(a);
  lo = rna_tf32(__fsub_rn(a, __uint_as_float(hi)));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// big += hi*hi; small += lo*hi + hi*lo, from f32 B elements b0, b1.
__device__ __forceinline__ void mma3(float (&big)[4], float (&small)[4],
                                     const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0,
                                     float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma_tf32(small, al, bh0, bh1);
  mma_tf32(small, ah, bl0, bl1);
  mma_tf32(big, ah, bh0, bh1);
}

__global__ void __launch_bounds__(kThreads, 2)
    prefill_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ out,
                   int s, int causal, float scale) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kBQ][kQStride]
  float* ks = qs + kQFloats;                    // [kStages][kBK][kKStride]
  float* vs = ks + kStages * kKFloats;          // [kStages][kBK][kVStride]
  const int qb = gridDim.z - 1 - blockIdx.z;    // heaviest tiles first
  const long long head =
      ((long long)blockIdx.y * gridDim.x + blockIdx.x) * s * kD;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qb * kBQ, row0 = q0 + 16 * warp + g;  // and row0 + 8
  const int nk = causal ? (q0 + kBQ) / kBK : s / kBK;

  auto load_kv = [&](int kt, int stage) {
    const long long k0 = head + (long long)kt * kBK * kD;
    float* kd = ks + stage * kKFloats;
    float* vd = vs + stage * kVFloats;
#pragma unroll
    for (int i = 0; i < kBK * kChunks / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / kChunks, col = 4 * (c % kChunks);
      cp_async16(kd + r * kKStride + col, k + k0 + (long long)r * kD + col);
      cp_async16(vd + r * kVStride + col, v + k0 + (long long)r * kD + col);
    }
  };
#pragma unroll
  for (int i = 0; i < kBQ * kChunks / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int r = c / kChunks, col = 4 * (c % kChunks);
    cp_async16(qs + r * kQStride + col,
               q + head + (long long)(q0 + r) * kD + col);
  }
  load_kv(0, 0);
  cp_commit();

  float o[16][4];  // output n8 tile kW a + i
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};  // rows g, g + 8
  const float* qw = qs + (16 * warp + g) * kQStride + 4 * t;

  for (int kt = 0; kt < nk; ++kt) {
    cp_wait_all();
    __syncthreads();  // tile kt landed; every warp is done with kt - 1
    if (kt + 1 < nk) load_kv(kt + 1, (kt + 1) % kStages);
    cp_commit();
    const int key0 = kt * kBK;
    if (causal && key0 > row0 - g + 15) continue;  // above the warp's rows
    const float* kw = ks + (kt % kStages) * kKFloats + g * kKStride + 4 * t;
    const float* vw = vs + (kt % kStages) * kVFloats + 2 * t * kVStride +
                      kW * g;

    // S = Q K^T for 16 rows x kBK keys: n8 tile j holds keys 8j..8j + 7.
    float sc[kNT][4], ss[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = ss[j][e] = 0.0f;
#pragma unroll 2
    for (int c = 0; c < kD / 16; ++c) {
      const float4 qa = *reinterpret_cast<const float4*>(qw + 16 * c);
      const float4 qc =
          *reinterpret_cast<const float4*>(qw + 8 * kQStride + 16 * c);
      uint32_t ah0[4], al0[4], ah1[4], al1[4];
      split(qa.x, ah0[0], al0[0]);
      split(qc.x, ah0[1], al0[1]);
      split(qa.y, ah0[2], al0[2]);
      split(qc.y, ah0[3], al0[3]);
      split(qa.z, ah1[0], al1[0]);
      split(qc.z, ah1[1], al1[1]);
      split(qa.w, ah1[2], al1[2]);
      split(qc.w, ah1[3], al1[3]);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const float4 kv =
            *reinterpret_cast<const float4*>(kw + 8 * j * kKStride + 16 * c);
        mma3(sc[j], ss[j], ah0, al0, kv.x, kv.y);
        mma3(sc[j], ss[j], ah1, al1, kv.z, kv.w);
      }
    }

    // Scale, mask, and the online softmax of rows g (e < 2) and g + 8.
    // sc[j][e] is key key0 + 8j + 2t + (e & 1).
    const bool diag = causal && key0 + kBK - 1 > row0 - g;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = __fmul_rn(__fadd_rn(sc[j][e], ss[j][e]), scale);
        if (diag && key0 + 8 * j + 2 * t + (e & 1) > row0 + 8 * (e >> 1))
          x = kNegInf;
        sc[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
    float psum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] = expf(sc[j][e] - m[e >> 1]);
        psum[e >> 1] += sc[j][e];
      }
    // l is each lane's share of its row's sum (the quad's alpha is one);
    // the quad adds its shares at the end.
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + psum[r];

    // O = O * alpha + P V, the tile's sum taken kW output n8 tiles at a
    // time.
    uint32_t ph[kNT][4], pl[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      split(sc[j][0], ph[j][0], pl[j][0]);
      split(sc[j][2], ph[j][1], pl[j][1]);
      split(sc[j][1], ph[j][2], pl[j][2]);
      split(sc[j][3], ph[j][3], pl[j][3]);
    }
#pragma unroll
    for (int a = 0; a < 16 / kW; ++a) {
      float tb[kW][4], ts[kW][4];
#pragma unroll
      for (int i = 0; i < kW; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) tb[i][e] = ts[i][e] = 0.0f;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const float* p0 = vw + 8 * j * kVStride + 8 * kW * a;
        const float4 v0 = *reinterpret_cast<const float4*>(p0);
        const float4 v1 = *reinterpret_cast<const float4*>(p0 + kVStride);
        mma3(tb[0], ts[0], ph[j], pl[j], v0.x, v1.x);
        mma3(tb[1], ts[1], ph[j], pl[j], v0.y, v1.y);
        mma3(tb[2], ts[2], ph[j], pl[j], v0.z, v1.z);
        mma3(tb[3], ts[3], ph[j], pl[j], v0.w, v1.w);
      }
#pragma unroll
      for (int i = 0; i < kW; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[kW * a + i][e] = fmaf(o[kW * a + i][e], alpha[e >> 1],
                                  __fadd_rn(tb[i][e], ts[i][e]));
    }
  }
  cp_wait_all();

  // Lane 4g + t holds dims 8 kW a + 2 kW t + u of rows g and g + 8: u < kW
  // from C column 2t of tile kW a + u, u >= kW from column 2t + 1.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float den = fmaxf(l[r], 1e-30f);
    float* orow = out + head + (long long)(row0 + 8 * r) * kD + 2 * kW * t;
    const int e = 2 * r;
#pragma unroll
    for (int a = 0; a < 16 / kW; ++a) {
      *reinterpret_cast<float4*>(orow + 8 * kW * a) =
          make_float4(o[kW * a][e] / den, o[kW * a + 1][e] / den,
                      o[kW * a + 2][e] / den, o[kW * a + 3][e] / den);
      *reinterpret_cast<float4*>(orow + 8 * kW * a + kW) = make_float4(
          o[kW * a][e + 1] / den, o[kW * a + 1][e + 1] / den,
          o[kW * a + 2][e + 1] / den, o[kW * a + 3][e + 1] / den);
    }
  }
}

}  // namespace

// The wrapper checks d == 128 and S a multiple of 128 (so of the 64-query
// tile and the key tile), contiguity and f32.
extern "C" int prefill_attn(const void* q, const void* k, const void* v,
                            void* out, int batch, int heads, int s, int d,
                            int causal, float scale, void* stream) {
  if (d != kD || s % kBQ || batch > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      prefill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  if (batch > 0 && heads > 0 && s > 0) {
    const dim3 grid(heads, batch, s / kBQ);
    prefill_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)out, s,
        causal, scale);
  }
  return (int)cudaGetLastError();
}
