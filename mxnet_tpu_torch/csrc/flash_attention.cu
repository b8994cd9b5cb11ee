// Flash-attention forward for Hopper (sm_90a) on the tensor cores, with a
// plain C interface that mxnet_tpu_torch/ops/flash_attention.py loads
// through ctypes.
//
// Replaces mxnet_tpu/ops/pallas_kernels.py `flash_attention` -> `_flash_fwd`
// (pl.pallas_call at :109, body `_flash_fwd_kernel` at :46): softmax(q k^T /
// sqrt(D)) v over q, k, v of shape (B, H, T, D), causal or full, with an fp32
// online softmax, the scale applied to q before the product (:50), kv tiles
// past the diagonal skipped when causal (:84-88), and out = acc / max(l,
// 1e-30) (:91).
//
// What bounds it on the H100: 2*B*H*T*(T+1)*D operations causal (twice that
// full) against 4*B*H*T*D elements moved, so at the GPT prefill shapes (D =
// 64, T up to 1024) it is bound by arithmetic. The bound of the math it runs:
// bf16 operations / 989 TFLOP/s; fp32 3 x operations / 494.7 TFLOP/s (3xTF32,
// below); the larger of that and bytes / 3.35 TB/s. At these sizes (B*H =
// 12, T <= 1024) a whole causal prefill is <= 1.6 GFLOP: the limits are
// filling 132 SMs and hiding latency, not the per-SM tensor rate.
//
// Design (FlashAttention-2's, on mma.sync):
// - A block of 4 warps owns BQ = 64 query rows of one (batch, head); each
//   warp owns 16 whole rows. Fewer rows a block would give more blocks, but
//   each block holds the same K/V ring, so fewer warps fit on an SM: at
//   every serve bucket that cost more than the wider grid gained (PERF.md).
//   Causal blocks with the most work launch first: blockIdx.y runs
//   backwards over the query tiles and blockIdx.x over the heads, so the
//   heavy tiles of all heads go out in the first wave and the light ones
//   fill in beside them.
// - K and V tiles of BK = 64 keys stream through a ring in shared memory
//   (3 stages for bf16, 2 for fp32) with 16-byte cp.async copies: the next
//   tiles' copies are in flight while the current tile's products run, and
//   one barrier a tile both publishes a landed tile and frees the stage the
//   next copy fills. Rows of q and K are padded by 8 elements and rows of V
//   by 16 bytes, so every fragment read is free of bank conflicts. Keys
//   past T and query rows past T load as zeros (cp.async zero-fill); the
//   columns D..DP of a D that is not a multiple of 16 are zeroed once and
//   never written.
// - S = Q K^T and O += P V are warp-level tensor-core products with fp32
//   accumulators in registers:
//   * bf16: mma.sync m16n8k16. P is rounded to bf16 for the P V product (the
//     TPU kernel kept P in fp32; the row sums l stay fp32). The scale is
//     applied to S in fp32 after the product (inside the exponent), so q
//     is not rounded again.
//   * fp32: mma.sync m16n8k8 in TF32 with the 3xTF32 split: x = hi + lo,
//     each rounded to TF32, and hi*hi + hi*lo + lo*hi accumulated in fp32
//     (one TF32 product alone misses the fp32 tolerance by 10x). Q (scaled
//     as the TPU kernel does) is split once per block into registers; each
//     warp splits the K/V fragments it reads once per tile, in registers.
// - P stays in registers: the S accumulator fragment is the A fragment of
//   P V. For m16n8k16 the layouts agree. For m16n8k8 the accumulator holds
//   keys (2t, 2t+1) of each 8-key slice where the A fragment wants (t, t+4),
//   so the keys of the slice are taken in the order 0,2,4,6,1,3,5,7 and V's
//   rows are read in the same order; the sum over keys does not care.
// - The online softmax runs in base 2 (log2 e folded into the scale) on the
//   MUFU's ex2; masked scores, on the tiles that have any, get probability
//   exactly 0. The row sums are kept per lane and reduced across the quad
//   once at the end.
// - The output is staged through the warp's own rows of the q tile and
//   stored with 16-byte writes; rows past T are never stored.
// - q, k, v and out take any batch, head and row strides (elements) with a
//   unit stride along D; the wrapper checks 16-byte alignment.
// - The bf16 instances load K and V fragments with ldmatrix (V transposed).
// wgmma/TMA, 32 rows a warp and splitting the heaviest causal tiles along
// the keys are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int BK = 64;             // keys per shared-memory tile
// depth of the K/V ring: 3 tiles in flight for bf16; fp32 tiles are twice
// the bytes, and a third stage would leave one block per SM
template <typename T>
__host__ __device__ constexpr int stages() { return sizeof(T) == 4 ? 2 : 3; }
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int BQ = WARPS * 16;     // query rows of a block
constexpr float NEG = -1e30f;      // the TPU kernel's mask value (:36)
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  long long b, h, t;  // in elements; the stride along D is 1
};

// 2^x (MUFU; flushes a denormal result to 0, so 2^-huge is exactly 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32; x - hi is exact in fp32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a)
               : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16 bytes global -> shared; `bytes` = 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

// T = float or __nv_bfloat16; DP = D rounded up to 16 (columns above D are
// zero in shared memory and never stored).
template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, Strides sq,
                 Strides sk, Strides sv, Strides so, int heads, int seq,
                 int dim, float scale_log2, int causal) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int CH = DP / EPC;         // chunks of a padded row
  constexpr int LDK = DP + 8;          // padded rows of the q and K tiles
  constexpr int LDV = DP + EPC;        // padded rows of the V tiles
  constexpr int KS = kF32 ? DP / 8 : DP / 16;  // k-slices of Q K^T
  constexpr int NB = DP / 8;                   // 8-column blocks of O
  constexpr int STAGES = stages<T>();
  static_assert(DP % 16 == 0 && DP <= 128, "DP: a multiple of 16, <= 128");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // [BQ][LDK]
  T* ks = qs + BQ * LDK;                   // [STAGES][BK][LDK]
  T* vs = ks + STAGES * BK * LDK;          // [STAGES][BK][LDV]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;  // the mma fragment coordinates
  // blockIdx.x is the (batch, head), so consecutive blocks are the same
  // query tile of different heads; the heaviest causal tiles come first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int wrow = q0 + warp * 16;  // first query row of this warp
  const int b = blockIdx.x / heads, h = blockIdx.x - b * heads;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  T* ob = o + b * so.b + h * so.h;
  const int chunks = dim / EPC;  // 16-byte chunks of a row (dim % 8 == 0)

  // columns [dim, DP) of every shared row: zero once, cp.async skips them
  if (dim < DP) {
    const int pad = DP - dim, nk = BQ + STAGES * BK;
    for (int i = tid; i < nk * pad; i += THREADS)
      qs[(i / pad) * LDK + dim + i % pad] = zero<T>();
    for (int i = tid; i < STAGES * BK * pad; i += THREADS)
      vs[(i / pad) * LDV + dim + i % pad] = zero<T>();
  }

  // rows [r0, r0 + nrows) of a (seq, dim) matrix into shared rows of `ld`
  auto load_rows = [&](T* dst, int ld, const T* src, long long stride,
                       int r0, int nrows) {
    for (int i = tid; i < nrows * CH; i += THREADS) {
      const int r = i / CH, c = i % CH;  // a constant divisor
      if (c < chunks) {
        const bool in = r0 + r < seq;
        const T* s =
            src + (in ? static_cast<long long>(r0 + r) * stride : 0) + c * EPC;
        cp_async16(dst + r * ld + c * EPC, s, in ? 16 : 0);
      }
    }
  };

  const int kend = causal ? min(seq, q0 + BQ) : seq;
  const int ntiles = (kend + BK - 1) / BK;
  // one commit group per tile (the q tile joins tile 0's); tiles 0 ..
  // STAGES - 2 before the loop, tile it + STAGES - 1 at step it
  auto load_tile = [&](int t) {
    if (t < ntiles) {
      const int st = t % STAGES;
      load_rows(ks + st * BK * LDK, LDK, kb, sk.t, t * BK, BK);
      load_rows(vs + st * BK * LDV, LDV, vb, sv.t, t * BK, BK);
    }
    cp_async_commit();
  };
  load_rows(qs, LDK, qb, sq.t, q0, BQ);
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) load_tile(t);

  uint32_t qa[KS][4];               // Q A-fragments (hi parts for fp32)
  uint32_t ql[kF32 ? KS : 1][4];    // fp32: the lo parts
  float oacc[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n)
    oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  // fp32 S comes scaled (q was); bf16 S is scaled in the exponent
  const float sc = kF32 ? 1.f : scale_log2;
  float m0 = NEG, m1 = NEG;  // running max of rows g and g + 8
  float l0 = 0.f, l1 = 0.f;  // this lane's part of their row sums

  for (int it = 0; it < ntiles; ++it) {
    const int st = it % STAGES;
    cp_async_wait<STAGES - 2>();  // tile it has landed
    // ... for every thread, and every warp is done with tile it - 1, whose
    // stage the next copy fills
    __syncthreads();
    load_tile(it + STAGES - 1);
    const T* kt = ks + st * BK * LDK;
    const T* vt = vs + st * BK * LDV;

    if (it == 0) {  // the q tile has landed: fragments into registers
      const T* qw = qs + (warp * 16) * LDK;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        if constexpr (kF32) {
          // A position t <-> column 2t, t + 4 <-> 2t + 1 of each 8-column
          // slice, as for K below: the sum over D does not care
          const float2 x0 = *reinterpret_cast<const float2*>(
              reinterpret_cast<const float*>(qw) + g * LDK + 8 * kk + 2 * t4);
          const float2 x1 = *reinterpret_cast<const float2*>(
              reinterpret_cast<const float*>(qw) + (g + 8) * LDK + 8 * kk +
              2 * t4);
          split(x0.x * scale_log2, qa[kk][0], ql[kk][0]);
          split(x1.x * scale_log2, qa[kk][1], ql[kk][1]);
          split(x0.y * scale_log2, qa[kk][2], ql[kk][2]);
          split(x1.y * scale_log2, qa[kk][3], ql[kk][3]);
        } else {
          const uint32_t* r0 =
              reinterpret_cast<const uint32_t*>(qw + g * LDK);
          const uint32_t* r1 =
              reinterpret_cast<const uint32_t*>(qw + (g + 8) * LDK);
          qa[kk][0] = r0[8 * kk + t4];
          qa[kk][1] = r1[8 * kk + t4];
          qa[kk][2] = r0[8 * kk + t4 + 4];
          qa[kk][3] = r1[8 * kk + t4 + 4];
        }
      }
    }

    // S = Q K^T: 8 blocks of 8 keys, fragment rows g and g + 8
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      if constexpr (kF32) {
        const float* kr =
            reinterpret_cast<const float*>(kt) + (8 * j + g) * LDK + 2 * t4;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          const float2 kx = *reinterpret_cast<const float2*>(kr + 8 * kk);
          uint32_t bh0, bl0, bh1, bl1;
          split(kx.x, bh0, bl0);
          split(kx.y, bh1, bl1);
          mma_tf32(s[j], ql[kk], bh0, bh1);
          mma_tf32(s[j], qa[kk], bl0, bl1);
          mma_tf32(s[j], qa[kk], bh0, bh1);
        }
      } else {
        // ldmatrix: lanes 0-7, 8-15, 16-23, 24-31 give the rows of the
        // 8 x 8 blocks at columns +0, +8, +16, +24: two k-slices
        const T* kr = kt + (8 * j + (lane & 7)) * LDK + (lane >> 3) * 8;
#pragma unroll
        for (int kp = 0; kp < KS / 2; ++kp) {
          uint32_t kb4[4];
          ldmatrix_x4(kb4, kr + 32 * kp);
          mma_bf16(s[j], qa[2 * kp], kb4[0], kb4[1]);
          mma_bf16(s[j], qa[2 * kp + 1], kb4[2], kb4[3]);
        }
        if constexpr (KS % 2) {
          uint32_t kb2[2];
          ldmatrix_x2(kb2, kr + 32 * (KS / 2));
          mma_bf16(s[j], qa[KS - 1], kb2[0], kb2[1]);
        }
      }
    }

    // mask the keys past T, and past the diagonal when causal
    const int k0 = it * BK;
    const bool edge = k0 + BK > seq || (causal && k0 + BK - 1 > wrow);
    if (edge) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * t4 + (e & 1);
          const int row = wrow + g + (e >> 1) * 8;
          if (key >= seq || (causal && key > row)) s[j][e] = NEG;
        }
    }

    // online softmax (base 2) over the tile, rows reduced across the quad;
    // the running max stays in S's units, and for bf16 the scale joins
    // in the exponent: p = 2^(s * sc - max * sc)
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float c0 = ex2((m0 - mx0) * sc), c1 = ex2((m1 - mx1) * sc);
    m0 = mx0;
    m1 = mx1;
    const float mb0 = mx0 * sc, mb1 = mx1 * sc;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(fmaf(s[j][e], sc, -(e < 2 ? mb0 : mb1)));
        if (edge && s[j][e] == NEG) p = 0.f;  // masked: exactly 0
        s[j][e] = p;
        if (e < 2)
          ls0 += p;
        else
          ls1 += p;
      }
    l0 = l0 * c0 + ls0;
    l1 = l1 * c1 + ls1;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      oacc[n][0] *= c0;
      oacc[n][1] *= c0;
      oacc[n][2] *= c1;
      oacc[n][3] *= c1;
    }

    // O += P V, P straight from the S accumulators
    if constexpr (kF32) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // A position t <-> key 2t, position t + 4 <-> key 2t + 1
        uint32_t ph[4], pl[4];
        split(s[j][0], ph[0], pl[0]);
        split(s[j][2], ph[1], pl[1]);
        split(s[j][1], ph[2], pl[2]);
        split(s[j][3], ph[3], pl[3]);
        const float* v0 =
            reinterpret_cast<const float*>(vt) + (8 * j + 2 * t4) * LDV;
        const float* v1 = v0 + LDV;
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          uint32_t bh0, bl0, bh1, bl1;
          split(v0[8 * n + g], bh0, bl0);
          split(v1[8 * n + g], bh1, bl1);
          mma_tf32(oacc[n], pl, bh0, bh1);
          mma_tf32(oacc[n], ph, bl0, bl1);
          mma_tf32(oacc[n], ph, bh0, bh1);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        // ldmatrix: lanes 0-7 keys 0-7, 8-15 keys 8-15 (columns 0-7), then
        // the same for columns 8-15 of each 16-column pair
        const T* vr = vt +
                      (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LDV +
                      (lane >> 4) * 8;
#pragma unroll
        for (int np = 0; np < DP / 16; ++np) {
          uint32_t vb4[4];
          ldmatrix_x4_trans(vb4, vr + 16 * np);
          mma_bf16(oacc[2 * np], pa, vb4[0], vb4[1]);
          mma_bf16(oacc[2 * np + 1], pa, vb4[2], vb4[3]);
        }
      }
    }
  }

  // out = acc / max(l, 1e-30), staged through this warp's rows of the q tile
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  T* os = qs + (warp * 16) * LDK;
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    const int col = 8 * n + 2 * t4;
    if constexpr (kF32) {
      *reinterpret_cast<float2*>(os + g * LDK + col) =
          make_float2(oacc[n][0] * inv0, oacc[n][1] * inv0);
      *reinterpret_cast<float2*>(os + (g + 8) * LDK + col) =
          make_float2(oacc[n][2] * inv1, oacc[n][3] * inv1);
    } else {
      *reinterpret_cast<uint32_t*>(os + g * LDK + col) =
          pack_bf16(oacc[n][0] * inv0, oacc[n][1] * inv0);
      *reinterpret_cast<uint32_t*>(os + (g + 8) * LDK + col) =
          pack_bf16(oacc[n][2] * inv1, oacc[n][3] * inv1);
    }
  }
  __syncwarp();
  for (int i = lane; i < 16 * chunks; i += 32) {
    const int r = i / chunks, c = i - r * chunks;
    if (wrow + r < seq)
      *reinterpret_cast<uint4*>(ob + static_cast<long long>(wrow + r) * so.t +
                                c * EPC) =
          *reinterpret_cast<const uint4*>(os + r * LDK + c * EPC);
  }
}

// the q tile, and the K and V rings
template <typename T, int DP>
constexpr int smem_bytes() {
  return static_cast<int>(((BQ + stages<T>() * BK) * (DP + 8) +
                           stages<T>() * BK * (DP + 16 / sizeof(T))) *
                          sizeof(T));
}

template <typename T, int DP>
cudaError_t launch_dp(const void* q, const void* k, const void* v, void* o,
                      const Strides (&st)[4], int batch, int heads, int seq,
                      int dim, float scale_log2, int causal, int device,
                      cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, DP>;
  constexpr int smem = smem_bytes<T, DP>();
  // dynamic shared memory above 48 KB is opted into once per device
  static unsigned long long opted = 0;
  if (device < 64 && !((opted >> device) & 1ull)) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    opted |= 1ull << device;
  }
  const dim3 grid(batch * heads, (seq + BQ - 1) / BQ);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), st[0], st[1], st[2],
      st[3], heads, seq, dim, scale_log2, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const Strides (&st)[4], int batch, int heads, int seq,
                   int dim, float scale_log2, int causal, int device,
                   cudaStream_t stream) {
  switch ((dim + 15) / 16 * 16) {
#define MXTPU_FA_CASE(DP)                                                    \
  case DP:                                                                  \
    return launch_dp<T, DP>(q, k, v, o, st, batch, heads, seq, dim,          \
                            scale_log2, causal, device, stream);
    MXTPU_FA_CASE(16) MXTPU_FA_CASE(32) MXTPU_FA_CASE(48)
    MXTPU_FA_CASE(64) MXTPU_FA_CASE(80) MXTPU_FA_CASE(96)
    MXTPU_FA_CASE(112) MXTPU_FA_CASE(128)
#undef MXTPU_FA_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: (batch, heads, seq, dim) with the given batch/head/row strides
// in elements and unit stride along dim, 16-byte aligned rows; dim a
// multiple of 8 up to 128; dtype 0 = float32, 1 = bfloat16; device = the
// CUDA device of the tensors. Launches on `stream` and returns the
// cudaError_t of the launch (0 on success).
extern "C" int mxtpu_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, long long qsb,
    long long qsh, long long qst, long long ksb, long long ksh,
    long long kst, long long vsb, long long vsh, long long vst,
    long long osb, long long osh, long long ost, int batch, int heads,
    int seq, int dim, int dtype, float scale, int causal, int device,
    void* stream) {
  if (batch < 1 || heads < 1 || seq < 1 || (seq + BQ - 1) / BQ > 65535 ||
      dim < 8 || dim > 128 || dim % 8)
    return cudaErrorInvalidValue;
  mxtpu::DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return scope.error();
  const Strides st[4] = {{qsb, qsh, qst}, {ksb, ksh, kst}, {vsb, vsh, vst},
                         {osb, osh, ost}};
  const float sl2 = scale * LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, o, st, batch, heads, seq, dim, sl2, causal,
                         device, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, st, batch, heads, seq, dim, sl2,
                                 causal, device, s);
  return cudaErrorInvalidValue;
}
