// Flash-attention forward for Hopper (sm_90a), with a plain C interface
// that mxnet_tpu_torch/ops/flash_attention.py loads through ctypes.
//
// Replaces mxnet_tpu/ops/pallas_kernels.py `flash_attention` -> `_flash_fwd`
// (pl.pallas_call at :109, body `_flash_fwd_kernel` at :46): softmax(q k^T /
// sqrt(D)) v over q, k, v of shape (B, H, T, D), causal or full, with an fp32
// online softmax, the scale applied to q before the product (:50), and kv
// tiles past the diagonal skipped when causal (:84-88).
//
// What bounds it on the H100: at the GPT prefill shapes (D = 64, T up to
// 1024) the work is 2*B*H*T^2*D operations causal against 4*B*H*T*D
// elements moved, so it is bound by arithmetic, not by device memory. This
// first version does the arithmetic as fp32 FMAs on the CUDA cores (no
// tensor cores), so its floor is the card's fp32 rate.
//
// Design:
// - One block per (query tile of BQ = 64 rows, batch*head). Causal blocks
//   with the most work are scheduled first (blockIdx.x runs backwards).
// - Each query row is owned by SPLIT = 2 threads. Both keep the row's scaled
//   q in registers; each sweeps its half of every key tile with its own
//   online-softmax state (m, l, acc[D]), and the two states are merged at the
//   end. That doubles the threads per block over one-thread-per-row.
// - K and V tiles of BK = 32 keys are staged in shared memory as fp32 (loads
//   are coalesced; bf16 is widened once on load) and read back as float4
//   broadcasts: every thread of a warp reads the same key.
// - Any T is taken: keys past T load as zero and are masked, rows past T are
//   computed but never stored. The TPU kernel asserted T % block == 0
//   instead (:102).
// - Masked scores get probability exactly 0 (not exp of -1e30), so a thread
//   whose half-tile is entirely masked leaves its state untouched.
// - q is loaded and the output stored through shared memory, so both are
//   coalesced.
// wgmma/TMA tiling is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;               // query rows per block
constexpr int BK = 32;               // keys per shared-memory tile
constexpr int SPLIT = 2;             // threads per query row
constexpr int THREADS = BQ * SPLIT;  // 128
constexpr int KPT = BK / SPLIT;      // keys of a tile per thread
constexpr float NEG_INF = -1e30f;    // the TPU kernel's mask value (:36)

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int seq,
                 float scale, int causal) {
  static_assert(D % 8 == 0 && D <= 128, "D must be a multiple of 8, <= 128");
  constexpr int LD = D + 4;  // padded row of the q/out staging tile
  constexpr int SMEM = (2 * BK * D > BQ * LD) ? 2 * BK * D : BQ * LD;
  __shared__ __align__(16) float smem[SMEM];
  float* ks = smem;           // [BK][D]
  float* vs = smem + BK * D;  // [BK][D]
  float* stage = smem;        // [BQ][LD], used before and after the sweep

  const int tid = threadIdx.x;
  const int r = tid % BQ;     // query row within the tile
  const int part = tid / BQ;  // which half of each key tile
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int row = q0 + r;
  const size_t base = static_cast<size_t>(blockIdx.y) * seq * D;

  // q tile -> shared (coalesced) -> registers, scaled as the TPU kernel does
  for (int i = tid; i < BQ * D; i += THREADS) {
    const int rr = i / D, dd = i - rr * D;
    stage[rr * LD + dd] =
        q0 + rr < seq ? to_float(q[base + static_cast<size_t>(q0) * D + i])
                      : 0.f;
  }
  __syncthreads();
  float qr[D];
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = stage[r * LD + d] * scale;
    acc[d] = 0.f;
  }
  float m = NEG_INF;
  float l = 0.f;

  const int kend = causal ? min(seq, q0 + BQ) : seq;
  const int ntiles = (kend + BK - 1) / BK;
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile (or the q staging) is consumed
    for (int i = tid; i < BK * D; i += THREADS) {
      const bool in = k0 + i / D < seq;
      const size_t g = base + static_cast<size_t>(k0) * D + i;
      ks[i] = in ? to_float(k[g]) : 0.f;
      vs[i] = in ? to_float(v[g]) : 0.f;
    }
    __syncthreads();

    float s[KPT];
    float mt = NEG_INF;
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const int j = part * KPT + jj;
      const int key = k0 + j;
      const float4* kr = reinterpret_cast<const float4*>(ks + j * D);
      float dot = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 kk = kr[d4];
        dot = fmaf(qr[4 * d4], kk.x, dot);
        dot = fmaf(qr[4 * d4 + 1], kk.y, dot);
        dot = fmaf(qr[4 * d4 + 2], kk.z, dot);
        dot = fmaf(qr[4 * d4 + 3], kk.w, dot);
      }
      const bool ok = key < seq && (!causal || key <= row);
      s[jj] = ok ? dot : NEG_INF;
      mt = fmaxf(mt, s[jj]);
    }
    const float mn = fmaxf(m, mt);
    const float corr = expf(m - mn);
    float lt = 0.f;
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const float p = s[jj] == NEG_INF ? 0.f : expf(s[jj] - mn);
      s[jj] = p;
      lt += p;
    }
    l = l * corr + lt;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const float p = s[jj];
      const float4* vr =
          reinterpret_cast<const float4*>(vs + (part * KPT + jj) * D);
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 vv = vr[d4];
        acc[4 * d4] = fmaf(p, vv.x, acc[4 * d4]);
        acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
        acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
        acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
      }
    }
    m = mn;
  }

  // merge the two halves' softmax states, then store through shared memory
  __syncthreads();
  if (part == 1) {
#pragma unroll
    for (int d = 0; d < D; ++d) stage[r * LD + d] = acc[d];
    stage[r * LD + D] = m;
    stage[r * LD + D + 1] = l;
  }
  __syncthreads();
  if (part == 0) {
    const float m1 = stage[r * LD + D];
    const float l1 = stage[r * LD + D + 1];
    const float mx = fmaxf(m, m1);
    const float a0 = expf(m - mx);
    const float a1 = expf(m1 - mx);
    const float inv = 1.f / fmaxf(l * a0 + l1 * a1, 1e-30f);
#pragma unroll
    for (int d = 0; d < D; ++d)
      stage[r * LD + d] = (acc[d] * a0 + stage[r * LD + d] * a1) * inv;
  }
  __syncthreads();
  for (int i = tid; i < BQ * D; i += THREADS) {
    const int rr = i / D, dd = i - rr * D;
    if (q0 + rr < seq)
      store(o + base + static_cast<size_t>(q0) * D + i, stage[rr * LD + dd]);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bh, int seq, int dim, float scale, int causal,
                   cudaStream_t stream) {
  const dim3 grid((seq + BQ - 1) / BQ, bh);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
  switch (dim) {
#define MXTPU_FA_CASE(DIM)                                             \
  case DIM:                                                           \
    flash_fwd_kernel<T, DIM><<<grid, THREADS, 0, stream>>>(           \
        qp, kp, vp, op, seq, scale, causal);                          \
    break;
    MXTPU_FA_CASE(8) MXTPU_FA_CASE(16) MXTPU_FA_CASE(24)
    MXTPU_FA_CASE(32) MXTPU_FA_CASE(40) MXTPU_FA_CASE(48)
    MXTPU_FA_CASE(56) MXTPU_FA_CASE(64) MXTPU_FA_CASE(72)
    MXTPU_FA_CASE(80) MXTPU_FA_CASE(88) MXTPU_FA_CASE(96)
    MXTPU_FA_CASE(104) MXTPU_FA_CASE(112) MXTPU_FA_CASE(120)
    MXTPU_FA_CASE(128)
#undef MXTPU_FA_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: contiguous (bh, seq, dim); dtype 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int mxtpu_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* o, int bh,
                                         int seq, int dim, int dtype,
                                         float scale, int causal,
                                         void* stream) {
  if (bh < 1 || bh > 65535 || seq < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, o, bh, seq, dim, scale, causal, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, bh, seq, dim, scale, causal, s);
  return cudaErrorInvalidValue;
}
