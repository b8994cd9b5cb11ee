// 1x1 convolution as a GEMM with the BatchNorm batch statistics in its
// epilogue, for Hopper (sm_90a), with a plain C interface that
// mxnet_tpu_torch/ops/conv1x1_bn.py loads through ctypes.
//
// Replaces mxnet_tpu/ops/pallas_kernels.py `conv1x1_bn_stats`
// (pl.pallas_call at :319, body `_conv1x1_bn_kernel` at :277): for x (M, Cin)
// and w (Cin, Cout), both row-major,
//   y    = x @ w                      (fp32 accumulation, stored in x's dtype)
//   mean = sum_rows(y) / M            (fp32, from the fp32 accumulator)
//   var  = max(sum_rows(y^2) / M - mean^2, 0)
// the single-pass statistics of mxnet_tpu/ops/nn.py's BatchNorm (:489-493).
//
// What bounds it on the H100: at ResNet-50's shapes (M = 6272 ... 401408,
// Cin, Cout = 64 ... 2048) the product does 2 * Cin * Cout operations per
// (Cin + Cout) * 2 bytes moved, 32 to 410 flop/byte in bf16, against the
// card's 295: the small-channel layers are bound by device memory, the wide
// ones by the tensor cores. The statistics would cost a second full read of
// y if computed apart; here they cost nothing in device memory.
//
// Design: one block per 128 x 64 (bf16, WMMA 16x16x16 tensor-core tiles,
// fp32 accumulators) or 64 x 64 (fp32, CUDA cores, 4 x 4 outputs a thread;
// no TF32) output tile, with its K loop through shared memory, single
// buffered. The epilogue stages the fp32 tile in shared memory, writes y,
// and sums each column's values and squares over the tile's valid rows.
//
// The TPU kernel carried s and ss from one grid step to the next by
// read-modify-write, which is sound only because a TPU grid runs in order.
// Blocks here run in no order, so each block writes its own partial sums to
// a (row tiles, Cout) scratch and a second small kernel reduces them in a
// fixed order, in fp64: the result has the same bits from run to run (no
// float atomics). M is never padded: rows past M are zero-filled on load,
// masked out of the statistics and never stored, and the divisor is M.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// Shared epilogue. Cs holds the block's BM x BN fp32 tile (row stride LDC)
// in shared memory; red is 2 * (NT / BN) * BN floats of shared scratch.
// Writes y and this row tile's column partials part_s / part_ss
// (row tile blockIdx.x, columns col0 ...).
template <typename T, int BM, int BN, int LDC, int NT>
__device__ __forceinline__ void store_tile_and_partials(
    const float* Cs, float* red, T* __restrict__ y, float* __restrict__ part_s,
    float* __restrict__ part_ss, int M, int N, int row0, int col0) {
  const int tid = threadIdx.x;
  for (int idx = tid; idx < BM * BN; idx += NT) {
    const int r = idx / BN, c = idx % BN;
    if (row0 + r < M && col0 + c < N)
      y[static_cast<size_t>(row0 + r) * N + col0 + c] =
          from_float<T>(Cs[r * LDC + c]);
  }
  constexpr int PARTS = NT / BN;
  const int c = tid % BN, part = tid / BN;
  const int rows = M - row0 < BM ? M - row0 : BM;
  float s = 0.f, ss = 0.f;
  for (int r = part; r < rows; r += PARTS) {
    const float v = Cs[r * LDC + c];
    s += v;
    ss = fmaf(v, v, ss);
  }
  red[part * BN + c] = s;
  red[(PARTS + part) * BN + c] = ss;
  __syncthreads();
  if (part == 0 && col0 + c < N) {
    float ts = 0.f, tss = 0.f;
#pragma unroll
    for (int p = 0; p < PARTS; ++p) {
      ts += red[p * BN + c];
      tss += red[(PARTS + p) * BN + c];
    }
    const size_t o = static_cast<size_t>(blockIdx.x) * N + col0 + c;
    part_s[o] = ts;
    part_ss[o] = tss;
  }
}

// ---- fp32: CUDA cores, 64 x 64 tile, 4 x 4 outputs per thread ----------
constexpr int S_BM = 64, S_BN = 64, S_BK = 16, S_NT = 256;

template <typename T>
__global__ void __launch_bounds__(S_NT)
conv1x1_simt_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ y, float* __restrict__ part_s,
                    float* __restrict__ part_ss, int M, int K, int N) {
  constexpr int LDC = S_BN + 1;
  __shared__ float As[S_BK][S_BM + 4];  // As[k][m]
  __shared__ float Bs[S_BK][S_BN + 4];  // Bs[k][n]
  __shared__ float Cs[S_BM * LDC];
  __shared__ float red[2 * (S_NT / S_BN) * S_BN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.x * S_BM, col0 = blockIdx.y * S_BN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += S_BK) {
#pragma unroll
    for (int i = 0; i < (S_BM * S_BK) / S_NT; ++i) {
      const int e = tid + i * S_NT, r = e / S_BK, kk = e % S_BK;
      const int gr = row0 + r, gk = k0 + kk;
      As[kk][r] = (gr < M && gk < K)
                      ? to_float(x[static_cast<size_t>(gr) * K + gk]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < (S_BK * S_BN) / S_NT; ++i) {
      const int e = tid + i * S_NT, kk = e / S_BN, c = e % S_BN;
      const int gk = k0 + kk, gc = col0 + c;
      Bs[kk][c] = (gk < K && gc < N)
                      ? to_float(w[static_cast<size_t>(gk) * N + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < S_BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      Cs[(ty * 4 + i) * LDC + tx * 4 + j] = acc[i][j];
  __syncthreads();
  store_tile_and_partials<T, S_BM, S_BN, LDC, S_NT>(
      Cs, red, y, part_s, part_ss, M, N, row0, col0);
}

// ---- bf16: tensor cores (WMMA), 128 x 64 tile, 8 warps of 32 x 32 -------
constexpr int W_BM = 128, W_BN = 64, W_BK = 32, W_NT = 256;

__global__ void __launch_bounds__(W_NT)
conv1x1_wmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    bf16* __restrict__ y, float* __restrict__ part_s,
                    float* __restrict__ part_ss, int M, int K, int N) {
  using namespace nvcuda;
  constexpr int LDA = W_BK + 8;  // bf16 elements; rows stay 32-byte aligned
  constexpr int LDB = W_BN + 8;
  constexpr int LDC = W_BN + 4;  // floats
  constexpr int TILE_BYTES = (W_BM * LDA + W_BK * LDB) * 2;
  constexpr int STAGE_BYTES = W_BM * LDC * 4;
  // the x and w tiles, and after the K loop the fp32 tile in the same bytes
  __shared__ __align__(128)
      unsigned char smem[TILE_BYTES > STAGE_BYTES ? TILE_BYTES : STAGE_BYTES];
  __shared__ float red[2 * (W_NT / W_BN) * W_BN];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + W_BM * LDA;
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;  // 4 x 2 warps
  const int row0 = blockIdx.x * W_BM, col0 = blockIdx.y * W_BN;
  // 16-byte loads when every 8-element group starts 16-byte aligned
  const bool vec = K % 8 == 0 && N % 8 == 0 &&
                   (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  const bf16 zero = __float2bfloat16_rn(0.f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += W_BK) {
    // x tile: 128 rows x 32 columns, 8 elements per group, 2 groups a thread
#pragma unroll
    for (int i = 0; i < (W_BM * W_BK / 8) / W_NT; ++i) {
      const int grp = tid + i * W_NT, r = grp / (W_BK / 8);
      const int kc = (grp % (W_BK / 8)) * 8;
      const int gr = row0 + r, gk = k0 + kc;
      bf16* dst = &As[r * LDA + kc];
      const bf16* src = x + static_cast<size_t>(gr) * K + gk;
      if (vec && gr < M && gk + 8 <= K) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (gr < M && gk + e < K) ? src[e] : zero;
      }
    }
    // w tile: 32 rows x 64 columns, one group a thread
    {
      const int kk = tid / (W_BN / 8), c = (tid % (W_BN / 8)) * 8;
      const int gk = k0 + kk, gc = col0 + c;
      bf16* dst = &Bs[kk * LDB + c];
      const bf16* src = w + static_cast<size_t>(gk) * N + gc;
      if (vec && gk < K && gc + 8 <= N) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (gk < K && gc + e < N) ? src[e] : zero;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < W_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[(wm * 32 + i * 16) * LDA + kk],
                               LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Bs[kk * LDB + wn * 32 + j * 16],
                               LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  // the tiles are dead: stage the fp32 accumulators in the same memory
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(
          &Cs[(wm * 32 + i * 16) * LDC + wn * 32 + j * 16], acc[i][j], LDC,
          wmma::mem_row_major);
  __syncthreads();
  store_tile_and_partials<bf16, W_BM, W_BN, LDC, W_NT>(
      Cs, red, y, part_s, part_ss, M, N, row0, col0);
}

// ---- the fixed-order reduction of the partials -------------------------
// 32 columns a block; 32 lanes of row tiles per column, each summing a
// strided share in fp64, then lane 0 adds the 32 shares in order.
__global__ void __launch_bounds__(1024)
bn_stats_finalize_kernel(const float* __restrict__ part_s,
                         const float* __restrict__ part_ss,
                         float* __restrict__ mean, float* __restrict__ var,
                         int tiles, int M, int N) {
  __shared__ double rs[32][33], rss[32][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  double s = 0.0, ss = 0.0;
  if (c < N) {
    for (int t = threadIdx.y; t < tiles; t += 32) {
      s += part_s[static_cast<size_t>(t) * N + c];
      ss += part_ss[static_cast<size_t>(t) * N + c];
    }
  }
  rs[threadIdx.y][threadIdx.x] = s;
  rss[threadIdx.y][threadIdx.x] = ss;
  __syncthreads();
  if (threadIdx.y == 0 && c < N) {
    double ts = 0.0, tss = 0.0;
    for (int p = 0; p < 32; ++p) {
      ts += rs[p][threadIdx.x];
      tss += rss[p][threadIdx.x];
    }
    const double mu = ts / M;
    mean[c] = static_cast<float>(mu);
    var[c] = static_cast<float>(fmax(tss / M - mu * mu, 0.0));
  }
}

}  // namespace

// Rows of x per block for `dtype` (0 = float32, 1 = bfloat16): the
// partials scratch holds ceil(M / rows) x N floats, twice.
extern "C" int mxtpu_conv1x1_bn_rows_per_tile(int dtype) {
  return dtype == 1 ? W_BM : S_BM;
}

// x (M, K), w (K, N), y (M, N): contiguous row-major, of one dtype
// (0 = float32, 1 = bfloat16); part_s, part_ss: float32 scratch of
// ceil(M / rows_per_tile) x N; mean, var: float32 (N,). Two launches on
// `stream`; returns the first cudaError_t, or 0.
extern "C" int mxtpu_conv1x1_bn_stats(const void* x, const void* w, void* y,
                                      void* part_s, void* part_ss, void* mean,
                                      void* var, int M, int K, int N,
                                      int dtype, void* stream) {
  if (M < 1 || K < 1 || N < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ps = static_cast<float*>(part_s);
  float* pss = static_cast<float*>(part_ss);
  int tiles;
  if (dtype == 0) {
    tiles = (M + S_BM - 1) / S_BM;
    const dim3 grid(tiles, (N + S_BN - 1) / S_BN);
    conv1x1_simt_kernel<float><<<grid, S_NT, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(y), ps, pss, M, K, N);
  } else if (dtype == 1) {
    tiles = (M + W_BM - 1) / W_BM;
    const dim3 grid(tiles, (N + W_BN - 1) / W_BN);
    conv1x1_wmma_kernel<<<grid, W_NT, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w),
        static_cast<bf16*>(y), ps, pss, M, K, N);
  } else {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bn_stats_finalize_kernel<<<(N + 31) / 32, dim3(32, 32), 0, s>>>(
      ps, pss, static_cast<float*>(mean), static_cast<float*>(var), tiles, M,
      N);
  return cudaGetLastError();
}
