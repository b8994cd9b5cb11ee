// Row LayerNorm over the last axis for Hopper (sm_90a), with a plain C
// interface that mxnet_tpu_torch/ops/layer_norm.py loads through ctypes.
//
// Replaces mxnet_tpu/ops/pallas_kernels.py `pallas_layer_norm`
// (pl.pallas_call at :184, body `_ln_kernel` at :163): per row, the fp32
// mean, then var = mean((x - mean)^2) (two passes, never E[x^2] - E[x]^2),
// y = (x - mean) * rsqrt(var + eps) * gamma + beta, cast to x's dtype.
//
// What bounds it on the H100: it does a handful of operations per element,
// so it is bound by device memory (each x read once, each y written once,
// gamma and beta once), and at the decode shapes (8 x 768) by the launch.
//
// Design: one warp per row, WARPS = 4 rows per block, so (1024, 768)
// launches 256 blocks on 132 SMs. The TPU kernel padded rows up to its
// block; here a warp past the last row exits.
// - Register-resident rows (N > 0): where D * elem is a multiple of 16 and
//   every pointer is 16-byte aligned, each lane loads its N 16-byte vectors
//   of the row (4 fp32 or 8 bf16 each) once, all loads issued before the
//   first reduction. The mean and then the centred sum of squares are
//   reduced from those registers with warp shuffles; gamma and beta are
//   read with the same width, and y is stored with 16-byte writes. N goes
//   up to 16, so D up to 2048 fp32 (4096 bf16) stays in registers.
// - Otherwise (N = 0: a larger D, or rows that are not 16-byte aligned),
//   the same kernel strides over the row with scalar loads and reads it
//   three times (sum, centred squares, output); the second and third reads
//   hit L1.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int WARPS = 4;  // rows per block

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// 16 bytes <-> 4 fp32 or 8 bf16 widened to fp32
__device__ __forceinline__ void load_vec(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ void store_vec(float* p, const float (&f)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&f)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// N > 0: each lane keeps N 16-byte vectors of its row in registers (vector
// i of the lane is vector lane + 32 i of the row); N = 0: scalar loop.
template <typename T, int N>
__global__ void __launch_bounds__(WARPS * 32)
layer_norm_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                  const T* __restrict__ beta, T* __restrict__ y, int rows,
                  int dim, float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= rows) return;
  const T* xr = x + static_cast<size_t>(row) * dim;
  T* yr = y + static_cast<size_t>(row) * dim;

  if constexpr (N > 0) {
    constexpr int EPV = 16 / sizeof(T);
    const int nvec = dim / EPV;
    float xv[N][EPV];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int vi = lane + 32 * i;
      if (vi < nvec) {
        load_vec(xr + vi * EPV, xv[i]);
      } else {
#pragma unroll
        for (int e = 0; e < EPV; ++e) xv[i][e] = 0.f;
      }
    }
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int e = 0; e < EPV; ++e) sum += xv[i][e];
    const float mean = warp_sum(sum) / dim;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (lane + 32 * i < nvec) {
#pragma unroll
        for (int e = 0; e < EPV; ++e) {
          const float c = xv[i][e] - mean;
          sq = fmaf(c, c, sq);
        }
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) / dim + eps);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int vi = lane + 32 * i;
      if (vi < nvec) {
        float gv[EPV], bv[EPV], out[EPV];
        load_vec(gamma + vi * EPV, gv);
        load_vec(beta + vi * EPV, bv);
#pragma unroll
        for (int e = 0; e < EPV; ++e)
          out[e] = fmaf((xv[i][e] - mean) * rstd, gv[e], bv[e]);
        store_vec(yr + vi * EPV, out);
      }
    }
  } else {
    float sum = 0.f;
    for (int i = lane; i < dim; i += 32) sum += to_float(xr[i]);
    const float mean = warp_sum(sum) / dim;
    float sq = 0.f;
    for (int i = lane; i < dim; i += 32) {
      const float c = to_float(xr[i]) - mean;
      sq = fmaf(c, c, sq);
    }
    const float rstd = rsqrtf(warp_sum(sq) / dim + eps);
    for (int i = lane; i < dim; i += 32) {
      const float c = (to_float(xr[i]) - mean) * rstd;
      store(yr + i, fmaf(c, to_float(gamma[i]), to_float(beta[i])));
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* gamma, const void* beta,
                   void* y, int rows, int dim, float eps,
                   cudaStream_t stream) {
  constexpr int EPV = 16 / sizeof(T);
  const bool aligned =
      dim % EPV == 0 &&
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(gamma) |
        reinterpret_cast<uintptr_t>(beta) | reinterpret_cast<uintptr_t>(y)) &
       15) == 0;
  const int per_lane = (dim / EPV + 31) / 32;  // vectors per lane
  const int blocks = (rows + WARPS - 1) / WARPS;
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(gamma);
  const T* bp = static_cast<const T*>(beta);
  T* yp = static_cast<T*>(y);
#define MXTPU_LN(NV)                                                       \
  layer_norm_kernel<T, NV><<<blocks, WARPS * 32, 0, stream>>>(xp, gp, bp, \
                                                             yp, rows, dim, \
                                                             eps)
  if (!aligned || per_lane > 16)
    MXTPU_LN(0);
  else if (per_lane <= 1)
    MXTPU_LN(1);
  else if (per_lane <= 2)
    MXTPU_LN(2);
  else if (per_lane <= 3)
    MXTPU_LN(3);
  else if (per_lane <= 4)
    MXTPU_LN(4);
  else if (per_lane <= 6)
    MXTPU_LN(6);
  else if (per_lane <= 8)
    MXTPU_LN(8);
  else if (per_lane <= 12)
    MXTPU_LN(12);
  else
    MXTPU_LN(16);
#undef MXTPU_LN
  return cudaGetLastError();
}

}  // namespace

// x, y: contiguous (rows, dim); gamma, beta: (dim,), all of one dtype:
// 0 = float32, 1 = bfloat16; device = the CUDA device of the tensors.
// Launches on `stream` and returns the cudaError_t of the launch.
extern "C" int mxtpu_layer_norm(const void* x, const void* gamma,
                                const void* beta, void* y, int rows,
                                int dim, int dtype, float eps, int device,
                                void* stream) {
  if (rows < 1 || dim < 1) return cudaErrorInvalidValue;
  mxtpu::DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return scope.error();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, gamma, beta, y, rows, dim, eps, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, gamma, beta, y, rows, dim, eps, s);
  return cudaErrorInvalidValue;
}
