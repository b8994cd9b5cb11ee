// Row LayerNorm over the last axis for Hopper (sm_90a), with a plain C
// interface that mxnet_tpu_torch/ops/layer_norm.py loads through ctypes.
//
// Replaces mxnet_tpu/ops/pallas_kernels.py `pallas_layer_norm`
// (pl.pallas_call at :184, body `_ln_kernel` at :163): per row, the fp32
// mean, then var = mean((x - mean)^2) (two passes, never E[x^2] - E[x]^2),
// y = (x - mean) * rsqrt(var + eps) * gamma + beta, cast to x's dtype.
//
// What bounds it on the H100: it does a handful of operations per element,
// so it is bound by device memory (each x read once, each y written once),
// and at the decode shapes (8 x 768, 1024 x 768) by launch latency.
//
// Design: one warp per row, WARPS rows per block, no shared memory. Each lane
// strides over the row; the sum and the centred sum of squares are reduced
// with warp shuffles. The row is read three times (sum, centred squares,
// output), and the second and third reads hit L1, so device memory sees one
// read. The TPU kernel padded rows up to its block; here a warp past the last
// row simply exits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;  // rows per block

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
layer_norm_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                  const T* __restrict__ beta, T* __restrict__ y, int rows,
                  int dim, float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= rows) return;
  const T* xr = x + static_cast<size_t>(row) * dim;
  T* yr = y + static_cast<size_t>(row) * dim;

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

template <typename T>
cudaError_t launch(const void* x, const void* gamma, const void* beta,
                   void* y, int rows, int dim, float eps,
                   cudaStream_t stream) {
  const int blocks = (rows + WARPS - 1) / WARPS;
  layer_norm_kernel<T><<<blocks, WARPS * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma),
      static_cast<const T*>(beta), static_cast<T*>(y), rows, dim, eps);
  return cudaGetLastError();
}

}  // namespace

// x, y: contiguous (rows, dim); gamma, beta: (dim,), all of one dtype:
// 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int mxtpu_layer_norm(const void* x, const void* gamma,
                                const void* beta, void* y, int rows,
                                int dim, int dtype, float eps,
                                void* stream) {
  if (rows < 1 || dim < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, gamma, beta, y, rows, dim, eps, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, gamma, beta, y, rows, dim, eps, s);
  return cudaErrorInvalidValue;
}
