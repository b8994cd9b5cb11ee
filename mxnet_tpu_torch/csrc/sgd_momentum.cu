// Multi-tensor momentum-SGD update for Hopper (sm_90a), with a plain C
// interface that mxnet_tpu_torch/ops/sgd_momentum.py loads through ctypes.
//
// Replaces mxnet_tpu/ops/pallas_kernels.py `fused_sgd_momentum`
// (pl.pallas_call at :259, body `_sgd_mom_kernel` at :216), per element:
//   m' = momentum * m + (rescale * g + wd * w)
//   w' = w - lr * cast<w dtype>(m')
// accumulated in fp32 (the promoted dtype of fp32 m and fp32/bf16 w, g),
// each output cast back to its input's dtype. Both are updated in place:
// the trainer owns w and m, where the JAX step donates them.
//
// What bounds it on the H100: 3 reads and 2 writes per element and about 6
// operations, so device memory (5 x 4 bytes per fp32 element: ResNet-50's
// 25.6M parameters move 0.51 GB, 153 us at 3.35 TB/s). At one launch per
// tensor, ResNet-50's 161 tensors would also pay ~161 launch latencies.
//
// Design: ONE launch for every tensor of a step. The wrapper uploads a
// table of (w, g, m, n, first chunk) per tensor; the tensors are cut into
// chunks of CHUNK elements and the grid walks the chunks in a grid-stride
// loop, each block finding its chunk's tensor by binary search over the
// table's first-chunk column. Inside a chunk each thread handles UNROLL
// elements at a stride of the block size (coalesced), loading all of them
// before it computes so that several loads are in flight per thread. The
// Pallas padding to (rows, 128) lanes is a TPU layout artifact and is not
// carried over: a chunk's tail is masked.
//
// Route: CUDA C++ rather than Triton, because one launch over ~160 tensors
// needs the pointer table, which a plain C pointer gives directly.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;
constexpr int64_t CHUNK = THREADS * UNROLL * 4;  // elements per chunk
constexpr int COLS = 5;  // table row: w, g, m, n, first chunk

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// T: dtype of w and g; m is fp32.
template <typename T>
__global__ void __launch_bounds__(THREADS)
sgd_momentum_kernel(const int64_t* __restrict__ table, int ntensors,
                    int64_t nchunks, float lr, float momentum, float wd,
                    float rescale) {
  for (int64_t chunk = blockIdx.x; chunk < nchunks; chunk += gridDim.x) {
    // the last tensor whose first chunk is <= chunk
    int lo = 0, hi = ntensors - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (table[mid * COLS + 4] <= chunk) lo = mid; else hi = mid - 1;
    }
    const int64_t* row = table + lo * COLS;
    T* __restrict__ w = reinterpret_cast<T*>(row[0]);
    const T* __restrict__ g = reinterpret_cast<const T*>(row[1]);
    float* __restrict__ m = reinterpret_cast<float*>(row[2]);
    const int64_t n = row[3];
    const int64_t begin = (chunk - row[4]) * CHUNK;
    const int64_t end = begin + CHUNK < n ? begin + CHUNK : n;
    for (int64_t base = begin + threadIdx.x; base < end;
         base += THREADS * UNROLL) {
      float wv[UNROLL], gv[UNROLL], mv[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int64_t i = base + u * THREADS;
        if (i < end) {
          wv[u] = to_float(w[i]);
          gv[u] = to_float(g[i]);
          mv[u] = m[i];
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int64_t i = base + u * THREADS;
        if (i < end) {
          const float gg = gv[u] * rescale + wd * wv[u];
          const float mm = momentum * mv[u] + gg;
          m[i] = mm;
          w[i] = from_float<T>(wv[u] - lr * to_float(from_float<T>(mm)));
        }
      }
    }
  }
}

}  // namespace

// table: device pointer to ntensors rows of 5 int64 (w, g, m pointers, the
// element count n, the index of the tensor's first chunk), rows ordered by
// first chunk; nchunks: the total number of chunks. dtype is w's and g's:
// 0 = float32, 1 = bfloat16; m is float32; device: the tensors' CUDA
// device. Returns the cudaError_t of the launch.
extern "C" int mxtpu_sgd_momentum(const void* table, int ntensors,
                                  long long nchunks, int dtype, float lr,
                                  float momentum, float wd, float rescale,
                                  int device, void* stream) {
  if (ntensors < 1 || nchunks < 1) return cudaErrorInvalidValue;
  mxtpu::DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return scope.error();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t cap = 132 * 8;  // 8 blocks of 256 threads per SM
  const int blocks = static_cast<int>(nchunks < cap ? nchunks : cap);
  const int64_t* t = static_cast<const int64_t*>(table);
  if (dtype == 0)
    sgd_momentum_kernel<float><<<blocks, THREADS, 0, s>>>(
        t, ntensors, nchunks, lr, momentum, wd, rescale);
  else if (dtype == 1)
    sgd_momentum_kernel<__nv_bfloat16><<<blocks, THREADS, 0, s>>>(
        t, ntensors, nchunks, lr, momentum, wd, rescale);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

extern "C" long long mxtpu_sgd_momentum_chunk() { return CHUNK; }
