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
// And the host: a train step calls it once, and a call that rebuilds and
// uploads a table of every tensor spends longer on the host than the update
// takes on the device.
//
// Design: ONE launch for every tensor of a step (up to MAX_TENSORS; a plan
// with more splits into launches of that many). The parameters and momenta
// never change between steps, so their table, (w, m, n, first chunk) per
// tensor, is uploaded once, when the wrapper builds its update plan. Only the
// gradients are new each step: their pointers travel by value in the
// launch's parameters (480 pointers, 3840 bytes: the parameters stay under
// the 4 KB every toolkit takes), read from the constant bank. The tensors
// are cut into chunks of CHUNK elements and the grid walks the chunks in a
// grid-stride loop, each block finding its chunk's tensor by binary search
// over the table's first-chunk column. A whole chunk of 16-byte aligned
// tensors (every chunk but a tensor's last, as the allocator aligns them)
// moves 4 elements an access: 16-byte loads and stores of fp32, 8-byte of
// bf16. Otherwise each thread handles UNROLL elements at a stride of the
// block size (coalesced). Either way a thread loads all of its elements
// before it computes, so that several loads are in flight.
// The Pallas padding to (rows, 128) lanes is a TPU layout artifact and is
// not carried over: a chunk's tail is masked.
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
constexpr int COLS = 4;  // table row: w, m, n, first chunk
constexpr int MAX_TENSORS = 480;

struct GradPointers {
  const void* g[MAX_TENSORS];
};

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

// 4 consecutive elements of T as floats, in one 16-byte (fp32) or 8-byte
// (bf16) access; p aligned to 4 elements
template <typename T>
struct Vec4;
template <>
struct Vec4<float> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Vec4<__nv_bfloat16> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&v)[4]) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&v)[4]) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 q;
    q.x = *reinterpret_cast<const uint32_t*>(&a);
    q.y = *reinterpret_cast<const uint32_t*>(&b);
    *reinterpret_cast<uint2*>(p) = q;
  }
};

// m' of one element
__device__ __forceinline__ float sgd_m(float w, float g, float m,
                                       float momentum, float wd,
                                       float rescale) {
  return momentum * m + (g * rescale + wd * w);
}

// T: dtype of w and g; m is fp32. grads.g[i] is tensor i's gradient.
template <typename T>
__global__ void __launch_bounds__(THREADS)
sgd_momentum_kernel(const int64_t* __restrict__ table,
                    const __grid_constant__ GradPointers grads, int ntensors,
                    int64_t nchunks, float lr, float momentum, float wd,
                    float rescale) {
  for (int64_t chunk = blockIdx.x; chunk < nchunks; chunk += gridDim.x) {
    // the last tensor whose first chunk is <= chunk
    int lo = 0, hi = ntensors - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (table[mid * COLS + 3] <= chunk) lo = mid; else hi = mid - 1;
    }
    const int64_t* row = table + lo * COLS;
    T* __restrict__ w = reinterpret_cast<T*>(row[0]);
    float* __restrict__ m = reinterpret_cast<float*>(row[1]);
    const T* __restrict__ g = static_cast<const T*>(grads.g[lo]);
    const int64_t n = row[2];
    const int64_t begin = (chunk - row[3]) * CHUNK;
    const int64_t end = begin + CHUNK < n ? begin + CHUNK : n;
    // a whole chunk of aligned tensors: 4 elements an access
    if (end - begin == CHUNK &&
        (reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(g)) %
                (4 * sizeof(T)) == 0 &&
        reinterpret_cast<uintptr_t>(m) % 16 == 0) {
      constexpr int PER = CHUNK / 4 / THREADS;
      float wv[PER][4], gv[PER][4], mv[PER][4];
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const int64_t i = begin + 4 * (threadIdx.x + u * THREADS);
        Vec4<T>::load(w + i, wv[u]);
        Vec4<T>::load(g + i, gv[u]);
        Vec4<float>::load(m + i, mv[u]);
      }
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const int64_t i = begin + 4 * (threadIdx.x + u * THREADS);
        float wn[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          mv[u][e] = sgd_m(wv[u][e], gv[u][e], mv[u][e], momentum, wd,
                           rescale);
          wn[e] = wv[u][e] - lr * to_float(from_float<T>(mv[u][e]));
        }
        Vec4<float>::store(m + i, mv[u]);
        Vec4<T>::store(w + i, wn);
      }
      continue;
    }
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
          const float mm = sgd_m(wv[u], gv[u], mv[u], momentum, wd, rescale);
          m[i] = mm;
          w[i] = from_float<T>(wv[u] - lr * to_float(from_float<T>(mm)));
        }
      }
    }
  }
}

}  // namespace

// table: device pointer to ntensors rows of 4 int64 (w and m pointers, the
// element count n, the index of the tensor's first chunk), rows ordered by
// first chunk; grads: host array of the ntensors gradient pointers (<=
// mxtpu_sgd_momentum_max_tensors()), in table order; nchunks: the total
// number of chunks. dtype is w's and g's: 0 = float32, 1 = bfloat16; m is
// float32; device: the tensors' CUDA device. Returns the cudaError_t of the
// launch.
extern "C" int mxtpu_sgd_momentum(const void* table, const void* const* grads,
                                  int ntensors, long long nchunks, int dtype,
                                  float lr, float momentum, float wd,
                                  float rescale, int device, void* stream) {
  if (ntensors < 1 || ntensors > MAX_TENSORS || nchunks < 1)
    return cudaErrorInvalidValue;
  mxtpu::DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return scope.error();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GradPointers gp;
  for (int i = 0; i < ntensors; ++i) gp.g[i] = grads[i];
  const int64_t cap = 132 * 8;  // 8 blocks of 256 threads per SM
  const int blocks = static_cast<int>(nchunks < cap ? nchunks : cap);
  const int64_t* t = static_cast<const int64_t*>(table);
  if (dtype == 0)
    sgd_momentum_kernel<float><<<blocks, THREADS, 0, s>>>(
        t, gp, ntensors, nchunks, lr, momentum, wd, rescale);
  else if (dtype == 1)
    sgd_momentum_kernel<__nv_bfloat16><<<blocks, THREADS, 0, s>>>(
        t, gp, ntensors, nchunks, lr, momentum, wd, rescale);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

extern "C" long long mxtpu_sgd_momentum_chunk() { return CHUNK; }

extern "C" int mxtpu_sgd_momentum_max_tensors() { return MAX_TENSORS; }
