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
// A second form, MXNet's `sgd_mom_update` / `mp_sgd_mom_update` (the
// update of Gluon's SGD, mxnet_tpu/optimizer.py `_prep` :226 and
// `_sgd_math` :241, fused as parallel/fused_update.py `_sgd_fused` :101),
// per element in fp32, each product and sum rounded on its own as the
// reference's separate operations round them:
//   g~ = rescale * g;  clip >= 0: g~ = clamp(g~, -clip, clip)
//   wd != 0: g~ = g~ + wd * w
//   momentum:    v' = momentum * v - lr * g~;  w' = w + v'
//   no momentum: w' = w - lr * g~               (no v read or written)
// w and v are of g's dtype, or, in multi-precision, w is the fp32 master
// and v fp32, g is bf16, and the bf16 weight is written as bf16(w') in the
// same pass. The two forms agree only while lr is constant and nothing is
// clipped: a scheduler's new lr reaches MXNet's velocity one step later.
// A device flag (the numerics guard's verdict that every gradient is
// finite) can veto the whole launch: every block reads it first and
// writes nothing when it is 0.
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
// The two forms are one kernel, `sgd_momentum_kernel<Form>`: the chunk walk,
// the table lookup and the loads and stores are shared, and a form supplies
// its dtypes and its per-element step (`MomentumForm<T>`, `MXNetForm<T, MP>`).
// Both read 3 and write 2 tensors an element, and multi-precision writes the
// bf16 weight too: 20 bytes an fp32 element, 20 a multi-precision one (4 +
// 4 + 2 read, 4 + 4 + 2 written).
//
// Route: CUDA C++ rather than Triton, because one launch over ~160 tensors
// needs the pointer table, which a plain C pointer gives directly.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;
constexpr int64_t CHUNK = THREADS * UNROLL * 4;  // elements per chunk
// table row: w, m, n, first chunk, and the bf16 weight of MXNet's
// multi-precision form (0 otherwise)
constexpr int COLS = 5;
constexpr int MAX_TENSORS = 480;

struct GradPointers {
  const void* g[MAX_TENSORS];
};

// a launch's hyper-parameters; clip (< 0: none) and has_mom are MXNet's
struct Hyper {
  float lr, momentum, wd, rescale, clip;
  bool has_mom;
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

// A form gives the kernel G, the gradient's dtype; W and V, the dtypes of
// the table's w and state columns; MP, whether the row's fifth column is a
// G weight to write as G(w'); and step, w' of one element with the state
// updated in place.

// The Pallas kernel's form: w and g of T, m fp32.
template <typename T>
struct MomentumForm {
  using G = T;
  using W = T;
  using V = float;
  static constexpr bool MP = false;
  static __device__ __forceinline__ bool has_state(const Hyper&) {
    return true;
  }
  static __device__ __forceinline__ float step(float w, float g, float& m,
                                               const Hyper& h) {
    m = h.momentum * m + (g * h.rescale + h.wd * w);
    return w - h.lr * to_float(from_float<T>(m));
  }
};

// MXNet's form: g of T; with MP, w is the fp32 master and v fp32 and the
// T weight is written too, otherwise w and v are T. Products and sums are
// rounded one at a time (__fmul_rn / __fadd_rn are never contracted into
// an FMA), and the clamp keeps a NaN a NaN, as jnp.clip and torch.clamp do.
template <typename T, bool MP_>
struct MXNetForm {
  using G = T;
  using W = typename std::conditional<MP_, float, T>::type;
  using V = W;
  static constexpr bool MP = MP_;
  static __device__ __forceinline__ bool has_state(const Hyper& h) {
    return h.has_mom;
  }
  static __device__ __forceinline__ float step(float w, float g, float& v,
                                               const Hyper& h) {
    float r = __fmul_rn(g, h.rescale);
    if (h.clip >= 0.f) r = r < -h.clip ? -h.clip : (r > h.clip ? h.clip : r);
    if (h.wd != 0.f) r = __fadd_rn(r, __fmul_rn(h.wd, w));
    if (h.has_mom) {
      v = __fsub_rn(__fmul_rn(h.momentum, v), __fmul_rn(h.lr, r));
      return __fadd_rn(w, v);
    }
    return __fsub_rn(w, __fmul_rn(h.lr, r));
  }
};

// the chunk's tensor: the last one whose first chunk is <= chunk
__device__ __forceinline__ int tensor_of(const int64_t* __restrict__ table,
                                         int ntensors, int64_t chunk) {
  int lo = 0, hi = ntensors - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (table[mid * COLS + 3] <= chunk) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// grads.g[i] is tensor i's gradient. ok: a device flag; the launch writes
// nothing when it is false (null: always update).
template <typename Form>
__global__ void __launch_bounds__(THREADS)
sgd_momentum_kernel(const int64_t* __restrict__ table,
                    const __grid_constant__ GradPointers grads, int ntensors,
                    int64_t nchunks, const Hyper h,
                    const bool* __restrict__ ok) {
  using T = typename Form::G;
  using W = typename Form::W;
  using V = typename Form::V;
  if (ok != nullptr && !*ok) return;
  const bool state = Form::has_state(h);
  for (int64_t chunk = blockIdx.x; chunk < nchunks; chunk += gridDim.x) {
    const int t = tensor_of(table, ntensors, chunk);
    const int64_t* row = table + t * COLS;
    W* __restrict__ w = reinterpret_cast<W*>(row[0]);
    V* __restrict__ v = reinterpret_cast<V*>(row[1]);
    T* __restrict__ lp = reinterpret_cast<T*>(row[4]);
    const T* __restrict__ g = static_cast<const T*>(grads.g[t]);
    const int64_t n = row[2];
    const int64_t begin = (chunk - row[3]) * CHUNK;
    const int64_t end = begin + CHUNK < n ? begin + CHUNK : n;
    // a whole chunk of aligned tensors: 4 elements an access (an absent v
    // or lp is 0, which is aligned)
    if (end - begin == CHUNK &&
        reinterpret_cast<uintptr_t>(w) % (4 * sizeof(W)) == 0 &&
        reinterpret_cast<uintptr_t>(v) % (4 * sizeof(V)) == 0 &&
        (reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(lp)) %
                (4 * sizeof(T)) == 0) {
      constexpr int PER = CHUNK / 4 / THREADS;
      float wv[PER][4], gv[PER][4], vv[PER][4] = {};
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const int64_t i = begin + 4 * (threadIdx.x + u * THREADS);
        Vec4<W>::load(w + i, wv[u]);
        Vec4<T>::load(g + i, gv[u]);
        if (state) Vec4<V>::load(v + i, vv[u]);
      }
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const int64_t i = begin + 4 * (threadIdx.x + u * THREADS);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          wv[u][e] = Form::step(wv[u][e], gv[u][e], vv[u][e], h);
        if (state) Vec4<V>::store(v + i, vv[u]);
        Vec4<W>::store(w + i, wv[u]);
        if constexpr (Form::MP) Vec4<T>::store(lp + i, wv[u]);
      }
      continue;
    }
    for (int64_t base = begin + threadIdx.x; base < end;
         base += THREADS * UNROLL) {
      float wv[UNROLL], gv[UNROLL], vv[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int64_t i = base + u * THREADS;
        if (i < end) {
          wv[u] = to_float(w[i]);
          gv[u] = to_float(g[i]);
          vv[u] = state ? to_float(v[i]) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int64_t i = base + u * THREADS;
        if (i < end) {
          const float wn = Form::step(wv[u], gv[u], vv[u], h);
          if (state) v[i] = from_float<V>(vv[u]);
          w[i] = from_float<W>(wn);
          if constexpr (Form::MP) lp[i] = from_float<T>(wn);
        }
      }
    }
  }
}

// the launch both C entry points make: the gradient pointers by value, at
// most 8 blocks of 256 threads per SM (132 SMs) walking the chunks
template <typename Form>
int launch(const void* table, const void* const* grads, int ntensors,
           long long nchunks, const Hyper& h, const void* ok, int device,
           void* stream) {
  if (ntensors < 1 || ntensors > MAX_TENSORS || nchunks < 1)
    return cudaErrorInvalidValue;
  mxtpu::DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return scope.error();
  GradPointers gp;
  for (int i = 0; i < ntensors; ++i) gp.g[i] = grads[i];
  const int64_t cap = 132 * 8;
  const int blocks = static_cast<int>(nchunks < cap ? nchunks : cap);
  sgd_momentum_kernel<Form>
      <<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int64_t*>(table), gp, ntensors, nchunks, h,
          static_cast<const bool*>(ok));
  return cudaGetLastError();
}

}  // namespace

// table: device pointer to ntensors rows of 5 int64 (w and m pointers, the
// element count n, the index of the tensor's first chunk, 0), rows ordered
// by first chunk; grads: host array of the ntensors gradient pointers (<=
// mxtpu_sgd_momentum_max_tensors()), in table order; nchunks: the total
// number of chunks. dtype is w's and g's: 0 = float32, 1 = bfloat16; m is
// float32; device: the tensors' CUDA device. Returns the cudaError_t of the
// launch.
extern "C" int mxtpu_sgd_momentum(const void* table, const void* const* grads,
                                  int ntensors, long long nchunks, int dtype,
                                  float lr, float momentum, float wd,
                                  float rescale, int device, void* stream) {
  const Hyper h{lr, momentum, wd, rescale, -1.f, true};
  if (dtype == 0)
    return launch<MomentumForm<float>>(table, grads, ntensors, nchunks, h,
                                       nullptr, device, stream);
  if (dtype == 1)
    return launch<MomentumForm<__nv_bfloat16>>(table, grads, ntensors,
                                               nchunks, h, nullptr, device,
                                               stream);
  return cudaErrorInvalidValue;
}

// MXNet's form. table: as above, with w the fp32 master and column 5 the
// bf16 weight when mp, else 0, and m the velocity v (0 when has_mom is 0);
// dtype is g's (and, without mp, w's and v's): 0 = float32, 1 = bfloat16;
// mp = 1 only with dtype 1. clip < 0: no clipping. ok: a device bool, the
// launch writes nothing when it is false; null: always update.
extern "C" int mxtpu_sgd_mxnet(const void* table, const void* const* grads,
                               int ntensors, long long nchunks, int dtype,
                               int mp, float lr, float momentum, float wd,
                               float rescale, float clip, int has_mom,
                               const void* ok, int device, void* stream) {
  const Hyper h{lr, momentum, wd, rescale, clip, has_mom != 0};
  if (dtype == 0 && !mp)
    return launch<MXNetForm<float, false>>(table, grads, ntensors, nchunks,
                                           h, ok, device, stream);
  if (dtype == 1 && !mp)
    return launch<MXNetForm<__nv_bfloat16, false>>(
        table, grads, ntensors, nchunks, h, ok, device, stream);
  if (dtype == 1 && mp)
    return launch<MXNetForm<__nv_bfloat16, true>>(
        table, grads, ntensors, nchunks, h, ok, device, stream);
  return cudaErrorInvalidValue;
}

extern "C" long long mxtpu_sgd_momentum_chunk() { return CHUNK; }

extern "C" int mxtpu_sgd_momentum_max_tensors() { return MAX_TENSORS; }
