// 1x1 convolution as a GEMM with the BatchNorm batch statistics in its
// epilogue, for Hopper (sm_90a), with a plain C interface that
// mxnet_tpu_torch/ops/conv1x1_bn.py loads through ctypes.
//
// Replaces mxnet_tpu/ops/pallas_kernels.py `conv1x1_bn_stats`
// (pl.pallas_call at :319, body `_conv1x1_bn_kernel` at :277): for x (M, Cin)
// and w (Cin, Cout),
//   y    = x @ w                      (fp32 accumulation, stored in x's dtype)
//   mean = sum_rows(y) / M            (fp32, from the fp32 accumulator)
//   var  = max(sum_rows(y^2) / M - mean^2, 0)
// the single-pass statistics of mxnet_tpu/ops/nn.py's BatchNorm (:489-493).
// x is row-major; w is row-major (Cin, Cout) or the transpose of a row-major
// (Cout, Cin), the layout a conv weight (Cout, Cin, 1, 1) has, so the caller
// passes the weight as it lies and nothing copies it.
//
// What bounds it on the H100: at ResNet-50's shapes (M = 6272 ... 401408,
// Cin, Cout = 64 ... 2048) the product does 2 * Cin * Cout operations per
// (Cin + Cout) * 2 bytes moved, 32 to 410 flop/byte in bf16, against the
// card's 295. Stage 1 (M = 401408, Cin + Cout <= 320) is bound by device
// memory, with a K loop of 1-4 steps of 64; stages 3-4 (M <= 25088, Cin up
// to 2048) sit near or above the ridge, where the tensor-core rate counts.
// The statistics would cost a second full read of y if computed apart; here
// they cost nothing in device memory.
//
// Paths (the wrapper chooses; each is checked against the plain version on
// the card by chip_smoke.py):
// - bf16, K and N multiples of 8, 16-byte aligned pointers: the main path,
//   `conv1x1_wgmma_kernel`, below.
// - bf16 shapes TMA cannot take: `conv1x1_wmma_kernel`, WMMA 16x16x16
//   tensor-core tiles of 128 x 64 through a single-buffered shared tile.
// - fp32: `conv1x1_simt_kernel`, 64 x 64 tiles on the CUDA cores, 4 x 4
//   outputs a thread, no TF32 (ResNet training runs bf16; fp32 runs only in
//   the small card-against-CPU check and the tests).
//
// The main path: a persistent, warp-specialised wgmma GEMM fed by TMA.
// - One block an SM walks output tiles of BM = 128 rows x BN columns (BN =
//   64, 128 or 256: the smallest that covers Cout, else 256). Where Cout
//   <= 256 one tile covers every output channel of its row stripe, so x is
//   read from device memory once. Where Cout > 256 the column tiles of a row
//   stripe are neighbours in tile order (column fastest) and the grid is a
//   multiple of the column-tile count, so they run side by side and the
//   stripe's re-reads hit L2; each block then keeps one column tile.
// - A producer warpgroup (one thread issuing) loads x tiles (BK = 64, 128
//   bytes a row) and w tiles by TMA (cp.async.bulk.tensor) into a ring of 3
//   (BN = 256) or 4 stages with 128-byte swizzle, full and empty mbarriers.
//   The ring runs on across tiles, so at Cin = 64 (one K step a tile) the
//   next tiles' loads are in flight while the consumers run an epilogue:
//   the overlap comes from the persistent block, not from several blocks an
//   SM (a 256-wide tile's ring and staging fill the SM's shared memory).
// - Two consumer warpgroups (64 rows each) issue wgmma.m64nBNk16 with bf16
//   operands from shared memory and fp32 accumulators in registers (64 x
//   BN / 128 a thread), one k16 group in flight behind the next. w in
//   either layout is read as it lies: K-major B for the transposed view,
//   MN-major (transposed descriptor) for a row-major w.
// - Epilogue from registers: each thread adds the values and squares of its
//   two rows for each of its columns; __shfl_xor_sync sums the 8 row lanes
//   that share columns; the 8 warps' column sums meet in shared memory and
//   are added in a fixed order into the tile's fp32 sum, which the block
//   adds into a per-column fp64 running sum across its tiles. y is rounded
//   to bf16 in registers, written to a swizzled staging tile and stored by
//   TMA (the store of one tile drains while the next is computed). Rows
//   past M load as zeros by TMA and add nothing; TMA stores no row past M.
// - The statistics stay deterministic without float atomics: the tile
//   order is fixed, each block writes its fp64 partial, and a second small
//   kernel adds the partials of each column in a fixed order in fp64.
//   Blocks are persistent, so there are at most #SMs partials a column
//   (the two other paths write one a 128- or 64-row tile).
// - The wgmma/TMA path needs no -lcuda: the tensor maps are encoded on the
//   host through cuTensorMapEncodeTiled, reached by the runtime's driver
//   entry point.
// Measured and not taken (PERF.md §6):
// - One tile a block: a grid of every tile, where a block's shared memory
//   leaves one block an SM, so nothing overlaps a tile's epilogue. At
//   (401408, 64, 256) it took 2.0x the persistent grid's time in three
//   runs of chip_smoke.py on the H100 (PERF.md §6); hence one block an SM.
// - Clusters of two blocks sharing each w tile by TMA multicast, which
//   halves the L2 reads of w: slower than the same kernel launched without
//   clusters at all 15 ResNet-50 shapes in a probe, as each block's ring
//   then waits on the other block's consumers. Its code is gone.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// Epilogue of the two tile kernels below. Cs holds the block's BM x BN fp32
// tile (row stride LDC) in shared memory; red is 2 * (NT / BN) * BN floats
// of shared scratch. Writes y and this row tile's column partials part_s /
// part_ss (row tile blockIdx.x, columns col0 ...).
template <typename T, int BM, int BN, int LDC, int NT>
__device__ __forceinline__ void store_tile_and_partials(
    const float* Cs, float* red, T* __restrict__ y, double* __restrict__ part_s,
    double* __restrict__ part_ss, int M, int N, int row0, int col0) {
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
// w[k][n] lies at w[k * sk + n * sn].
constexpr int S_BM = 64, S_BN = 64, S_BK = 16, S_NT = 256;

__global__ void __launch_bounds__(S_NT)
conv1x1_simt_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    float* __restrict__ y, double* __restrict__ part_s,
                    double* __restrict__ part_ss, int M, int K, int N,
                    long long sk, long long sn) {
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
      As[kk][r] = (gr < M && gk < K) ? x[static_cast<size_t>(gr) * K + gk]
                                     : 0.f;
    }
#pragma unroll
    for (int i = 0; i < (S_BK * S_BN) / S_NT; ++i) {
      const int e = tid + i * S_NT, kk = e / S_BN, c = e % S_BN;
      const int gk = k0 + kk, gc = col0 + c;
      Bs[kk][c] = (gk < K && gc < N) ? w[gk * sk + gc * sn] : 0.f;
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
  store_tile_and_partials<float, S_BM, S_BN, LDC, S_NT>(
      Cs, red, y, part_s, part_ss, M, N, row0, col0);
}

// ---- bf16 shapes TMA cannot take: WMMA, 128 x 64 tile, 8 warps of 32 x 32
constexpr int W_BM = 128, W_BN = 64, W_BK = 32, W_NT = 256;

__global__ void __launch_bounds__(W_NT)
conv1x1_wmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    bf16* __restrict__ y, double* __restrict__ part_s,
                    double* __restrict__ part_ss, int M, int K, int N,
                    long long sk, long long sn) {
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
  // 16-byte loads where every 8-element group starts 16-byte aligned
  const bool vec_x = K % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool vec_w = sn == 1 && sk % 8 == 0 &&
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
      if (vec_x && gr < M && gk + 8 <= K) {
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
      if (vec_w && gk < K && gc + 8 <= N) {
        *reinterpret_cast<uint4*>(dst) =
            *reinterpret_cast<const uint4*>(w + gk * sk + gc);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (gk < K && gc + e < N) ? w[gk * sk + (gc + e) * sn] : zero;
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

// ---- bf16 main path: TMA + wgmma, persistent, warp-specialised --------
constexpr int G_BM = 128;        // rows a tile: two consumer warpgroups
constexpr int G_BK = 64;         // 64 bf16 = 128 bytes: the swizzle span
constexpr int G_THREADS = 384;   // consumers 0-255, producer 256-383
constexpr int G_CONSUMERS = 256;
constexpr uint32_t A_BYTES = G_BM * G_BK * 2;   // 16 KB
constexpr uint32_t CHUNK_BYTES = 64 * 128;      // 64 rows of 128 bytes

template <int BN>
struct GCfg {
  static constexpr int STAGES = BN == 256 ? 3 : 4;
  static constexpr uint32_t B_BYTES = BN * G_BK * 2;
  static constexpr uint32_t STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr uint32_t RING = STAGES * STAGE_BYTES;
  // y staging: per consumer warpgroup, BN / 64 swizzled 64 x 64 chunks
  static constexpr uint32_t Y_BYTES = 2 * (BN / 64) * CHUNK_BYTES;
  static constexpr uint32_t RED_BYTES = 2 * 8 * BN * 4;   // s, ss x 8 warps
  static constexpr uint32_t BAR_BYTES = 2 * STAGES * 8;
  // + 1024: the base is rounded up to the 1024-byte swizzle period
  static constexpr uint32_t SMEM = RING + Y_BYTES + RED_BYTES + BAR_BYTES +
                                   1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// spins until the phase of parity `parity` of the barrier has completed; a
// wait of more than ~2^34 cycles (seconds) traps, so a lost arrival fails
// the launch instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long t0 = clock64();
  do {
    if (clock64() - t0 > (1ll << 34)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// the staging reads of every committed TMA store have finished
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads of the accumulators across a wait
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle. K-major tiles
// (rows of 64 bf16 = 128 bytes): 8-row groups 1024 bytes apart (SBO), the
// leading offset unused. MN-major tiles (w row-major: 64 columns of a K row
// in 128 bytes): 8-K-row groups 1024 bytes apart (SBO), 64-column chunks
// CHUNK_BYTES apart (LBO).
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

// D (64 x N, fp32, registers) (+)= A (64 x 16, K-major) x B (16 x N), bf16
// operands from shared memory; TB = 1 reads B MN-major. scale_d = 0 starts
// the sum. Register d[i] holds row 16 * warp + lane / 4 + 8 * ((i / 2) % 2),
// column 8 * (i / 4) + 2 * (lane % 4) + i % 2 of the warpgroup's 64 rows.
template <int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, %131;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
}

template <int BN, int TB>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t a,
                                           uint64_t b, int scale_d) {
  if constexpr (BN == 64)
    wgmma_n64<TB>(d, a, b, scale_d);
  else if constexpr (BN == 128)
    wgmma_n128<TB>(d, a, b, scale_d);
  else
    wgmma_n256<TB>(d, a, b, scale_d);
}

// x (M, K) and y (M, N) row-major through tm_x, tm_y; w through tm_w: TB =
// 0 when w is the transpose of a row-major (N, K) (K-major B), TB = 1 when
// it is row-major (K, N) (MN-major B). gridDim.x is a multiple of the
// column-tile count; block b takes tiles b, b + gridDim.x, ... (tile = row
// tile * column tiles + column tile, so it keeps column tile b % column
// tiles) and writes its fp64 column partials to row b / column tiles of
// part_s, part_ss.
template <int BN, int TB>
__global__ void __launch_bounds__(G_THREADS, 1)
conv1x1_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_w,
                     const __grid_constant__ CUtensorMap tm_y,
                     double* __restrict__ part_s,
                     double* __restrict__ part_ss, int M, int K, int N) {
  using C = GCfg<BN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t ring = base, ystage = base + C::RING;
  float* red = reinterpret_cast<float*>(smem_raw + (base - raw) + C::RING +
                                        C::Y_BYTES);
  // full[s] at bars + 8 s, empty[s] at bars + 8 (STAGES + s)
  const uint32_t bars = base + C::RING + C::Y_BYTES + C::RED_BYTES;

  const int col_tiles = (N + BN - 1) / BN;
  const int tiles = (M + G_BM - 1) / G_BM * col_tiles;
  const int k_steps = (K + G_BK - 1) / G_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (C::STAGES + s), G_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= G_CONSUMERS) {
    // ---- producer warpgroup: one thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == G_CONSUMERS) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int row0 = tile / col_tiles * G_BM;
        const int col0 = tile % col_tiles * BN;
        for (int kb = 0; kb < k_steps; ++kb) {
          const uint32_t full = bars + 8 * stage;
          mbar_wait(bars + 8 * (C::STAGES + stage), phase ^ 1);
          mbar_expect_tx(full, C::STAGE_BYTES);
          const uint32_t a = ring + stage * C::STAGE_BYTES;
          const uint32_t b = a + A_BYTES;
          tma_load(a, &tm_x, full, kb * G_BK, row0);
          if (TB == 0) {
            tma_load(b, &tm_w, full, kb * G_BK, col0);
          } else {
            for (int j = 0; j < BN / 64; ++j)
              tma_load(b + j * CHUNK_BYTES, &tm_w, full, col0 + 64 * j,
                       kb * G_BK);
          }
          if (++stage == C::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    const int w8 = wg * 4 + warp;  // warp of the block's 8 consumer warps
    const uint32_t ystage_wg = ystage + wg * (BN / 64) * CHUNK_BYTES;
    float d[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;
    // the running fp64 sums of column threadIdx.x (< BN) of the column tile
    double run_s = 0.0, run_ss = 0.0;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int row0 = tile / col_tiles * G_BM;
      const int col0 = tile % col_tiles * BN;
      int prev = 0;
      for (int kb = 0; kb < k_steps; ++kb) {
        mbar_wait(bars + 8 * stage, phase);
        const uint32_t a = ring + stage * C::STAGE_BYTES + wg * CHUNK_BYTES;
        const uint32_t b = ring + stage * C::STAGE_BYTES + A_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < G_BK / 16; ++kk) {
          const uint64_t da = wgmma_desc(a + kk * 32, 16, 1024);
          const uint64_t db =
              TB == 0 ? wgmma_desc(b + kk * 32, 16, 1024)
                      : wgmma_desc(b + kk * 2048, CHUNK_BYTES, 1024);
          wgmma_tile<BN, TB>(d, da, db, (kb | kk) != 0);
        }
        wgmma_commit();
        // the previous step's products are done: free its stage
        wgmma_wait<1>();
        if (kb > 0) mbar_arrive(bars + 8 * (C::STAGES + prev));
        prev = stage;
        if (++stage == C::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(d);
      mbar_arrive(bars + 8 * (C::STAGES + prev));

      // statistics: this thread's two rows, then the 8 lanes (lane / 4)
      // that share its columns; lanes 0-3 hold the warp's 16-row sums
      named_barrier(1, G_CONSUMERS);  // the last tile's sums have been read
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        float v[4] = {d[4 * j] + d[4 * j + 2], d[4 * j + 1] + d[4 * j + 3],
                      fmaf(d[4 * j], d[4 * j], d[4 * j + 2] * d[4 * j + 2]),
                      fmaf(d[4 * j + 1], d[4 * j + 1],
                           d[4 * j + 3] * d[4 * j + 3])};
#pragma unroll
        for (int o = 4; o < 32; o <<= 1)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[e] += __shfl_xor_sync(0xffffffffu, v[e], o);
        if (lane < 4) {
          const int c = 8 * j + 2 * lane;
          *reinterpret_cast<float2*>(&red[w8 * BN + c]) =
              make_float2(v[0], v[1]);
          *reinterpret_cast<float2*>(&red[(8 + w8) * BN + c]) =
              make_float2(v[2], v[3]);
        }
      }

      // y: bf16 in registers -> swizzled staging -> TMA store
      if (t == 0) bulk_wait_read();  // the last tile's store has read it
      named_barrier(2 + wg, 128);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = warp * 16 + lane / 4 + 8 * h;
          __nv_bfloat162 p =
              __floats2bfloat162_rn(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
          const uint32_t addr = ystage_wg + j / 8 * CHUNK_BYTES + r * 128 +
                                ((j % 8) ^ (r % 8)) * 16 + 4 * (lane % 4);
          asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr),
                       "r"(*reinterpret_cast<uint32_t*>(&p))
                       : "memory");
        }
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      named_barrier(2 + wg, 128);
      if (t == 0) {
        for (int c = 0; c < BN / 64; ++c)
          tma_store(&tm_y, ystage_wg + c * CHUNK_BYTES, col0 + 64 * c,
                    row0 + 64 * wg);
        bulk_commit();
      }

      // the tile's column sums over its 8 warps, in order, into fp64
      named_barrier(1, G_CONSUMERS);
      if (threadIdx.x < BN) {
        float ts = 0.f, tss = 0.f;
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          ts += red[p * BN + threadIdx.x];
          tss += red[(8 + p) * BN + threadIdx.x];
        }
        run_s += ts;
        run_ss += tss;
      }
    }
    const int col = blockIdx.x % col_tiles * BN + threadIdx.x;
    if (threadIdx.x < BN && col < N) {
      const size_t o = static_cast<size_t>(blockIdx.x / col_tiles) * N + col;
      part_s[o] = run_s;
      part_ss[o] = run_ss;
    }
    if (t == 0) bulk_wait();  // y is written before the block leaves
  }
}

// ---- the fixed-order reduction of the partials -------------------------
// 32 columns a block; 32 lanes of partial rows per column, each summing a
// strided share in fp64, then lane 0 adds the 32 shares in order.
__global__ void __launch_bounds__(1024)
bn_stats_finalize_kernel(const double* __restrict__ part_s,
                         const double* __restrict__ part_ss,
                         float* __restrict__ mean, float* __restrict__ var,
                         int rows, int M, int N) {
  __shared__ double rs[32][33], rss[32][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  double s = 0.0, ss = 0.0;
  if (c < N) {
    for (int t = threadIdx.y; t < rows; t += 32) {
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

// ---- host side -----------------------------------------------------------
enum Path { kSimt = 0, kWmma = 1, kWgmma = 2 };

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a bf16 matrix of `rows` rows of `cols` elements, `ld` elements apart,
// copied in boxes of box_rows x box_cols (box_cols * 2 <= 128 bytes) with
// the 128-byte swizzle; boxes past the edge read as zeros
bool make_map(CUtensorMap* map, const void* ptr, uint64_t cols, uint64_t rows,
              uint64_t ld, uint32_t box_cols, uint32_t box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {ld * 2};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count(int device) {
  static int cached[64] = {};
  if (device < 0 || device >= 64) return 0;
  if (cached[device] == 0 &&
      cudaDeviceGetAttribute(&cached[device], cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess)
    cached[device] = 0;
  return cached[device];
}

int tile_cols(int N) { return N <= 64 ? 64 : N <= 128 ? 128 : 256; }

// blocks of the wgmma path: one an SM, rounded down to a multiple of the
// column tiles, never more than the tiles
int wgmma_grid(int M, int N, int sms) {
  const int ct = (N + tile_cols(N) - 1) / tile_cols(N);
  const long long tiles = static_cast<long long>((M + G_BM - 1) / G_BM) * ct;
  const long long groups = sms / ct > 0 ? sms / ct : 1;
  return static_cast<int>(tiles < groups * ct ? tiles : groups * ct);
}

template <int BN, int TB>
cudaError_t launch_wgmma(const CUtensorMap& tx, const CUtensorMap& tw,
                         const CUtensorMap& ty, double* ps, double* pss,
                         int M, int K, int N, int grid, int device,
                         cudaStream_t s) {
  static bool sized[64] = {};
  auto kernel = conv1x1_wgmma_kernel<BN, TB>;
  if (!sized[device]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, GCfg<BN>::SMEM);
    if (e != cudaSuccess) return e;
    sized[device] = true;
  }
  kernel<<<grid, G_THREADS, GCfg<BN>::SMEM, s>>>(tx, tw, ty, ps, pss, M, K,
                                                 N);
  return cudaGetLastError();
}

}  // namespace

// Rows of fp64 partials per column that `path` (0 = fp32 CUDA cores, 1 =
// bf16 WMMA, 2 = bf16 wgmma/TMA) writes for an (M, N) output on `device`;
// -1 on bad arguments.
extern "C" int mxtpu_conv1x1_bn_partial_rows(int M, int N, int path,
                                             int device) {
  if (M < 1 || N < 1) return -1;
  switch (path) {
    case kSimt: return (M + S_BM - 1) / S_BM;
    case kWmma: return (M + W_BM - 1) / W_BM;
    case kWgmma: {
      const int sms = sm_count(device);
      if (sms < 1) return -1;
      const int ct = (N + tile_cols(N) - 1) / tile_cols(N);
      return wgmma_grid(M, N, sms) / ct;
    }
    default: return -1;
  }
}

// x (M, K) row-major; w (K, N) with w[k][n] at w + k * sk + n * sn; y (M, N)
// row-major; all of one dtype: float32 for path 0, bfloat16 for paths 1, 2.
// Path 2 needs K, N multiples of 8, 16-byte aligned x, w, y, and w either
// row-major (sk = N, sn = 1) or the transpose of a row-major (N, K) (sk =
// 1, sn = K). part: float64 scratch of 2 x partial_rows x N; mean, var:
// float32 (N,); device: the tensors' CUDA device. Two launches on
// `stream`; returns the first cudaError_t, or 0.
extern "C" int mxtpu_conv1x1_bn_stats(const void* x, const void* w, void* y,
                                      void* part, void* mean, void* var,
                                      int M, int K, int N, long long sk,
                                      long long sn, int path, int device,
                                      void* stream) {
  if (M < 1 || K < 1 || N < 1) return cudaErrorInvalidValue;
  mxtpu::DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return scope.error();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = mxtpu_conv1x1_bn_partial_rows(M, N, path, device);
  if (rows < 1) return cudaErrorInvalidValue;
  double* ps = static_cast<double*>(part);
  double* pss = ps + static_cast<size_t>(rows) * N;
  cudaError_t err = cudaSuccess;
  if (path == kSimt) {
    const dim3 grid(rows, (N + S_BN - 1) / S_BN);
    conv1x1_simt_kernel<<<grid, S_NT, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(y), ps, pss, M, K, N, sk, sn);
    err = cudaGetLastError();
  } else if (path == kWmma) {
    const dim3 grid(rows, (N + W_BN - 1) / W_BN);
    conv1x1_wmma_kernel<<<grid, W_NT, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w),
        static_cast<bf16*>(y), ps, pss, M, K, N, sk, sn);
    err = cudaGetLastError();
  } else {
    const bool aligned = ((reinterpret_cast<uintptr_t>(x) |
                           reinterpret_cast<uintptr_t>(w) |
                           reinterpret_cast<uintptr_t>(y)) & 15) == 0;
    const bool kmajor = sk == 1 && sn == K, mnmajor = sk == N && sn == 1;
    if (K % 8 || N % 8 || !aligned || !(kmajor || mnmajor))
      return cudaErrorInvalidValue;
    const int bn = tile_cols(N);
    CUtensorMap tx, tw, ty;
    const bool ok =
        make_map(&tx, x, K, M, K, G_BK, G_BM) &&
        make_map(&ty, y, N, M, N, 64, 64) &&
        (kmajor ? make_map(&tw, w, K, N, K, G_BK, bn)
                : make_map(&tw, w, N, K, N, 64, G_BK));
    if (!ok) return cudaErrorInvalidValue;
    const int grid = wgmma_grid(M, N, sm_count(device));
    if (device >= 64) return cudaErrorInvalidDevice;
#define MXTPU_WGMMA(BN)                                                      \
  err = kmajor ? launch_wgmma<BN, 0>(tx, tw, ty, ps, pss, M, K, N, grid,     \
                                     device, s)                              \
               : launch_wgmma<BN, 1>(tx, tw, ty, ps, pss, M, K, N, grid,     \
                                     device, s)
    if (bn == 64)
      MXTPU_WGMMA(64);
    else if (bn == 128)
      MXTPU_WGMMA(128);
    else
      MXTPU_WGMMA(256);
#undef MXTPU_WGMMA
  }
  if (err != cudaSuccess) return err;
  bn_stats_finalize_kernel<<<(N + 31) / 32, dim3(32, 32), 0, s>>>(
      ps, pss, static_cast<float*>(mean), static_cast<float*>(var), rows, M,
      N);
  return cudaGetLastError();
}
