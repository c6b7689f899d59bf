// The patch-staging probes for Hopper (sm_90a): eight small f32 kernels,
// each the counterpart of one Pallas kernel of scripts/mosaic_probe.py.
//
// The function.  x [T + 6, 32] f32, T a multiple of 32.  Six slices of x,
// shifted by one row each, side by side make the patch matrix (an im2col
// tile)
//   P[t, 32j + c] = x[t + j, c]                      P [T, 192]
// and two probes multiply it:  Y = P @ w,  w [192, 128], f32 sums.
// What tells the kernels apart is how each stages its data, because that is
// what each TPU probe tested:
//
//   #4 probe_concat_full_lane (scripts/mosaic_probe.py:50) -> concat_full_lane:
//      a gather in registers.  A block owns 8 rows of P; each thread loads
//      3 float4 of x straight from device memory, slice-major (slice j of
//      the block's rows is one contiguous 1 KB range of x), and stores them
//      to P, each 8 threads one aligned 128-byte run of a row.  No shared
//      memory.
//   #5 probe_concat_lane_off (:63) -> concat_lane_off: the same patches from
//      the paired layout xp = [x, 2x] [T + 6, 64] (built by the caller, as
//      the TPU probe builds it outside its kernel):
//        P[t, 32j + c] = xp[t + j, 32 (j % 2) + c].
//      16-byte float4 loads and stores; the 32-float column offset is 128 B,
//      so every vector stays aligned.
//   #6 probe_scratch_write (:82) -> scratch_write: P is assembled in a
//      shared-memory tile, each slice written at its 32-column offset, then
//      written out coalesced.  A block owns 8 rows of P; slice j of them is
//      one contiguous range of x, which consecutive threads load as float4
//      and store as float4 at column 32j of the tile's rows.
//   #7 probe_stack_reshape (:97) -> stack_reshape: a shared tile declared
//      [rows][6][32], written tap by tap and read out as flat [rows][192]
//      rows.  The reshape moves nothing: it is the same bytes read through
//      another index.  A block owns 8 rows of P and loads their window of
//      x (13 rows, one contiguous range) once, as float4, storing each
//      float4 into every tap of the tile it feeds.
//   #8 probe_dma_assemble (:111) -> dma_assemble: the copy engine.  For a
//      block's 32 rows, slice j is one contiguous 4 KB range of x; each is
//      one bulk async copy (cp.async.bulk ... mbarrier::complete_tx::bytes)
//      into its own shared buffer and completes on its own mbarrier, the
//      counterpart of the TPU's per-copy DMA semaphore.  The block waits on
//      the barriers in order and writes each slice of P as it lands.
//   #9 probe_matmul_after_concat (:138) -> matmul_after_concat: P's rows
//      are built in registers, 4 columns at a time, from 16-byte loads of x;
//      w is staged in shared memory; Y in f32 FMAs.  A block owns 16 rows x
//      32 columns of Y and stages only its columns of w (24 KB); its four
//      warps split K, each lane keeps a 4 x 4 tile of sums, and the four
//      partial tiles are summed in shared memory in a fixed order.
//  #10 probe_matmul_after_scratch (:159) -> matmul_after_scratch: P staged
//      in a shared tile whose rows are padded to 193 floats (lane r stores
//      row r down the columns), then the same product.  The padding
//      matters: a warp reads one column of 32 rows at each step.
//  #11 probe_mini_kernel (:183) -> mini_kernel: a miniature of the spec-conv
//      forward, a small implicit GEMM:
//        out[b, f, t, :] = sum_{g=3..8, dt<9} xq[b, f + g/4, t + dt,
//                          32 (g%4) : +32] @ w[32 (9 (g-3) + dt) : +32, :]
//      xq [B, F + 2, R + 8, 128], w [1728, 128], out [B, F, R, 128].  The
//      TPU kernel copies a [3, 264, 128] f32 window (405 KB) per grid step;
//      that does not fit a block's 227 KB.  Here a block owns (b, f, 32 rows
//      of t), stages with 16-byte cp.async only the six 32-channel groups the
//      function reads (block 0 lane 3, block 1 lanes 0-3, block 2 lane 0)
//      for its rows plus the 8-row halo (30 KB), streams w in 54 chunks of
//      32 rows through a double buffer, and keeps a 4 x 4 register tile of
//      f32 sums per thread.
//
// Every product is f32 by FMA: no TF32, no tensor cores.  The TPU probes
// take an f32 dot with f32 accumulation, and their checks (atol 1e-3 on sums
// of 192 unit normals) need full f32.
//
// What bounds them on this card (H100 SXM: 3.35 TB/s, 67 TFLOP/s f32), at
// the probe script's sizes (T = 256; B 2, F 3, R 512):
//   #4, #6-8: 230,144 B moved -> 0.069 us;  #5: 263,680 B -> 0.079 us;
//   #9-10:  12.58 MFLOP -> 0.188 us, above their 262,912 B (0.078 us);
//   #11:    1.359 GFLOP -> 20.3 us, above its 5.12 MB (1.53 us).
// #4-10 take far less time than a launch does (a one-element fill_ takes
// 1.0 us of device time), so at these sizes their times are a launch and a
// chain of dependent memory round trips.  #4, #6 and #7 keep that chain
// short: 32 blocks of 128 threads (8 rows of P each) in place of 8 blocks
// of 32 rows, every thread issues all its float4 loads before its first
// dependent store, and every access is 16 bytes a thread, neighbouring
// threads on neighbouring addresses.  #9 spreads its product over 64
// blocks (8 before), each a short chain of 48 k-steps a warp.
// At T = 131072 the copies #4 and #6-8 move 117.4 MB (x 16.8 MB, P
// 100.7 MB, more than the 50 MB L2): 35.1 us of bytes, the bound they are
// built for there (#5 reads xp: 134.2 MB, 40.1 us); the products do
// 6.44 GFLOP, 96.2 us at the f32 peak, above their 84.0 MB (25.1 us), and
// #9's blocks then walk the row tiles, staging w once each.  Device time
// (stylish_tts_tpu_torch/scripts/probe_times.py, NVIDIA H100 80GB HBM3,
// 700.00 W), at T = 256 and at T = 131072: #4 1.11 and 42.5 us (the
// 32-row design 2.4 and 45.7; the strided library copy 1.54 and 61.0);
// #6 / #7 1.16 / 1.18 and 42.7 / 41.9 us (the 32-row designs 2.61 / 2.83
// and 46.9 / 43.4); #9 2.75 and 223.8 us, 43% of the f32 bound (the
// one-block-a-32-rows design 16.6; F.conv1d in f32 11.1 and 251.7).
// #5, #8, #10 and #11 are first versions that are right; only #11 does
// enough work at the probe's sizes for its design to show.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CIN = 32;          // channels of a slice
constexpr int TAPS = 6;          // slices side by side
constexpr int K = TAPS * CIN;    // 192, the patch width
constexpr int N = 128;           // output columns of the products
constexpr int RT = 32;           // rows of P per block
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PITCH = K + 1;     // padded row of #10's shared P tile
constexpr int WC = N / WARPS;    // output columns per warp in #10
constexpr int SLICE_BYTES = RT * CIN * (int)sizeof(float);
static_assert(RT == 32, "one lane per row of the tile");
static_assert(SLICE_BYTES % 16 == 0, "bulk copies move multiples of 16 B");
static_assert(WC % 4 == 0, "float4 rows of w");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING) : "memory");
}

// ------------------------------------------------------------------------- //
// #5: 16-byte vectors at a 32-float column offset

__global__ void __launch_bounds__(THREADS)
concat_lane_off_kernel(const float4* __restrict__ xp, float4* __restrict__ p) {
  constexpr int PQ = K / 4;        // float4 per row of P
  constexpr int XQ = 2 * CIN / 4;  // float4 per row of xp
  constexpr int SQ = CIN / 4;      // float4 per slice row
  const int r0 = blockIdx.x * RT;
  for (int i = threadIdx.x; i < RT * PQ; i += THREADS) {
    const int r = i / PQ, q = i % PQ, j = q / SQ, c4 = q % SQ;
    p[(size_t)(r0 + r) * PQ + q] =
        __ldg(xp + (size_t)(r0 + r + j) * XQ + (j % 2) * SQ + c4);
  }
}

// ------------------------------------------------------------------------- //
// #10: P staged in a padded shared tile

// Rows r0..r0+31 of P into ps [RT][PITCH].  Warp j writes slice j; lane r
// loads row r0 + r + j of x in 16-byte pieces and stores it down the 32
// columns of slice j.  At a pitch of 193 floats, one column's 32 rows lie on
// 32 distinct banks.
__device__ __forceinline__ void stage_patches(const float* __restrict__ x,
                                              float* ps, int r0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int j = warp; j < TAPS; j += WARPS) {
    const float4* src =
        reinterpret_cast<const float4*>(x + (size_t)(r0 + lane + j) * CIN);
    float* dst = ps + lane * PITCH + j * CIN;
#pragma unroll
    for (int q = 0; q < CIN / 4; ++q) {
      const float4 v = __ldg(src + q);
      dst[4 * q] = v.x;
      dst[4 * q + 1] = v.y;
      dst[4 * q + 2] = v.z;
      dst[4 * q + 3] = v.w;
    }
  }
}

// ------------------------------------------------------------------------- //
// #4, #6 and #7: small blocks, 16-byte traffic.  A block owns BR rows of P,
// BR * PQ float4.  #6 and #7 build them as a tile [BR][192] floats in shared
// memory, written by float4 stores in which each group of 8 threads fills
// 128 contiguous bytes (one slice row), so a row pitch of 192 floats meets
// no bank conflict, and read out flat: float4 k of the tile is float4 k of
// the block's P.  #4 keeps them in registers.

constexpr int BR = 8;                 // rows of P per block
constexpr int BTHREADS = 128;
constexpr int SQ = CIN / 4;           // float4 per row of x
constexpr int PQ = K / 4;             // float4 per row of P
constexpr int WIN = BR + TAPS - 1;    // rows of x under a block's rows of P
constexpr int OUT_PER_THREAD = BR * PQ / BTHREADS;
static_assert(RT % BR == 0, "T is a multiple of RT, so of BR");
static_assert(BR * PQ % BTHREADS == 0, "whole float4 stores a thread");
static_assert(TAPS * BR * SQ % BTHREADS == 0, "whole slice loads a thread");

// #4: a gather in registers.  Float4 k of the block is taken slice-major,
// j = k >> 6, r = (k >> 3) & 7, c4 = k & 7: slice j of the block's rows is
// one contiguous 1 KB range of x (rows r0 + j .. r0 + j + 7), and each 8
// threads store one 128-byte run of a row of P at column 32j (a row is
// 768 B, so every run is 128-byte aligned).  Each thread issues its 3 loads
// before its 3 stores.
constexpr int SLICE_LOG2 = 6;         // BR * SQ = 64 float4 of a slice
constexpr int SQ_LOG2 = 3;            // SQ = 8
static_assert(BR * SQ == 1 << SLICE_LOG2 && SQ == 1 << SQ_LOG2, "shifts");

__global__ void __launch_bounds__(BTHREADS)
concat_full_lane_kernel(const float4* __restrict__ x, float4* __restrict__ p) {
  const int r0 = blockIdx.x * BR;
  float4 v[OUT_PER_THREAD];
#pragma unroll
  for (int u = 0; u < OUT_PER_THREAD; ++u) {
    const int k = threadIdx.x + u * BTHREADS, j = k >> SLICE_LOG2;
    v[u] = __ldg(x + (size_t)(r0 + j) * SQ + (k & (BR * SQ - 1)));
  }
#pragma unroll
  for (int u = 0; u < OUT_PER_THREAD; ++u) {
    const int k = threadIdx.x + u * BTHREADS, j = k >> SLICE_LOG2;
    const int r = (k >> SQ_LOG2) & (BR - 1), c4 = k & (SQ - 1);
    p[(size_t)(r0 + r) * PQ + j * SQ + c4] = v[u];
  }
}

// The tile out to P, coalesced: every thread reads all its float4 first.
__device__ __forceinline__ void write_tile(const float4* tile,
                                          float4* __restrict__ p, int r0) {
  float4 v[OUT_PER_THREAD];
#pragma unroll
  for (int u = 0; u < OUT_PER_THREAD; ++u)
    v[u] = tile[threadIdx.x + u * BTHREADS];
  float4* out = p + (size_t)r0 * PQ;
#pragma unroll
  for (int u = 0; u < OUT_PER_THREAD; ++u)
    out[threadIdx.x + u * BTHREADS] = v[u];
}

// #6: each slice written at its column offset.  Slice j of the block's rows
// is one contiguous range of x, rows r0 + j .. r0 + j + BR - 1 (BR * 8
// float4); consecutive threads load consecutive float4 of it and store each
// at column 32j of its row of the tile.
__global__ void __launch_bounds__(BTHREADS)
scratch_write_kernel(const float4* __restrict__ x, float4* __restrict__ p) {
  constexpr int SLICE = BR * SQ;                  // float4 of a slice
  constexpr int LOADS = TAPS * SLICE / BTHREADS;  // float4 loads a thread
  __shared__ float4 tile[BR * PQ];
  const int r0 = blockIdx.x * BR;
  float4 v[LOADS];
#pragma unroll
  for (int u = 0; u < LOADS; ++u) {
    const int i = threadIdx.x + u * BTHREADS, j = i / SLICE;
    v[u] = __ldg(x + (size_t)(r0 + j) * SQ + i % SLICE);
  }
#pragma unroll
  for (int u = 0; u < LOADS; ++u) {
    const int i = threadIdx.x + u * BTHREADS, j = i / SLICE, k = i % SLICE;
    tile[(k / SQ) * PQ + j * SQ + k % SQ] = v[u];
  }
  __syncthreads();
  write_tile(tile, p, r0);
}

// #7: the taps stacked, then reshaped.  The tile is declared [BR][6][8]
// float4 ([rows][6][32] floats).  The block loads its window of x, rows
// r0 .. r0 + BR + 4 (one contiguous range), once, and writes each float4
// into every tile[r][j] it feeds (r + j = its row in the window, up to six
// places); then reads the tile as flat [BR][192] rows.
__global__ void __launch_bounds__(BTHREADS)
stack_reshape_kernel(const float4* __restrict__ x, float4* __restrict__ p) {
  constexpr int LOADS = (WIN * SQ + BTHREADS - 1) / BTHREADS;
  __shared__ float4 tile[BR][TAPS][SQ];
  const int r0 = blockIdx.x * BR;
  float4 v[LOADS] = {};
#pragma unroll
  for (int u = 0; u < LOADS; ++u) {
    const int i = threadIdx.x + u * BTHREADS;
    if (i < WIN * SQ) v[u] = __ldg(x + (size_t)r0 * SQ + i);
  }
#pragma unroll
  for (int u = 0; u < LOADS; ++u) {
    const int i = threadIdx.x + u * BTHREADS, w = i / SQ, q = i % SQ;
#pragma unroll
    for (int j = 0; j < TAPS; ++j)
      if (i < WIN * SQ && w - j >= 0 && w - j < BR) tile[w - j][j][q] = v[u];
  }
  __syncthreads();
  write_tile(&tile[0][0][0], p, r0);
}

// ------------------------------------------------------------------------- //
// #8: bulk async copies completing on mbarriers

__device__ __forceinline__ void wait_phase0(const uint64_t* bar) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        " .reg .pred ready;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 ready, [%1], 0;\n"
        " selp.u32 %0, 1, 0, ready;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar))
        : "memory");
  } while (!done);
}

__global__ void __launch_bounds__(THREADS)
dma_assemble_kernel(const float* __restrict__ x, float* __restrict__ p) {
  __shared__ __align__(128) float buf[TAPS][RT * CIN];
  __shared__ __align__(8) uint64_t bar[TAPS];
  const int r0 = blockIdx.x * RT;
  if (threadIdx.x == 0) {
    for (int j = 0; j < TAPS; ++j)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(smem_addr(&bar[j])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int j = 0; j < TAPS; ++j) {
      const uint64_t src = reinterpret_cast<uint64_t>(x + (size_t)(r0 + j) * CIN);
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   :: "r"(smem_addr(&bar[j])), "r"(SLICE_BYTES) : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];\n"
          :: "r"(smem_addr(buf[j])), "l"(src), "r"(SLICE_BYTES),
             "r"(smem_addr(&bar[j]))
          : "memory");
    }
  }
  for (int j = 0; j < TAPS; ++j) {
    wait_phase0(&bar[j]);
    for (int i = threadIdx.x; i < RT * CIN; i += THREADS)
      p[(size_t)(r0 + i / CIN) * K + j * CIN + i % CIN] = buf[j][i];
  }
}

// ------------------------------------------------------------------------- //
// #10: Y = P @ w.  Lane = row of the block's 32, warp = 16 columns;
// w [K][N] in shared memory, read by the whole warp at one address.

constexpr int W_BYTES = K * N * (int)sizeof(float);

__device__ __forceinline__ void stage_w(const float* __restrict__ w, float* ws) {
  const float4* src = reinterpret_cast<const float4*>(w);
  float4* dst = reinterpret_cast<float4*>(ws);
  for (int i = threadIdx.x; i < K * N / 4; i += THREADS) dst[i] = __ldg(src + i);
}

__device__ __forceinline__ void fma_row(float (&acc)[WC], float a,
                                        const float* wrow) {
  const float4* b4 = reinterpret_cast<const float4*>(wrow);
#pragma unroll
  for (int u = 0; u < WC / 4; ++u) {
    const float4 b = b4[u];
    acc[4 * u] = fmaf(a, b.x, acc[4 * u]);
    acc[4 * u + 1] = fmaf(a, b.y, acc[4 * u + 1]);
    acc[4 * u + 2] = fmaf(a, b.z, acc[4 * u + 2]);
    acc[4 * u + 3] = fmaf(a, b.w, acc[4 * u + 3]);
  }
}

__device__ __forceinline__ void store_row(const float (&acc)[WC], float* y,
                                          int row, int col0) {
  float4* dst = reinterpret_cast<float4*>(y + (size_t)row * N + col0);
#pragma unroll
  for (int u = 0; u < WC / 4; ++u)
    dst[u] = make_float4(acc[4 * u], acc[4 * u + 1], acc[4 * u + 2],
                         acc[4 * u + 3]);
}

__global__ void __launch_bounds__(THREADS)
matmul_after_scratch_kernel(const float* __restrict__ x,
                            const float* __restrict__ w, float* __restrict__ y) {
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;
  float* ps = smem + K * N;
  const int r0 = blockIdx.x * RT;
  stage_w(w, ws);
  stage_patches(x, ps, r0);
  __syncthreads();
  const int lane = threadIdx.x % 32, col0 = (threadIdx.x / 32) * WC;
  float acc[WC] = {};
#pragma unroll 4
  for (int k = 0; k < K; ++k) fma_row(acc, ps[lane * PITCH + k], ws + k * N + col0);
  store_row(acc, y, r0 + lane, col0);
}

// ------------------------------------------------------------------------- //
// #9: Y = P @ w over the card.  A block owns MB rows x NB columns of Y; its
// warps split K = 192 into KSPLIT slices of KW, and each lane keeps a
// TM x TN register tile of f32 sums: rows TM rg + i of the block, columns
// TN cg + n (rg = lane / 8, cg = lane % 8).  A lane builds its rows of P in
// registers, a float4 of x (4 columns of P) per row at a time; the 8 lanes
// of one rg load the same address, so a warp's load touches 4 rows of x.
// Each warp stages its KW rows of the block's NB columns of w by 16-byte
// cp.async and waits for its own copies only.  The slices' partial tiles
// meet in shared memory and are summed in warp order.  The blocks of one
// column walk the row tiles with a stride, so each stages its w once.

constexpr int MB = 16;                    // rows of Y a block
constexpr int NB = 32;                    // columns of Y a block
constexpr int NB4 = NB / 4;               // float4 of a block's row of Y or w
constexpr int N4 = N / 4;                 // float4 of a row of Y or w
constexpr int KSPLIT = BTHREADS / 32;     // warps, one slice of K each
constexpr int KW = K / KSPLIT;            // 48, the depth of a slice
constexpr int TM = 4, TN = 4;             // a lane's tile of Y
static_assert(MB == 4 * TM && NB == 8 * TN, "4 x 8 lanes of TM x TN tiles");
static_assert(MB * NB4 == BTHREADS, "one float4 of Y a thread in the sum");
static_assert(NB4 == SQ && KW % 4 == 0 && RT % MB == 0, "the index shifts");

__device__ __forceinline__ float part_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__global__ void __launch_bounds__(BTHREADS)
matmul_after_concat_kernel(const float4* __restrict__ x,
                           const float4* __restrict__ w,
                           float4* __restrict__ y, int tiles) {
  __shared__ float4 ws[K * NB4];                // w[:, n0 : n0 + NB], 24 KB
  __shared__ float4 part[KSPLIT][MB * NB4];     // the slices' sums, 8 KB
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = lane >> 3, cg = lane & 7;
  const int n4 = blockIdx.x * NB4, g0 = warp * (KW / 4);
  for (int i = lane; i < KW * NB4; i += 32) {
    const int k = warp * KW + (i >> SQ_LOG2), c4 = i & (NB4 - 1);
    cp_async16(&ws[k * NB4 + c4], w + (size_t)k * N4 + n4 + c4);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();  // the warp reads only the rows it copied

  for (int tile = blockIdx.y; tile < tiles; tile += gridDim.y) {
    const int t0 = tile * MB;
    const float4* xr = x + (size_t)(t0 + TM * rg) * SQ;
    float acc[TM][TN] = {};
#pragma unroll
    for (int u = 0; u < KW / 4; ++u) {
      const int g = g0 + u;  // columns 4g .. 4g + 3 of P
      const int j = g >> SQ_LOG2, c4 = g & (SQ - 1);
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = __ldg(xr + (i + j) * SQ + c4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 b = ws[(4 * g + kk) * NB4 + cg];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float av = part_of(a[i], kk);
          acc[i][0] = fmaf(av, b.x, acc[i][0]);
          acc[i][1] = fmaf(av, b.y, acc[i][1]);
          acc[i][2] = fmaf(av, b.z, acc[i][2]);
          acc[i][3] = fmaf(av, b.w, acc[i][3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
      part[warp][(TM * rg + i) * NB4 + cg] =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    __syncthreads();
    float4 s = part[0][threadIdx.x];  // row threadIdx.x / 8 of the tile
#pragma unroll
    for (int q = 1; q < KSPLIT; ++q) {
      const float4 v = part[q][threadIdx.x];
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    y[(size_t)(t0 + (threadIdx.x >> SQ_LOG2)) * N4 + n4 +
      (threadIdx.x & (NB4 - 1))] = s;
    __syncthreads();  // part is written again for the next tile
  }
}

// ------------------------------------------------------------------------- //
// #11: the miniature spec-conv forward

constexpr int MT = 32;                 // rows of t per block
constexpr int GROUPS = 6;              // 32-channel groups g = 3..8
constexpr int KT = 9;                  // taps on t
constexpr int CHUNKS = GROUPS * KT;    // 54 chunks of 32 rows of w
constexpr int XC = 4 * CIN;            // 128 channels of a row of xq
constexpr int MWIN = MT + KT - 1;      // staged rows per group
constexpr int MROWS = MT / WARPS;      // output rows per thread
constexpr int MCOLS = N / 32;          // output columns per thread
constexpr int XS_FLOATS = GROUPS * MWIN * CIN;
constexpr int WB_FLOATS = CIN * N;
constexpr int MINI_SMEM = (XS_FLOATS + 2 * WB_FLOATS) * (int)sizeof(float);

// rows 32c .. 32c+31 of w into wb [CIN][N]
__device__ __forceinline__ void stage_w_chunk(const float* __restrict__ w,
                                              float* wb, int c) {
  const float* src = w + (size_t)c * CIN * N;
  for (int i = threadIdx.x; i < WB_FLOATS / 4; i += THREADS)
    cp_async16(wb + 4 * i, src + 4 * i);
}

__global__ void __launch_bounds__(THREADS)
mini_kernel(const float* __restrict__ xq, const float* __restrict__ w,
            float* __restrict__ out, int fq, int rows) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                 // [GROUPS][MWIN][CIN]
  float* wb = smem + XS_FLOATS;     // [2][CIN][N]
  const int t0 = blockIdx.x * MT, f = blockIdx.y, b = blockIdx.z;
  const int in_rows = rows + KT - 1;

  // the six groups' windows: group gi is g = gi + 3, read from frequency
  // block f + g / 4 at channels 32 (g % 4) .. +32
  for (int i = threadIdx.x; i < GROUPS * MWIN * (CIN / 4); i += THREADS) {
    const int gi = i / (MWIN * (CIN / 4));
    const int r = (i / (CIN / 4)) % MWIN, q = i % (CIN / 4);
    const int g = gi + 3;
    const float* src = xq + (((size_t)b * (fq + 2) + f + g / 4) * in_rows
                             + t0 + r) * XC + (g % 4) * CIN + 4 * q;
    cp_async16(xs + (gi * MWIN + r) * CIN + 4 * q, src);
  }
  stage_w_chunk(w, wb, 0);
  cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float acc[MROWS][MCOLS] = {};
  for (int c = 0; c < CHUNKS; ++c) {
    if (c + 1 < CHUNKS) {
      stage_w_chunk(w, wb + ((c + 1) & 1) * WB_FLOATS, c + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* wc = wb + (c & 1) * WB_FLOATS;
    const float* xg = xs + ((c / KT) * MWIN + warp * MROWS + c % KT) * CIN;
#pragma unroll 4
    for (int k = 0; k < CIN; ++k) {
      float a[MROWS], bv[MCOLS];
#pragma unroll
      for (int i = 0; i < MROWS; ++i) a[i] = xg[i * CIN + k];
#pragma unroll
      for (int u = 0; u < MCOLS; ++u) bv[u] = wc[k * N + lane + 32 * u];
#pragma unroll
      for (int i = 0; i < MROWS; ++i)
#pragma unroll
        for (int u = 0; u < MCOLS; ++u) acc[i][u] = fmaf(a[i], bv[u], acc[i][u]);
    }
    __syncthreads();  // the buffer read here is refilled in step c + 1
  }
#pragma unroll
  for (int i = 0; i < MROWS; ++i) {
    float* dst = out + (((size_t)b * fq + f) * rows + t0 + warp * MROWS + i) * N;
#pragma unroll
    for (int u = 0; u < MCOLS; ++u) dst[lane + 32 * u] = acc[i][u];
  }
}

int with_smem(const void* kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// C entry points.  Each launches on `stream` and returns cudaGetLastError()
// of the launch (0 = ok).  Pointers are 16-byte aligned f32 buffers; t and
// rows are multiples of 32 (the wrapper checks both).

extern "C" int probe_concat_full_lane(const void* x, void* p, int t,
                                      void* stream) {
  concat_full_lane_kernel<<<t / BR, BTHREADS, 0, (cudaStream_t)stream>>>(
      (const float4*)x, (float4*)p);
  return (int)cudaGetLastError();
}

extern "C" int probe_concat_lane_off(const void* xp, void* p, int t,
                                     void* stream) {
  concat_lane_off_kernel<<<t / RT, THREADS, 0, (cudaStream_t)stream>>>(
      (const float4*)xp, (float4*)p);
  return (int)cudaGetLastError();
}

extern "C" int probe_scratch_write(const void* x, void* p, int t,
                                   void* stream) {
  scratch_write_kernel<<<t / BR, BTHREADS, 0, (cudaStream_t)stream>>>(
      (const float4*)x, (float4*)p);
  return (int)cudaGetLastError();
}

extern "C" int probe_stack_reshape(const void* x, void* p, int t,
                                   void* stream) {
  stack_reshape_kernel<<<t / BR, BTHREADS, 0, (cudaStream_t)stream>>>(
      (const float4*)x, (float4*)p);
  return (int)cudaGetLastError();
}

extern "C" int probe_dma_assemble(const void* x, void* p, int t,
                                  void* stream) {
  dma_assemble_kernel<<<t / RT, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)p);
  return (int)cudaGetLastError();
}

extern "C" int probe_matmul_after_concat(const void* x, const void* w,
                                         void* y, int t, void* stream) {
  // the blocks of each column: as many as the card holds at once, at most
  // one a row tile
  static const int resident = [] {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, matmul_after_concat_kernel, BTHREADS, 0) != cudaSuccess)
      return 0;
    return sms * per_sm / (N / NB);
  }();
  if (resident < 1) return (int)cudaErrorInvalidConfiguration;
  const int tiles = t / MB;
  const dim3 grid(N / NB, tiles < resident ? tiles : resident);
  matmul_after_concat_kernel<<<grid, BTHREADS, 0, (cudaStream_t)stream>>>(
      (const float4*)x, (const float4*)w, (float4*)y, tiles);
  return (int)cudaGetLastError();
}

extern "C" int probe_matmul_after_scratch(const void* x, const void* w,
                                          void* y, int t, void* stream) {
  const int smem = W_BYTES + RT * PITCH * (int)sizeof(float);
  const int err = with_smem((const void*)matmul_after_scratch_kernel, smem);
  if (err != 0) return err;
  matmul_after_scratch_kernel<<<t / RT, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (float*)y);
  return (int)cudaGetLastError();
}

extern "C" int probe_mini_kernel(const void* xq, const void* w, void* out,
                                 int batch, int fq, int rows, void* stream) {
  const int err = with_smem((const void*)mini_kernel, MINI_SMEM);
  if (err != 0) return err;
  dim3 grid(rows / MT, fq, batch);
  mini_kernel<<<grid, THREADS, MINI_SMEM, (cudaStream_t)stream>>>(
      (const float*)xq, (const float*)w, (float*)out, fq, rows);
  return (int)cudaGetLastError();
}
