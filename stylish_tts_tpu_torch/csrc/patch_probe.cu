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
//      #4's gather on the paired layout: float4 loads at the 128 B column
//      offset of slice j (8 runs of 128 B at a row pitch of 256 B a slice
//      of the block), all issued before #4's float4 stores.
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
//   #8 probe_dma_assemble (:111) -> dma_assemble: the copy engine.  A
//      block owns 8 rows of P; slice j of them is one contiguous 1 KB range
//      of x, one bulk async copy (cp.async.bulk ... mbarrier::complete_tx::
//      bytes) issued by thread j right after it inits mbarrier j, into its
//      own shared buffer, completing on its own mbarrier, the counterpart
//      of the TPU's per-copy DMA semaphore.  Each thread then stores 3
//      float4 of P slice-major, each after its slice's barrier, 8 threads
//      one aligned 128-byte run of a row.  The TPU probe's own structure
//      (rows landing at column 32j of a [8][192] tile, one bulk store out)
//      was timed 0.8 us slower at T = 256 and no faster at T = 131072
//      (PERF.md).
//   #9 probe_matmul_after_concat (:138) -> matmul_after_concat: P's rows
//      are built in registers, 4 columns at a time, from 16-byte loads of x;
//      w is staged in shared memory; Y in f32 FMAs.  A block owns 16 rows x
//      32 columns of Y and stages only its columns of w (24 KB); its four
//      warps split K, each lane keeps a 4 x 4 tile of sums, and the four
//      partial tiles are summed in shared memory in a fixed order.
//  #10 probe_matmul_after_scratch (:159) -> matmul_after_scratch: #9's
//      tiling of Y, but the block's rows of P are first written into a
//      shared scratch at column 32j for slice j (#6's scratch write, by
//      16-byte cp.async into one of two buffers, so the next tile's writes
//      overlap this tile's FMAs) and multiplied from there, a float4 of P
//      (4 k-values of a row) at a time; the scratch's float4 columns are
//      swizzled by row so that those reads meet no bank conflict.  A
//      32 x 32 tile of Y takes over from 16 x 32 where its blocks fill the
//      card.
//  #11 probe_mini_kernel (:183) -> mini_kernel: a miniature of the spec-conv
//      forward, a small implicit GEMM:
//        out[b, f, t, :] = sum_{g=3..8, dt<9} xq[b, f + g/4, t + dt,
//                          32 (g%4) : +32] @ w[32 (9 (g-3) + dt) : +32, :]
//      xq [B, F + 2, R + 8, 128], w [1728, 128], out [B, F, R, 128].  The
//      TPU kernel copies a [3, 264, 128] f32 window (405 KB) per grid step;
//      that does not fit a block's 227 KB.  Here a persistent block keeps 16
//      columns of w resident and walks row tiles of 64 rows; its 12 warps
//      split K by half channel group, each staging by 16-byte cp.async only
//      its part of the six 32-channel groups the function reads (block 0
//      lane 3, block 1 lanes 0-3, block 2 lane 0) for the tile's rows plus
//      the 8-row halo, and reads the 9 taps as lane-offset slices of that
//      window.  A lane keeps 8 consecutive rows x 4 columns of f32 sums; the
//      12 partial tiles are summed in warp order.
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
// chain of dependent memory round trips.  #4-7 keep that chain short: 32
// blocks of 128 threads (8 rows of P each) in place of 8 blocks of 32
// rows, every thread issues all its float4 loads before its first
// dependent store, and every access is 16 bytes a thread, neighbouring
// threads on neighbouring addresses; #8 takes the same block shape, but
// its loads are the copy engine's.  #9 and #10 spread their product over
// 64 blocks (8 before), each a short chain of 48 k-steps a warp.
// At T = 131072 the copies #4 and #6-8 move 117.4 MB (x 16.8 MB, P
// 100.7 MB, more than the 50 MB L2): 35.1 us of bytes, the bound they are
// built for there (#5 reads xp: 134.2 MB, 40.1 us); the products do
// 6.44 GFLOP, 96.2 us at the f32 peak, above their 84.0 MB (25.1 us), and
// their blocks then walk the row tiles, staging w once each.  #11 at
// R = 8192 does 21.7 GFLOP, 324.5 us at the f32 peak, above its 68.0 MB
// (20.3 us), its blocks walking 48 row tiles each.  Device time
// (stylish_tts_tpu_torch/scripts/probe_times.py, NVIDIA H100 80GB HBM3,
// 700.00 W; two runs in one call), at T = 256 and at T = 131072: #4 1.09
// and 42.4 us; #5 1.09-1.10 and 48.2-48.3 us, 83% of the bytes bound (the
// strided reshape 1.66-1.79 and 73.0-73.3; the 32-row design before it
// 1.71-1.83 and 48.7); #6 / #7 1.13-1.15 / 1.16-1.17 and 41.6 / 41.7-41.9
// us; #8 1.43-1.48 and 42.7-42.9 us; #9 2.72-2.75 and 222.2-222.3 us, 43%
// of the f32 bound; #10 2.41-2.42 and 168.6-169.0 us, 57% of it (F.conv1d
// in f32 11.06-11.10 and 249.5-253.3).  #11: 35.4-35.6 us at R = 512,
// 57% of the f32 bound, and 516.9-517.0 us at R = 8192, 63% (F.conv2d over
// all 128 channels, twice the useful FLOP, 153.4-159.9 and 1142-1217; the
// design before it, one block a (b, f, 32 rows), 88.0 and 731.3-731.7).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CIN = 32;          // channels of a slice
constexpr int TAPS = 6;          // slices side by side
constexpr int K = TAPS * CIN;    // 192, the patch width
constexpr int N = 128;           // output columns of the products
constexpr int T_MULT = 32;       // T and rows are multiples of it (the wrapper)

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
// #4-7: small blocks, 16-byte traffic.  A block owns BR rows of P,
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
static_assert(T_MULT % BR == 0, "T is a multiple of BR");
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

// where float4 k of the block, taken slice-major, lies in P
__device__ __forceinline__ size_t patch_index(int r0, int k) {
  const int j = k >> SLICE_LOG2, r = (k >> SQ_LOG2) & (BR - 1);
  return (size_t)(r0 + r) * PQ + j * SQ + (k & (SQ - 1));
}

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
  for (int u = 0; u < OUT_PER_THREAD; ++u)
    p[patch_index(r0, threadIdx.x + u * BTHREADS)] = v[u];
}

// #5: #4's gather from the paired layout xp = [x, 2x], 2 SQ float4 a row.
// Slice j of the block's rows is rows r0 + j .. r0 + j + 7 of xp at float4
// column SQ (j & 1), the 128 B column offset: 8 runs of 128 B at a row
// pitch of 256 B, each read by 8 threads.  The stores are #4's.
__global__ void __launch_bounds__(BTHREADS)
concat_lane_off_kernel(const float4* __restrict__ xp, float4* __restrict__ p) {
  constexpr int XQ = 2 * SQ;  // float4 of a row of xp
  const int r0 = blockIdx.x * BR;
  float4 v[OUT_PER_THREAD];
#pragma unroll
  for (int u = 0; u < OUT_PER_THREAD; ++u) {
    const int k = threadIdx.x + u * BTHREADS, j = k >> SLICE_LOG2;
    const int r = (k >> SQ_LOG2) & (BR - 1);
    v[u] = __ldg(xp + (size_t)(r0 + r + j) * XQ + (j & 1) * SQ +
                 (k & (SQ - 1)));
  }
#pragma unroll
  for (int u = 0; u < OUT_PER_THREAD; ++u)
    p[patch_index(r0, threadIdx.x + u * BTHREADS)] = v[u];
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
// #8: bulk async copies completing on mbarriers, one barrier a slice.  A
// block owns BR rows of P.  Slice j of them is one contiguous BR * 128
// bytes of x: one bulk copy into a buffer of its own, which the block
// writes to P by float4 stores as it lands.

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               "fence.mbarrier_init.release.cluster;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// arrive on `bar` expecting `bytes` more, then copy them from x into shared
// memory; the copy completes them on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const float* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%2], [%3], %1, [%0];\n"
      :: "r"(smem_addr(bar)), "r"(bytes), "r"(smem_addr(dst)),
         "l"(reinterpret_cast<uint64_t>(src))
      : "memory");
}

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

constexpr int ROW_BYTES = CIN * (int)sizeof(float);  // 128, a row of x
static_assert(ROW_BYTES % 16 == 0, "bulk copies move multiples of 16 B");
static_assert(TAPS <= BTHREADS, "one thread a slice copy");

// Threads 0..5 each init bar[j] and copy slice j (rows r0 + j .. r0 + j + 7
// of x, 1 KB) into buf[j]; every thread then takes 3 float4 of P
// slice-major (#4's order), waits on its slice's barrier and stores it.
__global__ void __launch_bounds__(BTHREADS)
dma_assemble_kernel(const float* __restrict__ x, float* __restrict__ p) {
  constexpr int SLICE = BR * SQ;  // float4 of a slice
  __shared__ __align__(128) float4 buf[TAPS][SLICE];
  __shared__ __align__(8) uint64_t bar[TAPS];
  const int r0 = blockIdx.x * BR, tid = threadIdx.x;
  if (tid < TAPS) {
    bar_init(&bar[tid], 1);
    bulk_load(buf[tid], x + (size_t)(r0 + tid) * CIN, BR * ROW_BYTES,
              &bar[tid]);
  }
  __syncthreads();
  float4* out = reinterpret_cast<float4*>(p);
#pragma unroll
  for (int u = 0; u < OUT_PER_THREAD; ++u) {
    const int k = tid + u * BTHREADS, j = k >> SLICE_LOG2;
    wait_phase0(&bar[j]);
    out[patch_index(r0, k)] = buf[j][k & (SLICE - 1)];
  }
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
constexpr int LMB = 32, LNB = 32;         // #10's tile where it fills the card
constexpr int NB4 = NB / 4;               // float4 of a block's row of Y or w
constexpr int N4 = N / 4;                 // float4 of a row of Y or w
constexpr int KSPLIT = BTHREADS / 32;     // warps, one slice of K each
constexpr int KW = K / KSPLIT;            // 48, the depth of a slice
constexpr int TM = 4, TN = 4;             // a lane's tile of Y
static_assert(MB == 4 * TM && NB == 8 * TN, "4 x 8 lanes of TM x TN tiles");
static_assert(MB * NB4 == BTHREADS, "one float4 of Y a thread in the sum");
static_assert(NB4 == SQ && KW % 4 == 0 && T_MULT % MB == 0,
              "the index shifts");

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
// #10: Y = P @ w, multiplied from P written into a shared scratch.  #9's
// tiling: a block owns SMB rows x SNB columns of Y and stages only its
// columns of w, once; the four warps split K and each lane keeps a
// register tile, rows rg + 4i of the block (rg = lane / 8), float4 columns
// cg + 8h (cg = lane % 8); the partial tiles are summed in warp order; the
// blocks of one column walk the row tiles.  The block's rows of P are first
// written into the scratch at column 32j for slice j, by #6's scratch
// write (slice j of the rows is one contiguous range of x, moved float4 by
// float4) in its asynchronous form, 16-byte cp.async, into one of two
// buffers, so the next tile's writes overlap this tile's FMAs.  A k-step of
// four columns reads a float4 of P for each of a lane's rows and a float4
// of w for each column group and k: 8 LDS.128 per 64 FMA at 16 x 32.
//
// The scratch has a pitch of 192 floats, float4 column q of row r stored at
// q ^ (r & 3).  A warp's float4 read of P at one k reads rows 4i .. 4i + 3,
// which a pitch of 192 (6 x 32 banks) would put on the same four banks;
// swizzled they are four distinct float4 of the 32 banks, one wavefront,
// and a lane's swizzle is its rg.  The writes, 8 threads one row's 128
// contiguous bytes of a slice, stay 8 distinct float4 of one 128-byte run.
//
// Two tiles: #9's 16 x 32, which keeps 64 blocks busy at T = 256, and
// LMB x LNB = 32 x 32 where its blocks fill the card, which does twice the
// FMAs for each float4 of w it reads and for each barrier and partial sum
// (PERF.md holds the sweep of large tiles at T = 131072).

template <int SMB, int SNB>
struct ScratchTile {
  static constexpr int NB4 = SNB / 4;        // float4 of a block's row of Y
  static constexpr int TM = SMB / 4;         // rows of a lane
  static constexpr int TN4 = NB4 / 8;        // float4 columns of a lane
  static constexpr int W4 = K * NB4;         // float4 of the block's w
  static constexpr int P4 = SMB * PQ;        // float4 of one scratch buffer
  static constexpr int PART4 = SMB * NB4;    // float4 of a warp's partials
  static constexpr int SMEM = (W4 + 2 * P4 + KSPLIT * PART4) * 16;
  static_assert(SMB % 4 == 0 && T_MULT % SMB == 0,
                "4 row groups; whole tiles");
  static_assert(NB4 % 8 == 0 && N % SNB == 0, "8 column groups; whole N");
  static_assert(TAPS * SMB * SQ % BTHREADS == 0, "whole copies a thread");
};

// Rows t0 .. t0 + SMB - 1 of P into the scratch ps by 16-byte cp.async:
// copy i is float4 k = i % (SMB * 8) of slice j = i / (SMB * 8), row k / 8
// of the tile, float4 column 8j + k % 8 of it.
template <int SMB>
__device__ __forceinline__ void write_scratch(const float4* __restrict__ x,
                                              float4* ps, int t0) {
  constexpr int SLICE = SMB * SQ, LOADS = TAPS * SLICE / BTHREADS;
#pragma unroll
  for (int u = 0; u < LOADS; ++u) {
    const int i = threadIdx.x + u * BTHREADS, j = i / SLICE, k = i % SLICE;
    const int r = k / SQ, q = j * SQ + k % SQ;
    cp_async16(&ps[r * PQ + (q ^ (r & 3))], x + (size_t)(t0 + j) * SQ + k);
  }
}

template <int SMB, int SNB>
__global__ void __launch_bounds__(BTHREADS)
matmul_after_scratch_kernel(const float4* __restrict__ x,
                            const float4* __restrict__ w,
                            float4* __restrict__ y, int tiles) {
  using S = ScratchTile<SMB, SNB>;
  extern __shared__ float4 smem4[];
  float4* ws = smem4;                 // w[:, n0 : n0 + SNB]
  float4* ps = ws + S::W4;            // [2][SMB][PQ], the scratch
  float4* part = ps + 2 * S::P4;      // [KSPLIT][SMB * NB4]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = lane >> 3, cg = lane & 7;
  const int n4 = blockIdx.x * S::NB4;
  for (int i = threadIdx.x; i < S::W4; i += BTHREADS)
    cp_async16(&ws[i], w + (size_t)(i / S::NB4) * N4 + n4 + i % S::NB4);
  int tile = blockIdx.y;  // < tiles: the grid has at most one block a tile
  write_scratch<SMB>(x, ps, tile * SMB);
  cp_async_commit();

  for (int b = 0; tile < tiles; tile += gridDim.y, b ^= 1) {
    const int next = tile + gridDim.y;
    if (next < tiles) write_scratch<SMB>(x, ps + (b ^ 1) * S::P4, next * SMB);
    cp_async_commit();
    cp_async_wait<1>();  // w and this tile's scratch have landed
    __syncthreads();     // ... for every thread's copies
    const float4* pr = ps + b * S::P4 + rg * PQ;
    float acc[S::TM][S::TN4][4] = {};
#pragma unroll
    for (int u = 0; u < KW / 4; ++u) {
      const int g = warp * (KW / 4) + u;  // columns 4g .. 4g + 3 of P
      float4 a[S::TM];
#pragma unroll
      for (int i = 0; i < S::TM; ++i) a[i] = pr[4 * i * PQ + (g ^ rg)];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int h = 0; h < S::TN4; ++h) {
          const float4 bv = ws[(4 * g + kk) * S::NB4 + cg + 8 * h];
#pragma unroll
          for (int i = 0; i < S::TM; ++i) {
            const float av = part_of(a[i], kk);
            acc[i][h][0] = fmaf(av, bv.x, acc[i][h][0]);
            acc[i][h][1] = fmaf(av, bv.y, acc[i][h][1]);
            acc[i][h][2] = fmaf(av, bv.z, acc[i][h][2]);
            acc[i][h][3] = fmaf(av, bv.w, acc[i][h][3]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < S::TM; ++i)
#pragma unroll
      for (int h = 0; h < S::TN4; ++h)
        part[warp * S::PART4 + (rg + 4 * i) * S::NB4 + cg + 8 * h] =
            make_float4(acc[i][h][0], acc[i][h][1], acc[i][h][2],
                        acc[i][h][3]);
    // every warp's partials are written and every read of scratch b is
    // done, so the next step may refill b
    __syncthreads();
    for (int v = threadIdx.x; v < S::PART4; v += BTHREADS) {
      float4 s = part[v];
#pragma unroll
      for (int q = 1; q < KSPLIT; ++q) {
        const float4 o = part[q * S::PART4 + v];
        s.x += o.x; s.y += o.y; s.z += o.z; s.w += o.w;
      }
      y[(size_t)(tile * SMB + v / S::NB4) * N4 + n4 + v % S::NB4] = s;
    }
  }
}

// ------------------------------------------------------------------------- //
// #11: the miniature spec-conv forward as a tiled, persistent f32 implicit
// GEMM.  Its rows are (b, f, t), M = B F R, its columns the N = 128 outputs,
// its K = 1728 runs over (group gi, tap dt, channel c): k = 32 (9 gi + dt)
// + c, reading xq[b, f + g / 4, t + dt, 32 (g % 4) + c], g = gi + 3.
//
// A block owns MNB = 16 columns and keeps their slice of w resident in
// shared memory (108 KB, staged once); the blocks of a column walk the row
// tiles of MMT = 64 rows (one (b, f), up to 64 consecutive t).  Its 12
// warps split K: warp (gi, h) takes channels 16h .. 16h + 15 of group gi
// at all 9 taps (144 k).  Each warp stages its own part of the tile's
// window (the 72 rows t0 .. t0 + 71 of those channels: the TPU probe's six
// used groups, copied by offset from the tile index) and its own 144 rows
// of the w slice by 16-byte cp.async, and waits for its own copies only.
//
// A lane keeps 8 consecutive rows x 4 columns of sums: rows 8 rg .. 8 rg
// + 7 (rg = lane / 4), columns 4 cg .. 4 cg + 3 (cg = lane % 4).  Tap dt
// is the window's lane-offset slice that starts dt rows down, so for four
// channels the lane reads the 16 rows 8 rg .. 8 rg + 15 once, as float4,
// and uses each at every tap that reaches it: 16 + 36 LDS.128 (x, then a
// float4 of w a tap and channel) for 1152 FMAs.  A float4 read delivers 4
// words to each lane, and an SM delivers 32 words a clock against 128
// FMAs: a 4 x 4 tile of strided rows (2 FMAs a word) is held to half the
// FMA rate, and this tile's 5.5 FMAs a word lift that ceiling (PERF.md
// holds both designs' times).
// The window's rows are 128 B, float4 column q of row r at
// q ^ ((r >> 3) & 7): the 8 rows a warp reads at once are 8 apart and
// meet no bank conflict.
//
// A warp issues the next tile's window as soon as its lanes are done with
// this one's, so the copy runs during the partial sums.  The 12 partial
// tiles meet in shared memory and are summed in warp order (two barriers
// a tile): the output does not depend on the grid.  Where R is no multiple
// of MMT, the last tile of each (b, f) has 32 rows: the window rows past
// R + 7 are not copied and only rows past R read them, which are not
// stored.

constexpr int GROUPS = 6;                 // 32-channel groups g = 3..8
constexpr int KT = 9;                     // taps on t
constexpr int MK = GROUPS * KT * CIN;     // 1728
constexpr int XQ4 = 4 * SQ;               // float4 of a row of xq
constexpr int MMT = 64;                   // rows of a tile
constexpr int LROWS = 8;                  // consecutive rows of a lane
constexpr int LWIN = LROWS + KT - 1;      // rows of the window a lane reads
constexpr int MNB = 16;                   // columns of a block
constexpr int MNB4 = MNB / 4;             // float4 of a block's row of w
constexpr int HALF = CIN / 2;             // channels of a warp's part
constexpr int HQ = HALF / 4;              // float4 of a row of that part
constexpr int MWARPS = 2 * GROUPS;        // one a half group
constexpr int MTHREADS = 32 * MWARPS;
constexpr int MWIN = MMT + KT - 1;        // rows of a tile's window
constexpr int WIN4 = MWIN * SQ;           // float4 of a group's window
constexpr int MW4 = MK * MNB4;            // float4 of the w slice
constexpr int MPART4 = MMT * MNB4;        // float4 of a tile of sums
constexpr int MINI_SMEM = (MW4 + GROUPS * WIN4 + MWARPS * MPART4) * 16;
static_assert(MMT == 8 * LROWS && MNB4 == 4, "8 x 4 lanes of 8 x 4 tiles");
static_assert(MPART4 <= MTHREADS && MPART4 % 32 == 0, "the sum's threads");
static_assert(T_MULT == MMT / 2 && N % MNB == 0, "whole or half tiles");

// This warp's part of the window of the row tile at (bf, t0) into xw, its
// group's [MWIN][SQ] buffer: rows t0 .. t0 + MWIN - 1 (those below R + 8)
// of channels 32 (g % 4) + 16 h .. + 15 of frequency block f + g / 4.
__device__ __forceinline__ void stage_window(const float4* __restrict__ xq,
                                             float4* xw, int bf, int t0,
                                             int fq, int rows, int g, int h,
                                             int lane) {
  const int b = bf / fq, f = bf - b * fq, in_rows = rows + KT - 1;
  const int valid = min(MWIN, in_rows - t0);
  const float4* src =
      xq + ((size_t)(b * (fq + 2) + f + g / 4) * in_rows + t0) * XQ4 +
      (g % 4) * SQ + h * HQ;
  for (int i = lane; i < valid * HQ; i += 32) {
    const int r = i / HQ, q = h * HQ + i % HQ;
    cp_async16(&xw[r * SQ + (q ^ ((r >> 3) & 7))],
               src + (size_t)r * XQ4 + i % HQ);
  }
}

__global__ void __launch_bounds__(MTHREADS, 1)
mini_kernel(const float4* __restrict__ xq, const float4* __restrict__ w,
            float4* __restrict__ out, int fq, int rows, int tiles) {
  extern __shared__ float4 smem4[];
  float4* ws = smem4;                   // [MK][MNB4], the w slice
  float4* xs = ws + MW4;                // [GROUPS][MWIN][SQ], the window
  float4* part = xs + GROUPS * WIN4;    // [MWARPS][LROWS][32 lanes]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gi = warp >> 1, h = warp & 1, g = gi + 3;
  const int rg = lane >> 2, cg = lane & 3;
  const int n4 = blockIdx.x * MNB4;
  const int row_tiles = (rows + MMT - 1) / MMT;  // tiles of one (b, f)
  // the warp's rows of the w slice, k = 32 (9 gi + dt) + 16 h + c
  for (int i = lane; i < KT * HALF * MNB4; i += 32) {
    const int dt = i / (HALF * MNB4), c = i / MNB4 % HALF, c4 = i % MNB4;
    const int k = CIN * (KT * gi + dt) + HALF * h + c;
    cp_async16(&ws[k * MNB4 + c4], w + (size_t)k * N4 + n4 + c4);
  }
  float4* xw = xs + gi * WIN4;  // the warp's group
  int tile = blockIdx.y;        // < tiles: at most one block a tile
  stage_window(xq, xw, tile / row_tiles, tile % row_tiles * MMT, fq, rows, g,
               h, lane);
  cp_async_commit();

  const float4* wk = ws + (CIN * KT * gi + HALF * h) * MNB4 + cg;
  for (; tile < tiles; tile += gridDim.y) {
    cp_async_wait<0>();  // the w slice and this tile's window, own copies
    __syncwarp();        // ... and the warp's other lanes'
    float acc[LROWS][4] = {};
#pragma unroll 1
    for (int q = 0; q < HQ; ++q) {
      const int col = h * HQ + q;          // float4 column of the window
      float4 a[LWIN];                      // rows 8 rg + m
#pragma unroll
      for (int m = 0; m < LWIN; ++m) {
        const int r = LROWS * rg + m;
        a[m] = xw[r * SQ + (col ^ ((r >> 3) & 7))];
      }
      const float4* wq = wk + 4 * q * MNB4;
#pragma unroll
      for (int dt = 0; dt < KT; ++dt)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 bv = wq[(CIN * dt + kk) * MNB4];
#pragma unroll
          for (int i = 0; i < LROWS; ++i) {
            const float av = part_of(a[i + dt], kk);
            acc[i][0] = fmaf(av, bv.x, acc[i][0]);
            acc[i][1] = fmaf(av, bv.y, acc[i][1]);
            acc[i][2] = fmaf(av, bv.z, acc[i][2]);
            acc[i][3] = fmaf(av, bv.w, acc[i][3]);
          }
        }
    }
    __syncwarp();  // every lane is done with the window: refill it
    const int next = tile + gridDim.y;
    if (next < tiles)
      stage_window(xq, xw, next / row_tiles, next % row_tiles * MMT, fq, rows,
                   g, h, lane);
    cp_async_commit();
    __syncthreads();  // every thread is done summing the last tile
#pragma unroll
    for (int i = 0; i < LROWS; ++i)
      part[(warp * LROWS + i) * 32 + lane] =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    __syncthreads();  // every warp's partials are in
    if (threadIdx.x < MPART4) {  // row 8 (l / 4) + i, float4 column l % 4
      const int i = threadIdx.x >> 5, l = threadIdx.x & 31;
      float4 s = part[threadIdx.x];
#pragma unroll
      for (int q = 1; q < MWARPS; ++q) {
        const float4 o = part[q * MPART4 + threadIdx.x];
        s.x += o.x; s.y += o.y; s.z += o.z; s.w += o.w;
      }
      const int bf = tile / row_tiles;
      const int t = tile % row_tiles * MMT + LROWS * (l >> 2) + i;
      if (t < rows)
        out[((size_t)bf * rows + t) * N4 + n4 + (l & 3)] = s;
    }
  }
}

// #9-11 over the card: N / nb columns of blocks, each of as many blocks as
// the card holds at once (an occupancy query), at most one a row tile; the
// blocks of a column walk the rest.  A kernel's last argument is the
// number of row tiles.
template <typename Kernel>
int resident_per_column(Kernel kernel, int threads, int smem, int nb) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess ||
      cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, threads, smem) != cudaSuccess)
    return 0;
  return sms * per_sm / (N / nb);
}

template <typename Kernel, typename... Args>
int walk_launch(Kernel kernel, int resident, int threads, int smem, int nb,
                int tiles, void* stream, Args... args) {
  if (resident < 1) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid(N / nb, tiles < resident ? tiles : resident);
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(args..., tiles);
  return (int)cudaGetLastError();
}

// #10 in one tile shape; its residency is queried once
template <int SMB, int SNB>
struct Scratch {
  static constexpr int smem = ScratchTile<SMB, SNB>::SMEM;
  static int resident() {
    static const int r = resident_per_column(
        matmul_after_scratch_kernel<SMB, SNB>, BTHREADS, smem, SNB);
    return r;
  }
  static int launch(const void* x, const void* w, void* y, int t,
                    void* stream) {
    return walk_launch(matmul_after_scratch_kernel<SMB, SNB>, resident(),
                       BTHREADS, smem, SNB, t / SMB, stream,
                       (const float4*)x, (const float4*)w, (float4*)y);
  }
};

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
  concat_lane_off_kernel<<<t / BR, BTHREADS, 0, (cudaStream_t)stream>>>(
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
  dma_assemble_kernel<<<t / BR, BTHREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)p);
  return (int)cudaGetLastError();
}

extern "C" int probe_matmul_after_concat(const void* x, const void* w,
                                         void* y, int t, void* stream) {
  static const int resident =
      resident_per_column(matmul_after_concat_kernel, BTHREADS, 0, NB);
  return walk_launch(matmul_after_concat_kernel, resident, BTHREADS, 0, NB,
                     t / MB, stream, (const float4*)x, (const float4*)w,
                     (float4*)y);
}

extern "C" int probe_matmul_after_scratch(const void* x, const void* w,
                                          void* y, int t, void* stream) {
  // the large tile where its blocks fill the card, else #9's 16 x 32
  if (t / LMB >= Scratch<LMB, LNB>::resident())
    return Scratch<LMB, LNB>::launch(x, w, y, t, stream);
  return Scratch<MB, NB>::launch(x, w, y, t, stream);
}

extern "C" int probe_mini_kernel(const void* xq, const void* w, void* out,
                                 int batch, int fq, int rows, void* stream) {
  static const int resident =
      resident_per_column(mini_kernel, MTHREADS, MINI_SMEM, MNB);
  return walk_launch(mini_kernel, resident, MTHREADS, MINI_SMEM, MNB,
                     batch * fq * ((rows + MMT - 1) / MMT), stream,
                     (const float4*)xq, (const float4*)w, (float4*)out, fq,
                     rows);
}
