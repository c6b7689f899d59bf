// Forward real STFT for Hopper (sm_90a), f32 in, f32 out.
//
// Replaces the TPU kernel stylish_tts_tpu/ops/stft_pallas.py:_stft_kernel
// (launched by stft_pallas): reflect-pad by n_fft/2, frame at `hop`, and
// multiply each frame by the windowed DFT basis (cos | -sin columns) with
// f32 accumulation.  Outputs (real, imag), each [B, frames, n_fft/2+1].
//
// What bounds it on the card.  The function itself is bound by bytes: an
// FFT needs about 2.5*n_fft*log2(n_fft) FLOP per frame, far below the
// 8*(n_fft/2+1) bytes each frame writes, so writing (real, imag) once at
// 3.35 TB/s is the least time (0.094 ms for the main path's [8, 348000]).
// This kernel keeps the TPU kernel's DFT-product formulation instead:
// 2*1199*2050 FLOP per frame at the synthesis shape (n_fft 2048, hop 75,
// win 1200), about 530 FLOP per byte at B=4 over 10 s, so the kernel is
// bound by f32 FMA throughput (67 TFLOP/s on the H100 SXM), and that
// formulation, not the card, puts it about 60x above the function's bound.
// A tensor-core DFT (3xTF32 for f32 accuracy) or an FFT written by hand is
// the way to close that gap.  Within the DFT formulation it is built to
// keep the FMA units fed:
//
//  * one block per (batch, 64-frame tile, 128-column tile).  It stages the
//    contiguous span of the reflect-padded signal that its frames cover in
//    shared memory once (the reflection is done while staging; frames
//    overlap n_fft/hop ~ 27x at hop 75, so no frame matrix is ever built);
//  * only the taps where the window is non-zero are multiplied (the basis
//    rows outside [(n_fft-win)/2, (n_fft+win)/2) are zero): exact, and 41%
//    less work at win 1200;
//  * the basis, [taps, 2F] padded to a multiple of 16 rows and 128 columns
//    (10.4 MB at n_fft 2048, win 1200), stays in the 50 MB L2; each
//    block streams its 128 columns through a double-buffered shared tile
//    of 16 taps, prefetched into registers during the previous step;
//  * each thread accumulates an 8-frame x 4-column register tile on the
//    f32 FMA units.  Within a warp the 8 signal values are broadcast reads
//    and the 4 basis values are conflict-free, so a tap costs 12 shared
//    loads for 32 FMAs.  Tensor cores (3xTF32 to keep f32 accuracy), TMA
//    and wgmma are left for later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_F = 64;      // frames per block
constexpr int TILE_C = 128;     // basis columns per block
constexpr int KC = 16;          // taps per pipeline step
constexpr int THREADS = 256;    // 8 warps: warp w owns frames w + 8*i
constexpr int FR = TILE_F / (THREADS / 32);  // frames per thread (8)
constexpr int CR = TILE_C / 32;              // columns per thread (4)

__global__ void __launch_bounds__(THREADS)
stft_forward_kernel(const float* __restrict__ x,      // [B, T]
                    const float* __restrict__ basis,  // [k_pad, c_pad]
                    float* __restrict__ real,         // [B, frames, F]
                    float* __restrict__ imag,         // [B, frames, F]
                    int T, int frames, int pad, int hop, int lo,
                    int k_pad, int F, int c_pad) {
  extern __shared__ __align__(16) float smem[];
  float* btile = smem;                   // [2][KC][TILE_C]
  float* span = smem + 2 * KC * TILE_C;  // [(TILE_F-1)*hop + k_pad]

  const int b = blockIdx.z;
  const int f0 = blockIdx.x * TILE_F;
  const int c0 = blockIdx.y * TILE_C;
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;

  // stage the padded-signal span of this frame tile: padded index
  // p = f*hop + lo + k maps to x[p - pad], reflected at both ends
  const float* xb = x + (size_t)b * T;
  const long long p0 = (long long)f0 * hop + lo;
  const long long t_padded = (long long)T + 2LL * pad;
  const int span_len = (TILE_F - 1) * hop + k_pad;
  for (int i = threadIdx.x; i < span_len; i += THREADS) {
    const long long p = p0 + i;
    float v = 0.f;
    if (p < t_padded) {
      long long s = p - pad;
      if (s < 0) s = -s;
      else if (s >= T) s = 2LL * (T - 1) - s;
      v = __ldg(xb + s);
    }
    span[i] = v;
  }

  // basis tile loads: KC x TILE_C floats = 512 float4, two per thread
  const float* bcol = basis + c0;
  float4 stage[2];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int q = threadIdx.x + u * THREADS;
      const int row = q / (TILE_C / 4);
      const int c4 = q % (TILE_C / 4);
      stage[u] = __ldg(reinterpret_cast<const float4*>(
          bcol + (size_t)(k0 + row) * c_pad + c4 * 4));
    }
  };
  auto store_tile = [&](float* dst) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int q = threadIdx.x + u * THREADS;
      reinterpret_cast<float4*>(dst)[q] = stage[u];
    }
  };

  float acc[FR][CR];
#pragma unroll
  for (int i = 0; i < FR; ++i)
#pragma unroll
    for (int j = 0; j < CR; ++j) acc[i][j] = 0.f;

  load_tile(0);
  store_tile(btile);
  __syncthreads();  // span and the first basis tile are in place

  const int steps = k_pad / KC;
  for (int kt = 0; kt < steps; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < steps) load_tile((kt + 1) * KC);
    const float* bt = btile + cur * KC * TILE_C;
    const float* sp = span + kt * KC + ty * hop;
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      float a[FR], bv[CR];
#pragma unroll
      for (int i = 0; i < FR; ++i) a[i] = sp[i * (THREADS / 32) * hop + k];
#pragma unroll
      for (int j = 0; j < CR; ++j) bv[j] = bt[k * TILE_C + tx + 32 * j];
#pragma unroll
      for (int i = 0; i < FR; ++i)
#pragma unroll
        for (int j = 0; j < CR; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    // the other buffer was last read in step kt-1, before its barrier
    if (kt + 1 < steps) store_tile(btile + (cur ^ 1) * KC * TILE_C);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < FR; ++i) {
    const int f = f0 + ty + i * (THREADS / 32);
    if (f >= frames) continue;
    const size_t row = ((size_t)b * frames + f) * F;
#pragma unroll
    for (int j = 0; j < CR; ++j) {
      const int c = c0 + tx + 32 * j;
      if (c < F) real[row + c] = acc[i][j];
      else if (c < 2 * F) imag[row + c - F] = acc[i][j];
    }
  }
}

}  // namespace

// Shared memory the kernel needs for a given hop and padded tap count.
extern "C" int stft_forward_smem_bytes(int hop, int k_pad) {
  return (int)sizeof(float) * (2 * KC * TILE_C + (TILE_F - 1) * hop + k_pad);
}

// Launch on `stream`; returns cudaGetLastError() of the launch (0 = ok).
// Requires T > pad, k_pad % 16 == 0, c_pad % 128 == 0, c_pad >= 2F.
extern "C" int stft_forward_f32(const void* x, const void* basis, void* real,
                                void* imag, int batch, int T, int frames,
                                int pad, int hop, int lo, int k_pad, int F,
                                int c_pad, void* stream) {
  const int smem = stft_forward_smem_bytes(hop, k_pad);
  cudaError_t err = cudaFuncSetAttribute(
      stft_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((frames + TILE_F - 1) / TILE_F, c_pad / TILE_C, batch);
  stft_forward_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)basis, (float*)real, (float*)imag, T,
      frames, pad, hop, lo, k_pad, F, c_pad);
  return (int)cudaGetLastError();
}
