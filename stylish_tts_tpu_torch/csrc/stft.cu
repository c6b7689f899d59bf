// Forward real STFT for Hopper (sm_90a) by a shared-memory real FFT, f32
// in, f32 out.
//
// Replaces the TPU kernel stylish_tts_tpu/ops/stft_pallas.py:_stft_kernel
// (kernel :43, launched by stft_pallas :81): reflect-pad [B, T] by n_fft/2,
// frame at `hop`, multiply by the Hann window centre-padded to n_fft, and
// take the one-sided DFT with torch's e^{-j2πkn/N} sign.  Outputs (real,
// imag), each [B, frames, n_fft/2+1], planar.  The TPU kernel multiplies
// each frame by a windowed DFT basis, O(n_fft^2) work per frame; this one
// computes the same function by an FFT.
//
// What bounds it on the card.  Bytes: the signal read once and (real,
// imag) written once, 8*(n_fft/2+1) bytes per frame.  At the train step's
// [8, 138000] (n_fft 2048, hop 75, win 1200: 14,728 frames) that is
// 4.4 MB in and 120.8 MB out, 0.0374 ms at 3.35 TB/s; at the synthesis
// prior's [8, 348000], 0.094 ms.  The FFT needs about
// 2.5*N*log2(N) + N = 58 kFLOP per frame (0.86 GFLOP at the train shape,
// 0.0128 ms on the f32 units at 67 TFLOP/s), about 3x below the bytes.
// The windowed DFT product of the TPU kernel did 2*1200*2050 = 4.9 MFLOP
// per frame, 85x this.  The design keeps the work near the FFT's and the
// traffic near the bytes bound:
//
//  * One block of 256 threads owns FPB consecutive frames of one batch
//    row, n_fft/16 threads per frame: 2 frames at n_fft 2048, 4 at 1024,
//    8 at 512.  It stages the contiguous span of the reflect-padded signal
//    that those frames' non-zero window taps [lo, hi) cover,
//    (FPB-1)*hop + (hi-lo) floats, into shared memory once, reflecting
//    while it stages.  Frames overlap n_fft/hop = 27x at hop 75, so no
//    frame matrix is ever built in device memory.
//  * Window while loading.  Samples outside [lo, hi) are zero and are
//    neither staged nor loaded.  The window is the port's own f32 padded
//    Hann window (ops/stft.py:_padded_window), read from device memory, so
//    the kernel and the plain version multiply by the same numbers.
//  * Real FFT by packing.  The N real samples become N/2 complex ones,
//    z[m] = x[2m] + i*x[2m+1]; an N/2-point complex FFT Z runs in shared
//    memory; one pass unpacks all N/2+1 bins,
//      X[k] = (Z[k] + Z*[M-k])/2 - i/2 * e^{-2πik/N} (Z[k] - Z*[M-k]),
//    M = N/2, Z[M] = Z[0].  That halves the FFT's work and its buffer:
//    9 KB per frame at N 2048 with the padding below.  A thread unpacks
//    bins k and M-k together from the same two loads and one twiddle:
//    with E = (Z[k] + Z*[M-k])/2 and W O = X[k] - E, X[M-k] = (E - W O)*.
//    The DC and Nyquist bins, Z[0].x ± Z[0].y, are real, and their
//    imaginary parts are written as exact zeros: the generator takes the
//    phase of its prior's bins with atan2, which turns the sign of a
//    rounding error there into a jump from π to -π.
//  * Few passes through shared memory.  Each thread holds 8 complex values
//    in registers per pass and does one radix-8 butterfly (or two radix-4,
//    or four radix-2 in the last pass).  Between passes the values go
//    through the frame's buffer in Stockham order, so no bit-reversal pass
//    is needed: M = 1024 takes radices 8, 8, 8, 2, four passes.  The first
//    pass reads the windowed samples straight from the staged span; the
//    unpacking pass writes (real, imag) from the last buffer.
//  * Padded buffer.  Complex value p sits at p + p/8: the first pass
//    writes at a stride of 8 complex values (16 banks apart), which the
//    padding spreads over all 32 banks, and the other passes' accesses are
//    near-contiguous.
//  * Accurate twiddles, read coalesced.  All are made in double on the
//    host by stft_fft_twiddles below and rounded to f32 once (12 KB at
//    N 2048), read through __ldg: first the unpacking's e^{-2πik/N},
//    k = 0..M/2, then for each Stockham pass after the first (sub-transform
//    size NS, radix R) the rows r = 1..R-1 of e^{-2πi r k/(NS R)},
//    k = 0..NS-1.  Neighbouring threads of a pass have neighbouring k, so
//    they read neighbouring entries.  The passes and the table both follow
//    pass_radix, so the layout is defined in this file alone.  No
//    __sinf/__cosf and no fast-math.
//  * Write once, coalesced.  Neighbouring threads unpack neighbouring
//    pairs, so their stores to bins k (and to bins M-k) are neighbours,
//    scalar stores: rows of N/2+1 floats are not 16-byte aligned.
//  * 32-bit index arithmetic (the wrapper checks that the padded signal's
//    length fits): fewer registers a thread, so more blocks on an SM.
//
// n_fft is a power of two from 256 to 4096 on this FFT path.
//
// The DFT path (stft_dft_kernel, below) takes any even n_fft up to 128:
// the ringformer head's 60-point STFT (hop 15, window 60) of its harmonic
// source and of its magphase target.  At such sizes an FFT saves little
// and its radix plan would not fit 60 = 2^2 * 3 * 5, so the kernel takes
// the windowed DFT as the TPU kernel does, by f32 FMAs over the window's
// taps:
//
//  * The windowed basis [n_fft, 2*(n_fft/2+1)] f32 (cos * w, -sin * w;
//    the plain version's own table, ops/stft.py:forward_basis, made on the
//    host and uploaded once per device) is staged once per block, its rows
//    lo..hi-1 only: 14.6 KB at n_fft 60.
//  * A block of 256 threads owns DFT_FPB = 128 consecutive frames of one
//    batch row and stages their span of the reflect-padded signal,
//    (DFT_FPB-1)*hop + (hi-lo) floats, with coalesced loads, reflecting
//    while it stages, as the FFT path does.
//  * Each thread computes one bin of DFT_FR = 4 consecutive frames, real
//    and imaginary parts together, one tap after another: each tap's two
//    basis words serve four frames, so a tap costs 6 shared-memory reads
//    for 8 FMAs (3 for 2 with a (frame, bin) pair a thread).  Neighbouring
//    threads take neighbouring bins of one frame group, so they read one
//    span word per frame (a broadcast) and neighbouring basis words, and
//    their stores to (real, imag) are neighbours: [B, frames, bins] is
//    written once, coalesced.  Each (frame, bin) sums its taps in order,
//    as a thread of one pair would.
//
// Bound at the ringformer step's [8, 138000] (9,201 frames x 31 bins):
// 4.42 MB in and 18.26 MB out, 6.77 us at 3.35 TB/s.  The function needs a
// real FFT's 2.5*60*log2(60) + 60 = 946 FLOP a frame, 0.070 GFLOP, 1.0 us
// at 67 TFLOP/s f32, so the bytes bound it.  This kernel does the windowed
// DFT's 2*2*60 FLOP a (frame, bin) pair instead, 7.9x that: 0.548 GFLOP,
// 8.2 us at the f32 peak.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int THREADS = 256;

// Radix of the Stockham pass at sub-transform size ns of an m-point FFT:
// 8 while it fits, then one pass of 2 or 4.  The kernel's passes and the
// twiddle table's rows both follow it.
__host__ __device__ constexpr int pass_radix(int m, int ns) {
  return m / ns >= 8 ? 8 : m / ns;
}

__device__ __forceinline__ int padded(int p) { return p + (p >> 3); }

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 mul_neg_i(float2 a) {  // a * (-i)
  return make_float2(a.y, -a.x);
}

// In-place DFT of R values in natural order, e^{-2πirs/R}.
template <int R>
__device__ __forceinline__ void dft(float2* v) {
  if constexpr (R == 2) {
    const float2 a = v[0], b = v[1];
    v[0] = cadd(a, b);
    v[1] = csub(a, b);
  } else if constexpr (R == 4) {
    const float2 c0 = cadd(v[0], v[2]), c2 = csub(v[0], v[2]);
    const float2 c1 = cadd(v[1], v[3]), c3 = mul_neg_i(csub(v[1], v[3]));
    v[0] = cadd(c0, c1);
    v[1] = cadd(c2, c3);
    v[2] = csub(c0, c1);
    v[3] = csub(c2, c3);
  } else {
    static_assert(R == 8, "radix 2, 4 or 8");
    constexpr float s = 0.70710678118654752f;
    const float2 b0 = cadd(v[0], v[4]), b4 = csub(v[0], v[4]);
    const float2 b1 = cadd(v[1], v[5]), d5 = csub(v[1], v[5]);
    const float2 b2 = cadd(v[2], v[6]), d6 = csub(v[2], v[6]);
    const float2 b3 = cadd(v[3], v[7]), d7 = csub(v[3], v[7]);
    // the odd half's twiddles e^{-2πis/8}, s = 1, 2, 3
    const float2 b5 = make_float2(s * (d5.x + d5.y), s * (d5.y - d5.x));
    const float2 b6 = mul_neg_i(d6);
    const float2 b7 = make_float2(s * (d7.y - d7.x), -s * (d7.x + d7.y));
    const float2 c0 = cadd(b0, b2), c2 = csub(b0, b2);
    const float2 c1 = cadd(b1, b3), c3 = mul_neg_i(csub(b1, b3));
    const float2 c4 = cadd(b4, b6), c6 = csub(b4, b6);
    const float2 c5 = cadd(b5, b7), c7 = mul_neg_i(csub(b5, b7));
    v[0] = cadd(c0, c1);
    v[4] = csub(c0, c1);
    v[2] = cadd(c2, c3);
    v[6] = csub(c2, c3);
    v[1] = cadd(c4, c5);
    v[5] = csub(c4, c5);
    v[3] = cadd(c6, c7);
    v[7] = csub(c6, c7);
  }
}

// The Stockham passes after the first, from sub-transform size NS up to M:
// thread j0 of the frame holds 8 values, 8/R butterflies of radix R.  The
// pass's twiddles e^{-2πi r k/(NS R)} are tw[(r-1)*NS + k].
template <int M, int NS>
__device__ __forceinline__ void fft_passes(float2* buf, int j0,
                                           const float2* __restrict__ tw) {
  if constexpr (NS < M) {
    constexpr int R = pass_radix(M, NS);
    constexpr int PER = 8 / R;
    constexpr int TPF = M / 8;
    float2 v[8];
#pragma unroll
    for (int s = 0; s < PER; ++s)
#pragma unroll
      for (int r = 0; r < R; ++r)
        v[s * R + r] = buf[padded(j0 + s * TPF + r * (M / R))];
    __syncthreads();  // every value of the pass is in registers
#pragma unroll
    for (int s = 0; s < PER; ++s) {
      const int j = j0 + s * TPF;
      const int k = j % NS;
      float2* u = v + s * R;
#pragma unroll
      for (int r = 1; r < R; ++r)
        u[r] = cmul(u[r], __ldg(tw + (r - 1) * NS + k));
      dft<R>(u);
      const int d = (j / NS) * NS * R + k;
#pragma unroll
      for (int r = 0; r < R; ++r) buf[padded(d + r * NS)] = u[r];
    }
    __syncthreads();
    fft_passes<M, NS * R>(buf, j0, tw + (R - 1) * NS);
  }
}

template <int LOG_N>
__global__ void __launch_bounds__(THREADS)
stft_fft_kernel(const float* __restrict__ x,       // [B, T]
                const float* __restrict__ window,  // [n_fft]
                const float2* __restrict__ tw,     // twiddles, see above
                float* __restrict__ real,          // [B, frames, M + 1]
                float* __restrict__ imag,          // [B, frames, M + 1]
                int T, int frames, int pad, int hop, int lo, int hi) {
  constexpr int N = 1 << LOG_N;
  constexpr int M = N / 2;             // complex points of the FFT
  constexpr int TPF = M / 8;           // threads per frame
  constexpr int FPB = THREADS / TPF;   // frames per block
  constexpr int BUF = M + M / 8;       // padded slots per frame
  constexpr int F = M + 1;             // bins per frame
  constexpr int PAIRS = M / 2 + 1;     // bin pairs (k, M-k) per frame
  extern __shared__ __align__(16) unsigned char smem[];
  float2* bufs = reinterpret_cast<float2*>(smem);  // [FPB][BUF]
  float* span = reinterpret_cast<float*>(bufs + FPB * BUF);

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * FPB;
  const int fl = threadIdx.x / TPF;
  const int j0 = threadIdx.x % TPF;

  // stage the span of padded samples f0*hop + lo + i, reflected at both
  // ends of x, zero past the padded signal's end (frames past `frames`)
  const float* xb = x + (size_t)b * T;
  const int p0 = f0 * hop + lo;
  const int t_padded = T + 2 * pad;
  const int span_len = (FPB - 1) * hop + (hi - lo);
  for (int i = threadIdx.x; i < span_len; i += THREADS) {
    const int p = p0 + i;
    float v = 0.f;
    if (p < t_padded) {
      int s = p - pad;
      s = s < 0 ? -s : (s >= T ? 2 * (T - 1) - s : s);
      v = __ldg(xb + s);
    }
    span[i] = v;
  }
  __syncthreads();

  // first pass (sub-transform size 1, radix 8, no twiddles): the packed,
  // windowed samples z[j0 + r*M/8] straight from the span
  float2* buf = bufs + fl * BUF;
  const float* fs = span + fl * hop;  // fs[n - lo]: frame sample n
  float2 v[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int n = 2 * (j0 + r * (M / 8));
    float a = 0.f, c = 0.f;
    if (n >= lo && n < hi) a = fs[n - lo] * __ldg(window + n);
    if (n + 1 >= lo && n + 1 < hi) c = fs[n + 1 - lo] * __ldg(window + n + 1);
    v[r] = make_float2(a, c);
  }
  dft<8>(v);
#pragma unroll
  for (int r = 0; r < 8; ++r) buf[padded(8 * j0 + r)] = v[r];
  __syncthreads();
  fft_passes<M, 8>(buf, j0, tw + PAIRS);

  // unpack the N/2+1 bins of each frame in pairs (k, M-k), k = 0..M/2,
  // and write them once
  const int nf = min(FPB, frames - f0);
  const size_t row0 = ((size_t)b * frames + f0) * F;
  for (int idx = threadIdx.x; idx < nf * PAIRS; idx += THREADS) {
    const int g = idx / PAIRS;
    const int k = idx - g * PAIRS;
    const float2* z = bufs + g * BUF;
    float* re = real + row0 + (size_t)g * F;
    float* im = imag + row0 + (size_t)g * F;
    if (k == 0) {  // DC and Nyquist
      const float2 z0 = z[0];
      re[0] = z0.x + z0.y;
      im[0] = 0.f;
      re[M] = z0.x - z0.y;
      im[M] = 0.f;
      continue;
    }
    // E = (a + c*)/2 from the even samples, O = (a - c*)/2i from the odd
    const float2 a = z[padded(k)], c = z[padded(M - k)];
    const float er = 0.5f * (a.x + c.x), ei = 0.5f * (a.y - c.y);
    const float o_r = 0.5f * (a.y + c.y), o_i = -0.5f * (a.x - c.x);
    const float2 w = __ldg(tw + k);
    const float wr = w.x * o_r - w.y * o_i, wi = w.x * o_i + w.y * o_r;
    re[k] = er + wr;
    im[k] = ei + wi;
    if (k < M - k) {  // X[M-k] = (E - W O)*
      re[M - k] = er - wr;
      im[M - k] = wi - ei;
    }
  }
}

int frames_per_block(int n_fft) { return THREADS / (n_fft / 16); }

template <int LOG_N>
int launch(const void* x, const void* window, const void* tw, void* real,
           void* imag, int batch, int T, int frames, int pad, int hop, int lo,
           int hi, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      stft_fft_kernel<LOG_N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const int fpb = frames_per_block(1 << LOG_N);
  dim3 grid((frames + fpb - 1) / fpb, batch);
  stft_fft_kernel<LOG_N><<<grid, THREADS, smem, stream>>>(
      (const float*)x, (const float*)window, (const float2*)tw, (float*)real,
      (float*)imag, T, frames, pad, hop, lo, hi);
  return (int)cudaGetLastError();
}

constexpr int DFT_THREADS = 256;
constexpr int DFT_FPB = 128;  // frames a block
constexpr int DFT_FR = 4;     // frames a thread; divides DFT_FPB
constexpr int DFT_MAX_N_FFT = 128;
static_assert(DFT_FPB % DFT_FR == 0, "a block holds whole frame groups");

__global__ void __launch_bounds__(DFT_THREADS)
stft_dft_kernel(const float* __restrict__ x,      // [B, T]
                const float* __restrict__ basis,  // [n_fft, 2F] windowed
                float* __restrict__ real,         // [B, frames, F]
                float* __restrict__ imag,         // [B, frames, F]
                int T, int frames, int pad, int hop, int n_fft, int lo,
                int hi) {
  const int F = n_fft / 2 + 1;
  const int taps = hi - lo;
  extern __shared__ __align__(16) float dft_smem[];
  float* bas = dft_smem;              // [taps][2F]: basis rows lo..hi-1
  float* span = bas + taps * 2 * F;   // (DFT_FPB-1)*hop + taps samples

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * DFT_FPB;
  for (int i = threadIdx.x; i < taps * 2 * F; i += DFT_THREADS)
    bas[i] = __ldg(basis + lo * 2 * F + i);

  // the padded samples f0*hop + lo + i, reflected at both ends of x, zero
  // past the padded signal's end (frames past `frames`)
  const float* xb = x + (size_t)b * T;
  const int p0 = f0 * hop + lo;
  const int t_padded = T + 2 * pad;
  const int span_len = (DFT_FPB - 1) * hop + taps;
  for (int i = threadIdx.x; i < span_len; i += DFT_THREADS) {
    const int p = p0 + i;
    float v = 0.f;
    if (p < t_padded) {
      int s = p - pad;
      s = s < 0 ? -s : (s >= T ? 2 * (T - 1) - s : s);
      v = __ldg(xb + s);
    }
    span[i] = v;
  }
  __syncthreads();

  // frame group gi: frames g0 .. g0 + DFT_FR - 1 of the block; a group
  // past the last frame reads staged zeros and stores nothing
  const int nf = min(DFT_FPB, frames - f0);
  const int groups = (nf + DFT_FR - 1) / DFT_FR;
  const size_t row0 = ((size_t)b * frames + f0) * F;
  for (int idx = threadIdx.x; idx < groups * F; idx += DFT_THREADS) {
    const int gi = idx / F;
    const int k = idx - gi * F;
    const int g0 = gi * DFT_FR;
    // fs[j * hop + n]: frame g0 + j's sample at tap lo + n
    const float* fs = span + g0 * hop;
    const float* col = bas + k;
    float re[DFT_FR], im[DFT_FR];
#pragma unroll
    for (int j = 0; j < DFT_FR; ++j) re[j] = im[j] = 0.f;
    for (int n = 0; n < taps; ++n) {
      const float br = col[n * 2 * F], bi = col[n * 2 * F + F];
#pragma unroll
      for (int j = 0; j < DFT_FR; ++j) {
        const float v = fs[j * hop + n];
        re[j] = fmaf(v, br, re[j]);
        im[j] = fmaf(v, bi, im[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < DFT_FR; ++j) {
      if (g0 + j < nf) {
        const size_t at = row0 + (size_t)(g0 + j) * F + k;
        real[at] = re[j];
        imag[at] = im[j];
      }
    }
  }
}

bool dft_size(int n_fft) {
  return n_fft >= 2 && n_fft <= DFT_MAX_N_FFT && n_fft % 2 == 0;
}

}  // namespace

// Shared memory one block of the DFT path needs: the basis rows of the
// taps and the span.  -1 for an n_fft the path does not take.
extern "C" int stft_dft_smem_bytes(int n_fft, int hop, int taps) {
  if (!dft_size(n_fft)) return -1;
  const int f = n_fft / 2 + 1;
  return (int)((taps * 2 * f + (DFT_FPB - 1) * hop + taps) * sizeof(float));
}

// Launch the DFT path on `stream`; returns cudaGetLastError() of the
// launch (0 = ok).  Requires T > pad, T + 2*pad + hop < 2^31,
// 0 <= lo < hi <= n_fft, and n_fft even, at most 128.
extern "C" int stft_dft_f32(const void* x, const void* basis, void* real,
                            void* imag, int batch, int T, int frames,
                            int pad, int hop, int n_fft, int lo, int hi,
                            void* stream) {
  const int smem = stft_dft_smem_bytes(n_fft, hop, hi - lo);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      stft_dft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((frames + DFT_FPB - 1) / DFT_FPB, batch);
  stft_dft_kernel<<<grid, DFT_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)basis, (float*)real, (float*)imag, T,
      frames, pad, hop, n_fft, lo, hi);
  return (int)cudaGetLastError();
}

// The kernel's twiddle table for n_fft, laid out as the note at the top
// says: entry i is e^{-2πi p_i/n_fft}, made in double and rounded to float
// once.  Writes the exponents p_i to `exponent` and the (real, imag) pairs
// to `table`, each when it is not null; returns the number of entries, or
// -1 for an n_fft the kernel does not take.
extern "C" int stft_fft_twiddles(int n_fft, int* exponent, float* table) {
  if (n_fft < 256 || n_fft > 4096 || (n_fft & (n_fft - 1))) return -1;
  const int m = n_fft / 2;
  int i = 0;
  auto put = [&](int p) {
    if (exponent) exponent[i] = p;
    if (table) {
      const double angle = -2.0 * M_PI * p / n_fft;
      table[2 * i] = (float)std::cos(angle);
      table[2 * i + 1] = (float)std::sin(angle);
    }
    ++i;
  };
  for (int k = 0; k <= m / 2; ++k) put(k);  // the unpacking's e^{-2πik/N}
  for (int ns = 8; ns < m; ns *= pass_radix(m, ns)) {
    const int radix = pass_radix(m, ns);
    for (int r = 1; r < radix; ++r)  // e^{-2πi r k/(ns radix)}
      for (int k = 0; k < ns; ++k) put(r * k * (n_fft / (ns * radix)));
  }
  return i;
}

// Shared memory one block needs: FPB padded FFT buffers and the span of
// (FPB-1)*hop + taps floats.  -1 for an n_fft the kernel does not take.
extern "C" int stft_fft_smem_bytes(int n_fft, int hop, int taps) {
  if (n_fft < 256 || n_fft > 4096 || (n_fft & (n_fft - 1))) return -1;
  const int m = n_fft / 2;
  const int fpb = frames_per_block(n_fft);
  return (int)(fpb * (m + m / 8) * sizeof(float2) +
               ((fpb - 1) * hop + taps) * sizeof(float));
}

// Launch on `stream`; returns cudaGetLastError() of the launch (0 = ok).
// Requires T > pad, T + 2*pad + hop < 2^31, 0 <= lo < hi <= n_fft, and
// n_fft a power of two from 256 to 4096.
extern "C" int stft_fft_f32(const void* x, const void* window, const void* tw,
                            void* real, void* imag, int batch, int T,
                            int frames, int pad, int hop, int n_fft, int lo,
                            int hi, void* stream) {
  const int smem = stft_fft_smem_bytes(n_fft, hop, hi - lo);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (n_fft) {
    case 256: return launch<8>(x, window, tw, real, imag, batch, T, frames,
                               pad, hop, lo, hi, smem, s);
    case 512: return launch<9>(x, window, tw, real, imag, batch, T, frames,
                               pad, hop, lo, hi, smem, s);
    case 1024: return launch<10>(x, window, tw, real, imag, batch, T, frames,
                                 pad, hop, lo, hi, smem, s);
    case 2048: return launch<11>(x, window, tw, real, imag, batch, T, frames,
                                 pad, hop, lo, hi, smem, s);
    default: return launch<12>(x, window, tw, real, imag, batch, T, frames,
                               pad, hop, lo, hi, smem, s);
  }
}
