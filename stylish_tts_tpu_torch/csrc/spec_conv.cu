// The MRD discriminator's C=32 convolutions for Hopper (sm_90a): forward,
// input gradient (dgrad) and weight gradient (wgrad), bf16 in, f32 sums.
//
// Replaces the TPU kernels of stylish_tts_tpu/ops/spec_conv.py:
//   * _fwd_kernel (launched by _fwd_call) in its two uses: the fused
//     conv + bias + leaky_relu forward, and dx, which the TPU path computes
//     with the same kernel on a zero-dilated gradient and flipped weights;
//   * _dw_kernel (launched by _dw_call), the weight gradient.
//
// The function.  x [B, H, W, 32] bf16, plain channels-last; weights
// (kf=3, kt, 32, 32) with kt 9 or 3; zero padding (1, kt/2); stride 1 on
// H and s (1 or 2) on W, so W_out = ceil(W / s):
//   y[b,h,o,n]  = act(bias[n] + sum_{i,j,c} x[b, h+i-1, o*s+j-kt/2, c] w[i,j,c,n])
//   dx[b,h,w,c] = sum_{i,j,n} d[b, h-i+1, (w+kt/2-j)/s, n] w[i,j,c,n]
//                 (terms where (w+kt/2-j)/s is not a whole number vanish)
//   dW[i,j,c,n] = sum_{b,h,o} x[b, h+i-1, o*s+j-kt/2, c] d[b,h,o,n]
// where d is the gradient at the pre-activation (the caller applies the
// leaky mask).  Every product is a bf16 x bf16 tensor-core MMA
// (mma.sync m16n8k16, f32 accumulation).
//
// What bounds it on the card.  Each kernel does 2*B*H*W_out*kf*kt*32*32
// useful FLOP and moves its inputs and output once.  At the MRD's largest
// layer (res 0 conv_1, x [8, 257, 2761, 32], W_out 1381) that is 157 GFLOP,
// 0.16 ms at 989 TFLOP/s bf16 dense, against 0.16 ms for the 545 MB the
// forward moves at 3.35 TB/s: about 290 FLOP per byte, right at the card's
// balance point, so neither bound can be ignored.  conv_4 (kt 3, stride 1)
// has a third of the FLOP per byte and is bound by bytes.
//
// What the design does about that, as a first kernel that is right:
//   * implicit GEMM: no patch matrix and, for dgrad, no zero-dilated
//     gradient ever reach device memory.  Each block stages the input rows
//     its tile covers (tile + halo) in shared memory once and reads every
//     tap from there, so device memory sees each input about once (the
//     halo adds (kt-1)/(64 s) along W and 2/2 along H);
//   * forward and dgrad: a block owns 2 rows x 64 positions and all 32
//     output channels; each of its 4 warps owns 32 positions (two 16-row
//     MMA tiles that share the weight fragments).  The weights are packed
//     by the caller in MMA-fragment order, so a warp reads them with one
//     conflict-free 8-byte load per lane.  On the stride-2 axis the staged
//     columns are split by parity and dgrad gives each warp one parity
//     class, so it visits only the taps that reach it (the TPU path's
//     dilated gradient multiplies zeros half the time there);
//   * shared rows are padded to 40 bf16 per pixel (80 B): a warp's 8 rows
//     then fall on distinct banks;
//   * wgrad: blocks run in no order, so each block walks a strided set of
//     tiles, keeps its whole dW share in registers (one warp per column tap
//     j, holding the kf x 32 x 32 products of that tap) and writes f32
//     partials; a second kernel sums the partials in a fixed order, so the
//     result is the same from run to run (no float atomics).
// wgmma, TMA and a pipelined ring of tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 32;    // channels in and out
constexpr int KF = 3;    // taps on H
constexpr int TW = 64;   // positions on W per tile
constexpr int RH = 2;    // rows on H per tile
constexpr int PIX = 40;  // bf16 per staged pixel: 32 channels + 8 pad
constexpr int THREADS = 128;

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(uint16_t lo, uint16_t hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

__device__ __forceinline__ int floordiv(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// Packed weights: [KF][KT][2 channel halves][4 n-tiles][32 lanes][4 bf16],
// lane (g = lane/4, t = lane%4) holding B[16h+2t], B[16h+2t+1], B[16h+2t+8],
// B[16h+2t+9] of column 8*tile+g: its two B registers of mma m16n8k16.
template <int KT>
struct Packed {
  static constexpr int ELEMS = KF * KT * 2 * 4 * 32 * 4;
};

// Copy the packed weights into shared memory (16 B per thread and step).
__device__ __forceinline__ void stage_weights(uint16_t* ws, const uint16_t* wp,
                                              int elems) {
  const uint4* src = reinterpret_cast<const uint4*>(wp);
  uint4* dst = reinterpret_cast<uint4*>(ws);
  for (int i = threadIdx.x; i < elems / 8; i += blockDim.x) dst[i] = __ldg(src + i);
}

// ------------------------------------------------------------------------- //
// forward: y = act(conv(x, w) + bias)

template <int KT, int S>
struct Fwd {
  static constexpr int PT = KT / 2;
  static constexpr int WIN = (TW - 1) * S + KT;  // staged columns
  static constexpr int HALF = (WIN + 1) / 2;     // columns per parity plane
  static constexpr int ROWPIX = S == 2 ? 2 * HALF : WIN;
  static constexpr int XS = (RH + 2) * ROWPIX * PIX;
  static constexpr int SMEM = 2 * (XS + Packed<KT>::ELEMS);
  // staged pixel of input column c of the tile (parity planes on stride 2)
  __device__ static __forceinline__ int slot(int c) {
    return S == 2 ? (c & 1) * HALF + (c >> 1) : c;
  }
};

template <int KT, int S>
__global__ void __launch_bounds__(THREADS)
spec_conv_fwd_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ wp,
                     const float* __restrict__ bias, __nv_bfloat16* __restrict__ y,
                     int H, int W, int Wout, float slope) {
  using G = Fwd<KT, S>;
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* xs = smem;
  uint16_t* ws = smem + G::XS;

  const int b = blockIdx.z;
  const int h0 = blockIdx.y * RH;
  const int o0 = blockIdx.x * TW;

  // stage rows h0-1 .. h0+RH, columns o0*S - PT .. + WIN, zero outside
  const int items = (RH + 2) * G::WIN * 4;
  for (int it = threadIdx.x; it < items; it += THREADS) {
    const int chunk = it & 3;
    const int c = (it >> 2) % G::WIN;
    const int r = (it >> 2) / G::WIN;
    const int h = h0 - 1 + r;
    const int w = o0 * S - G::PT + c;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (h >= 0 && h < H && w >= 0 && w < W)
      v = __ldg(reinterpret_cast<const uint4*>(
          x + (((size_t)b * H + h) * W + w) * C + chunk * 8));
    *reinterpret_cast<uint4*>(xs + (r * G::ROWPIX + G::slot(c)) * PIX + chunk * 8) = v;
  }
  stage_weights(ws, wp, Packed<KT>::ELEMS);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int warp = threadIdx.x >> 5;
  const int hr = warp >> 1;
  const int qb = (warp & 1) * 32;

  float acc[2][4][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

#pragma unroll 1
  for (int i = 0; i < KF; ++i) {
#pragma unroll
    for (int j = 0; j < KT; ++j) {
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
        const uint2* wb = reinterpret_cast<const uint2*>(ws) +
                          (((i * KT + j) * 2 + ch) * 4) * 32 + lane;
        uint32_t bf[4][2];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const uint2 v = wb[n * 32];
          bf[n][0] = v.x;
          bf[n][1] = v.y;
        }
        const uint16_t* row = xs + (hr + i) * G::ROWPIX * PIX + ch * 16 + 2 * t;
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int q0 = qb + m * 16 + g;
          const uint16_t* p0 = row + G::slot(q0 * S + j) * PIX;
          const uint16_t* p1 = row + G::slot((q0 + 8) * S + j) * PIX;
          const uint32_t a[4] = {ld32(p0), ld32(p1), ld32(p0 + 8), ld32(p1 + 8)};
#pragma unroll
          for (int n = 0; n < 4; ++n) mma_bf16(acc[m][n], a, bf[n][0], bf[n][1]);
        }
      }
    }
  }

  const int h = h0 + hr;
  if (h >= H) return;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int o = o0 + qb + m * 16 + g + 8 * half;
      if (o >= Wout) continue;
      __nv_bfloat16* yp = y + (((size_t)b * H + h) * Wout + o) * C;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int co = n * 8 + 2 * t;
        float v0 = acc[m][n][2 * half] + bias[co];
        float v1 = acc[m][n][2 * half + 1] + bias[co + 1];
        v0 = v0 >= 0.f ? v0 : v0 * slope;
        v1 = v1 >= 0.f ? v1 : v1 * slope;
        *reinterpret_cast<__nv_bfloat162*>(yp + co) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// ------------------------------------------------------------------------- //
// dgrad: dx = conv_transpose(d, w), gathered directly

template <int KT, int S>
struct Dgr {
  static constexpr int PT = KT / 2;
  static constexpr int DWIN = (TW - 1 + KT - 1) / S + 2;  // staged d columns
  static constexpr int DS = (RH + 2) * DWIN * PIX;
  static constexpr int SMEM = 2 * (DS + Packed<KT>::ELEMS);
};

template <int KT, int S>
__global__ void __launch_bounds__(THREADS)
spec_conv_dgrad_kernel(const uint16_t* __restrict__ d, const uint16_t* __restrict__ wp,
                       __nv_bfloat16* __restrict__ dx, int H, int W, int Wout) {
  using G = Dgr<KT, S>;
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* ds = smem;
  uint16_t* ws = smem + G::DS;

  const int b = blockIdx.z;
  const int h0 = blockIdx.y * RH;
  const int w0 = blockIdx.x * TW;  // even: the parity of w is its class
  const int o_base = floordiv(w0 + G::PT - (KT - 1), S);

  // stage d rows h0-1 .. h0+RH, columns o_base .. + DWIN, zero outside
  const int items = (RH + 2) * G::DWIN * 4;
  for (int it = threadIdx.x; it < items; it += THREADS) {
    const int chunk = it & 3;
    const int c = (it >> 2) % G::DWIN;
    const int r = (it >> 2) / G::DWIN;
    const int hp = h0 - 1 + r;
    const int o = o_base + c;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (hp >= 0 && hp < H && o >= 0 && o < Wout)
      v = __ldg(reinterpret_cast<const uint4*>(
          d + (((size_t)b * H + hp) * Wout + o) * C + chunk * 8));
    *reinterpret_cast<uint4*>(ds + (r * G::DWIN + c) * PIX + chunk * 8) = v;
  }
  stage_weights(ws, wp, Packed<KT>::ELEMS);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int warp = threadIdx.x >> 5;
  const int hr = warp >> 1;
  const int cls = warp & 1;
  // position of row q (0..31) of this warp: stride 2 gives each warp one
  // parity class, stride 1 a run of 32
  auto wpos = [&](int q) { return S == 2 ? w0 + cls + 2 * q : w0 + cls * 32 + q; };

  float acc[2][4][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

#pragma unroll 1
  for (int i = 0; i < KF; ++i) {
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      if (S == 2 && ((cls + G::PT - j) & 1)) continue;  // tap misses this class
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
        const uint2* wb = reinterpret_cast<const uint2*>(ws) +
                          (((i * KT + j) * 2 + ch) * 4) * 32 + lane;
        uint32_t bf[4][2];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const uint2 v = wb[n * 32];
          bf[n][0] = v.x;
          bf[n][1] = v.y;
        }
        const uint16_t* row = ds + (hr + 2 - i) * G::DWIN * PIX + ch * 16 + 2 * t;
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int q0 = m * 16 + g;
          // exact divisions: the numerators are multiples of S here
          const int c0 = (wpos(q0) + G::PT - j) / S - o_base;
          const int c1 = (wpos(q0 + 8) + G::PT - j) / S - o_base;
          const uint16_t* p0 = row + c0 * PIX;
          const uint16_t* p1 = row + c1 * PIX;
          const uint32_t a[4] = {ld32(p0), ld32(p1), ld32(p0 + 8), ld32(p1 + 8)};
#pragma unroll
          for (int n = 0; n < 4; ++n) mma_bf16(acc[m][n], a, bf[n][0], bf[n][1]);
        }
      }
    }
  }

  const int h = h0 + hr;
  if (h >= H) return;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int w = wpos(m * 16 + g + 8 * half);
      if (w >= W) continue;
      __nv_bfloat16* p = dx + (((size_t)b * H + h) * W + w) * C;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int ci = n * 8 + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(p + ci) =
            __floats2bfloat162_rn(acc[m][n][2 * half], acc[m][n][2 * half + 1]);
      }
    }
  }
}

// ------------------------------------------------------------------------- //
// wgrad: per-block partial sums of patch^T . d, then a fixed-order reduction

template <int KT, int S>
struct Wgr {
  static constexpr int PT = KT / 2;
  static constexpr int XW = (TW - 1) * S + KT;  // staged input columns
  // columns per channel row in shared memory: parity planes of 68 on
  // stride 2, 72 on stride 1 (36 words: the 8 rows of a fragment land on
  // distinct banks)
  static constexpr int PLANE = 68;
  static constexpr int XWP = S == 2 ? 2 * PLANE : 72;
  static constexpr int DTP = 72;
  static constexpr int XS = (RH + 2) * C * XWP;
  static constexpr int DS = RH * C * DTP;
  static constexpr int SMEM = 2 * (XS + DS);
  static constexpr int ELEMS = KF * KT * C * C;
  static_assert(S == 2 ? (XW + 1) / 2 <= PLANE : XW <= XWP, "tile too wide");
  __device__ static __forceinline__ int slot(int c) {
    return S == 2 ? (c & 1) * PLANE + (c >> 1) : c;
  }
};

template <int KT, int S>
__global__ void __launch_bounds__(KT * 32)
spec_conv_wgrad_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ d,
                       float* __restrict__ partial, int B, int H, int W, int Wout) {
  using G = Wgr<KT, S>;
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* xs = smem;        // [RH+2][32 channels][XWP columns]
  uint16_t* dt = smem + G::XS;  // [RH][32 channels][DTP positions]

  const int nthreads = KT * 32;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int j = threadIdx.x >> 5;  // this warp's column tap

  float acc[KF][2][4][4];
#pragma unroll
  for (int i = 0; i < KF; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][h][n][e] = 0.f;

  const int tiles_w = (Wout + TW - 1) / TW;
  const int tiles_h = (H + RH - 1) / RH;
  const int tiles = B * tiles_h * tiles_w;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int o0 = (tile % tiles_w) * TW;
    const int h0 = ((tile / tiles_w) % tiles_h) * RH;
    const int b = tile / (tiles_w * tiles_h);
    __syncthreads();  // the previous tile's reads are done

    // x rows h0-1 .. h0+RH, columns o0*S - PT .. + XW, transposed to
    // channel-major; zero outside
    const int xitems = (RH + 2) * G::XW * 4;
    for (int it = threadIdx.x; it < xitems; it += nthreads) {
      const int chunk = it & 3;
      const int c = (it >> 2) % G::XW;
      const int r = (it >> 2) / G::XW;
      const int h = h0 - 1 + r;
      const int w = o0 * S - G::PT + c;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (h >= 0 && h < H && w >= 0 && w < W)
        v = __ldg(reinterpret_cast<const uint4*>(
            x + (((size_t)b * H + h) * W + w) * C + chunk * 8));
      const uint16_t* e = reinterpret_cast<const uint16_t*>(&v);
      uint16_t* dst = xs + (r * C + chunk * 8) * G::XWP + G::slot(c);
#pragma unroll
      for (int k = 0; k < 8; ++k) dst[k * G::XWP] = e[k];
    }
    // d rows h0 .. h0+RH-1, positions o0 .. o0+TW-1, channel-major; zero
    // outside, so padded positions add nothing
    const int ditems = RH * TW * 4;
    for (int it = threadIdx.x; it < ditems; it += nthreads) {
      const int chunk = it & 3;
      const int q = (it >> 2) % TW;
      const int r = (it >> 2) / TW;
      const int h = h0 + r;
      const int o = o0 + q;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (h < H && o < Wout)
        v = __ldg(reinterpret_cast<const uint4*>(
            d + (((size_t)b * H + h) * Wout + o) * C + chunk * 8));
      const uint16_t* e = reinterpret_cast<const uint16_t*>(&v);
      uint16_t* dst = dt + (r * C + chunk * 8) * G::DTP + q;
#pragma unroll
      for (int k = 0; k < 8; ++k) dst[k * G::DTP] = e[k];
    }
    __syncthreads();

#pragma unroll 1
    for (int hr = 0; hr < RH; ++hr) {
#pragma unroll 1
      for (int q0 = 0; q0 < TW; q0 += 16) {
        // B = d[positions q0.., channel n]: two registers per n-tile
        uint32_t bf[4][2];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const uint16_t* p = dt + (hr * C + n * 8 + g) * G::DTP + q0 + 2 * t;
          bf[n][0] = ld32(p);
          bf[n][1] = ld32(p + 8);
        }
        // staged columns of positions q0+2t, +1, +8, +9 at tap j
        const int s0 = G::slot((q0 + 2 * t) * S + j);
        const int s1 = G::slot((q0 + 2 * t + 1) * S + j);
        const int s2 = G::slot((q0 + 2 * t + 8) * S + j);
        const int s3 = G::slot((q0 + 2 * t + 9) * S + j);
#pragma unroll
        for (int i = 0; i < KF; ++i) {
#pragma unroll
          for (int ch = 0; ch < 2; ++ch) {
            const uint16_t* r0 = xs + ((hr + i) * C + ch * 16 + g) * G::XWP;
            const uint16_t* r1 = r0 + 8 * G::XWP;
            const uint32_t a[4] = {pack2(r0[s0], r0[s1]), pack2(r1[s0], r1[s1]),
                                   pack2(r0[s2], r0[s3]), pack2(r1[s2], r1[s3])};
#pragma unroll
            for (int n = 0; n < 4; ++n) mma_bf16(acc[i][ch][n], a, bf[n][0], bf[n][1]);
          }
        }
      }
    }
  }

  // this block's partial dW[i][j][c][n]
  float* out = partial + (size_t)blockIdx.x * G::ELEMS;
#pragma unroll
  for (int i = 0; i < KF; ++i)
#pragma unroll
    for (int ch = 0; ch < 2; ++ch)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int ci = ch * 16 + g;
        const int co = n * 8 + 2 * t;
        float* p = out + ((i * KT + j) * C + ci) * C + co;
        *reinterpret_cast<float2*>(p) = make_float2(acc[i][ch][n][0], acc[i][ch][n][1]);
        *reinterpret_cast<float2*>(p + 8 * C) =
            make_float2(acc[i][ch][n][2], acc[i][ch][n][3]);
      }
}

__global__ void sum_partials_kernel(const float* __restrict__ partial,
                                    float* __restrict__ out, int elems, int blocks) {
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < elems;
       e += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < blocks; ++k) s += partial[(size_t)k * elems + e];
    out[e] = s;
  }
}

// ------------------------------------------------------------------------- //
// launchers

template <int KT, int S>
int launch_fwd(const void* x, const void* wp, const void* bias, void* y, int B,
               int H, int W, int Wout, float slope, cudaStream_t stream) {
  auto kern = spec_conv_fwd_kernel<KT, S>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Fwd<KT, S>::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Wout + TW - 1) / TW, (H + RH - 1) / RH, B);
  kern<<<grid, THREADS, Fwd<KT, S>::SMEM, stream>>>(
      (const uint16_t*)x, (const uint16_t*)wp, (const float*)bias,
      (__nv_bfloat16*)y, H, W, Wout, slope);
  return (int)cudaGetLastError();
}

template <int KT, int S>
int launch_dgrad(const void* d, const void* wp, void* dx, int B, int H, int W,
                 int Wout, cudaStream_t stream) {
  auto kern = spec_conv_dgrad_kernel<KT, S>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Dgr<KT, S>::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + TW - 1) / TW, (H + RH - 1) / RH, B);
  kern<<<grid, THREADS, Dgr<KT, S>::SMEM, stream>>>(
      (const uint16_t*)d, (const uint16_t*)wp, (__nv_bfloat16*)dx, H, W, Wout);
  return (int)cudaGetLastError();
}

template <int KT, int S>
int launch_wgrad(const void* x, const void* d, void* partial, void* dw, int B,
                 int H, int W, int Wout, int blocks, cudaStream_t stream) {
  auto kern = spec_conv_wgrad_kernel<KT, S>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Wgr<KT, S>::SMEM);
  if (err != cudaSuccess) return (int)err;
  kern<<<blocks, KT * 32, Wgr<KT, S>::SMEM, stream>>>(
      (const uint16_t*)x, (const uint16_t*)d, (float*)partial, B, H, W, Wout);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int elems = Wgr<KT, S>::ELEMS;
  sum_partials_kernel<<<(elems + 255) / 256, 256, 0, stream>>>(
      (const float*)partial, (float*)dw, elems, blocks);
  return (int)cudaGetLastError();
}

}  // namespace

// Each launcher enqueues on `stream` and returns cudaGetLastError() of its
// launches (0 = ok).  Tensors are contiguous; x, d, dx, y bf16 [B, H, *, 32];
// wp the packed weights (see Packed); bias f32 [32]; kt 9 or 3; stride 1 or 2.

extern "C" int spec_conv_forward_bf16(const void* x, const void* wp,
                                      const void* bias, void* y, int B, int H,
                                      int W, int Wout, int kt, int stride,
                                      float slope, void* stream) {
#define CALL_FWD(K, S2) launch_fwd<K, S2>(x, wp, bias, y, B, H, W, Wout, slope, (cudaStream_t)stream)
  if (kt == 9 && stride == 2) return CALL_FWD(9, 2);
  if (kt == 9 && stride == 1) return CALL_FWD(9, 1);
  if (kt == 3 && stride == 2) return CALL_FWD(3, 2);
  if (kt == 3 && stride == 1) return CALL_FWD(3, 1);
  return (int)cudaErrorInvalidValue;
#undef CALL_FWD
}

extern "C" int spec_conv_dgrad_bf16(const void* d, const void* wp, void* dx,
                                    int B, int H, int W, int Wout, int kt,
                                    int stride, void* stream) {
#define CALL_DGR(K, S2) launch_dgrad<K, S2>(d, wp, dx, B, H, W, Wout, (cudaStream_t)stream)
  if (kt == 9 && stride == 2) return CALL_DGR(9, 2);
  if (kt == 9 && stride == 1) return CALL_DGR(9, 1);
  if (kt == 3 && stride == 2) return CALL_DGR(3, 2);
  if (kt == 3 && stride == 1) return CALL_DGR(3, 1);
  return (int)cudaErrorInvalidValue;
#undef CALL_DGR
}

// partial: f32 [blocks, 3*kt*32*32] scratch; dw: f32 [3, kt, 32, 32].
extern "C" int spec_conv_wgrad_bf16(const void* x, const void* d, void* partial,
                                    void* dw, int B, int H, int W, int Wout,
                                    int kt, int stride, int blocks, void* stream) {
#define CALL_WGR(K, S2) launch_wgrad<K, S2>(x, d, partial, dw, B, H, W, Wout, blocks, (cudaStream_t)stream)
  if (kt == 9 && stride == 2) return CALL_WGR(9, 2);
  if (kt == 9 && stride == 1) return CALL_WGR(9, 1);
  if (kt == 3 && stride == 2) return CALL_WGR(3, 2);
  if (kt == 3 && stride == 1) return CALL_WGR(3, 1);
  return (int)cudaErrorInvalidValue;
#undef CALL_WGR
}
