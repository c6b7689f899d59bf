// The MRD discriminator's C=32 convolutions for Hopper (sm_90a): forward,
// input gradient (dgrad) and weight gradient (wgrad), bf16 in, f32 sums.
//
// Replaces the TPU kernels of stylish_tts_tpu/ops/spec_conv.py:
//   * _fwd_kernel (launched by _fwd_call) in its two uses: the fused
//     conv + bias + leaky_relu forward (spec_conv_fwd_kernel), and dx,
//     which the TPU path computes with the same kernel on a zero-dilated
//     gradient and flipped weights (spec_conv_dgrad_kernel);
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
// leaky mask).  Every product is a bf16 x bf16 tensor-core MMA with f32
// accumulation (wgmma m64n32k16 in the forward and the dgrad, mma.sync
// m16n8k16 in the wgrad).
//
// What bounds it on the card.  Each kernel does 2*B*H*W_out*kf*kt*32*32
// useful FLOP and moves its inputs and output once.  At the MRD's largest
// layer (res 0 conv_1, x [8, 257, 2761, 32], W_out 1381) that is 157 GFLOP,
// 0.16 ms at 989 TFLOP/s bf16 dense, against 0.16 ms for the 545 MB the
// forward moves at 3.35 TB/s: about 290 FLOP per byte, right at the card's
// balance point, so neither bound can be ignored.  conv_4 (kt 3, stride 1)
// has a third of the FLOP per byte and is bound by bytes.  The dgrad moves
// the same bytes as the forward (d in, dx out) and does the same FLOP.
//
// What the design does about that.  The forward (redesigned for this card):
//   * persistent blocks: as many blocks as fit on the card at once (one
//     per SM at kt 9: 224 KB of shared memory), each loading the weights
//     into shared memory once and then walking work items (b, a strip of
//     64 positions, a chunk of up to 32 rows) in a fixed order.  The
//     weights are read from L2 once per block, not once per tile;
//   * a ring of input rows: the block walks down H, 8 output rows a step,
//     and keeps 20 staged rows; each input row is staged once per item and
//     read by the three output rows that need it, so the halo on H is
//     (32 + 2) / 32 instead of 2;
//   * cp.async staging that overlaps the MMAs: while a step computes, its
//     threads have the next step's 8 rows in flight (16-B copies whose
//     zero-fill form writes the conv's padding); one barrier a step;
//   * wgmma: each of the two warpgroups owns 4 output rows of 64 positions
//     x 32 channels and issues one m64n32k16 per row and k-step, A (the
//     tap's run of staged pixels) from registers loaded by ldmatrix.x4, B
//     (the tap's weights, packed by the caller in wgmma's K-major layout)
//     from shared memory through a descriptor; two A buffers keep one
//     batch of wgmmas in flight while the next one's fragments load;
//   * staged pixels are 64 B, split by parity on stride 2 so that a tap's
//     run of positions is a run of pixels, with the 16-B chunks XOR-
//     swizzled by pixel: ldmatrix's eight rows fall on distinct banks;
//   * the epilogue swaps words within each quad of lanes, so that each
//     lane stores 8 consecutive channels (16 B).
// The wgrad (redesigned on the forward's staging):
//   * the same persistent blocks, work items and ring of staged x rows as
//     the forward (4 output rows a step), with the step's d rows
//     double-buffered;
//     no weights in shared memory, and the next step's rows arrive by
//     cp.async while the current step's MMAs run;
//   * one warp per column tap j (four at kt 3, each on a quarter of the
//     positions), holding the kf x 32 x 32 sums of that tap in registers
//     across all the block's items; both operands (x^T and d)
//     come from the staged rows by ldmatrix.x4.trans, and each x fragment
//     serves the up to three output rows that read its input row;
//   * blocks run in no order, so each writes f32 partials once; a second
//     kernel sums them in a fixed order, so the result is the same from run
//     to run (no float atomics).
// The dgrad (redesigned on the forward's walk, with the forward's device
// code: walk_rows, mma_rows, store_tile):
//   * the forward's persistent blocks, plan, ring of 20 staged rows and
//     wgmma tiles, over d with the flipped, transposed weights (packed by
//     the caller as the forward's, resident in shared memory); no bias or
//     activation.  At stride 1 that is the whole story;
//   * at stride 2 the dx columns split by parity: column 2m + p reads d
//     columns m - 2 .. m + 2 (kt 9) through taps of one parity only, so
//     each class is a stride-1 correlation of d with its own taps (5 and 4
//     of 9 at kt 9), and no dilated zero is staged or multiplied.  The ring
//     stages 68 d columns per strip of 64 positions (128 dx columns) in the
//     stride-1 layout; each warpgroup runs class 0 on its four rows, stores
//     them, then class 1 from the same staged rows and accumulators;
//   * the epilogue stores 16 B a lane at column 2m + p.
// wgmma for the wgrad, and TMA, are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 32;    // channels in and out
constexpr int KF = 3;    // taps on H

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ------------------------------------------------------------------------- //
// forward: y = act(conv(x, w) + bias), persistent blocks over a ring of rows
// (the walk and the MMA loop serve the dgrad too)
//
// A work item is (b, a strip of FWD_STRIP output positions, a chunk of up
// to FWD_CHUNK_STEPS steps of FWD_ROWS output rows).  The grid holds as
// many blocks as fit on the card at once; each loads the weights into
// shared memory once and walks the items blockIdx.x, + gridDim.x, ...
// Within an item the block walks down H, FWD_ROWS output rows a step:
// warpgroup g computes rows 4g .. 4g+3 of the step, each a 64 x 32 wgmma
// tile (64 positions, 32 channels), from a ring of FWD_RING staged input
// rows.  A step stages only the FWD_ROWS rows its successor adds (the
// first step of an item all FWD_ROWS + 2), by cp.async into the ring while
// the current step's wgmmas run; one barrier a step hands the rows over.

constexpr int FWD_WARPGROUPS = 2;
constexpr int FWD_THREADS = 128 * FWD_WARPGROUPS;
constexpr int FWD_ROWS = 4 * FWD_WARPGROUPS;     // output rows per step
constexpr int FWD_STRIP = 64;                    // positions per wgmma tile
constexpr int FWD_RING = 2 * (FWD_ROWS + 2);     // staged input rows
constexpr int FWD_CHUNK_STEPS = 4;               // steps per item at most
constexpr int FWD_SLAB = 1024;                   // bytes of one 16 x 32 weight slab

template <int KT, int S>
struct Fwd {
  static constexpr int PT = KT / 2;
  static constexpr int WIN = (FWD_STRIP - 1) * S + KT;  // staged columns
  static constexpr int HALF = (WIN + 1) / 2;            // per parity plane
  static constexpr int ROWPIX = S == 2 ? 2 * HALF : WIN;
  static constexpr int ROWBYTES = ROWPIX * C * 2;
  static constexpr int WBYTES = KF * KT * 2 * FWD_SLAB;
  static constexpr int SMEM = WBYTES + FWD_RING * ROWBYTES;
  // staged pixel of column o * S + j of the strip's window: on stride 2
  // the columns are split by parity, so a tap's run of positions is a run
  // of consecutive pixels in either case
  __device__ static __forceinline__ int pixel(int o, int j) {
    return S == 2 ? (j & 1) * HALF + o + (j >> 1) : o + j;
  }
  __device__ static __forceinline__ int pixel_of_column(int c) {
    return S == 2 ? (c & 1) * HALF + (c >> 1) : c;
  }
  // the first staged column of the strip from position o0
  __device__ static __forceinline__ int column0(int o0) { return o0 * S - PT; }
  // byte offset of 16-B chunk k (channels 8k..8k+7) of pixel q: the chunk
  // is XOR-swizzled with bits 1-2 of q, so the eight rows of one ldmatrix
  // (eight consecutive pixels, one chunk) fall on eight distinct bank groups
  __device__ static __forceinline__ int offset(int q, int k) {
    return q * (C * 2) + ((k ^ ((q >> 1) & 3)) << 4);
  }
};

static_assert(Fwd<9, 2>::SMEM <= 232448, "forward does not fit in shared memory");

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  // src-size 0 writes 16 zero bytes: the conv's padding
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// wgmma's shared-memory descriptor of one weight slab (16 k x 32 n, laid
// out by the caller, see pack_weights_gmma): no swizzle, K-major core
// matrices of 8 rows x 16 B; 128 B from one 8-wide k half to the next
// (leading byte offset), 256 B from one group of 8 output channels to the
// next (stride byte offset)
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

// d[64 x 32] += a[64 x 16] . b[16 x 32]: a in registers (each warp of the
// warpgroup its 16 rows, in mma.sync's m16n8k16 A layout), b in shared
// memory; d[4n + e] holds this warp's m16n8 accumulator of n-tile n
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ uint32_t pick4(const uint32_t (&v)[4], int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}

// bias and leaky ReLU, in place, on a warp's 16 positions x 32 channels
// (d[4n + e]: the m16n8 accumulator of n-tile n)
__device__ __forceinline__ void bias_leaky(float (&d)[16], const float (&bv)[4][2],
                                           float slope) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = d[4 * n + e] + bv[n][e & 1];
      d[4 * n + e] = v >= 0.f ? v : v * slope;
    }
}

// one bf16 rounding of a warp's 16 positions x 32 channels (as bias_leaky),
// positions o_first + 0..15: position o to column CS * o + cls of the row
// `row`, if that is below `limit`; a quad's four lanes swap words so that
// each holds 8 consecutive channels of one position, stored as 16 B
template <int CS>
__device__ __forceinline__ void store_tile(const float (&d)[16], __nv_bfloat16* row,
                                           int o_first, int cls, int limit, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    uint32_t v[4];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const __nv_bfloat162 p =
          __floats2bfloat162_rn(d[4 * n + 2 * half], d[4 * n + 2 * half + 1]);
      v[n] = *reinterpret_cast<const uint32_t*>(&p);
    }
    // v[n] = channels 8n + 2*t4, +1; got[s] = channels 8*t4 + 2*(t4 ^ s),
    // +1, from lane t4 ^ s of the quad
    uint32_t got[4];
    got[0] = pick4(v, t4);
#pragma unroll
    for (int s = 1; s < 4; ++s) got[s] = __shfl_xor_sync(0xffffffffu, pick4(v, t4 ^ s), s);
    const int col = CS * (o_first + g + 8 * half) + cls;
    if (col < limit) {
      const uint4 out = make_uint4(pick4(got, t4), pick4(got, t4 ^ 1), pick4(got, t4 ^ 2),
                                   pick4(got, t4 ^ 3));
      *reinterpret_cast<uint4*>(row + (size_t)col * C + t4 * 8) = out;
    }
  }
}

// The work split of one forward or dgrad launch, made on the host.
struct FwdPlan {
  int blocks, strips, chunk_steps, chunks, items;
};

inline FwdPlan fwd_plan(int B, int H, int Wout, int slots) {
  FwdPlan p;
  p.strips = (Wout + FWD_STRIP - 1) / FWD_STRIP;
  const int steps_h = (H + FWD_ROWS - 1) / FWD_ROWS;
  // as many steps per item as keep four items per block, up to
  // FWD_CHUNK_STEPS (34 staged rows for 32 output rows)
  const long long work = (long long)B * p.strips * steps_h;
  long long chunk = work / (4LL * slots);
  if (chunk > FWD_CHUNK_STEPS) chunk = FWD_CHUNK_STEPS;
  if (chunk < 1) chunk = 1;
  p.chunk_steps = (int)chunk;
  p.chunks = (steps_h + p.chunk_steps - 1) / p.chunk_steps;
  p.items = B * p.strips * p.chunks;
  p.blocks = p.items < slots ? p.items : slots;
  return p;
}

// Walk this block's work items (blockIdx.x, + gridDim.x, ... below items)
// through the ring of staged rows.  First the packed weights (WBYTES) into
// shared memory at wsm, once; then, for each step of FWD_ROWS rows, the
// rows of src [B, H, src_w, 32] in the row layout L (strip window from
// column L::column0(o0), zero outside the image), staged by cp.async while
// the previous step computes.  step(b, o0, h0, ring, pos) computes rows
// h0 .. h0 + FWD_ROWS - 1 of strip o0, whose input row h0 - 1 is at ring
// position pos (mod FWD_RING).
template <class L, int WBYTES, class Step>
__device__ __forceinline__ void walk_rows(const uint16_t* __restrict__ src,
                                          const uint16_t* __restrict__ wp, uint32_t wsm,
                                          int H, int src_w, int strips, int chunk_steps,
                                          int chunks, int items, Step&& step) {
  const uint32_t ring = wsm + WBYTES;
  const int tid = threadIdx.x;
  const int steps_h = (H + FWD_ROWS - 1) / FWD_ROWS;
  if ((int)blockIdx.x >= items) return;

  for (int i = tid; i < WBYTES / 16; i += FWD_THREADS)
    cp_async16(wsm + 16 * i, wp + 8 * i, true);

  // rows r_first .. r_first + nrows - 1 of image b, the strip's window,
  // into ring positions pos, pos + 1, ...
  auto stage = [&](int b, int o0, int r_first, int nrows, int pos) {
    const int w0 = L::column0(o0);
    const int n = nrows * L::WIN * 4;
    for (int it = tid; it < n; it += FWD_THREADS) {
      const int k = it & 3;
      const int c = (it >> 2) % L::WIN;
      const int r = (it >> 2) / L::WIN;
      const int h = r_first + r, w = w0 + c;
      const bool ok = h >= 0 && h < H && w >= 0 && w < src_w;
      const uint16_t* s = ok ? src + (((size_t)b * H + h) * src_w + w) * C + k * 8 : src;
      cp_async16(ring + ((pos + r) % FWD_RING) * L::ROWBYTES +
                     L::offset(L::pixel_of_column(c), k),
                 s, ok);
    }
  };

  // the current step: item t, step k of it, rows h0 .. h0 + FWD_ROWS - 1,
  // its input row h0 - 1 at ring position pos; head = next free position
  int t = blockIdx.x, k = 0;
  int b, o0, h0, nsteps;
  auto decode = [&]() {
    const int strip = t % strips;
    const int chunk = (t / strips) % chunks;
    b = t / (strips * chunks);
    o0 = strip * FWD_STRIP;
    h0 = chunk * chunk_steps * FWD_ROWS;
    nsteps = min(chunk_steps, steps_h - chunk * chunk_steps);
  };
  decode();
  int pos = 0, head = FWD_ROWS + 2;
  stage(b, o0, h0 - 1, FWD_ROWS + 2, 0);
  cp_async_commit();

  for (;;) {
    cp_async_wait_all();
    __syncthreads();  // this step's rows are in; the previous step is done
    const int cb = b, co0 = o0, ch0 = h0, cpos = pos;
    // stage the next step's rows into positions the previous step freed
    bool last = false;
    if (k + 1 < nsteps) {
      ++k;
      h0 += FWD_ROWS;
      pos = cpos + FWD_ROWS;
      stage(b, o0, h0 + 1, FWD_ROWS, head);
      head += FWD_ROWS;
    } else {
      t += gridDim.x;
      k = 0;
      if (t < items) {
        decode();
        pos = head;
        stage(b, o0, h0 - 1, FWD_ROWS + 2, head);
        head += FWD_ROWS + 2;
      } else {
        last = true;
      }
    }
    cp_async_commit();
    step(cb, co0, ch0, ring, cpos);
    if (last) break;
  }
}

// Window taps u of the forward (and of the dgrad at stride 1): tap u
// multiplies weight slab u.
struct AllTaps {
  __device__ static constexpr int slab(int u) { return u; }
};

// acc[r] = the sums of output row r (0..3) of a warpgroup's four rows, whose
// input row r + i (tap i = 0..2 on H) is at ring position rowpos + r + i, in
// the row layout L.  Window tap u = 0..NU-1 on W reads staged pixel
// L::pixel(q, u) (q: this lane's ldmatrix row within the warpgroup's 64
// positions, lk its k half) and multiplies weight slab (i, Taps::slab(u))
// of the KT packed per i; a tap whose slab is outside [0, KT) is skipped.
// A (the tap's run of pixels) goes to registers by ldmatrix.x4, B by
// descriptor from the weights at desc0; two A buffers keep one batch of
// wgmmas in flight while the next one's fragments load.
template <class L, int KT, int NU, class Taps>
__device__ __forceinline__ void mma_rows(float (&acc)[4][16], uint32_t ring, int rowpos,
                                         int q, int lk, uint64_t desc0) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[r][e] = 0.f;
  uint32_t a[2][4][4];
#pragma unroll 1
  for (int i = 0; i < KF; ++i) {
    uint32_t row[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) row[r] = ring + ((rowpos + r + i) % FWD_RING) * L::ROWBYTES;
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const int j = Taps::slab(u);
      if (j < 0 || j >= KT) continue;  // the tap misses this class
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
        // A buffer ch: the batch that last read it, two back, is done
#pragma unroll
        for (int r = 0; r < 4; ++r)
          ldmatrix_x4(a[ch][r], row[r] + L::offset(L::pixel(q, u), ch * 2 + lk));
        wgmma_fence();
        const uint64_t desc = desc0 + (uint64_t)(((i * KT + j) * 2 + ch) * (FWD_SLAB >> 4));
#pragma unroll
        for (int r = 0; r < 4; ++r) wgmma_m64n32k16(acc[r], a[ch][r], desc);
        wgmma_commit();
        wgmma_wait<1>();
      }
    }
  }
  wgmma_wait<0>();
}

template <int KT, int S>
__global__ void __launch_bounds__(FWD_THREADS)
spec_conv_fwd_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ wp,
                     const float* __restrict__ bias, __nv_bfloat16* __restrict__ y,
                     float slope, int H, int W, int Wout, int strips, int chunk_steps,
                     int chunks, int items) {
  using G = Fwd<KT, S>;
  extern __shared__ __align__(16) uint16_t smem[];
  const uint32_t wsm = (uint32_t)__cvta_generic_to_shared(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // this lane's ldmatrix row (position within its warp's 16) and k half
  const int wg = warp >> 2, wq = warp & 3;
  const int q = wq * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lk = lane >> 4;
  float bv[4][2];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    bv[n][0] = __ldg(bias + n * 8 + 2 * (lane & 3));
    bv[n][1] = __ldg(bias + n * 8 + 2 * (lane & 3) + 1);
  }
  const uint64_t desc0 = gmma_desc(wsm);
  walk_rows<G, G::WBYTES>(
      x, wp, wsm, H, W, strips, chunk_steps, chunks, items,
      [&](int b, int o0, int h0, uint32_t ring, int pos) {
        // rows hb .. hb + 3 (this warpgroup's; warpgroup-uniform branch)
        const int hb = h0 + 4 * wg;
        if (hb >= H) return;
        float acc[4][16];
        mma_rows<G, KT, KT, AllTaps>(acc, ring, pos + 4 * wg, q, lk, desc0);
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (hb + r < H) {
            bias_leaky(acc[r], bv, slope);
            store_tile<1>(acc[r], y + ((size_t)b * H + hb + r) * Wout * C, o0 + 16 * wq, 0,
                          Wout, lane);
          }
      });
}

// ------------------------------------------------------------------------- //
// dgrad: dx = conv_transpose(d, w), the forward's walk over d
//
// dx is a correlation of d with the flipped weights w'[i][j] = w[2-i][kt-1-j]
// (transposed: d's channels are the reduction), packed as the forward's.  At
// stride 1 that is the forward itself, without bias and activation.  At
// stride 2, dx column w = 2m + p reads d column m + e through tap
// j = p + PT - 2e only, so each parity class p is a stride-1 correlation of
// d with its own taps and no dilated zeros: at kt 9 class 0 takes taps
// j = 8, 6, 4, 2, 0 (e = -2..2), class 1 j = 7, 5, 3, 1 (e = -1..2).  The
// ring stages d columns m0 - PE .. m0 + 63 + PE of a strip of 64 d
// positions in the stride-1 row layout, and window tap u = e + PE; each
// warpgroup computes its four rows for class 0 and stores them, then for
// class 1 from the same staged rows.

template <int KT, int S>
struct Dgr {
  static constexpr int PT = KT / 2;
  // d columns a strip reads on either side: e = -PE..PE
  static constexpr int PE = S == 2 ? (PT + 1) / 2 : PT;
  static constexpr int NU = 2 * PE + 1;  // window taps
  using L = Fwd<NU, 1>;                 // the staged row layout
  static constexpr int WBYTES = Fwd<KT, S>::WBYTES;
  static constexpr int SMEM = WBYTES + FWD_RING * L::ROWBYTES;
};

static_assert(Dgr<9, 2>::SMEM <= 232448, "dgrad does not fit in shared memory");

// Window tap u of parity class P at stride 2: the slab of the flipped
// weights, j' = kt - 1 - j for j = P + PT - 2 (u - PE)
template <int KT, int P>
struct ClassTaps {
  __device__ static constexpr int slab(int u) {
    return 2 * u - P + KT - 1 - KT / 2 - 2 * Dgr<KT, 2>::PE;
  }
};

template <int KT, int S>
__global__ void __launch_bounds__(FWD_THREADS)
spec_conv_dgrad_kernel(const uint16_t* __restrict__ d, const uint16_t* __restrict__ wp,
                       __nv_bfloat16* __restrict__ dx, int H, int W, int Wout,
                       int strips, int chunk_steps, int chunks, int items) {
  using G = Dgr<KT, S>;
  using L = typename G::L;
  extern __shared__ __align__(16) uint16_t smem[];
  const uint32_t wsm = (uint32_t)__cvta_generic_to_shared(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wg = warp >> 2, wq = warp & 3;
  const int q = wq * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lk = lane >> 4;
  const uint64_t desc0 = gmma_desc(wsm);
  walk_rows<L, G::WBYTES>(
      d, wp, wsm, H, Wout, strips, chunk_steps, chunks, items,
      [&](int b, int m0, int h0, uint32_t ring, int pos) {
        const int hb = h0 + 4 * wg;
        if (hb >= H) return;
        float acc[4][16];
        // dx column S * m + cls of d position m, below W
        auto store = [&](int cls) {
#pragma unroll
          for (int r = 0; r < 4; ++r)
            if (hb + r < H)
              store_tile<S>(acc[r], dx + ((size_t)b * H + hb + r) * W * C, m0 + 16 * wq, cls,
                            W, lane);
        };
        if constexpr (S == 1) {
          mma_rows<L, KT, G::NU, AllTaps>(acc, ring, pos + 4 * wg, q, lk, desc0);
          store(0);
        } else {
          mma_rows<L, KT, G::NU, ClassTaps<KT, 0>>(acc, ring, pos + 4 * wg, q, lk, desc0);
          store(0);
          mma_rows<L, KT, G::NU, ClassTaps<KT, 1>>(acc, ring, pos + 4 * wg, q, lk, desc0);
          store(1);
        }
      });
}

// ------------------------------------------------------------------------- //
// wgrad: dW = sum over positions of patch^T . d, persistent blocks over a
// ring of rows, per-block partial sums, then a fixed-order reduction
//
// GEMM per tap (i, j): M = 32 input channels (two 16-row MMA tiles), N = 32
// output channels (four n-tiles), K = positions.  A work item is (b, a strip
// of FWD_STRIP positions, a chunk of output rows); the grid holds as many
// blocks as fit on the card at once, each walking the items blockIdx.x,
// + gridDim.x, ...  Within an item the block walks down H, ROWS output rows
// a step, from a ring of staged x rows (the forward's layout: 64-B pixels,
// parity planes on stride 2, swizzled 16-B chunks) and double-buffered d
// rows; a step stages the next step's rows by cp.async while its MMAs run,
// and one barrier a step hands them over.  Warp j owns column tap j and
// keeps its KF x 32 x 32 sums in registers across all its items.  Both
// operands come from the staged rows by ldmatrix.x4.trans, whose transpose
// turns position-major pixels into the MMA's channel-major A (x^T) and
// K-major B (d) fragments; each A fragment (one input row) serves the up to
// three output rows that read it.

template <int KT, int S>
struct Wgr {
  using F = Fwd<KT, S>;
  static constexpr int ROWS = 4;                   // output rows per step
  // warps per column tap: at kt 3 four warps share a tap, each taking one
  // group of 16 positions, and add their sums in the block before it writes
  // its partial: one block of 12 warps an SM (of 9 at kt 9), so 132
  // partials to sum instead of the 528 of four 3-warp blocks an SM
  static constexpr int WPT = KT == 9 ? 1 : 4;
  static constexpr int THREADS = KT * WPT * 32;
  static constexpr int RING = 2 * (ROWS + 2);      // staged x rows
  static constexpr int CHUNK_STEPS = 32 / ROWS;    // steps per item at most
  static constexpr int DROW = FWD_STRIP * C * 2;   // bytes of one staged d row
  static constexpr int SMEM = RING * F::ROWBYTES + 2 * ROWS * DROW;
  static constexpr int ELEMS = KF * KT * C * C;
};

static_assert(Wgr<9, 2>::SMEM <= 232448, "wgrad does not fit in shared memory");
static_assert(3 * 96 * 32 * 4 <= Wgr<3, 1>::SMEM, "no room to add the kt 3 sums");

// The work split of one wgrad launch, made on the host: items of up to
// CHUNK_STEPS steps, the steps of a row spread evenly over its chunks.
struct WgrPlan {
  int blocks, strips, steps_h, chunks, items;
};

inline WgrPlan wgr_plan(int B, int H, int Wout, int rows, int chunk_steps_max,
                        int slots) {
  WgrPlan p;
  p.strips = (Wout + FWD_STRIP - 1) / FWD_STRIP;
  p.steps_h = (H + rows - 1) / rows;
  // as many steps per item as keep four items per block
  const long long work = (long long)B * p.strips * p.steps_h;
  long long chunk = work / (4LL * slots);
  if (chunk > chunk_steps_max) chunk = chunk_steps_max;
  if (chunk < 1) chunk = 1;
  p.chunks = (int)((p.steps_h + chunk - 1) / chunk);
  p.items = B * p.strips * p.chunks;
  p.blocks = p.items < slots ? p.items : slots;
  return p;
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

template <int KT, int S>
__global__ void __launch_bounds__(Wgr<KT, S>::THREADS)
spec_conv_wgrad_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ d,
                       float* __restrict__ partial, int H, int W, int Wout,
                       int strips, int steps_h, int chunks, int items) {
  using G = Wgr<KT, S>;
  using F = typename G::F;
  constexpr int R = G::ROWS;
  extern __shared__ __align__(16) uint16_t smem[];
  const uint32_t ring = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t dsm = ring + G::RING * F::ROWBYTES;  // two buffers of R d rows
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int j = (tid >> 5) % KT;   // this warp's column tap
  const int part = (tid >> 5) / KT;  // ... and its share of the positions
  constexpr int NT = G::THREADS;

  // rows r_first .. r_first + nrows - 1 of x (image b), the strip's window
  // from column o0 * S - PT, into ring positions pos, pos + 1, ...; zero
  // outside the image
  auto stage_x = [&](int b, int o0, int r_first, int nrows, int pos) {
    const int w0 = o0 * S - F::PT;
    const int n = nrows * F::WIN * 4;
    for (int it = tid; it < n; it += NT) {
      const int k = it & 3;
      const int c = (it >> 2) % F::WIN;
      const int r = (it >> 2) / F::WIN;
      const int h = r_first + r, w = w0 + c;
      const bool ok = h >= 0 && h < H && w >= 0 && w < W;
      const uint16_t* src = ok ? x + (((size_t)b * H + h) * W + w) * C + k * 8 : x;
      cp_async16(ring + ((pos + r) % G::RING) * F::ROWBYTES +
                     F::offset(F::pixel_of_column(c), k),
                 src, ok);
    }
  };
  // d rows h_first .. h_first + R - 1, positions o0 .. o0 + FWD_STRIP - 1,
  // into d buffer buf; zero past H and W_out, so those rows and positions
  // add nothing
  auto stage_d = [&](int b, int o0, int h_first, int buf) {
    for (int it = tid; it < R * FWD_STRIP * 4; it += NT) {
      const int k = it & 3;
      const int q = (it >> 2) % FWD_STRIP;
      const int r = (it >> 2) / FWD_STRIP;
      const int h = h_first + r, o = o0 + q;
      const bool ok = h < H && o < Wout;
      const uint16_t* src = ok ? d + (((size_t)b * H + h) * Wout + o) * C + k * 8 : d;
      cp_async16(dsm + (buf * R + r) * G::DROW + F::offset(q, k), src, ok);
    }
  };

  // the current step: item t, step k of it, output rows h0 .. h0 + R - 1,
  // input row h0 - 1 at ring position pos, d rows in buffer buf; head =
  // next free ring position
  int t = blockIdx.x, k = 0;
  int b, o0, h0, nsteps;
  auto decode = [&]() {
    const int strip = t % strips;
    const int chunk = (t / strips) % chunks;
    b = t / (strips * chunks);
    o0 = strip * FWD_STRIP;
    const int first = chunk * steps_h / chunks;
    h0 = first * R;
    nsteps = (chunk + 1) * steps_h / chunks - first;
  };
  decode();  // the plan gives every block an item
  int pos = 0, head = R + 2, buf = 0;
  stage_x(b, o0, h0 - 1, R + 2, 0);
  stage_d(b, o0, h0, 0);
  cp_async_commit();

  // ldmatrix.trans lane maps.  A (x^T, 16 channels x 16 positions): matrix
  // l >> 3 is (positions 8 * (l >> 4).., chunk (l >> 3) & 1 of the channel
  // half); B (d, 16 positions x two n-tiles): matrix l >> 3 is (positions
  // 8 * ((l >> 3) & 1).., n-tile l >> 4 of the pair)
  const int la = (lane & 7) + 8 * (lane >> 4);
  const int ka = (lane >> 3) & 1;
  const int lb = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int kb = lane >> 4;

  float acc[KF][2][4][4];
#pragma unroll
  for (int i = 0; i < KF; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][h][n][e] = 0.f;

  for (;;) {
    cp_async_wait_all();
    __syncthreads();  // this step's rows are in; the previous step is done
    const int co0 = o0, cpos = pos;
    const uint32_t drows = dsm + buf * R * G::DROW;
    // stage the next step's rows into ring positions and the d buffer that
    // the previous step freed
    bool last = false;
    if (k + 1 < nsteps) {
      ++k;
      h0 += R;
      pos = cpos + R;
      stage_x(b, o0, h0 + 1, R, head);
      head += R;
      stage_d(b, o0, h0, buf ^ 1);
    } else {
      t += gridDim.x;
      k = 0;
      if (t < items) {
        decode();
        pos = head;
        stage_x(b, o0, h0 - 1, R + 2, head);
        head += R + 2;
        stage_d(b, o0, h0, buf ^ 1);
      } else {
        last = true;
      }
    }
    buf ^= 1;
    cp_async_commit();

    uint32_t xrow[R + 2];  // input row h0 - 1 + u of the current step
#pragma unroll
    for (int u = 0; u < R + 2; ++u) xrow[u] = ring + ((cpos + u) % G::RING) * F::ROWBYTES;
#pragma unroll 1
    for (int q0 = 16 * part; q0 < FWD_STRIP && co0 + q0 < Wout; q0 += 16 * G::WPT) {
      // input row u is tap i = u - r of output row r: each A fragment (row
      // u, channel half ch; load s = 2u + ch) serves the B fragments of up
      // to three output rows (row r in bf[r], n-tile 2p + e in bf[r][p][2e],
      // [2e+1]).  Each load is issued one load ahead of the MMAs that use it.
      const int xa = F::pixel(q0 + la, j);
      uint32_t bf[R][2][4], a[2][4];
#pragma unroll
      for (int p = 0; p < 2; ++p)
        ldmatrix_x4_trans(bf[0][p], drows + F::offset(q0 + lb, 2 * p + kb));
      ldmatrix_x4_trans(a[0], xrow[0] + F::offset(xa, ka));
#pragma unroll
      for (int s = 0; s < 2 * (R + 2); ++s) {
        const int u = s >> 1, ch = s & 1;
        if (s + 1 < 2 * (R + 2)) {
          const int un = (s + 1) >> 1, chn = (s + 1) & 1;
          if (chn == 0 && un < R) {
#pragma unroll
            for (int p = 0; p < 2; ++p)
              ldmatrix_x4_trans(bf[un][p],
                                drows + un * G::DROW + F::offset(q0 + lb, 2 * p + kb));
          }
          ldmatrix_x4_trans(a[(s + 1) & 1], xrow[un] + F::offset(xa, 2 * chn + ka));
        }
#pragma unroll
        for (int r = (u >= 2 ? u - 2 : 0); r <= (u < R ? u : R - 1); ++r)
#pragma unroll
          for (int n = 0; n < 4; ++n)
            mma_bf16(acc[u - r][ch][n], a[s & 1], bf[r][n >> 1][2 * (n & 1)],
                     bf[r][n >> 1][2 * (n & 1) + 1]);
      }
    }
    if (last) break;
  }

  // the warps that share a tap add their sums in turn, through the ring
  // (free now: no copy is in flight after the last step)
  float* red = reinterpret_cast<float*>(smem);
  for (int sh = 1; sh < G::WPT; ++sh) {
    __syncthreads();  // every warp is done with the ring, or with red
    float* mine = red + j * (KF * 2 * 4 * 4) * 32 + lane;
    const bool put = part == sh;
#pragma unroll
    for (int i = 0; i < KF; ++i)
#pragma unroll
      for (int ch = 0; ch < 2; ++ch)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (put) mine[(((i * 2 + ch) * 4 + n) * 4 + e) * 32] = acc[i][ch][n][e];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < KF; ++i)
#pragma unroll
      for (int ch = 0; ch < 2; ++ch)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (part == 0) acc[i][ch][n][e] += mine[(((i * 2 + ch) * 4 + n) * 4 + e) * 32];
  }
  if (part != 0) return;

  // this block's partial dW[i][j][c][n]
  const int g = lane >> 2, t4 = lane & 3;
  float* out = partial + (size_t)blockIdx.x * G::ELEMS;
#pragma unroll
  for (int i = 0; i < KF; ++i)
#pragma unroll
    for (int ch = 0; ch < 2; ++ch)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int ci = ch * 16 + g;
        const int co = n * 8 + 2 * t4;
        float* p = out + ((i * KT + j) * C + ci) * C + co;
        *reinterpret_cast<float2*>(p) = make_float2(acc[i][ch][n][0], acc[i][ch][n][1]);
        *reinterpret_cast<float2*>(p + 8 * C) =
            make_float2(acc[i][ch][n][2], acc[i][ch][n][3]);
      }
}

// out[e] = sum over the blocks' partials, in a fixed order: a block of
// SUM_WARPS warps takes 32 consecutive elements, warp w sums partials w,
// w + SUM_WARPS, ... in turn, then one warp adds the SUM_WARPS sums in turn
constexpr int SUM_WARPS = 8;

__global__ void __launch_bounds__(SUM_WARPS * 32)
sum_partials_kernel(const float* __restrict__ partial, float* __restrict__ out,
                    int elems, int blocks) {
  __shared__ float part[SUM_WARPS][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int e = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (e < elems)
    for (int k = w; k < blocks; k += SUM_WARPS) s += partial[(size_t)k * elems + e];
  part[w][lane] = s;
  __syncthreads();
  if (w == 0 && e < elems) {
    float total = 0.f;
#pragma unroll
    for (int v = 0; v < SUM_WARPS; ++v) total += part[v][lane];
    out[e] = total;
  }
}

// ------------------------------------------------------------------------- //
// launchers

// Launch a persistent kernel over the ring of rows (the forward, the
// dgrad): as many blocks of FWD_THREADS as fit on `sms` multiprocessors at
// `smem` bytes of shared memory each, on the plan of B x H x Wout (Wout:
// the positions its strips cover).  The kernel takes args..., then the
// plan's strips, steps per item, chunks and items.  With `plan` non-null,
// the plan only, no launch.
template <class Kern, class... Args>
int launch_ring(Kern kern, int smem, int B, int H, int Wout, int sms, FwdPlan* plan,
                cudaStream_t stream, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, FWD_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const FwdPlan p = fwd_plan(B, H, Wout, per_sm * sms);
  if (plan) {
    *plan = p;
    return 0;
  }
  kern<<<p.blocks, FWD_THREADS, smem, stream>>>(args..., p.strips, p.chunk_steps, p.chunks,
                                                 p.items);
  return (int)cudaGetLastError();
}

template <int KT, int S>
int launch_fwd(const void* x, const void* wp, const void* bias, void* y, int B,
               int H, int W, int Wout, int sms, float slope, FwdPlan* plan,
               cudaStream_t stream) {
  return launch_ring(spec_conv_fwd_kernel<KT, S>, Fwd<KT, S>::SMEM, B, H, Wout, sms, plan,
                     stream, (const uint16_t*)x, (const uint16_t*)wp, (const float*)bias,
                     (__nv_bfloat16*)y, slope, H, W, Wout);
}

// the dgrad's strips cover d's W_out positions
template <int KT, int S>
int launch_dgrad(const void* d, const void* wp, void* dx, int B, int H, int W,
                 int Wout, int sms, FwdPlan* plan, cudaStream_t stream) {
  return launch_ring(spec_conv_dgrad_kernel<KT, S>, Dgr<KT, S>::SMEM, B, H, Wout, sms, plan,
                     stream, (const uint16_t*)d, (const uint16_t*)wp, (__nv_bfloat16*)dx, H,
                     W, Wout);
}

template <int KT, int S>
int launch_wgrad(const void* x, const void* d, void* partial, void* dw, int B,
                 int H, int W, int Wout, int sms, int partial_blocks,
                 WgrPlan* plan, cudaStream_t stream) {
  using G = Wgr<KT, S>;
  auto kern = spec_conv_wgrad_kernel<KT, S>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, G::THREADS, G::SMEM);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const WgrPlan p = wgr_plan(B, H, Wout, G::ROWS, G::CHUNK_STEPS, per_sm * sms);
  if (plan) {  // the plan only, no launch
    *plan = p;
    return 0;
  }
  if (p.blocks != partial_blocks) return (int)cudaErrorInvalidValue;
  kern<<<p.blocks, G::THREADS, G::SMEM, stream>>>(
      (const uint16_t*)x, (const uint16_t*)d, (float*)partial, H, W, Wout, p.strips,
      p.steps_h, p.chunks, p.items);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials_kernel<<<(G::ELEMS + 31) / 32, SUM_WARPS * 32, 0, stream>>>(
      (const float*)partial, (float*)dw, G::ELEMS, p.blocks);
  return (int)cudaGetLastError();
}

}  // namespace

// Each launcher enqueues on `stream` and returns cudaGetLastError() of its
// launches (0 = ok).  Tensors are contiguous; x, d, dx, y bf16 [B, H, *, 32];
// wp the packed weights (ops/spec_conv.py: pack_weights_gmma, and for the
// dgrad pack_weights_dgrad); bias f32 [32]; kt 9 or 3; stride 1 or 2.

// sms: the card's multiprocessor count; the launch holds as many blocks as
// fit on them at once (see fwd_plan).
static int forward_dispatch(const void* x, const void* wp, const void* bias,
                            void* y, int B, int H, int W, int Wout, int kt,
                            int stride, int sms, float slope, FwdPlan* plan,
                            void* stream) {
#define CALL_FWD(K, S2) launch_fwd<K, S2>(x, wp, bias, y, B, H, W, Wout, sms, slope, plan, (cudaStream_t)stream)
  if (kt == 9 && stride == 2) return CALL_FWD(9, 2);
  if (kt == 9 && stride == 1) return CALL_FWD(9, 1);
  if (kt == 3 && stride == 2) return CALL_FWD(3, 2);
  if (kt == 3 && stride == 1) return CALL_FWD(3, 1);
  return (int)cudaErrorInvalidValue;
#undef CALL_FWD
}

extern "C" int spec_conv_forward_bf16(const void* x, const void* wp,
                                      const void* bias, void* y, int B, int H,
                                      int W, int Wout, int kt, int stride,
                                      int sms, float slope, void* stream) {
  return forward_dispatch(x, wp, bias, y, B, H, W, Wout, kt, stride, sms,
                          slope, nullptr, stream);
}

static void put_plan(const FwdPlan& p, int* out) {
  out[0] = p.blocks;
  out[1] = p.strips;
  out[2] = p.chunk_steps;
  out[3] = p.chunks;
  out[4] = p.items;
}

// The forward's work split for a shape, without a launch: out[0..4] =
// blocks, strips, steps per item, chunks, items.
extern "C" int spec_conv_forward_plan(int B, int H, int Wout, int kt,
                                      int stride, int sms, int* out) {
  FwdPlan p;
  const int err = forward_dispatch(nullptr, nullptr, nullptr, nullptr, B, H, 0,
                                   Wout, kt, stride, sms, 0.f, &p, nullptr);
  if (err == 0) put_plan(p, out);
  return err;
}

static int dgrad_dispatch(const void* d, const void* wp, void* dx, int B, int H,
                          int W, int Wout, int kt, int stride, int sms,
                          FwdPlan* plan, void* stream) {
#define CALL_DGR(K, S2) launch_dgrad<K, S2>(d, wp, dx, B, H, W, Wout, sms, plan, (cudaStream_t)stream)
  if (kt == 9 && stride == 2) return CALL_DGR(9, 2);
  if (kt == 9 && stride == 1) return CALL_DGR(9, 1);
  if (kt == 3 && stride == 2) return CALL_DGR(3, 2);
  if (kt == 3 && stride == 1) return CALL_DGR(3, 1);
  return (int)cudaErrorInvalidValue;
#undef CALL_DGR
}

// wp: the flipped, transposed weights packed as the forward's.
extern "C" int spec_conv_dgrad_bf16(const void* d, const void* wp, void* dx,
                                    int B, int H, int W, int Wout, int kt,
                                    int stride, int sms, void* stream) {
  return dgrad_dispatch(d, wp, dx, B, H, W, Wout, kt, stride, sms, nullptr, stream);
}

// The dgrad's work split for a shape (Wout: d's width), without a launch:
// out[0..4] as spec_conv_forward_plan's.
extern "C" int spec_conv_dgrad_plan(int B, int H, int Wout, int kt, int stride,
                                    int sms, int* out) {
  FwdPlan p;
  const int err = dgrad_dispatch(nullptr, nullptr, nullptr, B, H, 0, Wout, kt, stride,
                                 sms, &p, nullptr);
  if (err == 0) put_plan(p, out);
  return err;
}

static int wgrad_dispatch(const void* x, const void* d, void* partial, void* dw,
                          int B, int H, int W, int Wout, int kt, int stride,
                          int sms, int partial_blocks, WgrPlan* plan, void* stream) {
#define CALL_WGR(K, S2) launch_wgrad<K, S2>(x, d, partial, dw, B, H, W, Wout, sms, partial_blocks, plan, (cudaStream_t)stream)
  if (kt == 9 && stride == 2) return CALL_WGR(9, 2);
  if (kt == 9 && stride == 1) return CALL_WGR(9, 1);
  if (kt == 3 && stride == 2) return CALL_WGR(3, 2);
  if (kt == 3 && stride == 1) return CALL_WGR(3, 1);
  return (int)cudaErrorInvalidValue;
#undef CALL_WGR
}

// partial: f32 [blocks, 3*kt*32*32] scratch, blocks as spec_conv_wgrad_plan
// gives them for this shape and sms; dw: f32 [3, kt, 32, 32].
extern "C" int spec_conv_wgrad_bf16(const void* x, const void* d, void* partial,
                                    void* dw, int B, int H, int W, int Wout,
                                    int kt, int stride, int sms, int blocks,
                                    void* stream) {
  return wgrad_dispatch(x, d, partial, dw, B, H, W, Wout, kt, stride, sms, blocks,
                        nullptr, stream);
}

// The wgrad's work split for a shape, without a launch: out[0..4] =
// blocks, strips, steps down H, chunks, items.
extern "C" int spec_conv_wgrad_plan(int B, int H, int Wout, int kt, int stride,
                                    int sms, int* out) {
  WgrPlan p;
  const int err = wgrad_dispatch(nullptr, nullptr, nullptr, nullptr, B, H, 0, Wout, kt,
                                 stride, sms, 0, &p, nullptr);
  if (err == 0) {
    out[0] = p.blocks;
    out[1] = p.strips;
    out[2] = p.steps_h;
    out[3] = p.chunks;
    out[4] = p.items;
  }
  return err;
}
