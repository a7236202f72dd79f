// Implicit-GEMM convolution at stride 1 or 2 over NHWC bf16 activations on Hopper's
// tensor cores (sm_90a): the bf16 arm of TPU kernel 1.
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_conv.py:_taps_kernel, launched by _conv_s1
// (pallas_conv.py:152-207), for bf16 inputs.  It computes the same function:
//
//   y[n, ho, wo, o] = sum_{dh < KH, dw < KW, c < C}
//                     xpad[n, S * ho + dh, S * wo + dw, c] * taps[dh * KW + dw, c, o]
//
// with xpad x padded by (pad_top, pad_bottom) rows and (pad_left, pad_right) columns of
// zeros, S the stride (1 or 2), x (N, H, W, C), taps (KH*KW, C, O) and y (N, Ho, Wo, O),
// all bf16.  ResNet-50's 3x3 / pad-1 convolutions run it with 3x3 taps at stride 1 or 2
// (each output row gathers its input pixels at the stride), and the data gradient of the
// stride-1 ones with flipped, io-swapped taps.  The fp32 arm is implicit_gemm_conv.cu.
//
// Numerics: bf16 x bf16 products are exact in fp32 and the tensor cores (mma.sync
// m16n8k16, bf16 in, fp32 accumulate) sum them in fp32, as the reference's dot_general
// with preferred_element_type=f32 does; the sum is rounded once to bf16.  Against the
// plain PyTorch version (fp32 matmuls per tap) only the order of the sums differs, so an
// output may round to the neighbouring bf16 value: within 2^-7 of the value plus 1e-4 of
// the largest |y|, the tolerance chip_smoke.py states.
//
// Design.  The output is a GEMM of M = N*Ho*Wo pixel rows by O channel columns with a
// reduction of KH*KW*C, walked tap by tap in k-slices of BK = 64 channels.  A block owns a
// BM x BN tile (128 x 64 or 128 x 128, chosen by the host plan in ops/hopper_conv.py so
// that the grid fills the SMs in whole waves); each warp owns a 64 x 32 sub-tile held as
// 4 x 4 m16n8 fp32 accumulators.  Operands stay bf16 in a 3-stage shared-memory ring
// filled by 16-byte cp.async: the A slice gathers the 128 pixels' shifted input rows
// straight from NHWC x, and a source size of 0 zero-fills the halo's padding and the
// ragged M, C and O edges, so there is no padded copy and no im2col in device memory.
// Rows of both tiles are 128 bytes (A) or 128-256 bytes (B) and their 16-byte chunks are
// XOR-swizzled by the row's low three bits, so ldmatrix (A, row-major) and ldmatrix.trans
// (B, stored k-major with O contiguous) read 8 rows without bank conflicts.  The epilogue
// rounds to bf16 into a shared-memory tile and writes y with 16-byte stores.
//   cp.async was chosen over TMA for A: the block's 128 rows are flattened pixels that
// cross image rows (and images), which a 4-D TMA box cannot express unless the M tile is
// a spatial box, and at 7x7 and 14x14 such boxes waste most of a 128-row tile; the
// gather also takes any C through the same code.  mma.sync was chosen over wgmma: its
// fragment layouts need no shared-memory descriptors, and it reaches several times the
// fp32 CUDA-core ceiling that bounded the earlier FMA arm.
//   Operands that a 16-byte copy cannot take (C or O not a multiple of 8, or x or taps not
// 16-byte aligned) take a slower load path inside the same kernel (template VEC = false):
// bf16 loads into registers and 16-byte shared-memory stores, and bf16 scalar stores in
// the epilogue.
//
// Bound at the main path's shapes (bf16, batch 128): each 3x3 at 64-512 channels is 29.6
// GFLOP on 13-103 MB, about 300-2300 FLOP per byte, so at 989 TFLOP/s against 3.35 TB/s
// the 56x56/64 one is (barely) bound by bytes and the rest by operations.  mma.sync from
// a cp.async ring, one tile per block and no warp specialisation stay below wgmma's rate;
// a persistent grid, TMA and wgmma are the later steps towards the bound.

#include "mma_bf16.cuh"

namespace {

constexpr int BM = 128;                 // output pixels per block
constexpr int BK = 64;                  // reduction channels per stage (one tap)
constexpr int STAGES = 3;               // shared-memory ring depth
constexpr int WM = 64;                  // warp tile rows
constexpr int WN = 32;                  // warp tile columns
constexpr int MI = WM / 16;             // m16 fragments of a warp tile
constexpr int NI = WN / 8;              // n8 fragments of a warp tile
constexpr int A_CHUNKS = BK / 8;        // 16-byte chunks of an A row

template <int BN>
struct Cfg {
  static constexpr int THREADS = (BM / WM) * (BN / WN) * 32;
  static constexpr int B_CHUNKS = BN / 8;                 // 16-byte chunks of a B row
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BK * BN * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int C_PITCH = BN + 8;                  // bf16 pitch of the epilogue tile
  static constexpr int SMEM = STAGES * STAGE_BYTES;
  static constexpr int A_PER_THREAD = BM * A_CHUNKS / THREADS;
  static constexpr int B_PER_THREAD = BK * B_CHUNKS / THREADS;
  static constexpr int MIN_BLOCKS = BN == 64 ? 3 : 2;     // blocks an SM holds
  static_assert(BM * C_PITCH * 2 <= SMEM, "the epilogue tile must fit the ring");
  static_assert(A_PER_THREAD * THREADS == BM * A_CHUNKS, "A loads must cover the tile");
  static_assert(B_PER_THREAD * THREADS == BK * B_CHUNKS, "B loads must cover the tile");
  static_assert(THREADS % A_CHUNKS == 0 && THREADS % B_CHUNKS == 0, "fixed chunk a thread");
};

template <int BN, bool VEC>
__global__ void __launch_bounds__(Cfg<BN>::THREADS, Cfg<BN>::MIN_BLOCKS)
taps_conv_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ taps,
                      bf16* __restrict__ y, int N, int H, int W, int C, int O, int KH,
                      int KW, int stride, int pad_top, int pad_left, int Ho, int Wo) {
  using K = Cfg<BN>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp % (BM / WM), wn = warp / (BM / WM);
  const long long M = (long long)N * Ho * Wo;
  const long long m0 = (long long)blockIdx.x * BM;
  const int o0 = blockIdx.y * BN;

  // A: this thread copies chunk a_ch of rows a_row + i * (THREADS / A_CHUNKS); per row the
  // input pixel of tap (0, 0) as (n*H*W + h*W + w, h, w), h far out of range past row M
  const int a_ch = tid % A_CHUNKS;
  const int a_row = tid / A_CHUNKS;
  int a_pix[K::A_PER_THREAD], a_h[K::A_PER_THREAD], a_w[K::A_PER_THREAD];
#pragma unroll
  for (int i = 0; i < K::A_PER_THREAD; ++i) {
    const long long m = m0 + a_row + i * (K::THREADS / A_CHUNKS);
    if (m < M) {
      const int hw = Ho * Wo;
      const int n = (int)(m / hw), rem = (int)(m % hw);
      a_h[i] = rem / Wo * stride - pad_top;
      a_w[i] = rem % Wo * stride - pad_left;
      a_pix[i] = (n * H + a_h[i]) * W + a_w[i];
    } else {
      a_h[i] = -(1 << 28);
      a_w[i] = 0;
      a_pix[i] = 0;
    }
  }
  // B: this thread copies chunk b_ch of reduction rows b_row + j * (THREADS / B_CHUNKS)
  const int b_ch = tid % K::B_CHUNKS;
  const int b_row = tid / K::B_CHUNKS;
  const int b_o = o0 + 8 * b_ch;

  const int cblocks = (C + BK - 1) / BK;
  const int ksteps = KH * KW * cblocks;

  auto load_stage = [&](int buf, int s) {
    unsigned char* As = smem + buf * K::STAGE_BYTES;
    unsigned char* Bs = As + K::A_BYTES;
    const int tap = s / cblocks;
    const int c0 = (s - tap * cblocks) * BK;
    const int dh = tap / KW, dw = tap - (tap / KW) * KW;
    const int c = c0 + 8 * a_ch;
#pragma unroll
    for (int i = 0; i < K::A_PER_THREAD; ++i) {
      const int row = a_row + i * (K::THREADS / A_CHUNKS);
      const int hi = a_h[i] + dh, wi = a_w[i] + dw;
      const bool pix = hi >= 0 && hi < H && wi >= 0 && wi < W;
      const bf16* src = x + ((long long)a_pix[i] + dh * W + dw) * C + c;
      if (VEC) {
        cp_async16(smem_addr(As + swz(row, a_ch, BK * 2)), pix && c < C ? src : x,
                   pix && c < C);
      } else {
        *reinterpret_cast<uint4*>(As + swz(row, a_ch, BK * 2)) =
            load8(src, [&](int j) { return pix && c + j < C; });
      }
    }
    const bf16* t = taps + (long long)tap * C * O;
#pragma unroll
    for (int j = 0; j < K::B_PER_THREAD; ++j) {
      const int row = b_row + j * (K::THREADS / K::B_CHUNKS);
      const int cc = c0 + row;
      const bf16* src = t + (long long)cc * O + b_o;
      if (VEC) {
        cp_async16(smem_addr(Bs + swz(row, b_ch, BN * 2)), cc < C && b_o < O ? src : taps,
                   cc < C && b_o < O);
      } else {
        *reinterpret_cast<uint4*>(Bs + swz(row, b_ch, BN * 2)) =
            load8(src, [&](int q) { return cc < C && b_o + q < O; });
      }
    }
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ksteps) load_stage(s, s);
    cp_async_commit();
  }
  for (int ks = 0; ks < ksteps; ++ks) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = ks + STAGES - 1;
    if (next < ksteps) load_stage(next % STAGES, next);
    cp_async_commit();

    const unsigned char* As = smem + (ks % STAGES) * K::STAGE_BYTES;
    const unsigned char* Bs = As + K::A_BYTES;
    const uint32_t a_base = smem_addr(As), b_base = smem_addr(Bs);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[MI][4], bfr[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int row = wm * WM + i * 16 + (lane & 15);
        ldmatrix_x4(af[i], a_base + swz(row, kk * 2 + (lane >> 4), BK * 2));
      }
#pragma unroll
      for (int j = 0; j < NI / 2; ++j) {
        const int row = kk * 16 + (lane & 15);
        uint32_t r[4];
        ldmatrix_x4_trans(r, b_base + swz(row, (wn * WN + j * 16) / 8 + (lane >> 4), BN * 2));
        bfr[2 * j][0] = r[0];
        bfr[2 * j][1] = r[1];
        bfr[2 * j + 1][0] = r[2];
        bfr[2 * j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) mma_bf16(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // epilogue: round to bf16 into a BM x BN tile in shared memory, then 16-byte rows out
  bf16* Cs = reinterpret_cast<bf16*>(smem);
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const int row = wm * WM + i * 16 + g;
      const int col = wn * WN + j * 8 + 2 * q;
      *reinterpret_cast<__nv_bfloat162*>(Cs + row * K::C_PITCH + col) =
          __floats2bfloat162_rn(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<__nv_bfloat162*>(Cs + (row + 8) * K::C_PITCH + col) =
          __floats2bfloat162_rn(acc[i][j][2], acc[i][j][3]);
    }
  __syncthreads();
  for (int idx = tid; idx < BM * K::B_CHUNKS; idx += K::THREADS) {
    const int row = idx / K::B_CHUNKS, ch = idx % K::B_CHUNKS;
    const long long m = m0 + row;
    const int o = o0 + 8 * ch;
    if (m >= M || o >= O) continue;
    const bf16* src = Cs + row * K::C_PITCH + 8 * ch;
    bf16* dst = y + m * O + o;
    if (VEC) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int j = 0; j < 8 && o + j < O; ++j) dst[j] = src[j];
    }
  }
}

template <int BN, bool VEC>
cudaError_t launch(const void* x, const void* taps, void* y, int N, int H, int W, int C,
                   int O, int KH, int KW, int stride, int pad_top, int pad_left, int Ho,
                   int Wo, cudaStream_t stream) {
  using K = Cfg<BN>;
  // above 48 KB of dynamic shared memory only after this (per device, so on every call)
  cudaError_t err = cudaFuncSetAttribute(taps_conv_bf16_kernel<BN, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, K::SMEM);
  if (err != cudaSuccess) return err;
  const long long M = (long long)N * Ho * Wo;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((O + BN - 1) / BN));
  taps_conv_bf16_kernel<BN, VEC><<<grid, K::THREADS, K::SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(taps), static_cast<bf16*>(y), N, H,
      W, C, O, KH, KW, stride, pad_top, pad_left, Ho, Wo);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_bn(bool vec, const void* x, const void* taps, void* y, int N, int H,
                      int W, int C, int O, int KH, int KW, int st, int pt, int pl, int Ho,
                      int Wo, cudaStream_t s) {
  return vec ? launch<BN, true>(x, taps, y, N, H, W, C, O, KH, KW, st, pt, pl, Ho, Wo, s)
             : launch<BN, false>(x, taps, y, N, H, W, C, O, KH, KW, st, pt, pl, Ho, Wo, s);
}

}  // namespace

// Plain C entry point, bound with ctypes.  x: (N, H, W, C), taps: (KH*KW, C, O), y:
// (N, Ho, Wo, O), all bf16 and contiguous on `device`.  bn (64 or 128) and vec (1: C and O
// multiples of 8 and x, taps, y 16-byte aligned, so the 16-byte copy path; 0: the
// element path) come from the host plan; stride is 1 or 2.  vec = 1 on operands that do
// not allow it returns cudaErrorMisalignedAddress, another stride or an index range past
// 32 bits cudaErrorInvalidValue.  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int mxtt_taps_conv_bf16(const void* x, const void* taps, void* y, int N, int H,
                                   int W, int C, int O, int KH, int KW, int pad_top,
                                   int pad_left, int Ho, int Wo, int bn, int vec, int stride,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((bn != 64 && bn != 128) || (stride != 1 && stride != 2) || N < 0 || C < 1 || O < 1 ||
      KH < 1 || KW < 1)
    return (int)cudaErrorInvalidValue;
  if ((long long)N * H * W >= (1LL << 31) || (long long)N * Ho * Wo >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (vec && (C % 8 || O % 8 || !aligned16(x) || !aligned16(taps) || !aligned16(y)))
    return (int)cudaErrorMisalignedAddress;
  if ((long long)N * Ho * Wo == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = bn == 64
            ? launch_bn<64>(vec != 0, x, taps, y, N, H, W, C, O, KH, KW, stride, pad_top,
                            pad_left, Ho, Wo, s)
            : launch_bn<128>(vec != 0, x, taps, y, N, H, W, C, O, KH, KW, stride, pad_top,
                             pad_left, Ho, Wo, s);
  return (int)err;
}

// Blocks of the (bn, vec) instantiation that one SM holds at once, into *blocks: what the
// host plan assumes (3 at bn 64, 2 at bn 128), read on the card.  Returns a CUDA error code.
extern "C" int mxtt_taps_conv_bf16_occupancy(int bn, int vec, int device, int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bn != 64 && bn != 128) return (int)cudaErrorInvalidValue;
  // the attribute must be set before the query counts shared memory past 48 KB
  if (bn == 64) {
    auto k = vec ? taps_conv_bf16_kernel<64, true> : taps_conv_bf16_kernel<64, false>;
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<64>::SMEM);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, Cfg<64>::THREADS,
                                                          Cfg<64>::SMEM);
  } else {
    auto k = vec ? taps_conv_bf16_kernel<128, true> : taps_conv_bf16_kernel<128, false>;
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<128>::SMEM);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, Cfg<128>::THREADS,
                                                          Cfg<128>::SMEM);
  }
  return (int)err;
}