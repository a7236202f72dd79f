// Implicit-GEMM convolution over NHWC fp32 activations at stride 1 or 2, for Hopper
// (sm_90a): the fp32 arm of TPU kernel 1.
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_conv.py:_taps_kernel, launched by
// _conv_s1 (pallas_conv.py:152-207).  It computes the same function, with a stride:
//
//   y[n, ho, wo, o] = sum_{dh < KH, dw < KW, c < C}
//                     xpad[n, S * ho + dh, S * wo + dw, c] * taps[dh * KW + dw, c, o]
//
// where xpad is x padded by pad_top rows and pad_left columns of zeros (and as many
// at the far edges as the output needs), S the stride (1 or 2), x (N, H, W, C), taps
// (KH*KW, C, O) and y (N, Ho, Wo, O).  ResNet-50's 3x3 / pad-1 convolutions run it
// with 3x3 taps at stride 1 and, natively, at stride 2 (the TPU kernel takes stride 2
// as a 2x2 conv over 4C channels after a space-to-depth copy, which does 16/9 of the
// MACs; here the stride-2 rows gather their pixels straight from x), and the data
// gradient of the stride-1 ones with flipped, io-swapped taps (ops/hopper_conv.py).
//
// Numerics: fp32 in and out, every product and sum in fp32 FMA on the CUDA cores (no
// TF32, no tensor cores).  bf16 inputs take taps_conv_bf16.cu (the tensor cores)
// instead.  Against the plain PyTorch version (a per-tap loop of fp32 matmuls) only the
// order of the sums differs; at unit-scale data the two agree to 1e-4 absolute and
// relative, the tolerance the tests and chip_smoke.py state.
//
// Bound at the main path's shapes (batch 32): each 3x3 is 3.7-7.4 GFLOP on 4-51 MB, so
// every one is bound by operations (0.110 ms a 7.4-GFLOP conv at 67 TFLOP/s fp32), not
// bytes.  What holds an FMA kernel back from that rate is everything that is not an FMA:
// shared-memory loads, barriers, address arithmetic, and SMs left idle by the grid.  The
// design is taps_wgrad.cu's (kernel 2 fp32), turned to the forward GEMM of M = N*Ho*Wo
// pixel rows by O channel columns with a reduction of KH*KW*C:
//
//   - Register-tiled outer products: 256 threads, 16 x 16 over the block's BM x BN
//     output tile, each thread 4-wide sub-tiles 64 apart both ways (8 x 4 accumulators at
//     128 x 64, 4 x 4 at 64 x 64).  The input rows are staged pixel-
//     major (their channels contiguous, as cp.async copies them) and read as float4s of 4
//     channels: within a quarter warp all lanes read one row (a broadcast), and the taps
//     as float4s of 4 consecutive output channels (8 lanes, 128 consecutive bytes): no
//     bank conflicts, 10.7 FMAs a 16-byte shared load at 128 x 64.
//   - A 4-stage shared-memory ring of 16-channel stages filled by cp.async: 16-byte copies
//     (cp.async.cg, 4 channels) where C and O are multiples of 4 and x, taps and y are
//     16-byte aligned, else 4-byte copies (cp.async.ca) in the same kernel (template VEC
//     = false).  The padding, the ragged channel edges and the rows past M are zero-filled
//     by a source size of 0, so there is no padded copy of x and no im2col.  One barrier
//     a stage.
//   - Each thread works out its rows' input pixel once; the stage's tap and channel block
//     are carried from stage to stage, so the loop divides nothing.
//   - A host plan (ops/hopper_conv.py conv_fp32_plan) picks the tile and a split of the
//     reduction over whole waves of the SMs: at 7 and 14 px the output tiles alone leave
//     most of the card idle.  Each split writes its partial output to a workspace
//     (splits, M, O) that the wrapper allocates, and split_sum.cuh's pass sums them in a
//     fixed order, so the same inputs give the same bits on every run; with one split
//     the kernel writes y itself.

#include "cp_async.cuh"
#include "split_sum.cuh"

namespace {

struct fp32_3x3_conv;                  // names this library's split sum in a trace

constexpr int BK = 16;                 // input channels a stage
constexpr int STAGES = 4;              // shared-memory ring depth
constexpr int THREADS = 256;           // 16 x 16 over the output tile
constexpr int A_PITCH = BK + 4;        // floats of a staged input row (16-byte aligned)

template <int BM, int BN>
struct Tile {
  static constexpr int SA = BM / 64;                   // a thread's 4-row sub-tiles
  static constexpr int SB = BN / 64;                   // ... and 4-column ones
  static constexpr int A_FLOATS = BM * A_PITCH;
  static constexpr int STAGE_FLOATS = A_FLOATS + BK * BN;
  static constexpr int SMEM = STAGES * STAGE_FLOATS * (int)sizeof(float);
  static constexpr int A_COPIES = BM * (BK / 4) / THREADS;   // 16-byte chunks a thread
  static constexpr int B_CPR = BN / 4;                       // chunks of a taps row
  static constexpr int B_RPP = THREADS / B_CPR;              // taps rows a pass copies
  static constexpr int B_COPIES = BK / B_RPP;
  // blocks an SM holds: what __launch_bounds__ asks and the host plan assumes
  static constexpr int PER_SM = BM * BN >= 128 * 64 ? 2 : 4;
  static_assert(SA >= 1 && SB >= 1 && SA * 64 == BM && SB * 64 == BN, "64-wide sub-tiles");
  static_assert(A_COPIES * THREADS == BM * (BK / 4), "A copies must cover the stage");
  static_assert(B_COPIES * B_RPP == BK, "B copies must cover the stage");
};

template <int BM, int BN, bool VEC>
__global__ void __launch_bounds__(THREADS, Tile<BM, BN>::PER_SM)
taps_conv_kernel(const float* __restrict__ x, const float* __restrict__ taps,
                 float* __restrict__ out, int N, int H, int W, int C, int O, int KH, int KW,
                 int stride, int pad_top, int pad_left, int Ho, int Wo, int kper) {
  using T = Tile<BM, BN>;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int hw = Ho * Wo;
  const int M = N * hw;
  const int m0 = blockIdx.x * BM, o0 = blockIdx.y * BN, split = blockIdx.z;
  const int cblocks = (C + BK - 1) / BK;
  const int kbeg = split * kper;
  const int kend = min(kbeg + kper, KH * KW * cblocks);
  const int ksteps = max(kend - kbeg, 0);

  // input copies: this thread copies chunk a_ch of rows a_row + 64 * i; per row the
  // input pixel of tap (0, 0) as (n*H*W + h*W + w, h, w), h far out of range past M
  const int a_ch = tid % 4, a_row = tid / 4;
  int a_pix[T::A_COPIES], a_h[T::A_COPIES], a_w[T::A_COPIES];
#pragma unroll
  for (int i = 0; i < T::A_COPIES; ++i) {
    const int m = m0 + a_row + 64 * i;
    if (m < M) {
      const int n = m / hw, rem = m - n * hw;
      const int ho = rem / Wo;
      a_h[i] = ho * stride - pad_top;
      a_w[i] = (rem - ho * Wo) * stride - pad_left;
      a_pix[i] = (n * H + a_h[i]) * W + a_w[i];
    } else {
      a_h[i] = -(1 << 28);
      a_w[i] = 0;
      a_pix[i] = 0;
    }
  }
  // taps copies: chunk b_ch of reduction rows b_row + B_RPP * j
  const int b_ch = tid % T::B_CPR, b_row = tid / T::B_CPR;
  const int b_o = o0 + 4 * b_ch;

  // the next stage to load, as (tap row, tap column, channel block), carried from load
  // to load
  int l_dh = kbeg / cblocks, l_cb = kbeg - l_dh * cblocks;
  int l_dw = l_dh % KW;
  l_dh /= KW;

  auto load_stage = [&](int buf) {
    float* as = smem + buf * T::STAGE_FLOATS;
    float* bs = as + T::A_FLOATS;
    const int c0 = l_cb * BK;
    const int c = c0 + 4 * a_ch;
#pragma unroll
    for (int i = 0; i < T::A_COPIES; ++i) {
      const int hi = a_h[i] + l_dh, wi = a_w[i] + l_dw;
      const bool pix = (unsigned)hi < (unsigned)H && (unsigned)wi < (unsigned)W;
      const float* src = x + ((long long)a_pix[i] + l_dh * W + l_dw) * C + c;
      const uint32_t dst = smem_addr(as + (a_row + 64 * i) * A_PITCH + 4 * a_ch);
      if (VEC) {
        cp_async16(dst, pix && c < C ? src : x, pix && c < C);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          cp_async4(dst + 4 * e, pix && c + e < C ? src + e : x, pix && c + e < C);
      }
    }
    const float* t = taps + (long long)(l_dh * KW + l_dw) * C * O;
#pragma unroll
    for (int j = 0; j < T::B_COPIES; ++j) {
      const int r = b_row + T::B_RPP * j;
      const int cc = c0 + r;
      const float* src = t + (long long)cc * O + b_o;
      const uint32_t dst = smem_addr(bs + r * BN + 4 * b_ch);
      if (VEC) {
        cp_async16(dst, cc < C && b_o < O ? src : taps, cc < C && b_o < O);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          cp_async4(dst + 4 * e, cc < C && b_o + e < O ? src + e : taps,
                    cc < C && b_o + e < O);
      }
    }
    if (++l_cb == cblocks) {             // the next stage: a channel block on
      l_cb = 0;
      if (++l_dw == KW) {
        l_dw = 0;
        ++l_dh;
      }
    }
  };

  const int tx = tid % 16;               // output-channel group of this thread
  const int ty = tid / 16;               // pixel group of this thread
  float acc[T::SA * 4][T::SB * 4];
#pragma unroll
  for (int i = 0; i < T::SA * 4; ++i)
#pragma unroll
    for (int j = 0; j < T::SB * 4; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ksteps) load_stage(s);
    cp_async_commit();
  }
  for (int ks = 0; ks < ksteps; ++ks) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (ks + STAGES - 1 < ksteps) load_stage((ks + STAGES - 1) % STAGES);
    cp_async_commit();

    const float* as = smem + (ks % STAGES) * T::STAGE_FLOATS;
    const float* bs = as + T::A_FLOATS;
#pragma unroll
    for (int kq = 0; kq < BK / 4; ++kq) {
      float4 a[T::SA * 4];               // 4 channels of each of this thread's rows
#pragma unroll
      for (int s = 0; s < T::SA; ++s)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[4 * s + i] =
              *reinterpret_cast<const float4*>(as + (s * 64 + ty * 4 + i) * A_PITCH + 4 * kq);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float b[T::SB * 4];
#pragma unroll
        for (int s = 0; s < T::SB; ++s) {
          const float4 v =
              *reinterpret_cast<const float4*>(bs + (4 * kq + k) * BN + s * 64 + tx * 4);
          b[4 * s] = v.x;
          b[4 * s + 1] = v.y;
          b[4 * s + 2] = v.z;
          b[4 * s + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < T::SA * 4; ++i) {
          const float av = k == 0 ? a[i].x : k == 1 ? a[i].y : k == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < T::SB * 4; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();
  allow_split_sum();

  // out is y (one split) or the workspace (splits, M, O): rows m are NHWC pixels, so
  // out[m * O + o]; 16-byte stores where O is a multiple of 4 (out is 16-byte aligned)
  float* dst = out + (long long)split * M * O;
#pragma unroll
  for (int s = 0; s < T::SA; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + s * 64 + ty * 4 + i;
      if (m >= M) continue;
      float* row = dst + (long long)m * O;
      const float* v = acc[4 * s + i];
#pragma unroll
      for (int sb = 0; sb < T::SB; ++sb) {
        const int o = o0 + sb * 64 + tx * 4;
        if ((O & 3) == 0) {
          if (o < O)
            *reinterpret_cast<float4*>(row + o) =
                make_float4(v[4 * sb], v[4 * sb + 1], v[4 * sb + 2], v[4 * sb + 3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (o + j < O) row[o + j] = v[4 * sb + j];
        }
      }
    }
}

// above 48 KB of dynamic shared memory only after this, once a device and instantiation
template <int BM, int BN, bool VEC>
cudaError_t allow_smem(int device) {
  static bool done[64];
  if (device >= 0 && device < 64 && done[device]) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(taps_conv_kernel<BM, BN, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Tile<BM, BN>::SMEM);
  if (err == cudaSuccess && device >= 0 && device < 64) done[device] = true;
  return err;
}

template <int BM, int BN, bool VEC>
cudaError_t launch_conv(dim3 grid, const void* x, const void* taps, float* dst, int N,
                        int H, int W, int C, int O, int KH, int KW, int stride, int pad_top,
                        int pad_left, int Ho, int Wo, int kper, int device, cudaStream_t s) {
  cudaError_t err = allow_smem<BM, BN, VEC>(device);
  if (err != cudaSuccess) return err;
  taps_conv_kernel<BM, BN, VEC><<<grid, THREADS, Tile<BM, BN>::SMEM, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(taps), dst, N, H, W, C, O, KH,
      KW, stride, pad_top, pad_left, Ho, Wo, kper);
  return cudaGetLastError();
}

template <int BM, int BN, bool VEC>
cudaError_t occupancy(int* blocks, int device) {
  cudaError_t err = allow_smem<BM, BN, VEC>(device);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, taps_conv_kernel<BM, BN, VEC>,
                                                       THREADS, Tile<BM, BN>::SMEM);
}

bool known_tile(int bm, int bn) {
  return (bm == 128 && bn == 64) || (bm == 64 && bn == 64);
}

}  // namespace

// Plain C entry point, bound with ctypes.  x: (N, H, W, C), taps: (KH*KW, C, O), y:
// (N, Ho, Wo, O), all fp32 and contiguous on `device`; workspace: (splits, N*Ho*Wo, O)
// fp32 when splits > 1 (else unused).  The tile (bm x bn: 128 x 64 or 64 x 64), the split of the reduction (split s walks stages [s * kper, (s + 1) * kper)
// of the KH*KW*ceil(C/16) stages of 16 channels) and vec (1: C and O multiples of 4 and
// x, taps and y 16-byte aligned, the 16-byte copy path; 0: 4-byte copies) come from the
// host plan; stride is 1 or 2.  Another tile or stride, splits that do not cover the
// stages, or an index range past 32 bits return cudaErrorInvalidValue, vec = 1 on
// operands that do not allow it cudaErrorMisalignedAddress.  Launches the convolution
// and, when splits > 1, the split sum on `stream`, counts each launch in launched[0]
// (convolutions) and launched[1] (split sums), which it zeroes first, and returns
// cudaGetLastError() after them (0 on success).
extern "C" int mxtt_taps_conv(const void* x, const void* taps, float* y, float* workspace,
                              int N, int H, int W, int C, int O, int KH, int KW, int stride,
                              int pad_top, int pad_left, int Ho, int Wo, int bm, int bn,
                              int splits, int kper, int vec, int device, void* stream,
                              int* launched) {
  launched[0] = launched[1] = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long M = (long long)N * Ho * Wo;
  if (!known_tile(bm, bn) || (stride != 1 && stride != 2) || N < 0 || C < 1 || O < 1 ||
      KH < 1 || KW < 1 || Ho < 0 || Wo < 0)
    return (int)cudaErrorInvalidValue;
  const long long ktotal = (long long)KH * KW * ((C + BK - 1) / BK);
  if (splits < 1 || splits > 65535 || kper < 1 || (long long)splits * kper < ktotal ||
      (splits > 1 && workspace == nullptr) || (long long)N * H * W >= (1LL << 31) ||
      M >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (vec && (C % 4 || O % 4 || !aligned16(x) || !aligned16(taps) || !aligned16(y)))
    return (int)cudaErrorMisalignedAddress;
  if (M == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)((M + bm - 1) / bm), (unsigned)((O + bn - 1) / bn),
                  (unsigned)splits);
  float* dst = splits > 1 ? workspace : y;
#define MXTT_CONV(BM_, BN_, V)                                                            \
  launch_conv<BM_, BN_, V>(grid, x, taps, dst, N, H, W, C, O, KH, KW, stride, pad_top,    \
                           pad_left, Ho, Wo, kper, device, s)
  if (bm == 128)
    err = vec ? MXTT_CONV(128, 64, true) : MXTT_CONV(128, 64, false);
  else
    err = vec ? MXTT_CONV(64, 64, true) : MXTT_CONV(64, 64, false);
#undef MXTT_CONV
  if (err != cudaSuccess) return (int)err;
  launched[0] = 1;
  if (splits == 1) return (int)cudaSuccess;
  err = launch_split_sum<fp32_3x3_conv>(workspace, y, M * O, splits, s);
  if (err == cudaSuccess) launched[1] = 1;
  return (int)err;
}

// Blocks of the (bm x bn, vec) instantiation that one SM holds at once, into *blocks:
// what the host plan assumes, read on the card.  Returns a CUDA error code.
extern "C" int mxtt_taps_conv_occupancy(int bm, int bn, int vec, int device, int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!known_tile(bm, bn)) return (int)cudaErrorInvalidValue;
  if (bm == 128)
    err = vec ? occupancy<128, 64, true>(blocks, device)
              : occupancy<128, 64, false>(blocks, device);
  else
    err = vec ? occupancy<64, 64, true>(blocks, device)
              : occupancy<64, 64, false>(blocks, device);
  return (int)err;
}
