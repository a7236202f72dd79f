// Implicit-GEMM stride-1 convolution over NHWC activations, for Hopper (sm_90a).
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_conv.py:_taps_kernel, launched by
// _conv_s1 (pallas_conv.py:152-207).  It computes the same function:
//
//   y[n, ho, wo, o] = sum_{dh < KH, dw < KW, c < C}
//                     xpad[n, ho + dh, wo + dw, c] * taps[dh * KW + dw, c, o]
//
// where xpad is x padded by (pad_top, pad_bottom) rows and (pad_left, pad_right)
// columns of zeros, so Ho = H + pad_top + pad_bottom - KH + 1 and likewise Wo.
// The 3x3 / stride-1 / pad-1 convolutions of ResNet-50 run it with 3x3 taps; the
// 3x3 / stride-2 / pad-1 ones run it with 2x2 taps on 4C channels after the exact
// space-to-depth rewrite done by the Python wrapper (mxnet_tpu_torch/ops/hopper_conv.py).
//
// Numerics: fp32 in and out, every product and sum in fp32 FMA on the CUDA
// cores (no TF32, no tensor cores).  bf16 inputs take taps_conv_bf16.cu (the
// tensor cores) instead.
// Against the plain PyTorch version (a per-tap loop of fp32 matmuls) only the
// order of the sums differs; at unit-scale data the two agree to 1e-4 absolute
// and relative, the tolerance the tests and chip_smoke.py state.
//
// Design.  The TPU kernel stacked NB images per grid step to fill VMEM, laid the
// images on an 8-aligned frame stride and fetched overlapping element-indexed
// slabs; all three are TPU artifacts and none is kept.  Here the output is a GEMM
// of M = N*Ho*Wo pixel rows by O channel columns with a reduction of KH*KW*C.
// Each block owns a BM x BN output tile and walks the reduction in stages of BK
// channels of one tap; a stage's input rows are gathered straight from x with the
// padding and the ragged tile edge masked to zero (no padded copy, no im2col in
// device memory), staged through shared memory, and multiplied by a BK x BN slice
// of the taps.  The next stage's global loads are issued into registers before
// the current stage's FMAs, so the loads overlap the arithmetic.  Each thread
// keeps an 8 x 4 fp32 accumulator in registers.  The kernel allocates nothing and
// runs on the stream it is given.
//
// Bound at the slice's shapes (ResNet-50 forward, batch N, fp32):
//   stride 1:  64->64 at 56x56 (x3), 128->128 at 28x28 (x3), 256->256 at 14x14 (x5),
//              512->512 at 7x7 (x2)
//   stride 2:  128->128 56->28, 256->256 28->14, 512->512 14->7 (each as 2x2 taps on
//              4C channels after space-to-depth, which does 16/9 of the MACs)
// At batch 32 each instance does 2*N*Ho*Wo*O*9*C = 3.7-7.4 GFLOP on 4-51 MB of
// input and output, about 150-1000 FLOP per byte, so in fp32 on the CUDA cores
// (67 TFLOP/s against 3.35 TB/s) every instance is bound by operations, not bytes.
// Tensor cores (TF32 wgmma), TMA and a pipelined shared-memory ring are the later
// steps towards that bound.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;                   // output pixels per block
constexpr int BN = 64;                    // output channels per block
constexpr int BK = 16;                    // reduction channels per stage
constexpr int THREADS = 256;
constexpr int TM = 8;                     // pixels per thread
constexpr int TN = 4;                     // channels per thread
constexpr int A_ROWS = THREADS / BK;      // pixel rows one pass of the block loads
constexpr int A_LOADS = BM / A_ROWS;      // A elements loaded per thread per stage
constexpr int B_ROWS = THREADS / BN;
constexpr int B_LOADS = BK / B_ROWS;      // B elements loaded per thread per stage
constexpr int A_PAD = 4;                  // keeps rows 16-byte aligned, eases bank conflicts

static_assert((BM / TM) * (BN / TN) == THREADS, "thread tile must cover the block tile");
static_assert(BM % A_ROWS == 0 && BK % B_ROWS == 0, "loads must cover the stage");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }

template <typename T>
__global__ void __launch_bounds__(THREADS)
taps_conv_kernel(const T* __restrict__ x, const T* __restrict__ taps, T* __restrict__ y,
                 int N, int H, int W, int C, int O, int KH, int KW,
                 int pad_top, int pad_left, int Ho, int Wo) {
  __shared__ __align__(16) float As[BK][BM + A_PAD];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const long long M = (long long)N * Ho * Wo;
  const long long m0 = (long long)blockIdx.x * BM;
  const int o0 = blockIdx.y * BN;

  // A (input rows): this thread loads channel a_k of pixels a_m + i * A_ROWS.
  const int a_k = tid % BK;
  const int a_m = tid / BK;
  int a_n[A_LOADS], a_h[A_LOADS], a_w[A_LOADS];
#pragma unroll
  for (int i = 0; i < A_LOADS; ++i) {
    const long long m = m0 + a_m + i * A_ROWS;
    if (m < M) {
      const long long hw = (long long)Ho * Wo;
      const int rem = (int)(m % hw);
      a_n[i] = (int)(m / hw);
      a_h[i] = rem / Wo - pad_top;
      a_w[i] = rem % Wo - pad_left;
    } else {
      a_n[i] = -1;
      a_h[i] = 0;
      a_w[i] = 0;
    }
  }
  // B (taps): this thread loads column b_o of reduction rows b_k + j * B_ROWS.
  const int b_o = tid % BN;
  const int b_k = tid / BN;

  const int cblocks = (C + BK - 1) / BK;
  const int stages = KH * KW * cblocks;

  float a_reg[A_LOADS], b_reg[B_LOADS];
  auto load_stage = [&](int s) {
    const int tap = s / cblocks;
    const int c0 = (s % cblocks) * BK;
    const int dh = tap / KW, dw = tap % KW;
    const int c = c0 + a_k;
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      const int hi = a_h[i] + dh, wi = a_w[i] + dw;
      float v = 0.f;
      if (a_n[i] >= 0 && c < C && hi >= 0 && hi < H && wi >= 0 && wi < W)
        v = to_f32(x[(((long long)a_n[i] * H + hi) * W + wi) * C + c]);
      a_reg[i] = v;
    }
    const T* t = taps + (long long)tap * C * O;
    const int o = o0 + b_o;
#pragma unroll
    for (int j = 0; j < B_LOADS; ++j) {
      const int cc = c0 + b_k + j * B_ROWS;
      b_reg[j] = (cc < C && o < O) ? to_f32(t[(long long)cc * O + o]) : 0.f;
    }
  };

  const int tx = tid % (BN / TN);         // channel group of this thread
  const int ty = tid / (BN / TN);         // pixel group of this thread
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  if (stages > 0) load_stage(0);
  for (int s = 0; s < stages; ++s) {
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) As[a_k][a_m + i * A_ROWS] = a_reg[i];
#pragma unroll
    for (int j = 0; j < B_LOADS; ++j) Bs[b_k + j * B_ROWS][b_o] = b_reg[j];
    __syncthreads();
    if (s + 1 < stages) load_stage(s + 1);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a_lo = *reinterpret_cast<const float4*>(&As[k][ty * TM]);
      const float4 a_hi = *reinterpret_cast<const float4*>(&As[k][ty * TM + 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[k][tx * TN]);
      const float a[TM] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w, a_hi.x, a_hi.y, a_hi.z, a_hi.w};
      const float b[TN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // NHWC output: row m of the GEMM is pixel (n, ho, wo) flattened, so y[m * O + o].
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long m = m0 + ty * TM + i;
    if (m >= M) continue;
    T* row = y + m * O;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int o = o0 + tx * TN + j;
      if (o < O) store_as(row + o, acc[i][j]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* taps, void* y, int N, int H, int W, int C,
                   int O, int KH, int KW, int pad_top, int pad_left, int Ho, int Wo,
                   cudaStream_t stream) {
  const long long M = (long long)N * Ho * Wo;
  if (M == 0 || O == 0) return cudaSuccess;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((O + BN - 1) / BN));
  taps_conv_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(taps), static_cast<T*>(y),
      N, H, W, C, O, KH, KW, pad_top, pad_left, Ho, Wo);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes.  dtype: 0 = float32 (any other code is
// cudaErrorInvalidValue: bf16 has its own library, taps_conv_bf16.cu).
// x: (N, H, W, C), taps: (KH*KW, C, O), y: (N, Ho, Wo, O), all contiguous on
// `device`.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int mxtt_taps_conv(const void* x, const void* taps, void* y, int dtype,
                              int N, int H, int W, int C, int O, int KH, int KW,
                              int pad_top, int pad_left, int Ho, int Wo, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch<float>(x, taps, y, N, H, W, C, O, KH, KW, pad_top, pad_left, Ho, Wo, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
