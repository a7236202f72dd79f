// Weight gradient of the stride-1 implicit-GEMM convolution, for Hopper (sm_90a).
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_conv.py:_wgrad_kernel, launched by
// _wgrad_s1 (pallas_conv.py:165-240).  It computes the same function:
//
//   dw[dh * KW + dw, c, o] = sum_{n, ho, wo} xpad[n, ho + dh, wo + dw, c] * dy[n, ho, wo, o]
//
// with xpad as in implicit_gemm_conv.cu (x padded by pad_top/pad_left rows and columns of
// zeros, Ho x Wo the output size), x, dy and dw in fp32.  ResNet-50's 3x3 / stride-1 /
// pad-1 convolutions call it with 3x3 taps on the layer's input and the cotangent of its
// output, both NHWC; bf16 inputs (the bf16 training step) take taps_wgrad_bf16.cu, the
// tensor cores, instead.
//
// Numerics: every product and sum is fp32 FMA on the CUDA cores (no TF32, no tensor
// cores), as in implicit_gemm_conv.cu.  Against the plain PyTorch version (one fp32
// x_tap^T @ dy matmul per tap) only the order of the sums differs; the tolerance the
// tests and chip_smoke.py state is 1e-4 of the largest |dw|.
//
// Design.  The TPU kernel carries one (KH*KW, C, O) fp32 block in VMEM across a
// sequential grid over row tiles.  On the H100 blocks run in parallel in no order, so
// the work is a reduction over M = N*Ho*Wo rows (100,352 at 64 channels / 56 px, batch
// 32; 1,568 at 512 / 7 px) into a small output, split three ways across the grid:
//   - blockIdx.x: a BC x BO tile of (input channel, output channel);
//   - blockIdx.y: the tap;
//   - blockIdx.z: a contiguous range of rows ("split"), chosen by the wrapper so that the
//     grid fills the card's SMs even when C and O are small.
// A block walks its rows in stages of BK; each stage gathers BK input rows of the tap
// straight from NHWC x (padding and the ragged edge masked to zero, no padded copy)
// and BK cotangent rows, stages both through shared memory, and adds their outer
// products to a 4 x 4 fp32 accumulator per thread.  The next stage's global loads start
// into registers before the current stage's FMAs.  Each split writes its partial
// tile to a workspace (splits, KH*KW, C, O) that the wrapper allocates; a second pass
// sums the partials in split order.  That sum is deterministic (the same inputs give the
// same bits on every run), which fp32 atomics into one output would not be.  With one
// split the first pass writes the output directly and the second is not launched.
//
// Bound at the slice's shapes (batch 32, fp32): the 16 3x3 stride-1 convolutions of a
// Gluon ResNet-50 v1 are 64->64 at 56 px (x3), 128->128 at 28 (x4), 256->256 at 14 (x6),
// 512->512 at 7 (x3); each does 2*M*C*O*9 = 7.4 GFLOP on 6-51 MB of x and dy, so every
// one is bound by operations (0.110 ms at 67 TFLOP/s fp32), not by bytes.

#include <cuda_runtime.h>

namespace {

constexpr int BC = 64;                    // input channels per block
constexpr int BO = 64;                    // output channels per block
constexpr int BK = 16;                    // rows per stage
constexpr int THREADS = 256;
constexpr int TC = 4;                     // input channels per thread
constexpr int TO = 4;                     // output channels per thread
constexpr int ROWS_PER_PASS = THREADS / BC;   // rows one pass of the block loads
constexpr int LOADS = BK / ROWS_PER_PASS;     // elements of x and of dy per thread per stage

static_assert(BC == BO, "one load pattern serves x and dy");
static_assert((BC / TC) * (BO / TO) == THREADS, "thread tile must cover the block tile");
static_assert(BK % ROWS_PER_PASS == 0, "loads must cover the stage");

__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename T>
__global__ void __launch_bounds__(THREADS)
taps_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                  float* __restrict__ out,
                  int N, int H, int W, int C, int O, int KH, int KW, int pad_top,
                  int pad_left, int Ho, int Wo, long long rows_per_split) {
  __shared__ __align__(16) float As[BK][BC];
  __shared__ __align__(16) float Bs[BK][BO];

  const int tid = threadIdx.x;
  const int ctiles = (C + BC - 1) / BC;
  const int c0 = (blockIdx.x % ctiles) * BC;
  const int o0 = (blockIdx.x / ctiles) * BO;
  const int tap = blockIdx.y;
  const int split = blockIdx.z;
  const int dh = tap / KW, dw = tap % KW;
  const long long hw = (long long)Ho * Wo;
  const long long M = (long long)N * hw;
  const long long m_begin = (long long)split * rows_per_split;
  const long long m_end = m_begin + rows_per_split < M ? m_begin + rows_per_split : M;

  // loads: this thread reads channel l_ch of x and of dy for rows l_row + i * ROWS_PER_PASS
  const int l_ch = tid % BC;
  const int l_row = tid / BC;
  const int c_ld = c0 + l_ch;
  const int o_ld = o0 + l_ch;

  float a_reg[LOADS], b_reg[LOADS];
  auto load_stage = [&](long long m0) {
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const long long m = m0 + l_row + i * ROWS_PER_PASS;
      float a = 0.f, b = 0.f;
      if (m < m_end) {
        const int n = (int)(m / hw);
        const int rem = (int)(m - (long long)n * hw);
        const int hi = rem / Wo + dh - pad_top;
        const int wi = rem % Wo + dw - pad_left;
        if (c_ld < C && hi >= 0 && hi < H && wi >= 0 && wi < W)
          a = to_f32(x[(((long long)n * H + hi) * W + wi) * C + c_ld]);
        if (o_ld < O) b = to_f32(dy[m * O + o_ld]);
      }
      a_reg[i] = a;
      b_reg[i] = b;
    }
  };

  const int tx = tid % (BO / TO);         // output-channel group of this thread
  const int ty = tid / (BO / TO);         // input-channel group of this thread
  float acc[TC][TO];
#pragma unroll
  for (int i = 0; i < TC; ++i)
#pragma unroll
    for (int j = 0; j < TO; ++j) acc[i][j] = 0.f;

  if (m_begin < m_end) load_stage(m_begin);
  for (long long m0 = m_begin; m0 < m_end; m0 += BK) {
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      As[l_row + i * ROWS_PER_PASS][l_ch] = a_reg[i];
      Bs[l_row + i * ROWS_PER_PASS][l_ch] = b_reg[i];
    }
    __syncthreads();
    if (m0 + BK < m_end) load_stage(m0 + BK);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&As[k][ty * TC]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[k][tx * TO]);
      const float a[TC] = {av.x, av.y, av.z, av.w};
      const float b[TO] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < TC; ++i)
#pragma unroll
        for (int j = 0; j < TO; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // out is (splits, KH*KW, C, O): this block's partial sum for its split and tap
  float* dst = out + ((long long)split * KH * KW + tap) * C * O;
#pragma unroll
  for (int i = 0; i < TC; ++i) {
    const int c = c0 + ty * TC + i;
    if (c >= C) continue;
#pragma unroll
    for (int j = 0; j < TO; ++j) {
      const int o = o0 + tx * TO + j;
      if (o < O) dst[(long long)c * O + o] = acc[i][j];
    }
  }
}

// out[i] = sum_{s < splits} part[s * total + i], in order s = 0, 1, ...
__global__ void sum_splits_kernel(const float* __restrict__ part, float* __restrict__ out,
                                  long long total, int splits) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += part[(long long)k * total + i];
    out[i] = s;
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  dtype: 0 = float32 (any other code is
// cudaErrorInvalidValue: bf16 has its own library, taps_wgrad_bf16.cu), the type of
// x: (N, H, W, C) and dy: (N, Ho, Wo, O); out: (KH*KW, C, O) fp32, workspace:
// (splits, KH*KW, C, O) fp32 when splits > 1 (else unused), all contiguous on `device`.
// Rows are dealt to splits in runs of 16; a split left without rows writes zeros.
// Launches the partial pass and, when splits > 1, the reduction pass on `stream`, and
// counts each launch in launched[0] (partial passes) and launched[1] (reduction passes),
// which it zeroes first; with no rows it launches no kernel and zero-fills out.  Returns
// cudaGetLastError() after them (0 on success).
extern "C" int mxtt_taps_wgrad(const void* x, const void* dy, float* out, float* workspace,
                               int dtype, int N, int H, int W, int C, int O, int KH, int KW,
                               int pad_top, int pad_left, int Ho, int Wo, int splits, int sms,
                               int device, void* stream, int* launched) {
  launched[0] = launched[1] = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long M = (long long)N * Ho * Wo;
  const long long total = (long long)KH * KW * C * O;
  if (total == 0) return cudaSuccess;
  if (M == 0) return (int)cudaMemsetAsync(out, 0, total * sizeof(float), s);
  if (splits < 1 || (splits > 1 && workspace == nullptr) || dtype != 0)
    return (int)cudaErrorInvalidValue;
  long long rows = (M + splits - 1) / splits;
  rows = (rows + BK - 1) / BK * BK;
  const dim3 grid((unsigned)(((C + BC - 1) / BC) * ((O + BO - 1) / BO)), (unsigned)(KH * KW),
                  (unsigned)splits);
  float* dst = splits > 1 ? workspace : out;
  taps_wgrad_kernel<float><<<grid, THREADS, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(dy), dst, N, H, W, C, O, KH,
      KW, pad_top, pad_left, Ho, Wo, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  launched[0] = 1;
  if (splits == 1) return (int)cudaSuccess;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  const long long cap = 8LL * (sms > 0 ? sms : 132);
  if (blocks > cap) blocks = cap;
  sum_splits_kernel<<<(unsigned)blocks, threads, 0, s>>>(workspace, out, total, splits);
  err = cudaGetLastError();
  if (err == cudaSuccess) launched[1] = 1;
  return (int)err;
}
