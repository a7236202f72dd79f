// Weight gradient of a 1x1 convolution in bf16, for Hopper (sm_90a).
//
// Replaces the TPU kernel tools/probe_conv_fixes.py:wgrad_kernel, launched by the
// pallas_call at probe_conv_fixes.py:173.  It computes the same function:
//
//   dw[c, o] = sum_{n, i, j} x[n, s*i, s*j, c] * g[n, i, j, o]
//
// with x (N, H, W, C) and g (N, Ho, Wo, O) in bf16, NHWC, s the stride (1, or 2 for
// ResNet's projection shortcuts and stage-entry 1x1s; Ho = (H - 1) / s + 1), every
// product exact in fp32 and every sum in fp32.  The output is fp32 (C, O); the caller
// casts it to the weight's dtype, as the TPU kernel's result is cast to bf16.  The
// kernel reads the strided pixels of x itself, so a stride-2 1x1 needs no slice copy.
//
// Numerics: bf16 x bf16 products are exact in fp32; the tensor cores (wmma 16x16x16,
// bf16 in, fp32 accumulate) and the fixed-order reduction pass add them in another
// order than the plain PyTorch version (one fp32 x^T @ g product), so the two agree
// within 1e-4 of the largest |dw|, the tolerance the tests and chip_smoke.py state.
//
// Design.  The TPU kernel carries one (C, O) fp32 block in VMEM across a sequential
// grid over 4,096-row tiles.  Here blocks run in parallel in no order, so the work is
// a reduction over M = N*Ho*Wo rows (401,408 at 56 px, batch 128) into a small output,
// split over a 2-D grid:
//   - blockIdx.x: a 64 x 64 tile of (input channel, output channel);
//   - blockIdx.y: a contiguous range of rows ("split"), chosen by the wrapper so that
//     the grid fills the card even when C and O are small (64 x 256 is 4 tiles).
// A block walks its rows in stages of 32: 128 threads each move 16 bytes (8 channels)
// of two rows of x and of g into shared memory, and 4 warps, 2 x 2 over the tile, run
// wmma bf16 products of 16 rows at a time into 32 x 32 fp32 accumulators.  The next
// stage's global loads start into registers before the current stage's products.
// Each split writes its partial tile to a workspace (splits, C, O) that the wrapper
// allocates, and a second pass sums the partials in split order, so the result is
// the same from run to run (fp32 atomics would not be).  With one split the first
// pass writes the output directly and the second is not launched.
//
// Bound at the slice's shapes (bf16, batch 128): ResNet-50 v1's 36 1x1 convolutions
// (15 distinct shapes) do 2*M*C*O FLOP on M*(C + O)*2 bytes of x and g; at the
// probe's (401,408 x 64) x (401,408 x 256), 13.2 GFLOP on 257 MB, the bound is set by
// memory (0.077 ms at 3.35 TB/s against 0.013 ms at 989 TFLOP/s).  This first kernel
// uses wmma through shared memory without cp.async, TMA or wgmma, which are the later
// steps towards that bound.
//
// Limits (the wrapper raises outside them): C and O multiples of 8 from 8 to 2048, so
// that every 16-byte load is aligned and lies wholly inside or outside the channels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int BC = 64;                      // input channels per block tile
constexpr int BO = 64;                      // output channels per block tile
constexpr int BK = 32;                      // rows per stage
constexpr int THREADS = 128;                // 4 warps, 2 x 2 over the block tile
constexpr int WT = 32;                      // warp tile (C and O)
constexpr int LDS = BC + 8;                 // bf16 pitch of the staging tiles
constexpr int LDC = BO + 4;                 // fp32 pitch of the epilogue tile
constexpr int VEC = 8;                      // bf16 values per 16-byte load
constexpr int VECS_PER_ROW = BC / VEC;
constexpr int ROWS_PER_PASS = THREADS / VECS_PER_ROW;
constexpr int LOADS = BK / ROWS_PER_PASS;   // 16-byte loads of x and of g per thread per stage

static_assert(BC == BO, "one load pattern serves x and g");
static_assert((BC / WT) * (BO / WT) * 32 == THREADS, "warps must cover the block tile");
static_assert(BK % ROWS_PER_PASS == 0 && BK % 16 == 0, "loads must cover the stage");

__global__ void __launch_bounds__(THREADS)
conv1x1_wgrad_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
                     float* __restrict__ out, int H, int W, int C, int O, int Ho, int Wo,
                     int stride, long long M, long long rows_per_split) {
  __shared__ __align__(128) __nv_bfloat16 Xs[BK][LDS];
  __shared__ __align__(128) __nv_bfloat16 Gs[BK][LDS];
  __shared__ __align__(128) float Cs[BC][LDC];

  const int tid = threadIdx.x;
  const int ctiles = (C + BC - 1) / BC;
  const int c0 = (blockIdx.x % ctiles) * BC;
  const int o0 = (blockIdx.x / ctiles) * BO;
  const int split = blockIdx.y;
  const long long hw = (long long)Ho * Wo;
  const long long m_begin = (long long)split * rows_per_split;
  const long long m_end = m_begin + rows_per_split < M ? m_begin + rows_per_split : M;

  // loads: this thread moves channels [l_col, l_col + 8) of rows l_row + i * ROWS_PER_PASS
  const int l_col = (tid % VECS_PER_ROW) * VEC;
  const int l_row = tid / VECS_PER_ROW;
  const bool c_in = c0 + l_col < C;         // C % 8 == 0: a vector is all in or all out
  const bool o_in = o0 + l_col < O;

  uint4 a_reg[LOADS], b_reg[LOADS];
  auto load_stage = [&](long long m0) {
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const long long m = m0 + l_row + i * ROWS_PER_PASS;
      uint4 a = make_uint4(0u, 0u, 0u, 0u), b = make_uint4(0u, 0u, 0u, 0u);
      if (m < m_end) {
        long long xrow = m;
        if (stride != 1) {
          const long long n = m / hw;
          const long long rem = m - n * hw;
          const long long oi = rem / Wo;
          const long long oj = rem - oi * Wo;
          xrow = (n * H + oi * stride) * W + oj * stride;
        }
        if (c_in) a = *reinterpret_cast<const uint4*>(x + xrow * C + c0 + l_col);
        if (o_in) b = *reinterpret_cast<const uint4*>(g + m * O + o0 + l_col);
      }
      a_reg[i] = a;
      b_reg[i] = b;
    }
  };

  const int warp = tid / 32;
  const int wc = (warp / (BO / WT)) * WT;   // this warp's input channels in the tile
  const int wo = (warp % (BO / WT)) * WT;   // this warp's output channels in the tile
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  if (m_begin < m_end) load_stage(m_begin);
  for (long long m0 = m_begin; m0 < m_end; m0 += BK) {
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      *reinterpret_cast<uint4*>(&Xs[l_row + i * ROWS_PER_PASS][l_col]) = a_reg[i];
      *reinterpret_cast<uint4*>(&Gs[l_row + i * ROWS_PER_PASS][l_col]) = b_reg[i];
    }
    __syncthreads();
    if (m0 + BK < m_end) load_stage(m0 + BK);
#pragma unroll
    for (int k = 0; k < BK; k += 16) {
      // A = x^T: element (c, row) sits at Xs[row][c], a column-major 16 x 16 tile
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> a[2];
      // B = g: element (row, o) sits at Gs[row][o], a row-major 16 x 16 tile
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], &Xs[k][wc + 16 * i], LDS);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], &Gs[k][wo + 16 * j], LDS);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[wc + 16 * i][wo + 16 * j], acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();
  // out is (splits, C, O): this block's partial sum for its split, coalesced along O
  float* dst = out + (long long)split * C * O;
  for (int e = tid; e < BC * BO; e += THREADS) {
    const int r = e / BO, col = e % BO;
    const int c = c0 + r, o = o0 + col;
    if (c < C && o < O) dst[(long long)c * O + o] = Cs[r][col];
  }
}

// out[i] = sum_{s < splits} part[s * total + i], in order s = 0, 1, ...
__global__ void sum_partials_1x1_kernel(const float* __restrict__ part, float* __restrict__ out,
                                  long long total, int splits) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += part[(long long)k * total + i];
    out[i] = s;
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  x: (N, H, W, C) bf16, g: (N, Ho, Wo, O) bf16,
// out: (C, O) fp32, workspace: (splits, C, O) fp32 when splits > 1 (else unused), all
// contiguous on `device`, x and g 16-byte aligned, C and O multiples of 8.  Rows are
// dealt to splits in runs of 32; a split left without rows writes zeros.  Launches the
// partial pass and, when splits > 1, the reduction pass on `stream`, and counts each
// launch in launched[0] (partial passes) and launched[1] (reduction passes), which it
// zeroes first; with no rows it launches no kernel and zero-fills out.  Returns
// cudaGetLastError() after them (0 on success).
extern "C" int mxtt_conv1x1_wgrad(const void* x, const void* g, float* out, float* workspace,
                                  int N, int H, int W, int C, int O, int Ho, int Wo,
                                  int stride, int splits, int sms, int device, void* stream,
                                  int* launched) {
  launched[0] = launched[1] = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long M = (long long)N * Ho * Wo;
  const long long total = (long long)C * O;
  if (total == 0) return cudaSuccess;
  if (M == 0) return (int)cudaMemsetAsync(out, 0, total * sizeof(float), s);
  if (C % VEC || O % VEC || stride < 1 || splits < 1 ||
      (splits > 1 && workspace == nullptr))
    return (int)cudaErrorInvalidValue;
  long long rows = (M + splits - 1) / splits;
  rows = (rows + BK - 1) / BK * BK;
  const dim3 grid((unsigned)(((C + BC - 1) / BC) * ((O + BO - 1) / BO)), (unsigned)splits);
  conv1x1_wgrad_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g),
      splits > 1 ? workspace : out, H, W, C, O, Ho, Wo, stride, M, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  launched[0] = 1;
  if (splits == 1) return (int)cudaSuccess;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  const long long cap = 8LL * (sms > 0 ? sms : 132);
  if (blocks > cap) blocks = cap;
  sum_partials_1x1_kernel<<<(unsigned)blocks, threads, 0, s>>>(workspace, out, total, splits);
  err = cudaGetLastError();
  if (err == cudaSuccess) launched[1] = 1;
  return (int)err;
}
