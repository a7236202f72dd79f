// Weight gradient of the stride-1 implicit-GEMM convolution for bf16 operands on Hopper's
// tensor cores (sm_90a): the bf16 arm of TPU kernel 2.
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_conv.py:_wgrad_kernel, launched by
// _wgrad_s1 (pallas_conv.py:165-240), for bf16 inputs.  It computes the same function:
//
//   dw[dh * KW + dw, c, o] = sum_{n, ho, wo} xpad[n, ho + dh, wo + dw, c] * dy[n, ho, wo, o]
//
// with xpad as in taps_conv_bf16.cu, x (N, H, W, C) and dy (N, Ho, Wo, O) bf16 and NHWC,
// dw (KH*KW, C, O) fp32 (the reference's dot_general with preferred_element_type=f32).
// The bf16 training step calls it for the 3x3 / stride-1 / pad-1 convolutions.  The fp32
// arm stays in taps_wgrad.cu.
//
// Numerics: bf16 x bf16 products are exact in fp32; the tensor cores (mma.sync m16n8k16,
// fp32 accumulate) sum them in fp32.  Against the plain PyTorch version (one fp32
// x_tap^T @ dy matmul per tap on the widened inputs) only the order of the sums differs:
// within 1e-4 of the largest |dw|, the tolerance chip_smoke.py states.
//
// Design.  Per tap the output is a (C x O) GEMM whose reduction runs over the M = N*Ho*Wo
// output pixels (up to 401,408 rows at batch 128), so the parallelism is in the rows:
//   - blockIdx.x: a BC x BO tile of (input channel, output channel);
//   - blockIdx.y: a row of the taps (dh) and a group of up to TAPS = 3 taps along it;
//   - blockIdx.z: a contiguous range of rows ("split"), from the host plan in
//     ops/hopper_conv.py, so that the grid fills the SMs when C and O are small.
// A block walks its rows in stages of BK = 32 through a 4-stage shared-memory ring filled
// by 16-byte cp.async: per stage one dy tile (BK x BO) and one x tile (BK x BC) for each
// of its taps, gathered straight from NHWC x with the padding and the ragged edges
// zero-filled by a source size of 0 (no padded copy); each thread carries its rows' pixel
// (n, ho, wo) from stage to stage rather than dividing it out of the row index in each,
// since a stage's integer work competes with its 48 MMAs a warp.  The dy tile is staged
// once and used for all the block's taps, so dy is read KH times per split and not KH*KW
// times as in the fp32 arm.  Both operands arrive row-major in M, which is the reduction here: x
// is read as x^T with ldmatrix.trans, dy as the k-major B operand with ldmatrix.trans;
// 16-byte chunks of the 128-byte tile rows are XOR-swizzled by the row's low three bits.
// Each of the 4 warps owns a 32 x 32 quadrant of the tile for each tap: 3 x 2 x 4 m16n8
// fp32 accumulators.  Each split writes its partial (KH*KW, C, O) sums to a workspace
// (splits, KH*KW, C, O) that the wrapper allocates, and split_sum.cuh's pass sums the
// partials in a fixed order: the result is deterministic (the same inputs give the same
// bits on every run), which fp32 atomics would not be.  With one split the first pass
// writes dw itself.
//   Operands that a 16-byte copy cannot take (C or O not a multiple of 8, x or dy not
// 16-byte aligned) take a slower load path inside the same kernel (template VEC = false):
// bf16 loads into registers and 16-byte shared-memory stores.
//
// Bound at the main path's shapes (bf16, batch 128): each of the 4 Gluon 3x3 wgrads is
// 29.6 GFLOP on 13-103 MB of x and dy plus the fp32 output, so it is bound by operations
// (0.0299 ms at 989 TFLOP/s) except at 56x56/64 (bytes, 0.0307 ms).  mma.sync from a
// cp.async ring, x gathered again for each tap and the partials' round trip through device
// memory keep it above that; a spatial band with one staged halo for all 9 taps, a
// persistent grid, TMA and wgmma are the later steps towards the bound.

#include "mma_bf16.cuh"
#include "split_sum.cuh"

namespace {

struct bf16_3x3_wgrad;                 // names this library's split sum in a trace

constexpr int BC = 64;                     // input channels per block
constexpr int BO = 64;                     // output channels per block
constexpr int BK = 32;                     // rows per stage
constexpr int TAPS = 3;                    // taps of one row per block
constexpr int STAGES = 4;                  // shared-memory ring depth
constexpr int THREADS = 128;               // 4 warps, 2 x 2 over (c, o)
constexpr int WT = 32;                     // warp tile, both ways
constexpr int MI = WT / 16;                // m16 fragments (input channels) of a warp tile
constexpr int NI = WT / 8;                 // n8 fragments (output channels) of a warp tile
constexpr int CHUNKS = 8;                  // 16-byte chunks of a 64-channel row
constexpr int ROW_BYTES = CHUNKS * 16;
constexpr int TILE_BYTES = BK * ROW_BYTES;
constexpr int STAGE_BYTES = (TAPS + 1) * TILE_BYTES;   // TAPS x tiles, then the dy tile
constexpr int SMEM = STAGES * STAGE_BYTES;
constexpr int ROWS_PER_PASS = THREADS / CHUNKS;
constexpr int LOADS = BK / ROWS_PER_PASS;  // rows of each tile a thread copies per stage

static_assert(BC == CHUNKS * 8 && BO == CHUNKS * 8, "one row layout serves x and dy");
static_assert((BC / WT) * (BO / WT) * 32 == THREADS, "warps must cover the tile");
static_assert(LOADS * ROWS_PER_PASS == BK, "loads must cover the stage");

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 3)
taps_wgrad_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                       float* __restrict__ out, int N, int H, int W, int C, int O, int KH,
                       int KW, int pad_top, int pad_left, int Ho, int Wo,
                       long long rows_per_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wc = (warp & 1) * WT, wo = (warp >> 1) * WT;
  const int ctiles = (C + BC - 1) / BC;
  const int c0 = (blockIdx.x % ctiles) * BC;
  const int o0 = (blockIdx.x / ctiles) * BO;
  const int groups = (KW + TAPS - 1) / TAPS;
  const int dh = blockIdx.y / groups;
  const int dw0 = (blockIdx.y % groups) * TAPS;
  const int ntaps = KW - dw0 < TAPS ? KW - dw0 : TAPS;
  const int split = blockIdx.z;
  const int hw = Ho * Wo;
  const long long M = (long long)N * hw;
  const long long m_begin = (long long)split * rows_per_split;
  const long long m_end = m_begin + rows_per_split < M ? m_begin + rows_per_split : M;
  const int ksteps = m_begin < m_end ? (int)((m_end - m_begin + BK - 1) / BK) : 0;

  // loads: this thread copies chunk l_ch of rows l_row + i * ROWS_PER_PASS of every tile.
  // Stages are loaded in order, each BK rows past the last, so each of its rows' pixel
  // (n, ho, wo) is carried from stage to stage instead of divided out anew (M < 2^31).
  const int l_ch = tid % CHUNKS;
  const int l_row = tid / CHUNKS;
  const int c_ld = c0 + 8 * l_ch;
  const int o_ld = o0 + 8 * l_ch;
  const int step_h = BK / Wo, step_w = BK - step_h * Wo;  // BK pixels as (rows, columns)
  int p_n[LOADS], p_ho[LOADS], p_wo[LOADS];
#pragma unroll
  for (int i = 0; i < LOADS; ++i) {
    const int m = (int)m_begin + l_row + i * ROWS_PER_PASS;
    p_n[i] = m / hw;
    p_ho[i] = (m - p_n[i] * hw) / Wo;
    p_wo[i] = m - p_n[i] * hw - p_ho[i] * Wo;
  }

  auto load_stage = [&](int buf, int s) {
    unsigned char* xs = smem + buf * STAGE_BYTES;
    unsigned char* gs = xs + TAPS * TILE_BYTES;
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int r = l_row + i * ROWS_PER_PASS;
      const long long m = m_begin + (long long)s * BK + r;
      const bool row_ok = m < m_end;
      const int n = p_n[i], ho = p_ho[i], wo_ = p_wo[i];
      // the next stage's row: BK pixels on
      p_wo[i] += step_w;
      p_ho[i] += step_h;
      if (p_wo[i] >= Wo) {
        p_wo[i] -= Wo;
        ++p_ho[i];
      }
      while (p_ho[i] >= Ho) {
        p_ho[i] -= Ho;
        ++p_n[i];
      }
      const bf16* g = dy + m * O + o_ld;
      if (VEC) {
        const bool ok = row_ok && o_ld < O;
        cp_async16(smem_addr(gs + swz(r, l_ch, ROW_BYTES)), ok ? g : dy, ok);
      } else {
        *reinterpret_cast<uint4*>(gs + swz(r, l_ch, ROW_BYTES)) =
            load8(g, [&](int j) { return row_ok && o_ld + j < O; });
      }
      const int hi = ho + dh - pad_top;
      const bool h_ok = row_ok && hi >= 0 && hi < H;
#pragma unroll
      for (int t = 0; t < TAPS; ++t) {
        if (t >= ntaps) continue;
        const int wi = wo_ + dw0 + t - pad_left;
        const bool pix = h_ok && wi >= 0 && wi < W;
        const bf16* src = x + (((long long)n * H + hi) * W + wi) * C + c_ld;
        unsigned char* dst = xs + t * TILE_BYTES + swz(r, l_ch, ROW_BYTES);
        if (VEC) {
          const bool ok = pix && c_ld < C;
          cp_async16(smem_addr(dst), ok ? src : x, ok);
        } else {
          *reinterpret_cast<uint4*>(dst) =
              load8(src, [&](int j) { return pix && c_ld + j < C; });
        }
      }
    }
  };

  float acc[TAPS][MI][NI][4];
#pragma unroll
  for (int t = 0; t < TAPS; ++t)
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[t][i][j][r] = 0.f;

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

    const uint32_t xs = smem_addr(smem + (ks % STAGES) * STAGE_BYTES);
    const uint32_t gs = xs + TAPS * TILE_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // B = dy (rows x output channels), k-major: fragment pairs along the rows
      uint32_t bfr[NI][2];
#pragma unroll
      for (int j = 0; j < NI / 2; ++j) {
        uint32_t r[4];
        ldmatrix_x4_trans(
            r, gs + swz(kk * 16 + (lane & 15), (wo + j * 16) / 8 + (lane >> 4), ROW_BYTES));
        bfr[2 * j][0] = r[0];
        bfr[2 * j][1] = r[1];
        bfr[2 * j + 1][0] = r[2];
        bfr[2 * j + 1][1] = r[3];
      }
      // A = x^T (input channels x rows): x stored row-major in the rows, read transposed
      const int a_row = kk * 16 + (lane & 7) + ((lane >> 4) << 3);
#pragma unroll
      for (int t = 0; t < TAPS; ++t) {
        if (t >= ntaps) continue;
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          uint32_t af[4];
          ldmatrix_x4_trans(af, xs + t * TILE_BYTES +
                                    swz(a_row, (wc + i * 16) / 8 + ((lane >> 3) & 1), ROW_BYTES));
#pragma unroll
          for (int j = 0; j < NI; ++j) mma_bf16(acc[t][i][j], af, bfr[j][0], bfr[j][1]);
        }
      }
    }
  }
  cp_async_wait<0>();
  allow_split_sum();

  // out is (splits, KH*KW, C, O): this block's partial sums for its split and taps
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int t = 0; t < TAPS; ++t) {
    if (t >= ntaps) continue;
    float* dst = out + ((long long)split * KH * KW + dh * KW + dw0 + t) * C * O;
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int o = o0 + wo + j * 8 + 2 * q;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = c0 + wc + i * 16 + g + 8 * h;
          if (c >= C) continue;
          float* p = dst + (long long)c * O + o;
          if (o < O) p[0] = acc[t][i][j][2 * h];
          if (o + 1 < O) p[1] = acc[t][i][j][2 * h + 1];
        }
      }
  }
}

template <bool VEC>
cudaError_t launch_partial(dim3 grid, const void* x, const void* dy, float* dst, int N,
                           int H, int W, int C, int O, int KH, int KW, int pad_top,
                           int pad_left, int Ho, int Wo, long long rows, cudaStream_t s) {
  // above 48 KB of dynamic shared memory only after this (per device, so on every call)
  cudaError_t err = cudaFuncSetAttribute(taps_wgrad_bf16_kernel<VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  taps_wgrad_bf16_kernel<VEC><<<grid, THREADS, SMEM, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy), dst, N, H, W, C, O, KH, KW,
      pad_top, pad_left, Ho, Wo, rows);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes.  x: (N, H, W, C) and dy: (N, Ho, Wo, O) bf16;
// out: (KH*KW, C, O) fp32; workspace: (splits, KH*KW, C, O) fp32 when splits > 1 (else
// unused); all contiguous on `device`.  splits and rows_per_split (split s takes rows
// [s * rows_per_split, (s + 1) * rows_per_split) of the N*Ho*Wo) and vec (1: C and O
// multiples of 8 and x and dy 16-byte aligned, the 16-byte copy path; 0: the element path)
// come from the host plan; rows that the splits do not cover return cudaErrorInvalidValue,
// vec = 1 on operands that do not allow it cudaErrorMisalignedAddress.  Launches the
// partial pass and, when splits > 1, the reduction pass on `stream`, and counts each launch
// in launched[0] (partial passes) and launched[1] (reduction passes), which it zeroes
// first; with no rows it launches no kernel and zero-fills out.  Returns cudaGetLastError()
// after them (0 on success).
extern "C" int mxtt_taps_wgrad_bf16(const void* x, const void* dy, float* out,
                                    float* workspace, int N, int H, int W, int C, int O,
                                    int KH, int KW, int pad_top, int pad_left, int Ho, int Wo,
                                    int splits, long long rows_per_split, int vec,
                                    int device, void* stream, int* launched) {
  launched[0] = launched[1] = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long M = (long long)N * Ho * Wo;
  const long long total = (long long)KH * KW * C * O;
  if (total == 0) return cudaSuccess;
  if (M == 0) return (int)cudaMemsetAsync(out, 0, total * sizeof(float), s);
  if (splits < 1 || splits > 65535 || rows_per_split < 1 ||
      (long long)splits * rows_per_split < M || (splits > 1 && workspace == nullptr) ||
      (long long)N * H * W >= (1LL << 31) || M >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (vec && (C % 8 || O % 8 || !aligned16(x) || !aligned16(dy)))
    return (int)cudaErrorMisalignedAddress;
  const dim3 grid((unsigned)(((C + BC - 1) / BC) * ((O + BO - 1) / BO)),
                  (unsigned)(KH * ((KW + TAPS - 1) / TAPS)), (unsigned)splits);
  float* dst = splits > 1 ? workspace : out;
  err = vec ? launch_partial<true>(grid, x, dy, dst, N, H, W, C, O, KH, KW, pad_top, pad_left,
                                   Ho, Wo, rows_per_split, s)
            : launch_partial<false>(grid, x, dy, dst, N, H, W, C, O, KH, KW, pad_top,
                                    pad_left, Ho, Wo, rows_per_split, s);
  if (err != cudaSuccess) return (int)err;
  launched[0] = 1;
  if (splits == 1) return (int)cudaSuccess;
  err = launch_split_sum<bf16_3x3_wgrad>(workspace, out, total, splits, s);
  if (err == cudaSuccess) launched[1] = 1;
  return (int)err;
}

// Blocks of the partial pass (vec or not) that one SM holds at once, into *blocks: what the
// host plan assumes (3), read on the card.  Returns a CUDA error code.
extern "C" int mxtt_taps_wgrad_bf16_occupancy(int vec, int device, int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto k = vec ? taps_wgrad_bf16_kernel<true> : taps_wgrad_bf16_kernel<false>;
  err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, THREADS, SMEM);
  return (int)err;
}