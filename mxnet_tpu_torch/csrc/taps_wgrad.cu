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
// Bound at the main path's shapes (batch 32, fp32): the 16 3x3 stride-1 convolutions of a
// Gluon ResNet-50 v1 are 64->64 at 56 px (x3), 128->128 at 28 (x4), 256->256 at 14 (x6),
// 512->512 at 7 (x3); each does 2*M*C*O*9 = 7.4 GFLOP on 6-51 MB of x and dy, so every
// one is bound by operations (0.110 ms at 67 TFLOP/s fp32), not by bytes.  What holds an
// FMA kernel back from that rate is everything that is not an FMA: shared-memory loads,
// barriers, address and index arithmetic.  The design keeps each of them small next to
// the FMAs:
//
//   - Per tap the output is a (C x O) product whose reduction runs over the M = N*Ho*Wo
//     rows, so the grid is (channel tile, group of taps, row split): blockIdx.x a tile of
//     TILE input by TILE output channels, blockIdx.y a row of the taps (dh) and a group
//     of TAPS taps along it, blockIdx.z a contiguous range of rows ("split") from the host
//     plan (ops/hopper_conv.py wgrad_fp32_plan), which fills the SMs when C and O are
//     small.
//   - A register-tiled outer product: 256 threads, 16 x 16 over the (taps x channels,
//     output channels) tile; each thread holds 4-wide sub-tiles 64 apart along both ways,
//     so its float4 shared loads in a quarter warp are one broadcast (A) or 8 consecutive
//     16-byte words (B): no bank conflicts.  TILE = 128, TAPS = 1 (C and O > 64): 8 x 8
//     accumulators, 64 FMAs to four 16-byte loads, 16 to each (the first kernel did 8).
//     TILE = 64, TAPS = 3 (the 64-channel layer): one staged dy tile serves the 3 taps of
//     a row, 12 x 4 accumulators, 48 FMAs to four loads.
//   - A 4-stage shared-memory ring of 16-row stages filled by cp.async: 16-byte copies
//     (cp.async.cg, 4 channels) where C and O are multiples of 4 and x and dy 16-byte
//     aligned, else 4-byte copies (cp.async.ca) in the same kernel (template VEC = false).
//     The padding, the ragged channel edge and rows past the split are zero-filled by a
//     source size of 0, so there is no padded copy of x.  One barrier a stage.
//   - Each thread carries its rows' pixel (n, ho, wo) from stage to stage (M < 2^31), so
//     the loop divides nothing.
//   - Each split writes its partial (KH*KW, C, O) sums to a workspace (splits, KH*KW, C,
//     O) that the wrapper allocates, and split_sum.cuh's pass sums them in a fixed order:
//     the same inputs give the same bits on every run, which fp32 atomics would not.
//     With one split the partial pass writes dw itself.
//
// On the card this runs at 31-41 TFLOP/s (chip_smoke.py phase 2b), half to two thirds of
// the FMA peak; 3-stage rings of 32- or 16-row stages measured no faster.  At 7 px the
// 144 tiles x taps of 512 channels fill 132 SMs unevenly whatever the split, which costs
// that shape a fifth more than the others.

#include "cp_async.cuh"
#include "split_sum.cuh"

namespace {

struct fp32_3x3_wgrad;                 // names this library's split sum in a trace

constexpr int BK = 16;                 // rows per stage
constexpr int STAGES = 4;              // shared-memory ring depth
constexpr int THREADS = 256;           // 16 x 16 over (taps x input channels, outputs)
constexpr int BLOCKS_PER_SM = 2;       // what __launch_bounds__ asks; the plan assumes it

template <int TILE, int TAPS>
__host__ __device__ constexpr int smem_bytes() {
  return STAGES * BK * (TAPS * TILE + TILE) * (int)sizeof(float);
}

template <int TILE, int TAPS, bool VEC>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
taps_wgrad_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                  float* __restrict__ out, int N, int H, int W, int C, int O, int KH, int KW,
                  int pad_top, int pad_left, int Ho, int Wo, long long rows_per_split) {
  constexpr int AW = TAPS * TILE;        // floats of a staged x row: the block's taps
  constexpr int SA = AW / 64;            // 4-wide sub-tiles of a thread along A, 64 apart
  constexpr int SB = TILE / 64;          // ... and along B
  constexpr int CPR = TILE / 4;          // 16-byte chunks of a tile row
  constexpr int RPP = THREADS / CPR;     // rows one pass of the block copies
  constexpr int LOADS = BK / RPP;        // rows of each tile a thread copies per stage
  constexpr int STAGE_FLOATS = BK * (AW + TILE);
  static_assert(TILE % 64 == 0 && SA * 64 == AW, "sub-tiles must cover the tile");
  static_assert(LOADS * RPP == BK, "loads must cover the stage");
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int ctiles = (C + TILE - 1) / TILE;
  const int c0 = (blockIdx.x % ctiles) * TILE;
  const int o0 = (blockIdx.x / ctiles) * TILE;
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

  // loads: this thread copies chunk l_ch of rows l_row + i * RPP of every tile.  Stages
  // are loaded in order, each BK rows past the last, so each of its rows' pixel
  // (n, ho, wo) is carried from stage to stage instead of divided out anew.
  const int l_ch = tid % CPR;
  const int l_row = tid / CPR;
  const int c_ld = c0 + 4 * l_ch;
  const int o_ld = o0 + 4 * l_ch;
  const int step_h = BK / Wo, step_w = BK - step_h * Wo;   // BK pixels as (rows, columns)
  int p_n[LOADS], p_ho[LOADS], p_wo[LOADS];
#pragma unroll
  for (int i = 0; i < LOADS; ++i) {
    const int m = (int)m_begin + l_row + i * RPP;
    p_n[i] = m / hw;
    p_ho[i] = (m - p_n[i] * hw) / Wo;
    p_wo[i] = m - p_n[i] * hw - p_ho[i] * Wo;
  }

  auto load_stage = [&](int buf, int s) {
    float* as = smem + buf * STAGE_FLOATS;
    float* bs = as + BK * AW;
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int r = l_row + i * RPP;
      const long long m = m_begin + (long long)s * BK + r;
      const bool row_ok = m < m_end;
      const int n = p_n[i], ho = p_ho[i], wo = p_wo[i];
      p_wo[i] += step_w;                 // the next stage's row: BK pixels on
      p_ho[i] += step_h;
      if (p_wo[i] >= Wo) {
        p_wo[i] -= Wo;
        ++p_ho[i];
      }
      while (p_ho[i] >= Ho) {
        p_ho[i] -= Ho;
        ++p_n[i];
      }
      const float* g = dy + m * O + o_ld;
      const uint32_t gdst = smem_addr(bs + r * TILE + 4 * l_ch);
      if (VEC) {
        const bool ok = row_ok && o_ld < O;
        cp_async16(gdst, ok ? g : dy, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = row_ok && o_ld + e < O;
          cp_async4(gdst + 4 * e, ok ? g + e : dy, ok);
        }
      }
      const int hi = ho + dh - pad_top;
      const bool h_ok = row_ok && hi >= 0 && hi < H;
#pragma unroll
      for (int t = 0; t < TAPS; ++t) {
        if (t >= ntaps) continue;
        const int wi = wo + dw0 + t - pad_left;
        const bool pix = h_ok && wi >= 0 && wi < W;
        const float* src = x + ((long long)(n * H + hi) * W + wi) * C + c_ld;
        const uint32_t dst = smem_addr(as + r * AW + t * TILE + 4 * l_ch);
        if (VEC) {
          const bool ok = pix && c_ld < C;
          cp_async16(dst, ok ? src : x, ok);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool ok = pix && c_ld + e < C;
            cp_async4(dst + 4 * e, ok ? src + e : x, ok);
          }
        }
      }
    }
  };

  const int tx = tid % 16;               // output-channel group of this thread
  const int ty = tid / 16;               // (tap, input channel) group of this thread
  float acc[SA * 4][SB * 4];
#pragma unroll
  for (int i = 0; i < SA * 4; ++i)
#pragma unroll
    for (int j = 0; j < SB * 4; ++j) acc[i][j] = 0.f;

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

    const float* as = smem + (ks % STAGES) * STAGE_FLOATS;
    const float* bs = as + BK * AW;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[SA * 4], b[SB * 4];
#pragma unroll
      for (int s = 0; s < SA; ++s) {
        const float4 v = *reinterpret_cast<const float4*>(as + k * AW + s * 64 + ty * 4);
        a[4 * s] = v.x;
        a[4 * s + 1] = v.y;
        a[4 * s + 2] = v.z;
        a[4 * s + 3] = v.w;
      }
#pragma unroll
      for (int s = 0; s < SB; ++s) {
        const float4 v = *reinterpret_cast<const float4*>(bs + k * TILE + s * 64 + tx * 4);
        b[4 * s] = v.x;
        b[4 * s + 1] = v.y;
        b[4 * s + 2] = v.z;
        b[4 * s + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < SA * 4; ++i)
#pragma unroll
        for (int j = 0; j < SB * 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  allow_split_sum();

  // out is (splits, KH*KW, C, O): this block's partial sums for its split and taps;
  // 16-byte stores where O is a multiple of 4 (the buffer is 16-byte aligned)
  float* base = out + (long long)split * KH * KW * C * O;
#pragma unroll
  for (int s = 0; s < SA; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int a_idx = s * 64 + ty * 4 + i;
      const int t = a_idx / TILE;
      const int c = c0 + a_idx % TILE;
      if (t >= ntaps || c >= C) continue;
      float* row = base + ((long long)(dh * KW + dw0 + t) * C + c) * O;
#pragma unroll
      for (int sb = 0; sb < SB; ++sb) {
        const int o = o0 + sb * 64 + tx * 4;
        if ((O & 3) == 0) {
          if (o < O)
            *reinterpret_cast<float4*>(row + o) =
                make_float4(acc[4 * s + i][4 * sb], acc[4 * s + i][4 * sb + 1],
                            acc[4 * s + i][4 * sb + 2], acc[4 * s + i][4 * sb + 3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (o + j < O) row[o + j] = acc[4 * s + i][4 * sb + j];
        }
      }
    }
}

// above 48 KB of dynamic shared memory only after this, once a device and instantiation
template <int TILE, int TAPS, bool VEC>
cudaError_t allow_smem(int device) {
  static bool done[64];
  if (device >= 0 && device < 64 && done[device]) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(taps_wgrad_kernel<TILE, TAPS, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes<TILE, TAPS>());
  if (err == cudaSuccess && device >= 0 && device < 64) done[device] = true;
  return err;
}

template <int TILE, int TAPS, bool VEC>
cudaError_t launch_partial(dim3 grid, const void* x, const void* dy, float* dst, int N,
                           int H, int W, int C, int O, int KH, int KW, int pad_top,
                           int pad_left, int Ho, int Wo, long long rows, int device,
                           cudaStream_t s) {
  constexpr int smem = smem_bytes<TILE, TAPS>();
  cudaError_t err = allow_smem<TILE, TAPS, VEC>(device);
  if (err != cudaSuccess) return err;
  taps_wgrad_kernel<TILE, TAPS, VEC><<<grid, THREADS, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(dy), dst, N, H, W, C, O, KH,
      KW, pad_top, pad_left, Ho, Wo, rows);
  return cudaGetLastError();
}

template <int TILE, int TAPS, bool VEC>
cudaError_t occupancy(int* blocks, int device) {
  cudaError_t err = allow_smem<TILE, TAPS, VEC>(device);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, taps_wgrad_kernel<TILE, TAPS, VEC>, THREADS, smem_bytes<TILE, TAPS>());
}

}  // namespace

// Plain C entry point, bound with ctypes.  x: (N, H, W, C) and dy: (N, Ho, Wo, O) fp32;
// out: (KH*KW, C, O) fp32; workspace: (splits, KH*KW, C, O) fp32 when splits > 1 (else
// unused); all contiguous on `device`.  tile (128: one tap a block; 64: the 3 taps of a
// row a block), splits and rows_per_split (split s takes rows [s * rows_per_split,
// (s + 1) * rows_per_split) of the N*Ho*Wo) and vec (1: C and O multiples of 4 and x and
// dy 16-byte aligned, the 16-byte copy path; 0: 4-byte copies) come from the host plan;
// rows that the splits do not cover, or another tile, return cudaErrorInvalidValue, vec =
// 1 on operands that do not allow it cudaErrorMisalignedAddress.  Launches the partial
// pass and, when splits > 1, the reduction pass on `stream`, and counts each launch in
// launched[0] (partial passes) and launched[1] (reduction passes), which it zeroes first;
// with no rows it launches no kernel and zero-fills out.  Returns cudaGetLastError()
// after them (0 on success).
extern "C" int mxtt_taps_wgrad(const void* x, const void* dy, float* out, float* workspace,
                               int N, int H, int W, int C, int O, int KH, int KW, int pad_top,
                               int pad_left, int Ho, int Wo, int tile, int splits,
                               long long rows_per_split, int vec, int device, void* stream,
                               int* launched) {
  launched[0] = launched[1] = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long M = (long long)N * Ho * Wo;
  const long long total = (long long)KH * KW * C * O;
  if (total == 0) return cudaSuccess;
  if (M == 0) return (int)cudaMemsetAsync(out, 0, total * sizeof(float), s);
  if ((tile != 64 && tile != 128) || splits < 1 || splits > 65535 || rows_per_split < 1 ||
      (long long)splits * rows_per_split < M || (splits > 1 && workspace == nullptr) ||
      (long long)N * H * W >= (1LL << 31) || M >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (vec && (C % 4 || O % 4 || !aligned16(x) || !aligned16(dy)))
    return (int)cudaErrorMisalignedAddress;
  const int taps = tile == 64 ? 3 : 1;
  const dim3 grid((unsigned)(((C + tile - 1) / tile) * ((O + tile - 1) / tile)),
                  (unsigned)(KH * ((KW + taps - 1) / taps)), (unsigned)splits);
  float* dst = splits > 1 ? workspace : out;
#define MXTT_PARTIAL(T, P, V) \
  launch_partial<T, P, V>(grid, x, dy, dst, N, H, W, C, O, KH, KW, pad_top, pad_left, Ho, \
                          Wo, rows_per_split, device, s)
  if (tile == 128)
    err = vec ? MXTT_PARTIAL(128, 1, true) : MXTT_PARTIAL(128, 1, false);
  else
    err = vec ? MXTT_PARTIAL(64, 3, true) : MXTT_PARTIAL(64, 3, false);
#undef MXTT_PARTIAL
  if (err != cudaSuccess) return (int)err;
  launched[0] = 1;
  if (splits == 1) return (int)cudaSuccess;
  err = launch_split_sum<fp32_3x3_wgrad>(workspace, out, total, splits, s);
  if (err == cudaSuccess) launched[1] = 1;
  return (int)err;
}

// Blocks of the partial pass at `tile` (vec or not) that one SM holds at once, into
// *blocks: what the host plan assumes (2), read on the card.  Returns a CUDA error code.
extern "C" int mxtt_taps_wgrad_occupancy(int tile, int vec, int device, int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (tile == 128)
    err = vec ? occupancy<128, 1, true>(blocks, device) : occupancy<128, 1, false>(blocks, device);
  else if (tile == 64)
    err = vec ? occupancy<64, 3, true>(blocks, device) : occupancy<64, 3, false>(blocks, device);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
