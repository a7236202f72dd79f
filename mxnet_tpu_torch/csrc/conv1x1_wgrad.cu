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
// Numerics: bf16 x bf16 products are exact in fp32; the tensor cores (mma.sync m16n8k16,
// bf16 in, fp32 accumulate) and the fixed-order split sum add them in another order than
// the plain PyTorch version (one fp32 x^T @ g product), so the two agree within 1e-4 of
// the largest |dw|, the tolerance the tests and chip_smoke.py state.
//
// Bound at the main path's shapes (bf16, batch 128): ResNet-50 v1's 36 1x1 convolutions
// (15 distinct shapes) do 2*M*C*O FLOP on M*(C + O)*2 bytes of x and g; the step's
// operands are 3.96 GB, 1.181 ms at 3.35 TB/s, and every shape but the widest at 7 and
// 14 px is bound by bytes.  So the design aims at moving each operand byte from device
// memory about once, and at keeping enough of them in flight:
//
//   - The work is a reduction over M = N*Ho*Wo rows (401,408 at 56 px) into a small
//     output, on a 2-D grid: blockIdx.x a BC x BO tile of (input channel, output
//     channel), blockIdx.y a contiguous range of rows ("split") from the host plan
//     (ops/hopper_conv.py conv1x1_wgrad_plan), which fills one wave of the SMs.
//   - Tiles as wide as the channels allow.  An operand is read again once per tile of
//     the other operand's channels, so the tile sets the bytes: 64 x 256 / 256 x 64 at the
//     64 <-> 256 layers at 56 px, where x and g are each read once; 256 x 128 / 128 x 256
//     (16 warps) where both sides are wider; 128 x 128 and 64 x 64 otherwise.  The first
//     kernel's 64 x 64 tiles read the step's operands 15.1 GB, these 6.35 GB.  The repeats
//     come from L2, since the blocks of one split run side by side, and with 128 x 128
//     tiles that L2 traffic set the pace of the shapes where it is read most (7-28 px):
//     the wider tiles cut it by a quarter to a third.
//   - A 3-stage shared-memory ring of 64-row stages filled by 16-byte cp.async (8
//     channels), 64-96 KB in flight a block: rows past the split are zero-filled by a
//     source size of 0.  One barrier a stage (64-row stages beat 32-row ones there).
//     A fourth stage, which the shared memory would hold, measured the same on every
//     shape (two stages in flight already cover the latency at 3.35 TB/s).
//     Operands that a 16-byte copy cannot take (x or g not 16-byte aligned)
//     take bf16 loads into registers and 16-byte shared stores in the same kernel
//     (template VEC = false).
//   - Both operands arrive row-major in M, which is the reduction: x is read as x^T with
//     ldmatrix.trans, g as the k-major B operand with ldmatrix.trans; 16-byte chunks of
//     the tile rows are XOR-swizzled by the row's low three bits (mma_bf16.cuh).  Each
//     warp holds a 64 x 32 quadrant, 4 x 4 m16n8 accumulators (32 x 16, 2 x 2, in the
//     64 x 64 tile).  Eight warps of 64 x 64, with half the ldmatrix traffic an MMA,
//     measured no faster on the card.
//   - Each thread carries the output pixel (n, i, j) of its next x row and steps it on
//     row by row, so a stride-2 row costs no division.
//   - The plan puts one block on an SM, and the blocks of splits 2k and 2k + 1 form a
//     thread-block cluster: each stages its fp32 tile in its own shared memory and each
//     sums half the tile's rows over both, in rank order, through distributed shared
//     memory, into one partial (C, O) in a workspace (splits / 2, C, O) that the wrapper
//     allocates; split_sum.cuh's pass sums those in a fixed order, so the result is the
//     same from run to run (fp32 atomics would not).  The step's partials make a 528 MB
//     round trip through device memory (the first kernel's: ~704 MB).  With one partial
//     the partial pass writes dw itself.
//
// Limits (the wrapper raises outside them): C and O multiples of 8 from 8 to 2048, so
// that every 16-byte chunk lies wholly inside or outside the channels.

#include <cooperative_groups.h>

#include "mma_bf16.cuh"
#include "split_sum.cuh"

namespace cg = cooperative_groups;

namespace {

struct bf16_1x1_wgrad;                 // names this library's split sum in a trace

constexpr int BK = 64;                 // rows per stage
constexpr int STAGES = 3;              // shared-memory ring depth
constexpr int CLUSTER = 2;             // blocks of consecutive splits whose tiles are summed
                                       // on chip when the plan splits the rows

template <int BC, int BO>
__host__ __device__ constexpr int smem_bytes() {
  return STAGES * BK * (BC + BO) * 2;
}

// WC x WO warps over the BC x BO tile, each a (BC / WC) x (BO / WO) quadrant; 16-warp
// blocks hold 128 registers a thread, 8-warp ones may run two to an SM
template <int BC, int BO, int WC, int WO, bool VEC>
__global__ void __launch_bounds__(WC * WO * 32, WC * WO == 16 ? 1 : 2)
conv1x1_wgrad_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                     float* __restrict__ out, int H, int W, int C, int O, int Ho, int Wo,
                     int stride, long long M, long long rows_per_split) {
  constexpr int THREADS = WC * WO * 32;
  constexpr int XCH = BC / 8, GCH = BO / 8;        // 16-byte chunks of a tile row
  constexpr int X_ROW = BC * 2, G_ROW = BO * 2;    // bytes of a tile row
  constexpr int X_TILE = BK * X_ROW;
  constexpr int STAGE_BYTES = BK * (X_ROW + G_ROW);
  constexpr int X_RPP = THREADS / XCH, G_RPP = THREADS / GCH;   // rows a pass copies
  constexpr int XL = BK / X_RPP, GL = BK / G_RPP;  // rows of a tile a thread copies
  constexpr int MI = BC / WC / 16;                 // m16 fragments (input channels)
  constexpr int NI = BO / WO / 8;                  // n8 fragments (output channels)
  static_assert(XL * X_RPP == BK && GL * G_RPP == BK, "loads must cover the stage");
  static_assert(MI >= 1 && NI % 2 == 0, "fragments must cover the warp tile");
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wc = (warp % WC) * (BC / WC), wo = (warp / WC) * (BO / WO);
  const int ctiles = (C + BC - 1) / BC;
  const int c0 = (blockIdx.x % ctiles) * BC;
  const int o0 = (blockIdx.x / ctiles) * BO;
  const int split = blockIdx.y;
  const int hw = Ho * Wo;
  const long long m_begin = (long long)split * rows_per_split;
  const long long m_end = m_begin + rows_per_split < M ? m_begin + rows_per_split : M;
  const int ksteps = m_begin < m_end ? (int)((m_end - m_begin + BK - 1) / BK) : 0;

  // loads: this thread copies chunk xc of x rows xr + i * X_RPP and chunk gc of g rows
  // gr + i * G_RPP.  Stages are loaded in order, each BK = XL * X_RPP rows past the last,
  // so the thread's x rows are evenly spaced: it carries one output pixel (n, i, j), that
  // of its next x row, and steps it X_RPP rows on after each (M < 2^31), dividing nothing.
  const int xc = tid % XCH, xr = tid / XCH;
  const int gc = tid % GCH, gr = tid / GCH;
  const int c_ld = c0 + 8 * xc, o_ld = o0 + 8 * gc;
  const int step_h = X_RPP / Wo, step_w = X_RPP - step_h * Wo;   // X_RPP pixels
  int p_n, p_i, p_j;
  {
    const int m = (int)m_begin + xr;
    p_n = m / hw;
    p_i = (m - p_n * hw) / Wo;
    p_j = m - p_n * hw - p_i * Wo;
  }

  auto load_stage = [&](int buf, int s) {
    unsigned char* xs = smem + buf * STAGE_BYTES;
    unsigned char* gs = xs + X_TILE;
    const long long m0 = m_begin + (long long)s * BK;
#pragma unroll
    for (int i = 0; i < XL; ++i) {
      const int r = xr + i * X_RPP;
      const bool row_ok = m0 + r < m_end;
      const bf16* src =
          x + ((long long)(p_n * H + stride * p_i) * W + stride * p_j) * C + c_ld;
      p_j += step_w;                     // the next x row: X_RPP pixels on
      p_i += step_h;
      if (p_j >= Wo) {
        p_j -= Wo;
        ++p_i;
      }
      while (p_i >= Ho) {
        p_i -= Ho;
        ++p_n;
      }
      unsigned char* dst = xs + swz(r, xc, X_ROW);
      if (VEC) {
        const bool ok = row_ok && c_ld < C;
        cp_async16(smem_addr(dst), ok ? src : x, ok);
      } else {
        *reinterpret_cast<uint4*>(dst) =
            load8(src, [&](int e) { return row_ok && c_ld + e < C; });
      }
    }
#pragma unroll
    for (int i = 0; i < GL; ++i) {
      const int r = gr + i * G_RPP;
      const bool row_ok = m0 + r < m_end;
      const bf16* src = g + (m0 + r) * O + o_ld;
      unsigned char* dst = gs + swz(r, gc, G_ROW);
      if (VEC) {
        const bool ok = row_ok && o_ld < O;
        cp_async16(smem_addr(dst), ok ? src : g, ok);
      } else {
        *reinterpret_cast<uint4*>(dst) =
            load8(src, [&](int e) { return row_ok && o_ld + e < O; });
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

    const uint32_t xs = smem_addr(smem + (ks % STAGES) * STAGE_BYTES);
    const uint32_t gs = xs + X_TILE;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // B = g (rows x output channels), k-major: fragment pairs along the rows
      uint32_t bfr[NI][2];
#pragma unroll
      for (int j = 0; j < NI / 2; ++j) {
        uint32_t r[4];
        ldmatrix_x4_trans(
            r, gs + swz(kk * 16 + (lane & 15), (wo + j * 16) / 8 + (lane >> 4), G_ROW));
        bfr[2 * j][0] = r[0];
        bfr[2 * j][1] = r[1];
        bfr[2 * j + 1][0] = r[2];
        bfr[2 * j + 1][1] = r[3];
      }
      // A = x^T (input channels x rows): x stored row-major in the rows, read transposed
      const int a_row = kk * 16 + (lane & 7) + ((lane >> 4) << 3);
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        uint32_t af[4];
        ldmatrix_x4_trans(af, xs + swz(a_row, (wc + i * 16) / 8 + ((lane >> 3) & 1), X_ROW));
#pragma unroll
        for (int j = 0; j < NI; ++j) mma_bf16(acc[i][j], af, bfr[j][0], bfr[j][1]);
      }
    }
  }
  cp_async_wait<0>();
  allow_split_sum();

  // out is (splits / cluster, C, O).  Alone (a cluster of 1), the block writes its partial
  // sums for its split; O % 8 == 0, so each pair of output channels is in or out together
  // and 8-byte aligned.
  const int gq = lane >> 2, q = lane & 3;
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = (int)cluster.num_blocks();
  if (cl == 1) {
    float* dst = out + (long long)split * C * O;
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int o = o0 + wo + j * 8 + 2 * q;
        if (o >= O) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = c0 + wc + i * 16 + gq + 8 * h;
          if (c < C)
            *reinterpret_cast<float2*>(dst + (long long)c * O + o) =
                make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
      }
    return;
  }
  // In a cluster of CLUSTER blocks (consecutive splits of one tile), each block stages its
  // fp32 tile in its own shared memory (the ring is done with), and block r sums rows
  // [r, r + 1) * BC / CLUSTER of the tile over the cluster's blocks in rank order, read
  // through distributed shared memory, into the cluster's one partial: the partials'
  // round trip through device memory shrinks by the cluster size, in a fixed order.
  static_assert(BC * BO * 4 <= smem_bytes<BC, BO>(), "the fp32 tile must fit the ring");
  static_assert(BC % CLUSTER == 0, "the cluster's blocks split the tile's rows");
  __syncthreads();
  float* tile = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(tile + (wc + i * 16 + gq + 8 * h) * BO + wo + j * 8 + 2 * q) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
  cluster.sync();
  const float* peer[CLUSTER];
#pragma unroll
  for (int r = 0; r < CLUSTER; ++r) peer[r] = cluster.map_shared_rank(tile, r);
  constexpr int ROWS = BC / CLUSTER;
  const int rank = (int)cluster.block_rank();
  float* dst = out + (long long)(split / CLUSTER) * C * O;
  for (int e = tid; e < ROWS * BO / 4; e += THREADS) {
    const int row = rank * ROWS + e / (BO / 4), col = 4 * (e % (BO / 4));
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < CLUSTER; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(peer[r] + row * BO + col);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    const int c = c0 + row, o = o0 + col;
    if (c < C && o < O) *reinterpret_cast<float4*>(dst + (long long)c * O + o) = sum;
  }
  cluster.sync();                        // peers' tiles stay until every block has read
}

// above 48 KB of dynamic shared memory only after this, once a device and instantiation
template <int BC, int BO, int WC, int WO, bool VEC>
cudaError_t allow_smem(int device) {
  static bool done[64];
  if (device >= 0 && device < 64 && done[device]) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(conv1x1_wgrad_kernel<BC, BO, WC, WO, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes<BC, BO>());
  if (err == cudaSuccess && device >= 0 && device < 64) done[device] = true;
  return err;
}

// the partial pass on `grid`, its blocks in clusters of `cl` (1 or CLUSTER) along the splits
template <int BC, int BO, int WC, int WO, bool VEC>
cudaError_t launch_partial(dim3 grid, int cl, const void* x, const void* g, float* dst, int H,
                           int W, int C, int O, int Ho, int Wo, int stride, long long M,
                           long long rows, int device, cudaStream_t s) {
  cudaError_t err = allow_smem<BC, BO, WC, WO, VEC>(device);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(WC * WO * 32);
  cfg.dynamicSmemBytes = smem_bytes<BC, BO>();
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = (unsigned)cl;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, conv1x1_wgrad_kernel<BC, BO, WC, WO, VEC>,
                           static_cast<const bf16*>(x), static_cast<const bf16*>(g), dst, H, W,
                           C, O, Ho, Wo, stride, M, rows);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int BC, int BO, int WC, int WO, bool VEC>
cudaError_t occupancy(int* blocks, int device) {
  cudaError_t err = allow_smem<BC, BO, WC, WO, VEC>(device);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, conv1x1_wgrad_kernel<BC, BO, WC, WO, VEC>, WC * WO * 32, smem_bytes<BC, BO>());
}

// the tiles (BC, BO), each with its WC x WO warps; any other is cudaErrorInvalidValue
template <bool VEC>
cudaError_t launch_tile(int bc, int bo, dim3 grid, int cl, const void* x, const void* g,
                        float* dst, int H, int W, int C, int O, int Ho, int Wo, int stride,
                        long long M, long long rows, int device, cudaStream_t s) {
  if (bc == 64 && bo == 64)
    return launch_partial<64, 64, 2, 4, VEC>(grid, cl, x, g, dst, H, W, C, O, Ho, Wo, stride,
                                             M, rows, device, s);
  if (bc == 128 && bo == 128)
    return launch_partial<128, 128, 2, 4, VEC>(grid, cl, x, g, dst, H, W, C, O, Ho, Wo,
                                               stride, M, rows, device, s);
  if (bc == 64 && bo == 256)
    return launch_partial<64, 256, 1, 8, VEC>(grid, cl, x, g, dst, H, W, C, O, Ho, Wo,
                                              stride, M, rows, device, s);
  if (bc == 256 && bo == 64)
    return launch_partial<256, 64, 4, 2, VEC>(grid, cl, x, g, dst, H, W, C, O, Ho, Wo,
                                              stride, M, rows, device, s);
  if (bc == 256 && bo == 128)
    return launch_partial<256, 128, 4, 4, VEC>(grid, cl, x, g, dst, H, W, C, O, Ho, Wo,
                                               stride, M, rows, device, s);
  if (bc == 128 && bo == 256)
    return launch_partial<128, 256, 2, 8, VEC>(grid, cl, x, g, dst, H, W, C, O, Ho, Wo,
                                               stride, M, rows, device, s);
  return cudaErrorInvalidValue;
}

template <bool VEC>
cudaError_t occupancy_tile(int bc, int bo, int* blocks, int device) {
  if (bc == 64 && bo == 64) return occupancy<64, 64, 2, 4, VEC>(blocks, device);
  if (bc == 128 && bo == 128) return occupancy<128, 128, 2, 4, VEC>(blocks, device);
  if (bc == 64 && bo == 256) return occupancy<64, 256, 1, 8, VEC>(blocks, device);
  if (bc == 256 && bo == 64) return occupancy<256, 64, 4, 2, VEC>(blocks, device);
  if (bc == 256 && bo == 128) return occupancy<256, 128, 4, 4, VEC>(blocks, device);
  if (bc == 128 && bo == 256) return occupancy<128, 256, 2, 8, VEC>(blocks, device);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point, bound with ctypes.  x: (N, H, W, C) bf16, g: (N, Ho, Wo, O) bf16,
// out: (C, O) fp32, workspace: (splits / cluster, C, O) fp32 when splits > cluster (else
// unused), all contiguous on `device`, C and O multiples of 8.  The tile bc x bo (64 x 64,
// 128 x 128, 64 x 256, 256 x 64, 256 x 128 or 128 x 256), splits and rows_per_split (split
// s takes rows [s * rows_per_split, (s + 1) * rows_per_split) of the N*Ho*Wo), cluster (1,
// or 2: the blocks of splits 2k and 2k + 1 sum their tiles on chip into one partial;
// splits even) and vec (1: x and g 16-byte aligned, the 16-byte copy path; 0: the element
// path) come from the host plan; rows that the splits do not cover, another tile or
// cluster, or channels off 8 return cudaErrorInvalidValue, vec = 1 on misaligned operands
// cudaErrorMisalignedAddress.  Launches the partial pass and, when splits > cluster, the
// reduction pass on `stream`, and counts each launch in launched[0] (partial passes) and
// launched[1] (reduction passes), which it zeroes first; with no rows it launches no kernel
// and zero-fills out.  Returns cudaGetLastError() after them (0 on success).
extern "C" int mxtt_conv1x1_wgrad(const void* x, const void* g, float* out, float* workspace,
                                  int N, int H, int W, int C, int O, int Ho, int Wo,
                                  int stride, int bc, int bo, int splits,
                                  long long rows_per_split, int cluster, int vec, int device,
                                  void* stream, int* launched) {
  launched[0] = launched[1] = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long M = (long long)N * Ho * Wo;
  const long long total = (long long)C * O;
  if (total == 0) return cudaSuccess;
  if (M == 0) return (int)cudaMemsetAsync(out, 0, total * sizeof(float), s);
  if (C % 8 || O % 8 || stride < 1 || splits < 1 || splits > 65535 ||
      (cluster != 1 && cluster != CLUSTER) || splits % cluster || rows_per_split < 1 ||
      (long long)splits * rows_per_split < M ||
      (splits > cluster && workspace == nullptr) || (long long)N * H * W >= (1LL << 31) ||
      M >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (vec && (!aligned16(x) || !aligned16(g))) return (int)cudaErrorMisalignedAddress;
  const dim3 grid((unsigned)(((C + bc - 1) / bc) * ((O + bo - 1) / bo)), (unsigned)splits);
  const int partials = splits / cluster;
  float* dst = partials > 1 ? workspace : out;
  err = vec ? launch_tile<true>(bc, bo, grid, cluster, x, g, dst, H, W, C, O, Ho, Wo, stride,
                                M, rows_per_split, device, s)
            : launch_tile<false>(bc, bo, grid, cluster, x, g, dst, H, W, C, O, Ho, Wo, stride,
                                 M, rows_per_split, device, s);
  if (err != cudaSuccess) return (int)err;
  launched[0] = 1;
  if (partials == 1) return (int)cudaSuccess;
  err = launch_split_sum<bf16_1x1_wgrad>(workspace, out, total, partials, s);
  if (err == cudaSuccess) launched[1] = 1;
  return (int)err;
}

// Blocks of the partial pass at tile bc x bo (vec or not) that one SM holds at once, into
// *blocks: at least what the host plan puts on an SM (1), read on the card.  Returns a
// CUDA error code.
extern "C" int mxtt_conv1x1_wgrad_occupancy(int bc, int bo, int vec, int device, int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = vec ? occupancy_tile<true>(bc, bo, blocks, device)
            : occupancy_tile<false>(bc, bo, blocks, device);
  return (int)err;
}
