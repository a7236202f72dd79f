// ResNet v1 identity bottleneck at inference, BatchNorm folded, bf16, for Hopper (sm_90a).
//
// Replaces the TPU kernel tools/probe_fused_block.py:_kernel, launched by the pallas_call
// at probe_fused_block.py:74.  It computes the same function, on NHWC activations:
//
//   h1  = bf16(relu(x . w1^T + b[0, :Cm]))                1x1, Cin -> Cm
//   h2  = bf16(relu(sum_taps pad1(h1)[tap] . w2[tap]^T + b[1, :Cm]))   3x3, stride 1, pad 1
//   out = bf16(relu(h2 . w3^T + b[2] + float(x)))           1x1, Cm -> Cin, fp32 residual
//
// with x (N, H, W, Cin) bf16, the folded weights bf16 as (out, in) like the convolutions'
// own: w1 (Cm, Cin), w2 (9, Cm, Cm) (tap 3*dy + dx), w3 (Cin, Cm) (the probe's are their
// transposes), and b (3, Cin) fp32 (rows 0 and 1 use their first Cm entries); every
// product is exact in fp32 and every sum fp32.  The halo of the 3x3 is zero in h1, after
// the bias and the ReLU, as the probe pads h1 (probe_fused_block.py:46-49), so a border tap
// adds nothing.
//
// Numerics: the tensor cores (wmma bf16 16x16x16, fp32 accumulate) add the products in
// another order than the plain PyTorch version (fp32 matmuls), so an fp32 sum may round
// to the neighbouring bf16 value at each of the three roundings: the two agree within one
// bf16 step of the value (2^-7 relative) plus 1e-3 of the largest |out|, the tolerance
// chip_smoke.py states.
//
// Design.  The TPU kernel keeps a batch tile of 2 whole images in VMEM.  Here one CTA takes
// one image and a band of R output rows, chosen by the host so that the band's
// intermediates fit in shared memory, and the three convolutions run back to back in it:
//   1. h1 for the band's R + 2 rows (the 3x3's halo), all W columns, into shared memory
//      in a zero-padded (R + 2) x (W + 2) layout; rows outside the image stay zero;
//   2. h2 for the band into shared memory.  The 3x3 is 9 shifted GEMMs over the padded h1:
//      output pixel q = i * (W + 2) + j reads h1 row q + dy * (W + 2) + dx, so each tap is
//      one GEMM over contiguous rows; the 2 junk columns of each row are computed and
//      dropped;
//   3. out in chunks of output channels: bias, the residual read from x and widened to
//      fp32, ReLU, a bf16 store.
// Each stage is a GEMM whose output is cut into 64 x 32 warp tiles, dealt to 8 warps row
// tile first, so that the warps in flight read the same weights (L1 hits); a warp runs
// wmma bf16 products into 4 x 2 fp32 accumulators, with A from shared memory (x staged
// through a per-warp buffer in stage 1, one 32-channel chunk ahead in registers) and B,
// the folded weights, loaded straight from global memory (L2-resident) as column-major
// fragments (each lane's pairs along the reduction contiguous), 4 steps ahead in
// registers.  The epilogue goes through a per-warp fp32 tile in shared memory and moves 8
// channels (16 bytes) a lane.  Only x is read from and out written to device memory.
//
// Bound at the slice's shapes (bf16, batch 128): x read once, out written once, the
// weights once; 2*M*(2*Cin*Cm + 9*Cm^2) FLOP.  At 56x56/256 and 28x28/512 bytes bound it
// (0.123 and 0.061 ms), at 14x14/1024 and 7x7/2048 operations (0.0565 ms each): 0.825 ms
// for a ResNet-50 forward's 12 blocks.  This first kernel reads the weights from L2 once per
// 64-row tile in every CTA (it keeps none in shared memory), recomputes the halo rows of h1
// and runs one CTA per SM; TMA, wgmma and weights shared across a cluster are the later
// steps towards that bound.
//
// Limits (the host entry returns cudaErrorInvalidValue outside them): Cin and Cm multiples
// of 32; a band of one row must fit in the card's shared memory (W up to ~600 at Cm 64).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TM = 64;                 // rows of a warp tile
constexpr int TN = 32;                 // columns of a warp tile
constexpr int FM = TM / 16, FN = TN / 16;
constexpr int BD = 4;                  // steps of B held in registers ahead of use
constexpr int PAD = 16;                // bf16 pad of an h1/h2 row: rows stay 32-byte aligned
constexpr int KS1 = 32;                // x channels staged per chunk of stage 1
constexpr int XLD = KS1 + 8;           // bf16 pitch of the stage-1 staging tile
constexpr int XV = TM * KS1 / 8 / 32;  // 16-byte loads of x per lane per chunk
constexpr int ELD = TN + 4;            // fp32 pitch of the epilogue tile
constexpr int WARP_BUF = TM * XLD * 2; // bytes of a warp's staging / epilogue buffer

static_assert(16 * ELD * 4 <= WARP_BUF, "the epilogue tile must fit the warp's buffer");
static_assert((16 * XLD * 2) % 32 == 0 && WARP_BUF % 128 == 0, "wmma needs 32-byte bases");
static_assert(16 * TN / 8 == 2 * 32, "the epilogue gives each lane 2 vectors of 8");

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// rows of the padded h1 buffer and of the h2 buffer for a band of R output rows: the
// shifted GEMMs of stage 2 read up to 2 * (W + 2) + 2 rows past the last 64-row tile
__host__ __device__ inline int h1_rows(int R, int W) {
  return round_up(R * (W + 2), TM) + 2 * (W + 2) + 2;
}
__host__ __device__ inline int h2_rows(int R, int W) { return round_up(R * W, TM); }

inline size_t smem_bytes(int R, int W, int Cm) {
  return (size_t)(h1_rows(R, W) + h2_rows(R, W)) * (Cm + PAD) * sizeof(bf16) +
         (size_t)WARPS * WARP_BUF;
}

__device__ inline void zero(FragC (&acc)[FM][FN]) {
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);
}

// B fragment j of a step: output channels 16 * j.. of the weights (out, in), which is B
// in column-major order, so each lane's pairs along the reduction are contiguous
__device__ inline void load_b(FragB (&b)[FN], const bf16* p, int ldb) {
#pragma unroll
  for (int j = 0; j < FN; ++j) wmma::load_matrix_sync(b[j], p + (size_t)16 * j * ldb, ldb);
}

// acc += A . B over `steps` steps of 16: prep(s) runs first in step s, then A fragment i
// of step s is read at a_row(s) + 16 * i rows (pitch lda, shared memory) and B of step s
// at b_col(s) (global memory, column pitch ldb), loaded BD steps ahead into a ring of
// registers
template <class ARow, class BCol, class Prep>
__device__ inline void warp_gemm(FragC (&acc)[FM][FN], int steps, ARow a_row, int lda,
                                 BCol b_col, int ldb, Prep prep) {
  FragB b[BD][FN];
#pragma unroll
  for (int d = 0; d < BD; ++d)
    if (d < steps) load_b(b[d], b_col(d), ldb);
  for (int s0 = 0; s0 < steps; s0 += BD) {
#pragma unroll
    for (int d = 0; d < BD; ++d) {
      const int s = s0 + d;
      if (s < steps) {
        prep(s);
        const bf16* a = a_row(s);
        FragA fa[FM];
#pragma unroll
        for (int i = 0; i < FM; ++i) wmma::load_matrix_sync(fa[i], a + 16 * i * lda, lda);
#pragma unroll
        for (int i = 0; i < FM; ++i)
#pragma unroll
          for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], fa[i], b[d][j], acc[i][j]);
        if (s + BD < steps) load_b(b[d], b_col(s + BD), ldb);
      }
    }
  }
}

// hands the warp tile to `put(row, v)` 8 columns at a time: lane l owns columns
// 8 * (l % 4) .. + 8 of rows l / 4 and l / 4 + 8 of each 16-row slab, v their fp32 sums
template <class Put>
__device__ inline void epilogue(FragC (&acc)[FM][FN], float* ep, int lane, Put put) {
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(ep + 16 * j, acc[i][j], ELD, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = lane / 4 + 8 * h;
      const float4* src = reinterpret_cast<const float4*>(ep + r * ELD + 8 * (lane % 4));
      const float4 lo = src[0], hi = src[1];
      float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      put(16 * i + r, v);
    }
    __syncwarp();
  }
}

// the 8 fp32 biases of this lane's columns
__device__ inline void load8(float (&dst)[8], const float* p) {
  const float4 lo = reinterpret_cast<const float4*>(p)[0];
  const float4 hi = reinterpret_cast<const float4*>(p)[1];
  dst[0] = lo.x; dst[1] = lo.y; dst[2] = lo.z; dst[3] = lo.w;
  dst[4] = hi.x; dst[5] = hi.y; dst[6] = hi.z; dst[7] = hi.w;
}

// relu(v + bias) as 8 bf16 in one 16-byte word
__device__ inline uint4 relu_pack(const float (&v)[8], const float (&bias)[8]) {
  uint4 out;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    o[k] = __floats2bfloat162_rn(fmaxf(v[2 * k] + bias[2 * k], 0.f),
                                 fmaxf(v[2 * k + 1] + bias[2 * k + 1], 0.f));
  return out;
}

__global__ void __launch_bounds__(THREADS, 1)
fused_bottleneck_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                        const bf16* __restrict__ w2, const bf16* __restrict__ w3,
                        const float* __restrict__ b, bf16* __restrict__ out, int H, int W,
                        int Cin, int Cm, int R) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int LD = Cm + PAD;
  const int WP = W + 2;
  const int n1 = h1_rows(R, W), n2 = h2_rows(R, W);
  bf16* h1 = reinterpret_cast<bf16*>(smem);
  bf16* h2 = h1 + (size_t)n1 * LD;
  unsigned char* wbuf = reinterpret_cast<unsigned char*>(h2 + (size_t)n2 * LD);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  bf16* xs = reinterpret_cast<bf16*>(wbuf + warp * WARP_BUF);   // stage-1 staging
  float* ep = reinterpret_cast<float*>(wbuf + warp * WARP_BUF); // epilogue (after staging)
  const int c8 = 8 * (lane % 4);                                 // this lane's epilogue columns

  const int r0 = blockIdx.x * R;                 // first output row of the band
  const int rows = min(R, H - r0);
  const int lo = max(r0 - 1, 0), hi = min(r0 + rows, H - 1);   // image rows of h1
  const int M1 = (hi - lo + 1) * W, M2 = rows * WP, M3 = rows * W;
  const long long img = (long long)blockIdx.y * H * W;         // first pixel of the image

  {  // zero h1 (halo, rows outside the image, slack rows) and h2 (rows past the band)
    uint4* p = reinterpret_cast<uint4*>(h1);
    const int vecs = (n1 + n2) * LD / 8;
    for (int i = threadIdx.x; i < vecs; i += THREADS) p[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  FragC acc[FM][FN];
  float bias[8];

  // stage 1: h1 = relu(x . w1 + b1) over the band's image rows lo..hi
  {
    const bf16* xb = x + (img + (long long)lo * W) * Cin;
    const int mtiles = (M1 + TM - 1) / TM, items = mtiles * (Cm / TN);
    for (int item = warp; item < items; item += WARPS) {
      const int m0 = item % mtiles * TM, n0 = item / mtiles * TN;
      // x rows m0.. in chunks of 32 channels, one chunk ahead in registers; rows past M1
      // are zero
      uint4 xr[XV];
      auto load_x = [&](int k0) {
#pragma unroll
        for (int v = 0; v < XV; ++v) {
          const int e = lane + 32 * v, r = e / (KS1 / 8), c = e % (KS1 / 8) * 8;
          xr[v] = m0 + r < M1
                      ? *reinterpret_cast<const uint4*>(xb + (long long)(m0 + r) * Cin + k0 + c)
                      : make_uint4(0u, 0u, 0u, 0u);
        }
      };
      load_x(0);
      zero(acc);
      warp_gemm(acc, Cin / 16, [&](int s) { return xs + 16 * (s % (KS1 / 16)); }, XLD,
                [&](int s) { return w1 + (size_t)n0 * Cin + 16 * s; }, Cin, [&](int s) {
                  if (s % (KS1 / 16)) return;
                  __syncwarp();        // the last chunk's fragments are loaded
#pragma unroll
                  for (int v = 0; v < XV; ++v) {
                    const int e = lane + 32 * v;
                    *reinterpret_cast<uint4*>(xs + e / (KS1 / 8) * XLD + e % (KS1 / 8) * 8) = xr[v];
                  }
                  __syncwarp();
                  if (16 * s + KS1 < Cin) load_x(16 * s + KS1);
                });
      __syncwarp();
      load8(bias, b + n0 + c8);
      epilogue(acc, ep, lane, [&](int r, const float (&v)[8]) {
        const int p = m0 + r;
        if (p < M1) {
          const int hr = lo + p / W - (r0 - 1), hc = p % W + 1;
          *reinterpret_cast<uint4*>(h1 + (size_t)(hr * WP + hc) * LD + n0 + c8) =
              relu_pack(v, bias);
        }
      });
    }
  }
  __syncthreads();

  // stage 2: h2 = relu(sum over 9 taps of shifted h1 . w2[tap] + b2), q = i * WP + j
  {
    const int ksteps = Cm / 16;
    const int mtiles = (M2 + TM - 1) / TM, items = mtiles * (Cm / TN);
    for (int item = warp; item < items; item += WARPS) {
      const int m0 = item % mtiles * TM, n0 = item / mtiles * TN;
      zero(acc);
      // step s: tap s / ksteps, channels 16 * (s % ksteps); w2 is (9, Cm out, Cm in)
      warp_gemm(acc, 9 * ksteps, [&](int s) {
        const int tap = s / ksteps, k0 = 16 * (s % ksteps);
        return h1 + (size_t)(m0 + tap / 3 * WP + tap % 3) * LD + k0;
      }, LD, [&](int s) {
        const int tap = s / ksteps, k0 = 16 * (s % ksteps);
        return w2 + ((size_t)tap * Cm + n0) * Cm + k0;
      }, Cm, [](int) {});
      load8(bias, b + Cin + n0 + c8);
      epilogue(acc, ep, lane, [&](int r, const float (&v)[8]) {
        const int q = m0 + r;
        const int i = q / WP, j = q - i * WP;
        if (q < M2 && j < W)
          *reinterpret_cast<uint4*>(h2 + (size_t)(i * W + j) * LD + n0 + c8) =
              relu_pack(v, bias);
      });
    }
  }
  __syncthreads();

  // stage 3: out = relu(h2 . w3 + b3 + x) for the band's pixels
  {
    const long long g0 = img + (long long)r0 * W;    // first output pixel of the band
    const int mtiles = (M3 + TM - 1) / TM, items = mtiles * (Cin / TN);
    for (int item = warp; item < items; item += WARPS) {
      const int m0 = item % mtiles * TM, n0 = item / mtiles * TN;
      zero(acc);
      warp_gemm(acc, Cm / 16, [&](int s) { return h2 + (size_t)m0 * LD + 16 * s; }, LD,
                [&](int s) { return w3 + (size_t)n0 * Cm + 16 * s; }, Cm, [](int) {});
      load8(bias, b + 2 * Cin + n0 + c8);
      epilogue(acc, ep, lane, [&](int r, const float (&v)[8]) {
        const int p = m0 + r;
        if (p < M3) {
          const size_t idx = (size_t)(g0 + p) * Cin + n0 + c8;
          const uint4 res = *reinterpret_cast<const uint4*>(x + idx);
          const __nv_bfloat162* rh = reinterpret_cast<const __nv_bfloat162*>(&res);
          uint4 y;
          __nv_bfloat162* yh = reinterpret_cast<__nv_bfloat162*>(&y);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float2 f = __bfloat1622float2(rh[k]);
            yh[k] = __floats2bfloat162_rn(fmaxf(v[2 * k] + bias[2 * k] + f.x, 0.f),
                                          fmaxf(v[2 * k + 1] + bias[2 * k + 1] + f.y, 0.f));
          }
          *reinterpret_cast<uint4*>(out + idx) = y;
        }
      });
    }
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  x and out: (N, H, W, Cin) bf16; w1 (Cm, Cin),
// w2 (9, Cm, Cm), w3 (Cin, Cm) bf16, (out, in); b (3, Cin) fp32; all contiguous on `device`, every
// pointer 32-byte aligned (wmma), Cin and Cm multiples of 32.  Picks the band height: the
// tallest band whose buffers fit the card's shared memory for one block, then evened out
// over the image (R = ceil(H / bands)).  Launches one kernel of (bands, N) blocks on
// `stream` and returns cudaGetLastError() after it (0 on success); info[0] gets R and
// info[1] the dynamic shared memory in bytes.
extern "C" int mxtt_fused_bottleneck(const void* x, const void* w1, const void* w2,
                                     const void* w3, const float* b, void* out, int N,
                                     int H, int W, int Cin, int Cm, int device, void* stream,
                                     int* info) {
  info[0] = info[1] = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N < 1 || H < 1 || W < 1 || Cin < TN || Cm < TN || Cin % TN || Cm % TN || N > 65535)
    return (int)cudaErrorInvalidValue;
  int limit = 0;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  int R = 0;
  while (R < H && smem_bytes(R + 1, W, Cm) <= (size_t)limit) ++R;
  if (R == 0) return (int)cudaErrorInvalidValue;
  const int bands = (H + R - 1) / R;
  R = (H + bands - 1) / bands;
  const size_t bytes = smem_bytes(R, W, Cm);
  err = cudaFuncSetAttribute(fused_bottleneck_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  fused_bottleneck_kernel<<<dim3((unsigned)bands, (unsigned)N), THREADS, bytes,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const bf16*>(w2),
      static_cast<const bf16*>(w3), b, static_cast<bf16*>(out), H, W, Cin, Cm, R);
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    info[0] = R;
    info[1] = (int)bytes;
  }
  return (int)err;
}
