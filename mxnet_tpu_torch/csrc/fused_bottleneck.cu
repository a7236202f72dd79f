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
// Numerics: the tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate) add the
// products in another order than the plain PyTorch version (fp32 matmuls), so an fp32 sum
// may round to the neighbouring bf16 value at each of the three roundings: the two agree
// within one bf16 step of the value (2^-7 relative) plus 1e-3 of the largest |out|, the
// tolerance chip_smoke.py states.
//
// Bound at the main path's shapes (bf16, batch 128): every block is 55.9 GFLOP; x read
// once, out written once, the weights once.  At 56x56/256 and 28x28/512 bytes bound it
// (0.123 and 0.061 ms), at 14x14/1024 and 7x7/2048 operations (0.0565 ms each).  What
// the design works against, on a card whose SMs each hold one such block at a time:
//
//   - Weight bytes from L2.  A block's folded weights are 0.14-8.9 MB.  Each CTA stages
//     them in 64-channel k-slices through a cp.async ring in shared memory that all 8
//     warps consume, warps splitting a chunk's rows before its columns, so that a weight
//     byte crosses from L2 once per CTA for all of its pixels (a whole 7x7 image, 98
//     output pixels at 14 px, 196 at 28, 392 at 56).
//   - The tensor cores' operands.  mma.sync m16n8k16 from ldmatrix (csrc/mma_bf16.cuh),
//     every warp a 64 x 64 tile of fp32 accumulators (8 ldmatrix.x4 to 32 MMAs a k16
//     step, their addresses worked out once a slice, no branch among them); one CTA of
//     256 threads an SM, so a thread may hold 128 accumulators.  The ring's 128-byte rows
//     are XOR-swizzled, the h1 and h2 rows padded to 16 bytes past a multiple of 128:
//     8 rows of ldmatrix hit 8 bank groups.
//   - Shared memory.  h1 of a band of R output rows (with its halo rows, zero-padded
//     columns) stays in shared memory, and so does h2, which is written over h1 where a
//     band's h2 is one chunk (every main-path shape): the room goes to the ring.  The
//     3x3 is 9 GEMMs over h1 whose A rows ldmatrix gathers per lane (output pixel (i, j)
//     reads padded row (i + dy)(W + 2) + j + dx), so no junk columns are computed and a
//     tap at the border reads the zero pad.  out leaves from the fragments, traded
//     within each quad by shuffles so that a lane reads its residual and writes 16
//     bytes of a row at once, the next row's residual loaded ahead.
//   - Pipeline bubbles and waves.  A CTA is persistent: it walks its work units (image,
//     band) chunk by chunk, the loads one flattened sequence of k-slices over all three
//     stages and all units, so the ring runs on across chunk, stage and unit boundaries;
//     a slice's copies are issued once its first k16 step's MMAs are in flight.
//
// On the card (chip_smoke.py phase 2h) it runs 0.33-0.56 ms a block, 100-168 TFLOP/s:
// each slice ends in a barrier of the CTA's 8 warps, the only warps on the SM, and at 7
// px each CTA streams all 8.9 MB of the weights from L2.  Warp-specialised loads with
// wgmma, and clusters sharing weight slices by TMA multicast, are the next steps.
//
// The host plan (ops/hopper_block.py fused_bottleneck_plan) picks the warps' layout (WM
// warps along the rows: a chunk of 64*WM rows by 512/WM columns), the band height R and
// the ring's depth so that the buffers fit in shared memory, by a cost model over whole
// waves of slices.
//
// Limits (the host entry returns cudaErrorInvalidValue outside them): Cin and Cm multiples
// of 32 (a reduction off 64 channels zero-fills its last slice), every operand 16-byte
// aligned, a plan whose buffers fit the card's shared memory.

#include "mma_bf16.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int CH = 32;                 // the channel counts' granule
constexpr int BK = 64;                 // reduction channels of a ring slice (128-byte rows)
constexpr int MI = 4, NI = 8;          // m16 and n8 tiles of a warp's 64 x 64 tile

// bytes of an h1 / h2 row of Cm channels: padded so that 8 rows hit 8 bank groups
__host__ __device__ inline int row_bytes(int Cm) { return 2 * Cm + 16; }

// whether h2 shares h1's buffer: where a band's h2 is one chunk (its rows and Cm fit one
// chunk) it is written once the 3x3 has read h1 for the last time, so it needs no buffer
// of its own (the band's h1 must hold the chunk's rows)
__host__ __device__ inline bool h2_in_h1(int wm, int R, int W, int Cm) {
  const int bm = 64 * wm;
  return R * W <= bm && Cm <= 512 / wm && (R + 2) * (W + 2) >= bm;
}

// dynamic shared memory of a plan: h1 of the band with its halo, the h2 tile of a
// chunk's rows unless it shares h1's buffer, and the ring of slices (A rows of x, then B
// rows of the weights)
__host__ __device__ inline long long smem_bytes(int wm, int R, int W, int Cm, int stages) {
  const int bm = 64 * wm, bn = 512 / wm;
  const int h2_rows = h2_in_h1(wm, R, W, Cm) ? 0 : bm;
  return (long long)((R + 2) * (W + 2) + h2_rows) * row_bytes(Cm) +
         (long long)stages * 2 * BK * (bm + bn);
}

// a0..a3[k] for a k known only at run time, as selects (an array indexed by it would
// go to local memory)
__device__ __forceinline__ float pick4(float a0, float a1, float a2, float a3, int k) {
  return k == 0 ? a0 : k == 1 ? a1 : k == 2 ? a2 : a3;
}

struct Shape {
  int H, W, Cin, Cm, R, bands, units;
};

// Where a walk over the CTA's k-slices stands: the work unit (image, band), the stage
// (0: h1, 1: h2, 2: out), the chunk of the stage's output rows (mc) and columns (nc), and
// the slice within the chunk.  The producer (the loads) and the consumer (the MMAs and
// epilogues) each walk one, the producer stages - 1 slices ahead.
template <int WM>
struct Cursor {
  static constexpr int BM = 64 * WM, BN = 512 / WM;
  int unit, stage, mc, nc, s;
  int img, r0, rows, lo, M1, M2;          // the unit's geometry

  __device__ void enter(const Shape& sh) {
    img = unit / sh.bands;
    r0 = (unit - img * sh.bands) * sh.R;
    rows = min(sh.R, sh.H - r0);
    lo = max(r0 - 1, 0);
    const int hi = min(r0 + rows, sh.H - 1);
    M1 = (hi - lo + 1) * sh.W;
    M2 = rows * sh.W;
    stage = mc = nc = s = 0;
  }
  __device__ bool valid(const Shape& sh) const { return unit < sh.units; }
  __device__ int out_cols(const Shape& sh) const { return stage == 2 ? sh.Cin : sh.Cm; }
  __device__ int slices(const Shape& sh) const {
    const int km = (sh.Cm + BK - 1) / BK;
    return stage == 0 ? (sh.Cin + BK - 1) / BK : stage == 1 ? 9 * km : km;
  }
  __device__ int chunk_rows() const { return (stage == 0 ? M1 : M2) - mc * BM; }
  __device__ void next_chunk(const Shape& sh) {
    s = slices(sh) - 1;
    advance(sh);
  }
  __device__ void advance(const Shape& sh) {
    if (++s < slices(sh)) return;
    s = 0;
    if (++nc * BN < out_cols(sh)) return;
    nc = 0;
    if (stage == 0) {
      if (++mc * BM < M1) return;
      mc = 0;
      stage = 1;
    } else if (stage == 1) {
      stage = 2;
    } else if (++mc * BM < M2) {
      stage = 1;
    } else {
      unit += gridDim.x;
      if (unit < sh.units) enter(sh);
    }
  }
};

template <int WM>
__global__ void __launch_bounds__(THREADS, 1)
fused_bottleneck_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                        const bf16* __restrict__ w2, const bf16* __restrict__ w3,
                        const float* __restrict__ b, bf16* __restrict__ out, Shape sh,
                        int stages) {
  constexpr int BM = 64 * WM, BN = 512 / WM;
  constexpr int ROW = 2 * BK;            // bytes of a ring slice's row
  constexpr int A_COPIES = BM * 8 / THREADS, B_COPIES = BN * 8 / THREADS;
  extern __shared__ __align__(128) unsigned char smem[];
  const int W = sh.W, Cin = sh.Cin, Cm = sh.Cm;
  const int WP = W + 2, P = row_bytes(Cm);
  const bool alias = h2_in_h1(WM, sh.R, W, Cm);
  unsigned char* h1 = smem;
  unsigned char* h2 = alias ? h1 : h1 + (size_t)(sh.R + 2) * WP * P;
  unsigned char* ring = h1 + (size_t)((sh.R + 2) * WP + (alias ? 0 : BM)) * P;
  constexpr int SLOT = ROW * (BM + BN);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WM, wn = warp / WM;
  const int g = lane >> 2, q = lane & 3;

  {  // zero h1 (its pad columns and out-of-image rows stay zero), h2 and the ring (an
     // A row read past Cm channels, against zero weights, must read finite values)
    uint4* p = reinterpret_cast<uint4*>(smem);
    const int vecs = (int)((ring + stages * SLOT - smem) / 16);
    for (int i = tid; i < vecs; i += THREADS) p[i] = make_uint4(0u, 0u, 0u, 0u);
  }

  Cursor<WM> prod, cons;
  prod.unit = cons.unit = blockIdx.x;
  if (prod.valid(sh)) {
    prod.enter(sh);
    cons.enter(sh);
  }

  // one slice of the producer's chunk into ring slot `slot`: for stage 0 the chunk's x
  // rows (zero past the rows) and w1's; for stages 1 and 2 the weights' rows alone;
  // channels past the reduction's (a Cm or Cin off 64) zero
  auto load = [&](int slot) {
    unsigned char* a_s = ring + slot * SLOT;
    unsigned char* b_s = a_s + ROW * BM;
    const int kch = (Cm + BK - 1) / BK;
    const bf16* wrow;
    int ldk, k0;
    if (prod.stage == 0) {
      k0 = prod.s * BK;
      const bf16* xb = x + ((long long)prod.img * sh.H + prod.lo) * W * Cin + k0;
#pragma unroll
      for (int i = 0; i < A_COPIES; ++i) {
        const int e = tid + THREADS * i, r = e >> 3, c = e & 7;
        const int m = prod.mc * BM + r;
        const bool ok = m < prod.M1 && k0 + 8 * c < Cin;
        cp_async16(smem_addr(a_s + swz(r, c, ROW)), ok ? xb + (long long)m * Cin + 8 * c : x,
                   ok);
      }
      wrow = w1;
      ldk = Cin;
    } else if (prod.stage == 1) {
      const int tap = prod.s / kch;
      k0 = (prod.s - tap * kch) * BK;
      wrow = w2 + (size_t)tap * Cm * Cm;
      ldk = Cm;
    } else {
      k0 = prod.s * BK;
      wrow = w3;
      ldk = Cm;
    }
    const int ncols = prod.out_cols(sh);
#pragma unroll
    for (int j = 0; j < B_COPIES; ++j) {
      const int e = tid + THREADS * j, r = e >> 3, c = e & 7;
      const int n = prod.nc * BN + r;
      const bool ok = n < ncols && k0 + 8 * c < ldk;
      cp_async16(smem_addr(b_s + swz(r, c, ROW)), ok ? wrow + (size_t)n * ldk + k0 + 8 * c : w1,
                 ok);
    }
  };
  auto wait_ring = [&]() {   // all but the newest stages - 2 groups have landed
    switch (stages) {
      case 2: cp_async_wait<0>(); break;
      case 3: cp_async_wait<1>(); break;
      default: cp_async_wait<2>();
    }
  };

  float acc[MI][NI][4];
  int gather[MI];          // stage 1: each m16 tile's h1 row of this lane's pixel, or -1
  int slot = 0;            // the ring slot of the consumer's slice
  uint32_t b_off[NI / 2];  // this lane's B rows in a ring slot, the first k16 step
#pragma unroll
  for (int jp = 0; jp < NI / 2; ++jp)
    b_off[jp] = ROW * BM + swz(wn * 64 + 16 * jp + (lane & 7) + ((lane >> 4) << 3),
                               (lane >> 3) & 1, ROW);

#pragma unroll 1
  for (int i = 0; i < stages - 1; ++i) {
    if (prod.valid(sh)) {
      load(i);
      prod.advance(sh);
    }
    cp_async_commit();
  }

#pragma unroll 1
  while (cons.valid(sh)) {   // a chunk: its slices, then its epilogue
    const int mrows = cons.chunk_rows();
    const int ncols = cons.out_cols(sh) - cons.nc * BN;
    // this warp's m16 tiles and n16 pairs that hold output (warp-uniform)
    const int m_tiles = min(MI, max(0, (mrows - wm * 64 + 15) / 16));
    const int n_pairs = min(NI / 2, max(0, (ncols - wn * 64 + 15) / 16));
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
    if (cons.stage == 1) {
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int p = cons.mc * BM + wm * 64 + 16 * i + (lane & 15);
        const int pi = p / W;
        gather[i] = p < cons.M2 ? pi * WP + (p - pi * W) : -1;
      }
    }
    const int nsl = cons.slices(sh), kch = (Cm + BK - 1) / BK;
#pragma unroll 1
    for (int s = 0; s < nsl; ++s) {
      wait_ring();
      __syncthreads();
      // the producer's next slice, into the slot the last slice was read from: issued
      // once the first k16 step's MMAs are in the tensor pipe
      const int feed_slot = slot == 0 ? stages - 1 : slot - 1;
      auto feed = [&]() {
        if (prod.valid(sh)) {
          load(feed_slot);
          prod.advance(sh);
        }
        cp_async_commit();
      };
      const uint32_t ring_s = smem_addr(ring + slot * SLOT);   // the slice's slot
      slot = slot + 1 == stages ? 0 : slot + 1;
      if (m_tiles == 0 || n_pairs == 0) {
        feed();
        continue;
      }
      // A rows of this lane for the slice's first k16 step, as an offset in the slot
      // (stage 0) or an address (h1, h2); step kk is the swizzled chunk 2 * kk on (offset
      // bits 5-6) or 32 * kk bytes on
      uint32_t a_addr[MI];
      if (cons.stage == 0) {
#pragma unroll
        for (int i = 0; i < MI; ++i)
          a_addr[i] = swz(wm * 64 + 16 * i + (lane & 15), lane >> 4, ROW);
      } else {
        int k0 = s * BK, tap_off = 0;
        if (cons.stage == 1) {
          const int tap = s / kch;
          k0 = (s - tap * kch) * BK;
          tap_off = tap / 3 * WP + tap % 3;
        }
        const uint32_t base = smem_addr(cons.stage == 1 ? h1 : h2) + (k0 + 8 * (lane >> 4)) * 2;
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          const int r = cons.stage == 2 ? wm * 64 + 16 * i + (lane & 15)
                                        : (gather[i] < 0 ? 0 : gather[i] + tap_off);
          a_addr[i] = base + r * P;
        }
      }
      const bool ring_a = cons.stage == 0;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t af[MI][4], bfr[NI][2];
#pragma unroll
        for (int i = 0; i < MI; ++i)
          ldmatrix_x4(af[i], ring_a ? ring_s + (a_addr[i] ^ (32u * kk)) : a_addr[i] + 32u * kk);
#pragma unroll
        for (int jp = 0; jp < NI / 2; ++jp) {
          uint32_t v[4];
          ldmatrix_x4(v, ring_s + (b_off[jp] ^ (32u * kk)));
          bfr[2 * jp][0] = v[0];
          bfr[2 * jp][1] = v[1];
          bfr[2 * jp + 1][0] = v[2];
          bfr[2 * jp + 1][1] = v[3];
        }
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NI; ++j) mma_bf16(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
        if (kk == 0) feed();
      }
    }

    {  // the chunk's epilogue
      if (cons.stage == 0 && cons.mc == 0 && cons.nc == 0) {
        // a unit's first h1 rows: the rows outside the image (above the first band, below
        // the last) were another unit's, and where h2 shares the buffer all of it was
        const int vecs = WP * P / 16;
        for (int hr = 0; hr < sh.R + 2; ++hr) {
          if (!alias && !(hr == 0 && cons.r0 == 0) &&
              !(hr == cons.rows + 1 && cons.r0 + cons.rows == sh.H))
            continue;
          uint4* p = reinterpret_cast<uint4*>(h1 + (size_t)hr * WP * P);
          for (int i = tid; i < vecs; i += THREADS) p[i] = make_uint4(0u, 0u, 0u, 0u);
        }
        if (alias) __syncthreads();
      }
      // h2 over h1: every warp has read h1 for the last time before any writes h2
      if (alias && cons.stage == 1) __syncthreads();
      // each of this lane's rows (m16 tile i, half h): its h1 row (stage 0), h2 row
      // (stage 1) or pixel (stage 2), or -1 where it holds no output
      int at[MI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm * 64 + 16 * i + g + 8 * h;
          const int m = cons.mc * BM + r;
          int v = r;
          if (cons.stage == 0) {
            const int ih = m / W;
            v = (cons.lo + ih - cons.r0 + 1) * WP + (m - ih * W) + 1;
          } else if (cons.stage == 2) {
            v = (cons.img * sh.H + cons.r0) * W + m;
          }
          at[i][h] = i < m_tiles && r < mrows ? v : -1;
        }
      const float* bias = b + cons.stage * Cin + cons.nc * BN + wn * 64;
      if (cons.stage == 2) {
        // out: the 4 lanes of a quad trade fragments by shuffles so that each holds 8
        // consecutive channels of a row, read as one 16-byte residual word and written
        // as one 16-byte store (a 4-byte store leaves most of each sector to another
        // instruction); the residual is loaded a row ahead, so its latency overlaps
#pragma unroll
        for (int jg = 0; jg < NI / 4; ++jg) {
          if (2 * jg >= n_pairs) break;            // 32 channels: 2 n16 pairs
          const int n = cons.nc * BN + wn * 64 + 32 * jg + 8 * q;   // this lane's 8
          const float4 b_lo = *reinterpret_cast<const float4*>(bias + 32 * jg + 8 * q);
          const float4 b_hi = *reinterpret_cast<const float4*>(bias + 32 * jg + 8 * q + 4);
          const float bb[8] = {b_lo.x, b_lo.y, b_lo.z, b_lo.w, b_hi.x, b_hi.y, b_hi.z, b_hi.w};
          auto residual = [&](int ih) {
            const int row = at[ih >> 1][ih & 1];
            return row < 0 ? make_uint4(0u, 0u, 0u, 0u)
                           : *reinterpret_cast<const uint4*>(x + (long long)row * Cin + n);
          };
          uint4 res_next = residual(0);
#pragma unroll
          for (int ih = 0; ih < 2 * MI; ++ih) {
            const int i = ih >> 1, h = ih & 1;
            const uint4 res = res_next;
            if (ih + 1 < 2 * MI) res_next = residual(ih + 1);
            // step t: send the pair of tile 4 jg + (q ^ t), get the partner's pair of
            // tile 4 jg + q, which is that tile's channels 2 (q ^ t) and 2 (q ^ t) + 1
            float got[4][2];
#pragma unroll
            for (int t = 0; t < 4; ++t)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                got[t][e] = __shfl_xor_sync(
                    0xffffffffu,
                    pick4(acc[i][4 * jg][2 * h + e], acc[i][4 * jg + 1][2 * h + e],
                          acc[i][4 * jg + 2][2 * h + e], acc[i][4 * jg + 3][2 * h + e], q ^ t),
                    t);
            if (at[i][h] < 0) continue;
            const __nv_bfloat162* rh = reinterpret_cast<const __nv_bfloat162*>(&res);
            uint4 y;
            __nv_bfloat162* yh = reinterpret_cast<__nv_bfloat162*>(&y);
#pragma unroll
            for (int c = 0; c < 4; ++c) {        // channels 2c, 2c + 1: step q ^ c's pair
              const int t = q ^ c;
              const float v0 = pick4(got[0][0], got[1][0], got[2][0], got[3][0], t);
              const float v1 = pick4(got[0][1], got[1][1], got[2][1], got[3][1], t);
              const float2 r = __bfloat1622float2(rh[c]);
              yh[c] = __floats2bfloat162_rn(fmaxf(v0 + bb[2 * c] + r.x, 0.f),
                                            fmaxf(v1 + bb[2 * c + 1] + r.y, 0.f));
            }
            *reinterpret_cast<uint4*>(out + (long long)at[i][h] * Cin + n) = y;
          }
        }
      } else {
        // h1 or h2: bias and ReLU, 2 channels a lane a row
        unsigned char* dst = cons.stage == 0 ? h1 : h2;
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          if (j >= 2 * n_pairs) break;
          const int n = cons.nc * BN + wn * 64 + 8 * j + 2 * q;
          const float2 bv = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * q);
#pragma unroll
          for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              if (at[i][h] < 0) continue;
              *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)at[i][h] * P + 2 * n) =
                  __floats2bfloat162_rn(fmaxf(acc[i][j][2 * h] + bv.x, 0.f),
                                        fmaxf(acc[i][j][2 * h + 1] + bv.y, 0.f));
            }
        }
      }
    }
    cons.next_chunk(sh);
  }
  cp_async_wait<0>();
}

// above 48 KB of dynamic shared memory only after this, once a device and layout: the
// card's whole opt-in limit, so that any plan that fits may launch
template <int WM>
cudaError_t allow_smem(int device, int limit) {
  static bool done[64];
  if (device >= 0 && device < 64 && done[device]) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(fused_bottleneck_kernel<WM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
  if (err == cudaSuccess && device >= 0 && device < 64) done[device] = true;
  return err;
}

// the card's opt-in shared memory a block, read once a device
int smem_limit(int device) {
  static int limit[64];
  if (device < 0 || device >= 64) return 0;
  if (limit[device] == 0 &&
      cudaDeviceGetAttribute(&limit[device], cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    limit[device] = 0;
  return limit[device];
}

template <int WM>
cudaError_t launch(int grid, const void* x, const void* w1, const void* w2, const void* w3,
                   const float* b, void* out, Shape sh, int stages, size_t bytes, int device,
                   cudaStream_t s) {
  cudaError_t err = allow_smem<WM>(device, smem_limit(device));
  if (err != cudaSuccess) return err;
  fused_bottleneck_kernel<WM><<<grid, THREADS, bytes, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const bf16*>(w2),
      static_cast<const bf16*>(w3), b, static_cast<bf16*>(out), sh, stages);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes.  x and out: (N, H, W, Cin) bf16; w1 (Cm, Cin),
// w2 (9, Cm, Cm), w3 (Cin, Cm) bf16, (out, in); b (3, Cin) fp32; all contiguous on
// `device` and 16-byte aligned, Cin and Cm multiples of 32.  The plan (wm warps along a
// chunk's rows: 1, 2, 4 or 8; the band height R; the ring's depth, 2 to 4 slices; the
// persistent grid, at most N * ceil(H / R) CTAs) comes from the host; a plan whose buffers
// do not fit the card's shared memory, or any other value out of range, returns
// cudaErrorInvalidValue.  Launches one kernel on `stream` and returns cudaGetLastError()
// after it (0 on success); info[0] gets the dynamic shared memory in bytes.
extern "C" int mxtt_fused_bottleneck(const void* x, const void* w1, const void* w2,
                                     const void* w3, const float* b, void* out, int N,
                                     int H, int W, int Cin, int Cm, int wm, int R, int stages,
                                     int grid, int device, void* stream, int* info) {
  info[0] = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N < 1 || H < 1 || W < 1 || Cin < CH || Cm < CH || Cin % CH || Cm % CH || R < 1 ||
      R > H || stages < 2 || stages > 4 || (wm != 1 && wm != 2 && wm != 4 && wm != 8))
    return (int)cudaErrorInvalidValue;
  const int bands = (H + R - 1) / R;
  if ((long long)N * bands >= (1LL << 31) || grid < 1 || grid > N * bands)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(w1) || !aligned16(w2) || !aligned16(w3) || !aligned16(b) ||
      !aligned16(out))
    return (int)cudaErrorMisalignedAddress;
  const long long bytes = smem_bytes(wm, R, W, Cm, stages);
  if (bytes > smem_limit(device)) return (int)cudaErrorInvalidValue;
  const Shape sh{H, W, Cin, Cm, R, bands, N * bands};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (wm) {
    case 1: err = launch<1>(grid, x, w1, w2, w3, b, out, sh, stages, bytes, device, s); break;
    case 2: err = launch<2>(grid, x, w1, w2, w3, b, out, sh, stages, bytes, device, s); break;
    case 4: err = launch<4>(grid, x, w1, w2, w3, b, out, sh, stages, bytes, device, s); break;
    default: err = launch<8>(grid, x, w1, w2, w3, b, out, sh, stages, bytes, device, s);
  }
  if (err == cudaSuccess) info[0] = (int)bytes;
  return (int)err;
}

// Blocks of the wm layout that one SM holds at the plan's shared memory, into *blocks: one
// (what the plan assumes), read on the card.  Returns a CUDA error code.
extern "C" int mxtt_fused_bottleneck_occupancy(int wm, int bytes, int device, int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int limit = smem_limit(device);
  switch (wm) {
    case 1: err = allow_smem<1>(device, limit); break;
    case 2: err = allow_smem<2>(device, limit); break;
    case 4: err = allow_smem<4>(device, limit); break;
    case 8: err = allow_smem<8>(device, limit); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  const void* k = wm == 1   ? (const void*)fused_bottleneck_kernel<1>
                  : wm == 2 ? (const void*)fused_bottleneck_kernel<2>
                  : wm == 4 ? (const void*)fused_bottleneck_kernel<4>
                            : (const void*)fused_bottleneck_kernel<8>;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, THREADS, bytes);
}
