// Fused LSTM recurrence, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_rnn.py:_fwd_kernel, launched by _lstm_fwd_impl
// (pallas_rnn.py:82-146).  It computes the same function, for t = 0 .. T-1:
//
//   pre[b, k*H + u] = xp[t, b, k*H + u] + sum_m h[b, m] * R[k*H + u, m] + bR[k*H + u]
//   i, f, g, o      = sigmoid(pre_i), sigmoid(pre_f), tanh(pre_g), sigmoid(pre_o)
//   c = f * c + i * g,   h = o * tanh(c)
//
// starting from h0 and c0, and writes ys[t] = h, hT, cT and the reserve the backward kernel
// (lstm_bwd.cu) reads: the post-activation gates (T, B, 4H) in [i f g o] order and the cell
// states cs (T, B, H).  Everything is fp32.  Layouts are the port's own, row-major: xp and
// gates (T, B, 4H) as the input projection x @ W^T + bW produces them, R (4H, H) as the
// packed RNN parameters hold it, ys and cs (T, B, H); the TPU kernel's (T, 4, B, H) layout
// was chosen for its lanes and does not carry over.
//
// Numerics: every product and sum in fp32 FMA on the CUDA cores (no TF32, no tensor cores),
// expf/tanhf for the activations.  Against the plain PyTorch version (lstm_fwd_plain in
// ops/hopper_rnn.py) only the order of the sums in h @ R^T differs; the tolerance that
// chip_smoke.py states is 1e-5 absolute.
//
// Design.  The TPU kernel runs the T steps as a sequential grid with h and c resident in
// VMEM.  On the H100 the recurrence is one persistent cooperative launch over all T steps:
//   - a block owns U hidden units and, from 64 rows up, one half of the batch: at H = 650
//     and B = 128, 130 blocks of 10 units and 64 rows cover the card, one a SM, and every
//     block is co-resident (the launch checks occupancy and fails rather than deadlock);
//     a block reads only its half of h each step, so the L2 traffic of the exchange halves;
//   - a thread owns two units and 4 batch rows and keeps the 4 gates' pre-activations of
//     those 32 (unit, gate, row) triples in registers, so the gate math needs no exchange
//     and each value of h it reads from shared memory serves 8 products;
//   - the block's threads form KG groups that split each stage's columns of h between
//     them (KG = 4 at H = 650: 384 threads) and add their partial sums through shared
//     memory at the end of the step, so that enough warps are in flight;
//   - the block's 4U rows of R stay in shared memory for the whole sequence when they fit
//     (40 x 704 fp32 = 110 KB at H = 650); otherwise (large H) they are
//     streamed from global memory (L2) in stages beside h;
//   - h_{t-1} lives in a global ping-pong buffer in (H, Bp) layout (Bp = B rounded up to
//     4), so a stage of KC columns of it is contiguous 16-byte copies; each step a block
//     reads its rows of all of it (166 KB at B = 128, H = 650, from L2) in stages of KC
//     columns, three stages in shared memory, copied with cp.async while earlier ones are
//     used;
//   - c_{t-1} is read back from cs[t-1], which the same thread wrote; it, the thread's
//     projections and its biases are copied to shared memory with cp.async while the
//     product runs, so the gate math waits on no load;
//   - after each step, cooperative_groups' grid sync makes h_t visible to every block.
//     The ping-pong buffer is copied with cp.async.cg (through L2, not the incoherent L1
//     or the read-only path), since other blocks write it inside the same launch.
// Batches wider than a tile (at most 128 rows) are walked in tiles.
//
// Bound at the slice's shape (T = 35, B = 128, H = 650, one layer): 2*B*H*4H FLOP a step,
// 15.14 GFLOP a call, 0.226 ms at 67 TFLOP/s fp32; about 123 MB of xp, gates, cs, ys and R,
// 37 us at 3.35 TB/s.  So it is bound by operations.  This design stays below that: a
// warp's 32 FMA instructions a column need 6 shared-memory wavefronts, every block reads
// its half of h from L2 each step (22 MB a step over the card), and each of the 35 grid
// syncs costs microseconds.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_THREADS = 512;
constexpr int MAX_ITEMS = 256;  // (unit pair, 4-row group) items of a block's tile
constexpr int MAX_TILE = 128;   // batch rows per tile
constexpr int KC = 64;          // columns of h (and of R) per shared-memory stage
constexpr int NSTAGE = 3;       // stages in shared memory

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

// Asynchronous copies global -> shared (sm_80+).  16-byte copies through L2 only (.cg), so
// they see what other blocks wrote before the last grid sync; src_bytes = 0 fills zeros.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// Wait until at most n (< 4) of this thread's copy groups are still in flight.
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  if (n >= 3)
    cp_async_wait<3>();
  else if (n == 2)
    cp_async_wait<2>();
  else if (n == 1)
    cp_async_wait<1>();
  else
    cp_async_wait<0>();
}

// Launch geometry.  U units a block (UG pairs), BR batch rows a block (the whole batch or
// half of it), 4-row groups a tile nbg = 2^lnbg, the
// UG * nbg items of a tile padded to whole warps (IP), KG groups of IP threads splitting
// each stage's columns, and the dynamic shared memory: NSTAGE stages of h [KC][BT], the
// partial sums of groups 1 .. KG-1 [KG-1][32][IP], group 0's gate inputs [48][IP], and R
// [Hp][8 UG] when resident (else NSTAGE stages [KC][8 UG]).
struct Geometry {
  int blocks, threads, U, BR, lnbg, KG, resident;
  size_t smem;
};

int plan(int B, int H, int device, Geometry* g) {
  int sms = 0, coop = 0, optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (!coop || sms < 1) return (int)cudaErrorNotSupported;
  if (B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  // a batch of 64 rows or more is split in two halves, each with its own blocks, so that a
  // block reads half of the exchanged state each step
  const int halves = B >= 64 ? 2 : 1;
  g->U = (H * halves + sms - 1) / sms;
  const int UG = (g->U + 1) / 2;
  if (UG > MAX_ITEMS) return (int)cudaErrorInvalidValue;
  g->blocks = halves * ((H + g->U - 1) / g->U);
  g->BR = ((B + halves - 1) / halves + 3) / 4 * 4;
  int nbg = 1;
  g->lnbg = 0;
  while (nbg * 4 < g->BR && nbg * 8 <= MAX_TILE && UG * nbg * 2 <= MAX_ITEMS) {
    nbg *= 2;
    ++g->lnbg;
  }
  const int IP = (UG * nbg + 31) / 32 * 32;
  g->KG = IP * 4 <= MAX_THREADS ? 4 : IP * 2 <= MAX_THREADS ? 2 : 1;
  g->threads = g->KG * IP;
  const size_t f = sizeof(float);
  const size_t hs = (size_t)NSTAGE * KC * 4 * nbg * f;
  const size_t red = (size_t)(g->KG - 1) * 32 * IP * f + (size_t)48 * IP * f;
  const size_t rw = (size_t)8 * UG;
  const size_t res = hs + red + (size_t)(H + KC - 1) / KC * KC * rw * f;
  g->resident = res <= (size_t)optin;
  g->smem = g->resident ? res : hs + red + (size_t)NSTAGE * KC * rw * f;
  if (g->smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  return 0;
}

// Column rr = 4 * ul + k of the block's R tile is gate k of unit u0 + ul (zero past nu).
template <bool R_RESIDENT>
__global__ void __launch_bounds__(MAX_THREADS)
lstm_fwd_kernel(const float* __restrict__ xp, const float* __restrict__ h0,
                const float* __restrict__ c0, const float* __restrict__ R,
                const float* __restrict__ bR, float* ys, float* gates, float* cs, float* hT,
                float* cT, float* hbuf, int T, int B, int H, int U, int BR, int lnbg, int KG) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const int nbg = 1 << lnbg;
  const int BT = 4 * nbg;
  const int UG = (U + 1) / 2;
  const int RW = 8 * UG;
  const int IP = (UG * nbg + 31) / 32 * 32;
  const int KCG = KC / KG;               // columns of a stage per thread group
  const int Bp = (B + 3) / 4 * 4;
  const int nst = (H + KC - 1) / KC;
  float* hs = smem;                                  // NSTAGE x [KC][BT]
  float* red = hs + NSTAGE * KC * BT;                // [KG-1][32][IP]
  float* xs = red + (KG - 1) * 32 * IP;              // [48][IP]: xp, bR, c_prev
  float* rs = xs + 48 * IP;                          // R, resident or streamed
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int kg = tid / IP, item = tid % IP;
  const int ug = item >> lnbg, bg = item & (nbg - 1);
  const int nut = (H + U - 1) / U;       // blocks per batch slice
  const int u0 = (blockIdx.x % nut) * U;
  const int nu = min(U, H - u0);
  const int b_lo = (blockIdx.x / nut) * BR;            // this block's batch rows
  const int b_hi = min(B, b_lo + BR);
  const int b_cap = min(Bp, b_lo + BR);                // ... rounded up to 4
  const size_t HB = (size_t)H * Bp;

  // h0 into ping-pong buffer 0, (H, Bp) layout, for this block's units and rows
  const int nb = b_hi - b_lo;
  for (int idx = tid; idx < nu * nb; idx += nthr) {
    const int uu = idx / nb, b = b_lo + idx % nb;
    hbuf[(size_t)(u0 + uu) * Bp + b] = h0[(size_t)b * H + u0 + uu];
  }
  if (R_RESIDENT) {
    const int Hp = nst * KC;
    for (int idx = tid; idx < RW * Hp; idx += nthr) {
      const int rr = idx / Hp, m = idx % Hp;
      const int uu = rr >> 2, k = rr & 3;
      float v = 0.f;
      if (uu < nu && m < H) v = R[(size_t)(k * H + u0 + uu) * H + m];
      rs[m * RW + rr] = v;
    }
  }
  grid.sync();

  for (int t = 0; t < T; ++t) {
    const float* hprev = hbuf + (size_t)(t & 1) * HB;
    float* hnext = hbuf + (size_t)((t + 1) & 1) * HB;
    for (int bt0 = b_lo; bt0 < b_hi; bt0 += BT) {
      const bool in_tile = ug < UG && bt0 + bg * 4 < b_hi;
      // stage s of h (and of R when streamed) into buffer s % NSTAGE
      auto issue = [&](int s) {
        const int m0 = s * KC;
        float* dst = hs + (s % NSTAGE) * KC * BT;
        for (int c = tid; c < KC * nbg; c += nthr) {
          const int kk = c >> lnbg, b4 = (c & (nbg - 1)) * 4;
          const bool ok = m0 + kk < H && bt0 + b4 < b_cap;
          cp_async16(dst + kk * BT + b4, ok ? hprev + (size_t)(m0 + kk) * Bp + bt0 + b4 : hprev,
                     ok ? 16 : 0);
        }
        if (!R_RESIDENT) {
          float* rdst = rs + (s % NSTAGE) * KC * RW;
          for (int idx = tid; idx < RW * KC; idx += nthr) {
            const int rr = idx / KC, kk = idx % KC;
            const int uu = rr >> 2, k = rr & 3;
            const bool ok = uu < nu && m0 + kk < H;
            cp_async4(rdst + kk * RW + rr, ok ? R + (size_t)(k * H + u0 + uu) * H + m0 + kk : R,
                      ok ? 4 : 0);
          }
        }
        cp_async_commit();
      };
      // group 0's gate inputs, copied while the product runs: for unit p of the pair,
      // gate k and row j, xp at 16 p + 4 k + j, bR at 32 + 4 p + k, c_prev at 40 + 4 p + j
      if (kg == 0 && in_tile) {
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int u = u0 + 2 * ug + p;
          const bool up = 2 * ug + p < nu;
#pragma unroll
          for (int k = 0; k < 4; ++k)
            cp_async4(xs + (32 + 4 * p + k) * IP + item, up ? bR + k * H + u : bR, up ? 4 : 0);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int b = bt0 + bg * 4 + j;
            const bool ok = up && b < b_hi;
            const size_t row = (size_t)t * B + b;
#pragma unroll
            for (int k = 0; k < 4; ++k)
              cp_async4(xs + (16 * p + 4 * k + j) * IP + item,
                        ok ? xp + row * 4 * H + k * H + u : xp, ok ? 4 : 0);
            const float* cp = t == 0 ? c0 + (size_t)b * H + u : cs + (row - B) * H + u;
            cp_async4(xs + (40 + 4 * p + j) * IP + item, ok ? cp : c0, ok ? 4 : 0);
          }
        }
      }
      // the first stage's commit covers the copies above
      for (int s = 0; s < NSTAGE - 1 && s < nst; ++s) issue(s);

      float acc[32];         // [unit of the pair][gate][row]
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] = 0.f;

      for (int s = 0; s < nst; ++s) {
        if (s + NSTAGE - 1 < nst) issue(s + NSTAGE - 1);
        cp_async_wait_pending(min(NSTAGE - 1, nst - 1 - s));
        __syncthreads();
        if (in_tile) {
          const float* hb = hs + (s % NSTAGE) * KC * BT + bg * 4;
          const float* rb = (R_RESIDENT ? rs + (size_t)s * KC * RW : rs + (s % NSTAGE) * KC * RW)
                            + ug * 8;
#pragma unroll 4
          for (int kk = kg * KCG; kk < (kg + 1) * KCG; ++kk) {
            const float4 hv = *reinterpret_cast<const float4*>(hb + kk * BT);
            const float4 ra = *reinterpret_cast<const float4*>(rb + kk * RW);
            const float4 rc = *reinterpret_cast<const float4*>(rb + kk * RW + 4);
            const float hh[4] = {hv.x, hv.y, hv.z, hv.w};
            const float rr[8] = {ra.x, ra.y, ra.z, ra.w, rc.x, rc.y, rc.z, rc.w};
#pragma unroll
            for (int pk = 0; pk < 8; ++pk)
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[pk * 4 + j] = fmaf(rr[pk], hh[j], acc[pk * 4 + j]);
          }
        }
        __syncthreads();     // buffer s % NSTAGE is refilled by stage s + NSTAGE
      }

      // the groups' partial sums meet in group 0
      if (kg > 0) {
        float* dst = red + (size_t)(kg - 1) * 32 * IP + item;
#pragma unroll
        for (int e = 0; e < 32; ++e) dst[e * IP] = acc[e];
      }
      __syncthreads();
      if (kg == 0 && in_tile) {
        for (int g2 = 1; g2 < KG; ++g2) {
          const float* src = red + (size_t)(g2 - 1) * 32 * IP + item;
#pragma unroll
          for (int e = 0; e < 32; ++e) acc[e] += src[e * IP];
        }
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int u = u0 + 2 * ug + p;
          if (2 * ug + p >= nu) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int b = bt0 + bg * 4 + j;
            if (b >= b_hi) continue;
            const size_t row = (size_t)t * B + b;
            // gate k of unit 2 ug + p, row j: acc[16 p + 4 k + j] + xp + bR
            float pre[4];
#pragma unroll
            for (int k = 0; k < 4; ++k)
              pre[k] = acc[p * 16 + 4 * k + j] + xs[(16 * p + 4 * k + j) * IP + item]
                       + xs[(32 + 4 * p + k) * IP + item];
            const float ig = sigmoid_f(pre[0]), fg = sigmoid_f(pre[1]);
            const float gg = tanhf(pre[2]), og = sigmoid_f(pre[3]);
            const float c = fg * xs[(40 + 4 * p + j) * IP + item] + ig * gg;
            const float h = og * tanhf(c);
            float* gr = gates + row * 4 * H;
            gr[u] = ig;
            gr[H + u] = fg;
            gr[2 * H + u] = gg;
            gr[3 * H + u] = og;
            cs[row * H + u] = c;
            ys[row * H + u] = h;
            hnext[(size_t)u * Bp + b] = h;
            if (t == T - 1) {
              hT[(size_t)b * H + u] = h;
              cT[(size_t)b * H + u] = c;
            }
          }
        }
      }
      __syncthreads();       // red is written again by the next tile
    }
    grid.sync();
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  xp (T, B, 4H), h0 (B, H), c0 (B, H), R (4H, H),
// bR (4H); outputs ys (T, B, H), gates (T, B, 4H), cs (T, B, H), hT (B, H), cT (B, H);
// scratch hbuf (2, H, Bp), Bp = B rounded up to a multiple of 4.  All fp32, contiguous, on
// `device`.  Launches the kernel once, as a cooperative launch on `stream`, and sets
// *launched to 1 when it did.  Returns 0, or the CUDA error: cudaErrorInvalidValue for an
// empty or unsupported shape, cudaErrorCooperativeLaunchTooLarge when the grid cannot be
// co-resident.
extern "C" int mxtt_lstm_fwd(const float* xp, const float* h0, const float* c0, const float* R,
                             const float* bR, float* ys, float* gates, float* cs, float* hT,
                             float* cT, float* hbuf, int T, int B, int H, int device,
                             void* stream, int* launched) {
  *launched = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (T < 1) return (int)cudaErrorInvalidValue;
  Geometry g;
  int rc = plan(B, H, device, &g);
  if (rc != 0) return rc;
  const void* kern = g.resident ? (const void*)lstm_fwd_kernel<true>
                                : (const void*)lstm_fwd_kernel<false>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)g.smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, g.threads, g.smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm * sms < g.blocks) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {(void*)&xp,   (void*)&h0, (void*)&c0, (void*)&R,  (void*)&bR,
                  (void*)&ys,   (void*)&gates, (void*)&cs, (void*)&hT, (void*)&cT,
                  (void*)&hbuf, (void*)&T,  (void*)&B,  (void*)&H,  (void*)&g.U,
                  (void*)&g.BR,  (void*)&g.lnbg, (void*)&g.KG};
  err = cudaLaunchCooperativeKernel(kern, dim3(g.blocks), dim3(g.threads), args, g.smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err == cudaSuccess) *launched = 1;
  return (int)err;
}

// The launch geometry of mxtt_lstm_fwd at (B, H), for reports: out[0..6] = blocks, threads,
// units per block, batch rows per block, batch rows per tile, dynamic shared memory bytes,
// R resident (0 or 1).
extern "C" int mxtt_lstm_fwd_geometry(int B, int H, int device, int* out) {
  Geometry g;
  int rc = plan(B, H, device, &g);
  if (rc != 0) return rc;
  out[0] = g.blocks;
  out[1] = g.threads;
  out[2] = g.U;
  out[3] = g.BR;
  out[4] = 4 << g.lnbg;
  out[5] = (int)g.smem;
  out[6] = g.resident;
  return 0;
}
