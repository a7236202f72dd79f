// Fused LSTM recurrence, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_rnn.py:_bwd_kernel, launched by _lstm_vjp_bwd
// (pallas_rnn.py:157-275).  It computes the same function, for t = T-1 down to 0, from the
// reserve that lstm_fwd.cu wrote (post-activation gates i, f, g, o and cell states cs):
//
//   dh     = dh_next + dys[t]                      (dh_next = dhT at t = T-1)
//   dct    = dh * o * (1 - tanh(c_t)^2) + dc_next  (dc_next = dcT at t = T-1)
//   d_pre  = [dct*g*i*(1-i), dct*c_{t-1}*f*(1-f), dct*i*(1-g^2), dh*tanh(c_t)*o*(1-o)]
//   dxp[t] = d_pre,   dc_next = dct * f,   dh_next[b, m] = sum_r d_pre[b, r] * R[r, m]
//
// with c_{-1} = c0, and returns dh0 = dh_next and dc0 = dc_next after t = 0.  dR and dbR are
// not reduced here: the caller computes them from dxp with two large products, as the TPU
// version does outside its kernel (pallas_rnn.py:260-275).  Everything is fp32; layouts as
// in lstm_fwd.cu: gates and dxp (T, B, 4H) in [i f g o] order, cs and dys (T, B, H),
// R (4H, H), c0, dhT, dcT, dh0 and dc0 (B, H).
//
// Numerics: fp32 FMA on the CUDA cores, tanhf for tanh(c_t).  Against the plain PyTorch
// version (lstm_bwd_plain in ops/hopper_rnn.py) only the order of the sums in d_pre @ R
// differs; the tolerance chip_smoke.py states is 1e-4 of the largest |value|.
//
// Design.  The TPU kernel walks a reversed sequential grid with dh and dc in VMEM.  Here,
// as in the forward, one persistent cooperative launch covers all T steps, a block owning
// U hidden units and (from 64 rows up) one half of the batch, a thread two units and 4
// batch rows.  Each step has two phases with a grid sync between them:
//   (a) elementwise: each thread turns its (unit, row) pairs into the four d_pre values,
//       writes them to dxp[t] and, transposed to (4H, Bp), to one of two scratch
//       buffers (the steps alternate, so that no second grid sync is needed before the
//       next step writes), and keeps dc;
//   (b) the product: dh_next for the block's units and rows needs every d_pre column of
//       those rows, so after the sync each block streams its rows of the (4H, Bp) scratch
//       (666 KB at B = 128, H = 650) through shared memory in stages of KC rows, four
//       stages deep, copied with cp.async.cg (through L2, since other blocks wrote it in
//       this launch), against the block's columns of R, 4H x U, resident in shared memory
//       for the whole sequence when they fit (2,624 x 10 fp32, 102 KB at H = 650), streamed
//       from global memory otherwise.  The block's threads form KG groups that split each
//       stage's rows and add their partial sums through shared memory, as in the forward.
// The running dh and dc live in the dh0 and dc0 outputs, each element read and written by
// one thread only, so they need no exchange; their final values are dh0 and dc0.
//
// Bound at the slice's shape (T = 35, B = 128, H = 650): 15.14 GFLOP a call, 0.226 ms at
// 67 TFLOP/s fp32, about 128 MB of traffic (37 us), so bound by operations.  Phase (b)'s
// thread tile is 2 units x 4 rows, so a warp's 8 FMA instructions a row of d_pre need 3
// to 5 shared-memory wavefronts; every block reads its rows of d_pre from L2 each step (87
// MB a step over the card); and each step has a grid sync.  It runs well below the
// bound in this design.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_THREADS = 512;
constexpr int MAX_ITEMS = 256;  // (unit pair, 4-row group) items of a block's tile
constexpr int MAX_TILE = 128;   // batch rows per tile
constexpr int KC = 64;          // rows of d_pre (and of R) per shared-memory stage
constexpr int NSTAGE = 4;       // stages in shared memory

// Asynchronous copies global -> shared, as in lstm_fwd.cu: 16 bytes through L2 only (.cg),
// or 4 bytes; src_bytes = 0 fills zeros.
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

// Launch geometry, as in lstm_fwd.cu: U units a block (UG pairs), BR batch rows a block,
// nbg = 2^lnbg 4-row
// groups a tile, items padded to IP, KG thread groups; the dynamic shared memory holds
// NSTAGE stages of d_pre^T [KC][BT], the partial sums of groups 1 .. KG-1 [KG-1][8][IP],
// and the block's columns of R, [Rp][2 UG] when resident (else NSTAGE stages [KC][2 UG]).
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
  const size_t ds = (size_t)NSTAGE * KC * 4 * nbg * f;
  const size_t red = (size_t)(g->KG - 1) * 8 * IP * f;
  const size_t rw = (size_t)2 * UG;
  const size_t res = ds + red + (size_t)(4 * H + KC - 1) / KC * KC * rw * f;
  g->resident = res <= (size_t)optin;
  g->smem = g->resident ? res : ds + red + (size_t)NSTAGE * KC * rw * f;
  if (g->smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  return 0;
}

// dpreT is (2, 4H, Bp), Bp = B rounded up to 4: step t uses buffer t & 1.  Column ul of
// the block's R tile is unit u0 + ul (zero past nu).  A thread owns units 2 ug and 2 ug + 1
// and 4 rows in both phases; group 0 does the elementwise phase and holds the product's
// sums.
template <bool R_RESIDENT>
__global__ void __launch_bounds__(MAX_THREADS)
lstm_bwd_kernel(const float* __restrict__ gates, const float* __restrict__ cs,
                const float* __restrict__ c0, const float* __restrict__ dys,
                const float* __restrict__ dhT, const float* __restrict__ dcT,
                const float* __restrict__ R, float* dxp, float* dh0, float* dc0, float* dpreT,
                int T, int B, int H, int U, int BR, int lnbg, int KG) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const int nbg = 1 << lnbg;
  const int BT = 4 * nbg;
  const int H4 = 4 * H;
  const int UG = (U + 1) / 2;
  const int RW = 2 * UG;
  const int IP = (UG * nbg + 31) / 32 * 32;
  const int KCG = KC / KG;
  const int Bp = (B + 3) / 4 * 4;
  const int nst = (H4 + KC - 1) / KC;
  float* ds = smem;                                  // NSTAGE x [KC][BT]
  float* red = ds + NSTAGE * KC * BT;                // [KG-1][8][IP]
  float* rs = red + (KG - 1) * 8 * IP;               // R columns, resident or streamed
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

  if (R_RESIDENT) {
    const int Rp = nst * KC;
    for (int idx = tid; idx < Rp * RW; idx += nthr) {
      const int r = idx / RW, uu = idx % RW;
      rs[idx] = (r < H4 && uu < nu) ? R[(size_t)r * H + u0 + uu] : 0.f;
    }
    __syncthreads();
  }

  for (int t = T - 1; t >= 0; --t) {
    // d_pre^T of this step; the other buffer may still be read by a block in phase (b) of
    // the step before, so each step needs one grid sync only
    float* dpre_w = dpreT + (size_t)(t & 1) * H4 * Bp;
    // (a) elementwise: d_pre for this thread's units and rows; every load first, so that
    // their latencies overlap
    for (int bt0 = b_lo; bt0 < b_hi; bt0 += BT) {
      if (kg != 0 || ug >= UG || bt0 + bg * 4 >= b_hi) continue;
      float v[2][4][9];      // [unit][row]: i, f, g, o, c_t, c_{t-1}, dh_next, dc_next, dys
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int u = min(u0 + 2 * ug + p, u0 + nu - 1);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int b = min(bt0 + bg * 4 + j, b_hi - 1);
          const size_t row = (size_t)t * B + b;
          const size_t bu = (size_t)b * H + u;
          const float* gr = gates + row * H4;
          v[p][j][0] = gr[u];
          v[p][j][1] = gr[H + u];
          v[p][j][2] = gr[2 * H + u];
          v[p][j][3] = gr[3 * H + u];
          v[p][j][4] = cs[row * H + u];
          v[p][j][5] = t > 0 ? cs[(row - B) * H + u] : c0[bu];
          v[p][j][6] = t == T - 1 ? dhT[bu] : dh0[bu];
          v[p][j][7] = t == T - 1 ? dcT[bu] : dc0[bu];
          v[p][j][8] = dys[row * H + u];
        }
      }
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        if (2 * ug + p >= nu) continue;
        const int u = u0 + 2 * ug + p;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int b = bt0 + bg * 4 + j;
          if (b >= b_hi) continue;
          const float* x = v[p][j];
          const float i = x[0], f = x[1], g = x[2], o = x[3];
          const float tc = tanhf(x[4]);
          const float dh = x[6] + x[8];
          const float dct = dh * o * (1.f - tc * tc) + x[7];
          const float dp[4] = {(dct * g) * i * (1.f - i), (dct * x[5]) * f * (1.f - f),
                               (dct * i) * (1.f - g * g), (dh * tc) * o * (1.f - o)};
          const size_t row = (size_t)t * B + b;
          float* dr = dxp + row * H4;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            dr[k * H + u] = dp[k];
            dpre_w[(size_t)(k * H + u) * Bp + b] = dp[k];
          }
          dc0[(size_t)b * H + u] = dct * f;
        }
      }
    }
    grid.sync();

    // (b) dh_next[b, u] = sum_r d_pre[b, r] * R[r, u] for this block's units
    for (int bt0 = b_lo; bt0 < b_hi; bt0 += BT) {
      const bool in_tile = ug < UG && bt0 + bg * 4 < b_hi;
      auto issue = [&](int s) {
        const int r0 = s * KC;
        float* dst = ds + (s % NSTAGE) * KC * BT;
        for (int c = tid; c < KC * nbg; c += nthr) {
          const int kk = c >> lnbg, b4 = (c & (nbg - 1)) * 4;
          const bool ok = r0 + kk < H4 && bt0 + b4 < b_cap;
          cp_async16(dst + kk * BT + b4, ok ? dpre_w + (size_t)(r0 + kk) * Bp + bt0 + b4 : dpre_w,
                     ok ? 16 : 0);
        }
        if (!R_RESIDENT) {
          float* rdst = rs + (s % NSTAGE) * KC * RW;
          for (int idx = tid; idx < KC * RW; idx += nthr) {
            const int kk = idx / RW, uu = idx % RW;
            const bool ok = r0 + kk < H4 && uu < nu;
            cp_async4(rdst + idx, ok ? R + (size_t)(r0 + kk) * H + u0 + uu : R, ok ? 4 : 0);
          }
        }
        cp_async_commit();
      };
      for (int s = 0; s < NSTAGE - 1 && s < nst; ++s) issue(s);
      float acc[8];          // [unit of the pair][row]
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = 0.f;
      for (int s = 0; s < nst; ++s) {
        if (s + NSTAGE - 1 < nst) issue(s + NSTAGE - 1);
        cp_async_wait_pending(min(NSTAGE - 1, nst - 1 - s));
        __syncthreads();
        if (in_tile) {
          const float* db = ds + (s % NSTAGE) * KC * BT + bg * 4;
          const float* rb = (R_RESIDENT ? rs + (size_t)s * KC * RW : rs + (s % NSTAGE) * KC * RW)
                            + ug * 2;
#pragma unroll 4
          for (int kk = kg * KCG; kk < (kg + 1) * KCG; ++kk) {
            const float4 dv = *reinterpret_cast<const float4*>(db + kk * BT);
            const float2 rv = *reinterpret_cast<const float2*>(rb + kk * RW);
            const float d4[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              acc[j] = fmaf(d4[j], rv.x, acc[j]);
              acc[4 + j] = fmaf(d4[j], rv.y, acc[4 + j]);
            }
          }
        }
        __syncthreads();     // buffer s % NSTAGE is refilled by stage s + NSTAGE
      }
      if (kg > 0) {
        float* dst = red + (size_t)(kg - 1) * 8 * IP + item;
#pragma unroll
        for (int e = 0; e < 8; ++e) dst[e * IP] = acc[e];
      }
      __syncthreads();
      if (kg == 0 && in_tile) {
        for (int g2 = 1; g2 < KG; ++g2) {
          const float* src = red + (size_t)(g2 - 1) * 8 * IP + item;
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[e] += src[e * IP];
        }
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          if (2 * ug + p >= nu) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int b = bt0 + bg * 4 + j;
            if (b < b_hi) dh0[(size_t)b * H + u0 + 2 * ug + p] = acc[p * 4 + j];
          }
        }
      }
      __syncthreads();       // red is written again by the next tile
    }
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  gates (T, B, 4H), cs (T, B, H), c0 (B, H), dys
// (T, B, H), dhT (B, H), dcT (B, H), R (4H, H); outputs dxp (T, B, 4H), dh0 (B, H), dc0
// (B, H); scratch dpreT (2, 4H, Bp), Bp = B rounded up to a multiple of 4.  All fp32, contiguous, on `device`.  Launches the kernel
// once, as a cooperative launch on `stream`, and sets *launched to 1 when it did.  Returns
// 0 or the CUDA error, as mxtt_lstm_fwd does.
extern "C" int mxtt_lstm_bwd(const float* gates, const float* cs, const float* c0,
                             const float* dys, const float* dhT, const float* dcT,
                             const float* R, float* dxp, float* dh0, float* dc0, float* dpreT,
                             int T, int B, int H, int device, void* stream, int* launched) {
  *launched = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (T < 1) return (int)cudaErrorInvalidValue;
  Geometry g;
  int rc = plan(B, H, device, &g);
  if (rc != 0) return rc;
  const void* kern = g.resident ? (const void*)lstm_bwd_kernel<true>
                                : (const void*)lstm_bwd_kernel<false>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)g.smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, g.threads, g.smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm * sms < g.blocks) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {(void*)&gates, (void*)&cs,  (void*)&c0,  (void*)&dys, (void*)&dhT,
                  (void*)&dcT,   (void*)&R,   (void*)&dxp, (void*)&dh0, (void*)&dc0,
                  (void*)&dpreT, (void*)&T,   (void*)&B,   (void*)&H,   (void*)&g.U,
                  (void*)&g.BR,  (void*)&g.lnbg, (void*)&g.KG};
  err = cudaLaunchCooperativeKernel(kern, dim3(g.blocks), dim3(g.threads), args, g.smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err == cudaSuccess) *launched = 1;
  return (int)err;
}

// The launch geometry of mxtt_lstm_bwd at (B, H), as mxtt_lstm_fwd_geometry reports it.
extern "C" int mxtt_lstm_bwd_geometry(int B, int H, int device, int* out) {
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
