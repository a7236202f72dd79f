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
// differs; the tolerance chip_smoke.py states is 1e-4 of the largest |value|.  Every sum
// runs in a fixed order, so reruns are bit-equal.
//
// Design.  The TPU kernel walks a reversed sequential grid with dh and dc in VMEM.  Here, as
// in the forward, one persistent cooperative launch covers all T steps, on the plan
// hopper_rnn.lstm_plan("bwd", ...) computes.  dh_next needs every one of the 4H columns of
// d_pre for its rows; had each block (as in the forward) owned 10 units and read all of
// them, the blocks would read 87 MB a step from L2 at B = 128, H = 650.  Instead the
// product is split over the four gates, the reduction's four quarters:
//   - a group of four blocks owns U units of one batch half (U = 41 at the LM's shape: 16
//     groups a half, 128 blocks); block q of the group keeps gate q's rows of R for those
//     units, R[q H : q H + H, units] (650 x 41, 112 KB with padding), resident in shared
//     memory, and multiplies gate q's d_pre (B_half x H, read from a (4H, Bp) exchange
//     buffer in stages, as the forward reads h) by it: lstm_common.cuh's lstm_product with
//     8-row x 4-column register tiles, a warp across the tiles' columns, KG = 7 groups of 88
//     threads (640 threads, 96 registers each); so each block reads 166 KB of d_pre a step,
//     22 MB over the card, as the forward does;
//   - its partial dh_next (rows x U) goes to a small global buffer, and after the group's
//     four blocks have written theirs (a 4-block barrier, lstm_common.cuh), each block adds
//     the four in gate order for its quarter of the group's units and all the half's rows:
//     the elementwise phase, which every thread runs (a (unit, row) pair a thread) and
//     whose inputs, the forward's gates and cell states and dys, were copied to shared
//     memory with cp.async with the last stage of the previous step's product; dc stays
//     in a register;
//   - d_pre goes to dxp and, transposed through shared memory, to the exchange buffer (rows
//     contiguous); a barrier among the half's blocks then opens the next product.  The
//     exchange buffer alternates between two copies from step to step, so that a block
//     still in the previous step's product is never overwritten; the partials' buffer needs
//     one copy, since the half's barrier lies between its reads and the next writes.
// So each step has two barriers, a 4-block one and the half's, and no grid sync.
//
// Bound at the slice's shape (T = 35, B = 128, H = 650): 15.14 GFLOP a call, 0.226 ms at
// 67 TFLOP/s fp32, about 128 MB of traffic (37 us), so bound by operations.  What keeps it
// above: the product's FMA issue (as in the forward, with the 41 units a block padded to
// 44 columns and 650 rows to 672), and a serial tail each step: the partials' exchange,
// the elementwise phase, the exchange of d_pre and two barriers.

#include <string.h>

#include "lstm_common.cuh"

namespace {

template <bool RES>
__global__ void __launch_bounds__(lstm_max_threads(false), 1)
lstm_bwd_kernel(const float* __restrict__ gates, const float* __restrict__ cs,
                const float* __restrict__ c0, const float* __restrict__ dys,
                const float* __restrict__ dhT, const float* __restrict__ dcT,
                const float* __restrict__ R, float* dxp, float* dh0, float* dc0, float* dpreT,
                float* part, unsigned* ctr, int T, int B, int H, LstmPlan p) {
  extern __shared__ __align__(16) float smem[];
  const LstmDims d = lstm_dims(p, H, false);
  const int U = p.units, BT = p.tile, KG = p.kg, RC = p.chunk;
  const int H4 = 4 * H, Bp = (B + 3) / 4 * 4;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int per_half = p.groups * 4;
  const int half = blockIdx.x / per_half, grp = (blockIdx.x % per_half) / 4, q = blockIdx.x % 4;
  const int u0 = grp * U, nu = min(U, H - u0);
  const int b_lo = half * p.rows, b_hi = min(B, b_lo + p.rows), nb = b_hi - b_lo;
  const int rcap = min(Bp, b_lo + p.rows);
  const int ntiles = (nb + BT - 1) / BT;
  // the elementwise phase: this block's units uq0 .. uq0 + nuq - 1 of the group, all rows
  const int Uq = (U + 3) / 4, uq0 = q * Uq, nuq = max(0, min(Uq, nu - uq0));
  const int nchunks = (nb + RC - 1) / RC;
  const bool one_chunk = nchunks == 1;
  const int RP = RC + 1, XSP = lstm_odd(Uq), RSZ = Uq * RP;

  float* wres = smem;                                  // R[qH + m][u0 + c]: [Kp][NCP]
  float* as = wres + (RES ? d.Kp * d.NCP : 0);         // the stage region
  float* wst = as + LSTM_NS * d.KC * BT;
  float* red = as;
  float* sdx = as;                                     // [4][RC][XSP]: d_pre for dxp
  float* sdp = sdx + lstm_r4(4 * RC * XSP);            // [4][Uq][RP]: d_pre for d_pre^T
  const int region = lstm_max(lstm_max(lstm_stage_floats(p, d), KG * d.NCP * d.BTP),
                              lstm_r4(4 * RC * XSP) + lstm_r4(4 * Uq * RP));
  float* rsv = as + region;                            // [7][Uq][RP]: i f g o c_t c_{t-1} dys
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lstm_smem_floats(p, H, false) -
                                               LSTM_RING_FLOATS);

  const int kg = tid / d.items, item = tid - kg * d.items;
  const int cg = item % d.NCG, rg = item / d.NCG;     // a warp spans the columns
  const bool active = kg < KG;
  unsigned* hctr = ctr + half;                         // the half's barrier
  unsigned* gctr = ctr + p.halves + half * p.groups + grp;   // the group's
  // partial dh_next of block (half, grp, j): [U][p.rows], rows contiguous
  auto part_of = [&](int j) {
    return part + ((size_t)(half * p.groups + grp) * 4 + j) * U * p.rows;
  };

  auto load_w = [&](float* dst, int m0) {
    lstm_for3(1, d.KC, d.NCP, [&](int, int kk, int c) {
      const bool ok = c < nu && m0 + kk < H;
      cp_async4(smem_addr(dst + kk * d.NCP + c),
                ok ? R + (size_t)(q * H + m0 + kk) * H + u0 + c : R, ok);
    });
  };
  if (RES) {
    for (int idx = tid; idx < d.Kp * d.NCP; idx += nthr) {
      const int m = idx / d.NCP, c = idx - m * d.NCP;
      wres[idx] = c < nu && m < H ? R[(size_t)(q * H + m) * H + u0 + c] : 0.f;
    }
  }
  if (blockIdx.x == 0)
    for (int i = tid; i < p.halves * (1 + p.groups); i += nthr) ctr[i] = 0u;
  // pair e = tid + i * nthr of a chunk of nbc rows is row e % nbc of unit uq0 + e / nbc:
  // with one chunk, row pb[i] of unit uq0 + pu[i] for the whole sequence
  float dcr[LSTM_MAXPP];
  int pb[LSTM_MAXPP], pu[LSTM_MAXPP];
#pragma unroll
  for (int i = 0; i < LSTM_MAXPP; ++i) {
    const int e = tid + i * nthr;
    pb[i] = e % nb;
    pu[i] = e / nb;
    dcr[i] = one_chunk && pu[i] < nuq ? dcT[(size_t)(b_lo + pb[i]) * H + u0 + uq0 + pu[i]] : 0.f;
  }
  // the reserve of step t, chunk ch into rsv (a warp reads runs of nuq units)
  auto fetch_r = [&](int t, int ch) {
    const int r0 = b_lo + ch * RC, nbc = min(RC, b_hi - r0);
    lstm_for3(7, nbc, nuq, [&](int v, int b, int ul) {
      const size_t row = (size_t)t * B + r0 + b;
      const int u = u0 + uq0 + ul;
      const float* src = v < 4 ? gates + row * H4 + v * H + u
                         : v == 4 ? cs + row * H + u
                         : v == 5 ? (t > 0 ? cs + (row - B) * H + u : c0 + (size_t)(r0 + b) * H + u)
                                  : dys + row * H + u;
      cp_async4(smem_addr(rsv + v * RSZ + ul * RP + b), src, true);
    });
  };
  fetch_r(T - 1, 0);
  cp_async_commit();
  lstm_ring_init(bars);
  int issued = 0;                      // stages through the ring so far
  cooperative_groups::this_grid().sync();

  for (int t = T - 1; t >= 0; --t) {
    float* dpw = dpreT + (size_t)(t & 1) * H4 * Bp;
    // dh_next of step t + 1: the group's four partials
    if (t < T - 1) lstm_wait(gctr, 4u * (unsigned)(T - 1 - t));
    for (int ch = 0; ch < nchunks; ++ch) {
      const int r0 = b_lo + ch * RC, nbc = min(RC, b_hi - r0);
      if (ch > 0) {
        fetch_r(t, ch);
        cp_async_commit();
      }
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll
      for (int i = 0; i < LSTM_MAXPP; ++i) {
        const int e = tid + i * nthr;
        const int b = one_chunk ? pb[i] : e % nbc, ul = one_chunk ? pu[i] : e / nbc;
        if (ul >= nuq) continue;
        const int bb = r0 + b, u = u0 + uq0 + ul, s = ul * RP + b;
        float dh;
        if (t == T - 1) {
          dh = dhT[(size_t)bb * H + u];
        } else {
          const size_t off = (size_t)(uq0 + ul) * p.rows + bb - b_lo;
          dh = __ldcg(part_of(0) + off);
#pragma unroll
          for (int j = 1; j < 4; ++j) dh += __ldcg(part_of(j) + off);
        }
        dh += rsv[6 * RSZ + s];
        const float ig = rsv[s], fg = rsv[RSZ + s], gg = rsv[2 * RSZ + s], og = rsv[3 * RSZ + s];
        const float tc = tanhf(rsv[4 * RSZ + s]);
        const float dc = one_chunk ? dcr[i] : t == T - 1 ? dcT[(size_t)bb * H + u]
                                                         : dc0[(size_t)bb * H + u];
        const float dct = dh * og * (1.f - tc * tc) + dc;
        const float dp[4] = {(dct * gg) * ig * (1.f - ig),
                             (dct * rsv[5 * RSZ + s]) * fg * (1.f - fg),
                             (dct * ig) * (1.f - gg * gg), (dh * tc) * og * (1.f - og)};
        if (one_chunk)
          dcr[i] = dct * fg;
        else
          dc0[(size_t)bb * H + u] = dct * fg;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          sdx[(k * RC + b) * XSP + ul] = dp[k];
          sdp[(k * Uq + ul) * RP + b] = dp[k];
        }
      }
      __syncthreads();
      // d_pre^T of the chunk, rows contiguous
      lstm_for3(4, nuq, nbc, [&](int k, int ul, int b) {
        dpw[(size_t)(k * H + u0 + uq0 + ul) * Bp + r0 + b] = sdp[(k * Uq + ul) * RP + b];
      });
      // every chunk's d_pre^T is out: the half's products may start
      if (ch == nchunks - 1) lstm_signal(hctr);
      lstm_for3(4, nbc, nuq, [&](int k, int b, int ul) {
        dxp[((size_t)t * B + r0 + b) * H4 + k * H + u0 + uq0 + ul] = sdx[(k * RC + b) * XSP + ul];
      });
      __syncthreads();                 // the staging is free; so is rsv
    }
    lstm_wait(hctr, (unsigned)(per_half * (T - t)));     // the half's d_pre of step t
    const float* A = dpw + (size_t)q * H * Bp;
    for (int tl = 0; tl < ntiles; ++tl) {
      const int r0 = b_lo + tl * BT, nbt = min(BT, b_hi - r0);
      float acc[8][4];
      // the next step's reserve comes with the last tile's last stage
      lstm_product<8, 4, RES>(acc, A, Bp, r0, rcap, H, as, wres, wst, d, BT, p.sc, kg, rg, cg,
                              active, bars, issued, load_w, [] {},
                              [&] {
                                if (t > 0 && tl == ntiles - 1) fetch_r(t - 1, 0);
                              });
      __syncthreads();
      if (active) lstm_store_partials<8, 4>(acc, red, d, kg, rg, cg);
      __syncthreads();
      float* mine = part_of(q);
      lstm_for3(1, nu, nbt, [&](int, int ul, int b) {
        mine[(size_t)ul * p.rows + r0 - b_lo + b] = lstm_sum_partials(red, d, KG, ul, b);
      });
      if (tl == ntiles - 1)
        lstm_signal(gctr);             // the group may add this step's partials
      else
        __syncthreads();               // red is the next tile's stage region
    }
  }
  // dh0 = dh_next after step 0, dc0 = dc_next
  lstm_wait(gctr, 4u * (unsigned)T);
  lstm_for3(1, nuq, nb, [&](int, int ul, int b) {
    const size_t off = (size_t)(uq0 + ul) * p.rows + b;
    float dh = __ldcg(part_of(0) + off);
#pragma unroll
    for (int j = 1; j < 4; ++j) dh += __ldcg(part_of(j) + off);
    dh0[(size_t)(b_lo + b) * H + u0 + uq0 + ul] = dh;
  });
  if (one_chunk) {
#pragma unroll
    for (int i = 0; i < LSTM_MAXPP; ++i)
      if (pu[i] < nuq) dc0[(size_t)(b_lo + pb[i]) * H + u0 + uq0 + pu[i]] = dcr[i];
  }
}

// the kernel of the plan's residency, its shared memory attribute set once a device
template <bool RES>
cudaError_t ready(int device, int optin, const void** kern) {
  static bool done[64];
  *kern = (const void*)lstm_bwd_kernel<RES>;
  return lstm_allow_smem(*kern, device, done, optin);
}
cudaError_t select_kernel(const LstmPlan& p, int device, int optin, const void** kern) {
  return p.resident ? ready<true>(device, optin, kern) : ready<false>(device, optin, kern);
}

}  // namespace

// Plain C entry point, bound with ctypes.  gates (T, B, 4H), cs (T, B, H), c0 (B, H), dys
// (T, B, H), dhT (B, H), dcT (B, H), R (4H, H); outputs dxp (T, B, 4H), dh0 (B, H), dc0
// (B, H); scratch dpreT (2, 4H, Bp), Bp = B rounded up to a multiple of 4, part (halves *
// groups * 4 * units * rows of the plan) and ctr (halves * (1 + groups) unsigned counters).
// All fp32, contiguous, on `device`; `plan` points to the 12 ints of
// hopper_rnn.lstm_plan("bwd", B, H, ...).  Launches the kernel once, as a cooperative launch
// on `stream`, and sets *launched to 1 when it did.  Returns 0 or the CUDA error, as
// mxtt_lstm_fwd does.
extern "C" int mxtt_lstm_bwd(const float* gates, const float* cs, const float* c0,
                             const float* dys, const float* dhT, const float* dcT,
                             const float* R, float* dxp, float* dh0, float* dc0, float* dpreT,
                             float* part, unsigned* ctr, int T, int B, int H, const int* plan,
                             int device, void* stream, int* launched) {
  *launched = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int sms = 0, optin = 0;
  if ((err = lstm_card(device, &sms, &optin)) != cudaSuccess) return (int)err;
  LstmPlan p;
  memcpy(&p, plan, sizeof(p));
  if (T < 1) return (int)cudaErrorInvalidValue;
  int rc = lstm_check_plan(p, B, H, false, sms, optin);
  if (rc != 0) return rc;
  const void* kern = nullptr;
  err = select_kernel(p, device, optin, &kern);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&gates, (void*)&cs,    (void*)&c0,   (void*)&dys, (void*)&dhT,
                  (void*)&dcT,   (void*)&R,     (void*)&dxp,  (void*)&dh0, (void*)&dc0,
                  (void*)&dpreT, (void*)&part,  (void*)&ctr,  (void*)&T,   (void*)&B,
                  (void*)&H,     (void*)&p};
  err = cudaLaunchCooperativeKernel(kern, dim3(p.halves * p.groups * 4), dim3(p.threads), args,
                                    p.smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err == cudaSuccess) *launched = 1;
  return (int)err;
}

// Blocks an SM can hold of the kernel the plan selects, as mxtt_lstm_fwd_occupancy reports.
extern "C" int mxtt_lstm_bwd_occupancy(const int* plan, int device, int* per_sm) {
  LstmPlan p;
  memcpy(&p, plan, sizeof(p));
  int sms = 0, optin = 0;
  cudaError_t err = lstm_card(device, &sms, &optin);
  if (err != cudaSuccess) return (int)err;
  const void* kern = nullptr;
  err = select_kernel(p, device, optin, &kern);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kern, p.threads, p.smem);
}
