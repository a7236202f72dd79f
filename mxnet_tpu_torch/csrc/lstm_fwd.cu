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
// ops/hopper_rnn.py) only the order of the sums differs; the tolerance chip_smoke.py states
// is 1e-5 absolute.  The partial sums are added in a fixed order, so reruns are bit-equal.
//
// Design.  The TPU kernel runs the T steps as a sequential grid with h and c resident in
// VMEM.  On the H100 the recurrence is one persistent cooperative launch over all T steps,
// on the launch plan hopper_rnn.lstm_plan computes (lstm_common.cuh checks it):
//   - a block owns U hidden units (its 4U gate columns of R) and, from 64 rows up, one half
//     of the batch: at H = 650 and B = 128, 130 blocks of 10 units and 64 rows cover the
//     card, one an SM; the two halves are independent recurrences, so each step ends with a
//     barrier among the 65 blocks of a half only (a counter in global memory, lstm_common.cuh),
//     not a grid sync;
//   - the step's product, h_{t-1} (B_half x H) times the block's R slice (H x 40), runs on
//     lstm_common.cuh's lstm_product: R resident in shared memory for the whole sequence
//     when it fits (672 x 40 fp32, 105 KB at H = 650), h_{t-1} from a global ping-pong
//     buffer in (H, Bp) layout in stages of KG * SC columns, three deep; a thread keeps a
//     4-row x 8-column register tile (32 FMAs for three 16-byte shared-memory loads), and
//     KG = 6 groups of 80 threads split each stage's columns: 480 threads with 128
//     registers each (at 640 threads the cap of 96 spilled, and ran slower);
//   - every thread finishes the step: the groups' partial sums meet in shared memory, and
//     each of the 640 (unit, row) pairs of the block's tile belongs to one thread, which adds
//     them in group order with xp and bR, applies the gates and keeps c in a register for
//     the whole sequence (when the block's rows fit one tile, as at the LM's shape); xp of
//     step t is copied to shared memory with cp.async with the last stage of step t's
//     product, and bR stays in shared memory, so after the barrier only h_{t-1} is on the
//     step's path;
//   - h_t goes straight to the exchange buffer (a thread a row, so a warp writes 128
//     contiguous bytes), then the block signals its half; the gates, cs and ys are staged in
//     shared memory and written, in runs of the block's units a row, while the next
//     product's first stage of h is on its way.
// Batches wider than a tile (at most 64 rows) are walked in tiles; c then round-trips
// through cs, which the block wrote a step earlier.  Loops over the block's copies and
// stores take one integer division a call (lstm_for3), none an element.
//
// Bound at the slice's shape (T = 35, B = 128, H = 650, one layer): 2*B*H*4H FLOP a step,
// 15.14 GFLOP a call, 0.226 ms at 67 TFLOP/s fp32 (6.5 us a step); about 123 MB of xp,
// gates, cs, ys and R, 37 us at 3.35 TB/s.  So it is bound by operations.  What keeps it
// above the bound: the product issues its FMAs at about half the card's rate (the shared-
// memory loads, a barrier a stage, the 650 columns padded to 672), and each step adds a
// serial tail the product cannot hide: the partial sums and the gates, the exchange of
// h_t through L2 (22 MB a step over the card) and the barrier.

#include <string.h>

#include "lstm_common.cuh"

namespace {

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

template <bool RES>
__global__ void __launch_bounds__(lstm_max_threads(true), 1)
lstm_fwd_kernel(const float* __restrict__ xp, const float* __restrict__ h0,
                const float* __restrict__ c0, const float* __restrict__ R,
                const float* __restrict__ bR, float* ys, float* gates, float* cs, float* hT,
                float* cT, float* hbuf, unsigned* ctr, int T, int B, int H, LstmPlan p) {
  extern __shared__ __align__(16) float smem[];
  const LstmDims d = lstm_dims(p, H, true);
  const int U = p.units, BT = p.tile, KG = p.kg;
  const int Bp = (B + 3) / 4 * 4;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int half = blockIdx.x / p.groups;
  const int u0 = (blockIdx.x % p.groups) * U, nu = min(U, H - u0);
  const int b_lo = half * p.rows, b_hi = min(B, b_lo + p.rows), nb = b_hi - b_lo;
  const int rcap = min(Bp, b_lo + p.rows);
  const int ntiles = (nb + BT - 1) / BT;
  const bool one_tile = ntiles == 1;
  const int XP = BT + 1, SP = lstm_odd(U), SO = BT * SP, UB = U * BT;

  float* wres = smem;                                  // R resident: [Kp][NCP]
  float* as = wres + (RES ? d.Kp * d.NCP : 0);         // the stage region
  float* wst = as + LSTM_NS * d.KC * BT;               // R's stages when streamed
  float* red = as;                                     // partial sums, over the stages
  float* xs = as + lstm_max(lstm_stage_floats(p, d), KG * d.NCP * d.BTP);  // [NCP][XP]
  float* sto = xs + lstm_r4(d.NCP * XP);               // [6][BT][SP]: i f g o c h
  float* bRs = sto + lstm_r4(6 * SO);                  // [4U]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lstm_smem_floats(p, H, true) -
                                               LSTM_RING_FLOATS);

  const int kg = tid / d.items, item = tid - kg * d.items;
  const int rg = item % d.NRG, cg = item / d.NRG;     // a warp spans the rows
  const bool active = kg < KG;

  // column c of the block's slice of R is gate c / U of unit u0 + c % U
  auto r_at = [&](int c, int m, bool* ok) {
    const int k = c / U, ul = c - k * U;
    *ok = c < 4 * U && ul < nu && m < H;
    return *ok ? R + (size_t)(k * H + u0 + ul) * H + m : R;
  };
  auto load_w = [&](float* dst, int m0) {
    lstm_for3(1, d.NCP, d.KC, [&](int, int c, int kk) {
      bool ok;
      const float* src = r_at(c, m0 + kk, &ok);
      cp_async4(smem_addr(dst + kk * d.NCP + c), src, ok);
    });
  };
  if (RES) {
    for (int idx = tid; idx < d.Kp * d.NCP; idx += nthr) {
      const int c = idx / d.Kp, m = idx - c * d.Kp;
      bool ok;
      const float* src = r_at(c, m, &ok);
      wres[m * d.NCP + c] = ok ? *src : 0.f;
    }
  }
  for (int c = tid; c < 4 * U; c += nthr) {
    const int k = c / U, ul = c - k * U;
    bRs[c] = ul < nu ? bR[k * H + u0 + ul] : 0.f;
  }
  for (int idx = tid; idx < nu * nb; idx += nthr) {     // h0 into buffer 0, (H, Bp)
    const int ul = idx / nb, b = b_lo + idx % nb;
    hbuf[(size_t)(u0 + ul) * Bp + b] = h0[(size_t)b * H + u0 + ul];
  }
  if (blockIdx.x == 0 && tid < p.halves) ctr[tid] = 0u;
  // pair pp = tid + i * nthr of a tile is row pb[i] = pp % BT of unit pu[i] = pp / BT
  float creg[LSTM_MAXPP];
  int pb[LSTM_MAXPP], pu[LSTM_MAXPP];
#pragma unroll
  for (int i = 0; i < LSTM_MAXPP; ++i) {
    const int pp = tid + i * nthr, b = pp % BT, ul = pp < UB ? pp / BT : U;
    pb[i] = b;
    pu[i] = ul;
    creg[i] = one_tile && ul < nu && b < nb ? c0[(size_t)(b_lo + b) * H + u0 + ul] : 0.f;
  }
  // xp of step t, tile tl into xs: column k U + ul, row b (a warp reads runs of nu units)
  auto fetch_x = [&](int t, int tl) {
    const int r0 = b_lo + tl * BT, nbt = min(BT, b_hi - r0);
    lstm_for3(4, nbt, nu, [&](int k, int b, int ul) {
      cp_async4(smem_addr(xs + (k * U + ul) * XP + b),
                xp + ((size_t)t * B + r0 + b) * 4 * H + k * H + u0 + ul, true);
    });
  };
  // the staged gates, cs and ys of step t, tile tl, in runs of nu units a row
  auto write_out = [&](int t, int tl) {
    const int r0 = b_lo + tl * BT, nbt = min(BT, b_hi - r0);
    lstm_for3(6, nbt, nu, [&](int o, int b, int ul) {
      const float v = sto[o * SO + b * SP + ul];
      const size_t row = (size_t)t * B + r0 + b;
      if (o < 4)
        gates[row * 4 * H + o * H + u0 + ul] = v;
      else
        (o == 4 ? cs : ys)[row * H + u0 + ul] = v;
    });
  };
  lstm_ring_init(bars);
  int issued = 0;                      // stages through the ring so far
  cooperative_groups::this_grid().sync();

  int out_t = -1, out_tl = 0;          // the tile whose outputs wait in sto
  for (int t = 0; t < T; ++t) {
    const float* hprev = hbuf + (size_t)(t & 1) * H * Bp;
    float* hnext = hbuf + (size_t)((t + 1) & 1) * H * Bp;
    if (t > 0) lstm_wait(ctr + half, (unsigned)(p.groups * t));   // h_{t-1} of the half
    for (int tl = 0; tl < ntiles; ++tl) {
      const int r0 = b_lo + tl * BT, nbt = min(BT, b_hi - r0);
      float acc[4][8];
      // the previous tile's outputs go out while this product's first stage lands; xp
      // of this tile comes with its last stage
      lstm_product<4, 8, RES>(
          acc, hprev, Bp, r0, rcap, H, as, wres, wst, d, BT, p.sc, kg, rg, cg, active, bars,
          issued, load_w,
          [&] {
            if (out_t >= 0) write_out(out_t, out_tl);
          },
          [&] { fetch_x(t, tl); });
      __syncthreads();                 // every thread is done with the stages
      if (active) lstm_store_partials<4, 8>(acc, red, d, kg, rg, cg);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < LSTM_MAXPP; ++i) {
        const int b = pb[i], ul = pu[i];
        if (ul >= nu || b >= nbt) continue;
        float pre[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int c = k * U + ul;
          pre[k] = lstm_sum_partials(red, d, KG, c, b) + xs[c * XP + b] + bRs[c];
        }
        const int bb = r0 + b, u = u0 + ul;
        const float ig = sigmoid_f(pre[0]), fg = sigmoid_f(pre[1]);
        const float gg = tanhf(pre[2]), og = sigmoid_f(pre[3]);
        const float cprev = one_tile ? creg[i]
                            : t == 0 ? c0[(size_t)bb * H + u]
                                     : cs[((size_t)(t - 1) * B + bb) * H + u];
        const float c = fg * cprev + ig * gg;
        const float h = og * tanhf(c);
        creg[i] = c;
        hnext[(size_t)u * Bp + bb] = h;
        float* so = sto + b * SP + ul;
        so[0] = ig;
        so[SO] = fg;
        so[2 * SO] = gg;
        so[3 * SO] = og;
        so[4 * SO] = c;
        so[5 * SO] = h;
        if (t == T - 1) {
          hT[(size_t)bb * H + u] = h;
          cT[(size_t)bb * H + u] = c;
        }
      }
      // h_t of every tile is written: the half may go on
      if (tl == ntiles - 1 && t < T - 1)
        lstm_signal(ctr + half);
      else
        __syncthreads();
      out_t = t;
      out_tl = tl;
    }
  }
  if (out_t >= 0) write_out(out_t, out_tl);
}

// the kernel of the plan's residency, its shared memory attribute set once a device
template <bool RES>
cudaError_t ready(int device, int optin, const void** kern) {
  static bool done[64];
  *kern = (const void*)lstm_fwd_kernel<RES>;
  return lstm_allow_smem(*kern, device, done, optin);
}
cudaError_t select_kernel(const LstmPlan& p, int device, int optin, const void** kern) {
  return p.resident ? ready<true>(device, optin, kern) : ready<false>(device, optin, kern);
}

}  // namespace

// Plain C entry point, bound with ctypes.  xp (T, B, 4H), h0 (B, H), c0 (B, H), R (4H, H),
// bR (4H); outputs ys (T, B, H), gates (T, B, 4H), cs (T, B, H), hT (B, H), cT (B, H);
// scratch hbuf (2, H, Bp), Bp = B rounded up to a multiple of 4, and ctr (a counter a
// half: plan[0] unsigned).  All fp32, contiguous, on `device`; `plan` points to the 12 ints of
// hopper_rnn.lstm_plan("fwd", B, H, ...).  Launches the kernel once, as a cooperative launch
// on `stream`, and sets *launched to 1 when it did.  Returns 0, or the CUDA error:
// cudaErrorInvalidValue for an empty shape or a plan that does not fit the shape and card,
// cudaErrorCooperativeLaunchTooLarge when the grid cannot be co-resident.
extern "C" int mxtt_lstm_fwd(const float* xp, const float* h0, const float* c0, const float* R,
                             const float* bR, float* ys, float* gates, float* cs, float* hT,
                             float* cT, float* hbuf, unsigned* ctr, int T, int B, int H,
                             const int* plan, int device, void* stream, int* launched) {
  *launched = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int sms = 0, optin = 0;
  if ((err = lstm_card(device, &sms, &optin)) != cudaSuccess) return (int)err;
  LstmPlan p;
  memcpy(&p, plan, sizeof(p));
  if (T < 1) return (int)cudaErrorInvalidValue;
  int rc = lstm_check_plan(p, B, H, true, sms, optin);
  if (rc != 0) return rc;
  const void* kern = nullptr;
  err = select_kernel(p, device, optin, &kern);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&xp, (void*)&h0, (void*)&c0,    (void*)&R,  (void*)&bR,
                  (void*)&ys, (void*)&gates, (void*)&cs, (void*)&hT, (void*)&cT,
                  (void*)&hbuf, (void*)&ctr, (void*)&T,  (void*)&B,  (void*)&H,
                  (void*)&p};
  err = cudaLaunchCooperativeKernel(kern, dim3(p.halves * p.groups), dim3(p.threads), args,
                                    p.smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err == cudaSuccess) *launched = 1;
  return (int)err;
}

// Blocks an SM can hold of the kernel the plan selects, as the card reports it (for
// reports; the launch itself refuses a grid that cannot be co-resident).
extern "C" int mxtt_lstm_fwd_occupancy(const int* plan, int device, int* per_sm) {
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
