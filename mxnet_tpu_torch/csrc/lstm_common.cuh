// What kernels 8 and 9 (lstm_fwd.cu, lstm_bwd.cu) share: the launch plan that
// ops/hopper_rnn.py:lstm_plan computes and both entry points check, the barriers between
// the blocks of one batch half, and the product every step runs:
//
//   out[BT rows][NC cols] = sum over m < K of A[m][rows] * W[m][cols]
//
// with A the state the blocks exchange each step, (K, Bp) in global memory (h_{t-1} in the
// forward, one gate's d_pre^T in the backward), staged through shared memory in stages of
// KC = KG * SC columns, NS deep, with cp.async.cg (through L2: other blocks wrote it in this
// launch), and W the block's slice of R, resident in shared memory for the whole sequence
// or, where it does not fit, staged beside A.  A thread keeps a TR x TC register tile;
// KG groups of threads split each stage's columns (SC each) and add their partial sums
// afterwards, in group order, so reruns are bit-equal.  fp32 FMA on the CUDA cores.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int LSTM_NS = 3;             // stages of A (and of a streamed W) in shared memory
// threads a block at most (__launch_bounds__): the forward's 512 leave it 128 registers a
// thread, which its epilogue needs; the backward's 640, 96
__host__ __device__ constexpr int lstm_max_threads(bool fwd) { return fwd ? 512 : 640; }
constexpr int LSTM_MAXPP = 2;          // (unit, row) pairs a thread keeps in registers
constexpr int LSTM_MAX_KG = 8;         // thread groups splitting a stage
constexpr int LSTM_RING_FLOATS = 16;   // the stage ring's 2 NS mbarriers, at the end

// The plan's fields, in the order of hopper_rnn.LstmPlan.  A launch has halves * groups *
// parts blocks: `parts` blocks (the backward's four gates, else 1) of a group own `units`
// hidden units of one batch half's `rows` rows; a product tile has `tile` rows; `kg` thread
// groups take `sc` columns of each stage; the backward's elementwise phase walks `chunk`
// rows at a time; `resident`: W stays in shared memory.
struct LstmPlan {
  int halves, groups, parts, units, rows, tile, kg, sc, chunk, threads, resident, smem;
};

__host__ __device__ inline int lstm_odd(int n) { return n | 1; }
__host__ __device__ inline int lstm_r4(int n) { return (n + 3) / 4 * 4; }

// Sizes derived from a plan: a thread tile of TR rows x TC columns (4 x 8 in the forward,
// 8 x 4 in the backward), NC output columns (4 U gate columns in the forward, U units in
// the backward) padded to NCP, NRG x NCG thread tiles, KC columns a stage over nst stages
// (Kp with the padding), the partial sums' row pitch BTP.
struct LstmDims {
  int TR, TC, NC, NCG, NCP, NRG, items, KC, nst, Kp, BTP;
};

__host__ __device__ inline LstmDims lstm_dims(const LstmPlan& p, int H, bool fwd) {
  LstmDims d;
  d.TR = fwd ? 4 : 8;
  d.TC = fwd ? 8 : 4;
  d.NC = fwd ? 4 * p.units : p.units;
  d.NCG = (d.NC + d.TC - 1) / d.TC;
  d.NCP = d.NCG * d.TC;
  d.NRG = p.tile / d.TR;
  d.items = d.NCG * d.NRG;
  d.KC = p.kg * p.sc;
  d.nst = (H + d.KC - 1) / d.KC;
  d.Kp = d.nst * d.KC;
  d.BTP = p.tile + 4;
  return d;
}

// Shared-memory floats of the stage region: the A stages (and W's when streamed), which
// the partial sums (and, in the backward, the elementwise phase's staging) reuse.
__host__ __device__ inline int lstm_stage_floats(const LstmPlan& p, const LstmDims& d) {
  return LSTM_NS * d.KC * p.tile + (p.resident ? 0 : LSTM_NS * d.KC * d.NCP);
}
__host__ __device__ inline int lstm_max(int a, int b) { return a > b ? a : b; }

// Dynamic shared memory of a launch, in floats (hopper_rnn.lstm_plan mirrors it): the
// block's slice of R when resident, the stage region (reused for the partial sums and, in
// the backward, the staging of d_pre), the kernel's own buffers, and the stage ring's
// mbarriers last.
__host__ __device__ inline int lstm_smem_floats(const LstmPlan& p, int H, bool fwd) {
  const LstmDims d = lstm_dims(p, H, fwd);
  const int res = p.resident ? d.Kp * d.NCP : 0;
  int region = lstm_max(lstm_stage_floats(p, d), p.kg * d.NCP * d.BTP);
  if (fwd) {
    // xp of a tile [NCP][BT + 1], the tile's six outputs [6][BT][U | 1], bR [4U]
    return res + region + lstm_r4(d.NCP * (p.tile + 1)) +
           lstm_r4(6 * p.tile * lstm_odd(p.units)) + lstm_r4(4 * p.units) + LSTM_RING_FLOATS;
  }
  const int uq = (p.units + 3) / 4;
  // staging of a chunk's d_pre: [4][chunk][uq | 1] for dxp, [4][uq][chunk + 1] for d_pre^T
  region = lstm_max(region, lstm_r4(4 * p.chunk * lstm_odd(uq)) +
                                lstm_r4(4 * uq * (p.chunk + 1)));
  // the reserve of a chunk: [7][uq][chunk + 1]
  return res + region + lstm_r4(7 * uq * (p.chunk + 1)) + LSTM_RING_FLOATS;
}

// 0 when the plan covers (B, H) on a card with `sms` SMs and `optin` bytes of shared memory
// a block, as hopper_rnn.lstm_plan builds it; else cudaErrorInvalidValue.
inline int lstm_check_plan(const LstmPlan& p, int B, int H, bool fwd, int sms, int optin) {
  const LstmDims d = lstm_dims(p, H, fwd);
  const int blocks = p.halves * p.groups * p.parts;
  const int uq = (p.units + 3) / 4;
  const bool ok =
      B >= 1 && H >= 1 && (p.halves == 1 || p.halves == 2) && p.parts == (fwd ? 1 : 4) &&
      p.units >= 1 && p.groups * p.units >= H && (p.groups - 1) * p.units < H &&
      p.rows % 4 == 0 && p.halves * p.rows >= B && (p.halves - 1) * p.rows < B &&
      p.tile >= d.TR && p.tile % d.TR == 0 && p.tile <= 128 &&
      p.threads % 32 == 0 && p.kg >= 1 && p.kg <= LSTM_MAX_KG && p.sc >= 1 &&
      p.threads <= lstm_max_threads(fwd) && p.kg * d.items <= p.threads && blocks >= 1 &&
      blocks <= sms &&
      (fwd ? p.units * p.tile <= LSTM_MAXPP * p.threads
           : p.chunk >= 1 && uq * p.chunk <= LSTM_MAXPP * p.threads) &&
      (p.resident == 0 || p.resident == 1) && p.smem == 4 * lstm_smem_floats(p, H, fwd) &&
      p.smem <= optin;
  return ok ? 0 : (int)cudaErrorInvalidValue;
}

// Barriers between the blocks of one batch half, on counters in global memory that only
// grow: a block adds 1 once its stores are done (thread 0, after the block's barrier, with
// release semantics at GPU scope), and waits until a counter reaches a target (thread 0
// reads with acquire semantics, then the block's barrier).  The launch is cooperative, so
// every block is resident and a wait always ends.  What is read after a wait is read
// through L2 (cp.async.cg, ld.global.cg), never from a stale L1 line.
__device__ __forceinline__ void lstm_signal(unsigned* ctr) {
  __syncthreads();
  if (threadIdx.x == 0)
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(ctr) : "memory");
}
__device__ __forceinline__ void lstm_wait(const unsigned* ctr, unsigned target) {
  if (threadIdx.x == 0) {
    unsigned v;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(ctr) : "memory");
    } while (v < target);
  }
  __syncthreads();
}

// f(plane, outer, inner) for every plane < np, outer < no, inner < ni, spread over the
// block with `inner` fastest across threads: one integer division a call, none an element
// (the shapes are runtime values, and a division by one costs some twenty instructions).
template <class F>
__device__ __forceinline__ void lstm_for3(int np, int no, int ni, F f) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  if (ni <= 0 || no <= 0) return;
  if (ni >= nthr) {
    for (int pl = 0; pl < np; ++pl)
      for (int o = 0; o < no; ++o)
        for (int i = tid; i < ni; i += nthr) f(pl, o, i);
    return;
  }
  const int per = nthr / ni, o0 = tid / ni, i = tid - o0 * ni;
  if (o0 >= per) return;
  for (int pl = 0; pl < np; ++pl)
    for (int o = o0; o < no; o += per) f(pl, o, i);
}

// mbarriers in shared memory (sm_80+): one thread initialises them; a thread's arrival,
// or the arrival that lands with all of the thread's earlier cp.async copies; a wait for
// the phase of a given parity to complete (with acquire semantics: the data that the
// arrivals covered is then visible).
__device__ __forceinline__ void lstm_mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void lstm_mbar_arrive(uint64_t* bar) {
  uint64_t state;
  asm volatile("mbarrier.arrive.shared::cta.b64 %0, [%1];\n"
               : "=l"(state)
               : "r"(smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void lstm_mbar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void lstm_mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// The ring of NS stage buffers: bars[b] completes when every thread's copies into buffer b
// have landed, bars[NS + b] when every thread has read it.  Stages are numbered over the
// whole launch (`issued`, the same in every thread), so that stage g uses buffer g % NS in
// its (g / NS)-th phase.  Every thread of the block arrives on both for every stage.
__device__ __forceinline__ void lstm_ring_init(uint64_t* bars) {
  if (threadIdx.x == 0)
    for (int b = 0; b < 2 * LSTM_NS; ++b) lstm_mbar_init(bars + b, blockDim.x);
}

// The product of one tile (see the top of this file): A's rows row0 .. row0 + tile of
// columns 0 .. K-1 (rows at or past rcap, columns at or past K read as zeros), W from
// `wres` (resident, [Kp][NCP]) or staged by load_w(dst [KC][NCP], first column) into `wst`.
// Thread group kg (active threads only) sums columns kg * SC .. of every stage into
// acc, its TR x TC tile at rows rg * TR and columns cg * TC.  The stages pass through the
// ring of `bars`: a thread waits for a stage's copies, reads it, and issues the stage
// NS - 1 ahead into the buffer it has just left once every thread has left it too, so no
// barrier of the whole block holds the warps in step.  Starts by issuing the first stages;
// the caller has made the stage region free (a barrier of the block since its last use).
// Then runs while_first_lands() (work that needs no stage) and, with the last stage's
// copies, prefetch() (copies the caller needs once the product is done: they land with
// that stage).  Ends with stages read by this thread only: the caller synchronises before
// reusing the region.
template <int TR, int TC, bool RES, class LoadW, class First, class Prefetch>
__device__ __forceinline__ void lstm_product(float (&acc)[TR][TC], const float* A, int Bp,
                                             int row0, int rcap, int K, float* as,
                                             const float* wres, float* wst, const LstmDims& d,
                                             int BT, int SC, int kg, int rg, int cg,
                                             bool active, uint64_t* bars, int& issued,
                                             LoadW load_w, First while_first_lands,
                                             Prefetch prefetch) {
  const int KC = d.KC, NCP = d.NCP, nst = d.nst, nq = BT / 4, g0 = issued;
  auto issue = [&](int s) {
    const int g = g0 + s, b = g % LSTM_NS, m0 = s * KC;
    // the buffer's previous stage has been read by every thread
    if (g >= LSTM_NS) lstm_mbar_wait(bars + LSTM_NS + b, (g / LSTM_NS - 1) & 1);
    float* dst = as + b * KC * BT;
    lstm_for3(1, KC, nq, [&](int, int kk, int q4) {
      const int r4 = 4 * q4;
      const bool ok = m0 + kk < K && row0 + r4 < rcap;
      cp_async16(smem_addr(dst + kk * BT + r4), ok ? A + (size_t)(m0 + kk) * Bp + row0 + r4 : A,
                 ok);
    });
    if (!RES) load_w(wst + b * KC * NCP, m0);
    if (s == nst - 1) prefetch();
    lstm_mbar_arrive_copies(bars + b);
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = 0.f;
  for (int s = 0; s < LSTM_NS - 1 && s < nst; ++s) issue(s);
  while_first_lands();
  for (int s = 0; s < nst; ++s) {
    const int g = g0 + s, b = g % LSTM_NS;
    lstm_mbar_wait(bars + b, (g / LSTM_NS) & 1);    // stage s has landed, every thread's part
    if (active) {
      const float* a = as + b * KC * BT + kg * SC * BT + rg * TR;
      const float* w = (RES ? wres + (size_t)s * KC * NCP : wst + b * KC * NCP) +
                       kg * SC * NCP + cg * TC;
#pragma unroll 4
      for (int kk = 0; kk < SC; ++kk) {
        float av[TR], wv[TC];
#pragma unroll
        for (int i = 0; i < TR; i += 4) {
          const float4 v = *reinterpret_cast<const float4*>(a + kk * BT + i);
          av[i] = v.x;
          av[i + 1] = v.y;
          av[i + 2] = v.z;
          av[i + 3] = v.w;
        }
#pragma unroll
        for (int j = 0; j < TC; j += 4) {
          const float4 v = *reinterpret_cast<const float4*>(w + kk * NCP + j);
          wv[j] = v.x;
          wv[j + 1] = v.y;
          wv[j + 2] = v.z;
          wv[j + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
          for (int j = 0; j < TC; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
      }
    }
    lstm_mbar_arrive(bars + LSTM_NS + b);               // this thread is done with it
    if (s + LSTM_NS - 1 < nst) issue(s + LSTM_NS - 1);
  }
  issued = g0 + nst;
}

// A thread group's partial sums into red [KG][NCP][BTP] (column-major tiles, float4 rows).
template <int TR, int TC>
__device__ __forceinline__ void lstm_store_partials(const float (&acc)[TR][TC], float* red,
                                                    const LstmDims& d, int kg, int rg, int cg) {
#pragma unroll
  for (int j = 0; j < TC; ++j)
#pragma unroll
    for (int i = 0; i < TR; i += 4)
      *reinterpret_cast<float4*>(red + (size_t)(kg * d.NCP + cg * TC + j) * d.BTP + rg * TR + i) =
          make_float4(acc[i][j], acc[i + 1][j], acc[i + 2][j], acc[i + 3][j]);
}

// Column c, row b of the tile: the groups' partial sums added in group order (all loads
// first, so that their latencies overlap).
__device__ __forceinline__ float lstm_sum_partials(const float* red, const LstmDims& d, int KG,
                                                   int c, int b) {
  const float* src = red + (size_t)c * d.BTP + b;
  const int step = d.NCP * d.BTP;
  float v[LSTM_MAX_KG];
#pragma unroll
  for (int g = 0; g < LSTM_MAX_KG; ++g) v[g] = g < KG ? src[g * step] : 0.f;
  float s = v[0];
#pragma unroll
  for (int g = 1; g < LSTM_MAX_KG; ++g)
    if (g < KG) s += v[g];
  return s;
}

// The dynamic shared memory attribute at the card's opt-in limit, once a device and kernel.
inline cudaError_t lstm_allow_smem(const void* kernel, int device, bool* done, int optin) {
  if (device >= 0 && device < 64 && done[device]) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess && device >= 0 && device < 64) done[device] = true;
  return err;
}

// The card's SM count and opt-in shared memory a block, read once a device.
inline cudaError_t lstm_card(int device, int* sms, int* optin) {
  static int cached_sms[64], cached_optin[64];
  if (device >= 0 && device < 64 && cached_sms[device] > 0) {
    *sms = cached_sms[device];
    *optin = cached_optin[device];
    return cudaSuccess;
  }
  int coop = 0;
  cudaError_t err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  if (device >= 0 && device < 64) {
    cached_optin[device] = *optin;
    cached_sms[device] = *sms;
  }
  return cudaSuccess;
}

}  // namespace
