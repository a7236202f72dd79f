// Flash attention forward, for Hopper (sm_90a): kernels 3, 4 and 5 of the port.
//
// Replaces three TPU kernels of mxnet_tpu/ops/pallas_attention.py, all over the online-softmax
// loop _online_softmax_loop (pallas_attention.py:72-110):
//   - _flash_fwd / _flash_kernel (:113, launched at :152), the forward that writes only out
//     (kernel 3, MODE_OUT);
//   - flash_attention_stats / _flash_stats_kernel (:167, launched at :199), ring attention's
//     per-shard pass, which writes the unnormalised accumulator acc and the running max m and
//     sum l of every row, for an exact merge across shards outside the kernel (kernel 4,
//     MODE_STATS);
//   - _flash_fwd_lse (:238, launched at :254), the forward of the training step, which also
//     writes lse = m + log(l) per row (+inf where l == 0, lse_of at :223) for the backward
//     (kernel 5, MODE_OUT_LSE).
// One template with a MODE parameter covers all three; they differ only in the epilogue.  For
// each (batch * head) and each query row:
//
//   s[j]  = scale * sum_d q[i, d] * k[j, d]          (-inf where masked: causal k > q, or j >= Tk)
//   m_i   = max_j s[j],  l_i = sum_j exp(s[j] - m_i),  acc_i = sum_j exp(s[j] - m_i) * v[j, :]
//   out_i = acc_i / max(l_i, 1e-37)
//
// with q (BH, Tq, D), k and v (BH, Tk, D), out or acc (BH, Tq, D), lse, m and l (BH, Tq), all
// fp32 and contiguous.  The causal mask is q_pos >= k_pos, aligned at the top left as the
// reference's.  A row that sees no key gives m = -inf, l = 0 and acc = 0 (the reference's
// kernel_skip values, so that merging it changes nothing).
//
// Numerics: fp32 FMA on the CUDA cores (no TF32), expf/logf; the running max and sum follow
// the reference's guards (m_safe, alpha: pallas_attention.py:99-103), so that a row masked in
// a whole tile never makes exp(-inf - (-inf)).  Against the plain PyTorch versions
// (flash_fwd_plain and flash_stats_plain in ops/hopper_attention.py, dense softmaxes) only the
// order of the sums differs; chip_smoke.py holds out, lse and m within 1e-5 absolute, acc and
// l within 1e-5 of their largest |value|, and every output bit-equal on a rerun (no atomics,
// no split across CTAs).
//
// Bound.  2 D multiply-adds a visible (query, key) pair: at gpt2-small's training shape (B 16,
// H 12, T 1024, D 64, causal) 25.8 GFLOP a call, 0.385 ms at 67 TFLOP/s fp32; 201 MB of q, k,
// v and out, 0.06 ms at 3.35 TB/s.  Kernel 4 at a ring step of the long context (B 1, H 12,
// T_loc 4096, D 64): 51.5 GFLOP unmasked, 0.77 ms; 50 MB, 0.015 ms.  Bound by operations: what
// limits the kernel is how many of its issue slots go to FMAs.
//
// Design (a CTA of 4 warps, 128 threads, per (b*h, query tile of BQ = 64 rows)):
//   - Each warp owns 16 query rows: lane (ty, tx) = (lane / 8, lane % 8) keeps rows ty + 4 i
//     (i < RQ = 4) of its warp, so a row's BK keys lie in 8 lanes of one warp and no warp waits
//     on another's rows.  The CTA's Q tile stays in shared memory.
//   - K and V come through a cp.async ring of NS = 2 slots of BK rows (64; 32 at D = 128),
//     K and V tiles in turn: the loop runs two phases a key tile, S (reads K_t) and P.V (reads
//     V_t).  Before each phase one barrier; then the copy of the tile NS - 1 phases ahead is
//     issued into the slot the previous phase read, so K_{t+1} lands under P.V of tile t and
//     V_{t+1} under S of tile t + 1.  A thread's copy offsets are fixed (copy_rows); rows past
//     Tk are zero-filled by a source size of 0.  Two barriers a key tile (three before); P
//     needs none of its own, since the barrier before P.V orders P's stores and loads, and
//     the one before the next S its reuse.
//   - Register tiles of 4 rows x 8 a thread in both products, from float4 shared loads whose
//     4 or 8 distinct addresses in a warp fall in distinct 16-byte bank groups, one wavefront
//     each (rows padded by 4 floats, P's by 8):
//       S    = Q K^T: keys tx + 8 j; per 4 d, 4 float4s of Q and BK / 8 of K feed 2 BK FMAs
//              a lane: 10.7 FMAs a float4 at BK = 64 (the 4 x 4 tile before: 8);
//       P.V: columns col(tx, g) + c (D / 8 a lane); per 4 keys, 4 float4s of P and D / 8 of V
//              feed 2 D FMAs: 10.7 at D = 64.
//     Why not 8 rows a lane (16 FMAs a float4): with 64 accumulators in each product the
//     kernel takes 254 registers and 128-row CTAs of 104 KB, two an SM, and the ring's
//     unmasked call (384 CTAs) then fills 264 slots in 1.45 waves; measured slower at every
//     timed shape on an H100 (chip_ab.py ablate, "rows_8"), as was 8 rows with 32-key tiles.
//     At 4 rows it takes 168 registers and 69 KB, three CTAs (12 warps) an SM.
//   - The online softmax keeps m per row (a 3-shuffle max over the row's 8 lanes) and l per
//     lane, over its own keys, scaled by the same alpha as its row; the 8 lanes' l are added
//     once, in the epilogue.  Only tiles that cross the diagonal or Tk test the mask.
//   - Under the causal mask a warp stops at the last key tile its rows see, and the CTA at its
//     last warp's; block b takes query tile n_qt - 1 - b / BH of head b % BH, so the heaviest
//     query tiles are dealt first and the tail falls on light ones (flash_fwd_plan in
//     ops/hopper_attention.py gives the same tile, shared memory and order; the entry point
//     refuses another tile).
// What limits it: FMA issue against everything else a lane issues.  Shared memory is not
// the bound: at 10.7 FMAs a one-wavefront load it is busy about 3 of every 8 clocks that the
// SM's 4 schedulers spend on FMAs.  Taking one part out at a time (chip_ab.py ablate; times
// in PERF.md) shows what each costs: the two products, then the pass between them (scale,
// mask, max, expf, P's stores, rescale), the copies and the barriers.
// Shared memory: (BQ + NS BK)(D + 4) + BQ (BK + 8) floats: 69 KB at D = 64, 33 and 45 KB at
// D = 16 and 32, 76 KB at D = 128.  The attribute that allows it is set once a device and
// instantiation.

#include <cuda_runtime.h>
#include <math.h>

#include "cp_async.cuh"

namespace {

constexpr int WARPS = 4;          // warps of a CTA
constexpr int NT = 32 * WARPS;    // threads of a CTA
constexpr int NS = 2;             // ring slots, K and V tiles in turn

// What the epilogue writes: out (kernel 3), out and lse (kernel 5), or acc, m and l (kernel 4).
constexpr int MODE_OUT = 0;
constexpr int MODE_OUT_LSE = 1;
constexpr int MODE_STATS = 2;

// The tile of head dim D: RQ rows a thread, BK keys a tile.
template <int D>
struct Tile {
  static constexpr int RQ = 4;
  static constexpr int BK = D == 128 ? 32 : 64;
  static constexpr int BQ = WARPS * 4 * RQ;     // query rows of a CTA
  static constexpr int WR = 4 * RQ;             // query rows of a warp
  static constexpr int RK = BK / 8;             // keys of a thread in S
  static constexpr int SD = D + 4;              // padded row of Q, K, V
  static constexpr int SP = BK + 8;             // padded row of P
  static constexpr int NC = D / 8;              // output columns of a thread
  static constexpr int CW = NC < 4 ? NC : 4;    // in groups of CW contiguous columns
  static constexpr int NG = NC / CW;
  static constexpr size_t SMEM =
      sizeof(float) * ((size_t)(BQ + NS * BK) * SD + (size_t)BQ * SP);
  // column group g of lane tx: groups of CW columns, 8 CW apart
  __device__ static __forceinline__ int col(int tx, int g) { return g * 8 * CW + tx * CW; }
};

template <int W>
__device__ __forceinline__ void ldv(float* dst, const float* src) {
  if constexpr (W == 4) {
    const float4 t = *reinterpret_cast<const float4*>(src);
    dst[0] = t.x; dst[1] = t.y; dst[2] = t.z; dst[3] = t.w;
  } else if constexpr (W == 2) {
    const float2 t = *reinterpret_cast<const float2*>(src);
    dst[0] = t.x; dst[1] = t.y;
  } else {
    dst[0] = src[0];
  }
}

template <int W>
__device__ __forceinline__ void stv(float* dst, const float* src) {
  if constexpr (W == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(src[0], src[1], src[2], src[3]);
  } else if constexpr (W == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(src[0], src[1]);
  } else {
    dst[0] = src[0];
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float lane4(float4 a, int u) {
  return u == 0 ? a.x : u == 1 ? a.y : u == 2 ? a.z : a.w;
}

// max and sum over the 8 lanes tx of a row group
__device__ __forceinline__ float row_max8(float x) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum8(float x) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// key tiles that query rows [r0, r0 + rows) walk: all of them, or under the causal mask those
// up to the last row's diagonal (0 for rows wholly past Tq)
__device__ __forceinline__ int key_tiles(int r0, int rows, int Tq, int Tk, int BK, int causal) {
  const int n_kt = (Tk + BK - 1) / BK;
  if (r0 >= Tq) return 0;
  if (!causal) return n_kt;
  return min(n_kt, (min(r0 + rows, Tq) - 1) / BK + 1);
}

// Rows [r0, min(r0 + ROWS, T)) of a (T, D) row-major matrix g into s (row stride D + 4), zeros
// past T, by cp.async.  Thread tid copies the 16 bytes at column (tid % (D / 4)) * 4 of rows
// tid / (D / 4) + LR u: the same offsets for every tile, so a copy costs an add, a compare and
// the cp.async.
template <int D, int ROWS>
__device__ __forceinline__ void copy_rows(float* s, const float* g, int r0, int T) {
  constexpr int V4 = D / 4, SD = D + 4, LR = NT / V4;   // LR rows a pass of the CTA
  static_assert(NT % V4 == 0 && ROWS % LR == 0, "whole passes");
  const int r = threadIdx.x / V4, c = (threadIdx.x % V4) * 4;
  const uint32_t dst = smem_addr(s + r * SD + c);
  const float* src = g + ((size_t)r0 + r) * D + c;
  const int left = T - r0 - r;
#pragma unroll
  for (int u = 0; u < ROWS / LR; ++u) {
    const bool ok = u * LR < left;
    cp_async16(dst + u * LR * SD * (int)sizeof(float), ok ? src + (size_t)u * LR * D : g, ok);
  }
}

// out: the output (MODE_OUT, MODE_OUT_LSE) or acc (MODE_STATS); lse: lse (MODE_OUT_LSE) or m
// (MODE_STATS); lsum: l (MODE_STATS).  Pointers a mode does not write may be null.
template <int D, int MODE>
__global__ void __launch_bounds__(NT, 3) flash_fwd_kernel(const float* __restrict__ q,
                                                          const float* __restrict__ k,
                                                          const float* __restrict__ v,
                                                          float* __restrict__ out,
                                                          float* __restrict__ lse,
                                                          float* __restrict__ lsum, int BH,
                                                          int Tq, int Tk, float scale,
                                                          int causal) {
  using T = Tile<D>;
  constexpr int RQ = T::RQ, BK = T::BK, BQ = T::BQ, WR = T::WR, RK = T::RK, SD = T::SD,
                SP = T::SP, NC = T::NC, CW = T::CW, NG = T::NG;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* ring = Qs + BQ * SD;
  float* Ps = ring + NS * BK * SD;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ty = lane >> 3, tx = lane & 7;
  const int n_qt = (Tq + BQ - 1) / BQ;
  const int bh = blockIdx.x % BH;                       // heaviest query tiles first
  const int q0 = (n_qt - 1 - (int)(blockIdx.x / BH)) * BQ;
  const int qw = q0 + warp * WR;                        // the warp's first row
  const float* qg = q + (size_t)bh * Tq * D;
  const float* kg = k + (size_t)bh * Tk * D;
  const float* vg = v + (size_t)bh * Tk * D;
  const int n_ph = 2 * key_tiles(q0, BQ, Tq, Tk, BK, causal);
  const int warp_kt = key_tiles(qw, WR, Tq, Tk, BK, causal);

  // phase h reads K (h even) or V (h odd) of key tile h / 2 from ring slot h % NS
  auto load_phase = [&](int h) {
    copy_rows<D, BK>(ring + (h % NS) * BK * SD, (h & 1) ? vg : kg, (h >> 1) * BK, Tk);
  };
  copy_rows<D, BQ>(Qs, qg, q0, Tq);
#pragma unroll
  for (int h = 0; h < NS - 1; ++h) {
    if (h < n_ph) load_phase(h);
    cp_async_commit();
  }

  float m[RQ], l[RQ], acc[RQ][NC];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
  const float* Qw = Qs + (warp * WR + ty) * SD;         // row ty + 4 i at Qw + 4 i SD
  float* Pw = Ps + (warp * WR + ty) * SP;

  for (int h = 0; h < n_ph; ++h) {
    cp_async_wait<NS - 2>();
    __syncthreads();      // phase h's tile has landed; phase h - 1's slot and P are free
    if (h + NS - 1 < n_ph) load_phase(h + NS - 1);
    cp_async_commit();
    const int kt = h >> 1;
    if (kt >= warp_kt) continue;                        // past the warp's last key tile
    const float* Ts = ring + (h % NS) * BK * SD;
    const int k0 = kt * BK;

    if ((h & 1) == 0) {
      // S = Q K^T: rows ty + 4 i, keys tx + 8 j
      float s[RQ][RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) s[i][j] = 0.f;
#pragma unroll 2
      for (int d = 0; d < D; d += 4) {
        float4 b[RK];
#pragma unroll
        for (int j = 0; j < RK; ++j)
          b[j] = *reinterpret_cast<const float4*>(Ts + (tx + 8 * j) * SD + d);
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          const float4 a = *reinterpret_cast<const float4*>(Qw + 4 * i * SD + d);
#pragma unroll
          for (int j = 0; j < RK; ++j) s[i][j] = dot4(a, b[j], s[i][j]);
        }
      }
      // the online softmax: P = exp(S - m) into shared memory, acc and l rescaled
      const bool whole = k0 + BK <= Tk && (!causal || k0 + BK - 1 <= qw);   // no key masked
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const int qp = qw + ty + 4 * i;
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < RK; ++j) {
          float x = s[i][j] * scale;
          if (!whole) {
            const int kp = k0 + tx + 8 * j;
            if (kp >= Tk || (causal && kp > qp)) x = -INFINITY;
          }
          s[i][j] = x;
          mx = fmaxf(mx, x);
        }
        mx = row_max8(mx);
        const float m_new = fmaxf(m[i], mx);
        const float m_safe = isfinite(m_new) ? m_new : 0.f;
        const float alpha = isfinite(m[i]) ? expf(m[i] - m_safe) : 0.f;
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < RK; ++j) {
          const float p = expf(s[i][j] - m_safe);
          rs += p;
          Pw[4 * i * SP + tx + 8 * j] = p;
        }
        l[i] = l[i] * alpha + rs;
        m[i] = m_new;
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
      }
    } else {
      // acc += P V: rows ty + 4 i, columns col(tx, g) + c
#pragma unroll 2
      for (int kk = 0; kk < BK; kk += 4) {
        float4 p[RQ];
#pragma unroll
        for (int i = 0; i < RQ; ++i) p[i] = *reinterpret_cast<const float4*>(Pw + 4 * i * SP + kk);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float vv[NC];
#pragma unroll
          for (int g = 0; g < NG; ++g) ldv<CW>(vv + g * CW, Ts + (kk + u) * SD + T::col(tx, g));
#pragma unroll
          for (int i = 0; i < RQ; ++i) {
            const float pu = lane4(p[i], u);
#pragma unroll
            for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pu, vv[c], acc[i][c]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const float li = row_sum8(l[i]);                    // the 8 lanes' partial sums
    const int r = qw + ty + 4 * i;
    if (r >= Tq) continue;
    const float den = fmaxf(li, 1e-37f);
    float o[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) o[c] = MODE == MODE_STATS ? acc[i][c] : acc[i][c] / den;
    float* og = out + ((size_t)bh * Tq + r) * D;
#pragma unroll
    for (int g = 0; g < NG; ++g) stv<CW>(og + T::col(tx, g), o + g * CW);
    if (tx != 0) continue;
    if (MODE == MODE_OUT_LSE) lse[(size_t)bh * Tq + r] = li > 0.f ? m[i] + logf(den) : INFINITY;
    if (MODE == MODE_STATS) {
      lse[(size_t)bh * Tq + r] = m[i];
      lsum[(size_t)bh * Tq + r] = li;
    }
  }
}

// above 48 KB of dynamic shared memory only after this, once a device and instantiation
template <int D, int MODE>
cudaError_t allow_smem(int device) {
  static bool done[64];
  if (device >= 0 && device < 64 && done[device]) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Tile<D>::SMEM);
  if (err == cudaSuccess && device >= 0 && device < 64) done[device] = true;
  return err;
}

template <int D, int MODE>
cudaError_t launch_mode(const float* q, const float* k, const float* v, float* out, float* lse,
                        float* lsum, int BH, int Tq, int Tk, float scale, int causal,
                        int device, cudaStream_t stream) {
  cudaError_t err = allow_smem<D, MODE>(device);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)BH * ((Tq + Tile<D>::BQ - 1) / Tile<D>::BQ);
  flash_fwd_kernel<D, MODE><<<(unsigned)blocks, NT, Tile<D>::SMEM, stream>>>(
      q, k, v, out, lse, lsum, BH, Tq, Tk, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* out, float* lse,
                   float* lsum, int BH, int Tq, int Tk, float scale, int causal, int mode,
                   int device, cudaStream_t s) {
  switch (mode) {
    case MODE_OUT:
      return launch_mode<D, MODE_OUT>(q, k, v, out, lse, lsum, BH, Tq, Tk, scale, causal,
                                      device, s);
    case MODE_OUT_LSE:
      return launch_mode<D, MODE_OUT_LSE>(q, k, v, out, lse, lsum, BH, Tq, Tk, scale, causal,
                                          device, s);
    case MODE_STATS:
      return launch_mode<D, MODE_STATS>(q, k, v, out, lse, lsum, BH, Tq, Tk, scale, causal,
                                        device, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int D>
cudaError_t occupancy(int* blocks, int device) {
  // the least over the three epilogues
  int b[3] = {0, 0, 0};
  cudaError_t err;
  if ((err = allow_smem<D, MODE_OUT>(device)) != cudaSuccess ||
      (err = allow_smem<D, MODE_OUT_LSE>(device)) != cudaSuccess ||
      (err = allow_smem<D, MODE_STATS>(device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(b, flash_fwd_kernel<D, MODE_OUT>,
                                                           NT, Tile<D>::SMEM)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           b + 1, flash_fwd_kernel<D, MODE_OUT_LSE>, NT, Tile<D>::SMEM)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           b + 2, flash_fwd_kernel<D, MODE_STATS>, NT, Tile<D>::SMEM)) != cudaSuccess)
    return err;
  *blocks = b[0] < b[1] ? (b[0] < b[2] ? b[0] : b[2]) : (b[1] < b[2] ? b[1] : b[2]);
  return cudaSuccess;
}

// (query rows of a CTA, keys of a tile) at head dim D, or (0, 0) for another D
void tile_of(int D, int* bq, int* bk) {
  switch (D) {
    case 16: *bq = Tile<16>::BQ; *bk = Tile<16>::BK; break;
    case 32: *bq = Tile<32>::BQ; *bk = Tile<32>::BK; break;
    case 64: *bq = Tile<64>::BQ; *bk = Tile<64>::BK; break;
    case 128: *bq = Tile<128>::BQ; *bk = Tile<128>::BK; break;
    default: *bq = *bk = 0;
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  q (BH, Tq, D), k and v (BH, Tk, D), out (BH, Tq, D),
// lse and lsum (BH, Tq), all fp32, contiguous, 16-byte aligned, on `device`.  mode 0 (kernel 3)
// writes out; mode 1 (kernel 5) out and lse; mode 2 (kernel 4) the unnormalised acc into out,
// m into lse and l into lsum.  A pointer the mode does not write may be null.  bq and bk (query
// rows of a CTA, keys of a tile) come from the host plan (ops/hopper_attention.py
// flash_fwd_plan) and must be this file's: 64 and 64 for D 16, 32 and 64, 64 and 32 for D 128.
// Launches one kernel on `stream` and sets *launched to 1 when it did.  Returns 0, or the CUDA
// error: cudaErrorInvalidValue for an empty shape, a grid too large, an unknown mode, another
// tile, or a D other than 16, 32, 64 and 128.
extern "C" int mxtt_flash_attn_fwd(const float* q, const float* k, const float* v, float* out,
                                   float* lse, float* lsum, int BH, int Tq, int Tk, int D,
                                   float scale, int causal, int mode, int bq, int bk,
                                   int device, void* stream, int* launched) {
  *launched = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int want_bq, want_bk;
  tile_of(D, &want_bq, &want_bk);
  if (want_bq == 0 || bq != want_bq || bk != want_bk || BH < 1 || Tq < 1 || Tk < 1 ||
      (long long)BH * ((Tq + bq - 1) / bq) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: err = launch<16>(q, k, v, out, lse, lsum, BH, Tq, Tk, scale, causal, mode, device, s); break;
    case 32: err = launch<32>(q, k, v, out, lse, lsum, BH, Tq, Tk, scale, causal, mode, device, s); break;
    case 64: err = launch<64>(q, k, v, out, lse, lsum, BH, Tq, Tk, scale, causal, mode, device, s); break;
    default: err = launch<128>(q, k, v, out, lse, lsum, BH, Tq, Tk, scale, causal, mode, device, s); break;
  }
  if (err == cudaSuccess) *launched = 1;
  return (int)err;
}

// CTAs of the kernel at head dim D that one SM holds at once (the least over the three
// epilogues), into *blocks: the design assumes 3 at D 64, read on the card.  Returns a CUDA
// error code.
extern "C" int mxtt_flash_attn_fwd_occupancy(int D, int device, int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  switch (D) {
    case 16: err = occupancy<16>(blocks, device); break;
    case 32: err = occupancy<32>(blocks, device); break;
    case 64: err = occupancy<64>(blocks, device); break;
    case 128: err = occupancy<128>(blocks, device); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}
