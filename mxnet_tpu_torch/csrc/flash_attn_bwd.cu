// Flash attention backward, for Hopper (sm_90a): kernels 6 and 7 of the port, fused into one
// launch and a fixed-order dq sum.
//
// Replaces the two TPU kernels of mxnet_tpu/ops/pallas_attention.py:flash_attention_bwd
// (:359): the dq kernel _dq_kernel (:276, launched at :377) and the dk/dv kernel _dkv_kernel
// (:315, launched at :393).  Given q, dO (BH, Tq, D), k, v (BH, Tk, D), the forward's
// lse (BH, Tq) and delta = rowsum(dO * out) (BH, Tq), it computes
//
//   p[i, j]  = exp(scale * q_i . k_j - lse_i)      (0 where masked: causal j > i, or out of range)
//   ds[i, j] = p[i, j] * (dO_i . v_j - delta_i) * scale
//   dq_i = sum_j ds[i, j] k_j,   dk_j = sum_i ds[i, j] q_i,   dv_j = sum_i p[i, j] dO_i
//
// in fp32, as the TPU pair does, but each (query, key) pair is visited once: the TPU pair
// (and the port's first two kernels) each recomputed s = q k^T and dp = dO v^T, seven
// products of D terms a visible pair where five suffice (S, dP, dV, dK, dQ).
//
// Bound.  5 D multiply-adds a visible pair: at gpt2-small's shape (B 16, H 12, T 1024, D 64,
// causal) 64.5 GFLOP a call, 0.962 ms at 67 TFLOP/s fp32, 11.55 ms over a step's 12 calls;
// at the ring's per-shard (1, 12, 4096, 4096, 64) 128.8 GFLOP non-causal, 64.4 causal.
// q, k, v, dO and the outputs are 250-300 MB a gpt2-small call, under 0.1 ms at 3.35 TB/s:
// bound by operations.
//
// Design (one CTA of 256 threads, 16 x 16, per (b*h, key tile)):
//   - The CTA's K and V tiles (BK = 128 keys; 64 at D = 128) stay in shared memory.  Q, dO,
//     lse and delta tiles of BQ queries (64; 32 at D = 128) stream through a 2-stage cp.async
//     ring: the next tile's copy runs under this tile's products.  Rows past Tq or Tk are
//     zero-filled by a source size of 0, so no product meets garbage.  A causal CTA starts at
//     the first q tile that can see its keys (floor(k0 / BQ), _dkv_kernel's lo).
//   - Block b takes key tile b / BH and head b % BH: under the causal mask the first key
//     tiles see the most queries, so the heaviest CTAs are dealt first and the tail falls on
//     short ones.
//   - Per q tile: S^T and dP^T (keys x queries) as dot products of padded rows, a 4*SK keys x
//     BQ/16 queries register tile a thread (float4 loads; the keys are shared by a quarter
//     warp, a broadcast); then P = exp(scale S - lse) and dS = P (dP - delta) scale, one expf
//     a pair, written once to shared memory as P[q][key] and dS[q][key].  After one barrier:
//     dV += P^T dO and dK += dS^T Q accumulate in registers (4*SK keys x D/16 columns each, a
//     float4 of P or dS broadcast a quarter warp, a row of dO or Q read as float4s), and the
//     tile's dQ = dS K (BQ/16 rows x D/16 columns a thread) is written to a workspace.  Two
//     barriers a q tile.  Rows are padded by 4 floats, so each quarter warp's float4 loads
//     and stores touch 8 distinct bank groups.
//   - dQ is summed in a fixed order, with no atomics, so reruns are bit-equal.  Every CTA
//     writes its dQ partial for the q rows it visits, lo * BQ .. Tq - 1, to a workspace the
//     wrapper allocates: per b*h, key tile kt's rows start at
//        off(kt) = sum over t < kt of rows(t),  rows(t) = Tq - lo(t) * BQ  (causal: lo(t) =
//        t * BK / BQ, and rows(t) = 0 once t * BK >= Tq; non-causal lo = 0),
//     then dq_sum_kernel adds, for each q row, the partials of key tiles 0, 1, ... in that
//     order (key tile kt holds row q iff lo(kt) * BQ <= q).  The rows are ragged under the
//     causal mask, which is why this is not split_sum.cuh's rectangular sum.  Workspace bytes:
//     4 D BH sum_kt rows(kt): 226 MB at gpt2-small's shape (4,608 rows a head), 403 MB at the
//     ring's non-causal 4096 x 4096 call and 207 MB at its causal one.
//
// What limits it: FMA issue against the other instructions at two warps a scheduler (one
// CTA an SM, 203 KB of shared memory at D = 64): the float4 loads that feed the register
// tiles (10.7 FMAs a load for S/dP and dK/dV at SK = 2, 8 for dQ), addressing, the expf and
// mask pass, two barriers a q tile; and the dq sum's two passes over the workspace.  On an
// H100 the three phases run at 36-45 TFLOP/s (chip_ab.py ablate); neither 8 x 8 tiles nor
// 16 warps an SM ran faster.
//
// Numerics: fp32 FMA on the CUDA cores, expf; against the plain PyTorch version
// (flash_bwd_plain in ops/hopper_attention.py) only the order of the sums differs;
// chip_smoke.py and the card test hold every output within 1e-4 of its largest |value|.

#include <cuda_runtime.h>
#include <math.h>

#include "cp_async.cuh"

namespace {

constexpr int NT = 256;      // threads per block: 16 x 16 (ty, tx)
constexpr int STAGES = 2;    // Q/dO ring depth

template <int D>
struct OutCols {             // the D / 16 output columns of thread tx: float4s 64 apart
  static constexpr int NC = D / 16;
  static constexpr int CW = NC < 4 ? NC : 4;
  static constexpr int NG = NC / CW;
  __device__ static __forceinline__ int col(int tx, int g) { return g * 16 * CW + tx * CW; }
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

__device__ __forceinline__ float lane(float4 a, int u) {
  return u == 0 ? a.x : u == 1 ? a.y : u == 2 ? a.z : a.w;
}

// first row of key tile kt's dQ partial in a head's workspace: sum over t < kt of rows(t)
__host__ __device__ __forceinline__ long long ws_off(int kt, int Tq, int BK, int causal) {
  if (!causal) return (long long)kt * Tq;
  const long long tiles = ((long long)Tq + BK - 1) / BK;
  const long long m = kt < tiles ? kt : tiles;
  return m * Tq - (long long)BK * m * (m - 1) / 2;
}

template <int D, int SK, int BQ>
struct Shape {
  static constexpr int BK = 64 * SK;           // keys of a CTA
  static constexpr int KEYS = 4 * SK;          // keys of a thread: ty*4 + i + 64*s
  static constexpr int QJ = BQ / 16;           // queries of a thread in S/dP: tx + 16 j
  static constexpr int RQ = BQ / 16;           // dQ rows of a thread: ty*RQ + i
  static constexpr int SD = D + 4;             // padded row of K, V, Q, dO
  static constexpr int SP = BK + 4;            // padded row of P, dS
  static constexpr int STAGE = 2 * BQ * SD + 2 * BQ;
  static constexpr size_t SMEM =
      sizeof(float) * ((size_t)2 * BK * SD + (size_t)STAGES * STAGE + (size_t)2 * BQ * SP);
};

template <int D, int SK, int BQ>
__global__ void __launch_bounds__(NT, 1) flash_bwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
    float* __restrict__ ws, int BH, int Tq, int Tk, float scale, int causal,
    long long ws_rows) {
  using S = Shape<D, SK, BQ>;
  using C = OutCols<D>;
  constexpr int BK = S::BK, KEYS = S::KEYS, QJ = S::QJ, RQ = S::RQ, SD = S::SD, SP = S::SP;
  constexpr int NC = C::NC, CW = C::CW, NG = C::NG, V4 = D / 4;
  static_assert(BK % BQ == 0, "a key tile is whole q tiles");
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * SD;
  float* ring = Vs + BK * SD;
  float* Ps = ring + STAGES * S::STAGE;
  float* dSs = Ps + BQ * SP;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int kt = blockIdx.x / BH;
  const int bh = blockIdx.x - kt * BH;
  const int k0 = kt * BK;
  const int n_qt = (Tq + BQ - 1) / BQ;
  const int qt0 = causal ? k0 / BQ : 0;
  const int nq = qt0 < n_qt ? n_qt - qt0 : 0;
  const float* qg = q + (size_t)bh * Tq * D;
  const float* dog = dout + (size_t)bh * Tq * D;
  const float* kg = k + (size_t)bh * Tk * D;
  const float* vg = v + (size_t)bh * Tk * D;

  // K and V of this key tile, then the first q tiles, each a cp.async group
  for (int idx = tid; idx < BK * V4; idx += NT) {
    const int r = idx / V4, c = (idx - r * V4) * 4;
    const bool ok = k0 + r < Tk;
    const size_t off = ok ? (size_t)(k0 + r) * D + c : 0;
    cp_async16(smem_addr(Ks + r * SD + c), kg + off, ok);
    cp_async16(smem_addr(Vs + r * SD + c), vg + off, ok);
  }
  auto load_stage = [&](int buf, int qt) {
    float* Qs = ring + buf * S::STAGE;
    float* dOs = Qs + BQ * SD;
    float* ls = dOs + BQ * SD;
    const int q0 = qt * BQ;
    for (int idx = tid; idx < BQ * V4; idx += NT) {
      const int r = idx / V4, c = (idx - r * V4) * 4;
      const bool ok = q0 + r < Tq;
      const size_t off = ok ? (size_t)(q0 + r) * D + c : 0;
      cp_async16(smem_addr(Qs + r * SD + c), qg + off, ok);
      cp_async16(smem_addr(dOs + r * SD + c), dog + off, ok);
    }
    if (tid < 2 * BQ) {                  // lse, then delta, of the tile's rows
      const int r = tid % BQ;
      const bool ok = q0 + r < Tq;
      const float* src = (tid < BQ ? lse : delta) + (ok ? (size_t)bh * Tq + q0 + r : 0);
      cp_async4(smem_addr(ls + tid), src, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nq) load_stage(s, qt0 + s);
    cp_async_commit();
  }

  float dk_acc[KEYS][NC], dv_acc[KEYS][NC];
#pragma unroll
  for (int a = 0; a < KEYS; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[a][c] = dv_acc[a][c] = 0.f;

  float* wsg = ws + ((size_t)bh * ws_rows + ws_off(kt, Tq, BK, causal)) * D;

  for (int it = 0; it < nq; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();                     // the tile has landed; the last one's P, dS are read
    const int next = it + STAGES - 1;
    if (next < nq) load_stage(next % STAGES, qt0 + next);
    cp_async_commit();

    const float* Qs = ring + (it % STAGES) * S::STAGE;
    const float* dOs = Qs + BQ * SD;
    const float* lse_s = dOs + BQ * SD;
    const float* delta_s = lse_s + BQ;
    const int q0 = (qt0 + it) * BQ;

    // S^T and dP^T: keys ty*4 + i + 64 s (a = 4 s + i) by queries tx + 16 j
    float st[KEYS][QJ], dpt[KEYS][QJ];
#pragma unroll
    for (int a = 0; a < KEYS; ++a)
#pragma unroll
      for (int j = 0; j < QJ; ++j) st[a][j] = dpt[a][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 qv[QJ], ov[QJ];
#pragma unroll
      for (int j = 0; j < QJ; ++j) {
        qv[j] = *reinterpret_cast<const float4*>(Qs + (tx + 16 * j) * SD + d);
        ov[j] = *reinterpret_cast<const float4*>(dOs + (tx + 16 * j) * SD + d);
      }
#pragma unroll
      for (int a = 0; a < KEYS; ++a) {
        const int key = ty * 4 + (a & 3) + 64 * (a >> 2);
        const float4 kv = *reinterpret_cast<const float4*>(Ks + key * SD + d);
        const float4 vv = *reinterpret_cast<const float4*>(Vs + key * SD + d);
#pragma unroll
        for (int j = 0; j < QJ; ++j) {
          st[a][j] = dot4(kv, qv[j], st[a][j]);
          dpt[a][j] = dot4(vv, ov[j], dpt[a][j]);
        }
      }
    }
    // P and dS, one expf a pair, to shared memory as [query][key]
#pragma unroll
    for (int j = 0; j < QJ; ++j) {
      const int qi = tx + 16 * j;
      const int qp = q0 + qi;
      const float l = lse_s[qi], dl = delta_s[qi];
#pragma unroll
      for (int a = 0; a < KEYS; ++a) {
        const int kp = k0 + ty * 4 + (a & 3) + 64 * (a >> 2);
        const bool keep = kp < Tk && qp < Tq && !(causal && kp > qp);
        const float p = keep ? expf(st[a][j] * scale - l) : 0.f;
        st[a][j] = p;
        dpt[a][j] = p * (dpt[a][j] - dl) * scale;
      }
#pragma unroll
      for (int s = 0; s < SK; ++s) {
        const int o = qi * SP + ty * 4 + 64 * s;
        *reinterpret_cast<float4*>(Ps + o) =
            make_float4(st[4 * s][j], st[4 * s + 1][j], st[4 * s + 2][j], st[4 * s + 3][j]);
        *reinterpret_cast<float4*>(dSs + o) =
            make_float4(dpt[4 * s][j], dpt[4 * s + 1][j], dpt[4 * s + 2][j], dpt[4 * s + 3][j]);
      }
    }
    __syncthreads();

    // dV += P^T dO, dK += dS^T Q over the tile's queries
#pragma unroll 4
    for (int qq = 0; qq < BQ; ++qq) {
      float pa[KEYS], da[KEYS], ob[NC], qb[NC];
#pragma unroll
      for (int s = 0; s < SK; ++s) {
        const float4 pv = *reinterpret_cast<const float4*>(Ps + qq * SP + ty * 4 + 64 * s);
        const float4 dv4 = *reinterpret_cast<const float4*>(dSs + qq * SP + ty * 4 + 64 * s);
        pa[4 * s] = pv.x; pa[4 * s + 1] = pv.y; pa[4 * s + 2] = pv.z; pa[4 * s + 3] = pv.w;
        da[4 * s] = dv4.x; da[4 * s + 1] = dv4.y; da[4 * s + 2] = dv4.z; da[4 * s + 3] = dv4.w;
      }
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        ldv<CW>(ob + g * CW, dOs + qq * SD + C::col(tx, g));
        ldv<CW>(qb + g * CW, Qs + qq * SD + C::col(tx, g));
      }
#pragma unroll
      for (int a = 0; a < KEYS; ++a)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          dv_acc[a][c] = fmaf(pa[a], ob[c], dv_acc[a][c]);
          dk_acc[a][c] = fmaf(da[a], qb[c], dk_acc[a][c]);
        }
    }

    // this tile's dQ partial: rows ty*RQ + i, dS[q][:] K, into the workspace
    float dq_acc[RQ][NC];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) dq_acc[i][c] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 a4[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
        a4[i] = *reinterpret_cast<const float4*>(dSs + (ty * RQ + i) * SP + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float kb[NC];
#pragma unroll
        for (int g = 0; g < NG; ++g) ldv<CW>(kb + g * CW, Ks + (kk + u) * SD + C::col(tx, g));
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          const float w = lane(a4[i], u);
#pragma unroll
          for (int c = 0; c < NC; ++c) dq_acc[i][c] = fmaf(w, kb[c], dq_acc[i][c]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = ty * RQ + i;
      if (q0 + r >= Tq) continue;
      float* row = wsg + (size_t)(q0 - qt0 * BQ + r) * D;
#pragma unroll
      for (int g = 0; g < NG; ++g) stv<CW>(row + C::col(tx, g), dq_acc[i] + g * CW);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int a = 0; a < KEYS; ++a) {
    const int kp = k0 + ty * 4 + (a & 3) + 64 * (a >> 2);
    if (kp >= Tk) continue;
    const size_t o = ((size_t)bh * Tk + kp) * D;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      stv<CW>(dk + o + C::col(tx, g), dk_acc[a] + g * CW);
      stv<CW>(dv + o + C::col(tx, g), dv_acc[a] + g * CW);
    }
  }
}

// dq[bh, q, :] = the partials of key tiles 0, 1, ... that hold row q, added in that order;
// one thread a float4 of a row
__global__ void __launch_bounds__(256) dq_sum_kernel(const float* __restrict__ ws,
                                                     float* __restrict__ dq, int BH, int Tq,
                                                     int D, int BK, int n_kt, int causal,
                                                     long long ws_rows) {
  const int V4 = D / 4;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)BH * Tq * V4) return;
  const int c = (int)(i % V4);
  const long long row = i / V4;
  const int qp = (int)(row % Tq);
  const long long bh = row / Tq;
  const int last = causal ? min(n_kt - 1, qp / BK) : n_kt - 1;
  const float4* w = reinterpret_cast<const float4*>(ws + (size_t)bh * ws_rows * D) + c;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  long long off = 0;
  for (int kt = 0; kt <= last; ++kt) {
    const long long lo = causal ? (long long)kt * BK : 0;
    const float4 t = w[(off + qp - lo) * V4];
    s.x += t.x;
    s.y += t.y;
    s.z += t.z;
    s.w += t.w;
    off += Tq - lo;
  }
  reinterpret_cast<float4*>(dq)[i] = s;
}

// above 48 KB of dynamic shared memory only after this, once a device and instantiation
template <int D, int SK, int BQ>
cudaError_t allow_smem(int device) {
  static bool done[64];
  if (device >= 0 && device < 64 && done[device]) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_kernel<D, SK, BQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Shape<D, SK, BQ>::SMEM);
  if (err == cudaSuccess && device >= 0 && device < 64) done[device] = true;
  return err;
}

template <int D, int SK, int BQ>
cudaError_t launch_bwd(const float* q, const float* k, const float* v, const float* dout,
                       const float* lse, const float* delta, float* dk, float* dv, float* ws,
                       int BH, int Tq, int Tk, float scale, int causal, long long ws_rows,
                       int device, cudaStream_t s) {
  cudaError_t err = allow_smem<D, SK, BQ>(device);
  if (err != cudaSuccess) return err;
  const int n_kt = (Tk + Shape<D, SK, BQ>::BK - 1) / Shape<D, SK, BQ>::BK;
  flash_bwd_kernel<D, SK, BQ><<<(unsigned)((long long)BH * n_kt), NT, Shape<D, SK, BQ>::SMEM,
                                s>>>(q, k, v, dout, lse, delta, dk, dv, ws, BH, Tq, Tk, scale,
                                     causal, ws_rows);
  return cudaGetLastError();
}

template <int D, int SK, int BQ>
cudaError_t occupancy(int* blocks, int device) {
  cudaError_t err = allow_smem<D, SK, BQ>(device);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, flash_bwd_kernel<D, SK, BQ>, NT,
                                                       Shape<D, SK, BQ>::SMEM);
}

// keys of a CTA at head dim D (the instantiations below), or 0 for another D
int keys_of(int D) {
  switch (D) {
    case 16: case 32: case 64: return 128;
    case 128: return 64;
    default: return 0;
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  q and dout (BH, Tq, D), k and v (BH, Tk, D), lse
// and delta (BH, Tq), outputs dq (BH, Tq, D), dk and dv (BH, Tk, D), and the dQ workspace
// (BH, ws_rows, D); all fp32, contiguous, 16-byte aligned, on `device`.  bk (keys of a CTA)
// and ws_rows come from the host plan (ops/hopper_attention.py flash_bwd_plan) and must be
// this file's: 128 for D 16, 32 and 64, 64 for D 128, ws_rows = off(ceil(Tk / bk)).
// Launches the fused kernel and the dq sum on `stream` and counts each launch in
// launched[0] and launched[1], which it zeroes first.  Returns 0, or the CUDA error:
// cudaErrorInvalidValue for an empty shape, a grid too large, another D, bk or ws_rows.
extern "C" int mxtt_flash_attn_bwd(const float* q, const float* k, const float* v,
                                   const float* dout, const float* lse, const float* delta,
                                   float* dq, float* dk, float* dv, float* ws, int BH, int Tq,
                                   int Tk, int D, float scale, int causal, int bk,
                                   long long ws_rows, int device, void* stream,
                                   int* launched) {
  launched[0] = launched[1] = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bk == 0 || bk != keys_of(D) || BH < 1 || Tq < 1 || Tk < 1)
    return (int)cudaErrorInvalidValue;
  const int n_kt = (Tk + bk - 1) / bk;
  const long long total4 = (long long)BH * Tq * (D / 4);
  if ((long long)BH * n_kt >= (1LL << 31) || (total4 + 255) / 256 >= (1LL << 31) ||
      ws_rows != ws_off(n_kt, Tq, bk, causal))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MXTT_BWD(D_, SK_, BQ_)                                                               \
  launch_bwd<D_, SK_, BQ_>(q, k, v, dout, lse, delta, dk, dv, ws, BH, Tq, Tk, scale, causal, \
                           ws_rows, device, s)
  switch (D) {
    case 16: err = MXTT_BWD(16, 2, 64); break;
    case 32: err = MXTT_BWD(32, 2, 64); break;
    case 64: err = MXTT_BWD(64, 2, 64); break;
    default: err = MXTT_BWD(128, 1, 32); break;
  }
#undef MXTT_BWD
  if (err != cudaSuccess) return (int)err;
  launched[0] = 1;
  dq_sum_kernel<<<(unsigned)((total4 + 255) / 256), 256, 0, s>>>(ws, dq, BH, Tq, D, bk, n_kt,
                                                                 causal, ws_rows);
  err = cudaGetLastError();
  if (err == cudaSuccess) launched[1] = 1;
  return (int)err;
}

// Blocks of the fused kernel at head dim D that one SM holds at once, into *blocks: what the
// design assumes (1), read on the card.  Returns a CUDA error code.
extern "C" int mxtt_flash_attn_bwd_occupancy(int D, int device, int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  switch (D) {
    case 16: err = occupancy<16, 2, 64>(blocks, device); break;
    case 32: err = occupancy<32, 2, 64>(blocks, device); break;
    case 64: err = occupancy<64, 2, 64>(blocks, device); break;
    case 128: err = occupancy<128, 1, 32>(blocks, device); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}
