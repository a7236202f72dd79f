// Flash attention backward, for Hopper (sm_90a): kernels 6 and 7 of the port.
//
// Replaces the two TPU kernels of mxnet_tpu/ops/pallas_attention.py:flash_attention_bwd
// (:359): the dq kernel _dq_kernel (:276, launched at :377) and the dk/dv kernel _dkv_kernel
// (:315, launched at :393).  Given q, dO (BH, Tq, D), k, v (BH, Tk, D), the forward's
// lse (BH, Tq) and delta = rowsum(dO * out) (BH, Tq), both recompute
//
//   p[i, j]  = exp(scale * q_i . k_j - lse_i)      (0 where masked: causal j > i, or out of range)
//   ds[i, j] = p[i, j] * (dO_i . v_j - delta_i) * scale
//
// and write, in fp32,
//   kernel 6: dq_i = sum_j ds[i, j] k_j                                        (BH, Tq, D)
//   kernel 7: dv_j = sum_i p[i, j] dO_i,   dk_j = sum_i ds[i, j] q_i           (BH, Tk, D)
// Two launches, no atomics: each output row is summed by one thread in a fixed order, so
// the result is deterministic.  scale enters s once and ds once, as in the reference.
//
// Numerics: fp32 FMA on the CUDA cores, expf; against the plain PyTorch version
// (flash_bwd_plain in ops/hopper_attention.py) only the order of the sums differs;
// chip_smoke.py holds every output within 1e-4 of its largest |value|.
//
// Design, as the forward (flash_attn_fwd.cu): 256 threads, 64-row tiles in shared memory
// with rows padded by 4 floats, a 4 x 4 register micro-tile of the (64 x 64) score tile per
// thread (rows 4 ty + i, columns tx + 16 j) computed from float4 loads, the (64 x 64) tile
// of p or ds passed through shared memory, and D / 16 output columns per thread and row.
//   - Kernel 6: grid (BH, ceil(Tq/64)).  The block keeps its Q and dO tiles, its rows' lse
//     and delta in registers, and loops over K/V tiles up to the last one that meets the
//     diagonal (causal), as _dq_kernel's loop bound (:311).
//   - Kernel 7: grid (BH, ceil(Tk/64)).  The block keeps its K and V tiles and loops over
//     Q/dO tiles from the first one that can see its keys (lo = k0 / 64, as :352); it
//     computes the transposed score tile (keys as rows), so that p^T and ds^T sit in shared
//     memory ready for dv += p^T dO and dk += ds^T q.
// D is a template parameter: 16, 32, 64 or 128.  Shared memory at D = 64: 85 KB (kernel 6),
// 102 KB (kernel 7); at D = 128: 150 KB and 168 KB.
//
// Bound at the slice's shape (B = 16, H = 12, T = 1024, D = 64, causal), with the masked half
// skipped: kernel 6 does 3 T^2 D FLOP per (b, h), 38.7 GFLOP, 0.577 ms at 67 TFLOP/s fp32;
// kernel 7 does 4 T^2 D, 51.5 GFLOP, 0.769 ms.  Their bytes (q, k, v, dO and the outputs,
// 250-300 MB) take under 0.1 ms at 3.35 TB/s, so both are bound by operations.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;    // query rows per tile
constexpr int BK = 64;    // key rows per tile
constexpr int NT = 256;   // threads per block: 16 x 16

template <int D>
struct OutCols {
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

template <int D, int ROWS>
__device__ __forceinline__ void load_tile(float* s, const float* g, int r0, int T) {
  constexpr int SD = D + 4, V4 = D / 4;
  for (int idx = threadIdx.x; idx < ROWS * V4; idx += NT) {
    const int r = idx / V4, c = (idx - r * V4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < T) v = *reinterpret_cast<const float4*>(g + (size_t)(r0 + r) * D + c);
    *reinterpret_cast<float4*>(s + r * SD + c) = v;
  }
}

// s[i][j] = A[4 ty + i] . B[tx + 16 j] over D, A and B in shared memory with row stride D + 4.
template <int D>
__device__ __forceinline__ void tile_dots(float (&s)[4][4], const float* A, const float* B,
                                          int ty, int tx) {
  constexpr int SD = D + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(A + (ty * 4 + i) * SD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * SD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float t = s[i][j];
        t = fmaf(a[i].x, b[j].x, t);
        t = fmaf(a[i].y, b[j].y, t);
        t = fmaf(a[i].z, b[j].z, t);
        t = fmaf(a[i].w, b[j].w, t);
        s[i][j] = t;
      }
  }
}

// acc[i][c] += sum_k P[4 ty + i][k] * M[k][col c], P (64 x 64, row stride 68) and M (64 x D,
// row stride D + 4) in shared memory.
template <int D>
__device__ __forceinline__ void tile_accum(float (&acc)[4][D / 16], const float* P,
                                           const float* M, int ty, int tx) {
  using C = OutCols<D>;
  constexpr int SD = D + 4, SP = 64 + 4;
#pragma unroll 2
  for (int kk = 0; kk < 64; kk += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = *reinterpret_cast<const float4*>(P + (ty * 4 + i) * SP + kk);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float mv[C::NC];
#pragma unroll
      for (int g = 0; g < C::NG; ++g) ldv<C::CW>(mv + g * C::CW, M + (kk + u) * SD + C::col(tx, g));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pu = u == 0 ? p[i].x : u == 1 ? p[i].y : u == 2 ? p[i].z : p[i].w;
#pragma unroll
        for (int c = 0; c < C::NC; ++c) acc[i][c] = fmaf(pu, mv[c], acc[i][c]);
      }
    }
  }
}

template <int D>
__device__ __forceinline__ void store_rows(float* g, const float (&acc)[4][D / 16], int r0,
                                           int T, int ty, int tx) {
  using C = OutCols<D>;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= T) continue;
#pragma unroll
    for (int g2 = 0; g2 < C::NG; ++g2)
      stv<C::CW>(g + (size_t)r * D + C::col(tx, g2), acc[i] + g2 * C::CW);
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * ((size_t)(2 * BQ + 2 * BK) * (D + 4) + (size_t)BQ * (BK + 4));
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * ((size_t)(2 * BQ + 2 * BK) * (D + 4) + 2 * (size_t)BK * (BQ + 4)
                          + 2 * BQ);
}

template <int D>
__global__ void __launch_bounds__(NT) flash_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int Tq, int Tk, float scale,
    int causal) {
  constexpr int SD = D + 4, SP = BK + 4;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * SD;
  float* Ks = dOs + BQ * SD;
  float* Vs = Ks + BK * SD;
  float* Ss = Vs + BK * SD;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* kg = k + (size_t)bh * Tk * D;
  const float* vg = v + (size_t)bh * Tk * D;
  load_tile<D, BQ>(Qs, q + (size_t)bh * Tq * D, q0, Tq);
  load_tile<D, BQ>(dOs, dout + (size_t)bh * Tq * D, q0, Tq);

  float lse_r[4], delta_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    lse_r[i] = r < Tq ? lse[(size_t)bh * Tq + r] : INFINITY;
    delta_r[i] = r < Tq ? delta[(size_t)bh * Tq + r] : 0.f;
  }
  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;

  int n_kt = (Tk + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (min(q0 + BQ, Tq) - 1) / BK + 1);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile<D, BK>(Ks, kg, k0, Tk);
    load_tile<D, BK>(Vs, vg, k0, Tk);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dots<D>(s, Qs, Ks, ty, tx);
    tile_dots<D>(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool keep = kp < Tk && !(causal && kp > qp);
        const float p = keep ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        Ss[(ty * 4 + i) * SP + tx + 16 * j] = p * (dp[i][j] - delta_r[i]) * scale;
      }
    }
    __syncthreads();
    tile_accum<D>(acc, Ss, Ks, ty, tx);
  }
  store_rows<D>(dq + (size_t)bh * Tq * D, acc, q0, Tq, ty, tx);
}

template <int D>
__global__ void __launch_bounds__(NT) flash_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int Tq,
    int Tk, float scale, int causal) {
  constexpr int SD = D + 4, SP = BQ + 4;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * SD;
  float* Qs = Vs + BK * SD;
  float* dOs = Qs + BQ * SD;
  float* Pt = dOs + BQ * SD;
  float* dSt = Pt + BK * SP;
  float* lse_s = dSt + BK * SP;
  float* delta_s = lse_s + BQ;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* qg = q + (size_t)bh * Tq * D;
  const float* dog = dout + (size_t)bh * Tq * D;
  load_tile<D, BK>(Ks, k + (size_t)bh * Tk * D, k0, Tk);
  load_tile<D, BK>(Vs, v + (size_t)bh * Tk * D, k0, Tk);

  float dk_acc[4][D / 16], dv_acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int n_qt = (Tq + BQ - 1) / BQ;
  const int lo = causal ? k0 / BQ : 0;
  for (int qt = lo; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();
    load_tile<D, BQ>(Qs, qg, q0, Tq);
    load_tile<D, BQ>(dOs, dog, q0, Tq);
    if (threadIdx.x < BQ) {
      const int r = q0 + threadIdx.x;
      lse_s[threadIdx.x] = r < Tq ? lse[(size_t)bh * Tq + r] : INFINITY;
      delta_s[threadIdx.x] = r < Tq ? delta[(size_t)bh * Tq + r] : 0.f;
    }
    __syncthreads();

    // transposed tiles: rows are this block's keys (4 ty + i), columns queries (tx + 16 j)
    float st[4][4], dpt[4][4];
    tile_dots<D>(st, Ks, Qs, ty, tx);
    tile_dots<D>(dpt, Vs, dOs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kp = k0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qj = tx + 16 * j;
        const int qp = q0 + qj;
        const bool keep = qp < Tq && !(causal && kp > qp);
        const float p = keep ? expf(st[i][j] * scale - lse_s[qj]) : 0.f;
        Pt[(ty * 4 + i) * SP + qj] = p;
        dSt[(ty * 4 + i) * SP + qj] = p * (dpt[i][j] - delta_s[qj]) * scale;
      }
    }
    __syncthreads();
    tile_accum<D>(dv_acc, Pt, dOs, ty, tx);
    tile_accum<D>(dk_acc, dSt, Qs, ty, tx);
  }
  store_rows<D>(dk + (size_t)bh * Tk * D, dk_acc, k0, Tk, ty, tx);
  store_rows<D>(dv + (size_t)bh * Tk * D, dv_acc, k0, Tk, ty, tx);
}

template <int D>
int launch_dq(const float* q, const float* k, const float* v, const float* dout,
              const float* lse, const float* delta, float* dq, int BH, int Tq, int Tk,
              float scale, int causal, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute((const void*)flash_dq_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_dq_kernel<D><<<dim3(BH, (Tq + BQ - 1) / BQ), NT, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, Tq, Tk, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const float* q, const float* k, const float* v, const float* dout,
               const float* lse, const float* delta, float* dk, float* dv, int BH, int Tq,
               int Tk, float scale, int causal, cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute((const void*)flash_dkv_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_dkv_kernel<D><<<dim3(BH, (Tk + BK - 1) / BK), NT, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, Tq, Tk, scale, causal);
  return (int)cudaGetLastError();
}

bool bad_shape(int BH, int Tq, int Tk) {
  return BH < 1 || Tq < 1 || Tk < 1 || (Tq + BQ - 1) / BQ > 65535 || (Tk + BK - 1) / BK > 65535;
}

}  // namespace

// Plain C entry points, bound with ctypes.  q and dout (BH, Tq, D), k and v (BH, Tk, D), lse
// and delta (BH, Tq), outputs dq (BH, Tq, D) (kernel 6) or dk, dv (BH, Tk, D) (kernel 7); all
// fp32, contiguous, 16-byte aligned, on `device`.  Each launches one kernel on `stream` and
// sets *launched to 1 when it did.  Returns 0, or the CUDA error: cudaErrorInvalidValue for
// an empty shape, a grid too tall, or a D other than 16, 32, 64 and 128.
extern "C" int mxtt_flash_attn_bwd_dq(const float* q, const float* k, const float* v,
                                      const float* dout, const float* lse, const float* delta,
                                      float* dq, int BH, int Tq, int Tk, int D, float scale,
                                      int causal, int device, void* stream, int* launched) {
  *launched = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_shape(BH, Tq, Tk)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  switch (D) {
    case 16: rc = launch_dq<16>(q, k, v, dout, lse, delta, dq, BH, Tq, Tk, scale, causal, s); break;
    case 32: rc = launch_dq<32>(q, k, v, dout, lse, delta, dq, BH, Tq, Tk, scale, causal, s); break;
    case 64: rc = launch_dq<64>(q, k, v, dout, lse, delta, dq, BH, Tq, Tk, scale, causal, s); break;
    case 128: rc = launch_dq<128>(q, k, v, dout, lse, delta, dq, BH, Tq, Tk, scale, causal, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc == 0) *launched = 1;
  return rc;
}

extern "C" int mxtt_flash_attn_bwd_dkv(const float* q, const float* k, const float* v,
                                       const float* dout, const float* lse, const float* delta,
                                       float* dk, float* dv, int BH, int Tq, int Tk, int D,
                                       float scale, int causal, int device, void* stream,
                                       int* launched) {
  *launched = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_shape(BH, Tq, Tk)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  switch (D) {
    case 16: rc = launch_dkv<16>(q, k, v, dout, lse, delta, dk, dv, BH, Tq, Tk, scale, causal, s); break;
    case 32: rc = launch_dkv<32>(q, k, v, dout, lse, delta, dk, dv, BH, Tq, Tk, scale, causal, s); break;
    case 64: rc = launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, BH, Tq, Tk, scale, causal, s); break;
    case 128: rc = launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, BH, Tq, Tk, scale, causal, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc == 0) *launched = 1;
  return rc;
}
