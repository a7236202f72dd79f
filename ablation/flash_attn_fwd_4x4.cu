// The flash attention forward as it stood before its redesign (4 x 4 register tiles, K and V
// loaded between barriers, three barriers a key tile, lightest query tiles first), kept only
// as a build of `chip_ab.py ablate`: it is not part of the package, and nothing else builds
// or calls it.  mxnet_tpu_torch/csrc/flash_attn_fwd.cu holds the kernel the port runs.
//
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
// order of the sums differs; chip_smoke.py holds out, lse, m and l within 1e-5 absolute and
// acc within 1e-5 of its largest |value|.
//
// Design.  The TPU kernel keeps all of K and V resident in VMEM for one (b*h) program and
// walks the K blocks on the core.  Here K and V stream through shared memory:
//   - a block of 256 threads owns BQ = 64 query rows of one (b*h): grid (BH, ceil(Tq/64));
//   - its Q tile stays in shared memory; K and V come in tiles of BK = 64 rows, each row
//     padded by 4 floats, so that the 16-byte loads of 8 neighbouring threads fall in
//     distinct banks;
//   - thread (ty, tx) (16 x 16) keeps a 4 x 4 micro-tile of S: rows 4 ty .. 4 ty + 3, columns
//     tx + 16 j.  S = Q K^T runs over D in steps of 4 (one float4 of Q and of K per row and
//     column: 8 shared loads for 64 FMAs);
//   - the 16 threads of a row group hold whole rows of S, so the row max and row sum are
//     two shuffle reductions within 16 lanes, and the thread keeps m and l of its 4 rows;
//   - P goes through shared memory (64 x 68 floats), and the same thread then accumulates
//     its 4 rows of out for D / 16 columns (tx * 4 + c, in float4 groups) from P and V;
//   - with a causal mask the loop stops at the last K tile that meets the diagonal; rows
//     and columns past Tq or Tk are masked, so any Tq, Tk >= 1 is taken.
// D is a template parameter: 16, 32, 64 or 128.  Shared memory: (BQ + 2 BK)(D + 4) + BQ(BK + 4)
// floats, 68 KB at D = 64 (three blocks a SM) and 116 KB at D = 128.
//
// Bound at gpt2-small's training shape (B = 16, H = 12, T = 1024, D = 64, causal): 2 T^2 D
// FLOP per (b, h) with the masked half skipped, 25.8 GFLOP a call, 0.385 ms at 67 TFLOP/s
// fp32; 201 MB of q, k, v and out, 0.06 ms at 3.35 TB/s.  Kernel 4 at a ring step of the long
// context (B = 1, H = 12, T_loc = 4096, D = 64, unmasked): 51.5 GFLOP, 0.77 ms; 50 MB,
// 0.015 ms.  So all three are bound by operations.  This design loads K and V synchronously
// (other resident blocks hide the wait) and spends a shared load for each 8 FMAs; a later
// design would use tensor cores (TF32 or bf16 wgmma).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;    // query rows per block
constexpr int BK = 64;    // key rows per tile
constexpr int NT = 256;   // threads per block: 16 x 16

// What the epilogue writes: out (kernel 3), out and lse (kernel 5), or acc, m and l (kernel 4).
constexpr int MODE_OUT = 0;
constexpr int MODE_OUT_LSE = 1;
constexpr int MODE_STATS = 2;

// The D / 16 output columns of thread tx: groups of CW contiguous columns, tx * CW + 16 CW g + c.
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

// Rows [r0, r0 + ROWS) of a (T, D) row-major matrix into shared memory with row stride D + 4;
// rows past T are zeros.
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

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * ((size_t)(BQ + 2 * BK) * (D + 4) + (size_t)BQ * (BK + 4));
}

// out: the output (MODE_OUT, MODE_OUT_LSE) or acc (MODE_STATS); lse: lse (MODE_OUT_LSE) or m
// (MODE_STATS); lsum: l (MODE_STATS).  Pointers a mode does not write may be null.
template <int D, int MODE>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(const float* __restrict__ q,
                                                       const float* __restrict__ k,
                                                       const float* __restrict__ v,
                                                       float* __restrict__ out,
                                                       float* __restrict__ lse,
                                                       float* __restrict__ lsum, int Tq, int Tk,
                                                       float scale, int causal) {
  using C = OutCols<D>;
  constexpr int SD = D + 4, SP = BK + 4;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * SD;
  float* Vs = Ks + BK * SD;
  float* Ps = Vs + BK * SD;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* qg = q + (size_t)bh * Tq * D;
  const float* kg = k + (size_t)bh * Tk * D;
  const float* vg = v + (size_t)bh * Tk * D;

  load_tile<D, BQ>(Qs, qg, q0, Tq);

  float m[4], l[4], acc[4][C::NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C::NC; ++c) acc[i][c] = 0.f;
  }

  int n_kt = (Tk + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (min(q0 + BQ, Tq) - 1) / BK + 1);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    load_tile<D, BK>(Ks, kg, k0, Tk);
    load_tile<D, BK>(Vs, vg, k0, Tk);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(Qs + (ty * 4 + i) * SD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * SD + d);
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

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (kp >= Tk || (causal && kp > qp)) x = -INFINITY;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = row_max16(mx);
      const float m_new = fmaxf(m[i], mx);
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      const float alpha = isfinite(m[i]) ? expf(m[i] - m_safe) : 0.f;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_safe);
        rs += p;
        Ps[(ty * 4 + i) * SP + tx + 16 * j] = p;
      }
      rs = row_sum16(rs);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < C::NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = *reinterpret_cast<const float4*>(Ps + (ty * 4 + i) * SP + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[C::NC];
#pragma unroll
        for (int g = 0; g < C::NG; ++g) ldv<C::CW>(vv + g * C::CW, Vs + (kk + u) * SD + C::col(tx, g));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pu = u == 0 ? p[i].x : u == 1 ? p[i].y : u == 2 ? p[i].z : p[i].w;
#pragma unroll
          for (int c = 0; c < C::NC; ++c) acc[i][c] = fmaf(pu, vv[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Tq) continue;
    const float den = fmaxf(l[i], 1e-37f);
    float o[C::NC];
#pragma unroll
    for (int c = 0; c < C::NC; ++c) o[c] = MODE == MODE_STATS ? acc[i][c] : acc[i][c] / den;
    float* og = out + ((size_t)bh * Tq + r) * D;
#pragma unroll
    for (int g = 0; g < C::NG; ++g) stv<C::CW>(og + C::col(tx, g), o + g * C::CW);
    if (tx != 0) continue;
    if (MODE == MODE_OUT_LSE) lse[(size_t)bh * Tq + r] = l[i] > 0.f ? m[i] + logf(den) : INFINITY;
    if (MODE == MODE_STATS) {
      lse[(size_t)bh * Tq + r] = m[i];
      lsum[(size_t)bh * Tq + r] = l[i];
    }
  }
}

template <int D, int MODE>
int launch_mode(const float* q, const float* k, const float* v, float* out, float* lse,
                float* lsum, int BH, int Tq, int Tk, float scale, int causal,
                cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute((const void*)flash_fwd_kernel<D, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(BH, (Tq + BQ - 1) / BQ);
  flash_fwd_kernel<D, MODE><<<grid, NT, smem, stream>>>(q, k, v, out, lse, lsum, Tq, Tk, scale,
                                                        causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* out, float* lse, float* lsum,
           int BH, int Tq, int Tk, float scale, int causal, int mode, cudaStream_t stream) {
  switch (mode) {
    case MODE_OUT:
      return launch_mode<D, MODE_OUT>(q, k, v, out, lse, lsum, BH, Tq, Tk, scale, causal, stream);
    case MODE_OUT_LSE:
      return launch_mode<D, MODE_OUT_LSE>(q, k, v, out, lse, lsum, BH, Tq, Tk, scale, causal,
                                          stream);
    case MODE_STATS:
      return launch_mode<D, MODE_STATS>(q, k, v, out, lse, lsum, BH, Tq, Tk, scale, causal,
                                        stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  q (BH, Tq, D), k and v (BH, Tk, D), out (BH, Tq, D),
// lse and lsum (BH, Tq), all fp32, contiguous, 16-byte aligned, on `device`.  mode 0 (kernel 3)
// writes out; mode 1 (kernel 5) out and lse; mode 2 (kernel 4) the unnormalised acc into out,
// m into lse and l into lsum.  A pointer the mode does not write may be null.  Launches one
// kernel on `stream` and sets *launched to 1 when it did.  Returns 0, or the CUDA error:
// cudaErrorInvalidValue for an empty shape, a grid too tall, an unknown mode, or a D other
// than 16, 32, 64 and 128.
extern "C" int mxtt_flash_attn_fwd(const float* q, const float* k, const float* v, float* out,
                                   float* lse, float* lsum, int BH, int Tq, int Tk, int D,
                                   float scale, int causal, int mode, int device, void* stream,
                                   int* launched) {
  *launched = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (BH < 1 || Tq < 1 || Tk < 1 || (Tq + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  switch (D) {
    case 16: rc = launch<16>(q, k, v, out, lse, lsum, BH, Tq, Tk, scale, causal, mode, s); break;
    case 32: rc = launch<32>(q, k, v, out, lse, lsum, BH, Tq, Tk, scale, causal, mode, s); break;
    case 64: rc = launch<64>(q, k, v, out, lse, lsum, BH, Tq, Tk, scale, causal, mode, s); break;
    case 128: rc = launch<128>(q, k, v, out, lse, lsum, BH, Tq, Tk, scale, causal, mode, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc == 0) *launched = 1;
  return rc;
}
