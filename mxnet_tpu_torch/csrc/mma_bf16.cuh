// PTX building blocks of the bf16 tensor-core kernels (taps_conv_bf16.cu,
// taps_wgrad_bf16.cu, conv1x1_wgrad.cu): ldmatrix, mma.sync m16n8k16 (bf16 in, fp32
// accumulate), the XOR swizzle of 16-byte chunks and the element load path; the cp.async
// copies with zero fill come from cp_async.cuh.
#pragma once

#include <cuda_bf16.h>

#include "cp_async.cuh"

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a . b, m16n8k16, bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// byte offset of 16-byte chunk `chunk` of row `row` in a tile of `row_bytes` rows, the
// chunk XOR-swizzled by the row's low three bits (8 rows of ldmatrix hit 8 bank groups)
__device__ __forceinline__ uint32_t swz(int row, int chunk, int row_bytes) {
  return (uint32_t)(row * row_bytes + ((chunk ^ (row & 7)) << 4));
}

// the 8 bf16 at p[0..7], each only where ok(j): the load path for unaligned or ragged data
template <class Ok>
__device__ __forceinline__ uint4 load8(const bf16* p, Ok ok) {
  __align__(16) bf16 v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = ok(j) ? p[j] : __float2bfloat16(0.f);
  return *reinterpret_cast<const uint4*>(v);
}

}  // namespace
