// The fixed-order sum of row-split partials that the weight-gradient kernels share
// (taps_wgrad.cu, taps_wgrad_bf16.cu, conv1x1_wgrad.cu): each of their partial passes
// writes one fp32 partial per split to a workspace (splits, total), and
//
//   out[i] = sum over the splits of part[s * total + i]
//
// in an order fixed by the split count alone, so the same inputs give the same bits on
// every run (fp32 atomics would not).  The splits are cut into up to 8 contiguous groups;
// a thread sums one group's partials of one element (4 elements, 16-byte loads, when
// total is a multiple of 4) in split order, and the group sums are added in group order
// through shared memory.  Summing groups in parallel keeps several loads of each element
// in flight when the output is small and the splits many (64 x 256 outputs from 132
// splits).  Tag names the instantiation, so that a trace tells each library's reduction
// apart: split_sum_kernel<Tag>.  It is launched as a programmatic dependent of the partial
// pass (Hopper): its launch is set up while the partial pass runs, and its threads wait
// (griddepcontrol.wait) until that pass has completed and its writes are visible before
// they read anything.  A partial pass calls allow_split_sum() once its main loop is done,
// so that the sum's blocks may be scheduled during its epilogue.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int SPLIT_SUM_LANES = 32;    // elements (or float4s) of a block
constexpr int SPLIT_SUM_GROUPS = 8;    // most groups of splits a block sums in parallel

// in a partial pass: its dependent split sum may be scheduled now
__device__ __forceinline__ void allow_split_sum() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

template <class Tag>
__global__ void __launch_bounds__(SPLIT_SUM_LANES * SPLIT_SUM_GROUPS)
split_sum_kernel(const float* __restrict__ part, float* __restrict__ out, long long total,
                 int splits) {
  __shared__ float4 sums[SPLIT_SUM_GROUPS][SPLIT_SUM_LANES];
  asm volatile("griddepcontrol.wait;\n" ::: "memory");   // the partial pass is done
  const int groups = blockDim.y, grp = threadIdx.y, lane = threadIdx.x;
  const int per = (splits + groups - 1) / groups;
  const int k0 = grp * per, k1 = k0 + per < splits ? k0 + per : splits;
  const bool vec = (total & 3) == 0;
  const long long items = vec ? total >> 2 : total;
  const long long i = (long long)blockIdx.x * SPLIT_SUM_LANES + lane;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (i < items) {
    if (vec) {
      const float4* p = reinterpret_cast<const float4*>(part) + i;
#pragma unroll 4
      for (int k = k0; k < k1; ++k) {
        const float4 v = p[(long long)k * items];
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
    } else {
#pragma unroll 4
      for (int k = k0; k < k1; ++k) s.x += part[(long long)k * total + i];
    }
  }
  if (groups > 1) {
    sums[grp][lane] = s;
    __syncthreads();
    if (grp != 0) return;
    for (int q = 1; q < groups; ++q) {
      const float4 v = sums[q][lane];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
  }
  if (i >= items) return;
  if (vec)
    reinterpret_cast<float4*>(out)[i] = s;
  else
    out[i] = s.x;
}

// Launches split_sum_kernel<Tag> on `stream`, right after the partial pass that wrote the
// (splits, total) fp32 workspace (16-byte aligned), into out (total).  Returns
// cudaGetLastError() after the launch.
template <class Tag>
cudaError_t launch_split_sum(const float* part, float* out, long long total, int splits,
                             cudaStream_t stream) {
  const long long items = (total & 3) == 0 ? total >> 2 : total;
  const int groups = splits < SPLIT_SUM_GROUPS ? splits : SPLIT_SUM_GROUPS;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((items + SPLIT_SUM_LANES - 1) / SPLIT_SUM_LANES));
  cfg.blockDim = dim3(SPLIT_SUM_LANES, groups);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, split_sum_kernel<Tag>, part, out, total, splits);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
