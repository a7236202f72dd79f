// Zero-fill, for Hopper (sm_90a): kernel 10 of the port, the probe of branch selection.
//
// Replaces the TPU kernel of mxnet_tpu/parallel/_compat.py:_platform_dependent_prunes (:36-60):
// _kernel (:45, launched by pl.pallas_call at :49), which writes zeros into an (8, 128) fp32
// block.  The reference compiles it once a process to learn whether its platform branch can
// carry a kernel; the port's platform_dependent (parallel/_compat.py) launches this kernel once
// a process and device, the first time it picks the gpu branch, over an (8, 128) buffer filled
// with NaN, and checks that it holds zeros: a build or launch that fails there raises before
// any kernel of the branch runs.
//
//   out[i] = 0.0f  for 0 <= i < n        (fp32, contiguous)
//
// One thread an element, 256 threads a block, ceil(n / 256) blocks.  Bound: 4 n bytes written
// at 3.35 TB/s (4 KB at the probe's size: the launch itself, some microseconds, is its cost).

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;

__global__ void __launch_bounds__(NT) zero_fill_kernel(float* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * NT + threadIdx.x;
  if (i < n) out[i] = 0.f;
}

}  // namespace

// Plain C entry point, bound with ctypes.  out: n fp32 values on `device`.  Launches one kernel
// on `stream` when n > 0 and sets *launched to 1 when it did; n == 0 launches nothing.  Returns
// 0, or the CUDA error: cudaErrorInvalidValue for n < 0 or more than 2^31 - 1 blocks.
extern "C" int mxtt_zero_fill(float* out, long long n, int device, void* stream, int* launched) {
  *launched = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (n + NT - 1) / NT;
  if (n < 0 || blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  zero_fill_kernel<<<(unsigned)blocks, NT, 0, static_cast<cudaStream_t>(stream)>>>(out, n);
  err = cudaGetLastError();
  if (err == cudaSuccess) *launched = 1;
  return (int)err;
}
