// The toolchain probe's kernel (K12): o = 2 x over n floats.  Replaces the
// Pallas compile-and-run probe of tools/tpu_probe.py (its `kernel`, o = 2 x
// on one (8, 128) float32 block).  The point is the toolchain, not the
// arithmetic: nvcc builds this file alone for sm_90a into its own library,
// ctypes loads it, and the probe checks the result exactly.  At (8, 128) the
// work is 8 KB of traffic, under a microsecond at 3.35 TB/s: the launch's
// time is its latency.
#include <cuda_runtime.h>

namespace {

__global__ void scale2_kernel(const float* __restrict__ x, float* __restrict__ o,
                              int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = 2.f * x[i];
}

}  // namespace

extern "C" int fcvsr_probe_scale2(const float* x, float* o, int n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  scale2_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(x, o, n);
  return (int)cudaGetLastError();
}

extern "C" const char* fcvsr_probe_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
