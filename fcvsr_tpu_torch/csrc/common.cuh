// Shared helpers of the port's CUDA kernels.
#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <mutex>

namespace fcvsr {

constexpr int kThreads = 256;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float leaky(float v, float slope) {
  return v >= 0.f ? v : slope * v;
}

constexpr int kMaxDevices = 64;

// Let `Kernel` launch with `bytes` of dynamic shared memory: anything above
// 48 KB needs the attribute on the function.  The ceiling granted on each
// device is kept, so the driver is called only when a launch needs more;
// the mutex keeps two threads from lowering each other's ceiling.
template <auto Kernel>
cudaError_t allow_smem(size_t bytes) {
  if (bytes > 232448) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  static std::atomic<size_t> granted[kMaxDevices];
  static std::mutex mu;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool kept = dev < kMaxDevices;
  if (kept && granted[dev].load() >= bytes) return cudaSuccess;
  std::lock_guard<std::mutex> lock(mu);
  if (kept && granted[dev].load() >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && kept) granted[dev].store(bytes);
  return err;
}

}  // namespace fcvsr

extern "C" const char* fcvsr_error_string(int code);
