// Shared helpers of the port's CUDA kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <mutex>

namespace fcvsr {

constexpr int kThreads = 256;

// Storage types.  The serving kernels (K1-K4, K6) store their feature maps
// as T, float or __nv_bfloat16, and compute and accumulate in float: a
// value is widened where it is loaded and rounded (to nearest even, as
// torch's .to(torch.bfloat16)) where it is stored.  Weights, biases and
// flows stay float.
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// A load cached in L2 only, for a map that other blocks of the same launch
// wrote (L1 is not coherent across SMs).
__device__ __forceinline__ float load_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float load_cg(const __nv_bfloat16* p) {
  const unsigned short bits = __ldcg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned>(bits) << 16);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float leaky(float v, float slope) {
  return v >= 0.f ? v : slope * v;
}

// A bilinear sample point of the port's flow warp (ops/warp.py): the
// displaced coordinates clamped to [-1.5, W+0.5] x [-1.5, H+0.5], where every
// corner lies outside the frame, their floor and fractions.  Corners outside
// the frame read zero.
struct Bilinear {
  int ix, iy;    // top-left corner
  float fx, fy;  // fractions towards the right and lower corners
};

__device__ __forceinline__ Bilinear bilinear_point(float x, float y, int H,
                                                   int W) {
  const float px = fminf(fmaxf(x, -1.5f), (float)W + 0.5f);
  const float py = fminf(fmaxf(y, -1.5f), (float)H + 0.5f);
  const float fx0 = floorf(px), fy0 = floorf(py);
  return {(int)fx0, (int)fy0, px - fx0, py - fy0};
}

__device__ __forceinline__ bool in_frame(int y, int x, int H, int W) {
  return y >= 0 && y < H && x >= 0 && x < W;
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
