// One exact IAC iteration on NHWC tensors (K1):
//
//   out = act(SAC_k1,k1(warp_bilinear_zeros(feat, flow)) + feat_in)
//
// Replaces the TPU kernel fcvsr_tpu/ops/pallas_iac.py::_kernel (with
// _tile_stencil_sac), reached there through warp_sac_fused, iac_fused and
// iac_fused_kf.  The TPU kernel bounds the warp to radius 2 around a per-tile
// mean displacement; this one reads the four bilinear corners straight from
// device memory, so it holds to the exact gather path
// (fcvsr_tpu.ops.sac.iac(warp_impl='gather')) at any displacement, with
// zeros outside the frame.
//
// Bound on the H100: bytes.  An iteration reads feat (gathered), flow, the
// per-pixel kernels (3C values per pixel, the largest stream) and feat_in,
// and writes out; the arithmetic is ~30 flops per output value.  The design
// keeps every intermediate on chip: a block runs the tile body of
// iac_tile.cuh (an 8x16 pixel tile, a 16-channel chunk, the warped tile with
// its halo in shared memory); nothing is written to device memory but out.
// The halo costs 1.4x in warped values.  The maps (feat, k, f0, feat_in,
// out) are float or bf16 storage: bf16 halves the bytes, arithmetic stays
// float.
//
// KF (fused kernel prediction, the TPU kernel's kf mode): the kernels are
// not read but computed in the block as k = f0 . Wsel + b from the predictor
// feature f0 (B,H,W,C0) and the iteration's columns of Wsel (C0, n*3C), so
// the (B,H,W,n*3C) kernel tensor is never written or read.
#include "iac_tile.cuh"

namespace fcvsr {
namespace {

template <typename T, bool KF>
__global__ void __launch_bounds__(kThreads)
iac_kernel(const T* __restrict__ feat, const float* __restrict__ flow,
           const T* __restrict__ k, const float* __restrict__ wsel, int k_ld,
           int k_off, const T* __restrict__ f0, const float* __restrict__ bsel,
           int c0, const T* __restrict__ feat_in, T* __restrict__ out, int H,
           int W, int C, int act) {
  extern __shared__ float smem[];
  const int nchunk = (C + iac::CC - 1) / iac::CC;
  iac::tile<T, KF, false>(smem, blockIdx.z / nchunk, blockIdx.y * iac::TH,
                          blockIdx.x * iac::TW, (blockIdx.z % nchunk) * iac::CC,
                          feat, flow, k, wsel, k_ld, k_off, f0, bsel, c0,
                          feat_in, out, H, W, C, act != 0);
}

template <typename T, bool KF>
int launch(const void* feat, const float* flow, const void* k, int k_ld, int k_off,
           const void* f0, const float* bsel, int c0, const void* feat_in, void* out,
           int B, int H, int W, int C, int act, cudaStream_t stream) {
  constexpr auto kernel = &iac_kernel<T, KF>;
  const size_t smem = iac::smem_bytes(KF, c0);
  cudaError_t err = allow_smem<kernel>(smem);
  if (err != cudaSuccess) return (int)err;
  const int nchunk = (C + iac::CC - 1) / iac::CC;
  dim3 grid((W + iac::TW - 1) / iac::TW, (H + iac::TH - 1) / iac::TH, B * nchunk);
  // with KF, k is Wsel (float); otherwise the materialised kernels (T)
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(feat), flow, KF ? nullptr : static_cast<const T*>(k),
      KF ? static_cast<const float*>(k) : nullptr, k_ld, k_off,
      static_cast<const T*>(f0), bsel, c0, static_cast<const T*>(feat_in),
      static_cast<T*>(out), H, W, C, act);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* feat, const float* flow, const void* k, int k_ld, int k_off,
             const void* f0, const float* bsel, int c0, const void* feat_in, void* out,
             int B, int H, int W, int C, int act, cudaStream_t stream) {
  if (f0 != nullptr)
    return launch<T, true>(feat, flow, k, k_ld, k_off, f0, bsel, c0, feat_in, out, B, H,
                           W, C, act, stream);
  return launch<T, false>(feat, flow, k, k_ld, k_off, f0, bsel, c0, feat_in, out, B, H,
                          W, C, act, stream);
}

}  // namespace
}  // namespace fcvsr

// k: the materialised kernels (B,H,W,k_ld), this iteration's tap-major
// block at columns [k_off, k_off + 3C); or, with f0 non-null, Wsel (c0, k_ld)
// in float and bsel (k_ld) with the block at the same columns.  The maps
// feat, k (materialised), f0, feat_in and out are bf16 when bf16 is set,
// float otherwise; flow, Wsel and bsel are float.
extern "C" int fcvsr_iac_step(const void* feat, const float* flow, const void* k,
                              int k_ld, int k_off, const void* f0, const float* bsel,
                              int c0, const void* feat_in, void* out, int B, int H,
                              int W, int C, int act, int bf16, void* stream) {
  using namespace fcvsr;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return dispatch<__nv_bfloat16>(feat, flow, k, k_ld, k_off, f0, bsel, c0, feat_in,
                                   out, B, H, W, C, act, s);
  return dispatch<float>(feat, flow, k, k_ld, k_off, f0, bsel, c0, feat_in, out, B, H,
                         W, C, act, s);
}

extern "C" const char* fcvsr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
