// The whole IAC chain in one launch (K4): ac_num exact IAC iterations,
//
//   cur_0 = feat_in;  cur_{i+1} = act_i(SAC_k1,k1(warp(cur_i, flow_i)) + feat_in)
//
// with act_i the leaky relu (0.1) for every iteration but the last, whose
// activation act_last decides.  Replaces the TPU kernel
// fcvsr_tpu/ops/pallas_iac.py::_chain_kernel (iac_fused_resident), which
// keeps the map in VMEM and lets the TPU's sequential grid order the
// iterations.
//
// Bound on the H100: bytes.  The chain reads feat_in once, the kernels
// (3C values a pixel and iteration, the largest stream) and the flows once,
// and writes the output once: 5.2 KB a pixel at C=64 and 6 iterations in
// float, half that for the maps in bf16.  The per-iteration chain (K1, one
// launch an iteration) also writes and reads the whole map between
// iterations.  Here the map ping-pongs between two device buffers that the
// 50 MB L2 can hold (two bf16 272x480x64 maps are 33.4 MB; two float maps
// are not), so only their eviction by the kernel stream reaches device
// memory, and the launch boundaries are gone.
//
// The design: each warp of an iteration reads the previous iteration's map
// at flow-displaced positions anywhere in the frame, so the barrier between
// iterations is grid-wide.  The launch is cooperative and persistent: the
// grid is as large as the card holds co-resident (the occupancy query times
// the SM count, never the tile count), each block loops over the tiles of
// iac_tile.cuh (8x16 pixels x 16 channels: K1's earlier body), and
// cooperative_groups::this_grid().sync() separates the iterations.
// Iteration 0 reads feat_in, only the last writes out, and the maps the
// launch itself wrote are read through L2 (ld.global.cg), since L1 is not
// coherent across SMs.  A grid that cannot be co-resident is refused, never
// split into per-iteration launches.
#include <cooperative_groups.h>

#include "iac_tile.cuh"

namespace cg = cooperative_groups;

namespace fcvsr {
namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads)
iac_chain_kernel(const T* __restrict__ feat_in, const float* __restrict__ flows,
                 const T* __restrict__ k, T* buf0, T* buf1, T* out, int B, int H,
                 int W, int C, int ac, int act_last) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const int tiles_x = (W + iac::TW - 1) / iac::TW;
  const int tiles_y = (H + iac::TH - 1) / iac::TH;
  const int nchunk = (C + iac::CC - 1) / iac::CC;
  const int ntiles = tiles_x * tiles_y * B * nchunk;
  const size_t flow_stride = (size_t)B * H * W * 2;
  const int k_ld = ac * 3 * C;
  for (int i = 0; i < ac; ++i) {
    // iteration i reads cur_i and writes cur_{i+1}: buf0 after even
    // iterations, buf1 after odd ones, out after the last
    const T* src = i == 0 ? feat_in : (i % 2 ? buf0 : buf1);
    T* dst = i == ac - 1 ? out : (i % 2 ? buf1 : buf0);
    const bool act = i < ac - 1 || act_last;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      int r = t;
      const int tx = r % tiles_x;
      r /= tiles_x;
      const int ty = r % tiles_y;
      r /= tiles_y;
      iac::tile<T, true>(smem, r / nchunk, ty * iac::TH, tx * iac::TW,
                         (r % nchunk) * iac::CC, src, flows + i * flow_stride, k,
                         k_ld, i * 3 * C, feat_in, dst, H, W, C, act);
      __syncthreads();  // the next tile overwrites the kernels this one read
    }
    if (i + 1 < ac) grid.sync();
  }
}

template <typename T>
int launch(const void* feat_in, const float* flows, const void* k, void* buf0,
           void* buf1, void* out, int B, int H, int W, int C, int ac, int act_last,
           cudaStream_t stream) {
  constexpr auto kernel = &iac_chain_kernel<T>;
  const size_t smem = iac::smem_bytes();
  cudaError_t err = allow_smem<kernel>(smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) !=
      cudaSuccess)
    return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const long long ntiles = (long long)((W + iac::TW - 1) / iac::TW) *
                           ((H + iac::TH - 1) / iac::TH) * B *
                           ((C + iac::CC - 1) / iac::CC);
  const int grid = (int)(ntiles < (long long)per_sm * sms ? ntiles
                                                          : (long long)per_sm * sms);
  const T* fi = static_cast<const T*>(feat_in);
  const T* kk = static_cast<const T*>(k);
  T* b0 = static_cast<T*>(buf0);
  T* b1 = static_cast<T*>(buf1);
  T* o = static_cast<T*>(out);
  void* args[] = {&fi, &flows, &kk, &b0, &b1, &o, &B, &H, &W, &C, &ac, &act_last};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                    dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fcvsr

// feat_in, out: (B,H,W,C); flows: (ac,B,H,W,2) float; k: (B,H,W,ac*3C)
// tap-major kernels, iteration i's block at columns [3Ci, 3C(i+1)); buf0,
// buf1: (B,H,W,C) scratch (unused when ac is 1; buf1 unused when ac is 2).
// The maps are bf16 when bf16 is set, float otherwise.
extern "C" int fcvsr_iac_chain(const void* feat_in, const float* flows, const void* k,
                               void* buf0, void* buf1, void* out, int B, int H, int W,
                               int C, int ac, int act_last, int bf16, void* stream) {
  using namespace fcvsr;
  cudaStream_t s = (cudaStream_t)stream;
  if (ac < 1) return (int)cudaErrorInvalidValue;
  if (bf16)
    return launch<__nv_bfloat16>(feat_in, flows, k, buf0, buf1, out, B, H, W, C, ac,
                                 act_last, s);
  return launch<float>(feat_in, flows, k, buf0, buf1, out, B, H, W, C, ac, act_last, s);
}
