// Deformable convolution (DCNv2, or DCNv1 without a mask), 3x3, stride 1,
// padding 1, dilation 1, groups 1, any number of deform groups, on NHWC
// float32 tensors, on the tensor cores.
//
// fcvsr_dcn3x3 (K7) replaces fcvsr_tpu/ops/pallas_dcn.py::_kernel (reached
// there through modulated_deform_conv2d_fused):
//   out[b,p,o] = bias[o] + sum over taps k and input channels c of
//                W[k,c,o] * m[b,p,g(c),k] * x~(p + tap_k + off[b,p,g(c),k])
// with x~ bilinear sampling, zero outside the frame; offsets are laid out
// (deform group, tap, [dy, dx]), the mask (deform group, tap).  The TPU
// kernel samples from one window per row tile around the tile's rounded
// mean offset and clamps each deviation to 2 px; this kernel gathers the
// four corners from device memory at any displacement, as the exact path
// (ops/dcn.py) does.
//
// An implicit GEMM on warpgroup MMA (wgmma): M = 128 pixels of the
// flattened (B, H, W) grid a block (64 a warpgroup), N = a tile of 64
// output channels, K = 9 taps x Cin in steps of one tap and one 64-channel
// chunk (csrc/dcn.cuh).  A step's A, m * x~ for the block's pixels, is
// gathered by all 256 threads through dcn.cuh's sampler into bf16 hi and
// lo planes; its B, the step's 64 x 64 weight slice, is loaded from the
// float32 HWIO weights a step ahead and split into planes beside it.  Two
// stages turn over: while the wgmma of step q run (three bf16 products a
// k16 step, bf16x3, as the conv kernels take for float32 maps: within 3 x
// 2^-16 of each product, ops/fused_dcn.py's emulation holds it to the
// 1e-4 bar on the CPU), the threads gather step q + 1 into the other.
// Stage: 2 planes x 8 chunks x (128 x 16 + 16) + 2 planes x 64 x 64 x 2
// bytes = 49,408; two stages 98,816, two blocks an SM.
//
// The weights are not split once into planes in device memory: the zoo's
// HWIO weight is a new tensor on every call under autograd
// (models/scnet_rows.py::hwio), so planes cached on it would be split again
// on every training call, a launch of their own; a step's slice is 16 KB
// of L2 reads beside the 128 KB its gather reads.
//
// Small frames fill the card by splitting K: when the tiles are too few
// for two blocks an SM, a thread-block cluster of 2, 4 or 8 blocks shares
// a tile, each block taking a run of the steps; their sums meet in
// distributed shared memory, each block adding up a slice of the tile's
// rows over the cluster in rank order (deterministic), with the bias, and
// storing them (BasicVSR++'s 64x64 training frame: 32 tiles, 8 blocks
// each).  One block alone stores through the same path.
//
// Bound on the H100: bytes.  x, the offsets, the mask and the weights read
// once, out written once: EDVR-M's level 1 (5 x 180 x 320, 64 -> 64, 8
// groups) moves 396 MB, 0.118 ms at 3.35 TB/s; its 21 GFLOP of products
// take 0.021 ms at the bf16 tensor cores' 989 TFLOP/s (the route's three
// products 0.064).  What holds it is what the gather reads through L2: 4
// corners x Cin x 9 values a pixel (2.65 GB at EDVR-M's level 1), and the
// offsets and the mask, a 32-byte sector for the 8 (4) bytes a (pixel,
// group, tap) uses, fetched again for each tap.  Taken out one at a time
// at EDVR-M's level 1 (benchmarks/dcn_ab.py, PERF.md §6): the corners'
// loads 36-39% of the time, the points' offset and mask loads 33%, the
// weight fill 10-11%, the wgmma 2-4%; one stage (more L1), one block an
// SM and a 4-item unroll each moved it by under 3% or made it slower.
#include <cooperative_groups.h>

#include "dcn.cuh"

namespace coop = cooperative_groups;

namespace fcvsr {
namespace {
namespace dcn {

constexpr int kTile = 128;                             // pixels a block
constexpr int kNo = 64;                                // output channels a block
constexpr int kLboA = chunk_stride<kTile>();           // A's chunks apart
constexpr int kPlaneA = (kCk / 8) * kLboA;
constexpr int kPlaneB = (kCk / 8) * kNo * kRow;        // [8-channel chunk][out channel][16 B]
constexpr int kStage = 2 * kPlaneA + 2 * kPlaneB;
constexpr int kSmemFwd = 2 * kStage;
constexpr int kItems = kTile * kQuads / kThreadsD;     // quads a thread a step
constexpr int kWItems = kNo * (kCk / 8) / kThreadsD;   // weight items a thread a step
constexpr int kLdo = kNo + 4;                          // floats a row of the sums' tile
static_assert(kTile * kLdo * 4 <= kSmemFwd, "the sums' tile fits in the stages");

// The step's weight slice W[tap][c0 .. c0 + 63][co0 .. co0 + 63] as the
// thread's items (out channel n = it % 64, 8 input channels from 8 (it /
// 64)): loads only, zeros past Cin and Cout; stored a step later
__device__ __forceinline__ void load_weights(float (&v)[kWItems][8],
                                             const float* __restrict__ w, int Cin,
                                             int Cout, int tap, int c0, int co0) {
#pragma unroll
  for (int i = 0; i < kWItems; ++i) {
    const int it = threadIdx.x + i * kThreadsD;
    const int co = co0 + it % kNo, c = c0 + (it / kNo) * 8;
    const float* p = w + ((size_t)tap * Cin + c) * Cout + co;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[i][e] = co < Cout && c + e < Cin ? __ldg(p + (size_t)e * Cout) : 0.f;
  }
}

// ... split into a stage's B planes: [8-channel chunk][out channel][16 B],
// K-major for N = out channels
__device__ __forceinline__ void store_weights(unsigned char* b,
                                              const float (&v)[kWItems][8]) {
#pragma unroll
  for (int i = 0; i < kWItems; ++i) {
    const int it = threadIdx.x + i * kThreadsD;
    uint4 hi, lo;
    tc::split8(v[i], hi, lo);
    unsigned char* d = b + (it / kNo) * kNo * kRow + (it % kNo) * kRow;
    *reinterpret_cast<uint4*>(d) = hi;
    *reinterpret_cast<uint4*>(d + kPlaneB) = lo;
  }
}

// A block: the tile of pixels n0 .. n0 + 127 (blockIdx.x / split), output
// channels co0 .. co0 + 63 (blockIdx.y), steps [q0, q1) of the 9 x nck
// (rank blockIdx.x % split of its cluster)
__global__ void __launch_bounds__(kThreadsD, 2)
dcn_fwd_kernel(const float* __restrict__ x, const float* __restrict__ offset,
               const float* __restrict__ mask, const float* __restrict__ w,
               const float* __restrict__ bias, float* __restrict__ out, int N, int H,
               int W, int Cin, int Cout, int dg, int nck, int split, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31;
  // warp-uniform roles: ptxas serialises wgmma on a path that branches on
  // the thread's index
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int wg = warp >> 2, wl = warp & 3;
  const int rank = blockIdx.x % split;
  const int n0 = (blockIdx.x / split) * kTile, co0 = blockIdx.y * kNo;
  const int cg = Cin / dg, nst = 9 * nck;
  const int q0 = rank * nst / split, q1 = (rank + 1) * nst / split;

  // step q's A: m * x~ of quad (p, cq) a item, into the stage at st
  auto gather = [&](int q, unsigned char* st) {
    const int tap = q / nck, c0 = (q % nck) * kCk;
#pragma unroll 2
    for (int i = 0; i < kItems; ++i) {
      const int it = tid + i * kThreadsD;
      const int p = it / kQuads, cq = 4 * (it % kQuads);
      const int n = n0 + p, c = c0 + cq;
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      if (n < N && c < Cin) {
        if (vec) {
          const Point pt = sample_point(offset, mask, n, c / cg, tap, dg, H, W);
          float4 v[4];
          load_quad(v, x, pt, Cin, c);
          s = make_float4(sample(pt, v[0].x, v[1].x, v[2].x, v[3].x),
                          sample(pt, v[0].y, v[1].y, v[2].y, v[3].y),
                          sample(pt, v[0].z, v[1].z, v[2].z, v[3].z),
                          sample(pt, v[0].w, v[1].w, v[2].w, v[3].w));
        } else {
          float r[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            r[e] = 0.f;
            if (c + e < Cin) {
              const Point pt = sample_point(offset, mask, n, (c + e) / cg, tap, dg, H, W);
              float v[4];
              load_one(v, x, pt, Cin, c + e);
              r[e] = sample(pt, v[0], v[1], v[2], v[3]);
            }
          }
          s = make_float4(r[0], r[1], r[2], r[3]);
        }
      }
      store_quad<kTile>(st, kPlaneA, p, cq, s);
    }
  };
  float wv[kWItems][8];  // the next step's weights, loaded before its gather
  auto fill = [&](int q) {
    load_weights(wv, w, Cin, Cout, q / nck, (q % nck) * kCk, co0);
  };

  fill(q0);
  gather(q0, smem);
  store_weights(smem + 2 * kPlaneA, wv);
  sm90::fence_proxy_async();
  __syncthreads();

  float acc[kNo / 2];
#pragma unroll
  for (int i = 0; i < kNo / 2; ++i) acc[i] = 0.f;
  for (int q = q0; q < q1; ++q) {
    unsigned char* st = smem + ((q - q0) & 1) * kStage;
    unsigned char* nx = smem + ((q - q0 + 1) & 1) * kStage;
    const uint32_t a = sm90::smem_u32(st) + wg * 64 * kRow;
    const uint32_t b = sm90::smem_u32(st + 2 * kPlaneA);
    sm90::wgmma_fence();
    mma_bf16x3<kNo, kCk / 16, 0, 0>(acc, a, kPlaneA, kLboA, 8 * kRow, 2 * kLboA, b,
                                    kPlaneB, kNo * kRow, 8 * kRow, 2 * kNo * kRow);
    sm90::wgmma_commit();
    // while they run: the next step into the other stage, which the step
    // before read (drained)
    if (q + 1 < q1) {
      fill(q + 1);
      gather(q + 1, nx);
      store_weights(nx + 2 * kPlaneA, wv);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_operand(acc);
    sm90::fence_proxy_async();
    __syncthreads();
  }

  // the block's sums into shared memory, [pixel][out channel]: d[4 j + e]
  // holds pixel 16 wl + lane / 4 + 8 (e / 2) of the warpgroup's 64,
  // channel 8 j + 2 (lane % 4) + e % 2
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < kNo / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = wg * 64 + 16 * wl + (lane >> 2) + 8 * h, c = 8 * j + 2 * (lane & 3);
      *reinterpret_cast<float2*>(red + p * kLdo + c) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  coop::cluster_group cluster = coop::this_cluster();
  cluster.sync();
  // rank r adds up rows [r * rows, (r + 1) * rows) over the cluster, in rank
  // order, adds the bias and stores them
  const int rows = kTile / split;
  const bool vec_out = Cout % 4 == 0;
  for (int e = tid; e < rows * (kNo / 4); e += kThreadsD) {
    const int p = rank * rows + e / (kNo / 4), c = 4 * (e % (kNo / 4));
    const int n = n0 + p, co = co0 + c;
    if (n >= N || co >= Cout) continue;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < split; ++k) {
      const float4 v =
          *reinterpret_cast<const float4*>(cluster.map_shared_rank(red, k) + p * kLdo + c);
      s.x += v.x, s.y += v.y, s.z += v.z, s.w += v.w;
    }
    float r[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (bias != nullptr && co + i < Cout) r[i] += __ldg(bias + co + i);
    float* o = out + (size_t)n * Cout + co;
    if (vec_out) {
      *reinterpret_cast<float4*>(o) = make_float4(r[0], r[1], r[2], r[3]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (co + i < Cout) o[i] = r[i];
    }
  }
  cluster.sync();  // the others read this block's sums until here
}

}  // namespace dcn
}  // namespace
}  // namespace fcvsr

// x (B,H,W,Cin), offset (B,H,W,dg*18), mask (B,H,W,dg*9) or null, w
// (3,3,Cin,Cout), bias (Cout) or null, out (B,H,W,Cout), all contiguous
// float32; dg divides Cin; out 16-byte aligned.
extern "C" int fcvsr_dcn3x3(const float* x, const float* offset, const float* mask,
                            const float* w, const float* bias, float* out, int B,
                            int H, int W, int Cin, int Cout, int dg, void* stream) {
  using namespace fcvsr;
  using namespace fcvsr::dcn;
  if (B < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1 || dg <= 0 || Cin % dg != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  constexpr auto kernel = &dcn_fwd_kernel;
  cudaError_t err = allow_smem<kernel>(kSmemFwd);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int N = B * H * W;
  const int tiles = (N + kTile - 1) / kTile, nco = (Cout + kNo - 1) / kNo;
  const int nck = (Cin + kCk - 1) / kCk;
  // split K while the blocks stay within two an SM (9 steps at least)
  int split = 1;
  while (split < 8 && (long)tiles * nco * split * 2 <= 2L * sms) split *= 2;
  const int vec = (Cin / dg) % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * split, nco, 1);
  cfg.blockDim = dim3(kThreadsD, 1, 1);
  cfg.dynamicSmemBytes = kSmemFwd;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, x, offset, mask, w, bias, out, N, H, W, Cin,
                           Cout, dg, nck, split, vec);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
