// Adjoint of the deformable convolution of csrc/dcn.cu (DCNv2, or DCNv1
// without a mask), 3x3, stride 1, padding 1, dilation 1, groups 1, any
// number of deform groups, on NHWC float32 tensors with f32 accumulation.
//
// For the forward
//   out[p,o] = bias[o] + sum over taps k and input channels c of
//              W[k,c,o] * m[p,d(c),k] * s[p,k,c],
//   s[p,k,c] = x~(p + tap_k + off[p,d(c),k])   (bilinear, zero outside)
// and the cotangent g = dL/dout it computes, with u = sum_o g[p,o] W[k,c,o]
// and v = m u:
//   dmask[p,d,k]     = sum over c in d of s u
//   doffset[p,d,k,.] = sum over c in d of v ds/d(py, px)
//   dx               = v times each corner's bilinear weight, scattered to
//                      the four corners of every sample
//   dW[k,c,o]        = sum_p m s g[p,o],   dbias = sum_p g.
// It is the exact adjoint of the exact forward: the sample point is clamped
// to [-1.5, W+0.5] x [-1.5, H+0.5] as in the forward, where every corner
// lies outside the frame, so ds/dpoint is 0 there without a case of its
// own; corners outside the frame read 0 and receive nothing; floor passes
// no gradient, so at an integer position ds/dpy = x(y0+1) - x(y0).
//
// fcvsr_dcn3x3_bwd_data and fcvsr_dcn3x3_bwd_weight replace
// fcvsr_tpu/ops/pallas_dcn.py::_bwd_kernel (reached there through _bwd_call
// and modulated_deform_conv2d_fused_vjp).  That kernel is the adjoint of
// the TPU forward, which samples one window per row tile and clamps each
// offset's deviation to 2 px; this one has no window and no radius.
//
// Bound on the H100: arithmetic.  The two contractions (g W^T and
// cols^T g) are 2 x 9 Cin Cout multiply-adds a pixel, 42 GFLOP at EDVR-M's
// 5 x 180 x 320, 64 -> 64, against ~0.8 GB of traffic; each sampled value
// adds some 30 flops (the sample, its two derivatives, the 4-corner
// scatter, and the re-sample of launch 2).  Both contractions run on the
// f32 FMA pipes in shared-memory tiles, as in csrc/dcn.cu.  Two launches,
// because blocks run in no order and sums cross them:
//
//  1. Data adjoint.  A block owns TP consecutive pixels of the flattened
//     (B, H, W) grid and one tap: every output of this launch is a sum of
//     atomics or a tap's own, so the taps need not share a block, and a
//     small frame still fills the card.  For each 32-channel chunk of Cin
//     it forms u for its pixels (register tiles of 4 pixels x 4 channels
//     over g and the tap's weight slice, staged 32 output channels at a
//     time), leaves it in shared memory, and then each warp walks pixels
//     with one lane an input channel: the lanes of a deform group share its
//     sample point, read the four corners of 32 contiguous NHWC channels
//     (coalesced), and scatter dx with float atomicAdd (32 contiguous
//     addresses a warp).  dmask and doffset are sums over a group's
//     channels: a segmented warp-shuffle sum over the group's lanes, added
//     by the group's first lane (an atomicAdd into a zeroed buffer, since a
//     group wider than a chunk is summed in parts).
//  2. Weight adjoint.  A block owns one tap, 64 input and 64 output channels
//     and a range of pixels: it re-samples m s for 32 pixels at a time (one
//     thread a (pixel, channel), channels fastest) beside g's tile, and
//     keeps a 4 x 4 register tile of dW.  The ranges give the launch about
//     four blocks an SM; each block adds its tile, and the tap-0 blocks
//     their dbias sums, into zeroed outputs with atomicAdd.
//
// Order of the sums: dx takes up to 9 x 4 atomic contributions a value and
// dW and dbias one a block, in an order that changes from run to run, so
// the results are reproducible only to f32 rounding of those sums.
#include "common.cuh"

namespace fcvsr {
namespace {

constexpr int kWarpsPerBlock = kThreads / 32;

// launch 1
constexpr int TP = 128;        // pixels a block
constexpr int CIB = 32;        // input channels a step: one lane each
constexpr int OC = 32;         // output channels of g staged a step
constexpr int LDG = TP + 4;    // g_s row stride, float4-aligned
constexpr int LDU = TP + 1;    // u_s row stride: lane-indexed reads conflict-free
static_assert(TP == 32 * 4 && CIB == 8 * 4, "4 x 4 register tiles of 256 threads");

// launch 2
constexpr int TPW = 32;        // pixels a step
constexpr int CIW = 64, COW = 64;
constexpr int LDW = 64 + 4;    // row stride of both tiles, float4-aligned
static_assert(CIW == 16 * 4 && COW == 16 * 4, "4 x 4 register tiles of 256 threads");

// The sample point of pixel n, tap, deform group grp, and its corners: the
// flat NHWC offset of each corner's channel 0 and whether it lies in the
// frame.
struct Corners {
  Bilinear s;
  size_t idx[4];
  bool in[4];
};

__device__ __forceinline__ Corners corners(const float* __restrict__ offset, int n,
                                           int grp, int tap, int dg, int H, int W,
                                           int Cin) {
  const int xx = n % W, yy = (n / W) % H, b = n / (W * H);
  const float* o = offset + ((size_t)n * dg + grp) * 18 + 2 * tap;
  Corners k;
  k.s = bilinear_point((float)(xx + tap % 3 - 1) + o[1],
                       (float)(yy + tap / 3 - 1) + o[0], H, W);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int cy = k.s.iy + q / 2, cx = k.s.ix + q % 2;
    k.in[q] = in_frame(cy, cx, H, W);
    k.idx[q] = k.in[q] ? (((size_t)b * H + cy) * W + cx) * Cin : 0;
  }
  return k;
}

__global__ void __launch_bounds__(kThreads)
dcn_bwd_data_kernel(const float* __restrict__ x, const float* __restrict__ offset,
                    const float* __restrict__ mask, const float* __restrict__ w,
                    const float* __restrict__ g, float* __restrict__ dx,
                    float* __restrict__ doffset, float* __restrict__ dmask, int N,
                    int H, int W, int Cin, int Cout, int dg) {
  __shared__ __align__(16) float g_s[OC * LDG];  // [out channel][pixel]
  __shared__ __align__(16) float w_s[OC * CIB];  // [out channel][in channel]
  __shared__ float u_s[CIB * LDU];               // [in channel][pixel]
  const int n0 = blockIdx.x * TP, tap = blockIdx.y;
  const int cg = Cin / dg;
  const int tid = threadIdx.x, lane = tid % 32, wid = tid / 32;
  const int cgi = tid % 8, pg = tid / 8;  // 4 in channels, 4 pixels a thread

  for (int ci0 = 0; ci0 < Cin; ci0 += CIB) {
    const int cn = min(CIB, Cin - ci0);
    // u[ci][p] = sum_o W[tap, ci0 + ci, o] g[n0 + p, o]
    float acc[4][4] = {};  // [pixel][in channel]
    for (int o0 = 0; o0 < Cout; o0 += OC) {
      const int on = min(OC, Cout - o0);
      for (int e = tid; e < OC * TP; e += kThreads) {
        const int o = e % OC, p = e / OC, n = n0 + p;
        g_s[o * LDG + p] = (o < on && n < N) ? g[(size_t)n * Cout + o0 + o] : 0.f;
      }
      for (int e = tid; e < OC * CIB; e += kThreads) {
        const int o = e % OC, ci = e / OC;
        w_s[o * CIB + ci] = (o < on && ci < cn)
                                ? w[((size_t)tap * Cin + ci0 + ci) * Cout + o0 + o]
                                : 0.f;
      }
      __syncthreads();
      for (int o = 0; o < on; ++o) {
        const float4 gv = *reinterpret_cast<const float4*>(g_s + o * LDG + pg * 4);
        const float4 wv = *reinterpret_cast<const float4*>(w_s + o * CIB + cgi * 4);
        const float gs[4] = {gv.x, gv.y, gv.z, gv.w};
        const float ws[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(gs[i], ws[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) u_s[(cgi * 4 + j) * LDU + pg * 4 + i] = acc[i][j];
    __syncthreads();

    // one lane an input channel; the lanes of a deform group are a
    // segment [lane of its first channel in the chunk, seg_end)
    const int c = ci0 + lane;
    const bool live = lane < cn;
    const int grp = live ? c / cg : 0;
    const int seg_end = live ? min(cn, (grp + 1) * cg - ci0) : 32;
    const bool head = live && (lane == 0 || c % cg == 0);
    for (int p = wid; p < TP; p += kWarpsPerBlock) {
      const int n = n0 + p;
      if (n >= N) break;  // the same for every lane of the warp
      float dm = 0.f, dpy = 0.f, dpx = 0.f;
      if (live) {
        const Corners k = corners(offset, n, grp, tap, dg, H, W, Cin);
        const float m = mask ? mask[((size_t)n * dg + grp) * 9 + tap] : 1.f;
        float val[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) val[q] = k.in[q] ? x[k.idx[q] + c] : 0.f;
        const float fy = k.s.fy, fx = k.s.fx, gy = 1.f - fy, gx = 1.f - fx;
        const float u = u_s[lane * LDU + p], v = m * u;
        dm = (gy * (gx * val[0] + fx * val[1]) + fy * (gx * val[2] + fx * val[3])) * u;
        dpy = v * (gx * (val[2] - val[0]) + fx * (val[3] - val[1]));
        dpx = v * (gy * (val[1] - val[0]) + fy * (val[3] - val[2]));
        const float wt[4] = {gy * gx, gy * fx, fy * gx, fy * fx};
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (k.in[q]) atomicAdd(dx + k.idx[q] + c, v * wt[q]);
      }
      // segmented sum: after the step of `off`, a lane holds the sum over
      // [lane, min(lane + 2 off, seg_end))
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const float a = __shfl_down_sync(0xffffffffu, dm, off);
        const float b = __shfl_down_sync(0xffffffffu, dpy, off);
        const float d = __shfl_down_sync(0xffffffffu, dpx, off);
        if (lane + off < seg_end) {
          dm += a;
          dpy += b;
          dpx += d;
        }
      }
      if (head) {
        float* dof = doffset + ((size_t)n * dg + grp) * 18 + 2 * tap;
        atomicAdd(dof, dpy);
        atomicAdd(dof + 1, dpx);
        if (dmask) atomicAdd(dmask + ((size_t)n * dg + grp) * 9 + tap, dm);
      }
    }
    __syncthreads();  // u_s and the tiles are rewritten by the next step
  }
}

__global__ void __launch_bounds__(kThreads)
dcn_bwd_weight_kernel(const float* __restrict__ x, const float* __restrict__ offset,
                      const float* __restrict__ mask, const float* __restrict__ g,
                      float* __restrict__ dw, float* __restrict__ dbias, int N,
                      int H, int W, int Cin, int Cout, int dg, int per_block) {
  __shared__ __align__(16) float cols_s[TPW * LDW];  // [pixel][in channel], m s
  __shared__ __align__(16) float g_s[TPW * LDW];     // [pixel][out channel]
  const int nci = (Cin + CIW - 1) / CIW;
  const int tap = blockIdx.y / nci, ci0 = (blockIdx.y % nci) * CIW;
  const int co0 = blockIdx.z * COW;
  const int nbeg = blockIdx.x * per_block, nend = min(N, nbeg + per_block);
  const int cg = Cin / dg;
  const int tid = threadIdx.x;
  const int ci_t = (tid % 16) * 4, co_t = (tid / 16) * 4;
  const bool bias_sum = dbias != nullptr && blockIdx.y == 0 && tid < COW;
  float acc[4][4] = {};  // [in channel][out channel]
  float bacc = 0.f;

  for (int p0 = nbeg; p0 < nend; p0 += TPW) {
    for (int e = tid; e < TPW * CIW; e += kThreads) {
      const int cl = e % CIW, p = e / CIW, n = p0 + p, c = ci0 + cl;
      float val = 0.f;
      if (n < nend && c < Cin) {
        const int grp = c / cg;
        const Corners k = corners(offset, n, grp, tap, dg, H, W, Cin);
        const float m = mask ? mask[((size_t)n * dg + grp) * 9 + tap] : 1.f;
        const float fy = k.s.fy, fx = k.s.fx, gy = 1.f - fy, gx = 1.f - fx;
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = k.in[q] ? x[k.idx[q] + c] : 0.f;
        val = m * (gy * (gx * v[0] + fx * v[1]) + fy * (gx * v[2] + fx * v[3]));
      }
      cols_s[p * LDW + cl] = val;
    }
    for (int e = tid; e < TPW * COW; e += kThreads) {
      const int o = e % COW, p = e / COW, n = p0 + p;
      g_s[p * LDW + o] = (n < nend && co0 + o < Cout) ? g[(size_t)n * Cout + co0 + o] : 0.f;
    }
    __syncthreads();
    for (int p = 0; p < TPW; ++p) {
      const float4 av = *reinterpret_cast<const float4*>(cols_s + p * LDW + ci_t);
      const float4 bv = *reinterpret_cast<const float4*>(g_s + p * LDW + co_t);
      const float as[4] = {av.x, av.y, av.z, av.w};
      const float bs[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(as[i], bs[j], acc[i][j]);
    }
    if (bias_sum)
      for (int p = 0; p < TPW; ++p) bacc += g_s[p * LDW + tid];
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = ci0 + ci_t + i;
    if (c >= Cin) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = co0 + co_t + j;
      if (o < Cout) atomicAdd(dw + ((size_t)tap * Cin + c) * Cout + o, acc[i][j]);
    }
  }
  if (bias_sum && co0 + tid < Cout) atomicAdd(dbias + co0 + tid, bacc);
}

}  // namespace
}  // namespace fcvsr

// Launch 1.  x (B,H,W,Cin), offset (B,H,W,dg*18), mask (B,H,W,dg*9) or
// null, w (3,3,Cin,Cout), g (B,H,W,Cout); dx, doffset and dmask (null
// without a mask) shaped like x, offset and mask and zeroed by the caller.
extern "C" int fcvsr_dcn3x3_bwd_data(const float* x, const float* offset,
                                     const float* mask, const float* w,
                                     const float* g, float* dx, float* doffset,
                                     float* dmask, int B, int H, int W, int Cin,
                                     int Cout, int dg, void* stream) {
  using namespace fcvsr;
  if (dg <= 0 || Cin % dg != 0 || (mask == nullptr) != (dmask == nullptr))
    return (int)cudaErrorInvalidValue;
  const int N = B * H * W;
  dim3 grid((N + TP - 1) / TP, 9);
  dcn_bwd_data_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x, offset, mask, w, g, dx, doffset, dmask, N, H, W, Cin, Cout, dg);
  return (int)cudaGetLastError();
}

// Launch 2.  dw (3,3,Cin,Cout) and dbias (Cout, or null without a bias),
// zeroed by the caller.
extern "C" int fcvsr_dcn3x3_bwd_weight(const float* x, const float* offset,
                                       const float* mask, const float* g,
                                       float* dw, float* dbias, int B, int H,
                                       int W, int Cin, int Cout, int dg,
                                       void* stream) {
  using namespace fcvsr;
  if (dg <= 0 || Cin % dg != 0) return (int)cudaErrorInvalidValue;
  const int N = B * H * W;
  const int nci = (Cin + CIW - 1) / CIW, nco = (Cout + COW - 1) / COW;
  // pixel ranges: about four blocks an SM of the H100's 132, whole tiles
  const int tiles = (N + TPW - 1) / TPW;
  const int per_tap = 9 * nci * nco;
  const int ranges = max(1, min(tiles, (4 * 132 + per_tap - 1) / per_tap));
  const int per_block = ((tiles + ranges - 1) / ranges) * TPW;
  dim3 grid((N + per_block - 1) / per_block, 9 * nci, nco);
  dcn_bwd_weight_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x, offset, mask, g, dw, dbias, N, H, W, Cin, Cout, dg, per_block);
  return (int)cudaGetLastError();
}
