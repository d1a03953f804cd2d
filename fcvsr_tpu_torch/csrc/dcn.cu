// Deformable convolution (DCNv2, or DCNv1 without a mask), 3x3, stride 1,
// padding 1, dilation 1, groups 1, any number of deform groups, on NHWC
// float32 tensors with f32 accumulation.
//
// fcvsr_dcn3x3 replaces fcvsr_tpu/ops/pallas_dcn.py::_kernel (reached there
// through modulated_deform_conv2d_fused):
//   out[b,p,o] = bias[o] + sum over taps k and input channels c of
//                W[k,c,o] * m[b,p,g(c),k] * x~(p + tap_k + off[b,p,g(c),k])
// with x~ bilinear sampling, zero outside the frame; offsets are laid out
// (deform group, tap, [dy, dx]), the mask (deform group, tap).  The TPU
// kernel samples from one window per row tile around the tile's rounded
// mean offset and clamps each deviation to 2 px; this kernel gathers the
// four corners from device memory at any displacement, as the exact path
// (ops/dcn.py) does.
//
// Bound on the H100: arithmetic.  The contraction is 9 * Cin * Cout FMAs a
// pixel (21 GFLOP at EDVR's 5 x 180 x 320, 64 -> 64) against ~0.4 GB of
// traffic; the sampling adds 4 loads and ~8 flops a sampled value, 1/Cout
// of that.  This first version runs on the f32 FMA pipes.  Design: every
// output pixel samples its own positions, so there is no spatial reuse to
// stage and no halo: a block owns TP consecutive pixels of the flattened
// (B, H, W) grid (a pyramid level narrower than a tile costs nothing) and up
// to 64 output channels.  For each tap and each 32-channel chunk of Cin, one
// thread per (deform group in the chunk, pixel) computes the four corner
// indices and weights times the mask once and samples that group's channels,
// which lie contiguous in NHWC, into a [channel][pixel] tile in shared
// memory; neighbouring threads take neighbouring pixels, so their writes are
// conflict-free and their reads share the L1 lines of nearby positions.  The
// tap's 32 x 64 weight slice is staged beside it, and each thread keeps a
// register tile of 4 consecutive pixels x 8 output channels, its 4-pixel
// column and its two 4-channel weight runs read as float4s.
#include "common.cuh"

namespace fcvsr {
namespace {

constexpr int TP = 128;                 // output pixels a block
constexpr int CIB = 32;                 // input channels sampled a step
constexpr int NCG = 8, CPT = 8;         // channel groups, channels a thread
constexpr int COB = NCG * CPT;          // output channels a block
constexpr int NPG = kThreads / NCG;     // pixel groups
constexpr int PPT = TP / NPG;           // pixels a thread
constexpr int LDP = TP + 4;             // cols_s row stride, float4-aligned
static_assert(PPT == 4 && CPT == 8, "the float4 reads assume 4 x 8 tiles");

__global__ void __launch_bounds__(kThreads)
dcn3x3_kernel(const float* __restrict__ x, const float* __restrict__ offset,
              const float* __restrict__ mask, const float* __restrict__ w,
              const float* __restrict__ bias, float* __restrict__ out, int N,
              int H, int W, int Cin, int Cout, int dg) {
  __shared__ __align__(16) float cols_s[CIB * LDP];  // [channel][pixel]
  __shared__ __align__(16) float w_s[CIB * COB];     // [channel][out channel]
  const int n0 = blockIdx.x * TP, co0 = blockIdx.y * COB;
  const int cg = Cin / dg;
  const int cgi = threadIdx.x % NCG, pg = threadIdx.x / NCG;
  // this thread's output channels: two runs of 4, 32 apart
  const int ca = cgi * 4, cb = 32 + cgi * 4;

  float acc[PPT][CPT] = {};
  for (int tap = 0; tap < 9; ++tap) {
    const int ty = tap / 3 - 1, tx = tap % 3 - 1;
    for (int ci0 = 0; ci0 < Cin; ci0 += CIB) {
      const int cn = min(CIB, Cin - ci0);
      const int g0 = ci0 / cg, ng = (ci0 + cn - 1) / cg - g0 + 1;
      // sample the chunk: one (group, pixel) a work item
      for (int e = threadIdx.x; e < ng * TP; e += kThreads) {
        const int p = e % TP, g = g0 + e / TP, n = n0 + p;
        const int c_lo = max(ci0, g * cg), c_hi = min(ci0 + cn, (g + 1) * cg);
        float* dst = cols_s + (c_lo - ci0) * LDP + p;
        if (n >= N) {
          for (int c = c_lo; c < c_hi; ++c, dst += LDP) *dst = 0.f;
          continue;
        }
        const int xx = n % W, yy = (n / W) % H, b = n / (W * H);
        const float* o = offset + ((size_t)n * dg + g) * 18 + 2 * tap;
        const float m = mask ? mask[((size_t)n * dg + g) * 9 + tap] : 1.f;
        const Bilinear s = bilinear_point((float)(xx + tx) + o[1],
                                          (float)(yy + ty) + o[0], H, W);
        // the corners, weighted by the mask; outside the frame weight 0 and
        // an index clamped into it
        size_t idx[4];
        float wt[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int cy = s.iy + q / 2, cx = s.ix + q % 2;
          const bool in = in_frame(cy, cx, H, W);
          idx[q] = in ? (((size_t)b * H + cy) * W + cx) * Cin : 0;
          wt[q] = in ? m * (q / 2 ? s.fy : 1.f - s.fy) * (q % 2 ? s.fx : 1.f - s.fx)
                     : 0.f;
        }
        for (int c = c_lo; c < c_hi; ++c, dst += LDP)
          *dst = wt[0] * x[idx[0] + c] + wt[1] * x[idx[1] + c] +
                 wt[2] * x[idx[2] + c] + wt[3] * x[idx[3] + c];
      }
      // the tap's weight slice: rows [ci0, ci0 + cn), columns [co0, co0 + 64),
      // zero beyond Cin and Cout
      for (int e = threadIdx.x; e < CIB * COB; e += kThreads) {
        const int co = e % COB, ci = e / COB;
        w_s[e] = (ci < cn && co0 + co < Cout)
                     ? w[((size_t)tap * Cin + ci0 + ci) * Cout + co0 + co] : 0.f;
      }
      __syncthreads();
      for (int ci = 0; ci < cn; ++ci) {
        const float4 xv = *reinterpret_cast<const float4*>(cols_s + ci * LDP + pg * PPT);
        const float4 wa = *reinterpret_cast<const float4*>(w_s + ci * COB + ca);
        const float4 wb = *reinterpret_cast<const float4*>(w_s + ci * COB + cb);
        const float xs[PPT] = {xv.x, xv.y, xv.z, xv.w};
        const float ws[CPT] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int i = 0; i < PPT; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(xs[i], ws[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int n = n0 + pg * PPT + i;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int co = co0 + (j < 4 ? ca + j : cb + j - 4);
      if (co < Cout) out[(size_t)n * Cout + co] = acc[i][j] + (bias ? bias[co] : 0.f);
    }
  }
}

}  // namespace
}  // namespace fcvsr

// x (B,H,W,Cin), offset (B,H,W,dg*18), mask (B,H,W,dg*9) or null, w
// (3,3,Cin,Cout), bias (Cout) or null, out (B,H,W,Cout), all contiguous;
// dg divides Cin.
extern "C" int fcvsr_dcn3x3(const float* x, const float* offset, const float* mask,
                            const float* w, const float* bias, float* out, int B,
                            int H, int W, int Cin, int Cout, int dg, void* stream) {
  using namespace fcvsr;
  if (dg <= 0 || Cin % dg != 0) return (int)cudaErrorInvalidValue;
  const int N = B * H * W;
  dim3 grid((N + TP - 1) / TP, (Cout + COB - 1) / COB);
  dcn3x3_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x, offset, mask, w, bias, out, N, H, W, Cin, Cout, dg);
  return (int)cudaGetLastError();
}
