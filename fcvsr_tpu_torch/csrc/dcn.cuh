// The deformable conv's shared pieces: the sampler that its forward (K7,
// csrc/dcn.cu) and its adjoint (K8, csrc/dcn_bwd.cu) run, the bf16 tiles
// it writes, and the bf16x3 wgmma product over them.
//
// Sampling.  A work item is a quad: one pixel of the flattened (B, H, W)
// grid and 4 consecutive input channels of a 64-channel chunk (kCk), item
// it = (pixel it / 16, quad it % 16), so a warp takes 2 pixels x 16 quads
// and its float4 loads of one corner read two whole 256-byte runs of NHWC
// channels.  When a deform group's width is a multiple of 4 ("vec": the
// zoo's 8, and every GPU test case but the odd ones), a quad lies in one
// group: its sample point (offset, mask, floor and fractions, the corners
// in the frame) is computed once for its 4 channels and its corners are
// read as float4 runs; the two quads of an 8-channel group compute the
// same point, which costs less than passing it between lanes.  Otherwise
// each channel finds its own group's point and reads scalars.
//
// Tiles.  Sampled values (and the adjoint's g) go into shared memory as
// bf16 hi and lo planes (the value's rounding, and the rounding of what is
// left) in the no-swizzle core-matrix layout of csrc/hopper.cuh: [8-channel
// chunk][pixel][8 channels], 16 bytes a (chunk, pixel) row.  For a product
// over channels (M pixels) that is K-major; for the adjoint's weight
// gradient (M channels, K pixels) the same tile is MN-major.  The chunks of
// a P-pixel tile lie P * 16 + 16 bytes apart: the extra 16 bytes put a
// pixel's 8 chunks on distinct banks, so a warp's 8-byte stores of 2 pixels
// x 16 quads take the two wavefronts their 256 bytes need (at P * 16 they
// would take eight).
#pragma once

#include "conv_tc.cuh"

namespace fcvsr {
namespace {
namespace dcn {

namespace sm90 = fcvsr::sm90;

constexpr int kThreadsD = 256;   // two warpgroups
constexpr int kCk = 64;          // input channels a chunk
constexpr int kQuads = kCk / 4;  // a chunk's quads: a half warp
constexpr int kRow = 16;         // bytes of a core-matrix row: 8 bf16 values

// the distance of two 8-channel chunks of a P-pixel tile, bytes
template <int P>
__host__ __device__ constexpr int chunk_stride() {
  return P * kRow + kRow;
}

// 4 values of a quad (channels cq .. cq + 3 of the chunk, cq a multiple of
// 4) at pixel p of a P-pixel tile, split into the hi plane at `tile` and
// the lo plane plane_b bytes on
template <int P>
__device__ __forceinline__ void store_quad(unsigned char* tile, int plane_b, int p, int cq,
                                           float4 v) {
  const __nv_bfloat162 h0 = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 h1 = __floats2bfloat162_rn(v.z, v.w);
  const float2 f0 = __bfloat1622float2(h0), f1 = __bfloat1622float2(h1);
  unsigned char* dst = tile + (cq >> 3) * chunk_stride<P>() + p * kRow + (cq & 7) * 2;
  *reinterpret_cast<uint2*>(dst) = make_uint2(tc::bf16x2_bits(h0), tc::bf16x2_bits(h1));
  *reinterpret_cast<uint2*>(dst + plane_b) =
      make_uint2(tc::bf16x2_bits(__floats2bfloat162_rn(v.x - f0.x, v.y - f0.y)),
                 tc::bf16x2_bits(__floats2bfloat162_rn(v.z - f1.x, v.w - f1.y)));
}

// A sample point: its corners' pixels in the flattened grid (-1 outside the
// frame), their bilinear weights (0 outside), the fractions and the mask
struct Point {
  int px[4];
  float wt[4];
  float fy, fx, m;
};

// The point of pixel n, deform group grp, tap: offsets laid out (group,
// tap, [dy, dx]), the mask (group, tap), or 1 without one
__device__ __forceinline__ Point sample_point(const float* __restrict__ offset,
                                              const float* __restrict__ mask, int n,
                                              int grp, int tap, int dg, int H, int W) {
  const int xx = n % W, yy = (n / W) % H, b = n / (W * H);
  const size_t og = (size_t)n * dg + grp;
  const float* o = offset + og * 18 + 2 * tap;
  Point p;
  p.m = mask != nullptr ? __ldg(mask + og * 9 + tap) : 1.f;
  const Bilinear s = bilinear_point((float)(xx + tap % 3 - 1) + __ldg(o + 1),
                                    (float)(yy + tap / 3 - 1) + __ldg(o), H, W);
  p.fy = s.fy;
  p.fx = s.fx;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int cy = s.iy + q / 2, cx = s.ix + q % 2;
    const bool in = in_frame(cy, cx, H, W);
    p.px[q] = in ? (b * H + cy) * W + cx : -1;
    p.wt[q] = in ? (q / 2 ? s.fy : 1.f - s.fy) * (q % 2 ? s.fx : 1.f - s.fx) : 0.f;
  }
  return p;
}

// the corners of channels c .. c + 3 at p, float4 runs (zeros outside)
__device__ __forceinline__ void load_quad(float4 (&v)[4], const float* __restrict__ x,
                                          const Point& p, int Cin, int c) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
    v[q] = p.px[q] >= 0
               ? __ldg(reinterpret_cast<const float4*>(x + (size_t)p.px[q] * Cin + c))
               : make_float4(0.f, 0.f, 0.f, 0.f);
}

// ... of one channel
__device__ __forceinline__ void load_one(float (&v)[4], const float* __restrict__ x,
                                         const Point& p, int Cin, int c) {
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = p.px[q] >= 0 ? __ldg(x + (size_t)p.px[q] * Cin + c) : 0.f;
}

// m times the bilinear sample of one channel's corners
__device__ __forceinline__ float sample(const Point& p, float v0, float v1, float v2,
                                        float v3) {
  return p.m * (p.wt[0] * v0 + p.wt[1] * v1 + p.wt[2] * v2 + p.wt[3] * v3);
}

// acc (64 x N) += A x B over KSTEPS k16 steps in bf16x3 (hi*hi + hi*lo +
// lo*hi): A at shared address a (TA 0 K-major, 1 MN-major), its lo plane
// a_lo bytes on, LBO and SBO as hopper.cuh defines them for that layout,
// each k16 step a_step bytes on; B likewise.  The sums accumulate: the
// caller zeroes them.
template <int N, int KSTEPS, int TA, int TB, int R>
__device__ __forceinline__ void mma_bf16x3(float (&acc)[R], uint32_t a, uint32_t a_lo,
                                           uint32_t a_lbo, uint32_t a_sbo, uint32_t a_step,
                                           uint32_t b, uint32_t b_lo, uint32_t b_lbo,
                                           uint32_t b_sbo, uint32_t b_step) {
#pragma unroll
  for (int s = 0; s < KSTEPS; ++s)
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const uint64_t da =
          sm90::desc_interleave(a + (p == 2 ? a_lo : 0) + s * a_step, a_lbo, a_sbo);
      const uint64_t db =
          sm90::desc_interleave(b + (p == 1 ? b_lo : 0) + s * b_step, b_lbo, b_sbo);
      sm90::wgmma_m64k16_bf16<N, TB, TA>(acc, da, db, 1);
    }
}

}  // namespace dcn
}  // namespace
}  // namespace fcvsr
