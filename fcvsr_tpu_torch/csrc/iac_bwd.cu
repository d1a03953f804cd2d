// Adjoint of one exact IAC iteration (csrc/iac.cu) without its residual and
// activation, on NHWC float32 tensors.  For
//
//   z = SAC_k1,k1(warped),   warped = warp_bilinear_zeros(src, flow)
//
// and the cotangent gz = dL/dz it computes dk (the iteration's tap-major 3C
// block of the kernel tensor), dflow and dsrc.  The chain walk around it
// (ops/fused_iac.py) applies the activation mask and adds the residual's
// adjoint.
//
// Replaces the TPU kernel fcvsr_tpu/ops/pallas_iac.py::_bwd_kernel, reached
// there through _rows_bwd_call and iac_fused_vjp.  That kernel is the
// adjoint of the TPU forward's radius-2 window; this one is the exact adjoint
// of the port's exact forward: zero-padded bilinear corners at any
// displacement, the coordinate clamp to [-1.5, W+0.5] x [-1.5, H+0.5] (zero
// dflow where it is active), no gradient through floor, and SAC's replicate
// border, where ring rows and columns are warped at clamped pixels, each with
// its own kernel.  Kernel1 applies in both passes, at columns k_off + t*C + c.
//
// Bound on the H100: bytes.  The function reads src, flow, the 3C kernel
// block and gz and writes dk, dflow and dsrc, about 9C floats a pixel, with
// some 50 flops a value.  Two launches, because blocks run in no order:
//
//  1. SAC adjoint: a block owns an 8x16 pixel tile and a 16-channel chunk.
//     The adjoint at a pixel reaches gz one row and one column away through
//     the neighbours' kernels, so the block stages the warped tile, the
//     kernels and gz with a one-pixel ring in shared memory (gz is zero
//     outside the frame), recomputes the vertical pass, and forms dv (the
//     vertical pass's output adjoint) and then dk and dwarped.  Each output
//     has one owner: no atomics.  dwarped goes to device memory.
//  2. Warp adjoint: one warp per pixel, its lanes over the channels.  dflow
//     is the reduction over all C channels of dwarped . dwarped/dflow, summed
//     by warp shuffles and written by lane 0.  dsrc is a scatter of the four
//     bilinear corners at any displacement: there is no transposed gather, so
//     it is float atomicAdd into a zeroed buffer (32 lanes on 32 contiguous
//     channels of one corner).  The order of those sums changes from run to
//     run, so dsrc is reproducible only to f32 rounding.
//
// Device-memory traffic beyond the bound: the warped tile's ring (1.4x of
// the gathered src), dwarped written and read once (2C floats a pixel).
#include "common.cuh"

namespace fcvsr {
namespace {

constexpr int TH = 8;    // tile rows
constexpr int TW = 16;   // tile columns
constexpr int CC = 16;   // channels per block
constexpr int HR = TH + 2, HC = TW + 2;  // the tile with its one-pixel ring

__global__ void __launch_bounds__(kThreads)
sac_adjoint_kernel(const float* __restrict__ src, const float* __restrict__ flow,
                   const float* __restrict__ k, int k_ld, int k_off,
                   const float* __restrict__ gz, float* __restrict__ dk,
                   float* __restrict__ dwarped, int H, int W, int C) {
  extern __shared__ float smem[];
  float* warp_s = smem;                 // [HR][HC][CC] warped, clamped pixels
  float* k_s = warp_s + HR * HC * CC;   // [HR][HC][3][CC] kernels, clamped
  float* g_s = k_s + HR * HC * 3 * CC;  // [HR][HC][CC] gz, 0 outside the frame
  float* v_s = g_s + HR * HC * CC;      // [TH][HC][CC] vertical pass
  float* dv_s = v_s + TH * HC * CC;     // [HR][TW][CC] its output's adjoint

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int nchunk = (C + CC - 1) / CC;
  const int b = blockIdx.z / nchunk;
  const int ch0 = (blockIdx.z % nchunk) * CC;
  const size_t pix0 = (size_t)b * H * W;  // first pixel of this image
  const float* srcb = src + pix0 * C;

  // 1. ring row r, column j is image pixel (y0-1+r, x0-1+j); warped values
  //    and kernels are those of the clamped pixel, as in the forward
  for (int e = tid; e < HR * HC * CC; e += kThreads) {
    const int ch = e % CC, p = e / CC;
    const int y = y0 - 1 + p / HC, x = x0 - 1 + p % HC;
    const int yy = clampi(y, 0, H - 1), xx = clampi(x, 0, W - 1);
    const size_t pix = pix0 + (size_t)yy * W + xx;
    float wv = 0.f, gv = 0.f, kv[3] = {0.f, 0.f, 0.f};
    if (ch0 + ch < C) {
      const float* fl = flow + pix * 2;
      const Bilinear q = bilinear_point((float)xx + fl[0], (float)yy + fl[1], H, W);
      const float* s = srcb + ch0 + ch;
      auto tap = [&](int yi, int xi) -> float {
        return in_frame(yi, xi, H, W) ? s[((size_t)yi * W + xi) * C] : 0.f;
      };
      wv = tap(q.iy, q.ix) * ((1.f - q.fy) * (1.f - q.fx));
      wv += tap(q.iy, q.ix + 1) * ((1.f - q.fy) * q.fx);
      wv += tap(q.iy + 1, q.ix) * (q.fy * (1.f - q.fx));
      wv += tap(q.iy + 1, q.ix + 1) * (q.fy * q.fx);
      if (y == yy && x == xx) gv = gz[pix * C + ch0 + ch];
      for (int t = 0; t < 3; ++t) kv[t] = k[pix * k_ld + k_off + t * C + ch0 + ch];
    }
    warp_s[e] = wv;
    g_s[e] = gv;
    for (int t = 0; t < 3; ++t) k_s[(p * 3 + t) * CC + ch] = kv[t];
  }
  __syncthreads();

  // 2. the vertical pass at the tile's rows, ring columns included
  for (int e = tid; e < TH * HC * CC; e += kThreads) {
    const int ch = e % CC, p = e / CC;
    const int r = p / HC, j = p % HC;
    const float* kk = k_s + ((r + 1) * HC + j) * 3 * CC + ch;
    float s = 0.f;
#pragma unroll
    for (int t = 0; t < 3; ++t) s += warp_s[((r + t) * HC + j) * CC + ch] * kk[t * CC];
    v_s[e] = s;
  }
  // 3. dv at the tile's columns, ring rows included: the horizontal taps of
  //    columns x-1 .. x+1 that land on x (clamped at the frame's edges)
  for (int e = tid; e < HR * TW * CC; e += kThreads) {
    const int ch = e % CC, p = e / CC;
    const int r = p / TW, j = p % TW;
    const int xt = x0 + j;
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const int x = xt - 1 + d;
      const float g = g_s[(r * HC + j + d) * CC + ch];
      const float* kk = k_s + (r * HC + j + d) * 3 * CC + ch;
#pragma unroll
      for (int t = 0; t < 3; ++t)
        if (clampi(x - 1 + t, 0, W - 1) == xt) s += kk[t * CC] * g;
    }
    dv_s[e] = s;
  }
  __syncthreads();

  // 4. dk (horizontal + vertical terms) and dwarped at the tile's pixels
  for (int e = tid; e < TH * TW * CC; e += kThreads) {
    const int ch = e % CC, p = e / CC;
    const int r = p / TW, j = p % TW;
    const int y = y0 + r, x = x0 + j;
    if (y >= H || x >= W || ch0 + ch >= C) continue;
    const float g = g_s[((r + 1) * HC + j + 1) * CC + ch];
    const float dvc = dv_s[((r + 1) * TW + j) * CC + ch];
    const size_t pix = pix0 + (size_t)y * W + x;
    float* dkp = dk + pix * k_ld + k_off + ch0 + ch;
#pragma unroll
    for (int t = 0; t < 3; ++t)
      dkp[t * C] = g * v_s[(r * HC + j + t) * CC + ch] +
                   dvc * warp_s[((r + t) * HC + j + 1) * CC + ch];
    // the vertical taps of rows y-1 .. y+1 that land on y
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const int ys = y - 1 + d;
      const float dvs = dv_s[((r + d) * TW + j) * CC + ch];
      const float* kk = k_s + ((r + d) * HC + j + 1) * 3 * CC + ch;
#pragma unroll
      for (int t = 0; t < 3; ++t)
        if (clampi(ys - 1 + t, 0, H - 1) == y) s += kk[t * CC] * dvs;
    }
    dwarped[pix * C + ch0 + ch] = s;
  }
}

constexpr int kWarps = kThreads / 32;  // pixels per block of the warp adjoint

__global__ void __launch_bounds__(kThreads)
warp_adjoint_kernel(const float* __restrict__ src, const float* __restrict__ flow,
                    const float* __restrict__ dwarped, float* __restrict__ dsrc,
                    float* __restrict__ dflow, long long npix, int H, int W,
                    int C) {
  const int lane = threadIdx.x & 31;
  const long long p = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (p >= npix) return;  // the whole warp leaves together
  const long long hw = (long long)H * W;
  const long long b = p / hw;
  const int y = (int)((p % hw) / W), x = (int)(p % W);
  const float rx = (float)x + flow[p * 2], ry = (float)y + flow[p * 2 + 1];
  const Bilinear q = bilinear_point(rx, ry, H, W);
  const float fx = q.fx, fy = q.fy;
  const bool ok00 = in_frame(q.iy, q.ix, H, W);
  const bool ok01 = in_frame(q.iy, q.ix + 1, H, W);
  const bool ok10 = in_frame(q.iy + 1, q.ix, H, W);
  const bool ok11 = in_frame(q.iy + 1, q.ix + 1, H, W);
  // corner offsets, negative for corners outside the frame (never read)
  const long long o00 = (b * hw + (long long)q.iy * W + q.ix) * C;
  const long long o01 = o00 + C, o10 = o00 + (long long)W * C, o11 = o10 + C;
  const float w00 = (1.f - fy) * (1.f - fx), w01 = (1.f - fy) * fx;
  const float w10 = fy * (1.f - fx), w11 = fy * fx;
  float ax = 0.f, ay = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float g = dwarped[p * C + c];
    const float s00 = ok00 ? src[o00 + c] : 0.f, s01 = ok01 ? src[o01 + c] : 0.f;
    const float s10 = ok10 ? src[o10 + c] : 0.f, s11 = ok11 ? src[o11 + c] : 0.f;
    ax += g * ((1.f - fy) * (s01 - s00) + fy * (s11 - s10));
    ay += g * ((1.f - fx) * (s10 - s00) + fx * (s11 - s01));
    if (ok00) atomicAdd(dsrc + o00 + c, g * w00);
    if (ok01) atomicAdd(dsrc + o01 + c, g * w01);
    if (ok10) atomicAdd(dsrc + o10 + c, g * w10);
    if (ok11) atomicAdd(dsrc + o11 + c, g * w11);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    ax += __shfl_down_sync(0xffffffffu, ax, off);
    ay += __shfl_down_sync(0xffffffffu, ay, off);
  }
  if (lane == 0) {
    // the clamp passes the gradient only where it is inactive
    dflow[p * 2] = (rx >= -1.5f && rx <= (float)W + 0.5f) ? ax : 0.f;
    dflow[p * 2 + 1] = (ry >= -1.5f && ry <= (float)H + 0.5f) ? ay : 0.f;
  }
}

}  // namespace
}  // namespace fcvsr

// Launch 1.  k: (B,H,W,k_ld) with the iteration's block at [k_off, k_off+3C);
// dk: the same layout, only that block written; dwarped: (B,H,W,C).
extern "C" int fcvsr_iac_bwd_sac(const float* src, const float* flow,
                                 const float* k, int k_ld, int k_off,
                                 const float* gz, float* dk, float* dwarped,
                                 int B, int H, int W, int C, void* stream) {
  using namespace fcvsr;
  const int nchunk = (C + CC - 1) / CC;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B * nchunk);
  const size_t smem = sizeof(float) * (HR * HC * CC + HR * HC * 3 * CC +
                                       HR * HC * CC + TH * HC * CC + HR * TW * CC);
  cudaError_t err = allow_smem<&sac_adjoint_kernel>(smem);
  if (err != cudaSuccess) return (int)err;
  sac_adjoint_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      src, flow, k, k_ld, k_off, gz, dk, dwarped, H, W, C);
  return (int)cudaGetLastError();
}

// Launch 2.  dsrc: (B,H,W,C), zeroed by the caller; dflow: (B,H,W,2).
extern "C" int fcvsr_iac_bwd_warp(const float* src, const float* flow,
                                  const float* dwarped, float* dsrc,
                                  float* dflow, int B, int H, int W, int C,
                                  void* stream) {
  using namespace fcvsr;
  const long long npix = (long long)B * H * W;
  const unsigned blocks = (unsigned)((npix + kWarps - 1) / kWarps);
  warp_adjoint_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      src, flow, dwarped, dsrc, dflow, npix, H, W, C);
  return (int)cudaGetLastError();
}
