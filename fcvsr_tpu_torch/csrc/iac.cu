// One exact IAC iteration on NHWC float32 tensors:
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
// keeps every intermediate on chip: a block owns an 8x16 pixel tile and a
// 16-channel chunk, gathers the warped tile with its one-pixel halo into
// shared memory (the corners of 16 neighbouring channels are 64 contiguous
// bytes), stages the tile's kernels there, runs the vertical SAC pass into
// shared memory and the horizontal pass straight into the output.  The halo
// costs 1.4x in warped values; nothing is written to device memory but out.
//
// KF (fused kernel prediction, the TPU kernel's kf mode): the kernels are
// not read but computed in the block as k = f0 . Wsel + b from the predictor
// feature f0 (B,H,W,C0) and the iteration's columns of Wsel (C0, n*3C), so
// the (B,H,W,n*3C) kernel tensor is never written or read.
#include "common.cuh"

namespace fcvsr {
namespace {

constexpr int TH = 8;    // output tile rows
constexpr int TW = 16;   // output tile columns
constexpr int CC = 16;   // channels per block
constexpr int HR = TH + 2, HC = TW + 2;  // warped tile with its SAC halo

template <bool KF>
__global__ void __launch_bounds__(kThreads)
iac_kernel(const float* __restrict__ feat, const float* __restrict__ flow,
           const float* __restrict__ k, int k_ld, int k_off,
           const float* __restrict__ f0, const float* __restrict__ bsel, int c0,
           const float* __restrict__ feat_in, float* __restrict__ out,
           int H, int W, int C, int act) {
  extern __shared__ float smem[];
  float* warp_s = smem;                   // [HR][HC][CC]
  float* k_s = warp_s + HR * HC * CC;     // [TH][HC][3][CC]
  float* v_s = k_s + TH * HC * 3 * CC;    // [TH][HC][CC]
  float* w_s = v_s + TH * HC * CC;        // KF: [c0][3][CC], then b [3][CC]
  float* b_s = w_s + c0 * 3 * CC;

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int nchunk = (C + CC - 1) / CC;
  const int b = blockIdx.z / nchunk;
  const int ch0 = (blockIdx.z % nchunk) * CC;
  const size_t pix0 = (size_t)b * H * W;  // first pixel of this image
  const float* featb = feat + pix0 * C;

  // 1. warped tile: rows clamp(y0-1 .. y0+TH), cols clamp(x0-1 .. x0+TW);
  //    the clamp is SAC's replicate border.
  for (int e = tid; e < HR * HC * CC; e += kThreads) {
    const int ch = e % CC, p = e / CC;
    const int yy = clampi(y0 - 1 + p / HC, 0, H - 1);
    const int xx = clampi(x0 - 1 + p % HC, 0, W - 1);
    float val = 0.f;
    if (ch0 + ch < C) {
      const float* fl = flow + (pix0 + (size_t)yy * W + xx) * 2;
      const Bilinear q = bilinear_point((float)xx + fl[0], (float)yy + fl[1], H, W);
      const float fx = q.fx, fy = q.fy;
      const int ix = q.ix, iy = q.iy;
      const float* src = featb + ch0 + ch;
      auto tap = [&](int yi, int xi) -> float {
        return in_frame(yi, xi, H, W) ? src[((size_t)yi * W + xi) * C] : 0.f;
      };
      val = tap(iy, ix) * ((1.f - fy) * (1.f - fx));
      val += tap(iy, ix + 1) * ((1.f - fy) * fx);
      val += tap(iy + 1, ix) * (fy * (1.f - fx));
      val += tap(iy + 1, ix + 1) * (fy * fx);
    }
    warp_s[e] = val;
  }

  // 2. the kernels of the TH x HC pixels the two passes read
  if (KF) {
    for (int e = tid; e < (c0 + 1) * 3 * CC; e += kThreads) {
      const int ch = e % CC, t = (e / CC) % 3, ci = e / (3 * CC);
      const int col = k_off + t * C + ch0 + ch;
      float val = 0.f;
      if (ch0 + ch < C) val = ci < c0 ? k[(size_t)ci * k_ld + col] : bsel[col];
      w_s[e] = val;  // the row ci == c0 lands in b_s
    }
    __syncthreads();
  }
  for (int e = tid; e < TH * HC * 3 * CC; e += kThreads) {
    const int ch = e % CC, t = (e / CC) % 3, p = e / (3 * CC);
    const int yy = min(y0 + p / HC, H - 1);
    const int xx = clampi(x0 - 1 + p % HC, 0, W - 1);
    const size_t pix = pix0 + (size_t)yy * W + xx;
    float val = 0.f;
    if (ch0 + ch < C) {
      if (KF) {
        const float* fp = f0 + pix * c0;
        for (int ci = 0; ci < c0; ++ci) val += fp[ci] * w_s[(ci * 3 + t) * CC + ch];
        val += b_s[t * CC + ch];
      } else {
        val = k[pix * k_ld + k_off + t * C + ch0 + ch];
      }
    }
    k_s[e] = val;
  }
  __syncthreads();

  // 3. vertical pass over TH x HC pixels, each with its own kernel
  for (int e = tid; e < TH * HC * CC; e += kThreads) {
    const int ch = e % CC, p = e / CC;
    const int r = p / HC, cc = p % HC;
    const float* kk = k_s + p * 3 * CC + ch;
    float s = 0.f;
#pragma unroll
    for (int t = 0; t < 3; ++t) s += warp_s[((r + t) * HC + cc) * CC + ch] * kk[t * CC];
    v_s[e] = s;
  }
  __syncthreads();

  // 4. horizontal pass, residual, activation
  for (int e = tid; e < TH * TW * CC; e += kThreads) {
    const int ch = e % CC, p = e / CC;
    const int r = p / TW, j = p % TW;
    const int y = y0 + r, x = x0 + j;
    if (y >= H || x >= W || ch0 + ch >= C) continue;
    const float* kk = k_s + (r * HC + j + 1) * 3 * CC + ch;
    float s = 0.f;
#pragma unroll
    for (int t = 0; t < 3; ++t) s += v_s[(r * HC + j + t) * CC + ch] * kk[t * CC];
    const size_t o = (pix0 + (size_t)y * W + x) * C + ch0 + ch;
    s += feat_in[o];
    out[o] = act ? leaky(s, 0.1f) : s;
  }
}

}  // namespace
}  // namespace fcvsr

// k: the materialised kernels (B,H,W,k_ld), this iteration's tap-major
// block at columns [k_off, k_off + 3C); or, with f0 non-null, Wsel (c0, k_ld)
// and bsel (k_ld) with the block at the same columns.
extern "C" int fcvsr_iac_step(const float* feat, const float* flow,
                              const float* k, int k_ld, int k_off,
                              const float* f0, const float* bsel, int c0,
                              const float* feat_in, float* out,
                              int B, int H, int W, int C, int act, void* stream) {
  using namespace fcvsr;
  const int nchunk = (C + CC - 1) / CC;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B * nchunk);
  const int kf = f0 != nullptr;
  size_t smem = sizeof(float) * (HR * HC * CC + TH * HC * 3 * CC + TH * HC * CC);
  if (kf) smem += sizeof(float) * (c0 + 1) * 3 * CC;
  auto kernel = kf ? &iac_kernel<true> : &iac_kernel<false>;
  cudaError_t err = kf ? allow_smem<&iac_kernel<true>>(smem)
                       : allow_smem<&iac_kernel<false>>(smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      feat, flow, k, k_ld, k_off, f0, bsel, c0, feat_in, out, H, W, C, act);
  return (int)cudaGetLastError();
}

extern "C" const char* fcvsr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
