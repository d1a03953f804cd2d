// The tile body of one exact IAC iteration run by the resident chain
// (iac_chain.cu, K4), and by the per-iteration kernel (K1) before its
// redesign (iac.cu's note):
//
//   out = act(SAC_k1,k1(warp_bilinear_zeros(feat, flow)) + feat_in)
//
// over one 8x16 pixel tile and one 16-channel chunk of an NHWC map.  The
// block gathers the warped tile with its one-pixel halo into shared memory
// (the corners of 16 neighbouring channels are contiguous), stages the
// tile's kernels there, runs the vertical SAC pass into shared memory and
// the horizontal pass straight into the output.  Maps are stored as T
// (float or __nv_bfloat16); shared memory and arithmetic are float.
#pragma once

#include "common.cuh"

namespace fcvsr {
namespace iac {

constexpr int TH = 8;    // output tile rows
constexpr int TW = 16;   // output tile columns
constexpr int CC = 16;   // channels per block
constexpr int HR = TH + 2, HC = TW + 2;  // warped tile with its SAC halo

// Dynamic shared memory of one block: the warped tile, the kernels, the
// vertical pass.
inline size_t smem_bytes() {
  return (HR * HC * CC + TH * HC * 3 * CC + TH * HC * CC) * sizeof(float);
}

// One tile of image b, rows from y0, columns from x0, channels from ch0.
// k: the materialised kernels (B,H,W,k_ld), this iteration's tap-major
// block at columns [k_off, k_off + 3C).  kL2Src reads feat through L2
// only: the resident chain's source was written by other blocks of the
// same launch.
template <typename T, bool kL2Src>
__device__ __forceinline__ void tile(
    float* smem, int b, int y0, int x0, int ch0, const T* __restrict__ feat,
    const float* __restrict__ flow, const T* __restrict__ k, int k_ld, int k_off,
    const T* __restrict__ feat_in, T* __restrict__ out, int H, int W, int C,
    bool act) {
  float* warp_s = smem;                   // [HR][HC][CC]
  float* k_s = warp_s + HR * HC * CC;     // [TH][HC][3][CC]
  float* v_s = k_s + TH * HC * 3 * CC;    // [TH][HC][CC]

  const int tid = threadIdx.x;
  const size_t pix0 = (size_t)b * H * W;  // first pixel of this image
  const T* featb = feat + pix0 * C;

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
      const T* src = featb + ch0 + ch;
      auto tap = [&](int yi, int xi) -> float {
        if (!in_frame(yi, xi, H, W)) return 0.f;
        const T* p = src + ((size_t)yi * W + xi) * C;
        if constexpr (kL2Src) return load_cg(p);
        else return to_f32(*p);
      };
      val = tap(iy, ix) * ((1.f - fy) * (1.f - fx));
      val += tap(iy, ix + 1) * ((1.f - fy) * fx);
      val += tap(iy + 1, ix) * (fy * (1.f - fx));
      val += tap(iy + 1, ix + 1) * (fy * fx);
    }
    warp_s[e] = val;
  }

  // 2. the kernels of the TH x HC pixels the two passes read
  for (int e = tid; e < TH * HC * 3 * CC; e += kThreads) {
    const int ch = e % CC, t = (e / CC) % 3, p = e / (3 * CC);
    const int yy = min(y0 + p / HC, H - 1);
    const int xx = clampi(x0 - 1 + p % HC, 0, W - 1);
    const size_t pix = pix0 + (size_t)yy * W + xx;
    float val = 0.f;
    if (ch0 + ch < C) val = to_f32(k[pix * k_ld + k_off + t * C + ch0 + ch]);
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
    s += to_f32(feat_in[o]);
    out[o] = from_f32<T>(act ? leaky(s, 0.1f) : s);
  }
}

}  // namespace iac
}  // namespace fcvsr
