// Device helpers of the float32-pipe 3x3 SAME conv kernels
// (conv3x3_quad.cu: K6; blockrcb.cu: K11).  A block stages 16 input
// channels of a window and of the weights in shared memory; each thread
// keeps a register tile of PPT pixels x CPT output channels, so every
// shared-memory value it loads feeds 4-8 FMAs.  Neighbouring threads take
// neighbouring output channels, so weight reads are conflict-free and
// input reads broadcast.
#pragma once

#include "common.cuh"

namespace fcvsr {
namespace conv {

constexpr int CIB = 16;  // input channels staged per step

// acc[i][j] += sum over taps and ci < cn of
//   src[(pixel_i + tap offset) * ld + ci] * w_s[(tap * CIB + ci) * COB + co_j]
// pixel_i = p0 + pg + i * NPG in an npix-pixel region of width ow, read
// from a source tile of width sw whose origin is one pixel up-left of the
// region.  S is the source's storage type (float or __nv_bfloat16).
template <int NCG, int CPT, int PPT, typename S>
__device__ __forceinline__ void accumulate(float (&acc)[PPT][CPT], const S* src, int ld,
                                           int sw, const float* w_s, int cn, int npix,
                                           int ow, int p0 = 0) {
  constexpr int NPG = kThreads / NCG, COB = NCG * CPT;
  const int cg = threadIdx.x % NCG, pg = threadIdx.x / NCG;
  int base[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = min(p0 + pg + i * NPG, npix - 1);  // spare slots redo a pixel
    base[i] = (p / ow) * sw + p % ow;
  }
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int toff = (tap / 3) * sw + tap % 3;
    for (int ci = 0; ci < cn; ++ci) {
      float wv[CPT];
#pragma unroll
      for (int j = 0; j < CPT; ++j) wv[j] = w_s[(tap * CIB + ci) * COB + cg + NCG * j];
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        const float xv = to_f32(src[(base[i] + toff) * ld + ci]);
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(xv, wv[j], acc[i][j]);
      }
    }
  }
}

// w (3,3,Cin,Cout) rows [ci0, ci0 + cn) x cols [co0, co0 + COB) -> w_s,
// zero beyond Cin / Cout; with BF16W each weight rounded to bf16 first.
template <int COB, bool BF16W = false>
__device__ __forceinline__ void stage_weights(float* w_s, const float* w, int Cin,
                                              int Cout, int ci0, int cn, int co0) {
  for (int e = threadIdx.x; e < 9 * CIB * COB; e += kThreads) {
    const int co = e % COB, ci = (e / COB) % CIB, tap = e / (COB * CIB);
    float v = (ci < cn && co0 + co < Cout)
                  ? w[((size_t)tap * Cin + ci0 + ci) * Cout + co0 + co] : 0.f;
    if (BF16W) v = __bfloat162float(__float2bfloat16_rn(v));
    w_s[e] = v;
  }
}

// x channels [ci0, ci0 + cn) on the ih x iw window at (y0, x0) -> in_s
// (float), zero outside the frame.  CG reads x through L2 only (a map that
// other blocks of the same launch wrote).
template <bool CG = false, typename T>
__device__ __forceinline__ void stage_input(float* in_s, int ld, const T* x, int H,
                                            int W, int Cin, int ci0, int cn, int y0,
                                            int x0, int ih, int iw) {
  for (int e = threadIdx.x; e < ih * iw * CIB; e += kThreads) {
    const int ci = e % CIB, p = e / CIB;
    const int yy = y0 + p / iw, xx = x0 + p % iw;
    float v = 0.f;
    if (ci < cn && yy >= 0 && yy < H && xx >= 0 && xx < W) {
      const T* src = x + ((size_t)yy * W + xx) * Cin + ci0 + ci;
      v = CG ? load_cg(src) : to_f32(*src);
    }
    in_s[p * ld + ci] = v;
  }
}

}  // namespace conv
}  // namespace fcvsr
