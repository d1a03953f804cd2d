// 3x3 SAME convolutions on NHWC float32 tensors, f32 accumulation.
//
// fcvsr_conv3x3 replaces fcvsr_tpu/ops/pallas_conv.py::_kernel (reached there
// through conv3x3_rows and conv3x3_rows_nhwc): out = act(conv(x) + b + res),
// the SCNet group conv with its fused residual and the C_out=1/3 conv_last0
// of the upsampling tail.
//
// fcvsr_conv3x3_pair replaces fcvsr_tpu/ops/pallas_conv.py::_pair_kernel
// (conv3x3_pair_rows): out = conv2(lrelu_ns1(conv1(x) + b1)) + b2, with the
// intermediate kept in shared memory and zero outside the frame, so conv2
// sees SAME zero padding of it, as on the TPU.
//
// Bound on the H100: arithmetic.  At the SCNet shapes a pair is ~9 GMAC per
// 272x480 map against ~100 MB of traffic, far above the card's
// operations-per-byte line; this first version runs it on the f32 FMA pipes
// (67 TFLOP/s peak), not the tensor cores.  The design: a block owns an
// output tile of pixels and up to 64 output channels; input (or the
// intermediate) and a 16-channel slice of the weights sit in shared memory,
// and each thread keeps a register tile of 4 pixels x 8 channels, so every
// shared-memory value it loads feeds 4-8 FMAs.  Neighbouring threads take
// neighbouring output channels, so weight reads are conflict-free and input
// reads broadcast.  The pair recomputes conv1 on a one-pixel ring around its
// tile (1.4x conv1 work) instead of writing the intermediate to device
// memory.
#include "common.cuh"

namespace fcvsr {
namespace {

constexpr int CIB = 16;  // input channels staged per step

// acc[i][j] += sum over taps and ci < cn of
//   src[(pixel_i + tap offset) * ld + ci] * w_s[(tap * CIB + ci) * COB + co_j]
// pixel_i = pg + i * NPG in an npix-pixel region of width ow, read from a
// source tile of width sw whose origin is one pixel up-left of the region.
template <int NCG, int CPT, int PPT>
__device__ __forceinline__ void accumulate(float (&acc)[PPT][CPT],
                                           const float* src, int ld, int sw,
                                           const float* w_s, int cn, int npix,
                                           int ow) {
  constexpr int NPG = kThreads / NCG, COB = NCG * CPT;
  const int cg = threadIdx.x % NCG, pg = threadIdx.x / NCG;
  int base[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = min(pg + i * NPG, npix - 1);  // spare slots redo a pixel
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
        const float xv = src[(base[i] + toff) * ld + ci];
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(xv, wv[j], acc[i][j]);
      }
    }
  }
}

// w (3,3,Cin,Cout) rows [ci0, ci0 + cn) x cols [co0, co0 + COB) -> w_s,
// zero beyond Cin / Cout.
template <int COB>
__device__ __forceinline__ void stage_weights(float* w_s, const float* w, int Cin,
                                              int Cout, int ci0, int cn, int co0) {
  for (int e = threadIdx.x; e < 9 * CIB * COB; e += kThreads) {
    const int co = e % COB, ci = (e / COB) % CIB, tap = e / (COB * CIB);
    w_s[e] = (ci < cn && co0 + co < Cout)
                 ? w[((size_t)tap * Cin + ci0 + ci) * Cout + co0 + co] : 0.f;
  }
}

// x channels [ci0, ci0 + cn) on the ih x iw window at (y0, x0) -> in_s,
// zero outside the frame.
__device__ __forceinline__ void stage_input(float* in_s, int ld, const float* x,
                                            int H, int W, int Cin, int ci0, int cn,
                                            int y0, int x0, int ih, int iw) {
  for (int e = threadIdx.x; e < ih * iw * CIB; e += kThreads) {
    const int ci = e % CIB, p = e / CIB;
    const int yy = y0 + p / iw, xx = x0 + p % iw;
    float v = 0.f;
    if (ci < cn && yy >= 0 && yy < H && xx >= 0 && xx < W)
      v = x[((size_t)yy * W + xx) * Cin + ci0 + ci];
    in_s[p * ld + ci] = v;
  }
}

template <int TH, int TW, int NCG, int CPT>
struct ConvCfg {
  static constexpr int COB = NCG * CPT, NPG = kThreads / NCG;
  static constexpr int PPT = (TH * TW + NPG - 1) / NPG;
  static constexpr int IH = TH + 2, IW = TW + 2, LD = CIB + 1;
  static constexpr size_t smem = sizeof(float) * (IH * IW * LD + 9 * CIB * COB);
};

template <int TH, int TW, int NCG, int CPT>
__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ bias, const float* __restrict__ res,
               float* __restrict__ out, int H, int W, int Cin, int Cout, int act,
               float ns) {
  using Cfg = ConvCfg<TH, TW, NCG, CPT>;
  constexpr int COB = Cfg::COB, NPG = Cfg::NPG, PPT = Cfg::PPT;
  extern __shared__ float smem[];
  float* in_s = smem;
  float* w_s = smem + Cfg::IH * Cfg::IW * Cfg::LD;

  const int nco = (Cout + COB - 1) / COB;
  const int b = blockIdx.z / nco, co0 = (blockIdx.z % nco) * COB;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const float* xb = x + (size_t)b * H * W * Cin;

  float acc[PPT][CPT] = {};
  for (int ci0 = 0; ci0 < Cin; ci0 += CIB) {
    const int cn = min(CIB, Cin - ci0);
    stage_input(in_s, Cfg::LD, xb, H, W, Cin, ci0, cn, y0 - 1, x0 - 1, Cfg::IH, Cfg::IW);
    stage_weights<COB>(w_s, w, Cin, Cout, ci0, cn, co0);
    __syncthreads();
    accumulate<NCG, CPT, PPT>(acc, in_s, Cfg::LD, Cfg::IW, w_s, cn, TH * TW, TW);
    __syncthreads();
  }

  const int cg = threadIdx.x % NCG, pg = threadIdx.x / NCG;
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = pg + i * NPG;
    const int y = y0 + p / TW, xx = x0 + p % TW;
    if (p >= TH * TW || y >= H || xx >= W) continue;
    const size_t o = (((size_t)b * H + y) * W + xx) * Cout;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int co = co0 + cg + NCG * j;
      if (co >= Cout) continue;
      float v = acc[i][j];
      if (bias) v += bias[co];
      if (res) v += res[o + co];
      out[o + co] = act ? leaky(v, ns) : v;
    }
  }
}

template <int TH, int TW, int NCG, int CPT>
int launch_conv(const float* x, const float* w, const float* bias, const float* res,
                float* out, int B, int H, int W, int Cin, int Cout, int act, float ns,
                cudaStream_t stream) {
  using Cfg = ConvCfg<TH, TW, NCG, CPT>;
  constexpr auto kernel = &conv3x3_kernel<TH, TW, NCG, CPT>;
  cudaError_t err = allow_smem<kernel>(Cfg::smem);
  if (err != cudaSuccess) return (int)err;
  const int nco = (Cout + Cfg::COB - 1) / Cfg::COB;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B * nco);
  kernel<<<grid, kThreads, Cfg::smem, stream>>>(x, w, bias, res, out, H, W, Cin, Cout,
                                                act, ns);
  return (int)cudaGetLastError();
}

// The pair: output tile TH x TW, intermediate tile (TH+2) x (TW+2) x C1.
constexpr int PTH = 8, PTW = 16, PNCG = 8, PCPT = 8;
constexpr int PCOB = PNCG * PCPT, PNPG = kThreads / PNCG;
constexpr int MH = PTH + 2, MW = PTW + 2;   // intermediate region
constexpr int PIH = PTH + 4, PIW = PTW + 4; // input window
constexpr int PPT1 = (MH * MW + PNPG - 1) / PNPG, PPT2 = (PTH * PTW + PNPG - 1) / PNPG;

size_t pair_smem(int c1) {
  return sizeof(float) *
         ((size_t)MH * MW * (c1 + 1) + PIH * PIW * (CIB + 1) + 9 * CIB * PCOB);
}

__global__ void __launch_bounds__(kThreads)
conv3x3_pair_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                    const float* __restrict__ b1, const float* __restrict__ w2,
                    const float* __restrict__ b2, float* __restrict__ out, int H,
                    int W, int Cin, int C1, int Cout, float ns1) {
  extern __shared__ float smem[];
  const int ldm = C1 + 1;
  float* mid_s = smem;                          // [MH*MW][C1+1]
  float* in_s = mid_s + MH * MW * ldm;          // [PIH*PIW][CIB+1]
  float* w_s = in_s + PIH * PIW * (CIB + 1);    // [9][CIB][PCOB]

  const int b = blockIdx.z;
  const int x0 = blockIdx.x * PTW, y0 = blockIdx.y * PTH;
  const float* xb = x + (size_t)b * H * W * Cin;
  const int cg = threadIdx.x % PNCG, pg = threadIdx.x / PNCG;

  // conv1 on the intermediate region at (y0-1, x0-1)
  for (int co0 = 0; co0 < C1; co0 += PCOB) {
    float acc[PPT1][PCPT] = {};
    for (int ci0 = 0; ci0 < Cin; ci0 += CIB) {
      const int cn = min(CIB, Cin - ci0);
      stage_input(in_s, CIB + 1, xb, H, W, Cin, ci0, cn, y0 - 2, x0 - 2, PIH, PIW);
      stage_weights<PCOB>(w_s, w1, Cin, C1, ci0, cn, co0);
      __syncthreads();
      accumulate<PNCG, PCPT, PPT1>(acc, in_s, CIB + 1, PIW, w_s, cn, MH * MW, MW);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < PPT1; ++i) {
      const int p = pg + i * PNPG;
      if (p >= MH * MW) continue;
      const int y = y0 - 1 + p / MW, xx = x0 - 1 + p % MW;
      const bool inside = y >= 0 && y < H && xx >= 0 && xx < W;
#pragma unroll
      for (int j = 0; j < PCPT; ++j) {
        const int co = co0 + cg + PNCG * j;
        if (co >= C1) continue;
        float v = acc[i][j] + (b1 ? b1[co] : 0.f);
        mid_s[p * ldm + co] = inside ? leaky(v, ns1) : 0.f;
      }
    }
  }
  __syncthreads();

  // conv2 from the intermediate
  for (int co0 = 0; co0 < Cout; co0 += PCOB) {
    float acc[PPT2][PCPT] = {};
    for (int ci0 = 0; ci0 < C1; ci0 += CIB) {
      const int cn = min(CIB, C1 - ci0);
      stage_weights<PCOB>(w_s, w2, C1, Cout, ci0, cn, co0);
      __syncthreads();
      accumulate<PNCG, PCPT, PPT2>(acc, mid_s + ci0, ldm, MW, w_s, cn, PTH * PTW, PTW);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < PPT2; ++i) {
      const int p = pg + i * PNPG;
      const int y = y0 + p / PTW, xx = x0 + p % PTW;
      if (p >= PTH * PTW || y >= H || xx >= W) continue;
      const size_t o = (((size_t)b * H + y) * W + xx) * Cout;
#pragma unroll
      for (int j = 0; j < PCPT; ++j) {
        const int co = co0 + cg + PNCG * j;
        if (co < Cout) out[o + co] = acc[i][j] + (b2 ? b2[co] : 0.f);
      }
    }
  }
}

}  // namespace
}  // namespace fcvsr

// w: (3,3,Cin,Cout) contiguous; bias (Cout) and res (B,H,W,Cout) may be null.
extern "C" int fcvsr_conv3x3(const float* x, const float* w, const float* bias,
                             const float* res, float* out, int B, int H, int W,
                             int Cin, int Cout, int act, float ns, void* stream) {
  using namespace fcvsr;
  cudaStream_t s = (cudaStream_t)stream;
  if (Cout <= 4)  // conv_last0: one pixel and 4 channels per thread
    return launch_conv<16, 16, 1, 4>(x, w, bias, res, out, B, H, W, Cin, Cout, act, ns, s);
  return launch_conv<8, 16, 8, 8>(x, w, bias, res, out, B, H, W, Cin, Cout, act, ns, s);
}

// w1: (3,3,Cin,C1), w2: (3,3,C1,Cout) contiguous; b1, b2 may be null.
extern "C" int fcvsr_conv3x3_pair(const float* x, const float* w1, const float* b1,
                                  const float* w2, const float* b2, float* out, int B,
                                  int H, int W, int Cin, int C1, int Cout, float ns1,
                                  void* stream) {
  using namespace fcvsr;
  const size_t smem = pair_smem(C1);
  cudaError_t err = allow_smem<&conv3x3_pair_kernel>(smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + PTW - 1) / PTW, (H + PTH - 1) / PTH, B);
  conv3x3_pair_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, w1, b1, w2, b2, out, H, W, Cin, C1, Cout, ns1);
  return (int)cudaGetLastError();
}

extern "C" size_t fcvsr_conv3x3_pair_smem(int c1) { return fcvsr::pair_smem(c1); }
