// 3x3 SAME convolutions on NHWC tensors, float accumulation.
//
// fcvsr_conv3x3 (K3) replaces fcvsr_tpu/ops/pallas_conv.py::_kernel
// (reached there through conv3x3_rows and conv3x3_rows_nhwc):
// out = act(conv(x) + b + res), the SCNet group conv with its fused
// residual and the C_out=1/3 conv_last0 of the upsampling tail.
//
// fcvsr_conv3x3_pair (K2) replaces fcvsr_tpu/ops/pallas_conv.py::_pair_kernel
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
// with the register tiles of conv3x3.cuh.  The pair recomputes conv1 on a
// one-pixel ring around its tile (1.4x conv1 work) instead of writing the
// intermediate to device memory.
//
// Storage: the maps (x, res, out, and the pair's intermediate in shared
// memory) are float or bf16 (T); weights and biases are float.  bf16
// halves the bytes and the intermediate's shared memory, and rounds where
// the kernel stores.
#include "conv3x3.cuh"

namespace fcvsr {
namespace {

using conv::accumulate;
using conv::CIB;
using conv::stage_input;
using conv::stage_weights;

template <int TH, int TW, int NCG, int CPT>
struct ConvCfg {
  static constexpr int COB = NCG * CPT, NPG = kThreads / NCG;
  static constexpr int PPT = (TH * TW + NPG - 1) / NPG;
  static constexpr int IH = TH + 2, IW = TW + 2, LD = CIB + 1;
  static constexpr size_t smem = sizeof(float) * (IH * IW * LD + 9 * CIB * COB);
};

template <typename T, int TH, int TW, int NCG, int CPT>
__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const T* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ bias, const T* __restrict__ res,
               T* __restrict__ out, int H, int W, int Cin, int Cout, int act,
               float ns) {
  using Cfg = ConvCfg<TH, TW, NCG, CPT>;
  constexpr int COB = Cfg::COB, NPG = Cfg::NPG, PPT = Cfg::PPT;
  extern __shared__ float smem[];
  float* in_s = smem;
  float* w_s = smem + Cfg::IH * Cfg::IW * Cfg::LD;

  const int nco = (Cout + COB - 1) / COB;
  const int b = blockIdx.z / nco, co0 = (blockIdx.z % nco) * COB;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const T* xb = x + (size_t)b * H * W * Cin;

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
      if (res) v += to_f32(res[o + co]);
      out[o + co] = from_f32<T>(act ? leaky(v, ns) : v);
    }
  }
}

template <typename T, int TH, int TW, int NCG, int CPT>
int launch_conv(const void* x, const float* w, const float* bias, const void* res,
                void* out, int B, int H, int W, int Cin, int Cout, int act, float ns,
                cudaStream_t stream) {
  using Cfg = ConvCfg<TH, TW, NCG, CPT>;
  constexpr auto kernel = &conv3x3_kernel<T, TH, TW, NCG, CPT>;
  cudaError_t err = allow_smem<kernel>(Cfg::smem);
  if (err != cudaSuccess) return (int)err;
  const int nco = (Cout + Cfg::COB - 1) / Cfg::COB;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B * nco);
  kernel<<<grid, kThreads, Cfg::smem, stream>>>(
      static_cast<const T*>(x), w, bias, static_cast<const T*>(res),
      static_cast<T*>(out), H, W, Cin, Cout, act, ns);
  return (int)cudaGetLastError();
}

template <typename T>
int conv_dispatch(const void* x, const float* w, const float* bias, const void* res,
                  void* out, int B, int H, int W, int Cin, int Cout, int act, float ns,
                  cudaStream_t s) {
  if (Cout <= 4)  // conv_last0: one pixel and 4 channels per thread
    return launch_conv<T, 16, 16, 1, 4>(x, w, bias, res, out, B, H, W, Cin, Cout, act,
                                        ns, s);
  return launch_conv<T, 8, 16, 8, 8>(x, w, bias, res, out, B, H, W, Cin, Cout, act, ns,
                                     s);
}

// The pair: output tile TH x TW, intermediate tile (TH+2) x (TW+2) x C1.
constexpr int PTH = 8, PTW = 16, PNCG = 8, PCPT = 8;
constexpr int PCOB = PNCG * PCPT, PNPG = kThreads / PNCG;
constexpr int MH = PTH + 2, MW = PTW + 2;   // intermediate region
constexpr int PIH = PTH + 4, PIW = PTW + 4; // input window
constexpr int PPT1 = (MH * MW + PNPG - 1) / PNPG, PPT2 = (PTH * PTW + PNPG - 1) / PNPG;

// the intermediate's leading dimension in elements: one spare element
// (two for bf16, which keeps rows 4-byte aligned)
template <typename T>
__host__ __device__ constexpr int mid_ld(int c1) { return c1 + (sizeof(T) == 4 ? 1 : 2); }

template <typename T>
size_t pair_smem(int c1) {
  size_t mid = (sizeof(T) * (size_t)MH * MW * mid_ld<T>(c1) + 15) / 16 * 16;
  return mid + sizeof(float) * (PIH * PIW * (CIB + 1) + 9 * CIB * PCOB);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv3x3_pair_kernel(const T* __restrict__ x, const float* __restrict__ w1,
                    const float* __restrict__ b1, const float* __restrict__ w2,
                    const float* __restrict__ b2, T* __restrict__ out, int H, int W,
                    int Cin, int C1, int Cout, float ns1) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldm = mid_ld<T>(C1);
  T* mid_s = reinterpret_cast<T*>(smem_raw);    // [MH*MW][ldm]
  float* in_s = reinterpret_cast<float*>(       // [PIH*PIW][CIB+1]
      smem_raw + (sizeof(T) * (size_t)MH * MW * ldm + 15) / 16 * 16);
  float* w_s = in_s + PIH * PIW * (CIB + 1);    // [9][CIB][PCOB]

  const int b = blockIdx.z;
  const int x0 = blockIdx.x * PTW, y0 = blockIdx.y * PTH;
  const T* xb = x + (size_t)b * H * W * Cin;
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
        mid_s[p * ldm + co] = from_f32<T>(inside ? leaky(v, ns1) : 0.f);
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
        if (co < Cout) out[o + co] = from_f32<T>(acc[i][j] + (b2 ? b2[co] : 0.f));
      }
    }
  }
}

template <typename T>
int launch_pair(const void* x, const float* w1, const float* b1, const float* w2,
                const float* b2, void* out, int B, int H, int W, int Cin, int C1,
                int Cout, float ns1, cudaStream_t stream) {
  constexpr auto kernel = &conv3x3_pair_kernel<T>;
  const size_t smem = pair_smem<T>(C1);
  cudaError_t err = allow_smem<kernel>(smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + PTW - 1) / PTW, (H + PTH - 1) / PTH, B);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x), w1, b1, w2, b2,
                                           static_cast<T*>(out), H, W, Cin, C1, Cout,
                                           ns1);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fcvsr

// w: (3,3,Cin,Cout) contiguous; bias (Cout) and res (B,H,W,Cout) may be
// null.  x, res and out are bf16 when bf16 is set, float otherwise.
extern "C" int fcvsr_conv3x3(const void* x, const float* w, const float* bias,
                             const void* res, void* out, int B, int H, int W, int Cin,
                             int Cout, int act, float ns, int bf16, void* stream) {
  using namespace fcvsr;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return conv_dispatch<__nv_bfloat16>(x, w, bias, res, out, B, H, W, Cin, Cout, act,
                                        ns, s);
  return conv_dispatch<float>(x, w, bias, res, out, B, H, W, Cin, Cout, act, ns, s);
}

// w1: (3,3,Cin,C1), w2: (3,3,C1,Cout) contiguous; b1, b2 may be null.  x and
// out (and the intermediate) are bf16 when bf16 is set, float otherwise.
extern "C" int fcvsr_conv3x3_pair(const void* x, const float* w1, const float* b1,
                                  const float* w2, const float* b2, void* out, int B,
                                  int H, int W, int Cin, int C1, int Cout, float ns1,
                                  int bf16, void* stream) {
  using namespace fcvsr;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch_pair<__nv_bfloat16>(x, w1, b1, w2, b2, out, B, H, W, Cin, C1, Cout,
                                      ns1, s);
  return launch_pair<float>(x, w1, b1, w2, b2, out, B, H, W, Cin, C1, Cout, ns1, s);
}
