// A BlockRCB conv body in one launch (K6): two chained 3x3 SAME conv pairs,
//
//   y   = conv2(lrelu_ns1(conv1(x) + b1)) + b2      (the block's pair)
//   out = conv4(lrelu_ns3(conv3(y) + b3)) + b4      (the RCB's pair)
//
// both emitted (the RCB residual needs y).  Replaces the TPU kernel
// fcvsr_tpu/ops/pallas_conv.py::_quad_kernel (conv3x3_quad_rows).  It is
// the same function as two fcvsr_conv3x3_pair launches (conv3x3.cu, K2),
// with the same storage rounding at every handoff.
//
// Bound on the H100: arithmetic (57.8 GFLOP at a 272x480 map with FCVSR's
// 64->128->64 and 64->64->64 convs, 0.86 ms on the f32 FMA pipes).  What
// the fusion saves against two pair launches is y's round trip through
// device memory and one launch; what it costs is halo recompute: the four
// convs run from one input window, each on a region one pixel ring larger
// than the next, so the window carries 4 rings and the first conv computes
// (TH+6) x (TW+6) pixels for TH x TW outputs.  The 128-channel first
// intermediate fills shared memory and sets the tile: 6x16 in float
// storage (1.9x the pair chain's conv work... at 64->128 the first conv
// alone 2.75x), 16x16 in bf16 (1.5x overall).  The regions live in shared
// memory at the storage type T: the first intermediate (later overwritten
// by the third), y (whose space first holds the staged input window), and
// a 16-input-channel slice of the weights.  Every conv runs the register
// tiles of conv3x3.cuh over passes of 256 pixels.  Values outside the frame
// are zero in every region, which gives each conv SAME zero padding.  Any H
// and W: tiles at the frame's edge are cut.
#include "conv3x3.cuh"

namespace fcvsr {
namespace {

using conv::accumulate;
using conv::CIB;
using conv::stage_input;
using conv::stage_weights;

template <typename T>
struct QuadTile;
template <>
struct QuadTile<float> {
  static constexpr int TH = 6, TW = 16;
};
template <>
struct QuadTile<__nv_bfloat16> {
  static constexpr int TH = 16, TW = 16;
};

constexpr int NCG = 8, CPT = 8, COB = NCG * CPT, NPG = kThreads / NCG;
constexpr int PPT = 8, PASS = NPG * PPT;  // 256 pixels a pass

// leading dimension of a T region of c channels: one spare element (two
// for bf16, keeping rows 4-byte aligned)
template <typename T>
__host__ __device__ constexpr int region_ld(int c) { return c + (sizeof(T) == 4 ? 1 : 2); }

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// Shared-memory layout in bytes: region A (the first intermediate, later
// the third), region B (the staged input window, later y), the weights.
template <typename T>
struct QuadLayout {
  static constexpr int TH = QuadTile<T>::TH, TW = QuadTile<T>::TW;
  static constexpr int R1H = TH + 6, R1W = TW + 6;  // conv1 out, at (y0-3, x0-3)
  static constexpr int R2H = TH + 4, R2W = TW + 4;  // y, at (y0-2, x0-2)
  static constexpr int R3H = TH + 2, R3W = TW + 2;  // conv3 out, at (y0-1, x0-1)
  static constexpr int IH = TH + 8, IW = TW + 8;    // input window, at (y0-4, x0-4)
  size_t a, b, w, total;
  __host__ __device__ QuadLayout(int c1, int c2, int c3) {
    const size_t mid1 = sizeof(T) * (size_t)R1H * R1W * region_ld<T>(c1);
    const size_t mid3 = sizeof(T) * (size_t)R3H * R3W * region_ld<T>(c3);
    const size_t ys = sizeof(T) * (size_t)R2H * R2W * region_ld<T>(c2);
    const size_t in = sizeof(float) * (size_t)IH * IW * (CIB + 1);
    a = 0;
    b = align16(mid1 > mid3 ? mid1 : mid3);
    w = b + align16(ys > in ? ys : in);
    total = w + sizeof(float) * 9 * CIB * COB;
  }
};

// One conv of the chain over an npix-pixel region of width ow: for each
// 64-channel output chunk and 256-pixel pass, sum over 16-channel input
// chunks (stage(ci0, cn) returns the source, staging it first if needed),
// then epi(p, co, v) for each pixel p < npix and channel co < Cout.
template <typename S, typename Stage, typename Epi>
__device__ __forceinline__ void conv_region(int npix, int ow, int Cin, int Cout,
                                            const float* __restrict__ w, float* w_s,
                                            Stage stage, Epi epi) {
  const int cg = threadIdx.x % NCG, pg = threadIdx.x / NCG;
  for (int co0 = 0; co0 < Cout; co0 += COB) {
    for (int p0 = 0; p0 < npix; p0 += PASS) {
      float acc[PPT][CPT] = {};
      for (int ci0 = 0; ci0 < Cin; ci0 += CIB) {
        const int cn = min(CIB, Cin - ci0);
        int ld = 0, sw = 0;
        const S* src = stage(ci0, cn, ld, sw);
        stage_weights<COB>(w_s, w, Cin, Cout, ci0, cn, co0);
        __syncthreads();
        accumulate<NCG, CPT, PPT>(acc, src, ld, sw, w_s, cn, npix, ow, p0);
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        const int p = p0 + pg + i * NPG;
        if (p >= npix) continue;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int co = co0 + cg + NCG * j;
          if (co < Cout) epi(p, co, acc[i][j]);
        }
      }
    }
  }
  __syncthreads();  // the next conv reads what epi wrote
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv3x3_quad_kernel(const T* __restrict__ x, const float* __restrict__ w1,
                    const float* __restrict__ b1, const float* __restrict__ w2,
                    const float* __restrict__ b2, const float* __restrict__ w3,
                    const float* __restrict__ b3, const float* __restrict__ w4,
                    const float* __restrict__ b4, T* __restrict__ y_out,
                    T* __restrict__ out, int H, int W, int C, int C1, int C2, int C3,
                    int Cout, float ns1, float ns3) {
  using L = QuadLayout<T>;
  constexpr int TH = L::TH, TW = L::TW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const L lay(C1, C2, C3);
  T* mid1 = reinterpret_cast<T*>(smem_raw + lay.a);
  T* mid3 = mid1;  // conv3 writes once conv2 has read conv1's output
  float* in_s = reinterpret_cast<float*>(smem_raw + lay.b);
  T* ys = reinterpret_cast<T*>(smem_raw + lay.b);  // y once conv1 is done
  float* w_s = reinterpret_cast<float*>(smem_raw + lay.w);
  const int ld1 = region_ld<T>(C1), ld2 = region_ld<T>(C2), ld3 = region_ld<T>(C3);

  const int b = blockIdx.z;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const T* xb = x + (size_t)b * H * W * C;

  // conv1: the input window -> the first intermediate over R1
  conv_region<float>(
      L::R1H * L::R1W, L::R1W, C, C1, w1, w_s,
      [&](int ci0, int cn, int& ld, int& sw) -> const float* {
        stage_input(in_s, CIB + 1, xb, H, W, C, ci0, cn, y0 - 4, x0 - 4, L::IH, L::IW);
        ld = CIB + 1;
        sw = L::IW;
        return in_s;
      },
      [&](int p, int co, float v) {
        const int yy = y0 - 3 + p / L::R1W, xx = x0 - 3 + p % L::R1W;
        v += b1 ? b1[co] : 0.f;
        mid1[p * ld1 + co] = from_f32<T>(in_frame(yy, xx, H, W) ? leaky(v, ns1) : 0.f);
      });

  // conv2: y over R2; the tile's own pixels also go to y_out
  conv_region<T>(
      L::R2H * L::R2W, L::R2W, C1, C2, w2, w_s,
      [&](int ci0, int, int& ld, int& sw) -> const T* {
        ld = ld1;
        sw = L::R1W;
        return mid1 + ci0;
      },
      [&](int p, int co, float v) {
        const int ry = p / L::R2W, rx = p % L::R2W;
        const int yy = y0 - 2 + ry, xx = x0 - 2 + rx;
        const bool inside = in_frame(yy, xx, H, W);
        const T q = from_f32<T>(inside ? v + (b2 ? b2[co] : 0.f) : 0.f);
        ys[p * ld2 + co] = q;
        if (inside && ry >= 2 && ry < TH + 2 && rx >= 2 && rx < TW + 2)
          y_out[(((size_t)b * H + yy) * W + xx) * C2 + co] = q;
      });

  // conv3: the third intermediate over R3
  conv_region<T>(
      L::R3H * L::R3W, L::R3W, C2, C3, w3, w_s,
      [&](int ci0, int, int& ld, int& sw) -> const T* {
        ld = ld2;
        sw = L::R2W;
        return ys + ci0;
      },
      [&](int p, int co, float v) {
        const int yy = y0 - 1 + p / L::R3W, xx = x0 - 1 + p % L::R3W;
        v += b3 ? b3[co] : 0.f;
        mid3[p * ld3 + co] = from_f32<T>(in_frame(yy, xx, H, W) ? leaky(v, ns3) : 0.f);
      });

  // conv4: out over the TH x TW tile
  conv_region<T>(
      TH * TW, TW, C3, Cout, w4, w_s,
      [&](int ci0, int, int& ld, int& sw) -> const T* {
        ld = ld3;
        sw = L::R3W;
        return mid3 + ci0;
      },
      [&](int p, int co, float v) {
        const int yy = y0 + p / TW, xx = x0 + p % TW;
        if (in_frame(yy, xx, H, W))
          out[(((size_t)b * H + yy) * W + xx) * Cout + co] =
              from_f32<T>(v + (b4 ? b4[co] : 0.f));
      });
}

template <typename T>
int launch_quad(const void* x, const float* w1, const float* b1, const float* w2,
                const float* b2, const float* w3, const float* b3, const float* w4,
                const float* b4, void* y, void* out, int B, int H, int W, int C, int C1,
                int C2, int C3, int Cout, float ns1, float ns3, cudaStream_t stream) {
  using L = QuadLayout<T>;
  constexpr auto kernel = &conv3x3_quad_kernel<T>;
  const size_t smem = L(C1, C2, C3).total;
  cudaError_t err = allow_smem<kernel>(smem);  // refuses above 227 KB
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + L::TW - 1) / L::TW, (H + L::TH - 1) / L::TH, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), w1, b1, w2, b2, w3, b3, w4, b4, static_cast<T*>(y),
      static_cast<T*>(out), H, W, C, C1, C2, C3, Cout, ns1, ns3);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fcvsr

// w1 (3,3,C,C1), w2 (3,3,C1,C2), w3 (3,3,C2,C3), w4 (3,3,C3,Cout)
// contiguous; any bias may be null.  x (B,H,W,C), y (B,H,W,C2) and out
// (B,H,W,Cout) are bf16 when bf16 is set, float otherwise.
extern "C" int fcvsr_conv3x3_quad(const void* x, const float* w1, const float* b1,
                                  const float* w2, const float* b2, const float* w3,
                                  const float* b3, const float* w4, const float* b4,
                                  void* y, void* out, int B, int H, int W, int C, int C1,
                                  int C2, int C3, int Cout, float ns1, float ns3, int bf16,
                                  void* stream) {
  using namespace fcvsr;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch_quad<__nv_bfloat16>(x, w1, b1, w2, b2, w3, b3, w4, b4, y, out, B, H, W,
                                      C, C1, C2, C3, Cout, ns1, ns3, s);
  return launch_quad<float>(x, w1, b1, w2, b2, w3, b3, w4, b4, y, out, B, H, W, C, C1,
                            C2, C3, Cout, ns1, ns3, s);
}
