// A BlockRCB conv body in one launch (K6): two chained 3x3 SAME conv pairs,
//
//   y   = conv2(lrelu_ns1(conv1(x) + b1)) + b2      (the block's pair)
//   out = conv4(lrelu_ns3(conv3(y) + b3)) + b4      (the RCB's pair)
//
// both emitted (the RCB residual needs y).  Replaces the TPU kernel
// fcvsr_tpu/ops/pallas_conv.py::_quad_kernel (conv3x3_quad_rows), which
// recomputes a halo so that y never leaves VMEM.  It is the same function
// as two fcvsr_conv3x3_pair launches (conv3x3.cu, K2), with the same
// products (bf16x3 for float maps, two bf16 products for bf16 maps) and
// the same storage rounding at every handoff.
//
// Bound on the H100: arithmetic.  At a 272x480 map with FCVSR's
// 64->128->64 and 64->64->64 pairs, 28.9 G multiply-adds, 57.8 GFLOP at
// the tensor cores' 989 TFLOP/s (0.058 ms; 0.86 ms on the f32 FMA pipes);
// the bytes (x read, y and out written, 100 MB in float) take 0.030 ms.
//
// The design.  On the H100 the TPU's trade is wrong: y is an output of K6
// whatever the design, so a fusion can save only y's re-read (16.7 MB in
// bf16, 33.4 MB in float, most of it still in the 50 MB L2) and one launch,
// and the halo recompute that keeps y on chip costs more: the earlier
// design (four convs from one 4-ring window on the f32 FMA pipes, 6x16 or
// 16x16 tiles) took 9.730 / 5.698 ms against 2 K2 launches' 1.317 / 1.215
// (PERF.md §6).  So K6 is K2's main loop run twice in one persistent
// cooperative launch:
//
// - Phase 1 runs pair_rows (conv_tc.cuh, K2's row loop: wgmma on rows
//   rolled through shared memory, the weights streamed a tap a stage) over
//   K2's work items (62-pixel segments x blocks of rows x images, the same
//   partition as a K2 launch), and writes y.
// - cooperative_groups::this_grid().sync() separates the phases.
// - Phase 2 runs pair_rows over y, reading it through L2 only (ld.global.cg:
//   other blocks of the launch wrote it, and L1 is not coherent across
//   SMs), and writes out.
// - The grid is as large as the card holds co-resident (the occupancy
//   query times the SM count: one block an SM) and never larger than the
//   work items; each block loops over items, so any B, H and W runs.  A
//   grid that cannot be co-resident at all is refused, never split into
//   two launches.
// - Each phase's N1 (C1 padded to 2 N1) is a template argument, as in K2:
//   32 for C1 (or C3) <= 64, 64 up to 128.
//
// The alternative for bf16 maps, all four convs rolled through one block
// (3 rows each of window, conv1, y and conv3 in shared memory, about 127
// KB plus two weight stages; float maps do not fit in 227 KB), avoids the
// grid barrier but recomputes what the pair chain does not: a segment
// keeps 58 of its 64 columns (K2: 62), and a block of R output rows runs
// conv1 over R + 6 rows, y over R + 4, conv3 over R + 2 (the chain: R + 2,
// R, R + 2, R), each row step streaming the weights of every conv it runs,
// the stream that holds K2 (PERF.md §6).  At K2's partition of 272x480 (R
// = 17) that is 1.20x the chain's rows.  Measured before choosing
// (benchmarks/pair_ab.py --quad --takeouts, an H100 80GB HBM3 at 700 W,
// bf16 272x480, ms): this kernel 1.180, without its grid barrier 1.169,
// phase 1 alone 0.629, phase 2 alone 0.523, 2 K2 launches 1.193.  The
// barrier and the phases' tails cost 0.028 ms (this kernel less its two
// phases alone) and y's re-read from L2 (16.7 MB) a few microseconds; the
// rolled chain's 20% more rows would cost about 0.23 ms.  It was not built.
//
// Storage: the maps (x, y, out, and the pairs' intermediates) are float or
// bf16 (T); weights and biases are float.
#include <cooperative_groups.h>

#include "conv_tc.cuh"

namespace cg = cooperative_groups;

namespace fcvsr {
namespace {
namespace tc {

template <typename T, int N1A, int N1B>
__global__ void __launch_bounds__(kThreadsTc, 1)
conv3x3_quad_kernel(const T* __restrict__ x, const float* __restrict__ w1,
                    const float* __restrict__ b1, const float* __restrict__ w2,
                    const float* __restrict__ b2, const float* __restrict__ w3,
                    const float* __restrict__ b3, const float* __restrict__ w4,
                    const float* __restrict__ b4, T* y, T* __restrict__ out, int B,
                    int H, int W, int C, int C1, int C2, int C3, int Cout, float ns1,
                    float ns3, int rows, int vec_x, int vec_y) {
  extern __shared__ __align__(128) unsigned char smem[];
  pair_phase<T, N1A, false>(smem, x, w1, b1, w2, b2, y, B, H, W, C, C1, C2, ns1, rows,
                            vec_x);
  cg::this_grid().sync();  // y complete, and visible in L2
  pair_phase<T, N1B, true>(smem, y, w3, b3, w4, b4, out, B, H, W, C2, C3, Cout, ns3,
                           rows, vec_y);
}

template <typename T, int N1A, int N1B>
int launch_quad(const void* x, const float* w1, const float* b1, const float* w2,
                const float* b2, const float* w3, const float* b3, const float* w4,
                const float* b4, void* y, void* out, int B, int H, int W, int C, int C1,
                int C2, int C3, int Cout, float ns1, float ns3, cudaStream_t stream) {
  constexpr auto kernel = &conv3x3_quad_kernel<T, N1A, N1B>;
  constexpr int smem = pair_smem<T, N1A>() > pair_smem<T, N1B>() ? pair_smem<T, N1A>()
                                                                  : pair_smem<T, N1B>();
  cudaError_t err = allow_smem<kernel>(smem);
  if (err != cudaSuccess) return (int)err;
  int grid = 0, rows = 0;
  if ((err = persistent_plan(kernel, smem, B, H, W, &grid, &rows)) != cudaSuccess)
    return (int)err;
  const auto addr = [](const void* p) { return reinterpret_cast<uintptr_t>(p); };
  int vec_x = (C * (int)sizeof(T)) % 16 == 0 && addr(x) % 16 == 0;
  int vec_y = (C2 * (int)sizeof(T)) % 16 == 0 && addr(y) % 16 == 0;
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  T* ot = static_cast<T*>(out);
  void* args[] = {&xt, &w1, &b1, &w2, &b2, &w3, &b3, &w4, &b4, &yt, &ot, &B, &H,
                  &W, &C, &C1, &C2, &C3, &Cout, &ns1, &ns3, &rows, &vec_x, &vec_y};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                    dim3(kThreadsTc), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int quad_dispatch(const void* x, const float* w1, const float* b1, const float* w2,
                  const float* b2, const float* w3, const float* b3, const float* w4,
                  const float* b4, void* y, void* out, int B, int H, int W, int C, int C1,
                  int C2, int C3, int Cout, float ns1, float ns3, cudaStream_t s) {
  if (C1 <= 64 && C3 <= 64)
    return launch_quad<T, 32, 32>(x, w1, b1, w2, b2, w3, b3, w4, b4, y, out, B, H, W, C,
                                  C1, C2, C3, Cout, ns1, ns3, s);
  if (C1 <= 64)
    return launch_quad<T, 32, 64>(x, w1, b1, w2, b2, w3, b3, w4, b4, y, out, B, H, W, C,
                                  C1, C2, C3, Cout, ns1, ns3, s);
  if (C3 <= 64)
    return launch_quad<T, 64, 32>(x, w1, b1, w2, b2, w3, b3, w4, b4, y, out, B, H, W, C,
                                  C1, C2, C3, Cout, ns1, ns3, s);
  return launch_quad<T, 64, 64>(x, w1, b1, w2, b2, w3, b3, w4, b4, y, out, B, H, W, C, C1,
                                C2, C3, Cout, ns1, ns3, s);
}

}  // namespace tc
}  // namespace
}  // namespace fcvsr

// w1 (3,3,C,C1), w2 (3,3,C1,C2), w3 (3,3,C2,C3), w4 (3,3,C3,Cout)
// contiguous; any bias may be null.  x (B,H,W,C), y (B,H,W,C2) and out
// (B,H,W,Cout) are bf16 when bf16 is set, float otherwise.  Each pair takes
// K2's channels: C, C2 <= 64, C1, C3 <= 128, Cout <= 64 (SCNet's BlockRCB
// is 64->128->64->64->64).
extern "C" int fcvsr_conv3x3_quad(const void* x, const float* w1, const float* b1,
                                  const float* w2, const float* b2, const float* w3,
                                  const float* b3, const float* w4, const float* b4,
                                  void* y, void* out, int B, int H, int W, int C, int C1,
                                  int C2, int C3, int Cout, float ns1, float ns3, int bf16,
                                  void* stream) {
  using namespace fcvsr;
  if (B < 1 || H < 1 || W < 1 || C < 1 || C1 < 1 || C2 < 1 || C3 < 1 || Cout < 1 ||
      C > tc::kCinMax || C1 > tc::kC1Max || C2 > tc::kCoutMax || C3 > tc::kC1Max ||
      Cout > tc::kCoutMax)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return tc::quad_dispatch<__nv_bfloat16>(x, w1, b1, w2, b2, w3, b3, w4, b4, y, out, B,
                                            H, W, C, C1, C2, C3, Cout, ns1, ns3, s);
  return tc::quad_dispatch<float>(x, w1, b1, w2, b2, w3, b3, w4, b4, y, out, B, H, W, C,
                                  C1, C2, C3, Cout, ns1, ns3, s);
}
