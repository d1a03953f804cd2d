// One exact IAC iteration on NHWC tensors (K1):
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
// Two modes.  Materialised: the per-pixel kernels are read, this
// iteration's 3C columns of pred_k (B,H,W,n*3C), the largest stream.  KF
// (fused kernel prediction, the TPU kernel's kf mode): they are computed in
// the block as k = f0 . Wsel + b from the predictor feature f0 (B,H,W,C0)
// and the iteration's columns of Wsel (C0, n*3C), so the kernel tensor is
// never written or read.
//
// Bound on the H100: bytes.  Materialised, float32 maps at 272x480x64: feat
// (gathered), flow, the 3C kernels and feat_in read, out written, 201.6 MB,
// 0.060 ms at 3.35 TB/s; the arithmetic is ~22 flops a value.  KF: 134.7 MB
// (no kernel stream), and the prediction's 2 C0 3C flops a pixel, 3.2 GFLOP
// at B 1, are 0.003 ms at the tensor cores' 989 TFLOP/s.
//
// The design.  K1's earlier tile body (8x16 pixels x 16 channels a block,
// every value loaded element by element, the flow and the corners
// recomputed for each of the 4 channel chunks, the kf prediction a scalar
// dot product per (pixel, tap, channel) on the float32 pipes) took 1.753
// ms at bf16 B 2 (PERF.md §6).  This one, iac.cuh's tile(), which the
// resident chain (K4, iac_chain.cu) runs too:
//
// - A block owns a tile of TH = 8 rows x TW = 14 output columns and every
//   channel.  A row's passes run over MP = 16 columns, x0 - 1 .. x0 + 14:
//   the vertical pass at the two halo columns too, so the horizontal pass
//   finds all three of its taps in the row.  16 columns are the M of an
//   mma.sync m16n8k16, and the kernels of a row's 16 pixels are one GEMM.
// - The corners of the tile's (TH + 2) x 16 warped pixels are computed
//   once, for all channels, into shared memory; the warped tile is then
//   gathered 8 channels an item, 16-byte loads (two for float32), all four
//   corners of two items in flight.
// - Warp w takes the channel blocks cb = w, w + 8, ... (8 channels each)
//   for all TH rows.  Its lanes hold an mma fragment: pixels g and g + 8
//   (g = lane / 4) of the row, channels 8 cb + 2 (lane % 4) + {0, 1}, for
//   the three taps.  The vertical pass reads the warped rows from shared
//   memory; the horizontal pass takes the neighbouring columns' sums from
//   the neighbouring lanes by shuffles, so the vertical pass and the
//   kernels never go to shared memory.  Each pixel's kernels are read
//   once: 32 contiguous bytes a pixel and tap (float32), 8 bytes a lane.
// - Materialised: a row's kernels are loaded a row ahead, and the first
//   row's before the gather.  KF: the prediction runs on the tensor cores:
//   for each row, A = f0 at the row's 16 pixels (16 x C0) times B = Wsel's
//   columns of the warp's channels (C0 x 8, one n-tile a tap).  f0's tile
//   (TH x 16 pixels x C0) is copied into shared memory by cp.async,
//   issued before the corners and the gather, which run while it lands.
//   Wsel comes split into planes (hi, and the rounding of what is left),
//   transposed and C0 padded to 16 (fused_iac.wsel_planes: once a weight
//   version, not in every block); each warp keeps its B fragments in
//   registers for all TH rows.  Precision, emulated on the CPU first
//   (fused_iac.predict_kernels_emulated, tests/test_torch_iac_tc.py): bf16
//   f0 is exact and takes two bf16 products, f0 w_hi + f0 w_lo (m16n8k16);
//   float32 f0 takes 3xTF32, f0_hi w_hi + f0_hi w_lo + f0_lo w_hi on TF32
//   parts (m16n8k8, within 3 x 2^-22 of each product): bf16x3, K2's route,
//   misses the 2e-5 bar at C0 5 (2.4e-4 against 2.2e-4 on the card and in
//   the emulation), 3xTF32 holds it by 100x.  Sums in float32.
// - Shared memory at C = 64: the warped tile 10 x 16 x 72 floats (46,080
//   bytes; 72 = 64 + 8 words a pixel, so a fragment's 8 pixels read
//   distinct banks), the corners 5,120, KF float32 f0's tile 8 x 16 x 68
//   floats (34,816): 51 KB materialised, 86 KB KF.  Several blocks share
//   an SM, so one block's gather overlaps another's passes (float32 KF
//   holds 96 registers of Wsel's TF32 fragments: one block).
//
// The maps (feat, k, f0, feat_in, out) are float or bf16 storage; flow,
// Wsel's planes and bsel as stated below; arithmetic and sums are float.
#include "iac.cuh"

namespace fcvsr {
namespace {
namespace k1 {

// K1: one block a tile
template <typename T, bool KF>
__global__ void __launch_bounds__(kThreads, KF ? (sizeof(T) == 4 ? 1 : 2) : 3)
iac_kernel(const T* __restrict__ feat, const float* __restrict__ flow,
           const T* __restrict__ k, const void* __restrict__ wpl, int k_ld,
           int k_off, const T* __restrict__ f0, const float* __restrict__ bsel, int c0,
           const T* __restrict__ feat_in, T* __restrict__ out, int H, int W, int C,
           int act, int vec, int f0vec, int pairs) {
  extern __shared__ __align__(16) unsigned char smem[];
  tile<T, KF>(smem, blockIdx.z, blockIdx.y * TH, blockIdx.x * TW, feat, flow, k, wpl,
              k_ld, k_off, f0, bsel, c0, feat_in, out, H, W, C, act, vec, f0vec, pairs);
}

template <typename T, bool KF>
int launch(const void* feat, const float* flow, const void* k, int k_ld, int k_off,
           const void* f0, const float* bsel, int c0, const void* feat_in, void* out,
           int B, int H, int W, int C, int act, cudaStream_t stream) {
  constexpr auto kernel = &iac_kernel<T, KF>;
  const size_t smem = smem_bytes<T>(KF, C, c0);
  cudaError_t err = allow_smem<kernel>(smem);
  if (err != cudaSuccess) return (int)err;
  const auto addr = [](const void* p) { return reinterpret_cast<uintptr_t>(p); };
  const int vec = (C * sizeof(T)) % 16 == 0 && addr(feat) % 16 == 0;
  const int f0vec = KF && (c0 * sizeof(T)) % 16 == 0 && addr(f0) % 16 == 0;
  const int pairs = C % 2 == 0 &&
                    (addr(feat_in) | addr(out) | (KF ? 0 : addr(k))) % (2 * sizeof(T)) == 0;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  // with KF, k is Wsel's planes; otherwise the materialised kernels (T)
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(feat), flow, KF ? nullptr : static_cast<const T*>(k),
      KF ? k : nullptr, k_ld, k_off,
      static_cast<const T*>(f0), bsel, c0, static_cast<const T*>(feat_in),
      static_cast<T*>(out), H, W, C, act, vec, f0vec, pairs);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* feat, const float* flow, const void* k, int k_ld, int k_off,
             const void* f0, const float* bsel, int c0, const void* feat_in, void* out,
             int B, int H, int W, int C, int act, cudaStream_t stream) {
  if (f0 != nullptr)
    return launch<T, true>(feat, flow, k, k_ld, k_off, f0, bsel, c0, feat_in, out, B, H,
                           W, C, act, stream);
  return launch<T, false>(feat, flow, k, k_ld, k_off, f0, bsel, c0, feat_in, out, B, H,
                          W, C, act, stream);
}

}  // namespace k1
}  // namespace
}  // namespace fcvsr

// k: the materialised kernels (B,H,W,k_ld), this iteration's tap-major
// block at columns [k_off, k_off + 3C); or, with f0 non-null, Wsel (c0,
// k_ld) as its planes (2, k_ld, c0 rounded up to 16): the rounding of
// Wsel's transpose and the rounding of what is left, zeros past c0, to
// TF32 (in float32 words) for float32 maps, to bf16 for bf16 maps
// (fused_iac.wsel_planes), and bsel (k_ld) in float, the block at the same
// columns.  The maps feat, k (materialised), f0, feat_in and out are bf16
// when bf16 is set, float otherwise; flow and bsel are float.  C <= 128,
// c0 <= 64.
extern "C" int fcvsr_iac_step(const void* feat, const float* flow, const void* k,
                              int k_ld, int k_off, const void* f0, const float* bsel,
                              int c0, const void* feat_in, void* out, int B, int H,
                              int W, int C, int act, int bf16, void* stream) {
  using namespace fcvsr;
  if (B < 1 || H < 1 || W < 1 || C < 1 || C > k1::kCMax ||
      (f0 != nullptr && (c0 < 1 || c0 > k1::kC0Max)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return k1::dispatch<__nv_bfloat16>(feat, flow, k, k_ld, k_off, f0, bsel, c0, feat_in,
                                       out, B, H, W, C, act, s);
  return k1::dispatch<float>(feat, flow, k, k_ld, k_off, f0, bsel, c0, feat_in, out, B, H,
                             W, C, act, s);
}

extern "C" const char* fcvsr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
