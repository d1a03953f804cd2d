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
// K3's bound on the H100: arithmetic, on the f32 FMA pipes (67 TFLOP/s):
// a block owns an output tile of pixels and up to 64 output channels;
// input and a 16-channel slice of the weights sit in shared memory, with
// the register tiles of conv3x3.cuh.
//
// K2 runs on the tensor cores, an implicit GEMM on warpgroup MMA (wgmma,
// csrc/hopper.cuh): M = 64 pixels of one row segment, N = output channels,
// K = 9 taps x input channels.  Each tap is one shifted window: the same
// stored rows read (dy rows, dx pixels) further on.  The operands are in the
// no-swizzle K-major layout, [8-channel chunk][pixel][8 channels], so a tap's
// dx is a 16-byte step of the descriptor's start address and nothing is
// copied per tap (an im2col tile built in shared memory cost 3.7x the
// window's copy, PERF.md §6).
//
// Precision.  The products run in bf16 with float32 sums.  A float32 map
// and every weight are split into a bf16 high part and the bf16 rounding
// of the rest, and the product takes three passes, hi*hi + hi*lo + lo*hi
// ("bf16x3"), within 3 x 2^-16 of each product; a bf16 map is exact, so two
// passes, x*w_hi + x*w_lo, keep the float32 weights.  Emulated on the CPU
// at SCNet's 64->128->64 pair (ops/fused_conv.py::conv3x3_pair_emulated),
// one TF32 pass misses the float32 bar (1e-4 of max|out|) by 5x; bf16x3
// and 3xTF32 hold it by 14x and 85x; bf16x3 runs at twice TF32's rate, and
// its two planes take the 4 bytes of the float32 they replace, where
// 3xTF32's would take 8.
//
// The rows roll.  A block owns a segment of 62 output pixels (64 computed:
// the last two would need the pixels past the 66 stored) and `rows` output
// rows of one image.  Three slots of window rows and three of intermediate
// rows turn over: each step loads one window row, computes one
// intermediate row (conv1, 9 taps) and one output row from the last three
// (conv2, 9 taps), so a block recomputes 2 intermediate rows, not a halo
// of each tile: at 272x480 a block takes 17 rows (19 conv1 rows).  Shared
// memory, float32 maps (two bf16 planes, C1 128): 3 window rows of 66 x 64
// x 4 bytes (50,688) + 3 intermediate rows of 66 x 128 x 4 (101,376) + 2
// weight stages of 2 planes x 128 x 64 x 2 (65,536) = 217,600 of 232,448
// bytes; bf16 maps 141,568.  An 8-row tile's intermediate alone (10 x 66 x
// 128 x 4 bytes = 338 KB) would not fit.
//
// The weights stream through two stages of one tap each (a conv1 tap is
// Cin x C1, a conv2 tap C1 x Cout, 8192 values at most), one stream of 18
// taps a step (stage_at).  While the two warpgroups' wgmma multiply one
// stage, all 256 threads split and transpose the next tap, loaded from the
// HWIO float32 weights during the stage before, into the K-major bf16
// planes of the other stage, and load the tap after it: each load's
// latency passes under a stage of wgmma (loaded and stored in the same
// stage, the weights took 0.79 of 1.27 ms, PERF.md §6).  Then the wgmma
// drain, a proxy fence and one barrier.  The window rows are read the same
// way (16-byte loads where the pixel stride allows, element loads
// otherwise, zeros outside the frame), loaded during conv1's third tap and
// stored during its fourth, once the slot of the row they replace has been
// read.  The two warpgroups split N: conv1's C1 (up to 2 x 64) and conv2's
// Cout (2 x 32).  Cin is padded to 64 and C1 to 64 or 128 with zero
// weights, so that the main loop's counts are compile-time; padded
// outputs are not stored.
//
// Bound: 2 x 19.25 G multiply-adds at 272x480 (64->128->64), 38.5 GFLOP at
// the tensor cores' 989 TFLOP/s, 0.039 ms; the route's three bf16 passes
// take three times that (0.117 ms).  What holds it is the weights' stream:
// every block splits all of them (147,456 float32 values) for every
// output row.  One tap's products (mma_tap) are the main loop's body; K3, a
// single conv with its residual, is its one-conv case.
//
// Storage: the maps (x, res, out, and the pair's intermediate) are float or
// bf16 (T); weights and biases are float.  bf16 maps round where the
// kernels store, as the plain versions do.
#include <type_traits>

#include "conv3x3.cuh"
#include "hopper.cuh"

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

// ------------------------------------------------------------------- K2

namespace pair {

namespace sm90 = fcvsr::sm90;

constexpr int kM = 64;                  // pixels of a row segment: the wgmma M
constexpr int kSeg = kM - 2;            // output pixels a segment
constexpr int kRowPx = kM + 2;          // pixels of a stored row: a tap reads 64 of them
constexpr int kChunk = 16;              // bytes of a core-matrix row: 8 bf16 channels
constexpr int kLbo = kRowPx * kChunk;   // a stored row's 8-channel chunks lie this far apart
constexpr int kSbo = 8 * kChunk;        // 8 pixels (or 8 weight rows) on
constexpr int kThreadsTc = 256;         // two warpgroups
constexpr int kCinMax = 64, kC1Max = 128, kCoutMax = 64;
constexpr int kN2 = kCoutMax / 2;       // conv2's output channels a warpgroup
constexpr int kStageItems = 4;          // (weight row, 8 k) items of a stage a thread
// bf16 products a k step: three for float maps (bf16x3: hi*hi + hi*lo +
// lo*hi), two for bf16 maps (x*w_hi + x*w_lo); one bf16 pass misses the
// float32 bar (PERF.md §6)
template <typename T>
constexpr int kPasses = sizeof(T) == 4 ? 3 : 2;

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// v -> its bf16 rounding (hi) and the bf16 rounding of what is left (lo), 8
// values as two 16-byte rows of the K-major layout
__device__ __forceinline__ void split8(const float (&v)[8], uint4& hi, uint4& lo) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 hb = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    const float2 hf = __bfloat1622float2(hb);
    h[i] = bf16x2_bits(hb);
    l[i] = bf16x2_bits(__floats2bfloat162_rn(v[2 * i] - hf.x, v[2 * i + 1] - hf.y));
  }
  hi = make_uint4(h[0], h[1], h[2], h[3]);
  lo = make_uint4(l[0], l[1], l[2], l[3]);
}

// One tap of a conv's float32 weights w[tap] (K x N, N contiguous), as the
// thread's kStageItems items of a stage: item it = (weight row n = it % NP,
// k chunk it / NP), 8 k values each (zeros past K and N).  Only loads: the
// values are used a stage later (store_stage), so their latency passes
// under a stage of wgmma.
__device__ __forceinline__ void load_stage(float (&v)[kStageItems][8],
                                           const float* __restrict__ w, int K, int N,
                                           int KP, int NP, int tap) {
  const float* wt = w + (size_t)tap * K * N;
  const int items = NP * (KP / 8);
#pragma unroll
  for (int i = 0; i < kStageItems; ++i) {
    const int it = threadIdx.x + i * kThreadsTc;
    const int n = it % NP, k0 = it / NP * 8;
    const bool in = it < items && n < N;
    const float* p = wt + (size_t)k0 * N + n;
#pragma unroll
    for (int e = 0; e < 8; ++e) v[i][e] = in && k0 + e < K ? __ldg(p + e * N) : 0.f;
  }
}

// The items into a stage: bf16 planes of KP / 8 chunks of NP rows (k
// contiguous, 16 bytes a row), the hi plane at dst, the lo plane plane_b
// bytes on when `lo`.
__device__ __forceinline__ void store_stage(unsigned char* dst, int plane_b, bool lo,
                                            const float (&v)[kStageItems][8], int KP,
                                            int NP) {
  const int items = NP * (KP / 8);
#pragma unroll
  for (int i = 0; i < kStageItems; ++i) {
    const int it = threadIdx.x + i * kThreadsTc;
    if (it < items) {
      uint4 hi, lw;
      split8(v[i], hi, lw);
      unsigned char* p = dst + (it / NP) * NP * kChunk + (it % NP) * kChunk;
      *reinterpret_cast<uint4*>(p) = hi;
      if (lo) *reinterpret_cast<uint4*>(p + plane_b) = lw;
    }
  }
}

// 8 channels [c0, c0 + 8) of one pixel (zeros past Cin and where !in)
__device__ __forceinline__ void load8(float (&v)[8], const float* p, int left, bool in,
                                      int vec) {
  if (in && vec) {  // Cin a multiple of 4: each 16-byte half is in or out whole
    const float4 a = left > 0 ? __ldg(reinterpret_cast<const float4*>(p)) : float4{};
    const float4 b = left > 4 ? __ldg(reinterpret_cast<const float4*>(p) + 1) : float4{};
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = in && e < left ? __ldg(p + e) : 0.f;
}

__device__ __forceinline__ void load8(uint4& v, const __nv_bfloat16* p, int left, bool in,
                                      int vec) {
  if (in && vec) {  // Cin a multiple of 8
    v = left > 0 ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0, 0, 0, 0);
    return;
  }
  uint32_t h[4];
  const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t a = in && 2 * i < left ? __ldg(q + 2 * i) : 0u;
    const uint32_t b = in && 2 * i + 1 < left ? __ldg(q + 2 * i + 1) : 0u;
    h[i] = a | (b << 16);
  }
  v = make_uint4(h[0], h[1], h[2], h[3]);
}

// A window row's values as the thread's items: 8 channels of a pixel each
// (float, or the bf16 map's 16 bytes)
template <typename T>
struct RowItems {
  static constexpr int kItems = (kRowPx * kCinMax / 8 + kThreadsTc - 1) / kThreadsTc;
  using Raw = typename std::conditional<sizeof(T) == 4, float[8], uint4>::type;
  Raw raw[kItems];
};

// Window row y of image xb (pixels x0 - 2 ..., kRowPx of them): loads only,
// zeros outside the frame and past Cin; item it = (pixel it / nch, chunk
// it % nch)
template <typename T>
__device__ __forceinline__ void load_row(RowItems<T>& r, const T* xb, int H, int W,
                                         int Cin, int nch, int y, int x0, int vec) {
  const int items = kRowPx * nch;
  const bool row_in = y >= 0 && y < H;
#pragma unroll
  for (int i = 0; i < RowItems<T>::kItems; ++i) {
    const int it = threadIdx.x + i * kThreadsTc;
    const int c = it % nch, xx = x0 - 2 + it / nch;
    const bool in = it < items && row_in && xx >= 0 && xx < W;
    load8(r.raw[i], xb + ((size_t)(in ? y : 0) * W + (in ? xx : 0)) * Cin + c * 8,
          Cin - c * 8, in, vec);
  }
}

// ... into its slot: chunk c of pixel px at c * kLbo + px * 16, float maps
// split into the hi plane and the lo plane plane_b bytes on
template <typename T>
__device__ __forceinline__ void store_row(unsigned char* slot, int plane_b,
                                          const RowItems<T>& r, int nch) {
  const int items = kRowPx * nch;
#pragma unroll
  for (int i = 0; i < RowItems<T>::kItems; ++i) {
    const int it = threadIdx.x + i * kThreadsTc;
    if (it < items) {
      unsigned char* p = slot + (it % nch) * kLbo + (it / nch) * kChunk;
      if constexpr (sizeof(T) == 4) {
        uint4 hi, lo;
        split8(r.raw[i], hi, lo);
        *reinterpret_cast<uint4*>(p) = hi;
        *reinterpret_cast<uint4*>(p + plane_b) = lo;
      } else {
        *reinterpret_cast<uint4*>(p) = r.raw[i];
      }
    }
  }
}

// One tap's products, the main loop's body: the stored rows at `at` (A:
// its hi plane, the lo plane a_plane bytes on) times this warpgroup's N
// rows of the stage at `bt` (B: 16 bytes a row, chunks ldb bytes apart,
// the lo plane plane_b bytes on), in KSTEPS k16 steps of PASSES products
// each: hi*hi, hi*lo_w, lo*hi_w; tap 0's first product clears the sums.
// Both counts are compile-time: with run-time counts the kernel took 1.2x
// as long (PERF.md §6).
template <int N, int KSTEPS, int PASSES, int R>
__device__ __forceinline__ void mma_tap(float (&acc)[R], uint32_t at, int a_plane,
                                        uint32_t bt, int plane_b, int ldb, int tap) {
#pragma unroll
  for (int s = 0; s < KSTEPS; ++s)
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const uint64_t da =
          sm90::desc_interleave(at + (p == 2 ? a_plane : 0) + 2 * s * kLbo, kLbo, kSbo);
      const uint64_t db =
          sm90::desc_interleave(bt + (p == 1 ? plane_b : 0) + 2 * s * ldb, ldb, kSbo);
      sm90::wgmma_m64k16_bf16<N, 0>(acc, da, db, tap | s | p);
    }
}

// The stage stream of a block: stage q is a tap of conv1 for the first 18
// (steps -1 and 0, the first two intermediate rows), then 9 taps of conv1
// and 9 of conv2 a step
struct Stage {
  int j, conv, tap;  // step (intermediate row y0 + j), conv (1 or 2), tap
};

__device__ __forceinline__ Stage stage_at(int q) {
  if (q < 18) return {q / 9 - 1, 1, q % 9};
  const int r = q - 18;
  return {r / 18 + 1, r % 18 < 9 ? 1 : 2, r % 9};
}

__host__ __device__ constexpr int slot_of(int row) { return ((row % 3) + 3) % 3; }

// shared memory of a launch: 3 window rows, 3 intermediate rows, 2 stages
constexpr int pair_smem(int a_planes, int c1p, int w_planes) {
  return 3 * a_planes * (kCinMax / 8 + c1p / 8) * kLbo +
         2 * w_planes * (kCinMax > kCoutMax ? kCinMax : kCoutMax) * c1p * 2;
}

// Cin is padded to kCinMax (8 chunks) and C1 to C1P = 2 N1, so that every
// count of the main loop is a compile-time one
template <typename T, int N1>
__global__ void __launch_bounds__(kThreadsTc, 1)
conv3x3_pair_kernel(const T* __restrict__ x, const float* __restrict__ w1,
                    const float* __restrict__ b1, const float* __restrict__ w2,
                    const float* __restrict__ b2, T* __restrict__ out, int H, int W,
                    int Cin, int C1, int Cout, float ns1, int rows, int vec) {
  constexpr int PA = sizeof(T) == 4 ? 2 : 1;  // A planes: hi and lo, or the bf16 map
  constexpr int PASSES = kPasses<T>;
  static_assert(PASSES <= PA + 1, "the third pass reads the map's lo plane");
  constexpr int C1P = 2 * N1, cin_p = kCinMax, nch = cin_p / 8;
  constexpr int pw = PASSES > 1 ? 2 : 1;  // weight planes
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int win_plane = nch * kLbo, win_slot = PA * win_plane;
  constexpr int mid_plane = C1P / 8 * kLbo, mid_slot = PA * mid_plane;
  constexpr int plane_b = (cin_p > kCoutMax ? cin_p : kCoutMax) * C1P * 2;
  constexpr int stage_b = pw * plane_b;
  unsigned char* win = smem;
  unsigned char* mid = win + 3 * win_slot;
  unsigned char* wst = mid + 3 * mid_slot;

  // roles and indices from values the compiler knows to be warp-uniform:
  // ptxas serialises wgmma on a path that branches on the thread's index
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int g = warp >> 2, wl = warp & 3;  // warpgroup, its warp
  const int x0 = blockIdx.x * kSeg, b = blockIdx.z, y0 = blockIdx.y * rows;
  const int last = min(rows, H - y0);  // steps j = -1 .. last: intermediate row y0 + j
  const int nst = 18 + 18 * last;       // stages
  const T* xb = x + (size_t)b * H * W * Cin;

  float pre[kStageItems][8];  // the next stage's weights, loaded a stage ahead
  auto load_q = [&](int q) {
    const Stage st = stage_at(q);
    if (st.conv == 1) load_stage(pre, w1, Cin, C1, cin_p, C1P, st.tap);
    else load_stage(pre, w2, C1, Cout, C1P, kCoutMax, st.tap);
  };
  auto store_q = [&](int q, int into) {
    const bool one = stage_at(q).conv == 1;
    store_stage(wst + into * stage_b, plane_b, pw > 1, pre, one ? cin_p : C1P,
                one ? C1P : kCoutMax);
  };

  // the intermediate rows' two spare pixels, read only by outputs past the
  // segment: zero, once
  for (int i = tid; i < 3 * PA * (C1P / 8) * 2; i += kThreadsTc)
    *reinterpret_cast<uint4*>(mid + (i / 2) * kLbo + (kM + i % 2) * kChunk) =
        make_uint4(0, 0, 0, 0);
  RowItems<T> row;
  for (int r = y0 - 2; r <= y0; ++r) {
    load_row(row, xb, H, W, Cin, nch, r, x0, vec);
    store_row(win + slot_of(r) * win_slot, win_plane, row, nch);
  }
  load_q(0);
  store_q(0, 0);
  load_q(1);
  sm90::fence_proxy_async();
  __syncthreads();

  const uint32_t win_s = sm90::smem_u32(win), mid_s = sm90::smem_u32(mid);
  const uint32_t wst_s = sm90::smem_u32(wst);
  float acc[N1 / 2] = {};  // conv1's sums, and conv2's in the first kN2 / 2
  for (int q = 0; q < nst; ++q) {
    const Stage st = stage_at(q);
    const int m = y0 + st.j;  // conv1: intermediate row m; conv2: output row m - 1
    const uint32_t bt = wst_s + (q & 1) * stage_b;
    sm90::wgmma_fence();
    if (st.conv == 1)  // window rows m - 1 .. m + 1
      mma_tap<N1, cin_p / 16, PASSES>(
          acc, win_s + slot_of(m - 1 + st.tap / 3) * win_slot + st.tap % 3 * kChunk,
          win_plane, bt + g * N1 * kChunk, plane_b, C1P * kChunk, st.tap);
    else  // intermediate rows m - 2 .. m
      mma_tap<kN2, C1P / 16, PASSES>(
          acc, mid_s + slot_of(m - 2 + st.tap / 3) * mid_slot + st.tap % 3 * kChunk,
          mid_plane, bt + g * kN2 * kChunk, plane_b, kCoutMax * kChunk, st.tap);
    sm90::wgmma_commit();
    // while the wgmma run: the next stage's weights into the other buffer
    // (read by the stage before, drained), the loads of the one after;
    // window row m + 2 for the next step, loaded at conv1's tap 2 and
    // stored at tap 3 into the slot of row m - 1, which taps 0-2 read
    if (q + 1 < nst) store_q(q + 1, (q + 1) & 1);
    if (q + 2 < nst) load_q(q + 2);
    if (st.conv == 1 && st.j < last) {
      if (st.tap == 2) load_row(row, xb, H, W, Cin, nch, m + 2, x0, vec);
      if (st.tap == 3) store_row(win + slot_of(m + 2) * win_slot, win_plane, row, nch);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_operand(acc);
    if (st.tap == 8 && st.conv == 1) {
      // bias, leaky relu, zero outside the frame, into the slot of row m
      unsigned char* dst = mid + slot_of(m) * mid_slot;
      const bool row_in = m >= 0 && m < H;
#pragma unroll
      for (int jn = 0; jn < N1 / 8; ++jn)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // d[4 jn + 2 h + e]: pixel 16 wl + lane / 4 + 8 h, channel
          // g N1 + 8 jn + 2 (lane % 4) + e
          const int px = 16 * wl + (lane >> 2) + 8 * h;
          const int n = g * N1 + 8 * jn + 2 * (lane & 3);
          const int xx = x0 - 1 + px;
          const bool in = row_in && xx >= 0 && xx < W;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float bias = b1 != nullptr && n + e < C1 ? __ldg(b1 + n + e) : 0.f;
            v[e] = in && n + e < C1 ? leaky(acc[4 * jn + 2 * h + e] + bias, ns1) : 0.f;
          }
          const __nv_bfloat162 hb = __floats2bfloat162_rn(v[0], v[1]);
          unsigned char* p = dst + (n / 8) * kLbo + px * kChunk + (n % 8) * 2;
          *reinterpret_cast<__nv_bfloat162*>(p) = hb;
          if constexpr (PA == 2) {
            const float2 hf = __bfloat1622float2(hb);
            *reinterpret_cast<__nv_bfloat162*>(p + mid_plane) =
                __floats2bfloat162_rn(v[0] - hf.x, v[1] - hf.y);
          }
        }
    } else if (st.tap == 8) {
      // bias, into output row m - 1 (the segment's 62 pixels in the frame)
      T* orow = out + ((size_t)b * H + m - 1) * W * Cout;
#pragma unroll
      for (int jn = 0; jn < kN2 / 8; ++jn)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int px = 16 * wl + (lane >> 2) + 8 * h;
          const int n = g * kN2 + 8 * jn + 2 * (lane & 3);
          const int xx = x0 + px;
          if (px >= kSeg || xx >= W) continue;
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (n + e < Cout)
              orow[(size_t)xx * Cout + n + e] = from_f32<T>(
                  acc[4 * jn + 2 * h + e] + (b2 != nullptr ? __ldg(b2 + n + e) : 0.f));
        }
    }
    sm90::fence_proxy_async();
    __syncthreads();
  }
}

// A block takes as many output rows as fill the card once.
template <typename T, int N1>
int launch_pair(const void* x, const float* w1, const float* b1, const float* w2,
                const float* b2, void* out, int B, int H, int W, int Cin, int C1,
                int Cout, float ns1, cudaStream_t stream) {
  constexpr auto kernel = &conv3x3_pair_kernel<T, N1>;
  constexpr int smem = pair_smem(sizeof(T) == 4 ? 2 : 1, 2 * N1, kPasses<T> > 1 ? 2 : 1);
  cudaError_t err = allow_smem<kernel>(smem);
  if (err != cudaSuccess) return (int)err;
  const int strips = (W + kSeg - 1) / kSeg;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int per_col = sms / (strips * B) > 1 ? sms / (strips * B) : 1;
  const int rows = (H + per_col - 1) / per_col;
  const int vec = (Cin * (int)sizeof(T)) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0;
  dim3 grid(strips, (H + rows - 1) / rows, B);
  kernel<<<grid, kThreadsTc, smem, stream>>>(
      static_cast<const T*>(x), w1, b1, w2, b2, static_cast<T*>(out), H, W, Cin, C1,
      Cout, ns1, rows, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int pair_dispatch(const void* x, const float* w1, const float* b1, const float* w2,
                  const float* b2, void* out, int B, int H, int W, int Cin, int C1,
                  int Cout, float ns1, cudaStream_t s) {
  if (C1 <= 64)
    return launch_pair<T, 32>(x, w1, b1, w2, b2, out, B, H, W, Cin, C1, Cout, ns1, s);
  return launch_pair<T, 64>(x, w1, b1, w2, b2, out, B, H, W, Cin, C1, Cout, ns1, s);
}

}  // namespace pair

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
// out are bf16 when bf16 is set, float otherwise.  Cin <= 64, C1 <= 128,
// Cout <= 64 (SCNet's pairs are 64->128->64 and 64->64->64).
extern "C" int fcvsr_conv3x3_pair(const void* x, const float* w1, const float* b1,
                                  const float* w2, const float* b2, void* out, int B,
                                  int H, int W, int Cin, int C1, int Cout, float ns1,
                                  int bf16, void* stream) {
  using namespace fcvsr;
  if (B < 1 || H < 1 || W < 1 || Cin < 1 || C1 < 1 || Cout < 1 ||
      Cin > pair::kCinMax || C1 > pair::kC1Max || Cout > pair::kCoutMax)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return pair::pair_dispatch<__nv_bfloat16>(x, w1, b1, w2, b2, out, B, H, W, Cin, C1,
                                              Cout, ns1, s);
  return pair::pair_dispatch<float>(x, w1, b1, w2, b2, out, B, H, W, Cin, C1, Cout, ns1,
                                    s);
}
