// 3x3 SAME convolutions on NHWC tensors, on the tensor cores.
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
// Both are an implicit GEMM on warpgroup MMA (wgmma, csrc/hopper.cuh):
// M = 64 pixels of one row segment, N = output channels, K = 9 taps x input
// channels.  Each tap is one shifted window: the same stored rows read (dy
// rows, dx pixels) further on.  The operands are in the no-swizzle K-major
// layout, [8-channel chunk][pixel][8 channels], so a tap's dx is a 16-byte
// step of the descriptor's start address and nothing is copied per tap (an
// im2col tile built in shared memory cost 3.7x the window's copy, PERF.md
// §6).
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
// 3xTF32's would take 8.  K3 takes the same route (conv3x3_emulated, held
// to float64 at Cout 64, 3 and 1 in tests/test_torch_conv_tc.py).
//
// K2: the rows roll.  A block owns a segment of 62 output pixels (64
// computed: the last two would need the pixels past the 66 stored) and
// `rows` output rows of one image.  Three slots of window rows and three of
// intermediate rows turn over: each step loads one window row, computes one
// intermediate row (conv1, 9 taps) and one output row from the last three
// (conv2, 9 taps), so a block recomputes 2 intermediate rows, not a halo
// of each tile: at 272x480 a block takes 17 rows (19 conv1 rows).  Shared
// memory, float32 maps (two bf16 planes, C1 128): 3 window rows of 66 x 64
// x 4 bytes (50,688) + 3 intermediate rows of 66 x 128 x 4 (101,376) + 2
// weight stages of 2 planes x 128 x 64 x 2 (65,536) = 217,600 of 232,448
// bytes; bf16 maps 141,568.  An 8-row tile's intermediate alone (10 x 66 x
// 128 x 4 bytes = 338 KB) would not fit.
//
// K2's weights stream through two stages of one tap each (a conv1 tap is
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
// K2's bound: 2 x 19.25 G multiply-adds at 272x480 (64->128->64), 38.5
// GFLOP at the tensor cores' 989 TFLOP/s, 0.039 ms; the route's three bf16
// passes take three times that (0.117 ms).  What holds it is the weights'
// stream: every block splits all of them (147,456 float32 values) for
// every output row.
//
// K3, one conv: the same main loop (mma_tap) with the weights resident.  A
// block owns a segment of 64 output pixels (the stored row holds 66: one
// conv needs no spare pixels) and a Cout tile of 64 channels, the two
// warpgroups splitting N (32 each).  Every tap's weights are split into
// the bf16 planes once a block, before the rows (float32 maps: 9 taps x 64
// x 64 x 2 planes x 2 bytes = 147,456 bytes), so no weight passes through
// the main loop: K2's weight stream, which holds K2, is gone.  Four window
// slots turn over: while a row's 9 taps run (one commit group), the row
// loaded during the step before is stored into the fourth slot, the row
// after it is loaded, and this row's residual is read; then the drain, the
// epilogue (bias, residual, leaky relu, the store) and one barrier a row.
// Shared memory, float32 maps: 4 slots x 2 planes x 66 x 64 x 2 bytes
// (67,584) + 147,456 = 215,040 bytes (bf16 maps 181,248): one block an SM.
//
// K3's narrow case, Cout <= 8 (conv_last0, 64 -> 1 or 3 at the output's
// 1088x1920): a segment of 128 pixels, a warpgroup a 64-pixel half, and N
// the three dy taps' output channels (8 columns each, 8 zero: N 32), so an
// input row is read from shared memory once for its 3 dx taps, not once
// for each of an output row's 9 taps; input row r adds its dy columns to
// the sums of output rows r + 1 - dy, which roll through registers.  With
// N 8 and 9 taps an output row (128-pixel segments, 4 slots), the same
// case took 0.52 ms (PERF.md §6).  Shared memory 91,136 bytes (float32
// maps): two blocks an SM.
//
// K3's bound at 272x480, 64->64 with its residual, float32 maps: bytes,
// x and res read and out written once, 100.3 MB at 3.35 TB/s, 0.030 ms;
// its 4.81 G multiply-adds take 0.010 ms at 989 TFLOP/s.  conv_last0
// (64->1 at 1088x1920): bytes, 543 MB, 0.162 ms.
//
// Storage: the maps (x, res, out, and the pair's intermediate) are float or
// bf16 (T); weights and biases are float.  bf16 maps round where the
// kernels store, as the plain versions do.
#include "conv_tc.cuh"

namespace fcvsr {
namespace {

// ------------------------------------------- K2 and K3: the tensor cores

namespace tc {

// K2: one block a work item of pair_rows (conv_tc.cuh)
template <typename T, int N1>
__global__ void __launch_bounds__(kThreadsTc, 1)
conv3x3_pair_kernel(const T* __restrict__ x, const float* __restrict__ w1,
                    const float* __restrict__ b1, const float* __restrict__ w2,
                    const float* __restrict__ b2, T* __restrict__ out, int H, int W,
                    int Cin, int C1, int Cout, float ns1, int rows, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  pair_rows<T, N1, false>(smem, x, w1, b1, w2, b2, out, H, W, Cin, C1, Cout, ns1, rows,
                          vec, blockIdx.x * kSeg, blockIdx.y * rows, blockIdx.z);
}

// A block takes as many output rows as fill the card once.
template <typename T, int N1>
int launch_pair(const void* x, const float* w1, const float* b1, const float* w2,
                const float* b2, void* out, int B, int H, int W, int Cin, int C1,
                int Cout, float ns1, cudaStream_t stream) {
  constexpr auto kernel = &conv3x3_pair_kernel<T, N1>;
  constexpr int smem = pair_smem<T, N1>();
  cudaError_t err = allow_smem<kernel>(smem);
  if (err != cudaSuccess) return (int)err;
  const int strips = (W + kSeg - 1) / kSeg;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int rows = pair_rows_per_block(B, H, W, sms);
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


// ------------------------------------------------------------------- K3

// K3's shapes.  Wide (Cout > 8): a 64-pixel segment, a Cout tile of 64, the
// warpgroups splitting N (32 each).  Narrow (Cout <= 8, conv_last0): a
// 128-pixel segment, the warpgroups splitting M; N holds the three dy taps
// of the Cout <= 8 channels, 8 columns each (and 8 zero columns: N 32).
constexpr int kWideNB = 64, kWideNW = 32, kWideRP = kM + 2;
constexpr int kNarrowRP = 2 * kM + 2, kNarrowN = 32;

template <typename T>
constexpr int one_smem(bool narrow) {
  return (narrow ? 2 : 4) * (sizeof(T) == 4 ? 2 : 1) * (kCinMax / 8) *
             (narrow ? kNarrowRP : kWideRP) * kChunk +
         (kPasses<T> > 1 ? 2 : 1) * (narrow ? 3 : 9) * (kCinMax / 8) *
             (narrow ? kNarrowN : kWideNB) * kChunk;
}

// Every tap's weights, split into the K-major bf16 planes once a block:
// plane rows n of NB (wide: output channel co0 + n; narrow: dy = n / 8,
// output channel n % 8), chunks kc of 8 input channels, one plane a tap
// (wide: 9 taps; narrow: 3, dx), the lo plane lo_b bytes on.  Three
// items' loads in flight before their stores.
template <bool NARROW, int NB, int TAPS>
__device__ __forceinline__ void fill_weights(unsigned char* wts, int lo_b, bool lo,
                                             const float* __restrict__ w, int Cin,
                                             int Cout, int co0) {
  constexpr int nch = kCinMax / 8, tap_b = nch * NB * kChunk;
  constexpr int kItems = TAPS * nch * NB, kBatch = 3;
  for (int i0 = threadIdx.x; i0 < kItems; i0 += kBatch * kThreadsTc) {
    float v[kBatch][8];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int it = i0 + j * kThreadsTc;
      const int n = it % NB, kc = (it / NB) % nch, t = it / (NB * nch);
      const int tap = NARROW ? (n / 8) * 3 + t : t;   // HWIO tap dy * 3 + dx
      const int co = NARROW ? n % 8 : co0 + n;
      const bool in = it < kItems && co < Cout && (!NARROW || n < 24);
      const float* p = w + ((size_t)tap * Cin + kc * 8) * Cout + co;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[j][e] = in && kc * 8 + e < Cin ? __ldg(p + (size_t)e * Cout) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int it = i0 + j * kThreadsTc;
      if (it < kItems) {
        const int n = it % NB, kc = (it / NB) % nch, t = it / (NB * nch);
        uint4 hi, lw;
        split8(v[j], hi, lw);
        unsigned char* d = wts + t * tap_b + kc * NB * kChunk + n * kChunk;
        *reinterpret_cast<uint4*>(d) = hi;
        if (lo) *reinterpret_cast<uint4*>(d + lo_b) = lw;
      }
    }
  }
}

// act(v + bias + res) of the fragment of d into output row `orow` (its
// first pixel's index): pixel xp + 16 wl + lane / 4 + 8 h, channel n + 8
// jn + 2 (lane % 4) + e, for jn < NJ; rv the residual at the same places
template <typename T, int NJ, int R>
__device__ __forceinline__ void store_fragment(T* __restrict__ out, size_t orow,
                                               const float (&d)[R], const float (&rv)[R],
                                               const float* __restrict__ bias, int xp,
                                               int n, int W, int Cout, int act, float ns) {
  const int lane = threadIdx.x & 31, wl = (threadIdx.x >> 5) & 3;
#pragma unroll
  for (int jn = 0; jn < NJ; ++jn)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int xx = xp + 16 * wl + (lane >> 2) + 8 * h;
      const int c = n + 8 * jn + 2 * (lane & 3);
      if (xx >= W) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (c + e < Cout) {
          float v = d[4 * jn + 2 * h + e] + rv[4 * jn + 2 * h + e];
          if (bias != nullptr) v += __ldg(bias + c + e);
          out[(orow + xx) * Cout + c + e] = from_f32<T>(act ? leaky(v, ns) : v);
        }
    }
}

// ... and the residual's values at those places (zeros where there is none)
template <typename T, int NJ, int R>
__device__ __forceinline__ void load_fragment(float (&rv)[R], const T* __restrict__ res,
                                              size_t orow, int xp, int n, int W, int Cout) {
  const int lane = threadIdx.x & 31, wl = (threadIdx.x >> 5) & 3;
#pragma unroll
  for (int jn = 0; jn < NJ; ++jn)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int xx = xp + 16 * wl + (lane >> 2) + 8 * h;
      const int c = n + 8 * jn + 2 * (lane & 3);
#pragma unroll
      for (int e = 0; e < 2; ++e)
        rv[4 * jn + 2 * h + e] = res != nullptr && xx < W && c + e < Cout
                                     ? to_f32(res[(orow + xx) * Cout + c + e]) : 0.f;
    }
}

// Wide: out = act(conv(x) + bias + res), Cin padded to 64 and the block's
// Cout tile of 64 with zero weights; output rows y0 .. y0 + rows - 1 of one
// image, pixels x0 .. x0 + 63, channels co0 .. co0 + 63.  Four window slots
// turn over: output row m reads rows m - 1 .. m + 1, and row m + 2 goes into
// the fourth while they run.
template <typename T>
__global__ void __launch_bounds__(kThreadsTc, 1)
conv3x3_one_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, const T* __restrict__ res,
                   T* __restrict__ out, int H, int W, int Cin, int Cout, int act,
                   float ns, int rows, int vec) {
  constexpr int PA = sizeof(T) == 4 ? 2 : 1;  // A planes: hi and lo, or the bf16 map
  constexpr int PASSES = kPasses<T>;
  constexpr int NB = kWideNB, NW = kWideNW, RP = kWideRP, nch = kCinMax / 8;
  constexpr int LBO = RP * kChunk, win_plane = nch * LBO, win_slot = PA * win_plane;
  constexpr int tap_b = nch * NB * kChunk, w_plane = 9 * tap_b;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* win = smem;               // 4 slots of window rows
  unsigned char* wts = win + 4 * win_slot;  // 9 taps, 1 or 2 planes

  // warp-uniform roles (see K2)
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int g = warp >> 2;
  const int nco = (Cout + NB - 1) / NB;
  const int b = blockIdx.z / nco, co0 = (blockIdx.z % nco) * NB;
  const int x0 = blockIdx.x * kM, y0 = blockIdx.y * rows;
  const int last = min(rows, H - y0);  // output rows y0 .. y0 + last - 1
  const T* xb = x + (size_t)b * H * W * Cin;

  // window rows y0 - 1 .. y0 + 1 (pixels x0 - 1 ...), loaded with the weights
  RowItems<T, RP> row[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) load_row(row[i], xb, H, W, Cin, nch, y0 - 1 + i, x0 - 1, vec);
  fill_weights<false, NB, 9>(wts, w_plane, PASSES > 1, w, Cin, Cout, co0);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    store_row(win + slot_n(y0 - 1 + i, 4) * win_slot, win_plane, row[i], nch);
  // row y0 + 2 into registers: stored during the first step
  if (last > 1) load_row(row[0], xb, H, W, Cin, nch, y0 + 2, x0 - 1, vec);
  sm90::fence_proxy_async();
  __syncthreads();

  const uint32_t win_s = sm90::smem_u32(win), w_s = sm90::smem_u32(wts);
  const int n0 = co0 + g * NW;  // this warpgroup's N columns
  float acc[NW / 2], rv[NW / 2];
  for (int j = 0; j < last; ++j) {
    const int m = y0 + j;
    sm90::wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
      mma_tap<NW, kCinMax / 16, PASSES, LBO>(
          acc, win_s + slot_n(m - 1 + tap / 3, 4) * win_slot + tap % 3 * kChunk,
          win_plane, w_s + tap * tap_b + g * NW * kChunk, w_plane, NB * kChunk, tap);
    sm90::wgmma_commit();
    // while they run: row m + 2 (loaded during the step before) into the
    // slot of row m - 2, which the step before read last; row m + 3's
    // loads; this row's residual
    if (j + 1 < last) store_row(win + slot_n(m + 2, 4) * win_slot, win_plane, row[0], nch);
    if (j + 2 < last) load_row(row[0], xb, H, W, Cin, nch, m + 3, x0 - 1, vec);
    const size_t orow = ((size_t)b * H + m) * W;
    load_fragment<T, NW / 8>(rv, res, orow, x0, n0, W, Cout);
    sm90::wgmma_wait<0>();
    sm90::fence_operand(acc);
    store_fragment<T, NW / 8>(out, orow, acc, rv, bias, x0, n0, W, Cout, act, ns);
    sm90::fence_proxy_async();
    __syncthreads();
  }
}

// Narrow (Cout <= 8): each input row is multiplied once, by the three dy
// taps at once (N 32: columns 8 dy + co), its three dx taps shifting the
// row; input row r adds its dy columns to output rows r + 1 - dy, whose
// sums roll through registers; output row r - 1 is complete after input
// row r.  Two window slots turn over.  Against one output row's 9 taps of
// N 8, a third of the products' shared-memory reads.
template <typename T>
__global__ void __launch_bounds__(kThreadsTc, 2)
conv3x3_one_narrow_kernel(const T* __restrict__ x, const float* __restrict__ w,
                          const float* __restrict__ bias, const T* __restrict__ res,
                          T* __restrict__ out, int H, int W, int Cin, int Cout,
                          int act, float ns, int rows, int vec) {
  constexpr int PA = sizeof(T) == 4 ? 2 : 1;
  constexpr int PASSES = kPasses<T>;
  constexpr int NB = kNarrowN, RP = kNarrowRP, nch = kCinMax / 8;
  constexpr int LBO = RP * kChunk, win_plane = nch * LBO, win_slot = PA * win_plane;
  constexpr int tap_b = nch * NB * kChunk, w_plane = 3 * tap_b;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* win = smem;               // 2 slots of input rows
  unsigned char* wts = win + 2 * win_slot;  // 3 dx taps, 1 or 2 planes

  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int g = warp >> 2;  // this warpgroup's 64-pixel tile
  const int b = blockIdx.z, x0 = blockIdx.x * 2 * kM, y0 = blockIdx.y * rows;
  const int last = min(rows, H - y0);  // output rows y0 .. y0 + last - 1
  const int steps = last + 2;          // input rows y0 - 1 .. y0 + last
  const T* xb = x + (size_t)b * H * W * Cin;

  RowItems<T, RP> row;
  load_row(row, xb, H, W, Cin, nch, y0 - 1, x0 - 1, vec);
  fill_weights<true, NB, 3>(wts, w_plane, PASSES > 1, w, Cin, Cout, 0);
  store_row(win + slot_n(y0 - 1, 2) * win_slot, win_plane, row, nch);
  load_row(row, xb, H, W, Cin, nch, y0, x0 - 1, vec);  // stored during step 0
  sm90::fence_proxy_async();
  __syncthreads();

  const uint32_t win_s = sm90::smem_u32(win), w_s = sm90::smem_u32(wts);
  const int xp = x0 + g * kM;
  float acc[NB / 2], rv[4];
  float next[4] = {}, cur[4] = {}, prev[4] = {};  // sums of rows r + 1, r, r - 1
  for (int j = 0; j < steps; ++j) {
    const int r = y0 - 1 + j;  // input row
    sm90::wgmma_fence();
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
      mma_tap<NB, kCinMax / 16, PASSES, LBO>(
          acc, win_s + slot_n(r, 2) * win_slot + g * kM * kChunk + dx * kChunk, win_plane,
          w_s + dx * tap_b, w_plane, NB * kChunk, dx);
    sm90::wgmma_commit();
    // while they run: row r + 1 into the other slot (read last by the
    // step before), row r + 2's loads, the residual of output row r - 1
    if (j + 1 < steps) store_row(win + slot_n(r + 1, 2) * win_slot, win_plane, row, nch);
    if (j + 2 < steps) load_row(row, xb, H, W, Cin, nch, r + 2, x0 - 1, vec);
    const bool done = j >= 2;  // output row r - 1 is complete after this row
    const size_t orow = ((size_t)b * H + r - 1) * W;
    if (done) load_fragment<T, 1>(rv, res, orow, xp, 0, W, Cout);
    sm90::wgmma_wait<0>();
    sm90::fence_operand(acc);
    // d[4 dy + i]: dy's columns; output rows r + 1, r, r - 1
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      next[i] += acc[i];
      cur[i] += acc[4 + i];
      prev[i] += acc[8 + i];
    }
    if (done) store_fragment<T, 1>(out, orow, prev, rv, bias, xp, 0, W, Cout, act, ns);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      prev[i] = cur[i];
      cur[i] = next[i];
      next[i] = 0.f;
    }
    sm90::fence_proxy_async();
    __syncthreads();
  }
}

// A block takes as many output rows as fill the card once.
template <typename T>
int launch_one(const void* x, const float* w, const float* bias, const void* res,
               void* out, int B, int H, int W, int Cin, int Cout, int act, float ns,
               cudaStream_t stream) {
  const bool narrow = Cout <= 8;
  constexpr auto wide_k = &conv3x3_one_kernel<T>;
  constexpr auto narrow_k = &conv3x3_one_narrow_kernel<T>;
  const int smem = one_smem<T>(narrow);
  cudaError_t err = narrow ? allow_smem<narrow_k>(smem) : allow_smem<wide_k>(smem);
  if (err != cudaSuccess) return (int)err;
  const int seg = narrow ? 2 * kM : kM;
  const int strips = (W + seg - 1) / seg;
  const int nco = narrow ? 1 : (Cout + kWideNB - 1) / kWideNB;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int fill = narrow ? 2 * sms : sms;  // the narrow kernel's blocks fit 2 an SM
  const int per_col = fill / (strips * B * nco) > 1 ? fill / (strips * B * nco) : 1;
  const int rows = (H + per_col - 1) / per_col;
  const int vec = (Cin * (int)sizeof(T)) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0;
  dim3 grid(strips, (H + rows - 1) / rows, B * nco);
  (narrow ? narrow_k : wide_k)<<<grid, kThreadsTc, smem, stream>>>(
      static_cast<const T*>(x), w, bias, static_cast<const T*>(res),
      static_cast<T*>(out), H, W, Cin, Cout, act, ns, rows, vec);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace
}  // namespace fcvsr

// w: (3,3,Cin,Cout) contiguous; bias (Cout) and res (B,H,W,Cout) may be
// null.  x, res and out are bf16 when bf16 is set, float otherwise.
// Cin <= 64 (SCNet's convs, conv_last0 and the pairs' rebuilt
// intermediates are 64 -> 64, 1, 3 and 128); any Cout.
extern "C" int fcvsr_conv3x3(const void* x, const float* w, const float* bias,
                             const void* res, void* out, int B, int H, int W, int Cin,
                             int Cout, int act, float ns, int bf16, void* stream) {
  using namespace fcvsr;
  if (B < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1 || Cin > tc::kCinMax)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return tc::launch_one<__nv_bfloat16>(x, w, bias, res, out, B, H, W, Cin, Cout, act,
                                         ns, s);
  return tc::launch_one<float>(x, w, bias, res, out, B, H, W, Cin, Cout, act, ns, s);
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
      Cin > tc::kCinMax || C1 > tc::kC1Max || Cout > tc::kCoutMax)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return tc::pair_dispatch<__nv_bfloat16>(x, w1, b1, w2, b2, out, B, H, W, Cin, C1,
                                              Cout, ns1, s);
  return tc::pair_dispatch<float>(x, w1, b1, w2, b2, out, B, H, W, Cin, C1, Cout, ns1,
                                    s);
}
