// The tensor-core conv helpers that the conv pair (K2) and the single conv
// (K3) of csrc/conv3x3.cu and the BlockRCB quad (K6, csrc/conv3x3_quad.cu)
// share: the wgmma main loop's tap (mma_tap), the window rows' loads and
// stores in the no-swizzle K-major layout, the weight stages, and K2's
// whole row loop over one (segment, row block) work item (pair_rows).
// conv3x3.cu's note says why the loop is shaped so; K6 runs pair_rows
// twice, over y in between, in one persistent cooperative launch.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace fcvsr {
namespace {
namespace tc {

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

// A map's load: through L1 (__ldg), or with CG through L2 only (__ldcg), for
// a map that other blocks of the same launch wrote (L1 is not coherent
// across SMs)
template <bool CG, typename V>
__device__ __forceinline__ V ld(const V* p) {
  if constexpr (CG) return __ldcg(p);
  else return __ldg(p);
}

// 8 channels [c0, c0 + 8) of one pixel (zeros past Cin and where !in)
template <bool CG>
__device__ __forceinline__ void load8(float (&v)[8], const float* p, int left, bool in,
                                      int vec) {
  if (in && vec) {  // Cin a multiple of 4: each 16-byte half is in or out whole
    const float4* q = reinterpret_cast<const float4*>(p);
    const float4 a = left > 0 ? ld<CG>(q) : float4{};
    const float4 b = left > 4 ? ld<CG>(q + 1) : float4{};
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = in && e < left ? ld<CG>(p + e) : 0.f;
}

template <bool CG>
__device__ __forceinline__ void load8(uint4& v, const __nv_bfloat16* p, int left, bool in,
                                      int vec) {
  if (in && vec) {  // Cin a multiple of 8
    v = left > 0 ? ld<CG>(reinterpret_cast<const uint4*>(p)) : make_uint4(0, 0, 0, 0);
    return;
  }
  uint32_t h[4];
  const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t a = in && 2 * i < left ? ld<CG>(q + 2 * i) : 0u;
    const uint32_t b = in && 2 * i + 1 < left ? ld<CG>(q + 2 * i + 1) : 0u;
    h[i] = a | (b << 16);
  }
  v = make_uint4(h[0], h[1], h[2], h[3]);
}

// A window row of RP pixels as the thread's items: 8 channels of a pixel
// each (float, or the bf16 map's 16 bytes)
template <typename T, int RP = kRowPx>
struct RowItems {
  static constexpr int kPx = RP;
  static constexpr int kItems = (RP * kCinMax / 8 + kThreadsTc - 1) / kThreadsTc;
  using Raw = typename std::conditional<sizeof(T) == 4, float[8], uint4>::type;
  Raw raw[kItems];
};

// Window row y of image xb (pixels xs, xs + 1, ..., RP of them): loads
// only, zeros outside the frame and past Cin; item it = (pixel it / nch,
// chunk it % nch); CG reads through L2 only
template <bool CG = false, typename T, int RP>
__device__ __forceinline__ void load_row(RowItems<T, RP>& r, const T* xb, int H, int W,
                                         int Cin, int nch, int y, int xs, int vec) {
  const int items = RP * nch;
  const bool row_in = y >= 0 && y < H;
#pragma unroll
  for (int i = 0; i < RowItems<T, RP>::kItems; ++i) {
    const int it = threadIdx.x + i * kThreadsTc;
    const int c = it % nch, xx = xs + it / nch;
    const bool in = it < items && row_in && xx >= 0 && xx < W;
    load8<CG>(r.raw[i], xb + ((size_t)(in ? y : 0) * W + (in ? xx : 0)) * Cin + c * 8,
              Cin - c * 8, in, vec);
  }
}

// ... into its slot: chunk c of pixel px at c * RP * 16 + px * 16, float
// maps split into the hi plane and the lo plane plane_b bytes on
template <typename T, int RP>
__device__ __forceinline__ void store_row(unsigned char* slot, int plane_b,
                                          const RowItems<T, RP>& r, int nch) {
  const int items = RP * nch;
#pragma unroll
  for (int i = 0; i < RowItems<T, RP>::kItems; ++i) {
    const int it = threadIdx.x + i * kThreadsTc;
    if (it < items) {
      unsigned char* p = slot + (it % nch) * (RP * kChunk) + (it / nch) * kChunk;
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
// its hi plane, the lo plane a_plane bytes on, 8-channel chunks LBO bytes
// apart) times this warpgroup's N
// rows of the stage at `bt` (B: 16 bytes a row, chunks ldb bytes apart,
// the lo plane plane_b bytes on), in KSTEPS k16 steps of PASSES products
// each: hi*hi, hi*lo_w, lo*hi_w; tap 0's first product clears the sums.
// Both counts are compile-time: with run-time counts the kernel took 1.2x
// as long (PERF.md §6).
template <int N, int KSTEPS, int PASSES, int LBO = kLbo, int R>
__device__ __forceinline__ void mma_tap(float (&acc)[R], uint32_t at, int a_plane,
                                        uint32_t bt, int plane_b, int ldb, int tap) {
#pragma unroll
  for (int s = 0; s < KSTEPS; ++s)
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const uint64_t da =
          sm90::desc_interleave(at + (p == 2 ? a_plane : 0) + 2 * s * LBO, LBO, kSbo);
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

// the slot of `row` among n slots that turn over
__host__ __device__ constexpr int slot_n(int row, int n) { return ((row % n) + n) % n; }

// shared memory of a pair: 3 window rows, 3 intermediate rows, 2 stages
constexpr int pair_smem(int a_planes, int c1p, int w_planes) {
  return 3 * a_planes * (kCinMax / 8 + c1p / 8) * kLbo +
         2 * w_planes * (kCinMax > kCoutMax ? kCinMax : kCoutMax) * c1p * 2;
}

// ... for maps of T at N1 (C1 padded to 2 N1), PASSES products a k step
template <typename T, int N1, int PASSES = kPasses<T>>
constexpr int pair_smem() {
  return pair_smem(sizeof(T) == 4 ? 2 : 1, 2 * N1, PASSES > 1 ? 2 : 1);
}

// K2's partition of a map: segments of kSeg pixels, and as many blocks of
// rows as fill the card's `sms` once; the rows a block takes
inline int pair_rows_per_block(int B, int H, int W, int sms) {
  const int strips = (W + kSeg - 1) / kSeg;
  const int per_col = sms / (strips * B) > 1 ? sms / (strips * B) : 1;
  return (H + per_col - 1) / per_col;
}

// One work item of K2: out = conv2(lrelu_ns1(conv1(x) + b1)) + b2 at the
// segment of output pixels x0 .. x0 + kSeg - 1 (cut at W) and output rows
// y0 .. y0 + rows - 1 (cut at H) of image b.  Cin is padded to kCinMax (8
// chunks) and C1 to C1P = 2 N1, so that every count of the main loop is a
// compile-time one.  CG reads x through L2 only.  PASSES is the bf16
// products a k step (kPasses<T>: K2's routes; 1 for bf16 maps whose weights
// are rounded to bf16, as K11 takes them).  Every thread of the block calls
// it; it ends with a barrier, so the next call may reuse `smem`.
template <typename T, int N1, bool CG, int PASSES = kPasses<T>>
__device__ __forceinline__ void pair_rows(unsigned char* smem, const T* __restrict__ x,
                                          const float* __restrict__ w1,
                                          const float* __restrict__ b1,
                                          const float* __restrict__ w2,
                                          const float* __restrict__ b2,
                                          T* __restrict__ out, int H, int W, int Cin,
                                          int C1, int Cout, float ns1, int rows, int vec,
                                          int x0, int y0, int b) {
  constexpr int PA = sizeof(T) == 4 ? 2 : 1;  // A planes: hi and lo, or the bf16 map
  static_assert(PASSES <= PA + 1, "the third pass reads the map's lo plane");
  constexpr int C1P = 2 * N1, cin_p = kCinMax, nch = cin_p / 8;
  constexpr int pw = PASSES > 1 ? 2 : 1;  // weight planes
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
    load_row<CG>(row, xb, H, W, Cin, nch, r, x0 - 2, vec);
    store_row(win + slot_n(r, 3) * win_slot, win_plane, row, nch);
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
          acc, win_s + slot_n(m - 1 + st.tap / 3, 3) * win_slot + st.tap % 3 * kChunk,
          win_plane, bt + g * N1 * kChunk, plane_b, C1P * kChunk, st.tap);
    else  // intermediate rows m - 2 .. m
      mma_tap<kN2, C1P / 16, PASSES>(
          acc, mid_s + slot_n(m - 2 + st.tap / 3, 3) * mid_slot + st.tap % 3 * kChunk,
          mid_plane, bt + g * kN2 * kChunk, plane_b, kCoutMax * kChunk, st.tap);
    sm90::wgmma_commit();
    // while the wgmma run: the next stage's weights into the other buffer
    // (read by the stage before, drained), the loads of the one after;
    // window row m + 2 for the next step, loaded at conv1's tap 2 and
    // stored at tap 3 into the slot of row m - 1, which taps 0-2 read
    if (q + 1 < nst) store_q(q + 1, (q + 1) & 1);
    if (q + 2 < nst) load_q(q + 2);
    if (st.conv == 1 && st.j < last) {
      if (st.tap == 2) load_row<CG>(row, xb, H, W, Cin, nch, m + 2, x0 - 2, vec);
      if (st.tap == 3) store_row(win + slot_n(m + 2, 3) * win_slot, win_plane, row, nch);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_operand(acc);
    if (st.tap == 8 && st.conv == 1) {
      // bias, leaky relu, zero outside the frame, into the slot of row m
      unsigned char* dst = mid + slot_n(m, 3) * mid_slot;
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

// Every work item of a phase, in turn over the blocks of a persistent grid:
// item i is segment i % strips, row block (i / strips) % rblocks, image
// i / (strips rblocks), as K2's grid (x, y, z) orders them.
template <typename T, int N1, bool CG, int PASSES = kPasses<T>>
__device__ __forceinline__ void pair_phase(unsigned char* smem, const T* x,
                                           const float* w1, const float* b1,
                                           const float* w2, const float* b2, T* out,
                                           int B, int H, int W, int Cin, int C1,
                                           int Cout, float ns, int rows, int vec) {
  const int strips = (W + kSeg - 1) / kSeg, rblocks = (H + rows - 1) / rows;
  const int items = strips * rblocks * B;
  for (int i = blockIdx.x; i < items; i += gridDim.x)
    pair_rows<T, N1, CG, PASSES>(smem, x, w1, b1, w2, b2, out, H, W, Cin, C1, Cout, ns,
                                 rows, vec, i % strips * kSeg,
                                 (i / strips) % rblocks * rows, i / (strips * rblocks));
}

// The plan of a persistent cooperative launch of `kernel` (kThreadsTc
// threads, `smem` bytes) over K2's work items of a (B, H, W) map: the rows
// a block takes (K2's partition) and the grid, as many blocks as the card
// holds co-resident (the occupancy query times the SM count) and never
// more than the items.  An error where the card takes no cooperative
// launch or not one block of the kernel: such a grid is refused, never
// split.
template <typename K>
cudaError_t persistent_plan(K kernel, int smem, int B, int H, int W, int* grid,
                            int* rows) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) !=
      cudaSuccess)
    return err;
  if (!coop) return cudaErrorNotSupported;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreadsTc, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *rows = pair_rows_per_block(B, H, W, sms);
  const long long items = (long long)((W + kSeg - 1) / kSeg) * ((H + *rows - 1) / *rows) * B;
  const long long fill = (long long)per_sm * sms;
  *grid = (int)(items < fill ? items : fill);
  return cudaSuccess;
}

}  // namespace tc
}  // namespace
}  // namespace fcvsr
