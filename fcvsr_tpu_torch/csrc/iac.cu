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
// The design.  K1's earlier tile body, iac_tile.cuh, is what the resident
// chain K4 still runs: 8x16 pixels x 16 channels a block, every value
// loaded element by element, the flow and the corners recomputed for each
// of the 4 channel chunks, the kf prediction a scalar dot product per
// (pixel, tap, channel) on the float32 pipes (1.753 ms at bf16 B 2,
// PERF.md §6).  This one:
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
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace fcvsr {
namespace {
namespace k1 {

constexpr int TH = 8;          // output rows a tile
constexpr int MP = 16;         // columns a row's passes compute: the mma's M
constexpr int TW = MP - 2;     // output columns a tile
constexpr int WR = TH + 2;     // warped rows
constexpr int kWarps = kThreads / 32;
constexpr int kC0Max = 64;     // the prediction's K
// k steps of the prediction at C0 64: 8 of m16n8k8 (TF32, float32 f0), 4
// of m16n8k16 (bf16 f0)
template <typename T>
constexpr int kSteps = sizeof(T) == 4 ? kC0Max / 8 : kC0Max / 16;
constexpr int kCMax = 128;

// floats a warped pixel takes: C rounded up to 8, then to 8 mod 32 words,
// so that the 8 pixels of a fragment's float2 reads fall in distinct banks
__host__ __device__ constexpr int warp_stride(int C) {
  return ((C + 7) / 8 * 8 + 23) / 32 * 32 + 8;
}
__host__ __device__ constexpr int c0_pad(int c0) { return (c0 + 15) / 16 * 16; }
// values a staged f0 pixel takes: C0 padded to 16, plus 4 words, so that
// the 8 pixels of a fragment's 32-bit reads fall in distinct banks
template <typename T>
__host__ __device__ constexpr int f0_stride(int c0) {
  return c0_pad(c0) + 16 / (int)sizeof(T);
}

// the four bilinear corners of a warped pixel: pixel offsets in the image
// and weights, 0 for a corner outside the frame
struct Corners {
  int off[4];
  float wt[4];
};

template <typename T>
size_t smem_bytes(bool kf, int C, int c0) {
  size_t n = (size_t)WR * MP * (warp_stride(C) * sizeof(float) + sizeof(Corners));
  if (kf) n += (size_t)TH * MP * f0_stride<T>(c0) * sizeof(T);
  return n;
}

// 8 channels of a pixel as floats (zeros past `left`); vec: C * sizeof(T)
// a multiple of 16 bytes, so each 16-byte load is in or out whole
__device__ __forceinline__ void load8(float (&v)[8], const float* p, int left, bool vec) {
  if (vec) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = left > 4 ? __ldg(reinterpret_cast<const float4*>(p) + 1)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = e < left ? __ldg(p + e) : 0.f;
}

__device__ __forceinline__ void load8(float (&v)[8], const __nv_bfloat16* p, int left,
                                      bool vec) {
  if (vec) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = e < left ? to_f32(p[e]) : 0.f;
}

// two neighbouring channels (n of them valid, 0-2) as the storage holds
// them (float2, or bf16x2 in one register): one 8-byte (bf16 4-byte) load
// when `pairs` (C even, the pointers aligned), else one a value.  Widened
// only where they are used, so that no instruction waits on a load issued
// a row ahead before then.
template <typename T>
using Raw2 = typename std::conditional<sizeof(T) == 4, float2, __nv_bfloat162>::type;

template <typename T>
__device__ __forceinline__ Raw2<T> load2(const T* p, int n, bool pairs) {
  if (pairs && n == 2) return __ldg(reinterpret_cast<const Raw2<T>*>(p));
  const T zero = from_f32<T>(0.f);
  Raw2<T> v;
  v.x = n > 0 ? p[0] : zero;
  v.y = n > 1 ? p[1] : zero;
  return v;
}

__device__ __forceinline__ float2 widen(float2 v) { return v; }
__device__ __forceinline__ float2 widen(__nv_bfloat162 v) { return __bfloat1622float2(v); }

template <typename T>
__device__ __forceinline__ void store2(T* p, const float (&v)[2], int n, bool pairs) {
  if (pairs && n == 2) {
    if constexpr (sizeof(T) == 4)
      *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
    else
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
    return;
  }
  if (n > 0) p[0] = from_f32<T>(v[0]);
  if (n > 1) p[1] = from_f32<T>(v[1]);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; `bytes` 0 writes
// zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// v as TF32 parts: hi (its rounding) and lo (the rounding of what is left)
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(v));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(v - __uint_as_float(hi)));
}

// d += A (16 x K, row-major fragment a) x B (K x 8, column fragment b),
// float32 sums: K 16 of bf16 (m16n8k16) for a bf16 T, 8 of TF32
// (m16n8k8) for a float T
template <typename T>
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  if constexpr (sizeof(T) == 4)
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One tile: image b, output rows y0 .. y0 + TH - 1, columns x0 .. x0 + TW - 1.
// k: materialised kernels (B,H,W,k_ld), this iteration's tap-major block at
// columns [k_off, k_off + 3C); with KF, wpl holds Wsel's planes (2, k_ld,
// c0_pad(c0)), TF32 in float32 words for a float T, bf16 for a bf16 T, and
// the kernels are f0 . Wsel + bsel at the same columns.
template <typename T, bool KF>
__global__ void __launch_bounds__(kThreads, KF ? (sizeof(T) == 4 ? 1 : 2) : 3)
iac_kernel(const T* __restrict__ feat, const float* __restrict__ flow,
           const T* __restrict__ k, const void* __restrict__ wpl, int k_ld,
           int k_off, const T* __restrict__ f0, const float* __restrict__ bsel, int c0,
           const T* __restrict__ feat_in, T* __restrict__ out, int H, int W, int C,
           int act, int vec, int f0vec, int pairs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int CP = warp_stride(C);
  float* warp_s = reinterpret_cast<float*>(smem);                  // [WR][MP][CP]
  Corners* corners = reinterpret_cast<Corners*>(warp_s + WR * MP * CP);  // [WR * MP]
  T* f0_s = reinterpret_cast<T*>(corners + WR * MP);                // KF: [TH][MP][F0S]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int b = blockIdx.z, y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const size_t pix0 = (size_t)b * H * W;  // first pixel of this image
  const T* featb = feat + pix0 * C;
  const int ncb = (C + 7) / 8;

  // this thread's kernels at row r: pixels (y0 + r, x0 - 1 + g + 8 h),
  // clamped (SAC's replicate border), channels 8 cb + 2 q + e, taps t
  auto load_k = [&](Raw2<T> (&kr)[3][2], int r, int cb) {
    const int yk = min(y0 + r, H - 1), ch = cb * 8 + 2 * q;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int xk = clampi(x0 - 1 + g + 8 * h, 0, W - 1);
      const T* kp = k + (pix0 + (size_t)yk * W + xk) * k_ld + k_off + ch;
#pragma unroll
      for (int t = 0; t < 3; ++t) kr[t][h] = load2(kp + t * C, C - ch, pairs);
    }
  };

  // 0. KF: f0's tile, asynchronously; materialised: the first row's kernels
  Raw2<T> kn[3][2];
  if constexpr (KF) {
    constexpr int kPer = 16 / sizeof(T);  // values a 16-byte copy
    const int F0S = f0_stride<T>(c0), per = c0_pad(c0) / kPer;
    for (int e = tid; e < TH * MP * per; e += kThreads) {
      const int ck = e % per, p = e / per;
      const int yy = min(y0 + p / MP, H - 1), xx = clampi(x0 - 1 + p % MP, 0, W - 1);
      const T* src = f0 + (pix0 + (size_t)yy * W + xx) * c0 + ck * kPer;
      T* dst = f0_s + p * F0S + ck * kPer;
      if (f0vec) {
        cp_async16(dst, ck * kPer < c0 ? src : f0, ck * kPer < c0 ? 16 : 0);
      } else {
#pragma unroll
        for (int i = 0; i < kPer; ++i) dst[i] = ck * kPer + i < c0 ? src[i] : from_f32<T>(0.f);
      }
    }
  } else {
    if (warp < ncb) load_k(kn, 0, warp);
  }

  // 1. the corners of the WR x MP warped pixels: rows clamp(y0 - 1 ..),
  //    columns clamp(x0 - 1 ..), SAC's replicate border
  for (int p = tid; p < WR * MP; p += kThreads) {
    const int yy = clampi(y0 - 1 + p / MP, 0, H - 1);
    const int xx = clampi(x0 - 1 + p % MP, 0, W - 1);
    const float* fl = flow + (pix0 + (size_t)yy * W + xx) * 2;
    const Bilinear bp = bilinear_point((float)xx + fl[0], (float)yy + fl[1], H, W);
    Corners c;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int yi = bp.iy + i / 2, xi = bp.ix + i % 2;
      const bool in = in_frame(yi, xi, H, W);
      const float wy = i / 2 ? bp.fy : 1.f - bp.fy, wx = i % 2 ? bp.fx : 1.f - bp.fx;
      c.off[i] = in ? yi * W + xi : 0;
      c.wt[i] = in ? wy * wx : 0.f;
    }
    corners[p] = c;
  }
  __syncthreads();

  // 2. the warped tile, 8 channels an item
  const int ngrp = (C + 7) / 8;
#pragma unroll 2
  for (int e = tid; e < WR * MP * ngrp; e += kThreads) {
    const int grp = e % ngrp, p = e / ngrp;
    const Corners c = corners[p];
    float a[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      load8(a[i], featb + (size_t)c.off[i] * C + grp * 8, C - grp * 8, vec);
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float s = a[0][j] * c.wt[0];
      s += a[1][j] * c.wt[1];
      s += a[2][j] * c.wt[2];
      s += a[3][j] * c.wt[3];
      v[j] = s;
    }
    float4* d = reinterpret_cast<float4*>(warp_s + p * CP + grp * 8);
    d[0] = make_float4(v[0], v[1], v[2], v[3]);
    d[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
  if constexpr (KF) cp_async_wait_all();
  __syncthreads();

  // 3. the passes, a warp per 8-channel block, a row at a time
  // the prediction's k steps, and the 32-bit words of a plane's column
  constexpr int KS = kSteps<T>;
  const int F0S = f0_stride<T>(c0), ks = c0_pad(c0) / (sizeof(T) == 4 ? 8 : 16);
  const int wpc = c0_pad(c0) * sizeof(T) / 4;
  for (int cb = warp; cb < ncb; cb += kWarps) {
    const int ch = cb * 8 + 2 * q, nv = min(2, C - ch);  // this thread's channels
    uint32_t bh[3][KS][2], bl[3][KS][2];  // KF: Wsel's fragments
    float bias[3][2];
    if constexpr (KF) {
      const size_t lo = (size_t)k_ld * wpc;  // the lo plane, in words
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        // b0, b1 of k step s: column n = g of the n-tile, rows (k) from
        // s K + 2 q (bf16 pairs) or s K + q (TF32), and 8 (4) rows on:
        // word 8 s + q + 4 i of the column in both layouts
        const bool in = cb * 8 + g < C;
        const uint32_t* col = reinterpret_cast<const uint32_t*>(wpl) +
                              (size_t)(k_off + t * C + (in ? cb * 8 + g : 0)) * wpc + q;
#pragma unroll
        for (int s = 0; s < KS; ++s)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const bool use = in && s < ks;
            bh[t][s][i] = use ? __ldg(col + 8 * s + 4 * i) : 0u;
            bl[t][s][i] = use ? __ldg(col + lo + 8 * s + 4 * i) : 0u;
          }
#pragma unroll
        for (int e = 0; e < 2; ++e)
          bias[t][e] = e < nv ? __ldg(bsel + k_off + t * C + ch + e) : 0.f;
      }
    } else if (cb != warp) {
      load_k(kn, 0, cb);
    }
    for (int r = 0; r < TH; ++r) {
      const int y = y0 + r;
      if (y >= H) break;
      float kk[3][2][2];  // [tap][pixel g, g + 8][channel]
      if constexpr (KF) {
        float acc[3][4];
#pragma unroll
        for (int t = 0; t < 3; ++t)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[t][i] = bias[t][i & 1];
        const T* fr = f0_s + (r * MP + g) * F0S;
#pragma unroll
        for (int s = 0; s < KS; ++s) {
          if (s >= ks) break;
          uint32_t ah[4], al[4];
          if constexpr (sizeof(T) == 4) {
            // a0: pixel g, c0 8 s + q; a1: pixel g + 8; a2, a3: c0 + 4
            const float* f = fr + 8 * s + q;
            split_tf32(f[0], ah[0], al[0]);
            split_tf32(f[8 * F0S], ah[1], al[1]);
            split_tf32(f[4], ah[2], al[2]);
            split_tf32(f[8 * F0S + 4], ah[3], al[3]);
          } else {
            // a0: pixel g, c0 16 s + 2 q (+1); a1: pixel g + 8; a2, a3: c0 + 8
            const T* f = fr + 16 * s + 2 * q;
            ah[0] = *reinterpret_cast<const uint32_t*>(f);
            ah[1] = *reinterpret_cast<const uint32_t*>(f + 8 * F0S);
            ah[2] = *reinterpret_cast<const uint32_t*>(f + 8);
            ah[3] = *reinterpret_cast<const uint32_t*>(f + 8 * F0S + 8);
          }
#pragma unroll
          for (int t = 0; t < 3; ++t) {
            mma<T>(acc[t], ah, bh[t][s]);
            mma<T>(acc[t], ah, bl[t][s]);
            if constexpr (sizeof(T) == 4) mma<T>(acc[t], al, bh[t][s]);
          }
        }
        // c0, c1: pixel g, channels ch, ch + 1; c2, c3: pixel g + 8
#pragma unroll
        for (int t = 0; t < 3; ++t)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            kk[t][0][e] = acc[t][e];
            kk[t][1][e] = acc[t][2 + e];
          }
      } else {
#pragma unroll
        for (int t = 0; t < 3; ++t)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 v = widen(kn[t][h]);
            kk[t][h][0] = v.x, kk[t][h][1] = v.y;
          }
        if (r + 1 < TH && y + 1 < H) load_k(kn, r + 1, cb);  // a row ahead
      }
      // the residual at this row's outputs: columns p = g (p >= 1) and
      // g + 8 (p <= 14), x = x0 - 1 + p
      float2 fin[2];
      const size_t orow = pix0 + (size_t)y * W;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int x = x0 - 1 + g + 8 * h;
        const bool o = (h == 0 ? g >= 1 : g <= 6) && x < W;
        const T* fp = feat_in + (orow + (o ? x : 0)) * C + ch;
        fin[h] = widen(load2(fp, o ? nv : 0, pairs));
      }
      // vertical pass: v(y, p) = sum_t warped(y - 1 + t, p) k(y, p)[t]
      float v[2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* wp = warp_s + (r * MP + g + 8 * h) * CP + ch;
        float s[2] = {0.f, 0.f};
#pragma unroll
        for (int t = 0; t < 3; ++t) {
          const float2 wv = *reinterpret_cast<const float2*>(wp + t * MP * CP);
          s[0] += wv.x * kk[t][h][0];
          s[1] += wv.y * kk[t][h][1];
        }
        v[h][0] = s[0], v[h][1] = s[1];
      }
      // horizontal pass: out(y, p) = sum_t v(y, p - 1 + t) k(y, p)[t], the
      // neighbouring columns from the lanes 4 on and 4 back (column 8 is
      // pixel g + 8 of the lane with g = 0, column 7 pixel g of g = 7)
      float o[2][2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float nx0 = __shfl_sync(0xffffffffu, v[0][e], (lane + 4) & 31);
        const float nx1 = __shfl_sync(0xffffffffu, v[1][e], (lane + 4) & 31);
        const float pv0 = __shfl_sync(0xffffffffu, v[0][e], (lane + 28) & 31);
        const float pv1 = __shfl_sync(0xffffffffu, v[1][e], (lane + 28) & 31);
        const float l[2] = {pv0, g > 0 ? pv1 : pv0};
        const float rt[2] = {g < 7 ? nx0 : nx1, nx1};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float s = 0.f;
          s += l[h] * kk[0][h][e];
          s += v[h][e] * kk[1][h][e];
          s += rt[h] * kk[2][h][e];
          s += e ? fin[h].y : fin[h].x;
          o[h][e] = act ? leaky(s, 0.1f) : s;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int x = x0 - 1 + g + 8 * h;
        if ((h == 0 ? g >= 1 : g <= 6) && x < W)
          store2(out + (orow + x) * C + ch, o[h], nv, pairs);
      }
    }
  }
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
