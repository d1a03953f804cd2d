// Adjoint of one exact IAC iteration (csrc/iac.cu) without its residual and
// activation, on NHWC float32 tensors (K5).  For
//
//   z = SAC_k1,k1(warped),   warped = warp_bilinear_zeros(src, flow)
//
// and the cotangent gz = dL/dz it computes dk (the iteration's tap-major 3C
// block of the kernel tensor), dflow and dsrc.  The chain walk around it
// (ops/fused_iac.py) applies the activation mask and adds the residual's
// adjoint.
//
// Replaces the TPU kernel fcvsr_tpu/ops/pallas_iac.py::_bwd_kernel, reached
// there through _rows_bwd_call and iac_fused_vjp, which returns dk, dflow
// and dsrc's window from one pallas_call.  That kernel is the adjoint of
// the TPU forward's radius-2 window; this one is the exact adjoint of the
// port's exact forward: zero-padded bilinear corners at any displacement,
// the coordinate clamp to [-1.5, W+0.5] x [-1.5, H+0.5] (zero dflow where
// it is active), no gradient through floor, and SAC's replicate border,
// where ring rows and columns are warped at clamped pixels, each with its
// own kernel.  Kernel1 applies in both passes, at columns k_off + t*C + c.
//
// Bound on the H100: bytes.  The function reads src, flow, the 3C kernel
// block and gz and writes dk, dflow and dsrc, about 9C floats a pixel, with
// some 50 flops a value: 228 MB at FCVSR's training shape (6 x 128 x 128 x
// 64), 0.068 ms at 3.35 TB/s; its 0.3 GFLOP take about 5 us of the f32
// pipes, so the tensor cores have nothing to take here.
//
// One launch.  A block owns an 8x16 pixel tile and a 16-channel chunk of
// C (the grid's x is tile column x chunk, the chunk fastest: 3-4% faster
// than the chunk slowest, PERF.md §6).  The adjoint at a pixel reaches gz one
// row and one column away through the neighbours' kernels, so the block
// works on the tile with a one-pixel ring (10x18), in shared memory:
//
//  0. the bilinear corners of every ring pixel's warp (at its clamped
//     pixel, as the forward warps there), once a pixel: the corners'
//     pixels (-1 outside the frame), the fractions and the clamp's flags;
//  1. the gather, a thread a quad (a pixel and 4 channels): the 4 corners
//     as 16-byte loads (scalars where C is not a multiple of 4), warped,
//     and for the tile's own pixels d(warped)/dx and /dy kept in
//     registers; gz (zero outside the frame) and the 3 kernels of the quad
//     staged beside them;
//  2. the vertical pass v at the tile's rows (ring columns too) and its
//     output's adjoint dv at the tile's columns (ring rows too);
//  3. at the tile's own pixels, a thread a quad: dk (the horizontal and
//     vertical terms, stored: each (pixel, channel) has one owner), then
//     dwarped, which never leaves the registers: dsrc += dwarped times each
//     corner's weight by 16-byte float atomics into the zeroed dsrc (a
//     scatter at any displacement has no transposed gather), and dflow =
//     sum over channels of dwarped . d(warped)/d(x, y), summed over a
//     pixel's 4 quads by shuffles and stored where one chunk holds C, else
//     added by 2 float atomics a pixel into the zeroed dflow.
//
// What held the two-launch kernel this replaces (PERF.md §6, from
// benchmarks/iac_ab.py --bwd --takeouts): its first launch's per-element
// work, a bilinear point and 4 scalar corner loads for every (ring pixel,
// channel), about 75% of its time; its second launch (a re-gather and the
// scalar atomics) 18%, of which the atomics 2-5%; the dk stores 8%.  So the
// points are computed once a pixel and the corners read once a quad.  In
// this kernel (the same script): the kernels' loads take 26% of its time,
// the dk stores 13-16%, the warp's adjoint 7-9%, dsrc's float4 atomics
// 3-4%, dflow's 2 atomics a pixel and chunk under 1%, so dflow takes
// atomics rather than a cluster's shared-memory sum.  Tiles of 16x16 or
// 8x32 (one block an SM) ran 30% slower, 8-channel chunks no faster.
//
// Order of the sums: dsrc takes the contributions of every pixel whose warp
// lands near it, and dflow those of C / 16 chunks, by atomics in an order
// that changes from run to run, so both are reproducible only to f32
// rounding of those sums (the tests' 1e-5 bar).
#include "common.cuh"

namespace fcvsr {
namespace {
namespace k5 {

constexpr int TH = 8;    // tile rows
constexpr int TW = 16;   // tile columns
constexpr int CC = 16;   // channels a block
constexpr int NQ = CC / 4;                // quads a pixel
constexpr int HR = TH + 2, HC = TW + 2;   // the tile with its one-pixel ring
constexpr int RING = HR * HC;
constexpr int kTileItems = TH * TW * NQ / kThreads;  // a thread's tile quads
constexpr int kEdge = RING - TH * TW;                // the ring's own pixels
static_assert(TH * TW * NQ % kThreads == 0 && kEdge * NQ <= kThreads && RING <= kThreads,
              "the gather's items fill the block");

// the warp of a ring pixel: its corners' pixels in the flattened (B, H, W)
// grid (-1 outside the frame), the fractions, and whether the clamp leaves
// x (bit 0) and y (bit 1) free
struct Pt {
  int px[4];
  float fx, fy;
  int free;
  int pad;
};

// shared memory in floats: [RING][CC] warped, [RING][3][CC] kernels,
// [RING][CC] gz, [TH][HC][CC] v, [HR][TW][CC] dv, then the points
constexpr int kW = 0, kK = kW + RING * CC, kG = kK + RING * 3 * CC;
constexpr int kV = kG + RING * CC, kDv = kV + TH * HC * CC, kPt = kDv + HR * TW * CC;
constexpr size_t kSmem = sizeof(float) * kPt + sizeof(Pt) * RING;

__device__ __forceinline__ float4 operator*(float a, float4 v) {
  return make_float4(a * v.x, a * v.y, a * v.z, a * v.w);
}
__device__ __forceinline__ float4 operator+(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float4 operator-(float4 a, float4 b) {
  return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
}
__device__ __forceinline__ float4 operator*(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}
__device__ __forceinline__ float dot(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// channels c .. c + 3 at p, n of them valid (zeros past); vec: C a multiple
// of 4 and the map 16-byte aligned, so a quad is in or out whole
__device__ __forceinline__ float4 load4(const float* p, int n, bool vec) {
  if (vec) return n > 0 ? __ldg(reinterpret_cast<const float4*>(p)) : make_float4(0.f, 0.f, 0.f, 0.f);
  return make_float4(n > 0 ? __ldg(p) : 0.f, n > 1 ? __ldg(p + 1) : 0.f,
                     n > 2 ? __ldg(p + 2) : 0.f, n > 3 ? __ldg(p + 3) : 0.f);
}

__device__ __forceinline__ void store4(float* p, float4 v, int n, bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = v;
    return;
  }
  if (n > 0) p[0] = v.x;
  if (n > 1) p[1] = v.y;
  if (n > 2) p[2] = v.z;
  if (n > 3) p[3] = v.w;
}

__device__ __forceinline__ void add4(float* p, float4 v, int n, bool vec) {
  if (vec) {
    atomicAdd(reinterpret_cast<float4*>(p), v);
    return;
  }
  if (n > 0) atomicAdd(p, v.x);
  if (n > 1) atomicAdd(p + 1, v.y);
  if (n > 2) atomicAdd(p + 2, v.z);
  if (n > 3) atomicAdd(p + 3, v.w);
}

// a corner's weight: 0 outside the frame
__device__ __forceinline__ float weight(const Pt& q, int i) {
  return q.px[i] < 0 ? 0.f : (i / 2 ? q.fy : 1.f - q.fy) * (i % 2 ? q.fx : 1.f - q.fx);
}

// ring pixel p of the tile at (y0, x0): (row, column) in the ring
__device__ __forceinline__ int ring_of_tile(int p) { return (1 + p / TW) * HC + 1 + p % TW; }
__device__ __forceinline__ int ring_of_edge(int p) {
  if (p < HC) return p;                          // row 0
  if (p < 2 * HC) return (HR - 1) * HC + p - HC;  // row HR - 1
  const int k = p - 2 * HC;                       // columns 0 and HC - 1
  return (1 + k / 2) * HC + (k % 2) * (HC - 1);
}

__global__ void __launch_bounds__(kThreads, 2)
iac_bwd_kernel(const float* __restrict__ src, const float* __restrict__ flow,
               const float* __restrict__ k, int k_ld, int k_off,
               const float* __restrict__ gz, float* __restrict__ dk,
               float* __restrict__ dsrc, float* __restrict__ dflow, int H, int W, int C,
               int vec) {
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem + kW;
  float* k_s = smem + kK;
  float* g_s = smem + kG;
  float* v_s = smem + kV;
  float* dv_s = smem + kDv;
  Pt* pt_s = reinterpret_cast<Pt*>(smem + kPt);

  const int tid = threadIdx.x;
  const int nchunk = (C + CC - 1) / CC;
  const int chunk = blockIdx.x % nchunk, b = blockIdx.z;
  const int x0 = blockIdx.x / nchunk * TW, y0 = blockIdx.y * TH;
  const int ch0 = chunk * CC;
  const int pix0 = b * H * W;  // first pixel of this image

  // 0. the ring's points: ring row r, column j is image pixel (y0-1+r,
  //    x0-1+j), warped at its clamped pixel, as in the forward
  if (tid < RING) {
    const int yy = clampi(y0 - 1 + tid / HC, 0, H - 1);
    const int xx = clampi(x0 - 1 + tid % HC, 0, W - 1);
    const float* fl = flow + (size_t)(pix0 + yy * W + xx) * 2;
    const float rx = (float)xx + __ldg(fl), ry = (float)yy + __ldg(fl + 1);
    const Bilinear q = bilinear_point(rx, ry, H, W);
    Pt pt;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int cy = q.iy + i / 2, cx = q.ix + i % 2;
      pt.px[i] = in_frame(cy, cx, H, W) ? pix0 + cy * W + cx : -1;
    }
    pt.fx = q.fx;
    pt.fy = q.fy;
    pt.free = (rx >= -1.5f && rx <= (float)W + 0.5f) | (ry >= -1.5f && ry <= (float)H + 0.5f) << 1;
    pt.pad = 0;
    pt_s[tid] = pt;
  }
  __syncthreads();

  // 1. the gather, a quad an item: the tile's own pixels first, whose
  //    d(warped)/dx and /dy stay in registers, then the ring's edge
  float4 ddx[kTileItems], ddy[kTileItems];
  auto gather = [&](int rp, int q, float4& dx, float4& dy) {
    const int y = y0 - 1 + rp / HC, x = x0 - 1 + rp % HC;
    const int yy = clampi(y, 0, H - 1), xx = clampi(x, 0, W - 1);
    const int pix = pix0 + yy * W + xx;
    const int c = ch0 + 4 * q, n = C - c;
    const Pt pt = pt_s[rp];
    float4 s[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      s[i] = pt.px[i] >= 0 ? load4(src + (size_t)pt.px[i] * C + c, n, vec)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    const float fx = pt.fx, fy = pt.fy, gx = 1.f - fx, gy = 1.f - fy;
    const float4 wv = weight(pt, 0) * s[0] + weight(pt, 1) * s[1] +
                      weight(pt, 2) * s[2] + weight(pt, 3) * s[3];
    dx = gy * (s[1] - s[0]) + fy * (s[3] - s[2]);
    dy = gx * (s[2] - s[0]) + fx * (s[3] - s[1]);
    const float4 gv = y == yy && x == xx ? load4(gz + (size_t)pix * C + c, n, vec)
                                         : make_float4(0.f, 0.f, 0.f, 0.f);
    const float* kp = k + (size_t)pix * k_ld + k_off + c;
    float4* ks = reinterpret_cast<float4*>(k_s) + rp * 3 * NQ + q;
#pragma unroll
    for (int t = 0; t < 3; ++t) ks[t * NQ] = load4(kp + t * C, n, vec);
    reinterpret_cast<float4*>(w_s)[rp * NQ + q] = wv;
    reinterpret_cast<float4*>(g_s)[rp * NQ + q] = gv;
  };
#pragma unroll
  for (int i = 0; i < kTileItems; ++i) {
    const int it = tid + i * kThreads;
    gather(ring_of_tile(it / NQ), it % NQ, ddx[i], ddy[i]);
  }
  if (tid < kEdge * NQ) {
    float4 dx, dy;
    gather(ring_of_edge(tid / NQ), tid % NQ, dx, dy);
  }
  __syncthreads();

  const float4* w4 = reinterpret_cast<const float4*>(w_s);
  const float4* k4 = reinterpret_cast<const float4*>(k_s);
  const float4* g4 = reinterpret_cast<const float4*>(g_s);
  // 2. the vertical pass at the tile's rows, ring columns included
  for (int e = tid; e < TH * HC * NQ; e += kThreads) {
    const int q = e % NQ, p = e / NQ;
    const int r = p / HC, j = p % HC;
    const float4* kk = k4 + ((r + 1) * HC + j) * 3 * NQ + q;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int t = 0; t < 3; ++t) s = s + w4[((r + t) * HC + j) * NQ + q] * kk[t * NQ];
    reinterpret_cast<float4*>(v_s)[e] = s;
  }
  //    dv at the tile's columns, ring rows included: the horizontal taps of
  //    columns x-1 .. x+1 that land on x (clamped at the frame's edges)
  for (int e = tid; e < HR * TW * NQ; e += kThreads) {
    const int q = e % NQ, p = e / NQ;
    const int r = p / TW, j = p % TW;
    const int xt = x0 + j;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const int x = xt - 1 + d;
      const float4 g = g4[(r * HC + j + d) * NQ + q];
      const float4* kk = k4 + (r * HC + j + d) * 3 * NQ + q;
#pragma unroll
      for (int t = 0; t < 3; ++t)
        if (clampi(x - 1 + t, 0, W - 1) == xt) s = s + kk[t * NQ] * g;
    }
    reinterpret_cast<float4*>(dv_s)[e] = s;
  }
  __syncthreads();

  // 3. the tile's own pixels: dk, dwarped, then the warp's adjoint
  const float4* v4 = reinterpret_cast<const float4*>(v_s);
  const float4* dv4 = reinterpret_cast<const float4*>(dv_s);
#pragma unroll
  for (int i = 0; i < kTileItems; ++i) {
    const int it = tid + i * kThreads;
    const int q = it % NQ, p = it / NQ;
    const int r = p / TW, j = p % TW;
    const int y = y0 + r, x = x0 + j;
    const int c = ch0 + 4 * q, n = C - c;
    const bool mine = y < H && x < W && n > 0;
    float ax = 0.f, ay = 0.f;
    if (mine) {
      const int pix = pix0 + y * W + x;
      const int rp = (r + 1) * HC + j + 1;
      const float4 g = g4[rp * NQ + q];
      const float4 dvc = dv4[((r + 1) * TW + j) * NQ + q];
      float* dkp = dk + (size_t)pix * k_ld + k_off + c;
#pragma unroll
      for (int t = 0; t < 3; ++t)
        store4(dkp + t * C,
               g * v4[(r * HC + j + t) * NQ + q] + dvc * w4[((r + t) * HC + j + 1) * NQ + q],
               n, vec);
      // the vertical taps of rows y-1 .. y+1 that land on y
      float4 dw = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const int ys = y - 1 + d;
        const float4 dvs = dv4[((r + d) * TW + j) * NQ + q];
        const float4* kk = k4 + ((r + d) * HC + j + 1) * 3 * NQ + q;
#pragma unroll
        for (int t = 0; t < 3; ++t)
          if (clampi(ys - 1 + t, 0, H - 1) == y) dw = dw + kk[t * NQ] * dvs;
      }
      ax = dot(dw, ddx[i]);
      ay = dot(dw, ddy[i]);
      const Pt pt = pt_s[rp];
#pragma unroll
      for (int m = 0; m < 4; ++m)
        if (pt.px[m] >= 0) add4(dsrc + (size_t)pt.px[m] * C + c, weight(pt, m) * dw, n, vec);
    }
    // dflow: the pixel's 4 quads are 4 neighbouring lanes
#pragma unroll
    for (int o = 1; o < NQ; o *= 2) {
      ax += __shfl_xor_sync(0xffffffffu, ax, o);
      ay += __shfl_xor_sync(0xffffffffu, ay, o);
    }
    if (q == 0 && y < H && x < W) {
      const int free = pt_s[(r + 1) * HC + j + 1].free;
      float* df = dflow + (size_t)(pix0 + y * W + x) * 2;
      // the clamp passes the gradient only where it is inactive
      ax = free & 1 ? ax : 0.f;
      ay = free & 2 ? ay : 0.f;
      if (nchunk == 1) {
        df[0] = ax;
        df[1] = ay;
      } else {
        atomicAdd(df, ax);
        atomicAdd(df + 1, ay);
      }
    }
  }
}

}  // namespace k5
}  // namespace
}  // namespace fcvsr

// k: (B,H,W,k_ld) with the iteration's block at [k_off, k_off+3C); dk: the
// same layout, only that block written; src, gz, dsrc: (B,H,W,C), dsrc
// zeroed by the caller; flow, dflow: (B,H,W,2), dflow zeroed by the caller
// when C > 16 (the chunks add into it).  B*H*W below 2^31.
extern "C" int fcvsr_iac_bwd(const float* src, const float* flow, const float* k,
                             int k_ld, int k_off, const float* gz, float* dk, float* dsrc,
                             float* dflow, int B, int H, int W, int C, void* stream) {
  using namespace fcvsr::k5;
  if (B < 1 || H < 1 || W < 1 || C < 1 || (long long)B * H * W >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const auto a16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec = C % 4 == 0 && k_ld % 4 == 0 && k_off % 4 == 0 && a16(src) && a16(k) &&
                  a16(gz) && a16(dk) && a16(dsrc);
  const int nchunk = (C + CC - 1) / CC;
  // a tile's channel chunks side by side in the grid, so that they read
  // and write the same pixels' rows close together in time
  dim3 grid((W + TW - 1) / TW * nchunk, (H + TH - 1) / TH, B);
  cudaError_t err = fcvsr::allow_smem<&iac_bwd_kernel>(kSmem);
  if (err != cudaSuccess) return (int)err;
  iac_bwd_kernel<<<grid, fcvsr::kThreads, kSmem, (cudaStream_t)stream>>>(
      src, flow, k, k_ld, k_off, gz, dk, dsrc, dflow, H, W, C, vec);
  return (int)cudaGetLastError();
}
