// Adjoint of the deformable convolution of csrc/dcn.cu (DCNv2, or DCNv1
// without a mask), 3x3, stride 1, padding 1, dilation 1, groups 1, any
// number of deform groups, on NHWC float32 tensors, on the tensor cores.
//
// For the forward
//   out[p,o] = bias[o] + sum over taps k and input channels c of
//              W[k,c,o] * m[p,d(c),k] * s[p,k,c],
//   s[p,k,c] = x~(p + tap_k + off[p,d(c),k])   (bilinear, zero outside)
// and the cotangent g = dL/dout it computes, with u = sum_o g[p,o] W[k,c,o]
// and v = m u:
//   dmask[p,d,k]     = sum over c in d of s u
//   doffset[p,d,k,.] = sum over c in d of v ds/d(py, px)
//   dx               = v times each corner's bilinear weight, scattered to
//                      the four corners of every sample
//   dW[k,c,o]        = sum_p m s g[p,o],   dbias = sum_p g.
// It is the exact adjoint of the exact forward: the sample point is clamped
// to [-1.5, W+0.5] x [-1.5, H+0.5] as in the forward, where every corner
// lies outside the frame, so ds/dpoint is 0 there without a case of its
// own; corners outside the frame read 0 and receive nothing; floor passes
// no gradient, so at an integer position ds/dpy = x(y0+1) - x(y0).
//
// fcvsr_dcn3x3_bwd (K8) replaces fcvsr_tpu/ops/pallas_dcn.py::_bwd_kernel
// (reached there through _bwd_call and modulated_deform_conv2d_fused_vjp).
// That kernel is the adjoint of the TPU forward, which samples one window
// per row tile and clamps each offset's deviation to 2 px; this one has no
// window and no radius.
//
// One launch.  A block owns one tap, one 64-channel chunk of Cin (dcn.cuh)
// and a range of 64-pixel tiles of the flattened (B, H, W) grid, walked in
// turn; the blocks of the 9 taps of a range run side by side (the tap is
// blockIdx.x), so the tiles of g and x they share are read from L2.  Once
// a block: the tap's W^T slice (Cout x 64) split into bf16 hi and lo planes
// in shared memory.  For each tile:
//   1. g's tile (64 pixels x Cout) split into planes [8-channel chunk]
//      [pixel][8], the tap-0 blocks summing it for dbias;
//   2. u = g W^T on wgmma (M 64 pixels, N 32 channels a warpgroup, K Cout,
//      bf16x3), stored float32 into shared memory;
//   3. dcn.cuh's sampler, one quad (pixel, 4 channels) a item, samples the
//      four corners once: from them and u come s (m s goes into a planes
//      tile, cols), the quad's shares of dmask and doffset, and dx, added
//      to the four corners by float4 atomics (sm_90), a quarter of one a
//      value;
//   4. dmask and doffset: a segmented shuffle sum over the quads of each
//      group, stored by its first lane where the block owns the (pixel,
//      group, tap), which it does when no group crosses a 64-channel chunk
//      and the corners are read as float4 runs (the zoo's layouts);
//      otherwise added by atomics into zeroed buffers (the wrapper knows
//      which: ops/fused_dcn.py::offsets_written_whole);
//   5. dW[tap] += cols^T g on wgmma (M the chunk's 64 channels, N half of
//      Cout a warpgroup, K the tile's 64 pixels), both operands the tiles
//      of steps 1 and 3 read MN-major, the sums kept in registers across
//      the block's tiles and added to the zeroed dW once at the end, with
//      dbias.
// Each value is sampled once and g read once a tap.  Shared memory, Cout
// padded to 64 (128): W^T 16 KB (32), g 16.3 KB (32.5), u 17 KB, cols
// 16.3 KB: 67,072 (100,096) bytes, two blocks an SM.
//
// Bound on the H100: bytes.  x, the offsets, the mask, the weights and g
// read once, the five gradients written once: 719 MB at EDVR-M's level 1
// (5 x 180 x 320, 64 -> 64, 8 groups), 0.215 ms at 3.35 TB/s; its two
// contractions' 42 GFLOP take 0.043 ms at the bf16 tensor cores' rate.
// What holds it is the gather and the scatter: 9 taps x 4 corners of
// every input value read through L1 and L2 (with the offsets' and the
// mask's sectors, as in csrc/dcn.cu), and added back by atomics.  Taken
// out one at a time at EDVR-M's level 1 (benchmarks/dcn_ab.py --bwd,
// PERF.md §6): the points' loads 25% of the time, the corners' loads 16%,
// the dx atomics 16-17%, g's loads 7%, doffset and dmask 6-8%, each wgmma
// 2-3%; the rest is the four barriers a tile.  Three blocks an SM (80
// registers, spilling) did not help.
//
// Order of the sums: dx takes up to 9 x 4 atomic contributions a value, dW
// and dbias one a block, in an order that changes from run to run, so the
// results are reproducible only to f32 rounding of those sums.
#include "dcn.cuh"

namespace fcvsr {
namespace {
namespace dcn {

constexpr int kTileB = 64;                      // pixels a tile
constexpr int kLbo = chunk_stride<kTileB>();    // a tile's chunks apart
constexpr int kLdu = kCk + 4;                   // floats a row of u's tile
constexpr int kNu = kCk / 2;                    // u's N a warpgroup
constexpr int kItemsB = kTileB * kQuads / kThreadsD;

// shared memory of a block, Cout padded to COUTP
template <int COUTP>
struct BwdSmem {
  static constexpr int kOc = COUTP / 8;                  // g's 8-channel chunks
  static constexpr int kPlaneW = kOc * kCk * kRow;       // W^T: [o chunk][c][8 o]
  static constexpr int kPlaneG = kOc * kLbo;             // g: [o chunk][pixel][8 o]
  static constexpr int kPlaneC = (kCk / 8) * kLbo;       // cols: [c chunk][pixel][8 c]
  static constexpr int kW = 0, kG = kW + 2 * kPlaneW, kU = kG + 2 * kPlaneG;
  static constexpr int kC = kU + kTileB * kLdu * 4;
  static constexpr int kBytes = kC + 2 * kPlaneC;
  static constexpr int kGItems = kTileB * kOc / kThreadsD;
};

// one channel's share: its cols value m s (returned), and s u, v ds/dpy, v
// ds/dpx added to dm, dpy, dpx
__device__ __forceinline__ float adjoint_one(const Point& p, float v0, float v1, float v2,
                                             float v3, float u, float& dm, float& dpy,
                                             float& dpx) {
  const float fy = p.fy, fx = p.fx, gy = 1.f - fy, gx = 1.f - fx;
  const float s = gy * (gx * v0 + fx * v1) + fy * (gx * v2 + fx * v3);
  const float vv = p.m * u;
  dm += s * u;
  dpy += vv * (gx * (v2 - v0) + fx * (v3 - v1));
  dpx += vv * (gy * (v1 - v0) + fy * (v3 - v2));
  return p.m * s;
}

// v (4 channels) times each corner's weight, added to dx at the corners
__device__ __forceinline__ void scatter_quad(float* __restrict__ dx, const Point& p,
                                             int Cin, int c, float4 v) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (p.px[q] >= 0)
      atomicAdd(reinterpret_cast<float4*>(dx + (size_t)p.px[q] * Cin + c),
                make_float4(v.x * p.wt[q], v.y * p.wt[q], v.z * p.wt[q], v.w * p.wt[q]));
}

// (pixel n, group grp, tap)'s dmask and doffset: stored, or added where the
// buffers were zeroed for sums in parts
__device__ __forceinline__ void store_offsets(float* __restrict__ doffset,
                                              float* __restrict__ dmask, int n, int grp,
                                              int tap, int dg, float dm, float dpy,
                                              float dpx, int zeroed) {
  const size_t og = (size_t)n * dg + grp;
  float* o = doffset + og * 18 + 2 * tap;
  if (zeroed) {
    atomicAdd(o, dpy);
    atomicAdd(o + 1, dpx);
    if (dmask != nullptr) atomicAdd(dmask + og * 9 + tap, dm);
  } else {
    o[0] = dpy;
    o[1] = dpx;
    if (dmask != nullptr) dmask[og * 9 + tap] = dm;
  }
}

template <int COUTP>
__global__ void __launch_bounds__(kThreadsD, 2)
dcn_bwd_kernel(const float* __restrict__ x, const float* __restrict__ offset,
               const float* __restrict__ mask, const float* __restrict__ w,
               const float* __restrict__ g, float* __restrict__ dx,
               float* __restrict__ doffset, float* __restrict__ dmask,
               float* __restrict__ dw, float* __restrict__ dbias, int N, int H, int W,
               int Cin, int Cout, int dg, int per_range, int vec, int vec_g,
               int zeroed) {
  using L = BwdSmem<COUTP>;
  constexpr int kNw = COUTP / 2;  // dW's N a warpgroup
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* wt_s = smem + L::kW;
  unsigned char* g_s = smem + L::kG;
  float* u_s = reinterpret_cast<float*>(smem + L::kU);
  unsigned char* cols_s = smem + L::kC;
  const int tid = threadIdx.x, lane = tid & 31;
  // warp-uniform roles (see csrc/dcn.cu)
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int wg = warp >> 2, wl = warp & 3;
  const int tap = blockIdx.x, c0 = blockIdx.y * kCk;
  const int ntiles = (N + kTileB - 1) / kTileB;
  const int t0 = blockIdx.z * per_range, t1 = min(ntiles, t0 + per_range);
  const int cg = Cin / dg;
  const bool bias_sum = dbias != nullptr && tap == 0 && blockIdx.y == 0;

  // W^T of the tap and chunk, once: item (channel c, 8 output channels)
  for (int it = tid; it < kCk * L::kOc; it += kThreadsD) {
    const int c = it % kCk, oc = it / kCk;
    const float* p = w + ((size_t)tap * Cin + c0 + c) * Cout + oc * 8;
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = c0 + c < Cin && oc * 8 + e < Cout ? __ldg(p + e) : 0.f;
    uint4 hi, lo;
    tc::split8(v, hi, lo);
    unsigned char* d = wt_s + oc * kCk * kRow + c * kRow;
    *reinterpret_cast<uint4*>(d) = hi;
    *reinterpret_cast<uint4*>(d + L::kPlaneW) = lo;
  }

  float accw[kNw / 2];  // dW[tap][c0 + row][o], this warpgroup's half of N
#pragma unroll
  for (int i = 0; i < kNw / 2; ++i) accw[i] = 0.f;
  float bacc[8] = {};  // dbias of output channels 8 (tid % kOc) ..

  for (int t = t0; t < t1; ++t) {
    const int n0 = t * kTileB;
    // 1. g's tile: item (pixel, 8 output channels)
#pragma unroll
    for (int i = 0; i < L::kGItems; ++i) {
      const int it = tid + i * kThreadsD;
      const int p = it / L::kOc, oc = it % L::kOc, n = n0 + p;
      float v[8];
      tc::load8<false>(v, g + (size_t)(n < N ? n : 0) * Cout + oc * 8, Cout - oc * 8,
                       n < N, vec_g);
      if (bias_sum)
#pragma unroll
        for (int e = 0; e < 8; ++e) bacc[e] += v[e];
      uint4 hi, lo;
      tc::split8(v, hi, lo);
      unsigned char* d = g_s + oc * kLbo + p * kRow;
      *reinterpret_cast<uint4*>(d) = hi;
      *reinterpret_cast<uint4*>(d + L::kPlaneG) = lo;
    }
    sm90::fence_proxy_async();
    __syncthreads();

    // 2. u = g W^T (A: g K-major, B: W^T K-major, N the warpgroup's 32
    // channels), into u_s [pixel][channel]
    float accu[kNu / 2];
#pragma unroll
    for (int i = 0; i < kNu / 2; ++i) accu[i] = 0.f;
    sm90::wgmma_fence();
    mma_bf16x3<kNu, COUTP / 16, 0, 0>(
        accu, sm90::smem_u32(g_s), L::kPlaneG, kLbo, 8 * kRow, 2 * kLbo,
        sm90::smem_u32(wt_s) + wg * kNu * kRow, L::kPlaneW, kCk * kRow, 8 * kRow,
        2 * kCk * kRow);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_operand(accu);
#pragma unroll
    for (int j = 0; j < kNu / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = 16 * wl + (lane >> 2) + 8 * h, c = wg * kNu + 8 * j + 2 * (lane & 3);
        *reinterpret_cast<float2*>(u_s + p * kLdu + c) =
            make_float2(accu[4 * j + 2 * h], accu[4 * j + 2 * h + 1]);
      }
    __syncthreads();

    // 3-4. the samples, dmask, doffset, dx and cols: item (pixel p, quad
    // cq); the lanes of a half warp are one pixel's 16 quads
#pragma unroll 2
    for (int i = 0; i < kItemsB; ++i) {
      const int it = tid + i * kThreadsD;
      const int p = it / kQuads, qd = it % kQuads, cq = 4 * qd;
      const int n = n0 + p, c = c0 + cq;
      const bool live = n < N && c < Cin;
      const float4 u = *reinterpret_cast<const float4*>(u_s + p * kLdu + cq);
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      if (vec) {
        const int grp = live ? c / cg : 0;
        float dm = 0.f, dpy = 0.f, dpx = 0.f;
        if (live) {
          const Point pt = sample_point(offset, mask, n, grp, tap, dg, H, W);
          float4 v[4];
          load_quad(v, x, pt, Cin, c);
          s.x = adjoint_one(pt, v[0].x, v[1].x, v[2].x, v[3].x, u.x, dm, dpy, dpx);
          s.y = adjoint_one(pt, v[0].y, v[1].y, v[2].y, v[3].y, u.y, dm, dpy, dpx);
          s.z = adjoint_one(pt, v[0].z, v[1].z, v[2].z, v[3].z, u.z, dm, dpy, dpx);
          s.w = adjoint_one(pt, v[0].w, v[1].w, v[2].w, v[3].w, u.w, dm, dpy, dpx);
          const float4 vv = make_float4(pt.m * u.x, pt.m * u.y, pt.m * u.z, pt.m * u.w);
          scatter_quad(dx, pt, Cin, c, vv);
        }
        // the group's quads in this chunk are lanes [first, seg_end) of the
        // half warp: after the step of `off`, a lane holds the sum over
        // [qd, min(qd + 2 off, seg_end))
        const int first = max(grp * cg, c0) - c0;
        const int seg_end = live ? (min(min((grp + 1) * cg, c0 + kCk), Cin) - c0) / 4 : 0;
#pragma unroll
        for (int off = 1; off < kQuads; off *= 2) {
          const float a = __shfl_down_sync(0xffffffffu, dm, off);
          const float b = __shfl_down_sync(0xffffffffu, dpy, off);
          const float d = __shfl_down_sync(0xffffffffu, dpx, off);
          if (qd + off < seg_end) {
            dm += a;
            dpy += b;
            dpx += d;
          }
        }
        if (live && cq == first)
          store_offsets(doffset, dmask, n, grp, tap, dg, dm, dpy, dpx, zeroed);
      } else {
        // a channel a point, read as scalars; dmask and doffset by atomics
        const float ua[4] = {u.x, u.y, u.z, u.w};
        float r[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!live || c + e >= Cin) continue;
          const int grp = (c + e) / cg;
          const Point pt = sample_point(offset, mask, n, grp, tap, dg, H, W);
          float v[4];
          load_one(v, x, pt, Cin, c + e);
          float dm = 0.f, dpy = 0.f, dpx = 0.f;
          r[e] = adjoint_one(pt, v[0], v[1], v[2], v[3], ua[e], dm, dpy, dpx);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (pt.px[q] >= 0)
              atomicAdd(dx + (size_t)pt.px[q] * Cin + c + e, pt.m * ua[e] * pt.wt[q]);
          store_offsets(doffset, dmask, n, grp, tap, dg, dm, dpy, dpx, zeroed);
        }
        s = make_float4(r[0], r[1], r[2], r[3]);
      }
      store_quad<kTileB>(cols_s, L::kPlaneC, p, cq, s);
    }
    sm90::fence_proxy_async();
    __syncthreads();

    // 5. dW[tap] += cols^T g: A cols MN-major (M the chunk's channels), B g
    // MN-major (N this warpgroup's half of Cout), K the tile's pixels
    sm90::wgmma_fence();
    mma_bf16x3<kNw, kTileB / 16, 1, 1>(
        accw, sm90::smem_u32(cols_s), L::kPlaneC, 8 * kRow, kLbo, 2 * 8 * kRow,
        sm90::smem_u32(g_s) + wg * (kNw / 8) * kLbo, L::kPlaneG, 8 * kRow, kLbo,
        2 * 8 * kRow);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_operand(accw);
    __syncthreads();  // the next tile rewrites g_s, u_s and cols_s
  }

  // dW: d[4 j + e] holds channel c0 + 16 wl + lane / 4 + 8 (e / 2), output
  // channel wg kNw + 8 j + 2 (lane % 4) + e % 2
#pragma unroll
  for (int j = 0; j < kNw / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = c0 + 16 * wl + (lane >> 2) + 8 * (e >> 1);
      const int o = wg * kNw + 8 * j + 2 * (lane & 3) + (e & 1);
      if (c < Cin && o < Cout && t0 < t1)
        atomicAdd(dw + ((size_t)tap * Cin + c) * Cout + o, accw[4 * j + e]);
    }
  if (bias_sum) {
    // the lanes of a warp with one o chunk, then one atomic a value a warp
#pragma unroll
    for (int off = L::kOc; off < 32; off *= 2)
#pragma unroll
      for (int e = 0; e < 8; ++e) bacc[e] += __shfl_xor_sync(0xffffffffu, bacc[e], off);
    if (lane < L::kOc)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (lane * 8 + e < Cout) atomicAdd(dbias + lane * 8 + e, bacc[e]);
  }
}

template <int COUTP>
int launch_bwd(const float* x, const float* offset, const float* mask, const float* w,
               const float* g, float* dx, float* doffset, float* dmask, float* dw,
               float* dbias, int N, int H, int W, int Cin, int Cout, int dg, int vec,
               int vec_g, int zeroed, cudaStream_t stream) {
  constexpr auto kernel = &dcn_bwd_kernel<COUTP>;
  constexpr int smem = BwdSmem<COUTP>::kBytes;
  cudaError_t err = allow_smem<kernel>(smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // ranges of tiles: two blocks an SM over the 9 taps and the chunks
  const int ntiles = (N + kTileB - 1) / kTileB, nck = (Cin + kCk - 1) / kCk;
  const int per_tap = 9 * nck;
  const int ranges = max(1, min(ntiles, (2 * sms + per_tap - 1) / per_tap));
  const int per_range = (ntiles + ranges - 1) / ranges;
  dim3 grid(9, nck, (ntiles + per_range - 1) / per_range);
  kernel<<<grid, kThreadsD, smem, stream>>>(x, offset, mask, w, g, dx, doffset, dmask, dw,
                                             dbias, N, H, W, Cin, Cout, dg, per_range, vec,
                                             vec_g, zeroed);
  return (int)cudaGetLastError();
}

}  // namespace dcn
}  // namespace
}  // namespace fcvsr

// x (B,H,W,Cin), offset (B,H,W,dg*18), mask (B,H,W,dg*9) or null, w
// (3,3,Cin,Cout), g (B,H,W,Cout), all contiguous float32, Cout <= 128; dx,
// dw and dbias (Cout, or null without a bias) zeroed by the caller, dx
// 16-byte aligned; doffset and dmask (null without a mask) zeroed when
// `zeroed` is set, which it must be unless they are written whole: a deform
// group's width a multiple of 4, x 16-byte aligned, no group across a
// 64-channel chunk (ops/fused_dcn.py::offsets_written_whole).
extern "C" int fcvsr_dcn3x3_bwd(const float* x, const float* offset, const float* mask,
                                const float* w, const float* g, float* dx,
                                float* doffset, float* dmask, float* dw, float* dbias,
                                int B, int H, int W, int Cin, int Cout, int dg,
                                int zeroed, void* stream) {
  using namespace fcvsr;
  using namespace fcvsr::dcn;
  if (B < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1 || Cout > 128 || dg <= 0 ||
      Cin % dg != 0 || (mask == nullptr) != (dmask == nullptr) ||
      reinterpret_cast<uintptr_t>(dx) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int cg = Cin / dg;
  const int vec = cg % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  bool whole = vec;
  for (int d = 0; d < dg && whole; ++d)
    whole = d * cg / kCk == ((d + 1) * cg - 1) / kCk;
  if (!zeroed && !whole) return (int)cudaErrorInvalidValue;
  const int vec_g = Cout % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
  const int N = B * H * W;
  cudaStream_t s = (cudaStream_t)stream;
  if (Cout <= 64)
    return launch_bwd<64>(x, offset, mask, w, g, dx, doffset, dmask, dw, dbias, N, H, W,
                          Cin, Cout, dg, vec, vec_g, zeroed, s);
  return launch_bwd<128>(x, offset, mask, w, g, dx, doffset, dmask, dw, dbias, N, H, W,
                         Cin, Cout, dg, vec, vec_g, zeroed, s);
}
