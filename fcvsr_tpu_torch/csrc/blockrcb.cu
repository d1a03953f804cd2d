// One BlockRCB level in one launch (K11), per image:
//
//   a   = bf16(lrelu_ns(conv(x, Wb0) + bb0))          (ns = ns_body, 0.1)
//   y   = bf16(conv(a, Wb1) + bb1)
//   a'  = bf16(lrelu_0.2(conv(y, Wr0)))
//   r   = bf16(conv(a', Wr1))
//   l_p = sum_c r[p, c] w_mask[c]
//   ctx = sum_p softmax(l)_p r[p, :]                  (over the image's pixels)
//   t   = lrelu_0.2(ctx A0) A1                        (A0, A1: (in, out))
//   out = bf16(y + lrelu_0.2(r + t))
//
// Every conv is 3x3 SAME with zero padding, its weights rounded to bf16 and
// its sums in float; the maps are bf16.  Replaces the TPU kernel
// benchmarks/microbench_blockrcb_kernel.py::_block_kernel (block_rcb_rows),
// which keeps the whole level in VMEM and sweeps its tiles with a loop.
//
// Bound on the H100: arithmetic.  At a 272x480 map with C = C1 = 64 the four
// convs are 38.5 GFLOP, 0.039 ms at the bf16 tensor cores' 989 TFLOP/s;
// with FCVSR's C1 = 128, 57.8 GFLOP (0.058 ms).  The bytes, x read and out
// written once, are 33 MB (0.01 ms).
//
// The design: K6 (conv3x3_quad.cu) with the ContextBlock after it, in one
// persistent cooperative launch.  A level's conv body is exactly K6's
// function with ns1 = ns_body, ns3 = 0.2, no biases in the second pair, and
// every weight rounded to bf16, so:
//
// - Phase 1 runs K2's row loop (conv_tc.cuh::pair_rows, wgmma on rows
//   rolled through shared memory) over K2's work items and writes y.
// - grid.sync(); phase 2 runs it over y, read through L2 only (other blocks
//   wrote it; L1 is not coherent across SMs), and writes r.  Both phases
//   take one bf16 product a k step (bf16 maps times bf16 weights: the
//   weights' lo plane, which K6's bf16 route multiplies too, is zero), so
//   y and r equal a K6 launch's on bf16-rounded weights bit for bit.
// - Straight after each of its phase-2 items a block reads back the r it
//   just stored (hot in L2) and folds the item's pixels into online-softmax
//   partials: 8 lanes a pixel, a lane 8 channels, the logit summed by
//   shuffles over the 8 lanes, and each lane keeps the max m, the sum s of
//   exp(l - m) and its 8 channels of ctx = sum exp(l - m) r.  At the end of
//   each image the block merges its lanes' partials and stores one row
//   (m_b, s_b, ctx_b) a block and image.
// - grid.sync(); every block merges the rows of the images it holds, runs
//   the 64x64 MLP itself (no further barrier) and writes out = y +
//   lrelu_0.2(r + t) over its items, y and r read through L2.
//
// The grid is K6's: the occupancy query times the SM count, never more than
// the items; a grid that cannot be co-resident is refused, never split.
// The wrapper sizes the partials' buffer from it (fcvsr_blockrcb_grid).
// Channels: C <= 64 and C1 <= 128, what K2's loop takes.
#include <cooperative_groups.h>

#include <cmath>

#include "conv_tc.cuh"

namespace coop = cooperative_groups;

namespace fcvsr {
namespace {
namespace rcb {

using bf16 = __nv_bfloat16;
using tc::kSeg;
using tc::kThreadsTc;

constexpr int kLanes = 8;                     // lanes of a pixel, 8 channels each
constexpr int kSlots = kThreadsTc / kLanes;   // pixels a block folds at once
constexpr int kWarps = kThreadsTc / 32;
// floats of the merge's scratch before its per-block weights
constexpr int kMergeFloats = kThreadsTc + 3 * tc::kCoutMax + kWarps;

struct Params {
  const bf16* x;
  const float *wb0, *bb0, *wb1, *bb1, *wr0, *wr1, *wmask, *a0, *a1;
  bf16 *y, *r, *out;
  float* part;  // (gridDim.x, B, C + 2): m_b, s_b, ctx_b
  int B, H, W, C, C1, rows, vec;
  float ns_body;
};

// The max (MAX) or sum of v over the block, returned to every thread.
template <bool MAX>
__device__ float block_reduce(float v, float* wred) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = MAX ? fmaxf(v, u) : v + u;
  }
  __syncthreads();  // the previous reduction's readers are done with wred
  if (threadIdx.x % 32 == 0) wred[threadIdx.x / 32] = v;
  __syncthreads();
  v = wred[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) v = MAX ? fmaxf(v, wred[i]) : v + wred[i];
  return v;
}

// 8 bf16 values of a 16-byte row as floats
__device__ __forceinline__ void unpack8(const uint4& u, float (&v)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// A lane's online-softmax partial of one image: its pixels' max logit m,
// the sum s of exp(l - m), and its 8 channels of sum exp(l - m) r
struct Partial {
  float m = -INFINITY, s = 0.f, ctx[8] = {};
};

// Fold the pixels of a work item (segment x0, rows y0.., image b) of r,
// which this block has just stored, into the lanes' partials.
__device__ void fold_item(const Params& p, Partial& pt, int x0, int y0, int b) {
  const int lane8 = threadIdx.x % kLanes, slot = threadIdx.x / kLanes;
  const int c0 = lane8 * 8, nch = (p.C + 7) / 8;
  const int nx = min(kSeg, p.W - x0), ny = min(p.rows, p.H - y0);
  float wm[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) wm[e] = c0 + e < p.C ? __ldg(p.wmask + c0 + e) : 0.f;
  // every lane runs every round, so that the shuffles see a whole warp
  for (int k0 = 0; k0 < nx * ny; k0 += kSlots) {
    const int k = k0 + slot;
    const bool in = k < nx * ny;
    const size_t pix = ((size_t)b * p.H + y0 + k / nx) * p.W + x0 + k % nx;
    uint4 raw;
    tc::load8<true>(raw, p.r + pix * p.C + c0, p.C - c0, in && lane8 < nch, p.vec);
    float v[8];
    unpack8(raw, v);
    float l = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) l = fmaf(v[e], wm[e], l);
#pragma unroll
    for (int o = kLanes / 2; o; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (!in) continue;
    if (l > pt.m) {
      const float sc = expf(pt.m - l);  // 0 for the first pixel
      pt.s *= sc;
#pragma unroll
      for (int e = 0; e < 8; ++e) pt.ctx[e] *= sc;
      pt.m = l;
    }
    const float ex = expf(l - pt.m);
    pt.s += ex;
#pragma unroll
    for (int e = 0; e < 8; ++e) pt.ctx[e] = fmaf(ex, v[e], pt.ctx[e]);
  }
}

// Merge the lanes' partials of image b into the block's row of it.
__device__ void flush(const Params& p, float* sm, const Partial& pt, int b) {
  float* red = sm;                       // [kSlots][64]
  float* wred = sm + kSlots * tc::kCoutMax;
  const int lane8 = threadIdx.x % kLanes, slot = threadIdx.x / kLanes;
  const float M = block_reduce<true>(pt.m, wred);
  const float sc = pt.s > 0.f ? expf(pt.m - M) : 0.f;
  const float S = block_reduce<false>(lane8 == 0 ? pt.s * sc : 0.f, wred);
#pragma unroll
  for (int e = 0; e < 8; ++e) red[slot * tc::kCoutMax + lane8 * 8 + e] = pt.ctx[e] * sc;
  __syncthreads();
  float* row = p.part + ((size_t)blockIdx.x * p.B + b) * (p.C + 2);
  if (threadIdx.x < p.C) {
    float v = 0.f;
    for (int q = 0; q < kSlots; ++q) v += red[q * tc::kCoutMax + threadIdx.x];
    row[2 + threadIdx.x] = v;
  }
  if (threadIdx.x == 0) {
    row[0] = M;
    row[1] = S;
  }
  __syncthreads();  // red is free for the next item's smem
}

// Merge every block's row of image b and run the MLP: t in t_s.
__device__ void context_of(const Params& p, float* sm, int b, float* t_s) {
  const int C = p.C, G = gridDim.x;
  float* red = sm;                  // kThreadsTc
  float* ctx_t = red + kThreadsTc;  // C
  float* h_s = ctx_t + tc::kCoutMax;
  float* wred = t_s + tc::kCoutMax;
  float* wrow = sm + kMergeFloats;  // G
  const size_t stride = (size_t)p.B * (C + 2);
  const float* rows = p.part + (size_t)b * (C + 2);
  float m = -INFINITY;
  for (int j = threadIdx.x; j < G; j += kThreadsTc)
    if (__ldcg(rows + j * stride + 1) > 0.f) m = fmaxf(m, __ldcg(rows + j * stride));
  const float M = block_reduce<true>(m, wred);
  float s = 0.f;
  for (int j = threadIdx.x; j < G; j += kThreadsTc) {
    const float sj = __ldcg(rows + j * stride + 1);
    const float wj = sj > 0.f ? expf(__ldcg(rows + j * stride) - M) : 0.f;
    wrow[j] = wj;
    s += wj * sj;
  }
  const float S = block_reduce<false>(s, wred);  // wrow visible after it
  const int nq = kThreadsTc / C;
  if (threadIdx.x < nq * C) {
    const int c = threadIdx.x % C, q = threadIdx.x / C;
    float v = 0.f;
    for (int j = q; j < G; j += nq)
      if (wrow[j] != 0.f) v += wrow[j] * __ldcg(rows + j * stride + 2 + c);
    red[threadIdx.x] = v;
  }
  __syncthreads();
  if (threadIdx.x < C) {
    float v = 0.f;
    for (int q = 0; q < nq; ++q) v += red[q * C + threadIdx.x];
    ctx_t[threadIdx.x] = v / S;
  }
  __syncthreads();
  if (threadIdx.x < C) {
    float v = 0.f;
    for (int k = 0; k < C; ++k) v = fmaf(ctx_t[k], __ldg(p.a0 + k * C + threadIdx.x), v);
    h_s[threadIdx.x] = leaky(v, 0.2f);
  }
  __syncthreads();
  if (threadIdx.x < C) {
    float v = 0.f;
    for (int k = 0; k < C; ++k) v = fmaf(h_s[k], __ldg(p.a1 + k * C + threadIdx.x), v);
    t_s[threadIdx.x] = v;
  }
  __syncthreads();
}

// out = bf16(y + lrelu_0.2(r + t)) over a work item, 8 channels an element
__device__ void out_item(const Params& p, const float* t_s, int x0, int y0, int b) {
  const int nch = (p.C + 7) / 8;
  const int nx = min(kSeg, p.W - x0), ny = min(p.rows, p.H - y0);
  for (int e = threadIdx.x; e < nx * ny * nch; e += kThreadsTc) {
    const int k = e / nch, c0 = e % nch * 8;
    const size_t o = (((size_t)b * p.H + y0 + k / nx) * p.W + x0 + k % nx) * p.C + c0;
    uint4 yr, rr;
    tc::load8<true>(yr, p.y + o, p.C - c0, true, p.vec);
    tc::load8<true>(rr, p.r + o, p.C - c0, true, p.vec);
    float yv[8], rv[8];
    unpack8(yr, yv);
    unpack8(rr, rv);
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 2 * i + h;
        v[h] = yv[j] + leaky(rv[j] + (c0 + j < p.C ? t_s[c0 + j] : 0.f), 0.2f);
      }
      w[i] = tc::bf16x2_bits(__floats2bfloat162_rn(v[0], v[1]));
    }
    if (p.vec) {
      *reinterpret_cast<uint4*>(p.out + o) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      unsigned short* q = reinterpret_cast<unsigned short*>(p.out + o);
      for (int j = 0; j < 8 && c0 + j < p.C; ++j)
        q[j] = (unsigned short)(j % 2 ? w[j / 2] >> 16 : w[j / 2] & 0xffffu);
    }
  }
}

// N1: phase 1's C1 padded to 2 N1 (32 up to 64, 64 up to 128); phase 2's
// conv pair is C -> C -> C (N1 32)
template <int N1>
__global__ void __launch_bounds__(kThreadsTc, 1) blockrcb_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* sm = reinterpret_cast<float*>(smem);
  coop::grid_group grid = coop::this_grid();
  const int C = p.C;
  const int strips = (p.W + kSeg - 1) / kSeg, rblocks = (p.H + p.rows - 1) / p.rows;
  const int per_image = strips * rblocks, items = per_image * p.B;
  // this block's rows start empty (s = 0): a block may hold no item of an
  // image
  for (int e = threadIdx.x; e < p.B * (C + 2); e += kThreadsTc)
    p.part[(size_t)blockIdx.x * p.B * (C + 2) + e] = e % (C + 2) == 0 ? -INFINITY : 0.f;

  tc::pair_phase<bf16, N1, false, 1>(smem, p.x, p.wb0, p.bb0, p.wb1, p.bb1, p.y, p.B,
                                     p.H, p.W, C, p.C1, C, p.ns_body, p.rows, p.vec);
  grid.sync();  // y complete, and visible in L2

  Partial pt;
  int cur = -1;
  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    const int b = i / per_image, x0 = i % strips * kSeg, y0 = (i / strips) % rblocks * p.rows;
    if (b != cur) {
      if (cur >= 0) flush(p, sm, pt, cur);
      pt = Partial();
      cur = b;
    }
    tc::pair_rows<bf16, 32, true, 1>(smem, p.y, p.wr0, nullptr, p.wr1, nullptr, p.r,
                                     p.H, p.W, C, C, C, 0.2f, p.rows, p.vec, x0, y0, b);
    fold_item(p, pt, x0, y0, b);
  }
  if (cur >= 0) flush(p, sm, pt, cur);
  grid.sync();  // r and every block's rows complete

  float* t_s = sm + kMergeFloats - tc::kCoutMax - kWarps;
  int merged = -1;
  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    const int b = i / per_image, x0 = i % strips * kSeg, y0 = (i / strips) % rblocks * p.rows;
    if (b != merged) {
      context_of(p, sm, b, t_s);
      merged = b;
    }
    out_item(p, t_s, x0, y0, b);
  }
}

template <int N1>
constexpr int smem_bytes() {
  return tc::pair_smem<bf16, N1, 1>() > tc::pair_smem<bf16, 32, 1>()
             ? tc::pair_smem<bf16, N1, 1>()
             : tc::pair_smem<bf16, 32, 1>();
}

// The kernel's grid and rows on this card; the merge's weights must fit its
// shared memory beside its scratch
template <int N1>
cudaError_t plan(int B, int H, int W, int* grid, int* rows) {
  constexpr auto kernel = &blockrcb_kernel<N1>;
  cudaError_t err = allow_smem<kernel>(smem_bytes<N1>());
  if (err != cudaSuccess) return err;
  err = tc::persistent_plan(kernel, smem_bytes<N1>(), B, H, W, grid, rows);
  if (err != cudaSuccess) return err;
  if (kMergeFloats + *grid > smem_bytes<N1>() / 4) return cudaErrorInvalidConfiguration;
  return cudaSuccess;
}

template <int N1>
int launch(Params p, int part_blocks, cudaStream_t stream) {
  int grid = 0;
  cudaError_t err = plan<N1>(p.B, p.H, p.W, &grid, &p.rows);
  if (err != cudaSuccess) return (int)err;
  if (grid > part_blocks) return (int)cudaErrorInvalidValue;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(&blockrcb_kernel<N1>),
                                    dim3(grid), dim3(kThreadsTc), args, smem_bytes<N1>(),
                                    stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

bool channels_ok(int C, int C1) {
  return C >= 1 && C <= tc::kCinMax && C1 >= 1 && C1 <= tc::kC1Max;
}

}  // namespace rcb
}  // namespace
}  // namespace fcvsr

// The grid a launch takes at (B, H, W, C, C1) on the current device, into
// *grid: the rows of the partials' buffer.
extern "C" int fcvsr_blockrcb_grid(int B, int H, int W, int C, int C1, int* grid) {
  using namespace fcvsr::rcb;
  if (B < 1 || H < 1 || W < 1 || !channels_ok(C, C1)) return (int)cudaErrorInvalidValue;
  int rows = 0;
  return (int)(C1 <= 64 ? plan<32>(B, H, W, grid, &rows) : plan<64>(B, H, W, grid, &rows));
}

// x, out: (B,H,W,C) bf16; wb0 (3,3,C,C1), wb1 (3,3,C1,C), wr0, wr1 (3,3,C,C)
// float; bb0 (C1) and bb1 (C) float or null; wmask (C); a0, a1 (C,C) (in,
// out) float.  Scratch: y and r (B,H,W,C) bf16, part (part_blocks, B, C+2)
// float, part_blocks at least fcvsr_blockrcb_grid's grid.  C <= 64, C1 <=
// 128.
extern "C" int fcvsr_blockrcb(const void* x, const float* wb0, const float* bb0,
                              const float* wb1, const float* bb1, const float* wr0,
                              const float* wr1, const float* wmask, const float* a0,
                              const float* a1, void* y, void* r, void* out, float* part,
                              int part_blocks, int B, int H, int W, int C, int C1,
                              float ns_body, void* stream) {
  using namespace fcvsr::rcb;
  if (B < 1 || H < 1 || W < 1 || !channels_ok(C, C1) || part_blocks < 1)
    return (int)cudaErrorInvalidValue;
  const auto addr = [](const void* q) { return reinterpret_cast<uintptr_t>(q); };
  const int vec = C % 8 == 0 && addr(x) % 16 == 0 && addr(y) % 16 == 0 &&
                  addr(r) % 16 == 0 && addr(out) % 16 == 0;
  Params p{static_cast<const bf16*>(x), wb0, bb0, wb1, bb1, wr0, wr1, wmask, a0, a1,
           static_cast<bf16*>(y), static_cast<bf16*>(r), static_cast<bf16*>(out),
           part, B, H, W, C, C1, 0, vec, ns_body};
  cudaStream_t s = (cudaStream_t)stream;
  return C1 <= 64 ? launch<32>(p, part_blocks, s) : launch<64>(p, part_blocks, s);
}
