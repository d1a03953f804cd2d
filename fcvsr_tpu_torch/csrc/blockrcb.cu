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
// convs are 38.5 GFLOP (0.575 ms on the f32 FMA pipes); with FCVSR's C1 =
// 128, 57.8 GFLOP (0.862 ms).  The bytes, x read and out written once, are
// 33 MB (0.01 ms).
//
// The design.  An SM holds 228 KB of shared memory, not the level, so the
// level stays resident in the 50 MB L2 instead: a, y and r (a bf16 272x480x64
// map is 16.7 MB) go to scratch buffers in device memory, and each conv's
// input is read back by the blocks that need its neighbourhood.  Every conv
// needs its input's neighbours from other tiles, and the softmax needs the
// whole image, so the passes are separated by grid-wide barriers: the launch
// is cooperative and persistent, its grid as large as the card holds
// co-resident (the occupancy query times the SM count), and each block loops
// over 8x16-pixel output tiles.  A grid that cannot be co-resident is
// refused, never split.  Each conv pass runs the register tiles of
// conv3x3.cuh over its tiles, with no halo recompute (what sank K6's first
// design).  The last conv also takes each pixel's logit from the
// bf16-rounded r it stores and keeps, per block and image, online-softmax
// partials: the max m_b, the
// sum s_b of exp(l - m_b) and ctx_b = sum exp(l - m_b) r.  After one more
// barrier every block merges the partials of the images it holds, runs the
// ContextBlock's MLP itself (no further barrier) and writes out over its
// tiles, in place of r.  Maps that other blocks of the launch wrote are read
// through L2 (ld.global.cg): L1 is not coherent across SMs.
#include <cooperative_groups.h>

#include <cmath>

#include "conv3x3.cuh"

namespace coop = cooperative_groups;

namespace fcvsr {
namespace {

using bf16 = __nv_bfloat16;
using conv::accumulate;
using conv::CIB;
using conv::stage_input;
using conv::stage_weights;

constexpr int TH = 8, TW = 16, TP = TH * TW;  // an output tile
constexpr int NCG = 8, CPT = 8, COB = NCG * CPT, NPG = kThreads / NCG;
constexpr int PPT = TP / NPG;
constexpr int IH = TH + 2, IW = TW + 2, LD = CIB + 1;
constexpr int CONV_FLOATS = IH * IW * LD + 9 * CIB * COB;
constexpr int NWARP = kThreads / 32;

// Shared memory in floats: the conv staging area (which the merge reuses
// for its per-block weights), then the ContextBlock's scratch.
__host__ __device__ constexpr int smem_floats(int C) {
  return CONV_FLOATS + 2 * TP + kThreads + NWARP + 4 * C;
}

struct Params {
  const bf16* x;
  const float *wb0, *bb0, *wb1, *bb1, *wr0, *wr1, *wmask, *a0, *a1;
  bf16 *a, *y, *out;  // scratch a (B,H,W,max(C,C1)), y (B,H,W,C); out
  float* part;        // (grid, B, C + 2): m_b, s_b, ctx_b
  int B, H, W, C, C1;
  float ns_body;
};

struct Smem {
  float *in_s, *w_s, *logit_s, *e_s, *red_s, *wred, *ctx_t, *ctx_b, *h_s, *t_s;
  __device__ Smem(float* sm, int C)
      : in_s(sm), w_s(sm + IH * IW * LD), logit_s(sm + CONV_FLOATS),
        e_s(logit_s + TP), red_s(e_s + TP), wred(red_s + kThreads),
        ctx_t(wred + NWARP), ctx_b(ctx_t + C), h_s(ctx_b + C), t_s(h_s + C) {}
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
  for (int i = 1; i < NWARP; ++i) v = MAX ? fmaxf(v, wred[i]) : v + wred[i];
  return v;
}

struct Tile {
  int b, y0, x0, th, tw;  // image, origin, the part inside the frame
};

__device__ Tile tile_at(int t, int H, int W) {
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  Tile tl;
  tl.x0 = (t % tiles_x) * TW;
  t /= tiles_x;
  tl.y0 = (t % tiles_y) * TH;
  tl.b = t / tiles_y;
  tl.th = min(TH, H - tl.y0);
  tl.tw = min(TW, W - tl.x0);
  return tl;
}

// The block's online-softmax partial of one image, as every thread of the
// block holds it: m and s in registers (block-uniform), ctx in ctx_b[c],
// kept by thread c.
struct Partial {
  int b = -1;
  float m = -INFINITY, s = 0.f;
};

__device__ void flush(const Params& p, const Smem& sh, const Partial& pt) {
  float* row = p.part + ((size_t)blockIdx.x * p.B + pt.b) * (p.C + 2);
  if (threadIdx.x == 0) {
    row[0] = pt.m;
    row[1] = pt.s;
  }
  if (threadIdx.x < p.C) row[2 + threadIdx.x] = sh.ctx_b[threadIdx.x];
}

// Fold the tile just stored in out (r, with its logits in logit_s) into
// the block's partial.
__device__ void fold_tile(const Params& p, const Smem& sh, const Tile& tl,
                          Partial& pt) {
  const int C = p.C;
  const bool mine = threadIdx.x < TP && threadIdx.x / TW < tl.th &&
                    threadIdx.x % TW < tl.tw;
  const float l = mine ? sh.logit_s[threadIdx.x] : -INFINITY;
  const float mt = block_reduce<true>(l, sh.wred);
  const float e = mine ? expf(l - mt) : 0.f;
  if (threadIdx.x < TP) sh.e_s[threadIdx.x] = e;
  const float st = block_reduce<false>(e, sh.wred);  // e_s visible after it
  // ctx of the tile: thread (q, c) sums channel c over pixels q, q + nq, ...
  const int nq = kThreads / C;
  if (threadIdx.x < nq * C) {
    const int c = threadIdx.x % C, q = threadIdx.x / C;
    const bf16* r = p.out + (((size_t)tl.b * p.H + tl.y0) * p.W + tl.x0) * C + c;
    float s = 0.f;
    for (int px = q; px < TP; px += nq)
      if (px / TW < tl.th && px % TW < tl.tw)
        s += sh.e_s[px] * load_cg(r + ((size_t)(px / TW) * p.W + px % TW) * C);
    sh.red_s[threadIdx.x] = s;
  }
  __syncthreads();
  if (tl.b != pt.b) {  // the block's first tile of this image
    if (pt.b >= 0) flush(p, sh, pt);
    pt = Partial();
    pt.b = tl.b;
    if (threadIdx.x < C) sh.ctx_b[threadIdx.x] = 0.f;
  }
  const float m = fmaxf(pt.m, mt);
  const float sa = pt.m == -INFINITY ? 0.f : expf(pt.m - m), sb = expf(mt - m);
  pt.m = m;
  pt.s = pt.s * sa + st * sb;
  if (threadIdx.x < C) {
    float s = 0.f;
    for (int q = 0; q < nq; ++q) s += sh.red_s[q * C + threadIdx.x];
    sh.ctx_b[threadIdx.x] = sh.ctx_b[threadIdx.x] * sa + s * sb;
  }
}

// One conv pass over the block's tiles: dst = bf16(act(conv(src, w) + bias)).
// CG: src was written by this launch.  LOGITS: the last conv, which also
// folds each tile into the block's softmax partials.
template <bool CG, bool LOGITS>
__device__ void conv_pass(const Params& p, const Smem& sh, const bf16* src,
                          const float* w, const float* bias, bf16* dst, int Cin,
                          int Cout, bool act, float ns, Partial& pt) {
  const int ntiles = ((p.W + TW - 1) / TW) * ((p.H + TH - 1) / TH) * p.B;
  const int cg = threadIdx.x % NCG, pg = threadIdx.x / NCG;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const Tile tl = tile_at(t, p.H, p.W);
    const bf16* sb = src + (size_t)tl.b * p.H * p.W * Cin;
    bf16* db = dst + (size_t)tl.b * p.H * p.W * Cout;
    for (int co0 = 0; co0 < Cout; co0 += COB) {
      float acc[PPT][CPT] = {};
      for (int ci0 = 0; ci0 < Cin; ci0 += CIB) {
        const int cn = min(CIB, Cin - ci0);
        stage_input<CG>(sh.in_s, LD, sb, p.H, p.W, Cin, ci0, cn, tl.y0 - 1,
                        tl.x0 - 1, IH, IW);
        stage_weights<COB, true>(sh.w_s, w, Cin, Cout, ci0, cn, co0);
        __syncthreads();
        accumulate<NCG, CPT, PPT>(acc, sh.in_s, LD, IW, sh.w_s, cn, TP, TW);
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        const int px = pg + i * NPG, py = px / TW, pxx = px % TW;
        const bool inside = py < tl.th && pxx < tl.tw;
        const size_t o = (((size_t)(tl.y0 + py)) * p.W + tl.x0 + pxx) * Cout;
        float lp = 0.f;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int co = co0 + cg + NCG * j;
          if (co >= Cout) continue;
          float v = acc[i][j] + (bias ? bias[co] : 0.f);
          if (act) v = leaky(v, ns);
          const bf16 q = from_f32<bf16>(v);
          if (inside) db[o + co] = q;
          if (LOGITS) lp = fmaf(to_f32(q), p.wmask[co], lp);
        }
        if (LOGITS) {
          // the NCG threads of a pixel are neighbouring lanes of one warp
#pragma unroll
          for (int d = NCG / 2; d; d >>= 1) lp += __shfl_xor_sync(0xffffffffu, lp, d);
          if (cg == 0) sh.logit_s[px] = (co0 == 0 ? 0.f : sh.logit_s[px]) + lp;
        }
      }
    }
    if (LOGITS) {
      __syncthreads();  // the tile's logits and r are complete
      fold_tile(p, sh, tl, pt);
    }
  }
  if (LOGITS && pt.b >= 0) flush(p, sh, pt);
}

// Merge every block's partial of image b into t = MLP(ctx) in sh.t_s.
__device__ void context_of(const Params& p, const Smem& sh, int b) {
  const int C = p.C, G = gridDim.x;
  const size_t stride = (size_t)p.B * (C + 2);
  const float* rows = p.part + (size_t)b * (C + 2);
  float m = -INFINITY;
  for (int j = threadIdx.x; j < G; j += kThreads)
    if (__ldcg(rows + j * stride + 1) > 0.f) m = fmaxf(m, __ldcg(rows + j * stride));
  const float M = block_reduce<true>(m, sh.wred);
  float* wrow = sh.in_s;  // G floats of the conv staging area
  float s = 0.f;
  for (int j = threadIdx.x; j < G; j += kThreads) {
    const float sj = __ldcg(rows + j * stride + 1);
    const float wj = sj > 0.f ? expf(__ldcg(rows + j * stride) - M) : 0.f;
    wrow[j] = wj;
    s += wj * sj;
  }
  const float S = block_reduce<false>(s, sh.wred);  // wrow visible after it
  const int nq = kThreads / C;
  if (threadIdx.x < nq * C) {
    const int c = threadIdx.x % C, q = threadIdx.x / C;
    float v = 0.f;
    for (int j = q; j < G; j += nq)
      if (wrow[j] != 0.f) v += wrow[j] * __ldcg(rows + j * stride + 2 + c);
    sh.red_s[threadIdx.x] = v;
  }
  __syncthreads();
  if (threadIdx.x < C) {
    float v = 0.f;
    for (int q = 0; q < nq; ++q) v += sh.red_s[q * C + threadIdx.x];
    sh.ctx_t[threadIdx.x] = v / S;
  }
  __syncthreads();
  if (threadIdx.x < C) {
    float v = 0.f;
    for (int k = 0; k < C; ++k) v = fmaf(sh.ctx_t[k], p.a0[k * C + threadIdx.x], v);
    sh.h_s[threadIdx.x] = leaky(v, 0.2f);
  }
  __syncthreads();
  if (threadIdx.x < C) {
    float v = 0.f;
    for (int k = 0; k < C; ++k) v = fmaf(sh.h_s[k], p.a1[k * C + threadIdx.x], v);
    sh.t_s[threadIdx.x] = v;
  }
  __syncthreads();
}

// Two blocks an SM: ptxas gives the kernel 238 registers unbounded (one
// block an SM), 128 with a few spills at two; two ran 14% (C1 64) and 21%
// (C1 128) faster on an H100, three (80 registers, more spills) slower.
__global__ void __launch_bounds__(kThreads, 2) blockrcb_kernel(Params p) {
  extern __shared__ float sm[];
  const Smem sh(sm, p.C);
  coop::grid_group grid = coop::this_grid();
  const int C = p.C;
  // this block's partial rows start empty (s = 0): a block may hold no tile
  // of an image
  for (int e = threadIdx.x; e < p.B * (C + 2); e += kThreads)
    p.part[(size_t)blockIdx.x * p.B * (C + 2) + e] =
        e % (C + 2) == 0 ? -INFINITY : 0.f;
  Partial pt;
  conv_pass<false, false>(p, sh, p.x, p.wb0, p.bb0, p.a, C, p.C1, true, p.ns_body, pt);
  grid.sync();
  conv_pass<true, false>(p, sh, p.a, p.wb1, p.bb1, p.y, p.C1, C, false, 0.f, pt);
  grid.sync();
  conv_pass<true, false>(p, sh, p.y, p.wr0, nullptr, p.a, C, C, true, 0.2f, pt);
  grid.sync();
  conv_pass<true, true>(p, sh, p.a, p.wr1, nullptr, p.out, C, C, false, 0.f, pt);
  grid.sync();

  // out = bf16(y + lrelu_0.2(r + t)) over the block's tiles, in place of r
  const int ntiles = ((p.W + TW - 1) / TW) * ((p.H + TH - 1) / TH) * p.B;
  int merged = -1;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const Tile tl = tile_at(t, p.H, p.W);
    if (tl.b != merged) {
      context_of(p, sh, tl.b);
      merged = tl.b;
    }
    for (int e = threadIdx.x; e < TP * C; e += kThreads) {
      const int px = e / C, c = e % C;
      if (px / TW >= tl.th || px % TW >= tl.tw) continue;
      const size_t o =
          (((size_t)tl.b * p.H + tl.y0 + px / TW) * p.W + tl.x0 + px % TW) * C + c;
      const float v = load_cg(p.y + o) + leaky(load_cg(p.out + o) + sh.t_s[c], 0.2f);
      p.out[o] = from_f32<bf16>(v);
    }
  }
}

}  // namespace
}  // namespace fcvsr

// x, out: (B,H,W,C) bf16; wb0 (3,3,C,C1), wb1 (3,3,C1,C), wr0, wr1 (3,3,C,C)
// float; bb0 (C1) and bb1 (C) float or null; wmask (C); a0, a1 (C,C) (in,
// out) float.  Scratch: a (B,H,W,max(C,C1)) and y (B,H,W,C) bf16, part
// (part_blocks, B, C+2) float; the grid is at most part_blocks blocks.
extern "C" int fcvsr_blockrcb(const void* x, const float* wb0, const float* bb0,
                              const float* wb1, const float* bb1, const float* wr0,
                              const float* wr1, const float* wmask, const float* a0,
                              const float* a1, void* a, void* y, void* out, float* part,
                              int part_blocks, int B, int H, int W, int C, int C1,
                              float ns_body, void* stream) {
  using namespace fcvsr;
  if (B < 1 || H < 1 || W < 1 || C < 1 || C > kThreads || C1 < 1 || part_blocks < 1)
    return (int)cudaErrorInvalidValue;
  constexpr auto kernel = &blockrcb_kernel;
  const size_t smem = sizeof(float) * smem_floats(C);
  cudaError_t err = allow_smem<kernel>(smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, cooperative = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&cooperative, cudaDevAttrCooperativeLaunch, dev)) !=
      cudaSuccess)
    return (int)err;
  if (!cooperative) return (int)cudaErrorNotSupported;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const long long ntiles =
      (long long)((W + TW - 1) / TW) * ((H + TH - 1) / TH) * B;
  long long grid = (long long)per_sm * sms;
  if (ntiles < grid) grid = ntiles;
  if (part_blocks < grid) grid = part_blocks;
  if (grid > CONV_FLOATS) grid = CONV_FLOATS;  // the merge's weights fit
  Params p{static_cast<const bf16*>(x), wb0, bb0, wb1, bb1, wr0, wr1, wmask, a0, a1,
           static_cast<bf16*>(a), static_cast<bf16*>(y), static_cast<bf16*>(out),
           part, B, H, W, C, C1, ns_body};
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3((unsigned)grid), dim3(kThreads), args, smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
