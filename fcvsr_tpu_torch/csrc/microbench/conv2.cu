// K9: the probes of the rows conv kernel's time, on Hopper.
//
// Replaces the four Pallas kernels of benchmarks/microbench_conv2.py, each
// run over the real kernel's 17-tile grid (TH 16 rows a tile, C 64, WP 512
// lanes):
//   mm_stream_kernel  (:62)   out[r] = bf16(w) @ rhs[r], (C, 9C) x (9C, WP)
//   mm_stream3_kernel (:82)   the same in 3 accumulating passes of K = 3C
//   im2col_kernel     (:107)  the window copy, the 9 shifted bf16 slabs
//                             stacked into the (9C, WP) operand, a reduce
//   dma_kernel        (:140)  the window copy and a reduce
// The TPU kernels write one output block that every grid step overwrites;
// here every tile's work is real and checkable (fcvsr_tpu_torch/benchmarks/
// microbench_conv2.py says what each function computes).
//
// mm_stream / mm_stream3.  Bound by operations: 2 * 17 * 16 * 576 * 64 *
// 512 = 10.3 GFLOP at 989 TFLOP/s bf16 is 0.0104 ms, against 11.7 MB of
// traffic (0.0035 ms).  Design: bf16 tensor cores through mma.sync
// m16n8k16 with f32 sums (wgmma is for a later kernel).  Persistent blocks,
// two an SM, each rounds w to bf16 once into shared memory (74 KB) and then
// walks work items (tile, row, 128-lane chunk); the rhs rows of all its
// items stream through one 2-stage cp.async ring of 64 x 128 bf16 stages,
// read by ldmatrix.trans, so the next item's rows load while this item's
// last are multiplied.  The fixed rhs (9.4 MB) stays in the 50 MB L2, as
// the TPU kept it in VMEM.  Each item's outputs are summed into a partial in a
// fixed order; the last block of a tile to finish sums that tile's partials
// in a fixed order into its checksum, so every tile's checksum is the same
// number, bit for bit.  Only the last tile writes `out`.
//
// im2col / dma_window.  Bound by bytes: the 35.9 MB float32 source read
// once (0.0107 ms at 3.35 TB/s); the 16 + 2 rows of a tile's window overlap
// the next tile's by 2.  Design: a block a (tile, 16-lane strip); cp.async
// copies the strip's (TH + 2) x C x (16 + 2) window, the 2-lane halo
// wrapping at the row's end, into shared memory (92 KB, two blocks an SM).
// im2col then builds, for each output row, the bf16 (9C x 16) operand tile
// as a tensor-core GEMM reads it (k = (dy * 3 + dx) * C + c rows, lanes
// contiguous) and reduces it over k; dma_window reduces the window over C.
// The two differ only by the build.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "../common.cuh"

namespace {

using fcvsr::allow_smem;

// ---------------------------------------------------------------- helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give matrix i's row addresses
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// ------------------------------------------------------------- mm stream

constexpr int kC = 64;              // output channels: the block's M
constexpr int kK = 9 * kC;          // 576
constexpr int kNC = 128;            // output lanes a work item
constexpr int kKC = 64;             // rhs rows a pipeline stage
constexpr int kStages = 2;          // faster than 32 rows in 2 to 4 stages
constexpr int kChunks = kK / kKC;   // 9
constexpr int kAStride = kK + 8;    // bf16; 1168 B rows, ldmatrix conflict-free
constexpr int kBStride = kNC + 8;   // bf16; 272 B rows
constexpr int kMmThreads = 256;     // 8 warps: 2 (M, 32 rows) x 4 (N, 32 lanes)
constexpr size_t kMmSmem = (size_t)kC * kAStride * 2 +
                           (size_t)kStages * kKC * kBStride * 2 + 8 * sizeof(float);

static_assert(kK % (3 * kKC) == 0, "a pass of mm_stream3 is whole stages");

// One stage: rhs[r, k0 : k0 + 32, n0 : n0 + 128] into bs, lanes past WP zero.
__device__ __forceinline__ void load_stage(__nv_bfloat16* bs,
                                           const __nv_bfloat16* rhs, int r,
                                           int k0, int n0, int WP, bool vec) {
  for (int q = threadIdx.x; q < kKC * (kNC / 8); q += kMmThreads) {
    const int row = q / (kNC / 8), seg = q % (kNC / 8);
    const int n = n0 + seg * 8;
    const __nv_bfloat16* g = rhs + ((size_t)r * kK + k0 + row) * WP + n;
    __nv_bfloat16* s = bs + row * kBStride + seg * 8;
    if (vec && n + 8 <= WP) {
      cp_async16(s, g);
    } else {
      for (int e = 0; e < 8; ++e)
        s[e] = n + e < WP ? g[e] : __float2bfloat16_rn(0.f);
    }
  }
}

template <int kPasses>
__global__ void __launch_bounds__(kMmThreads, 2)
    mm_stream_kernel(const __nv_bfloat16* __restrict__ rhs,
                     const float* __restrict__ w, float* __restrict__ out,
                     float* __restrict__ checksums, float* partials,
                     unsigned* counters, int TH, int WP, int tiles, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* bs = as + kC * kAStride;
  float* red = reinterpret_cast<float*>(bs + kStages * kKC * kBStride);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, tig = lane & 3;

  // w rounded to bf16 once a block, four values a load
  for (int i = tid; i < kC * kK / 4; i += kMmThreads) {
    const float4 v = reinterpret_cast<const float4*>(w)[i];
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
        as + (i / (kK / 4)) * kAStride + (i % (kK / 4)) * 4);
    dst[0] = __floats2bfloat162_rn(v.x, v.y);
    dst[1] = __floats2bfloat162_rn(v.z, v.w);
  }

  // The block's items are blockIdx.x + i * gridDim.x; their chunks form one
  // stream through the ring, so the next item's first chunks load while
  // this one's last are multiplied.
  const int nch = (WP + kNC - 1) / kNC;
  const int per_tile = TH * nch;
  const int items = tiles * per_tile;
  const int mine = (items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int total = mine * kChunks;
  auto load = [&](int q) {  // chunk q of the block's stream into its stage
    const int p = (blockIdx.x + (q / kChunks) * gridDim.x) % per_tile;
    load_stage(bs + (q % kStages) * kKC * kBStride, rhs, p / nch,
               (q % kChunks) * kKC, (p % nch) * kNC, WP, vec);
  };
#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) {
    if (q < total) load(q);
    cp_async_commit();
  }

  float acc[2][4][4], d[2][4][4];
  for (int q = 0; q < total; ++q) {
    const int c = q % kChunks;
    if (c == 0) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][nt][e] = d[mi][nt][e] = 0.f;
    }
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk q is in; every warp is done with chunk q - 1
    if (q + kStages - 1 < total) load(q + kStages - 1);
    cp_async_commit();
    const __nv_bfloat16* b = bs + (q % kStages) * kKC * kBStride;
#pragma unroll
    for (int kk = 0; kk < kKC; kk += 16) {
      uint32_t a[2][4], bf[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4(a[mi], as + (32 * wm + 16 * mi + (lane & 15)) * kAStride +
                           c * kKC + kk + (lane >> 4) * 8);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        ldsm_x4_trans(bf[nj],
                      b + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * kBStride +
                          32 * wn + 16 * nj + (lane >> 4) * 8);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const uint32_t b0 = bf[nt >> 1][(nt & 1) * 2];
          const uint32_t b1 = bf[nt >> 1][(nt & 1) * 2 + 1];
          if constexpr (kPasses == 1)
            mma_bf16(acc[mi][nt], a[mi], b0, b1);
          else
            mma_bf16(d[mi][nt], a[mi], b0, b1);
        }
    }
    if constexpr (kPasses > 1) {
      if ((c + 1) % (kChunks / kPasses) == 0) {
        // the end of a pass: acc = acc + dot_pass, as the TPU kernel adds
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[mi][nt][e] += d[mi][nt][e];
              d[mi][nt][e] = 0.f;
            }
      }
    }
    if (c != kChunks - 1) continue;

    // the item is done: its partial sum, in a fixed order (lanes past WP
    // hold 0), and the output block from the last tile
    const int item = blockIdx.x + (q / kChunks) * gridDim.x;
    const int t = item / per_tile, p = item % per_tile;
    const int r = p / nch, n0 = (p % nch) * kNC;
    float s = 0.f;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s += acc[mi][nt][e];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) red[warp] = s;
    if (t == tiles - 1) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int m = 32 * wm + 16 * mi + g + (e >> 1) * 8;
            const int n = n0 + 32 * wn + 8 * nt + 2 * tig + (e & 1);
            if (n < WP) out[((size_t)r * kC + m) * WP + n] = acc[mi][nt][e];
          }
    }
    __syncthreads();  // red is complete
    if (tid == 0) {
      float part = 0.f;
      for (int i = 0; i < kMmThreads / 32; ++i) part += red[i];
      partials[(size_t)t * per_tile + p] = part;
      __threadfence();
      if (atomicAdd(&counters[t], 1u) == (unsigned)per_tile - 1) {
        // the tile's last item: its checksum, then the counter back to 0
        __threadfence();
        float sum = 0.f;
        for (int i = 0; i < per_tile; ++i)
          sum += __ldcg(&partials[(size_t)t * per_tile + i]);
        checksums[t] = sum;
        counters[t] = 0u;
      }
    }
  }
  cp_async_wait<0>();
}

// --------------------------------------------------------- window probes

constexpr int kSW = 16;          // output lanes a block
constexpr int kLine = kSW + 4;   // f32 stride of a window line: 16 + 2 halo, 16 B rows
constexpr int kWinThreads = 256;

static_assert(kWinThreads == kSW * 16, "the reduce takes 16 parts a lane");

size_t window_smem(int TH, int C, bool build) {
  size_t bytes = (size_t)(TH + 2) * C * kLine * sizeof(float);
  if (build) bytes += (size_t)9 * C * kSW * 2 + kWinThreads * sizeof(float);
  return bytes;
}

template <bool kBuild>
__global__ void __launch_bounds__(kWinThreads)
    window_kernel(const float* __restrict__ src, float* __restrict__ out, int TH,
                  int C, int WP, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* win = reinterpret_cast<float*>(smem);  // (TH + 2) x C x kLine
  const int tid = threadIdx.x;
  const int t = blockIdx.y, x0 = blockIdx.x * kSW;
  const int nout = min(kSW, WP - x0);
  const int nlane = nout + 2;  // window lanes read, the last 2 wrapping
  const int lines = (TH + 2) * C;
  const float* base = src + (size_t)t * TH * C * WP;

  if (vec && nout == kSW) {  // 4 copies of 16 B and the 2 halo lanes a line
    for (int q = tid; q < lines * 6; q += kWinThreads) {
      const int line = q / 6, part = q % 6;
      const float* gl = base + (size_t)line * WP;
      float* sl = win + line * kLine;
      if (part < 4) {
        cp_async16(sl + 4 * part, gl + x0 + 4 * part);
      } else {
        int x = x0 + kSW + part - 4;
        if (x >= WP) x -= WP;
        cp_async4(sl + kSW + part - 4, gl + x);
      }
    }
  } else {
    for (int q = tid; q < lines * nlane; q += kWinThreads) {
      const int line = q / nlane, j = q % nlane;
      int x = x0 + j;
      if (x >= WP) x -= WP;
      cp_async4(win + line * kLine + j, base + (size_t)line * WP + x);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  if (!kBuild) {  // o[t, row, x] = sum_c window[row, c, x]
    for (int q = tid; q < (TH + 2) * nout; q += kWinThreads) {
      const int row = q / nout, x = q % nout;
      float s = 0.f;
      for (int c = 0; c < C; ++c) s += win[(row * C + c) * kLine + x];
      out[((size_t)t * (TH + 2) + row) * WP + x0 + x] = s;
    }
    return;
  }

  __nv_bfloat16* op = reinterpret_cast<__nv_bfloat16*>(win + lines * kLine);
  float* red = reinterpret_cast<float*>(op + 9 * C * kSW);
  const int K = 9 * C;
  const int x = tid % kSW, part = tid / kSW;  // a lane and one of 16 parts
  for (int r = 0; r < TH; ++r) {
    // the (9C x 16) operand of output row r: row k = (dy * 3 + dx) * C + c
    // holds window row r + dy, channel c, lanes shifted by dx; a thread
    // builds lane x of the channels part, part + 16, ...
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const float* wl = win + (r + tap / 3) * C * kLine + x + tap % 3;
      __nv_bfloat16* ol = op + tap * C * kSW + x;
      for (int c = part; c < C; c += 16)
        ol[c * kSW] = __float2bfloat16_rn(x < nout ? wl[c * kLine] : 0.f);
    }
    __syncthreads();
    // its sum over k: 16 parts of every 16th row, then the parts in order
    float s = 0.f;
    for (int k = part; k < K; k += 16) s += __bfloat162float(op[k * kSW + x]);
    red[tid] = s;
    __syncthreads();
    if (tid < nout) {
      float v = 0.f;
      for (int i = 0; i < 16; ++i) v += red[i * kSW + tid];
      out[((size_t)t * TH + r) * WP + x0 + tid] = v;
    }
    __syncthreads();  // op and red are free for the next row
  }
}

template <bool kBuild>
cudaError_t launch_window(const float* src, float* out, int TH, int C, int WP,
                          int tiles, cudaStream_t stream) {
  const size_t smem = window_smem(TH, C, kBuild);
  cudaError_t err = allow_smem<window_kernel<kBuild>>(smem);
  if (err != cudaSuccess) return err;
  const int vec = WP % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0;
  const dim3 grid((WP + kSW - 1) / kSW, tiles);
  window_kernel<kBuild><<<grid, kWinThreads, smem, stream>>>(src, out, TH, C, WP,
                                                             vec);
  return cudaGetLastError();
}

}  // namespace

// rhs (TH, 576, WP) bf16, w (64, 576) f32 (16-byte aligned); out (TH, 64,
// WP) f32 (the last tile's), checksums (tiles,); partials (tiles * TH *
// ceil(WP / 128)) f32 scratch; counters (tiles,) u32, zero on entry and left
// zero.
extern "C" int fcvsr_mb_mm_stream(const void* rhs, const float* w, float* out,
                                  float* checksums, float* partials,
                                  unsigned* counters, int TH, int WP, int tiles,
                                  int passes, void* stream) {
  if (TH < 1 || WP < 3 || tiles < 1 || (passes != 1 && passes != 3) ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return (int)cudaErrorInvalidValue;
  auto kernel = passes == 1 ? mm_stream_kernel<1> : mm_stream_kernel<3>;
  cudaError_t err = passes == 1 ? allow_smem<mm_stream_kernel<1>>(kMmSmem)
                                : allow_smem<mm_stream_kernel<3>>(kMmSmem);
  if (err != cudaSuccess) return (int)err;
  int sms = 0, per_sm = 0;
  if ((err = sm_count(&sms)) != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kMmThreads,
                                                      kMmSmem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long items = (long long)tiles * TH * ((WP + kNC - 1) / kNC);
  const long long slots = (long long)sms * per_sm;
  const int grid = (int)(items < slots ? items : slots);
  const int vec = WP % 8 == 0 && reinterpret_cast<uintptr_t>(rhs) % 16 == 0;
  kernel<<<grid, kMmThreads, kMmSmem, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(rhs), w, out, checksums, partials,
      counters, TH, WP, tiles, vec);
  return (int)cudaGetLastError();
}

// src (1, tiles * TH + 2, C, WP) f32.  build 1: im2col, out (tiles, TH, WP);
// build 0: the window's channel sums, out (tiles, TH + 2, WP).
extern "C" int fcvsr_mb_window(const float* src, float* out, int TH, int C, int WP,
                               int tiles, int build, void* stream) {
  if (TH < 1 || C < 1 || WP < 3 || tiles < 1) return (int)cudaErrorInvalidValue;
  return (int)(build ? launch_window<true>(src, out, TH, C, WP, tiles,
                                           (cudaStream_t)stream)
                     : launch_window<false>(src, out, TH, C, WP, tiles,
                                            (cudaStream_t)stream));
}

extern "C" const char* fcvsr_mb_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
