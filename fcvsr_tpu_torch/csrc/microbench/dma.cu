// K10: the window-copy probes, on Hopper.
//
// Replaces the three Pallas kernels of benchmarks/microbench_dma.py, which
// copy a (17 * 16 + 2, 64, 512) source from HBM into VMEM on three
// schedules, in float32 and bf16:
//   one_shot (:60)  one copy of the whole source
//   serial   (:80)  17 slabs of 16 + 2 rows, each copy started and waited
//   dbuf     (:102) the same slabs double-buffered: slab t + 1's copy in
//                   flight while slab t is waited on
// and store the first row's channel 0 (of the source, or of the last slab)
// as a (1, 1, WP) float32 output.  Here each block also folds what landed in
// its shared memory into words, one a kFold-byte segment of the copied range
// (of each slab): the wrapping sum of the segment's raw 32-bit words, so
// that the output depends on every copied byte and the plain version can
// compute the same fold, bit for bit, from the source.
//
// Bound by bytes: the source read once, 35.9 MB in float32 (0.0107 ms at
// 3.35 TB/s) and 18.0 MB in bf16 (0.0054 ms); the slabs overlap by 2 rows,
// which the bound does not count.  Design: the 1-D bulk form of TMA,
// cp.async.bulk global -> shared completing on an mbarrier, issued by one
// thread a block; the copy engine computes no addresses in the SM's
// threads.  A bulk copy needs 16-byte aligned addresses and a size that is a
// multiple of 16, and one mbarrier phase takes at most 2^20 - 1 bytes.  A
// block cannot hold the source (the card has 132 x 227 KB, the float32
// source 35.9 MB), so:
//   one_shot   as many blocks as the source takes at one bulk copy of up to
//              227 KB each, in no order among them;
//   serial     one block an SM, each copying its share of slab t into its
//              buffer and waiting before it issues slab t + 1: one copy in
//              flight a block;
//   dbuf       the same with two buffers and two mbarriers, slab t + 1
//              issued before slab t is waited on.
// The blocks' shares are multiples of kFold bytes, so a segment lies in one
// block, whose warps fold it with 16-byte loads and a warp reduction and
// write its word; no atomics, and the output needs no zeroing.  After each
// slab (after the copy in one_shot) the blocks that hold the wanted row
// write it to the output, which the last slab overwrites last, as the TPU
// kernels overwrite their output block at every grid step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "../common.cuh"

namespace {

using fcvsr::allow_smem;

constexpr int kDmaThreads = 1024;  // 32 warps to fold; one thread copies
constexpr int kHeader = 128;  // bytes before the buffers: the mbarriers
constexpr long long kMaxTx = (1 << 20) - 1;
constexpr int kFold = 1024;  // bytes a folded word

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one thread: arrive and expect `bytes` of transactions on the phase, then
// issue the bulk copy that completes them.  The proxy fence orders the
// block's earlier reads of the buffer (generic proxy, before the caller's
// barrier) before the copy's writes (async proxy).
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// wait for the completion of the barrier's phase with this parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// out[i] for the elements i < WP that fall in this block's bytes [lo, lo +
// bytes) of the copied range, from its buffer
__device__ __forceinline__ void store_row(float* out, const unsigned char* buf,
                                          long long lo, long long bytes, int WP,
                                          int bf16) {
  const int es = bf16 ? 2 : 4;
  const long long e0 = lo / es, e1 = (lo + bytes) / es;
  for (long long i = e0 + threadIdx.x; i < e1 && i < WP; i += kDmaThreads) {
    const long long j = i - e0;
    out[i] = bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(buf)[j])
                  : reinterpret_cast<const float*>(buf)[j];
  }
}

// folds[s] for the kFold-byte segments s of this block's bytes [lo, lo +
// bytes) of the copied range (lo a multiple of kFold, bytes of 16): the
// wrapping sum of the segment's 32-bit words, from its buffer
// (a warp a segment, two 16-byte loads a lane, one warp reduction)
__device__ __forceinline__ void fold(unsigned* folds, const unsigned char* buf,
                                     long long lo, long long bytes) {
  constexpr int kVecs = kFold / 16;  // 16-byte words a segment
  static_assert(kVecs == 64, "two 16-byte loads a lane");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint4* v = reinterpret_cast<const uint4*>(buf);
  const int n = (int)(bytes / 16), segs = (int)((bytes + kFold - 1) / kFold);
  unsigned* dst = folds + lo / kFold;
  for (int s = warp; s < segs; s += kDmaThreads / 32) {
    const int i0 = s * kVecs + lane, i1 = i0 + 32;
    unsigned acc = 0;
    if (i0 < n) {
      const uint4 q = v[i0];
      acc = q.x + q.y + q.z + q.w;
    }
    if (i1 < n) {
      const uint4 q = v[i1];
      acc += q.x + q.y + q.z + q.w;
    }
    acc = __reduce_add_sync(0xffffffffu, acc);
    if (lane == 0) dst[s] = acc;
  }
}

__global__ void __launch_bounds__(kDmaThreads)
    one_shot_kernel(const unsigned char* __restrict__ src, float* __restrict__ out,
                    unsigned* __restrict__ folds, long long total, int chunk,
                    int WP, int bf16) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  unsigned char* buf = smem + kHeader;
  const long long lo = (long long)blockIdx.x * chunk;
  const long long bytes = total - lo < chunk ? total - lo : chunk;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    fence_mbar_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) bulk_load(buf, src + lo, (unsigned)bytes, bar);
  mbar_wait(bar, 0);
  store_row(out, buf, lo, bytes, WP, bf16);
  fold(folds, buf, lo, bytes);
}

template <bool kDbuf>
__global__ void __launch_bounds__(kDmaThreads)
    slabs_kernel(const unsigned char* __restrict__ src, float* __restrict__ out,
                 unsigned* __restrict__ folds, int tiles, long long stride,
                 long long slab, int share, int WP, int bf16) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  unsigned char* buf[2] = {smem + kHeader, smem + kHeader + share};
  const long long lo = (long long)blockIdx.x * share;
  const long long bytes = slab - lo < share ? slab - lo : share;
  if (threadIdx.x == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    fence_mbar_init();
  }
  __syncthreads();
  const unsigned char* part = src + lo;  // this block's share of slab 0
  const long long segs = (slab + kFold - 1) / kFold;  // folded words a slab
  if (kDbuf) {
    if (threadIdx.x == 0) bulk_load(buf[0], part, (unsigned)bytes, &bar[0]);
    for (int t = 0; t < tiles; ++t) {
      // buffer (t + 1) % 2 held slab t - 1, read before the last barrier
      if (threadIdx.x == 0 && t + 1 < tiles)
        bulk_load(buf[(t + 1) & 1], part + (t + 1) * stride, (unsigned)bytes,
                  &bar[(t + 1) & 1]);
      mbar_wait(&bar[t & 1], (t >> 1) & 1);
      store_row(out, buf[t & 1], lo, bytes, WP, bf16);
      fold(folds + t * segs, buf[t & 1], lo, bytes);
      __syncthreads();
    }
  } else {
    for (int t = 0; t < tiles; ++t) {
      if (threadIdx.x == 0)
        bulk_load(buf[0], part + t * stride, (unsigned)bytes, &bar[0]);
      mbar_wait(&bar[0], t & 1);
      store_row(out, buf[0], lo, bytes, WP, bf16);
      fold(folds + t * segs, buf[0], lo, bytes);
      __syncthreads();  // the buffer is free for slab t + 1
    }
  }
}

cudaError_t max_smem(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// src: `total` bytes (a multiple of 16, 16-byte aligned); out (WP,) float32:
// the source's first WP elements; folds (ceil(total / 1024),) u32.
extern "C" int fcvsr_mb_one_shot(const void* src, float* out, unsigned* folds,
                                 long long total, int WP, int bf16, void* stream) {
  if (total < 16 || total % 16 || !aligned16(src) || WP < 1 ||
      (long long)WP * (bf16 ? 2 : 4) > total)
    return (int)cudaErrorInvalidValue;
  int optin = 0;
  cudaError_t err = max_smem(&optin);
  if (err != cudaSuccess) return (int)err;
  long long chunk = ((long long)(optin - kHeader) / kFold) * kFold;
  if (chunk > kMaxTx / kFold * kFold) chunk = kMaxTx / kFold * kFold;
  if (chunk > total) chunk = total;
  const size_t smem = kHeader + (size_t)chunk;
  if ((err = allow_smem<one_shot_kernel>(smem)) != cudaSuccess) return (int)err;
  const long long blocks = (total + chunk - 1) / chunk;
  one_shot_kernel<<<(unsigned)blocks, kDmaThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const unsigned char*>(src), out, folds, total, (int)chunk, WP,
      bf16);
  return (int)cudaGetLastError();
}

// src (1, tiles * TH + 2, rows of `row` bytes, a multiple of 16); slab t is
// rows [t * TH, t * TH + TH + 2).  out (WP,) float32: the last slab's first
// WP elements; folds (tiles, ceil(slab bytes / 1024)) u32.  dbuf 0: serial,
// 1: double-buffered.
extern "C" int fcvsr_mb_slabs(const void* src, float* out, unsigned* folds,
                              int tiles, int TH, long long row, int WP, int bf16,
                              int dbuf, void* stream) {
  if (tiles < 1 || TH < 1 || row < 16 || row % 16 || !aligned16(src) || WP < 1 ||
      (long long)WP * (bf16 ? 2 : 4) > row * (TH + 2))
    return (int)cudaErrorInvalidValue;
  int optin = 0, sms = 0, dev = 0;
  cudaError_t err = max_smem(&optin);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return (int)err;
  const long long slab = row * (TH + 2);
  // one block an SM, each a kFold-byte multiple share; more blocks only
  // when two shares would not fit a block's shared memory
  long long share = ((slab + sms - 1) / sms + kFold - 1) / kFold * kFold;
  const long long cap = ((long long)(optin - kHeader) / 2 / kFold) * kFold;
  if (share > cap) share = cap;
  const size_t smem = kHeader + (size_t)(dbuf ? 2 : 1) * share;
  err = dbuf ? allow_smem<slabs_kernel<true>>(smem)
             : allow_smem<slabs_kernel<false>>(smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (slab + share - 1) / share;
  auto kernel = dbuf ? slabs_kernel<true> : slabs_kernel<false>;
  kernel<<<(unsigned)blocks, kDmaThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const unsigned char*>(src), out, folds, tiles, row * TH, slab,
      (int)share, WP, bf16);
  return (int)cudaGetLastError();
}
