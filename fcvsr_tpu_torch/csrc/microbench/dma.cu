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
// producer lane a block; the copy engine computes no addresses in the SM's
// threads.  A bulk copy needs 16-byte aligned addresses and a size that is
// a multiple of 16, and one mbarrier phase takes at most 2^20 - 1 bytes.
//
// One persistent block an SM, so that no SM idles and none runs a second
// wave.  Each range (the source, or a slab) is dealt in whole segments,
// block b taking a share of S / G segments of its S (one more for the
// first S % G blocks): a slab of 2,304 KB is 17 or 18 KB on 132 SMs.  A
// block cuts its share of each range into copies that land in a ring of
// `nbuf` buffers, each with a full mbarrier (the producer's arrival and
// the bytes) and an empty one (one arrival from each folding warp).  The
// producer lane issues the first copies before the block's barrier, and
// copy j into buffer j % nbuf as soon as the warps have folded copy j -
// nbuf there.  No block-wide barrier runs a step.  The plans:
//   one_shot   the share (266 KB in float32, 133 KB in bf16) in the fewest
//              copies that two buffers hold two of, at least two: a bf16
//              share's 2 copies of 66-67 KB issued at once; a float32
//              one's 3 of 88-89 KB through 2 buffers, the third issued as
//              the first is folded ("as far as shared memory allows");
//   serial     a copy a slab, one buffer: one copy in flight a block;
//   dbuf       the same in two buffers: slab t + 1's copy in flight while
//              slab t's is folded.
// Few large copies an SM stream faster than many small ones: PR 13's
// single 136-226 KB copy a block drew 21-31 GB/s an SM at the margin,
// rings of 16 KB copies 15-19 (PERF.md §6, PR 14).  A warp
// folds a segment (two 16-byte loads a lane, one warp reduction) and
// writes its word: no atomics, and the output needs no zeroing.  The
// folding warps are as many as a slab share's segments (18 in float32, 9
// in bf16), so that a serial step's fold is one segment's; 31 for the
// one-shot copies.  The warp that folds a segment of the last range also
// writes the row's elements that lie in it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "../common.cuh"
#include "../hopper.cuh"

namespace {

using fcvsr::allow_smem;
namespace sm90 = fcvsr::sm90;

constexpr int kHeader = 256;        // bytes before the buffers: the mbarriers
constexpr int kMaxBufs = kHeader / 16;  // a full and an empty mbarrier each
constexpr long long kMaxTx = (1 << 20) - 1;
constexpr int kFold = 1024;         // bytes a folded word
constexpr int kMaxFolders = 31;     // warps: 1024 threads with the producer

// the one thread's bulk copy of `bytes` into `dst`, completing on `bar`
// (whose phase it arrives on, expecting the bytes)
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  sm90::mbar_expect_tx(bar, bytes);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(sm90::smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(sm90::smem_u32(bar))
      : "memory");
}

// the wrapping sum of the 32-bit words of a segment's `bytes` (a multiple
// of 16, at most kFold) at p, in every lane of the warp
__device__ __forceinline__ unsigned fold_segment(const unsigned char* p, int bytes,
                                                 int lane) {
  static_assert(kFold / 16 == 64, "two 16-byte loads a lane");
  const uint4* v = reinterpret_cast<const uint4*>(p);
  const int n = bytes / 16;
  unsigned acc = 0;
  if (lane < n) {
    const uint4 q = v[lane];
    acc = q.x + q.y + q.z + q.w;
  }
  if (lane + 32 < n) {
    const uint4 q = v[lane + 32];
    acc += q.x + q.y + q.z + q.w;
  }
  return __reduce_add_sync(0xffffffffu, acc);
}

// `ranges` ranges of `range` bytes, `stride` bytes apart in src.  Each
// range's S segments are cut into grid * cuts pieces, `base` segments each
// and one more in the first `extra`, and block b copies pieces b cuts to
// b cuts + cuts - 1 of every range (its share); copy j lands in buffer j %
// nbuf.  folds (ranges, S); out (WP,) the last range's first WP elements
// (bf16 or float32 in the source), as float32.  Threads: 32 a folding
// warp, then the producer's warp.  A block's walk over its copies takes no
// division.
struct Cursor {
  int r = 0, c = 0, p, cuts, extra;
  long long base;

  __device__ Cursor(long long base_, int extra_, int cuts_)
      : p((int)blockIdx.x * cuts_), cuts(cuts_), extra(extra_), base(base_) {}
  __device__ void next() {
    ++p;
    if (++c == cuts) {
      c = 0;
      p -= cuts;
      ++r;
    }
  }
  __device__ long long s0() const { return p * base + min(p, extra); }
  __device__ int nseg() const { return (int)base + (p < extra); }
};

__global__ void __launch_bounds__(1024)
    copy_kernel(const unsigned char* __restrict__ src, float* __restrict__ out,
                unsigned* __restrict__ folds, int ranges, long long stride,
                long long range, long long base, int extra, int cuts, int piece,
                int nbuf, int WP, int bf16) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + nbuf;
  unsigned char* bufs = smem + kHeader;
  const int lane = threadIdx.x & 31;
  const int warp = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 5, 0);
  const int folders = (int)blockDim.x / 32 - 1;
  const long long segs = (range + kFold - 1) / kFold;
  const int n = ranges * cuts;  // copies
  Cursor pc(base, extra, cuts);

  // the producer lane: the barriers, then the first nbuf copies before the
  // block's barrier (which makes the barriers' initialisation visible to
  // the folding warps), then each later copy as its buffer is folded
  const bool producer = warp == folders && lane == 0;
  const auto issue = [&](int j) {
    const int b = j % nbuf;
    const long long b0 = pc.s0() * kFold;
    const long long b1 = b0 + (long long)pc.nseg() * kFold;
    if (j >= nbuf) sm90::mbar_wait(&empty[b], (j / nbuf - 1) & 1);
    bulk_load(bufs + (size_t)b * piece * kFold, src + pc.r * stride + b0,
              (unsigned)((b1 < range ? b1 : range) - b0), &full[b]);
  };
  int j0 = 0;
  if (producer) {
    for (int b = 0; b < nbuf; ++b) {
      sm90::mbar_init(&full[b], 1);
      sm90::mbar_init(&empty[b], folders);
    }
    sm90::fence_mbar_init();
    for (; j0 < n && j0 < nbuf; ++j0, pc.next()) issue(j0);
  }
  __syncthreads();
  if (warp == folders) {
    if (producer)
      for (int j = j0; j < n; ++j, pc.next()) issue(j);
    return;
  }

  const int es = bf16 ? 2 : 4;
  for (int j = 0; j < n; ++j, pc.next()) {
    const int b = j % nbuf;
    const long long s0 = pc.s0();
    const int nseg = pc.nseg();
    const unsigned char* buf = bufs + (size_t)b * piece * kFold;
    sm90::mbar_wait(&full[b], (j / nbuf) & 1);
    for (int g = warp; g < nseg; g += folders) {
      const long long at = (s0 + g) * kFold;  // the segment's first byte
      const int bytes = (int)(range - at < kFold ? range - at : kFold);
      const unsigned word = fold_segment(buf + g * kFold, bytes, lane);
      if (lane == 0) folds[pc.r * segs + s0 + g] = word;
      if (pc.r == ranges - 1 && at < (long long)WP * es) {
        const int e0 = (int)at / es, e1 = min(WP, ((int)at + bytes) / es);
        const unsigned char* seg = buf + g * kFold;
        for (int e = e0 + lane; e < e1; e += 32)
          out[e] = bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(
                              seg)[e - e0])
                        : reinterpret_cast<const float*>(seg)[e - e0];
      }
    }
    __syncwarp();
    sm90::mbar_arrive(&empty[b], lane == 0);  // the warp is done with buffer b
  }
}

cudaError_t device_ints(int* optin, int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// each range cut into grid * cuts pieces, `cuts` a block, through `nbuf`
// buffers a block
cudaError_t launch_copy(const void* src, float* out, unsigned* folds, int ranges,
                        long long stride, long long range, int grid, int cuts,
                        int nbuf, int folders, int WP, int bf16, cudaStream_t stream) {
  const long long segs = (range + kFold - 1) / kFold;
  const long long pieces = (long long)grid * cuts;
  const int piece = (int)((segs + pieces - 1) / pieces);  // segments at most
  const size_t smem = kHeader + (size_t)nbuf * piece * kFold;
  cudaError_t err = allow_smem<copy_kernel>(smem);
  if (err != cudaSuccess) return err;
  copy_kernel<<<grid, 32 * (folders + 1), smem, stream>>>(
      static_cast<const unsigned char*>(src), out, folds, ranges, stride, range,
      segs / pieces, (int)(segs % pieces), cuts, piece, nbuf, WP, bf16);
  return cudaGetLastError();
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
  int optin = 0, sms = 0;
  cudaError_t err = device_ints(&optin, &sms);
  if (err != cudaSuccess) return (int)err;
  // a block an SM (no more than the segments), its share in the fewest
  // copies of near-equal sizes that two buffers hold two of, and at least
  // two where each gets a segment, so that the first one's fold overlaps
  // the second one's landing (one copy of a bf16 share ran 5% slower)
  const long long segs = (total + kFold - 1) / kFold;
  const int grid = (int)(segs < sms ? segs : sms);
  const int share = (int)((segs + grid - 1) / grid);
  const int cap = (optin - kHeader) / kFold;  // segments the buffers hold
  int cuts = segs >= 2LL * grid ? 2 : 1;
  while (2 * ((share + cuts - 1) / cuts) > cap) ++cuts;
  const int fit = cap / ((share + cuts - 1) / cuts);
  const int nbuf = min(min(cuts, fit), kMaxBufs);
  return (int)launch_copy(src, out, folds, 1, 0, total, grid, cuts, nbuf,
                          kMaxFolders, WP, bf16, (cudaStream_t)stream);
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
  int optin = 0, sms = 0;
  cudaError_t err = device_ints(&optin, &sms);
  if (err != cudaSuccess) return (int)err;
  const long long slab = row * (TH + 2);
  const long long segs = (slab + kFold - 1) / kFold;
  const int nbuf = dbuf ? 2 : 1;
  // a block an SM, each a share of whole segments; more blocks only where
  // a share would not fit nbuf buffers or one copy's bytes
  long long cap = (optin - kHeader) / nbuf / kFold;
  if (cap > kMaxTx / kFold) cap = kMaxTx / kFold;
  long long grid = segs < sms ? segs : sms;
  if ((segs + grid - 1) / grid > cap) grid = (segs + cap - 1) / cap;
  // a copy a block a slab: its share
  const int piece = (int)((segs + grid - 1) / grid);
  const int folders = piece < kMaxFolders ? piece : kMaxFolders;
  return (int)launch_copy(src, out, folds, tiles, row * TH, slab, (int)grid, 1, nbuf,
                          folders, WP, bf16, (cudaStream_t)stream);
}
