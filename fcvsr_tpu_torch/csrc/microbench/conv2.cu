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
// traffic (0.0035 ms at HBM's rate).  But the probe stands for K2, where
// every tile's operand differs, so each tile streams its rhs again: 17 x
// 9.4 MB = 160 MB through the 50 MB L2, which holds the fixed rhs as the
// TPU held it in VMEM, and every block also reads w (147 KB).  What holds
// it on the H100 is each SM's intake of those bytes, about 45 GB/s (an SM
// takes its share in the same time whether 66 or 132 SMs run), so the
// time follows the SM with the most bytes (PERF.md §6).
//
// Design: Hopper's warpgroup MMA fed by TMA, one persistent block an SM
// (206 KB of shared memory), 320 threads: two consumer warpgroups, a
// producer warp and a bookkeeper warp.  M = C = 64 is one wgmma m64 tile.
// The consumers round w to bf16 once into A (74 KB, K-major, 128-byte
// swizzled, csrc/hopper.cuh), 12 loads in flight a thread, then take the
// block's units of work in turn (unit_of): a unit is rows r of tile t
// times 128 lanes (wgmma m64n128k16), or in the last round 64 lanes
// (m64n64k16), so that the busiest SM takes 8.5 items' bytes, not 9, at
// the real shape (1088 items on 132 SMs).  Each consumer has its own ring
// of 4 stages (64 k rows x 128 lanes, two TMA boxes of 64 x 64 through a
// tensor map over rhs as a (TH * 576, WP) array, 128-byte swizzled, so B
// is MN-major and read through the transpose bit: no ldmatrix) with a full
// and an empty mbarrier each, filled by its own producer lane; so the next
// unit's rows load while this one's last are multiplied, and while one
// warpgroup drains and sums a unit the other's wgmma keep the tensor cores
// busy.  A consumer keeps one wgmma group in flight (wait_group 1) and
// frees a stage once the group that read it has retired; a unit's first
// wgmma has scale-d 0, which clears the sums.  TMA fills lanes past WP
// with zeros, so a ragged chunk needs no masking; WP must be a multiple of
// 8 (TMA's 16-byte row stride; the wrapper raises on others).  Nothing is
// shared across tiles: each unit's stages are loaded for it, and each
// tile's product and checksum computed anew.
//
// mm_stream3 runs the same kernel: its one float32 accumulator takes the
// three 192-wide passes in turn.  A second accumulator for each pass's
// dot, added into the first at the pass's end as the TPU kernel adds, held
// the tolerance too but ran 1.1% to 1.4% slower (PERF.md §6).
//
// The epilogue: each unit's outputs are summed into a partial for each
// 64-lane half in a fixed order (a thread's 32 sums, a warp's shuffle
// tree, the four warps), the same bits whether the half came alone or in
// an item; the bookkeeper takes them through 2 hand-over slots, counts
// halves off on the tile's counter (each call zeroes them), and for the
// unit that completes a tile sums its partials in a fixed order into the
// checksum, so every tile's checksum is the same number, bit for bit; off
// the consumers, whose wgmma waits for all their threads.  Only the last tile writes `out`, from the wgmma
// accumulator layout (hopper.cuh gives each register's row and column).
//
// What had to be solved: the tensor map comes from cuTensorMapEncodeTiled,
// which lives in libcuda, fetched through the runtime's entry-point query
// (no link against libcuda), encoded per call from the pointer and WP and
// passed as a __grid_constant__ parameter; the descriptors' byte offsets
// (A: SBO 1024, the k16 slices 32 bytes apart; B: SBO 1024 between atoms
// of 8 k rows, LBO 8 KB between the two boxes; the odd-shape GPU tests cut
// a chunk and a tile short to catch a wrong one); 1024-byte aligned atoms
// in dynamic shared memory (aligned by hand); a proxy fence and a barrier
// between A's ordinary stores and wgmma's reads, and wgmma.fence before
// each stage's first wgmma; ptxas serialises wgmma under a branch on the
// thread's index, so the roles branch on a warp-uniform value, the
// mbarrier waits loop inside their asm and arrivals are predicated there;
// the accumulators are touched only after a drain and fenced as operands,
// so that no read moves before a wgmma wait; a ring shared by two
// consumers would let one pass a parity wait before the slot's previous
// load landed, so each has its own.
//
// im2col / dma_window.  Bound by bytes: the 35.9 MB float32 source read
// once (0.0107 ms at 3.35 TB/s; the outputs add 0.3 to 0.6 MB).  What a
// window of rows costs to stream into an SM is the question these probes
// answer for K2, so they are built as K2's stream should be: one
// persistent block an SM takes units of (source row, lane chunk), dealt in
// turn (block b: units b, b + grid, ...), so that no SM takes more than
// one unit above another (2,192 units of 64 lanes on 132 SMs: 17 at most,
// 16.6 on average).  A unit's C channels x L lanes arrive as one TMA box
// (a float32 tensor map over src as a (rows * C, WP) array, unswizzled;
// L 64 lanes for C <= 64, 16 KB, fewer for more channels) into a ring of
// 12 stages on full and empty mbarriers, kept full by one producer lane
// (which issues the first 12 before the block's barrier);
// four consumer warps take the units in turn (stage s is always warp s %
// 4's, so no warp waits on a stage's later phase before its earlier one
// completed), each reading its stage as float4 columns, summing the
// channels in float32 and handing the stage back.  Each source row is
// read once: the two rows that neighbouring tiles share come from the
// same sums.
//
// dma_window writes each unit's channel sums where its row lies in one
// tile's window or in two.  im2col is the same function as the channel
// sums of the bf16-rounded window taken through the 3x3 box, with lanes x
// + 1 and x + 2 past WP from lanes 0 and 1: the TPU built the (9C, WP)
// operand because its matrix unit takes one, but on Hopper K2 builds none
// either (its taps are descriptor offsets into the stored rows,
// csrc/conv_tc.cuh), so nothing here stands for the rolls and the concat.
// A box needs the sums of two more rows and lanes, which other units
// make: the sums go to a (rows, WP) float32 scratch (0.56 MB at the real
// shape, in L2), and after a grid barrier in the same cooperative launch
// every block takes output rows' float4 groups, nine L2 reads each.  (A
// unit holding three rows' sums would read the source three times; a
// second launch would cost as much as the barrier and a launch's gap.)
// TMA takes rows of WP x 4 bytes that are a multiple of 16 and a box of
// at most 256 elements a dimension: WP a multiple of 4 and C <= 256 (the
// wrapper raises on others).
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "../common.cuh"
#include "../hopper.cuh"

namespace {

using fcvsr::allow_smem;

// ---------------------------------------------------------------- helpers

using fcvsr::sm90::smem_u32;

cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// ------------------------------------------------------------- mm stream

namespace sm90 = fcvsr::sm90;

constexpr int kC = 64;                      // output channels: the wgmma M
constexpr int kK = 9 * kC;                  // 576
constexpr int kNC = 128;                    // output lanes an item: the wgmma N
constexpr int kKC = 64;                     // rhs rows a stage: one k block
constexpr int kChunks = kK / kKC;           // 9 stages a unit of work
constexpr int kBox = 64;                    // lanes a TMA box: one 128-byte row
constexpr int kStages = 4;                  // a consumer's ring of stages
constexpr int kConsumers = 2;               // warpgroups, on alternate units
constexpr int kSlots = kConsumers * kStages;
constexpr int kABlock = kC * 128;           // bytes of A a 64-wide k block: 8 KB
constexpr int kABytes = kChunks * kABlock;  // 73,728
constexpr int kBoxBytes = kKC * kBox * 2;   // 8 KB
constexpr int kStageBytes = 2 * kBoxBytes;  // an item's two boxes, LBO apart
constexpr int kHand = 2;                    // units' sums in the bookkeeper's hands
constexpr int kProducer = 4 * kConsumers;   // warps: the consumers', then these
constexpr int kBookkeeper = kProducer + 1;
constexpr int kMmThreads = 32 * (kBookkeeper + 1);
constexpr size_t kMmSmem = 1024 /* to align */ + kABytes +
                           (size_t)kSlots * kStageBytes +
                           (2 * kSlots + 2 * kHand) * sizeof(uint64_t) +
                           kHand * 2 * 4 * sizeof(float);

static_assert(kHand % kConsumers == 0, "a hand-over slot serves one consumer");
static_assert(kNC == 2 * kBox, "an item is two halves of a box each");
static_assert(kKC == 64, "a stage is one k block of A");
static_assert(kC * kK / 4 % (128 * kConsumers) == 0, "a uniform trip count");

// A unit of work: rows r of tile t, lanes 128 c + 64 h0 on, `halves` 64-lane
// halves of them (2: a whole item, 1: a half).  Each block takes the items
// of the whole rounds in turn (block b: items b, b + nblk, ...), then the
// halves of the rest (halves b, b + nblk, ... of the last items), so that
// no block has a whole item more than another.
struct Unit {
  int t, r, c, h0, halves;
};

__device__ __forceinline__ Unit unit_of(int u, int blk, int nblk, int per_tile,
                                        int nch, int items) {
  const int rounds = items / nblk;
  int item, h0 = 0, halves = 2;
  if (u < rounds) {
    item = blk + u * nblk;
  } else {
    const int half = blk + (u - rounds) * nblk;
    item = rounds * nblk + half / 2;
    h0 = half % 2;
    halves = 1;
  }
  const int p = item % per_tile;
  return {item / per_tile, p / nch, p % nch, h0, halves};
}

__global__ void __launch_bounds__(kMmThreads, 1)
    mm_stream_kernel(const __grid_constant__ CUtensorMap rhs_map,
                     const float* __restrict__ w, float* __restrict__ out,
                     float* __restrict__ checksums, float* partials,
                     unsigned* counters, int TH, int WP, int tiles) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzled tiles need 1024-byte aligned atoms
  unsigned char* as =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);  // A: bf16(w)
  unsigned char* bs = as + kABytes;  // the consumers' rings of rhs stages
  uint64_t* full = reinterpret_cast<uint64_t*>(bs + kSlots * kStageBytes);
  uint64_t* empty = full + kSlots;
  uint64_t* sums_full = empty + kSlots;  // a unit's warp sums, handed over
  uint64_t* sums_empty = sums_full + kHand;
  float* red = reinterpret_cast<float*>(sums_empty + kHand);  // kHand x 2 halves x 4

  // the warp's role from a value the compiler knows to be warp-uniform
  // (read from lane 0): a role branch on threadIdx would be a divergent
  // path, and ptxas serialises wgmma inside one
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int blk = (int)blockIdx.x, nblk = (int)gridDim.x;
  const int nch = (WP + kNC - 1) / kNC;
  const int per_tile = TH * nch;  // items a tile, each with 2 partials
  const int items = tiles * per_tile;
  const int tail = 2 * (items % nblk);  // the halves of the last items
  const int mine = items / nblk + (tail - blk + nblk - 1) / nblk;  // units
  // Consumer g takes the block's units g, g + kConsumers, ...; their stages
  // form one stream through the consumer's own ring, so the next unit's
  // stages load while this unit's last are multiplied and its epilogue
  // runs.  A ring's slots are used in order, each use's wait on the phase
  // after the one before it completed (a ring shared by two consumers
  // would let one wait on a phase parity that reads as complete before the
  // slot's previous load has landed); so are the hand-over slots.

  if (tid == 0) {
    for (int s = 0; s < kSlots; ++s) {
      sm90::mbar_init(&full[s], 1);   // the producer's arrival and the bytes
      sm90::mbar_init(&empty[s], 4);  // one arrival a warp of the consumer
    }
    for (int b = 0; b < kHand; ++b) {
      sm90::mbar_init(&sums_full[b], 4);
      sm90::mbar_init(&sums_empty[b], 1);
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  if (warp == kProducer) {  // lane g starts every load of consumer g's ring
    if (lane < kConsumers) {
      const int g = lane, n = (mine - g + kConsumers - 1) / kConsumers;
      for (int q = 0; q < n * kChunks; ++q) {
        const int s = g * kStages + q % kStages, use = q / kStages;
        if (use > 0) sm90::mbar_wait(&empty[s], (use - 1) & 1);
        const Unit u = unit_of(g + (q / kChunks) * kConsumers, blk, nblk,
                               per_tile, nch, items);
        const int x = u.c * kNC + u.h0 * kBox;
        const int y = u.r * kK + (q % kChunks) * kKC;
        unsigned char* st = bs + s * kStageBytes;
        sm90::mbar_expect_tx(&full[s], u.halves * kBoxBytes);
        sm90::tma_load_2d(st, &rhs_map, x, y, &full[s]);
        if (u.halves == 2)
          sm90::tma_load_2d(st + kBoxBytes, &rhs_map, x + kBox, y, &full[s]);
      }
    }
    return;
  }

  if (warp == kBookkeeper) {
    // each unit's partials (one a half) from its four warp sums, in a fixed
    // order, and, for the unit that completes a tile, the tile's checksum
    // from its 2 * per_tile partials in a fixed order (a lane every 32nd,
    // then a shuffle tree), counting off halves on the tile's counter; off
    // the consumers, whose wgmma waits for all their threads
    for (int i = 0; i < mine; ++i) {
      const int b = i % kHand;
      const Unit u = unit_of(i, blk, nblk, per_tile, nch, items);
      sm90::mbar_wait(&sums_full[b], (i / kHand) & 1);
      unsigned last = 0;
      if (lane == 0) {
        float* part = partials + ((size_t)u.t * per_tile + u.r * nch + u.c) * 2;
        for (int h = 0; h < u.halves; ++h) {
          float v = 0.f;
          for (int j = 0; j < 4; ++j) v += red[(b * 2 + h) * 4 + j];
          part[u.h0 + h] = v;
        }
        __threadfence();
        last = atomicAdd(&counters[u.t], (unsigned)u.halves) + u.halves ==
               2u * per_tile;
      }
      sm90::mbar_arrive(&sums_empty[b], lane == 0);
      if (!__shfl_sync(0xffffffffu, last, 0)) continue;
      __threadfence();  // every lane reads what the other blocks released
      // on the critical path for the last tile: unrolled, so that the
      // loads go out together
      float sum = 0.f;
#pragma unroll 4
      for (int j = lane; j < 2 * per_tile; j += 32)
        sum += __ldcg(&partials[(size_t)u.t * 2 * per_tile + j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        checksums[u.t] = sum;
        counters[u.t] = 0u;  // back to 0 for the next call
      }
    }
    return;
  }

  // the consumers.  w rounded to bf16 once, four values a load, into A's
  // K-major swizzled layout: k block k / 64, row m, 16-byte chunk (k % 64)
  // / 8 stored at chunk ((k % 64) / 8) ^ (m % 8); kWBatch loads in flight a
  // thread (one at a time, each waiting on the store before it, took a
  // round trip to L2 each while the rings sat full)
  constexpr int kWLoads = kC * kK / 4 / (128 * kConsumers);  // 36 a thread
  constexpr int kWBatch = 12;
  static_assert(kWLoads % kWBatch == 0, "whole batches");
  for (int j0 = 0; j0 < kWLoads; j0 += kWBatch) {
    float4 v[kWBatch];
#pragma unroll
    for (int j = 0; j < kWBatch; ++j)
      v[j] = reinterpret_cast<const float4*>(w)[tid + 128 * kConsumers * (j0 + j)];
#pragma unroll
    for (int j = 0; j < kWBatch; ++j) {
      const int i = tid + 128 * kConsumers * (j0 + j);
      const int m = i / (kK / 4), k = (i % (kK / 4)) * 4;
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v[j].x, v[j].y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v[j].z, v[j].w);
      uint2 u;
      u.x = *reinterpret_cast<const uint32_t*>(&lo);
      u.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(as + (k / 64) * kABlock + m * 128 +
                                ((((k % 64) / 8) ^ (m & 7)) << 4) + (k % 8) * 2) = u;
    }
  }
  sm90::fence_proxy_async();  // the stores before the wgmma reads of A
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kConsumers) : "memory");

  // While one warpgroup drains and sums a unit, the other's wgmma keep the
  // tensor cores busy.  The accumulators are touched outside wgmma only
  // after a full drain (wait_group 0) and are fenced there as operands on
  // both sides, so that the compiler moves no access into a span where a
  // group is in flight.  One accumulator takes all 576 k, mm_stream3's
  // three passes too (the note above says why).
  const int wg = warp / 4, wl = warp % 4;
  constexpr int kAcc = kNC / 2;  // accumulator registers a thread
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  for (int i = wg; i < mine; i += kConsumers) {
    const Unit u = unit_of(i, blk, nblk, per_tile, nch, items);
    for (int c = 0; c < kChunks; ++c) {
      const int q = (i / kConsumers) * kChunks + c;  // in the ring's stream
      const int s = wg * kStages + q % kStages;
      sm90::mbar_wait(&full[s], (q / kStages) & 1);
      const unsigned char* st = bs + s * kStageBytes;
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKC / 16; ++kk) {
        // A: the k16 slice 32 bytes on in its k block; B: 16 rhs rows, two
        // swizzle atoms of 8 rows, 2048 bytes on; its boxes LBO apart.  The
        // unit's first product clears the sums (scale-d 0)
        const uint64_t da = sm90::desc_sw128(as + c * kABlock + kk * 32, 16, 1024);
        const uint64_t db = sm90::desc_sw128(st + kk * 2048, kBoxBytes, 1024);
        if (u.halves == 2)
          sm90::wgmma_m64k16_bf16<kNC>(acc, da, db, c > 0 || kk > 0);
        else
          sm90::wgmma_m64k16_bf16<kBox>(acc, da, db, c > 0 || kk > 0);
      }
      sm90::wgmma_commit();
      // the stage before this one: its group is done once one is in flight
      const int prev = wg * kStages + (q + kStages - 1) % kStages;
      if (c + 1 < kChunks) {
        sm90::wgmma_wait<1>();
        if (c > 0) sm90::mbar_arrive(&empty[prev], lane == 0);
        continue;
      }
      sm90::wgmma_wait<0>();  // the sums are needed: drain
      sm90::mbar_arrive(&empty[prev], lane == 0);
      sm90::mbar_arrive(&empty[s], lane == 0);
      sm90::fence_operand(acc);
    }

    // the unit is done: each half's outputs summed in a fixed order (a
    // thread's 32, a warp's shuffle tree; lanes past WP multiplied TMA's
    // zeros), the same whether the half came as a unit or in an item, and
    // handed to the bookkeeper; the output block from the last tile
    const int b = i % kHand;
    float sums[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = 0.f;
#pragma unroll
      for (int j = 0; j < kAcc / 2; ++j) v += acc[h * kAcc / 2 + j];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      sums[h] = v;
    }
    if (i >= kHand) sm90::mbar_wait(&sums_empty[b], (i / kHand - 1) & 1);
    if (lane == 0) {
      red[(b * 2) * 4 + wl] = sums[0];
      red[(b * 2 + 1) * 4 + wl] = sums[1];
    }
    sm90::mbar_arrive(&sums_full[b], lane == 0);
    if (u.t == tiles - 1) {
      // d[4 j + 2 h + e]: row 16 wl + lane / 4 + 8 h, column 8 j + 2 (lane
      // % 4) + e; WP is a multiple of 8, so a pair is in or out whole
      const int n0 = u.c * kNC + u.h0 * kBox;
#pragma unroll
      for (int j = 0; j < kNC / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = 16 * wl + (lane >> 2) + 8 * h;
          const int n = n0 + 8 * j + 2 * (lane & 3);
          if (j < 8 * u.halves && n < WP)
            *reinterpret_cast<float2*>(&out[((size_t)u.r * kC + m) * WP + n]) =
                make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
    }
    sm90::fence_operand(acc);
  }
}

// --------------------------------------------------------- window probes

constexpr int kWinConsumers = 4;  // warps that sum: a unit each, in turn
constexpr int kWinStages = 12;    // the ring, 3 stages a consumer
constexpr int kWinThreads = 32 * (kWinConsumers + 1);
constexpr int kWinMaxC = 256;     // a TMA box's rows: the channels

static_assert(kWinStages % kWinConsumers == 0, "a stage serves one consumer");

// lanes a unit: a stage of at most 16 KB (C x L floats), L a power of two
// that a warp covers as L / 4 float4 columns
int window_lanes(int C) { return C <= 64 ? 64 : C <= 128 ? 32 : 16; }

__host__ __device__ inline int window_stage_bytes(int C, int L) {
  return (C * L * 4 + 127) / 128 * 128;
}

size_t window_smem(int C, int L) {
  return 128 /* to align */ + (size_t)kWinStages * window_stage_bytes(C, L) +
         2 * kWinStages * sizeof(uint64_t);
}

__device__ __forceinline__ float4 bf16_rounded(float4 v) {
  const auto r = [](float f) { return __bfloat162float(__float2bfloat16_rn(f)); };
  return make_float4(r(v.x), r(v.y), r(v.z), r(v.w));
}

__device__ __forceinline__ void add4(float4& a, float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// o[i, x] = sum over dy, dx < 3 of s[i + dy, (x + dx) mod WP], i < tiles
// TH, from the (tiles * TH + 2, WP) sums: a float4 group of lanes a
// thread of the grid, the next group's first two lanes (group 0's past the
// row's end) for x + 1 and x + 2; the sums read through L2, where the
// other blocks wrote them
__device__ __forceinline__ void window_box(float* __restrict__ out, const float* sums,
                                           int TH, int WP, int tiles) {
  const int q4 = WP / 4;
  const long long n = (long long)tiles * TH * q4;
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x; q < n;
       q += (long long)gridDim.x * blockDim.x) {
    const int i = (int)(q / q4), x = (int)(q % q4) * 4;
    const int xn = x + 4 == WP ? 0 : x + 4;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const float* r = sums + (size_t)(i + dy) * WP;
      const float4 a = __ldcg(reinterpret_cast<const float4*>(r + x));
      const float2 b = __ldcg(reinterpret_cast<const float2*>(r + xn));
      o.x += a.x + a.y + a.z;
      o.y += a.y + a.z + a.w;
      o.z += a.z + a.w + b.x;
      o.w += a.w + b.x + b.y;
    }
    *reinterpret_cast<float4*>(out + (size_t)i * WP + x) = o;
  }
}

// src (1, tiles * TH + 2, C, WP) as the map's (rows * C, WP) array.
// kBuild: sums (rows, WP) scratch, out (tiles * TH, WP); else out (tiles,
// TH + 2, WP).  One block an SM; kBuild launches cooperatively.
template <bool kBuild, int L>
__global__ void __launch_bounds__(kWinThreads, 1)
    window_kernel(const __grid_constant__ CUtensorMap src_map, float* __restrict__ out,
                  float* sums, int TH, int C, int WP, int tiles) {
  constexpr int kCols = L / 4, kParts = 32 / kCols;  // a warp over a stage
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  const int stage = window_stage_bytes(C, L);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kWinStages * stage);
  uint64_t* empty = full + kWinStages;
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int blk = (int)blockIdx.x, nblk = (int)gridDim.x;
  const int rows = tiles * TH + 2, nch = (WP + L - 1) / L;
  const int units = rows * nch;
  const int mine = (units - blk + nblk - 1) / nblk;  // units blk, blk + nblk, ...

  // the producer lane: the barriers, the first kWinStages loads before the
  // block's barrier (which makes the barriers' initialisation visible to
  // the consumers), then each later one as its stage is handed back
  const bool producer = warp == kWinConsumers && lane == 0;
  const auto load = [&](int i) {
    const int s = i % kWinStages, u = blk + i * nblk;
    if (i >= kWinStages) sm90::mbar_wait(&empty[s], (i / kWinStages - 1) & 1);
    sm90::mbar_expect_tx(&full[s], C * L * 4);
    sm90::tma_load_2d(ring + s * stage, &src_map, (u % nch) * L, (u / nch) * C,
                      &full[s]);
  };
  int i0 = 0;
  if (producer) {
    for (int s = 0; s < kWinStages; ++s) {
      sm90::mbar_init(&full[s], 1);   // the producer's arrival and the bytes
      sm90::mbar_init(&empty[s], 1);  // the consumer warp's lane 0
    }
    sm90::fence_mbar_init();
    for (; i0 < mine && i0 < kWinStages; ++i0) load(i0);
  }
  __syncthreads();

  if (warp == kWinConsumers) {  // the producer lane keeps the ring full
    if (producer)
      for (int i = i0; i < mine; ++i) load(i);
  } else {
    // consumer `warp` takes the block's units warp, warp + 4, ...: lane
    // (col, part) sums float4 column col of channels part, part + kParts,
    // ..., then the parts meet by shuffles
    const int col = lane % kCols, part = lane / kCols;
    for (int i = warp; i < mine; i += kWinConsumers) {
      const int s = i % kWinStages, u = blk + i * nblk;
      sm90::mbar_wait(&full[s], (i / kWinStages) & 1);
      const float4* st = reinterpret_cast<const float4*>(ring + s * stage);
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int c = part; c < C; c += kParts) {
        const float4 v = st[c * kCols + col];
        add4(acc, kBuild ? bf16_rounded(v) : v);
      }
      __syncwarp();
      sm90::mbar_arrive(&empty[s], lane == 0);  // the stage is read
#pragma unroll
      for (int o = kCols; o < 32; o <<= 1) {
        acc.x += __shfl_xor_sync(0xffffffffu, acc.x, o);
        acc.y += __shfl_xor_sync(0xffffffffu, acc.y, o);
        acc.z += __shfl_xor_sync(0xffffffffu, acc.z, o);
        acc.w += __shfl_xor_sync(0xffffffffu, acc.w, o);
      }
      const int row = u / nch, x = (u % nch) * L + 4 * col;
      if (part != 0 || x >= WP) continue;  // WP % 4 == 0: a float4 is in or out
      if (kBuild) {
        __stcg(reinterpret_cast<float4*>(sums + (size_t)row * WP + x), acc);
      } else {
        // the tiles whose window holds the row: t TH <= row < t TH + TH + 2
        for (int t = min(row / TH, tiles - 1); t >= 0 && row - t * TH < TH + 2; --t)
          *reinterpret_cast<float4*>(out + ((size_t)t * (TH + 2) + row - t * TH) * WP +
                                     x) = acc;
      }
    }
  }
  if constexpr (kBuild) {
    cooperative_groups::this_grid().sync();  // every row's sums, in L2
    window_box(out, sums, TH, WP, tiles);
  }
}

template <bool kBuild, int L>
cudaError_t launch_window(const CUtensorMap& map, float* out, float* sums, int TH,
                          int C, int WP, int tiles, cudaStream_t stream) {
  const auto kernel = window_kernel<kBuild, L>;
  const size_t smem = window_smem(C, L);
  cudaError_t err = allow_smem<window_kernel<kBuild, L>>(smem);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  if ((err = sm_count(&sms)) != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWinThreads,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // one block an SM, no more than the units
  const long long units = (long long)(tiles * TH + 2) * ((WP + L - 1) / L);
  int grid = (int)(units < sms ? units : sms);
  if (!kBuild) {
    kernel<<<grid, kWinThreads, smem, stream>>>(map, out, sums, TH, C, WP, tiles);
    return cudaGetLastError();
  }
  void* args[] = {const_cast<CUtensorMap*>(&map), &out, &sums, &TH, &C, &WP, &tiles};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                    dim3(kWinThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool kBuild>
cudaError_t window_dispatch(const CUtensorMap& map, float* out, float* sums, int TH,
                            int C, int WP, int tiles, cudaStream_t stream) {
  switch (window_lanes(C)) {
    case 64:
      return launch_window<kBuild, 64>(map, out, sums, TH, C, WP, tiles, stream);
    case 32:
      return launch_window<kBuild, 32>(map, out, sums, TH, C, WP, tiles, stream);
    default:
      return launch_window<kBuild, 16>(map, out, sums, TH, C, WP, tiles, stream);
  }
}

}  // namespace

// rhs (TH, 576, WP) bf16 (16-byte aligned, WP a multiple of 8: TMA's row
// stride), w (64, 576) f32 (16-byte aligned); out (TH, 64, WP) f32 (the
// last tile's), checksums (tiles,); partials (tiles * TH * ceil(WP / 128) *
// 2) f32 scratch; counters (tiles,) u32, zero on entry and left zero.
extern "C" int fcvsr_mb_mm_stream(const void* rhs, const float* w, float* out,
                                  float* checksums, float* partials,
                                  unsigned* counters, int TH, int WP, int tiles,
                                  void* stream) {
  if (TH < 1 || WP < 8 || WP % 8 || tiles < 1 ||
      reinterpret_cast<uintptr_t>(w) % 16 || reinterpret_cast<uintptr_t>(rhs) % 16)
    return (int)cudaErrorInvalidValue;
  // rhs as a 2-D (TH * 576, WP) array, boxes of 64 rows x 64 lanes; a map
  // holds the pointer, so each call encodes its own
  CUtensorMap map;
  cudaError_t err = sm90::encode_bf16_2d(&map, rhs, (uint64_t)TH * kK, WP, kKC, kBox);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem<mm_stream_kernel>(kMmSmem);
  if (err != cudaSuccess) return (int)err;
  // persistent blocks, one an SM (its shared memory allows no second), no
  // more than the work items
  int sms = 0, per_sm = 0;
  if ((err = sm_count(&sms)) != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mm_stream_kernel,
                                                      kMmThreads, kMmSmem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // (as many as there are halves of items, so that a block has some work)
  const long long halves = 2LL * tiles * TH * ((WP + kNC - 1) / kNC);
  const long long slots = (long long)sms * per_sm;
  const int grid = (int)(halves < slots ? halves : slots);
  mm_stream_kernel<<<grid, kMmThreads, kMmSmem, (cudaStream_t)stream>>>(
      map, w, out, checksums, partials, counters, TH, WP, tiles);
  return (int)cudaGetLastError();
}

// src (1, tiles * TH + 2, C, WP) f32, 16-byte aligned, WP a multiple of
// 4 and C <= 256 (TMA's row stride and box).  build 1: im2col, out
// (tiles, TH, WP), sums a (tiles * TH + 2, WP) f32 scratch; build 0: the
// window's channel sums, out (tiles, TH + 2, WP), sums unused.
extern "C" int fcvsr_mb_window(const float* src, float* out, float* sums, int TH,
                               int C, int WP, int tiles, int build, void* stream) {
  if (TH < 1 || C < 1 || C > kWinMaxC || WP < 4 || WP % 4 || tiles < 1 ||
      reinterpret_cast<uintptr_t>(src) % 16 || reinterpret_cast<uintptr_t>(out) % 16 ||
      (build && (sums == nullptr || reinterpret_cast<uintptr_t>(sums) % 16)))
    return (int)cudaErrorInvalidValue;
  // a map holds the pointer, so each call encodes its own
  CUtensorMap map;
  cudaError_t err = sm90::encode_f32_2d(&map, src, (uint64_t)(tiles * TH + 2) * C, WP,
                                        C, window_lanes(C));
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(build ? window_dispatch<true>(map, out, sums, TH, C, WP, tiles, s)
                     : window_dispatch<false>(map, out, sums, TH, C, WP, tiles, s));
}

extern "C" const char* fcvsr_mb_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
