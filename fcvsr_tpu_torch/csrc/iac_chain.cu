// The whole IAC chain in one launch (K4): ac_num exact IAC iterations,
//
//   cur_0 = feat_in;  cur_{i+1} = act_i(SAC_k1,k1(warp(cur_i, flow_i)) + feat_in)
//
// with act_i the leaky relu (0.1) for every iteration but the last, whose
// activation act_last decides.  Replaces the TPU kernel
// fcvsr_tpu/ops/pallas_iac.py::_chain_kernel (iac_fused_resident), which
// keeps the map in VMEM and lets the TPU's sequential grid order the
// iterations.
//
// Bound on the H100: bytes.  The chain reads feat_in once, the kernels
// (3C values a pixel and iteration, the largest stream) and the flows once,
// and writes the output once: 5.2 KB a pixel at C=64 and 6 iterations in
// float, half that for the maps in bf16.  The per-iteration chain (K1, one
// launch an iteration) also writes and reads the whole map between
// iterations.  Here the map an iteration reads was written just before it
// and mostly sits in the 50 MB L2 (a bf16 272x480x64 map is 16.7 MB, a
// float one 33.4 MB), and the launch boundaries are gone.
//
// The design.  The launch is persistent and cooperative, so that its
// blocks are co-resident, which the waits below need: the grid is as large
// as the card holds co-resident (the occupancy query times the SM count,
// never the tile count), and each block runs K1's tile body
// (iac.cuh: 8 rows x 14 outputs and every channel, passes over 16 columns
// with the horizontal taps by shuffles, the corners once a warped pixel,
// the kernels loaded a row ahead) over the tiles of every iteration.  Each
// tile is K1's call of the same body on the same values, so the chain
// equals ac_num K1 launches bit for bit.  A grid that cannot be co-resident
// is refused, never split into per-iteration launches.
//
// Iterations are ordered by data, not by a grid-wide barrier.  A tile of
// iteration i reads iteration i-1's map at flow-displaced positions; once
// its corners are computed (before the gather), it knows the rows they
// touch and waits until iteration i-1 has finished the tile rows holding
// them (a count per tile row and image, raised by each tile when its
// stores are done, read with acquire).  Blocks claim tiles in one order,
// iteration by iteration, row-major, from a counter, as a freed slot of a
// K1 launch takes the next block: every tile a block waits for was claimed
// earlier by a co-resident block whose own waits reach only further back,
// so the waits cannot close a cycle.  The maps rotate through three
// scratch buffers (the last iteration writes out): iteration i overwrites
// the map iteration i-2 read, so it also waits until iteration i-2 is
// done, which it nearly always is.  A wait that outlasts about 2 s traps,
// so a fault fails the launch instead of hanging the card.
//
// Why so, each measured against 6 K1 launches in turns
// (benchmarks/iac_ab.py --chain, 272x480x64, ms, an H100 80GB HBM3 at 700
// W; PERF.md §6):
// - The gather's L1.  A map that other blocks of the launch wrote cannot
//   take the read-only path (__ldg, not coherent).  Read through L2 only
//   (ld.global.cg) a float chain took 0.872 where weak loads through L1
//   (ld.global.ca), which the acquire before them makes coherent, took
//   0.656 (6 K1 launches: 0.600): neighbouring warped pixels share their
//   corners.
// - Claimed tiles.  With every gridDim-th tile a block, a few blocks ran
//   a fourth tile of an iteration while the rest waited.
// - No barrier.  With cooperative_groups' grid.sync() between iterations
//   (tiles claimed, gathers through L1), each iteration ended waiting
//   about 20 us for the slowest blocks' last tiles, more than a kernel
//   boundary costs K1: 0.543 / 0.620 at B 1 (bf16 / float) against
//   0.506 / 0.599.  Ordered by rows: 0.513 / 0.550 against 0.511 / 0.592;
//   at B 2 0.957 / 0.977 against 0.908 / 0.985.
#include <climits>

#include "iac.cuh"

namespace fcvsr {
namespace {
namespace k1 {

// how an iteration's gather reads the map the iteration before wrote
constexpr int kChainSrc = kSrcL1;
constexpr int kScratch = 3;  // maps the iterations rotate through

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// spin until *p >= want; trap after about 2 s
__device__ __forceinline__ void wait_at_least(const int* p, int want) {
  const long long t0 = clock64();
  while (load_acquire(p) < want)
    if (clock64() - t0 > (1LL << 32)) __trap();
}

// A tile's wait before its gather: the tile rows of image b that iteration
// i-1 must have finished (rows_done, null for i = 0: feat_in), and the
// tiles of iteration i-2 (iter_done, null when no map is overwritten).
struct ChainWait {
  const int* rows_done;  // iteration i-1, image b: finished tiles a tile row
  const int* iter_done;  // iteration i-2: finished tiles
  int W, tiles_x, ntiles;
  __device__ __forceinline__ void operator()(const Corners* corners) const {
    if (rows_done == nullptr && iter_done == nullptr) return;
    if (threadIdx.x < 32) {
      // the rows the corners touch (a corner outside the frame reads pixel
      // 0 with weight 0: row 0 too)
      int lo = INT_MAX, hi = 0;
      for (int p = threadIdx.x; p < WR * MP; p += 32)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = corners[p].off[c] / W;
          lo = min(lo, r);
          hi = max(hi, r);
        }
      lo = __reduce_min_sync(0xffffffffu, lo);
      hi = __reduce_max_sync(0xffffffffu, hi);
      if (threadIdx.x == 0) {
        if (rows_done != nullptr)
          for (int ty = lo / TH; ty <= hi / TH; ++ty)
            wait_at_least(rows_done + ty, tiles_x);
        if (iter_done != nullptr) wait_at_least(iter_done, ntiles);
      }
    }
    __syncthreads();  // the whole block gathers after the wait's acquire
  }
};

// counters: the claim counter, then ac finished-tile counts, then ac x B x H
// finished-tile counts of a tile row (H slots an image; tiles_y are used)
template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
iac_chain_kernel(const T* __restrict__ feat_in, const float* __restrict__ flows,
                 const T* __restrict__ k, T* scratch, T* out, int* __restrict__ counters,
                 int B, int H, int W, int C, int ac, int act_last, int vec, int pairs) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int next;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const int ntiles = tiles_x * tiles_y * B;
  const size_t map = (size_t)B * H * W * C;
  int* claim = counters;
  int* iter_done = counters + 1;
  int* rows_done = iter_done + ac;
  // tile g of the launch: iteration g / ntiles, its tile g % ntiles as
  // K1's grid (x, y, z) orders them
  for (int g = blockIdx.x; g < ac * ntiles;) {
    const int i = g / ntiles, t = g % ntiles;
    const int b = t / (tiles_x * tiles_y), ty = t / tiles_x % tiles_y;
    const T* src = i == 0 ? feat_in : scratch + (size_t)((i - 1) % kScratch) * map;
    T* dst = i == ac - 1 ? out : scratch + (size_t)(i % kScratch) * map;
    const ChainWait wait{
        i > 0 ? rows_done + ((size_t)(i - 1) * B + b) * H : nullptr,
        i >= kScratch && i < ac - 1 ? iter_done + i - 2 : nullptr, W, tiles_x, ntiles};
    tile<T, false, kChainSrc>(smem, b, ty * TH, t % tiles_x * TW, src,
                              flows + (size_t)i * B * H * W * 2, k, nullptr, ac * 3 * C,
                              i * 3 * C, nullptr, nullptr, 0, feat_in, dst, H, W, C,
                              i < ac - 1 || act_last, vec, 0, pairs, wait);
    __syncthreads();  // every warp's stores issued
    if (threadIdx.x == 0) {
      __threadfence();  // ... and visible before the counts say so
      atomicAdd(rows_done + ((size_t)i * B + b) * H + ty, 1);
      atomicAdd(iter_done + i, 1);
      next = gridDim.x + atomicAdd(claim, 1);
    }
    // every thread reads next before the next tile's first barrier, which
    // thread 0 passes before it writes next again
    __syncthreads();
    g = next;
  }
}

template <typename T>
int launch_chain(const void* feat_in, const float* flows, const void* k, void* scratch,
                 void* out, int* counters, int B, int H, int W, int C, int ac,
                 int act_last, cudaStream_t stream) {
  constexpr auto kernel = &iac_chain_kernel<T>;
  const size_t smem = smem_bytes<T>(false, C, 0);
  cudaError_t err = allow_smem<kernel>(smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) !=
      cudaSuccess)
    return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const long long ntiles =
      (long long)((W + TW - 1) / TW) * ((H + TH - 1) / TH) * B;
  const int grid = (int)(ntiles < (long long)per_sm * sms ? ntiles
                                                          : (long long)per_sm * sms);
  // every map an iteration reads or writes: 16-byte gathers and pair
  // loads and stores where all of them allow
  const auto addr = [](const void* p) { return reinterpret_cast<uintptr_t>(p); };
  const uintptr_t maps = addr(feat_in) | addr(scratch) | addr(out) |
                         ((uintptr_t)B * H * W * C * sizeof(T));  // the maps' stride
  int vec = (C * sizeof(T)) % 16 == 0 && maps % 16 == 0;
  int pairs = C % 2 == 0 && (maps | addr(k)) % (2 * sizeof(T)) == 0;
  const T* fi = static_cast<const T*>(feat_in);
  const T* kk = static_cast<const T*>(k);
  T* sc = static_cast<T*>(scratch);
  T* o = static_cast<T*>(out);
  void* args[] = {&fi, &flows, &kk, &sc, &o, &counters, &B, &H, &W, &C, &ac, &act_last,
                  &vec, &pairs};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                    dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace k1
}  // namespace
}  // namespace fcvsr

// feat_in, out: (B,H,W,C); flows: (ac,B,H,W,2) float; k: (B,H,W,ac*3C)
// tap-major kernels, iteration i's block at columns [3Ci, 3C(i+1));
// scratch: min(3, ac - 1) maps (B,H,W,C) (unused when ac is 1); counters:
// 1 + ac + ac*B*H ints, zero.  The maps are bf16 when bf16 is set, float
// otherwise.  C <= 128, K1's.
extern "C" int fcvsr_iac_chain(const void* feat_in, const float* flows, const void* k,
                               void* scratch, void* out, int* counters, int B, int H,
                               int W, int C, int ac, int act_last, int bf16,
                               void* stream) {
  using namespace fcvsr;
  if (B < 1 || H < 1 || W < 1 || C < 1 || C > k1::kCMax || ac < 1 ||
      counters == nullptr || (ac > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return k1::launch_chain<__nv_bfloat16>(feat_in, flows, k, scratch, out, counters, B,
                                           H, W, C, ac, act_last, s);
  return k1::launch_chain<float>(feat_in, flows, k, scratch, out, counters, B, H, W, C,
                                 ac, act_last, s);
}
