// Hopper (sm_90a) building blocks, written as PTX: mbarriers, TMA tensor
// loads on a tensor map, the wgmma shared-memory descriptors and the bf16
// warpgroup MMA with float32 sums.  Used by the rows-conv probes' GEMM
// stream (K9, csrc/microbench/conv2.cu), by the SCNet conv pair and
// single conv (K2, K3: csrc/conv3x3.cu) and by the deformable conv and its
// adjoint (K7, K8: csrc/dcn.cuh), whose operands are in the no-swizzle
// layout below.
//
// Layouts.  Every operand tile in shared memory is in the 128-byte swizzle
// that TMA's CU_TENSOR_MAP_SWIZZLE_128B writes and a wgmma descriptor of
// layout type 1 reads: rows of 128 bytes, eight rows an atom of 1024 bytes,
// the 16-byte chunk c of row j stored at chunk c ^ (j % 8).  The swizzle is
// taken on the address bits, so each atom starts 1024-byte aligned.
//   K-major (A: rows m, k contiguous): a row holds 64 bf16 k values; the
//     atoms of 8 rows lie SBO = 1024 bytes apart; the k16 slices of a
//     64-wide k block start 32 bytes apart (the hardware swizzles the
//     offset address); LBO is unused (1).
//   MN-major (B: rows k, n contiguous, read through the transpose bit): a
//     row holds 64 bf16 n values; the atoms of 8 k rows lie SBO bytes
//     apart and the 64-wide n blocks LBO bytes apart.
//
// The no-swizzle (interleaved) layout, descriptor layout type 0, is built
// of core matrices of 8 rows x 16 bytes (8 bf16 k values), each 128
// contiguous bytes, row r at 16 r.  K-major, which both operands of K2 use
// (trans-a = trans-b = 0): LBO is the byte distance between the two core
// matrices of a k16 slice (k 0-7 and 8-15), SBO the distance between core
// matrices 8 rows apart in M (or N).  Any 16-byte aligned start address
// works, so an operand can begin at any row of a stored tile: K2's shifted
// windows are the same tile read 16 bytes (one pixel) further on.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums: types only, no libcuda link
#include <cuda_runtime.h>

#include <cstdint>

namespace fcvsr {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------ mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// the barriers' initialisation visible to the async proxy (TMA)
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive where `pred` holds, predicated inside the asm: a branch on a
// thread's index around it would make the code path divergent, and ptxas
// then serialises the warpgroup's wgmma
__device__ __forceinline__ void mbar_arrive(uint64_t* bar, bool pred) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"((int)pred)
      : "memory");
}

// arrive, and expect `bytes` of transactions on the current phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the completion of the barrier's phase with this parity.  The
// loop is inside the asm (labels are local to its braces), so the compiler
// sees no divergent path.  A wait that outlasts 2 s (%globaltimer, read
// after the first failed try) traps: a fault in a pipeline's protocol
// becomes a launch error, not a card that hangs.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .u64 t0, t1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra MBAR_DONE;\n"
      "mov.u64 t0, %%globaltimer;\n"
      "MBAR_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra MBAR_DONE;\n"
      "mov.u64 t1, %%globaltimer;\n"
      "sub.u64 t1, t1, t0;\n"
      "setp.gt.u64 p, t1, 2000000000;\n"
      "@p trap;\n"
      "bra MBAR_WAIT;\n"
      "MBAR_DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// ------------------------------------------------------------------ TMA

// The thread's earlier writes to shared memory (generic proxy) ordered
// before later reads by the async proxy (wgmma, TMA).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The box of `map` at element coordinates (x, y) (x the contiguous one)
// into `dst` (1024-byte aligned for a swizzled map), completing its bytes
// on `bar`.  Elements outside the tensor land as zeros; the barrier counts
// the whole box.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_u32(bar))
      : "memory");
}

// ---------------------------------------------------------------- wgmma

// A shared-memory matrix descriptor of the 128-byte swizzle: the start
// address, LBO and SBO in bytes (16-byte units in the descriptor), layout
// type 1 in bits 62-63, base offset 0 (atoms 1024-byte aligned).
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// A descriptor of the no-swizzle layout at shared-memory address `addr`
// (16-byte aligned), LBO and SBO in bytes: layout type 0, base offset 0.
__device__ __forceinline__ uint64_t desc_interleave(uint32_t addr, uint32_t lbo,
                                                    uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of the accumulators across
// a wgmma wait or fence: each register passes through an empty asm.
template <int N>
__device__ __forceinline__ void fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N, float32) = A (64 x 16 bf16, descriptor a) x B (16 x N bf16,
// descriptor b) + (scale_d ? d : 0), N 32, 64 or 128, in d[0 : N / 2] of a
// thread's registers.  B is MN-major, read through the transpose bit (TB
// 1, the mm probes'), or K-major (TB 0: each of the N rows holds its 16 k
// values, K2's); A K-major (TA 0) or MN-major (TA 1: each of the 16 k rows
// holds M values, the DCN adjoint's weight gradient).  MN-major without a
// swizzle: core matrices of 8 k rows x 8 M (or N) values, 16 bytes a row;
// SBO the distance between core matrices 8 M (or N) apart, LBO between
// those 8 k apart.  The fragment of thread t = 32 w + l of the
// warpgroup: d[4 j + e] holds row 16 w + l / 4 + 8 (e / 2), column 8 j + 2
// (l % 4) + e % 2, so an N 64 product fills what the first 64 columns of
// an N 128 one would.
template <int N, int TB = 1, int TA = 0, int R>
__device__ __forceinline__ void wgmma_m64k16_bf16(float (&d)[R], uint64_t a,
                                                  uint64_t b, int scale_d) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma m64nNk16: N 32, 64 or 128 here");
  static_assert(TB == 0 || TB == 1, "B K-major (0) or MN-major (1)");
  static_assert(TA == 0 || TA == 1, "A K-major (0) or MN-major (1)");
  static_assert(R >= N / 2, "the fragment is d[0 : N / 2]");
  if constexpr (N == 32) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{ %0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15},"
        " %16, %17, p, 1, 1, %19, %20;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{ %0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31},"
        " %32, %33, p, 1, 1, %35, %36;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{ %0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63},"
        " %64, %65, p, 1, 1, %67, %68;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  }
}

// ----------------------------------------------------------- host side

using TensorMapEncode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                     void*, const cuuint64_t*, const cuuint64_t*,
                                     const cuuint32_t*, const cuuint32_t*,
                                     CUtensorMapInterleave, CUtensorMapSwizzle,
                                     CUtensorMapL2promotion,
                                     CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda: it is fetched through the
// runtime, so the library needs no link against libcuda.
inline cudaError_t tensor_map_encoder(TensorMapEncode* fn_out) {
  static TensorMapEncode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorSymbolNotFound;
    encode = reinterpret_cast<TensorMapEncode>(fn);
  }
  *fn_out = encode;
  return cudaSuccess;
}

// A 2-D tensor map of a row-major array (rows, cols) of `type` with a row
// stride of cols elements (`bytes` each; TMA takes row strides that are a
// multiple of 16 bytes) and boxes of (box_rows, box_cols); elements
// outside the array land as zeros.
inline cudaError_t encode_2d(CUtensorMap* map, CUtensorMapDataType type,
                             unsigned bytes, const void* base, uint64_t rows,
                             uint64_t cols, uint32_t box_rows, uint32_t box_cols,
                             CUtensorMapSwizzle swizzle) {
  TensorMapEncode encode = nullptr;
  cudaError_t err = tensor_map_encoder(&encode);
  if (err != cudaSuccess) return err;
  if (cols * bytes % 16 || reinterpret_cast<uintptr_t>(base) % 16)
    return cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult res = encode(
      map, type, 2, const_cast<void*>(base), dims, strides, box, steps,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// bf16 (rows, cols), cols a multiple of 8, boxes 128-byte swizzled (the
// wgmma operand layout above).
inline cudaError_t encode_bf16_2d(CUtensorMap* map, const void* base,
                                  uint64_t rows, uint64_t cols, uint32_t box_rows,
                                  uint32_t box_cols) {
  return encode_2d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, rows, cols,
                   box_rows, box_cols, CU_TENSOR_MAP_SWIZZLE_128B);
}

// float32 (rows, cols), cols a multiple of 4, boxes unswizzled: a box
// lands as box_rows rows of box_cols contiguous floats (its start 128-byte
// aligned in shared memory).
inline cudaError_t encode_f32_2d(CUtensorMap* map, const void* base,
                                 uint64_t rows, uint64_t cols, uint32_t box_rows,
                                 uint32_t box_cols) {
  return encode_2d(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, base, rows, cols,
                   box_rows, box_cols, CU_TENSOR_MAP_SWIZZLE_NONE);
}

}  // namespace sm90
}  // namespace fcvsr
