// Hopper (sm_90a) building blocks shared by the port's TMA + wgmma kernels
// (fused_collectives.cu rows 7/8, flash_attention.cu, paged_attention.cu):
// mbarriers, TMA tensor loads and bulk copies, wgmma shared-memory
// descriptors and fences, integer payload bytes read as floats, and the
// host-side encoding of TMA tensor maps.
// Everything is inline and lives in namespace `hopper`; each .cu file that
// includes this header gets its own copy inside its own shared library.
//
// The tensor maps are encoded with cuTensorMapEncodeTiled taken from the
// driver through the runtime (cudaGetDriverEntryPointByVersion), so a
// library needs no link against libcuda.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; no libcuda link
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ------------------------------------------------------------ device side
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

// after every mbar_init of a block, before any other thread uses them
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also expects `bytes` of TMA transactions this phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}

// one arrival (release: this thread's earlier writes are seen by the
// threads that wait for the phase)
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// until the phase of parity `parity` has completed; on a fresh barrier,
// parity 1 names the phase before the first, which counts as complete
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)) : "memory");
}

// the box of `map` at coordinates (c0, c1), innermost first, into shared
// memory at dst; completes its bytes on mbarrier `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16; both addresses 16-byte
// aligned) from global src into shared memory at dst, a bulk copy of the
// async proxy (no tensor map); completes its bytes on mbarrier `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// A shared-memory matrix descriptor of wgmma, 128-byte swizzle (atoms of 8
// rows of 128 bytes, 1024-byte aligned). For a K-major operand (K along
// the 128-byte rows) lbo is unused and sbo = 1024 (the next 8 rows); a
// k step of 16 elements adds 32 bytes to addr. For an MN-major operand
// (MN along the rows: wgmma's transpose bit) lbo = the stride of the
// 64-wide MN atoms and sbo = 1024 (the next 8 k rows); a k step of 16
// rows adds 2048 bytes.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// before the first wgmma of a batch whose accumulators or A registers were
// written by other instructions
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// until at most N committed wgmma groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma uses (accumulators, A fragments) across its waits
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// register reallocation between the warpgroups of a block (sm_90a): every
// thread of a warpgroup runs the same one. The block starts with the
// count ptxas gives each thread at entry (the launch bounds' maximum); a
// warpgroup that lowers its count to N gives the rest back to the block,
// and one that raises it waits until the block has them
template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// generic-proxy writes to shared memory, read next by the async proxy
// (wgmma, TMA)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Integer payloads to floats with no conversion instruction (I2F runs at
// a quarter of the fp32 rate). 2^23 as fp32 bits: an integer j < 2^23 OR-ed into its mantissa reads as
// 2^23 + j, and taking 2^23 + bias away gives j - bias exactly
constexpr uint32_t kTwo23 = 0x4B000000u;

// byte e of x in the low mantissa byte of 2^23 (the selector as an
// immediate, the constant `two23` in a register)
template <int E>
__device__ __forceinline__ float byte_in_two23(uint32_t x, uint32_t two23) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(x), "r"(two23),
      "n"(0x7650 | E));
  return __uint_as_float(r);
}

// -------------------------------------------------------------- host side
using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline EncodeTiledFn lookup_encoder() {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
  const cudaError_t err = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
  const cudaError_t err = cudaGetDriverEntryPoint(
      "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
  if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
    return nullptr;
  return reinterpret_cast<EncodeTiledFn>(fn);
}

// The tensor map of a `rank`-dimensional array: dims innermost first,
// byte strides of dims 1 .. rank-1 (multiples of 16), box in elements.
// Zeros are read past its edges. Returns a cudaError_t value.
inline int encode_tiled(CUtensorMap* map, CUtensorMapDataType type, int rank,
                        const void* ptr, const cuuint64_t* dims,
                        const cuuint64_t* strides, const cuuint32_t* box,
                        bool swizzle) {
  static const EncodeTiledFn encode = lookup_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(
      map, type, static_cast<cuuint32_t>(rank), const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// the tensor map of a row-major [rows, cols] matrix of `esize`-byte
// elements, box [box_rows, box_cols]
inline int encode_2d(CUtensorMap* map, CUtensorMapDataType type, int esize,
                     const void* ptr, int rows, int cols, int box_rows,
                     int box_cols, bool swizzle) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * esize};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  return encode_tiled(map, type, 2, ptr, dims, strides, box, swizzle);
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace hopper
