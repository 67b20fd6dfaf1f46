// Hopper (sm_90a) building blocks of the port's kernels: mbarriers, TMA
// tile loads (cp.async.bulk.tensor) from tensor maps made on the host,
// warpgroup matrix products (wgmma.mma_async, bf16 in, f32 accumulate) with
// their shared-memory descriptors and fences, and the rounding of bf16 or
// f32 rows that TMA staged densely into swizzled bf16 tiles.
//
// Shared-memory operands are kept in the 128-byte swizzled layout that TMA
// writes with CU_TENSOR_MAP_SWIZZLE_128B: rows of 128 bytes (64 bf16), the
// 16-byte chunk c of row r stored at chunk c ^ (r % 8), in atoms of 8 rows
// (1024 bytes) that start on 1024-byte boundaries. A wgmma descriptor names
// the start of such a tile, the byte stride between atoms along the
// dimension that is not contiguous ("stride", SBO: the next 8 rows) and,
// for an operand whose contiguous dimension is M or N ("transposed"), the
// byte stride between 64-element atoms along that dimension ("leading",
// LBO).
//
// Host side: libcuda's cuTensorMapEncodeTiled is reached through the
// runtime's cudaGetDriverEntryPoint(ByVersion), so the libraries need no
// -lcuda.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace onedc {

template <typename T>
constexpr bool kIsBf16 = std::is_same<T, __nv_bfloat16>::value;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two adjacent output values (p 4-byte aligned for bf16, 8 for f32).
template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b) {
  if constexpr (kIsBf16<T>) {
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
}

namespace sm90 {

// ---------------------------------------------------------------- host side

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiledFn>(p)
                                            : nullptr;
  }();
  return fn;
}

// A tensor map of `rank` dimensions (dims[0] contiguous; strides in bytes
// of dims 1..rank-1) whose boxes land in shared memory in the 128-byte
// swizzled layout (bf16, the default) or densely (swizzle NONE: a box of
// f32 rows for warps to round to bf16); coordinates outside the tensor
// read as zero.
inline cudaError_t make_tensor_map(
    CUtensorMap* map, const void* base, int rank, const uint64_t* dims,
    const uint64_t* strides, const uint32_t* box,
    CUtensorMapDataType dtype = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
    CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  cuuint32_t elem_strides[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(
      map, dtype, static_cast<cuuint32_t>(rank), const_cast<void*>(base),
      reinterpret_cast<const cuuint64_t*>(dims),
      reinterpret_cast<const cuuint64_t*>(strides),
      reinterpret_cast<const cuuint32_t*>(box), elem_strides,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A tensor map over (D, H, rows, B) of a contiguous (B, rows, H, D) tensor
// of T, boxes of `box_cols` columns x `box_rows` rows of one head: bf16
// 128-byte swizzled (box_cols 64), or, for `dense`, unswizzled (box_cols =
// D: rows land D * sizeof(T) bytes apart).
template <typename T>
inline cudaError_t head_map(CUtensorMap* map, const void* base, int B,
                            int rows, int H, int D, int box_cols, int box_rows,
                            bool dense) {
  const uint64_t esz = sizeof(T);
  const uint64_t dims[4] = {static_cast<uint64_t>(D), static_cast<uint64_t>(H),
                            static_cast<uint64_t>(rows),
                            static_cast<uint64_t>(B)};
  const uint64_t strides[3] = {dims[0] * esz, dims[0] * dims[1] * esz,
                               dims[0] * dims[1] * dims[2] * esz};
  const uint32_t box[4] = {static_cast<uint32_t>(box_cols), 1,
                           static_cast<uint32_t>(box_rows), 1};
  return make_tensor_map(map, base, 4, dims, strides, box,
                         sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                         dense ? CU_TENSOR_MAP_SWIZZLE_NONE
                               : CU_TENSOR_MAP_SWIZZLE_128B);
}

// -------------------------------------------------------------- device side

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// waits until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// orders this thread's generic-proxy shared-memory accesses before later
// async-proxy (TMA, wgmma) accesses of the same bytes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier `id` (1..15) among `count` threads (a multiple of 32)
__device__ __forceinline__ void named_barrier_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// shared -> global tile store through a tensor map (coordinates outside the
// tensor are not written), tracked in the thread's bulk-async group
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// waits until the committed bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// wgmma descriptor of a 128-byte swizzled tile at shared address `addr`
// (leading and stride byte offsets as described at the top)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// waits until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving register reads or writes of v across
// wgmma fences, commits and waits (v is read or written asynchronously)
__device__ __forceinline__ void reg_fence(float& v) {
  asm volatile("" : "+f"(v)::"memory");
}
__device__ __forceinline__ void reg_fence(uint32_t& v) {
  asm volatile("" : "+r"(v)::"memory");
}

// moves registers between warpgroups: a producer warpgroup gives some up
// (dealloc), the consumers take them (alloc); every warp of the warpgroup
// runs it, on a branch that does not rejoin the others
template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d (64 x N, f32, the warpgroup's accumulator fragment) += a (64 x 16 bf16,
// registers: per warp the m16n8k16 A fragment of its 16 rows) * b (16 x N
// bf16 in shared memory, N contiguous: transposed). The operand lists are
// written out because PTX names every accumulator register.
__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t a[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n40(float* d, const uint32_t a[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19"
      "}, {%20, %21, %22, %23}, %24, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n48(float* d, const uint32_t a[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t a[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n80(float* d, const uint32_t a[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t a[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n160(float* d, const uint32_t a[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79"
      "}, {%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// d (64 x N) (+)= a (64 x 16 bf16, shared, K contiguous) * b (16 x N bf16,
// shared, K contiguous); scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d = a * b, the first k-step of a product: d is written only ("=f"), so
// that its registers need no value before the product starts
__device__ __forceinline__ void wgmma_ss_n64_first(float* d, uint64_t desc_a,
                                                    uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
        "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),
        "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
        "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),
        "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
        "=f"(d[30]), "=f"(d[31])
      : "l"(desc_a), "l"(desc_b));
}

__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t a[4],
                                         uint64_t desc_b, int scale_d) {
  static_assert(N == 16 || N == 40 || N == 48 || N == 64 || N == 80 ||
                    N == 128 || N == 160,
                "no wgmma_rs variant for this N");
  if constexpr (N == 16) wgmma_rs_n16(d, a, desc_b, scale_d);
  if constexpr (N == 40) wgmma_rs_n40(d, a, desc_b, scale_d);
  if constexpr (N == 48) wgmma_rs_n48(d, a, desc_b, scale_d);
  if constexpr (N == 64) wgmma_rs_n64(d, a, desc_b, scale_d);
  if constexpr (N == 80) wgmma_rs_n80(d, a, desc_b, scale_d);
  if constexpr (N == 128) wgmma_rs_n128(d, a, desc_b, scale_d);
  if constexpr (N == 160) wgmma_rs_n160(d, a, desc_b, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  static_assert(N == 64 || N == 128, "no wgmma_ss variant for this N");
  if constexpr (N == 64) wgmma_ss_n64(d, desc_a, desc_b, scale_d);
  if constexpr (N == 128) wgmma_ss_n128(d, desc_a, desc_b, scale_d);
}

// ------------------------------------------ rounding staged rows to bf16

// Eight consecutive values of T (bf16 or f32): 16 or 32 bytes.
template <typename T>
struct Chunk8 {
  uint4 v[sizeof(T) / 2];
};

// the chunk as 8 bf16 (16 bytes): f32 rounded to nearest even
template <typename T>
__device__ __forceinline__ uint4 bf16x8(const Chunk8<T>& c) {
  if constexpr (kIsBf16<T>) {
    return c.v[0];
  } else {
    return make_uint4(
        pack_bf16(__uint_as_float(c.v[0].x), __uint_as_float(c.v[0].y)),
        pack_bf16(__uint_as_float(c.v[0].z), __uint_as_float(c.v[0].w)),
        pack_bf16(__uint_as_float(c.v[1].x), __uint_as_float(c.v[1].y)),
        pack_bf16(__uint_as_float(c.v[1].z), __uint_as_float(c.v[1].w)));
  }
}

// Rounds `rows` rows of D columns (a multiple of 8) of T that a dense TMA
// box put in shared memory (row r at src[i] + r * D; rows past the
// tensor read as zero) to bf16 and writes them to swizzled tiles in the
// layout TMA writes with CU_TENSOR_MAP_SWIZZLE_128B, which wgmma's
// descriptors read: columns 8c .. 8c+7 of row r in 16-byte chunk
// (c % 8) ^ (r % 8) of 64-column atom c / 8, atoms atom_rows * 128 bytes
// apart from dst[i] on (dst[i] may start inside a tile, 8 rows aligned).
// Columns D .. C-1 are written as zeros, so D is padded in shared memory
// only. Thread `tid` of `nthreads` takes the units (row, chunk) tid, tid +
// nthreads, ... of each tensor. The caller orders the stores before the
// async proxy's reads (fence_proxy_async) and signals them.
template <int C, int kTensors, typename T>
__device__ __forceinline__ void convert_staged(
    unsigned char* const (&dst)[kTensors], const T* const (&src)[kTensors],
    int rows, int atom_rows, int D, int tid, int nthreads) {
  static_assert(C % 8 == 0, "whole 16-byte chunks");
  constexpr int kChunks = C / 8;  // per row
  constexpr int kWords = static_cast<int>(sizeof(T)) / 2;  // uint4 a chunk
#pragma unroll
  for (int ti = 0; ti < kTensors; ++ti) {
#pragma unroll 4
    for (int u = tid; u < rows * kChunks; u += nthreads) {
      const int r = u / kChunks;
      const int c = u - r * kChunks;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (c * 8 < D) {
        Chunk8<T> ch;
        const uint4* p =
            reinterpret_cast<const uint4*>(src[ti] + r * D + c * 8);
#pragma unroll
        for (int e = 0; e < kWords; ++e) ch.v[e] = p[e];
        val = bf16x8(ch);
      }
      *reinterpret_cast<uint4*>(dst[ti] + (c >> 3) * atom_rows * 128 +
                                r * 128 + (((c & 7) ^ (r & 7)) << 4)) = val;
    }
  }
}

// The S operand of the f32 backward at D <= 16, where the gradients are
// ill-conditioned in q and k (a product of rounded operands moved dQ by 1-2 %
// of its largest value on an H100): `rows` rows of D columns of f32, staged
// as convert_staged stages them, into three segments of C columns, each the
// row rounded to bf16 (hi) but segment lo_seg, which holds what that
// rounding lost, rounded again (lo): [hi | lo | hi] (lo_seg 1) or [hi | hi |
// lo] (lo_seg 2). A product over the 3C columns of one of each is hi * hi +
// lo * hi + hi * lo, the f32 product but for lo * lo (2^-16 relative);
// segment 0 alone is the tile that convert_staged writes.
template <int C>
__device__ __forceinline__ void convert_staged_split(
    unsigned char* dst, const float* src, int rows, int atom_rows, int D,
    int lo_seg, int tid, int nthreads) {
  static_assert(C % 8 == 0 && 3 * C <= 64, "three segments in one atom");
  constexpr int kChunks = 3 * C / 8;  // per row
#pragma unroll 4
  for (int u = tid; u < rows * kChunks; u += nthreads) {
    const int r = u / kChunks;
    const int c = u - r * kChunks;
    const int seg = c / (C / 8);
    const int cs = c - seg * (C / 8);  // the chunk of the source row
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (cs * 8 < D) {
      Chunk8<float> ch;
      const uint4* p = reinterpret_cast<const uint4*>(src + r * D + cs * 8);
      ch.v[0] = p[0];
      ch.v[1] = p[1];
      if (seg == lo_seg) {
        uint32_t* w = reinterpret_cast<uint32_t*>(ch.v);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float x = __uint_as_float(w[e]);
          w[e] = __float_as_uint(
              x - __bfloat162float(__float2bfloat16_rn(x)));
        }
      }
      val = bf16x8(ch);
    }
    *reinterpret_cast<uint4*>(dst + (c >> 3) * atom_rows * 128 + r * 128 +
                              (((c & 7) ^ (r & 7)) << 4)) = val;
  }
}

}  // namespace sm90
}  // namespace onedc
