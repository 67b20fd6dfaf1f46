// Building blocks shared by the port's kernels: bf16 tensor-core products
// (mma.sync m16n8k16, f32 accumulate), ldmatrix, cp.async, and the staging
// of bf16 or f32 operands into shared memory as bf16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace onedc {

template <typename T>
constexpr bool kIsBf16 = std::is_same<T, __nv_bfloat16>::value;

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a (16x16, row) * b (16x8, col); bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four transposed 8x8 tiles from shared memory: the B fragments of two
// adjacent n8 tiles when B is stored k-major (rows = k).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const __nv_bfloat16* p) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 16-byte global -> shared copy that bypasses the registers; with
// pred false it writes 16 zero bytes and reads nothing
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// Eight f32 values from global memory (16-byte aligned) to 16 bytes of
// shared memory as bf16, through registers.
__device__ __forceinline__ void stage8_f32(__nv_bfloat16* s, const float* g) {
  const float4 lo = *reinterpret_cast<const float4*>(g);
  const float4 hi = *reinterpret_cast<const float4*>(g + 4);
  *reinterpret_cast<uint4*>(s) =
      make_uint4(pack_bf16(lo.x, lo.y), pack_bf16(lo.z, lo.w),
                 pack_bf16(hi.x, hi.y), pack_bf16(hi.z, hi.w));
}

// Eight consecutive elements of T (bf16 or f32) from global memory to 16
// bytes of shared memory as bf16; zeros when !valid (g is then not read,
// but must still be a valid address). bf16 goes by cp.async (the caller
// commits and waits), f32 through registers with a round to bf16.
template <typename T>
__device__ __forceinline__ void stage8(__nv_bfloat16* s, const T* g,
                                       bool valid) {
  if constexpr (kIsBf16<T>) {
    cp_async16(s, g, valid);
  } else {
    if (valid) {
      stage8_f32(s, g);
    } else {
      *reinterpret_cast<uint4*>(s) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// Stages a tile of 64 rows x DP columns of T from global memory (row
// stride `stride` elements) into shared memory as bf16 (row stride DP + 8),
// by the 128 threads of an attention block; rows >= rows_valid and columns
// >= D are zero-filled, so D is padded to DP here and never in device
// memory.
template <int DP, typename T>
__device__ __forceinline__ void load_tile(__nv_bfloat16* s, const T* g,
                                          int rows_valid, size_t stride,
                                          int D) {
  constexpr int LD = DP + 8;
  constexpr int VPR = DP / 8;
  for (int i = threadIdx.x; i < 64 * VPR; i += 128) {
    const int r = i / VPR;
    const int d = (i % VPR) * 8;
    const bool valid = r < rows_valid && d < D;
    stage8<T>(s + r * LD + d, valid ? g + r * stride + d : g, valid);
  }
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

}  // namespace onedc
