// Flash attention forward (non-causal) for Hopper, bf16 in and out.
//
// Replaces the Pallas TPU kernel reached from onedc_tpu/nn/attention.py:43
// (flash_attention_tpu -> jax.experimental.pallas.ops.tpu.flash_attention).
// Computes o = softmax(q k^T * scale) v per (batch, head) with an online
// softmax, so the N x M score matrix never reaches device memory.
//
// Layout: q (B, N, H, D), k and v (B, M, H, D), o (B, N, H, D), contiguous.
// The kernel reads the heads through strides: no transpose and no padding of
// D in device memory (the TPU version padded D to 128 lanes in HBM).
//
// What bounds it on the H100: at the UNet's self-attention shapes
// ((1, 9216, 8, 40) and (1, 2304, 8, 80)) the work is ~4*N*M*H*D FLOPs
// against ~8*N*H*D bytes of q/k/v/o, far above the card's ~295 FLOP/byte
// ridge, so the tensor cores bound it. The design keeps both products on the
// tensor cores (mma.sync m16n8k16 bf16, f32 accumulate), keeps the
// probabilities in registers between the two products (the QK^T accumulator
// fragment is re-packed as the A operand of PV), and stages K and V in shared
// memory once per 64-key tile for all four warps, double-buffered with
// cp.async so the next tile's copies overlap this tile's math. D is padded
// inside the kernel to a multiple of 16 (40 -> 48, 80 -> 80) by zero-filled
// copies. Not yet done: TMA and wgmma (later work).
//
// Grid: one block per (64-query tile, batch*head); 4 warps, 16 query rows
// each. Ragged N and M edges are masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;

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

// Starts the copy of 64 rows x DP columns from global (row stride `stride`
// elements) into shared memory (row stride DP + 8); rows >= rows_valid and
// columns >= D are zero-filled.
template <int DP>
__device__ __forceinline__ void load_tile(__nv_bfloat16* s,
                                          const __nv_bfloat16* g,
                                          int rows_valid, size_t stride,
                                          int D) {
  constexpr int LD = DP + 8;
  constexpr int VPR = DP / 8;
  for (int i = threadIdx.x; i < 64 * VPR; i += kThreads) {
    const int r = i / VPR;
    const int d = (i % VPR) * 8;
    const bool valid = r < rows_valid && d < D;
    cp_async16(s + r * LD + d, valid ? g + r * stride + d : g, valid);
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, int N, int M, int H,
                     int D, float scale_log2) {
  constexpr int LD = DP + 8;
  constexpr int NT = kBlockK / 8;  // n8 tiles of scores per key tile
  constexpr int DT = DP / 8;       // n8 tiles of output
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  // K and V in two stages: [stage][K tile, V tile]
  __nv_bfloat16* sKV = sQ + kBlockQ * LD;

  const int n0 = blockIdx.x * kBlockQ;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const size_t stride = static_cast<size_t>(H) * D;
  const __nv_bfloat16* qb =
      q + (static_cast<size_t>(b) * N + n0) * stride + static_cast<size_t>(h) * D;
  const __nv_bfloat16* kb =
      k + static_cast<size_t>(b) * M * stride + static_cast<size_t>(h) * D;
  const __nv_bfloat16* vb =
      v + static_cast<size_t>(b) * M * stride + static_cast<size_t>(h) * D;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = warp * 16;

  load_tile<DP>(sQ, qb, N - n0, stride, D);
  load_tile<DP>(sKV, kb, M, stride, D);
  load_tile<DP>(sKV + kBlockK * LD, vb, M, stride, D);
  cp_async_commit();

  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) {
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  }
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  for (int it = 0, m0 = 0; m0 < M; ++it, m0 += kBlockK) {
    cp_async_wait_all();
    __syncthreads();  // tile `it` landed; the other stage is consumed
    const int m1 = m0 + kBlockK;
    if (m1 < M) {  // the next tile's copies overlap this tile's math
      __nv_bfloat16* nxt = sKV + ((it + 1) & 1) * 2 * kBlockK * LD;
      load_tile<DP>(nxt, kb + static_cast<size_t>(m1) * stride, M - m1, stride,
                    D);
      load_tile<DP>(nxt + kBlockK * LD, vb + static_cast<size_t>(m1) * stride,
                    M - m1, stride, D);
      cp_async_commit();
    }
    const __nv_bfloat16* sK = sKV + (it & 1) * 2 * kBlockK * LD;
    const __nv_bfloat16* sV = sK + kBlockK * LD;

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const __nv_bfloat16* qa = sQ + (row0 + g) * LD + kk * 16 + 2 * t;
      uint32_t a[4] = {ld_u32(qa), ld_u32(qa + 8 * LD), ld_u32(qa + 8),
                       ld_u32(qa + 8 * LD + 8)};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const __nv_bfloat16* kp = sK + (j * 8 + g) * LD + kk * 16 + 2 * t;
        mma_bf16(s[j], a, ld_u32(kp), ld_u32(kp + 8));
      }
    }

    // scale (log2 domain), mask keys past M, running row max.
    // Thread holds rows g (e = 0, 1) and g + 8 (e = 2, 3).
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = m0 + j * 8 + 2 * t + (e & 1);
        s[j][e] = key < M ? s[j][e] * scale_log2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    float alpha[2];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      alpha[r] = exp2f(m_run[r] - mx[r]);  // 0 on the first tile
      m_run[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - mx[e >> 1]);
        rs[e >> 1] += s[j][e];
      }
    }
    // row sums stay per thread until the end: alpha is uniform in a quad
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rs[r];
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      acc[i][0] *= alpha[0];
      acc[i][1] *= alpha[0];
      acc[i][2] *= alpha[1];
      acc[i][3] *= alpha[1];
    }

    // O += P V: the score accumulators of key tiles 2kk, 2kk+1 are the A
    // fragment of keys 16kk..16kk+15.
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                       pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                       pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                       pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dn2 = 0; dn2 < DP / 16; ++dn2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(
            bv, sV + (kk * 16 + (lane & 15)) * LD + dn2 * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dn2], a, bv[0], bv[1]);
        mma_bf16(acc[2 * dn2 + 1], a, bv[2], bv[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const float inv0 = 1.f / l_run[0];
  const float inv1 = 1.f / l_run[1];
  const int r_lo = n0 + row0 + g;
  const int r_hi = r_lo + 8;
#pragma unroll
  for (int i = 0; i < DT; ++i) {
    const int d = i * 8 + 2 * t;
    if (d >= D) continue;
    if (r_lo < N) {
      *reinterpret_cast<uint32_t*>(
          o + ((static_cast<size_t>(b) * N + r_lo) * H + h) * D + d) =
          pack_bf16(acc[i][0] * inv0, acc[i][1] * inv0);
    }
    if (r_hi < N) {
      *reinterpret_cast<uint32_t*>(
          o + ((static_cast<size_t>(b) * N + r_hi) * H + h) * D + d) =
          pack_bf16(acc[i][2] * inv1, acc[i][3] * inv1);
    }
  }
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int N, int M, int H, int D, float scale,
                   cudaStream_t stream) {
  // Q tile + two stages of (K tile, V tile)
  const size_t smem = static_cast<size_t>(5) * 64 * (DP + 8) * sizeof(__nv_bfloat16);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((N + kBlockQ - 1) / kBlockQ, B * H);
  flash_fwd_kernel<DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), N,
      M, H, D, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace

extern "C" int onedc_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* o, int B, int N,
                                         int M, int H, int D, float scale,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((D + 15) / 16 * 16) {
    case 16: return launch<16>(q, k, v, o, B, N, M, H, D, scale, s);
    case 32: return launch<32>(q, k, v, o, B, N, M, H, D, scale, s);
    case 48: return launch<48>(q, k, v, o, B, N, M, H, D, scale, s);
    case 64: return launch<64>(q, k, v, o, B, N, M, H, D, scale, s);
    case 80: return launch<80>(q, k, v, o, B, N, M, H, D, scale, s);
    case 96: return launch<96>(q, k, v, o, B, N, M, H, D, scale, s);
    case 112: return launch<112>(q, k, v, o, B, N, M, H, D, scale, s);
    case 128: return launch<128>(q, k, v, o, B, N, M, H, D, scale, s);
    case 144: return launch<144>(q, k, v, o, B, N, M, H, D, scale, s);
    case 160: return launch<160>(q, k, v, o, B, N, M, H, D, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
