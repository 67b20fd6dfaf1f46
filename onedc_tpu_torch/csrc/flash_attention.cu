// Flash attention forward (non-causal) for Hopper, bf16 or f32 in and out.
//
// Replaces the Pallas TPU kernel reached from onedc_tpu/nn/attention.py:43
// (flash_attention_tpu -> jax.experimental.pallas.ops.tpu.flash_attention,
// _flash_attention_impl). Computes o = softmax(q k^T * scale) v per
// (batch, head) with an online softmax, so the N x M score matrix never
// reaches device memory; on request it also writes the row log-sum-exp
// lse = log(sum_j exp(scale * q.k_j)) (B, H, N) f32, which the backward
// (flash_attention_bwd.cu) uses to recompute the probabilities, as the TPU
// kernel saves l and m for its VJP.
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
// memory once per 64-key tile for all four warps, double-buffered. bf16
// operands go by cp.async, so the next tile's copies overlap this tile's
// math; f32 operands (the training path) are loaded through registers and
// rounded to bf16 as they are staged, so the products keep bf16 operands and
// f32 accumulation, as the TPU runs f32 matmuls at default precision. D is
// padded inside the kernel to a multiple of 16 (8 -> 16, 40 -> 48) by
// zero-filled copies. Not yet done: TMA and wgmma (later work).
//
// Grid: one block per (64-query tile, batch*head); 4 warps, 16 query rows
// each. Ragged N and M edges are masked.

#include "mma.cuh"

#include <math.h>

namespace {

using namespace onedc;

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int DP, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int N, int M, int H, int D,
                     float scale_log2) {
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
  const T* qb =
      q + (static_cast<size_t>(b) * N + n0) * stride + static_cast<size_t>(h) * D;
  const T* kb = k + static_cast<size_t>(b) * M * stride + static_cast<size_t>(h) * D;
  const T* vb = v + static_cast<size_t>(b) * M * stride + static_cast<size_t>(h) * D;

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
      store2<T>(o + ((static_cast<size_t>(b) * N + r_lo) * H + h) * D + d,
                acc[i][0] * inv0, acc[i][1] * inv0);
    }
    if (r_hi < N) {
      store2<T>(o + ((static_cast<size_t>(b) * N + r_hi) * H + h) * D + d,
                acc[i][2] * inv1, acc[i][3] * inv1);
    }
  }
  if (lse != nullptr && t == 0) {  // natural log of the scaled row sum
    float* lb = lse + (static_cast<size_t>(b) * H + h) * N;
    if (r_lo < N) lb[r_lo] = (m_run[0] + log2f(l_run[0])) * kLn2;
    if (r_hi < N) lb[r_hi] = (m_run[1] + log2f(l_run[1])) * kLn2;
  }
}

template <int DP, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int N, int M, int H, int D, float scale,
                   cudaStream_t stream) {
  // Q tile + two stages of (K tile, V tile)
  const size_t smem = static_cast<size_t>(5) * 64 * (DP + 8) * sizeof(__nv_bfloat16);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<DP, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((N + kBlockQ - 1) / kBlockQ, B * H);
  flash_fwd_kernel<DP, T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, N, M, H, D,
      scale * kLog2e);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, float* lse,
             int B, int N, int M, int H, int D, float scale, cudaStream_t s) {
  switch ((D + 15) / 16 * 16) {
    case 16: return launch<16, T>(q, k, v, o, lse, B, N, M, H, D, scale, s);
    case 32: return launch<32, T>(q, k, v, o, lse, B, N, M, H, D, scale, s);
    case 48: return launch<48, T>(q, k, v, o, lse, B, N, M, H, D, scale, s);
    case 64: return launch<64, T>(q, k, v, o, lse, B, N, M, H, D, scale, s);
    case 80: return launch<80, T>(q, k, v, o, lse, B, N, M, H, D, scale, s);
    case 96: return launch<96, T>(q, k, v, o, lse, B, N, M, H, D, scale, s);
    case 112: return launch<112, T>(q, k, v, o, lse, B, N, M, H, D, scale, s);
    case 128: return launch<128, T>(q, k, v, o, lse, B, N, M, H, D, scale, s);
    case 144: return launch<144, T>(q, k, v, o, lse, B, N, M, H, D, scale, s);
    case 160: return launch<160, T>(q, k, v, o, lse, B, N, M, H, D, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, k, v, o of one type: f32 when `f32` is nonzero, else bf16. lse may be
// null (no log-sum-exp written).
extern "C" int onedc_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* o, void* lse,
                                         int B, int N, int M, int H, int D,
                                         float scale, int f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  return f32 ? dispatch<float>(q, k, v, o, l, B, N, M, H, D, scale, s)
             : dispatch<__nv_bfloat16>(q, k, v, o, l, B, N, M, H, D, scale, s);
}
