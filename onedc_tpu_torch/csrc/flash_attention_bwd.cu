// Flash attention backward (non-causal) for Hopper, bf16 or f32.
//
// Replaces the Pallas TPU kernels _flash_attention_bwd_dkv
// (jax/experimental/pallas/ops/tpu/flash_attention.py:941, pallas_call
// :1121) and _flash_attention_bwd_dq (:1287, pallas_call :1456), called
// from _flash_attention_bwd (:254) when the UNet trains. FlashAttention-2
// style: the probabilities are recomputed from q, k and the forward's row
// log-sum-exp, never stored:
//     P = exp(scale * Q K^T - lse),  dV = P^T dO,  dP = dO V^T,
//     dS = P * (dP - di),  dK = scale * dS^T Q,  dQ = scale * dS K,
// with di = rowsum(O * dO) computed beforehand (plain torch, as the TPU
// path computes it in plain jnp, flash_attention.py:273).
//
// Two kernels, as on the TPU, so that no sum crosses blocks and no atomics
// are needed (the result is deterministic):
//  - dK/dV: one block per (64-key tile, batch*head), 4 warps x 16 keys; it
//    keeps its K and V tile in shared memory and walks the query tiles;
//  - dQ: one block per (64-query tile, batch*head), 4 warps x 16 queries;
//    it keeps its Q and dO tile and walks the key tiles.
// Each recomputes S, so the pair does 7 products of N*M*D per head against
// the forward's 2 (2*7*N*M*D*B*H FLOPs on the tensor cores).
//
// Layout: q, dq (B, N, H, D); k, v, dk, dv (B, M, H, D); dout (B, N, H, D);
// lse and di (B, H, N) f32; all contiguous. Operands are staged into shared
// memory as bf16 (bf16 inputs by cp.async, f32 inputs through registers with
// a round to bf16), D padded there to a multiple of 16, and every product
// runs on mma.sync m16n8k16 bf16 with f32 accumulation; P and dS are
// re-packed from the accumulator fragments as A operands in registers, as
// in the forward.
//
// What bounds it on the H100: ~14*N*M*D FLOPs per head against ~40*N*D
// bytes (f32), far above the ridge: the tensor cores. This first version
// is single-buffered (each tile's copies wait for the previous tile's math)
// and runs no wgmma or TMA (later work).

#include "mma.cuh"

#include <math.h>

namespace {

using namespace onedc;

constexpr int kTile = 64;
constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

// acc[j] (16 rows x 8 columns, j = 0..7) += rows of `sa` (16 x DP, from
// row0) times columns of `sb` (64 rows x DP, each row one output column):
// acc = A B^T over d.
template <int DP>
__device__ __forceinline__ void gemm_abt(float acc[8][4],
                                         const __nv_bfloat16* sa,
                                         const __nv_bfloat16* sb, int row0,
                                         int g, int t) {
  constexpr int LD = DP + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const __nv_bfloat16* pa = sa + (row0 + g) * LD + kk * 16 + 2 * t;
    const uint32_t a[4] = {ld_u32(pa), ld_u32(pa + 8 * LD), ld_u32(pa + 8),
                           ld_u32(pa + 8 * LD + 8)};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const __nv_bfloat16* pb = sb + (j * 8 + g) * LD + kk * 16 + 2 * t;
      mma_bf16(acc[j], a, ld_u32(pb), ld_u32(pb + 8));
    }
  }
}

// out[i] (16 rows x DP) += P (16 x 64, accumulator fragments p[8][4]) times
// `sb` (64 rows x DP, k-major).
template <int DP>
__device__ __forceinline__ void gemm_pb(float out[DP / 8][4],
                                        float p[8][4],
                                        const __nv_bfloat16* sb, int lane) {
  constexpr int LD = DP + 8;
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                           pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int dn2 = 0; dn2 < DP / 16; ++dn2) {
      uint32_t bv[4];
      ldmatrix_x4_trans(
          bv, sb + (kk * 16 + (lane & 15)) * LD + dn2 * 16 + (lane >> 4) * 8);
      mma_bf16(out[2 * dn2], a, bv[0], bv[1]);
      mma_bf16(out[2 * dn2 + 1], a, bv[2], bv[3]);
    }
  }
}

// Stores 16 rows (row0 + g, row0 + g + 8 of the tile at r0) x D of
// acc * mul to dst (rows of stride H * D).
template <int DP, typename T>
__device__ __forceinline__ void store_rows(T* dst, float acc[DP / 8][4],
                                           float mul, int r0, int rows,
                                           size_t stride, int D, int g,
                                           int t) {
  const int r_lo = r0 + g;
  const int r_hi = r_lo + 8;
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) {
    const int d = i * 8 + 2 * t;
    if (d >= D) continue;
    if (r_lo < rows) {
      store2<T>(dst + r_lo * stride + d, acc[i][0] * mul, acc[i][1] * mul);
    }
    if (r_hi < rows) {
      store2<T>(dst + r_hi * stride + d, acc[i][2] * mul, acc[i][3] * mul);
    }
  }
}

template <int DP, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ di, T* __restrict__ dk,
                         T* __restrict__ dv, int N, int M, int H, int D,
                         float scale, float scale_log2) {
  constexpr int LD = DP + 8;
  constexpr int DT = DP / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + kTile * LD;
  __nv_bfloat16* sQ = sV + kTile * LD;
  __nv_bfloat16* sO = sQ + kTile * LD;  // dO
  float* sL = reinterpret_cast<float*>(sO + kTile * LD);  // lse * log2(e)
  float* sD = sL + kTile;                                 // di

  const int m0 = blockIdx.x * kTile;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const size_t stride = static_cast<size_t>(H) * D;
  const size_t head = static_cast<size_t>(h) * D;
  const T* qb = q + static_cast<size_t>(b) * N * stride + head;
  const T* ob = dout + static_cast<size_t>(b) * N * stride + head;
  const size_t kv0 = (static_cast<size_t>(b) * M + m0) * stride + head;
  const float* lb = lse + (static_cast<size_t>(b) * H + h) * N;
  const float* db = di + (static_cast<size_t>(b) * H + h) * N;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = warp * 16;

  load_tile<DP>(sK, k + kv0, M - m0, stride, D);
  load_tile<DP>(sV, v + kv0, M - m0, stride, D);

  float acc_dk[DT][4], acc_dv[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) {
    acc_dk[i][0] = acc_dk[i][1] = acc_dk[i][2] = acc_dk[i][3] = 0.f;
    acc_dv[i][0] = acc_dv[i][1] = acc_dv[i][2] = acc_dv[i][3] = 0.f;
  }

  for (int n0 = 0; n0 < N; n0 += kTile) {
    __syncthreads();  // the previous query tile is consumed
    load_tile<DP>(sQ, qb + static_cast<size_t>(n0) * stride, N - n0, stride, D);
    load_tile<DP>(sO, ob + static_cast<size_t>(n0) * stride, N - n0, stride, D);
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const bool valid = n0 + i < N;
      sL[i] = valid ? lb[n0 + i] * kLog2e : 0.f;
      sD[i] = valid ? db[n0 + i] : 0.f;
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    // P^T (this warp's 16 keys x 64 queries), recomputed from S^T = K Q^T
    float p[8][4];
    gemm_abt<DP>(p, sK, sQ, row0, g, t);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = j * 8 + 2 * t + (e & 1);
        p[j][e] = n0 + qi < N ? exp2f(p[j][e] * scale_log2 - sL[qi]) : 0.f;
      }
    }
    gemm_pb<DP>(acc_dv, p, sO, lane);  // dV += P^T dO

    // dS^T = P^T * (dP^T - di), dP^T = V dO^T
    float ds[8][4];
    gemm_abt<DP>(ds, sV, sO, row0, g, t);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ds[j][e] = p[j][e] * (ds[j][e] - sD[j * 8 + 2 * t + (e & 1)]);
      }
    }
    gemm_pb<DP>(acc_dk, ds, sQ, lane);  // dK += dS^T Q
  }

  store_rows<DP>(dk + kv0, acc_dk, scale, row0, M - m0, stride, D, g, t);
  store_rows<DP>(dv + kv0, acc_dv, 1.f, row0, M - m0, stride, D, g, t);
}

template <int DP, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ di, T* __restrict__ dq,
                        int N, int M, int H, int D, float scale,
                        float scale_log2) {
  constexpr int LD = DP + 8;
  constexpr int DT = DP / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sO = sQ + kTile * LD;  // dO
  __nv_bfloat16* sK = sO + kTile * LD;
  __nv_bfloat16* sV = sK + kTile * LD;

  const int n0 = blockIdx.x * kTile;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const size_t stride = static_cast<size_t>(H) * D;
  const size_t head = static_cast<size_t>(h) * D;
  const size_t q0 = (static_cast<size_t>(b) * N + n0) * stride + head;
  const T* kb = k + static_cast<size_t>(b) * M * stride + head;
  const T* vb = v + static_cast<size_t>(b) * M * stride + head;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = warp * 16;

  load_tile<DP>(sQ, q + q0, N - n0, stride, D);
  load_tile<DP>(sO, dout + q0, N - n0, stride, D);
  // this thread's rows: row0 + g (e = 0, 1) and row0 + g + 8 (e = 2, 3)
  float l2[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = n0 + row0 + g + 8 * r;
    const size_t at = (static_cast<size_t>(b) * H + h) * N + row;
    l2[r] = row < N ? lse[at] * kLog2e : 0.f;
    dd[r] = row < N ? di[at] : 0.f;
  }

  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int m0 = 0; m0 < M; m0 += kTile) {
    __syncthreads();  // the previous key tile is consumed
    load_tile<DP>(sK, kb + static_cast<size_t>(m0) * stride, M - m0, stride, D);
    load_tile<DP>(sV, vb + static_cast<size_t>(m0) * stride, M - m0, stride, D);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    float p[8][4];
    gemm_abt<DP>(p, sQ, sK, row0, g, t);  // S = Q K^T
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = m0 + j * 8 + 2 * t + (e & 1);
        p[j][e] = key < M ? exp2f(p[j][e] * scale_log2 - l2[e >> 1]) : 0.f;
      }
    }
    float ds[8][4];
    gemm_abt<DP>(ds, sO, sV, row0, g, t);  // dP = dO V^T
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[j][e] = p[j][e] * (ds[j][e] - dd[e >> 1]);
    }
    gemm_pb<DP>(acc, ds, sK, lane);  // dQ += dS K
  }

  store_rows<DP>(dq + q0, acc, scale, row0, N - n0, stride, D, g, t);
}

template <int DP, typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* di,
                   void* dq, void* dk, void* dv, int B, int N, int M, int H,
                   int D, float scale, cudaStream_t stream) {
  const size_t tiles = static_cast<size_t>(4) * kTile * (DP + 8) * sizeof(__nv_bfloat16);
  const size_t smem_dkv = tiles + 2 * kTile * sizeof(float);
  // a function attribute belongs to the current device: set on every launch
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<DP, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_dkv));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<DP, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(tiles));
  if (err != cudaSuccess) return err;
  const float scale_log2 = scale * kLog2e;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  flash_bwd_dkv_kernel<DP, T>
      <<<dim3((M + kTile - 1) / kTile, B * H), kThreads, smem_dkv, stream>>>(
          tq, tk, tv, tdo, lse, di, static_cast<T*>(dk), static_cast<T*>(dv),
          N, M, H, D, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<DP, T>
      <<<dim3((N + kTile - 1) / kTile, B * H), kThreads, tiles, stream>>>(
          tq, tk, tv, tdo, lse, di, static_cast<T*>(dq), N, M, H, D, scale,
          scale_log2);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* dout,
             const float* lse, const float* di, void* dq, void* dk, void* dv,
             int B, int N, int M, int H, int D, float scale, cudaStream_t s) {
  switch ((D + 15) / 16 * 16) {
#define ONEDC_CASE(DP)                                                      \
  case DP:                                                                  \
    return launch<DP, T>(q, k, v, dout, lse, di, dq, dk, dv, B, N, M, H, D, \
                         scale, s);
    ONEDC_CASE(16)
    ONEDC_CASE(32)
    ONEDC_CASE(48)
    ONEDC_CASE(64)
    ONEDC_CASE(80)
    ONEDC_CASE(96)
    ONEDC_CASE(112)
    ONEDC_CASE(128)
#undef ONEDC_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dq, dk, dv from q, k, v, dout (one type: f32 when `f32` is nonzero, else
// bf16) and the forward's lse and di = rowsum(o * dout), (B, H, N) f32.
extern "C" int onedc_flash_attention_bwd(const void* q, const void* k,
                                         const void* v, const void* dout,
                                         const void* lse, const void* di,
                                         void* dq, void* dk, void* dv, int B,
                                         int N, int M, int H, int D,
                                         float scale, int f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(di);
  return f32 ? dispatch<float>(q, k, v, dout, l, d, dq, dk, dv, B, N, M, H, D,
                               scale, s)
             : dispatch<__nv_bfloat16>(q, k, v, dout, l, d, dq, dk, dv, B, N,
                                       M, H, D, scale, s);
}
