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
// The kernels read the heads through strides: no transpose and no padding of
// D in device memory (the TPU version padded D to 128 lanes in HBM).
//
// What bounds it on the H100: at the UNet's self-attention shapes
// ((1, 9216, 8, 40) and (1, 2304, 8, 80)) the work is ~4*N*M*H*D FLOPs
// against ~8*N*H*D bytes of q/k/v/o, far above the card's ~295 FLOP/byte
// ridge. It also takes N*M*H exponentials, 16 per clock per SM on the
// special-function units: at D = 40 those, not the tensor cores, bind it.
//
// Two kernels:
// - bf16 (the decode path), flash_fwd_kernel_wgmma: a block owns 128 query
//   rows of one (batch, head): two consumer warpgroups of 64 rows and one
//   producer warp. The producer loads the Q tile once and K and V tiles
//   through a 2-stage ring guarded by mbarriers, by TMA from tensor maps
//   over (D, H, N, B): a box of 64 columns lands 128-byte swizzled, the
//   columns past D zero-filled, so D is padded in shared memory only.
//   S = Q K^T runs on wgmma with both operands in shared memory (k = D
//   rounded up to 16); the online softmax folds the scale and the running
//   max into one FFMA per score before exp2; P is re-packed from S's
//   accumulator into registers as the A operand of O += P V (wgmma, V in
//   shared memory N-major: "transposed", N = 48, 80 or 160).
//   The two warpgroups run independently on the shared ring, so one's
//   softmax can overlap the other's products.
// - f32 (the training path, with the LSE), flash_fwd_kernel<DP, float>: one
//   block per (64 queries, batch*head), 4 warps x 16 rows, both products on
//   mma.sync m16n8k16 bf16 with f32 accumulate, operands rounded to bf16 as
//   they are staged (as the TPU runs f32 matmuls at default precision), the
//   score fragment re-packed in registers as PV's A operand, K and V tiles
//   double-buffered; D padded to a multiple of 16 by zero-filled copies.
// Ragged N and M edges are masked in both.

#include "mma.cuh"
#include "sm90.cuh"

#include <math.h>

namespace {

using namespace onedc;

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// the f32 kernel (T = float; see the top of the file)
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

// ------------------------------------------------------------------------
// bf16 on wgmma + TMA (see the top of the file)

namespace wg {

constexpr int kQRows = 128;       // two consumer warpgroups of 64 rows
constexpr int kConsumerWarps = 8;
constexpr int kBlockThreads = kConsumerWarps * 32 + 32;  // + the producer
constexpr int kStages = 2;        // K and V tiles in flight

}  // namespace wg

// DP: D rounded up to 64 (the columns staged, 64 per 128-byte atom); DV: the
// output columns computed (48, 80 or 160); BKV: keys per tile
template <int DP, int DV, int BKV>
__global__ void __launch_bounds__(wg::kBlockThreads, 1)
    flash_fwd_kernel_wgmma(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           __nv_bfloat16* __restrict__ o,
                           float* __restrict__ lse, int N, int M, int H, int D,
                           float scale_log2) {
  using namespace wg;
  using namespace sm90;
  constexpr int NA = DP / 64;               // 64-column atoms per row
  constexpr int kQBytes = NA * kQRows * 128;
  constexpr int kKVBytes = NA * BKV * 128;  // one K or V tile
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // TMA's 128-byte swizzle is a function of the shared address: 1024-align
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = smem;                  // [atom][128 rows][128 bytes]
  unsigned char* sK = sQ + kQBytes;          // [stage][atom][BKV][128 bytes]
  unsigned char* sV = sK + kStages * kKVBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + kStages * kKVBytes);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + kStages;
  uint64_t* v_full = k_empty + kStages;
  uint64_t* v_empty = v_full + kStages;

  const int n0 = blockIdx.x * kQRows;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int ntiles = (M + BKV - 1) / BKV;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], kConsumerWarps);
      mbar_init(&v_empty[s], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // producer: one thread issues every load
    if (lane == 0) {
      mbar_arrive_expect_tx(q_full, kQBytes);
      for (int a = 0; a < NA; ++a) {
        tma_load_4d(sQ + a * kQRows * 128, &qmap, q_full, a * 64, h, n0, b);
      }
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % kStages;
        const uint32_t ph = ((j / kStages) & 1) ^ 1;
        mbar_wait(&k_empty[s], ph);
        mbar_arrive_expect_tx(&k_full[s], kKVBytes);
        for (int a = 0; a < NA; ++a) {
          tma_load_4d(sK + s * kKVBytes + a * BKV * 128, &kmap, &k_full[s],
                      a * 64, h, j * BKV, b);
        }
        mbar_wait(&v_empty[s], ph);
        mbar_arrive_expect_tx(&v_full[s], kKVBytes);
        for (int a = 0; a < NA; ++a) {
          tma_load_4d(sV + s * kKVBytes + a * BKV * 128, &vmap, &v_full[s],
                      a * 64, h, j * BKV, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wgi owns query rows 64*wgi .. +63, warp wi of it
  // rows 16*wi .. +15; the thread holds rows g and g + 8 of those
  const int wgi = warp / 4;
  const int wi = warp % 4;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int ksteps = (D + 15) / 16;
  const uint32_t qaddr = smem_addr(sQ) + wgi * 64 * 128;

  float oacc[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) oacc[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  mbar_wait(q_full, 0);

  for (int j = 0; j < ntiles; ++j) {
    const int s = j % kStages;
    const uint32_t ph = (j / kStages) & 1;
    const uint32_t kaddr = smem_addr(sK + s * kKVBytes);
    const uint32_t vaddr = smem_addr(sV + s * kKVBytes);

    // S = Q K^T, 64 rows x BKV keys per warpgroup; k-step kk reads 16
    // columns: 32 bytes into atom kk / 4 (both operands K-major)
    float sc[BKV / 2];
    mbar_wait(&k_full[s], ph);
    wgmma_fence();
    for (int kk = 0; kk < ksteps; ++kk) {
      const uint32_t off = (kk & 3) * 32;
      wgmma_ss<BKV>(sc,
                    desc_sw128(qaddr + (kk >> 2) * kQRows * 128 + off, 16,
                               1024),
                    desc_sw128(kaddr + (kk >> 2) * BKV * 128 + off, 16, 1024),
                    kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) reg_fence(sc[i]);
    if (lane == 0) mbar_arrive(&k_empty[s]);

    // online softmax in the log2 domain. Element 4jj + e: row g (e < 2) or
    // g + 8, key j*BKV + 8jj + 2t + (e & 1)
    if (j * BKV + BKV > M) {
#pragma unroll
      for (int jj = 0; jj < BKV / 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (j * BKV + jj * 8 + 2 * t + (e & 1) >= M) {
            sc[4 * jj + e] = -INFINITY;
          }
        }
      }
    }
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) {
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    }
    float ms[2];
    float alpha[2];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      ms[r] = mx[r] * scale_log2;
      alpha[r] = exp2f(m_run[r] * scale_log2 - ms[r]);  // 0 on the first tile
      m_run[r] = mx[r];
    }
    // one FFMA folds the scale and the running max into each score
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) {
      const int r = (i >> 1) & 1;
      sc[i] = exp2f(fmaf(sc[i], scale_log2, -ms[r]));
      rs[r] += sc[i];
    }
    // row sums stay per thread until the end: alpha is uniform in a quad
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rs[r];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) oacc[i] *= alpha[(i >> 1) & 1];

    // O += P V: the score accumulators of key blocks 2kk, 2kk+1 are the A
    // fragment of keys 16kk .. 16kk+15
    uint32_t pa[BKV / 16][4];
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
    mbar_wait(&v_full[s], ph);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      // B: keys 16kk .. +15 (2048 bytes per 16 rows), N-major; 64-column
      // atoms BKV*128 bytes apart, 8-row groups 1024 apart
      wgmma_rs<DV>(oacc, pa[kk],
                   desc_sw128(vaddr + kk * 2048, BKV * 128, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) reg_fence(oacc[i]);
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) reg_fence(pa[kk][r]);
    if (lane == 0) mbar_arrive(&v_empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const float inv0 = 1.f / l_run[0];
  const float inv1 = 1.f / l_run[1];
  const int r_lo = n0 + wgi * 64 + wi * 16 + g;
  const int r_hi = r_lo + 8;
#pragma unroll
  for (int i = 0; i < DV / 8; ++i) {
    const int d = i * 8 + 2 * t;
    if (d >= D) continue;
    if (r_lo < N) {
      store2<__nv_bfloat16>(
          o + ((static_cast<size_t>(b) * N + r_lo) * H + h) * D + d,
          oacc[4 * i] * inv0, oacc[4 * i + 1] * inv0);
    }
    if (r_hi < N) {
      store2<__nv_bfloat16>(
          o + ((static_cast<size_t>(b) * N + r_hi) * H + h) * D + d,
          oacc[4 * i + 2] * inv1, oacc[4 * i + 3] * inv1);
    }
  }
  if (lse != nullptr && t == 0) {  // natural log of the scaled row sum
    float* lb = lse + (static_cast<size_t>(b) * H + h) * N;
    if (r_lo < N) lb[r_lo] = (m_run[0] * scale_log2 + log2f(l_run[0])) * kLn2;
    if (r_hi < N) lb[r_hi] = (m_run[1] * scale_log2 + log2f(l_run[1])) * kLn2;
  }
}

// a tensor map over (D, H, rows, B) of a (B, rows, H, D) tensor, boxes of
// 64 columns x `box_rows` rows of one head
cudaError_t head_map(CUtensorMap* map, const void* base, int B, int rows,
                     int H, int D, int box_rows) {
  const uint64_t esz = sizeof(__nv_bfloat16);
  const uint64_t dims[4] = {static_cast<uint64_t>(D), static_cast<uint64_t>(H),
                            static_cast<uint64_t>(rows),
                            static_cast<uint64_t>(B)};
  const uint64_t strides[3] = {dims[0] * esz, dims[0] * dims[1] * esz,
                               dims[0] * dims[1] * dims[2] * esz};
  const uint32_t box[4] = {64, 1, static_cast<uint32_t>(box_rows), 1};
  return sm90::make_tensor_map(map, base, 4, dims, strides, box);
}

template <int DP, int DV, int BKV>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 float* lse, int B, int N, int M, int H, int D, float scale,
                 cudaStream_t stream) {
  using namespace wg;
  CUtensorMap qmap, kmap, vmap;
  cudaError_t err = head_map(&qmap, q, B, N, H, D, kQRows);
  if (err == cudaSuccess) err = head_map(&kmap, k, B, M, H, D, BKV);
  if (err == cudaSuccess) err = head_map(&vmap, v, B, M, H, D, BKV);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = 1024 + static_cast<size_t>(DP / 64) * 128 *
                                 (kQRows + 2 * kStages * BKV) +
                      (1 + 4 * kStages) * 8;
  err = cudaFuncSetAttribute(flash_fwd_kernel_wgmma<DP, DV, BKV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kQRows - 1) / kQRows, B * H);
  flash_fwd_kernel_wgmma<DP, DV, BKV><<<grid, kBlockThreads, smem, stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(o), lse, N, M, H, D,
      scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// D a multiple of 8, at most 160 (the wrapper checks): 40, 80 and 160 are
// the UNet's head dims
int dispatch_wgmma(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int N, int M, int H, int D, float scale,
                   cudaStream_t s) {
  if (D % 8 || D <= 0 || D > 160) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // beyond 128 columns a 64-key tile keeps two stages of K and V within
  // shared memory
  auto* launch = D <= 48   ? &launch_wgmma<64, 48, 128>
                 : D <= 80 ? &launch_wgmma<128, 80, 128>
                           : &launch_wgmma<192, 160, 64>;
  return launch(q, k, v, o, lse, B, N, M, H, D, scale, s);
}

}  // namespace

// q, k, v, o of one type: f32 when `f32` is nonzero (the mma.sync kernel),
// else bf16 (the wgmma kernel). lse may be null (no log-sum-exp written).
extern "C" int onedc_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* o, void* lse,
                                         int B, int N, int M, int H, int D,
                                         float scale, int f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  return f32 ? dispatch<float>(q, k, v, o, l, B, N, M, H, D, scale, s)
             : dispatch_wgmma(q, k, v, o, l, B, N, M, H, D, scale, s);
}
