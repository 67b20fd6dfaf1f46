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
// One kernel, flash_fwd_kernel_wgmma, for bf16 (the decode path) and f32
// (the training path, with the LSE). A block owns the query rows of one
// (batch, head), 64 per consumer warpgroup (two; three for f32 up to
// D = 48, where they fit: the rounding below is then shared by 192
// rows), and has a producer. The
// producer fills the Q tile once and K and V tiles through a 2-stage ring
// guarded by mbarriers, as bf16 in the 128-byte swizzled layout, 64
// columns per atom, the columns past D zero, so D is padded in shared
// memory only:
// - bf16: one producer warp loads by TMA from tensor maps over
//   (D, H, N, B): a box of 64 columns lands swizzled, zero-filled past D;
// - f32: a producer warpgroup rounds f32 to bf16 as it stages it (as the
//   TPU runs f32 matmuls at default precision), from a staging ring into
//   which TMA lands the Q tile and then each key tile's K and V rows
//   densely, as they are in device memory (sm90::convert_staged; two
//   staging stages up to D = 48, where key tiles are 128, and up to
//   D = 80, where they are 64, one above).
//   setmaxnreg gives the consumers the producer's unused registers.
// S = Q K^T runs on wgmma with both operands in shared memory (k = D
// rounded up to 16); the online softmax folds the scale and the running
// max into one FFMA per score before exp2; P is re-packed from S's
// accumulator into registers as the A operand of O += P V (wgmma, V in
// shared memory N-major: "transposed", N = 48, 80 or 160), f32
// accumulate. The two warpgroups run independently on the shared ring, so
// one's softmax can overlap the other's products. The output is stored in
// the input's type from the accumulators; the ragged N and M edges are
// masked.

#include "sm90.cuh"

#include <math.h>

namespace {

using namespace onedc;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

namespace wg {

constexpr int kStages = 2;        // K and V tiles in flight
// the producer: one warp (bf16, TMA) or a warpgroup (f32)
template <typename T>
constexpr int kProducerWarps = kIsBf16<T> ? 1 : 4;
// kWG consumer warpgroups of 64 query rows and the producer
template <typename T, int kWG>
constexpr int kBlockThreads = (4 * kWG + kProducerWarps<T>) * 32;
// f32: the Q tile, then the K and V rows of each key tile, land densely
// by TMA in a staging ring (capacity DV columns) that the producer
// warpgroup rounds into the bf16 tiles; two stages where they fit
template <typename T, int DV, int BKV>
constexpr int kStgBytes = kIsBf16<T> ? 0 : 2 * BKV * DV * 4;
template <typename T, int DV, int BKV>
constexpr int kStgStages = kStgBytes<T, DV, BKV> <= 48 * 1024 ? 2 : 1;
// f32: registers per thread of the producer warpgroup and of the consumers
// after setmaxnreg; they add up to what the block starts with, 65,536 /
// threads rounded down to 8 (setmaxnreg.inc takes only what the block's
// warps gave up): 128 x 104 + 256 x 200 = 384 x 168, 128 x 56 + 384 x 152
// = 512 x 128
constexpr int kProducerRegs[2] = {104, 56};
constexpr int kConsumerRegs[2] = {200, 152};

}  // namespace wg

// DP: D rounded up to 64 (the columns staged, 64 per 128-byte atom); DV: the
// output columns computed (48, 80 or 160); BKV: keys per tile. The tensor
// maps box bf16 rows swizzled (T = bf16) or f32 rows densely (T = float).
template <int DP, int DV, int BKV, typename T, int kWG>
__global__ void __launch_bounds__(wg::kBlockThreads<T, kWG>, 1)
    flash_fwd_kernel_wgmma(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           T* __restrict__ o,
                           float* __restrict__ lse, int N, int M, int H, int D,
                           float scale_log2) {
  using namespace wg;
  using namespace sm90;
  constexpr int kQRows = 64 * kWG;
  constexpr int kConsumerWarps = 4 * kWG;
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
  constexpr int kSF = kStgStages<T, DV, BKV>;
  unsigned char* stg = sV + kStages * kKVBytes;  // f32: [kSF][K, V][BKV][D]
  static_assert(kIsBf16<T> || 2 * BKV >= kQRows, "a stage holds the Q tile");
  uint64_t* q_full =
      reinterpret_cast<uint64_t*>(stg + kSF * kStgBytes<T, DV, BKV>);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + kStages;
  uint64_t* v_full = k_empty + kStages;
  uint64_t* v_empty = v_full + kStages;
  uint64_t* stg_full = v_empty + kStages;  // f32 only

  const int n0 = blockIdx.x * kQRows;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int ntiles = (M + BKV - 1) / BKV;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, kProducerWarps<T>);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], kProducerWarps<T>);
      mbar_init(&v_full[s], kProducerWarps<T>);
      mbar_init(&k_empty[s], kConsumerWarps);
      mbar_init(&v_empty[s], kConsumerWarps);
    }
    if constexpr (!kIsBf16<T>) {
      for (int s = 0; s < kSF; ++s) mbar_init(&stg_full[s], 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // the producer. The bf16 test stays warp == kConsumerWarps: one
  // instruction less ahead of the main loop (warp >= ...) moved the
  // loop's code and cost the decode's D = 40 kernel 8 % on an H100
  if constexpr (kIsBf16<T>) {
    if (warp == kConsumerWarps) {  // one thread issues every TMA load
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
  } else if (warp >= kConsumerWarps) {
    // a warpgroup rounds to bf16 and writes the swizzled tiles, from a
    // staging ring that TMA fills with the Q tile (step 0: 128 rows fill
    // a stage) and then each key tile's K and V rows (step j + 1)
    reg_dealloc<kProducerRegs[kWG - 2]>();
    const int pt = threadIdx.x - kConsumerWarps * 32;
    constexpr int kThreadsP = kProducerWarps<T> * 32;
    auto staged = [&](int sf, int i) {  // i = 0: K (or Q), 1: V
      return stg + sf * kStgBytes<T, DV, BKV> + i * BKV * DV * 4;
    };
    auto issue = [&](int e) {  // one thread: staging step e
      const int sf = e % kSF;
      fence_proxy_async();  // the warpgroup's reads of the stage first
      if (e == 0) {
        mbar_arrive_expect_tx(&stg_full[sf], kQRows * D * sizeof(T));
        tma_load_4d(staged(sf, 0), &qmap, &stg_full[sf], 0, h, n0, b);
      } else {
        mbar_arrive_expect_tx(&stg_full[sf], 2 * BKV * D * sizeof(T));
        tma_load_4d(staged(sf, 0), &kmap, &stg_full[sf], 0, h,
                    (e - 1) * BKV, b);
        tma_load_4d(staged(sf, 1), &vmap, &stg_full[sf], 0, h,
                    (e - 1) * BKV, b);
      }
    };
    if (pt == 0) {
      for (int e = 0; e < kSF && e <= ntiles; ++e) issue(e);
    }
    for (int e = 0; e <= ntiles; ++e) {
      const int sf = e % kSF;
      mbar_wait(&stg_full[sf], (e / kSF) & 1);
      if (e == 0) {
        unsigned char* const dst[1] = {sQ};
        const T* const src[1] = {reinterpret_cast<const T*>(staged(sf, 0))};
        convert_staged<DV, 1>(dst, src, kQRows, kQRows, D, pt, kThreadsP);
      } else {
        const int s = (e - 1) % kStages;
        const uint32_t ph = (((e - 1) / kStages) & 1) ^ 1;
        mbar_wait(&k_empty[s], ph);
        mbar_wait(&v_empty[s], ph);
        unsigned char* const dst[2] = {sK + s * kKVBytes,
                                       sV + s * kKVBytes};
        const T* const src[2] = {reinterpret_cast<const T*>(staged(sf, 0)),
                                 reinterpret_cast<const T*>(staged(sf, 1))};
        convert_staged<DV, 2>(dst, src, BKV, BKV, D, pt, kThreadsP);
      }
      // this warp's stores before the async proxy (wgmma), one arrival
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
        if (e == 0) {
          mbar_arrive(q_full);
        } else {
          mbar_arrive(&k_full[(e - 1) % kStages]);
          mbar_arrive(&v_full[(e - 1) % kStages]);
        }
      }
      // every thread is done reading stage sf: refill it
      named_barrier_sync(1, kThreadsP);
      if (pt == 0 && e + kSF <= ntiles) issue(e + kSF);
    }
    return;
  }

  if constexpr (!kIsBf16<T>) reg_alloc<kConsumerRegs[kWG - 2]>();
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
      store2<T>(o + ((static_cast<size_t>(b) * N + r_lo) * H + h) * D + d,
                oacc[4 * i] * inv0, oacc[4 * i + 1] * inv0);
    }
    if (r_hi < N) {
      store2<T>(o + ((static_cast<size_t>(b) * N + r_hi) * H + h) * D + d,
                oacc[4 * i + 2] * inv1, oacc[4 * i + 3] * inv1);
    }
  }
  if (lse != nullptr && t == 0) {  // natural log of the scaled row sum
    float* lb = lse + (static_cast<size_t>(b) * H + h) * N;
    if (r_lo < N) lb[r_lo] = (m_run[0] * scale_log2 + log2f(l_run[0])) * kLn2;
    if (r_hi < N) lb[r_hi] = (m_run[1] * scale_log2 + log2f(l_run[1])) * kLn2;
  }
}

template <int DP, int DV, int BKV, typename T, int kWG>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 float* lse, int B, int N, int M, int H, int D, float scale,
                 cudaStream_t stream) {
  using namespace wg;
  constexpr int kQRows = 64 * kWG;
  CUtensorMap qmap{}, kmap{}, vmap{};
  cudaError_t err = cudaSuccess;
  if constexpr (kIsBf16<T>) {
    err = sm90::head_map<T>(&qmap, q, B, N, H, D, 64, kQRows, false);
    if (err == cudaSuccess) {
      err = sm90::head_map<T>(&kmap, k, B, M, H, D, 64, BKV, false);
    }
    if (err == cudaSuccess) {
      err = sm90::head_map<T>(&vmap, v, B, M, H, D, 64, BKV, false);
    }
  } else {
    err = sm90::head_map<T>(&qmap, q, B, N, H, D, D, kQRows, true);
    if (err == cudaSuccess) {
      err = sm90::head_map<T>(&kmap, k, B, M, H, D, D, BKV, true);
    }
    if (err == cudaSuccess) {
      err = sm90::head_map<T>(&vmap, v, B, M, H, D, D, BKV, true);
    }
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kSF = kStgStages<T, DV, BKV>;
  const size_t smem = 1024 + static_cast<size_t>(DP / 64) * 128 *
                                 (kQRows + 2 * kStages * BKV) +
                      static_cast<size_t>(kSF) * kStgBytes<T, DV, BKV> +
                      (1 + 4 * kStages + (kIsBf16<T> ? 0 : kSF)) * 8;
  err = cudaFuncSetAttribute(flash_fwd_kernel_wgmma<DP, DV, BKV, T, kWG>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kQRows - 1) / kQRows, B * H);
  flash_fwd_kernel_wgmma<DP, DV, BKV, T, kWG>
      <<<grid, kBlockThreads<T, kWG>, smem, stream>>>(
          qmap, kmap, vmap, static_cast<T*>(o), lse, N, M, H, D,
          scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// D a multiple of 8, at most 160 (the wrapper checks): 40, 80 and 160 are
// the UNet's head dims, 8 the encoder UNet's /16 attention in training
template <typename T>
int dispatch_wgmma(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int N, int M, int H, int D, float scale,
                   cudaStream_t s) {
  if (D % 8 || D <= 0 || D > 160) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // beyond 128 columns a 64-key tile keeps two stages of K and V within
  // shared memory; f32 also keeps a staging ring there, so that its key
  // tiles are 64 from D = 56, and it runs three consumer warpgroups (192
  // query rows) where they fit, up to D = 48
  constexpr int kBKV80 = kIsBf16<T> ? 128 : 64;
  constexpr int kWG48 = kIsBf16<T> ? 2 : 3;
  auto* launch = D <= 48   ? &launch_wgmma<64, 48, 128, T, kWG48>
                 : D <= 80 ? &launch_wgmma<128, 80, kBKV80, T, 2>
                           : &launch_wgmma<192, 160, 64, T, 2>;
  return launch(q, k, v, o, lse, B, N, M, H, D, scale, s);
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
  return f32 ? dispatch_wgmma<float>(q, k, v, o, l, B, N, M, H, D, scale, s)
             : dispatch_wgmma<__nv_bfloat16>(q, k, v, o, l, B, N, M, H, D,
                                             scale, s);
}
