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
// are needed: every output is summed in one fixed order, and two launches
// on the same inputs give the same bits.
//  - dK/dV, flash_bwd_dkv_kernel: a block owns the keys of one (batch,
//    head), 64 per consumer warpgroup (three up to D = 48, where their
//    tiles fit, else two), keeps their K and V tiles in shared memory and
//    walks the query tiles of 64. Per tile, with the keys as
//    wgmma's M so that each product lands in registers where the next
//    needs it:
//        S^T = K Q^T (SS),  P^T = exp2(S^T * scale * log2e - lse * log2e),
//        dV += P^T dO (RS),  dP^T = V dO^T (SS),  dS^T = P^T * (dP^T - di),
//        dK += dS^T Q (RS), dS^T packed where P^T was once dV has read it;
//    lse and di vary along the columns here, so the producer stages them
//    per query tile in shared memory beside Q and dO.
//  - dQ, flash_bwd_dq_kernel: a block owns queries, 64 per consumer
//    warpgroup (as many as above), keeps their Q and dO tiles and walks
//    the key tiles of 64:
//        S = Q K^T (SS),  P,  dP = dO V^T (SS),  dS = P * (dP - di),
//        dQ += dS K (RS).
// SS: both operands in shared memory, K-major (D contiguous). RS: the A
// operand (P^T, dS^T or dS) re-packed from the accumulator fragment into
// registers as bf16, as the forward packs P; the B operand (dO, Q or K
// rows) in shared memory N-major ("transposed"), N = D rounded up to 16,
// 40, 48, 80 or 128. The pair does 7 products of N*M*D per head (against the
// bound's 5: S twice) and takes the exponentials twice. Every product
// retires within its tile (see the dK/dV loop).
//
// Loads: a producer warpgroup fills the resident tiles once and streams
// the other pair through two rings: TMA lands rows densely, as they are
// in device memory (f32 or bf16), in a staging ring (two stages up to
// D = 80), and the warpgroup rounds them to bf16 into the resident tiles
// or the 128-byte swizzled ring (three stages at D <= 48, two above) that
// wgmma's descriptors read, D zero-padded there and never in device
// memory (sm90::convert_staged).
// f32 is thus rounded to bf16 as it is staged, as the TPU runs f32
// matmuls at default precision; the products accumulate in f32. At D <= 16
// in f32 the scores are the exception: there the gradients are
// ill-conditioned in q and k (rounded operands moved dQ by 2 % of its
// largest value), so the producer stages Q and K as bf16 hi and lo parts
// side by side and S takes three k-steps, hi*hi + lo*hi + hi*lo
// (sm90::convert_staged_split), as the forward does there, so that P here
// is the forward's; and the wrapper computes di from the dout that dP
// reads, rounded to bf16, so that di = rowsum(P * dP) in the kernel's own
// arithmetic.
// setmaxnreg gives the consumers the producer's unused registers.
//
// Layout: q, dq (B, N, H, D); k, v, dk, dv (B, M, H, D); dout (B, N, H,
// D); lse and di (B, H, N) f32; all contiguous, 16-byte aligned, D a
// multiple of 8, at most 128. dq, dk, dv are stored in q's type from the
// accumulators; the ragged N and M edges are masked.
//
// What bounds it on the H100: ~10*N*M*D FLOPs per head on the tensor cores
// (14 as done here) against ~40*N*D bytes (f32), far above the ridge, and
// N*M exponentials: the tensor cores at the training shapes, except D = 8
// (the exponentials).

#include "sm90.cuh"

#include <math.h>

namespace {

using namespace onedc;

constexpr float kLog2e = 1.4426950408889634f;

constexpr int kTile = 64;   // streamed queries (dK/dV) or keys (dQ)
constexpr int kProducerWarps = 4;

// A block: kWG consumer warpgroups of 64 resident keys (dK/dV) or queries
// (dQ) each, and a producer warpgroup. Registers per thread after
// setmaxnreg: the producer's and the consumers' add up to what the block
// starts with, 65,536 / threads rounded down to 8 (setmaxnreg.inc takes
// only what the block's warps gave up): 128 x 104 + 256 x 200 = 384 x 168,
// 128 x 56 + 384 x 152 = 512 x 128.
template <int kWG>
struct Block {
  static_assert(kWG == 2 || kWG == 3, "two or three consumer warpgroups");
  static constexpr int kRows = 64 * kWG;
  static constexpr int kConsumerWarps = 4 * kWG;
  static constexpr int kThreads = (kConsumerWarps + kProducerWarps) * 32;
  static constexpr int kProducerRegs = kWG == 2 ? 104 : 56;
  static constexpr int kConsumerRegs = kWG == 2 ? 200 : 152;
};

// columns staged per row for DV computed: D's columns and the zeros that
// pad them to the 16 a k-step reads
template <int DV>
constexpr int kStagedCols = (DV + 15) / 16 * 16;

// f32 at D <= 16: S from hi and lo bf16 parts of Q and K (see the top)
template <typename T, int DV>
constexpr bool kSplitS = !kIsBf16<T> && DV == 16;
// k-steps of 16 columns of S at most: three segments of D's when split
template <typename T, int DV>
constexpr int kSSteps = (kSplitS<T, DV> ? 3 : 1) * kStagedCols<DV> / 16;

// Shared memory of both kernels, 1024-aligned: two resident tiles of kRows
// rows, a ring of kStages pairs of streamed tiles of kTile rows (each
// [DP / 64 atoms][rows][128 bytes]), the dK/dV kernel's lse * log2(e) and
// di rows per stage, a staging ring of kStg pairs of streamed tiles as TMA
// lands them (dense rows of D <= DV columns of f32 or bf16), and the
// barriers. Three bf16 stages and two staging stages where they fit.
template <int DP, int DV, int kWG>
struct Smem {
  static constexpr int kRows = Block<kWG>::kRows;
  static constexpr int kStages = DP == 64 ? 3 : 2;
  static constexpr int kStg = DV <= 48 ? 3 : DV <= 80 ? 2 : 1;
  static constexpr int kResBytes = DP / 64 * kRows * 128;
  static constexpr int kTileBytes = DP / 64 * kTile * 128;
  static constexpr int kStgTileBytes = kTile * DV * 4;  // f32 capacity
  static constexpr int kRowsOff = 2 * kResBytes + 2 * kStages * kTileBytes;
  static constexpr int kStgOff = kRowsOff + kStages * 2 * kTile * 4;
  static constexpr int kBarOff = kStgOff + kStg * 2 * kStgTileBytes;
  static constexpr size_t kBytes =
      1024 + kBarOff + (1 + 2 * kStages + kStg) * 8;
  unsigned char* base;
  __device__ unsigned char* res(int i) const { return base + i * kResBytes; }
  __device__ unsigned char* tile(int s, int i) const {
    return base + 2 * kResBytes + (2 * s + i) * kTileBytes;
  }
  __device__ float* rows(int s, int i) const {  // i = 0: lse * log2(e), 1: di
    return reinterpret_cast<float*>(base + kRowsOff) + (2 * s + i) * kTile;
  }
  __device__ unsigned char* staged(int sf, int i) const {
    return base + kStgOff + (2 * sf + i) * kStgTileBytes;
  }
  __device__ uint64_t* res_full() const {
    return reinterpret_cast<uint64_t*>(base + kBarOff);
  }
  __device__ uint64_t* full(int s) const { return res_full() + 1 + s; }
  __device__ uint64_t* empty(int s) const {
    return res_full() + 1 + kStages + s;
  }
  __device__ uint64_t* stg_full(int sf) const {
    return res_full() + 1 + 2 * kStages + sf;
  }
};
static_assert(Smem<128, 80, 2>::kBytes <= 232448, "shared memory");
static_assert(Smem<128, 128, 2>::kBytes <= 232448, "shared memory");
static_assert(Smem<64, 48, 3>::kBytes <= 232448, "shared memory");

template <int DP, int DV, int kWG>
__device__ __forceinline__ Smem<DP, DV, kWG> smem_layout() {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle is a function of the shared address: 1024-align
  return Smem<DP, DV, kWG>{
      smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023)};
}

template <int DP, int DV, int kWG>
__device__ __forceinline__ void init_barriers(const Smem<DP, DV, kWG>& sm) {
  if (threadIdx.x == 0) {
    sm90::mbar_init(sm.res_full(), kProducerWarps);
    for (int s = 0; s < sm.kStages; ++s) {
      sm90::mbar_init(sm.full(s), kProducerWarps);
      sm90::mbar_init(sm.empty(s), Block<kWG>::kConsumerWarps);
    }
    for (int sf = 0; sf < sm.kStg; ++sf) sm90::mbar_init(sm.stg_full(sf), 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
}

// Rounds a staged pair (the S operand, then dO or V) into its tiles; with
// kSplitS the S operand as hi and lo parts, its lo in segment lo_seg: 1 for
// the resident tile (the A operand of S or S^T), 2 for the streamed one.
template <int DV, typename T>
__device__ __forceinline__ void stage_pair(unsigned char* const (&dst)[2],
                                           const T* const (&src)[2], int rows,
                                           int atom_rows, int D, int lo_seg,
                                           int tid, int nthreads) {
  if constexpr (kSplitS<T, DV>) {
    sm90::convert_staged_split<kStagedCols<DV>>(dst[0], src[0], rows,
                                                atom_rows, D, lo_seg, tid,
                                                nthreads);
    unsigned char* const d1[1] = {dst[1]};
    const T* const s1[1] = {src[1]};
    sm90::convert_staged<kStagedCols<DV>, 1>(d1, s1, rows, atom_rows, D, tid,
                                             nthreads);
  } else {
    sm90::convert_staged<kStagedCols<DV>, 2>(dst, src, rows, atom_rows, D,
                                             tid, nthreads);
  }
}

// the producer warp's stores are done: order them before the async proxy
// (wgmma) and arrive once for the warp
__device__ __forceinline__ void arrive_stored(uint64_t* bar) {
  sm90::fence_proxy_async();
  __syncwarp();
  if (threadIdx.x % 32 == 0) sm90::mbar_arrive(bar);
}

// The producer warpgroup. TMA lands row blocks of kTile rows of two
// tensors at a time, densely, in staging stage e % kStg: at steps e <
// kHalves the resident rows r0 + e * kTile (rmap0, rmap1), then at step
// kHalves + j the streamed tile j (smap0, smap1). The warpgroup rounds
// each step into the resident tiles or into ring stage j % kStages once
// the consumers have freed it, and one thread refills the staging stage
// with step e + kStg. Per streamed tile, fetch(j) runs first (global
// loads, in flight while the thread waits) and put(s, value) after the
// ring stage is free and before the consumers are signalled: the dK/dV
// kernel's lse and di rows.
template <int DP, int DV, int kWG, typename T, typename F, typename G>
__device__ __forceinline__ void produce(const Smem<DP, DV, kWG>& sm,
                                        const CUtensorMap* rmap0,
                                        const CUtensorMap* rmap1, int r0,
                                        const CUtensorMap* smap0,
                                        const CUtensorMap* smap1, int h,
                                        int b, int ntiles, int D, F&& fetch,
                                        G&& put) {
  constexpr int kP = kProducerWarps * 32;
  constexpr int kHalves = Block<kWG>::kRows / kTile;
  const int pt = threadIdx.x - Block<kWG>::kConsumerWarps * 32;
  const int steps = kHalves + ntiles;
  auto issue = [&](int e) {
    const int sf = e % sm.kStg;
    const bool res = e < kHalves;
    const int row = res ? r0 + e * kTile : (e - kHalves) * kTile;
    sm90::fence_proxy_async();  // the warpgroup's reads of the stage first
    sm90::mbar_arrive_expect_tx(sm.stg_full(sf),
                                2 * kTile * D * sizeof(T));
    sm90::tma_load_4d(sm.staged(sf, 0), res ? rmap0 : smap0, sm.stg_full(sf),
                      0, h, row, b);
    sm90::tma_load_4d(sm.staged(sf, 1), res ? rmap1 : smap1, sm.stg_full(sf),
                      0, h, row, b);
  };
  if (pt == 0) {
    for (int e = 0; e < sm.kStg && e < steps; ++e) issue(e);
  }
  for (int e = 0; e < steps; ++e) {
    const int sf = e % sm.kStg;
    const int j = e - kHalves;
    const float fetched = j >= 0 ? fetch(j) : 0.f;
    sm90::mbar_wait(sm.stg_full(sf), (e / sm.kStg) & 1);
    const T* const src[2] = {reinterpret_cast<const T*>(sm.staged(sf, 0)),
                             reinterpret_cast<const T*>(sm.staged(sf, 1))};
    if (j < 0) {
      unsigned char* const dst[2] = {sm.res(0) + e * kTile * 128,
                                     sm.res(1) + e * kTile * 128};
      stage_pair<DV>(dst, src, kTile, sm.kRows, D, 1, pt, kP);
      if (e == kHalves - 1) arrive_stored(sm.res_full());
    } else {
      const int s = j % sm.kStages;
      sm90::mbar_wait(sm.empty(s), ((j / sm.kStages) & 1) ^ 1);
      unsigned char* const dst[2] = {sm.tile(s, 0), sm.tile(s, 1)};
      stage_pair<DV>(dst, src, kTile, kTile, D, 2, pt, kP);
      put(s, fetched);
      arrive_stored(sm.full(s));
    }
    // every thread is done reading staging stage sf: refill it
    sm90::named_barrier_sync(1, kP);
    if (pt == 0 && e + sm.kStg < steps) issue(e + sm.kStg);
  }
}

// acc (64 x N: 64 resident rows x kTile streamed) = A (the warpgroup's 64
// rows of a resident tile) times B^T (a streamed tile), over the D columns:
// both K-major, ksteps (D / 16 rounded up, or three times that for a split
// S; at most kMaxSteps) of 16 columns, 32 bytes into atom kk / 4. Unrolled,
// and the first k-step only writes acc: a loop would carry acc through
// moves, and a value given to acc beforehand would be one more write, while
// products are in flight (ptxas serialises the products it sees so
// written).
template <int DV, int kRows, int kMaxSteps = kStagedCols<DV> / 16>
__device__ __forceinline__ void product_ss(float* acc, uint32_t a_addr,
                                           uint32_t b_addr, int ksteps) {
  using namespace sm90;
  static_assert(kTile == 64, "wgmma_ss_n64_first");
  wgmma_ss_n64_first(acc, desc_sw128(a_addr, 16, 1024),
                     desc_sw128(b_addr, 16, 1024));
#pragma unroll
  for (int kk = 1; kk < kMaxSteps; ++kk) {
    if (kk >= ksteps) break;
    const uint32_t off = (kk & 3) * 32;
    wgmma_ss<kTile>(acc,
                    desc_sw128(a_addr + (kk >> 2) * kRows * 128 + off, 16,
                               1024),
                    desc_sw128(b_addr + (kk >> 2) * kTile * 128 + off, 16,
                               1024),
                    1);
  }
}

// acc (64 x DV) += A (64 x kTile, bf16 fragments in registers) times the
// streamed tile at b_addr (kTile rows x DV columns, N-major: 64-column
// atoms kTile * 128 bytes apart, 8-row groups 1024 apart)
template <int DV>
__device__ __forceinline__ void product_rs(float* acc,
                                           const uint32_t (&a)[kTile / 16][4],
                                           uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    sm90::wgmma_rs<DV>(acc, a[kk],
                       sm90::desc_sw128(b_addr + kk * 2048, kTile * 128, 1024),
                       1);
  }
}

// the accumulator fragment of 64 x kTile scores as kTile / 16 A fragments:
// key (or query) blocks 2kk, 2kk+1 of the accumulator are the A fragment
// of columns 16kk .. 16kk+15
__device__ __forceinline__ void pack_a(uint32_t (&a)[kTile / 16][4],
                                       const float* x) {
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      a[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
    }
  }
}

template <int N>
__device__ __forceinline__ void fence_regs(float* x) {
#pragma unroll
  for (int i = 0; i < N; ++i) sm90::reg_fence(x[i]);
}

__device__ __forceinline__ void fence_regs(uint32_t (&a)[kTile / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) sm90::reg_fence(a[kk][r]);
}

// Stores a warpgroup's 64 rows x D of acc * mul (the DV-column accumulator
// fragment: element 4i + e is row g + 8 (e / 2), column 8i + 2t + e % 2 of
// the warp's 16) to dst, rows r0 .. of `rows` valid, row stride `stride`.
template <int DV, typename T>
__device__ __forceinline__ void store_rows(T* dst, const float* acc, float mul,
                                           int r0, int rows, size_t stride,
                                           int D) {
  const int lane = threadIdx.x % 32;
  const int r_lo = r0 + (threadIdx.x / 32 % 4) * 16 + (lane >> 2);
  const int r_hi = r_lo + 8;
#pragma unroll
  for (int i = 0; i < DV / 8; ++i) {
    const int d = i * 8 + 2 * (lane & 3);
    if (d >= D) continue;
    if (r_lo < rows) {
      store2<T>(dst + r_lo * stride + d, acc[4 * i] * mul,
                acc[4 * i + 1] * mul);
    }
    if (r_hi < rows) {
      store2<T>(dst + r_hi * stride + d, acc[4 * i + 2] * mul,
                acc[4 * i + 3] * mul);
    }
  }
}

// DP: D rounded up to 64 (columns staged per row, 64 per atom); DV: the
// columns computed (D rounded up to 16, 40, 48, 80 or 128)
template <int DP, int DV, int kWG, typename T>
__global__ void __launch_bounds__(Block<kWG>::kThreads, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap omap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const float* __restrict__ lse,
                         const float* __restrict__ di, T* __restrict__ dk,
                         T* __restrict__ dv, int N, int M, int H, int D,
                         float scale, float scale_log2) {
  using Blk = Block<kWG>;
  const Smem<DP, DV, kWG> sm = smem_layout<DP, DV, kWG>();
  init_barriers(sm);
  const int m0 = blockIdx.x * Blk::kRows;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const size_t stride = static_cast<size_t>(H) * D;
  const size_t head = static_cast<size_t>(h) * D;
  const size_t kv0 = (static_cast<size_t>(b) * M + m0) * stride + head;
  const int ntiles = (N + kTile - 1) / kTile;
  const int warp = threadIdx.x / 32;

  if (warp >= Blk::kConsumerWarps) {  // the producer warpgroup
    sm90::reg_dealloc<Blk::kProducerRegs>();
    const int pt = threadIdx.x - Blk::kConsumerWarps * 32;
    const size_t row0 = (static_cast<size_t>(b) * H + h) * N;
    // threads 0..63 stage lse * log2(e), 64..127 di; a query past N gets
    // lse = +inf, so that its probabilities are exp2(-inf) = 0
    produce<DP, DV, kWG, T>(
        sm, &kmap, &vmap, m0, &qmap, &omap, h, b, ntiles, D,
        [&](int i) {
          const int qi = i * kTile + pt % kTile;
          return pt < kTile ? (qi < N ? lse[row0 + qi] * kLog2e : INFINITY)
                            : (qi < N ? di[row0 + qi] : 0.f);
        },
        [&](int s, float x) { sm.rows(s, pt / kTile)[pt % kTile] = x; });
    return;
  }

  sm90::reg_alloc<Blk::kConsumerRegs>();
  // consumers: warpgroup wgi owns keys m0 + 64*wgi .. +63; in each
  // fragment the thread holds rows g and g + 8 of its warp's 16 and the
  // columns 8jj + 2t + e % 2
  const int wgi = warp / 4;
  const int t = threadIdx.x % 4;
  const int ksteps = (D + 15) / 16;
  const int ssteps = kSplitS<T, DV> ? 3 * ksteps : ksteps;
  const uint32_t kaddr = sm90::smem_addr(sm.res(0)) + wgi * 64 * 128;
  const uint32_t vaddr = sm90::smem_addr(sm.res(1)) + wgi * 64 * 128;

  float acc_dk[DV / 2], acc_dv[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;
  uint32_t a_p[kTile / 16][4];
  sm90::mbar_wait(sm.res_full(), 0);

  // Every register a product writes or reads is touched again only after
  // the wait that retires it, and every product retires within its tile:
  // a write to one while products are in flight (a loop's back-edge moving
  // an accumulator, too) makes ptxas serialise every product. One A
  // fragment serves P^T and then dS^T, so that three warpgroups' registers
  // fit.
  for (int i = 0; i < ntiles; ++i) {
    const int s = i % sm.kStages;
    sm90::mbar_wait(sm.full(s), (i / sm.kStages) & 1);
    const uint32_t qaddr = sm90::smem_addr(sm.tile(s, 0));
    const uint32_t oaddr = sm90::smem_addr(sm.tile(s, 1));
    const float* l2 = sm.rows(s, 0);
    const float* dd = sm.rows(s, 1);

    float p[kTile / 2], dp[kTile / 2];
    sm90::wgmma_fence();
    product_ss<DV, Blk::kRows, kSSteps<T, DV>>(p, kaddr, qaddr,
                                               ssteps);  // S^T = K Q^T
    product_ss<DV, Blk::kRows>(dp, vaddr, oaddr, ksteps);  // dP^T = V dO^T
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    fence_regs<kTile / 2>(p);
    fence_regs<kTile / 2>(dp);
#pragma unroll
    for (int jj = 0; jj < kTile / 8; ++jj) {
      const float2 l = *reinterpret_cast<const float2*>(l2 + 8 * jj + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[4 * jj + e] =
            exp2f(fmaf(p[4 * jj + e], scale_log2, (e & 1) ? -l.y : -l.x));
      }
    }
    pack_a(a_p, p);
    sm90::wgmma_fence();
    product_rs<DV>(acc_dv, a_p, oaddr);  // dV += P^T dO
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    fence_regs<DV / 2>(acc_dv);
    fence_regs(a_p);
#pragma unroll
    for (int jj = 0; jj < kTile / 8; ++jj) {
      const float2 d2 = *reinterpret_cast<const float2*>(dd + 8 * jj + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dp[4 * jj + e] =
            p[4 * jj + e] * (dp[4 * jj + e] - ((e & 1) ? d2.y : d2.x));
      }
    }
    pack_a(a_p, dp);
    sm90::wgmma_fence();
    product_rs<DV>(acc_dk, a_p, qaddr);  // dK += dS^T Q
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    fence_regs<DV / 2>(acc_dk);
    fence_regs(a_p);
    if (threadIdx.x % 32 == 0) sm90::mbar_arrive(sm.empty(s));
  }

  store_rows<DV>(dk + kv0, acc_dk, scale, wgi * 64, M - m0, stride, D);
  store_rows<DV>(dv + kv0, acc_dv, 1.f, wgi * 64, M - m0, stride, D);
}

template <int DP, int DV, int kWG, typename T>
__global__ void __launch_bounds__(Block<kWG>::kThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap omap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const float* __restrict__ lse,
                        const float* __restrict__ di, T* __restrict__ dq,
                        int N, int M, int H, int D, float scale,
                        float scale_log2) {
  using Blk = Block<kWG>;
  const Smem<DP, DV, kWG> sm = smem_layout<DP, DV, kWG>();
  init_barriers(sm);
  const int n0 = blockIdx.x * Blk::kRows;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const size_t stride = static_cast<size_t>(H) * D;
  const size_t head = static_cast<size_t>(h) * D;
  const size_t q0 = (static_cast<size_t>(b) * N + n0) * stride + head;
  const int ntiles = (M + kTile - 1) / kTile;
  const int warp = threadIdx.x / 32;

  if (warp >= Blk::kConsumerWarps) {  // the producer warpgroup
    sm90::reg_dealloc<Blk::kProducerRegs>();
    produce<DP, DV, kWG, T>(sm, &qmap, &omap, n0, &kmap, &vmap, h, b, ntiles,
                            D, [](int) { return 0.f; },
                            [](int, float) {});
    return;
  }

  sm90::reg_alloc<Blk::kConsumerRegs>();
  // consumers: warpgroup wgi owns queries n0 + 64*wgi .. +63; the thread
  // holds rows g and g + 8 of its warp's 16 (e / 2 = 0, 1) and the key
  // columns 8jj + 2t + e % 2
  const int wgi = warp / 4;
  const int lane = threadIdx.x % 32;
  const int t = lane & 3;
  const int ksteps = (D + 15) / 16;
  const int ssteps = kSplitS<T, DV> ? 3 * ksteps : ksteps;
  const uint32_t qaddr = sm90::smem_addr(sm.res(0)) + wgi * 64 * 128;
  const uint32_t oaddr = sm90::smem_addr(sm.res(1)) + wgi * 64 * 128;
  float l2[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = n0 + wgi * 64 + (warp % 4) * 16 + (lane >> 2) + 8 * r;
    const size_t at = (static_cast<size_t>(b) * H + h) * N + row;
    l2[r] = row < N ? lse[at] * kLog2e : 0.f;
    dd[r] = row < N ? di[at] : 0.f;
  }

  float acc[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
  uint32_t a[kTile / 16][4];
  sm90::mbar_wait(sm.res_full(), 0);

  // Every product retires within its tile, as in the dK/dV kernel.
  for (int j = 0; j < ntiles; ++j) {
    const int s = j % sm.kStages;
    sm90::mbar_wait(sm.full(s), (j / sm.kStages) & 1);
    const uint32_t kaddr = sm90::smem_addr(sm.tile(s, 0));
    const uint32_t vaddr = sm90::smem_addr(sm.tile(s, 1));

    float p[kTile / 2], dp[kTile / 2];
    sm90::wgmma_fence();
    product_ss<DV, Blk::kRows, kSSteps<T, DV>>(p, qaddr, kaddr,
                                               ssteps);  // S = Q K^T
    product_ss<DV, Blk::kRows>(dp, oaddr, vaddr, ksteps);  // dP = dO V^T
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    fence_regs<kTile / 2>(p);
    fence_regs<kTile / 2>(dp);
    const int m0 = j * kTile;
#pragma unroll
    for (int i = 0; i < kTile / 2; ++i) {
      p[i] = exp2f(fmaf(p[i], scale_log2, -l2[(i >> 1) & 1]));
    }
    if (m0 + kTile > M) {  // keys past M (zero rows of K) weigh nothing
#pragma unroll
      for (int i = 0; i < kTile / 2; ++i) {
        if (m0 + (i >> 2) * 8 + 2 * t + (i & 1) >= M) p[i] = 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < kTile / 2; ++i) {
      dp[i] = p[i] * (dp[i] - dd[(i >> 1) & 1]);
    }
    pack_a(a, dp);
    sm90::wgmma_fence();
    product_rs<DV>(acc, a, kaddr);  // dQ += dS K
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    fence_regs<DV / 2>(acc);
    fence_regs(a);
    if (lane == 0) sm90::mbar_arrive(sm.empty(s));
  }

  store_rows<DV>(dq + q0, acc, scale, wgi * 64, N - n0, stride, D);
}

// a block: three consumer warpgroups where their resident tiles and rings
// fit beside the staging ring (D <= 48), else two
template <int DP>
constexpr int kWGs = DP == 64 ? 3 : 2;

template <int DP, int DV, typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* di,
                   void* dq, void* dk, void* dv, int B, int N, int M, int H,
                   int D, float scale, cudaStream_t stream) {
  using Blk = Block<kWGs<DP>>;
  constexpr size_t smem = Smem<DP, DV, kWGs<DP>>::kBytes;
  // a function attribute belongs to the current device: set on every launch
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<DP, DV, kWGs<DP>, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<DP, DV, kWGs<DP>, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const float scale_log2 = scale * kLog2e;
  // dense boxes of kTile rows x D columns
  CUtensorMap qmap, omap, kmap, vmap;
  err = sm90::head_map<T>(&qmap, q, B, N, H, D, D, kTile, true);
  if (err == cudaSuccess) {
    err = sm90::head_map<T>(&omap, dout, B, N, H, D, D, kTile, true);
  }
  if (err == cudaSuccess) {
    err = sm90::head_map<T>(&kmap, k, B, M, H, D, D, kTile, true);
  }
  if (err == cudaSuccess) {
    err = sm90::head_map<T>(&vmap, v, B, M, H, D, D, kTile, true);
  }
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<DP, DV, kWGs<DP>, T>
      <<<dim3((M + Blk::kRows - 1) / Blk::kRows, B * H), Blk::kThreads, smem,
         stream>>>(qmap, omap, kmap, vmap, lse, di, static_cast<T*>(dk),
                   static_cast<T*>(dv), N, M, H, D, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<DP, DV, kWGs<DP>, T>
      <<<dim3((N + Blk::kRows - 1) / Blk::kRows, B * H), Blk::kThreads, smem,
         stream>>>(qmap, omap, kmap, vmap, lse, di, static_cast<T*>(dq), N,
                   M, H, D, scale, scale_log2);
  return cudaGetLastError();
}

// D a multiple of 8, at most 128 (the wrapper checks): 8, 40 and 80 are the
// training path's head dims
template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* dout,
             const float* lse, const float* di, void* dq, void* dk, void* dv,
             int B, int N, int M, int H, int D, float scale, cudaStream_t s) {
  if (D % 8 || D <= 0 || D > 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* fn = D <= 16   ? &launch<64, 16, T>
             : D <= 40 ? &launch<64, 40, T>
             : D <= 48 ? &launch<64, 48, T>
             : D <= 80 ? &launch<128, 80, T>
                       : &launch<128, 128, T>;
  return static_cast<int>(
      fn(q, k, v, dout, lse, di, dq, dk, dv, B, N, M, H, D, scale, s));
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
