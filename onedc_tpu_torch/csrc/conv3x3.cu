// 3x3 stride-1 "same" convolutions for Hopper (implicit GEMM on wgmma):
//
// K2, fused GroupNorm-affine + SiLU + 3x3 conv. Replaces the Pallas TPU
// kernel onedc_tpu/ops/pallas_conv.py:292 (_conv3x3_v2_single, body
// _kernel_v2 :219), entered through affine_silu_conv3x3 :404. Computes
//     out[b] = conv3x3(silu(x[b] * mul[b, c] + add[b, c])) + bias
// with a zero border applied AFTER the SiLU, so the normalised tensor never
// reaches device memory. bf16 (the decode path):
// gn_silu_conv3x3_kernel_wgmma; f32 (the training forward):
// gn_silu_conv3x3_kernel_wgmma_f32.
//
// K3, the plain 3x3 conv of the input gradient, f32 (training):
// conv3x3_dx_kernel_wgmma computes dx = conv3x3(g, flip(w)^T) for output
// gradient g and the forward conv's weights w. Replaces
// onedc_tpu/ops/pallas_conv.py:89 (_conv3x3_pallas_single, body _kernel
// :43), entered through conv3x3_same :153, whose VJP runs the same kernel
// on flipped, transposed weights for dx (:164-179): on this path it is the
// input gradient of every K2 conv in training. The TPU version staged three
// dx-shifted copies of the input in HBM so that its DMAs stayed aligned;
// Hopper needs no such copies.
//
// All three are one body (conv3x3_wgmma below) and differ only in how the
// input patch reaches shared memory, in the weights' tap order and in the
// epilogue.
//
// Layout: x (B, H, W, Cin) NHWC; mul, add (B, Cin) f32; w (3, 3, Cin, Cout)
// bf16, i.e. [tap][Cin][Cout] viewed as (9*Cin, Cout); out (B, H, W, Cout)
// NHWC. bf16 K2: x, bias, out bf16. f32 K2: x, bias, out f32, w the bf16
// copy of the f32 weights that the wrapper makes per launch. K3: x (= g)
// and out f32, w the bf16 copy of the forward weights transposed to
// (3, 3, Cout_fwd, Cin_fwd) = (3, 3, Cin, Cout) of this conv, NOT flipped:
// the kernel reads tap t's weights from tap 8 - t. Cin and Cout multiples
// of 64; the wrapper checks.
//
// What bounds it on the H100: a conv does 18*H*W*Cin*Cout FLOPs, e.g.
// 768x768x256->128 bf16: ~174 GFLOP on ~453 MB, ~380 FLOP/byte, above the
// ~295 ridge, so the tensor cores bound it (the smaller spatial levels with
// 512 channels are further above it). f32 x and out double those bytes
// and bring the 128-channel training levels to the ridge: 128->128 at
// 512x512 does 77.3 GFLOP on 269 MB per image, 288 FLOP/byte.
//
// An output tile is 16x16 pixels x TN = 128 channels (64 where noted
// below), computed over 64-channel input chunks. bf16: a block per tile,
// TN = 64 where 128-channel tiles would fill the SMs fewer than 3 times
// (the 96x96 decode level). f32: a persistent block per SM walks the tiles
// (output-channel blocks fastest), so the next tile's patches load while
// this tile's last products and its epilogue run; TN = 64 only where Cout
// is not a multiple of 128. Three warpgroups: two consume (8 output rows
// each), the third feeds them. In the third, one warp issues TMA loads of
// the weights of each (tap, chunk), 64 x TN of w viewed as (9*Cin, Cout),
// into a 4-stage ring; the other three warps fill a 3-stage ring of input
// patches, each the chunk's 18x18 pixels (the tile and its 1-pixel halo) x
// 64 channels as bf16 in the 128-byte swizzled layout (41,472 bytes,
// 41,984 with the stage's 1024-byte alignment):
//   - bf16: the first of them loads each patch by TMA, one 4-D box (64
//     channels, 18, 18, 1) of a tensor map over x, zero-filled outside the
//     image, and all three apply affine + SiLU in f32 to it in place
//     (positions outside the image stay 0);
//   - f32: an f32 TMA box of 64 channels (82,944 bytes) does not fit beside
//     the bf16 rings (below), so the three warps load x from device memory
//     themselves, 16 bytes a load with 18 loads in flight per thread,
//     predicated at the border, apply affine + SiLU in f32 (K2) or nothing
//     (K3), round to bf16 and write the swizzled ring, zeros outside the
//     image;
// both while the consumers run the previous chunk's products. SiLU: bf16,
// v/2 * (1 + tanh.approx(v/2)), one special-function op, relative error
// ~2^-11, below the bf16 rounding (2^-9) that follows it; f32 (training),
// v / (1 + exp(-v)) with __expf and __fdividef, within a few ulp of f32:
// with tanh.approx ~8 % of the rounded activations land one bf16 ulp from
// the exact form's, and two AdamW steps carried that to a 1.2e-3 relative
// change of bpp (PERF.md, runs K and L).
// Rings are guarded by mbarriers. The consumers run the 9 taps of a chunk:
// the A operand (pixels x channels) is an ldmatrix of the tap's shifted
// window of the patch into registers (a one-pixel shift breaks the
// alignment a shared-memory A operand needs), the B operand is the weight
// tile through a descriptor (HWIO makes it N-major: "transposed"), and
// wgmma m64nNk16 accumulates in f32 registers, the next k-step's ldmatrix
// overlapping the products in flight. Epilogue: bf16 adds the bias, stages
// the tile in shared memory in the swizzled layout and stores it with TMA;
// f32 (a 16x16x128 f32 tile is 128 KB) adds the f32 bias (K2) and stores
// from the accumulators, each quad of lanes 32 contiguous bytes, masked at
// the image's ragged edge. Output-channel blocks are the fastest tile
// index, so the blocks that share an input patch run together. Each
// output's sum runs over (chunk, tap, k) in one fixed order whatever the
// grid: no split-K, so a batch row does not depend on the other rows.
//
// Shared memory per block, TN = 128: 1024 (alignment) + 3 x 41,984
// (patches) + 4 x 16,384 (weights) + 136 (barriers) = 192,648 bytes of the
// 232,448 a block may have; TN = 64: 159,880.
// Left for later: the epilogue does not overlap the products (bf16: a
// persistent walk would need a separate staging buffer; f32: the walk
// overlaps the loads only), and the 96x96 decode level is wave-bound
// (PERF.md).

#include <algorithm>

#include "sm90.cuh"

namespace {

using namespace onedc;

namespace wg {

constexpr int kTileH = 16;        // output rows per tile
constexpr int kTileW = 16;        // output columns per tile (a warp's m16)
constexpr int kPatchH = kTileH + 2;  // staged patch rows (halo)
constexpr int kPatchW = kTileW + 2;  // staged patch columns (halo)
constexpr int kPatchPixels = kPatchH * kPatchW;
constexpr int kChunk = 64;        // input channels per chunk (128 bytes)
constexpr int kPatchBytes = kPatchPixels * kChunk * 2;  // one TMA box
constexpr int kPatchStride = (kPatchBytes + 1023) / 1024 * 1024;
constexpr int kPatchStages = 3;  // consumed, transformed, loading
constexpr int kWStages = 4;
constexpr int kConsumerWarps = 8;  // two warpgroups of 8 output rows
constexpr int kConsumers = kConsumerWarps * 32;
// a third warpgroup: one warp issues the weight loads, three fill the
// patches ahead of the consumers (bf16: the first of them also issues the
// patch loads)
constexpr int kWeightWarp = kConsumerWarps;
constexpr int kTransformWarp0 = kConsumerWarps + 1;
constexpr int kTransformWarps = 3;
constexpr int kTransformers = kTransformWarps * 32;
// a transform thread's units are one 16-byte chunk of pixels
// tt / 8 + kPixelStep * k (bf16: chunk tt % 8 of the swizzled row, whose
// channel group alternates between two values; f32: channel group tt % 8)
constexpr int kPixelStep = kTransformers / 8;
static_assert(kPixelStep % 8 == 4, "two channel groups per thread");
// f32: each thread's 27 units in 3 batches of loads in flight
static_assert(kPatchPixels % kPixelStep == 0, "whole units per thread");
constexpr int kUnits = kPatchPixels / kPixelStep;
constexpr int kLoadBatch = 9;
static_assert(kUnits % kLoadBatch == 0, "whole batches");
constexpr int kBlockThreads = kConsumers + 128;
// the bf16 output tile, staged for its TMA store in the patch stages'
// place: two 64-channel atoms of 256 pixels x 128 bytes
constexpr int kOutAtomBytes = kTileH * kTileW * 128;
static_assert(2 * kOutAtomBytes <= kPatchStages * kPatchStride,
              "the output tile must fit where the patches were");
// the weights of one (tap, chunk) for TN output channels: TN / 64 boxes
template <int TN>
constexpr int kWBytes = kChunk * TN * 2;
template <int TN>
constexpr size_t kSmemBytes = 1024 + kPatchStages * kPatchStride +
                              kWStages * kWBytes<TN> +
                              (3 * kPatchStages + 2 * kWStages) * 8;

}  // namespace wg

// silu(v) = v/2 * (1 + tanh(v/2)): one special-function op (tanh.approx)
// instead of two (exp, reciprocal)
__device__ __forceinline__ float silu_tanh(float v) {
  float th;
  asm("tanh.approx.f32 %0, %1;" : "=f"(th) : "f"(0.5f * v));
  const float h = 0.5f * v;
  return fmaf(h, th, h);
}

// silu(v) = v / (1 + exp(-v)), within a few ulp of f32
__device__ __forceinline__ float silu_exp(float v) {
  return __fdividef(v, 1.f + __expf(-v));
}

__device__ __forceinline__ float4 ldg_f4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// an output tile: channels n0 .., rows ty0 .., columns tx0 .. of image b
struct Tile {
  int n0, ty0, tx0, b;
};

// The shared body of a block over output tiles of 16x16 pixels x TN (128
// or 64) channels. T = __nv_bfloat16: bf16 K2 (xmap, omap; x, out unused),
// one tile per block at its grid coordinates. T = float: f32 K2 (kAffine)
// or K3 (!kAffine: mul, add, bias unused, taps read flipped; xmap, omap
// unused), a persistent walk over tiles blockIdx.x + k * gridDim.x,
// output-channel blocks fastest: the next tile's patches and weights load
// while this tile's last products and its epilogue run.
template <int TN, typename T, bool kAffine>
__device__ __forceinline__ void conv3x3_wgmma(
    const CUtensorMap* xmap, const CUtensorMap* wmap, const CUtensorMap* omap,
    const T* __restrict__ x, const float* __restrict__ mul,
    const float* __restrict__ add, const T* __restrict__ bias,
    T* __restrict__ out, int B, int H, int W, int Cin, int Cout, int tiles_x,
    int tiles_y) {
  using namespace wg;
  using namespace sm90;
  constexpr bool kBf16 = kIsBf16<T>;
  static_assert(kAffine || !kBf16, "bf16 is K2 only");
  constexpr int kWB = kWBytes<TN>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // TMA's 128-byte swizzle is a function of the shared address: 1024-align
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* patch = smem;  // [stage][kPatchPixels][128 bytes]
  unsigned char* wbuf = smem + kPatchStages * kPatchStride;
  uint64_t* patch_full =  // loaded (TMA -> transform warps; bf16 only)
      reinterpret_cast<uint64_t*>(wbuf + kWStages * kWB);
  uint64_t* patch_ready = patch_full + kPatchStages;  // -> consumers
  uint64_t* patch_empty = patch_ready + kPatchStages;  // -> patch producer
  uint64_t* w_full = patch_empty + kPatchStages;
  uint64_t* w_empty = w_full + kWStages;

  const int nblk = (Cout + TN - 1) / TN;
  const int tiles_img = tiles_x * tiles_y;
  const int first = kBf16 ? 0 : blockIdx.x;
  const int stride = kBf16 ? 1 : gridDim.x;
  const int ntiles = kBf16 ? 1 : nblk * tiles_img * B;
  auto tile = [&](int i) {
    if constexpr (kBf16) {
      return Tile{static_cast<int>(blockIdx.x) * TN,
                  static_cast<int>(blockIdx.y / tiles_x) * kTileH,
                  static_cast<int>(blockIdx.y % tiles_x) * kTileW,
                  static_cast<int>(blockIdx.z)};
    } else {
      const int s = i / nblk;
      const int si = s % tiles_img;
      return Tile{(i % nblk) * TN, (si / tiles_x) * kTileH,
                  (si % tiles_x) * kTileW, s / tiles_img};
    }
  };
  const int nchunks = Cin / kChunk;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kPatchStages; ++s) {
      mbar_init(&patch_full[s], 1);
      mbar_init(&patch_ready[s], kTransformWarps);
      mbar_init(&patch_empty[s], kConsumerWarps);
    }
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(&w_full[s], 1);
      mbar_init(&w_empty[s], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kWeightWarp) {  // one thread issues every weight load
    if (lane == 0) {
      int ws = 0;
      uint32_t wph = 0;
      for (int it = first; it < ntiles; it += stride) {
        const int n0 = tile(it).n0;
        for (int c = 0; c < nchunks; ++c) {
          for (int tap = 0; tap < 9; ++tap) {
            mbar_wait(&w_empty[ws], wph ^ 1);
            mbar_arrive_expect_tx(&w_full[ws], kWB);
            unsigned char* dst = wbuf + ws * kWB;
            // K3 runs the conv of the flipped weights: tap t is w's 8 - t
            const int row = (kAffine ? tap : 8 - tap) * Cin + c * kChunk;
            for (int h = 0; h < TN / 64; ++h) {
              tma_load_2d(dst + h * (kWB / (TN / 64)), wmap, &w_full[ws],
                          n0 + 64 * h, row);
            }
            if (++ws == kWStages) {
              ws = 0;
              wph ^= 1;
            }
          }
        }
      }
    }
    return;
  }
  if (warp >= kTransformWarp0) {
    const int tt = threadIdx.x - kTransformWarp0 * 32;
    if constexpr (kBf16) {
      // silu(x*mul+add) in f32 -> bf16, in place, on each loaded patch;
      // positions outside the image keep TMA's zeros (the border of the
      // normalised tensor, i.e. zero AFTER the SiLU). Thread tt's units are
      // the 16-byte chunk tt % 8 of pixels tt / 8 + 12k, which holds
      // channels 8 * ((tt % 8) ^ (p % 8)) (the 128-byte swizzle): two
      // groups, for even and odd k.
      const Tile tl = tile(0);
      const int ty0 = tl.ty0;
      const int tx0 = tl.tx0;
      const int b = tl.b;
      auto load_patch = [&](int c) {
        const int ps = c % kPatchStages;
        if (c >= kPatchStages) {
          mbar_wait(&patch_empty[ps], ((c / kPatchStages) & 1) ^ 1);
        }
        mbar_arrive_expect_tx(&patch_full[ps], kPatchBytes);
        tma_load_4d(patch + ps * kPatchStride, xmap, &patch_full[ps],
                    c * kChunk, tx0 - 1, ty0 - 1, b);
      };
      if (tt == 0) {
        load_patch(0);
        if (nchunks > 1) load_patch(1);
      }
      const int grp[2] = {((tt & 7) ^ ((tt >> 3) & 7)) << 3,
                          (((tt & 7) ^ ((tt >> 3) & 7)) << 3) ^ 32};
      for (int c = 0; c < nchunks; ++c) {
        const int ps = c % kPatchStages;
        float mm[2][8], aa[2][8];
#pragma unroll
        for (int par = 0; par < 2; ++par) {
          const size_t off =
              static_cast<size_t>(b) * Cin + c * kChunk + grp[par];
          const float* mc = mul + off;
          const float* ac = add + off;
#pragma unroll
          for (int e = 0; e < 8; e += 4) {
            const float4 mv = *reinterpret_cast<const float4*>(mc + e);
            const float4 av = *reinterpret_cast<const float4*>(ac + e);
            mm[par][e] = mv.x, mm[par][e + 1] = mv.y;
            mm[par][e + 2] = mv.z, mm[par][e + 3] = mv.w;
            aa[par][e] = av.x, aa[par][e + 1] = av.y;
            aa[par][e + 2] = av.z, aa[par][e + 3] = av.w;
          }
        }
        mbar_wait(&patch_full[ps], (c / kPatchStages) & 1);
        unsigned char* pt = patch + ps * kPatchStride;
#pragma unroll 2
        for (int k2 = 0; k2 < (kPatchPixels / kPixelStep + 2) / 2; ++k2) {
#pragma unroll
          for (int par = 0; par < 2; ++par) {
            const int p = (tt >> 3) + kPixelStep * (2 * k2 + par);
            const int iy = ty0 - 1 + p / kPatchW;
            const int ix = tx0 - 1 + p % kPatchW;
            if (p >= kPatchPixels || iy < 0 || iy >= H || ix < 0 || ix >= W) {
              continue;
            }
            uint4* slot =
                reinterpret_cast<uint4*>(pt + p * 128 + (tt & 7) * 16);
            const uint4 raw = *slot;
            const __nv_bfloat16* rv =
                reinterpret_cast<const __nv_bfloat16*>(&raw);
            uint4 packed;
            uint32_t* pk = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
            for (int e = 0; e < 8; e += 2) {
              pk[e / 2] = pack_bf16(
                  silu_tanh(fmaf(__bfloat162float(rv[e]), mm[par][e],
                                 aa[par][e])),
                  silu_tanh(fmaf(__bfloat162float(rv[e + 1]), mm[par][e + 1],
                                 aa[par][e + 1])));
            }
            *slot = packed;
          }
        }
        // order these generic-proxy writes before the TMA that will refill
        // the stage once the consumers are done with it
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(&patch_ready[ps]);
        // chunk c + 2 goes where chunk c - 1 was: the consumers, now on
        // chunk c at the latest, are done with it
        if (tt == 0 && c + 2 < nchunks) load_patch(c + 2);
      }
    } else {
      // f32 x straight from device memory: thread tt owns channel group
      // cg = tt % 8 (8 channels, 32 bytes of f32) of pixels tt / 8 + 12k,
      // k < 27, written to 16-byte chunk cg ^ (p % 8) of the pixel's
      // swizzled row. Eight neighbouring threads read one pixel's 256
      // contiguous bytes and write its 128-byte row without bank
      // conflicts.
      const int cg = tt & 7;
      int gc = 0;  // chunks this block has staged
      for (int it = first; it < ntiles; it += stride) {
        const Tile tl = tile(it);
        const T* xb = x + static_cast<size_t>(tl.b) * H * W * Cin + cg * 8;
        for (int c = 0; c < nchunks; ++c, ++gc) {
          const int ps = gc % kPatchStages;
          float mm[8], aa[8];
          if constexpr (kAffine) {
            const size_t off =
                static_cast<size_t>(tl.b) * Cin + c * kChunk + cg * 8;
#pragma unroll
            for (int e = 0; e < 8; e += 4) {
              const float4 mv = ldg_f4(mul + off + e);
              const float4 av = ldg_f4(add + off + e);
              mm[e] = mv.x, mm[e + 1] = mv.y, mm[e + 2] = mv.z;
              mm[e + 3] = mv.w;
              aa[e] = av.x, aa[e + 1] = av.y, aa[e + 2] = av.z;
              aa[e + 3] = av.w;
            }
          }
          if (gc >= kPatchStages) {
            mbar_wait(&patch_empty[ps], ((gc / kPatchStages) & 1) ^ 1);
          }
          unsigned char* pt = patch + ps * kPatchStride;
          const T* xc = xb + c * kChunk;
#pragma unroll 1
          for (int k0 = 0; k0 < kUnits; k0 += kLoadBatch) {
            float v[kLoadBatch][8];
            bool inside[kLoadBatch];
#pragma unroll
            for (int u = 0; u < kLoadBatch; ++u) {
              const int p = (tt >> 3) + kPixelStep * (k0 + u);
              const int iy = tl.ty0 - 1 + p / kPatchW;
              const int ix = tl.tx0 - 1 + p % kPatchW;
              inside[u] = iy >= 0 && iy < H && ix >= 0 && ix < W;
              float4 lo = make_float4(0.f, 0.f, 0.f, 0.f);
              float4 hi = lo;
              if (inside[u]) {
                const T* src = xc + (static_cast<size_t>(iy) * W + ix) * Cin;
                lo = ldg_f4(src);
                hi = ldg_f4(src + 4);
              }
              v[u][0] = lo.x, v[u][1] = lo.y, v[u][2] = lo.z, v[u][3] = lo.w;
              v[u][4] = hi.x, v[u][5] = hi.y, v[u][6] = hi.z, v[u][7] = hi.w;
            }
#pragma unroll
            for (int u = 0; u < kLoadBatch; ++u) {
              const int p = (tt >> 3) + kPixelStep * (k0 + u);
              uint4 packed = make_uint4(0u, 0u, 0u, 0u);
              if (inside[u]) {
                uint32_t* pk = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
                for (int e = 0; e < 8; e += 2) {
                  if constexpr (kAffine) {
                    pk[e / 2] = pack_bf16(
                        silu_exp(fmaf(v[u][e], mm[e], aa[e])),
                        silu_exp(fmaf(v[u][e + 1], mm[e + 1], aa[e + 1])));
                  } else {
                    pk[e / 2] = pack_bf16(v[u][e], v[u][e + 1]);
                  }
                }
              }
              *reinterpret_cast<uint4*>(pt + p * 128 +
                                        ((cg ^ (p & 7)) << 4)) = packed;
            }
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(&patch_ready[ps]);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wgi owns tile rows 8*wgi .. 8*wgi+7; m64 tile mt
  // of it rows 8*wgi + 4*mt .. +3, one 16-pixel row per warp
  const int tid = threadIdx.x;
  const int wgi = warp / 4;
  const int wi = warp % 4;
  const int g = lane >> 2;
  const int t = lane & 3;

  // the first k-step overwrites acc (scale_d 0): no other instruction
  // writes the accumulators while products are in flight
  float acc[2][TN / 2];
  uint32_t afr[2][2][4] = {};  // [k-step parity][mt]: A fragments in flight

  int ws = 0;
  uint32_t wph = 0;
  int gc = 0;  // chunks this block has consumed
  for (int it = first; it < ntiles; it += stride) {
    const Tile tl = tile(it);
    for (int c = 0; c < nchunks; ++c, ++gc) {
      const int ps = gc % kPatchStages;
      mbar_wait(&patch_ready[ps], (gc / kPatchStages) & 1);
      unsigned char* pt = patch + ps * kPatchStride;
      const uint32_t pbase = smem_addr(pt);
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3;
        const int dx = tap % 3;
        mbar_wait(&w_full[ws], wph);
        const uint32_t wstage = smem_addr(wbuf + ws * kWB);
#pragma unroll
        for (int kk = 0; kk < kChunk / 16; ++kk) {
          const int buf = kk & 1;  // kChunk / 16 is even: the step parity
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            // this lane's ldmatrix row: pixel (lane & 15) of its warp's output
            // row, shifted by the tap; channels kk*16 + 8*(lane >> 4) ...
            const int p =
                (wgi * 8 + mt * 4 + wi + dy) * kPatchW + (lane & 15) + dx;
            const int chunk = kk * 2 + (lane >> 4);
            ldmatrix_x4(afr[buf][mt],
                        pbase + p * 128 + ((chunk ^ (p & 7)) << 4));
          }
          wgmma_fence();
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            // B: k rows kk*16 .. +15 of the stage (2048 bytes each 16),
            // 64-channel atoms 8192 bytes apart, 8-row groups 1024 apart
            wgmma_rs<TN>(acc[mt], afr[buf][mt],
                             desc_sw128(wstage + kk * 2048, 8192, 1024),
                             (c | tap | kk) != 0);
          }
          wgmma_commit();
          wgmma_wait<1>();  // the previous k-step's products are done
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int r = 0; r < 4; ++r) reg_fence(afr[buf ^ 1][mt][r]);
          if (kk == 0 && (c > 0 || tap > 0) && lane == 0) {
            // ... and with them the previous tap's weights
            mbar_arrive(&w_empty[(ws + kWStages - 1) % kWStages]);
          }
        }
        if (++ws == kWStages) {
          ws = 0;
          wph ^= 1;
        }
      }
      // every ldmatrix of this patch has returned
      __syncwarp();
      if (lane == 0) mbar_arrive(&patch_empty[ps]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int i = 0; i < TN / 2; ++i) reg_fence(acc[mt][i]);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        reg_fence(afr[0][mt][r]);
        reg_fence(afr[1][mt][r]);
      }
    }

    // Accumulator element 4j + e of m64 tile mt: pixel g (e < 2) or g + 8 of
    // the warp's output row, channel n0 + 8j + 2t + (e & 1).
    const int n0 = tl.n0;
    const int ty0 = tl.ty0;
    const int tx0 = tl.tx0;
    const int b = tl.b;
    if constexpr (!kBf16) {
      // every product of the tile is done: its last weights go back
      if (lane == 0) mbar_arrive(&w_empty[(ws + kWStages - 1) % kWStages]);
      // f32: (+ bias) straight from the registers, 8 bytes a lane; rows and
      // columns past the image and channels past Cout are not written
      const int oy = ty0 + wgi * 8 + wi;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (oy + mt * 4 >= H) continue;
        T* orow = out + (static_cast<size_t>(b) * H + oy + mt * 4) * W * Cout;
#pragma unroll
        for (int j = 0; j < TN / 8; ++j) {
          const int n = n0 + j * 8 + 2 * t;
          if (n >= Cout) continue;
          float2 bv = make_float2(0.f, 0.f);
          if constexpr (kAffine) {
            bv = __ldg(reinterpret_cast<const float2*>(bias + n));
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int ox = tx0 + g + 8 * h;
            if (ox >= W) continue;
            *reinterpret_cast<float2*>(orow + static_cast<size_t>(ox) * Cout +
                                       n) =
                make_float2(acc[mt][4 * j + 2 * h] + bv.x,
                            acc[mt][4 * j + 2 * h + 1] + bv.y);
          }
        }
      }
    } else {
      // bf16: + bias, staged in the 128-byte swizzled layout of TN / 64
      // boxes (64 channels, 16, 16, 1) where the patches were (every
      // consumer is past its last ldmatrix after the barrier), then stored by
      // TMA, which clips the image's ragged edge and the channels past Cout.
      named_barrier_sync(1, kConsumers);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int j = 0; j < TN / 8; ++j) {
          const int n = n0 + j * 8 + 2 * t;
          const float b0 = n < Cout ? __bfloat162float(bias[n]) : 0.f;
          const float b1 = n < Cout ? __bfloat162float(bias[n + 1]) : 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int px = (wgi * 8 + mt * 4 + wi) * kTileW + g + 8 * h;
            const uint32_t off = (j / 8) * kOutAtomBytes + px * 128 +
                                 (((j % 8) ^ (px & 7)) << 4) + t * 4;
            *reinterpret_cast<uint32_t*>(smem + off) = pack_bf16(
                acc[mt][4 * j + 2 * h] + b0, acc[mt][4 * j + 2 * h + 1] + b1);
          }
        }
      }
      fence_proxy_async();
      named_barrier_sync(1, kConsumers);
      if (tid == 0) {
        for (int h = 0; h < TN / 64; ++h) {
          tma_store_4d(omap, smem + h * kOutAtomBytes, n0 + 64 * h, tx0, ty0,
                       b);
        }
        bulk_commit();
        bulk_wait_read();  // the shared memory stays until TMA has read it
      }
    }
  }
}

// the three kernels; the profiling tools group by these names
// (tools/profile_port_decode.py, tools/profile_port_train.py)
template <int TN>
__global__ void __launch_bounds__(wg::kBlockThreads, 1)
    gn_silu_conv3x3_kernel_wgmma(const __grid_constant__ CUtensorMap xmap,
                                 const __grid_constant__ CUtensorMap wmap,
                                 const __grid_constant__ CUtensorMap omap,
                                 const float* __restrict__ mul,
                                 const float* __restrict__ add,
                                 const __nv_bfloat16* __restrict__ bias,
                                 int B, int H, int W, int Cin, int Cout,
                                 int tiles_x, int tiles_y) {
  conv3x3_wgmma<TN, __nv_bfloat16, true>(&xmap, &wmap, &omap, nullptr, mul,
                                         add, bias, nullptr, B, H, W, Cin,
                                         Cout, tiles_x, tiles_y);
}

template <int TN>
__global__ void __launch_bounds__(wg::kBlockThreads, 1)
    gn_silu_conv3x3_kernel_wgmma_f32(const __grid_constant__ CUtensorMap wmap,
                                     const float* __restrict__ x,
                                     const float* __restrict__ mul,
                                     const float* __restrict__ add,
                                     const float* __restrict__ bias,
                                     float* __restrict__ out, int B, int H,
                                     int W, int Cin, int Cout, int tiles_x,
                                     int tiles_y) {
  conv3x3_wgmma<TN, float, true>(nullptr, &wmap, nullptr, x, mul, add, bias,
                                 out, B, H, W, Cin, Cout, tiles_x, tiles_y);
}

template <int TN>
__global__ void __launch_bounds__(wg::kBlockThreads, 1)
    conv3x3_dx_kernel_wgmma(const __grid_constant__ CUtensorMap wmap,
                            const float* __restrict__ x,
                            float* __restrict__ out, int B, int H, int W,
                            int Cin, int Cout, int tiles_x, int tiles_y) {
  conv3x3_wgmma<TN, float, false>(nullptr, &wmap, nullptr, x, nullptr,
                                  nullptr, nullptr, out, B, H, W, Cin, Cout,
                                  tiles_x, tiles_y);
}

// a bf16 tensor map over NHWC (B, H, W, C), boxes of (64 channels, box_w,
// box_h, 1)
cudaError_t nhwc_map(CUtensorMap* map, const void* base, int B, int H, int W,
                     int C, int box_w, int box_h) {
  const uint64_t esz = sizeof(__nv_bfloat16);
  const uint64_t dims[4] = {static_cast<uint64_t>(C), static_cast<uint64_t>(W),
                            static_cast<uint64_t>(H), static_cast<uint64_t>(B)};
  const uint64_t strides[3] = {dims[0] * esz, dims[0] * dims[1] * esz,
                               dims[0] * dims[1] * dims[2] * esz};
  const uint32_t box[4] = {64, static_cast<uint32_t>(box_w),
                           static_cast<uint32_t>(box_h), 1};
  return sm90::make_tensor_map(map, base, 4, dims, strides, box);
}

// the bf16 weights (3, 3, Cin, Cout) as (9*Cin, Cout), boxes of 64 x 64
cudaError_t weight_map(CUtensorMap* map, const void* w, int Cin, int Cout) {
  const uint64_t dims[2] = {static_cast<uint64_t>(Cout),
                            static_cast<uint64_t>(9) * Cin};
  const uint64_t strides[1] = {dims[0] * sizeof(__nv_bfloat16)};
  const uint32_t box[2] = {64, wg::kChunk};
  return sm90::make_tensor_map(map, w, 2, dims, strides, box);
}

// Launches kernel k64 or k128 (64- or 128-channel tiles) with `args...`,
// B, H, W, Cin, Cout, tiles_x, tiles_y. `walk` (f32): a persistent grid of
// one block per SM (at most one per tile), 128-channel tiles where Cout
// allows (a 64-channel tile does half the products on the same f32 patch
// traffic, and the walk leaves only the last round's SMs idle). Else
// (bf16) one block per tile (output-channel blocks, tiles, batch),
// 64-channel tiles where 128-channel ones would fill the SMs fewer than 3
// times, as there a partly filled last wave costs more than reading each
// input patch twice as often.
template <typename F, typename... Args>
int launch_tiles(F k64, F k128, bool walk, int B, int H, int W, int Cin,
                 int Cout, void* stream, Args... args) {
  using namespace wg;
  if (Cin % kChunk || Cout % 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const int tiles_y = (H + kTileH - 1) / kTileH;
  const int tiles = tiles_x * tiles_y * B;
  const bool narrow =
      walk ? Cout % 128 != 0 : (Cout + 127) / 128 * tiles < 3 * sms;
  F kernel = narrow ? k64 : k128;
  const int tn = narrow ? 64 : 128;
  const size_t smem = narrow ? kSmemBytes<64> : kSmemBytes<128>;
  // a function attribute belongs to the current device: set it on every
  // launch (a host-side call of about a microsecond), as the kernel may run
  // on more than one device in a process
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nblk = (Cout + tn - 1) / tn;
  const dim3 grid = walk ? dim3(std::min(nblk * tiles, sms))
                         : dim3(nblk, tiles / B, B);
  kernel<<<grid, kBlockThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      args..., B, H, W, Cin, Cout, tiles_x, tiles_y);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K2. f32 nonzero: x, bias, out f32 and w the bf16 copy of the f32
// weights; else x, w, bias, out bf16.
extern "C" int onedc_gn_silu_conv3x3(const void* x, const void* mul,
                                     const void* add, const void* w,
                                     const void* bias, void* out, int B, int H,
                                     int W, int Cin, int Cout, int f32,
                                     void* stream) {
  CUtensorMap wmap;
  cudaError_t err = weight_map(&wmap, w, Cin, Cout);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* m = static_cast<const float*>(mul);
  const float* a = static_cast<const float*>(add);
  if (f32) {
    return launch_tiles(gn_silu_conv3x3_kernel_wgmma_f32<64>,
                        gn_silu_conv3x3_kernel_wgmma_f32<128>, true, B, H, W,
                        Cin, Cout, stream, wmap, static_cast<const float*>(x),
                        m, a, static_cast<const float*>(bias),
                        static_cast<float*>(out));
  }
  CUtensorMap xmap, omap;
  err = nhwc_map(&xmap, x, B, H, W, Cin, wg::kPatchW, wg::kPatchH);
  if (err == cudaSuccess) {
    err = nhwc_map(&omap, out, B, H, W, Cout, wg::kTileW, wg::kTileH);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_tiles(gn_silu_conv3x3_kernel_wgmma<64>,
                      gn_silu_conv3x3_kernel_wgmma<128>, false, B, H, W, Cin,
                      Cout, stream, xmap, wmap, omap, m, a,
                      static_cast<const __nv_bfloat16*>(bias));
}

// K3, f32: out = conv3x3(x, flip(w)) for x (B, H, W, Cin) f32 and w the
// bf16 forward weights transposed to (3, 3, Cin, Cout), not flipped.
extern "C" int onedc_conv3x3(const void* x, const void* w, void* out, int B,
                             int H, int W, int Cin, int Cout, void* stream) {
  CUtensorMap wmap;
  const cudaError_t err = weight_map(&wmap, w, Cin, Cout);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_tiles(conv3x3_dx_kernel_wgmma<64>,
                      conv3x3_dx_kernel_wgmma<128>, true, B, H, W, Cin, Cout,
                      stream, wmap, static_cast<const float*>(x),
                      static_cast<float*>(out));
}
