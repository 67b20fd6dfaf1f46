// 3x3 stride-1 "same" convolutions for Hopper (implicit GEMM):
//
// K2, fused GroupNorm-affine + SiLU + 3x3 conv. Replaces the Pallas TPU
// kernel onedc_tpu/ops/pallas_conv.py:292 (_conv3x3_v2_single, body
// _kernel_v2 :219), entered through affine_silu_conv3x3 :404. Computes
//     out[b] = conv3x3(silu(x[b] * mul[b, c] + add[b, c])) + bias
// with a zero border applied AFTER the SiLU, so the normalised tensor never
// reaches device memory. Two kernels: bf16 (the decode path) on wgmma + TMA,
// gn_silu_conv3x3_kernel_wgmma below; f32 (the training forward) on the
// mma.sync template gn_silu_conv3x3_kernel<float, true>.
//
// K3, the plain 3x3 conv out = conv3x3(x) (no prologue, no bias), f32 only:
// gn_silu_conv3x3_kernel<float, false>. Replaces
// onedc_tpu/ops/pallas_conv.py:89 (_conv3x3_pallas_single, body _kernel
// :43), entered through conv3x3_same :153, whose VJP runs the same kernel
// on flipped, transposed weights for dx (:164-179): on this path it is the
// input gradient of every K2 conv in training. The TPU version staged three
// dx-shifted copies of the input in HBM so that its DMAs stayed aligned;
// Hopper needs no such copies, so K3 is K2's structure without the
// prologue.
//
// Layout: x (B, H, W, Cin) NHWC; mul, add (B, Cin) f32; w (3, 3, Cin, Cout),
// i.e. [tap][Cin][Cout]; bias (Cout); out (B, H, W, Cout) NHWC. x, w, bias
// and out are all bf16 (serving; Cin % 64 == 0, Cout % 64 == 0) or all f32
// (training; Cin % 32 == 0, Cout % 8 == 0); the wrapper checks.
//
// What bounds it on the H100: a VAE conv does 18*H*W*Cin*Cout FLOPs on
// ~2*H*W*(Cin + Cout) bytes in bf16, e.g. 768x768x256->128: ~174 GFLOP on
// 453 MB, ~380 FLOP/byte, above the ~295 ridge, so the tensor cores bound
// it (the smaller spatial levels with 512 channels are further above it;
// f32 operands double the bytes and bring the 128-channel levels near the
// ridge).
//
// The bf16 kernel: a block owns a 16x16-pixel x 128-channel output tile
// (64 channels where 128-channel tiles would fill the SMs fewer than 3
// times: the 96x96 level) and loops over 64-channel input chunks. Three
// warpgroups: two consume (8 output rows each), the third feeds them. In
// the third, one warp issues TMA loads of the weights of each (tap,
// chunk), 64 x 128 of w viewed as (9*Cin, Cout), into a 4-stage ring; the
// other three warps transform the input patches: the first of them loads
// each chunk's patch with its 1-pixel halo by TMA, one 4-D box (64
// channels, 18, 18, 1) of a tensor map over x, zero-filled outside the
// image (a 3-stage ring: consumed, transformed, loading), and all three
// apply affine + SiLU in f32 to it in place (SiLU by tanh.approx, one
// special-function op; positions outside the image stay 0) while the
// consumers run the previous chunk's products. Rings are guarded by
// mbarriers; tiles land 128-byte swizzled. The consumers run the 9 taps
// of a chunk: the A operand (pixels x channels) is an ldmatrix of the
// tap's shifted window of the patch into registers (a one-pixel shift
// breaks the alignment a shared-memory A operand needs), the B operand is
// the weight tile through a descriptor (HWIO makes it N-major:
// "transposed"), and wgmma m64nNk16 accumulates in f32 registers, the
// next k-step's ldmatrix overlapping the products in flight. The epilogue
// adds the bias, stages the bf16 tile in shared memory in the swizzled
// layout and stores it with TMA. The 256 pixels of a tile halve the
// weight reads from L2 per output pixel against the 128 of the f32
// kernel; output-channel blocks are the fastest grid dimension, so the
// blocks that share an input patch run together. Each output's sum runs
// over (chunk, tap, k) in one fixed order whatever the grid: no split-K,
// so a batch row does not depend on the other rows.
// Left for later: the epilogue does not overlap the products (a
// persistent tile walk would need a separate staging buffer), and the
// 96x96 level is wave-bound (PERF.md).
//
// The f32 kernels (mma.sync template): each block owns an 8x16-pixel x
// 128-channel output tile and loops over 32-channel input chunks; per chunk
// it stages the patch (10x18 pixels) and the chunk's weights for all 9
// taps into shared memory as bf16 through registers, K2's affine + SiLU
// applied in f32 on the way; products on mma.sync m16n8k16 bf16 with f32
// accumulate. Two blocks share an SM. The batch is a grid dimension, any
// H, W work (ragged tiles masked) in both kernels: the TPU gate
// supports_pallas_conv (pallas_conv.py:143) does not carry over.

#include "mma.cuh"
#include "sm90.cuh"

namespace {

using namespace onedc;

constexpr int TH = 8;             // output rows per tile
constexpr int TW = 16;            // output columns per tile (one m16 tile)
constexpr int PH = TH + 2;        // staged patch rows (halo)
constexpr int PW = TW + 2;        // staged patch columns (halo)
constexpr int BN = 128;           // output channels per block
constexpr int BK = 32;            // input channels per chunk
constexpr int PLD = BK + 8;       // patch pixel stride (bf16 elements)
constexpr int WLD = BN + 8;       // weight row stride (bf16 elements)
constexpr int kThreads = 256;     // 8 warps: 2 (pixel rows) x 4 (channels)
constexpr size_t kSmem =
    (static_cast<size_t>(PH * PW * PLD) + 9 * BK * WLD) * sizeof(__nv_bfloat16);

__device__ __forceinline__ float silu(float v) {
  return __fdividef(v, 1.f + __expf(-v));
}

// silu(v * m + a) of 8 channels, packed as 8 bf16
__device__ __forceinline__ uint4 affine_silu8(const float v[8],
                                              const float* m,
                                              const float* a) {
  const float4 m_lo = *reinterpret_cast<const float4*>(m);
  const float4 m_hi = *reinterpret_cast<const float4*>(m + 4);
  const float4 a_lo = *reinterpret_cast<const float4*>(a);
  const float4 a_hi = *reinterpret_cast<const float4*>(a + 4);
  const float mm[8] = {m_lo.x, m_lo.y, m_lo.z, m_lo.w,
                       m_hi.x, m_hi.y, m_hi.z, m_hi.w};
  const float aa[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w,
                       a_hi.x, a_hi.y, a_hi.z, a_hi.w};
  uint4 packed;
  uint32_t* pk = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
  for (int e = 0; e < 8; e += 2) {
    pk[e / 2] = pack_bf16(silu(v[e] * mm[e] + aa[e]),
                          silu(v[e + 1] * mm[e + 1] + aa[e + 1]));
  }
  return packed;
}

// f32 K2 (kAffine) and K3 (!kAffine; mul, add and bias null); the
// profiling tools group by this name (tools/profile_port_decode.py), and
// tell K3 by its template argument (tools/profile_port_train.py)
template <typename T, bool kAffine>
__global__ void __launch_bounds__(kThreads)
    gn_silu_conv3x3_kernel(const T* __restrict__ x,
                           const float* __restrict__ mul,
                           const float* __restrict__ add,
                           const T* __restrict__ w, const T* __restrict__ bias,
                           T* __restrict__ out, int H, int W, int Cin,
                           int Cout, int tiles_x) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(smem);  // [PH*PW][PLD]
  __nv_bfloat16* sW = sP + PH * PW * PLD;                      // [9*BK][WLD]

  const int ty0 = (blockIdx.x / tiles_x) * TH;
  const int tx0 = (blockIdx.x % tiles_x) * TW;
  const int n0 = blockIdx.y * BN;
  const int b = blockIdx.z;
  const T* xb = x + static_cast<size_t>(b) * H * W * Cin;
  const float* mb = kAffine ? mul + static_cast<size_t>(b) * Cin : nullptr;
  const float* ab = kAffine ? add + static_cast<size_t>(b) * Cin : nullptr;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = warp & 1;   // tile rows 4*wm .. 4*wm+3
  const int wn = warp >> 1;  // channels n0 + 32*wn .. +31

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += BK) {
    __syncthreads();  // the previous chunk is consumed

    // input patch (with halo) and this chunk's weights for all 9 taps;
    // positions outside the image and output channels past Cout are
    // zero-filled
    for (int i = threadIdx.x; i < PH * PW * (BK / 8); i += kThreads) {
      const int p = i / (BK / 8);
      const int cv = (i % (BK / 8)) * 8;
      const int iy = ty0 + p / PW - 1;
      const int ix = tx0 + p % PW - 1;
      const bool inside = iy >= 0 && iy < H && ix >= 0 && ix < W;
      const T* src =
          inside ? xb + (static_cast<size_t>(iy) * W + ix) * Cin + c0 + cv : xb;
      __nv_bfloat16* dst = sP + p * PLD + cv;
      if constexpr (!kAffine) {
        stage8<T>(dst, src, inside);
      } else {  // K2: affine + SiLU on the way in; the border stays 0
        if (inside) {
          const float4 lo = *reinterpret_cast<const float4*>(src);
          const float4 hi = *reinterpret_cast<const float4*>(src + 4);
          const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
          *reinterpret_cast<uint4*>(dst) =
              affine_silu8(v, mb + c0 + cv, ab + c0 + cv);
        } else {
          *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
    for (int i = threadIdx.x; i < 9 * BK * (BN / 8); i += kThreads) {
      const int r = i / (BN / 8);
      const int nv = (i % (BN / 8)) * 8;
      const int tap = r / BK;
      const int c = r % BK;
      const bool valid = n0 + nv < Cout;
      stage8<T>(sW + r * WLD + nv,
                valid ? w + (static_cast<size_t>(tap) * Cin + c0 + c) * Cout +
                            n0 + nv
                      : w,
                valid);
    }
    __syncthreads();

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3;
      const int dx = tap % 3;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t bfr[4][2];
#pragma unroll
        for (int j2 = 0; j2 < 2; ++j2) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, sW + (tap * BK + kk * 16 + (lane & 15)) * WLD +
                                   wn * 32 + j2 * 16 + (lane >> 4) * 8);
          bfr[2 * j2][0] = r[0];
          bfr[2 * j2][1] = r[1];
          bfr[2 * j2 + 1][0] = r[2];
          bfr[2 * j2 + 1][1] = r[3];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // m16 tile i = output row 4*wm+i, pixels 0..15 of the tile row
          const __nv_bfloat16* pa =
              sP + ((wm * 4 + i + dy) * PW + g + dx) * PLD + kk * 16 + 2 * t;
          const uint32_t a[4] = {ld_u32(pa), ld_u32(pa + 8 * PLD),
                                 ld_u32(pa + 8), ld_u32(pa + 8 * PLD + 8)};
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a, bfr[j][0], bfr[j][1]);
        }
      }
    }
  }

  // epilogue: + bias, store NHWC in T
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int oy = ty0 + wm * 4 + i;
    if (oy >= H) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + wn * 32 + j * 8 + 2 * t;
      if (n >= Cout) continue;
      const float b0 = bias != nullptr ? to_f32(bias[n]) : 0.f;
      const float b1 = bias != nullptr ? to_f32(bias[n + 1]) : 0.f;
      const int ox_lo = tx0 + g;
      const int ox_hi = ox_lo + 8;
      T* ob = out + (static_cast<size_t>(b) * H + oy) * W * Cout + n;
      if (ox_lo < W) {
        store2<T>(ob + static_cast<size_t>(ox_lo) * Cout, acc[i][j][0] + b0,
                  acc[i][j][1] + b1);
      }
      if (ox_hi < W) {
        store2<T>(ob + static_cast<size_t>(ox_hi) * Cout, acc[i][j][2] + b0,
                  acc[i][j][3] + b1);
      }
    }
  }
}

template <typename T, bool kAffine>
int launch(const void* x, const void* mul, const void* add, const void* w,
           const void* bias, void* out, int B, int H, int W, int Cin,
           int Cout, void* stream) {
  // a function attribute belongs to the current device: set it on every
  // launch (a host-side call of about a microsecond), as the kernel may run
  // on more than one device in a process
  cudaError_t err = cudaFuncSetAttribute(
      gn_silu_conv3x3_kernel<T, kAffine>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_y = (H + TH - 1) / TH;
  const dim3 grid(tiles_x * tiles_y, (Cout + BN - 1) / BN, B);
  gn_silu_conv3x3_kernel<T, kAffine><<<grid, kThreads, kSmem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(mul),
      static_cast<const float*>(add), static_cast<const T*>(w),
      static_cast<const T*>(bias), static_cast<T*>(out), H, W, Cin, Cout,
      tiles_x);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------------
// bf16 K2 on wgmma + TMA (see the top of the file)

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
// a third warpgroup: one warp issues the weight loads, three transform
// patches (affine + SiLU) ahead of the consumers, the first of them also
// issuing the patch loads
constexpr int kWeightWarp = kConsumerWarps;
constexpr int kTransformWarp0 = kConsumerWarps + 1;
constexpr int kTransformWarps = 3;
constexpr int kTransformers = kTransformWarps * 32;
// a transform thread's units are the 16-byte chunk (tt % 8) of pixels
// tt / 8 + kPixelStep * k: channel groups alternate between two values
constexpr int kPixelStep = kTransformers / 8;
static_assert(kPixelStep % 8 == 4, "two channel groups per thread");
constexpr int kBlockThreads = kConsumers + 128;
// the output tile, staged for its TMA store in the patch stages' place:
// two 64-channel atoms of 256 pixels x 128 bytes
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

// a block per output tile of 16x16 pixels x TN (128 or 64) channels
template <int TN>
__global__ void __launch_bounds__(wg::kBlockThreads, 1)
    gn_silu_conv3x3_kernel_wgmma(const __grid_constant__ CUtensorMap xmap,
                                 const __grid_constant__ CUtensorMap wmap,
                                 const __grid_constant__ CUtensorMap omap,
                                 const float* __restrict__ mul,
                                 const float* __restrict__ add,
                                 const __nv_bfloat16* __restrict__ bias,
                                 int H, int W, int Cin, int Cout,
                                 int tiles_x) {
  using namespace wg;
  using namespace sm90;
  constexpr int kWB = kWBytes<TN>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // TMA's 128-byte swizzle is a function of the shared address: 1024-align
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* patch = smem;  // [stage][kPatchPixels][128 bytes]
  unsigned char* wbuf = smem + kPatchStages * kPatchStride;
  uint64_t* patch_full =  // loaded (TMA -> transform warps)
      reinterpret_cast<uint64_t*>(wbuf + kWStages * kWB);
  uint64_t* patch_ready = patch_full + kPatchStages;  // -> consumers
  uint64_t* patch_empty = patch_ready + kPatchStages;  // -> patch producer
  uint64_t* w_full = patch_empty + kPatchStages;
  uint64_t* w_empty = w_full + kWStages;

  const int n0 = blockIdx.x * TN;
  const int ty0 = (blockIdx.y / tiles_x) * kTileH;
  const int tx0 = (blockIdx.y % tiles_x) * kTileW;
  const int b = blockIdx.z;
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
      for (int c = 0; c < nchunks; ++c) {
        for (int tap = 0; tap < 9; ++tap) {
          mbar_wait(&w_empty[ws], wph ^ 1);
          mbar_arrive_expect_tx(&w_full[ws], kWB);
          unsigned char* dst = wbuf + ws * kWB;
          const int row = tap * Cin + c * kChunk;
          for (int h = 0; h < TN / 64; ++h) {
            tma_load_2d(dst + h * (kWB / (TN / 64)), &wmap, &w_full[ws],
                        n0 + 64 * h, row);
          }
          if (++ws == kWStages) {
            ws = 0;
            wph ^= 1;
          }
        }
      }
    }
    return;
  }
  // the transform warps: silu(x*mul+add) in f32 -> bf16, in place, on
  // each loaded patch while the consumers run the previous chunk's
  // products; positions outside the image keep TMA's zeros (the border of
  // the normalised tensor, i.e. zero AFTER the SiLU). Thread tt's units
  // are the 16-byte chunk tt % 8 of pixels tt / 8 + 12k, which holds
  // channels 8 * ((tt % 8) ^ (p % 8)) (the 128-byte swizzle): two groups,
  // for even and odd k.
  if (warp >= kTransformWarp0) {
    const int tt = threadIdx.x - kTransformWarp0 * 32;
    auto load_patch = [&](int c) {
      const int ps = c % kPatchStages;
      if (c >= kPatchStages) {
        mbar_wait(&patch_empty[ps], ((c / kPatchStages) & 1) ^ 1);
      }
      mbar_arrive_expect_tx(&patch_full[ps], kPatchBytes);
      tma_load_4d(patch + ps * kPatchStride, &xmap, &patch_full[ps],
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
        const size_t off = static_cast<size_t>(b) * Cin + c * kChunk + grp[par];
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
      // chunk c + 2 goes where chunk c - 1 was: the consumers, now on chunk
      // c at the latest, are done with it
      if (tt == 0 && c + 2 < nchunks) load_patch(c + 2);
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
  for (int c = 0; c < nchunks; ++c) {
    const int ps = c % kPatchStages;
    mbar_wait(&patch_ready[ps], (c / kPatchStages) & 1);
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

  // epilogue: + bias, bf16. Accumulator element 4j + e of m64 tile mt:
  // pixel g (e < 2) or g + 8 of the warp's output row, channel
  // n0 + 8j + 2t + (e & 1). Staged in the 128-byte swizzled layout of
  // TN / 64 boxes (64 channels, 16, 16, 1) where the patches were (every
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
      tma_store_4d(&omap, smem + h * kOutAtomBytes, n0 + 64 * h, tx0, ty0, b);
    }
    bulk_commit();
    bulk_wait_read();  // the shared memory stays until TMA has read it
  }
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

int launch_wgmma(const void* x, const void* mul, const void* add,
                 const void* w, const void* bias, void* out, int B, int H,
                 int W, int Cin, int Cout, void* stream) {
  using namespace wg;
  if (Cin % kChunk || Cout % 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap xmap, wmap, omap;
  cudaError_t err = nhwc_map(&xmap, x, B, H, W, Cin, kPatchW, kPatchH);
  if (err == cudaSuccess) {
    err = nhwc_map(&omap, out, B, H, W, Cout, kTileW, kTileH);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint64_t wdims[2] = {static_cast<uint64_t>(Cout),
                             static_cast<uint64_t>(9) * Cin};
  const uint64_t wstrides[1] = {wdims[0] * sizeof(__nv_bfloat16)};
  const uint32_t wbox[2] = {64, kChunk};
  err = sm90::make_tensor_map(&wmap, w, 2, wdims, wstrides, wbox);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0;
  int sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const int tiles = tiles_x * ((H + kTileH - 1) / kTileH) * B;
  // 64-channel tiles where 128-channel ones would fill the SMs fewer than
  // 3 times: there a partly filled last wave costs more than reading each
  // input patch twice as often
  const bool narrow = (Cout + 127) / 128 * tiles < 3 * sms;
  auto* kernel = narrow ? gn_silu_conv3x3_kernel_wgmma<64>
                        : gn_silu_conv3x3_kernel_wgmma<128>;
  const int tn = narrow ? 64 : 128;
  const size_t smem = narrow ? kSmemBytes<64> : kSmemBytes<128>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Cout + tn - 1) / tn, tiles / B, B);
  kernel<<<grid, kBlockThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xmap, wmap, omap, static_cast<const float*>(mul),
      static_cast<const float*>(add),
      static_cast<const __nv_bfloat16*>(bias), H, W, Cin, Cout, tiles_x);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K2. x, w, bias, out of one type: f32 when `f32` is nonzero (the mma.sync
// template), else bf16 (the wgmma kernel).
extern "C" int onedc_gn_silu_conv3x3(const void* x, const void* mul,
                                     const void* add, const void* w,
                                     const void* bias, void* out, int B, int H,
                                     int W, int Cin, int Cout, int f32,
                                     void* stream) {
  return f32 ? launch<float, true>(x, mul, add, w, bias, out, B, H, W, Cin,
                                   Cout, stream)
             : launch_wgmma(x, mul, add, w, bias, out, B, H, W, Cin, Cout,
                            stream);
}

// K3, f32: x, w, out.
extern "C" int onedc_conv3x3(const void* x, const void* w, void* out, int B,
                             int H, int W, int Cin, int Cout, void* stream) {
  return launch<float, false>(x, nullptr, nullptr, w, nullptr, out, B, H, W,
                              Cin, Cout, stream);
}
