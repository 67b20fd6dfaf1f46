// 3x3 stride-1 "same" convolutions for Hopper (implicit GEMM), two kernels
// from one template:
//
// K2, fused GroupNorm-affine + SiLU + 3x3 conv. Replaces the Pallas TPU
// kernel onedc_tpu/ops/pallas_conv.py:292 (_conv3x3_v2_single, body
// _kernel_v2 :219), entered through affine_silu_conv3x3 :404. Computes
//     out[b] = conv3x3(silu(x[b] * mul[b, c] + add[b, c])) + bias
// with a zero border applied AFTER the SiLU, so the normalised tensor never
// reaches device memory.
//
// K3, the plain 3x3 conv out = conv3x3(x) (no prologue, no bias). Replaces
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
// and out are all bf16 (serving) or all f32 (training). Cin % 32 == 0,
// Cout % 8 == 0 (the wrapper checks).
//
// What bounds it on the H100: a VAE conv does 18*H*W*Cin*Cout FLOPs on
// ~2*H*W*(Cin + Cout) bytes in bf16, e.g. 768x768x256->128: ~174 GFLOP on
// 453 MB, ~380 FLOP/byte, above the ~295 ridge, so the tensor cores bound
// it (the smaller spatial levels with 512 channels are further above it;
// f32 operands double the bytes and bring the 128-channel levels near the
// ridge).
// The design: each block owns an 8x16-pixel x 128-channel output tile and
// loops over 32-channel input chunks. Per chunk it stages the input patch
// with its 1-pixel halo (10x18 pixels) and the chunk's weights for all 9 taps
// into shared memory as bf16 (positions outside the image zero-filled): bf16
// by cp.async, all copies in flight at once, K2's prologue then applying
// affine + SiLU in f32 in place; f32 through registers, K2's affine + SiLU
// applied in f32 on the way, rounded to bf16 as they are stored. The 9 taps
// read shifted windows of the same staged patch, so each input pixel is
// transformed once per chunk, not nine times. Products run on the tensor
// cores (mma.sync m16n8k16 bf16, f32 accumulate); bias is added in the
// epilogue. Two blocks share an SM (~93 KB of shared memory each), so one
// block's copies overlap the other's math; a double-buffered variant at one
// block per SM measured slower. The batch is a grid dimension.
// Hopper has no 128-lane tiling constraint, so the TPU gate
// supports_pallas_conv (pallas_conv.py:143) does not carry over: any H, W
// work, with ragged tiles masked.
// Not yet done: TMA, wgmma, and larger pixel tiles to cut the per-block
// weight reloads from L2, now the main cost (later work).

#include "mma.cuh"

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

// K2 (kAffine) and K3 (!kAffine; mul, add and bias null); the profiling
// tools group by this name (tools/profile_port_decode.py), and tell K3 by
// its template argument (tools/profile_port_train.py)
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
      if constexpr (kIsBf16<T> || !kAffine) {
        stage8<T>(dst, src, inside);
      } else {  // f32 K2: affine + SiLU on the way in; the border stays 0
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
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    if constexpr (kIsBf16<T> && kAffine) {
      // prologue, in place: silu(x*mul+add) in f32 -> bf16 inside the
      // image; the zero-filled border stays zero (it is the border of the
      // normalised tensor, i.e. zero AFTER the SiLU)
      for (int i = threadIdx.x; i < PH * PW * (BK / 8); i += kThreads) {
        const int p = i / (BK / 8);
        const int cv = (i % (BK / 8)) * 8;
        const int iy = ty0 + p / PW - 1;
        const int ix = tx0 + p % PW - 1;
        if (iy < 0 || iy >= H || ix < 0 || ix >= W) continue;
        uint4* slot = reinterpret_cast<uint4*>(sP + p * PLD + cv);
        const uint4 raw = *slot;
        const __nv_bfloat16* rv = reinterpret_cast<const __nv_bfloat16*>(&raw);
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(rv[e]);
        *slot = affine_silu8(v, mb + c0 + cv, ab + c0 + cv);
      }
      __syncthreads();
    }

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

}  // namespace

// K2. x, w, bias, out of one type: f32 when `f32` is nonzero, else bf16.
extern "C" int onedc_gn_silu_conv3x3(const void* x, const void* mul,
                                     const void* add, const void* w,
                                     const void* bias, void* out, int B, int H,
                                     int W, int Cin, int Cout, int f32,
                                     void* stream) {
  return f32 ? launch<float, true>(x, mul, add, w, bias, out, B, H, W, Cin,
                                   Cout, stream)
             : launch<__nv_bfloat16, true>(x, mul, add, w, bias, out, B, H, W,
                                           Cin, Cout, stream);
}

// K3. x, w, out of one type: f32 when `f32` is nonzero, else bf16.
extern "C" int onedc_conv3x3(const void* x, const void* w, void* out, int B,
                             int H, int W, int Cin, int Cout, int f32,
                             void* stream) {
  return f32 ? launch<float, false>(x, nullptr, nullptr, w, nullptr, out, B,
                                    H, W, Cin, Cout, stream)
             : launch<__nv_bfloat16, false>(x, nullptr, nullptr, w, nullptr,
                                            out, B, H, W, Cin, Cout, stream);
}
