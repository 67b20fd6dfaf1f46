// Fused GroupNorm-affine + SiLU + 3x3 convolution for Hopper (implicit GEMM).
//
// Replaces the Pallas TPU kernel onedc_tpu/ops/pallas_conv.py:292
// (_conv3x3_v2_single, body _kernel_v2 :219), entered through
// affine_silu_conv3x3 :404. Computes
//     out[b] = conv3x3(silu(x[b] * mul[b, c] + add[b, c])) + bias
// with stride 1 and a zero "same" border applied AFTER the SiLU, so the
// normalised tensor never reaches device memory.
//
// Layout: x (B, H, W, Cin) bf16 NHWC; mul, add (B, Cin) f32; w (3, 3, Cin,
// Cout) bf16, i.e. [tap][Cin][Cout]; bias (Cout) bf16; out (B, H, W, Cout)
// bf16 NHWC. Cin % 32 == 0, Cout % 8 == 0 (the wrapper checks).
//
// What bounds it on the H100: a VAE-decoder conv does 18*H*W*Cin*Cout FLOPs
// on ~2*H*W*(Cin + Cout) bytes, e.g. 768x768x256->128: ~174 GFLOP on 453 MB,
// ~380 FLOP/byte, above the ~295 ridge, so the tensor cores bound it (and
// the smaller spatial levels with 512 channels are further above the ridge).
// The design: each block owns an 8x16-pixel x 128-channel output tile and
// loops over 32-channel input chunks. Per chunk it copies the raw input patch
// with its 1-pixel halo (10x18 pixels) and the chunk's weights for all 9 taps
// into shared memory with cp.async, all copies in flight at once (positions
// outside the image zero-filled); the prologue then applies affine + SiLU in
// f32 in place and rounds to bf16, leaving the border zero; the 9 taps read
// shifted windows of the same staged patch, so each input pixel is
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

__device__ __forceinline__ float silu(float v) {
  return __fdividef(v, 1.f + __expf(-v));
}

__global__ void __launch_bounds__(kThreads)
    gn_silu_conv3x3_kernel(const __nv_bfloat16* __restrict__ x,
                           const float* __restrict__ mul,
                           const float* __restrict__ add,
                           const __nv_bfloat16* __restrict__ w,
                           const __nv_bfloat16* __restrict__ bias,
                           __nv_bfloat16* __restrict__ out, int H, int W,
                           int Cin, int Cout, int tiles_x) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(smem);  // [PH*PW][PLD]
  __nv_bfloat16* sW = sP + PH * PW * PLD;                      // [9*BK][WLD]

  const int ty0 = (blockIdx.x / tiles_x) * TH;
  const int tx0 = (blockIdx.x % tiles_x) * TW;
  const int n0 = blockIdx.y * BN;
  const int b = blockIdx.z;
  const __nv_bfloat16* xb = x + static_cast<size_t>(b) * H * W * Cin;
  const float* mb = mul + static_cast<size_t>(b) * Cin;
  const float* ab = add + static_cast<size_t>(b) * Cin;

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

    // raw input patch (with halo) and this chunk's weights for all 9 taps,
    // all copies in flight at once; positions outside the image and output
    // channels past Cout are zero-filled
    for (int i = threadIdx.x; i < PH * PW * (BK / 8); i += kThreads) {
      const int p = i / (BK / 8);
      const int cv = (i % (BK / 8)) * 8;
      const int iy = ty0 + p / PW - 1;
      const int ix = tx0 + p % PW - 1;
      const bool inside = iy >= 0 && iy < H && ix >= 0 && ix < W;
      cp_async16(sP + p * PLD + cv,
                 inside ? xb + (static_cast<size_t>(iy) * W + ix) * Cin + c0 + cv
                        : xb,
                 inside);
    }
    for (int i = threadIdx.x; i < 9 * BK * (BN / 8); i += kThreads) {
      const int r = i / (BN / 8);
      const int nv = (i % (BN / 8)) * 8;
      const int tap = r / BK;
      const int c = r % BK;
      const bool valid = n0 + nv < Cout;
      cp_async16(sW + r * WLD + nv,
                 valid ? w + (static_cast<size_t>(tap) * Cin + c0 + c) * Cout +
                             n0 + nv
                       : w,
                 valid);
    }
    cp_async_wait_all();
    __syncthreads();

    // prologue, in place: silu(x*mul+add) in f32 -> bf16 inside the image;
    // the zero-filled border stays zero (it is the border of the normalised
    // tensor, i.e. zero AFTER the SiLU)
    for (int i = threadIdx.x; i < PH * PW * (BK / 8); i += kThreads) {
      const int p = i / (BK / 8);
      const int cv = (i % (BK / 8)) * 8;
      const int iy = ty0 + p / PW - 1;
      const int ix = tx0 + p % PW - 1;
      if (iy < 0 || iy >= H || ix < 0 || ix >= W) continue;
      uint4* slot = reinterpret_cast<uint4*>(sP + p * PLD + cv);
      const uint4 raw = *slot;
      const __nv_bfloat16* rv = reinterpret_cast<const __nv_bfloat16*>(&raw);
      const float4 m_lo = *reinterpret_cast<const float4*>(mb + c0 + cv);
      const float4 m_hi = *reinterpret_cast<const float4*>(mb + c0 + cv + 4);
      const float4 a_lo = *reinterpret_cast<const float4*>(ab + c0 + cv);
      const float4 a_hi = *reinterpret_cast<const float4*>(ab + c0 + cv + 4);
      const float mm[8] = {m_lo.x, m_lo.y, m_lo.z, m_lo.w,
                           m_hi.x, m_hi.y, m_hi.z, m_hi.w};
      const float aa[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w,
                           a_hi.x, a_hi.y, a_hi.z, a_hi.w};
      uint4 packed;
      uint32_t* pk = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        const float v0 = silu(__bfloat162float(rv[e]) * mm[e] + aa[e]);
        const float v1 =
            silu(__bfloat162float(rv[e + 1]) * mm[e + 1] + aa[e + 1]);
        pk[e / 2] = pack_bf16(v0, v1);
      }
      *slot = packed;
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

  // epilogue: + bias, round to bf16, store NHWC
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int oy = ty0 + wm * 4 + i;
    if (oy >= H) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + wn * 32 + j * 8 + 2 * t;
      if (n >= Cout) continue;
      const float b0 = __bfloat162float(bias[n]);
      const float b1 = __bfloat162float(bias[n + 1]);
      const int ox_lo = tx0 + g;
      const int ox_hi = ox_lo + 8;
      __nv_bfloat16* ob = out + (static_cast<size_t>(b) * H + oy) * W * Cout + n;
      if (ox_lo < W) {
        *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(ox_lo) * Cout) =
            pack_bf16(acc[i][j][0] + b0, acc[i][j][1] + b1);
      }
      if (ox_hi < W) {
        *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(ox_hi) * Cout) =
            pack_bf16(acc[i][j][2] + b0, acc[i][j][3] + b1);
      }
    }
  }
}

}  // namespace

extern "C" int onedc_gn_silu_conv3x3(const void* x, const void* mul,
                                     const void* add, const void* w,
                                     const void* bias, void* out, int B, int H,
                                     int W, int Cin, int Cout, void* stream) {
  // a function attribute belongs to the current device: set it on every
  // launch (a host-side call of about a microsecond), as the kernel may run
  // on more than one device in a process
  cudaError_t err = cudaFuncSetAttribute(
      gn_silu_conv3x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_y = (H + TH - 1) / TH;
  const dim3 grid(tiles_x * tiles_y, (Cout + BN - 1) / BN, B);
  gn_silu_conv3x3_kernel<<<grid, kThreads, kSmem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(mul),
      static_cast<const float*>(add), static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(out),
      H, W, Cin, Cout, tiles_x);
  return static_cast<int>(cudaGetLastError());
}
