// Fused conv+BN+relu, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of tensorflow_ocr_tpu/ops/pallas_fused.py:
//   fused_conv_fwd <- _f1x1 (:112) and _f3x3 (:153);
//   fused_conv_bwd <- _fused_conv1x1_bwd (:267) and _fused_conv3x3_bwd (:318).
// One source, templated on the kernel size KS (1 or 3, stride 1, SAME).
//
// Contract (NHWC rows, M = N*H*W; bf16 activations, f32 tables):
//   forward:  xn = bf16(relu(x*a + b)), zero at the pad taps (the pad
//             applies to the ACTIVATED tensor, so it comes after the
//             prologue); y = bf16(acc), acc = im2col(xn) . W in f32;
//             s = [sum acc, sum acc^2] per output channel, from the f32
//             accumulator.
//   backward: dye = bf16(dy + ds0 + 2*y*ds1), zero at the pad taps;
//             dW = im2col(xn)^T . dye (f32);
//             g = im2col(dye) . Wflip (the flipped, transposed kernel);
//             gm = g*[x*a + b > 0]; dx = bf16(gm*a);
//             dab = [sum gm*x, sum gm] per input channel.
//
// What bounds it on the H100: at the slice's shapes (M = 524,288 rows at
// 128x128, channels 64-256) a 1x1 conv does 2*M*Ci*Co flops on 2*M*(Ci+Co)
// bytes, 16-64 flops a byte: memory-bound against the card's ~295 flops a
// byte at bf16. The 3x3 convs do 9x the work on the same bytes and sit
// near the ridge. So the design keeps the activated operand and dy_eff
// out of device memory: the affine+relu prologue and the dy_eff fold are
// applied as tiles are staged into shared memory, and the statistics are
// reduced from the accumulator in registers (one f32 atomicAdd per block
// and channel). That is the TPU kernel's idea; its tiling is not.
//
// Design: an implicit GEMM, one CTA of 256 threads (8 warps) per
// 128 x BN output tile, BK = 32. Tiles go global -> registers -> shared
// memory, with the next tile's global loads in flight while the tensor
// cores (mma.sync m16n8k16 bf16, f32 accumulate) work on the current
// one: the shared core and loaders of igemm.cuh, with the two transforms
// below (AffineRelu, DyEff) applied as a tile is stored. Every channel
// count is a multiple of 64, so each 8-wide K vector lies inside one tap
// and loads as one 16-byte vector. Three kernels:
//   conv_fwd:  rows = pixels, cols = Co, K = KS*KS*Ci;
//   conv_dx:   rows = pixels, cols = Ci, K = KS*KS*Co (dye in, dx out);
//   conv_dw:   rows = KS*KS*Ci, cols = Co, K = pixels, split over the
//              pixels across CTAs and summed with f32 atomics into dW.
// wgmma, TMA and a deeper pipeline are later work: this version is the
// simple one that is right first.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "igemm.cuh"

namespace {

using namespace igemm;

constexpr int BM = 128;

// The operand transforms of the fused kernels, for igemm.cuh's loaders
// (channel counts multiples of 8): raw loads at fetch time, the transform
// when the tile is stored.

// xn = relu(x*a + b), a and b per channel.
struct AffineRelu {
  static constexpr bool kEach = false;
  struct Reg {
    uint4 r;
    int c;      // first channel
    bool live;  // false: zero (pad tap or out of range)
  };
  const bf16* x;
  const float *a, *b;

  __device__ __forceinline__ void fetch(Reg& v, int pix, int ch,
                                        int c) const {
    v.c = c;
    v.live = pix >= 0;
    if (v.live)
      v.r = __ldg(reinterpret_cast<const uint4*>(x + (size_t)pix * ch + c));
  }
  __device__ __forceinline__ uint4 value(const Reg& v) const {
    if (!v.live) return make_uint4(0, 0, 0, 0);
    float xf[8], p[8], q[8], o[8];
    unpack8(v.r, xf);
    load8f(a + v.c, p);
    load8f(b + v.c, q);
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = fmaxf(affine(xf[i], p[i], q[i]), 0.f);
    return pack8(o);
  }
};

// dye = dy + ds0 + 2*y*ds1, ds0 and ds1 per channel.
struct DyEff {
  static constexpr bool kEach = false;
  struct Reg {
    uint4 dy, y;
    int c;
    bool live;
  };
  const bf16 *dy, *y;
  const float *ds0, *ds1;

  __device__ __forceinline__ void fetch(Reg& v, int pix, int ch,
                                        int c) const {
    v.c = c;
    v.live = pix >= 0;
    if (v.live) {
      size_t off = (size_t)pix * ch + c;
      v.dy = __ldg(reinterpret_cast<const uint4*>(dy + off));
      v.y = __ldg(reinterpret_cast<const uint4*>(y + off));
    }
  }
  __device__ __forceinline__ uint4 value(const Reg& v) const {
    if (!v.live) return make_uint4(0, 0, 0, 0);
    float d[8], yf[8], p[8], q[8], o[8];
    unpack8(v.dy, d);
    unpack8(v.y, yf);
    load8f(ds0 + v.c, p);
    load8f(ds1 + v.c, q);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      o[i] = __fadd_rn(__fadd_rn(d[i], p[i]), __fmul_rn(2.f * yf[i], q[i]));
    return pack8(o);
  }
};

// ---------------------------------------------------------------- kernels

template <int KS, int BN>
__global__ void __launch_bounds__(THREADS)
conv_fwd(const bf16* __restrict__ x, const float* __restrict__ ab,
         const bf16* __restrict__ wt, bf16* __restrict__ y,
         float* __restrict__ stats, Geo g, int ci, int co) {
  using W = Warps<BM, BN>;
  __shared__ __align__(16) bf16 sA[BM][LDS];
  __shared__ __align__(16) bf16 sB[BN][LDS];
  __shared__ float red[2][128];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  for (int i = threadIdx.x; i < 2 * 128; i += THREADS) red[i / 128][i % 128] = 0.f;

  const int kdim = KS * KS * ci;
  PixelRows<KS, AffineRelu, BM> la{{x, ab, ab + ci}, g, ci, m0, true};
  PixelRows<1, Ident, BN> lb{{wt}, Geo{1, 1, co, co}, kdim, n0, true};
  float acc[W::MT][W::NT][4] = {};
  mainloop<BM, BN>(la, lb, kdim / BK, sA, sB, acc);

  float p0[W::NT][2] = {}, p1[W::NT][2] = {};
#pragma unroll
  for (int i = 0; i < W::MT; ++i)
#pragma unroll
    for (int j = 0; j < W::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        int r, c;
        acc_pos<BM, BN>(i, j, e, r, c);
        if (m0 + r >= g.m) continue;
        float u = acc[i][j][e], v = acc[i][j][e + 1];
        *reinterpret_cast<__nv_bfloat162*>(y + (size_t)(m0 + r) * co + n0 + c) =
            __floats2bfloat162_rn(u, v);
        p0[j][0] += u;
        p0[j][1] += v;
        p1[j][0] += u * u;
        p1[j][1] += v * v;
      }
  reduce_cols<BM, BN>(p0, p1, red);
  __syncthreads();
  for (int c = threadIdx.x; c < BN; c += THREADS) {
    atomicAdd(&stats[n0 + c], red[0][c]);
    atomicAdd(&stats[co + n0 + c], red[1][c]);
  }
}

template <int KS, int BN>
__global__ void __launch_bounds__(THREADS)
conv_dx(const bf16* __restrict__ x, const float* __restrict__ ab,
        const bf16* __restrict__ wflip, const bf16* __restrict__ y,
        const bf16* __restrict__ dy, const float* __restrict__ ds,
        bf16* __restrict__ dx, float* __restrict__ dab, Geo g, int ci,
        int co) {
  using W = Warps<BM, BN>;
  __shared__ __align__(16) bf16 sA[BM][LDS];
  __shared__ __align__(16) bf16 sB[BN][LDS];
  __shared__ float red[2][128];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  for (int i = threadIdx.x; i < 2 * 128; i += THREADS) red[i / 128][i % 128] = 0.f;

  const int kdim = KS * KS * co;
  PixelRows<KS, DyEff, BM> la{{dy, y, ds, ds + co}, g, co, m0, true};
  PixelRows<1, Ident, BN> lb{{wflip}, Geo{1, 1, ci, ci}, kdim, n0, true};
  float acc[W::MT][W::NT][4] = {};
  mainloop<BM, BN>(la, lb, kdim / BK, sA, sB, acc);

  float p0[W::NT][2] = {}, p1[W::NT][2] = {};
#pragma unroll
  for (int j = 0; j < W::NT; ++j) {
    int r, c;
    acc_pos<BM, BN>(0, j, 0, r, c);
    const float a0 = __ldg(ab + n0 + c), a1 = __ldg(ab + n0 + c + 1);
    const float b0 = __ldg(ab + ci + n0 + c), b1 = __ldg(ab + ci + n0 + c + 1);
#pragma unroll
    for (int i = 0; i < W::MT; ++i)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        acc_pos<BM, BN>(i, j, e, r, c);
        if (m0 + r >= g.m) continue;
        size_t off = (size_t)(m0 + r) * ci + n0 + c;
        float2 xv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(x + off));
        float gu = affine(xv.x, a0, b0) > 0.f ? acc[i][j][e] : 0.f;
        float gv = affine(xv.y, a1, b1) > 0.f ? acc[i][j][e + 1] : 0.f;
        *reinterpret_cast<__nv_bfloat162*>(dx + off) =
            __floats2bfloat162_rn(gu * a0, gv * a1);
        p0[j][0] += gu * xv.x;
        p0[j][1] += gv * xv.y;
        p1[j][0] += gu;
        p1[j][1] += gv;
      }
  }
  reduce_cols<BM, BN>(p0, p1, red);
  __syncthreads();
  for (int c = threadIdx.x; c < BN; c += THREADS) {
    atomicAdd(&dab[n0 + c], red[0][c]);
    atomicAdd(&dab[ci + n0 + c], red[1][c]);
  }
}

template <int KS, int BN>
__global__ void __launch_bounds__(THREADS)
conv_dw(const bf16* __restrict__ x, const float* __restrict__ ab,
        const bf16* __restrict__ y, const bf16* __restrict__ dy,
        const float* __restrict__ ds, float* __restrict__ dw, Geo g, int ci,
        int co, int chunk) {
  using W = Warps<BM, BN>;
  __shared__ __align__(16) bf16 sA[BM][LDS];
  __shared__ __align__(16) bf16 sB[BN][LDS];
  const int kdim = KS * KS * ci;
  const int q0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int p0 = blockIdx.z * chunk;
  const int pend = min(g.m, p0 + chunk);
  if (p0 >= pend) return;

  PixelCols<KS, AffineRelu, BM> la{{x, ab, ab + ci}, g, ci, q0, p0, pend,
                                   true};
  PixelCols<1, DyEff, BN> lb{{dy, y, ds, ds + co}, g, co, n0, p0, pend,
                             true};
  float acc[W::MT][W::NT][4] = {};
  mainloop<BM, BN>(la, lb, (pend - p0 + BK - 1) / BK, sA, sB, acc);

#pragma unroll
  for (int i = 0; i < W::MT; ++i)
#pragma unroll
    for (int j = 0; j < W::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int r, c;
        acc_pos<BM, BN>(i, j, e, r, c);
        if (q0 + r < kdim) atomicAdd(&dw[(size_t)(q0 + r) * co + n0 + c], acc[i][j][e]);
      }
}

int num_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 132;
  }
  return n;
}

template <int KS>
int launch_fwd(const bf16* x, const float* ab, const bf16* wt, bf16* y,
               float* stats, Geo g, int ci, int co, cudaStream_t s) {
  dim3 grid((g.m + BM - 1) / BM, 1);
  if (co % 128 == 0) {
    grid.y = co / 128;
    conv_fwd<KS, 128><<<grid, THREADS, 0, s>>>(x, ab, wt, y, stats, g, ci, co);
  } else {
    grid.y = co / 64;
    conv_fwd<KS, 64><<<grid, THREADS, 0, s>>>(x, ab, wt, y, stats, g, ci, co);
  }
  return cudaGetLastError();
}

template <int KS>
int launch_bwd(const bf16* x, const float* ab, const bf16* wflip,
               const bf16* y, const bf16* dy, const float* ds, bf16* dx,
               float* dab, float* dw, Geo g, int ci, int co, cudaStream_t s) {
  // dW: (KS*KS*ci) x co tiles, the pixels split to fill ~4 waves
  const int kdim = KS * KS * ci;
  const int bn = co % 128 == 0 ? 128 : 64;
  const int tiles = ((kdim + BM - 1) / BM) * (co / bn);
  int splits = (4 * num_sms() + tiles - 1) / tiles;
  int chunk = (g.m + splits - 1) / splits;
  chunk = (chunk + BK - 1) / BK * BK;
  splits = (g.m + chunk - 1) / chunk;
  dim3 gw((kdim + BM - 1) / BM, co / bn, splits);
  if (bn == 128)
    conv_dw<KS, 128><<<gw, THREADS, 0, s>>>(x, ab, y, dy, ds, dw, g, ci, co, chunk);
  else
    conv_dw<KS, 64><<<gw, THREADS, 0, s>>>(x, ab, y, dy, ds, dw, g, ci, co, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  dim3 gx((g.m + BM - 1) / BM, 1);
  if (ci % 128 == 0) {
    gx.y = ci / 128;
    conv_dx<KS, 128><<<gx, THREADS, 0, s>>>(x, ab, wflip, y, dy, ds, dx, dab, g, ci, co);
  } else {
    gx.y = ci / 64;
    conv_dx<KS, 64><<<gx, THREADS, 0, s>>>(x, ab, wflip, y, dy, ds, dx, dab, g, ci, co);
  }
  return cudaGetLastError();
}

}  // namespace

// x (n,h,w,ci) bf16; ab (2,ci) f32; wt (co, ks*ks*ci) bf16 with K in
// (ky, kx, ci) order; y (n,h,w,co) bf16 out; stats (2,co) f32, zeroed by
// the caller. ci, co multiples of 64; ks 1 or 3. Returns the launch error.
extern "C" int fused_conv_fwd(const void* x, const void* ab, const void* wt,
                              void* y, void* stats, int n, int h, int w,
                              int ci, int co, int ks, void* stream) {
  if (ci % 64 || co % 64 || (ks != 1 && ks != 3)) return cudaErrorInvalidValue;
  Geo g{n, h, w, n * h * w};
  if (g.m == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto xb = static_cast<const bf16*>(x);
  auto abf = static_cast<const float*>(ab);
  auto wb = static_cast<const bf16*>(wt);
  auto yb = static_cast<bf16*>(y);
  auto st = static_cast<float*>(stats);
  return ks == 1 ? launch_fwd<1>(xb, abf, wb, yb, st, g, ci, co, s)
                 : launch_fwd<3>(xb, abf, wb, yb, st, g, ci, co, s);
}

// x, ab as above; wflip (ci, ks*ks*co) bf16, the flipped kernel with K
// in (ky, kx, co) order; y, dy (n,h,w,co) bf16; ds (2,co) f32; outputs
// dx (n,h,w,ci) bf16, dab (2,ci) f32 and dw (ks*ks*ci, co) f32, the last
// two zeroed by the caller. Returns the first launch error.
extern "C" int fused_conv_bwd(const void* x, const void* ab,
                              const void* wflip, const void* y,
                              const void* dy, const void* ds, void* dx,
                              void* dab, void* dw, int n, int h, int w,
                              int ci, int co, int ks, void* stream) {
  if (ci % 64 || co % 64 || (ks != 1 && ks != 3)) return cudaErrorInvalidValue;
  Geo g{n, h, w, n * h * w};
  if (g.m == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto args = [&](auto launch) {
    return launch(static_cast<const bf16*>(x), static_cast<const float*>(ab),
                  static_cast<const bf16*>(wflip), static_cast<const bf16*>(y),
                  static_cast<const bf16*>(dy), static_cast<const float*>(ds),
                  static_cast<bf16*>(dx), static_cast<float*>(dab),
                  static_cast<float*>(dw), g, ci, co, s);
  };
  return ks == 1 ? args(launch_bwd<1>) : args(launch_bwd<3>);
}
