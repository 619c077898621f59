// Stride-1 convolutions as implicit GEMMs for Hopper (sm_90a): the
// kernels of the pallas_conv route.
//
// Replaces the TPU kernels of tensorflow_ocr_tpu/ops/pallas_conv.py:
//   conv_fwd, KS = 1 <- _matmul_rows (:81): the 1x1 forward and its dX;
//   conv_dw,  KS = 1 <- _dw_rows (:108):    the 1x1 dW;
//   conv_fwd, KS = 3 <- _conv3 (:148):      the 3x3 forward and its dX
//                                           (the flipped kernel);
//   conv_dw,  KS = 3 <- _dw3 (:190):        the 3x3 dW.
// conv_fwd_f32 and conv_dw_f32 are the same narrow shapes in float32.
// conv_dw here takes the dW products whose channel counts are not
// multiples of 8 (the PixelLink head's projections to 2 channels);
// conv_dw.cu's TMA and wgmma kernel takes the rest (ops/conv.py
// tma_takes).
//
// Contract (NHWC pixel rows, M = N*H*W; bf16 operands, f32 accumulate):
//   conv_fwd: y (M, Co) = bf16(im2col(x) . wt^T), wt (Co, KS*KS*Ci) with
//             K in (ky, kx, ci) order, the taps outside the image zero
//             (SAME padding);
//   conv_dw:  dw (KS*KS*Ci, Co) = im2col(x)^T . dy in f32.
// Any channel counts >= 1: the loaders of igemm.cuh (operands as they
// are, `Ident`) load 16-byte vectors where a count is a multiple of 8 and
// each element alone, predicated on the K tail and its own tap, where it
// is not. Columns past Co (the PixelLink head's 2 and 16 channels) are
// predicated in the epilogue.
//
// What bounds it on the H100: a 1x1 conv does 2*M*Ci*Co flops on
// 2*M*(Ci+Co) bytes, 16-64 flops a byte at this model's channels (2-32
// in the head): memory-bound against the card's ~295 flops a byte at
// bf16. A 3x3 does 9x the work on the same bytes and sits near the
// ridge. The dW products reduce over all M pixels into a small
// (KS*KS*Ci, Co) table.
//
// Design: the shared core of igemm.cuh (8 warps, BM x BN tiles, BK = 32,
// mma.sync m16n8k16, next slice's loads in flight, its loaders), no
// prologue or epilogue statistics. conv_fwd: rows = pixels (BM = 128), columns = Co
// (BN = 32, 64 or 128 by Co). conv_dw: rows = (tap, ci), columns = Co,
// K = pixels, transposed as they are staged; the pixels are split into
// chunks across CTAs (blockIdx.z), each chunk writes its own partial
// table, and sum_splits adds them in a fixed order: no atomics, the
// result is deterministic, and 64-row tiles where KS*KS*Ci <= 64 keep
// the tiles full. igemm_dw is held to 128 registers (two CTAs an SM).
// The host side (ops/conv.py) picks the tiles and the split, and
// allocates the partial tables. wgmma and TMA are later work.

#include <algorithm>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "igemm.cuh"

namespace {

using namespace igemm;

template <int KS, int BN>
__global__ void __launch_bounds__(THREADS)
igemm_fwd(const bf16* __restrict__ x, const bf16* __restrict__ wt,
          bf16* __restrict__ y, Geo g, int ci, int co, bool vx, bool vw) {
  constexpr int BM = 128;
  using W = Warps<BM, BN>;
  __shared__ __align__(16) bf16 sA[BM][LDS];
  __shared__ __align__(16) bf16 sB[BN][LDS];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int kdim = KS * KS * ci;

  PixelRows<KS, Ident, BM> la{{x}, g, ci, m0, vx};
  PixelRows<1, Ident, BN> lb{{wt}, Geo{1, 1, co, co}, kdim, n0, vw};
  float acc[W::MT][W::NT][4] = {};
  mainloop<BM, BN>(la, lb, (kdim + BK - 1) / BK, sA, sB, acc);

#pragma unroll
  for (int i = 0; i < W::MT; ++i)
#pragma unroll
    for (int j = 0; j < W::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        int r, c;
        acc_pos<BM, BN>(i, j, e, r, c);
        const int m = m0 + r, n = n0 + c;
        if (m >= g.m || n >= co) continue;
        bf16* out = y + (size_t)m * co + n;
        if (co % 2 == 0) {  // n even: a pair, 4-byte aligned
          *reinterpret_cast<__nv_bfloat162*>(out) =
              __floats2bfloat162_rn(acc[i][j][e], acc[i][j][e + 1]);
        } else {
          out[0] = __float2bfloat16(acc[i][j][e]);
          if (n + 1 < co) out[1] = __float2bfloat16(acc[i][j][e + 1]);
        }
      }
}

template <int KS, int BM, int BN>
__global__ void __launch_bounds__(THREADS, 2)
igemm_dw(const bf16* __restrict__ x, const bf16* __restrict__ dy,
         float* __restrict__ part, Geo g, int ci, int co, int chunk, bool vx,
         bool vdy) {
  using W = Warps<BM, BN>;
  __shared__ __align__(16) bf16 sA[BM][LDS];
  __shared__ __align__(16) bf16 sB[BN][LDS];
  const int kdim = KS * KS * ci;
  const int q0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int p0 = blockIdx.z * chunk, pend = min(g.m, p0 + chunk);

  PixelCols<KS, Ident, BM> la{{x}, g, ci, q0, p0, pend, vx};
  PixelCols<1, Ident, BN> lb{{dy}, g, co, n0, p0, pend, vdy};
  float acc[W::MT][W::NT][4] = {};
  mainloop<BM, BN>(la, lb, (pend - p0 + BK - 1) / BK, sA, sB, acc);

  float* out = part + (size_t)blockIdx.z * kdim * co;
#pragma unroll
  for (int i = 0; i < W::MT; ++i)
#pragma unroll
    for (int j = 0; j < W::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int r, c;
        acc_pos<BM, BN>(i, j, e, r, c);
        if (q0 + r < kdim && n0 + c < co)
          out[(size_t)(q0 + r) * co + n0 + c] = acc[i][j][e];
      }
}

// dw[i] = sum over the splits of part[s][i], in split order.
__global__ void sum_splits(const float* __restrict__ part,
                           float* __restrict__ dw, int size, int splits) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < size;
       i += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += part[(size_t)k * size + i];
    dw[i] = s;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int KS>
int launch_fwd(const bf16* x, const bf16* wt, bf16* y, Geo g, int ci, int co,
               int bn, cudaStream_t s) {
  const bool vx = ci % 8 == 0 && aligned16(x);
  const bool vw = (KS * KS * ci) % 8 == 0 && aligned16(wt);
  dim3 grid((g.m + 127) / 128, (co + bn - 1) / bn);
  if (bn == 128)
    igemm_fwd<KS, 128><<<grid, THREADS, 0, s>>>(x, wt, y, g, ci, co, vx, vw);
  else if (bn == 64)
    igemm_fwd<KS, 64><<<grid, THREADS, 0, s>>>(x, wt, y, g, ci, co, vx, vw);
  else if (bn == 32)
    igemm_fwd<KS, 32><<<grid, THREADS, 0, s>>>(x, wt, y, g, ci, co, vx, vw);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

template <int KS>
int launch_dw(const bf16* x, const bf16* dy, float* part, Geo g, int ci,
              int co, int bm, int bn, int chunk, int splits, cudaStream_t s) {
  const bool vx = ci % 8 == 0 && aligned16(x);
  const bool vdy = co % 8 == 0 && aligned16(dy);
  const int kdim = KS * KS * ci;
  dim3 grid((kdim + bm - 1) / bm, (co + bn - 1) / bn, splits);
#define CONV_DW(BM_, BN_)                                              \
  igemm_dw<KS, BM_, BN_><<<grid, THREADS, 0, s>>>(x, dy, part, g, ci, co, \
                                                  chunk, vx, vdy)
  if (bm == 128 && bn == 128) CONV_DW(128, 128);
  else if (bm == 128 && bn == 64) CONV_DW(128, 64);
  else if (bm == 128 && bn == 32) CONV_DW(128, 32);
  else if (bm == 64 && bn == 128) CONV_DW(64, 128);
  else if (bm == 64 && bn == 64) CONV_DW(64, 64);
  else return cudaErrorInvalidValue;
#undef CONV_DW
  return cudaGetLastError();
}

// ---------------------------------------------------------------- float32
//
// The narrow shapes in float32 (the head's projections to 2 channels: the
// dX that contracts 2 channels, the dW into 2 columns): plain SIMT loops
// of f32 FMAs, one output element a thread, summed in K order. The forward
// reads 2 (18) values a pixel and writes Ci; the dW reads each pixel's x
// once a column (from L1) and splits the pixels into chunks, each summed
// in order into its own partial table, added by sum_splits in split order.

template <int KS>
__global__ void narrow_fwd_f32(const float* __restrict__ x,
                               const float* __restrict__ wt,
                               float* __restrict__ y, Geo g, int ci, int co) {
  const long long total = (long long)g.m * co;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int m = (int)(i / co), nn = (int)(i % co);
    const float* wr = wt + (size_t)nn * KS * KS * ci;
    float acc = 0.f;
    for (int t = 0; t < KS * KS; ++t) {
      const int pix = tap_pixel<KS>(g, m, t);
      if (pix < 0) continue;
      const float* xr = x + (size_t)pix * ci;
      for (int c = 0; c < ci; ++c) acc = fmaf(xr[c], wr[t * ci + c], acc);
    }
    y[i] = acc;
  }
}

template <int KS>
__global__ void narrow_dw_f32(const float* __restrict__ x,
                              const float* __restrict__ dy,
                              float* __restrict__ part, Geo g, int ci, int co,
                              int chunk) {
  const int kdim = KS * KS * ci;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= kdim * co) return;
  const int q = e / co, nn = e % co, t = q / ci, c = q % ci;
  const int p0 = blockIdx.y * chunk, pend = min(g.m, p0 + chunk);
  float acc = 0.f;
  for (int p = p0; p < pend; ++p) {
    const int pix = tap_pixel<KS>(g, p, t);
    if (pix >= 0)
      acc = fmaf(x[(size_t)pix * ci + c], dy[(size_t)p * co + nn], acc);
  }
  part[(size_t)blockIdx.y * kdim * co + e] = acc;
}

}  // namespace

// x (n,h,w,ci) bf16; wt (co, ks*ks*ci) bf16 with K in (ky, kx, ci) order;
// y (n,h,w,co) bf16 out. bn (32, 64 or 128): the column tile. Returns the
// launch error.
extern "C" int conv_fwd(const void* x, const void* wt, void* y, int n, int h,
                        int w, int ci, int co, int ks, int bn, void* stream) {
  if (ci < 1 || co < 1 || (ks != 1 && ks != 3)) return cudaErrorInvalidValue;
  Geo g{n, h, w, n * h * w};
  if (g.m == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto xb = static_cast<const bf16*>(x);
  auto wb = static_cast<const bf16*>(wt);
  auto yb = static_cast<bf16*>(y);
  return ks == 1 ? launch_fwd<1>(xb, wb, yb, g, ci, co, bn, s)
                 : launch_fwd<3>(xb, wb, yb, g, ci, co, bn, s);
}

// x (n,h,w,ci) bf16; dy (n,h,w,co) bf16; dw (ks*ks*ci, co) f32 out, with
// K in (ky, kx, ci) order. The pixels are split into `splits` chunks of
// `chunk` (a multiple of 32; every chunk holds a pixel); with splits > 1,
// ws holds splits * ks*ks*ci * co floats of partial tables, else it is
// unused. bm x bn: the tile (128 x {32, 64, 128} or 64 x {64, 128}).
// Returns the first launch error.
extern "C" int conv_dw(const void* x, const void* dy, void* dw, void* ws,
                       int n, int h, int w, int ci, int co, int ks, int bm,
                       int bn, int chunk, int splits, void* stream) {
  if (ci < 1 || co < 1 || (ks != 1 && ks != 3) || chunk % BK || splits < 1)
    return cudaErrorInvalidValue;
  Geo g{n, h, w, n * h * w};
  const int size = ks * ks * ci * co;
  auto s = static_cast<cudaStream_t>(stream);
  if (g.m == 0) return cudaMemsetAsync(dw, 0, sizeof(float) * size, s);
  if ((long long)chunk * (splits - 1) >= g.m ||
      (long long)chunk * splits < g.m)
    return cudaErrorInvalidValue;
  auto xb = static_cast<const bf16*>(x);
  auto dyb = static_cast<const bf16*>(dy);
  float* part = static_cast<float*>(splits > 1 ? ws : dw);
  int err = ks == 1
                ? launch_dw<1>(xb, dyb, part, g, ci, co, bm, bn, chunk, splits, s)
                : launch_dw<3>(xb, dyb, part, g, ci, co, bm, bn, chunk, splits, s);
  if (err != cudaSuccess || splits == 1) return err;
  const int blocks = std::min((size + 255) / 256, 4096);
  sum_splits<<<blocks, 256, 0, s>>>(part, static_cast<float*>(dw), size,
                                    splits);
  return cudaGetLastError();
}

// The float32 forward of any channel counts: x (n,h,w,ci), wt (co,
// ks*ks*ci), y (n,h,w,co), all f32. Returns the launch error.
extern "C" int conv_fwd_f32(const void* x, const void* wt, void* y, int n,
                            int h, int w, int ci, int co, int ks,
                            void* stream) {
  if (ci < 1 || co < 1 || (ks != 1 && ks != 3)) return cudaErrorInvalidValue;
  Geo g{n, h, w, n * h * w};
  if (g.m == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const long long total = (long long)g.m * co;
  const int blocks = (int)std::min<long long>((total + 255) / 256, 65536);
  auto xf = static_cast<const float*>(x);
  auto wf = static_cast<const float*>(wt);
  auto yf = static_cast<float*>(y);
  if (ks == 1)
    narrow_fwd_f32<1><<<blocks, 256, 0, s>>>(xf, wf, yf, g, ci, co);
  else
    narrow_fwd_f32<3><<<blocks, 256, 0, s>>>(xf, wf, yf, g, ci, co);
  return cudaGetLastError();
}

// The float32 dW of any channel counts: x (n,h,w,ci), dy (n,h,w,co) f32;
// dw (ks*ks*ci, co) f32 out. The pixels in `splits` chunks of `chunk`
// (every chunk holds a pixel); with splits > 1, ws holds splits partial
// tables. Returns the first launch error.
extern "C" int conv_dw_f32(const void* x, const void* dy, void* dw, void* ws,
                           int n, int h, int w, int ci, int co, int ks,
                           int chunk, int splits, void* stream) {
  if (ci < 1 || co < 1 || (ks != 1 && ks != 3) || chunk < 1 || splits < 1)
    return cudaErrorInvalidValue;
  Geo g{n, h, w, n * h * w};
  const int size = ks * ks * ci * co;
  auto s = static_cast<cudaStream_t>(stream);
  if (g.m == 0) return cudaMemsetAsync(dw, 0, sizeof(float) * size, s);
  if ((long long)chunk * (splits - 1) >= g.m ||
      (long long)chunk * splits < g.m)
    return cudaErrorInvalidValue;
  float* part = static_cast<float*>(splits > 1 ? ws : dw);
  const dim3 grid((size + 255) / 256, splits);
  auto xf = static_cast<const float*>(x);
  auto df = static_cast<const float*>(dy);
  if (ks == 1)
    narrow_dw_f32<1><<<grid, 256, 0, s>>>(xf, df, part, g, ci, co, chunk);
  else
    narrow_dw_f32<3><<<grid, 256, 0, s>>>(xf, df, part, g, ci, co, chunk);
  int err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int blocks = std::min((size + 255) / 256, 4096);
  sum_splits<<<blocks, 256, 0, s>>>(part, static_cast<float*>(dw), size,
                                    splits);
  return cudaGetLastError();
}
