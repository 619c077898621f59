// Fused conv+BN+relu, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of tensorflow_ocr_tpu/ops/pallas_fused.py:
//   fused_conv_fwd <- _f1x1 (:112) and _f3x3 (:153);
//   fused_conv_bwd <- _fused_conv1x1_bwd (:267) and _fused_conv3x3_bwd (:318).
// Kernel size KS 1 or 3, stride 1, SAME.
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
// reduced from the accumulator in registers. That is the TPU kernel's
// idea; its tiling is not.
//
// Forward (conv_fwd): an implicit GEMM on igemm.cuh's mma.sync core, one
// CTA of 8 warps per 128 x BN output tile, BK = 32, the prologue
// (AffineRelu) applied as a tile is stored to shared memory, the
// statistics summed with one f32 atomicAdd per block and channel.
//
// Backward (fused_conv_bwd): conv_bwd.cuh's TMA/wgmma kernels with FusedTr
// as the staging transform (x -> relu(x*a + b), dy and y -> dy_eff, both
// zero where the pixel read lies outside the image), one launch for each
// product (and a small one for each fixed-order sum):
//   dW  tdw: the X and dY boxes rewritten in shared memory after they
//       arrive, the pixels split over clusters reduced in rank order (then
//       sum_tables): no atomics, bit-equal launch to launch (the TPU
//       kernel sums in grid order, pallas_fused.py:199-206, 224-234);
//   dX  tdx: dy_eff staged per K step from the shifted dy and y boxes;
//       the epilogue masks with x (by TMA into its slot), stores dx by
//       TMA and sums dab per CTA in a fixed order (then reduce_parts).
// The one-pass form of the TPU kernel (dW, dX and dab in one sweep) would
// need the whole dW table on chip; two products keep every shape of the
// step on one design (PERF.md).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "conv_bwd.cuh"
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


namespace {

// The backward's staging transform (conv_bwd.cuh): x -> relu(x*a + b),
// dy and y -> dy_eff = dy + ds0 + 2*y*ds1, and the epilogue's (a, b).
struct FusedTr {
  using Aux = bf16;  // y
  static constexpr int kAux = 2;
  static constexpr bool kPerCta = true;
  struct XT {
    float a[8], b[8];
  };
  struct DT {
    float p[8], q[8];
  };
  const float* abt;  // (2, ci)
  const float* ds;   // (2, co)
  int ci, co;

  __device__ __forceinline__ bool x_on() const { return true; }
  __device__ __forceinline__ int key(int) const { return 0; }
  __device__ __forceinline__ void x_tab(XT& t, int, int c) const {
    load8f(abt + c, t.a);
    load8f(abt + ci + c, t.b);
  }
  __device__ __forceinline__ void x(float v[8], const XT& t) const {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = fmaxf(affine(v[i], t.a[i], t.b[i]), 0.f);
  }
  __device__ __forceinline__ void d_tab(DT& t, int, int c) const {
    load8f(ds + c, t.p);
    load8f(ds + co + c, t.q);
  }
  __device__ __forceinline__ void dy(float d[8], const float y[8],
                                     const DT& t, int, int) const {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      d[i] = __fadd_rn(__fadd_rn(d[i], t.p[i]), __fmul_rn(2.f * y[i], t.q[i]));
  }
  __device__ __forceinline__ const float* ab_row(int) const { return abt; }
};

}  // namespace

// x (n,h,w,ci) bf16 and ab (2,ci) f32: the conv's input before its
// prologue; wflip (ci, ks*ks*co) bf16, the flipped kernel with K in (ky,
// kx, co) order; y, dy (n,h,w,co) bf16; ds (2,co) f32. Out: dx (n,h,w,ci)
// bf16, dab (2,ci) f32, dw (ks*ks*ci, co) f32, all written whole. A 1x1
// may pass its rows as n = h = 1, w = M. The plans (ops/conv.py): dW
// tma_dw_plan with y's aux boxes (wb, hb, bn, two, stages, splits, cs;
// with splits / cs > 1, ws_dw holds that many (ks*ks*ci, co) tables), dX
// tma_bwd_dx_plan (xwb, xhb, xbn, resident, xstages, grid, eslots;
// ws_dab holds grid / (ci / xbn) entries of (2, ci)). ci, co multiples of 64, 16-byte
// aligned bases. Returns the first launch error.
extern "C" int fused_conv_bwd(const void* x, const void* ab,
                              const void* wflip, const void* y,
                              const void* dy, const void* ds, void* dx,
                              void* dab, void* dw, void* ws_dw, void* ws_dab,
                              int n, int h, int w, int ci, int co, int ks,
                              int wb, int hb, int bn, int two, int stages,
                              int splits, int cs, int xwb, int xhb, int xbn,
                              int resident, int xstages, int grid, int eslots,
                              void* stream) {
  if (ci % 64 || co % 64 || (ks != 1 && ks != 3) || !ab || !ds)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const FusedTr tr{static_cast<const float*>(ab),
                   static_cast<const float*>(ds), ci, co};
  int err = bwd::run_dw(x, dy, y, static_cast<float*>(dw),
                        static_cast<float*>(ws_dw), n, h, w, ci, co, ks,
                        bwd::DwPlan{wb, hb, bn, two, stages, splits, cs}, tr,
                        s);
  if (err != cudaSuccess) return err;
  bwd::DxArgs a{};
  a.out = dx;
  a.out_kind = 3;
  return bwd::run_dx(dy, y, wflip, x, a, static_cast<float*>(ws_dab),
                     static_cast<float*>(dab), n, h, w, ci, co, ks, 1,
                     bwd::DxPlan{xwb, xhb, xbn, resident, xstages, grid,
                                 eslots},
                     tr, s);
}
