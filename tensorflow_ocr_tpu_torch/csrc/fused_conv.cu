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
// Forward (fused_conv_fwd): conv_bwd.cuh's tdx in its forward mode, one
// launch and a small one for the sums. Persistent CTAs walk 128-pixel x
// BN tiles (BN 128 where it divides co, else 64), each a contiguous range
// of pixel tiles in one column; each K step's slot holds x's box at the
// tile shifted by the tap, by TMA. Each warp loads its 16 rows of it by
// ldmatrix into wgmma's register A fragment and applies ActTr there
// (relu(x*a + b), zero where the pixel read lies outside the image: TMA's
// zero fill would give relu(b) there), then wgmma with the weight K-major
// in shared memory; a 3x3 over 64- or 128-pixel rows instead rewrites one
// halo box a ky in shared memory for its three taps; a 1x1's weight stays
// resident where it fits. The epilogue stages y = bf16(acc) in an epilogue
// slot that a producer thread stores by TMA, and sums [acc, acc^2] of the
// f32 accumulator per column in registers over the CTA's tiles; the CTAs'
// entries are added in order (reduce_parts). No atomics: two launches are
// bit-equal (the TPU kernel sums in grid order, pallas_fused.py:104-110).
// Its tiling is ops/conv.py tma_staged_fwd_plan.
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

// x (n,h,w,ci) bf16; ab (2,ci) f32; wt (co, ks*ks*ci) bf16 with K in (ky,
// kx, ci) order; y (n,h,w,co) bf16 and stats (2,co) f32 out, written
// whole. A 1x1 may pass its rows as n = h = 1, w = M. The plan (ops/conv.py
// tma_staged_fwd_plan: wb, hb, bn, resident, stages, grid, eslots); ws
// holds grid / (co / bn) entries of (2, co). ci, co multiples of 64,
// 16-byte aligned bases. Returns the first launch error.
extern "C" int fused_conv_fwd(const void* x, const void* ab, const void* wt,
                              void* y, void* stats, void* ws, int n, int h,
                              int w, int ci, int co, int ks, int wb, int hb,
                              int bn, int resident, int stages, int grid,
                              int eslots, void* stream) {
  if (ci % 64 || co % 64 || (ks != 1 && ks != 3) || !ab)
    return cudaErrorInvalidValue;
  bwd::DxArgs a{};
  a.out = y;
  a.out_kind = 4;
  // tdx's columns are the conv's output channels, its K the input's
  return bwd::run_dx(x, nullptr, wt, nullptr, a, static_cast<float*>(ws),
                     static_cast<float*>(stats), n, h, w, co, ci, ks, 1,
                     bwd::DxPlan{wb, hb, bn, resident, stages, grid, eslots},
                     bwd::ActTr<true>{static_cast<const float*>(ab), ci, 0},
                     static_cast<cudaStream_t>(stream));
}

namespace {

using igemm::affine;
using igemm::load8f;
using bf16 = __nv_bfloat16;

// The backward's staging transform (conv_bwd.cuh): x -> relu(x*a + b),
// dy and y -> dy_eff = dy + ds0 + 2*y*ds1, and the epilogue's (a, b).
struct FusedTr {
  using Aux = bf16;  // y
  static constexpr int kAux = 2;
  static constexpr bool kPerCta = true;
  static constexpr bool kBandRuns = false;
  static constexpr bool kFwd = false;
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
