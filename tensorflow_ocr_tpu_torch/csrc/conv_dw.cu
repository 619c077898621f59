// The dW products of the pallas_conv route on Hopper (sm_90a): TMA loads,
// wgmma from shared memory and a split reduction in a fixed order.
//
// Replaces the TPU kernels of tensorflow_ocr_tpu/ops/pallas_conv.py:
//   KS = 1 <- _dw_rows (:108): the 1x1 dW, X^T . dY over all pixel rows;
//   KS = 3 <- _dw3 (:190):     the 3x3 dW, nine tap contractions.
// Contract: x (n, h, w, ci) and dy (n, h, w, co) bf16 NHWC; dw (KS*KS*ci,
// co) f32 = im2col(x)^T . dy, rows in (ky, kx, ci) order, the taps outside
// the image zero (SAME padding), f32 accumulation. ci and co multiples of
// 8 and 16-byte aligned bases, which is what TMA takes. The PixelLink
// head's projections to 2 channels (4 of a train step's 44 1x1 dW
// products) stay on conv.cu's igemm_dw, chosen by shape in ops/conv.py:
// a dispatch between two hand-written kernels.
//
// What bounds it on the H100: a 3x3 dW does 18*M*ci*co flops on
// 2*M*(ci + co) bytes, 9*ci*co/(ci + co) flops a byte (288 at 64 channels,
// 2,304 at 512): operations, at 989 TFLOP/s bf16. A 1x1 dW does a ninth
// of that: block1's shapes (64-256 channels over 524,288 pixels, 32-51
// flops a byte) and the head's are bound by bytes at 3.35 TB/s, the widest
// (1024 -> 2048 channels over 8,192 pixels, 683 a byte) by operations.
//
// Design. A CTA of three warpgroups computes an output tile of one or two
// 64-row chunks (a chunk is 64 channels of one tap) by BN columns (64, 128
// or 256 of co), over a contiguous range of pixel tiles:
// - One producer thread issues TMA loads into a ring of `stages` slots,
//   each guarded by a full and an empty mbarrier. A pixel tile is a box of
//   wb x hb pixels of one image (KP = wb*hb = 64). The X operand of chunk
//   (tap, c0) is the box of channels c0..c0+63 at the tile's origin shifted
//   by the tap (ky-1, kx-1): TMA's zero fill outside the tensor is the SAME
//   pad and the ragged H, W and channel edges. dY is the unshifted box, as
//   BN/64 boxes of 64 channels. Both arrive as they lie in memory, channel
//   contiguous, 128-byte swizzled: nothing is transposed on the way.
// - Two consumer warpgroups run wgmma m64nNk16 with both operands MN-major
//   in shared memory and f32 accumulators in registers (setmaxnreg moves
//   registers from the producer's warpgroup to them). Where the table has
//   two chunks or more, each warpgroup owns one; where it has one (a 1x1
//   dW with ci <= 64), both own it and take half of each tile's k16 steps.
// - The pixel tiles are split across CTAs so that one wave fills the card;
//   the CTAs of `cs` neighbouring splits form a thread block cluster (cs
//   <= 2: at this kernel's shared memory the H100 holds 66 clusters of 2
//   at once, all 132 SMs, but 30 of 4; scripts/conv_dw_probe.py). Each
//   CTA parks its accumulators in its shared memory; rank r of the
//   cluster sums its 1/cs share of the tile's rows over the ranks in rank
//   order (warpgroup order within a rank) through distributed shared
//   memory and writes them. With more than one cluster each writes its own
//   table and sum_tables adds them in cluster order. No atomics: two
//   launches on the same inputs are bit-equal.
// - The nine taps of a 3x3 reload the same dY box, from L2: a warpgroup
//   keeps one chunk's accumulators, not nine.
// conv_dw_tma_f32 (at the end) is the float32 dW of the same two TPU
// kernels: conv_bwd.cuh's tdw_f32_wg, split TF32 on TF32 wgmma (the
// operations bound it at 495/3 TFLOP/s, every shape of the route but
// block1's 1x1s, whose bytes bound them at 3.35 TB/s): A = X^T from
// registers, dY transposed once a stage into K-major hi and lo tiles that
// both warpgroups read, runs of R k8 steps in a fresh accumulator
// (run_dw_f32; the fused and ghost backwards' tdw_f32_tr is the same body
// with their staging transforms, compiled out here). The plan (box, BN, chunks a CTA, stages, splits, cluster) comes from
// ops/conv.py tma_dw_plan. The kernel is conv_bwd.cuh's tdw, which the
// fused and ghost backwards run with their staging transforms; here it
// takes IdentTr, which has no aux tensor, so the rewrite of each slot is
// compiled out and the operands go from TMA to wgmma as they arrive.

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "conv_bwd.cuh"

namespace {

// The identity staging transform: no aux tensor (kAux = 0), so tdw
// compiles no rewrite and none of the members below is called.
struct IdentTr {
  using Aux = __nv_bfloat16;
  static constexpr int kAux = 0;
  static constexpr bool kPerCta = false;
  struct XT {};
  struct DT {};
  __device__ bool x_on() const { return false; }
  __device__ int key(int) const { return 0; }
  __device__ void x_tab(XT&, int, int) const {}
  __device__ void x(float*, const XT&) const {}
  __device__ void d_tab(DT&, int, int) const {}
  __device__ void dy(float*, const float*, const DT&, int, int) const {}
};

}  // namespace

// x (n, h, w, ci) bf16; dy (n, h, w, co) bf16; dw (ks*ks*ci, co) f32 out,
// rows in (ky, kx, ci) order. The plan (ops/conv.py tma_dw_plan): a pixel
// box of wb x hb (wb*hb = 64), bn (64, 128 or 256) columns a CTA, two = 1
// where the table has more than one 64-row chunk, `stages` ring slots, the
// pixel tiles split `splits` ways (each split non-empty) in clusters of cs
// (1, 2 or 4; splits a multiple; ops/conv.py takes at most 2). With
// splits / cs > 1, ws holds that many (ks*ks*ci, co) f32 tables, else it
// is unused. Returns the first launch error, or cudaErrorInvalidValue for
// a shape or plan the kernel does not take (ci or co not a multiple of 8,
// a base not 16-byte aligned).
extern "C" int conv_dw_tma(const void* x, const void* dy, void* dw, void* ws,
                           int n, int h, int w, int ci, int co, int ks, int wb,
                           int hb, int bn, int two, int stages, int splits,
                           int cs, void* stream) {
  return bwd::run_dw(x, dy, nullptr, static_cast<float*>(dw),
                     static_cast<float*>(ws), n, h, w, ci, co, ks,
                     bwd::DwPlan{wb, hb, bn, two, stages, splits, cs},
                     IdentTr{}, static_cast<cudaStream_t>(stream));
}

// The float32 dW: x (n, h, w, ci) f32; dy (n, h, w, co) f32; dw (ks*ks*ci,
// co) f32 out, rows in (ky, kx, ci) order; ci and co multiples of 8. The
// plan as conv_dw_tma's with bn 64 or 128 (ops/conv.py tma_dw_plan with
// 4-byte elements: a stage also holds the split dY's lo tile, stages
// counted by conv_bwd.cuh dw32_stage_bytes); `run` (1, 2 or 4; ops/conv.py
// DW32_RUN) k8 steps a fresh accumulator. The products are conv_bwd.cuh's
// tdw_f32_wg (split TF32 on TF32 wgmma), the clusters' tables added in
// double by sum_tables_wide.
extern "C" int conv_dw_tma_f32(const void* x, const void* dy, void* dw,
                               void* ws, int n, int h, int w, int ci, int co,
                               int ks, int wb, int hb, int bn, int two,
                               int stages, int splits, int cs, int run,
                               void* stream) {
  return bwd::run_dw_f32(x, dy, nullptr, static_cast<float*>(dw),
                         static_cast<float*>(ws), n, h, w, ci, co, ks,
                         bwd::DwPlan{wb, hb, bn, two, stages, splits, cs},
                         bwd::IdentTr32{}, run,
                         static_cast<cudaStream_t>(stream));
}
