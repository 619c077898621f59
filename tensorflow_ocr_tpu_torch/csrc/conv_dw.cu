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
// both warpgroups read, runs of R k8 steps in a fresh accumulator.
// The plan (box, BN, chunks a CTA, stages, splits, cluster) comes from
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

namespace {

template <int BN, bool TWO, int R>
int launch_dw_f32_wg(const CUtensorMap& mx, const CUtensorMap& mdy,
                     const bwd::DwArgs& a, dim3 grid, int smem,
                     cudaStream_t s) {
  static bool set[64] = {};
  cudaError_t e =
      hop::allow_smem(bwd::tdw_f32_wg<BN, TWO, R>, set, bwd::MAX_SMEM);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(bwd::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = a.cs;
  cfg.attrs = attr;
  cfg.numAttrs = a.cs > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, bwd::tdw_f32_wg<BN, TWO, R>, mx, mdy, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace

// The float32 dW: x (n, h, w, ci) f32; dy (n, h, w, co) f32; dw (ks*ks*ci,
// co) f32 out, rows in (ky, kx, ci) order; ci and co multiples of 8. The
// plan as conv_dw_tma's with bn 64 or 128 (ops/conv.py tma_dw_plan with
// 4-byte elements: a stage also holds the split dY's lo tile, stages
// counted by conv_bwd.cuh dw32wg_stage_bytes); `run` (1, 2 or 4; ops/conv.py
// DW32_RUN) k8 steps a fresh accumulator. The products are conv_bwd.cuh's
// tdw_f32_wg (split TF32 on TF32 wgmma), the clusters' tables added in
// double by sum_tables_wide.
extern "C" int conv_dw_tma_f32(const void* x, const void* dy, void* dw,
                               void* ws, int n, int h, int w, int ci, int co,
                               int ks, int wb, int hb, int bn, int two,
                               int stages, int splits, int cs, int run,
                               void* stream) {
  using namespace bwd;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(dw);
  const size_t size = (size_t)ks * ks * ci * co;
  if (ci < 8 || co < 8 || ci % 8 || co % 8 || (ks != 1 && ks != 3) ||
      (run != 1 && run != 2 && run != 4) || !aligned16(x) || !aligned16(dy) ||
      !aligned16(dw))
    return cudaErrorInvalidValue;
  if ((long long)n * h * w == 0)
    return cudaMemsetAsync(dw, 0, sizeof(float) * size, s);
  DwArgs a{};
  a.out = splits / cs > 1 ? static_cast<float*>(ws) : out;
  a.h = h, a.w = w, a.ci = ci, a.co = co, a.ks = ks, a.wb = wb, a.hb = hb;
  a.tiles_w = (w + wb - 1) / wb;
  a.tiles_h = (h + hb - 1) / hb;
  const long long ntiles = (long long)n * a.tiles_w * a.tiles_h;
  a.ntiles = (int)ntiles;
  a.cchunks = (ci + 63) / 64;
  a.rchunks = ks * ks * a.cchunks;
  a.stages = stages, a.splits = splits, a.cs = cs;
  const int stage = dw32wg_stage_bytes(bn, two);
  const int smem = stages * stage + 16 * stages + 1024;
  if (wb < 1 || hb < 1 || wb * hb != KP || wb > 256 || hb > 256 ||
      (bn != 64 && bn != 128) || two != (a.rchunks > 1) || stages < 2 ||
      (cs != 1 && cs != 2 && cs != 4) || splits < 1 || splits % cs ||
      splits > ntiles || ntiles >= (1ll << 31) || smem > MAX_SMEM ||
      2 * 64 * (bn + 8) * 4 > stages * stage || (splits / cs > 1 && !ws))
    return cudaErrorInvalidValue;
  CUtensorMap mx, mdy;
  if (!encode_act32(&mx, x, ci, w, h, n, wb, hb) ||
      !encode_act32(&mdy, dy, co, w, h, n, wb, hb))
    return cudaErrorInvalidValue;
  const dim3 grid(two ? (a.rchunks + 1) / 2 : 1, (co + bn - 1) / bn, splits);
  auto go = [&](auto tw, auto rn) {
    constexpr bool T = decltype(tw)::value;
    constexpr int R = decltype(rn)::value;
    return bn == 128 ? launch_dw_f32_wg<128, T, R>(mx, mdy, a, grid, smem, s)
                     : launch_dw_f32_wg<64, T, R>(mx, mdy, a, grid, smem, s);
  };
  auto by_run = [&](auto tw) {
    return run == 4   ? go(tw, std::integral_constant<int, 4>{})
           : run == 2 ? go(tw, std::integral_constant<int, 2>{})
                      : go(tw, std::integral_constant<int, 1>{});
  };
  const int err = two ? by_run(std::true_type{}) : by_run(std::false_type{});
  if (err != cudaSuccess || splits / cs == 1) return err;
  const int blocks =
      (int)((size + 255) / 256 < 4096 ? (size + 255) / 256 : 4096);
  sum_tables_wide<<<blocks, 256, 0, s>>>(static_cast<float*>(ws), out, size,
                                         splits / cs);
  return cudaGetLastError();
}
