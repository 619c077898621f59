// The unit-fused ghost-BN bottleneck unit, forward and exact backward, for
// Hopper (sm_90a).
//
// Replaces the TPU kernels of tensorflow_ocr_tpu/ops/pallas_unit.py:
//   _unit_fwd (:270, pallas_call :303), _unit_bwd sweep 1 (:627, :677)
//   and sweep 2 (:627, :700),
// which run a whole bottleneck unit per (image, band of gh rows) in VMEM.
// Four entry points compute the same function between them, over full
// NHWC tensors with per-(image, band) tables (ops/ghost.py chains them):
//   ghost_conv_fwd  y = conv_k(act(x)) with act = relu(x*a + b) under the
//                   (a, b) of the OUTPUT pixel's band (the 3x3's halo rows
//                   under the reading band's affine, zero outside the
//                   image); per-band [sum y, sum y^2] of the ROUNDED y;
//   ghost_boundary  forward: out = relu(z3*a3 + b3 + sc) (sc = zs*as + bs
//                   or o); backward: gm3 = dout*[pre > 0] (exact in bf16)
//                   and its band sums [sum gm*z3, sum gm, sum gm*zs];
//   ghost_conv_bwd  one conv's backward from dz = bf16(g*a + c1 + 2z*c2
//                   (+ the seam term on a band's edge rows)), staged into
//                   dW = act(x)^T . dz and dX = dz * Wflip (the 3x3 dX
//                   reads only the dz rows of its output row's band),
//                   which ends as gm = dX*[x*a + b > 0] (f32) with its
//                   band sums, or as do = dX + addend;
//   ghost_seam_bwd  the two halo rows of each band's 3x3 backward: gm =
//                   (dz of the band's edge row . Wflip's ky row) *[z1*a1 +
//                   b1 > 0] under the READING band's (a1, b1), added to
//                   that band's sums, and gm*a1 stored as the seam term of
//                   the row's own band.
// Tables (float32) are (bands, rows, ch) with band = pixel / (gh*W).
//
// What bounds it on the H100: the unit's convs at 512^2, batch 32 (M =
// 524,288 or 131,072 pixel rows, 64-512 channels) do 16-64 flops a byte
// in a 1x1 and ~9x that in the 3x3, against the card's ~295 flops a byte
// at bf16: memory-bound but for the 3x3. The TPU kernel keeps the whole
// band in VMEM and so moves each activation once; a band's halo tile
// (10 x 128 x 256 bf16 = 655 KB at block1) does not fit in one SM's
// 227 KB, so here z1, z2, z3 and zs go through device memory once each,
// and the design keeps the rest out of it: act1 and act2 are never
// stored (the banded affine+relu is applied as a tile is staged), nor
// is dz (staged from g, z and the band tables), and every statistic is
// summed from the accumulator in registers.
//
// Design. The forward convs (ghost_conv_fwd): conv_bwd.cuh's tdx in its
// forward mode with ActTr keyed by band: persistent CTAs walk 128-pixel x
// BN tiles whose box height divides gh, so a tile lies in one band, each
// CTA a contiguous range of them in one column; each K step's box of x (at
// the tile shifted by the tap, by TMA) goes through relu(x*a + b) under
// the table of the tile's band, in wgmma's register A fragment (a 3x3 in
// halo mode: one halo box a ky rewritten in shared memory), which for a
// 3x3's halo rows is the reading band's table, not the rows' own, and
// zero only outside the image (no transform where tab is null: TMA's zero
// fill is the pad). The epilogue stages y = bf16(acc) for a TMA store and
// sums the ROUNDED y per column in registers over each run of the CTA's
// tiles in one band, written at the run's last tile (zero entries at the
// others); reduce_parts adds a band's entries in tile order. No atomics:
// two launches are bit-equal (the TPU kernel sums each band in one grid
// step, pallas_unit.py:60-64). Its tiling is ops/conv.py
// tma_staged_fwd_plan.
// The seam pass (ghost_seam_bwd, tseam below): a 1x3 product a side, K =
// 3 taps x c, on TMA and wgmma. Persistent CTAs of two consumer warpgroups
// and one producer walk tiles of one side (the slot written) and column
// tile; a warpgroup takes a 64-pixel segment of one seam row by 64
// columns: c = 64, two segments a tile; else both warpgroups share one
// segment, 64 of the tile's 128 columns each. A K step is one channel box:
// each segment's 66-pixel halo box of z and g at the neighbouring band's
// edge row, rewritten in shared memory into dz under that band's table
// (GhostTr's arithmetic; zero at the w pad and outside the image; by the
// warpgroup whose segment it is, or by both where they share it), read by
// the three kx taps through descriptors shifted by kx rows, against the
// flipped kernel's ky row (read from the kernel unflipped: its row 2 - ky
// at column 2 - kx; resident in shared memory where it fits). The
// epilogue takes x_q by TMA, masks under the reading band's (a1, b1),
// stages gm*a1 as f32 boxes stored by TMA into the slot of the row's own
// band, and writes [sum gm*x_q, sum gm] of its segment as one entry of the
// reading band (side 0 before side 1), added in order by reduce_parts. No
// atomics: two launches are bit-equal. Its plan: ops/ghost.py seam_plan.
// The conv backward (ghost_conv_bwd): two launches on conv_bwd.cuh's
// TMA/wgmma cores with GhostTr as the staging transform (x -> relu(x*a +
// b) under the band of the output pixel, z and g -> dz under the band of
// the pixel read, plus the seam term): dW (tdw) split over clusters
// reduced in rank order, dX (tdx) with a masked epilogue whose band sums
// take one entry a 128-pixel tile (a tile lies in one band: its box height
// divides gh) added in tile order by reduce_parts. No atomics: two
// launches are bit-equal. One pass per band (a cluster with distributed
// shared memory) is later work.
//
// Float32 (ghost_conv_fwd_f32, ghost_conv_bwd_f32, ghost_boundary_f32,
// ghost_seam_bwd_f32): the TPU kernels work in o.dtype, so a float32 model
// runs them in float32 (pallas_unit.py:117-121, 289, 383-384). The same
// contract with f32 activations, weights and outputs (no rounding but the
// f32 products'), each product float32 by split TF32 (hi.lo' + lo.hi' +
// hi.hi' on the tensor cores, the weight split by split_tf32):
//   the convs on conv_bwd.cuh's tdx_f32 (the forward with BandActTr32: the
//   table of the tile's band on each value of x; the dX with GhostTr32: dz
//   and the seam term formed from z's and g's f32 boxes in registers) and
//   tdw_f32_tr with GhostTr32 (TF32 wgmma: x under the tile's band, which
//   is the output pixel's, on each value of the register A fragment; z and
//   g to dz under the same band (the pixel read), with the seam term, as
//   the consumers transpose them into K-major hi and lo tiles), the band
//   sums added in double;
//   gboundary32, gboundary at 4 channels a 16-byte vector;
//   tseam32, tseam with a K step of 32 channels: dz formed once a K step
//   (the z and g halo boxes rewritten into its TF32 hi and lo in place),
//   the three taps' products back to back, x_q and gm*a1 through
//   registers, 64-column tiles (below, "seam, f32").
// What bounds them: three TF32 passes (495 / 3 TFLOP/s) on twice bf16's
// bytes; block1's 1x1s and the seam stay bound by the bytes.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <initializer_list>

#include "conv_bwd.cuh"
#include "igemm.cuh"

namespace {

using namespace igemm;

// out = bf16(relu(z*a + b + (sc*as + bs, or sc))); with dout: gm =
// dout*[pre > 0] into out, and sums (bands, 3, c) [sum gm*z, sum gm,
// sum gm*sc]. Grid (bands, c / (8*cvb)): a block owns a band's rows for
// 8*cvb channels, so its sums are written, not added; each thread sums its
// rows, and the block adds the threads' partials in row-group order (no
// atomics: two launches are bit-equal).
__global__ void __launch_bounds__(256)
gboundary(const bf16* __restrict__ dout, const bf16* __restrict__ z,
          const float* __restrict__ t, const bf16* __restrict__ sc,
          const float* __restrict__ ts, bf16* __restrict__ out,
          float* __restrict__ sums, int band_px, int c, int cvb) {
  // thread i's partials of its 8 channels at [k][8 i .. 8 i + 7]: row group
  // r, channel cc of the block at [k][r * 8 cvb + cc]
  __shared__ __align__(16) float red[3][256 * 8];
  const int band = blockIdx.x, rows = blockDim.x / cvb;
  const int rsub = threadIdx.x / cvb;
  const int cb = blockIdx.y * cvb * 8, ch0 = cb + (threadIdx.x % cvb) * 8;
  float a[8], b[8], as[8], bs[8];
  load8f(t + (size_t)band * 2 * c + ch0, a);
  load8f(t + (size_t)band * 2 * c + c + ch0, b);
  if (ts) {
    load8f(ts + (size_t)band * 2 * c + ch0, as);
    load8f(ts + (size_t)band * 2 * c + c + ch0, bs);
  }
  float sz[8] = {}, sg[8] = {}, ss[8] = {};
  for (int r = rsub; r < band_px; r += rows) {
    const size_t off = ((size_t)band * band_px + r) * c + ch0;
    float zf[8], sf[8], o[8];
    unpack8(__ldg(reinterpret_cast<const uint4*>(z + off)), zf);
    unpack8(__ldg(reinterpret_cast<const uint4*>(sc + off)), sf);
    float pre[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      pre[i] = __fadd_rn(affine(zf[i], a[i], b[i]),
                         ts ? affine(sf[i], as[i], bs[i]) : sf[i]);
    if (!dout) {
#pragma unroll
      for (int i = 0; i < 8; ++i) o[i] = fmaxf(pre[i], 0.f);
    } else {
      float d[8];
      unpack8(__ldg(reinterpret_cast<const uint4*>(dout + off)), d);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        o[i] = pre[i] > 0.f ? d[i] : 0.f;
        sz[i] += o[i] * zf[i];
        sg[i] += o[i];
        ss[i] += o[i] * sf[i];
      }
    }
    *reinterpret_cast<uint4*>(out + off) = pack8(o);
  }
  if (!dout) return;
  auto put = [&](int k, const float v[8]) {
    float4* p = reinterpret_cast<float4*>(&red[k][8 * threadIdx.x]);
    p[0] = make_float4(v[0], v[1], v[2], v[3]);
    p[1] = make_float4(v[4], v[5], v[6], v[7]);
  };
  put(0, sz);
  put(1, sg);
  put(2, ss);
  __syncthreads();
  for (int i = threadIdx.x; i < 3 * cvb * 8; i += blockDim.x) {
    const int k = i / (cvb * 8), cc = i % (cvb * 8);
    float s = 0.f;
    for (int r = 0; r < rows; ++r) s += red[k][r * cvb * 8 + cc];
    sums[((size_t)band * 3 + k) * c + cb + cc] = s;
  }
}

bool bad_geometry(int n, int h, int w, int gh, int c1, int c2) {
  return n < 1 || h < 1 || w < 1 || gh < 2 || h % gh || c1 % 64 || c2 % 64;
}

// The backward's staging transform (conv_bwd.cuh): x -> relu(x*a + b)
// under the table of the band of the output pixel (x as it is where tx is
// null), z and g -> dz = g*a + c1 + 2z*c2 (+ the seam term on the band's
// first and last rows) under the table of the band of the pixel read.
template <class G>
struct GhostTr {
  using Aux = G;       // g
  static constexpr int kAux = (int)sizeof(G);
  static constexpr bool kPerCta = false;
  static constexpr bool kBandRuns = false;
  static constexpr bool kFwd = false;
  struct XT {
    float a[8], b[8];
  };
  struct DT {
    float a[8], c1[8], c2[8];
  };
  const float* tx;     // (bands, 2, ci) or null
  const float* td;     // (bands, 3, co)
  const float* edge;   // (bands, 2, w, co) or null
  int ci, co, band_px, w;

  __device__ __forceinline__ bool x_on() const { return tx != nullptr; }
  __device__ __forceinline__ int key(int pix) const { return pix / band_px; }
  __device__ __forceinline__ void x_tab(XT& t, int band, int c) const {
    const float* p = tx + (size_t)band * 2 * ci + c;
    load8f(p, t.a);
    load8f(p + ci, t.b);
  }
  __device__ __forceinline__ void x(float v[8], const XT& t) const {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = fmaxf(affine(v[i], t.a[i], t.b[i]), 0.f);
  }
  __device__ __forceinline__ void d_tab(DT& t, int band, int c) const {
    const float* p = td + (size_t)band * 3 * co + c;
    load8f(p, t.a);
    load8f(p + co, t.c1);
    load8f(p + 2 * co, t.c2);
  }
  // d: z in, dz out; g: the aux
  __device__ __forceinline__ void dy(float d[8], const float g[8],
                                     const DT& t, int pix, int c) const {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      d[i] = __fadd_rn(__fadd_rn(__fmul_rn(g[i], t.a[i]), t.c1[i]),
                       __fmul_rn(2.f * d[i], t.c2[i]));
    if (edge) {
      const int band = pix / band_px, off = pix - band * band_px;
      const int row = off / w;
      if (row == 0 || row == band_px / w - 1) {
        float e[8];
        load8f(edge + (((size_t)band * 2 + (row != 0)) * w + off % w) * co + c,
               e);
#pragma unroll
        for (int i = 0; i < 8; ++i) d[i] = __fadd_rn(d[i], e[i]);
      }
    }
  }
  __device__ __forceinline__ const float* ab_row(int band) const {
    return tx + (size_t)band * 2 * ci;
  }
};

template <class G>
int conv_bwd(const void* x, const float* tx, const void* g, const void* z,
             const float* td, const float* edge, const void* wflip, void* dx,
             float* sums, float* dw, const void* addend, float* ws_dw,
             float* ws_sums, int add_kind, int out_kind, int n, int h, int w,
             int ci, int co, int ks, int gh, const bwd::DwPlan& pw,
             const bwd::DxPlan& px, cudaStream_t s) {
  const GhostTr<G> tr{tx, td, edge, ci, co, gh * w, w};
  int err = bwd::run_dw(x, z, g, dw, ws_dw, n, h, w, ci, co, ks, pw, tr, s);
  if (err != cudaSuccess) return err;
  bwd::DxArgs a{};
  a.out = dx;
  a.addend = addend;
  a.add_kind = add_kind;
  a.out_kind = out_kind;
  a.band_px = ks == 3 ? gh * w : 0;
  // the epilogue's bf16 input: x for gm, the bf16 addend for do
  return bwd::run_dx(z, g, wflip, out_kind == 0 ? x : addend, a, ws_sums,
                     sums, n, h, w, ci, co, ks, gh, px, tr, s);
}


// gboundary in float32: 4 channels a 16-byte vector, a block 16 of them
// (64 channels) by 16 row groups; grid (bands, c / 64). The same sums, each
// thread's rows added in order and the block's row groups' partials in
// row-group order (no atomics: two launches are bit-equal).
__global__ void __launch_bounds__(256)
gboundary32(const float* __restrict__ dout, const float* __restrict__ z,
            const float* __restrict__ t, const float* __restrict__ sc,
            const float* __restrict__ ts, float* __restrict__ out,
            float* __restrict__ sums, int band_px, int c) {
  constexpr int CV = 16;  // 4-channel vectors a block row
  __shared__ __align__(16) float red[3][256 * 4];
  const int band = blockIdx.x, rows = blockDim.x / CV;
  const int rsub = threadIdx.x / CV;
  const int cb = blockIdx.y * CV * 4, ch0 = cb + (threadIdx.x % CV) * 4;
  auto ld4 = [](const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  };
  const float* tb = t + (size_t)band * 2 * c;
  const float4 a4 = ld4(tb + ch0), b4 = ld4(tb + c + ch0);
  const float a[4] = {a4.x, a4.y, a4.z, a4.w}, b[4] = {b4.x, b4.y, b4.z, b4.w};
  float as[4] = {}, bs[4] = {};
  if (ts) {
    const float* q = ts + (size_t)band * 2 * c;
    const float4 u = ld4(q + ch0), v = ld4(q + c + ch0);
    as[0] = u.x; as[1] = u.y; as[2] = u.z; as[3] = u.w;
    bs[0] = v.x; bs[1] = v.y; bs[2] = v.z; bs[3] = v.w;
  }
  float sz[4] = {}, sg[4] = {}, ss[4] = {};
  for (int r = rsub; r < band_px; r += rows) {
    const size_t off = ((size_t)band * band_px + r) * c + ch0;
    const float4 z4 = ld4(z + off), s4 = ld4(sc + off);
    const float zf[4] = {z4.x, z4.y, z4.z, z4.w};
    const float sf[4] = {s4.x, s4.y, s4.z, s4.w};
    float o[4], d[4] = {};
    if (dout) {
      const float4 d4 = ld4(dout + off);
      d[0] = d4.x; d[1] = d4.y; d[2] = d4.z; d[3] = d4.w;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float pre = __fadd_rn(affine(zf[i], a[i], b[i]),
                                  ts ? affine(sf[i], as[i], bs[i]) : sf[i]);
      if (!dout) {
        o[i] = fmaxf(pre, 0.f);
      } else {
        o[i] = pre > 0.f ? d[i] : 0.f;
        sz[i] += o[i] * zf[i];
        sg[i] += o[i];
        ss[i] += o[i] * sf[i];
      }
    }
    *reinterpret_cast<float4*>(out + off) = make_float4(o[0], o[1], o[2], o[3]);
  }
  if (!dout) return;
  // thread i's partials of its 4 channels at [k][4 i .. 4 i + 3]: row group
  // r, channel cc of the block at [k][r * 4 CV + cc]
  *reinterpret_cast<float4*>(&red[0][4 * threadIdx.x]) =
      make_float4(sz[0], sz[1], sz[2], sz[3]);
  *reinterpret_cast<float4*>(&red[1][4 * threadIdx.x]) =
      make_float4(sg[0], sg[1], sg[2], sg[3]);
  *reinterpret_cast<float4*>(&red[2][4 * threadIdx.x]) =
      make_float4(ss[0], ss[1], ss[2], ss[3]);
  __syncthreads();
  for (int i = threadIdx.x; i < 3 * CV * 4; i += blockDim.x) {
    const int k = i / (CV * 4), cc = i % (CV * 4);
    float s = 0.f;
    for (int r = 0; r < rows; ++r) s += red[k][r * CV * 4 + cc];
    sums[((size_t)band * 3 + k) * c + cb + cc] = s;
  }
}

// GhostTr in float32 (conv_bwd.cuh's banded float32 transform):
// tdw_f32_tr's transform (T_x: x -> relu(x*a + b) under the table of the
// tile's band, the output pixel's, on a lane's A fragment, channels c and
// c + 8, x as it is where tx is null; T_dy: z and g -> dz = g*a + c1 +
// 2z*c2 under the same band's table, the pixel read's, as the dY tile is
// transposed, columns c .. c+3, plus the seam term on the band's first and
// last rows, edge_at) and tdx_f32's register transform of a thread's k8
// fragment (channels ch and ch + 4; its seam term by edge_row), in the
// plain version's order of rounding.
struct GhostTr32 {
  static constexpr int kAux = 4;  // g, f32
  static constexpr bool kFwd = false;
  static constexpr bool kBanded = true;
  struct K8 {
    float a[2], c1[2], c2[2];
  };
  struct X2 {
    float a[2], b[2];
  };
  struct D4 {
    float a[4], c1[4], c2[4];
  };
  const float* tx;    // (bands, 2, ci) or null
  const float* td;    // (bands, 3, co)
  const float* edge;  // (bands, 2, w, co) or null
  int ci, co, band_px, w;

  __device__ __forceinline__ int key(int pix) const { return pix / band_px; }
  __device__ __forceinline__ void x2_tab(X2& t, int key, int c) const {
    if (!tx) return;
    const float* p = tx + (size_t)key * 2 * ci + c;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      t.a[j] = __ldg(p + 8 * j);
      t.b[j] = __ldg(p + ci + 8 * j);
    }
  }
  __device__ __forceinline__ float x1(float v, const X2& t, int j) const {
    return tx ? fmaxf(affine(v, t.a[j], t.b[j]), 0.f) : v;
  }
  __device__ __forceinline__ static float dz(float z, float g, float a,
                                             float c1, float c2) {
    return __fadd_rn(__fadd_rn(__fmul_rn(g, a), c1), __fmul_rn(2.f * z, c2));
  }
  // the row of the seam term at pixel pix (its band's first row: slot 0,
  // last: slot 1), or null
  __device__ __forceinline__ const float* edge_row(int pix) const {
    if (!edge) return nullptr;
    const int band = pix / band_px, off = pix - band * band_px;
    const int row = off / w;
    if (row != 0 && row != band_px / w - 1) return nullptr;
    return edge + (((size_t)band * 2 + (row != 0)) * w + off % w) * co;
  }
  // edge_row of row brow (0 .. gh - 1) of band key at column ow
  __device__ __forceinline__ const float* edge_at(int key, int brow, int gh,
                                                  int ow) const {
    if (!edge || (brow != 0 && brow != gh - 1)) return nullptr;
    return edge + (((size_t)key * 2 + (brow != 0)) * w + ow) * co;
  }
  __device__ __forceinline__ void d4_tab(D4& t, int key, int c) const {
    const float* p = td + (size_t)key * 3 * co + c;
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 c1 = __ldg(reinterpret_cast<const float4*>(p + co));
    const float4 c2 = __ldg(reinterpret_cast<const float4*>(p + 2 * co));
    t.a[0] = a.x; t.a[1] = a.y; t.a[2] = a.z; t.a[3] = a.w;
    t.c1[0] = c1.x; t.c1[1] = c1.y; t.c1[2] = c1.z; t.c1[3] = c1.w;
    t.c2[0] = c2.x; t.c2[1] = c2.y; t.c2[2] = c2.z; t.c2[3] = c2.w;
  }
  // z and g of one value of column c + j -> dz (the seam term added by the
  // caller)
  __device__ __forceinline__ float d1(float z, float g, const D4& t,
                                      int j) const {
    return dz(z, g, t.a[j], t.c1[j], t.c2[j]);
  }
  __device__ __forceinline__ void k8_tab(K8& t, int key, int ch) const {
    const float* p = td + (size_t)key * 3 * co + ch;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      t.a[j] = __ldg(p + 4 * j);
      t.c1[j] = __ldg(p + co + 4 * j);
      t.c2[j] = __ldg(p + 2 * co + 4 * j);
    }
  }
  // z and g of one fragment value -> dz (the seam term added by the caller)
  __device__ __forceinline__ float k8(float z, float g, const K8& t,
                                      int j) const {
    return dz(z, g, t.a[j], t.c1[j], t.c2[j]);
  }
  __device__ __forceinline__ const float* ab_row(int key) const {
    return tx + (size_t)key * 2 * ci;
  }
};

// ------------------------------------------------------------------ seam
//
// Band b's edge row q (slot 0: its first row; slot 1: its last) is the
// halo row of the neighbouring band rb = b - 1 (slot 0) or b + 1 (slot 1),
// whose 3x3 backward sends into q: gm = (dz of rb's edge row q' = q - 1
// or q + 1 . the flipped kernel's ky row: 0 for slot 0, 2 for slot 1) *
// [x_q*a1 + b1 > 0] with rb's (a1, b1) and rb's table for dz;
// edge[b][slot] = gm*a1, and rb's sums [sum gm*x_q, sum gm]. Where rb lies
// outside the image (band 0's slot 0, band nb-1's slot 1), so does q':
// TMA's zero fill and the rewrite's zero give a zero product, and the slot
// and its entry are written 0. A side is a slot; a seam row is (image,
// band) of one side; a segment is 64 pixels of a seam row.
namespace seam {

using namespace hop;

constexpr int SEG = 64;                // pixels a segment: a warpgroup's rows
constexpr int HROWS = SEG + 2;         // rows of its halo box
constexpr int HBOX = 9216;             // the bf16 halo box, 1024-aligned
constexpr int GBOX = HROWS * 256;      // its f32 g box, 256-byte rows
constexpr int OUT = SEG * 64 * 4;      // a warpgroup's f32 output (x first)
constexpr int RED = 8 * 2 * 64 * 4;    // the warps' column sums

struct Args {
  float* part;       // entries (n*nb groups, 2*segs, 2, c)
  const float* td;   // (n*nb, 3, c) [a2, c12, c22]
  const float* tx;   // (n*nb, 2, c) [a1, b1]
  int n, h, w, c, gh, nb;
  int ct, cb, col_tiles;  // columns a tile, channel boxes, column tiles
  int segs, count, tiles; // segments a seam row; of a side; tiles a side
  int stages, resident;
};

// The ring slot: the segments' halo boxes (bf16), their g boxes (f32),
// and the three kx weight boxes where the weight is not resident. One
// epilogue slot beside the ring: x_q in, gm*a1 out.
__host__ __device__ constexpr int stage_bytes(int nseg, int ct,
                                              bool resident) {
  return bwd::round1k(nseg * (HBOX + GBOX)) + (resident ? 0 : 3 * ct * 128);
}
__host__ __device__ constexpr int smem_bytes(int nseg, int ct, int cb,
                                             bool resident, int stages) {
  return stages * stage_bytes(nseg, ct, resident) +
         (resident ? 3 * cb * ct * 128 : 0) + 2 * OUT + RED +
         8 * (2 * stages + 3) + 1024;
}

struct Seg {
  int img, b, x0, q, qa, rb;
  bool live;  // a segment of the side (a two-segment tile's second may
              // not be; its boxes then lie past the last image)
};

__device__ __forceinline__ Seg seg_of(const Args& a, int side, int s) {
  Seg g;
  g.live = s < a.count;
  const int row = s / a.segs;
  g.x0 = (s - row * a.segs) * SEG;
  g.img = row / a.nb;
  g.b = row - g.img * a.nb;
  g.q = g.b * a.gh + (side ? a.gh - 1 : 0);
  g.qa = g.q + (side ? 1 : -1);
  g.rb = g.b + (side ? 1 : -1);
  return g;
}

__device__ __forceinline__ bool reads(const Args& a, const Seg& g) {
  return g.live && g.rb >= 0 && g.rb < a.nb;
}

// Byte offset of f32 element (row, col) of a warpgroup's output: two boxes
// of 32 columns, 64 rows of 128 bytes under the 128-byte swizzle.
__device__ __forceinline__ uint32_t out_offset(int row, int col) {
  const int cc = col & 31;
  return (col >> 5) * (SEG * 128) + row * 128 +
         ((((cc >> 2) ^ row) & 7) << 4) + (cc & 3) * 4;
}

// NSEG 2: a tile is segments 2t and 2t + 1 of its side, one a warpgroup,
// 64 columns (c = 64); NSEG 1: segment t, the two warpgroups 64 of its
// 128 columns each. The grid is a multiple of the 2 * col_tiles groups
// (side, column tile); each CTA a contiguous range of its group's tiles.
template <int NSEG>
__global__ void __launch_bounds__(bwd::THREADS, 1)
tseam(const __grid_constant__ CUtensorMap mz,
      const __grid_constant__ CUtensorMap mg,
      const __grid_constant__ CUtensorMap mw,
      const __grid_constant__ CUtensorMap mx,
      const __grid_constant__ CUtensorMap me, const Args a,
      const GhostTr<float> tr) {
  extern __shared__ uint8_t raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  const int sb = stage_bytes(NSEG, a.ct, a.resident);
  const int w_at = bwd::round1k(NSEG * (HBOX + GBOX));  // streamed weight
  const int wbox = a.ct * 128;                           // one weight box
  uint8_t* wres = smem + a.stages * sb;
  uint8_t* eslot = wres + (a.resident ? 3 * a.cb * wbox : 0);
  float* red = reinterpret_cast<float*>(eslot + 2 * OUT);
  uint64_t* full = reinterpret_cast<uint64_t*>(red + RED / 4);
  uint64_t* empty = full + a.stages;
  uint64_t* wbar = empty + a.stages;
  uint64_t* efull = wbar + 1;
  uint64_t* edone = efull + 1;

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int tid = threadIdx.x % 128;
  const int groups = 2 * a.col_tiles;
  const int gid = (int)blockIdx.x % groups;
  const int side = gid / a.col_tiles, col = gid % a.col_tiles;
  const int ctas = (int)gridDim.x / groups, me_i = (int)blockIdx.x / groups;
  const int t_lo = (int)((long long)me_i * a.tiles / ctas);
  const int ntiles = (int)((long long)(me_i + 1) * a.tiles / ctas) - t_lo;
  // the kernel's row read: 0 for slot 1 (the flipped kernel's row 2), 2
  // for slot 0
  const int kyw = side ? 0 : 2;
  // warpgroup g's segment of tile t, and its first column
  auto seg_at = [&](int t, int g) {
    return seg_of(a, side, NSEG == 2 ? 2 * t + g : t);
  };
  const int cc0 = col * a.ct;
  auto cols_of = [&](int g) { return cc0 + (NSEG == 1 ? 64 * g : 0); };

  if (threadIdx.x == 0) {
    for (int i = 0; i < a.stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 2);
    }
    mbar_init(wbar, 1);
    mbar_init(efull, 1);
    mbar_init(edone, 2);
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------------------ producer
    regs_shrink<40>();
    if (tid == 0) {
      prefetch_map(&mz);
      prefetch_map(&mg);
      prefetch_map(&mw);
      if (a.resident) {
        // this CTA's side and column: the row's 3 x cb boxes, once
        mbar_expect_tx(wbar, 3 * a.cb * wbox);
        for (int kw = 0; kw < 3; ++kw)
          for (int k = 0; k < a.cb; ++k)
            tma_load_3d(wres + (kw * a.cb + k) * wbox, &mw, wbar, 64 * k,
                        3 * kyw + kw, cc0);
      }
      const int bytes =
          NSEG * HROWS * (128 + 256) + (a.resident ? 0 : 3 * wbox);
      int st = 0, ph = 0;
      for (int i = 0; i < ntiles; ++i) {
        for (int k = 0; k < a.cb; ++k) {
          mbar_wait(&empty[st], ph ^ 1);
          uint8_t* buf = smem + st * sb;
          mbar_expect_tx(&full[st], bytes);
          for (int j = 0; j < NSEG; ++j) {
            const Seg g = seg_at(t_lo + i, j);
            tma_load_4d(buf + j * HBOX, &mz, &full[st], 64 * k, g.x0 - 1,
                        g.qa, g.img);
            tma_load_4d(buf + NSEG * HBOX + j * GBOX, &mg, &full[st], 64 * k,
                        g.x0 - 1, g.qa, g.img);
          }
          if (!a.resident)
            for (int kw = 0; kw < 3; ++kw)
              tma_load_3d(buf + w_at + kw * wbox, &mw, &full[st], 64 * k,
                          3 * kyw + kw, cc0);
          if (++st == a.stages) st = 0, ph ^= 1;
        }
      }
    } else if (tid == 32) {
      // the epilogue slot: store the last tile's gm*a1, let the store read
      // it, then fill the slot with the next tile's x_q
      prefetch_map(&mx);
      prefetch_map(&me);
      auto store = [&](int t) {
        for (int g = 0; g < 2; ++g) {
          const Seg s = seg_at(t, g);
          for (int hb = 0; hb < 2; ++hb)
            tma_store_4d(&me, eslot + g * OUT + hb * SEG * 128,
                         cols_of(g) + 32 * hb, s.x0, 2 * s.b + side, s.img);
        }
      };
      for (int i = 0; i < ntiles; ++i) {
        mbar_wait(edone, (i & 1) ^ 1);
        if (i > 0) {
          store(t_lo + i - 1);
          bulk_commit();
          bulk_wait_read<0>();
        }
        mbar_expect_tx(efull, 2 * SEG * 128);
        for (int g = 0; g < 2; ++g) {
          const Seg s = seg_at(t_lo + i, g);
          tma_load_4d(eslot + g * OUT, &mx, efull, cols_of(g), s.x0, s.q,
                      s.img);
        }
      }
      if (ntiles > 0) {
        mbar_wait(edone, (ntiles - 1) & 1);
        store(t_lo + ntiles - 1);
      }
      bulk_commit();
      bulk_wait<0>();
    }
  } else {
    // ----------------------------------------------------------- consumers
    regs_grow<232>();
    float acc[32] = {};  // each tile's first product overwrites it
    if (a.resident) mbar_wait(wbar, 0);
    const int warp = tid / 32, lane = tid % 32;
    // the halo box this thread rewrites, and its threads: a warpgroup its
    // own segment's box (NSEG 2), or both warpgroups the one box
    constexpr int RW = NSEG == 2 ? 128 : bwd::CONSUMERS;
    const int rt = NSEG == 2 ? tid : (int)threadIdx.x, jc = rt % 8;
    const int rbox = NSEG == 2 ? wg : 0;
    int st = 0, ph = 0;
    for (int i = 0; i < ntiles; ++i) {
      // the segment of the box rewritten, and of this warpgroup's rows
      const Seg g = seg_at(t_lo + i, rbox);
      const bool on = reads(a, g);
      const int n0 = cols_of(wg);
      // the mask's (a1, b1) of the fragment's columns, loaded ahead
      float2 ta[8], tb[8];
      if (on) {
        const float* tab = a.tx + (size_t)(g.img * a.nb + g.rb) * 2 * a.c + n0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int cl = 8 * j + 2 * (lane % 4);
          ta[j] = __ldg(reinterpret_cast<const float2*>(tab + cl));
          tb[j] = __ldg(reinterpret_cast<const float2*>(tab + a.c + cl));
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) ta[j] = tb[j] = make_float2(0.f, 0.f);
      }
      int prev = 0;
      for (int k = 0; k < a.cb; ++k) {
        const int c = 64 * k + 8 * jc;
        // the box's table (its reading band's), loaded before the wait
        typename GhostTr<float>::DT dt;
        if (on) tr.d_tab(dt, g.img * a.nb + g.rb, c);
        mbar_wait(&full[st], ph);
        uint8_t* buf = smem + st * sb;
        // dz of the halo box: chunk u is its row hr = u / 8, pixel x0 - 1
        // + hr of the row q' (zero outside the image: the w pad, and q'
        // past the image's first or last row)
        uint8_t* box = buf + rbox * HBOX;
        const uint8_t* gbox = buf + NSEG * HBOX + rbox * GBOX;
#pragma unroll
        for (int q = 0; q < (HROWS * 8 + RW - 1) / RW; ++q) {
          const int hr = (rt + RW * q) / 8;
          if (hr >= HROWS) break;
          const int sx = g.x0 - 1 + hr;
          const uint32_t off = bwd::chunk_offset(hr, jc);
          uint4 v = make_uint4(0, 0, 0, 0);
          if (on && sx >= 0 && sx < a.w) {
            float d[8], gf[8];
            unpack8(*reinterpret_cast<const uint4*>(box + off), d);
            bwd::aux8<float>(gbox, 0, hr, jc, gf);
            tr.dy(d, gf, dt, 0, c);
            v = pack8(d);
          }
          *reinterpret_cast<uint4*>(box + off) = v;
        }
        fence_async_smem();
        if (NSEG == 2)
          bar_sync(2 + wg, 128);
        else
          bar_sync(1, bwd::CONSUMERS);
        // the three kx taps: the box read kx rows in, against the
        // kernel's row kyw at column 2 - kx (the flipped kernel's ky row),
        // this warpgroup's 64 columns of it
        const uint8_t* wk = a.resident ? wres + k * wbox : buf + w_at;
        const int wstep = a.resident ? a.cb * wbox : wbox;
        const int wrow = NSEG == 1 ? wg * 64 * 128 : 0;
        wgmma_fence();
        fence_operands(acc);
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const uint64_t da = sw128_desc(box + kx * 128, 16, 1024);
          const uint64_t db =
              sw128_desc(wk + (2 - kx) * wstep + wrow, 16, 1024);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)  // 32 bytes a k16 step, >> 4
            WgmmaK<64>::mma(acc, da + 2 * kk, db + 2 * kk,
                            k > 0 || kx > 0 || kk > 0);
        }
        wgmma_commit();
        fence_operands(acc);
        wgmma_wait<1>();
        if (k > 0 && tid == 0) mbar_arrive(&empty[prev]);
        prev = st;
        if (++st == a.stages) st = 0, ph ^= 1;
      }
      wgmma_wait<0>();
      fence_operands(acc);
      if (tid == 0) mbar_arrive(&empty[prev]);

      // ---------------------------------------------------------- epilogue
      uint8_t* slot = eslot + wg * OUT;
      const Seg& s = g;
      mbar_wait(efull, i & 1);
      // x_q of the fragment's pixels, read before gm*a1 overwrites the slot
      uint32_t xr[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2)
          xr[j][e2] = *reinterpret_cast<const uint32_t*>(
              slot + swizzled_offset(16 * warp + lane / 4 + 8 * e2,
                                     8 * j + 2 * (lane % 4)));
      bar_sync(2 + wg, 128);
      float* wred = red + (wg * 4 + warp) * 128;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int cl = 8 * j + 2 * (lane % 4);
        float s0[2] = {0.f, 0.f}, s1[2] = {0.f, 0.f};
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int row = 16 * warp + lane / 4 + 8 * e2;
          const bool in = on && s.x0 + row < a.w;
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&xr[j][e2]));
          const float u = in && affine(xv.x, ta[j].x, tb[j].x) > 0.f
                              ? acc[4 * j + 2 * e2] : 0.f;
          const float v = in && affine(xv.y, ta[j].y, tb[j].y) > 0.f
                              ? acc[4 * j + 2 * e2 + 1] : 0.f;
          s0[0] += u * xv.x;
          s0[1] += v * xv.y;
          s1[0] += u;
          s1[1] += v;
          *reinterpret_cast<float2*>(slot + out_offset(row, cl)) =
              make_float2(u * ta[j].x, v * ta[j].y);
        }
        // the warp's 16 rows, in a fixed order
#pragma unroll
        for (int e3 = 0; e3 < 2; ++e3)
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            s0[e3] += __shfl_xor_sync(0xffffffffu, s0[e3], o);
            s1[e3] += __shfl_xor_sync(0xffffffffu, s1[e3], o);
          }
        if (lane < 4) {
          *reinterpret_cast<float2*>(wred + cl) = make_float2(s0[0], s0[1]);
          *reinterpret_cast<float2*>(wred + 64 + cl) =
              make_float2(s1[0], s1[1]);
        }
      }
      // the slot is done (gm*a1 staged): the producer stores it
      fence_async_smem();
      bar_sync(2 + wg, 128);
      if (tid == 0) mbar_arrive(edone);
      if (s.live) {
        // the segment's entry of the reading band (rb modulo nb: an
        // out-of-image rb writes the zero entry that no segment reads
        // into), its 4 warps in order
        const int k2 = tid / 64, cl = tid % 64;
        float sum = 0.f;
#pragma unroll
        for (int w4 = 0; w4 < 4; ++w4)
          sum += red[(wg * 4 + w4) * 128 + k2 * 64 + cl];
        const int grp = s.img * a.nb + (s.rb + a.nb) % a.nb;
        const int entry = grp * 2 * a.segs + (side ? 0 : a.segs) + s.x0 / SEG;
        a.part[((size_t)entry * 2 + k2) * a.c + n0 + cl] = sum;
      }
      bar_sync(2 + wg, 128);  // red is read before the next tile writes it
    }
  }
}


// ------------------------------------------------------------ seam, f32
//
// tseam in float32 (tseam32): the same sides, segments, slots and entries,
// a K step of 32 channels and the 1x3 product by split TF32. A tile is
// two segments, one a warpgroup, by 64 columns at every c. What held the
// first float32 design (dz formed in registers once a tap, each tap's
// twelve products waited for alone, one epilogue slot whose x_q load
// waited behind the last store: 0.4132 ms a step on the H100 against a
// bound of 0.1419) is answered so:
// - dz once a K step: each consumer warpgroup turns its segment's z and g
//   halo boxes (66 rows of 32 f32, 128-byte swizzled) into dz's TF32 hi
//   and lo in place, hi over z and lo over g, each thread the 16-byte
//   chunks it reads (one 4-channel column of the box; the band's table
//   loaded a K step ahead), zero at the w pad and over the whole box
//   where the reading band lies outside the image; then fence_async_smem
//   and the warpgroup's named barrier, and each tap reads A through
//   descriptors of the boxes shifted by kx rows, as the bf16 tseam's.
// - the three taps back to back: each into its own fresh accumulator, the
//   K step's 36 wgmmas under one commit and one wait, then the three
//   accumulators added to the f32 sum in the order kx 0, 1, 2 (the K step,
//   then kx: the first design's order of summation). The next K step's
//   boxes rewritten under these products (three ring slots at c = 64)
//   measured no faster, and were taken out.
// - no epilogue slot: each thread loads its fragment's x_q (f32, 32 bytes
//   a row a quad of lanes: whole sectors) into registers before the
//   tile's first products and stores gm*a1 from registers into the
//   edge's row (masked at the ragged w), so the next tile's x_q loads
//   while this one's result is stored; the reading band's (a1, b1) come
//   into shared memory by cp.async with the first products. A slot, or
//   two, would leave the ring two slots at c = 64. The column sums by the
//   butterfly of conv_bwd.cuh's tile_sums (seam_sums).
// - the weight (Co, Ci, 3, 3) is laid out and split in one launch
//   (seam_wsplit32), resident where it fits beside the ring (c = 64),
//   else streamed with each K step.
// On the H100 (PERF.md, Findings) what bounds it is the ring: the z and g
// loads alone (no products, no epilogue) take 0.43 of the kernel's time
// at 128^2, at 2.1 TB/s, and shared memory, which three slots and the
// resident weight fill, keeps the loads, the rewrite and the products
// (both operands read from shared memory at 64 columns) from overlapping
// further. Tried and measured slower or no faster: dz by ldmatrix into
// the taps' register fragments (1.3-1.9x), 32-column tiles (the boxes read
// twice or four times), a ring a warpgroup with their products in turns,
// the rows prefetched into L2 ahead.
// The band sums: one entry a segment, its 4 warps in order, added in
// order in double (reduce_groups_wide). No atomics: two launches are
// bit-equal, and both plans' output is the same.
constexpr int HBOX32 = 9216;  // a segment's 66-pixel box of 32 f32
                              // channels (8,448 bytes), 1024-aligned
constexpr int RED32 = RED + 2 * 2 * 64 * 4;  // the warps' column sums and
                                             // each warpgroup's (a1, b1)
constexpr int N32 = 64;                      // columns a tile
constexpr int WBOX32 = N32 * 128;            // a weight box (hi or lo)

struct Args32 : Args {
  const float* x;  // z1 (n, h, w, c): x_q
  float* edge;     // (n, nb, 2, w, c)
};

// A ring slot: both segments' z and g boxes, and the streamed weight's
// boxes of the three taps.
__host__ __device__ constexpr int stage_bytes32(bool resident) {
  return 4 * HBOX32 + (resident ? 0 : 6 * WBOX32);
}
__host__ __device__ constexpr int smem_bytes32(int cb, bool resident,
                                               int stages) {
  return stages * stage_bytes32(resident) +
         (resident ? 6 * cb * WBOX32 : 0) + RED32 + 8 * (2 * stages + 1) +
         1024;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// A consumer warpgroup's column sums of its segment in a fixed order (the
// first float32 design's): each thread's two rows (cs0, cs1: [sum gm*x_q,
// sum gm] of its columns), the warp's 8 row slots (lanes xor 4, 8, 16) by
// the butterfly of conv_bwd.cuh's tile_sums (each level adds the pairs the
// xor shuffles of every value would add, with a quarter of the shuffles),
// then the warpgroup's 4 warps in order. Returns value tid's sum (tid <
// 128: [sum cs0, sum cs1] of column tid % 64). Every thread of the
// warpgroup calls it; red is read before it returns.
__device__ __forceinline__ float seam_sums(float (&cs0)[N32 / 8][2],
                                           float (&cs1)[N32 / 8][2],
                                           float* red, int wg, int warp,
                                           int lane, int tid) {
  constexpr int V = N32 / 2;  // a thread's values: cs0, then cs1
  float v[V];
#pragma unroll
  for (int j = 0; j < N32 / 8; ++j)
#pragma unroll
    for (int e3 = 0; e3 < 2; ++e3) {
      v[2 * j + e3] = cs0[j][e3];
      v[V / 2 + 2 * j + e3] = cs1[j][e3];
    }
  const int g = lane >> 2;
  const bool b0 = g & 1, b1 = g & 2, b2 = g & 4;
  float w1[V / 2], w2[V / 4], w3[V / 8];
#pragma unroll
  for (int i = 0; i < V / 2; ++i)
    w1[i] = (b0 ? v[i + V / 2] : v[i]) +
            __shfl_xor_sync(0xffffffffu, b0 ? v[i] : v[i + V / 2], 4);
#pragma unroll
  for (int i = 0; i < V / 4; ++i)
    w2[i] = (b1 ? w1[i + V / 4] : w1[i]) +
            __shfl_xor_sync(0xffffffffu, b1 ? w1[i] : w1[i + V / 4], 8);
#pragma unroll
  for (int i = 0; i < V / 8; ++i)
    w3[i] = (b2 ? w2[i + V / 8] : w2[i]) +
            __shfl_xor_sync(0xffffffffu, b2 ? w2[i] : w2[i + V / 8], 16);
  // the lane's values: flat indices f0 + i of v
  float* wred = red + (wg * 4 + warp) * 2 * N32;
  const int f0 = (b0 ? V / 2 : 0) + (b1 ? V / 4 : 0) + (b2 ? V / 8 : 0);
  const int t2 = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < V / 8; ++i) {
    const int f = f0 + i, r = f % (V / 2);
    wred[(f / (V / 2)) * N32 + 8 * (r / 2) + t2 + (r & 1)] = w3[i];
  }
  bar_sync(2 + wg, 128);
  float s = 0.f;
#pragma unroll
  for (int w4 = 0; w4 < 4; ++w4) s += red[(wg * 4 + w4) * 2 * N32 + tid];
  return s;
}

__global__ void __launch_bounds__(bwd::THREADS, 1)
tseam32(const __grid_constant__ CUtensorMap mz,
        const __grid_constant__ CUtensorMap mg,
        const __grid_constant__ CUtensorMap mw, const Args32 a,
        const GhostTr32 tr) {
  constexpr int NA = N32 / 2;  // accumulator registers a tap
  extern __shared__ uint8_t raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  const int sb = stage_bytes32(a.resident);
  const int w_at = 4 * HBOX32;  // the streamed weight boxes
  uint8_t* wres = smem + a.stages * sb;
  float* red = reinterpret_cast<float*>(wres +
                                        (a.resident ? 6 * a.cb * WBOX32 : 0));
  uint64_t* full = reinterpret_cast<uint64_t*>(red + RED32 / 4);
  uint64_t* empty = full + a.stages;
  uint64_t* wbar = empty + a.stages;

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int tid = threadIdx.x % 128;
  const int groups = 2 * a.col_tiles;
  const int gid = (int)blockIdx.x % groups;
  const int side = gid / a.col_tiles, col = gid % a.col_tiles;
  const int ctas = (int)gridDim.x / groups, me_i = (int)blockIdx.x / groups;
  const int t_lo = (int)((long long)me_i * a.tiles / ctas);
  const int ntiles = (int)((long long)(me_i + 1) * a.tiles / ctas) - t_lo;
  // the kernel's row read: 0 for slot 1 (the flipped kernel's row 2), 2
  // for slot 0
  const int kyw = side ? 0 : 2;
  // warpgroup g's segment of tile t
  auto seg_at = [&](int t, int g) { return seg_of(a, side, 2 * t + g); };
  const int cc0 = col * N32;

  if (threadIdx.x == 0) {
    for (int i = 0; i < a.stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 2);
    }
    mbar_init(wbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------------------ producer
    regs_shrink<40>();
    if (tid == 0) {
      prefetch_map(&mz);
      prefetch_map(&mg);
      prefetch_map(&mw);
      if (a.resident) {
        // this CTA's side and column: the row's 3 x cb x (hi, lo) boxes
        mbar_expect_tx(wbar, 6 * a.cb * WBOX32);
        for (int kw = 0; kw < 3; ++kw)
          for (int k = 0; k < a.cb; ++k)
            for (int part = 0; part < 2; ++part)
              tma_load_4d(wres + ((kw * a.cb + k) * 2 + part) * WBOX32, &mw,
                          wbar, 32 * k, 3 * kyw + kw, cc0, part);
      }
      const int bytes = 4 * HROWS * 128 + (a.resident ? 0 : 6 * WBOX32);
      int st = 0, ph = 0;
      for (int i = 0; i < ntiles; ++i) {
        for (int k = 0; k < a.cb; ++k) {
          mbar_wait(&empty[st], ph ^ 1);
          uint8_t* buf = smem + st * sb;
          mbar_expect_tx(&full[st], bytes);
          for (int j = 0; j < 2; ++j) {
            const Seg g = seg_at(t_lo + i, j);
            tma_load_4d(buf + j * HBOX32, &mz, &full[st], 32 * k, g.x0 - 1,
                        g.qa, g.img);
            tma_load_4d(buf + (2 + j) * HBOX32, &mg, &full[st], 32 * k,
                        g.x0 - 1, g.qa, g.img);
          }
          if (!a.resident)
            for (int kw = 0; kw < 3; ++kw)
              for (int part = 0; part < 2; ++part)
                tma_load_4d(buf + w_at + (kw * 2 + part) * WBOX32, &mw,
                            &full[st], 32 * k, 3 * kyw + kw, cc0, part);
          if (++st == a.stages) st = 0, ph ^= 1;
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------- consumers
  regs_grow<232>();
  float acc[3][NA] = {}, sum[NA];
  if (a.resident) mbar_wait(wbar, 0);
  const int warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  // this warpgroup's (a1, b1) of the tile's columns, by cp.async
  float* tab = red + RED / 4 + wg * 2 * N32;
  const int nsteps = ntiles * a.cb;
  // step s's z box of this warpgroup's segment (its g box 2 boxes on)
  auto zbox_of = [&](int s) {
    return smem + (s % a.stages) * sb + wg * HBOX32;
  };
  // the flipped kernel's ky row at column 2 - kx, this K step's hi box
  auto wbox_at = [&](int k, int st, int kx) {
    return a.resident ? wres + ((2 - kx) * a.cb + k) * 2 * WBOX32
                      : smem + st * sb + w_at + (2 - kx) * 2 * WBOX32;
  };

  // the band's table of the chunk a thread rewrites (channels 32 k + 4 jc
  // .. + 3 of step s's band), loaded one K step ahead
  const int jc = tid % 8;
  GhostTr32::D4 tn;
  auto load_tab = [&](int s) {
    const int i = s / a.cb;
    const Seg g = seg_at(t_lo + i, wg);
    if (reads(a, g))
      tr.d4_tab(tn, g.img * a.nb + g.rb, 32 * (s - i * a.cb) + 4 * jc);
  };
  // step s's boxes (tile s / cb, K step s % cb) rewritten into dz's hi and
  // lo, seen by the warpgroup's async proxy; step s + 1's table loaded
  auto rewrite = [&](int s) {
    const int i = s / a.cb;
    const Seg g = seg_at(t_lo + i, wg);
    const bool on = reads(a, g);
    mbar_wait(&full[s % a.stages], (s / a.stages) & 1);
    uint8_t* zb = zbox_of(s);
    uint8_t* gb = zb + 2 * HBOX32;
#pragma unroll
    for (int q = 0; q < (HROWS * 8 + 127) / 128; ++q) {
      // row hr: pixel x0 - 1 + hr of the row q' (zero at the w pad; the
      // whole box where rb lies outside the image)
      const int hr = tid / 8 + 16 * q;
      if (hr >= HROWS) break;
      const int sx = g.x0 - 1 + hr;
      const uint32_t off = bwd::chunk_offset(hr, jc);
      uint4 hi = make_uint4(0, 0, 0, 0), lo = hi;
      if (on && sx >= 0 && sx < a.w) {
        const float4 z4 = *reinterpret_cast<const float4*>(zb + off);
        const float4 g4 = *reinterpret_cast<const float4*>(gb + off);
        tf32_split(tr.d1(z4.x, g4.x, tn, 0), hi.x, lo.x);
        tf32_split(tr.d1(z4.y, g4.y, tn, 1), hi.y, lo.y);
        tf32_split(tr.d1(z4.z, g4.z, tn, 2), hi.z, lo.z);
        tf32_split(tr.d1(z4.w, g4.w, tn, 3), hi.w, lo.w);
      }
      *reinterpret_cast<uint4*>(zb + off) = hi;
      *reinterpret_cast<uint4*>(gb + off) = lo;
    }
    if (s + 1 < nsteps) load_tab(s + 1);
    fence_async_smem();
    bar_sync(2 + wg, 128);
  };

  // step s's 36 products, the three taps back to back, each into its own
  // fresh accumulator, under one commit
  auto issue = [&](int s) {
    const int k = s % a.cb, st = s % a.stages;
    const uint8_t* zb = zbox_of(s);
    wgmma_fence();
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      const uint8_t* wb = wbox_at(k, st, kx);
      const uint64_t bhi = sw128_desc(wb, 16, 1024);
      const uint64_t blo = sw128_desc(wb + WBOX32, 16, 1024);
      // the boxes kx rows in: hi over z, lo over g
      const uint64_t ahi = sw128_desc(zb + kx * 128, 16, 1024);
      const uint64_t alo = sw128_desc(zb + 2 * HBOX32 + kx * 128, 16, 1024);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // 32 bytes a k8 step, >> 4
        WgmmaTf32<N32>::mma(acc[kx], alo + 2 * kk, bhi + 2 * kk, kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        WgmmaTf32<N32>::mma(acc[kx], ahi + 2 * kk, blo + 2 * kk, 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        WgmmaTf32<N32>::mma(acc[kx], ahi + 2 * kk, bhi + 2 * kk, 1);
    }
    wgmma_commit();
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) fence_operands(acc[kx]);
  };

  // step s's products waited for, added to the sum kx 0, 1, 2, its slot
  // released
  auto retire = [&](int s) {
    wgmma_wait<0>();
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) fence_operands(acc[kx]);
#pragma unroll
    for (int kx = 0; kx < 3; ++kx)
#pragma unroll
      for (int e = 0; e < NA; ++e) sum[e] += acc[kx][e];
    if (tid == 0) mbar_arrive(&empty[s % a.stages]);
  };

  // x_q of the fragment's pixels, loaded at the tile's first products
  float2 xq[N32 / 8][2];
  // tile i's inputs of the epilogue: x_q into registers, (a1, b1) of the
  // reading band by cp.async
  auto prefetch = [&](int i) {
    const Seg g = seg_at(t_lo + i, wg);
    const bool on = reads(a, g);
    const float* xrow =
        a.x + (((size_t)g.img * a.h + g.q) * a.w + g.x0) * a.c + cc0 + 2 * t4;
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int row = 16 * warp + g8 + 8 * e2;
      const bool in = on && g.x0 + row < a.w;
#pragma unroll
      for (int j = 0; j < N32 / 8; ++j)
        xq[j][e2] = in ? __ldg(reinterpret_cast<const float2*>(
                             xrow + (size_t)row * a.c + 8 * j))
                       : make_float2(0.f, 0.f);
    }
    if (on && tid < N32 / 2) {
      // 16 16-byte chunks of a1, then of b1
      const int part = tid / (N32 / 4), ch = 4 * (tid % (N32 / 4));
      cp_async16(tab + part * N32 + ch,
                 a.tx + ((size_t)(g.img * a.nb + g.rb) * 2 + part) * a.c +
                     cc0 + ch);
    }
  };

  // tile i's epilogue: gm = sum masked under the reading band's (a1, b1)
  // at x_q, gm*a1 stored into the slot of the row's own band, the
  // segment's [sum gm*x_q, sum gm] one entry of the reading band
  auto epilogue = [&](int i) {
    const Seg g = seg_at(t_lo + i, wg);
    const bool on = reads(a, g);
    cp_async_wait_all();
    bar_sync(2 + wg, 128);
    float* erow = a.edge +
                  ((((size_t)g.img * a.nb + g.b) * 2 + side) * a.w + g.x0) *
                      a.c + cc0 + 2 * t4;
    float cs0[N32 / 8][2], cs1[N32 / 8][2];
#pragma unroll
    for (int j = 0; j < N32 / 8; ++j) {
      const int cl = 8 * j + 2 * t4;
      float2 ta = make_float2(0.f, 0.f), tb = ta;
      if (on) {
        ta = *reinterpret_cast<const float2*>(tab + cl);
        tb = *reinterpret_cast<const float2*>(tab + N32 + cl);
      }
      cs0[j][0] = cs0[j][1] = cs1[j][0] = cs1[j][1] = 0.f;
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int row = 16 * warp + g8 + 8 * e2;
        const bool in = on && g.x0 + row < a.w;
        const float2 xv = xq[j][e2];
        const float u = in && affine(xv.x, ta.x, tb.x) > 0.f
                            ? sum[4 * j + 2 * e2] : 0.f;
        const float v = in && affine(xv.y, ta.y, tb.y) > 0.f
                            ? sum[4 * j + 2 * e2 + 1] : 0.f;
        cs0[j][0] += u * xv.x;
        cs0[j][1] += v * xv.y;
        cs1[j][0] += u;
        cs1[j][1] += v;
        if (g.live && g.x0 + row < a.w)
          *reinterpret_cast<float2*>(erow + (size_t)row * a.c + 8 * j) =
              make_float2(u * ta.x, v * ta.y);
      }
    }
    const float s = seam_sums(cs0, cs1, red, wg, warp, lane, tid);
    if (g.live) {
      // the segment's entry of the reading band (rb modulo nb: an
      // out-of-image rb writes the zero entry that no segment reads into)
      const int grp = g.img * a.nb + (g.rb + a.nb) % a.nb;
      const int entry = grp * 2 * a.segs + (side ? 0 : a.segs) + g.x0 / SEG;
      a.part[((size_t)entry * 2 + tid / N32) * a.c + cc0 + tid % N32] = s;
    }
    // the sums and the table read before the next tile writes them
    bar_sync(2 + wg, 128);
  };

  if (nsteps > 0) load_tab(0);
  for (int s = 0; s < nsteps; ++s) {
    const int i = s / a.cb, k = s - i * a.cb;
    if (k == 0) {
#pragma unroll
      for (int e = 0; e < NA; ++e) sum[e] = 0.f;
      prefetch(i);
    }
    rewrite(s);
    issue(s);
    retire(s);
    if (k == a.cb - 1) epilogue(i);
  }
}

// The seam's weight (Co, Ci, 3, 3) f32 as its TF32 split in the layout
// tseam32's map mw reads, (2, Ci, 9, Co): out[p][ci][tap][co] is hi (p 0)
// or lo (p 1) of w[co][ci][tap], in one launch. A block transposes a 32 x
// 8 (co, ci) tile of all 9 taps through shared memory, each of its 256
// threads 9 values, its loads all in flight: w read and out written in
// runs of 288 and 128 bytes. Grid (c / 32, c / 8).
__global__ void __launch_bounds__(256)
seam_wsplit32(const float* __restrict__ w, float* __restrict__ out, int c) {
  __shared__ float t[32][8 * 9 + 1];
  const int co0 = blockIdx.x * 32, ci0 = blockIdx.y * 8;
  float v[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    // r: co - co0; e: (ci - ci0) * 9 + tap
    const int i = threadIdx.x + 256 * j, r = i / 72, e = i - r * 72;
    v[j] = __ldg(w + ((size_t)(co0 + r) * c + ci0) * 9 + e);
  }
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    const int i = threadIdx.x + 256 * j, r = i / 72;
    t[r][i - r * 72] = v[j];
  }
  __syncthreads();
  const size_t n = 9ull * c * c;
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    const int i = threadIdx.x + 256 * j, e = i / 32, r = i % 32;
    uint32_t hi, lo;
    tf32_split(t[r][e], hi, lo);
    const size_t o = ((size_t)(ci0 + e / 9) * 9 + e % 9) * c + co0 + r;
    out[o] = __uint_as_float(hi);
    out[n + o] = __uint_as_float(lo);
  }
}

}  // namespace seam

// The seam plan (ops/ghost.py seam_plan): ct columns a tile (64: two
// segments a tile; 128: one, the warpgroups' columns side by side), the
// weight resident or streamed, `stages` ring slots, `grid` persistent
// CTAs (a multiple of 2 * c / ct).
int run_seam(const void* g, const void* z, const float* td, const void* x,
             const float* tx, const void* wt, float* edge, float* sums,
             float* part, int n, int h, int w, int c, int gh, int ct,
             int resident, int stages, int grid, cudaStream_t s) {
  seam::Args a{};
  a.part = part;
  a.td = td;
  a.tx = tx;
  a.n = n, a.h = h, a.w = w, a.c = c, a.gh = gh, a.nb = h / gh;
  a.ct = ct, a.cb = c / 64, a.col_tiles = c / ct;
  a.segs = (w + seam::SEG - 1) / seam::SEG;
  const int nseg = ct == 64 ? 2 : 1;
  const long long count = (long long)n * a.nb * a.segs;
  a.count = (int)count;
  a.tiles = (int)((count + nseg - 1) / nseg);
  a.stages = stages, a.resident = resident;
  const int groups = 2 * a.col_tiles;
  const int smem = seam::smem_bytes(nseg, ct, a.cb, resident, stages);
  bool aligned = true;
  for (const void* p : {g, z, (const void*)td, x, (const void*)tx, wt,
                        (const void*)edge, (const void*)part})
    aligned = aligned && hop::aligned16(p);
  if ((ct != 64 && ct != 128) || c % ct || stages < 2 ||
      smem > bwd::MAX_SMEM || grid < groups ||
      grid % groups || grid / groups > a.tiles || !aligned ||
      (long long)n * h * w * c >= (1ll << 31))
    return cudaErrorInvalidValue;
  CUtensorMap mz, mg, mw, mx, me;
  const cuuint64_t wdims[3] = {(cuuint64_t)c, 9, (cuuint64_t)c};
  const cuuint32_t wb[3] = {64, 1, (cuuint32_t)ct};
  // edge (n, nb, 2, w, c) as (c, w, 2 nb, n): seam row 2 b + slot
  const cuuint64_t edims[4] = {(cuuint64_t)c, (cuuint64_t)w,
                               (cuuint64_t)(2 * a.nb), (cuuint64_t)n};
  const cuuint32_t eb[4] = {32, (cuuint32_t)seam::SEG, 1, 1};
  if (!hop::encode_act(&mz, z, false, c, w, h, n, seam::HROWS, 1) ||
      !hop::encode_act(&mg, g, true, c, w, h, n, seam::HROWS, 1) ||
      !hop::encode(&mw, wt, false, 3, wdims, wb,
                   CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hop::encode_act(&mx, x, false, c, w, h, n, seam::SEG, 1) ||
      !hop::encode(&me, edge, true, 4, edims, eb, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  const GhostTr<float> tr{nullptr, td, nullptr, c, c, gh * w, w};
  static bool set1[64] = {}, set2[64] = {};
  cudaError_t err;
  if (nseg == 2) {
    err = hop::allow_smem(seam::tseam<2>, set2, bwd::MAX_SMEM);
    if (err == cudaSuccess)
      seam::tseam<2><<<grid, bwd::THREADS, smem, s>>>(mz, mg, mw, mx, me, a,
                                                      tr);
  } else {
    err = hop::allow_smem(seam::tseam<1>, set1, bwd::MAX_SMEM);
    if (err == cudaSuccess)
      seam::tseam<1><<<grid, bwd::THREADS, smem, s>>>(mz, mg, mw, mx, me, a,
                                                      tr);
  }
  if (err != cudaSuccess) return err;
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // each band's entries, side 0's segments before side 1's, in order
  bwd::reduce_parts<<<dim3((2 * c + 127) / 128, (unsigned)(n * a.nb)), 128,
                      0, s>>>(part, sums, 2 * c, 2 * a.segs);
  return cudaGetLastError();
}

// The float32 seam plan (ops/ghost.py seam_plan with 4-byte elements):
// 64-column tiles of two segments, the weight resident or streamed,
// `stages` ring slots, `grid` persistent CTAs (a multiple of 2 * c / 64);
// wsplit (2, c, 9c) f32 scratch for the weight's layout and TF32 split.
int run_seam32(const float* g, const float* z, const float* td,
               const float* x, const float* tx, const float* wt,
               float* wsplit, float* edge, float* sums, float* part, int n,
               int h, int w, int c, int gh, int resident, int stages,
               int grid, cudaStream_t s) {
  seam::Args32 a{};
  a.part = part;
  a.td = td;
  a.tx = tx;
  a.x = x;
  a.edge = edge;
  a.n = n, a.h = h, a.w = w, a.c = c, a.gh = gh, a.nb = h / gh;
  a.ct = seam::N32, a.cb = c / 32, a.col_tiles = c / seam::N32;
  a.segs = (w + seam::SEG - 1) / seam::SEG;
  const long long count = (long long)n * a.nb * a.segs;
  a.count = (int)count;
  a.tiles = (int)((count + 1) / 2);
  a.stages = stages, a.resident = resident;
  const int groups = 2 * a.col_tiles;
  const int smem = seam::smem_bytes32(a.cb, resident, stages);
  bool aligned = true;
  for (const void* p : {(const void*)g, (const void*)z, (const void*)td,
                        (const void*)x, (const void*)tx, (const void*)wt,
                        (const void*)wsplit, (const void*)edge,
                        (const void*)part})
    aligned = aligned && hop::aligned16(p);
  if (c % 64 || stages < 2 || smem > bwd::MAX_SMEM || grid < groups ||
      grid % groups || grid / groups > a.tiles || !aligned ||
      (long long)n * h * w * c >= (1ll << 31))
    return cudaErrorInvalidValue;
  CUtensorMap mz, mg, mw;
  // the split weight as (c, 9, c, 2): box (32, 1, 64, 1), hi at 0
  const cuuint64_t wdims[4] = {(cuuint64_t)c, 9, (cuuint64_t)c, 2};
  const cuuint32_t wb[4] = {32, 1, (cuuint32_t)seam::N32, 1};
  if (!hop::encode_act32(&mz, z, c, w, h, n, seam::HROWS, 1) ||
      !hop::encode_act32(&mg, g, c, w, h, n, seam::HROWS, 1) ||
      !hop::encode(&mw, wsplit, true, 4, wdims, wb,
                   CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  const GhostTr32 tr{tx, td, nullptr, c, c, gh * w, w};
  seam::seam_wsplit32<<<dim3(c / 32, c / 8), 256, 0, s>>>(wt, wsplit, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  static bool set[64] = {};
  if ((err = hop::allow_smem(seam::tseam32, set, bwd::MAX_SMEM)) !=
      cudaSuccess)
    return err;
  seam::tseam32<<<grid, bwd::THREADS, smem, s>>>(mz, mg, mw, a, tr);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // each band's entries, side 0's segments before side 1's, in order, in
  // double
  bwd::reduce_groups_wide<<<dim3((2 * c + 127) / 128,
                                 (unsigned)(n * a.nb)), 128, 0, s>>>(
      part, sums, 2 * c, 2 * a.segs);
  return cudaGetLastError();
}

}  // namespace

// x (n,h,w,ci) bf16; tab (bands,2,ci) f32 or null; wt (co, ks*ks*ci) bf16
// with K in (ky, kx, ci) order; y (n,h,w,co) bf16 and stats (bands,2,co)
// f32 out, written whole. The plan (ops/conv.py tma_staged_fwd_plan over
// the image geometry: wb, hb, bn, resident, stages, grid, eslots; hb
// divides gh); ws holds one (2, co) entry a row tile. ci, co multiples of
// 64; ks 1 or 3; h a multiple of gh. Returns the first launch error.
extern "C" int ghost_conv_fwd(const void* x, const void* tab, const void* wt,
                              void* y, void* stats, void* ws, int n, int h,
                              int w, int ci, int co, int ks, int gh, int wb,
                              int hb, int bn, int resident, int stages,
                              int grid, int eslots, void* stream) {
  if (bad_geometry(n, h, w, gh, ci, co) || (ks != 1 && ks != 3) ||
      (long long)n * h * w * (ci > co ? ci : co) >= (1ll << 31))
    return cudaErrorInvalidValue;
  bwd::DxArgs a{};
  a.out = y;
  a.out_kind = 4;
  // tdx's columns are the conv's output channels, its K the input's
  return bwd::run_dx(x, nullptr, wt, nullptr, a, static_cast<float*>(ws),
                     static_cast<float*>(stats), n, h, w, co, ci, ks, gh,
                     bwd::DxPlan{wb, hb, bn, resident, stages, grid, eslots},
                     bwd::ActTr<false>{static_cast<const float*>(tab), ci,
                                       gh * w},
                     static_cast<cudaStream_t>(stream));
}

// x (n,h,w,ci) bf16 and tx (bands,2,ci) f32 or null: the conv's operand
// before its banded affine+relu; g (n,h,w,co) bf16 or f32 (g_f32), z
// (n,h,w,co) bf16, td (bands,3,co) f32 [a, c1, c2], edge (bands,2,w,co)
// f32 or null; wflip (ci, ks*ks*co) bf16, the flipped kernel with K in
// (ky, kx, co) order. Out: dx (n,h,w,ci), f32 gm (out_kind 0, with sums
// (bands,2,ci) and tx required), bf16 (1) or f32 (2) dX + addend (bf16
// add_kind 1, f32 add_kind 2, none 0); dw (ks*ks*ci, co) f32; all written
// whole. The plans (ops/conv.py), both over the image geometry: dW
// tma_dw_plan with g's aux boxes (wb, hb, bn, two, stages, splits, cs;
// with splits / cs > 1, ws_dw holds that many tables), dX tma_bwd_dx_plan
// (xwb, xhb, xbn, resident, xstages, grid, eslots; xhb divides gh; ws_sums
// holds one (2, ci) entry a row tile with out_kind 0). Taken: ks 1 with g
// bf16 or f32, ks 3 with g f32. Returns the first launch error.
extern "C" int ghost_conv_bwd(const void* x, const void* tx, const void* g,
                              const void* z, const void* td, const void* edge,
                              const void* wflip, void* dx, void* sums,
                              void* dw, const void* addend, void* ws_dw,
                              void* ws_sums, int g_f32, int add_kind,
                              int out_kind, int n, int h, int w, int ci,
                              int co, int ks, int gh, int wb, int hb, int bn,
                              int two, int stages, int splits, int cs,
                              int xwb, int xhb, int xbn, int resident,
                              int xstages, int grid, int eslots,
                              void* stream) {
  if (bad_geometry(n, h, w, gh, ci, co) || (ks != 1 && ks != 3) ||
      (ks == 3 && !g_f32) || out_kind < 0 || out_kind > 2 ||
      (out_kind == 0 && (!tx || !sums || !ws_sums)) || add_kind < 0 ||
      add_kind > 2 || (add_kind != 0 && !addend) || !td ||
      (long long)n * h * w * (ci > co ? ci : co) >= (1ll << 31))
    return cudaErrorInvalidValue;
  const bwd::DwPlan pw{wb, hb, bn, two, stages, splits, cs};
  const bwd::DxPlan px{xwb, xhb, xbn, resident, xstages, grid, eslots};
  auto txf = static_cast<const float*>(tx);
  auto tdf = static_cast<const float*>(td);
  auto ef = static_cast<const float*>(edge);
  auto sf = static_cast<float*>(sums);
  auto dwf = static_cast<float*>(dw);
  auto wsd = static_cast<float*>(ws_dw);
  auto wss = static_cast<float*>(ws_sums);
  auto s = static_cast<cudaStream_t>(stream);
  if (g_f32)
    return conv_bwd<float>(x, txf, g, z, tdf, ef, wflip, dx, sf, dwf, addend,
                           wsd, wss, add_kind, out_kind, n, h, w, ci, co, ks,
                           gh, pw, px, s);
  return conv_bwd<bf16>(x, txf, g, z, tdf, ef, wflip, dx, sf, dwf, addend,
                        wsd, wss, add_kind, out_kind, n, h, w, ci, co, ks, gh,
                        pw, px, s);
}

// Forward (dout null): out = relu(z*a + b + (sc*as + bs, or sc where ts is
// null)); backward: out = gm = dout*[pre > 0], sums (bands,3,c) f32 [sum
// gm*z, sum gm, sum gm*sc]. z, sc, dout, out (n,h,w,c) bf16; t, ts
// (bands,2,c) f32. Returns the launch error.
extern "C" int ghost_boundary(const void* dout, const void* z, const void* t,
                              const void* sc, const void* ts, void* out,
                              void* sums, int n, int h, int w, int c, int gh,
                              void* stream) {
  if (bad_geometry(n, h, w, gh, c, c) || (dout && !sums))
    return cudaErrorInvalidValue;
  const int cvb = c / 8 < 32 ? c / 8 : 32;  // 8-channel vectors a block row
  dim3 grid(n * (h / gh), c / (8 * cvb));
  gboundary<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(dout), static_cast<const bf16*>(z),
      static_cast<const float*>(t), static_cast<const bf16*>(sc),
      static_cast<const float*>(ts), static_cast<bf16*>(out),
      static_cast<float*>(sums), gh * w, c, cvb);
  return cudaGetLastError();
}

// g (n,h,w,c) f32 and z (n,h,w,c) bf16 with td (bands,3,c): dz of the 3x3
// conv's output; x (n,h,w,c) bf16 with tx (bands,2,c): its input z1 and
// (a1, b1); wt (c, 9c) bf16, the kernel (unflipped) with K in (ky, kx, c)
// order: wt[i][(3 ky + kx) c + o] = w[o][i][ky][kx]. Out: edge
// (bands,2,w,c) and sums (bands,2,c) f32, written whole; part holds the
// segments' entries (bands, 2 ceil(w/64), 2, c). The plan (ops/ghost.py
// seam_plan): ct, resident, stages, grid. c a multiple of 64.
// Returns the first launch error.
extern "C" int ghost_seam_bwd(const void* g, const void* z, const void* td,
                              const void* x, const void* tx, const void* wt,
                              void* edge, void* sums, void* part, int n,
                              int h, int w, int c, int gh, int ct,
                              int resident, int stages, int grid,
                              void* stream) {
  if (bad_geometry(n, h, w, gh, c, c)) return cudaErrorInvalidValue;
  return run_seam(g, z, static_cast<const float*>(td), x,
                  static_cast<const float*>(tx), wt,
                  static_cast<float*>(edge), static_cast<float*>(sums),
                  static_cast<float*>(part), n, h, w, c, gh, ct, resident,
                  stages, grid, static_cast<cudaStream_t>(stream));
}

// ghost_conv_fwd in float32: x (n,h,w,ci), wt (co, ks*ks*ci), y (n,h,w,co)
// f32; wsplit (2, co, ks*ks*ci) f32 scratch for the weight's TF32 split;
// tab, stats and ws as ghost_conv_fwd's. The plan (ops/conv.py
// tma_staged_fwd_plan with gh and 4-byte elements: wb, hb, bn, resident,
// stages, grid, eslots, overlap; hb divides gh). Returns the first launch
// error.
extern "C" int ghost_conv_fwd_f32(const void* x, const void* tab,
                                  const void* wt, void* wsplit, void* y,
                                  void* stats, void* ws, int n, int h, int w,
                                  int ci, int co, int ks, int gh, int wb,
                                  int hb, int bn, int resident, int stages,
                                  int grid, int eslots, int overlap,
                                  void* stream) {
  if (bad_geometry(n, h, w, gh, ci, co) || (ks != 1 && ks != 3) ||
      (long long)n * h * w * (ci > co ? ci : co) >= (1ll << 31))
    return cudaErrorInvalidValue;
  bwd::DxArgs a{};
  a.out = y;
  a.out_kind = 4;
  // tdx_f32's columns are the conv's output channels, its K the input's
  return bwd::run_dx_f32(x, nullptr, wt, static_cast<float*>(wsplit),
                         nullptr, a, static_cast<float*>(ws),
                         static_cast<float*>(stats), n, h, w, co, ci, ks,
                         bwd::DxPlan{wb, hb, bn, resident, stages, grid,
                                     eslots, overlap},
                         bwd::BandActTr32{static_cast<const float*>(tab), ci,
                                          gh * w},
                         static_cast<cudaStream_t>(stream), gh);
}

// ghost_conv_bwd in float32: x, g, z, wflip, addend and dx f32 (shapes as
// ghost_conv_bwd's; dx f32 for every out_kind, the addend f32 (add_kind 2)
// or none (0)); wsplit (2, ci, ks*ks*co) f32 scratch for wflip's TF32
// split. The plans (ops/conv.py): dW tma_dw_plan with g's f32 aux boxes
// and 4-byte elements (wb, hb, bn, two, stages, splits, cs), dX
// tma_bwd_dx_plan with gh and 4-byte elements (xwb, xhb, xbn, resident,
// xstages, grid, eslots, overlap; ws_sums one (2, ci) entry a row tile
// with out_kind 0); the dW's box height hb divides gh (its tiles are keyed by
// one band each: ops/conv.py tma_dw_plan's gh), `run` (1, 2 or 4;
// ops/conv.py DW32_RUN) k8 steps a fresh accumulator. Returns the first
// launch error.
extern "C" int ghost_conv_bwd_f32(const void* x, const void* tx,
                                  const void* g, const void* z,
                                  const void* td, const void* edge,
                                  const void* wflip, void* wsplit, void* dx,
                                  void* sums, void* dw, const void* addend,
                                  void* ws_dw, void* ws_sums, int add_kind,
                                  int out_kind, int n, int h, int w, int ci,
                                  int co, int ks, int gh, int wb, int hb,
                                  int bn, int two, int stages, int splits,
                                  int cs, int xwb, int xhb, int xbn,
                                  int resident, int xstages, int grid,
                                  int eslots, int overlap, int run,
                                  void* stream) {
  if (bad_geometry(n, h, w, gh, ci, co) || (ks != 1 && ks != 3) ||
      hb < 1 || gh % hb || out_kind < 0 || out_kind > 2 ||
      (out_kind == 0 && (!tx || !sums || !ws_sums)) ||
      (add_kind != 0 && add_kind != 2) || (add_kind != 0 && !addend) ||
      !td || (long long)n * h * w * (ci > co ? ci : co) >= (1ll << 31))
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const GhostTr32 tr{static_cast<const float*>(tx),
                     static_cast<const float*>(td),
                     static_cast<const float*>(edge), ci, co, gh * w, w};
  int err = bwd::run_dw_f32(x, z, g, static_cast<float*>(dw),
                            static_cast<float*>(ws_dw), n, h, w, ci, co, ks,
                            bwd::DwPlan{wb, hb, bn, two, stages, splits, cs},
                            tr, run, s);
  if (err != cudaSuccess) return err;
  bwd::DxArgs a{};
  a.out = dx;
  a.addend = addend;
  a.add_kind = add_kind;
  a.out_kind = out_kind;
  a.band_px = ks == 3 ? gh * w : 0;
  // the epilogue's input: x for gm, the addend for dX + addend
  return bwd::run_dx_f32(z, g, wflip, static_cast<float*>(wsplit),
                         out_kind == 0 ? x : addend, a,
                         static_cast<float*>(ws_sums),
                         static_cast<float*>(sums), n, h, w, ci, co, ks,
                         bwd::DxPlan{xwb, xhb, xbn, resident, xstages, grid,
                                     eslots, overlap},
                         tr, s, gh);
}

// ghost_boundary in float32: dout, z, sc and out (n,h,w,c) f32 (4 channels
// a 16-byte vector, c a multiple of 64), the rest as ghost_boundary's.
// Returns the launch error.
extern "C" int ghost_boundary_f32(const void* dout, const void* z,
                                  const void* t, const void* sc,
                                  const void* ts, void* out, void* sums,
                                  int n, int h, int w, int c, int gh,
                                  void* stream) {
  if (bad_geometry(n, h, w, gh, c, c) || (dout && !sums))
    return cudaErrorInvalidValue;
  dim3 grid(n * (h / gh), c / 64);
  gboundary32<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dout), static_cast<const float*>(z),
      static_cast<const float*>(t), static_cast<const float*>(sc),
      static_cast<const float*>(ts), static_cast<float*>(out),
      static_cast<float*>(sums), gh * w, c);
  return cudaGetLastError();
}

// ghost_seam_bwd in float32: g, z, x (n,h,w,c) and w (c, c, 3, 3) f32 (the
// 3x3 weight as PyTorch holds it), wsplit (2, c, 9c) f32 scratch for its
// layout and TF32 split; td, tx, edge, sums and part as ghost_seam_bwd's.
// The plan (ops/ghost.py seam_plan with 4-byte elements): resident,
// stages, grid (64-column tiles). c a multiple of 64. Returns the first
// launch error.
extern "C" int ghost_seam_bwd_f32(const void* g, const void* z,
                                  const void* td, const void* x,
                                  const void* tx, const void* w,
                                  void* wsplit, void* edge, void* sums,
                                  void* part, int n, int h, int wd, int c,
                                  int gh, int resident, int stages,
                                  int grid, void* stream) {
  if (bad_geometry(n, h, wd, gh, c, c) || !td || !tx)
    return cudaErrorInvalidValue;
  return run_seam32(static_cast<const float*>(g),
                    static_cast<const float*>(z),
                    static_cast<const float*>(td),
                    static_cast<const float*>(x),
                    static_cast<const float*>(tx),
                    static_cast<const float*>(w),
                    static_cast<float*>(wsplit), static_cast<float*>(edge),
                    static_cast<float*>(sums), static_cast<float*>(part), n,
                    h, wd, c, gh, resident, stages, grid,
                    static_cast<cudaStream_t>(stream));
}

// tdx_f32's registers a thread and local (spill) bytes into the two ints
// at out: the forward's instantiation (BandActTr32) where fwd, else the
// dX's (GhostTr32), at bn (64 or 128) and overlap (0 or 1). Returns the
// query's error.
extern "C" int ghost_tdx32_attrs(int fwd, int bn, int overlap, void* out) {
  int* o = static_cast<int*>(out);
  return fwd ? bwd::dx32_attrs<bwd::BandActTr32>(bn, overlap, o)
             : bwd::dx32_attrs<GhostTr32>(bn, overlap, o);
}
