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
// The seam pass (ghost_seam_bwd): the implicit-GEMM core and loaders of
// igemm.cuh (CTA of 8 warps, 128 x BN tiles, BK = 32, mma.sync m16n8k16
// bf16, f32 accumulate, the next slice's loads in flight), with its banded
// transform BandDz; channel counts multiples of 64. Its band sums: where
// a CTA's 128 rows lie in one band, warp shuffles, a shared table and one
// f32 atomic per column and CTA; where only a warp's rows do, one per
// column and warp; otherwise one per element.
// The conv backward (ghost_conv_bwd): two launches on conv_bwd.cuh's
// TMA/wgmma cores with GhostTr as the staging transform (x -> relu(x*a +
// b) under the band of the output pixel, z and g -> dz under the band of
// the pixel read, plus the seam term): dW (tdw) split over clusters
// reduced in rank order, dX (tdx) with a masked epilogue whose band sums
// take one entry a 128-pixel tile (a tile lies in one band: its box height
// divides gh) added in tile order by reduce_parts. No atomics: two
// launches are bit-equal. One pass per band (a cluster with distributed
// shared memory) is later work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "conv_bwd.cuh"
#include "igemm.cuh"

namespace {

using namespace igemm;

constexpr int BM = 128;

// Per-band column sums [sum v0, sum v1] of a product's rows, added to
// tab (bands, 2, cols) with band = row / px (see the header).
template <int BN>
struct BandSums {
  using W = Warps<BM, BN>;
  float p0[W::NT][2], p1[W::NT][2];
  float* tab;
  int cols, px, level, band;  // level 0: the CTA's rows in one band;
                              // 1: the warp's; 2: neither; 3: no rows

  __device__ BandSums(float* tab_, int cols_, int px_, int m0, int rows)
      : tab(tab_), cols(cols_), px(px_) {
#pragma unroll
    for (int j = 0; j < W::NT; ++j)
      p0[j][0] = p0[j][1] = p1[j][0] = p1[j][1] = 0.f;
    const int wm = threadIdx.x / 32 / W::WN;
    const int lo = m0 + wm * (BM / W::WM);
    const int hi = min(lo + BM / W::WM, rows) - 1;
    const int last = min(m0 + BM, rows) - 1;
    if (m0 / px == last / px) {
      level = 0;
      band = m0 / px;
    } else if (lo > hi) {
      level = 3;
    } else if (lo / px == hi / px) {
      level = 1;
      band = lo / px;
    } else {
      level = 2;
    }
  }

  // entry (j, column parity e) at row m, global column col
  __device__ __forceinline__ void add(int j, int e, int m, int col, float v0,
                                      float v1) {
    if (level == 2) {
      float* t = tab + (size_t)(m / px) * 2 * cols + col;
      atomicAdd(t, v0);
      atomicAdd(t + cols, v1);
    } else {
      p0[j][e] += v0;
      p1[j][e] += v1;
    }
  }

  // red: the CTA's shared [2][128] table, zeroed before the main loop.
  __device__ __forceinline__ void flush(float (*red)[128], int n0) {
    if (level == 0) {
      reduce_cols<BM, BN>(p0, p1, red);
      __syncthreads();
      float* t = tab + (size_t)band * 2 * cols + n0;
      for (int c = threadIdx.x; c < BN; c += THREADS) {
        atomicAdd(t + c, red[0][c]);
        atomicAdd(t + cols + c, red[1][c]);
      }
      return;
    }
    if (level != 1) return;
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int j = 0; j < W::NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          p0[j][e] += __shfl_xor_sync(0xffffffffu, p0[j][e], off);
          p1[j][e] += __shfl_xor_sync(0xffffffffu, p1[j][e], off);
        }
        if (lane < 4) {
          int r, c;
          acc_pos<BM, BN>(0, j, e, r, c);
          float* t = tab + (size_t)band * 2 * cols + n0 + c;
          atomicAdd(t, p0[j][e]);
          atomicAdd(t + cols, p1[j][e]);
        }
      }
  }
};

__device__ __forceinline__ void zero_red(float (*red)[128]) {
  for (int i = threadIdx.x; i < 2 * 128; i += THREADS) red[i / 128][i % 128] = 0.f;
}

// out = bf16(relu(z*a + b + (sc*as + bs, or sc))); with dout: gm =
// dout*[pre > 0] into out, and sums (bands, 3, c) [sum gm*z, sum gm,
// sum gm*sc]. Grid (bands, c / (8*cvb)): a block owns a band's rows for
// 8*cvb channels, so its sums are written, not added.
__global__ void __launch_bounds__(256)
gboundary(const bf16* __restrict__ dout, const bf16* __restrict__ z,
          const float* __restrict__ t, const bf16* __restrict__ sc,
          const float* __restrict__ ts, bf16* __restrict__ out,
          float* __restrict__ sums, int band_px, int c, int cvb) {
  __shared__ float red[3][256];
  const int band = blockIdx.x, rows = blockDim.x / cvb;
  const int rsub = threadIdx.x / cvb;
  const int cb = blockIdx.y * cvb * 8, ch0 = cb + (threadIdx.x % cvb) * 8;
  for (int i = threadIdx.x; i < 3 * 256; i += blockDim.x) red[i / 256][i % 256] = 0.f;
  __syncthreads();
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
  const int lc = ch0 - cb;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    atomicAdd(&red[0][lc + i], sz[i]);
    atomicAdd(&red[1][lc + i], sg[i]);
    atomicAdd(&red[2][lc + i], ss[i]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 3 * cvb * 8; i += blockDim.x) {
    const int k = i / (cvb * 8), cc = i % (cvb * 8);
    sums[((size_t)band * 3 + k) * c + cb + cc] = red[k][cc];
  }
}

// --------------------------------------------------------------- backward

// The A operand of the seam product: row s = (band, w) of one side (0:
// the halo row above the band, read by the band's first row; 1: below,
// read by its last row); K = (kx, channel) over 3*ch: dz of the band's
// edge row at column w + kx - 1. Zero past the image's edges.
template <class X, int ROWS>
struct SeamRows {
  static constexpr int VECS = ROWS * BK / 8;
  static constexpr int V = (VECS + THREADS - 1) / THREADS;
  X x;
  Geo g;
  int ch, m0, side, gh, nb;
  typename X::Reg v[V];

  __device__ __forceinline__ void fetch(int kt) {
    const int k = kt * BK + (threadIdx.x % (BK / 8)) * 8;
    const int kx = k / ch, c = k - kx * ch;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      int idx = threadIdx.x + i * THREADS;
      if (idx >= VECS) break;
      const int s = m0 + idx / (BK / 8);
      int pix = -1;
      if (s < g.n * nb * g.w) {
        const int band = s / g.w, j = band % nb, ww = s % g.w + kx - 1;
        if ((side == 0 ? j > 0 : j < nb - 1) && ww >= 0 && ww < g.w)
          pix = ((band / nb) * g.h + j * gh + (side == 0 ? 0 : gh - 1)) * g.w + ww;
      }
      fetch_one(x, v[i], pix, ch, c, pix);
    }
  }
  __device__ __forceinline__ void store(bf16 (*s)[LDS]) const {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      int idx = threadIdx.x + i * THREADS;
      if (idx >= VECS) break;
      *reinterpret_cast<uint4*>(&s[idx / (BK / 8)][(idx % (BK / 8)) * 8]) =
          x.value(v[i]);
    }
  }
};

// Halo rows of each band's 3x3 backward (grid z = side): gm = (dz row .
// Wflip[ky]) * [x*a1 + b1 > 0] with the reading band's (a1, b1), added to
// its sums (bands, 2, c); gm*a1 to edge (bands, 2, W, c) of the row's own
// band (slot 1: its last row, above the reading band; slot 0: its first).
template <int BN>
__global__ void __launch_bounds__(THREADS)
gseam(const float* __restrict__ gg, const bf16* __restrict__ z,
      const float* __restrict__ td, const bf16* __restrict__ x,
      const float* __restrict__ tx, const bf16* __restrict__ wflip,
      float* __restrict__ edge, float* __restrict__ sums, Geo g, int c,
      int gh) {
  using W = Warps<BM, BN>;
  __shared__ __align__(16) bf16 sA[BM][LDS];
  __shared__ __align__(16) bf16 sB[BN][LDS];
  __shared__ float red[2][128];
  const int side = blockIdx.z, nb = g.h / gh, band_px = gh * g.w;
  const int rows = g.n * nb * g.w;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  zero_red(red);

  SeamRows<BandDz<float>, BM> la{{gg, z, td, nullptr, c, band_px, g.w}, g, c,
                                 m0, side, gh, nb};
  // the flipped kernel's ky row: 2 for the row above, 0 for the row below
  PixelRows<1, Ident, BN> lb{{wflip + (side == 0 ? 2 : 0) * 3 * c},
                             Geo{1, 1, c, c}, 9 * c, n0, true};
  float acc[W::MT][W::NT][4] = {};
  mainloop<BM, BN>(la, lb, 3 * c / BK, sA, sB, acc);

  BandSums<BN> bs(sums, c, g.w, m0, rows);
#pragma unroll
  for (int i = 0; i < W::MT; ++i)
#pragma unroll
    for (int j = 0; j < W::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        int r, cc;
        acc_pos<BM, BN>(i, j, e, r, cc);
        const int s = m0 + r, col = n0 + cc;
        if (s >= rows) continue;
        const int band = s / g.w, jb = band % nb, w = s % g.w;
        if (side == 0 ? jb == 0 : jb == nb - 1) continue;
        const int q = (band / nb) * g.h + (side == 0 ? jb * gh - 1 : jb * gh + gh);
        const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            x + ((size_t)q * g.w + w) * c + col));
        const float* t = tx + (size_t)band * 2 * c + col;
        const float gu = affine(xv.x, t[0], t[c]) > 0.f ? acc[i][j][e] : 0.f;
        const float gv = affine(xv.y, t[1], t[c + 1]) > 0.f ? acc[i][j][e + 1] : 0.f;
        bs.add(j, 0, s, col, gu * xv.x, gu);
        bs.add(j, 1, s, col + 1, gv * xv.y, gv);
        const int own = side == 0 ? band - 1 : band + 1, slot = side == 0 ? 1 : 0;
        *reinterpret_cast<float2*>(edge + (((size_t)own * 2 + slot) * g.w + w) * c + col) =
            make_float2(gu * t[0], gv * t[1]);
      }
  bs.flush(red, n0);
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
// (a1, b1); wflip (c, 9c) bf16. Out: edge (bands,2,w,c) and sums
// (bands,2,c) f32, zeroed by the caller. Returns the launch error.
extern "C" int ghost_seam_bwd(const void* g, const void* z, const void* td,
                              const void* x, const void* tx, const void* wflip,
                              void* edge, void* sums, int n, int h, int w,
                              int c, int gh, void* stream) {
  if (bad_geometry(n, h, w, gh, c, c)) return cudaErrorInvalidValue;
  Geo geo{n, h, w, n * h * w};
  const int rows = n * (h / gh) * w;
  dim3 grid((rows + BM - 1) / BM, c % 128 == 0 ? c / 128 : c / 64, 2);
  auto s = static_cast<cudaStream_t>(stream);
  auto args = [&](auto kernel) {
    kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(g), static_cast<const bf16*>(z),
        static_cast<const float*>(td), static_cast<const bf16*>(x),
        static_cast<const float*>(tx), static_cast<const bf16*>(wflip),
        static_cast<float*>(edge), static_cast<float*>(sums), geo, c, gh);
  };
  if (c % 128 == 0)
    args(gseam<128>);
  else
    args(gseam<64>);
  return cudaGetLastError();
}
