// The staged conv products on Hopper (sm_90a): TMA loads, an elementwise
// rewrite of each tile in shared memory, wgmma, and reductions in a fixed
// order. fused_conv.cu (the fused conv+BN+relu, forward and backward) and
// ghost_unit.cu (the ghost-BN unit's convs, forward and backward)
// instantiate it with their transforms; conv_dw.cu runs tdw with none.
//
// Contract of one conv (NHWC, n images of h x w; a 1x1 may pass its rows
// as n = h = 1, w = M; ci, co multiples of 64):
//   T_x(x)    the conv's activated input: relu(x*a + b) (per channel, or
//             per band of the OUTPUT pixel), or x as it is;
//   forward   y = bf16(im2col(T_x(x)) . W^T) (tdx in its forward mode,
//             out_kind 4, with ActTr: A = T_x(x), B = W) and the column
//             sums [sum v, sum v^2] with v the f32 accumulator (fused:
//             pallas_fused.py:100-110) or the rounded y, per band (ghost:
//             pallas_unit.py:60-64 _band_stats);
//   T_dy      the output gradient, staged from two tensors: dy_eff = dy
//             + ds0 + 2*y*ds1 (fused) or dz = g*a + c1 + 2*z*c2 (+ the
//             seam term on a band's edge rows) under the table of the
//             band of the pixel read (ghost); rounded to bf16;
//   dW = im2col(T_x(x))^T . T_dy  (tdw; rows (tap, ci), f32),
//   dX = T_dy * Wflip             (tdx; the flipped kernel), finished in
//        the epilogue (see DxArgs::out_kind).
//
// What it must get right: TMA's zero fill gives x = 0 and dy = y = 0 (g =
// z = 0) outside the image, but relu(0*a + b) = relu(b) and dy_eff =
// ds0 are not zero. So the transform zeroes every element whose source
// pixel lies outside the image (a pad tap of a 3x3, the ragged edge of a
// tile, rows past M), the tensor-level zero pad of the plain versions
// (pallas_fused.py _zero_halo_rows, and :219-220). A ghost 3x3's dX also
// zeroes the rows of a shifted box that lie in another band than the
// output row (the 3x3 dX reads only its own band's dz; the seam rows are
// ghost_seam_bwd's), and a ghost T_x takes the (a, b) of the band of the
// output pixel, which for a halo row is the reading band, not the row's
// own. The ghost FORWARD's 3x3 reads its halo rows from the neighbouring
// band, under the output band's affine, and zeroes none of them: only
// taps outside the image are zero.
//
// dW (tdw), also conv_dw.cu's plain dW (an identity transform compiles
// the rewrite out). A CTA of three warpgroups owns one or two 64-row
// chunks (64 channels of one tap) by BN columns over a contiguous range of
// 64-pixel tiles. The producer thread issues TMA loads into a ring: the X
// box of each chunk shifted by its tap, and for each 64 columns the raw dY
// box (dy or z, bf16, 128-byte swizzled) and its aux box (y or g: bf16
// swizzled the same, or f32 unswizzled, 256-byte rows). After a slot's
// full barrier the 256 consumer threads rewrite it in place: X through
// T_x, and T_dy into the dY box; each 16-byte chunk of a box is one
// thread's (a thread keeps one 8-channel column of every box, and its
// tables in registers while the band holds; both warpgroups share the
// work of the common dY boxes), then fence.proxy.async and a named
// barrier over both warpgroups before either issues wgmma (MN-major
// operands). The rewrite of slot i overlaps the products of slot i - 1,
// which are still in flight. The pixel tiles are split (ops/conv.py: in
// waves that fill the SMs) over clusters of <= 2 CTAs reduced through
// distributed shared memory in rank order, the clusters' tables summed
// by sum_tables in cluster order: no atomics, two launches are bit-equal.
//
// dX and the forward (tdx), on conv_fwd.cu's pattern. Persistent CTAs
// walk 128-pixel x BN tiles, each CTA a contiguous range of pixel tiles in
// one column (the grid is a multiple of the column tiles); a K step is a
// tap x 64 contracted channels, its slot the A box shifted by the tap (dy
// or z; x in the forward), its aux box (none in the forward) and the
// weight box unless the weight is resident. The backward's warpgroups
// rewrite their 64 rows of the A box in shared memory through T_dy
// (d_tab/dy); the forward's load theirs by ldmatrix into wgmma's register
// A fragment and apply T_x there (ActTr::ab2/act2: no store, no proxy
// fence and no barrier a step; an identity T_x reads the box as it is). A
// 3x3 whose box is a 64- or 128-pixel row segment takes halo mode
// (dx_halo: one box a ky rewritten once in shared memory, by either
// direction's transform, for three taps). Then wgmma m64nBNk16, K-major
// operands. The epilogue's bf16 input (x, or the addend) arrives by TMA in
// an epilogue slot that the bf16 output (dx, do, or the forward's y) then
// overwrites and a second producer thread stores by TMA, so neither waits
// on the ring; f32 outputs go from the fragment. The column sums are
// reduced in a fixed order (shuffles, then the 8 warps in order) into one
// partial entry a tile (the ghost dX: band sums, a tile lies in one band),
// a run of a CTA's tiles in one band (the ghost forward: kept in registers
// over the run, zero entries at its other tiles) or a CTA (fused: kept in
// registers over its tiles), and reduce_parts adds the entries in order.
// No atomics: bit-equal twice.
//
// Float32 (the fused transforms, and the ghost unit's banded ones):
// tdx_f32 (the forward and dX, each A value put through the transform in
// registers and split into TF32 hi and lo there, wgmma.cuh WgmmaTf32R; each
// product's fragment prepared while the previous product's wgmmas run, BN
// 128 where the columns allow, a 1x1's weight resident where it fits; the
// column sums reduced a tile at a time) and
// the dW tdw_f32_tr (TF32 wgmma: T_x(X)^T as the register A fragment, each
// value through T_x before its split; T_dy formed as the consumers
// transpose dY and its aux box once a stage into K-major hi and lo tiles;
// no rewrite of a stage in place); the operands f32, the products float32
// by split TF32, the tables and sums added in double (sum_tables_wide,
// reduce_parts_wide; reduce_groups_wide by band). A banded transform
// (Tr::kBanded: ghost_unit.cu GhostTr32, BandActTr32 below) takes its
// tables by band and its sums per band, through `if constexpr` branches
// that leave the fused instantiations' machine code as it was. The
// float32 dW without a transform (conv_dw.cu, the PALLAS_CONVS route) is
// tdw_f32_wg, the same body with every step of the transform compiled
// out.

#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

#include "igemm.cuh"
#include "wgmma.cuh"

namespace bwd {

using namespace hop;
using igemm::affine;
using igemm::load8f;
using igemm::pack8;
using igemm::unpack8;
using bf16 = __nv_bfloat16;

constexpr int KP = 64;           // dW: pixels a tile (four k16 steps)
constexpr int BOX = KP * 128;    // dW: bytes of a 64-channel bf16 box
constexpr int TM = 128;          // dX: pixels a tile
constexpr int ABOX = TM * 128;   // dX: bytes of the A box
constexpr int THREADS = 384;     // two consumer warpgroups, one producer
constexpr int CONSUMERS = 256;
constexpr int MAX_SMEM = 232448;

// 8 aux values (channels 8 jc .. 8 jc + 7 of box row r) of a bf16 box
// stored as the main box (128-byte swizzle: the same offset `off`), or of
// an f32 box of 256-byte unswizzled rows.
template <class A>
__device__ __forceinline__ void aux8(const uint8_t* box, uint32_t off, int r,
                                     int jc, float f[8]) {
  if constexpr (sizeof(A) == 2) {
    unpack8(*reinterpret_cast<const uint4*>(box + off), f);
  } else {
    const float4* p = reinterpret_cast<const float4*>(box + r * 256 + jc * 32);
    const float4 u = p[0], v = p[1];
    f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
    f[4] = v.x; f[5] = v.y; f[6] = v.z; f[7] = v.w;
  }
}

// The 16-byte chunk jc of row r of a 128-byte-swizzled tile.
__device__ __forceinline__ uint32_t chunk_offset(int r, int jc) {
  return r * 128 + (((jc ^ r) & 7) << 4);
}

// A transform Tr (FusedTr, GhostTr) gives, for the 8 channels c .. c+7
// of a thread's chunk:
//   Aux, kAux           the aux tensor's element type (bf16 or float)
//                       and its bytes; kAux = 0: no aux tensor and no
//                       rewrite (conv_dw.cu's plain dW, IdentTr);
//   key(pix)            which tables pixel pix reads (its band; 0: one
//                       set for every pixel);
//   x_tab(XT&, key, c)  loads T_x's tables, x(v, XT) applies them;
//   d_tab(DT&, key, c)  loads T_dy's tables, dy(d, aux, DT, pix, c)
//                       applies them to the raw d and aux at pixel pix;
//   ab_row(key)         the mask's a (b at + ci) of the dX epilogue;
//   x_on()              false: x enters as it is;
//   kPerCta             the dX sums are the whole tensor's (one entry a
//                       CTA, kept in registers over its tiles), else a
//                       band's (one entry a tile);
//   kBandRuns           (with !kPerCta) a band's sums kept in registers
//                       over a run of the CTA's tiles in that band, the
//                       run's entry at its last tile, zero at the others;
//   kFwd                false: a backward transform. A forward one
//                       (ActTr) is tdx's alone: kAux = 0, d_tab/dy stage
//                       a halo box of x through T_x, ab2/act2 the register
//                       fragment of the other K steps, x_on() false skips
//                       both, kRoundedSums picks the value summed.
// The kernels keep a thread's tables in registers while the key holds.

// ------------------------------------------------------------------- dW

struct DwArgs {
  float* out;      // the table (KS*KS*ci, co), or the clusters' tables
  int h, w;        // image geometry (a 1x1's rows: 1, M)
  int ci, co, ks;
  int wb, hb;      // the pixel box
  int tiles_w, tiles_h, ntiles;
  int cchunks;     // 64-channel chunks of ci
  int rchunks;     // row chunks of the table, ks*ks*cchunks
  int stages, splits, cs;
};

template <class Tr>
constexpr int dw_stage_bytes(int bn, bool two) {
  return ((two ? 2 : 1) + bn / 64) * BOX + bn / 64 * KP * 64 * Tr::kAux;
}

template <int BN, bool TWO, class Tr>
__global__ void __launch_bounds__(THREADS, 1)
tdw(const __grid_constant__ CUtensorMap mx,
    const __grid_constant__ CUtensorMap mdy,
    const __grid_constant__ CUtensorMap maux, const DwArgs a, const Tr tr) {
  using Aux = typename Tr::Aux;
  constexpr int NB = BN / 64;                // dY boxes a stage
  constexpr int IN = BN >= 128 ? 128 : 64;   // columns of one wgmma
  constexpr int NI = BN / IN;                // wgmmas a k16 step
  constexpr int LDR = BN + 8;                // floats a parked row
  constexpr int NA = TWO ? 2 : 1;            // X boxes a stage
  constexpr int KSTEPS = TWO ? KP / 16 : KP / 32;  // k16 steps a warpgroup
  constexpr int AUXBOX = KP * 64 * Tr::kAux;
  constexpr int STAGE = (NA + NB) * BOX + NB * AUXBOX;
  constexpr bool STAGED = Tr::kAux > 0;  // else the operands go as they come
  extern __shared__ uint8_t raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + a.stages * STAGE);
  uint64_t* empty = full + a.stages;

  // the warpgroup's role, warp-uniform to the compiler: a role branch it
  // sees as divergent makes it serialise the wgmmas
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int tid = threadIdx.x % 128;
  const long long t0 = (long long)blockIdx.z * a.ntiles / a.splits;
  const int nt =
      (int)((long long)(blockIdx.z + 1) * a.ntiles / a.splits - t0);
  const int co0 = blockIdx.y * BN;
  const int half = a.ks / 2;
  // the chunk of warpgroup slot j; an odd last chunk is loaded twice and
  // its duplicate not stored
  auto chunk_of = [&](int j) {
    return TWO ? min(2 * (int)blockIdx.x + j, a.rchunks - 1) : 0;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < a.stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 2);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------------------ producer
    regs_shrink<40>();
    if (tid == 0) {
      prefetch_map(&mx);
      prefetch_map(&mdy);
      if (STAGED) prefetch_map(&maux);
      for (int i = 0; i < nt; ++i) {
        const int st = i % a.stages;
        mbar_wait(&empty[st], ((i / a.stages) & 1) ^ 1);
        uint8_t* buf = smem + st * STAGE;
        mbar_expect_tx(&full[st], STAGE);
        int t = (int)t0 + i;
        const int w0 = (t % a.tiles_w) * a.wb;
        t /= a.tiles_w;
        const int h0 = (t % a.tiles_h) * a.hb, img = t / a.tiles_h;
        for (int j = 0; j < NA; ++j) {
          const int c = chunk_of(j), tap = c / a.cchunks;
          tma_load_4d(buf + j * BOX, &mx, &full[st], (c % a.cchunks) * 64,
                      w0 + tap % a.ks - half, h0 + tap / a.ks - half, img);
        }
        for (int j = 0; j < NB; ++j) {
          tma_load_4d(buf + (NA + j) * BOX, &mdy, &full[st], co0 + 64 * j,
                      w0, h0, img);
          if (STAGED)
            tma_load_4d(buf + (NA + NB) * BOX + j * AUXBOX, &maux, &full[st],
                        co0 + 64 * j, w0, h0, img);
        }
      }
    }
    __syncwarp();
    cluster_sync();  // the accumulators are parked
    cluster_sync();  // every rank has read them
  } else {
    // ----------------------------------------------------------- consumers
    regs_grow<232>();
    float acc[NI][IN / 2];
#pragma unroll
    for (int ii = 0; ii < NI; ++ii)
#pragma unroll
      for (int e = 0; e < IN / 2; ++e) acc[ii][e] = 0.f;
    // the k16 steps of each tile that this warpgroup takes: all of them,
    // or its half where both warpgroups own the one chunk
    const uint64_t k0 = TWO ? 0 : (wg * KSTEPS * 16 * 128) >> 4;
    const int aslot = TWO ? wg : 0;
    // the staging rewrite: consumer thread ct keeps the 8-channel column
    // jc of every box, rows ct / 8 and ct / 8 + 32; its tables (of those
    // channels, of the band of the row's pixel) stay in registers until
    // the band changes
    const int ct = threadIdx.x, jc = ct % 8;
    const bool xon = tr.x_on();
    typename Tr::XT xt[NA];
    typename Tr::DT dt[NB];
    int tkey = -1;
    int prev = -1;
    for (int i = 0; i < nt; ++i) {
      const int st = i % a.stages;
      int t = (int)t0 + i;
      const int w0 = (t % a.tiles_w) * a.wb;
      t /= a.tiles_w;
      const int h0 = (t % a.tiles_h) * a.hb, img = t / a.tiles_h;
      mbar_wait(&full[st], (i / a.stages) & 1);
      uint8_t* buf = smem + st * STAGE;
      if constexpr (STAGED) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int r = ct / 8 + 32 * q;
          const int ow = w0 + r % a.wb, oh = h0 + r / a.wb;
          const bool in = ow < a.w && oh < a.h;
          const int pix = (img * a.h + oh) * a.w + ow;  // the output pixel
          const uint32_t off = chunk_offset(r, jc);
          if (in && tr.key(pix) != tkey) {
            tkey = tr.key(pix);
#pragma unroll
            for (int j = 0; j < NA; ++j)
              if (xon) tr.x_tab(xt[j], tkey, (chunk_of(j) % a.cchunks) * 64 + 8 * jc);
#pragma unroll
            for (int j = 0; j < NB; ++j)
              tr.d_tab(dt[j], tkey, co0 + 64 * j + 8 * jc);
          }
          // the raw chunks first, then the rewrite: their loads in flight
          // together
          uint4 xr[NA], dr[NB];
          float ax[NB][8];
#pragma unroll
          for (int j = 0; j < NA; ++j)
            if (xon) xr[j] = *reinterpret_cast<const uint4*>(buf + j * BOX + off);
#pragma unroll
          for (int j = 0; j < NB; ++j) {
            dr[j] = *reinterpret_cast<const uint4*>(buf + (NA + j) * BOX + off);
            aux8<Aux>(buf + (NA + NB) * BOX + j * AUXBOX, off, r, jc, ax[j]);
          }
          if (xon) {
#pragma unroll
            for (int j = 0; j < NA; ++j) {
              const int tap = chunk_of(j) / a.cchunks;
              const int sw = ow + tap % a.ks - half, sh = oh + tap / a.ks - half;
              uint4 v = make_uint4(0, 0, 0, 0);  // the pad: zero after T_x
              if (in && sw >= 0 && sw < a.w && sh >= 0 && sh < a.h) {
                float f[8];
                unpack8(xr[j], f);
                tr.x(f, xt[j]);
                v = pack8(f);
              }
              *reinterpret_cast<uint4*>(buf + j * BOX + off) = v;
            }
          }
#pragma unroll
          for (int j = 0; j < NB; ++j) {
            uint4 v = make_uint4(0, 0, 0, 0);
            if (in) {
              float d[8];
              unpack8(dr[j], d);
              tr.dy(d, ax[j], dt[j], pix, co0 + 64 * j + 8 * jc);
              v = pack8(d);
            }
            *reinterpret_cast<uint4*>(buf + (NA + j) * BOX + off) = v;
          }
        }
        fence_async_smem();
        bar_sync(1, CONSUMERS);
      }

      const uint64_t da = sw128_desc(buf + aslot * BOX, BOX, 1024) + k0;
      const uint64_t db = sw128_desc(buf + NA * BOX, BOX, 1024) + k0;
      wgmma_fence();
#pragma unroll
      for (int ii = 0; ii < NI; ++ii) fence_operands(acc[ii]);
#pragma unroll
      for (int k = 0; k < KSTEPS; ++k) {
        const uint64_t dk = (k * 16 * 128) >> 4;
#pragma unroll
        for (int ii = 0; ii < NI; ++ii)
          Wgmma<IN>::mma(acc[ii], da + dk,
                         db + dk + ((ii * (IN / 64) * BOX) >> 4));
      }
      wgmma_commit();
#pragma unroll
      for (int ii = 0; ii < NI; ++ii) fence_operands(acc[ii]);
      wgmma_wait<1>();
      if (prev >= 0 && tid == 0) mbar_arrive(&empty[prev]);
      prev = st;
    }
    wgmma_wait<0>();
#pragma unroll
    for (int ii = 0; ii < NI; ++ii) fence_operands(acc[ii]);

    // park the accumulators over the ring, once both warpgroups are done
    // reading it
    bar_sync(1, CONSUMERS);
    float* park = reinterpret_cast<float*>(smem) + wg * 64 * LDR;
    const int warp = tid / 32, lane = tid % 32;
#pragma unroll
    for (int ii = 0; ii < NI; ++ii)
#pragma unroll
      for (int j = 0; j < IN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = 16 * warp + lane / 4 + 8 * e;
          const int col = ii * IN + 8 * j + 2 * (lane % 4);
          *reinterpret_cast<float2*>(park + row * LDR + col) =
              make_float2(acc[ii][4 * j + 2 * e], acc[ii][4 * j + 2 * e + 1]);
        }
    cluster_sync();

    // rank r sums and writes rows [r, r+1) * rows/cs of the tile
    const int share = 64 * NA / a.cs;
    const int rank = (int)cluster_rank();
    float* out = a.out + (size_t)(blockIdx.z / a.cs) *
                             ((size_t)a.ks * a.ks * a.ci * a.co);
    const float* base = reinterpret_cast<const float*>(smem);
    for (int idx = threadIdx.x; idx < share * (BN / 4); idx += CONSUMERS) {
      const int r = rank * share + idx / (BN / 4), c = (idx % (BN / 4)) * 4;
      const int j = TWO ? r / 64 : 0, i = r % 64;
      if (TWO && 2 * (int)blockIdx.x + j >= a.rchunks) continue;
      const int ch = chunk_of(j);
      const int cin = (ch % a.cchunks) * 64 + i, n = co0 + c;
      if (cin >= a.ci || n >= a.co) continue;
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int q = 0; q < a.cs; ++q)
        for (int p = TWO ? j : 0; p <= (TWO ? j : 1); ++p) {
          const float4 v = ld_cluster_f4(base + (p * 64 + i) * LDR + c, q);
          sum.x += v.x;
          sum.y += v.y;
          sum.z += v.z;
          sum.w += v.w;
        }
      *reinterpret_cast<float4*>(
          out + ((size_t)(ch / a.cchunks) * a.ci + cin) * a.co + n) = sum;
    }
    cluster_sync();
  }
}

// dw[i] = the sum over the clusters' tables of part[t][i], in table order.
__global__ void sum_tables(const float* __restrict__ part,
                           float* __restrict__ dw, size_t size, int tables) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < size;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < tables; ++k) s += part[(size_t)k * size + i];
    dw[i] = s;
  }
}

// sum_tables for the float32 kernels: the same order, added in double and
// rounded once, so that the float32 product keeps its accuracy over up to
// 2 x 132 / 2 clusters' tables.
__global__ void sum_tables_wide(const float* __restrict__ part,
                                float* __restrict__ dw, size_t size,
                                int tables) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < size;
       i += (size_t)gridDim.x * blockDim.x) {
    double s = 0.0;
    for (int k = 0; k < tables; ++k) s += part[(size_t)k * size + i];
    dw[i] = (float)s;
  }
}

// ------------------------------------------------------------ dW, f32
//
// The float32 dW (x, dy f32; the table f32) on TF32 wgmma: tdw's split of
// the pixel tiles, ring, parking and rank-order cluster reduction, with
// each 64-channel chunk of X as two boxes of 32 f32 channels (128-byte
// rows, swizzled) and dY as BN / 32 such boxes. TF32 wgmma takes K-major
// operands only, and the boxes are pixel-major (the product contracts over
// pixels):
// - A is T_x(X)^T, the warpgroup's 64 channels by a k8 step's 8 pixels,
//   from registers (WgmmaTf32R): its A fragment has mma.sync's lanes, so
//   each warp reads its 16 rows (channels 16 warp + g and 16 warp + g + 8
//   of the chunk) from the swizzled X boxes, its loads ordered so that no
//   two lanes share a bank, puts each value through T_x and only then
//   splits it;
// - B is T_dy, BN columns by the k8 step's 8 pixels, K-major in shared
//   memory: once a stage the 256 consumer threads transpose the BN / 32
//   dY boxes into a TF32 hi and a lo tile (split_offset: two blocks of 32
//   pixels, BN rows of 128 bytes under the 128-byte swizzle, which the
//   bf16 K-major descriptors read), each value put through T_dy with its
//   aux value before the split; hi over the raw dY boxes and lo over the
//   aux boxes (or into a slot of its own, which no box fills, without a
//   transform) once every thread holds its raw values (a named barrier);
//   a thread takes 4 channels x 4 pixels at a time, four 16-byte loads of
//   each box and eight 16-byte stores, the 8 threads of a phase on 8
//   distinct chunks on either side (no bank conflicts). Both warpgroups
//   read the one copy.
// Three m64nBNk8 products a k8 step (lo.hi', hi.lo', hi.hi'); a run of R
// k8 steps goes to a fresh accumulator pass by pass (the small passes
// first, as conv_fwd_tma_f32's K step) and is then added to the f32 sum:
// the tensor cores truncate as they accumulate, so runs stay short (R:
// ops/conv.py DW32_RUN). One accumulator, waited for after each run, as
// in conv_fwd_tma_f32 (the other warpgroup's products fill the wait; the
// next run's A fragments load under this one): with two alternating
// under wgmma.wait_group 1, ptxas serialised every wgmma (C7514: it took
// the add of the retired accumulator for a read of one in flight).
// Without a transform the previous tile's last run stays in flight over
// the next tile's transpose; with one it is retired before it: in flight,
// its accumulator and fragments beside the transform's values pushed the
// BN 128 kernels past the 232 registers a consumer has (spills of 16-268
// bytes), and retired first the fused dW ran 7% faster and the ghost one
// as fast (H100, scripts/fused_f32_probe.py --split). No atomics, two
// launches are bit-equal; the clusters' tables are added by
// sum_tables_wide (in double).
//
// Two kernels share the body (dw32_body, which takes DwArgs by value: by
// reference it reordered 3 instructions of the route's one-chunk
// kernels): tdw_f32_wg without a transform (IdentTr32: conv_dw.cu
// conv_dw_tma_f32, the PALLAS_CONVS route's dw_rows and dw3) and
// tdw_f32_tr with a staging transform Tr and its f32 aux box (y or g:
// fused_conv.cu FusedTr32, ghost_unit.cu GhostTr32).
// Every step of the transform is an `if constexpr` branch, so tdw_f32_wg
// compiles as it did alone. T_x and T_dy run in float32 in the plain
// versions' order of rounding, and zero every value whose pixel lies
// outside the image: TMA's zero fill gives x = dy = aux = 0 there, but
// relu(0*a + b) and dy_eff = ds0 are not zero. T_x zeroes by a mask of
// the lane's pixels, set each tile from bounds on the tile's columns and
// rows under the warpgroup's tap (the pad taps, the ragged edge), T_dy on
// the ragged edge. T_x's (a, b) of the lane's two channels stay in
// registers, loaded where their key changes: the fused ones once, a
// banded transform's at each tile of another band; T_dy's of the
// thread's 4 BN / 64 columns ((ds0, ds1), or (a, c1, c2)) are read from
// L1 at each tile's transpose. A tile lies in one band (ghost_conv_bwd_f32
// takes boxes whose height divides the band's: ops/conv.py tma_dw_plan's
// gh), whose table T_x takes for the output pixel and T_dy for the pixel
// read (the same pixel: dY is not shifted); a banded T_dy adds the seam
// term on the band's first and last rows.

constexpr int BOX32 = KP * 128;  // dW f32: bytes of a 32-channel box

// Whether a float32 transform is keyed by band (Tr::kBanded: the ghost
// unit's, ghost_unit.cu GhostTr32 and BandActTr32 below): its tables are
// those of a pixel's band (tdw_f32_tr: the tile's; tdx_f32: the tile's, a
// tile lying in one band), its sums a band's. The fused transforms have
// no kBanded and compile as they were.
template <class Tr, class = void>
struct banded : std::false_type {};
template <class Tr>
struct banded<Tr, std::void_t<decltype(Tr::kBanded)>>
    : std::bool_constant<Tr::kBanded> {};

// Byte offset of (output channel n, pixel p) in a split dY tile (hi or
// lo) of bn channels by KP pixels: block p / 32 of bn rows of 128 bytes,
// the 16-byte chunk (p % 32) / 4 of row n permuted by n % 8. The B
// operand of the k8 step at pixel q starts split_offset(bn, 0, q) in.
__host__ __device__ constexpr uint32_t split_offset(int bn, int n, int p) {
  return (p / 32) * bn * 128 + n * 128 +
         (((((p % 32) >> 2) ^ n) & 7) << 4) + (p % 4) * 4;
}

// A stage of the float32 dW: two X boxes of 32 f32 channels a 64-row
// chunk, bn / 32 dY boxes (then the hi tile) and as many aux boxes (then
// the lo tile).
__host__ __device__ constexpr int dw32_stage_bytes(int bn, bool two) {
  return ((two ? 2 : 1) * 2 + 2 * (bn / 32)) * BOX32;
}

// The 4x4 block blk of the split's transpose: channels 4 cq.. and pixels
// 4 pq.. of the tile, the 8 threads of a phase (blk % 8 their lane's) on
// pq % 8 = blk % 8 and cq % 8 = blk % 8 ^ (blk / 8 % 8): 8 distinct
// 16-byte chunks of a 128-byte row where they read the dY box and where
// they write the tile.
__device__ __forceinline__ void xpose_block(int blk, int& cq, int& pq) {
  const int t = blk & 7;
  cq = 8 * (blk >> 7) + (t ^ ((blk >> 3) & 7));
  pq = 8 * ((blk >> 6) & 1) + t;
}

// v[pixel][channel] of block blk from the raw dY (or aux) boxes at raw.
__device__ __forceinline__ void xpose_read(const uint8_t* raw, int blk,
                                           float (&v)[4][4]) {
  int cq, pq;
  xpose_block(blk, cq, pq);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int p = 4 * pq + r;
    const float4 f = *reinterpret_cast<const float4*>(
        raw + (cq / 8) * BOX32 + chunk_offset(p, cq % 8));
    v[r][0] = f.x;
    v[r][1] = f.y;
    v[r][2] = f.z;
    v[r][3] = f.w;
  }
}

// Block blk split into the hi and lo tiles: a 16-byte chunk (4 pixels)
// of each channel's row in each.
template <int BN>
__device__ __forceinline__ void xpose_write(uint8_t* hi, uint8_t* lo,
                                            int blk,
                                            const float (&v)[4][4]) {
  int cq, pq;
  xpose_block(blk, cq, pq);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t h[4], l[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) tf32_split(v[r][j], h[r], l[r]);
    const uint32_t off = split_offset(BN, 4 * cq + j, 4 * pq);
    *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// Keeps a run's A fragments in their registers up to this point: the
// registers a wgmma reads asynchronously must not be reused before the
// wait that retires it, and the compiler sees them dead once the product
// is issued.
template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&f)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(f[i][j])::"memory");
}

// The float32 dW's identity transform (tdw_f32_wg): no aux box, nothing
// staged.
struct IdentTr32 {
  static constexpr int kAux = 0;
};

// A staging transform Tr of tdw_f32_tr (FusedTr32, GhostTr32) gives:
//   X2, x2_tab(X2&, key, c)  T_x's tables of channels c and c + 8 under
//                            key (the band, or 0), x1(v, X2, j) applies
//                            those of channel j (j = 0, 1) to v;
//   D4, d4_tab(D4&, key, c)  T_dy's tables of columns c .. c + 3,
//                            d1(d, aux, D4, j) applies those of column
//                            c + j to the raw d and its aux value;
//   band_px, edge_at         (banded) the band's pixels, and the seam
//                            term's row at a band's first and last rows.
// A consumer thread's state of it: T_x's tables of the lane's channels and
// their key; none for the identity. (T_dy's are read from L1 at each
// tile's transpose rather than kept: a BN 128 consumer's registers are
// the scarce resource.)
template <class Tr, bool = (Tr::kAux > 0)>
struct DwState {};
template <class Tr>
struct DwState<Tr, true> {
  typename Tr::X2 xt;
  int key = -1;
};

template <int BN, bool TWO, int R, class Tr>
__device__ __forceinline__ void dw32_body(const CUtensorMap& mx,
                                          const CUtensorMap& mdy,
                                          const CUtensorMap& maux,
                                          const DwArgs a, const Tr& tr) {
  static_assert(Tr::kAux == 0 || Tr::kAux == 4,
                "the float32 dW takes no aux box or an f32 one");
  constexpr bool STAGED = Tr::kAux > 0;
  constexpr bool BANDED = banded<Tr>::value;
  constexpr int NB = BN / 32;                 // dY boxes a stage
  constexpr int NA = TWO ? 2 : 1;             // 64-row chunks a stage
  constexpr int LDR = BN + 8;                 // floats a parked row
  constexpr int K8 = TWO ? KP / 8 : KP / 16;  // k8 steps a warpgroup
  constexpr int NR = K8 / R;                  // runs a tile
  constexpr int XB = BN / 64;                 // 4x4 blocks a thread
  constexpr int LOAD = (2 * NA + (STAGED ? 2 : 1) * NB) * BOX32;  // TMA's
  constexpr int STAGE = dw32_stage_bytes(BN, TWO);
  static_assert(K8 % R == 0, "a run divides the tile's k8 steps");
  extern __shared__ uint8_t raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + a.stages * STAGE);
  uint64_t* empty = full + a.stages;

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int tid = threadIdx.x % 128;
  const long long t0 = (long long)blockIdx.z * a.ntiles / a.splits;
  const int nt =
      (int)((long long)(blockIdx.z + 1) * a.ntiles / a.splits - t0);
  const int co0 = blockIdx.y * BN;
  const int half = a.ks / 2;
  auto chunk_of = [&](int j) {
    return TWO ? min(2 * (int)blockIdx.x + j, a.rchunks - 1) : 0;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < a.stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], CONSUMERS);  // every consumer thread is done
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------------------ producer
    regs_shrink<40>();
    if (tid == 0) {
      prefetch_map(&mx);
      prefetch_map(&mdy);
      if constexpr (STAGED) prefetch_map(&maux);
      for (int i = 0; i < nt; ++i) {
        const int st = i % a.stages;
        mbar_wait(&empty[st], ((i / a.stages) & 1) ^ 1);
        uint8_t* buf = smem + st * STAGE;
        mbar_expect_tx(&full[st], LOAD);
        int t = (int)t0 + i;
        const int w0 = (t % a.tiles_w) * a.wb;
        t /= a.tiles_w;
        const int h0 = (t % a.tiles_h) * a.hb, img = t / a.tiles_h;
        for (int j = 0; j < NA; ++j) {
          const int c = chunk_of(j), tap = c / a.cchunks;
          for (int b = 0; b < 2; ++b)
            tma_load_4d(buf + (2 * j + b) * BOX32, &mx, &full[st],
                        (c % a.cchunks) * 64 + 32 * b, w0 + tap % a.ks - half,
                        h0 + tap / a.ks - half, img);
        }
        for (int j = 0; j < NB; ++j) {
          tma_load_4d(buf + (2 * NA + j) * BOX32, &mdy, &full[st],
                      co0 + 32 * j, w0, h0, img);
          if constexpr (STAGED)  // into the lo tile's slot
            tma_load_4d(buf + (2 * NA + NB + j) * BOX32, &maux, &full[st],
                        co0 + 32 * j, w0, h0, img);
        }
      }
    }
    __syncwarp();
    cluster_sync();  // the sums are parked
    cluster_sync();  // every rank has read them
  } else {
    // ----------------------------------------------------------- consumers
    regs_grow<232>();
    float acc[BN / 2], sum[BN / 2];
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) sum[e] = 0.f;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    // the warp's 16 rows of its chunk (box 2 aslot + warp / 2, channels
    // m0 + g and m0 + g + 8 of it); the pixels of each tile it takes: all,
    // or its warpgroup's half where both own the one chunk
    const int aslot = TWO ? wg : 0;
    const int abox = 2 * aslot + warp / 2, m0 = 16 * (warp % 2);
    const int p0 = TWO ? 0 : wg * (KP / 2);
    // a staging transform's tables, and which of the lane's pixels of the
    // tile T_x takes (bit k: pixel p0 + t4 + 4 k)
    [[maybe_unused]] DwState<Tr> ts;
    [[maybe_unused]] uint32_t live = 0;
    // The A fragment of the k8 step at pixel q: X at pixels q + t4 and q +
    // t4 + 4 of channels m0 + g and m0 + g + 8; lanes g < 4 load the first
    // pixel first and lanes g >= 4 the second, so that each load's 32
    // lanes fall on 32 banks (one pixel's rows alone would take 16), then
    // each lane puts the two in their places, through T_x, and splits them.
    const bool low = g < 4;
    auto a_frag = [&](const uint8_t* xa, int q, uint32_t (&ah)[4],
                      uint32_t (&al)[4]) {
      const int pa = q + t4 + (low ? 0 : 4), pb = q + t4 + (low ? 4 : 0);
      const float u0 = lds_sw32(xa, pa, m0 + g);
      const float u1 = lds_sw32(xa, pb, m0 + g);
      const float u2 = lds_sw32(xa, pa, m0 + g + 8);
      const float u3 = lds_sw32(xa, pb, m0 + g + 8);
      if constexpr (STAGED) {
        float f[4] = {low ? u0 : u1, low ? u2 : u3, low ? u1 : u0,
                      low ? u3 : u2};
#pragma unroll
        for (int e = 0; e < 2; ++e) {  // pixels q + t4 and q + t4 + 4
          const bool on = (live >> ((q - p0) / 4 + e)) & 1;
          f[2 * e] = on ? tr.x1(f[2 * e], ts.xt, 0) : 0.f;
          f[2 * e + 1] = on ? tr.x1(f[2 * e + 1], ts.xt, 1) : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) tf32_split(f[j], ah[j], al[j]);
      } else {
        tf32_split(low ? u0 : u1, ah[0], al[0]);
        tf32_split(low ? u2 : u3, ah[1], al[1]);
        tf32_split(low ? u1 : u0, ah[2], al[2]);
        tf32_split(low ? u3 : u2, ah[3], al[3]);
      }
    };
    const int ct = threadIdx.x;  // the transpose's blocks ct + 256 x
    // each run's A fragments; without a transform the last run's stay
    // over the next tile's transpose, in flight
    uint32_t ah[NR][R][4] = {}, al[NR][R][4] = {};
    int prev = -1;  // the slot of the previous tile, its last run in flight
    for (int i = 0; i < nt; ++i) {
      const int st = i % a.stages;
      mbar_wait(&full[st], (i / a.stages) & 1);
      uint8_t* buf = smem + st * STAGE;
      if constexpr (STAGED) {
        if (prev >= 0) {  // the previous tile's last run, retired first
          wgmma_wait<0>();
          fence_operands(acc);
          fence_frags(ah[NR - 1]);
          fence_frags(al[NR - 1]);
#pragma unroll
          for (int e = 0; e < BN / 2; ++e) sum[e] += acc[e];
          mbar_arrive(&empty[prev]);
          prev = -1;
        }
      }
      uint8_t* hi = buf + 2 * NA * BOX32;  // the raw dY boxes, then hi
      uint8_t* lo = hi + NB * BOX32;       // the aux boxes, then lo
      const uint8_t* xa = buf + abox * BOX32;
      float v[XB][4][4];
#pragma unroll
      for (int x = 0; x < XB; ++x) xpose_read(hi, ct + CONSUMERS * x, v[x]);
      if constexpr (STAGED) {
        int t = (int)t0 + i;
        const int w0 = (t % a.tiles_w) * a.wb;
        t /= a.tiles_w;
        const int h0 = (t % a.tiles_h) * a.hb, img = t / a.tiles_h;
        // the tables' key: the tile's band, or 0
        int key = 0;
        if constexpr (BANDED) key = ((img * a.h + h0) * a.w + w0) / tr.band_px;
        if (key != ts.key) {
          ts.key = key;
          tr.x2_tab(ts.xt, key,
                    (chunk_of(aslot) % a.cchunks) * 64 + 16 * warp + g);
        }
        // T_x's pixels: in the image, and so is the pixel the tap reads
        // (box columns [clo, clo + cspan), rows [rlo, rlo + rspan))
        const int wm = a.wb - 1, lwb = __ffs(a.wb) - 1;
        const int tap = chunk_of(aslot) / a.cchunks;
        const int dx = tap % a.ks - half, dy = tap / a.ks - half;
        const int clo = max(0, -w0 - dx);
        const int cspan = max(0, min(a.w - w0, a.w - w0 - dx) - clo);
        const int rlo = max(0, -h0 - dy);
        const int rspan = max(0, min(a.h - h0, a.h - h0 - dy) - rlo);
        live = 0;
#pragma unroll
        for (int k = 0; k < 2 * K8; ++k) {
          const int p = p0 + t4 + 4 * k;
          live |= (uint32_t)((unsigned)((p & wm) - clo) < (unsigned)cspan &&
                             (unsigned)((p >> lwb) - rlo) < (unsigned)rspan)
                  << k;
        }
        // T_dy: the raw value and its aux value (a row of the block's at a
        // time), zero outside the image
        [[maybe_unused]] int gh = 0, brow0 = 0;  // the band's rows
        if constexpr (BANDED) {
          gh = tr.band_px / a.w;
          brow0 = img * a.h + h0 - key * gh;
        }
#pragma unroll
        for (int x = 0; x < XB; ++x) {
          int cq, pq;
          xpose_block(ct + CONSUMERS * x, cq, pq);
          typename Tr::D4 dt;
          tr.d4_tab(dt, key, co0 + 4 * cq);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int p = 4 * pq + r;
            const bool in = (p & wm) < a.w - w0 && (p >> lwb) < a.h - h0;
            const float4 y4 = *reinterpret_cast<const float4*>(
                lo + (cq / 8) * BOX32 + chunk_offset(p, cq % 8));
            const float u[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
            for (int j = 0; j < 4; ++j)
              v[x][r][j] = tr.d1(v[x][r][j], u[j], dt, j);
            if constexpr (BANDED) {
              if (const float* e = in ? tr.edge_at(key, brow0 + (p >> lwb),
                                                   gh, w0 + (p & wm))
                                      : nullptr) {
                const float4 s = __ldg(
                    reinterpret_cast<const float4*>(e + co0 + 4 * cq));
                v[x][r][0] = __fadd_rn(v[x][r][0], s.x);
                v[x][r][1] = __fadd_rn(v[x][r][1], s.y);
                v[x][r][2] = __fadd_rn(v[x][r][2], s.z);
                v[x][r][3] = __fadd_rn(v[x][r][3], s.w);
              }
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) v[x][r][j] = in ? v[x][r][j] : 0.f;
          }
        }
      }
      bar_sync(1, CONSUMERS);  // every raw value is read: hi goes over them
#pragma unroll
      for (int x = 0; x < XB; ++x)
        xpose_write<BN>(hi, lo, ct + CONSUMERS * x, v[x]);
      fence_async_smem();
      bar_sync(1, CONSUMERS);
      if (prev >= 0) {  // the previous tile's last run
        wgmma_wait<0>();
        fence_operands(acc);
        fence_frags(ah[NR - 1]);
        fence_frags(al[NR - 1]);
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) sum[e] += acc[e];
        mbar_arrive(&empty[prev]);
      }
#pragma unroll
      for (int s = 0; s < R; ++s) a_frag(xa, p0 + 8 * s, ah[0][s], al[0][s]);
      const uint64_t dhi = sw128_desc(hi, 16, 1024);
      const uint64_t dlo = sw128_desc(lo, 16, 1024);
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        wgmma_fence();
        fence_operands(acc);
#pragma unroll
        for (int s = 0; s < R; ++s)  // the k8 step's start, >> 4
          WgmmaTf32R<BN>::mma(acc, al[r][s],
                              dhi + (split_offset(BN, 0, p0 + 8 * (r * R + s))
                                     >> 4), s > 0);
#pragma unroll
        for (int s = 0; s < R; ++s)
          WgmmaTf32R<BN>::mma(acc, ah[r][s],
                              dlo + (split_offset(BN, 0, p0 + 8 * (r * R + s))
                                     >> 4), 1);
#pragma unroll
        for (int s = 0; s < R; ++s)
          WgmmaTf32R<BN>::mma(acc, ah[r][s],
                              dhi + (split_offset(BN, 0, p0 + 8 * (r * R + s))
                                     >> 4), 1);
        wgmma_commit();
        fence_operands(acc);
        if (r + 1 < NR) {  // the next run's fragments under this one
#pragma unroll
          for (int s = 0; s < R; ++s)
            a_frag(xa, p0 + 8 * ((r + 1) * R + s), ah[r + 1][s],
                   al[r + 1][s]);
          wgmma_wait<0>();
          fence_operands(acc);
          fence_frags(ah[r]);
          fence_frags(al[r]);
#pragma unroll
          for (int e = 0; e < BN / 2; ++e) sum[e] += acc[e];
        }
      }
      prev = st;
    }
    wgmma_wait<0>();  // the last tile's last run
    fence_operands(acc);
    fence_frags(ah[NR - 1]);
    fence_frags(al[NR - 1]);
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) sum[e] += acc[e];

    // park the sums over the ring, once both warpgroups are done reading
    // it
    bar_sync(1, CONSUMERS);
    float* park = reinterpret_cast<float*>(smem) + wg * 64 * LDR;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = 16 * warp + g + 8 * e;
        const int col = 8 * j + 2 * t4;
        *reinterpret_cast<float2*>(park + row * LDR + col) =
            make_float2(sum[4 * j + 2 * e], sum[4 * j + 2 * e + 1]);
      }
    cluster_sync();

    // rank r sums and writes rows [r, r+1) * rows/cs of the tile
    const int share = 64 * NA / a.cs;
    const int rank = (int)cluster_rank();
    float* out = a.out + (size_t)(blockIdx.z / a.cs) *
                             ((size_t)a.ks * a.ks * a.ci * a.co);
    const float* base = reinterpret_cast<const float*>(smem);
    for (int idx = threadIdx.x; idx < share * (BN / 4); idx += CONSUMERS) {
      const int r = rank * share + idx / (BN / 4), c = (idx % (BN / 4)) * 4;
      const int j = TWO ? r / 64 : 0, ii = r % 64;
      if (TWO && 2 * (int)blockIdx.x + j >= a.rchunks) continue;
      const int ch = chunk_of(j);
      const int cin = (ch % a.cchunks) * 64 + ii, n = co0 + c;
      if (cin >= a.ci || n >= a.co) continue;
      float4 sum4 = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int q = 0; q < a.cs; ++q)
        for (int pp = TWO ? j : 0; pp <= (TWO ? j : 1); ++pp) {
          const float4 v = ld_cluster_f4(base + (pp * 64 + ii) * LDR + c, q);
          sum4.x += v.x;
          sum4.y += v.y;
          sum4.z += v.z;
          sum4.w += v.w;
        }
      *reinterpret_cast<float4*>(
          out + ((size_t)(ch / a.cchunks) * a.ci + cin) * a.co + n) = sum4;
    }
    cluster_sync();
  }
}

template <int BN, bool TWO, int R>
__global__ void __launch_bounds__(THREADS, 1)
tdw_f32_wg(const __grid_constant__ CUtensorMap mx,
           const __grid_constant__ CUtensorMap mdy, const DwArgs a) {
  dw32_body<BN, TWO, R>(mx, mdy, mdy, a, IdentTr32{});
}

template <int BN, bool TWO, int R, class Tr>
__global__ void __launch_bounds__(THREADS, 1)
tdw_f32_tr(const __grid_constant__ CUtensorMap mx,
           const __grid_constant__ CUtensorMap mdy,
           const __grid_constant__ CUtensorMap maux, const DwArgs a,
           const Tr tr) {
  dw32_body<BN, TWO, R>(mx, mdy, maux, a, tr);
}

// ------------------------------------------------------- dX, forward

// The forward's transform (tdx, out_kind 4): the A operand x -> relu(x*a
// + b), (a, b) from tab (keys, 2, c) at the tile's key: the one
// (2, c) table where band_px = 0 (fused_conv.cu), else the table of the
// band of the output pixel (ghost_unit.cu; a tile lies in one band, and
// a 3x3's halo rows take it too). tab null: x as it is, no rewrite.
// kPerCta: the sums of the whole tensor, of the f32 accumulator (fused);
// else per band, of the rounded y, kept over each run of a CTA's tiles in
// one band (ghost, kBandRuns).
template <bool PER_CTA>
struct ActTr {
  using Aux = bf16;                   // unread: no aux box
  static constexpr int kAux = 0;
  static constexpr bool kPerCta = PER_CTA;
  static constexpr bool kBandRuns = !PER_CTA;
  static constexpr bool kFwd = true;
  static constexpr bool kRoundedSums = !PER_CTA;
  struct DT {
    float a[8], b[8];
  };
  const float* tab;
  int c, band_px;

  __device__ __forceinline__ bool x_on() const { return tab != nullptr; }
  __device__ __forceinline__ int key(int pix) const {
    return band_px > 0 ? pix / band_px : 0;
  }
  __device__ __forceinline__ void d_tab(DT& t, int key, int ch) const {
    const float* p = tab + (size_t)key * 2 * c + ch;
    load8f(p, t.a);
    load8f(p + c, t.b);
  }
  __device__ __forceinline__ void dy(float v[8], const float*, const DT& t,
                                     int, int) const {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = fmaxf(affine(v[i], t.a[i], t.b[i]), 0.f);
  }
  // the register path (a K step's A fragment): (a, b) of channels ch and
  // ch + 1 as {a0, a1, b0, b1}, and T_x of one bf16 pair, zero where !live
  __device__ __forceinline__ float4 ab2(int key, int ch) const {
    const float* p = tab + (size_t)key * 2 * c + ch;
    const float2 u = __ldg(reinterpret_cast<const float2*>(p));
    const float2 v = __ldg(reinterpret_cast<const float2*>(p + c));
    return make_float4(u.x, u.y, v.x, v.y);
  }
  __device__ __forceinline__ uint32_t act2(uint32_t x, const float4& t,
                                           bool live) const {
    __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&x);
    const float2 f = __bfloat1622float2(h);
    h = __floats2bfloat162_rn(fmaxf(affine(f.x, t.x, t.z), 0.f),
                              fmaxf(affine(f.y, t.y, t.w), 0.f));
    return live ? *reinterpret_cast<const uint32_t*>(&h) : 0u;
  }
};

// out_kind: what the epilogue makes of the product acc at output pixel
// p, column c (x, and the mask's (a, b) from the row tr.ab_row of the
// tile's band):
//   0  gm = acc*[x*a + b > 0] stored f32; sums [sum gm*x, sum gm];
//   1  bf16(acc + addend) (TMA store);
//   2  acc + addend stored f32;
//   3  gm as 0, dx = bf16(gm*a) (TMA store); sums as 0;
//   4  the forward (Tr::kFwd): y = bf16(acc) (TMA store); sums [sum v,
//      sum v^2], v = acc or, with Tr::kRoundedSums, the rounded y.
// addend (add_kind 0 none, 1 bf16, 2 f32) is (n, h, w, ci).
struct DxArgs {
  void* out;         // (n*h*w, ci), bf16 (out_kind 1, 3, 4) or f32 (0, 2)
  float* part;       // partial sums (entries, 2, ci) (out_kind 0, 3, 4)
  const void* addend;
  int add_kind, out_kind;
  int h, w, ci, co, ks;  // ci = columns of dX, co = the contracted dim
  int wb, hb, tiles_w, tiles_h;
  int lwb;               // log2(wb): row r of a tile is pixel (r & (wb -
                         // 1), r >> lwb) of its box
  int col_tiles, tiles;  // tiles = row tiles * col_tiles
  int cb, ksteps;        // 64-channel boxes of co; K steps a tile
  int stages, resident;
  int halo;              // 3x3 halo mode (dx_halo)
  int eslots;            // epilogue slots (dx_eslots)
  int band_px;           // > 0: a ghost 3x3's reads stay in the output's band
};

// bf16 output stored by TMA from the epilogue slot
__host__ __device__ constexpr bool dx_staged(int out_kind) {
  return out_kind == 1 || out_kind == 3 || out_kind == 4;
}
// column sums, one entry a tile or a CTA
__host__ __device__ constexpr bool dx_sums(int out_kind) {
  return out_kind == 0 || out_kind == 3 || out_kind == 4;
}
// the epilogue's bf16 input (x, or a bf16 addend) loaded by TMA into the
// epilogue slot, where the output then overwrites it
__host__ __device__ constexpr bool dx_ein(int out_kind, int add_kind) {
  return out_kind == 0 || out_kind == 3 || (out_kind == 1 && add_kind == 1);
}
// Halo mode: a 3x3 whose box is a 64- or 128-pixel row segment (wb >=
// 64): a K step is one (ky, channel box), its A box the (wb + 2) x hb
// pixels around the tile's rows, rewritten once; the three kx taps read it
// through A descriptors shifted by kx rows (each warpgroup's 64 output
// pixels lie in one image row), each with its own weight box. A third of
// the loads and rewrites of one box a tap.
__host__ __device__ constexpr bool dx_halo(int ks, int wb) {
  return ks == 3 && wb >= 64;
}
__host__ __device__ constexpr int round1k(int bytes) {
  return (bytes + 1023) / 1024 * 1024;
}
__host__ __device__ constexpr int dx_stage_bytes(int bn, bool resident,
                                                 bool halo, int wb, int hb,
                                                 int aux) {
  return halo ? round1k((wb + 2) * hb * 128) +
                    round1k((wb + 2) * hb * 64 * aux) + 3 * bn * 128
              : ABOX + TM * 64 * aux + (resident ? 0 : bn * 128);
}

// Byte offset of output element (row, col) of a warpgroup's 64-row half
// tile in its epilogue slot: 64-column sub-tiles of 64 rows x 128 bytes
// under the 128-byte swizzle (the TMA boxes of the epilogue's input and
// output).
__device__ __forceinline__ uint32_t staged_offset(int row, int col) {
  return (col / 64) * (64 * 128) + swizzled_offset(row, col % 64);
}

template <int BN, class Tr>
__global__ void __launch_bounds__(THREADS, 1)
tdx(const __grid_constant__ CUtensorMap mdy,
    const __grid_constant__ CUtensorMap maux,
    const __grid_constant__ CUtensorMap mw,
    const __grid_constant__ CUtensorMap me,
    const __grid_constant__ CUtensorMap my, const DxArgs a, const Tr tr) {
  using Aux = typename Tr::Aux;
  constexpr bool FWD = Tr::kFwd;        // out_kind 4
  constexpr int BBOX = BN * 128;        // bytes of one weight box
  constexpr int AUXBOX = TM * 64 * Tr::kAux;
  constexpr int HALF = 64 * BN * 2;     // bytes of a warpgroup's half slot
  extern __shared__ uint8_t raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  const bool staged = dx_staged(a.out_kind);
  const bool ein = dx_ein(a.out_kind, a.add_kind);
  const bool sums = dx_sums(a.out_kind);
  const bool mask = !FWD && sums;       // the epilogue's relu mask
  // the A box's rewrite: every backward's, a forward's unless T_x is the
  // identity (TMA's zero fill is then the pad)
  const bool rewrite = !FWD || tr.x_on();
  const int hrows = (a.wb + 2) * a.hb;  // rows of a halo box
  const int hbox = round1k(hrows * 128);
  const int stage_bytes = dx_stage_bytes(BN, a.resident, a.halo, a.wb,
                                         a.hb, Tr::kAux);
  // the A box (halo mode: its halo box), its aux box, the weight box(es)
  const int aux_at = a.halo ? hbox : ABOX;
  const int w_at = a.halo ? hbox + round1k(hrows * 64 * Tr::kAux)
                          : ABOX + AUXBOX;
  uint8_t* wres = smem + a.stages * stage_bytes;
  uint8_t* eslot = wres + (a.resident ? a.ksteps * BBOX : 0);
  // the 8 warps' column sums, then the tile's mask (a, b)
  float* red = reinterpret_cast<float*>(eslot + a.eslots * 2 * HALF);
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 9 * 2 * BN);
  uint64_t* empty = full + a.stages;
  uint64_t* wbar = empty + a.stages;
  uint64_t* efull = wbar + 1;
  uint64_t* edone = efull + 3;

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int tid = threadIdx.x % 128;
  const int half = a.ks / 2;

  if (threadIdx.x == 0) {
    for (int i = 0; i < a.stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 2);
    }
    mbar_init(wbar, 1);
    for (int i = 0; i < 3; ++i) {
      mbar_init(&efull[i], 1);
      mbar_init(&edone[i], 2);
    }
    fence_barrier_init();
  }
  __syncthreads();

  auto tile_of = [&](int t, int& img, int& x0, int& y0, int& col) {
    col = t % a.col_tiles;
    t /= a.col_tiles;
    x0 = (t % a.tiles_w) * a.wb;
    t /= a.tiles_w;
    y0 = (t % a.tiles_h) * a.hb;
    img = t / a.tiles_h;
  };
  // this CTA's tiles, in order: a contiguous range of row tiles in the
  // column blockIdx.x % col_tiles (the grid is a multiple of the column
  // tiles; each of its grid / col_tiles groups takes an equal share)
  const int groups = gridDim.x / a.col_tiles;
  const int row_tiles = a.tiles / a.col_tiles;
  const int grp = blockIdx.x / a.col_tiles;
  const int r_lo = (int)((long long)grp * row_tiles / groups);
  const int ntiles = (int)((long long)(grp + 1) * row_tiles / groups) - r_lo;
  auto tile_at = [&](int i) {
    return (r_lo + i) * a.col_tiles + (int)blockIdx.x % a.col_tiles;
  };
  // the epilogue slot's TMA boxes of tile t (load or store): each
  // warpgroup's 64 rows, the right half of a 128-pixel row or the lower
  // hb / 2 rows of the box, 64 columns a box
  auto slot_boxes = [&](int t, uint8_t* slot, bool load, uint64_t* bar) {
    int img, x0, y0, col;
    tile_of(t, img, x0, y0, col);
    for (int g = 0; g < 2; ++g) {
      const int sx = a.wb == TM ? x0 + 64 * g : x0;
      const int sy = a.wb == TM ? y0 : y0 + g * (a.hb / 2);
      for (int sub = 0; sub < BN / 64; ++sub) {
        uint8_t* box = slot + g * HALF + sub * (64 * 128);
        if (load)
          tma_load_4d(box, &me, bar, col * BN + 64 * sub, sx, sy, img);
        else
          tma_store_4d(&my, box, col * BN + 64 * sub, sx, sy, img);
      }
    }
  };

  if (wg == 2) {
    // ------------------------------------------------------------ producer
    regs_shrink<40>();
    if (tid == 0) {
      prefetch_map(&mdy);
      if (Tr::kAux) prefetch_map(&maux);
      prefetch_map(&mw);
      if (a.resident) {
        // the grid is a multiple of the column tiles: every tile of this
        // CTA has the column of its first
        const int n0 = (blockIdx.x % a.col_tiles) * BN;
        mbar_expect_tx(wbar, a.ksteps * BBOX);
        for (int k = 0; k < a.ksteps; ++k)
          tma_load_3d(wres + k * BBOX, &mw, wbar, (k % a.cb) * 64,
                      k / a.cb, n0);
      }
      const int tx_bytes =
          a.halo ? hrows * 128 + hrows * 64 * Tr::kAux + 3 * BBOX
                 : stage_bytes;
      // the ring slot and its phase, and the K step's channel box and tap
      // (halo mode: ky), kept as running counters: no division a step
      int st = 0, ph = 0;
      for (int i = 0; i < ntiles; ++i) {
        int img, x0, y0, col;
        tile_of(tile_at(i), img, x0, y0, col);
        int c0 = 0, tap = 0, kx = -half, ky = -half;
        for (int k = 0; k < a.ksteps; ++k) {
          mbar_wait(&empty[st], ph ^ 1);
          uint8_t* buf = smem + st * stage_bytes;
          mbar_expect_tx(&full[st], tx_bytes);
          if (a.halo) {
            tma_load_4d(buf, &mdy, &full[st], c0, x0 - 1, y0 + tap - 1, img);
            if (Tr::kAux)
              tma_load_4d(buf + aux_at, &maux, &full[st], c0, x0 - 1,
                          y0 + tap - 1, img);
            for (int j = 0; j < 3; ++j)
              tma_load_3d(buf + w_at + j * BBOX, &mw, &full[st], c0,
                          3 * tap + j, col * BN);
          } else {
            tma_load_4d(buf, &mdy, &full[st], c0, x0 + kx, y0 + ky, img);
            if (Tr::kAux)
              tma_load_4d(buf + aux_at, &maux, &full[st], c0, x0 + kx,
                          y0 + ky, img);
            if (!a.resident)
              tma_load_3d(buf + w_at, &mw, &full[st], c0, tap, col * BN);
          }
          if ((c0 += 64) == 64 * a.cb) {
            c0 = 0;
            ++tap;
            if (++kx > half) kx = -half, ++ky;
          }
          if (++st == a.stages) st = 0, ph ^= 1;
        }
      }
    } else if (tid == 32 && a.eslots) {
      // the epilogue slots, on a thread of their own so that the ring's
      // loads never wait for them: a slot's last tile is done, so store
      // it from the slot, let the store read it, then fill the slot with
      // the next tile's input
      if (ein) prefetch_map(&me);
      if (staged) prefetch_map(&my);
      int i = 0;
      for (; i < ntiles; ++i) {
        const int t = tile_at(i), e = i % a.eslots;
        mbar_wait(&edone[e], ((i / a.eslots) & 1) ^ 1);
        uint8_t* slot = eslot + e * 2 * HALF;
        if (staged && i >= a.eslots) {
          slot_boxes(tile_at(i - a.eslots), slot, false, nullptr);
          bulk_commit();
          bulk_wait_read<0>();
        }
        if (ein) {
          mbar_expect_tx(&efull[e], 2 * HALF);
          slot_boxes(t, slot, true, &efull[e]);
        } else {
          mbar_arrive(&efull[e]);
        }
      }
      if (staged) {
        // the last tiles' stores
        for (int j = i < a.eslots ? 0 : i - a.eslots; j < i; ++j) {
          mbar_wait(&edone[j % a.eslots], (j / a.eslots) & 1);
          slot_boxes(tile_at(j), eslot + (j % a.eslots) * 2 * HALF, false,
                     nullptr);
        }
        bulk_commit();
        bulk_wait<0>();
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    regs_grow<232>();
    float acc[BN / 2] = {};  // each tile's first product overwrites it
    if (a.resident) mbar_wait(wbar, 0);
    const int ct = threadIdx.x, jc = ct % 8;
    // kPerCta: the thread's column sums over its rows of every tile, in
    // tile order, reduced across the CTA once at its end; kBandRuns: the
    // same over each run of the CTA's tiles that lie in one band, reduced
    // at the run's end into the entry of its last row tile (the others'
    // entries zero)
    constexpr bool RUNS = Tr::kPerCta || Tr::kBandRuns;
    constexpr int PC = RUNS ? BN / 8 : 1;
    float cs0[PC][2] = {}, cs1[PC][2] = {};
    const int warp = tid / 32, lane = tid % 32;
    // the run's sums into entry `entry` of part, in a fixed order: the
    // warp's 16 row slots by shuffles, then the 8 warps
    auto flush = [&](size_t entry) {
      float* wred = red + (wg * 4 + warp) * 2 * BN;
#pragma unroll
      for (int j = 0; j < PC; ++j)
#pragma unroll
        for (int e3 = 0; e3 < 2; ++e3) {
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            cs0[j][e3] += __shfl_xor_sync(0xffffffffu, cs0[j][e3], o);
            cs1[j][e3] += __shfl_xor_sync(0xffffffffu, cs1[j][e3], o);
          }
          if (lane < 4) {
            wred[8 * j + 2 * lane + e3] = cs0[j][e3];
            wred[BN + 8 * j + 2 * lane + e3] = cs1[j][e3];
          }
          cs0[j][e3] = cs1[j][e3] = 0.f;
        }
      bar_sync(1, CONSUMERS);
      if (ct < 2 * BN) {
        float sum = 0.f;
#pragma unroll
        for (int w8 = 0; w8 < 8; ++w8) sum += red[w8 * 2 * BN + ct];
        const int cc = (blockIdx.x % a.col_tiles) * BN + ct % BN;
        if (cc < a.ci) a.part[(entry * 2 + ct / BN) * a.ci + cc] = sum;
      }
      bar_sync(1, CONSUMERS);  // red is read before it is written again
    };
    // the key of the CTA's i-th tile
    auto key_at = [&](int i) {
      int img, x0, y0, col;
      tile_of(tile_at(i), img, x0, y0, col);
      return tr.key((img * a.h + y0) * a.w + x0);
    };
    // the mask's (a, b) of value ct, loaded one tile ahead
    float abnext = 0.f;
    auto prefetch_ab = [&](int i) {
      if constexpr (!FWD) {
        if (!mask || ct >= 2 * BN || i >= ntiles) return;
        int img, x0, y0, col;
        tile_of(tile_at(i), img, x0, y0, col);
        abnext = __ldg(tr.ab_row(tr.key((img * a.h + y0) * a.w + x0)) +
                       (ct / BN) * a.ci + col * BN + ct % BN);
      }
    };
    prefetch_ab(0);
    // a halo box's rows a warpgroup's 64 output pixels start at
    const int hrow0 = (64 * wg / a.wb) * (a.wb + 2) + (64 * wg) % a.wb;
    // the ring slot and its phase, as the producer keeps them
    int st = 0, ph = 0;
    for (int i = 0; i < ntiles; ++i) {
      const int t = tile_at(i);
      int img, x0, y0, col;
      tile_of(t, img, x0, y0, col);
      const int n0 = col * BN;
      // a tile lies in one band (the box height divides gh): its key, and
      // its band's first row where a 3x3's reads stay in the band
      const int key = tr.key((img * a.h + y0) * a.w + x0);
      const int gh = a.band_px / a.w;
      const int band_y0 = a.band_px > 0 ? y0 - y0 % gh : 0;
      const float abv = abnext;
      prefetch_ab(i + 1);
      int prev = 0;
      // the K step's channel box and tap (halo mode: ky), running
      int cbox = 0, tap = 0, tkx = -half, tky = -half;
      for (int k = 0; k < a.ksteps; ++k) {
        const int c = 64 * cbox + 8 * jc;
        // the live rows read the tile's band: its tables, loaded before
        // the slot's wait
        typename Tr::DT dt;
        if (rewrite && (!FWD || a.halo)) tr.d_tab(dt, key, c);
        mbar_wait(&full[st], ph);
        uint8_t* buf = smem + st * stage_bytes;
        if (a.halo) {
          // T_dy (T_x) of the whole halo box, shared by both warpgroups:
          // row hr is pixel (x0 - 1 + hr % (wb + 2), y0 + ky - 1 + hr /
          // (wb + 2)), read by output row y0 + hr / (wb + 2)
          const int ky = tap;
          if (rewrite) {
#pragma unroll
            for (int q = 0; q < 5; ++q) {
              const int hr = ct / 8 + 32 * q;
              if (hr >= hrows) break;
              // hr < 160 < 3 (wb + 2): its row of the box by comparison
              const int hy = (hr >= a.wb + 2) + (hr >= 2 * (a.wb + 2));
              const int oy = y0 + hy;
              const int sx = x0 - 1 + hr - hy * (a.wb + 2), sy = oy + ky - 1;
              const int src = (img * a.h + sy) * a.w + sx;
              bool live = sx >= 0 && sx < a.w && sy >= 0 && sy < a.h;
              if (a.band_px > 0)
                live = live && sy >= band_y0 && sy < band_y0 + gh;
              const uint32_t off = chunk_offset(hr, jc);
              uint4 v = make_uint4(0, 0, 0, 0);
              if (live) {
                float d[8], x2[8];
                unpack8(*reinterpret_cast<const uint4*>(buf + off), d);
                if constexpr (Tr::kAux == 2)
                  aux8<Aux>(buf + aux_at, off, hr, jc, x2);
                else if constexpr (Tr::kAux == 4)
                  aux8<Aux>(buf + aux_at, 0, hr, jc, x2);
                tr.dy(d, x2, dt, src, c);
                v = pack8(d);
              }
              *reinterpret_cast<uint4*>(buf + off) = v;
            }
            fence_async_smem();
            bar_sync(1, CONSUMERS);
          }
          wgmma_fence();
          fence_operands(acc);
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            // kx rows into the box: the hardware swizzles the address it
            // forms, as for the k16 steps inside a row
            const uint64_t da = sw128_desc(buf + (hrow0 + kx) * 128, 16, 1024);
            const uint64_t db = sw128_desc(buf + w_at + kx * BBOX, 16, 1024);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)  // 32 bytes a k16 step, >> 4
              WgmmaK<BN>::mma(acc, da + 2 * kk, db + 2 * kk,
                              k > 0 || kx > 0 || kk > 0);
          }
        } else {
          // T_dy (T_x) of this warpgroup's 64 rows of the A box: row r is
          // output pixel (x0 + r % wb, y0 + r / wb), read at that pixel
          // shifted by the tap
          const int kx = tkx, ky = tky;
          const uint64_t db = sw128_desc(
              a.resident ? wres + k * BBOX : buf + w_at, 16, 1024);
          if constexpr (FWD) {
            if (rewrite) {
              // A from registers, no round trip through shared memory:
              // each warp's 16 rows by ldmatrix (lane l gives row l % 8 +
              // 8 (l / 8 % 2) of them, 16-byte chunk 2 kk + l / 16 of the
              // row), through T_x, zero where the pixel read lies outside
              // the image; the thread's rows g and g + 8 of the warp's
              const int g = lane / 4, t4 = lane % 4;
              bool live[2];
#pragma unroll
              for (int h2 = 0; h2 < 2; ++h2) {
                const int r = 64 * wg + 16 * warp + g + 8 * h2;
                const int ox = x0 + (r & (a.wb - 1)), oy = y0 + (r >> a.lwb);
                const int sx = ox + kx, sy = oy + ky;
                live[h2] = ox < a.w && oy < a.h && sx >= 0 && sx < a.w &&
                           sy >= 0 && sy < a.h;
              }
              const int lr = 64 * wg + 16 * warp + (lane & 7) +
                             8 * ((lane >> 3) & 1);
              const uint32_t rowaddr = smem_u32(buf) + lr * 128;
              uint32_t af[4][4];
#pragma unroll
              for (int kk = 0; kk < 4; ++kk)
                ldsm_x4(rowaddr + ((((2 * kk + (lane >> 4)) ^ lr) & 7) << 4),
                        af[kk]);
#pragma unroll
              for (int kk = 0; kk < 4; ++kk) {
                const int ch = 64 * cbox + 16 * kk + 2 * t4;
                const float4 lo = tr.ab2(key, ch), hi = tr.ab2(key, ch + 8);
                af[kk][0] = tr.act2(af[kk][0], lo, live[0]);
                af[kk][1] = tr.act2(af[kk][1], lo, live[1]);
                af[kk][2] = tr.act2(af[kk][2], hi, live[0]);
                af[kk][3] = tr.act2(af[kk][3], hi, live[1]);
              }
              wgmma_fence();
              fence_operands(acc);
#pragma unroll
              for (int kk = 0; kk < 4; ++kk)  // 32 bytes a k16 step, >> 4
                WgmmaKR<BN>::mma(acc, af[kk], db + 2 * kk, k > 0 || kk > 0);
            } else {
              // x as it is: TMA's zero fill is the pad
              const uint64_t da = sw128_desc(buf + wg * 64 * 128, 16, 1024);
              wgmma_fence();
              fence_operands(acc);
#pragma unroll
              for (int kk = 0; kk < 4; ++kk)
                WgmmaK<BN>::mma(acc, da + 2 * kk, db + 2 * kk, k > 0 || kk > 0);
            }
          } else {
            if (rewrite) {
              uint4 dr[4];
              float ax[4][8];
              int src[4];
              bool live[4];
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const int r = 64 * wg + tid / 8 + 16 * q;
                const int ox = x0 + (r & (a.wb - 1)), oy = y0 + (r >> a.lwb);
                const int sx = ox + kx, sy = oy + ky;
                src[q] = (img * a.h + sy) * a.w + sx;
                live[q] = ox < a.w && oy < a.h && sx >= 0 && sx < a.w &&
                          sy >= 0 && sy < a.h;
                if (a.band_px > 0)
                  live[q] = live[q] && sy >= band_y0 && sy < band_y0 + gh;
                const uint32_t off = chunk_offset(r, jc);
                dr[q] = *reinterpret_cast<const uint4*>(buf + off);
                if constexpr (Tr::kAux > 0)
                  aux8<Aux>(buf + aux_at, off, r, jc, ax[q]);
              }
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const int r = 64 * wg + tid / 8 + 16 * q;
                uint4 v = make_uint4(0, 0, 0, 0);
                if (live[q]) {
                  float d[8];
                  unpack8(dr[q], d);
                  tr.dy(d, ax[q], dt, src[q], c);
                  v = pack8(d);
                }
                *reinterpret_cast<uint4*>(buf + chunk_offset(r, jc)) = v;
              }
              fence_async_smem();
              bar_sync(2 + wg, 128);
            }
            const uint64_t da = sw128_desc(buf + wg * 64 * 128, 16, 1024);
            wgmma_fence();
            fence_operands(acc);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)  // 32 bytes a k16 step, >> 4
              WgmmaK<BN>::mma(acc, da + 2 * kk, db + 2 * kk, k > 0 || kk > 0);
          }
        }
        wgmma_commit();
        fence_operands(acc);
        wgmma_wait<1>();
        if (k > 0 && tid == 0) mbar_arrive(&empty[prev]);
        prev = st;
        if (++cbox == a.cb) {
          cbox = 0;
          ++tap;
          if (++tkx > half) tkx = -half, ++tky;
        }
        if (++st == a.stages) st = 0, ph ^= 1;
      }
      wgmma_wait<0>();
      fence_operands(acc);
      if (tid == 0) mbar_arrive(&empty[prev]);

      // ---------------------------------------------------------- epilogue
      const int e = a.eslots ? i % a.eslots : 0;
      uint8_t* slot = eslot + e * 2 * HALF + wg * HALF;
      if (a.eslots) mbar_wait(&efull[e], (i / a.eslots) & 1);
      if (mask && (!Tr::kPerCta || i == 0)) {
        // the mask's (a, b) of the tile's columns (a CTA's, where its tiles
        // share the table); the last tile's readers are past the barrier
        // that ends its sums
        if (ct < 2 * BN) red[8 * 2 * BN + ct] = abv;
        bar_sync(1, CONSUMERS);
      }
      const float* sab = red + 8 * 2 * BN;
      float* wred = red + (wg * 4 + warp) * 2 * BN;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int cl = 8 * j + 2 * (lane % 4);
        float s0[2] = {0.f, 0.f}, s1[2] = {0.f, 0.f};
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int row = 16 * warp + lane / 4 + 8 * e2, r = 64 * wg + row;
          const int ox = x0 + (r & (a.wb - 1)), oy = y0 + (r >> a.lwb);
          const bool in = ox < a.w && oy < a.h;
          const size_t off =
              (((size_t)img * a.h + oy) * a.w + ox) * a.ci + n0 + cl;
          __nv_bfloat162* sp =
              reinterpret_cast<__nv_bfloat162*>(slot + staged_offset(row, cl));
          float u = acc[4 * j + 2 * e2], v = acc[4 * j + 2 * e2 + 1];
          float2 ev = make_float2(0.f, 0.f);
          if (!FWD && ein) ev = __bfloat1622float2(*sp);
          if constexpr (FWD) {
            // y; the sums of the pixels in the image (a halo box reads
            // live pixels for rows past it)
            const __nv_bfloat162 yb = __floats2bfloat162_rn(u, v);
            *sp = yb;
            if constexpr (Tr::kRoundedSums) {
              const float2 f = __bfloat1622float2(yb);
              u = f.x;
              v = f.y;
            }
            u = in ? u : 0.f;
            v = in ? v : 0.f;
            s0[0] += u;
            s0[1] += v;
            s1[0] += u * u;
            s1[1] += v * v;
          } else if (a.out_kind == 0 || a.out_kind == 3) {
            const float ta0 = sab[cl], ta1 = sab[cl + 1];
            u = in && affine(ev.x, ta0, sab[BN + cl]) > 0.f ? u : 0.f;
            v = in && affine(ev.y, ta1, sab[BN + cl + 1]) > 0.f ? v : 0.f;
            s0[0] += u * ev.x;
            s0[1] += v * ev.y;
            s1[0] += u;
            s1[1] += v;
            if (a.out_kind == 3)
              *sp = __floats2bfloat162_rn(u * ta0, v * ta1);
            else if (in)
              *reinterpret_cast<float2*>(static_cast<float*>(a.out) + off) =
                  make_float2(u, v);
          } else {
            if (a.add_kind == 1) {
              u += ev.x;
              v += ev.y;
            } else if (in && a.add_kind == 2) {
              const float2 ad = __ldg(reinterpret_cast<const float2*>(
                  static_cast<const float*>(a.addend) + off));
              u += ad.x;
              v += ad.y;
            }
            if (a.out_kind == 1)
              *sp = __floats2bfloat162_rn(u, v);
            else if (in)
              *reinterpret_cast<float2*>(static_cast<float*>(a.out) + off) =
                  make_float2(u, v);
          }
        }
        if constexpr (RUNS) {
#pragma unroll
          for (int e3 = 0; e3 < 2; ++e3) {
            cs0[j][e3] += s0[e3];
            cs1[j][e3] += s1[e3];
          }
        } else if (sums) {
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
            *reinterpret_cast<float2*>(wred + BN + cl) =
                make_float2(s1[0], s1[1]);
          }
        }
      }
      if (a.eslots) {
        // the slot is done (its output staged): the producer stores it
        if (staged) fence_async_smem();
        bar_sync(2 + wg, 128);
        if (tid == 0) mbar_arrive(&edone[e]);
      }
      if constexpr (Tr::kBandRuns) {
        // the run's sums at its last tile, else a zero entry
        const size_t rt = t / a.col_tiles;
        if (i + 1 == ntiles || key_at(i + 1) != key) {
          flush(rt);
        } else if (ct < 2 * BN && n0 + ct % BN < a.ci) {
          a.part[(rt * 2 + ct / BN) * a.ci + n0 + ct % BN] = 0.f;
        }
      } else if (sums && !Tr::kPerCta) {
        // the tile's column sums: the 8 warps in order
        bar_sync(1, CONSUMERS);
        if (ct < 2 * BN) {
          float sum = 0.f;
#pragma unroll
          for (int w8 = 0; w8 < 8; ++w8) sum += red[w8 * 2 * BN + ct];
          const int cc = n0 + ct % BN;
          if (cc < a.ci) {
            const int rt = t / a.col_tiles;
            a.part[((size_t)rt * 2 + ct / BN) * a.ci + cc] = sum;
          }
        }
        bar_sync(1, CONSUMERS);  // red is read before the next tile's
      }
    }
    // the CTA's column sums, one entry a CTA of its column
    if (sums && Tr::kPerCta) flush(grp);
  }
}

// out[g][i] = the sum of part[g * entries + e][i] over e in order, i <
// cols (2 * ci): the column sums of group g (a band, or everything).
__global__ void reduce_parts(const float* __restrict__ part,
                             float* __restrict__ out, int cols, int entries) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cols) return;
  const float* p = part + (size_t)blockIdx.y * entries * cols + i;
  float s = 0.f;
  for (int e = 0; e < entries; ++e) s += p[(size_t)e * cols];
  out[(size_t)blockIdx.y * cols + i] = s;
}

// reduce_parts for the float32 kernels (one group): the same order, added
// in double and rounded once.
__global__ void reduce_parts_wide(const float* __restrict__ part,
                                  float* __restrict__ out, int cols,
                                  int entries) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cols) return;
  double s = 0.0;
  for (int e = 0; e < entries; ++e) s += part[(size_t)e * cols + i];
  out[i] = (float)s;
}

// reduce_parts_wide over groups (the banded float32 kernels' band sums):
// out[g][i] = the sum of part[g * entries + e][i] over e in order, added in
// double and rounded once.
__global__ void reduce_groups_wide(const float* __restrict__ part,
                                   float* __restrict__ out, int cols,
                                   int entries) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cols) return;
  const float* p = part + (size_t)blockIdx.y * entries * cols + i;
  double s = 0.0;
  for (int e = 0; e < entries; ++e) s += p[(size_t)e * cols];
  out[(size_t)blockIdx.y * cols + i] = (float)s;
}

// ------------------------------------------------ dX and forward, f32
//
// tdx_f32: tdx's products in float32: x, y, dy, dx and the weight f32. The
// same persistent tiles (128 pixels x BN columns, BN 64 or 128, each CTA a
// contiguous run of pixel tiles in one column), ring, halo mode and
// epilogue slots, with a K step of 32 contracted channels (one 128-byte f32
// row) and the product as split TF32 (wgmma.cuh), as conv_fwd.cu's
// conv_fwd_tma_f32: the weight comes split, its hi and lo boxes from a (2,
// rows, K) copy that split_tf32 writes before the launch (TF32 wgmma takes
// K-major operands only, and a split needs both halves of A); a 1x1's
// weight, hi and lo, stays resident in shared memory where it fits beside
// the ring (the plan's `resident`), else each slot carries its boxes.
//
// A product is one K step (in halo mode one kx of it: the slot's halo box
// read three times, its rows shifted by kx, each kx with its own weight
// boxes). Its A operand is prepared in registers: each warp loads its 16
// rows of the A box by ldmatrix (the TF32 fragment has the bf16 one's
// bytes), puts each value through the transform there (Tr::k8: the
// forward's relu(x*a + b), the backward's dy_eff with y's box loaded
// alike), zero where the pixel read lies outside the image (TMA's zero fill
// would give relu(b) or ds0), and splits it into TF32 hi and lo (Frag32).
// Twelve m64nBNk8 products (4 k8 steps of lo.hi', then hi.lo', then hi.hi')
// go to a fresh accumulator, which is waited for and added to the tile's
// f32 sum. With OVL (the plan's `overlap`) each consumer warpgroup keeps
// two fragment sets: it starts product p from one and, while those
// products run, prepares product p + 1 (the next tile's first, at a tile's
// end) into the other; then it waits, folds the accumulator into the sum
// and releases the slot that p was the last product of. Without OVL the
// preparation follows the wait. A tile has an even number of products (the
// contracted channels are a multiple of 64), so the sets alternate in a
// fixed pattern and every index into them is known to the compiler.
//
// The epilogue as tdx's in f32: the forward stores y = sum (out_kind 4) and
// sums [sum, sum^2]; the fused backward reads x's f32 box from its epilogue
// slot (by TMA), masks, stores dx = gm*a over it (out_kind 3) and sums
// [gm*x, gm]; the slot's 32-column sub-boxes are stored by TMA from a
// thread of their own. Every tile's column sums are reduced in a fixed
// order (tile_sums: each thread its two rows, the warp's 8 row slots,
// then the 8 warps in order): a banded transform's go to one entry a tile
// (its row tile) of part, added a band's in order in double by
// reduce_groups_wide; the fused transforms' are added in double in shared
// memory over the CTA's tiles in order, then go to one entry a CTA, added
// in order in double by reduce_parts_wide. No atomics: two launches are
// bit-equal.
// A banded transform (the ghost unit's) keys the tables by the tile's band
// (a tile lies in one band: the box height divides gh) and sums per band.
// Its dX ends as gm (masked under the tile's band's (a, b), stored by TMA
// over x's f32 box), or as dX + the f32 addend (loaded by TMA into the
// epilogue slot) or dX alone; a 3x3 dX reads only its output row's band
// (a.band_px), and the seam term (Tr::edge_row) is added to dz on a band's
// first and last rows before the split.

// The f32 forward's transform (tdx_f32, out_kind 4): x -> relu(x*a + b),
// (a, b) from the (2, c) table tab; the sums those of the f32 product.
struct ActTr32 {
  static constexpr int kAux = 0;
  static constexpr bool kFwd = true;
  struct K8 {
    float a[2], b[2];
  };
  const float* tab;
  int c;

  // (a, b) of channels ch and ch + 4, the two of a thread's k8 fragment
  __device__ __forceinline__ void k8_tab(K8& t, int ch) const {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      t.a[j] = __ldg(tab + ch + 4 * j);
      t.b[j] = __ldg(tab + c + ch + 4 * j);
    }
  }
  __device__ __forceinline__ float k8(float v, float, const K8& t,
                                      int j) const {
    return fmaxf(affine(v, t.a[j], t.b[j]), 0.f);
  }
};

// The ghost forward's transform in float32 (tdx_f32, out_kind 4, banded):
// x -> relu(x*a + b) under the table (keys, 2, c) of the tile's band (a
// 3x3's halo rows take it too), x as it is where tab is null; the sums a
// band's, of the f32 y, one entry a tile.
struct BandActTr32 {
  static constexpr int kAux = 0;
  static constexpr bool kFwd = true;
  static constexpr bool kBanded = true;
  struct K8 {
    float a[2], b[2];
  };
  const float* tab;
  int c, band_px;

  __device__ __forceinline__ int key(int pix) const { return pix / band_px; }
  __device__ __forceinline__ void k8_tab(K8& t, int key, int ch) const {
    if (!tab) return;
    const float* p = tab + (size_t)key * 2 * c + ch;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      t.a[j] = __ldg(p + 4 * j);
      t.b[j] = __ldg(p + c + 4 * j);
    }
  }
  __device__ __forceinline__ float k8(float v, float, const K8& t,
                                      int j) const {
    return tab ? fmaxf(affine(v, t.a[j], t.b[j]), 0.f) : v;
  }
  // no seam term in the forward
  __device__ __forceinline__ const float* edge_row(int) const {
    return nullptr;
  }
};

// Bytes of a tdx_f32 ring slot: the A box (halo mode: the (wb + 2) x hb
// halo box), its aux box, and the weight's hi and lo boxes of each kx
// unless the weight is resident.
__host__ __device__ constexpr int dx32_stage_bytes(int bn, bool halo, int wb,
                                                   int hb, bool aux,
                                                   bool resident) {
  return halo ? round1k((wb + 2) * hb * 128) * (aux ? 2 : 1) + 6 * bn * 128
              : ABOX * (aux ? 2 : 1) + (resident ? 0 : 2 * bn * 128);
}

// Byte offset of output element (row, col) of a warpgroup's 64-row half
// tile in its f32 epilogue slot: 32-column sub-tiles of 64 rows x 128
// bytes under the 128-byte swizzle (the TMA boxes of x and of the output).
__device__ __forceinline__ uint32_t staged_offset32(int row, int col) {
  return (col / 32) * (64 * 128) + row * 128 +
         ((((col >> 2) ^ row) & 7) << 4) + (col & 3) * 4;
}

// tdx_f32's column sums of one tile in a fixed order: each thread's two
// rows (cs0, cs1), the warp's 8 row slots (the lanes of one t4), then the
// 8 warps in order. The 8 lanes add by a butterfly that keeps half of a
// lane's values at each of its three levels (lanes xor 4, 8, 16): each
// level adds the pairs that xor shuffles of every value would add, so the
// bits are those of the shuffle tree, with a quarter of its shuffles.
// Returns value ct's sum (ct < 2 BN: [sum cs0, sum cs1] of column ct % BN;
// 0 elsewhere). Every consumer thread calls it.
template <int BN>
__device__ __forceinline__ float tile_sums(float (&cs0)[BN / 8][2],
                                           float (&cs1)[BN / 8][2],
                                           float* red, int wg, int warp,
                                           int lane, int ct) {
  constexpr int V = BN / 2;  // a thread's values: cs0, then cs1
  float v[V];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e3 = 0; e3 < 2; ++e3) {
      v[2 * j + e3] = cs0[j][e3];
      v[V / 2 + 2 * j + e3] = cs1[j][e3];
    }
  const int g = lane >> 2;
  // level 1 (g ^ 1): the lane keeps the half of bit 0 of g
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
  // the lane's values: flat indices i + (bits of g) * V / 8 of v
  float* wred = red + (wg * 4 + warp) * 2 * BN;
  const int f0 = (b0 ? V / 2 : 0) + (b1 ? V / 4 : 0) + (b2 ? V / 8 : 0);
  const int t2 = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < V / 8; ++i) {
    const int f = f0 + i, r = f % (V / 2);
    wred[(f / (V / 2)) * BN + 8 * (r / 2) + t2 + (r & 1)] = w3[i];
  }
  bar_sync(1, CONSUMERS);
  float s = 0.f;
  if (ct < 2 * BN) {
#pragma unroll
    for (int w8 = 0; w8 < 8; ++w8) s += red[w8 * 2 * BN + ct];
  }
  bar_sync(1, CONSUMERS);  // red is read before it is written again
  return s;
}

// A consumer warpgroup's A operand of one tdx_f32 product, prepared in
// registers: the TF32 hi and lo fragments of its four k8 steps, the low
// word of the descriptor of its weight's hi box (the lo box follows it;
// the high word is every box's), and the ring slot that the product's
// retirement releases (-1: a later product of the slot reads it).
struct Frag32 {
  uint32_t ah[4][4], al[4][4];
  uint32_t dhi;
  int rel;
};

// The next product a tdx_f32 consumer prepares: the CTA's i-th tile, its
// pixel box (and band), its K step k (channel box, tap; halo mode: ky),
// its kx in halo mode, and its ring slot and phase.
struct Pos32 {
  int i, k, kx, st, ph, cbox, tap;
  int img, x0, y0, key, band_y0;
};

template <int BN, bool OVL, class Tr>
__global__ void __launch_bounds__(THREADS, 1)
tdx_f32(const __grid_constant__ CUtensorMap mdy,
        const __grid_constant__ CUtensorMap maux,
        const __grid_constant__ CUtensorMap mw,
        const __grid_constant__ CUtensorMap me,
        const __grid_constant__ CUtensorMap my, const DxArgs a, const Tr tr) {
  constexpr bool FWD = Tr::kFwd;        // out_kind 4, else 3 (banded: 0-2)
  constexpr bool AUX = Tr::kAux > 0;    // y beside dy (the backward)
  constexpr bool BANDED = banded<Tr>::value;
  constexpr int BBOX = BN * 128;        // bytes of one weight box (hi or lo)
  constexpr int HALF = 64 * BN * 4;     // bytes of a warpgroup's half slot
  extern __shared__ uint8_t raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  const int hrows = (a.wb + 2) * a.hb;  // rows of a halo box
  const int abox = a.halo ? round1k(hrows * 128) : ABOX;
  const int stage_bytes =
      dx32_stage_bytes(BN, a.halo, a.wb, a.hb, AUX, a.resident);
  const int w_at = abox * (AUX ? 2 : 1);  // the A box, its y box, weights
  // the ring, the resident weight (K step k's hi and lo boxes at 2k, 2k +
  // 1), the epilogue slots
  uint8_t* wres = smem + a.stages * stage_bytes;
  uint8_t* eslot = wres + (a.resident ? a.ksteps * 2 * BBOX : 0);
  // the 8 warps' column sums, then the CTA's mask (a, b), then the fused
  // transforms' running sums of the CTA's tiles
  float* red = reinterpret_cast<float*>(eslot + a.eslots * 2 * HALF);
  double* run = reinterpret_cast<double*>(red + 9 * 2 * BN);
  uint64_t* full = reinterpret_cast<uint64_t*>(run + 2 * BN);
  uint64_t* empty = full + a.stages;
  uint64_t* wbar = empty + a.stages;
  uint64_t* efull = wbar + 1;
  uint64_t* edone = efull + 3;

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int tid = threadIdx.x % 128;
  const int half = a.ks / 2;

  if (threadIdx.x == 0) {
    for (int i = 0; i < a.stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 2);
    }
    mbar_init(wbar, 1);
    for (int i = 0; i < 3; ++i) {
      mbar_init(&efull[i], 1);
      mbar_init(&edone[i], 2);
    }
    fence_barrier_init();
  }
  __syncthreads();

  auto tile_of = [&](int t, int& img, int& x0, int& y0, int& col) {
    col = t % a.col_tiles;
    t /= a.col_tiles;
    x0 = (t % a.tiles_w) * a.wb;
    t /= a.tiles_w;
    y0 = (t % a.tiles_h) * a.hb;
    img = t / a.tiles_h;
  };
  const int groups = gridDim.x / a.col_tiles;
  const int row_tiles = a.tiles / a.col_tiles;
  const int grp = blockIdx.x / a.col_tiles;
  const int r_lo = (int)((long long)grp * row_tiles / groups);
  const int ntiles = (int)((long long)(grp + 1) * row_tiles / groups) - r_lo;
  const int n0 = (int)(blockIdx.x % a.col_tiles) * BN;  // the CTA's column
  auto tile_at = [&](int i) {
    return (r_lo + i) * a.col_tiles + (int)blockIdx.x % a.col_tiles;
  };
  // the epilogue slot's TMA boxes of tile t (load or store): each
  // warpgroup's 64 rows, 32 columns a box
  auto slot_boxes = [&](int t, uint8_t* slot, bool load, uint64_t* bar) {
    int img, x0, y0, col;
    tile_of(t, img, x0, y0, col);
    for (int g = 0; g < 2; ++g) {
      const int sx = a.wb == TM ? x0 + 64 * g : x0;
      const int sy = a.wb == TM ? y0 : y0 + g * (a.hb / 2);
      for (int sub = 0; sub < BN / 32; ++sub) {
        uint8_t* box = slot + g * HALF + sub * (64 * 128);
        if (load)
          tma_load_4d(box, &me, bar, col * BN + 32 * sub, sx, sy, img);
        else
          tma_store_4d(&my, box, col * BN + 32 * sub, sx, sy, img);
      }
    }
  };

  if (wg == 2) {
    // ------------------------------------------------------------ producer
    regs_shrink<40>();
    if (tid == 0) {
      prefetch_map(&mdy);
      if (AUX) prefetch_map(&maux);
      prefetch_map(&mw);
      if (a.resident) {
        // the grid is a multiple of the column tiles: every tile of this
        // CTA has the column of its first
        mbar_expect_tx(wbar, a.ksteps * 2 * BBOX);
        for (int k = 0; k < a.ksteps; ++k)
          for (int part = 0; part < 2; ++part)
            tma_load_4d(wres + (2 * k + part) * BBOX, &mw, wbar,
                        (k % a.cb) * 32, k / a.cb, n0, part);
      }
      const int tx_bytes = a.halo ? hrows * 128 * (AUX ? 2 : 1) + 6 * BBOX
                                  : stage_bytes;
      // the ring slot and its phase, and the K step's channel box and tap
      // (halo mode: ky), kept as running counters
      int st = 0, ph = 0;
      for (int i = 0; i < ntiles; ++i) {
        int img, x0, y0, col;
        tile_of(tile_at(i), img, x0, y0, col);
        int c0 = 0, tap = 0, kx = -half, ky = -half;
        for (int k = 0; k < a.ksteps; ++k) {
          mbar_wait(&empty[st], ph ^ 1);
          uint8_t* buf = smem + st * stage_bytes;
          mbar_expect_tx(&full[st], tx_bytes);
          const int sx = a.halo ? x0 - 1 : x0 + kx;
          const int sy = a.halo ? y0 + tap - 1 : y0 + ky;
          tma_load_4d(buf, &mdy, &full[st], c0, sx, sy, img);
          if (AUX) tma_load_4d(buf + abox, &maux, &full[st], c0, sx, sy, img);
          if (!a.resident)
            for (int j = 0; j < (a.halo ? 3 : 1); ++j)
              for (int part = 0; part < 2; ++part)
                tma_load_4d(buf + w_at + (2 * j + part) * BBOX, &mw,
                            &full[st], c0, a.halo ? 3 * tap + j : tap,
                            col * BN, part);
          if ((c0 += 32) == 32 * a.cb) {
            c0 = 0;
            ++tap;
            if (++kx > half) kx = -half, ++ky;
          }
          if (++st == a.stages) st = 0, ph ^= 1;
        }
      }
    } else if (tid == 32) {
      // the epilogue slots, on a thread of their own: a slot's last tile
      // is done, so store it from the slot, let the store read it, then
      // fill the slot with the next tile's input (the backward's x; banded:
      // x for gm, the addend where there is one)
      bool ein;
      if constexpr (BANDED)
        ein = !FWD && (a.out_kind == 0 || a.add_kind != 0);
      else
        ein = !FWD;
      if (ein) prefetch_map(&me);
      prefetch_map(&my);
      int i = 0;
      for (; i < ntiles; ++i) {
        const int t = tile_at(i), e = i % a.eslots;
        mbar_wait(&edone[e], ((i / a.eslots) & 1) ^ 1);
        uint8_t* slot = eslot + e * 2 * HALF;
        if (i >= a.eslots) {
          slot_boxes(tile_at(i - a.eslots), slot, false, nullptr);
          bulk_commit();
          bulk_wait_read<0>();
        }
        if (ein) {
          mbar_expect_tx(&efull[e], 2 * HALF);
          slot_boxes(t, slot, true, &efull[e]);
        } else {
          mbar_arrive(&efull[e]);
        }
      }
      // the last tiles' stores
      for (int j = i < a.eslots ? 0 : i - a.eslots; j < i; ++j) {
        mbar_wait(&edone[j % a.eslots], (j / a.eslots) & 1);
        slot_boxes(tile_at(j), eslot + (j % a.eslots) * 2 * HALF, false,
                   nullptr);
      }
      bulk_commit();
      bulk_wait<0>();
    }
  } else {
    // ----------------------------------------------------------- consumers
    regs_grow<232>();
    float acc[BN / 2], sum[BN / 2];
    const int ct = threadIdx.x;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    // the tile row this lane gives ldmatrix: rows l % 8 + 8 (l / 8 % 2) of
    // the warp's 16, 16-byte chunk 2 kk + l / 16 of the row
    const int lr = 64 * wg + 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1);
    // halo mode: its row in the halo box at kx = 0 (each warpgroup's 64
    // output pixels lie in one image row)
    const int hr0 = (lr >> a.lwb) * (a.wb + 2) + (lr & (a.wb - 1));
    const int nkx = a.halo ? 3 : 1;  // products a slot
    // banded: the rows of a band
    [[maybe_unused]] int gh = 1;
    if constexpr (BANDED) gh = tr.band_px / a.w;
    if constexpr (!FWD && !BANDED) {  // the mask's (a, b) of the CTA's columns
      if (ct < 2 * BN)
        red[8 * 2 * BN + ct] =
            __ldg(tr.ab_row() + (ct / BN) * a.ci + n0 + ct % BN);
      bar_sync(1, CONSUMERS);
    }
    const float* sab = red + 8 * 2 * BN;
    if (!BANDED && ct < 2 * BN) run[ct] = 0.0;  // thread ct's alone
    if (a.resident) mbar_wait(wbar, 0);

    // the next product to prepare (its ring slot and phase run on from
    // tile to tile)
    Pos32 c{};
    // c at the first product of the CTA's i-th tile
    auto enter = [&](int i) {
      c.i = i;
      c.k = c.kx = c.cbox = c.tap = 0;
      if (i >= ntiles) return;
      int col;
      tile_of(tile_at(i), c.img, c.x0, c.y0, col);
      if constexpr (BANDED) {
        c.key = tr.key((c.img * a.h + c.y0) * a.w + c.x0);
        c.band_y0 = c.y0 - c.y0 % gh;
      }
    };
    // the product at c into f, then c to the next one
    auto prep = [&](Frag32& f) {
      if (c.kx == 0) mbar_wait(&full[c.st], c.ph);
      const uint8_t* buf = smem + c.st * stage_bytes;
      // the pixel read: the output pixel shifted by the tap (halo mode:
      // ky and kx)
      const int ty = a.ks == 3 ? c.tap / 3 : 0;
      const int dxp = a.halo ? c.kx - 1 : c.tap - 3 * ty - half;
      const int dyp = a.halo ? c.tap - 1 : ty - half;
      bool live[2];
      // banded: the seam term's row at the pixel read (its band's first or
      // last row), else null
      [[maybe_unused]] const float* ep[2] = {nullptr, nullptr};
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int r = 64 * wg + 16 * warp + g + 8 * h2;
        const int ox = c.x0 + (r & (a.wb - 1)), oy = c.y0 + (r >> a.lwb);
        const int sx = ox + dxp, sy = oy + dyp;
        live[h2] = ox < a.w && oy < a.h && sx >= 0 && sx < a.w && sy >= 0 &&
                   sy < a.h;
        if constexpr (BANDED) {
          if (a.band_px > 0)
            live[h2] = live[h2] && sy >= c.band_y0 && sy < c.band_y0 + gh;
          if (live[h2]) ep[h2] = tr.edge_row((c.img * a.h + sy) * a.w + sx);
        }
      }
      const int hr = a.halo ? hr0 + c.kx : lr;
      const uint32_t rowaddr = smem_u32(buf) + hr * 128;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t off = (((2 * kk + (lane >> 4)) ^ hr) & 7) << 4;
        uint32_t v[4], y[4] = {};
        ldsm_x4(rowaddr + off, v);
        if (AUX) ldsm_x4(rowaddr + abox + off, y);
        typename Tr::K8 tb;
        if constexpr (BANDED)
          tr.k8_tab(tb, c.key, 32 * c.cbox + 8 * kk + t4);
        else
          tr.k8_tab(tb, 32 * c.cbox + 8 * kk + t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // v[e]: row g + 8 (e % 2), channel t4 + 4 (e / 2) of the k8 step
          float fv = live[e & 1] ? tr.k8(__uint_as_float(v[e]),
                                         __uint_as_float(y[e]), tb, e >> 1)
                                 : 0.f;
          if constexpr (BANDED)
            if (ep[e & 1])
              fv = __fadd_rn(fv, __ldg(ep[e & 1] + 32 * c.cbox + 8 * kk + t4 +
                                       4 * (e >> 1)));
          tf32_split(fv, f.ah[kk][e], f.al[kk][e]);
        }
      }
      f.dhi = (uint32_t)sw128_desc(a.resident ? wres + c.k * 2 * BBOX
                                              : buf + w_at + 2 * c.kx * BBOX,
                                   16, 1024);
      f.rel = c.kx == nkx - 1 ? c.st : -1;
      if (++c.kx == nkx) {
        c.kx = 0;
        if (++c.st == a.stages) c.st = 0, c.ph ^= 1;
        if (++c.cbox == a.cb) c.cbox = 0, ++c.tap;
        if (++c.k == a.ksteps) enter(c.i + 1);
      }
    };
    // the descriptors' high word (sw128_desc's: sbo 1024, the swizzle)
    const uint64_t desc_hi = sw128_desc(smem, 16, 1024) & ~0xFFFFFFFFull;
    // f's twelve products into the fresh accumulator, committed
    auto start = [&](Frag32& f) {
      const uint64_t dhi = desc_hi | f.dhi, dlo = dhi + (BBOX >> 4);
      // the first k8 step writes acc without reading it: acc's registers
      // hold nothing from the last retire to here
      wgmma_fence();
      WgmmaTf32R<BN>::mma0(acc, f.al[0], dhi);
#pragma unroll
      for (int kk = 1; kk < 4; ++kk)  // 32 bytes a k8 step, >> 4
        WgmmaTf32R<BN>::mma(acc, f.al[kk], dhi + 2 * kk, 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        WgmmaTf32R<BN>::mma(acc, f.ah[kk], dlo + 2 * kk, 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        WgmmaTf32R<BN>::mma(acc, f.ah[kk], dhi + 2 * kk, 1);
      wgmma_commit();
      fence_operands(acc);
    };
    // f's products waited for (its registers kept to here), added to the
    // sum, and its slot released where f was the slot's last product
    auto retire = [&](Frag32& f) {
      wgmma_wait<0>();
      fence_operands(acc);
      fence_frags(f.ah);
      fence_frags(f.al);
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) sum[e] += acc[e];
      if (f.rel >= 0 && tid == 0) mbar_arrive(&empty[f.rel]);
    };
    // product f, and the next one prepared into `next` (where `more`):
    // under f's products with OVL, after them without
    auto step = [&](Frag32& f, Frag32& next, bool more) {
      start(f);
      if constexpr (OVL) {
        if (more) prep(next);
        retire(f);
      } else {
        retire(f);
        if (more) prep(next);
      }
    };

    // two fragment sets with OVL, one without
    Frag32 f0, f1;
    Frag32& fb = OVL ? f1 : f0;
    enter(0);
    if (ntiles > 0) prep(f0);
    // a tile's products: even, since co / 32 is
    const int nprod = a.ksteps * nkx;
    for (int i = 0; i < ntiles; ++i) {
      const int t = tile_at(i);
      int img, x0, y0, col;
      tile_of(t, img, x0, y0, col);
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) sum[e] = 0.f;
      // banded gm: the mask's (a, b) of value ct under the tile's band,
      // loaded before the products
      [[maybe_unused]] float abv = 0.f;
      if constexpr (BANDED && !FWD)
        if (a.out_kind == 0 && ct < 2 * BN)
          abv = __ldg(tr.ab_row(tr.key((img * a.h + y0) * a.w + x0)) +
                      (ct / BN) * a.ci + n0 + ct % BN);
      for (int q = 0; q < nprod; q += 2) {
        step(f0, fb, true);
        step(fb, f0, q + 2 < nprod || i + 1 < ntiles);
      }

      // ---------------------------------------------------------- epilogue
      const int e = i % a.eslots;
      uint8_t* slot = eslot + e * 2 * HALF + wg * HALF;
      if constexpr (BANDED && !FWD) {
        // the mask's (a, b) of the tile's band; the last tile's readers
        // are past the barrier that ends its sums
        if (a.out_kind == 0) {
          if (ct < 2 * BN) red[8 * 2 * BN + ct] = abv;
          bar_sync(1, CONSUMERS);
        }
      }
      mbar_wait(&efull[e], (i / a.eslots) & 1);
      // the thread's column sums over its two rows of the tile
      float cs0[BN / 8][2] = {}, cs1[BN / 8][2] = {};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int cl = 8 * j + 2 * t4;
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int row = 16 * warp + g + 8 * e2, r = 64 * wg + row;
          const int ox = x0 + (r & (a.wb - 1)), oy = y0 + (r >> a.lwb);
          const bool in = ox < a.w && oy < a.h;
          float2* sp = reinterpret_cast<float2*>(slot + staged_offset32(row, cl));
          float u = sum[4 * j + 2 * e2], v = sum[4 * j + 2 * e2 + 1];
          if constexpr (FWD) {
            // y; the sums of the pixels in the image
            *sp = make_float2(u, v);
            u = in ? u : 0.f;
            v = in ? v : 0.f;
            cs0[j][0] += u;
            cs0[j][1] += v;
            cs1[j][0] += u * u;
            cs1[j][1] += v * v;
          } else if constexpr (BANDED) {
            if (a.out_kind == 0) {
              // gm = g*[x*a + b > 0] stored over x; sums [gm*x, gm]
              const float2 xv = *sp;
              u = in && affine(xv.x, sab[cl], sab[BN + cl]) > 0.f ? u : 0.f;
              v = in && affine(xv.y, sab[cl + 1], sab[BN + cl + 1]) > 0.f
                      ? v : 0.f;
              cs0[j][0] += u * xv.x;
              cs0[j][1] += v * xv.y;
              cs1[j][0] += u;
              cs1[j][1] += v;
            } else if (a.add_kind != 0) {
              // dX + the f32 addend, loaded over the slot
              const float2 ad = *sp;
              u += ad.x;
              v += ad.y;
            }
            *sp = make_float2(u, v);
          } else {
            // gm = g*[x*a + b > 0], dx = gm*a over x; sums [gm*x, gm]
            const float2 xv = *sp;
            const float ta0 = sab[cl], ta1 = sab[cl + 1];
            u = in && affine(xv.x, ta0, sab[BN + cl]) > 0.f ? u : 0.f;
            v = in && affine(xv.y, ta1, sab[BN + cl + 1]) > 0.f ? v : 0.f;
            cs0[j][0] += u * xv.x;
            cs0[j][1] += v * xv.y;
            cs1[j][0] += u;
            cs1[j][1] += v;
            *sp = make_float2(u * ta0, v * ta1);
          }
        }
      }
      // the slot is done (its output staged): the producer stores it
      fence_async_smem();
      bar_sync(2 + wg, 128);
      if (tid == 0) mbar_arrive(&edone[e]);
      // the tile's sums: banded (the forward's, gm's), into the tile's
      // entry (its row tile); fused, added in double to the CTA's
      bool with_sums = true;
      if constexpr (BANDED && !FWD) with_sums = a.out_kind == 0;
      if (with_sums) {
        const float s = tile_sums<BN>(cs0, cs1, red, wg, warp, lane, ct);
        if (ct < 2 * BN) {
          if constexpr (BANDED)
            a.part[((size_t)(t / a.col_tiles) * 2 + ct / BN) * a.ci + n0 +
                   ct % BN] = s;
          else
            run[ct] += s;
        }
      }
    }
    // the fused transforms: the CTA's sums into its entry
    if constexpr (!BANDED)
      if (ct < 2 * BN)
        a.part[((size_t)grp * 2 + ct / BN) * a.ci + n0 + ct % BN] =
            (float)run[ct];
  }
}

// ------------------------------------------------------------------ host

template <int BN, bool TWO, class Tr>
int launch_dw(const CUtensorMap& mx, const CUtensorMap& mdy,
              const CUtensorMap& maux, const DwArgs& a, const Tr& tr,
              dim3 grid, int smem, cudaStream_t s) {
  static bool set[64] = {};
  cudaError_t e = allow_smem(tdw<BN, TWO, Tr>, set, MAX_SMEM);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = a.cs;
  cfg.attrs = attr;
  cfg.numAttrs = a.cs > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, tdw<BN, TWO, Tr>, mx, mdy, maux, a, tr);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// The dW plan (ops/conv.py tma_dw_plan): a pixel box of wb x hb (wb*hb =
// 64), bn columns a CTA (64, 128 or 256; 64 or 128 with a staging
// transform), two = 1 where the table has more than one 64-row chunk,
// `stages` ring slots, the pixel tiles split `splits` ways (each split
// non-empty) in clusters of cs (1, 2 or 4; splits a multiple).
struct DwPlan {
  int wb, hb, bn, two, stages, splits, cs;
};

// dw (ks*ks*ci, co) f32 = im2col(T_x(x))^T . T_dy(dy, aux) over n images
// of h x w (a 1x1's rows: 1, 1, M); x (.., ci) and dy (.., co) bf16, aux
// (.., co) of Tr::kAux bytes an element (none where 0: T_x and T_dy are
// then the identity, and ci, co need only be multiples of 8). With splits
// / cs > 1, ws holds that many tables. Returns the first launch error, or
// cudaErrorInvalidValue for a shape or plan the kernel does not take.
template <class Tr>
int run_dw(const void* x, const void* dy, const void* aux, float* dw,
           float* ws, int n, int h, int w, int ci, int co, int ks,
           const DwPlan& p, const Tr& tr, cudaStream_t s) {
  constexpr bool STAGED = Tr::kAux > 0;
  const int q = STAGED ? 64 : 8;  // the channel multiple taken
  const size_t size = (size_t)ks * ks * ci * co;
  if (ci < q || co < q || ci % q || co % q || (ks != 1 && ks != 3) ||
      !aligned16(x) || !aligned16(dy) || (STAGED && !aligned16(aux)) ||
      !aligned16(dw))
    return cudaErrorInvalidValue;
  if ((long long)n * h * w == 0)
    return cudaMemsetAsync(dw, 0, sizeof(float) * size, s);
  DwArgs a{};
  a.out = p.splits / p.cs > 1 ? ws : dw;
  a.h = h, a.w = w, a.ci = ci, a.co = co, a.ks = ks, a.wb = p.wb,
  a.hb = p.hb;
  a.tiles_w = (w + p.wb - 1) / p.wb;
  a.tiles_h = (h + p.hb - 1) / p.hb;
  const long long ntiles = (long long)n * a.tiles_w * a.tiles_h;
  a.ntiles = (int)ntiles;
  a.cchunks = (ci + 63) / 64;
  a.rchunks = ks * ks * a.cchunks;
  a.stages = p.stages, a.splits = p.splits, a.cs = p.cs;
  const int stage = dw_stage_bytes<Tr>(p.bn, p.two);
  const int smem = p.stages * stage + 16 * p.stages + 1024;
  if (p.wb < 1 || p.hb < 1 || p.wb * p.hb != KP || p.wb > 256 ||
      p.hb > 256 || (p.bn != 64 && p.bn != 128 && (STAGED || p.bn != 256)) ||
      (STAGED && co % p.bn) || p.two != (a.rchunks > 1) || p.stages < 2 ||
      (p.cs != 1 && p.cs != 2 && p.cs != 4) || p.splits < 1 ||
      p.splits % p.cs || p.splits > ntiles || ntiles >= (1ll << 31) ||
      smem > MAX_SMEM || 2 * 64 * (p.bn + 8) * 4 > p.stages * stage ||
      (p.splits / p.cs > 1 && !ws))
    return cudaErrorInvalidValue;
  CUtensorMap mx, mdy, maux;
  if (!encode_act(&mx, x, false, ci, w, h, n, p.wb, p.hb) ||
      !encode_act(&mdy, dy, false, co, w, h, n, p.wb, p.hb) ||
      (STAGED && !encode_act(&maux, aux, Tr::kAux == 4, co, w, h, n, p.wb,
                             p.hb)))
    return cudaErrorInvalidValue;
  if (!STAGED) maux = mdy;  // unread
  const dim3 grid(p.two ? (a.rchunks + 1) / 2 : 1, (co + p.bn - 1) / p.bn,
                  p.splits);
  auto go = [&](auto two) {
    constexpr bool T = decltype(two)::value;
    if constexpr (!STAGED)
      if (p.bn == 256)
        return launch_dw<256, T>(mx, mdy, maux, a, tr, grid, smem, s);
    return p.bn == 128 ? launch_dw<128, T>(mx, mdy, maux, a, tr, grid, smem, s)
                       : launch_dw<64, T>(mx, mdy, maux, a, tr, grid, smem, s);
  };
  const int err = p.two ? go(std::true_type{}) : go(std::false_type{});
  if (err != cudaSuccess || p.splits / p.cs == 1) return err;
  const int blocks =
      (int)((size + 255) / 256 < 4096 ? (size + 255) / 256 : 4096);
  sum_tables<<<blocks, 256, 0, s>>>(ws, dw, size, p.splits / p.cs);
  return cudaGetLastError();
}

// Launches the float32 dW of tile (BN, TWO) with runs of R k8 steps:
// tdw_f32_wg without a transform, tdw_f32_tr with one.
template <int BN, bool TWO, int R, class Tr>
int launch_dw32(const CUtensorMap& mx, const CUtensorMap& mdy,
                const CUtensorMap& maux, const DwArgs& a, const Tr& tr,
                dim3 grid, int smem, cudaStream_t s) {
  static bool set[64] = {};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = a.cs;
  cfg.attrs = attr;
  cfg.numAttrs = a.cs > 1 ? 1 : 0;
  cudaError_t e;
  if constexpr (Tr::kAux == 0) {
    e = allow_smem(tdw_f32_wg<BN, TWO, R>, set, MAX_SMEM);
    if (e != cudaSuccess) return e;
    e = cudaLaunchKernelEx(&cfg, tdw_f32_wg<BN, TWO, R>, mx, mdy, a);
  } else {
    e = allow_smem(tdw_f32_tr<BN, TWO, R, Tr>, set, MAX_SMEM);
    if (e != cudaSuccess) return e;
    e = cudaLaunchKernelEx(&cfg, tdw_f32_tr<BN, TWO, R, Tr>, mx, mdy, maux,
                           a, tr);
  }
  return e != cudaSuccess ? e : cudaGetLastError();
}

// run_dw in float32 (tdw_f32_wg, or tdw_f32_tr with a staging transform):
// x (.., ci), dy (.., co) and aux (.., co) f32; without a transform (no
// aux) ci and co multiples of 8, with one (Tr::kAux 4) multiples of 64;
// the plan as run_dw's with bn 64 or 128 (ops/conv.py tma_dw_plan with
// 4-byte elements, and aux 4 with a transform); `run` (1, 2 or 4;
// ops/conv.py DW32_RUN) k8 steps a fresh accumulator. The clusters'
// tables are added in double by sum_tables_wide.
template <class Tr>
int run_dw_f32(const void* x, const void* dy, const void* aux, float* dw,
               float* ws, int n, int h, int w, int ci, int co, int ks,
               const DwPlan& p, const Tr& tr, int run, cudaStream_t s) {
  constexpr bool STAGED = Tr::kAux > 0;
  const int q = STAGED ? 64 : 8;  // the channel multiple taken
  const size_t size = (size_t)ks * ks * ci * co;
  if (ci < q || co < q || ci % q || co % q || (ks != 1 && ks != 3) ||
      (run != 1 && run != 2 && run != 4) || !aligned16(x) ||
      !aligned16(dy) || (STAGED && !aligned16(aux)) || !aligned16(dw))
    return cudaErrorInvalidValue;
  if ((long long)n * h * w == 0)
    return cudaMemsetAsync(dw, 0, sizeof(float) * size, s);
  DwArgs a{};
  a.out = p.splits / p.cs > 1 ? ws : dw;
  a.h = h, a.w = w, a.ci = ci, a.co = co, a.ks = ks, a.wb = p.wb,
  a.hb = p.hb;
  a.tiles_w = (w + p.wb - 1) / p.wb;
  a.tiles_h = (h + p.hb - 1) / p.hb;
  const long long ntiles = (long long)n * a.tiles_w * a.tiles_h;
  a.ntiles = (int)ntiles;
  a.cchunks = (ci + 63) / 64;
  a.rchunks = ks * ks * a.cchunks;
  a.stages = p.stages, a.splits = p.splits, a.cs = p.cs;
  const int stage = dw32_stage_bytes(p.bn, p.two);
  const int smem = p.stages * stage + 16 * p.stages + 1024;
  if (p.wb < 1 || p.hb < 1 || p.wb * p.hb != KP || p.wb > 256 ||
      p.hb > 256 || (p.bn != 64 && p.bn != 128) || (STAGED && co % p.bn) ||
      p.two != (a.rchunks > 1) || p.stages < 2 ||
      (p.cs != 1 && p.cs != 2 && p.cs != 4) || p.splits < 1 ||
      p.splits % p.cs || p.splits > ntiles || ntiles >= (1ll << 31) ||
      smem > MAX_SMEM || 2 * 64 * (p.bn + 8) * 4 > p.stages * stage ||
      (p.splits / p.cs > 1 && !ws))
    return cudaErrorInvalidValue;
  CUtensorMap mx, mdy, maux;
  if (!encode_act32(&mx, x, ci, w, h, n, p.wb, p.hb) ||
      !encode_act32(&mdy, dy, co, w, h, n, p.wb, p.hb) ||
      (STAGED && !encode_act32(&maux, aux, co, w, h, n, p.wb, p.hb)))
    return cudaErrorInvalidValue;
  if (!STAGED) maux = mdy;  // unread
  const dim3 grid(p.two ? (a.rchunks + 1) / 2 : 1, (co + p.bn - 1) / p.bn,
                  p.splits);
  auto go = [&](auto two, auto rn) {
    constexpr bool T = decltype(two)::value;
    constexpr int R = decltype(rn)::value;
    return p.bn == 128
               ? launch_dw32<128, T, R>(mx, mdy, maux, a, tr, grid, smem, s)
               : launch_dw32<64, T, R>(mx, mdy, maux, a, tr, grid, smem, s);
  };
  auto by_run = [&](auto two) {
    return run == 4   ? go(two, std::integral_constant<int, 4>{})
           : run == 2 ? go(two, std::integral_constant<int, 2>{})
                      : go(two, std::integral_constant<int, 1>{});
  };
  const int err = p.two ? by_run(std::true_type{}) : by_run(std::false_type{});
  if (err != cudaSuccess || p.splits / p.cs == 1) return err;
  const int blocks =
      (int)((size + 255) / 256 < 4096 ? (size + 255) / 256 : 4096);
  sum_tables_wide<<<blocks, 256, 0, s>>>(ws, dw, size, p.splits / p.cs);
  return cudaGetLastError();
}

template <int BN, class Tr>
int launch_dx(const CUtensorMap& mdy, const CUtensorMap& maux,
              const CUtensorMap& mw, const CUtensorMap& me,
              const CUtensorMap& my, const DxArgs& a, const Tr& tr, int grid,
              int smem, cudaStream_t s) {
  static bool set[64] = {};
  const cudaError_t e = allow_smem(tdx<BN, Tr>, set, MAX_SMEM);
  if (e != cudaSuccess) return e;
  tdx<BN, Tr><<<grid, THREADS, smem, s>>>(mdy, maux, mw, me, my, a, tr);
  return cudaGetLastError();
}

// The dX plan (ops/conv.py tma_bwd_dx_plan; the forward's is
// tma_staged_fwd_plan, the same with the channel counts swapped and no
// aux box): a pixel box of wb x hb (wb*hb = 128; hb divides the band
// height of a ghost conv), bn (64 or 128) columns a tile, the weight
// resident (1) or streamed, `stages` ring slots, `grid` persistent CTAs
// (a multiple of the column tiles), `eslots` epilogue slots (0 to 3).
struct DxPlan {
  int wb, hb, bn, resident, stages, grid, eslots;
  int overlap = 0;  // tdx_f32 only: its OVL
};

// dX (n, h, w, ci) of T_dy(dy, aux) (n, h, w, co) * wflip (ci, ks*ks*co),
// finished as a.out_kind says (a.out, a.addend, a.add_kind, a.band_px set
// by the caller; ein: x, or the bf16 addend, where dx_ein); with sums,
// part holds the entries (Tr::kPerCta: grid / col_tiles; else the
// row tiles, gh / hb * tiles_w a band) and sums (groups, 2, ci) receives
// their sums, written whole. The forward (out_kind 4, Tr::kFwd) is the
// same call with dy = x (n, h, w, co), no aux, wflip = W (ci, ks*ks*co):
// here ci is the conv's output channels and co its input channels.
template <class Tr>
int run_dx(const void* dy, const void* aux, const void* wflip,
           const void* ein, DxArgs a, float* part, float* sums, int n, int h,
           int w, int ci, int co, int ks, int gh, const DxPlan& p,
           const Tr& tr, cudaStream_t s) {
  constexpr int AUX = Tr::kAux;
  const bool with_sums = dx_sums(a.out_kind);
  const bool staged = dx_staged(a.out_kind);
  const bool in_slot = dx_ein(a.out_kind, a.add_kind);
  // the sums' groups: everything (kPerCta), or each band of gh rows
  const long long groups =
      Tr::kPerCta ? 1 : (gh > 0 ? n * (long long)(h / gh) : 0);
  if (ci % 64 || co % 64 || (ks != 1 && ks != 3) || !aligned16(dy) ||
      (AUX && !aligned16(aux)) || !aligned16(wflip) || !aligned16(a.out) ||
      (in_slot && !aligned16(ein)) || (with_sums && (!part || !sums)) ||
      Tr::kFwd != (a.out_kind == 4) || (Tr::kFwd && a.band_px) ||
      ((a.band_px > 0 || (with_sums && !Tr::kPerCta)) && (gh < 1 || h % gh)))
    return cudaErrorInvalidValue;
  if ((long long)n * h * w == 0)
    return with_sums ? cudaMemsetAsync(sums, 0,
                                       sizeof(float) * groups * 2 * ci, s)
                     : cudaSuccess;
  a.part = part;
  a.h = h, a.w = w, a.ci = ci, a.co = co, a.ks = ks, a.wb = p.wb, a.hb = p.hb;
  while (a.lwb < 8 && (1 << a.lwb) < p.wb) ++a.lwb;
  a.tiles_w = (w + p.wb - 1) / p.wb;
  a.tiles_h = (h + p.hb - 1) / p.hb;
  a.col_tiles = ci / p.bn;
  const long long rows = (long long)n * a.tiles_w * a.tiles_h;
  const long long tiles = rows * a.col_tiles;
  a.tiles = (int)tiles;
  a.cb = co / 64;
  a.halo = dx_halo(ks, p.wb);
  a.ksteps = (a.halo ? 3 : ks * ks) * a.cb;
  a.stages = p.stages, a.resident = p.resident, a.eslots = p.eslots;
  const int bbox = p.bn * 128;
  const int smem =
      p.stages * dx_stage_bytes(p.bn, p.resident, a.halo, p.wb, p.hb, AUX) +
      (p.resident ? a.ksteps * bbox : 0) + p.eslots * TM * p.bn * 2 +
      9 * 2 * p.bn * 4 + 8 * (2 * p.stages + 7) + 1024;
  if (p.wb < 1 || p.hb < 1 || p.wb * p.hb != TM || p.wb != 1 << a.lwb ||
      p.hb > 256 || (p.bn != 64 && p.bn != 128) || ci % p.bn ||
      p.stages < 2 || smem > MAX_SMEM || p.grid < 1 || p.grid > tiles ||
      tiles >= (1ll << 31) || p.grid % a.col_tiles ||
      (a.halo && p.resident) || p.eslots < 0 || p.eslots > 3 ||
      ((staged || in_slot) && p.eslots < 1) ||
      ((a.band_px > 0 || (with_sums && !Tr::kPerCta)) && gh % p.hb))
    return cudaErrorInvalidValue;
  CUtensorMap mdy, maux, mw, me, my;
  const cuuint64_t wdims[3] = {(cuuint64_t)co, (cuuint64_t)(ks * ks),
                               (cuuint64_t)ci};
  const cuuint32_t wbox[3] = {64, 1, (cuuint32_t)p.bn};
  // the epilogue slot's boxes: a warpgroup's 64 rows of the tile, 64
  // columns a box
  const cuuint64_t ydims[4] = {(cuuint64_t)ci, (cuuint64_t)w, (cuuint64_t)h,
                               (cuuint64_t)n};
  const int sw = p.wb < 64 ? p.wb : 64;
  const cuuint32_t ybox[4] = {64, (cuuint32_t)sw, (cuuint32_t)(64 / sw), 1};
  // the A box: the tile's box, or in halo mode its rows widened by the
  // pixel on either side
  const int awb = a.halo ? p.wb + 2 : p.wb;
  if (!encode_act(&mdy, dy, false, co, w, h, n, awb, p.hb) ||
      (AUX && !encode_act(&maux, aux, AUX == 4, co, w, h, n, awb, p.hb)) ||
      !encode(&mw, wflip, false, 3, wdims, wbox, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  me = my = mdy;  // unread unless set below
  if (!AUX) maux = mdy;
  if ((in_slot && !encode(&me, ein, false, 4, ydims, ybox,
                          CU_TENSOR_MAP_SWIZZLE_128B)) ||
      (staged && !encode(&my, a.out, false, 4, ydims, ybox,
                         CU_TENSOR_MAP_SWIZZLE_128B)))
    return cudaErrorInvalidValue;
  const int err = p.bn == 128
                      ? launch_dx<128>(mdy, maux, mw, me, my, a, tr, p.grid,
                                       smem, s)
                      : launch_dx<64>(mdy, maux, mw, me, my, a, tr, p.grid,
                                      smem, s);
  if (err != cudaSuccess || !with_sums) return err;
  // the entries of a group: a CTA's (kPerCta: one group), or a band's row
  // tiles, which are consecutive: gh / hb rows of tiles_w tiles
  const int entries =
      Tr::kPerCta ? p.grid / a.col_tiles : gh / p.hb * a.tiles_w;
  reduce_parts<<<dim3((2 * ci + 127) / 128, (unsigned)groups), 128, 0, s>>>(
      part, sums, 2 * ci, entries);
  return cudaGetLastError();
}

template <int BN, bool OVL, class Tr>
int launch_dx_f32(const CUtensorMap& mdy, const CUtensorMap& maux,
                  const CUtensorMap& mw, const CUtensorMap& me,
                  const CUtensorMap& my, const DxArgs& a, const Tr& tr,
                  int grid, int smem, cudaStream_t s) {
  static bool set[64] = {};
  const cudaError_t e = allow_smem(tdx_f32<BN, OVL, Tr>, set, MAX_SMEM);
  if (e != cudaSuccess) return e;
  tdx_f32<BN, OVL, Tr><<<grid, THREADS, smem, s>>>(mdy, maux, mw, me, my, a,
                                                   tr);
  return cudaGetLastError();
}

// tdx_f32<128, true, Tr> where Tr is a forward's transform. A dX's ring
// at BN 128 (the A box, its aux box and the weight's hi and lo boxes: 64
// KiB a slot, beside a 64 KiB epilogue slot) keeps two slots, where a
// product prepared under its predecessor would hold both, so no plan asks
// for that instantiation and none is built.
template <class Tr>
const void* dx32_fwd_only() {
  if constexpr (Tr::kAux > 0)
    return nullptr;
  else
    return reinterpret_cast<const void*>(&tdx_f32<128, true, Tr>);
}

// tdx_f32<bn, overlap, Tr>'s registers a thread (its launch count; the
// consumers take 232 by setmaxnreg) and local bytes (spills) into out[0],
// out[1]. Returns the query's error.
template <class Tr>
int dx32_attrs(int bn, int overlap, int* out) {
  const void* fn;
  if (bn == 128 && Tr::kAux > 0 && overlap) return cudaErrorInvalidValue;
  if (bn == 128)
    fn = overlap ? dx32_fwd_only<Tr>()
                 : reinterpret_cast<const void*>(&tdx_f32<128, false, Tr>);
  else
    fn = overlap ? reinterpret_cast<const void*>(&tdx_f32<64, true, Tr>)
                 : reinterpret_cast<const void*>(&tdx_f32<64, false, Tr>);
  cudaFuncAttributes f{};
  const cudaError_t e = cudaFuncGetAttributes(&f, fn);
  out[0] = f.numRegs;
  out[1] = (int)f.localSizeBytes;
  return e;
}

// run_dx in float32 (tdx_f32): dX (n, h, w, ci) of T_dy(dy, aux) (n, h,
// w, co) * wflip (ci, ks*ks*co), all f32, finished as out_kind 3 (the
// fused transforms: Tr::kFwd false, ein = x, a.out = dx) or, with
// Tr::kFwd, the forward (out_kind 4: dy = x, no aux, wflip = W, a.out =
// y); wsplit (2, ci, ks*ks*co) f32 scratch for the weight's TF32 split.
// The fused transforms' sums: part holds grid / (ci / bn) entries (a
// CTA's) and sums (2, ci) receives their sums. A banded transform (Tr::kBanded, the ghost
// unit's: a.band_px, a.add_kind and a.addend set by the caller) takes the
// forward or out_kind 0 (gm, ein = x), 1 or 2 (dX + the f32 addend where
// add_kind is 2, ein = the addend); with sums (out_kind 4 and 0) part
// holds one entry a row tile and sums (n * h / gh, 2, ci) a band's, gh
// rows of the image a band, the box height a divisor of gh. Sums written
// whole. The plan (ops/conv.py tma_bwd_dx_plan / tma_staged_fwd_plan with
// 4-byte elements): bn 64 or 128, a 1x1's weight resident or streamed, 1
// to 3 epilogue slots of TM x bn f32, `overlap` (tdx_f32's OVL). Three
// launches: the split, the product, the sums (reduce_parts_wide,
// reduce_groups_wide by band).
template <class Tr>
int run_dx_f32(const void* dy, const void* aux, const void* wflip,
               float* wsplit, const void* ein, DxArgs a, float* part,
               float* sums, int n, int h, int w, int ci, int co, int ks,
               const DxPlan& p, const Tr& tr, cudaStream_t s, int gh = 0) {
  constexpr bool AUX = Tr::kAux > 0;
  constexpr bool BANDED = banded<Tr>::value;
  bool with_sums = true, in_slot = !Tr::kFwd;
  if constexpr (BANDED) {
    with_sums = a.out_kind == 4 || a.out_kind == 0;
    in_slot = a.out_kind == 0 || (a.out_kind != 4 && a.add_kind == 2);
    if ((Tr::kFwd ? a.out_kind != 4 : a.out_kind < 0 || a.out_kind > 2) ||
        (a.add_kind != 0 && (a.add_kind != 2 || a.out_kind == 0)) ||
        (Tr::kFwd && a.band_px) || (a.band_px && a.band_px != gh * w) ||
        gh < 1 || h % gh || (long long)gh * w != tr.band_px)
      return cudaErrorInvalidValue;
  } else if (a.out_kind != (Tr::kFwd ? 4 : 3)) {
    return cudaErrorInvalidValue;
  }
  // the sums' groups: everything, or (banded) each band of gh rows
  const long long groups = BANDED ? n * (long long)(h / (gh > 0 ? gh : 1))
                                  : 1;
  if (ci % 64 || co % 64 || (ks != 1 && ks != 3) || !aligned16(dy) ||
      (AUX && !aligned16(aux)) || !aligned16(wflip) || !aligned16(wsplit) ||
      !aligned16(a.out) || (in_slot && !aligned16(ein)) ||
      (with_sums && (!part || !sums)))
    return cudaErrorInvalidValue;
  if ((long long)n * h * w == 0)
    return with_sums ? cudaMemsetAsync(sums, 0,
                                       sizeof(float) * groups * 2 * ci, s)
                     : cudaSuccess;
  a.part = part;
  a.h = h, a.w = w, a.ci = ci, a.co = co, a.ks = ks, a.wb = p.wb, a.hb = p.hb;
  while (a.lwb < 8 && (1 << a.lwb) < p.wb) ++a.lwb;
  a.tiles_w = (w + p.wb - 1) / p.wb;
  a.tiles_h = (h + p.hb - 1) / p.hb;
  a.col_tiles = ci / p.bn;
  const long long tiles = (long long)n * a.tiles_w * a.tiles_h * a.col_tiles;
  a.tiles = (int)tiles;
  a.cb = co / 32;
  a.halo = dx_halo(ks, p.wb);
  a.ksteps = (a.halo ? 3 : ks * ks) * a.cb;
  a.stages = p.stages, a.resident = p.resident, a.eslots = p.eslots;
  const int smem =
      p.stages * dx32_stage_bytes(p.bn, a.halo, p.wb, p.hb, AUX,
                                  p.resident) +
      p.resident * a.ksteps * 2 * p.bn * 128 + p.eslots * TM * p.bn * 4 +
      9 * 2 * p.bn * 4 + 2 * p.bn * 8 + 8 * (2 * p.stages + 7) + 1024;
  if (p.wb < 1 || p.hb < 1 || p.wb * p.hb != TM || p.wb != 1 << a.lwb ||
      p.hb > 256 || (p.bn != 64 && p.bn != 128) || ci % p.bn ||
      (p.resident && (ks != 1 || p.resident != 1)) || p.stages < 2 ||
      smem > MAX_SMEM || p.grid < 1 || p.grid > tiles ||
      tiles >= (1ll << 31) || p.grid % a.col_tiles || p.eslots < 1 ||
      p.eslots > 3 || (BANDED && gh % p.hb))
    return cudaErrorInvalidValue;
  CUtensorMap mdy, maux, mw, me, my;
  // the split weight as (co, ks*ks, ci, 2): box (32, 1, bn, 1), hi at 0
  const cuuint64_t wdims[4] = {(cuuint64_t)co, (cuuint64_t)(ks * ks),
                               (cuuint64_t)ci, 2};
  const cuuint32_t wbox[4] = {32, 1, (cuuint32_t)p.bn, 1};
  // the epilogue slot's boxes: a warpgroup's 64 rows of the tile, 32
  // columns a box
  const cuuint64_t ydims[4] = {(cuuint64_t)ci, (cuuint64_t)w, (cuuint64_t)h,
                               (cuuint64_t)n};
  const int sw = p.wb < 64 ? p.wb : 64;
  const cuuint32_t ybox[4] = {32, (cuuint32_t)sw, (cuuint32_t)(64 / sw), 1};
  // the A box: the tile's box, or in halo mode its rows widened by the
  // pixel on either side
  const int awb = a.halo ? p.wb + 2 : p.wb;
  if (!encode_act32(&mdy, dy, co, w, h, n, awb, p.hb) ||
      (AUX && !encode_act32(&maux, aux, co, w, h, n, awb, p.hb)) ||
      !encode(&mw, wsplit, true, 4, wdims, wbox, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(&my, a.out, true, 4, ydims, ybox, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  me = mdy;  // unread where the epilogue takes no input
  if (!AUX) maux = mdy;
  if (in_slot && !encode(&me, ein, true, 4, ydims, ybox,
                         CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  cudaError_t err = split_tf32(static_cast<const float*>(wflip), wsplit,
                               (long long)ci * ks * ks * co, s);
  if (err != cudaSuccess) return err;
  if (p.bn == 128 && p.overlap) {
    // a forward's only (dx32_fwd_only)
    if constexpr (AUX)
      return cudaErrorInvalidValue;
    else
      err = (cudaError_t)launch_dx_f32<128, true>(mdy, maux, mw, me, my, a,
                                                  tr, p.grid, smem, s);
  } else if (p.bn == 128)
    err = (cudaError_t)launch_dx_f32<128, false>(mdy, maux, mw, me, my, a,
                                                 tr, p.grid, smem, s);
  else
    err = (cudaError_t)(p.overlap ? launch_dx_f32<64, true>(
                                        mdy, maux, mw, me, my, a, tr, p.grid,
                                        smem, s)
                                  : launch_dx_f32<64, false>(
                                        mdy, maux, mw, me, my, a, tr, p.grid,
                                        smem, s));
  if (err != cudaSuccess || !with_sums) return err;
  if constexpr (BANDED) {
    // a band's row tiles are consecutive: gh / hb rows of tiles_w tiles
    reduce_groups_wide<<<dim3((2 * ci + 127) / 128, (unsigned)groups), 128,
                         0, s>>>(part, sums, 2 * ci, gh / p.hb * a.tiles_w);
  } else {
    reduce_parts_wide<<<(2 * ci + 127) / 128, 128, 0, s>>>(
        part, sums, 2 * ci, p.grid / a.col_tiles);
  }
  return cudaGetLastError();
}

}  // namespace bwd
