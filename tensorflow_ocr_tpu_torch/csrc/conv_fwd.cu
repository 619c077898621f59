// The forward products of the pallas_conv route on Hopper (sm_90a): TMA
// loads, K-major wgmma from shared memory and a persistent tile loop.
//
// Replaces the TPU kernels of tensorflow_ocr_tpu/ops/pallas_conv.py:
//   KS = 1 <- _matmul_rows (:81): the 1x1 forward, y = x . W over pixel
//             rows, and its dX (dY . W^T);
//   KS = 3 <- _conv3 (:148):      the 3x3 stride-1 SAME forward, and its
//             dX (the same conv of dY with the flipped, channel-swapped
//             weight).
// Contract: x (n, h, w, ci) bf16 NHWC (a 1x1 over M rows: n = h = 1, w =
// M); wt (co, KS*KS*ci) bf16 with K in (ky, kx, ci) order; y (n*h*w, co)
// bf16 = bf16(im2col(x) . wt^T), f32 accumulation, the taps outside the
// image zero. ci a multiple of 8 and 16-byte aligned x and wt, which is
// what TMA takes; any co. The dX of the PixelLink head's projections to
// 2 channels (ci = 2 here: 4 of a train step's 114 forward products)
// stays on conv.cu's igemm_fwd, chosen by shape in ops/conv.py
// (tma_fwd_takes): a dispatch between two hand-written kernels.
//
// What bounds it on the H100: a 1x1 does 2*M*ci*co flops on 2*M*(ci + co)
// bytes (plus the weight), ci*co/(ci + co) flops a byte: 51 for block1's
// 64 <-> 256 over 524,288 pixels, 205 for 1024 <-> 256: bytes at 3.35
// TB/s, against the card's ~295 flops a byte at bf16; only the widest
// (1024 <-> 512, 512 <-> 2048 and 1024 <-> 2048 at 16^2, 341-683 a byte)
// are bound by operations at 989 TFLOP/s. A 3x3 does 9x the work on the same bytes,
// 288-2,304 flops a byte: operations.
//
// Design. A persistent CTA (one an SM) of three warpgroups walks output
// tiles of 128 pixels by BN columns (16, 64 or 128 of co: the narrowest
// that covers co, 128 above; BN = 256, which would read X once where co
// <= 256, ran slower than two column tiles of 128 at every forward shape
// of the route on the H100 and spilled 184 bytes, scripts/
// conv_fwd_probe.py --sweep: its 64 KB of staging left the ring 3
// slots):
// - One producer thread issues TMA loads into a ring of `stages` slots,
//   each guarded by a full and an empty mbarrier. A slot holds one K step:
//   the A box of 64 channels by 128 pixels and the weight box of 64 K by
//   BN rows, both K-major, 128-byte swizzled, as they lie in memory. The
//   A box is wb x hb pixels of one image (wb*hb = 128; 128 x 1 rows of a
//   1x1) at the tile's origin shifted by the tap (kx-1, ky-1): TMA's zero
//   fill outside the tensor is the SAME pad and the ragged W, H and
//   channel edges. The weight is the (ci, KS*KS, co) map, box (64, 1, BN):
//   a ci that is not a multiple of 64 zero-fills on its side too, and the
//   rows past co arrive as zeros. The K loop runs over KS*KS taps x
//   ceil(ci/64) channel boxes.
// - Resident weight (1x1, where the K x BN slice fits beside >= 3 A
//   slots): the CTA loads its column's weight once and streams only X;
//   the grid is then a multiple of the column tiles, so a CTA's tiles all
//   share one column. Block1's bytes-bound shapes then read W once per CTA
//   (from L2), X once from memory (a second column tile's read of it hits
//   L2) and write Y once.
// - Two consumer warpgroups (setmaxnreg moves registers from the
//   producer's) each own 64 of the tile's 128 rows: wgmma m64nBNk16, both
//   operands K-major in shared memory, f32 accumulators in registers (64
//   a thread at BN = 128). A slot is released once the products that read
//   it have completed (one K step behind).
// - The epilogue rounds to bf16 once and stores each element once,
//   through shared memory by TMA where co is a multiple of 8: each
//   warpgroup stages its 64 rows as the store's boxes (64 columns, 128-
//   byte swizzled; 16 plain at BN = 16) by 64 pixels (half a 128-pixel
//   row, or hb / 2 rows of the box), one thread issues the stores, and
//   the warpgroup goes on to the next tile's products while they drain;
//   TMA skips pixels outside the image and columns past co. This is the
//   shared-memory epilogue rather than a ping-pong of the warpgroups: a
//   ping-pong needs each warpgroup to hold a whole 128-row tile's
//   accumulators (128 registers a thread at BN = 128) and the ring to
//   serve two tiles at once. Stores from the
//   fragment (bf16 pairs, 16 bytes of a row a quad) ran at ~1 TB/s on
//   block1's 64 -> 256 (scripts/conv_fwd_probe.py). Rows of a co that is
//   not a multiple of 8 (the head's co = 2: 4-byte rows) TMA cannot
//   store: those tiles are stored from the fragment, row r of the tile
//   being pixel (x0 + r % wb, y0 + r / wb). Either way the ring is not
//   tied to a tile, so the producer's loads of the next tile are in
//   flight during the epilogue.
// - Tiles go to the CTAs in a fixed order: tile t = row block t / col
//   tiles, column t % col tiles, CTA b taking t = b, b + grid, ...; the
//   column tiles of a row block run side by side, so X stays in L2 where
//   co > BN. No split of K: two launches on the same inputs are bit-equal.
// The plan (box, BN, resident weight, stages, grid) comes from
// ops/conv.py tma_fwd_plan. The tensor maps are encoded by wgmma.cuh's
// host helpers, through the driver entry point that the runtime hands
// out (no -lcuda).
//
// conv_fwd_tma_f32 (below) is the same in float32 for the same two TPU
// kernels, which take float32 as they take bf16: a float32 product by
// split TF32, bound by operations at 495 / 3 TFLOP/s (three TF32 passes)
// and, for block1's 1x1s, by the bytes, twice bf16's.

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "wgmma.cuh"

namespace {

using namespace hop;

constexpr int TM = 128;          // pixels a tile (wb * hb)
constexpr int ABOX = TM * 128;   // bytes of one A box: 128 rows of 64 bf16
constexpr int THREADS = 384;     // two consumer warpgroups, one producer
constexpr int MAX_SMEM = 232448;

struct FwdArgs {
  __nv_bfloat16* y;
  int h, w, co, ks;
  int wb, hb, tiles_w, tiles_h;
  int col_tiles, tiles;  // tiles = row tiles * col_tiles
  int cb;                // 64-channel boxes of ci
  int ksteps;            // ks * ks * cb
  int stages, resident;
  int tma_store;         // co % 8 == 0: the epilogue stores by TMA
};

// The tile t's origin: image, first pixel (x0, y0), column tile.
struct Tile {
  int img, x0, y0, col;
};

template <class Args>  // FwdArgs, FwdArgs32
__device__ __forceinline__ Tile tile_of(const Args& a, int t) {
  Tile r;
  r.col = t % a.col_tiles;
  t /= a.col_tiles;
  r.x0 = (t % a.tiles_w) * a.wb;
  t /= a.tiles_w;
  r.y0 = (t % a.tiles_h) * a.hb;
  r.img = t / a.tiles_h;
  return r;
}

// Byte offset of output element (row, col) of a warpgroup's 64-row half
// tile in its staging buffer: 64-column sub-tiles of 64 rows x 128 bytes
// under the 128-byte swizzle (the TMA store's boxes), or, at BN = 16, plain
// rows of 32 bytes.
template <int BN>
__device__ __forceinline__ uint32_t staged_offset(int row, int col) {
  if constexpr (BN >= 64)
    return (col / 64) * (64 * 128) + swizzled_offset(row, col % 64);
  else
    return row * (BN * 2) + col * 2;
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
conv_fwd_tma(const __grid_constant__ CUtensorMap mx,
             const __grid_constant__ CUtensorMap mw,
             const __grid_constant__ CUtensorMap my, const FwdArgs a) {
  constexpr int BBOX = BN * 128;        // bytes of one weight box
  constexpr int HALF = 64 * BN * 2;     // bytes of a warpgroup's staging
  extern __shared__ uint8_t raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  const int stage_bytes = ABOX + (a.resident ? 0 : BBOX);
  uint8_t* wres = smem + a.stages * stage_bytes;
  uint8_t* staging = wres + (a.resident ? a.ksteps * BBOX : 0);
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 2 * HALF);
  uint64_t* empty = full + a.stages;
  uint64_t* wbar = empty + a.stages;

  // the warpgroup's role, warp-uniform to the compiler: a role branch it
  // sees as divergent makes it serialise the wgmmas
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int tid = threadIdx.x % 128;

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
      prefetch_map(&mx);
      prefetch_map(&mw);
      if (a.tma_store) prefetch_map(&my);
      if (a.resident) {
        // the grid is a multiple of the column tiles: every tile of this
        // CTA has the column of its first
        const int n0 = (blockIdx.x % a.col_tiles) * BN;
        mbar_expect_tx(wbar, a.ksteps * BBOX);
        for (int k = 0; k < a.ksteps; ++k)
          tma_load_3d(wres + k * BBOX, &mw, wbar, k * 64, 0, n0);
      }
      const int half = a.ks / 2;
      int it = 0;
      for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
        const Tile tl = tile_of(a, t);
        for (int k = 0; k < a.ksteps; ++k, ++it) {
          const int st = it % a.stages;
          mbar_wait(&empty[st], ((it / a.stages) & 1) ^ 1);
          uint8_t* buf = smem + st * stage_bytes;
          mbar_expect_tx(&full[st], stage_bytes);
          const int tap = k / a.cb, c0 = (k % a.cb) * 64;
          tma_load_4d(buf, &mx, &full[st], c0, tl.x0 + tap % a.ks - half,
                      tl.y0 + tap / a.ks - half, tl.img);
          if (!a.resident)
            tma_load_3d(buf + ABOX, &mw, &full[st], c0, tap, tl.col * BN);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    regs_grow<232>();
    float acc[BN / 2] = {};  // each tile's first product overwrites it
    if (a.resident) mbar_wait(wbar, 0);
    const int warp = tid / 32, lane = tid % 32;
    int it = 0;
    for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
      const Tile tl = tile_of(a, t);
      int prev = 0;
      for (int k = 0; k < a.ksteps; ++k, ++it) {
        const int st = it % a.stages;
        mbar_wait(&full[st], (it / a.stages) & 1);
        const uint8_t* buf = smem + st * stage_bytes;
        const uint64_t da = sw128_desc(buf + wg * 64 * 128, 16, 1024);
        const uint64_t db = sw128_desc(
            a.resident ? wres + k * BBOX : buf + ABOX, 16, 1024);
        wgmma_fence();
        fence_operands(acc);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // 32 bytes a k16 step, >> 4
          WgmmaK<BN>::mma(acc, da + 2 * kk, db + 2 * kk, k > 0 || kk > 0);
        wgmma_commit();
        fence_operands(acc);
        wgmma_wait<1>();
        if (k > 0 && tid == 0) mbar_arrive(&empty[prev]);
        prev = st;
      }
      wgmma_wait<0>();
      fence_operands(acc);
      if (tid == 0) mbar_arrive(&empty[prev]);

      if (a.tma_store) {
        // epilogue through shared memory: the warpgroup's 64 rows are
        // staged as the TMA store's boxes and stored by one thread while
        // the warpgroup goes on to the next tile's products
        uint8_t* stg = staging + wg * HALF;
        if (tid == 0) bulk_wait_read<0>();  // the last store has read stg
        bar_sync(1 + wg, 128);
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int row = 16 * warp + lane / 4 + 8 * e2;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const int col = 8 * j + 2 * (lane % 4);
            *reinterpret_cast<__nv_bfloat162*>(
                stg + staged_offset<BN>(row, col)) =
                __floats2bfloat162_rn(acc[4 * j + 2 * e2],
                                      acc[4 * j + 2 * e2 + 1]);
          }
        }
        fence_async_smem();
        bar_sync(1 + wg, 128);
        if (tid == 0) {
          // rows 64 wg .. 64 wg + 63 of the tile: the right half of a
          // 128-pixel row, or the lower hb / 2 rows of the box
          const int sx = a.wb == TM ? tl.x0 + 64 * wg : tl.x0;
          const int sy = a.wb == TM ? tl.y0 : tl.y0 + wg * (a.hb / 2);
#pragma unroll
          for (int sub = 0; sub < (BN >= 64 ? BN / 64 : 1); ++sub) {
            const int c0 = tl.col * BN + 64 * sub;
            if (c0 < a.co)
              tma_store_4d(&my, stg + sub * (64 * 128), c0, sx, sy, tl.img);
          }
          bulk_commit();
        }
        continue;
      }
      // epilogue from registers (co not a multiple of 8: rows TMA cannot
      // store): row r of the tile is pixel (x0 + r % wb, y0 + r / wb)
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int r = wg * 64 + 16 * warp + lane / 4 + 8 * e2;
        const int x = tl.x0 + r % a.wb, yy = tl.y0 + r / a.wb;
        if (x >= a.w || yy >= a.h) continue;
        __nv_bfloat16* out =
            a.y + ((size_t)((size_t)tl.img * a.h + yy) * a.w + x) * a.co;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int c = tl.col * BN + 8 * j + 2 * (lane % 4);
          if (c >= a.co) continue;
          const float v0 = acc[4 * j + 2 * e2], v1 = acc[4 * j + 2 * e2 + 1];
          if (a.co % 2 == 0) {  // c even: a pair, 4-byte aligned
            *reinterpret_cast<__nv_bfloat162*>(out + c) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            out[c] = __float2bfloat16(v0);
            if (c + 1 < a.co) out[c + 1] = __float2bfloat16(v1);
          }
        }
      }
    }
    if (tid == 0 && a.tma_store) bulk_wait<0>();  // before the CTA exits
  }
}

template <int BN>
int launch(const CUtensorMap& mx, const CUtensorMap& mw, const CUtensorMap& my,
           const FwdArgs& a, int grid, int smem, cudaStream_t s) {
  static bool set[64] = {};
  const cudaError_t e = allow_smem(conv_fwd_tma<BN>, set, MAX_SMEM);
  if (e != cudaSuccess) return e;
  conv_fwd_tma<BN><<<grid, THREADS, smem, s>>>(mx, mw, my, a);
  return cudaGetLastError();
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// ---------------------------------------------------------------- float32
//
// conv_fwd_tma_f32: the same contract in float32 (x, wt and y f32), the
// same persistent tiles, ring, plan and epilogue, and the product as split
// TF32 on the tensor cores (wgmma.cuh): a K step is 32 channels of one tap
// (a 128-byte f32 row); the weight comes split, hi and lo boxes from a
// (2, co, KS*KS*ci) copy that split_tf32 (wgmma.cuh) writes before the
// launch; each warp loads its 16 rows of the A box by ldmatrix (the TF32
// fragment has the bf16 one's bytes) and splits them in registers; twelve
// m64nBNk8 products a K step (4 k8 steps of lo.hi', then hi.lo', then
// hi.hi') into a fresh accumulator, waited for and added to the tile's f32
// sum (the tensor cores' truncation stays inside the K step). No overlap
// of one K step's products with the next's: the other warpgroup's fill it.
// y is stored in f32 by TMA (128-byte swizzled boxes of 32 columns, plain
// 16-column rows at BN = 16), or from registers where co % 8 != 0.

struct FwdArgs32 {
  float* y;
  int h, w, co, ks;
  int wb, hb, tiles_w, tiles_h;
  int col_tiles, tiles;  // tiles = row tiles * col_tiles
  int cb;                // 32-channel boxes of ci
  int ksteps;            // ks * ks * cb
  int stages, resident;
  int tma_store;         // co % 8 == 0: the epilogue stores by TMA
};

// Byte offset of output element (row, col) of a warpgroup's 64-row half
// tile in its f32 staging buffer: 32-column sub-tiles of 64 rows x 128
// bytes under the 128-byte swizzle, or, at BN = 16, plain 64-byte rows.
template <int BN>
__device__ __forceinline__ uint32_t staged_offset32(int row, int col) {
  if constexpr (BN >= 32)
    return (col / 32) * (64 * 128) + row * 128 +
           ((((col >> 2) ^ row) & 7) << 4) + (col & 3) * 4;
  else
    return row * (BN * 4) + col * 4;
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
conv_fwd_tma_f32(const __grid_constant__ CUtensorMap mx,
                 const __grid_constant__ CUtensorMap mw,
                 const __grid_constant__ CUtensorMap my, const FwdArgs32 a) {
  constexpr int BBOX = BN * 128;        // bytes of one weight box (hi or lo)
  constexpr int HALF = 64 * BN * 4;     // bytes of a warpgroup's staging
  extern __shared__ uint8_t raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  const int stage_bytes = ABOX + (a.resident ? 0 : 2 * BBOX);
  uint8_t* wres = smem + a.stages * stage_bytes;
  uint8_t* staging = wres + (a.resident ? a.ksteps * 2 * BBOX : 0);
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 2 * HALF);
  uint64_t* empty = full + a.stages;
  uint64_t* wbar = empty + a.stages;

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int tid = threadIdx.x % 128;

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
      prefetch_map(&mx);
      prefetch_map(&mw);
      if (a.tma_store) prefetch_map(&my);
      if (a.resident) {
        const int n0 = (blockIdx.x % a.col_tiles) * BN;
        mbar_expect_tx(wbar, a.ksteps * 2 * BBOX);
        for (int k = 0; k < a.ksteps; ++k)
          for (int part = 0; part < 2; ++part)
            tma_load_4d(wres + (2 * k + part) * BBOX, &mw, wbar,
                        (k % a.cb) * 32, k / a.cb, n0, part);
      }
      const int half = a.ks / 2;
      int it = 0;
      for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
        const Tile tl = tile_of(a, t);
        for (int k = 0; k < a.ksteps; ++k, ++it) {
          const int st = it % a.stages;
          mbar_wait(&empty[st], ((it / a.stages) & 1) ^ 1);
          uint8_t* buf = smem + st * stage_bytes;
          mbar_expect_tx(&full[st], stage_bytes);
          const int tap = k / a.cb, c0 = (k % a.cb) * 32;
          tma_load_4d(buf, &mx, &full[st], c0, tl.x0 + tap % a.ks - half,
                      tl.y0 + tap / a.ks - half, tl.img);
          if (!a.resident)
            for (int part = 0; part < 2; ++part)
              tma_load_4d(buf + ABOX + part * BBOX, &mw, &full[st], c0, tap,
                          tl.col * BN, part);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    regs_grow<232>();
    float acc[BN / 2] = {}, sum[BN / 2];
    if (a.resident) mbar_wait(wbar, 0);
    const int warp = tid / 32, lane = tid % 32;
    // the row of the A box this lane gives ldmatrix: rows l % 8 + 8 (l / 8
    // % 2) of the warp's 16, 16-byte chunk 2 kk + l / 16 of the row
    const int lr = 64 * wg + 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1);
    int it = 0;
    for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
      const Tile tl = tile_of(a, t);
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) sum[e] = 0.f;
      for (int k = 0; k < a.ksteps; ++k, ++it) {
        const int st = it % a.stages;
        mbar_wait(&full[st], (it / a.stages) & 1);
        const uint8_t* buf = smem + st * stage_bytes;
        const uint8_t* wb = a.resident ? wres + 2 * k * BBOX : buf + ABOX;
        const uint64_t dhi = sw128_desc(wb, 16, 1024);
        const uint64_t dlo = sw128_desc(wb + BBOX, 16, 1024);
        const uint32_t rowaddr = smem_u32(buf) + lr * 128;
        uint32_t ah[4][4], al[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t r[4];
          ldsm_x4(rowaddr + ((((2 * kk + (lane >> 4)) ^ lr) & 7) << 4), r);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            tf32_split(__uint_as_float(r[i]), ah[kk][i], al[kk][i]);
        }
        wgmma_fence();
        fence_operands(acc);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // 32 bytes a k8 step, >> 4
          WgmmaTf32R<BN>::mma(acc, al[kk], dhi + 2 * kk, kk > 0);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          WgmmaTf32R<BN>::mma(acc, ah[kk], dlo + 2 * kk, 1);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          WgmmaTf32R<BN>::mma(acc, ah[kk], dhi + 2 * kk, 1);
        wgmma_commit();
        fence_operands(acc);
        wgmma_wait<0>();
        fence_operands(acc);
        if (tid == 0) mbar_arrive(&empty[st]);
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) sum[e] += acc[e];
      }

      if (a.tma_store) {
        uint8_t* stg = staging + wg * HALF;
        if (tid == 0) bulk_wait_read<0>();  // the last store has read stg
        bar_sync(1 + wg, 128);
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int row = 16 * warp + lane / 4 + 8 * e2;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const int col = 8 * j + 2 * (lane % 4);
            *reinterpret_cast<float2*>(stg + staged_offset32<BN>(row, col)) =
                make_float2(sum[4 * j + 2 * e2], sum[4 * j + 2 * e2 + 1]);
          }
        }
        fence_async_smem();
        bar_sync(1 + wg, 128);
        if (tid == 0) {
          const int sx = a.wb == TM ? tl.x0 + 64 * wg : tl.x0;
          const int sy = a.wb == TM ? tl.y0 : tl.y0 + wg * (a.hb / 2);
#pragma unroll
          for (int sub = 0; sub < (BN >= 32 ? BN / 32 : 1); ++sub) {
            const int c0 = tl.col * BN + 32 * sub;
            if (c0 < a.co)
              tma_store_4d(&my, stg + sub * (64 * 128), c0, sx, sy, tl.img);
          }
          bulk_commit();
        }
        continue;
      }
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int r = wg * 64 + 16 * warp + lane / 4 + 8 * e2;
        const int x = tl.x0 + r % a.wb, yy = tl.y0 + r / a.wb;
        if (x >= a.w || yy >= a.h) continue;
        float* out =
            a.y + ((size_t)((size_t)tl.img * a.h + yy) * a.w + x) * a.co;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int c = tl.col * BN + 8 * j + 2 * (lane % 4);
          if (c < a.co) out[c] = sum[4 * j + 2 * e2];
          if (c + 1 < a.co) out[c + 1] = sum[4 * j + 2 * e2 + 1];
        }
      }
    }
    if (tid == 0 && a.tma_store) bulk_wait<0>();  // before the CTA exits
  }
}

template <int BN>
int launch32(const CUtensorMap& mx, const CUtensorMap& mw,
             const CUtensorMap& my, const FwdArgs32& a, int grid, int smem,
             cudaStream_t s) {
  static bool set[64] = {};
  const cudaError_t e = allow_smem(conv_fwd_tma_f32<BN>, set, MAX_SMEM);
  if (e != cudaSuccess) return e;
  conv_fwd_tma_f32<BN><<<grid, THREADS, smem, s>>>(mx, mw, my, a);
  return cudaGetLastError();
}

}  // namespace

// x (n, h, w, ci) bf16; wt (co, ks*ks*ci) bf16, K in (ky, kx, ci) order;
// y (n*h*w, co) bf16 out, stored by TMA where co is a multiple of 8 (else
// from registers). The plan (ops/conv.py tma_fwd_plan): a pixel box
// of wb x hb (wb*hb = 128), bn (16, 64 or 128) columns a tile, the
// weight resident (1) or streamed (0), `stages` ring slots, `grid`
// persistent CTAs (a multiple of the column tiles where the weight is
// resident). Returns the launch error, or cudaErrorInvalidValue for a
// shape or plan the kernel does not take (ci not a multiple of 8, x, wt or
// y not 16-byte aligned).
extern "C" int conv_fwd_tma(const void* x, const void* wt, void* y, int n,
                            int h, int w, int ci, int co, int ks, int wb,
                            int hb, int bn, int resident, int stages,
                            int grid, void* stream) {
  if (ci < 8 || ci % 8 || co < 1 || (ks != 1 && ks != 3) || !aligned(x, 16) ||
      !aligned(wt, 16) || !aligned(y, 16))
    return cudaErrorInvalidValue;
  if ((long long)n * h * w == 0) return cudaSuccess;
  FwdArgs a{};
  a.y = static_cast<__nv_bfloat16*>(y);
  a.h = h, a.w = w, a.co = co, a.ks = ks, a.wb = wb, a.hb = hb;
  a.tiles_w = (w + wb - 1) / wb;
  a.tiles_h = (h + hb - 1) / hb;
  a.col_tiles = (co + bn - 1) / bn;
  const long long tiles = (long long)n * a.tiles_w * a.tiles_h * a.col_tiles;
  a.tiles = (int)tiles;
  a.cb = (ci + 63) / 64;
  a.ksteps = ks * ks * a.cb;
  a.stages = stages, a.resident = resident;
  a.tma_store = co % 8 == 0;
  const int bbox = bn * 128;
  const int smem = stages * (ABOX + (resident ? 0 : bbox)) +
                   (resident ? a.ksteps * bbox : 0) + 2 * 64 * bn * 2 +
                   8 * (2 * stages + 1) + 1024;
  if (wb < 1 || hb < 1 || wb * hb != TM || wb > 256 || hb > 256 ||
      (bn != 16 && bn != 64 && bn != 128) || stages < 2 ||
      smem > MAX_SMEM || grid < 1 || grid > tiles || tiles >= (1ll << 31) ||
      (resident && grid % a.col_tiles))
    return cudaErrorInvalidValue;
  CUtensorMap mx, mw, my;
  const cuuint64_t xdims[4] = {(cuuint64_t)ci, (cuuint64_t)w, (cuuint64_t)h,
                               (cuuint64_t)n};
  const cuuint32_t xbox[4] = {64, (cuuint32_t)wb, (cuuint32_t)hb, 1};
  const cuuint64_t wdims[3] = {(cuuint64_t)ci, (cuuint64_t)(ks * ks),
                               (cuuint64_t)co};
  const cuuint32_t wbox[3] = {64, 1, (cuuint32_t)bn};
  // the store's box: a warpgroup's 64 rows of the tile, 64 columns (16 at
  // bn = 16) a box
  const cuuint64_t ydims[4] = {(cuuint64_t)co, (cuuint64_t)w, (cuuint64_t)h,
                               (cuuint64_t)n};
  const int sw = wb < 64 ? wb : 64;
  const cuuint32_t ybox[4] = {(cuuint32_t)(bn < 64 ? bn : 64), (cuuint32_t)sw,
                              (cuuint32_t)(64 / sw), 1};
  if (!encode(&mx, x, false, 4, xdims, xbox, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(&mw, wt, false, 3, wdims, wbox, CU_TENSOR_MAP_SWIZZLE_128B) ||
      (a.tma_store &&
       !encode(&my, y, false, 4, ydims, ybox,
               bn < 64 ? CU_TENSOR_MAP_SWIZZLE_NONE
                       : CU_TENSOR_MAP_SWIZZLE_128B)))
    return cudaErrorInvalidValue;
  if (!a.tma_store) my = mx;  // unread
  auto s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 128: return launch<128>(mx, mw, my, a, grid, smem, s);
    case 64: return launch<64>(mx, mw, my, a, grid, smem, s);
    default: return launch<16>(mx, mw, my, a, grid, smem, s);
  }
}

// The float32 forward: x (n, h, w, ci) f32; wt (co, ks*ks*ci) f32, K in
// (ky, kx, ci) order; wsplit (2, co, ks*ks*ci) f32 scratch for the
// weight's TF32 split; y (n*h*w, co) f32 out. The plan as conv_fwd_tma's
// (ops/conv.py tma_fwd_plan with 4-byte elements): a K step is 32
// channels, a slot holds the A box and the weight's hi and lo boxes, a
// resident weight both. Two launches: the split, then the product.
// Returns the first launch error, or cudaErrorInvalidValue for a shape or
// plan the kernel does not take.
extern "C" int conv_fwd_tma_f32(const void* x, const void* wt, void* wsplit,
                                void* y, int n, int h, int w, int ci, int co,
                                int ks, int wb, int hb, int bn, int resident,
                                int stages, int grid, void* stream) {
  if (ci < 8 || ci % 8 || co < 1 || (ks != 1 && ks != 3) || !aligned(x, 16) ||
      !aligned(wt, 16) || !aligned(wsplit, 16) || !aligned(y, 16))
    return cudaErrorInvalidValue;
  if ((long long)n * h * w == 0) return cudaSuccess;
  FwdArgs32 a{};
  a.y = static_cast<float*>(y);
  a.h = h, a.w = w, a.co = co, a.ks = ks, a.wb = wb, a.hb = hb;
  a.tiles_w = (w + wb - 1) / wb;
  a.tiles_h = (h + hb - 1) / hb;
  a.col_tiles = (co + bn - 1) / bn;
  const long long tiles = (long long)n * a.tiles_w * a.tiles_h * a.col_tiles;
  a.tiles = (int)tiles;
  a.cb = (ci + 31) / 32;
  a.ksteps = ks * ks * a.cb;
  a.stages = stages, a.resident = resident;
  a.tma_store = co % 8 == 0;
  const int bbox = bn * 128;
  const int smem = stages * (ABOX + (resident ? 0 : 2 * bbox)) +
                   (resident ? a.ksteps * 2 * bbox : 0) + 2 * 64 * bn * 4 +
                   8 * (2 * stages + 1) + 1024;
  if (wb < 1 || hb < 1 || wb * hb != TM || wb > 256 || hb > 256 ||
      (bn != 16 && bn != 64 && bn != 128) || stages < 2 ||
      smem > MAX_SMEM || grid < 1 || grid > tiles || tiles >= (1ll << 31) ||
      (resident && grid % a.col_tiles))
    return cudaErrorInvalidValue;
  CUtensorMap mx, mw, my;
  // the split weight as (ci, ks*ks, co, 2): box (32, 1, bn, 1), hi at 0
  const cuuint64_t wdims[4] = {(cuuint64_t)ci, (cuuint64_t)(ks * ks),
                               (cuuint64_t)co, 2};
  const cuuint32_t wbox[4] = {32, 1, (cuuint32_t)bn, 1};
  const cuuint64_t ydims[4] = {(cuuint64_t)co, (cuuint64_t)w, (cuuint64_t)h,
                               (cuuint64_t)n};
  const int sw = wb < 64 ? wb : 64;
  const cuuint32_t ybox[4] = {(cuuint32_t)(bn < 32 ? bn : 32), (cuuint32_t)sw,
                              (cuuint32_t)(64 / sw), 1};
  if (!encode_act32(&mx, x, ci, w, h, n, wb, hb) ||
      !encode(&mw, wsplit, true, 4, wdims, wbox, CU_TENSOR_MAP_SWIZZLE_128B) ||
      (a.tma_store &&
       !encode(&my, y, true, 4, ydims, ybox,
               bn < 32 ? CU_TENSOR_MAP_SWIZZLE_NONE
                       : CU_TENSOR_MAP_SWIZZLE_128B)))
    return cudaErrorInvalidValue;
  if (!a.tma_store) my = mx;  // unread
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      split_tf32(static_cast<const float*>(wt), static_cast<float*>(wsplit),
                 (long long)co * ks * ks * ci, s);
  if (e != cudaSuccess) return e;
  switch (bn) {
    case 128: return launch32<128>(mx, mw, my, a, grid, smem, s);
    case 64: return launch32<64>(mx, mw, my, a, grid, smem, s);
    default: return launch32<16>(mx, mw, my, a, grid, smem, s);
  }
}
