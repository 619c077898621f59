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
// The plan (box, BN, chunks a CTA, stages, splits, cluster) comes from
// ops/conv.py tma_dw_plan. The tensor maps are encoded here, through the
// driver entry point that the runtime hands out (no -lcuda).

#include <algorithm>
#include <cstdint>
#include <type_traits>
#include <cuda.h>
#include <cuda_runtime.h>

#include "wgmma.cuh"

namespace {

using namespace hop;

constexpr int KP = 64;          // pixels a tile: four k16 steps
constexpr int BOX = KP * 128;   // bytes of one 64-channel box of a tile
constexpr int THREADS = 384;    // two consumer warpgroups, one producer
constexpr int CONSUMERS = 256;
constexpr int MAX_SMEM = 232448;

struct DwArgs {
  float* out;     // the table (KS*KS*ci, co), or the clusters' tables
  int ci, co, ks;
  int wb, hb;     // the pixel box
  int tiles_w, tiles_h, ntiles;
  int cchunks;    // 64-channel chunks of ci
  int rchunks;    // row chunks of the table, ks*ks*cchunks
  int stages, splits, cs;
};

template <int BN, bool TWO>
__global__ void __launch_bounds__(THREADS, 1)
tma_dw(const __grid_constant__ CUtensorMap mx,
       const __grid_constant__ CUtensorMap mdy, const DwArgs a) {
  constexpr int NB = BN / 64;                // dY boxes a stage
  constexpr int IN = BN >= 128 ? 128 : 64;   // columns of one wgmma
  constexpr int NI = BN / IN;                // wgmmas a k16 step
  constexpr int LDR = BN + 8;                // floats a parked row
  extern __shared__ uint8_t raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  constexpr int NA = TWO ? 2 : 1;            // X boxes a stage
  constexpr int KSTEPS = TWO ? KP / 16 : KP / 32;  // k16 steps a warpgroup
  const int stage_bytes = (NA + NB) * BOX;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + a.stages * stage_bytes);
  uint64_t* empty = full + a.stages;

  // the warpgroup's role, warp-uniform to the compiler: a role branch it
  // sees as divergent makes it serialise the wgmmas
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int tid = threadIdx.x % 128;
  const long long t0 = (long long)blockIdx.z * a.ntiles / a.splits;
  const int nt =
      (int)((long long)(blockIdx.z + 1) * a.ntiles / a.splits - t0);
  const int co0 = blockIdx.y * BN;
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
      const int half = a.ks / 2;
      for (int i = 0; i < nt; ++i) {
        const int st = i % a.stages;
        mbar_wait(&empty[st], ((i / a.stages) & 1) ^ 1);
        uint8_t* buf = smem + st * stage_bytes;
        mbar_expect_tx(&full[st], stage_bytes);
        int t = (int)t0 + i;
        const int tw = t % a.tiles_w;
        t /= a.tiles_w;
        const int w0 = tw * a.wb, h0 = (t % a.tiles_h) * a.hb;
        const int img = t / a.tiles_h;
        for (int j = 0; j < NA; ++j) {
          const int c = chunk_of(j), tap = c / a.cchunks;
          tma_load_4d(buf + j * BOX, &mx, &full[st], (c % a.cchunks) * 64,
                      w0 + tap % a.ks - half, h0 + tap / a.ks - half, img);
        }
        for (int j = 0; j < NB; ++j)
          tma_load_4d(buf + (NA + j) * BOX, &mdy, &full[st], co0 + 64 * j, w0,
                      h0, img);
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
    int prev = -1;
    for (int i = 0; i < nt; ++i) {
      const int st = i % a.stages;
      mbar_wait(&full[st], (i / a.stages) & 1);
      const uint8_t* buf = smem + st * stage_bytes;
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

using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                            void*, const cuuint64_t*, const cuuint64_t*,
                            const cuuint32_t*, const cuuint32_t*,
                            CUtensorMapInterleave, CUtensorMapSwizzle,
                            CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

Encode encoder() {
  static const Encode fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<Encode>(p)
               : nullptr;
  }();
  return fn;
}

// The (c, w, h, n) map of an NHWC bf16 tensor, read in boxes of 64
// channels by wb x hb pixels of one image, 128-byte swizzled, zero fill.
bool encode(CUtensorMap* map, const void* p, int c, int w, int h, int n,
            int wb, int hb) {
  const Encode fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)w, (cuuint64_t)h,
                              (cuuint64_t)n};
  const cuuint64_t strides[3] = {2ull * c, 2ull * c * w, 2ull * c * w * h};
  const cuuint32_t box[4] = {64, (cuuint32_t)wb, (cuuint32_t)hb, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, bool TWO>
int launch(const CUtensorMap& mx, const CUtensorMap& mdy, const DwArgs& a,
           dim3 grid, int smem, cudaStream_t s) {
  // the shared memory the launches may take, set once a device
  static bool set[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!set[dev]) {
    e = cudaFuncSetAttribute(tma_dw<BN, TWO>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MAX_SMEM);
    if (e != cudaSuccess) return e;
    set[dev] = true;
  }
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
  e = cudaLaunchKernelEx(&cfg, tma_dw<BN, TWO>, mx, mdy, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// x (n, h, w, ci) bf16; dy (n, h, w, co) bf16; dw (ks*ks*ci, co) f32 out,
// rows in (ky, kx, ci) order. The plan (ops/conv.py tma_dw_plan): a pixel
// box of wb x hb (wb*hb = 64), bn (64, 128 or 256) columns a CTA, two = 1
// where the table has more than one 64-row chunk, `stages` ring slots, the
// pixel tiles split `splits` ways (each split non-empty) in clusters of cs
// (1, 2 or 4; splits a multiple; ops/conv.py takes at most 2). With splits / cs > 1, ws holds that many
// (ks*ks*ci, co) f32 tables, else it is unused. Returns the first launch
// error, or cudaErrorInvalidValue for a shape or plan the kernel does not
// take (ci or co not a multiple of 8, a base not 16-byte aligned).
extern "C" int conv_dw_tma(const void* x, const void* dy, void* dw, void* ws,
                           int n, int h, int w, int ci, int co, int ks, int wb,
                           int hb, int bn, int two, int stages, int splits,
                           int cs, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const size_t size = (size_t)ks * ks * ci * co;
  if (ci < 8 || co < 8 || ci % 8 || co % 8 || (ks != 1 && ks != 3) ||
      !aligned16(x) || !aligned16(dy) || !aligned16(dw))
    return cudaErrorInvalidValue;
  if ((long long)n * h * w == 0)
    return cudaMemsetAsync(dw, 0, sizeof(float) * size, s);
  DwArgs a{};
  a.out = static_cast<float*>(splits / cs > 1 ? ws : dw);
  a.ci = ci, a.co = co, a.ks = ks, a.wb = wb, a.hb = hb;
  a.tiles_w = (w + wb - 1) / wb;
  a.tiles_h = (h + hb - 1) / hb;
  const long long ntiles = (long long)n * a.tiles_w * a.tiles_h;
  a.ntiles = (int)ntiles;
  a.cchunks = (ci + 63) / 64;
  a.rchunks = ks * ks * a.cchunks;
  a.stages = stages, a.splits = splits, a.cs = cs;
  const int stage_bytes = ((two ? 2 : 1) + bn / 64) * BOX;
  const int smem = stages * stage_bytes + 16 * stages + 1024;
  if (wb < 1 || hb < 1 || wb * hb != KP || wb > 256 || hb > 256 ||
      (bn != 64 && bn != 128 && bn != 256) || two != (a.rchunks > 1) ||
      stages < 2 || (cs != 1 && cs != 2 && cs != 4) || splits < 1 ||
      splits % cs || splits > ntiles || ntiles >= (1ll << 31) ||
      smem > MAX_SMEM || 2 * 64 * (bn + 8) * 4 > stages * stage_bytes)
    return cudaErrorInvalidValue;
  CUtensorMap mx, mdy;
  if (!encode(&mx, x, ci, w, h, n, wb, hb) ||
      !encode(&mdy, dy, co, w, h, n, wb, hb))
    return cudaErrorInvalidValue;
  const dim3 grid(two ? (a.rchunks + 1) / 2 : 1, (co + bn - 1) / bn, splits);
  auto go = [&](auto mode) {
    constexpr bool T = decltype(mode)::value;
    return bn == 256   ? launch<256, T>(mx, mdy, a, grid, smem, s)
           : bn == 128 ? launch<128, T>(mx, mdy, a, grid, smem, s)
                       : launch<64, T>(mx, mdy, a, grid, smem, s);
  };
  const int err = two ? go(std::true_type{}) : go(std::false_type{});
  if (err != cudaSuccess || splits / cs == 1) return err;
  const int blocks = (int)std::min<size_t>((size + 255) / 256, 4096);
  sum_tables<<<blocks, 256, 0, s>>>(static_cast<const float*>(ws),
                                    static_cast<float*>(dw), size,
                                    splits / cs);
  return cudaGetLastError();
}
