// The core of the implicit-GEMM conv kernels of conv.cu (the narrow
// forward and dW, igemm_fwd and igemm_dw), and the vector helpers
// (unpack8, pack8, load8f, affine) that conv_bwd.cuh's staging transforms
// and ghost_unit.cu use: the tap map
// of a KSxKS stride-1 SAME window over NHWC pixel rows, the loaders that
// stage im2col operands into shared memory, and the tensor-core tile
// loop. A CTA of 8 warps computes a BM x BN tile of
// C = A . B^T in f32 from bf16 tiles staged in shared memory, BK = 32 of
// the K dimension at a time, with mma.sync m16n8k16.
//
// A loader stages one BK-wide K slice of its operand as (rows x LDS)
// shared rows, K contiguous; it has fetch(kt) (global loads into
// registers) and store(tile) (registers into shared memory), so that the
// next slice's loads are in flight while the tensor cores work. Its
// operand is the im2col matrix of a KSxKS window over an NHWC tensor of
// ch channels: row = pixel, K index = (tap, channel), K = KS*KS*ch
// (with KS = 1 and g = {1, 1, rows, rows}, a plain row-major (rows x ch)
// matrix, such as the weights). Each thread moves 8-wide K vectors,
// and a transform X says what a vector holds:
//   X::Reg                    the raw loads of one vector;
//   X::fetch(reg, pix, ch, c) loads channels c..c+7 of pixel pix (pix < 0:
//                             the pad or past the end, a zero);
//   X::value(reg)             the 8 staged bf16 values.
// Where ch is a multiple of 8 and the pointer 16-byte aligned (`vec`), 8
// consecutive K indices lie inside one tap and load as one vector.
// Otherwise each element loads alone, predicated on the K tail and on its
// own tap: only transforms with kEach (Ident, whose Reg is the uint4 of
// the 8 values) take that path; the others need vec.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>

namespace igemm {

using bf16 = __nv_bfloat16;

constexpr int BK = 32;
constexpr int LDS = BK + 8;  // padded shared row: conflict-free fragments
constexpr int THREADS = 256;
static_assert(THREADS % BK == 0, "a thread's vectors share a K offset");

struct Geo {
  int n, h, w, m;  // m = n*h*w pixels
};

// Pixel index of output pixel m shifted by tap t of a KSxKS window,
// or -1 where the tap falls outside the image (the SAME pad).
template <int KS>
__device__ __forceinline__ int tap_pixel(const Geo& g, int m, int t) {
  if (m >= g.m) return -1;
  if (KS == 1) return m;
  int ow = m % g.w;
  int r = m / g.w;
  int oh = r % g.h;
  int ky = t / KS, kx = t % KS;
  int hh = oh + ky - KS / 2, ww = ow + kx - KS / 2;
  if (hh < 0 || hh >= g.h || ww < 0 || ww >= g.w) return -1;
  return m + (ky - KS / 2) * g.w + (kx - KS / 2);
}

// ----------------------------------------------------------------- loaders

// The operand as it is in memory.
struct Ident {
  static constexpr bool kEach = true;
  using Reg = uint4;
  const bf16* src;

  __device__ __forceinline__ void fetch(Reg& v, int pix, int ch,
                                        int c) const {
    v = pix >= 0 ? __ldg(reinterpret_cast<const uint4*>(
                       src + (size_t)pix * ch + c))
                 : make_uint4(0, 0, 0, 0);
  }
  __device__ __forceinline__ bf16 elem(int pix, int ch, int c) const {
    return pix >= 0 ? src[(size_t)pix * ch + c] : __float2bfloat16(0.f);
  }
  __device__ __forceinline__ uint4 value(const Reg& v) const { return v; }
};

// K indices k..k+7 of im2col row m into v; zero where !in, past
// KS*KS*ch, or at a pad tap. At KS = 1 the K index is the channel.
template <int KS, class X>
__device__ __forceinline__ void fetch8(const X& x, typename X::Reg& v,
                                       const Geo& g, int m, bool in, int k,
                                       int ch, bool vec) {
  const int kdim = KS * KS * ch;
  if constexpr (X::kEach) {
    if (!vec) {
      uint4 u;
      bf16* e = reinterpret_cast<bf16*>(&u);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kj = k + j, t = KS == 1 ? 0 : kj / ch;
        int pix = in && kj < kdim ? tap_pixel<KS>(g, m, t) : -1;
        e[j] = x.elem(pix, ch, kj - t * ch);
      }
      v = u;
      return;
    }
  }
  const int t = KS == 1 ? 0 : k / ch;
  int pix = in && k < kdim ? tap_pixel<KS>(g, m, t) : -1;
  x.fetch(v, pix, ch, k - t * ch);
}

// Rows m0 + r of the operand, slice kt = K indices kt*BK + [0, BK). A
// thread's vectors share one K offset (THREADS is a multiple of BK/8).
template <int KS, class X, int ROWS>
struct PixelRows {
  static constexpr int VECS = ROWS * BK / 8;  // 8-wide vectors a slice
  static constexpr int V = (VECS + THREADS - 1) / THREADS;
  X x;
  Geo g;
  int ch, m0;
  bool vec;
  typename X::Reg v[V];

  __device__ __forceinline__ void fetch(int kt) {
    const int k = kt * BK + (threadIdx.x % (BK / 8)) * 8;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      int idx = threadIdx.x + i * THREADS;
      if (idx >= VECS) break;
      fetch8<KS>(x, v[i], g, m0 + idx / (BK / 8), true, k, ch, vec);
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

// The same operand transposed as it is staged, for the dW products:
// shared row = K index q0 + ql of the conv (tap, channel), shared column
// = a pixel of the chunk [p0, pend); slice kt = pixels p0 + kt*BK +
// [0, BK). Consecutive threads take consecutive pixels, so that a warp's
// 2-byte transposed stores fall in one shared row and in distinct banks.
template <int KS, class X, int ROWS>
struct PixelCols {
  static constexpr int VECS = ROWS * BK / 8;
  static constexpr int V = (VECS + THREADS - 1) / THREADS;
  X x;
  Geo g;
  int ch, q0, p0, pend;
  bool vec;
  typename X::Reg v[V];

  __device__ __forceinline__ void fetch(int kt) {
    const int pix = p0 + kt * BK + threadIdx.x % BK;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      int idx = threadIdx.x + i * THREADS;
      if (idx >= VECS) break;
      fetch8<KS>(x, v[i], g, pix, pix < pend, q0 + (idx / BK) * 8, ch, vec);
    }
  }
  __device__ __forceinline__ void store(bf16 (*s)[LDS]) const {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      int idx = threadIdx.x + i * THREADS;
      if (idx >= VECS) break;
      const int pl = idx % BK, ql = (idx / BK) * 8;
      const uint4 u = x.value(v[i]);
      const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
      for (int j = 0; j < 8; ++j) s[ql + j][pl] = e[j];
    }
  }
};

// ------------------------------------------------------------ tile loop

// 8 warps over a BM x BN tile: WN warps along N (32 columns each), WM
// along M, each warp MT m16 tiles by NT n8 tiles.
template <int BM, int BN>
struct Warps {
  static constexpr int WN = BN / 32;
  static constexpr int WM = 8 / WN;
  static constexpr int MT = BM / WM / 16;
  static constexpr int NT = 4;
  static_assert(WN * WM == 8 && MT >= 1 && MT * WM * 16 == BM,
                "unsupported tile");
};

__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// acc += sA (BM x BK, K contiguous) . sB (BN x BK, K contiguous)^T
template <int BM, int BN>
__device__ __forceinline__ void mma_tile(bf16 (*sA)[LDS], bf16 (*sB)[LDS],
                                         float acc[][Warps<BM, BN>::NT][4]) {
  using W = Warps<BM, BN>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / W::WN, wn = warp % W::WN;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t a[W::MT][4], b[W::NT][2];
#pragma unroll
    for (int i = 0; i < W::MT; ++i) {
      int r = wm * (BM / W::WM) + i * 16 + g;
      a[i][0] = lds32(&sA[r][kk + 2 * t]);
      a[i][1] = lds32(&sA[r + 8][kk + 2 * t]);
      a[i][2] = lds32(&sA[r][kk + 2 * t + 8]);
      a[i][3] = lds32(&sA[r + 8][kk + 2 * t + 8]);
    }
#pragma unroll
    for (int j = 0; j < W::NT; ++j) {
      int nrow = wn * 32 + j * 8 + g;
      b[j][0] = lds32(&sB[nrow][kk + 2 * t]);
      b[j][1] = lds32(&sB[nrow][kk + 2 * t + 8]);
    }
#pragma unroll
    for (int i = 0; i < W::MT; ++i)
#pragma unroll
      for (int j = 0; j < W::NT; ++j) mma16816(acc[i][j], a[i], b[j]);
  }
}

// Row and column of accumulator element e (0..3) of tile (i, j), within
// the CTA's tile.
template <int BM, int BN>
__device__ __forceinline__ void acc_pos(int i, int j, int e, int& r, int& c) {
  using W = Warps<BM, BN>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / W::WN, wn = warp % W::WN;
  r = wm * (BM / W::WM) + i * 16 + lane / 4 + (e >= 2 ? 8 : 0);
  c = wn * 32 + j * 8 + 2 * (lane % 4) + (e & 1);
}

// acc += A . B^T over nk K slices, A and B staged by the loaders la, lb.
template <int BM, int BN, class LA, class LB>
__device__ __forceinline__ void mainloop(LA& la, LB& lb, int nk,
                                         bf16 (*sA)[LDS], bf16 (*sB)[LDS],
                                         float acc[][Warps<BM, BN>::NT][4]) {
  if (nk <= 0) return;
  la.fetch(0);
  lb.fetch(0);
  for (int kt = 0; kt < nk; ++kt) {
    la.store(sA);
    lb.store(sB);
    __syncthreads();
    if (kt + 1 < nk) {
      la.fetch(kt + 1);
      lb.fetch(kt + 1);
    }
    mma_tile<BM, BN>(sA, sB, acc);
    __syncthreads();
  }
}

// ------------------------------------------------------- vector helpers

__device__ __forceinline__ void unpack8(const uint4& v, float f[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float f[8]) {
  uint4 v;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

__device__ __forceinline__ void load8f(const float* p, float f[8]) {
  float4 a = __ldg(reinterpret_cast<const float4*>(p));
  float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// x*a + b rounded after each operation, as the plain versions' separate
// elementwise ops round it (no FMA contraction): the relu masks of the
// kernels and of the plain versions then agree exactly.
__device__ __forceinline__ float affine(float x, float a, float b) {
  return __fadd_rn(__fmul_rn(x, a), b);
}

}  // namespace igemm
