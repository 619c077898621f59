// Connected components of the PixelLink link graph, for Hopper (sm_90a).
//
// Replaces the TPU kernel cc_sweeps_pallas (tensorflow_ocr_tpu/ops/
// pallas_kernels.py:91) and the loop that calls it,
// connected_components_pallas (:112-150). Contract (tensorflow_ocr_tpu/
// ops/decode.py:103-161): every mask pixel gets the minimum linear index
// (y*w + x, within its image) of its weakly connected component;
// background gets h*w. A link counts when both of its pixels are in the
// mask and in the image.
//
// What bounds it on the H100: not bytes. At the detect shape a batch is
// 8 x 192 x 320 = 491,520 pixels, about 5 MB of edges, mask and labels
// (0.0019 ms at 3.35 TB/s). The work is a chain of dependent loads
// (following parent pointers) and atomics, so latency bounds it: a parent
// hop through L2 costs ~0.5 us, one through shared memory ~30 ns.
//
// What the design does about it: block-based union-find (Playne and
// Hawick, IEEE TPDS 2018; Allegretti, Bolelli and Grana, IEEE TPDS 2020),
// three launches over the whole batch:
//   local:   one CTA of 32 x 32 threads a 32 x 32 tile of one image (the
//            ragged right and bottom tiles too; a tile never spans two
//            images). Each thread loads its pixel's mask byte and its 8
//            link bytes in one 8-byte load into shared memory. A pair of
//            pixels counts where either end's bit links it, so each pair
//            is taken once, by its later pixel: the left neighbour as a
//            plain parent (row runs), then up-left, up and up-right by
//            union in shared memory (atomicMin, the larger root under the
//            smaller, retried where another thread got there first; find
//            halves the path). Then each pixel's parent is its local
//            root, written as the root's global index: local row-major
//            order is monotone in the global index, so a local root is
//            its tree's minimum. Background gets h*w;
//   border:  a thread per pixel of a tile with backward neighbours in
//            other tiles (its top row, its left and right columns)
//            unions each such pair in global memory with the same
//            atomicMin rule: across a side, and at a corner into the
//            diagonal neighbour tile. A pair is skipped where the
//            predecessor along the side has the same link and both ends
//            already share its trees (equal parents); find compresses
//            the path behind it by writing only smaller values
//            (atomicMin), so the chains stay short;
//   flatten: each mask pixel follows its parents to the root.
// Every parent pointer points at a smaller index, so each root is the
// minimum index of its tree, which is exactly the contract, and no host
// sync is needed. Labels are a function of the map: two launches are
// equal. Only the 8 forward link bits are read: the reverse bits of
// pack_edges (pallas_kernels.py:28) are the same undirected pairs.
//
// No round cap: the TPU kernel's loop (connected_components_pallas) and
// the plain versions (decode.py:103-161, ops/kernels.py) stop after h + w
// rounds of sweeps; union-find runs to completion and is exact on every
// map. Where a component needs more rounds than that (a long serpentine,
// say), the capped versions return it split into pieces and this kernel
// returns it whole. The exact labelling is the correct one: the cap
// bounds the sweeps' time and is not part of the contract.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int T = 32;  // tile side: a CTA's T x T pixels, one a thread

// The root of x in the tile's shared parents (volatile: other threads'
// atomics move them), halving the path on the way: each node passed
// takes its grandparent, an ancestor too.
__device__ __forceinline__ int local_root(volatile int* par, int x) {
  int p = par[x];
  while (p != x) {
    const int g = par[p];
    if (g != p) par[x] = g;
    x = p;
    p = g;
  }
  return x;
}

// union(a, b) in the tile's shared parents: hang the larger root under
// the smaller one; where the larger was re-parented meanwhile, retry from
// its new parent.
__device__ __forceinline__ void local_unite(int* par, int a, int b) {
  while (true) {
    a = local_root(par, a);
    b = local_root(par, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(par + b, a);
    if (old == b) return;  // b was still a root and now hangs under a
    b = old;
  }
}

// union(a, b) in global memory, as local_unite: the two roots found in
// lockstep (both parents loaded together at each step), each start then
// hung straight under its root, parents only ever lowered. Parent
// pointers change under other threads' atomics: read through L2
// (ld.global.cg), never a stale L1 line.
__device__ __forceinline__ void global_unite(int* parent, int a, int b) {
  while (true) {
    int ra = a, rb = b;
    int pa = __ldcg(parent + ra), pb = __ldcg(parent + rb);
    while (pa != ra || pb != rb) {
      ra = pa, rb = pb;
      pa = __ldcg(parent + ra);
      pb = __ldcg(parent + rb);
    }
    if (ra != a) atomicMin(parent + a, ra);
    if (rb != b) atomicMin(parent + b, rb);
    if (ra == rb) return;
    if (ra > rb) {
      const int t = ra;
      ra = rb;
      rb = t;
    }
    const int old = atomicMin(parent + rb, ra);
    if (old == rb) return;
    a = ra, b = old;
  }
}

__device__ __forceinline__ uint64_t links_of(const uint8_t* edges,
                                             size_t pix) {
  return __ldg(reinterpret_cast<const unsigned long long*>(edges) + pix);
}

__device__ __forceinline__ bool bit(uint64_t links, int c) {
  return (links >> (8 * c)) & 0xff;
}

// A pixel's backward neighbours (before it in row-major order): (dx, dy),
// the pixel's link channel to it and the neighbour's channel back, in the
// channel order of ops/labels.py LINK_OFFSETS ((dx, dy) = (-1, 0), (-1,
// 1), (-1, -1), (1, 0), (1, 1), (1, -1), (0, -1), (0, 1)). A pair counts
// where either end's bit links it, so each pair is taken once, by its
// later pixel.
__constant__ int kBack[4][4] = {
    {-1, 0, 0, 3}, {-1, -1, 2, 4}, {0, -1, 6, 7}, {1, -1, 5, 1}};

// Grid: batch * tiles_w * tiles_h CTAs of T x T threads; a warp is a row
// of the tile.
__global__ void __launch_bounds__(T * T)
cc_local(const uint8_t* __restrict__ edges, const uint8_t* __restrict__ mask,
         int* __restrict__ labels, int h, int w, int tiles_w, int tiles) {
  __shared__ int par[T * T];        // local index, -1 off the mask
  __shared__ int run[T * T];        // the first pixel of the pixel's run
  __shared__ uint64_t lk[T * T];    // the 8 link bytes
  const int img = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int x0 = tile % tiles_w * T, y0 = tile / tiles_w * T;
  const int lx = threadIdx.x, ly = threadIdx.y, l = ly * T + lx;
  const int x = x0 + lx, y = y0 + ly;
  const bool in = x < w && y < h;
  const size_t pix = ((size_t)img * h + y) * w + x;
  const bool on = in && mask[pix];
  par[l] = on ? l : -1;
  lk[l] = on ? links_of(edges, pix) : 0;
  __syncthreads();
  // backward neighbour d of local pixel v (at column vx of row vy) inside
  // the tile, on the mask and linked
  auto linked = [&](int v, int vx, int vy, int d, int& q) {
    const int nx = vx + kBack[d][0], ny = vy + kBack[d][1];
    if (nx < 0 || nx >= T || ny < 0) return false;
    q = ny * T + nx;
    return par[q] >= 0 &&
           (bit(lk[v], kBack[d][2]) || bit(lk[q], kBack[d][3]));
  };
  // row runs: a run's first pixel (on the mask, no link to its left
  // neighbour) is the parent of every pixel of the run, found by a ballot
  // over the row
  int q;
  const bool left = on && linked(l, lx, ly, 0, q);
  const unsigned starts = __ballot_sync(0xffffffffu, on && !left);
  const int r0 = ly * T + 31 - __clz(starts & (0xffffffffu >> (31 - lx)));
  __syncthreads();
  if (on) par[l] = run[l] = r0;
  __syncthreads();
  // the runs above: union of the two runs where up-left, up or up-right
  // links them, unless an earlier direction of this pixel, or the
  // previous pixel of its run, already links the same two runs (the
  // previous pixel unions them, or one before it does)
  if (on && ly > 0)
    for (int d = 1; d < 4; ++d) {
      if (!linked(l, lx, ly, d, q)) continue;
      bool covered = false;
      int q2;
      for (int d2 = 1; d2 < d; ++d2)
        covered = covered || (linked(l, lx, ly, d2, q2) && run[q2] == run[q]);
      for (int d2 = 1; d2 < 4 && left; ++d2)
        covered = covered ||
                  (linked(l - 1, lx - 1, ly, d2, q2) && run[q2] == run[q]);
      if (!covered) local_unite(par, r0, run[q]);
    }
  __syncthreads();
  if (!in) return;
  int label = h * w;
  if (on) {
    const int r = local_root(par, r0);
    label = (y0 + r / T) * w + x0 + r % T;
  }
  labels[pix] = label;
}

// Grid: batch * tiles CTAs of 4 T threads, one a pixel of the tile with
// backward neighbours in other tiles: its top row, then the rows below at
// its left and its right column (fewer in a ragged tile).
__global__ void __launch_bounds__(4 * T)
cc_border(const uint8_t* __restrict__ edges, const uint8_t* __restrict__ mask,
          int* labels, int h, int w, int tiles_w, int tiles) {
  const int img = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int x0 = tile % tiles_w * T, y0 = tile / tiles_w * T;
  const int tw = min(T, w - x0), th = min(T, h - y0);
  const int below = th - 1, right = tw > 1 ? below : 0;
  int i = threadIdx.x, lx, ly, px, py;  // (px, py): the predecessor's step
  if (i < tw) {
    lx = i, ly = 0, px = -1, py = 0;
  } else if ((i -= tw) < below) {
    lx = 0, ly = 1 + i, px = 0, py = -1;
  } else if ((i -= below) < right) {
    lx = tw - 1, ly = 1 + i, px = 0, py = -1;
  } else {
    return;
  }
  const int x = x0 + lx, y = y0 + ly, n = h * w;
  const uint8_t* m = mask + (size_t)img * n;
  const uint8_t* e = edges + (size_t)img * n * 8;
  int* parent = labels + (size_t)img * n;
  const int p = y * w + x;
  if (!m[p]) return;
  const uint64_t lp = links_of(e, p);
  // pixel a at (ax, ay) and its backward neighbour b in direction d: on
  // the mask, in the image and linked
  auto pair = [&](int a, int ax, int ay, int d, uint64_t la, int& b) {
    const int bx = ax + kBack[d][0], by = ay + kBack[d][1];
    if (bx < 0 || bx >= w || by < 0) return false;
    b = by * w + bx;
    return m[b] && (bit(la, kBack[d][2]) || bit(links_of(e, b), kBack[d][3]));
  };
  for (int d = 0; d < 4; ++d) {
    int q;
    if (!pair(p, x, y, d, lp, q)) continue;
    const int qx = q % w, qy = q / w;
    if (qx / T == x / T && qy / T == y / T) continue;  // the local pass's
    // the predecessor along the side (the previous pixel of the top row,
    // the pixel above in a column): where it is linked the same way and
    // both ends share its trees (equal parents), its union covers this one
    const int ax = x + px, ay = y + py, a = ay * w + ax;
    const int fp = __ldcg(parent + p), fq = __ldcg(parent + q);
    int q2;
    if ((px == 0 || lx > 0) && m[a] && pair(a, ax, ay, d, links_of(e, a), q2) &&
        __ldcg(parent + a) == fp && __ldcg(parent + q2) == fq)
      continue;
    global_unite(parent, fp, fq);
  }
}

__global__ void cc_flatten(const uint8_t* __restrict__ mask, int* labels,
                           int total, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total || !mask[i]) return;
  const int img = i / n;
  int* parent = labels + (size_t)img * n;
  int r = __ldcg(labels + i), p = __ldcg(parent + r);
  while (p != r) {
    r = p;
    p = __ldcg(parent + r);
  }
  labels[i] = r;
}

}  // namespace

// edges: (B, h, w, 8) bool as bytes, 8-byte aligned; mask: (B, h, w) bool
// as bytes; labels: (B, h, w) int32 output. All contiguous on the device.
// Launches on `stream` and returns the first launch error (cudaSuccess =
// 0).
extern "C" int cc_label(const uint8_t* edges, const uint8_t* mask,
                        int32_t* labels, int batch, int h, int w,
                        void* stream) {
  const long long total = (long long)batch * h * w;
  if (total == 0) return 0;
  const int tiles_w = (w + T - 1) / T, tiles_h = (h + T - 1) / T;
  const long long blocks = (long long)batch * tiles_w * tiles_h;
  if (reinterpret_cast<uintptr_t>(edges) % 8 || total >= (1ll << 31) ||
      blocks >= (1ll << 31))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = tiles_w * tiles_h;
  cc_local<<<(int)blocks, dim3(T, T), 0, s>>>(edges, mask, labels, h, w,
                                              tiles_w, tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cc_border<<<(int)blocks, 4 * T, 0, s>>>(edges, mask, labels, h, w, tiles_w,
                                          tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cc_flatten<<<(int)((total + 255) / 256), 256, 0, s>>>(mask, labels,
                                                         (int)total, h * w);
  return cudaGetLastError();
}
