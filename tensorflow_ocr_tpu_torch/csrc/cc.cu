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
// 8 x 192 x 320 = 491,520 pixels, about 5 MB of edges, mask and labels,
// which sit in the 50 MB L2. The work is a chain of dependent loads
// (following parent pointers) and atomics on a 61,440-pixel map per
// image, so latency and atomic contention bound it.
//
// What the design does about it: the TPU kernel keeps the whole label map
// in VMEM for K min-label sweeps, with XLA pointer jumping between bursts.
// That map (~490 KB per image with its edges) does not fit one SM's
// 227 KB of shared memory, so this is union-find labelling in global
// memory instead, in three launches over the whole batch:
//   init:    parent = own index on mask pixels, h*w on background;
//   merge:   one thread per pixel unions it with each linked neighbour,
//            always hanging the larger root under the smaller with
//            atomicMin and retrying when another thread got there first;
//   flatten: each mask pixel follows its parents to the root.
// Every parent pointer points at a smaller index, so each root is the
// minimum index of its tree, which is exactly the contract, and no host
// sync is needed. Only the 8 forward link bits are read: the reverse bits
// of pack_edges (pallas_kernels.py:28) are the same undirected pairs.
// Tiling in shared memory with a border merge is the next step for speed.
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

// (dx, dy) per link channel, the order of ops/labels.py LINK_OFFSETS.
__constant__ int kDx[8] = {-1, -1, -1, 1, 1, 1, 0, 0};
__constant__ int kDy[8] = {0, 1, -1, 0, 1, -1, -1, 1};

// Parent pointers change under other threads' atomics; read through L2
// (ld.global.cg), never a stale L1 line.
__device__ __forceinline__ int find_root(const int* parent, int x) {
  int p = __ldcg(parent + x);
  while (p != x) {
    x = p;
    p = __ldcg(parent + x);
  }
  return x;
}

__global__ void cc_init(const uint8_t* __restrict__ mask,
                        int* __restrict__ labels, int total, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < total) labels[i] = mask[i] ? i % n : n;
}

__global__ void cc_merge(const uint8_t* __restrict__ edges,
                         const uint8_t* __restrict__ mask, int* labels,
                         int total, int h, int w) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total || !mask[i]) return;
  int n = h * w;
  int img = i / n;
  int local = i - img * n;
  int y = local / w;
  int x = local - y * w;
  int* parent = labels + img * n;
  const uint8_t* e = edges + (size_t)i * 8;
  for (int c = 0; c < 8; ++c) {
    if (!e[c]) continue;
    int nx = x + kDx[c];
    int ny = y + kDy[c];
    if (nx < 0 || nx >= w || ny < 0 || ny >= h) continue;
    int q = ny * w + nx;
    if (!mask[img * n + q]) continue;
    // union(local, q): hang the larger root under the smaller one
    int a = local, b = q;
    while (true) {
      a = find_root(parent, a);
      b = find_root(parent, b);
      if (a == b) break;
      if (a > b) {
        int t = a;
        a = b;
        b = t;
      }
      int old = atomicMin(parent + b, a);
      if (old == b) break;  // b was still a root and now hangs under a
      b = old;              // b was re-parented meanwhile: retry from there
    }
  }
}

__global__ void cc_flatten(const uint8_t* __restrict__ mask, int* labels,
                           int total, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total || !mask[i]) return;
  int img = i / n;
  int* parent = labels + img * n;
  parent[i - img * n] = find_root(parent, i - img * n);
}

}  // namespace

// edges: (B, h, w, 8) bool as bytes; mask: (B, h, w) bool as bytes;
// labels: (B, h, w) int32 output. All contiguous on the device. Launches
// on `stream` and returns the first launch error (cudaSuccess = 0).
extern "C" int cc_label(const uint8_t* edges, const uint8_t* mask,
                        int32_t* labels, int batch, int h, int w,
                        void* stream) {
  int n = h * w;
  int total = batch * n;
  if (total == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const int blocks = (total + threads - 1) / threads;
  cc_init<<<blocks, threads, 0, s>>>(mask, labels, total, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cc_merge<<<blocks, threads, 0, s>>>(edges, mask, labels, total, h, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cc_flatten<<<blocks, threads, 0, s>>>(mask, labels, total, n);
  return cudaGetLastError();
}
