// The bottleneck unit's residual boundary, forward and backward, for
// Hopper (sm_90a).
//
// Replaces the TPU kernels of tensorflow_ocr_tpu/ops/pallas_fused.py:
//   fused_boundary_fwd <- fused_boundary (:420):
//       out = bf16(relu(z*a + b + zs*as + bs))
//   fused_boundary_bwd <- _fused_boundary_bwd (:456):
//       gm = g*[pre > 0]; dz = bf16(gm*a); dzs = bf16(gm*as);
//       dab = [sum gm*z, sum gm]; dabs = [sum gm*zs, sum gm]
// over M rows of C channels (NHWC), bf16 activations, f32 tables; and
// the same in float32 (fused_boundary_fwd_f32, fused_boundary_bwd_f32:
// the TPU kernels take the activations' dtype, and a float32 model runs
// them in float32), f32 activations and outputs, from the same templates.
//
// What bounds it on the H100: bytes alone. The forward reads two bf16
// tensors and writes one (6 bytes a channel-row, a few flops); the
// backward reads three and writes two (10 bytes). At 512^2, batch 32
// and C = 256 that is 0.8 / 1.3 GB a call against 3.35 TB/s; twice that
// in float32.
//
// What the design does about it: one pass each, 16-byte vectors (8 bf16
// or 4 f32 channels a thread) on consecutive addresses, the affine tables
// held in registers for the whole grid-stride loop, and the per-channel
// sums of the backward kept in registers. Each block adds its threads'
// partials in row-group order and writes them as one entry of a scratch
// buffer; a second launch adds the entries in a fixed order (32 runs of
// consecutive blocks, each in block order, then the runs in order). No
// atomics: two launches are bit-equal (the grid depends only on m, c and
// the SM count).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

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

// A thread's 16-byte vector of T: V channels, as floats.
template <class T>
struct Vec;

template <>
struct Vec<bf16> {
  static constexpr int V = 8;
  static __device__ __forceinline__ void unpack(const uint4& v, float f[8]) {
    unpack8(v, f);
  }
  static __device__ __forceinline__ uint4 pack(const float f[8]) {
    return pack8(f);
  }
};

template <>
struct Vec<float> {
  static constexpr int V = 4;
  static __device__ __forceinline__ void unpack(const uint4& v, float f[4]) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  static __device__ __forceinline__ uint4 pack(const float f[4]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

// Threads of a block: cvecs = C/V vectors per row, rows rows per pass.
template <int V>
struct Layout {
  int cvecs, rows, cv, rsub;
  __device__ Layout(int c) {
    cvecs = c / V;
    rows = blockDim.x / cvecs;
    cv = threadIdx.x % cvecs;
    rsub = threadIdx.x / cvecs;
  }
};

// z*a + b + zs*as + bs rounded after each operation, in the plain
// version's order (no FMA contraction), so the relu masks agree exactly.
__device__ __forceinline__ float pre_act(float z, float a, float b, float s,
                                         float as, float bs) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(z, a), b), __fmul_rn(s, as)),
                   bs);
}

template <int V>
struct Tables {
  float a[V], b[V], as[V], bs[V];
  __device__ void load(const float* ab, const float* abs, int c, int c0) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      a[i] = ab[c0 + i];
      b[i] = ab[c + c0 + i];
      as[i] = abs[c0 + i];
      bs[i] = abs[c + c0 + i];
    }
  }
};

template <class T>
__device__ __forceinline__ void bnd_fwd_body(const T* __restrict__ z,
                                             const float* __restrict__ ab,
                                             const T* __restrict__ zs,
                                             const float* __restrict__ abs,
                                             T* __restrict__ out, int m,
                                             int c) {
  constexpr int V = Vec<T>::V;
  Layout<V> l(c);
  if (l.rsub >= l.rows) return;
  Tables<V> t;
  t.load(ab, abs, c, l.cv * V);
  for (int r = blockIdx.x * l.rows + l.rsub; r < m; r += gridDim.x * l.rows) {
    size_t off = (size_t)r * c + l.cv * V;
    float zf[V], sf[V], o[V];
    Vec<T>::unpack(__ldg(reinterpret_cast<const uint4*>(z + off)), zf);
    Vec<T>::unpack(__ldg(reinterpret_cast<const uint4*>(zs + off)), sf);
#pragma unroll
    for (int i = 0; i < V; ++i)
      o[i] = fmaxf(pre_act(zf[i], t.a[i], t.b[i], sf[i], t.as[i], t.bs[i]), 0.f);
    *reinterpret_cast<uint4*>(out + off) = Vec<T>::pack(o);
  }
}

__global__ void bnd_fwd(const bf16* __restrict__ z,
                        const float* __restrict__ ab,
                        const bf16* __restrict__ zs,
                        const float* __restrict__ abs,
                        bf16* __restrict__ out, int m, int c) {
  bnd_fwd_body(z, ab, zs, abs, out, m, c);
}

__global__ void bnd_fwd_f32(const float* __restrict__ z,
                            const float* __restrict__ ab,
                            const float* __restrict__ zs,
                            const float* __restrict__ abs,
                            float* __restrict__ out, int m, int c) {
  bnd_fwd_body(z, ab, zs, abs, out, m, c);
}

// The backward's pass: dz, dzs, and block b's partial sums of its rows
// written whole to part[b] (3, c): [sum gm*z, sum gm*zs, sum gm]. Thread
// i's partials of its V channels go to red[V i ..] (blockDim * V floats
// of dynamic shared memory): row group r, channel ch at red[r * c + ch],
// added for each channel in row-group order.
template <class T>
__device__ __forceinline__ void bnd_bwd_body(const T* __restrict__ g,
                                             const T* __restrict__ z,
                                             const float* __restrict__ ab,
                                             const T* __restrict__ zs,
                                             const float* __restrict__ abs,
                                             T* __restrict__ dz,
                                             T* __restrict__ dzs,
                                             float* __restrict__ part, int m,
                                             int c) {
  constexpr int V = Vec<T>::V;
  extern __shared__ __align__(16) float red[];
  Layout<V> l(c);
  const bool on = l.rsub < l.rows;
  float sz[V] = {}, szs[V] = {}, sg[V] = {};
  if (on) {
    Tables<V> t;
    t.load(ab, abs, c, l.cv * V);
    for (int r = blockIdx.x * l.rows + l.rsub; r < m;
         r += gridDim.x * l.rows) {
      size_t off = (size_t)r * c + l.cv * V;
      float gf[V], zf[V], sf[V], oz[V], os[V];
      Vec<T>::unpack(__ldg(reinterpret_cast<const uint4*>(g + off)), gf);
      Vec<T>::unpack(__ldg(reinterpret_cast<const uint4*>(z + off)), zf);
      Vec<T>::unpack(__ldg(reinterpret_cast<const uint4*>(zs + off)), sf);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float pre = pre_act(zf[i], t.a[i], t.b[i], sf[i], t.as[i], t.bs[i]);
        float gm = pre > 0.f ? gf[i] : 0.f;
        oz[i] = gm * t.a[i];
        os[i] = gm * t.as[i];
        sz[i] += gm * zf[i];
        szs[i] += gm * sf[i];
        sg[i] += gm;
      }
      *reinterpret_cast<uint4*>(dz + off) = Vec<T>::pack(oz);
      *reinterpret_cast<uint4*>(dzs + off) = Vec<T>::pack(os);
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float* v = k == 0 ? sz : k == 1 ? szs : sg;
    if (on) {
      float4* p = reinterpret_cast<float4*>(&red[V * threadIdx.x]);
#pragma unroll
      for (int q = 0; q < V / 4; ++q)
        p[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    }
    __syncthreads();
    for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
      float s = 0.f;
      for (int r = 0; r < l.rows; ++r) s += red[r * c + ch];
      part[((size_t)blockIdx.x * 3 + k) * c + ch] = s;
    }
    __syncthreads();
  }
}

__global__ void bnd_bwd(const bf16* __restrict__ g,
                        const bf16* __restrict__ z,
                        const float* __restrict__ ab,
                        const bf16* __restrict__ zs,
                        const float* __restrict__ abs,
                        bf16* __restrict__ dz, bf16* __restrict__ dzs,
                        float* __restrict__ part, int m, int c) {
  bnd_bwd_body(g, z, ab, zs, abs, dz, dzs, part, m, c);
}

__global__ void bnd_bwd_f32(const float* __restrict__ g,
                            const float* __restrict__ z,
                            const float* __restrict__ ab,
                            const float* __restrict__ zs,
                            const float* __restrict__ abs,
                            float* __restrict__ dz, float* __restrict__ dzs,
                            float* __restrict__ part, int m, int c) {
  bnd_bwd_body(g, z, ab, zs, abs, dz, dzs, part, m, c);
}

// dab = [sum gm*z, sum gm], dabs = [sum gm*zs, sum gm]: the blocks'
// entries added in a fixed order. Block (32, kChunks): thread (x, y)
// adds, in block order, channel-sum i = 32 blockIdx.x + x (k = i / c)
// over its run y of the blocks' entries; row y = 0 then adds the runs in
// order. The reads of one entry are coalesced along x.
constexpr int kChunks = 32;

__global__ void bnd_sum(const float* __restrict__ part,
                        float* __restrict__ dab, float* __restrict__ dabs,
                        int blocks, int c) {
  __shared__ float run[kChunks][33];
  const int i = blockIdx.x * 32 + threadIdx.x;
  const int k = i / c, ch = i % c;
  const int len = (blocks + kChunks - 1) / kChunks;
  const int b0 = threadIdx.y * len, b1 = min(blocks, b0 + len);
  float s = 0.f;
  if (i < 3 * c)
    for (int b = b0; b < b1; ++b) s += part[((size_t)b * 3 + k) * c + ch];
  run[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y != 0 || i >= 3 * c) return;
  float t = 0.f;
  for (int y = 0; y < kChunks; ++y) t += run[y][threadIdx.x];
  if (k == 0) {
    dab[ch] = t;
  } else if (k == 1) {
    dabs[ch] = t;
  } else {
    dab[c + ch] = t;
    dabs[c + ch] = t;
  }
}

// Block of cvecs * rows threads (~256), grid of at most 8 blocks an SM;
// v channels a vector (8 bf16, 4 f32).
void shape(int m, int c, int v, dim3& grid, dim3& block) {
  int cvecs = c / v;
  int rows = cvecs >= 256 ? 1 : 256 / cvecs;
  block = dim3(cvecs * rows);
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    sms = 132;
  long need = ((long)m + rows - 1) / rows;
  grid = dim3((unsigned)(need < 8L * sms ? need : 8L * sms));
}

// Whether the kernels take c channels of T: a whole number of vectors
// and at most 1024 threads a row (8192 bf16 or 4096 f32 channels).
template <class T>
bool takes(int c) {
  return c % 8 == 0 && c / Vec<T>::V <= 1024;
}

template <class T>
int boundary_fwd(const void* z, const void* ab, const void* zs,
                 const void* abs, void* out, int m, int c, void* stream,
                 void (*kernel)(const T*, const float*, const T*,
                                const float*, T*, int, int)) {
  if (!takes<T>(c)) return cudaErrorInvalidValue;
  if (m == 0) return 0;
  dim3 grid, block;
  shape(m, c, Vec<T>::V, grid, block);
  kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(z), static_cast<const float*>(ab),
      static_cast<const T*>(zs), static_cast<const float*>(abs),
      static_cast<T*>(out), m, c);
  return cudaGetLastError();
}

template <class T>
int boundary_bwd_blocks(int m, int c) {
  if (!takes<T>(c) || m == 0) return 0;
  dim3 grid, block;
  shape(m, c, Vec<T>::V, grid, block);
  return (int)grid.x;
}

template <class T>
int boundary_bwd(const void* g, const void* z, const void* ab, const void* zs,
                 const void* abs, void* dz, void* dzs, void* dab, void* dabs,
                 void* part, int m, int c, int blocks, void* stream,
                 void (*kernel)(const T*, const T*, const float*, const T*,
                                const float*, T*, T*, float*, int, int)) {
  if (!takes<T>(c)) return cudaErrorInvalidValue;
  if (m == 0) return 0;
  dim3 grid, block;
  shape(m, c, Vec<T>::V, grid, block);
  if ((int)grid.x != blocks) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  // <= 1024 threads: at most 32 KB, under the default 48 KB
  const size_t smem = (size_t)block.x * Vec<T>::V * sizeof(float);
  kernel<<<grid, block, smem, s>>>(
      static_cast<const T*>(g), static_cast<const T*>(z),
      static_cast<const float*>(ab), static_cast<const T*>(zs),
      static_cast<const float*>(abs), static_cast<T*>(dz),
      static_cast<T*>(dzs), static_cast<float*>(part), m, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bnd_sum<<<(3 * c + 31) / 32, dim3(32, kChunks), 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(dab),
      static_cast<float*>(dabs), blocks, c);
  return cudaGetLastError();
}

}  // namespace

// z, zs, out (m, c) bf16; ab, abs (2, c) f32. c % 8 == 0, c <= 8192.
// Returns the launch error (cudaSuccess = 0).
extern "C" int fused_boundary_fwd(const void* z, const void* ab,
                                  const void* zs, const void* abs, void* out,
                                  int m, int c, void* stream) {
  return boundary_fwd<bf16>(z, ab, zs, abs, out, m, c, stream, bnd_fwd);
}

// The backward's block count: the entries of its scratch buffer.
extern "C" int fused_boundary_bwd_blocks(int m, int c) {
  return boundary_bwd_blocks<bf16>(m, c);
}

// g, z, zs, dz, dzs (m, c) bf16; ab, abs (2, c) f32; dab, dabs (2, c)
// f32, written whole; part (blocks, 3, c) f32 scratch, blocks =
// fused_boundary_bwd_blocks(m, c). Returns the first launch error.
extern "C" int fused_boundary_bwd(const void* g, const void* z,
                                  const void* ab, const void* zs,
                                  const void* abs, void* dz, void* dzs,
                                  void* dab, void* dabs, void* part, int m,
                                  int c, int blocks, void* stream) {
  return boundary_bwd<bf16>(g, z, ab, zs, abs, dz, dzs, dab, dabs, part, m,
                            c, blocks, stream, bnd_bwd);
}

// The same in float32: z, zs, out, g, dz, dzs (m, c) f32; c % 8 == 0,
// c <= 4096; the blocks of fused_boundary_bwd_blocks_f32(m, c).
extern "C" int fused_boundary_fwd_f32(const void* z, const void* ab,
                                      const void* zs, const void* abs,
                                      void* out, int m, int c, void* stream) {
  return boundary_fwd<float>(z, ab, zs, abs, out, m, c, stream, bnd_fwd_f32);
}

extern "C" int fused_boundary_bwd_blocks_f32(int m, int c) {
  return boundary_bwd_blocks<float>(m, c);
}

extern "C" int fused_boundary_bwd_f32(const void* g, const void* z,
                                      const void* ab, const void* zs,
                                      const void* abs, void* dz, void* dzs,
                                      void* dab, void* dabs, void* part,
                                      int m, int c, int blocks,
                                      void* stream) {
  return boundary_bwd<float>(g, z, ab, zs, abs, dz, dzs, dab, dabs, part, m,
                             c, blocks, stream, bnd_bwd_f32);
}
