// The bottleneck unit's residual boundary, forward and backward, for
// Hopper (sm_90a).
//
// Replaces the TPU kernels of tensorflow_ocr_tpu/ops/pallas_fused.py:
//   fused_boundary_fwd <- fused_boundary (:420):
//       out = bf16(relu(z*a + b + zs*as + bs))
//   fused_boundary_bwd <- _fused_boundary_bwd (:456):
//       gm = g*[pre > 0]; dz = bf16(gm*a); dzs = bf16(gm*as);
//       dab = [sum gm*z, sum gm]; dabs = [sum gm*zs, sum gm]
// over M rows of C channels (NHWC), bf16 activations, f32 tables.
//
// What bounds it on the H100: bytes alone. The forward reads two bf16
// tensors and writes one (6 bytes a channel-row, a few flops); the
// backward reads three and writes two (10 bytes). At 512^2, batch 32
// and C = 256 that is 0.8 / 1.3 GB a call against 3.35 TB/s.
//
// What the design does about it: one pass each, 16-byte vectors (8
// channels a thread) on consecutive addresses, the affine tables held in
// registers for the whole grid-stride loop, and the per-channel sums of
// the backward kept in registers. Each block adds its threads' partials
// in row-group order and writes them as one entry of a scratch buffer;
// a second launch adds the entries in a fixed order (32 runs of
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

// Threads of a block: cvecs = C/8 vectors per row, rows rows per pass.
struct Layout {
  int cvecs, rows, cv, rsub;
  __device__ Layout(int c) {
    cvecs = c / 8;
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

struct Tables {
  float a[8], b[8], as[8], bs[8];
  __device__ void load(const float* ab, const float* abs, int c, int c0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      a[i] = ab[c0 + i];
      b[i] = ab[c + c0 + i];
      as[i] = abs[c0 + i];
      bs[i] = abs[c + c0 + i];
    }
  }
};

__global__ void bnd_fwd(const bf16* __restrict__ z,
                        const float* __restrict__ ab,
                        const bf16* __restrict__ zs,
                        const float* __restrict__ abs,
                        bf16* __restrict__ out, int m, int c) {
  Layout l(c);
  if (l.rsub >= l.rows) return;
  Tables t;
  t.load(ab, abs, c, l.cv * 8);
  for (int r = blockIdx.x * l.rows + l.rsub; r < m; r += gridDim.x * l.rows) {
    size_t off = (size_t)r * c + l.cv * 8;
    float zf[8], sf[8], o[8];
    unpack8(__ldg(reinterpret_cast<const uint4*>(z + off)), zf);
    unpack8(__ldg(reinterpret_cast<const uint4*>(zs + off)), sf);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      o[i] = fmaxf(pre_act(zf[i], t.a[i], t.b[i], sf[i], t.as[i], t.bs[i]), 0.f);
    *reinterpret_cast<uint4*>(out + off) = pack8(o);
  }
}

// The backward's pass: dz, dzs, and block b's partial sums of its rows
// written whole to part[b] (3, c): [sum gm*z, sum gm*zs, sum gm]. Thread
// i's partials of its 8 channels go to red[8 i ..] (blockDim * 8 floats
// of dynamic shared memory): row group r, channel ch at red[r * c + ch],
// added for each channel in row-group order.
__global__ void bnd_bwd(const bf16* __restrict__ g,
                        const bf16* __restrict__ z,
                        const float* __restrict__ ab,
                        const bf16* __restrict__ zs,
                        const float* __restrict__ abs,
                        bf16* __restrict__ dz, bf16* __restrict__ dzs,
                        float* __restrict__ part, int m, int c) {
  extern __shared__ __align__(16) float red[];
  Layout l(c);
  const bool on = l.rsub < l.rows;
  float sz[8] = {}, szs[8] = {}, sg[8] = {};
  if (on) {
    Tables t;
    t.load(ab, abs, c, l.cv * 8);
    for (int r = blockIdx.x * l.rows + l.rsub; r < m;
         r += gridDim.x * l.rows) {
      size_t off = (size_t)r * c + l.cv * 8;
      float gf[8], zf[8], sf[8], oz[8], os[8];
      unpack8(__ldg(reinterpret_cast<const uint4*>(g + off)), gf);
      unpack8(__ldg(reinterpret_cast<const uint4*>(z + off)), zf);
      unpack8(__ldg(reinterpret_cast<const uint4*>(zs + off)), sf);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float pre = pre_act(zf[i], t.a[i], t.b[i], sf[i], t.as[i], t.bs[i]);
        float gm = pre > 0.f ? gf[i] : 0.f;
        oz[i] = gm * t.a[i];
        os[i] = gm * t.as[i];
        sz[i] += gm * zf[i];
        szs[i] += gm * sf[i];
        sg[i] += gm;
      }
      *reinterpret_cast<uint4*>(dz + off) = pack8(oz);
      *reinterpret_cast<uint4*>(dzs + off) = pack8(os);
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float* v = k == 0 ? sz : k == 1 ? szs : sg;
    if (on) {
      float4* p = reinterpret_cast<float4*>(&red[8 * threadIdx.x]);
      p[0] = make_float4(v[0], v[1], v[2], v[3]);
      p[1] = make_float4(v[4], v[5], v[6], v[7]);
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

// Block of cvecs * rows threads (~256), grid of at most 8 blocks an SM.
void shape(int m, int c, dim3& grid, dim3& block) {
  int cvecs = c / 8;
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

}  // namespace

// z, zs, out (m, c) bf16; ab, abs (2, c) f32. c % 8 == 0, c <= 8192.
// Returns the launch error (cudaSuccess = 0).
extern "C" int fused_boundary_fwd(const void* z, const void* ab,
                                  const void* zs, const void* abs, void* out,
                                  int m, int c, void* stream) {
  if (c % 8 || c > 8192) return cudaErrorInvalidValue;
  if (m == 0) return 0;
  dim3 grid, block;
  shape(m, c, grid, block);
  bnd_fwd<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(z), static_cast<const float*>(ab),
      static_cast<const bf16*>(zs), static_cast<const float*>(abs),
      static_cast<bf16*>(out), m, c);
  return cudaGetLastError();
}

// The backward's block count: the entries of its scratch buffer.
extern "C" int fused_boundary_bwd_blocks(int m, int c) {
  if (c % 8 || c > 8192 || m == 0) return 0;
  dim3 grid, block;
  shape(m, c, grid, block);
  return (int)grid.x;
}

// g, z, zs, dz, dzs (m, c) bf16; ab, abs (2, c) f32; dab, dabs (2, c)
// f32, written whole; part (blocks, 3, c) f32 scratch, blocks =
// fused_boundary_bwd_blocks(m, c). Returns the first launch error.
extern "C" int fused_boundary_bwd(const void* g, const void* z,
                                  const void* ab, const void* zs,
                                  const void* abs, void* dz, void* dzs,
                                  void* dab, void* dabs, void* part, int m,
                                  int c, int blocks, void* stream) {
  if (c % 8 || c > 8192) return cudaErrorInvalidValue;
  if (m == 0) return 0;
  dim3 grid, block;
  shape(m, c, grid, block);
  if ((int)grid.x != blocks) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  // <= 1024 threads: at most 32 KB, under the default 48 KB
  const size_t smem = (size_t)block.x * 8 * sizeof(float);
  bnd_bwd<<<grid, block, smem, s>>>(
      static_cast<const bf16*>(g), static_cast<const bf16*>(z),
      static_cast<const float*>(ab), static_cast<const bf16*>(zs),
      static_cast<const float*>(abs), static_cast<bf16*>(dz),
      static_cast<bf16*>(dzs), static_cast<float*>(part), m, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bnd_sum<<<(3 * c + 31) / 32, dim3(32, kChunks), 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(dab),
      static_cast<float*>(dabs), blocks, c);
  return cudaGetLastError();
}
