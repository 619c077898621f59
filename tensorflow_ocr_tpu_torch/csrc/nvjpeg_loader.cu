// Batch JPEG decode and resize on the card: the counterpart of
// native/ocr_loader.cc (tensorflow_ocr_tpu/data/native_loader.py:67-105),
// which decodes and resizes a batch with OpenCV on a C++ thread pool.
//
// nvjpeg_decode: nvJPEG's decode of one JPEG (Huffman on the host, the
// IDCT and colour conversion on the card) into an interleaved RGB buffer
// the caller allocated on the card. resize_linear_u8: cv2.resize
// (INTER_LINEAR) on HWC uint8 in cv2's fixed point, the arithmetic of
// data/codec.py resize: a thread an output pixel, the 11-bit weights from
// the float position, each row sum >> 4 times the row weight >> 16, then
// (sum + 2) >> 2; an exact 2x downscale is the 2x2 mean, as cv2 hands it
// to INTER_AREA. Bound by bytes: one read of the source, one write of the
// output. Neither allocates; both run on the caller's stream and return
// the launch's (or nvJPEG's) status.
#include <cuda_runtime.h>
#include <nvjpeg.h>
#include <math.h>

extern "C" {

struct NvjHandle {
  nvjpegHandle_t handle;
  nvjpegJpegState_t state;
};

int nvjpeg_create(void** out) {
  NvjHandle* h = new NvjHandle();
  nvjpegStatus_t st = nvjpegCreateSimple(&h->handle);
  if (st != NVJPEG_STATUS_SUCCESS) { delete h; return (int)st; }
  st = nvjpegJpegStateCreate(h->handle, &h->state);
  if (st != NVJPEG_STATUS_SUCCESS) {
    nvjpegDestroy(h->handle);
    delete h;
    return (int)st;
  }
  *out = h;
  return 0;
}

int nvjpeg_destroy(void* p) {
  NvjHandle* h = (NvjHandle*)p;
  nvjpegJpegStateDestroy(h->state);
  nvjpegDestroy(h->handle);
  delete h;
  return 0;
}

// width and height of a JPEG's first component; nvJPEG's status
int nvjpeg_info(void* p, const unsigned char* data, size_t len, int* width,
                int* height) {
  NvjHandle* h = (NvjHandle*)p;
  int n = 0;
  nvjpegChromaSubsampling_t sub;
  int w[NVJPEG_MAX_COMPONENT], hh[NVJPEG_MAX_COMPONENT];
  nvjpegStatus_t st = nvjpegGetImageInfo(h->handle, data, len, &n, &sub, w, hh);
  if (st != NVJPEG_STATUS_SUCCESS) return (int)st;
  *width = w[0];
  *height = hh[0];
  return 0;
}

int nvjpeg_decode(void* p, const unsigned char* data, size_t len,
                  unsigned char* rgb, int pitch, cudaStream_t stream) {
  NvjHandle* h = (NvjHandle*)p;
  nvjpegImage_t img = {};
  img.channel[0] = rgb;
  img.pitch[0] = (unsigned int)pitch;
  nvjpegStatus_t st = nvjpegDecode(h->handle, h->state, data, len,
                                   NVJPEG_OUTPUT_RGBI, &img, stream);
  return (int)st;
}

}  // extern "C"

// clamp_w: along x cv2 clamps a position outside the image to the border
// pixel with weights (2048, 0); along y it keeps the fraction's weights
// and clamps only the two row indices (codec.py _linear_taps).
__device__ __forceinline__ void taps(int d, int n_in, double scale,
                                     bool clamp_w, int* s0, int* s1,
                                     int* w0, int* w1) {
  float f = (float)(((double)d + 0.5) * scale - 0.5);
  int s = (int)floorf(f);
  f = f - (float)s;
  if (clamp_w && s < 0) { f = 0.f; s = 0; }
  if (clamp_w && s >= n_in - 1) { f = 0.f; s = n_in - 1; }
  *s0 = min(max(s, 0), n_in - 1);
  *s1 = min(max(s + 1, 0), n_in - 1);
  *w0 = __float2int_rn((1.f - f) * 2048.f);
  *w1 = __float2int_rn(f * 2048.f);
}

__global__ void resize_linear_kernel(const unsigned char* __restrict__ src,
                                     int sh, int sw,
                                     unsigned char* __restrict__ dst, int dh,
                                     int dw, double scale_x, double scale_y,
                                     int area2) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y;
  if (x >= dw) return;
  unsigned char* out = dst + ((size_t)y * dw + x) * 3;
  if (area2) {
    const unsigned char* a = src + ((size_t)(2 * y) * sw + 2 * x) * 3;
    const unsigned char* b = a + (size_t)sw * 3;
    for (int c = 0; c < 3; ++c)
      out[c] = (unsigned char)((a[c] + a[3 + c] + b[c] + b[3 + c] + 2) >> 2);
    return;
  }
  int x0, x1, a0, a1, y0, y1, b0, b1;
  taps(x, sw, scale_x, true, &x0, &x1, &a0, &a1);
  taps(y, sh, scale_y, false, &y0, &y1, &b0, &b1);
  const unsigned char* r0 = src + (size_t)y0 * sw * 3;
  const unsigned char* r1 = src + (size_t)y1 * sw * 3;
  for (int c = 0; c < 3; ++c) {
    int top = r0[x0 * 3 + c] * a0 + r0[x1 * 3 + c] * a1;
    int bot = r1[x0 * 3 + c] * a0 + r1[x1 * 3 + c] * a1;
    int v = ((((top >> 4) * b0) >> 16) + (((bot >> 4) * b1) >> 16) + 2) >> 2;
    out[c] = (unsigned char)min(max(v, 0), 255);
  }
}

extern "C" int resize_linear_u8(const unsigned char* src, int sh, int sw,
                                unsigned char* dst, int dh, int dw,
                                double scale_x, double scale_y, int area2,
                                cudaStream_t stream) {
  dim3 block(128);
  dim3 grid((dw + 127) / 128, dh);
  resize_linear_kernel<<<grid, block, 0, stream>>>(src, sh, sw, dst, dh, dw,
                                                   scale_x, scale_y, area2);
  return (int)cudaGetLastError();
}
