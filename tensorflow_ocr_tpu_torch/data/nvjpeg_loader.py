"""Batch decode and resize into a uint8 batch: nvJPEG on the card.

The counterpart of ``tensorflow_ocr_tpu/data/native_loader.py`` (:67-105,
over ``native/ocr_loader.cc``, which links OpenCV; the card has no
OpenCV C++ libraries): :func:`load_batch` ``(paths, out_w, out_h) ->
(images, ok, src_hw)`` with the same contract, the images (N, out_h,
out_w, 3) uint8 RGB on the caller's device.

- On the card, ``csrc/nvjpeg_loader.cu`` (built with ``nvcc -lnvjpeg`` by
  ``ops/kernels.py`` ``build_library`` into the git-ignored ``build/``,
  bound with ctypes): nvJPEG decodes each JPEG into a buffer on the card
  and ``resize_linear_u8`` resizes it into its slot of the batch, in
  ``data/codec.py`` ``resize``'s fixed point. A file without the JPEG
  magic (a PNG, a BMP: what ``cv::imread`` also reads, on the host too)
  is decoded on the host by ``codec.imread``, equal to cv2's, copied to
  the card and resized into its slot by the same ``resize_linear_u8``.
  A file that cannot be read
  or decoded is flagged in ``ok`` (its slot left zero;
  ``data/device_cache.py`` leaves it out and says so). A JPEG that
  nvJPEG refuses raises and never goes the host way, so that a broken
  decoder on the card does not pass for a dataset with fewer files.
- On the CPU, :func:`load_batch_reference`, the plain version: every file
  by ``codec.imread`` and ``codec.resize``, a JPEG it cannot decode
  raising as on the card.

``load_batch.launches`` counts the images nvJPEG decoded on the card,
``load_batch.host_decoded`` the files decoded on the host (both resized
on the card).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Tuple

import numpy as np
import torch

from tensorflow_ocr_tpu_torch.data import codec

_JPEG_MAGIC = b"\xff\xd8"


@functools.cache
def _lib():
    from tensorflow_ocr_tpu_torch.ops.kernels import build_library

    lib = ctypes.CDLL(str(build_library("nvjpeg_loader",
                                        link=("-lnvjpeg",))))
    vp, sz, ip = ctypes.c_void_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int)
    lib.nvjpeg_create.argtypes = [ctypes.POINTER(ctypes.c_void_p)]
    lib.nvjpeg_info.argtypes = [vp, ctypes.c_char_p, sz, ip, ip]
    lib.nvjpeg_decode.argtypes = [vp, ctypes.c_char_p, sz, vp, ctypes.c_int,
                                  vp]
    lib.resize_linear_u8.argtypes = [vp, ctypes.c_int, ctypes.c_int, vp,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_double, ctypes.c_double,
                                     ctypes.c_int, vp]
    for fn in (lib.nvjpeg_create, lib.nvjpeg_info, lib.nvjpeg_decode,
               lib.resize_linear_u8):
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _handle():
    """The process's nvJPEG handle and decode state."""
    h = ctypes.c_void_p()
    st = _lib().nvjpeg_create(ctypes.byref(h))
    if st != 0:
        raise RuntimeError(f"nvjpegCreateSimple failed: status {st}")
    return h


def load_batch_reference(paths: List[str], out_w: int, out_h: int
                         ) -> Tuple[torch.Tensor, np.ndarray, np.ndarray]:
    """Plain version: PIL's decode and codec.resize on the host of every
    file; a JPEG it cannot decode raises, as nvJPEG's refusal does."""
    n = len(paths)
    out = np.zeros((n, out_h, out_w, 3), np.uint8)
    ok = np.zeros(n, bool)
    src_hw = np.zeros((n, 2), np.int32)
    for i, p in enumerate(paths):
        try:
            with open(p, "rb") as f:
                is_jpeg = f.read(2).startswith(_JPEG_MAGIC)
        except OSError:
            continue
        im = codec.imread(p)
        if im is None:
            if is_jpeg:
                raise RuntimeError(f"{p}: a JPEG the decoder refuses")
            continue
        out[i] = codec.resize(im, (out_w, out_h))[:, :, ::-1]
        src_hw[i] = im.shape[:2]
        ok[i] = True
    return torch.from_numpy(out), ok, src_hw


def resize_on_card(src: torch.Tensor, out: torch.Tensor) -> None:
    """``codec.resize`` of one (h, w, 3) uint8 frame on the card into
    ``out`` (out_h, out_w, 3), on the current stream."""
    if not (src.is_cuda and out.is_cuda and src.dtype == torch.uint8
            and out.dtype == torch.uint8 and src.is_contiguous()
            and out.is_contiguous() and src.shape[-1] == 3
            and out.shape[-1] == 3):
        raise ValueError("resize_on_card takes contiguous (h, w, 3) uint8 "
                         "tensors on the card")
    (sh, sw), (dh, dw) = src.shape[:2], out.shape[:2]
    _, _, sx, sy, area2 = codec.resize_plan(sw, sh, (dw, dh))
    rc = _lib().resize_linear_u8(
        src.data_ptr(), sh, sw, out.data_ptr(), dh, dw, sx, sy, int(area2),
        torch.cuda.current_stream(out.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"resize_linear_u8 launch failed: {rc}")


def load_batch(paths: List[str], out_w: int, out_h: int, device="cuda"
               ) -> Tuple[torch.Tensor, np.ndarray, np.ndarray]:
    """(images (N, out_h, out_w, 3) uint8 RGB on ``device``, ok (N,) bool,
    src_hw (N, 2) int32 source sizes). On the card: nvJPEG, raising on a
    JPEG it refuses, and the host decode of the files that are not JPEGs,
    every frame resized by ``resize_on_card``; on the CPU: the plain
    version."""
    device = torch.device(device)
    if device.type != "cuda":
        return load_batch_reference(paths, out_w, out_h)
    lib, h = _lib(), _handle()
    stream = torch.cuda.current_stream(device).cuda_stream
    n = len(paths)
    out = torch.zeros((n, out_h, out_w, 3), dtype=torch.uint8, device=device)
    ok = np.zeros(n, bool)
    src_hw = np.zeros((n, 2), np.int32)
    for i, p in enumerate(paths):
        try:
            with open(p, "rb") as f:
                data = f.read()
        except OSError:  # flagged in ok, as a file that does not decode
            continue
        if not data.startswith(_JPEG_MAGIC):
            im = codec.imread(p)
            if im is None:  # flagged in ok, as cv::imread's empty Mat
                continue
            rgb = torch.from_numpy(np.ascontiguousarray(im[:, :, ::-1]))
            resize_on_card(rgb.to(device), out[i])
            load_batch.host_decoded += 1
            ok[i] = True
            src_hw[i] = im.shape[:2]
            continue
        w, hh = ctypes.c_int(), ctypes.c_int()
        st = lib.nvjpeg_info(h, data, len(data), ctypes.byref(w),
                             ctypes.byref(hh))
        if st != 0:
            raise RuntimeError(f"nvjpegGetImageInfo failed on {p}: status "
                               f"{st}")
        rgb = torch.empty((hh.value, w.value, 3), dtype=torch.uint8,
                          device=device)
        st = lib.nvjpeg_decode(h, data, len(data), rgb.data_ptr(),
                               w.value * 3, stream)
        if st != 0:
            raise RuntimeError(f"nvjpegDecode failed on {p}: status {st}")
        resize_on_card(rgb, out[i])
        load_batch.launches += 1
        ok[i] = True
        src_hw[i] = (hh.value, w.value)
    return out, ok, src_hw


load_batch.launches = 0
load_batch.host_decoded = 0
