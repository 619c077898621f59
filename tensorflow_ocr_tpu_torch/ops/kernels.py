"""Connected components: the CUDA kernel's Python side and its plain version.

Port of ``tensorflow_ocr_tpu/ops/pallas_kernels.py`` (``cc_sweeps_pallas``
and ``connected_components_pallas``). :func:`connected_components`
dispatches on the tensors' device:

- CPU tensors go to :func:`connected_components_reference`, the plain
  PyTorch port of ``tensorflow_ocr_tpu/ops/decode.py:103-161``;
- CUDA tensors go to the hand-written kernel in ``csrc/cc.cu`` (block
  union-find: 32 x 32 tiles in shared memory, then the links across the
  tiles' borders in global memory, then a flatten), or raise.

The kernel is compiled with ``nvcc`` on first use into
``tensorflow_ocr_tpu_torch/build/``, keyed by a hash of the source, the
flags and the compiler, and loaded with ``ctypes``.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from tensorflow_ocr_tpu_torch.ops.labels import LINK_OFFSETS, shift_map

_PACKAGE = Path(__file__).resolve().parent.parent
CSRC_DIR = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE / "build"
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels are built from csrc/ on first use")


def build_library(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` into a shared library, once per content
    hash (of the source, the ``csrc/*.cuh`` headers it may include, the
    flags and the compiler), and return its path. Raises if ``nvcc`` is
    missing or fails."""
    src = CSRC_DIR / f"{name}.cu"
    nvcc = _nvcc()
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + "\0".join(NVCC_FLAGS + (nvcc,)).encode()
    ).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}_{digest}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent reader never sees half
    return out


@functools.cache
def _cc_label():
    fn = ctypes.CDLL(str(build_library("cc"))).cc_label
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def connected_components_reference(edges: torch.Tensor, mask: torch.Tensor,
                                   max_iters: int | None = None
                                   ) -> torch.Tensor:
    """Plain version: min-label sweeps with pointer jumping.

    edges (B, h, w, 8) bool forward links; mask (B, h, w) bool. Returns
    (B, h, w) int32: the minimum linear index of each pixel's weakly
    connected component, ``h*w`` on background. Stops when a sweep changes
    nothing or after ``h + w`` rounds, like decode.py:103-161 (an image
    that has converged is a fixed point, so the batch loop gives each
    image the result of its own loop). The CUDA kernel has no such cap:
    on a map that needs more rounds, it returns the exact components
    where this version returns a component in pieces (see csrc/cc.cu).
    """
    b, h, w = mask.shape
    n = h * w
    idx = torch.arange(n, dtype=torch.int32, device=mask.device)
    labels = torch.where(mask, idx.reshape(h, w), n)
    if max_iters is None:
        max_iters = h + w
    # an edge into me from direction c: my -offset neighbour links to me
    rev = [shift_map(edges[..., c], -dx, -dy, False)
           for c, (dx, dy) in enumerate(LINK_OFFSETS)]
    pad = torch.full((b, 1), n, dtype=torch.int32, device=mask.device)

    def sweep(labels):
        best = labels
        for c, (dx, dy) in enumerate(LINK_OFFSETS):
            fwd = shift_map(labels, dx, dy, n)
            best = torch.minimum(best, torch.where(edges[..., c], fwd, n))
            bwd = shift_map(labels, -dx, -dy, n)
            best = torch.minimum(best, torch.where(rev[c], bwd, n))
        return torch.where(mask, best, n)

    changed, it = True, 0
    while changed and it < max_iters:
        # pointer jumping: follow each label to its current root
        flat = labels.reshape(b, n)
        jumped = torch.cat([flat, pad], 1).gather(1, flat.long())
        jumped = torch.where(jumped == n, flat, jumped)
        labels = torch.minimum(labels, jumped.reshape(b, h, w))
        new = sweep(labels)
        changed = bool((new != labels).any())
        labels, it = new, it + 1
    return labels


def connected_components(edges: torch.Tensor, mask: torch.Tensor
                         ) -> torch.Tensor:
    """(B, h, w, 8) bool links + (B, h, w) bool mask -> (B, h, w) int32
    component labels (contract of :func:`connected_components_reference`).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted in ``connected_components.launches``) or raise.
    """
    if edges.device.type == "cpu" and mask.device.type == "cpu":
        return connected_components_reference(edges, mask)
    if edges.device.type != "cuda" or edges.device != mask.device:
        raise ValueError(f"edges on {edges.device}, mask on {mask.device}: "
                         "need both on one CUDA device (or both on the CPU)")
    if edges.dtype != torch.bool or mask.dtype != torch.bool:
        raise TypeError(f"need bool tensors, got {edges.dtype}, {mask.dtype}")
    if mask.dim() != 3 or tuple(edges.shape) != tuple(mask.shape) + (8,):
        raise ValueError(f"need edges (B,h,w,8) and mask (B,h,w), got "
                         f"{tuple(edges.shape)}, {tuple(mask.shape)}")
    if not (edges.is_contiguous() and mask.is_contiguous()):
        raise ValueError("edges and mask must be contiguous")
    if edges.data_ptr() % 8:
        raise ValueError("edges: the kernel loads a pixel's 8 links as one "
                         "8-byte word and needs an 8-byte aligned base")
    b, h, w = mask.shape
    if b * h * w >= 2 ** 31:
        raise ValueError(f"{b}x{h}x{w} pixels overflow the kernel's int32 "
                         "indices")
    labels = torch.empty((b, h, w), dtype=torch.int32, device=mask.device)
    if labels.numel() == 0:
        return labels
    index = mask.device.index
    # the device guard only where it is not the current device: the
    # wrapper's host time exceeds the kernel's device time
    with (contextlib.nullcontext() if index == torch.cuda.current_device()
          else torch.cuda.device(index)):
        err = _cc_label()(edges.data_ptr(), mask.data_ptr(),
                          labels.data_ptr(), b, h, w,
                          torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"cc_label launch failed: cudaError_t {err}")
    connected_components.launches += 1
    return labels


connected_components.launches = 0
