#!/usr/bin/env python3
"""Probe of csrc/conv_dw.cu on one CUDA GPU: device time of the dW kernel
at every dW shape of the 512^2 batch-32 train step under each cluster
cap, and how many clusters of each size fit on the card at once.

    python3 scripts/conv_dw_probe.py

Device times come from torch.profiler (the sum of the device entries of
5 calls, over 5), so the wrapper's host time is left out; cuBLAS/cuDNN's
call is timed the same way beside them. The occupancy is
cudaOccupancyMaxActiveClusters of the kernel at its plan's shared
memory, from a shim built into tensorflow_ocr_tpu_torch/build/ that
includes the source. Exits 2 without CUDA.
"""

import ctypes
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SHIM = r"""
#include "conv_dw.cu"

// Clusters of cs CTAs of the dW kernel (conv_bwd.cuh's tdw with conv_dw.cu's
// identity transform) that fit on the card at once.
template <int BN, bool TWO>
int fit(int smem, int cs) {
  cudaFuncSetAttribute(bwd::tdw<BN, TWO, IdentTr>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, 1, 128);
  cfg.blockDim = dim3(bwd::THREADS);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = cs;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveClusters(&n, bwd::tdw<BN, TWO, IdentTr>, &cfg);
  return e == cudaSuccess ? n : -(int)e;
}

extern "C" int clusters(int bn, int two, int stages, int cs) {
  const int smem = stages * ((two ? 2 : 1) + bn / 64) * bwd::BOX +
                   16 * stages + 1024;
  if (bn == 256) return two ? fit<256, true>(smem, cs)
                            : fit<256, false>(smem, cs);
  if (bn == 128) return two ? fit<128, true>(smem, cs)
                            : fit<128, false>(smem, cs);
  return two ? fit<64, true>(smem, cs) : fit<64, false>(smem, cs);
}
"""


def device_ms(fn, iters=5):
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total
               for e in prof.key_averages()) / 1e3 / iters


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("conv_dw_probe: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as C
    from tensorflow_ocr_tpu_torch.ops import conv as CV
    from tensorflow_ocr_tpu_torch.ops import kernels as K

    print(C.card_line())
    K.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = K.BUILD_DIR / "conv_dw_probe.cu"
    lib = K.BUILD_DIR / "conv_dw_probe.so"
    src.write_text(SHIM)
    subprocess.run([K._nvcc(), *K.NVCC_FLAGS, "-I", str(K.CSRC_DIR), "-o",
                    str(lib), str(src)], check=True)
    shim = ctypes.CDLL(str(lib))
    for bn, two, stages in ((64, 0, 8), (64, 1, 8), (128, 1, 7), (256, 0, 5),
                            (256, 1, 4)):
        fits = {cs: shim.clusters(bn, two, stages, cs) for cs in (1, 2, 4, 8)}
        print(f"clusters that fit at once, bn {bn} two {two} stages "
              f"{stages}: {fits}")

    gen = torch.Generator().manual_seed(0)
    counts = C.route_shape_counts(C.TRAIN_BATCH, (C.TRAIN_SIZE,) * 2)

    def act(n, c, h, w):
        t = torch.randn(n, c, h, w, generator=gen)
        return t.to("cuda", torch.bfloat16).contiguous(
            memory_format=torch.channels_last)

    inputs = {}
    for n, h, w, ci, co, k, s in counts:
        if s == 1 and CV.tma_takes(ci, co):
            inputs[(n, h, w, ci, co, k)] = (act(n, ci, h, w), act(n, co, h, w))
    for cap in (1, 2, 4):
        CV.MAX_CLUSTER = cap
        CV.tma_dw_plan.cache_clear()
        sums = {1: [0.0, 0.0], 3: [0.0, 0.0]}
        for (n, h, w, ci, co, k), (x, dy) in inputs.items():
            if k == 1:
                x2, dy2 = CV.rows(x), CV.rows(dy)
                fn, lib_fn = (lambda: CV.dw_rows(x2, dy2),
                              lambda: torch.matmul(x2.t(), dy2))
                plan = CV.tma_dw_plan(1, 1, n * h * w, ci, co, 1, CV._sms(0))
            else:
                fn = lambda: CV.dw3(x, dy)
                lib_fn = lambda: torch.nn.grad.conv2d_weight(
                    x, (co, ci, 3, 3), dy, padding=1)
                plan = CV.tma_dw_plan(n, h, w, ci, co, 3, CV._sms(0))
            ms, lms = device_ms(fn), device_ms(lib_fn)
            sums[k][0] += ms
            sums[k][1] += lms
            print(f"cluster cap {cap}: {k}x{k} {ci}->{co} at {n}x{h}x{w} "
                  f"{plan}: device {ms:.4f} ms, library {lms:.4f}")
        for k, (ms, lms) in sums.items():
            print(f"cluster cap {cap}: the {k}x{k} dW shapes on conv_dw.cu "
                  f"summed: device {ms:.4f} ms, library {lms:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
