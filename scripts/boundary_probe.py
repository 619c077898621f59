#!/usr/bin/env python3
"""Probe of the fused residual boundary's backward (csrc/fused_boundary.cu
fused_boundary_bwd) on one CUDA GPU, against another checkout's.

    python3 scripts/boundary_probe.py [--parent DIR]

At the 4 boundary shapes of the 512^2 batch-32 train step
(chip_smoke.py BOUNDARY_SHAPES): this tree's kernel held bit-equal over
two launches and against its plain version (dz, dzs equal; dab, dabs
within chip_smoke.py's SUM_REL), its ms by CUDA events (the wrapper's
host time included) and its device ms by CUDA-graph replay. With
``--parent``, the fused_boundary.cu of that checkout (e.g. a ``git
archive`` of the parent commit unpacked in the gitignored
``_smoke_checkout/parent``) is built too and called through its own C
entry point, whichever of the two argument lists it has (dab and dabs
zeroed by the caller and added with atomics, or the block-partials
scratch of fixed-order sums), and the two are timed in the order
parent, change, change, parent, with the largest relative difference of
their dab and dabs. Prints the sums over the 4 shapes and the bound (the
bytes over 3.35 TB/s or the f32 operations over 67 TFLOP/s, the larger).

Exits 2 without CUDA.
"""

import argparse
import ctypes
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parent_bwd(checkout):
    """The other checkout's fused_boundary_bwd as a function of (g, z, ab,
    zs, abs_) -> (dz, dab, dzs, dabs)."""
    import torch
    from tensorflow_ocr_tpu_torch.ops import kernels as K

    src = os.path.join(checkout, "tensorflow_ocr_tpu_torch", "csrc",
                       "fused_boundary.cu")
    K.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = K.BUILD_DIR / "libfused_boundary_other.so"
    subprocess.run([K._nvcc(), *K.NVCC_FLAGS, "-o", str(out), src],
                   check=True)
    lib = ctypes.CDLL(str(out))
    text = open(src).read()
    params = re.search(r'extern "C" int fused_boundary_bwd\(([^)]*)\)',
                       text).group(1).split(",")
    kinds = [ctypes.c_int if " ".join(p.split()).startswith("int ")
             else ctypes.c_void_p for p in params]
    fn = lib.fused_boundary_bwd
    fn.argtypes, fn.restype = kinds, ctypes.c_int
    scratch = len(kinds) == 14  # dab, dabs written whole from block entries
    if scratch:
        lib.fused_boundary_bwd_blocks.argtypes = [ctypes.c_int] * 2

    def run(g, z, ab, zs, abs_):
        c = z.shape[1]
        m = z.numel() // c
        dz, dzs = torch.empty_like(z), torch.empty_like(zs)
        dab = torch.zeros((2, c), device=z.device)
        dabs = torch.zeros((2, c), device=z.device)
        stream = torch._C._cuda_getCurrentRawStream(z.device.index)
        ptrs = [t.data_ptr() for t in (g, z, ab, zs, abs_, dz, dzs, dab,
                                       dabs)]
        if scratch:
            blocks = lib.fused_boundary_bwd_blocks(m, c)
            part = torch.empty((blocks, 3, c), device=z.device)
            err = fn(*ptrs, part.data_ptr(), m, c, blocks, stream)
        else:
            err = fn(*ptrs, m, c, stream)
        if err:
            raise RuntimeError(f"fused_boundary_bwd: cudaError_t {err}")
        return dz, dab, dzs, dabs
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="another checkout's root")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("boundary_probe: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as c
    from tensorflow_ocr_tpu_torch.ops import fused as FU

    print(c.card_line())
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(5)

    def act(n, ch, h, w, scale=1.0):
        return (torch.randn(n, ch, h, w, generator=gen) * scale).to(
            dev, torch.bfloat16).contiguous(memory_format=torch.channels_last)

    def table(ch):
        return torch.stack([torch.empty(ch).uniform_(0.5, 1.5, generator=gen),
                            torch.randn(ch, generator=gen) * 0.5]).to(dev)

    runs = [("change", FU.boundary_bwd)]
    if args.parent:
        other = parent_bwd(args.parent)
        runs = [("parent", other), ("change", FU.boundary_bwd),
                ("change", FU.boundary_bwd), ("parent", other)]
    sums = [0.0] * len(runs)
    device = {}
    bound = 0.0
    for n, h, w, ch in c.BOUNDARY_SHAPES:
        z, zs, g = act(n, ch, h, w), act(n, ch, h, w), act(n, ch, h, w, 1e-2)
        ab, abs_ = table(ch), table(ch)
        mc = n * h * w * ch
        bound += max(1e3 * 10 * mc / c.PEAK_F32,
                     1e3 * (10 * mc + 32 * ch) / c.PEAK_HBM)
        got = FU.boundary_bwd(g, z, ab, zs, abs_)
        again = FU.boundary_bwd(g, z, ab, zs, abs_)
        c.check(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"C={ch}: two launches differ")
        want = FU.boundary_bwd_reference(g, z, ab, zs, abs_)
        c.bf16_close("dz", got[0], want[0])
        c.bf16_close("dzs", got[2], want[2])
        line = []
        if args.parent:
            p = other(g, z, ab, zs, abs_)
            rel = max(float(((p[i] - got[i]).abs()
                             / got[i].abs().clamp_min(1e-30)).max())
                      for i in (1, 3))
            c.check(torch.equal(p[0], got[0]) and torch.equal(p[2], got[2]),
                    f"C={ch}: dz differs from the other checkout's")
            line.append(f"dab/dabs max rel diff {rel:.3e}")
        ms = []
        for i, (name, fn) in enumerate(runs):
            ms.append(c.cuda_ms(lambda: fn(g, z, ab, zs, abs_), 50))
            sums[i] += ms[-1]
        for name, fn in dict(runs).items():
            t = c.graph_ms(lambda: fn(g, z, ab, zs, abs_), 50)
            device[name] = device.get(name, 0.0) + t
            line.append(f"{name} device {t:.4f}")
        print(f"fused_boundary_bwd C={ch} at {n}x{h}x{w}: "
              + ", ".join(f"{name} {t:.4f}" for (name, _), t
                          in zip(runs, ms))
              + " ms (events); " + "; ".join(line)
              + "; this tree bit-equal twice")
    print("sums over the 4 shapes, ms by events: "
          + ", ".join(f"{name} {t:.4f}" for (name, _), t in zip(runs, sums))
          + "; device: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                     device.items())
          + f"; bound {bound:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
