#!/usr/bin/env python3
"""Probe of the staged conv kernels (csrc/conv_bwd.cuh, through
fused_conv.cu's fused_conv_fwd and fused_conv_bwd and ghost_unit.cu's
ghost_conv_fwd and ghost_conv_bwd) and of ghost_unit.cu's seam pass
(tseam) on one CUDA GPU.

    python3 scripts/fused_bwd_probe.py

1. builds fused_conv.cu and ghost_unit.cu once more with -Xptxas -v (both
   nvcc at once) and prints the registers, shared memory and spills of
   each tdw, tdx and tseam instance: the backward's dW and dX, the
   forward (tdx with ActTr) and the seam pass;
2. runs chip_smoke.py's fused and ghost kernel phases: every kernel of
   the two sources against its plain version at every shape of the 512^2
   batch-32 step, each conv forward and backward launched twice and held
   bit-equal (the ghost boundary's backward and the seam pass too), with
   its time by CUDA events, its device time (forward; the backward's dW
   and dX; the seam) from torch.profiler and its ms a step (each shape
   times its launches).

Exits 2 without CUDA.
"""

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ptxas_report():
    """fused_conv.cu and ghost_unit.cu built with -Xptxas -v: the resource
    lines of each tdw, tdx and tseam instance, and every warning."""
    from tensorflow_ocr_tpu_torch.ops import kernels as K

    K.BUILD_DIR.mkdir(parents=True, exist_ok=True)

    def build(name):
        out = K.BUILD_DIR / f"{name}_ptxas.so"
        return name, subprocess.run(
            [K._nvcc(), *K.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out),
             str(K.CSRC_DIR / f"{name}.cu")],
            capture_output=True, text=True, check=True).stderr

    with ThreadPoolExecutor(2) as pool:
        for src, err in pool.map(build, ("fused_conv", "ghost_unit")):
            name = None
            for line in err.splitlines():
                if "Compiling entry function" in line:
                    name = line.split("'")[1]
                elif "warning" in line.lower() or (
                        name and any(k in name for k in ("tdw", "tdx",
                                                         "tseam")) and (
                            "registers" in line or "spill" in line)):
                    print(f"ptxas {src} {name}: "
                          f"{line.split(':', 1)[-1].strip()}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("fused_bwd_probe: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as C

    device = torch.device("cuda", 0)
    print(C.card_line())
    ptxas_report()
    C.build_all()
    fused = {name: {} for name in C.FUSED_KERNELS}
    C.phase_fused_kernels(device, fused)
    ghost = {name: {} for name in C.GHOST_KERNELS}
    C.phase_ghost_kernels(device, ghost)
    for name, r in (("fused_conv_fwd", fused["fused_conv_fwd"]),
                    ("fused_conv_bwd", fused["fused_conv_bwd"]),
                    ("ghost_conv_fwd", ghost["ghost_conv_fwd"]),
                    ("ghost_conv_bwd", ghost["ghost_conv_bwd"]),
                    ("ghost_boundary_bwd", ghost["ghost_boundary_bwd"]),
                    ("ghost_seam_bwd", ghost["ghost_seam_bwd"])):
        print(f"{name}: {r['ms']:.4f} ms over its shapes (events), bound "
              f"{r['bound_ms']:.4f} ({r['bound_by']}), plain "
              f"{r['plain_ms']:.4f}, max abs err {r['max_abs_err']:.3e}")
    print(C.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
