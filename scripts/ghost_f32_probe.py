#!/usr/bin/env python3
"""Probe of the ghost unit's float32 kernels on one CUDA GPU.

    python3 scripts/ghost_f32_probe.py [--arm] [--graph] [--faults]
                                       [--tree DIR]

1. builds ghost_unit.cu with -Xptxas -v and prints the registers, shared
   memory and spills of each float32 kernel (tdx_f32, tdw_f32,
   gboundary32, tseam32);
2. chip_smoke.py's phase 14b: each ghost kernel in float32 along one
   unit's chain at the 4 ghost unit shapes of the 512^2 batch-32 step,
   each output's error against the float64 result beside the plain
   float32 version's, two launches bit-equal, kernel, plain and
   conv-alone ms;
3. with --graph: phase 17's graph = eager check of the float32 ghost arm;
4. with --arm: chip_smoke.py's phase 16b (3 float32 ghost steps through
   Trainer.run, the launches, img/s, peak memory, the arm check against
   the plain versions: from the augmented state with --faults, else from
   the seeded one; a float32 freeze_bn step);
5. with --faults: the readings that set chip_smoke.py's F32_GHOST_ARM_*
   bounds, 3 sound runs and phase 15's planted faults (the seam terms
   dropped, the halo rows under their own band's affine, dW2 x 0.9), from
   the augmented state (chip_smoke.py's phase 10b: the synthetic tiers
   written and 768 augmented steps).

--tree DIR runs the kernels of another checkout (e.g. a `git archive` of
the parent under the gitignored _smoke_checkout/). Exits 2 without CUDA.
"""

import argparse
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ("tdx_f32", "tdw_f32", "gboundary32", "tseam32")


def ptxas_report():
    """ghost_unit.cu built with -Xptxas -v: the resource lines of its
    float32 kernels."""
    from tensorflow_ocr_tpu_torch.ops import kernels as K

    K.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = K.BUILD_DIR / "ghost_unit_ptxas.so"
    proc = subprocess.run(
        [K._nvcc(), *K.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out),
         str(K.CSRC_DIR / "ghost_unit.cu")], capture_output=True, text=True)
    if proc.returncode:
        print(proc.stderr[-6000:])
        raise SystemExit("nvcc failed on ghost_unit.cu")
    name = None
    for line in proc.stderr.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "warning" in line.lower() or (
                name and any(k in name for k in KERNELS) and (
                    "registers" in line or "spill" in line)):
            print(f"ptxas ghost_unit.cu {name}: {line.strip()}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arm", action="store_true")
    ap.add_argument("--graph", action="store_true")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--tree", default=REPO)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ghost_f32_probe: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.tree))
    import chip_smoke as c

    t0 = time.perf_counter()
    device = torch.device("cuda", 0)
    print(f"card: {c.card_line()}; torch {torch.__version__}")
    ptxas_report()
    c.build_all()
    reports = {n: {} for n in c.GHOST_F32_KERNELS}
    c.phase_ghost_kernels_f32(device, reports)
    if not (args.arm or args.graph or args.faults):
        return 0
    import numpy as np

    batch = c.train_batch(np.random.RandomState(7), device, c.TRAIN_BATCH,
                          c.TRAIN_SIZE)
    snap = start = c.seeded_snap(device)
    if args.faults:  # first: the augmented state is --arm's start too
        import shutil

        root, _ = c.phase_data_write()
        start, _ = c.augmented_start(device, root, snap)
        shutil.rmtree(root)
        c.phase_ghost_faults(device, start, batch, "augmented", "float32")
    if args.graph:
        c.graph_equal(device, snap, c.scene_dataset(device),
                      np.random.RandomState(31), "ghost float32",
                      c.train_config("ghost", dtype="float32"))
    if args.arm:
        c.phase_ghost_train_f32(device, reports, snap, batch, start)
    print(f"ghost_f32_probe: {time.perf_counter() - t0:.1f} s; "
          f"{c.card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
