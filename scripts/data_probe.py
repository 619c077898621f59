#!/usr/bin/env python3
"""Probe of chip_smoke.py's data phase alone, on one CUDA GPU.

    python3 scripts/data_probe.py [--faults]

Builds the kernels (nvjpeg_loader.cu among them), writes phase 32's
dataset (16 default and 16 "v2" synthetic images at 1280x720), trains
the augmented state on it (AUG_TRAINED_STEPS steps, the residual BN
scales' spread printed; its checkpoint serves the detect), reads its
bf16 eval forward against the f32 one (phase 10c) and runs the data
phase: nvJPEG's decode against its committed cv2 decode and its img/s,
a JPEG and a PNG staged together, run_device_cached without and with
augmentation, 16 augmented graph steps against eager ones, the draws on
the card against the CPU's, host ingest with a mid-epoch resume, detect
on the images the port read.

``--faults`` reads the fused, pallas-conv and ghost arm checks from the
augmented state, sound and under the planted faults, in place of the
data phase.

Each part's seconds are printed. Exits 2 without CUDA.
"""

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--faults", action="store_true",
                    help="read the arm checks from the augmented state "
                    "instead of running the data phase")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("data_probe: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as c

    t0 = time.perf_counter()
    print(c.card_line())
    c.build_all()
    device = torch.device("cuda", 0)
    snap = c.seeded_snap(device)
    root, v2 = c.phase_data_write()
    start, aug_ck = c.augmented_start(device, root, snap)
    c.phase_bf16_forward(device, start, v2)
    if args.faults:
        batch = c.train_batch(np.random.RandomState(7), device,
                              c.TRAIN_BATCH, c.TRAIN_SIZE)
        c.phase_fused_faults(device, start, batch, "augmented")
        c.phase_conv_faults(device, start, batch, "augmented")
        c.phase_ghost_faults(device, start, batch, "augmented")
        import shutil

        shutil.rmtree(root)
        shutil.rmtree(aug_ck)
    else:
        c.phase_data(device, snap, root, v2, aug_ck)
    print(f"data_probe: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
