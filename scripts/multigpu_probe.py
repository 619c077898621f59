#!/usr/bin/env python3
"""Probe of chip_smoke.py's multi-GPU phases 38 and 39 alone, on one
CUDA GPU.

    python3 scripts/multigpu_probe.py [--phases 38 39]

Builds the kernels, then runs phase_multigpu (38): (a) a world-1 NCCL
group (the fused arm's 4-step graph dispatch with its all-reduces
captured, against the same dispatch with no process group;
spatial_forward at world 1 against the Predictor, in the xla and the
fused arm) and (b) two gloo ranks on the one card (one eager fused step
against the two-halves emulation), each in processes that ``python -m
torch.distributed.run`` starts; prints each rank's step ms, all-reduce
ms and peak memory with the card's name and power limit. Then
phase_spatial_arms (39): the kernel arms served sharded on H over 2 and
4 shards emulated on the one card, against the whole forward, with one
shard's device ms and peak memory. Exits 2 without CUDA.
"""

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", nargs="+", choices=("38", "39"),
                    default=("38", "39"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("multigpu_probe: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as c

    print(f"torch {torch.__version__} cuda {torch.version.cuda}; card: "
          f"{c.card_line()}", flush=True)
    t0 = time.perf_counter()
    c.build_all()
    print(f"builds {time.perf_counter() - t0:.1f} s", flush=True)
    if "38" in args.phases:
        c.phase_multigpu()
    if "39" in args.phases:
        c.phase_spatial_arms(torch.device("cuda", 0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
