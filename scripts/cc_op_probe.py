#!/usr/bin/env python3
"""Detect p50 and serve img/s of a checkout on one CUDA GPU, to read the
connected-components kernel's route through its torch.library op
(``tensorflow_ocr_tpu_torch::connected_components``) against a tree that
launched it through the plain wrapper.

    python3 scripts/cc_op_probe.py [--tree DIR] [--window-s S]

Runs DIR's own chip_smoke.py ``phase_main_path`` (pixellink_resnet50,
8 x 1280x768 bf16 scenes, logits scaled to unit spread, thresholds at
quantiles; the CC kernel checked against its plain version) and
``time_detect_serve`` (detect p50 at batch 1 and serve img/s at batch 8
over 3 windows of S seconds), so the same code path is timed in each tree.
Run the trees in turns in one call (parent, change, change, parent), e.g.
with the parent unpacked by ``git archive`` into the gitignored
``_smoke_checkout/parent``. Exits 2 without CUDA.
"""

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=REPO)
    ap.add_argument("--window-s", type=float, default=3.0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("cc_op_probe: torch sees no CUDA device", file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import chip_smoke as c
    from tensorflow_ocr_tpu_torch.ops import kernels as K

    route = ("op" if hasattr(K, "connected_components_op")
             else "plain wrapper")
    print(f"tree {tree}: CC through the {route}; card: {c.card_line()}")
    pred, images = c.phase_main_path(torch.device("cuda", 0), {})
    c.time_detect_serve(pred, images, args.window_s, label=f"[{route}] ")
    return 0


if __name__ == "__main__":
    sys.exit(main())
