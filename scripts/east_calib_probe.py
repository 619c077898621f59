#!/usr/bin/env python3
"""How well chip_smoke.py's EAST state detects the scenes it trains on.

    python3 scripts/east_calib_probe.py [--steps 448,896,1792]

Trains east_resnet50 (RBOX, the EAST loss, the fused arm, 512^2, batch
32) from the seeded state of chip_smoke.py's phase 25 through the graph
dispatch on its dataset of DATASET_SCENES numpy scenes, and at each step
count of ``--steps`` scores the first EVAL_IMAGES of those scenes
(chip_smoke.east_scenes, written by chip_smoke.east_scene_dir) with the
eval hook: P/R/F with the EMA and with the raw weights at a few score x
NMS points, at the matching IoU of 0.5 and, to tell the box geometry
from the score map, at 0.1; the boxes kept an image and each
evaluation's seconds.

Exits 2 without CUDA.
"""

import argparse
import copy
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVAL_IMAGES = 4
# (score, nms) points: the sweep's lowest and the defaults
POINTS = ((0.5, 0.1), (0.8, 0.2))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", default="448,896,1792",
                    help="comma-separated step counts to score at")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("east_calib_probe: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as c
    from tensorflow_ocr_tpu_torch.train import trainer as T
    from tensorflow_ocr_tpu_torch.train.eval_hook import EvalDuringTraining

    t0 = time.perf_counter()
    print(c.card_line())
    c.build_all()
    device = torch.device("cuda", 0)
    cfg = c.east_config()
    state = T.create_train_state(cfg, device,
                                 generator=torch.Generator().manual_seed(13))
    batch = c.east_scenes(device)
    scenes = c.east_scene_dir(batch, EVAL_IMAGES)
    ds = T.device_dataset(batch, cfg, device)
    del batch
    loose = copy.deepcopy(cfg)
    loose.eval.matching_iou_threshold = 0.1
    hooks = {0.5: EvalDuringTraining(cfg, scenes, max_images=EVAL_IMAGES),
             0.1: EvalDuringTraining(loose, scenes, max_images=EVAL_IMAGES)}
    n_gt = sum(int((~ig).sum()) for _, ig in hooks[0.5].gts)
    print(f"east_calib_probe: {EVAL_IMAGES} train scenes, {n_gt} cared-for "
          f"quads")
    multi = T.make_multi_train_step(state, cfg, T.label_keys(cfg))
    rng = np.random.RandomState(73)
    for target in sorted(int(s) for s in args.steps.split(",")):
        t1 = time.perf_counter()
        while int(state.step) < target:
            last = multi(state, ds, c.dispatch_rows(rng, cfg.train.scan_steps,
                                                    device))
        torch.cuda.synchronize()
        print(f"step {int(state.step)}: trained in "
              f"{time.perf_counter() - t1:.1f} s, model loss "
              f"{float(last['model_loss']):.6f}")
        for iou, hook in hooks.items():
            for use_ema in (True, False):
                with hook.cached_forward():
                    for st, nt in POINTS:
                        t2 = time.perf_counter()
                        r = hook(None, state, use_ema=use_ema,
                                 score_thresh=st, nms_thresh=nt)
                        print(f"  iou {iou} {'ema' if use_ema else 'raw'} "
                              f"({st}, {nt}): P {r['precision']:.4f} R "
                              f"{r['recall']:.4f} F {r['fmean']:.4f} ({r})"
                              f" in {time.perf_counter() - t2:.3f} s")
    multi.release()
    import shutil

    shutil.rmtree(scenes)
    print(f"east_calib_probe: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
