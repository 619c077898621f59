#!/usr/bin/env python3
"""Probe of the trainer's phases of chip_smoke.py alone, on one CUDA GPU.

    python3 scripts/trainer_probe.py [graph] [resume] [timing] [--windows N]
        [--loss-dtype float32|bfloat16]
    python3 scripts/trainer_probe.py eager [--windows N] [--tree DIR]
        [--model east_resnet50 --loss east]

Builds the kernels, makes the seeded state phase_train starts from
(chip_smoke.py's seeded_snap) and its dataset of numpy scenes, then runs
the phases named (graph, resume and timing by default):

- graph: phase_graph_step, the multi-step dispatch (a CUDA graph)
  against eager steps, bit-equal, for the fused, ghost, xla and xla
  pallas-conv arms;
- resume: phase_resume and phase_serve_checkpoint (resume against an
  uninterrupted run, SIGTERM, serving the checkpoint);
- timing: phase_graph_timing, train img/s through the graph for the five
  arms over N windows of at least 10 s (1 by default), with the device
  idle share of one fused and one ghost dispatch.

``--loss-dtype`` narrows graph and timing to bench.py's frozen arm
(freeze_bn, its value_freeze_bn_finetune) on the xla and the fused
bottlenecks, with the OHEM loss's compute_dtype set to it (bench.py's
recipe takes bfloat16), e.g. to time both dtypes in fresh processes:
``for d in float32 bfloat16 bfloat16 float32; do python3
scripts/trainer_probe.py timing --loss-dtype $d; done``.

``eager`` runs alone: phase_train_timing, train img/s of the eager step
(train_step a call) for the five arms over N windows, from a state
seeded as phase_train's, on the chip_smoke.py and the package of the
checkout DIR (this one by default). Given a ``git archive`` of another
commit as DIR, it times that commit's eager step with the same script,
so that two commits are compared in one call, e.g. parent, change,
change, parent. ``--model`` and ``--loss`` (eager only) time another
model of the registry with its loss, e.g. ``east_resnet50`` with
``east``, on the same numpy scenes (with their EAST geometry).

Each phase's seconds are printed. Exits 2 without CUDA.
"""

import argparse
import os
import sys
import time
import types

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("phases", nargs="*", choices=("graph", "resume",
                                                  "timing", "eager"))
    ap.add_argument("--windows", type=int, default=1)
    ap.add_argument("--loss-dtype", choices=("float32", "bfloat16"),
                    help="graph and timing: the frozen arms only, with the "
                         "OHEM loss in this dtype")
    ap.add_argument("--tree", default=REPO,
                    help="the checkout whose chip_smoke.py and package the "
                         "eager phase imports")
    ap.add_argument("--model", default=None,
                    help="eager only: the model to time (chip_smoke.py's "
                         "MODEL by default)")
    ap.add_argument("--loss", default=None,
                    help="eager only: its loss (chip_smoke.py's LOSS, ohem, "
                         "by default)")
    args = ap.parse_args()
    if "eager" in args.phases and args.phases != ["eager"]:
        ap.error("eager runs alone")
    if (args.model or args.loss) and args.phases != ["eager"]:
        ap.error("--model and --loss go with eager")
    if args.loss_dtype and "eager" in args.phases:
        ap.error("--loss-dtype goes with graph and timing")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("trainer_probe: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.tree))
    import chip_smoke as c

    phases = args.phases or ["graph", "resume", "timing"]
    t0 = time.perf_counter()

    def stamp(what):
        print(f"[{time.perf_counter() - t0:.1f} s] {what}", flush=True)

    dev = torch.device("cuda", 0)
    print(c.card_line())
    print(f"tree: {os.path.abspath(args.tree)}")
    c.build_all()
    stamp("built")
    if phases == ["eager"]:
        from tensorflow_ocr_tpu_torch.train import trainer as T

        c.ARM_WINDOWS, c.ARM_WINDOW_S = args.windows, c.TRAIN_WINDOW_S
        c.MODEL = args.model or c.MODEL
        c.LOSS = args.loss or c.LOSS
        print(f"model {c.MODEL}, loss {c.LOSS}")
        state = T.create_train_state(
            c.train_config("fused"), dev,
            generator=torch.Generator().manual_seed(11))
        batch = c.train_batch(np.random.RandomState(7), dev, c.TRAIN_BATCH,
                              c.TRAIN_SIZE)
        c.phase_train_timing(types.SimpleNamespace(state=state), batch)
        stamp("eager timing")
        return 0
    snap = c.seeded_snap(dev)
    ds = c.scene_dataset(dev)
    stamp("seeded state and dataset")
    frozen = [(f"freeze_bn {impl} {args.loss_dtype}-loss", impl, True, False)
              for impl in c.FROZEN_IMPLS]
    if "graph" in phases:
        if args.loss_dtype:
            rng = np.random.RandomState(31)
            for label, impl, _, _ in frozen:
                c.graph_equal(dev, snap, ds, rng, label, c.train_config(
                    impl, True, loss_dtype=args.loss_dtype))
        else:
            c.phase_graph_step(dev, snap, ds)
        stamp("graph step")
    if "resume" in phases:
        images = c.scene_images(np.random.RandomState(0), 8)
        root, served = c.phase_resume(dev, c.serving_start(dev, snap, images),
                                      ds)
        c.phase_serve_checkpoint(dev, root, served, images)
        stamp("resume and serve")
    if "timing" in phases:
        c.GRAPH_WINDOWS = args.windows
        c.ARM_WINDOW_S = 10
        if args.loss_dtype:
            c.phase_graph_timing(snap, ds, arms=frozen,
                                 loss_dtype=args.loss_dtype)
        else:
            c.phase_graph_timing(snap, ds, True)
        stamp("graph timing")
    return 0


if __name__ == "__main__":
    sys.exit(main())
