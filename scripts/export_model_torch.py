#!/usr/bin/env python
"""Export a port checkpoint as a torch serving bundle.

    python scripts/export_model_torch.py --checkpoint /tmp/ckpt/ \
        --model pixellink_resnet50 --out /tmp/bundle \
        [--batch 8 --size 512 --maps-only --bake-weights --device cuda]

The port's counterpart of scripts/export_model.py, with its flags (its
``--platforms`` is ``--device`` here: a torch program runs on the device
it was exported on). The bundle is ``program.pt2`` (torch.export) and
``meta.json``; see tensorflow_ocr_tpu_torch/export.py for the contract.
The EMA weights of the newest ``ckpt_*`` under ``--checkpoint`` are
served, and the decode's operating point is the checkpoint's calibrated
one where it has one. Loading the bundle needs torch and this package's
ops (``load_serving_bundle``).
"""

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--model", default="pixellink_resnet50")
    ap.add_argument("--out", required=True)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=512,
                    help="square input size (must be a multiple of 32)")
    ap.add_argument("--maps-only", action="store_true",
                    help="export raw probability maps instead of the "
                         "decoded boxes")
    ap.add_argument("--bake-weights", action="store_true",
                    help="the weights as the program's own state (one "
                         "file to deploy) instead of an input taken from "
                         "the checkpoint")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from tensorflow_ocr_tpu_torch.export import save_serving_bundle
    from tensorflow_ocr_tpu_torch.infer import Predictor

    pred = Predictor(args.model, device=args.device,
                     checkpoint_path=args.checkpoint)
    out = save_serving_bundle(
        args.out, pred, args.batch, args.size, args.size,
        with_decode=not args.maps_only, bake_weights=args.bake_weights,
        weights_source=args.checkpoint)
    print(f"wrote serving bundle to {out} "
          f"(model={args.model}, {args.batch}x{args.size}x{args.size}, "
          f"calibrated={pred.calibrated})")
    return out


if __name__ == "__main__":
    main()
