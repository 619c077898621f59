#!/usr/bin/env python
"""Held-out evaluation of the PyTorch port on hard synthetic scenes.

The port's counterpart of scripts/holdout_eval.py, with its flags, its
defaults and its record: render two DISJOINT synthetic sets, train on
one (optionally warm-started from a pretrain on an easy set), and report
P/R/F with the EMA weights on the other, at the default decode
thresholds, at the operating point calibrated on an 8-image slice of the
TRAIN split (what a Predictor serving this checkpoint adopts), and with
--sweep-thresholds at the best point of a sweep on the held-out set. One
device, no mesh; the port imports nothing of JAX.

Usage (on the GPU):
    python scripts/holdout_eval_torch.py --model pixellink_resnet50 \\
        --steps 5000 --pretrain-steps 1000 --augment --scenes v2 \\
        --train-images 64 --val-images 16 --batch 8 --lr 3e-4 \\
        --sweep-thresholds --json quality.json

The data sets and checkpoints go under --work-dir (by default the
checkout's gitignored tensorflow_ocr_tpu_torch/build/holdout/).
"""

import argparse
import contextlib
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--model", default="pixellink_resnet50")
    ap.add_argument("--train-images", type=int, default=32)
    ap.add_argument("--val-images", type=int, default=16)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--loss", default=None,
                    help="override the head's default loss (ohem for the "
                         "pixel/link heads, east for EAST), e.g. focal")
    ap.add_argument("--input-size", type=int, default=512,
                    help="train/eval square size (multiple of 32)")
    ap.add_argument("--pretrain-steps", type=int, default=0,
                    help="first train this many steps on an EASY synthetic "
                         "set and warm-start the hard training from that "
                         "checkpoint")
    ap.add_argument("--freeze-bn", action="store_true",
                    help="freeze BN statistics during the hard training")
    ap.add_argument("--augment", action="store_true",
                    help="train with crop/rotate/scale augmentation on the "
                         "device, inside the captured step "
                         "(run_device_cached)")
    ap.add_argument("--host-augment", action="store_true",
                    help="augment on the host instead (PrefetchLoader and "
                         "Trainer.run)")
    ap.add_argument("--min-size", type=int, default=None,
                    help="override infer.min_component_size")
    ap.add_argument("--sweep-thresholds", action="store_true",
                    help="after training, sweep the decode thresholds on "
                         "the held-out set and report the best point")
    ap.add_argument("--geometry", default="RBOX", choices=["RBOX", "QUAD"],
                    help="EAST head geometry")
    ap.add_argument("--scenes", default="v1",
                    choices=["v1", "v2", "photo", "photo_mix", "photo2"],
                    help="hard-scene tier: v1, v2, photo (v2 instances "
                         "over package photographs, disjoint train/val "
                         "sets), photo_mix (train on half v2, half "
                         "photo:train; val photo:val) or photo2 (photo "
                         "with the texture sets added)")
    ap.add_argument("--note", default=None,
                    help="free-text annotation stored in the JSON record")
    ap.add_argument("--json", default=None, metavar="OUT",
                    help="append a result record to this file's 'runs' "
                         "list (created if missing)")
    ap.add_argument("--seed", type=int, default=0,
                    help="TrainConfig.seed of both trainings: the init, "
                         "the row order and the augmentation draws (the "
                         "data sets keep their seeds)")
    ap.add_argument("--bottleneck-impl", default=None,
                    choices=["xla", "fused", "ghost"],
                    help="ModelConfig.bottleneck_impl of both trainings "
                         "(default: the config's, \"xla\", as "
                         "holdout_eval.py trains); stored in the record")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--work-dir", default=os.path.join(
        REPO, "tensorflow_ocr_tpu_torch", "build", "holdout"))
    return ap.parse_args(argv)


def prf(d):
    return {k: round(float(d.get(k, 0.0)), 4)
            for k in ("precision", "recall", "fmean")}


def line(d):
    return (f"P={d.get('precision', 0):.4f} R={d.get('recall', 0):.4f} "
            f"F={d.get('fmean', 0):.4f}")


def main(argv=None):
    args = parse_args(argv)

    from tensorflow_ocr_tpu_torch.config import Config
    from tensorflow_ocr_tpu_torch.data.icdar import make_synthetic_dataset
    from tensorflow_ocr_tpu_torch.models.detector import model_head
    from tensorflow_ocr_tpu_torch.ops.losses import (
        effective_loss_compute_dtype)
    from tensorflow_ocr_tpu_torch.train import trainer as T
    from tensorflow_ocr_tpu_torch.train.calibrate import (
        LINK_GRID,
        NMS_GRID,
        PIXEL_GRID,
        SCORE_GRID,
        calibrate_thresholds,
    )
    from tensorflow_ocr_tpu_torch.train.eval_hook import EvalDuringTraining

    t_start = time.time()
    hard = "v2" if args.scenes == "v2" else True
    hard_val = hard
    if args.scenes.startswith("photo"):
        # disjoint sets of package photographs for the two splits
        tier = "photo2" if args.scenes == "photo2" else "photo"
        hard, hard_val = f"{tier}:train", f"{tier}:val"
    suffix = "" if args.scenes == "v1" else f"_{args.scenes}"
    size = args.input_size
    if size != 512:
        suffix += f"_{size}"
    work = args.work_dir
    train_dir = os.path.join(work, f"train{suffix}")
    val_dir = os.path.join(work, f"val{suffix}")
    if args.scenes == "photo_mix":
        # half v2 scenes, half photo:train: four train photographs alone
        # are memorised (holdout_eval.py:112-123)
        half = args.train_images // 2
        make_synthetic_dataset(train_dir, half, (size, size), seed=0,
                               hard="v2")
        make_synthetic_dataset(train_dir, args.train_images - half,
                               (size, size), seed=2, hard="photo:train",
                               start_index=half)
    else:
        make_synthetic_dataset(train_dir, args.train_images, (size, size),
                               seed=0, hard=hard)
    make_synthetic_dataset(val_dir, args.val_images, (size, size),
                           seed=1, hard=hard_val)
    is_east = model_head(args.model) == "east"

    def base_cfg():
        cfg = Config()
        cfg.model.name = args.model
        if args.bottleneck_impl is not None:
            cfg.model.bottleneck_impl = args.bottleneck_impl
        cfg.loss.name = args.loss or ("east" if is_east else "ohem")
        cfg.data.input_size = size
        cfg.data.geometry = args.geometry
        cfg.data.batch_size = args.batch
        cfg.data.max_polys = 16
        cfg.data.min_text_size = 5
        cfg.train.scan_steps = 25
        cfg.train.learning_rate = args.lr
        cfg.train.seed = args.seed
        cfg.train.save_checkpoint_steps = 0
        cfg.train.log_every_steps = 100
        if args.min_size is not None:
            cfg.infer.min_component_size = args.min_size
        return cfg

    pretrain_ckpt = None
    if args.pretrain_steps > 0:
        psuf = f"_{size}" if size != 512 else ""
        easy_dir = os.path.join(work, f"pretrain{psuf}")
        pretrain_ckpt = os.path.join(work, f"pretrain_ckpt{psuf}")
        make_synthetic_dataset(easy_dir, args.train_images, (size, size),
                               seed=2, hard=False)
        pcfg = base_cfg()
        pcfg.data.training_data_path = easy_dir
        pcfg.train.max_steps = args.pretrain_steps
        pcfg.train.checkpoint_path = pretrain_ckpt
        ptr = T.Trainer(pcfg, args.device)
        t0 = time.time()
        pm = ptr.run_device_cached()
        print(f"pretrained {args.pretrain_steps} steps on easy scenes in "
              f"{time.time() - t0:.1f}s; loss {pm.get('total_loss'):.3f}")
        T.save_checkpoint(pretrain_ckpt, ptr.state)
        del ptr

    cfg = base_cfg()
    cfg.data.training_data_path = train_dir
    cfg.train.max_steps = args.steps
    cfg.model.freeze_bn = args.freeze_bn
    if pretrain_ckpt:
        cfg.train.pretrained_model_path = pretrain_ckpt
    if args.augment or args.host_augment:
        cfg.data.use_crop = cfg.data.use_rotate = True
        cfg.data.use_random_scale = True
    tr = T.Trainer(cfg, args.device)
    t0 = time.time()
    if args.host_augment:
        from tensorflow_ocr_tpu_torch.data.pipeline import PrefetchLoader

        loader = PrefetchLoader(cfg.data, want_east=is_east,
                                seed=cfg.train.seed)
        tr.setup()
        try:
            metrics = tr.run(loader, max_steps=args.steps)
        finally:
            loader.stop()
    else:
        metrics = tr.run_device_cached()
    dt = time.time() - t0
    print(f"trained {args.steps} steps in {dt:.1f}s "
          f"({args.steps * args.batch / dt:.1f} img/s); {metrics}")

    t_eval = time.time()
    val_hook = EvalDuringTraining(cfg, val_dir, max_images=args.val_images)
    train_hook = EvalDuringTraining(cfg, train_dir, max_images=16)
    val = val_hook(tr.state.model, tr.state, use_ema=True)
    train = train_hook(tr.state.model, tr.state, use_ema=True)
    del train_hook
    print(f"VAL  (held out, {args.val_images} imgs): {line(val)}")
    print(f"TRAIN (seen, 16 imgs):                  {line(train)}")

    # what a Predictor serving this checkpoint adopts: the operating point
    # calibrated on an 8-image slice of the TRAIN split, scored on val
    t0 = time.time()
    calib = calibrate_thresholds(tr.state.model, tr.state, cfg, train_dir,
                                 max_images=8)
    calib_s = time.time() - t0
    val_cal = val
    if calib:
        kw = ({"score_thresh": calib["score"], "nms_thresh": calib["nms"]}
              if is_east else
              {"pixel_thresh": calib["pixel"], "link_thresh": calib["link"]})
        val_cal = val_hook(tr.state.model, tr.state, use_ema=True, **kw)
        print(f"CALIBRATED (train-slice sweep, {calib_s:.2f}s) {calib}: "
              f"{line(val_cal)}")

    icfg = cfg.infer
    if is_east:
        best_thresholds = (icfg.score_map_thresh, icfg.nms_thresh)
    else:
        best_thresholds = (icfg.pixel_conf_threshold,
                           icfg.link_conf_threshold)
    best_val = val
    if args.sweep_thresholds:
        grid = ([(a, b) for a in SCORE_GRID for b in NMS_GRID] if is_east
                else [(a, b) for a in PIXEL_GRID for b in LINK_GRID])
        best = (val.get("fmean", 0.0), *best_thresholds, val)
        with val_hook.cached_forward():
            for a, b in grid:
                kw = ({"score_thresh": a, "nms_thresh": b} if is_east else
                      {"pixel_thresh": a, "link_thresh": b})
                r = val_hook(tr.state.model, tr.state, use_ema=True, **kw)
                f = r.get("fmean", 0.0)
                print(f"  sweep {a:.1f}/{b:.1f}: {line(r)}")
                if f > best[0]:
                    best = (f, a, b, r)
        f, a, b, r = best
        best_thresholds, best_val = (a, b), r
        print(f"BEST thresholds {a}/{b} -> {line(r)}")
    eval_s = time.time() - t_eval
    wall = time.time() - t_start
    print(f"held-out eval: {eval_s:.1f}s of eval and calibration, overflow "
          f"retries val {val_hook.overflow_retries}; wall {wall:.1f}s")

    if args.json:
        record = {
            "model": args.model,
            "geometry": args.geometry if is_east else None,
            "steps": args.steps,
            "batch": args.batch,
            "lr": args.lr,
            "loss": cfg.loss.name,
            # the dtype the loss ran in: the config's, or OCR_LOSS_BF16's
            "loss_compute_dtype": effective_loss_compute_dtype(
                cfg.loss.compute_dtype, cfg.loss.name),
            "input_size": size,
            "recipe": {
                "pretrain_steps": args.pretrain_steps,
                "freeze_bn": args.freeze_bn,
                "augment": args.augment or args.host_augment,
                "augment_path": ("host" if args.host_augment
                                 else "device" if args.augment else None),
                "min_component_size": icfg.min_component_size,
                "bottleneck_impl": cfg.model.bottleneck_impl,
                "seed": args.seed,
            },
            "data": {
                "train_images": args.train_images,
                "val_images": args.val_images,
                "train_seed": 0,
                "val_seed": 1,
                "scenes": args.scenes,
            },
            # wall-clock img/s (staging and the graph capture included)
            "train_images_per_sec": round(args.steps * args.batch / dt, 1),
            # the median dispatch after the first (device-cached loop only)
            "train_images_per_sec_steady": (
                round(metrics["images_per_sec_steady"], 1)
                if "images_per_sec_steady" in metrics else None),
            "val": prf(val),
            "train": prf(train),
            "calibrated_thresholds": calib,
            "val_at_calibrated": prf(val_cal),
            "thresholds": ({"score": best_thresholds[0],
                            "nms": best_thresholds[1]} if is_east else
                           {"pixel": best_thresholds[0],
                            "link": best_thresholds[1]}),
            "val_at_best_thresholds": prf(best_val),
            "calibration_seconds": round(calib_s, 3),
            "train_seconds": round(dt, 1),
            "wall_seconds": round(wall, 1),
            "device": _device_name(args.device),
        }
        if args.note:
            record["note"] = args.note
        doc = {"runs": []}
        if os.path.exists(args.json):
            with open(args.json) as f, contextlib.suppress(ValueError):
                doc = json.load(f)
            doc.setdefault("runs", [])
        doc["runs"].append(record)
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(doc, f, indent=1)
        print(f"wrote {args.json} ({len(doc['runs'])} runs)")
        print(json.dumps(record))


def _device_name(device):
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    return torch.cuda.get_device_name(dev)


if __name__ == "__main__":
    main()
