#!/usr/bin/env python3
"""Levers on the port's held-out F at the default thresholds.

Runs ``scripts/holdout_eval_torch.py``'s flagship recipe unchanged
(``pixellink_resnet50``, 1000 easy + 5000 augmented steps of batch 8,
64 train / 16 val v2 scenes, lr 3e-4, the threshold sweep, the config's
"xla" bottleneck) with one lever applied at a time, each run in a fresh
process, the lever set by a config field or a patch inside that process
only (the package has no switch for any of them):

- ``L0``: the unchanged recipe; then its final state is scored at the
  default thresholds four ways: EMA and raw weights, each through the
  eval module in bfloat16 and in float32 (TF32 off), with the maps'
  confidence beside them (the mean pixel probability, the share above
  the default threshold, the bf16 logits against the f32 ones).
- ``L1``: ``ModelConfig.compute_dtype = "float32"``, TF32 off.
- ``L2``: the datasets staged through the host decode (``codec``: PIL,
  equal to cv2, and ``codec.resize``) in place of nvJPEG: both the easy
  pretrain and the hard set, which ``Trainer.run_device_cached`` stages
  with its augmentation flags off.
- ``L3``: the unchanged recipe (the port's own seed spread).

Usage (on the GPU; about 6 minutes a bfloat16 run and 10 a float32 one
on an H100):

    python3 scripts/holdout_lever_probe.py L0:0 L1:0 L1:1 \\
        --json chiprun_out/levers.json

Each ``LEVER:SEED`` is one run. Arguments after ``--`` are appended to
the recipe's (the later flag wins), for a rehearsal at a small size,
e.g. ``-- --model pixellink_tiny --steps 2 --device cpu``. A run's data
and checkpoints go under ``tensorflow_ocr_tpu_torch/build/`` (or its
``--work-dir``) and are removed after it.
Each run's record (holdout_eval_torch.py's, plus ``lever``,
``nvjpeg_images`` and ``host_staged_images`` and, for L0, ``l0``) is
appended to ``--json``; a table of lever, seed, default / calibrated /
best F and train seconds ends the output. Prints the card's name and
power limit first.
"""

import argparse
import contextlib
import copy
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

RECIPE = ["--model", "pixellink_resnet50", "--steps", "5000",
          "--pretrain-steps", "1000", "--augment", "--scenes", "v2",
          "--train-images", "64", "--val-images", "16", "--batch", "8",
          "--lr", "3e-4", "--sweep-thresholds"]
LEVERS = ("L0", "L1", "L2", "L3")


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip() or "nvidia-smi: no output"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def apply_lever(lever: str, counts: dict) -> None:
    """Patch this process for ``lever``; ``counts`` gathers the images
    each staging took."""
    from tensorflow_ocr_tpu_torch import config as C
    from tensorflow_ocr_tpu_torch.data import device_cache as DC
    from tensorflow_ocr_tpu_torch.data import nvjpeg_loader as NJ

    if lever == "L1":
        base = C.Config

        class F32Config(base):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                self.model.compute_dtype = "float32"

        C.Config = F32Config
        import torch

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if lever == "L2":
        def host_stage(self, files, cfg, want_east):
            size = cfg.input_size
            loaded = NJ.load_batch_reference(files, size, size)
            counts["host_staged_images"] += int(loaded[1].sum())
            return DC.stage_loaded(files, *loaded, cfg, want_east)

        DC.DeviceDataset._stage_nvjpeg = host_stage


def confidence(hook, state, use_ema: bool):
    """The val maps' confidence through ``hook``'s module (the mean pixel
    probability, the share of pixels above the default pixel threshold)
    and its logits, for the bf16/f32 comparison."""
    import torch

    from tensorflow_ocr_tpu_torch.infer import pixel_link_scores

    with torch.no_grad():
        out = hook._load(state, use_ema)(hook._x)
        pixel, _ = pixel_link_scores(out)
    thr = hook.cfg.infer.pixel_conf_threshold
    return ({"mean_pixel_prob": float(pixel.float().mean()),
             "share_above_default": float((pixel > thr).float().mean())},
            {k: v.float() for k, v in out.items()})


def score_l0(cfg, state, val_dir: str, val_images: int) -> dict:
    """L0: the final state at the default thresholds, EMA and raw, the
    eval module in bfloat16 and in float32 (TF32 off), each with its
    best point of the sweep and its maps' confidence."""
    from tensorflow_ocr_tpu_torch.ops.fused import full_f32
    from tensorflow_ocr_tpu_torch.train.calibrate import (LINK_GRID,
                                                          PIXEL_GRID)
    from tensorflow_ocr_tpu_torch.train.eval_hook import EvalDuringTraining

    out, logits = {}, {}
    for dtype in ("bfloat16", "float32"):
        c = copy.deepcopy(cfg)
        c.model.compute_dtype = dtype
        hook = EvalDuringTraining(c, val_dir, max_images=val_images)
        ctx = full_f32() if dtype == "float32" else contextlib.nullcontext()
        with ctx:
            for use_ema in (True, False):
                name = f"{'ema' if use_ema else 'raw'}_{dtype}"
                default = hook(state.model, state, use_ema=use_ema)
                best = (default.get("fmean", 0.0), None)
                with hook.cached_forward():
                    for a in PIXEL_GRID:
                        for b in LINK_GRID:
                            f = hook(state.model, state, use_ema=use_ema,
                                     pixel_thresh=a, link_thresh=b).get(
                                         "fmean", 0.0)
                            if f > best[0]:
                                best = (f, (a, b))
                conf, logits[name] = confidence(hook, state, use_ema)
                out[name] = {"default_f": round(default.get("fmean", 0), 4),
                             "best_f": round(best[0], 4),
                             "best_at": best[1], **conf}
                print(f"L0 {name}: default F {out[name]['default_f']}, "
                      f"best {out[name]['best_f']} at {best[1]}, mean "
                      f"pixel prob {conf['mean_pixel_prob']:.4f}, share "
                      f"above {conf['share_above_default']:.4f}")
        del hook
    for kind in ("ema", "raw"):
        lo, hi = logits[f"{kind}_bfloat16"], logits[f"{kind}_float32"]
        for key in ("pixel_logits", "link_logits"):
            d = lo[key] - hi[key]
            scale = float(hi[key].abs().max())
            out[f"{kind}_{key}_bf16_vs_f32"] = {
                "mean_abs_over_scale": float(d.abs().mean()) / scale,
                "max_abs_over_scale": float(d.abs().max()) / scale,
                "mean_signed": float(d.mean()),
            }
            print(f"L0 {kind} {key} bf16 - f32: "
                  f"{out[f'{kind}_{key}_bf16_vs_f32']}")
    return out


def run_one(lever: str, seed: int, json_path: str, extra) -> int:
    """One run of the recipe under ``lever`` in this process."""
    import importlib.util

    from tensorflow_ocr_tpu_torch.data import nvjpeg_loader as NJ

    counts = {"host_staged_images": 0}
    apply_lever(lever, counts)
    spec = importlib.util.spec_from_file_location(
        "holdout_eval_torch", os.path.join(REPO, "scripts",
                                           "holdout_eval_torch.py"))
    holdout = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(holdout)
    from tensorflow_ocr_tpu_torch.train import trainer as T

    trainers = []

    class Kept(T.Trainer):  # the last trainer: its final state for L0
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            trainers[:] = [self]

    T.Trainer = Kept
    work = os.path.join(REPO, "tensorflow_ocr_tpu_torch", "build",
                        f"levers_{lever}_{seed}")
    tmp = f"{json_path}.{lever}_{seed}.tmp"
    if os.path.exists(tmp):
        os.remove(tmp)
    argv = RECIPE + ["--seed", str(seed), "--work-dir", work, "--json", tmp,
                     "--note", lever] + list(extra)
    ns = holdout.parse_args(argv)
    work = ns.work_dir  # the caller's --work-dir wins
    try:
        holdout.main(argv)
        with open(tmp) as f:
            record = json.load(f)["runs"][-1]
        record["lever"] = lever
        record["model_compute_dtype"] = trainers[0].cfg.model.compute_dtype
        record["nvjpeg_images"] = NJ.load_batch.launches
        record["host_staged_images"] = counts["host_staged_images"]
        if lever == "L0":
            tr = trainers[0]
            suffix = "" if ns.scenes == "v1" else f"_{ns.scenes}"
            if ns.input_size != 512:
                suffix += f"_{ns.input_size}"
            record["l0"] = score_l0(tr.cfg, tr.state,
                                    os.path.join(work, f"val{suffix}"),
                                    ns.val_images)
    finally:
        shutil.rmtree(work, ignore_errors=True)
        if os.path.exists(tmp):
            os.remove(tmp)
    doc = {"runs": []}
    if os.path.exists(json_path):
        with open(json_path) as f, contextlib.suppress(ValueError):
            doc = json.load(f)
    doc.setdefault("runs", []).append(record)
    os.makedirs(os.path.dirname(os.path.abspath(json_path)), exist_ok=True)
    with open(json_path, "w") as f:
        json.dump(doc, f, indent=1)
    print("LEVER_RECORD " + json.dumps(record))
    return 0


def table(records) -> str:
    rows = ["| lever | seed | default F | calibrated F (at) | best F (at) | "
            "train s | nvJPEG / host-staged images |", "|---|---|---|---|---|---|---|"]
    for r in records:
        cal, best = r["calibrated_thresholds"] or {}, r["thresholds"]
        rows.append(
            f"| {r['lever']} | {r['recipe']['seed']} | {r['val']['fmean']} "
            f"| {r['val_at_calibrated']['fmean']} ({cal.get('pixel')}, "
            f"{cal.get('link')}) | {r['val_at_best_thresholds']['fmean']} "
            f"({best.get('pixel')}, {best.get('link')}) | "
            f"{r['train_seconds']} | {r['nvjpeg_images']} / "
            f"{r['host_staged_images']} |")
    return "\n".join(rows)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    extra = []
    if "--" in argv:
        i = argv.index("--")
        argv, extra = argv[:i], argv[i + 1:]
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("runs", nargs="+", metavar="LEVER:SEED")
    ap.add_argument("--json", default=os.path.join(REPO, "chiprun_out",
                                                   "levers.json"))
    ap.add_argument("--one", action="store_true",
                    help="run the single LEVER:SEED in this process")
    args = ap.parse_args(argv)
    runs = []
    for r in args.runs:
        lever, _, seed = r.partition(":")
        if lever not in LEVERS or not seed.isdigit():
            ap.error(f"not LEVER:SEED with a lever of {LEVERS}: {r}")
        runs.append((lever, int(seed)))
    if args.one:
        (lever, seed), = runs
        return run_one(lever, seed, args.json, extra)
    print(card_line(), flush=True)
    records = []
    for lever, seed in runs:
        t0 = time.time()
        cmd = [sys.executable, os.path.abspath(__file__), f"{lever}:{seed}",
               "--one", "--json", args.json, "--", *extra]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        out = proc.stdout
        keep = [ln for ln in out.splitlines()
                if not ln.startswith("  sweep ")]
        print("\n".join(keep[-40:]), flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr, flush=True)
            print(f"{lever}:{seed} failed (rc {proc.returncode})",
                  flush=True)
            continue
        for ln in out.splitlines():
            if ln.startswith("LEVER_RECORD "):
                records.append(json.loads(ln[len("LEVER_RECORD "):]))
        print(f"{lever}:{seed} done in {time.time() - t0:.1f}s", flush=True)
    print(table(records))
    print(card_line())
    return 0 if len(records) == len(runs) else 1


if __name__ == "__main__":
    sys.exit(main())
