"""Checkpoint-time decode-threshold calibration (no validation leakage).

Port of ``tensorflow_ocr_tpu/train/calibrate.py``: the decode thresholds
are swept on a small slice of the TRAIN split (never the validation set)
after training or at checkpoint time, and the chosen operating point is
written beside the checkpoints as ``operating_point.json``, which
:class:`~tensorflow_ocr_tpu_torch.infer.Predictor` adopts by default.

The sweep runs the eval hook (``train/eval_hook.py``) once per grid
point inside its ``cached_forward``: the forward runs once for the whole
sweep and only the decode and the matching run per point. The forward
does not depend on the thresholds, so the numbers are those of a forward
per point.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

OPERATING_POINT_FILE = "operating_point.json"

# the sweep grids (scripts/holdout_eval.py's --sweep-thresholds ranges)
PIXEL_GRID = (0.5, 0.6, 0.7, 0.8, 0.9)
LINK_GRID = (0.5, 0.7, 0.8, 0.9)
SCORE_GRID = (0.5, 0.6, 0.7, 0.8, 0.9)
NMS_GRID = (0.1, 0.2, 0.3)


def _plateau_pick(results, eps: float = 0.015):
    """The near-best grid point at the CENTER of its plateau.

    ``results`` is a list of (fmean, (i, j) grid indices, combo dict).
    Among the points within ``eps`` of the best F, the one with the least
    summed squared grid-index distance to the others of that set wins,
    ties to the higher F: on a small slice the exact argmax often sits at
    the plateau's edge, which generalizes worst.
    """
    best_f = max(f for f, _, _ in results)
    near = [(f, ij, d) for f, ij, d in results if f >= best_f - eps]
    if len(near) == 1:
        return near[0][0], near[0][2]

    def spread(p):
        return sum((p[0] - q[0]) ** 2 + (p[1] - q[1]) ** 2
                   for _, q, _ in near)

    f, _, d = min(near, key=lambda r: (spread(r[1]), -r[0]))
    return f, d


def calibrate_thresholds(model, state, cfg, train_dir: str,
                         max_images: int = 8,
                         hook=None) -> Optional[Dict[str, float]]:
    """Sweep the decode thresholds on a train-split slice; return the
    pick of :func:`_plateau_pick`.

    Returns {"pixel": p, "link": l, "fmean": f} for the PixelLink and
    link8 heads or {"score": s, "nms": n, "fmean": f} for EAST, or None
    when the slice holds no usable image. ``hook`` injects a prebuilt
    :class:`~tensorflow_ocr_tpu_torch.train.eval_hook.EvalDuringTraining`
    (tests, or a trainer that keeps one); by default one is built on
    ``train_dir``. ``model`` and ``state`` are passed to the hook.
    """
    from tensorflow_ocr_tpu_torch.models.detector import model_head
    from tensorflow_ocr_tpu_torch.train.eval_hook import EvalDuringTraining

    if hook is None:
        hook = EvalDuringTraining(cfg, train_dir, max_images=max_images)
    if hook.images is None:
        return None
    is_east = model_head(cfg.model.name) == "east"
    if is_east:
        grid = [((i, j), {"score": st, "nms": nt})
                for i, st in enumerate(SCORE_GRID)
                for j, nt in enumerate(NMS_GRID)]
    else:
        grid = [((i, j), {"pixel": pt, "link": lt})
                for i, pt in enumerate(PIXEL_GRID)
                for j, lt in enumerate(LINK_GRID)]
    results = []
    with hook.cached_forward():
        for ij, d in grid:
            kw = ({"score_thresh": d["score"], "nms_thresh": d["nms"]}
                  if is_east else
                  {"pixel_thresh": d["pixel"], "link_thresh": d["link"]})
            r = hook(model, state, use_ema=True, **kw)
            results.append((r.get("fmean", 0.0), ij, d))
    best_f, best = _plateau_pick(results)
    best = dict(best)
    best["fmean"] = round(best_f, 4)
    return best


def save_operating_point(ckpt_dir: str, op: Dict[str, float],
                         step: Optional[int] = None) -> str:
    """Write the operating point at the checkpoint root (the latest
    calibration wins), through a temporary file and a rename, so a reader
    never sees a torn file."""
    os.makedirs(ckpt_dir, exist_ok=True)
    rec = dict(op)
    if step is not None:
        rec["step"] = int(step)
    path = os.path.join(ckpt_dir, OPERATING_POINT_FILE)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")
    os.replace(tmp, path)
    return path


def load_operating_point(ckpt_dir: str) -> Optional[Dict[str, float]]:
    """The stored operating point, or None if absent or unreadable."""
    path = os.path.join(str(ckpt_dir), OPERATING_POINT_FILE)
    try:
        with open(path) as f:
            op = json.load(f)
        return op if isinstance(op, dict) else None
    except (OSError, ValueError):
        return None


def calibrate_and_store(model, state, cfg, train_dir: str, ckpt_dir: str,
                        max_images: int = 8,
                        hook=None) -> Optional[Dict[str, float]]:
    """Calibrate on the train slice and write the result, with the
    state's step, at ``ckpt_dir``."""
    op = calibrate_thresholds(model, state, cfg, train_dir,
                              max_images=max_images, hook=hook)
    if op is not None:
        save_operating_point(ckpt_dir, op, step=int(state.step))
    return op
