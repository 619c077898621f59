"""Streaming precision/recall/f-mean and the ICDAR directory evaluator.

A copy of ``tensorflow_ocr_tpu/eval/metrics.py`` (``safe_divide`` :21,
``fmean`` :25, ``StreamingPRF`` :29, ``_read_quads_file`` :80,
``evaluate_icdar_directory`` :99), host numpy, matching through the
port's ``eval/bboxes.py``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from tensorflow_ocr_tpu_torch.eval.bboxes import bboxes_matching


def safe_divide(num: float, den: float) -> float:
    return num / den if den > 0 else 0.0


def fmean(precision: float, recall: float) -> float:
    return safe_divide(2.0 * precision * recall, precision + recall)


@dataclass
class StreamingPRF:
    """Accumulates TP/FP across batches."""

    matching_threshold: float = 0.5
    n_gt: int = 0
    tp: List[np.ndarray] = field(default_factory=list)
    fp: List[np.ndarray] = field(default_factory=list)
    scores: List[np.ndarray] = field(default_factory=list)

    def update(self, det_quads, det_scores, gt_quads, gt_ignored):
        n_gt, tp, fp = bboxes_matching(
            np.asarray(det_quads, np.float32).reshape(-1, 4, 2),
            np.asarray(det_scores, np.float32),
            np.asarray(gt_quads, np.float32).reshape(-1, 4, 2),
            np.asarray(gt_ignored, bool),
            self.matching_threshold,
        )
        self.n_gt += n_gt
        self.tp.append(tp)
        self.fp.append(fp)
        self.scores.append(np.asarray(det_scores, np.float32))

    def precision_recall(self):
        """Cumulative P/R over the score-sorted detections."""
        if not self.tp:
            return np.zeros(0), np.zeros(0)
        tp = np.concatenate(self.tp)
        fp = np.concatenate(self.fp)
        scores = np.concatenate(self.scores)
        order = np.argsort(-scores)
        tp_c = np.cumsum(tp[order].astype(np.float64))
        fp_c = np.cumsum(fp[order].astype(np.float64))
        recall = tp_c / self.n_gt if self.n_gt else np.zeros_like(tp_c)
        precision = np.where(tp_c + fp_c > 0,
                             tp_c / np.maximum(tp_c + fp_c, 1e-12), 0.0)
        return precision, recall

    def result(self) -> Dict[str, float]:
        """Final operating-point P/R/F (all detections kept)."""
        tp = float(np.concatenate(self.tp).sum()) if self.tp else 0.0
        fp = float(np.concatenate(self.fp).sum()) if self.fp else 0.0
        precision = safe_divide(tp, tp + fp)
        recall = safe_divide(tp, float(self.n_gt))
        return {
            "precision": precision,
            "recall": recall,
            "fmean": fmean(precision, recall),
            "n_gt": float(self.n_gt),
            "tp": tp,
            "fp": fp,
        }


def _read_quads_file(path: str):
    quads, tags = [], []
    if not os.path.exists(path):
        return np.zeros((0, 4, 2), np.float32), np.zeros((0,), bool)
    with open(path, "r", encoding="utf-8-sig") as f:
        for line in f:
            parts = [p.strip() for p in line.strip().split(",")
                     if p.strip() != ""]
            if len(parts) < 8:
                continue
            vals = list(map(float, parts[:8]))
            quads.append(np.array(vals, np.float32).reshape(4, 2))
            tag = parts[8] if len(parts) > 8 else ""
            tags.append(tag in ("###", "*"))
    if not quads:
        return np.zeros((0, 4, 2), np.float32), np.zeros((0,), bool)
    return np.stack(quads), np.array(tags, bool)


def evaluate_icdar_directory(results_dir: str, gt_dir: str,
                             matching_threshold: float = 0.5
                             ) -> Dict[str, float]:
    """Score a directory of res_*.txt against gt_*.txt (ICDAR-2015
    style); every detection scores 1."""
    prf = StreamingPRF(matching_threshold)
    for name in sorted(os.listdir(results_dir)):
        if not (name.startswith("res_") and name.endswith(".txt")):
            continue
        stem = name[len("res_"):-len(".txt")]
        det, _ = _read_quads_file(os.path.join(results_dir, name))
        gt, ignored = _read_quads_file(os.path.join(gt_dir, f"gt_{stem}.txt"))
        scores = np.ones(len(det), np.float32)
        prf.update(det, scores, gt, ignored)
    return prf.result()
