"""Detection-to-GT matching (Pascal-VOC greedy, ICDAR ignore handling).

Port of ``tensorflow_ocr_tpu/eval/bboxes.py``: ``bboxes_jaccard`` (:25),
``_intersection_over_det`` (:30) and ``bboxes_matching`` (:41), host
numpy. The detections are visited in ``np.argsort(-scores)`` order, as in
JAX, so ties fall the same way. JAX's IoU and intersection-over-detection
call ``cv2.intersectConvexConvex``; here both come from the pure-numpy
Sutherland-Hodgman clip of ``utils/nms.py``, after each quad is put in
counter-clockwise order (the clip keeps the points on the left of each
edge), so either orientation of either quad gives the same area, as
OpenCV's does.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from tensorflow_ocr_tpu_torch.utils.nms import (
    _clip_polygon,
    _poly_area,
    quad_iou,
)


def _ccw(quad: np.ndarray) -> np.ndarray:
    """``quad`` as float64 with a non-negative shoelace area."""
    q = np.asarray(quad, np.float64)
    x, y = q[:, 0], q[:, 1]
    signed = np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))
    return q[::-1].copy() if signed < 0 else q


def _iou(a: np.ndarray, b: np.ndarray) -> float:
    """IoU of two counter-clockwise quads; 0.0 where either has zero area
    (a clip polygon of zero area would keep every point)."""
    if not (_poly_area(a) > 0 and _poly_area(b) > 0):
        return 0.0
    return quad_iou(a, b)


def bboxes_jaccard(quad: np.ndarray, quads: np.ndarray) -> np.ndarray:
    """IoU of one (4,2) quad against (N,4,2) quads."""
    q = _ccw(quad)
    return np.array([_iou(q, _ccw(g)) for g in quads], np.float32)


def _intersection_over_det(det: np.ndarray, gt: np.ndarray) -> float:
    """Intersection area / detection area (the ICDAR don't-care measure);
    0.0 where either quad has zero area."""
    det = _ccw(np.asarray(det, np.float32))
    gt = _ccw(np.asarray(gt, np.float32))
    area = _poly_area(det)
    if not (area > 0 and _poly_area(gt) > 0):
        return 0.0
    inter_poly = _clip_polygon(det, gt)
    inter = _poly_area(inter_poly) if len(inter_poly) >= 3 else 0.0
    return float(inter / area)


def bboxes_matching(
    det_quads: np.ndarray,      # (N, 4, 2), any order
    det_scores: np.ndarray,     # (N,)
    gt_quads: np.ndarray,       # (M, 4, 2)
    gt_ignored: np.ndarray,     # (M,) bool
    matching_threshold: float = 0.5,
    icdar_dontcare: bool = True,
) -> Tuple[int, np.ndarray, np.ndarray]:
    """Greedy match in descending score order (bboxes.py:41-94).

    Returns (n_gt_not_ignored, tp (N,), fp (N,)) in the ORIGINAL
    detection order. A detection whose intersection over its own area
    with an ignored GT exceeds 0.5 counts neither TP nor FP
    (``icdar_dontcare``); so does one whose best IoU match is an ignored
    GT. A second detection of a matched GT is a FP.
    """
    n = len(det_quads)
    m = len(gt_quads)
    tp = np.zeros(n, bool)
    fp = np.zeros(n, bool)
    gt_match = np.zeros(m, bool)
    gt_ignored = np.asarray(gt_ignored, bool)
    n_gt = int((~gt_ignored).sum()) if m else 0
    if n == 0:
        return n_gt, tp, fp
    dontcare = gt_quads[gt_ignored] if (m and icdar_dontcare) else []
    order = np.argsort(-np.asarray(det_scores))
    for i in order:
        if len(dontcare):
            ioa = max(
                _intersection_over_det(det_quads[i], dc) for dc in dontcare
            )
            if ioa > 0.5:
                continue  # excluded: neither TP nor FP
        if m == 0:
            fp[i] = True
            continue
        ious = bboxes_jaccard(det_quads[i], gt_quads)
        j = int(np.argmax(ious))
        if ious[j] > matching_threshold:
            if gt_ignored[j]:
                continue  # neither TP nor FP
            if not gt_match[j]:
                gt_match[j] = True
                tp[i] = True
            else:
                fp[i] = True  # duplicate detection of a matched GT
        else:
            fp[i] = True
    return n_gt, tp, fp
