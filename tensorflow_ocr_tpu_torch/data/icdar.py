"""Host-side helpers of the ICDAR data tier that the EAST labels need.

The start of the port of ``tensorflow_ocr_tpu/data/icdar.py``: copies of
``_pad_polys`` (:151-161), which pads an image's polygons to a fixed
count of slots, and ``east_poly_geometry`` (:163-195), the per-polygon
shrink and rectangle fit that ``ops/labels.py`` ``east_labels_batch``
rasterizes on the device. They read no file and use no ``cv2``. The rest
of the module (the annotation readers, ``prepare_sample``, the synthetic
and photo tiers, ``make_synthetic_dataset``) comes with ROADMAP.md
Queue 1 item 4.
"""

from __future__ import annotations

import numpy as np

from tensorflow_ocr_tpu_torch.ops import geometry as G


def _pad_polys(polys, tags, max_polys: int):
    """(K, 4, 2) polygons and (K,) ignore tags -> the first ``max_polys``
    of them in fixed slots: polys (max_polys, 4, 2) float32, tags and
    valid (max_polys,) bool."""
    k = min(len(polys), max_polys)
    out_p = np.zeros((max_polys, 4, 2), np.float32)
    out_t = np.zeros((max_polys,), bool)
    out_v = np.zeros((max_polys,), bool)
    if k:
        out_p[:k] = polys[:k]
        out_t[:k] = tags[:k]
        out_v[:k] = True
    return out_p, out_t, out_v


def east_poly_geometry(polys: np.ndarray):
    """Per-polygon EAST shrink and rectangle fit (icdar.py:163-195):
    (K, 4, 2) padded polygons -> shrunk polygons (K, 4, 2), fitted
    rectangles sorted clockwise from the top left (K, 4, 2) and their
    angles (K,). An all-zero slot stays zero; a polygon the fit fails on
    keeps itself as its shrunk polygon and rectangle, angle 0."""
    k = polys.shape[0]
    shrunk = np.zeros_like(polys)
    rects = np.zeros_like(polys)
    angles = np.zeros((k,), np.float32)
    for i in range(k):
        poly = polys[i]
        if not poly.any():
            continue
        r = np.array(
            [
                min(np.linalg.norm(poly[j] - poly[(j + 1) % 4]),
                    np.linalg.norm(poly[j] - poly[(j - 1) % 4]))
                for j in range(4)
            ]
        )
        try:
            shrunk[i] = G.shrink_poly(poly, r)
            fitted = G.rectangle_from_parallelogram(poly)
            rect, angle = G.sort_rectangle(fitted)
            rects[i] = rect
            angles[i] = angle
        except Exception:
            shrunk[i] = poly
            rects[i] = poly
    return shrunk, rects, angles
