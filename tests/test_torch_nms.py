"""Port parity: locality-aware NMS (utils/nms.py) against the JAX
package's copy.

Candidates come in raster order, as ``east_detect``'s valid rows reach
the host: runs of near-duplicate quads along rows (chains that the merge
collapses), isolated quads, overlapping quads of different scores, and
rotated ones. ``locality_aware_nms`` (with and without a cap on the
merged candidates), ``standard_nms``, ``_chain_merge`` and
``batch_quad_iou`` return the same rows as JAX's: equal, since both run
the same numpy. ``quad_iou`` (the port's has no ``cv2`` branch) agrees
with JAX's within 1e-4 (JAX's takes cv2's float32 intersection where
cv2 is installed).
"""

import warnings

import numpy as np
import pytest

from tensorflow_ocr_tpu.utils import nms as JN
from tensorflow_ocr_tpu_torch.utils import nms as TN


def candidates(rng, runs=6, per_run=(1, 12), jitter=1.5):
    """(N, 9) raster-order rows [x0, y0, ..., x3, y3, score]."""
    rows = []
    for _ in range(runs):
        x0, y0 = rng.uniform(0, 600, 2)
        w, h = rng.uniform(20, 120), rng.uniform(8, 30)
        th = rng.uniform(-0.4, 0.4)
        c, s = np.cos(th), np.sin(th)
        box = np.array([[0, 0], [w, 0], [w, h], [0, h]]) @ np.array(
            [[c, s], [-s, c]]) + (x0, y0)
        for _ in range(rng.randint(*per_run)):
            q = box + rng.randn(4, 2) * jitter
            rows.append(np.concatenate([q.reshape(-1),
                                        [rng.uniform(0.8, 1.0)]]))
    rows = np.array(rows)
    order = np.lexsort((rows[:, 0], rows[:, 1]))  # raster order by origin
    return rows[order].astype(np.float32)


@pytest.mark.parametrize("seed,thresh,cap", [(0, 0.2, 1024), (1, 0.3, 1024),
                                             (2, 0.2, 0), (3, 0.5, 1024),
                                             (4, 0.2, 3)])
def test_locality_aware_nms_rows_equal_jax(seed, thresh, cap):
    polys = candidates(np.random.RandomState(seed))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got = TN.locality_aware_nms(polys, thresh, cap)
        want = JN.locality_aware_nms(polys, thresh, cap)
    assert len(want) > 1
    np.testing.assert_array_equal(got, want)
    if cap == 3:
        assert len(got) <= 3


def test_cap_warns_like_jax():
    polys = candidates(np.random.RandomState(5), runs=8, per_run=(1, 3),
                       jitter=60.0)
    with pytest.warns(RuntimeWarning, match="capped"):
        TN.locality_aware_nms(polys, 0.2, 2)


def test_empty_input():
    got = TN.locality_aware_nms(np.zeros((0, 9), np.float32))
    assert got.shape == (0, 9)


def test_chain_merge_standard_nms_and_iou_equal_jax():
    rng = np.random.RandomState(6)
    polys = candidates(rng).astype(np.float64)
    np.testing.assert_array_equal(TN._chain_merge(polys, 0.2),
                                  JN._chain_merge(polys, 0.2))
    np.testing.assert_array_equal(TN.standard_nms(polys, 0.2),
                                  JN.standard_nms(polys, 0.2))
    q = polys[:, :8].reshape(-1, 4, 2)
    a, b = q[:-1], q[1:]
    iou = TN.batch_quad_iou(a, b)
    np.testing.assert_array_equal(iou, JN.batch_quad_iou(a, b))
    for i in range(0, len(a), 3):
        want = JN.quad_iou(a[i], b[i])
        assert abs(TN.quad_iou(a[i], b[i]) - want) <= 1e-4
        assert abs(iou[i] - want) <= 1e-4
