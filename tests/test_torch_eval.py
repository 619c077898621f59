"""The port's matching and P/R/F (eval/) against the JAX package's.

The same numpy quads go through both: IoU and intersection over the
detection within 1e-5 (JAX clips with ``cv2.intersectConvexConvex`` on
float32, the port with the numpy Sutherland-Hodgman clip), on rotated
rectangles in either orientation, and on degenerate and self-touching
quads; the greedy matching's TP/FP equal, element for element, on random
scenes with ignored ground truth; ``evaluate_icdar_directory`` equal on a
directory of random results. Then the cases of ``tests/test_eval.py`` on
the port. Quads that are not convex (a bow-tie, or one folded back along
an edge) are left out: ``intersectConvexConvex`` has no defined answer
for them (it returns an area for the bow-tie and 0 for the fold), and no
decode gives one.
"""

import numpy as np
import pytest
import torch

from tensorflow_ocr_tpu.eval import bboxes as JB
from tensorflow_ocr_tpu.eval import metrics as JM
from tensorflow_ocr_tpu_torch.eval import bboxes as TB
from tensorflow_ocr_tpu_torch.eval import metrics as TM

torch.set_num_threads(1)
TOL = 1e-5


def _quad(x, y, w, h):
    return np.array(
        [[x, y], [x + w, y], [x + w, y + h], [x, y + h]], np.float32
    )


def rotated(rng, lo=20, hi=80):
    """A rotated rectangle, counter-clockwise or (half the time)
    clockwise."""
    c = rng.uniform(lo, hi, 2)
    w, h = rng.uniform(5, 40, 2)
    a = rng.uniform(0, np.pi)
    r = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
    q = (np.array([[-w, -h], [w, -h], [w, h], [-w, h]]) / 2 @ r.T + c)
    q = q.astype(np.float32)
    return q[::-1].copy() if rng.rand() < 0.5 else q


ODD = {
    "zero": np.zeros((4, 2), np.float32),
    "point": np.full((4, 2), 3.0, np.float32),
    "segment": np.array([[0, 0], [10, 0], [20, 0], [5, 0]], np.float32),
    "square": _quad(0, 0, 10, 10),
    "square_cw": _quad(0, 0, 10, 10)[::-1].copy(),
    "inner": _quad(2, 3, 5, 4),
    "offset": _quad(5, 5, 10, 10),
    "apart": _quad(40, 40, 5, 5),
}

# self-touching quads (a vertex repeated: a triangle) and that triangle
# with three vertices; cv2 gets the repeated vertex wrong (0, or a
# negative IoU), so the port is held against JAX on the triangle
TOUCHING = {
    "corner": (np.array([[0, 0], [10, 0], [10, 0], [0, 10]], np.float32),
               np.array([[0, 0], [10, 0], [0, 10]], np.float32)),
    "side": (np.array([[0, 0], [10, 0], [10, 10], [10, 10]], np.float32),
             np.array([[0, 0], [10, 0], [10, 10]], np.float32)),
}


def test_iou_and_ioa_random_quads():
    rng = np.random.RandomState(0)
    for _ in range(200):
        a, b = rotated(rng), rotated(rng)
        assert abs(TB.bboxes_jaccard(a, b[None])[0]
                   - JB.bboxes_jaccard(a, b[None])[0]) <= TOL
        assert abs(TB._intersection_over_det(a, b)
                   - JB._intersection_over_det(a, b)) <= TOL


@pytest.mark.parametrize("det", sorted(ODD))
def test_iou_and_ioa_degenerate(det):
    for gt in sorted(ODD):
        d, g = ODD[det], ODD[gt]
        assert abs(TB.bboxes_jaccard(d, g[None])[0]
                   - JB.bboxes_jaccard(d, g[None])[0]) <= TOL, (det, gt)
        assert abs(TB._intersection_over_det(d, g)
                   - JB._intersection_over_det(d, g)) <= TOL, (det, gt)


@pytest.mark.parametrize("name", sorted(TOUCHING))
def test_iou_and_ioa_self_touching(name):
    quad, tri = TOUCHING[name]
    for other in (ODD["inner"], ODD["offset"], ODD["square_cw"]):
        for q, t in ((quad, tri), (quad[::-1].copy(), tri[::-1].copy())):
            assert abs(TB.bboxes_jaccard(q, other[None])[0]
                       - JB.bboxes_jaccard(t, other[None])[0]) <= TOL
            assert abs(TB.bboxes_jaccard(other, q[None])[0]
                       - JB.bboxes_jaccard(other, t[None])[0]) <= TOL
            assert abs(TB._intersection_over_det(q, other)
                       - JB._intersection_over_det(t, other)) <= TOL
            assert abs(TB._intersection_over_det(other, q)
                       - JB._intersection_over_det(other, t)) <= TOL


def scene(rng, n_det, n_gt):
    """Ground truth, some detections near it (scaled and shifted), some
    anywhere."""
    gt = np.stack([rotated(rng) for _ in range(n_gt)]) if n_gt else \
        np.zeros((0, 4, 2), np.float32)
    dets = []
    for _ in range(n_det):
        if n_gt and rng.rand() < 0.6:  # a convex quad near a GT
            g = gt[rng.randint(n_gt)]
            c = g.mean(0)
            q = (g - c) * rng.uniform(0.7, 1.3) + c + rng.normal(0, 3, 2)
            dets.append(q.astype(np.float32))
        else:
            dets.append(rotated(rng))
    det = np.stack(dets) if dets else np.zeros((0, 4, 2), np.float32)
    scores = rng.rand(n_det).astype(np.float32)
    scores[rng.rand(n_det) < 0.2] = 0.5  # ties: argsort order decides
    return det, scores, gt, rng.rand(n_gt) < 0.25


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("dontcare", [True, False])
def test_matching_equals_jax(seed, dontcare):
    rng = np.random.RandomState(seed)
    for _ in range(5):
        det, scores, gt, ign = scene(rng, rng.randint(0, 12),
                                     rng.randint(0, 8))
        want = JB.bboxes_matching(det, scores, gt, ign,
                                  icdar_dontcare=dontcare)
        got = TB.bboxes_matching(det, scores, gt, ign,
                                 icdar_dontcare=dontcare)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])


def test_streaming_prf_equals_jax():
    rng = np.random.RandomState(7)
    jp, tp = JM.StreamingPRF(), TM.StreamingPRF()
    for _ in range(8):
        args = scene(rng, rng.randint(0, 10), rng.randint(0, 6))
        jp.update(*args)
        tp.update(*args)
    assert tp.result() == jp.result()
    for g, w in zip(tp.precision_recall(), jp.precision_recall()):
        np.testing.assert_array_equal(g, w)


def write_quads(path, quads, tags=None):
    with open(path, "w") as f:
        for i, q in enumerate(quads):
            line = ",".join(f"{v:.2f}" for v in q.reshape(-1))
            if tags is not None:
                line += ",###" if tags[i] else ",text"
            f.write(line + "\r\n")


def test_evaluate_directory_equals_jax(tmp_path):
    rng = np.random.RandomState(3)
    gt_dir, res_dir = tmp_path / "gt", tmp_path / "res"
    gt_dir.mkdir()
    res_dir.mkdir()
    for i in range(6):
        det, _, gt, ign = scene(rng, rng.randint(0, 9), rng.randint(0, 6))
        write_quads(gt_dir / f"gt_img_{i}.txt", gt, ign)
        write_quads(res_dir / f"res_img_{i}.txt", det)
    (res_dir / "notes.txt").write_text("not a result file\n")
    got = TM.evaluate_icdar_directory(str(res_dir), str(gt_dir))
    assert got == JM.evaluate_icdar_directory(str(res_dir), str(gt_dir))
    assert got["n_gt"] > 0 and got["tp"] > 0


# the cases of tests/test_eval.py, on the port


def test_matching_basic_tp_fp():
    gt = np.stack([_quad(0, 0, 20, 10), _quad(50, 50, 20, 10)])
    det = np.stack([_quad(1, 0, 20, 10), _quad(100, 100, 10, 10)])
    n_gt, tp, fp = TB.bboxes_matching(det, np.array([0.9, 0.8]), gt,
                                      np.array([False, False]))
    assert n_gt == 2
    assert tp.tolist() == [True, False]
    assert fp.tolist() == [False, True]


def test_matching_duplicate_detection_is_fp():
    gt = _quad(0, 0, 20, 10)[None]
    det = np.stack([_quad(0, 0, 20, 10), _quad(1, 0, 20, 10)])
    _, tp, fp = TB.bboxes_matching(det, np.array([0.9, 0.8]), gt,
                                   np.array([False]))
    assert tp.sum() == 1 and fp.sum() == 1


def test_icdar_dontcare_excludes_partial_overlap():
    gt = _quad(0, 0, 100, 100)[None]
    det = _quad(10, 10, 10, 10)[None]
    n_gt, tp, fp = TB.bboxes_matching(det, np.array([0.9]), gt,
                                      np.array([True]))
    assert n_gt == 0 and tp.sum() == 0 and fp.sum() == 0
    n_gt, tp, fp = TB.bboxes_matching(det, np.array([0.9]), gt,
                                      np.array([True]), icdar_dontcare=False)
    assert fp.sum() == 1


def test_matching_ignored_gt_neither_tp_nor_fp():
    gt = _quad(0, 0, 20, 10)[None]
    n_gt, tp, fp = TB.bboxes_matching(gt.copy(), np.array([0.9]), gt,
                                      np.array([True]))
    assert n_gt == 0 and tp.sum() == 0 and fp.sum() == 0


def test_streaming_prf_and_fmean():
    prf = TM.StreamingPRF()
    gt = np.stack([_quad(0, 0, 20, 10), _quad(50, 50, 20, 10)])
    prf.update(_quad(0, 0, 20, 10)[None], np.array([0.9]), gt,
               np.array([False, False]))
    prf.update(_quad(200, 200, 5, 5)[None], np.array([0.7]),
               np.zeros((0, 4, 2)), np.zeros(0, bool))
    r = prf.result()
    assert r["tp"] == 1 and r["fp"] == 1 and r["n_gt"] == 2
    assert r["precision"] == r["recall"] == r["fmean"] == pytest.approx(0.5)
    assert TM.safe_divide(1.0, 0.0) == 0.0
    assert TM.fmean(0.0, 0.0) == 0.0 and TM.fmean(1.0, 1.0) == 1.0


def test_evaluate_directory(tmp_path):
    gt_dir, res_dir = tmp_path / "gt", tmp_path / "res"
    gt_dir.mkdir()
    res_dir.mkdir()
    (gt_dir / "gt_img_1.txt").write_text(
        "0,0,20,0,20,10,0,10,text\n50,50,70,50,70,60,50,60,###\n")
    (res_dir / "res_img_1.txt").write_text("0,0,20,0,20,10,0,10\r\n")
    r = TM.evaluate_icdar_directory(str(res_dir), str(gt_dir))
    assert r["precision"] == 1.0 and r["recall"] == 1.0 and r["fmean"] == 1.0
