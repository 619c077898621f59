"""The EAST serving path: the port's Predictor against JAX's.

``east_tiny`` with seeded numpy variables in the Flax tree's shapes (BN
statistics perturbed), converted into the port. JAX's ``Predictor``
(``infer.py``: ``east_detect`` in the jitted forward, then
``locality_aware_nms`` on the host and ``box_thresh``) runs the same
variables in float32 (its model built with ``dtype=float32`` and the
``f32_batchnorm`` fixture; it has no dtype option), the port's in float32
on the CPU, both at a ``score_map_thresh`` in the widest gap between the
score map's sorted values (no candidate within float noise of it), and
low enough that NMS has work. The boxes after NMS: the same count and
within 1e-2 pixels (RBOX and QUAD). Then an ``operating_point.json``
beside the weights overrides ``score`` and ``nms`` as JAX's does
(``infer.py:105-110``), and the boxes equal those of a Predictor given
the same thresholds by its config.
"""

import json
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_ocr_tpu import infer as JInfer
from tensorflow_ocr_tpu.config import Config as JConfig
from tensorflow_ocr_tpu.models import build_model as build_jax_model
from tensorflow_ocr_tpu.train import trainer as JT
from tensorflow_ocr_tpu_torch.config import InferConfig
from tensorflow_ocr_tpu_torch.infer import OPERATING_POINT_FILE, Predictor
from tensorflow_ocr_tpu_torch.models import convert
from test_torch_bottleneck import f32_batchnorm  # noqa: F401
from test_torch_step import numpy_init

torch.set_num_threads(1)
SIZE = (64, 96)


def gap_threshold(scores, lo=0.5, hi=0.9):
    """Midpoint of the widest gap between the sorted scores in the
    [lo, hi] quantile range."""
    s = np.sort(scores.ravel())
    part = s[int(lo * len(s)):int(hi * len(s))]
    k = int(np.argmax(np.diff(part)))
    return float((part[k] + part[k + 1]) / 2)


def setup(geometry, seed):
    rng = np.random.RandomState(seed)
    jmodel = build_jax_model("east_tiny", dtype=jnp.float32,
                             geometry=geometry)
    variables = numpy_init(jmodel, SIZE[0], rng)
    images = rng.randint(0, 256, (2, *SIZE, 3)).astype(np.uint8)
    score = np.asarray(jmodel.apply(variables, jnp.asarray(images))["score"])
    return jmodel, variables, images, gap_threshold(score)


def jax_predictor(variables, geometry, thresh, monkeypatch):
    cfg = JConfig()
    cfg.model.name = "east_tiny"
    cfg.data.geometry = geometry
    cfg.infer.score_map_thresh = thresh
    cfg.infer.use_calibrated_thresholds = False
    monkeypatch.setattr(JInfer, "build_model",
                        partial(build_jax_model, dtype=jnp.float32))
    _, state, _ = JT.create_train_state(
        cfg, jax.random.PRNGKey(0), np.zeros((1, 64, 64, 3), np.float32))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = state.replace(params=params, ema_params=params,
                          batch_stats=jax.tree_util.tree_map(
                              jnp.asarray, variables["batch_stats"]))
    return JInfer.Predictor(cfg, state=state)


def assert_same(got, want):
    assert [len(b) for b in got] == [len(b) for b in want]
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-2)


@pytest.mark.parametrize("geometry", ["RBOX", "QUAD"])
def test_east_predictor_boxes_match_jax(f32_batchnorm, monkeypatch,
                                        geometry):
    _, variables, images, thresh = setup(geometry, 3 + len(geometry))
    want = jax_predictor(variables, geometry, thresh,
                         monkeypatch).detect_batch(images)
    pred = Predictor("east_tiny", weights=convert.convert_variables(
        variables), device="cpu", dtype=torch.float32, geometry=geometry,
        infer=InferConfig(score_map_thresh=thresh))
    assert pred.is_east and pred.score_thresh == thresh
    got = pred.detect_batch(images)
    assert sum(len(b) for b in want) > 0
    assert_same(got, want)
    assert pred.nms_ms > 0


def test_operating_point_overrides_score_and_nms(f32_batchnorm, tmp_path):
    _, variables, images, thresh = setup("RBOX", 11)
    path = tmp_path / "weights.npz"
    np.savez(path, **convert.flatten_variables(variables))
    op = {"score": thresh, "nms": 0.35}
    with open(tmp_path / OPERATING_POINT_FILE, "w") as f:
        json.dump(op, f)
    pred = Predictor("east_tiny", weights=str(path), device="cpu",
                     dtype=torch.float32)
    assert pred.calibrated
    assert (pred.score_thresh, pred.nms_thresh) == (op["score"], op["nms"])
    ref = Predictor("east_tiny", weights=convert.load_npz(str(path)),
                    device="cpu", dtype=torch.float32,
                    infer=InferConfig(score_map_thresh=op["score"],
                                      nms_thresh=op["nms"]))
    assert not ref.calibrated
    got = pred.detect_batch(images)
    assert sum(len(b) for b in got) > 0
    assert_same(got, ref.detect_batch(images))
    boxes, ms = pred.detect(images[0])
    assert ms > 0 and all(b.shape == (4, 2) for b in boxes)
