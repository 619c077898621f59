"""Checkpoint-time threshold calibration (train/calibrate.py) of the port.

The cases of ``tests/test_calibrate.py`` with the same stub hooks (a known
F landscape over the grid), ``_plateau_pick`` equal to JAX's on random
grids with ties and near-ties, the operating-point file written and read
as JAX's (and read by JAX's reader), and the sweep inside the hook's
``cached_forward``.
"""

import contextlib
import json
import os

import numpy as np
import pytest
import torch

from tensorflow_ocr_tpu.train import calibrate as JC
from tensorflow_ocr_tpu_torch import infer
from tensorflow_ocr_tpu_torch.config import Config
from tensorflow_ocr_tpu_torch.train.calibrate import (
    LINK_GRID,
    NMS_GRID,
    OPERATING_POINT_FILE,
    PIXEL_GRID,
    SCORE_GRID,
    _plateau_pick,
    calibrate_and_store,
    calibrate_thresholds,
    load_operating_point,
    save_operating_point,
)

torch.set_num_threads(1)


class _StubHook:
    """EvalDuringTraining stand-in with a known F landscape."""

    def __init__(self, best=(0.6, 0.7), east=False):
        self.images = np.zeros((1, 8, 8, 3))
        self.best = best
        self.east = east
        self.calls = 0

    def __call__(self, model, state, use_ema=True, pixel_thresh=None,
                 link_thresh=None, score_thresh=None, nms_thresh=None):
        self.calls += 1
        if self.east:
            d = abs(score_thresh - self.best[0]) + abs(
                nms_thresh - self.best[1])
        else:
            d = abs(pixel_thresh - self.best[0]) + abs(
                link_thresh - self.best[1])
        return {"fmean": 1.0 - d, "precision": 1.0, "recall": 1.0}

    def cached_forward(self):
        return contextlib.nullcontext()


class _StubState:
    step = 123


def cfg_of(name):
    cfg = Config()
    cfg.model.name = name
    return cfg


def test_calibrate_finds_best_grid_point():
    hook = _StubHook(best=(0.6, 0.7))
    op = calibrate_thresholds(None, _StubState(), cfg_of("pixellink_resnet50"),
                              "/unused", hook=hook)
    assert op["pixel"] == 0.6 and op["link"] == 0.7
    assert hook.calls == len(PIXEL_GRID) * len(LINK_GRID)
    assert op["fmean"] == 1.0


def test_calibrate_east_family_grid():
    hook = _StubHook(best=(0.7, 0.2), east=True)
    op = calibrate_thresholds(None, _StubState(), cfg_of("east_resnet50"),
                              "/unused", hook=hook)
    assert op["score"] == 0.7 and op["nms"] == 0.2
    assert hook.calls == len(SCORE_GRID) * len(NMS_GRID)


def test_link8_calibrates_pixel_and_link():
    op = calibrate_thresholds(None, _StubState(), cfg_of("link8_resnet50"),
                              "/unused", hook=_StubHook(best=(0.9, 0.5)))
    assert (op["pixel"], op["link"]) == (0.9, 0.5)


def test_operating_point_roundtrip(tmp_path):
    op = {"pixel": 0.6, "link": 0.7, "fmean": 0.91}
    p = save_operating_point(str(tmp_path), op, step=500)
    assert os.path.basename(p) == OPERATING_POINT_FILE
    got = load_operating_point(str(tmp_path))
    assert got["pixel"] == 0.6 and got["link"] == 0.7 and got["step"] == 500
    assert JC.load_operating_point(str(tmp_path)) == got
    assert not os.path.exists(p + ".tmp")
    with open(p, "w") as f:
        f.write("{not json")
    assert load_operating_point(str(tmp_path)) is None
    assert load_operating_point("/nonexistent_dir_xyz") is None


def test_file_is_the_one_jax_writes(tmp_path):
    op = {"score": 0.7, "nms": 0.2, "fmean": 0.5}
    save_operating_point(str(tmp_path / "port"), op, step=9)
    JC.save_operating_point(str(tmp_path / "jax"), op, step=9)
    assert ((tmp_path / "port" / OPERATING_POINT_FILE).read_text()
            == (tmp_path / "jax" / OPERATING_POINT_FILE).read_text())


def test_predictor_reads_the_same_file():
    assert infer.OPERATING_POINT_FILE == OPERATING_POINT_FILE
    assert infer.load_operating_point is load_operating_point


def test_calibrate_and_store_writes_with_step(tmp_path):
    op = calibrate_and_store(None, _StubState(), cfg_of("pixellink_resnet50"),
                             "/unused", str(tmp_path),
                             hook=_StubHook(best=(0.5, 0.9)))
    assert op["pixel"] == 0.5
    rec = json.load(open(tmp_path / OPERATING_POINT_FILE))
    assert rec["step"] == 123 and rec["link"] == 0.9


def test_calibrate_no_images_returns_none(tmp_path):
    hook = _StubHook()
    hook.images = None
    assert calibrate_thresholds(None, _StubState(),
                                cfg_of("pixellink_resnet50"), "/u",
                                hook=hook) is None
    assert calibrate_and_store(None, _StubState(),
                               cfg_of("pixellink_resnet50"), "/u",
                               str(tmp_path), hook=hook) is None
    assert not (tmp_path / OPERATING_POINT_FILE).exists()


def test_calibrate_without_a_directory_finds_no_image(tmp_path):
    """A train split that holds no image (an empty or missing directory):
    the real hook stages nothing and calibration returns None."""
    for path in (str(tmp_path), str(tmp_path / "missing")):
        assert calibrate_thresholds(None, _StubState(),
                                    cfg_of("pixellink_tiny"), path) is None


class _PlateauHook:
    """A plateau pixel in {0.5,0.6,0.7} x link in {0.5,0.7} at F=0.90,
    with a +eps/2 spike at its corner (0.7, 0.5)."""

    def __init__(self):
        self.images = np.zeros((1, 8, 8, 3))

    def __call__(self, model, state, use_ema=True, pixel_thresh=None,
                 link_thresh=None, **kw):
        on = pixel_thresh in (0.5, 0.6, 0.7) and link_thresh in (0.5, 0.7)
        f = 0.90 if on else 0.40
        if (pixel_thresh, link_thresh) == (0.7, 0.5):
            f += 0.007
        return {"fmean": f, "precision": 1.0, "recall": 1.0}

    def cached_forward(self):
        return contextlib.nullcontext()


def test_calibrate_prefers_plateau_center_over_noisy_edge():
    op = calibrate_thresholds(None, _StubState(), cfg_of("pixellink_resnet50"),
                              "/unused", hook=_PlateauHook())
    assert op["pixel"] == 0.6, op
    assert op["link"] in (0.5, 0.7)


@pytest.mark.parametrize("seed", range(8))
def test_plateau_pick_equals_jax(seed):
    rng = np.random.RandomState(seed)
    for shape in ((5, 4), (5, 3)):
        f = rng.choice([0.3, 0.5, 0.8, 0.81, 0.82, 0.83], shape)
        f = f + rng.uniform(0, 0.02, shape) * (rng.rand(*shape) < 0.5)
        results = [(float(f[i, j]), (i, j), {"a": i, "b": j})
                   for i in range(shape[0]) for j in range(shape[1])]
        assert _plateau_pick(results) == JC._plateau_pick(results)
        for eps in (0.0, 0.05):
            assert (_plateau_pick(results, eps)
                    == JC._plateau_pick(results, eps))


class _CachingHook(_StubHook):
    """A hook whose ``cached_forward`` counts the sweeps it wraps."""

    def __init__(self):
        super().__init__()
        self.sweeps = 0
        self.inside = []

    @contextlib.contextmanager
    def cached_forward(self):
        self.sweeps += 1
        self._on = True
        try:
            yield self
        finally:
            self._on = False

    def __call__(self, *a, **k):
        self.inside.append(getattr(self, "_on", False))
        return super().__call__(*a, **k)


def test_sweep_runs_inside_cached_forward():
    hook = _CachingHook()
    calibrate_thresholds(None, _StubState(), cfg_of("pixellink_resnet50"),
                         "/unused", hook=hook)
    assert hook.sweeps == 1 and all(hook.inside)
    assert len(hook.inside) == len(PIXEL_GRID) * len(LINK_GRID)
