"""Checkpoint-time calibration and the eval hook inside the port's trainer.

``pixellink_tiny`` in float32 on the CPU at 64^2 over a 4-image synthetic
split: each save of ``Trainer.run`` and of ``Trainer.run_device_cached``
writes ``operating_point.json`` with the saved step; the state after the
run is bit-equal to the same run with calibration off (the sweep reads
the live model and never writes it); a failing calibration is logged as a
warning and training goes on; with no image in the train split nothing
is written; and the eval hook logs ``val/*`` every ``eval_every_steps``.
"""

import logging

import pytest
import torch

from tensorflow_ocr_tpu_torch.config import Config
from tensorflow_ocr_tpu_torch.data import icdar
from tensorflow_ocr_tpu_torch.data.pipeline import batch_generator
from tensorflow_ocr_tpu_torch.train import calibrate as TC
from tensorflow_ocr_tpu_torch.train import trainer as TT

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("calib")
    icdar.make_synthetic_dataset(str(d), 4, (96, 128), seed=3)
    return str(d)


def _cfg(path, ckpt, calibrate=True):
    cfg = Config()
    cfg.model.name = "pixellink_tiny"
    cfg.model.compute_dtype = "float32"
    d = cfg.data
    d.training_data_path, d.input_size, d.batch_size = path, 64, 2
    d.max_polys, d.min_text_size = 8, 2
    t = cfg.train
    t.checkpoint_path, t.save_checkpoint_steps = str(ckpt), 2
    t.calibrate_at_checkpoint = calibrate
    t.log_every_steps, t.scan_steps = 1, 2
    cfg.infer.min_component_size = 1
    return cfg


@pytest.fixture(scope="module")
def batches(dataset):
    gen = batch_generator(_cfg(dataset, "").data, seed=0)
    return [next(gen) for _ in range(5)]


def _run(cfg, batches, steps=5):
    tr = TT.Trainer(cfg, device="cpu")
    tr.setup()
    seen = []
    calibrate = tr._maybe_calibrate

    def spy():
        op = calibrate()
        seen.append((int(tr.state.step), op,
                     TC.load_operating_point(cfg.train.checkpoint_path)))
        return op

    tr._maybe_calibrate = spy
    tr.run(batches, steps)
    return tr, seen


def _tensors(state):
    return TT.flat_tree(TT.state_tensors(state))


def test_each_save_writes_an_operating_point(dataset, batches, tmp_path):
    tr, seen = _run(_cfg(dataset, tmp_path), batches)
    assert [s for s, _, _ in seen] == [3, 5]  # saves after steps 2 and 4
    for step, op, stored in seen:
        assert set(op) == {"pixel", "link", "fmean"}
        assert op["pixel"] in TC.PIXEL_GRID and op["link"] in TC.LINK_GRID
        assert stored == dict(op, step=step)
    assert TT.latest_checkpoint(str(tmp_path)).endswith("ckpt_5")


def test_calibration_leaves_the_state_bit_equal(dataset, batches, tmp_path):
    on, _ = _run(_cfg(dataset, tmp_path / "on"), batches)
    off, seen = _run(_cfg(dataset, tmp_path / "off", calibrate=False),
                     batches)
    assert [op for _, op, _ in seen] == [None, None]
    assert TC.load_operating_point(str(tmp_path / "off")) is None
    a, b = _tensors(on.state), _tensors(off.state)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_failing_calibration_warns_and_training_goes_on(
        dataset, batches, tmp_path, monkeypatch, caplog):
    def broken(*a, **k):
        raise RuntimeError("planted")

    monkeypatch.setattr(TC, "calibrate_and_store", broken)
    with caplog.at_level(logging.WARNING):
        tr, seen = _run(_cfg(dataset, tmp_path), batches)
    assert int(tr.state.step) == 5 and [op for _, op, _ in seen] == [None,
                                                                      None]
    assert "threshold calibration failed: RuntimeError: planted" in caplog.text
    assert TT.latest_checkpoint(str(tmp_path)).endswith("ckpt_5")


def test_no_train_images_writes_nothing(batches, tmp_path):
    cfg = _cfg(str(tmp_path / "no_such_dir"), tmp_path / "ck")
    tr, seen = _run(cfg, batches, 3)
    assert seen == [(3, None, None)]


def test_device_cached_loop_calibrates_each_save(dataset, tmp_path):
    cfg = _cfg(dataset, tmp_path)
    tr = TT.Trainer(cfg, device="cpu")
    seen = []
    calibrate = tr._maybe_calibrate

    def spy():
        op = calibrate()
        seen.append((int(tr.state.step), op))
        return op

    tr._maybe_calibrate = spy
    tr.run_device_cached(4)
    assert [s for s, _ in seen] == [2, 4]
    assert TC.load_operating_point(str(tmp_path)) == dict(seen[-1][1], step=4)


class _Summary:
    def __init__(self):
        self.scalars = []

    def add_scalar(self, k, v, step):
        self.scalars.append((k, step))


@pytest.mark.parametrize("loop", ["run", "device_cached"])
def test_eval_hook_logs_every_eval_steps(dataset, batches, tmp_path, loop):
    cfg = _cfg(dataset, tmp_path, calibrate=False)
    cfg.train.save_checkpoint_steps = 0
    cfg.train.eval_every_steps = 2
    cfg.eval.gt_path = dataset
    writer = _Summary()
    tr = TT.Trainer(cfg, device="cpu", summary_writer=writer)
    assert tr.eval_hook is not None and tr.eval_hook.images is not None
    if loop == "run":
        tr.setup()
        tr.run(batches, 5)
    else:
        tr.run_device_cached(4)
    steps = sorted({s for k, s in writer.scalars if k == "val/fmean"})
    assert steps == [2, 4]
    assert {k for k, _ in writer.scalars if k.startswith("val/")} == {
        "val/precision", "val/recall", "val/fmean"}
