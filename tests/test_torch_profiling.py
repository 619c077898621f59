"""The port's utils/profiling.py and utils/summary.py against the JAX
package's.

StepTimer is a verbatim copy: on the same tick times (the clock
monkeypatched in both modules) its stats equal JAX's exactly. The
summary writer is a copy of the JAX-free one: it does nothing where
torch.utils.tensorboard cannot be imported, and writes through it where
it can (a stand-in module records the calls). trace() writes a Chrome
trace of the block; annotate() names a range in it.
"""

import json
import sys
import types

import numpy as np
import pytest
import torch

from tensorflow_ocr_tpu.utils import profiling as JP
from tensorflow_ocr_tpu_torch.utils import profiling as TP
from tensorflow_ocr_tpu_torch.utils import summary as TS

torch.set_num_threads(1)


@pytest.mark.parametrize("window", [3, 100])
def test_step_timer_stats_equal_jax(monkeypatch, window):
    ticks = iter(np.cumsum(np.random.RandomState(window).uniform(
        0.05, 0.3, 12)).tolist())
    timers = (TP.StepTimer(window), JP.StepTimer(window))
    for now in ticks:
        for mod in (TP, JP):
            monkeypatch.setattr(mod.time, "time", lambda now=now: now)
        for t in timers:
            t.tick()
    got, want = (t.stats(batch_size=32) for t in timers)
    assert got == want and set(got) == {
        "sec_per_step_p50", "sec_per_step_p90", "examples_per_sec"}
    assert TP.StepTimer().stats() == {}


def test_summary_writer_does_nothing_without_tensorboard(monkeypatch,
                                                         tmp_path):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    w = TS.SummaryWriter(str(tmp_path))
    assert w._writer is None
    w.add_scalar("loss", 1.0, 0)
    w.add_scalars({"a": 1.0}, 1)
    w.add_histogram("h", [1.0, 2.0], 0)
    w.add_detection_summaries(0, images=np.zeros((1, 4, 4, 3)),
                              gt_score=np.zeros((1, 2, 2, 1)),
                              pred_score=np.ones((1, 2, 2, 1)))
    w.flush()
    w.close()
    assert list(tmp_path.iterdir()) == []


def test_summary_writer_writes_through_tensorboard(monkeypatch, tmp_path):
    calls = []

    class Writer:
        def __init__(self, logdir):
            calls.append(("init", logdir))

        def add_scalar(self, tag, value, step):
            calls.append(("scalar", tag, value, step))

        def add_image(self, tag, img, step, dataformats):
            calls.append(("image", tag, img.dtype, img.shape, dataformats))

    fake = types.ModuleType("torch.utils.tensorboard")
    fake.SummaryWriter = Writer
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", fake)
    w = TS.SummaryWriter(str(tmp_path))
    w.add_scalars({"total_loss": np.float32(2.5)}, 7)
    w.add_detection_summaries(3, images=np.full((1, 4, 6, 3), 200.0),
                              pred_score=np.full((1, 2, 3, 1), 0.5))
    assert calls == [
        ("init", str(tmp_path)), ("scalar", "total_loss", 2.5, 7),
        ("image", "input", np.uint8, (4, 6, 3), "HWC"),
        ("image", "score_map_pred", np.uint8, (2, 3, 1), "HWC")]


def test_trace_writes_a_chrome_trace_with_annotations(tmp_path):
    with TP.trace(str(tmp_path)):
        with TP.annotate("step"):
            torch.ones(8).sum()
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "step" for e in events)
