"""The pallas_conv route on the train step: the port's xla-arm step with
``PALLAS_CONVS`` on (ops/conv.py, the plain versions on the CPU) against
JAX's ``make_train_step`` with ``layers.PALLAS_CONVS`` on and the Pallas
kernels in interpret mode.

pixellink_resnet50 at 64x64, batch 2, float32, 1 step; setup and
tolerances are test_torch_step.py's. Both sides must route convs: at
64x64 JAX takes the 3x3s and the 1x1s of M >= 256 (block1 and the
head's pool2 and pool3 projections); the port takes every stride-1 1x1
and 3x3 (44 and 13 in the forward). The freeze_bn arm is
test_torch_step_pallas_conv_freeze_bn.py.
"""

import pytest
import torch

from tensorflow_ocr_tpu.models import layers as JL
from tensorflow_ocr_tpu.ops import pallas_conv as PCV
from tensorflow_ocr_tpu_torch.models import layers as TL
from tensorflow_ocr_tpu_torch.ops import conv as CV
from test_torch_bottleneck import f32_batchnorm  # noqa: F401
from test_torch_step import run_parity

torch.set_num_threads(1)
STEPS = 1


@pytest.fixture
def routed(monkeypatch):
    """Both routes on, JAX's kernels interpreted; counts conv2d calls
    (the JAX side's at trace time, one trace)."""
    calls = {"jax": 0, "port": 0}

    def counted(side, fn):
        def wrapped(*args, **kw):
            calls[side] += 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(JL, "PALLAS_CONVS", True)
    monkeypatch.setattr(PCV, "conv2d", counted("jax", PCV.conv2d))
    monkeypatch.setattr(TL, "PALLAS_CONVS", True)
    monkeypatch.setattr(CV, "conv2d", counted("port", CV.conv2d))
    PCV.set_interpret(True)
    yield calls
    PCV.set_interpret(False)


def check_routed(calls):
    assert calls["jax"] > 0
    assert calls["port"] == STEPS * (44 + 13)


def test_pallas_conv_train_steps_match_jax(f32_batchnorm, routed):
    run_parity(freeze_bn=False, steps=STEPS, impl="xla")
    check_routed(routed)
