"""The pallas_conv route on the train step: the port's xla-arm step with
``PALLAS_CONVS`` on (ops/conv.py, the plain versions on the CPU) against
JAX's ``make_train_step`` with ``layers.PALLAS_CONVS`` on and the Pallas
kernels in interpret mode.

pixellink_resnet50 at 64x64, batch 2, float32, 1 step; setup and
tolerances are test_torch_step.py's. Both sides must route convs: at
64x64 JAX takes the 3x3s and the 1x1s of M >= 256 (block1 and the
head's pool2 and pool3 projections), and the port's route takes the
same convs (``ops/conv.py`` ``supported`` mirrors JAX's). The freeze_bn
arm is test_torch_step_pallas_conv_freeze_bn.py.
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
    (the JAX side's at trace time) and records the shapes each side
    routes, as (N, H, W, Ci, Co, k)."""
    calls = {"jax": 0, "port": 0, "jax_shapes": set(), "port_shapes": set()}

    def counted(side, fn):
        def wrapped(x, w, *args, **kw):
            calls[side] += 1
            if side == "jax":
                n, h, wd, ci = x.shape
                key = (n, h, wd, ci, w.shape[3], w.shape[0])
            else:
                n, ci, h, wd = x.shape
                key = (n, h, wd, ci, w.shape[0], w.shape[-1])
            calls[f"{side}_shapes"].add(key)
            return fn(x, w, *args, **kw)
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
    # 13 convs a forward (block1's 1x1s and 3x3s, the 3x3 of block2 and
    # the head's projections from pool2 and pool3), the shapes JAX's route
    # takes at the batch's size (JAX also traces its batch-1 init)
    assert calls["port"] == STEPS * 13
    n = {k[0] for k in calls["port_shapes"]}
    assert calls["port_shapes"] == {k for k in calls["jax_shapes"]
                                    if k[0] in n}


def test_pallas_conv_train_steps_match_jax(f32_batchnorm, routed):
    run_parity(freeze_bn=False, steps=STEPS, impl="xla")
    check_routed(routed)
