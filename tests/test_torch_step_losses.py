"""The train step with the other losses against JAX's ``make_train_step``.

``check_step`` of tests/test_torch_step_east.py (one step at 64x64,
batch 2, float32, from one converted init; losses rtol 1e-4, parameter
moves, Adam's moments and BN statistics as described there) for:
``pixellink_tiny`` with the dice, positive and focal losses, whose
dispatch (trainer.py:127-163) the port's ``make_loss_fn`` follows, and a
link8 model on the tiny backbone with the dice loss (``link8_tiny``,
added to both registries for the test: the registries have no tiny
link8 model).
"""

import pytest
import torch

from tensorflow_ocr_tpu.models import detector as JDet
from tensorflow_ocr_tpu_torch.models import detector as TDet
from test_torch_bottleneck import f32_batchnorm  # noqa: F401
from test_torch_step_east import check_step

torch.set_num_threads(1)


@pytest.mark.parametrize("loss", ["dice", "positive", "focal"])
def test_pixellink_step_matches_jax(f32_batchnorm, loss):
    m = check_step("pixellink_tiny", loss)
    assert float(m["link_loss"]) > 0


def test_link8_step_matches_jax(f32_batchnorm, monkeypatch):
    entry = dict(backbone_name="tiny", head_name="link8")
    monkeypatch.setitem(JDet.MODEL_REGISTRY, "link8_tiny", dict(entry))
    monkeypatch.setitem(TDet.MODEL_REGISTRY, "link8_tiny", dict(entry))
    m = check_step("link8_tiny", "dice")
    assert float(m["pixel_loss"]) > 0
