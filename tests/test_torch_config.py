"""The port's settings keep the JAX package's defaults.

``tensorflow_ocr_tpu_torch.config`` copies the fields of
``tensorflow_ocr_tpu.config`` that the Predictor (``InferConfig``) and
the train step (``DataConfig``, ``ModelConfig``, ``LossConfig``,
``TrainConfig``) read, so that the port imports nothing of the JAX
package. Each copied field must exist on the JAX side with the same
default.
"""

import dataclasses

import pytest
import torch

from tensorflow_ocr_tpu import config as J
from tensorflow_ocr_tpu.config import InferConfig as JaxInferConfig
from tensorflow_ocr_tpu_torch import config as T
from tensorflow_ocr_tpu_torch.config import InferConfig

torch.set_num_threads(1)


@pytest.mark.parametrize("field", [f.name for f in
                                   dataclasses.fields(InferConfig)])
def test_infer_default_matches_jax(field):
    assert getattr(InferConfig(), field) == getattr(JaxInferConfig(), field)


TRAIN_SECTIONS = ("DataConfig", "ModelConfig", "LossConfig", "TrainConfig")


@pytest.mark.parametrize("section,field", [
    (sec, f.name) for sec in TRAIN_SECTIONS
    for f in dataclasses.fields(getattr(T, sec))])
def test_train_default_matches_jax(section, field):
    port, jax_ = getattr(T, section)(), getattr(J, section)()
    assert getattr(port, field) == getattr(jax_, field)


def test_config_tree_has_the_sections():
    cfg = T.Config()
    for name in ("data", "model", "loss", "train", "infer"):
        assert type(getattr(cfg, name)).__name__ == type(
            getattr(J.Config(), name)).__name__
