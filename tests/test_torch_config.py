"""The port's inference settings keep the JAX package's defaults.

``tensorflow_ocr_tpu_torch.config.InferConfig`` copies the fields of
``tensorflow_ocr_tpu.config.InferConfig`` that the PixelLink Predictor
reads, so that the port imports nothing of the JAX package. Each copied
field must exist on the JAX side with the same default.
"""

import dataclasses

import pytest
import torch

from tensorflow_ocr_tpu.config import InferConfig as JaxInferConfig
from tensorflow_ocr_tpu_torch.config import InferConfig

torch.set_num_threads(1)


@pytest.mark.parametrize("field", [f.name for f in
                                   dataclasses.fields(InferConfig)])
def test_infer_default_matches_jax(field):
    assert getattr(InferConfig(), field) == getattr(JaxInferConfig(), field)
