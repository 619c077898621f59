"""The data settings the port brought back keep the JAX package's defaults.

``tensorflow_ocr_tpu_torch.config.DataConfig`` now carries every field of
``tensorflow_ocr_tpu/config.py:18-49`` (the reader, the loaders, the
augmentation, the decode cache) and ``TrainConfig.use_device_cache``
(:158): each exists on both sides with the same default, and the port has
no data field that JAX lacks.
"""

import dataclasses

import pytest
import torch

from tensorflow_ocr_tpu import config as J
from tensorflow_ocr_tpu_torch import config as T

torch.set_num_threads(1)


@pytest.mark.parametrize("field", [f.name for f in
                                   dataclasses.fields(J.DataConfig)])
def test_every_jax_data_field_is_ported_with_its_default(field):
    assert getattr(T.DataConfig(), field) == getattr(J.DataConfig(), field)


def test_the_port_adds_no_data_field():
    port = {f.name for f in dataclasses.fields(T.DataConfig)}
    assert port == {f.name for f in dataclasses.fields(J.DataConfig)}


def test_use_device_cache_is_back():
    assert T.TrainConfig().use_device_cache is \
        J.TrainConfig().use_device_cache is False
