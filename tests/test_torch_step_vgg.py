"""The VGG-16 train step against JAX's ``make_train_step``.

``check_step`` of tests/test_torch_step_east.py for ``pixellink2s_vgg16``
with the OHEM loss at 64x64, batch 2, float32: the PixelLink head one
level finer (conv2_2), labels rasterised on the stride-2 grid (32x32) on
both sides. What is compared and the tolerances are described there.
"""

import torch

from test_torch_step_east import check_step

torch.set_num_threads(1)


def test_pixellink2s_vgg16_step_matches_jax():
    m = check_step("pixellink2s_vgg16", "ohem")
    assert float(m["n_pos"]) > 0
