"""The ghost arm's freeze_bn step against JAX's ``make_train_step`` with
``freeze_bn`` and its ghost units on: at an admitted shape the eval-mode
ghost unit applies the running-statistics affine after the products, in
float32 (resnet.py:275-302), not the ConvBN fold, and the gradients flow
through that formula (plain torch ops, no kernel). Setup, sizes and
tolerances: test_torch_step_ghost.py."""

import torch

from test_torch_bottleneck import f32_batchnorm  # noqa: F401
from test_torch_step import run_parity
from test_torch_step_ghost import GHOST_SIZE, ghost  # noqa: F401

torch.set_num_threads(1)


def test_ghost_freeze_bn_steps_match_jax(f32_batchnorm, ghost):
    run_parity(freeze_bn=True, impl="ghost", size=GHOST_SIZE)
    assert ghost["jax"] == 0        # eval-mode units: no ghost kernel
    assert ghost["port"] == 2 * 3   # the ghost eval formula, 2 units
