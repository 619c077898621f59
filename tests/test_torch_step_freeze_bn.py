"""The slice's freeze_bn arm: 3 train steps on running BN statistics
(the eval-mode model, gradients through the BN fold and the fused
kernels with ds = None) against JAX's ``make_train_step`` with
``freeze_bn``. Setup and tolerances: test_torch_step.py."""

import torch

from test_torch_bottleneck import f32_batchnorm  # noqa: F401
from test_torch_step import run_parity

torch.set_num_threads(1)


def test_freeze_bn_train_steps_match_jax_make_train_step(f32_batchnorm):
    run_parity(freeze_bn=True)
