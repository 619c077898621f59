"""The pallas_conv route on the freeze_bn step against JAX's
``make_train_step`` with ``freeze_bn``: the eval-mode BN fold rounds
w·mul to the activation dtype (float32 here), runs the routed conv, then
adds the shift. Setup, counts and tolerances:
test_torch_step_pallas_conv.py."""

import torch

from test_torch_bottleneck import f32_batchnorm  # noqa: F401
from test_torch_step import run_parity
from test_torch_step_pallas_conv import (  # noqa: F401
    STEPS,
    check_routed,
    routed,
)

torch.set_num_threads(1)


def test_pallas_conv_freeze_bn_steps_match_jax(f32_batchnorm, routed):
    run_parity(freeze_bn=True, steps=STEPS, impl="xla")
    check_routed(routed)
