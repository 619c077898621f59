"""The data-parallel ``freeze_bn`` step on gloo ranks against JAX's.

As tests/test_torch_dp_step.py (its helpers and tolerances), with
``freeze_bn``: BN normalises with the running statistics, so there are
none to reduce; the gradients (mean) and the metrics are. pixellink_tiny
at 64x64, float32, 2 images a rank, on 2 and 4 ranks.
"""

import numpy as np
import pytest
import torch

from test_torch_bottleneck import f32_batchnorm  # noqa: F401
from test_torch_dp_step import SIZE, dp_step_matches_jax
from test_torch_step import scene_batch

torch.set_num_threads(1)


@pytest.mark.parametrize("world", [2, 4])
def test_dp_freeze_bn_step_matches_jax(tmp_path, f32_batchnorm, world):
    batch = scene_batch(np.random.RandomState(40 + world), 2 * world, SIZE)
    outs = dp_step_matches_jax(tmp_path, {
        "model": "pixellink_tiny", "freeze_bn": True}, world, batch,
        seed=40 + world)
    # the running statistics are the init's: nothing updated them
    init = torch.load(tmp_path / "weights.pt")
    for k, v in outs[0]["state"]["model"].items():
        if k.endswith(("running_mean", "running_var")):
            assert torch.equal(v, init[k]), k
    key = "backbone.stem1.conv.weight"
    assert not torch.equal(outs[0]["state"]["ema"][key], init[key])
