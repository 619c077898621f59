"""One data-parallel EAST step on gloo ranks against JAX's.

As tests/test_torch_dp_step.py (its helpers and tolerances) with
``east_tiny`` RBOX and the EAST loss at 64x64, float32, on a batch of
numpy scenes with their EAST geometry (``east_poly_geometry``), labels
made from the polygons on both sides; 2 images a rank on 2 and 4 ranks.
Params, BN buffers, Adam moments, EMA and metrics are compared.
"""

import numpy as np
import pytest
import torch

from test_torch_bottleneck import f32_batchnorm  # noqa: F401
from test_torch_dp_step import SIZE, dp_step_matches_jax
from test_torch_step_east import east_batch

torch.set_num_threads(1)


@pytest.mark.parametrize("world", [2, 4])
def test_dp_east_step_matches_jax(tmp_path, f32_batchnorm, world):
    batch = east_batch(np.random.RandomState(50 + world), 2 * world, SIZE)
    outs = dp_step_matches_jax(tmp_path, {
        "model": "east_tiny", "loss": "east", "geometry": "RBOX"}, world,
        batch, seed=50 + world)
    assert float(outs[0]["metrics"]["geo_loss"]) > 0
