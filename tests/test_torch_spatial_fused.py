"""The H-sharded forward of the fused arm on gloo ranks against JAX.

pixellink_resnet50 with ``bottleneck_impl="fused"`` at 2 x 128x64,
float32, the fused kernels' plain versions (the CPU path of their
wrappers): each of the 13 fused units runs its 3x3 on the shard's rows
and one halo row each side (``HaloRows.halo``; the prologue relu(x·a + b)
applies to the halo rows as on the whole image), its 1x1s and boundary on
the shard's rows. H over 2 and 4 ranks, and a 2x2 (data, space) grid.
Every rank's maps against JAX's single-device ``model.apply`` of the
"xla" model with the same variables, rtol 1e-3 and atol 1e-3 of the
largest value (test_torch_spatial_vgg.py's check; the fused unit is held
to the xla one by test_torch_bottleneck.py), and against the port's own
unsharded fused forward within 1e-5 of the largest value.
"""

import pytest
import torch

from test_torch_spatial_vgg import check_sharded, port_reference

torch.set_num_threads(1)
MODEL, HW, SEED = "pixellink_resnet50", (128, 64), 73


@pytest.mark.parametrize("world,data_axis", [(2, 1), (4, 1), (4, 2)])
def test_fused_sharded_forward_matches_jax(tmp_path, world, data_axis):
    whole = port_reference(MODEL, HW, SEED, "fused")[1]
    outs = check_sharded(tmp_path, MODEL, HW, SEED, world, data_axis,
                         "fused", unsharded=True)
    # the 13 stride-1 units are fused; each rank's 3x3s read its rows and
    # the halo: one row more at each edge that is not the image's
    assert len(whole["fused3x3"]) == 13
    space = world // data_axis
    for r, out in enumerate(outs):
        s = r % space
        assert out["calls"]["fused3x3"] == [
            h // space + (s > 0) + (s < space - 1)
            for h in whole["fused3x3"]], r
        assert not out["calls"]["route"] and not out["calls"]["ghost_eval"]
