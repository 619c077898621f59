"""The H-sharded forward of pixellink_tiny and east_tiny on gloo ranks
against JAX's single-device apply.

As tests/test_torch_spatial_vgg.py (its check and tolerances): the tiny
backbone's SAME stride-2 3x3s (pads 0 above, 1 below), its ConvBNs with
BN folded, and the heads' unpools (one neighbour row each side, the edge
row replicated at the image's top and bottom); east_tiny adds the EAST
merge's 3x3s. 2 images at 128x64, H over 2 and 4 ranks, and a 2x2
(data, space) grid.
"""

import pytest
import torch

from test_torch_spatial_vgg import check_sharded

torch.set_num_threads(1)


@pytest.mark.parametrize("world,data_axis", [(2, 1), (4, 1), (4, 2)])
def test_tiny_sharded_forward_matches_jax(tmp_path, world, data_axis):
    check_sharded(tmp_path, "pixellink_tiny", (128, 64), 71, world,
                  data_axis)


def test_east_tiny_sharded_forward_matches_jax(tmp_path):
    check_sharded(tmp_path, "east_tiny", (128, 64), 72, 4, 1)
