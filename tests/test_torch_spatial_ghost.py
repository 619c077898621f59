"""The H-sharded forward of the ghost arm on gloo ranks against JAX.

pixellink_resnet50 with ``bottleneck_impl="ghost"`` at 2 x 128x64,
float32. JAX picks a ghost unit where ``pick_gh`` gives the global shape
a band (resnet.py:436-451), and its eval is plain ops
(resnet.py:275-302): so is the port's ``GhostBottleneck._eval``, whose
3x3 takes its halo rows through ``conv2d_pads``. The port picks the unit
from the whole image's height (``layers.full_height``): at 4 ranks
block3's 8 rows are 2 a shard, where ``pick_gh`` gives none, and every
shard still runs the ghost eval there, as the whole image does. H over 2
and 4 ranks, and a 2x2 (data, space) grid. Every rank's maps against
JAX's single-device ``model.apply`` of its ghost model (rtol 1e-3, atol
1e-3 of the largest value, test_torch_spatial_vgg.py's check) and
against the port's own unsharded ghost forward within 1e-5 of the
largest value; every rank runs the ghost eval in the units the whole
image does.
"""

import pytest
import torch

from tensorflow_ocr_tpu.models import resnet as JR
from tensorflow_ocr_tpu_torch.ops import ghost as G
from test_torch_spatial_vgg import check_sharded, port_reference

torch.set_num_threads(1)
MODEL, HW, SEED = "pixellink_resnet50", (128, 64), 74


@pytest.fixture
def jax_ghost(monkeypatch):
    """JAX's ghost units on for the reference (its eval runs no kernel)."""
    monkeypatch.delenv("OCR_GHOST_UNITS", raising=False)
    monkeypatch.delenv("OCR_FUSED_BOTTLENECKS", raising=False)
    monkeypatch.setattr(JR, "GHOST_BOTTLENECKS", True)
    monkeypatch.setattr(JR, "FUSED_BOTTLENECKS", False)


@pytest.mark.parametrize("world,data_axis", [(2, 1), (4, 1), (4, 2)])
def test_ghost_sharded_forward_matches_jax(tmp_path, jax_ghost, world,
                                           data_axis):
    whole = port_reference(MODEL, HW, SEED, "ghost")[1]
    outs = check_sharded(tmp_path, MODEL, HW, SEED, world, data_axis,
                         "ghost", unsharded=True)
    # block1 (32 rows), block2 (16) and block3 (8) have bands, block4 (4)
    # none: 2 + 3 + 5 ghost units
    assert whole["ghost_eval"] == 10
    # a 4-rank shard of block3 has 2 rows, where pick_gh gives no band
    assert G.pick_gh(8, 4, 1024, 256, 1024) == 8
    assert G.pick_gh(2, 4, 1024, 256, 1024) is None
    for r, out in enumerate(outs):
        assert out["calls"]["ghost_eval"] == whole["ghost_eval"], r
        assert not out["calls"]["route"] and not out["calls"]["fused3x3"]
