"""The H-sharded forward of the ``PALLAS_CONVS`` route on gloo ranks
against JAX.

pixellink_tiny at 2 x 128x64, float32, with the route on both sides
(JAX's Pallas kernels interpreted, the port's conv kernels on their plain
versions). The route decides on the whole image's shape, as JAX's does
on the global one, so every rank routes the convs the whole image
routes: each routed 3x3 runs on the shard's rows and one halo row each
side (SAME inside the kernel; ``HaloRows.halo``), each routed 1x1 on the
shard's rows alone. H over 2 and 4 ranks, and a 2x2 (data, space) grid.
Every rank's maps against JAX's single-device ``model.apply`` with the
route (rtol 1e-3, atol 1e-3 of the largest value,
test_torch_spatial_vgg.py's check) and against the port's own unsharded
forward with the route within 1e-5 of the largest value.
"""

import pytest
import torch

from tensorflow_ocr_tpu.models import layers as JL
from tensorflow_ocr_tpu.ops import pallas_conv as PCV
from tensorflow_ocr_tpu_torch.models import layers as TL
from test_torch_spatial_vgg import check_sharded, port_reference

torch.set_num_threads(1)
MODEL, HW, SEED = "pixellink_tiny", (128, 64), 75
_JAX_ROUTED = []


@pytest.fixture
def routed(monkeypatch):
    """Both routes on, JAX's kernels interpreted; JAX's conv2d calls
    recorded as (N, k, H) while its reference is made."""
    conv2d = PCV.conv2d

    def counted(x, w, *a, **k):
        _JAX_ROUTED.append((x.shape[0], w.shape[0], x.shape[1]))
        return conv2d(x, w, *a, **k)

    monkeypatch.setattr(JL, "PALLAS_CONVS", True)
    monkeypatch.setattr(PCV, "conv2d", counted)
    monkeypatch.setattr(TL, "PALLAS_CONVS", True)
    PCV.set_interpret(True)
    yield
    PCV.set_interpret(False)


@pytest.mark.parametrize("world,data_axis", [(2, 1), (4, 1), (4, 2)])
def test_route_sharded_forward_matches_jax(tmp_path, routed, world,
                                           data_axis):
    whole = port_reference(MODEL, HW, SEED, "xla", True)[1]
    outs = check_sharded(tmp_path, MODEL, HW, SEED, world, data_axis,
                         "xla", True, unsharded=True)
    # JAX's route on the batch of 2 at 128x64 (its init traces batch 1)
    # and the port's take the same convs: the stride-1 3x3 at 16x8 and
    # the head's 1x1s from pool2 and pool3 (M = 1024 and 256)
    assert sorted(whole["route"]) == sorted(
        (k, h) for n, k, h in _JAX_ROUTED if n == 2) == [
            (1, 16), (1, 16), (1, 32), (1, 32), (3, 16)]
    space = world // data_axis
    for r, out in enumerate(outs):
        s = r % space
        assert out["calls"]["route"] == [
            (k, h // space + (k == 3) * ((s > 0) + (s < space - 1)))
            for k, h in whole["route"]], r
        assert not out["calls"]["fused3x3"] and not out["calls"]["ghost_eval"]
