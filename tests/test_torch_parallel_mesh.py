"""``parallel/mesh.py`` and the refusals of the multi-GPU paths, in one
process with no process group (the single-device behaviour).

``shard_batch`` keeps rank r's contiguous rows ``[r·B/n, (r+1)·B/n)`` of
every array (JAX's ``P("data")``: the same global batch reaches the same
shard, checked against the rows JAX's ``shard_batch`` places on each
device of ``make_mesh(4)``), drops the file names and refuses a batch
that does not split. ``make_mesh`` refuses a ``num_devices`` other than
the world's size. ``make_multi_train_step`` refuses gloo on CUDA tensors
(a CUDA graph cannot capture a host sync; it never runs eagerly on the
card). The H-sharded forward refuses an image height that is not a
multiple of 32 x space (its kernel arms are served:
tests/test_torch_spatial_fused.py, _ghost.py, _route.py).
"""

import types

import numpy as np
import pytest
import torch

from tensorflow_ocr_tpu.parallel import make_mesh as jax_make_mesh
from tensorflow_ocr_tpu.parallel import shard_batch as jax_shard_batch
from tensorflow_ocr_tpu_torch.config import Config
from tensorflow_ocr_tpu_torch.models import build_model
from tensorflow_ocr_tpu_torch.parallel import (DataGroup, make_mesh,
                                               shard_batch, spatial)
from tensorflow_ocr_tpu_torch.parallel.mesh import backend_for
from tensorflow_ocr_tpu_torch.train import trainer as TT

torch.set_num_threads(1)


def test_shard_batch_takes_jax_s_rows(cpu_devices):
    batch = {"images": np.arange(8 * 2).reshape(8, 2).astype(np.float32),
             "polys": torch.arange(8 * 3).reshape(8, 3),
             "fns": [f"f{i}" for i in range(8)]}
    placed = jax_shard_batch(jax_make_mesh(4), batch)["images"]
    for r in range(4):
        g = DataGroup(r, 4, torch.device("cpu"), object(), "gloo")
        mine = shard_batch(g, batch)
        assert set(mine) == {"images", "polys"}
        jax_rows = next(np.asarray(s.data) for s in
                        placed.addressable_shards
                        if s.device == cpu_devices[r])
        np.testing.assert_array_equal(mine["images"], jax_rows)
        assert torch.equal(mine["polys"], batch["polys"][2 * r:2 * r + 2])
    with pytest.raises(ValueError, match="not divisible by 3"):
        shard_batch(DataGroup(0, 3, torch.device("cpu")), batch)


def test_make_mesh_without_a_process_group():
    g = make_mesh(device="cpu")
    assert (g.rank, g.world, g.reduces, g.backend) == (0, 1, False, None)
    assert make_mesh(1, "cpu").world == 1
    for n in (2, 16):
        with pytest.raises(ValueError, match=f"{n}-device mesh .* 1 rank"):
            make_mesh(n, "cpu")
    assert backend_for("cuda") == "nccl" and backend_for("cpu") == "gloo"
    # the collectives are skipped: the single-device step is unchanged
    t = torch.ones(3)
    g.all_reduce_([t])
    assert torch.equal(t, torch.ones(3))
    assert g.any_(True, False) == [True, False]


def test_multi_step_refuses_gloo_on_cuda_tensors():
    cuda_state = types.SimpleNamespace(
        step=types.SimpleNamespace(device=torch.device("cuda")))
    gloo = DataGroup(0, 2, torch.device("cuda", 0), object(), "gloo")
    with pytest.raises(ValueError, match="gloo backend.*CUDA graph"):
        TT.make_multi_train_step(cuda_state, Config(), group=gloo)


def test_spatial_refuses_a_height_off_32_x_space():
    mesh = spatial.make_spatial_mesh(1, "cpu")
    model = build_model("pixellink_tiny", dtype=torch.float32)
    run = spatial.spatial_forward(model, mesh)
    with pytest.raises(ValueError, match="multiple of 32"):
        run(np.zeros((1, 48, 32, 3), np.float32))


def test_one_shard_serving_is_the_predictor_s(monkeypatch):
    """A world of one through spatial_predictor: the same maps and boxes
    as the Predictor's own forward (the halo path pads at the image's
    edges only, with the conv's own padding where it is symmetric)."""
    from tensorflow_ocr_tpu_torch.infer import Predictor, pixel_link_scores

    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (2, 64, 96, 3)).astype(np.uint8)
    pred = Predictor("pixellink_tiny", device="cpu", dtype=torch.float32)
    want_maps = pred.model(torch.from_numpy(images))
    want = pred.detect_batch(images)
    spatial.spatial_predictor(pred, spatial.make_spatial_mesh(1, "cpu"))
    got_maps = pred.forward(torch.from_numpy(images))
    for k, v in want_maps.items():
        assert torch.equal(got_maps[k], v), k
    assert pixel_link_scores(got_maps)[0].shape == (2, 16, 24)
    got = pred.detect_batch(images)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert len(a) == len(b) and all(np.array_equal(x, y)
                                        for x, y in zip(a, b))
