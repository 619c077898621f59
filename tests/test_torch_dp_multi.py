"""The data-parallel multi-step dispatch with on-device augmentation on
gloo ranks against JAX's ``make_multi_train_step(augment=True)``.

Every rank holds the whole dataset and the same (S, B) rows, trains on
its columns of them, and folds its rank into the augmentation key where
JAX folds ``axis_index`` (trainer.py:346-347): the ranks' draws differ
and match the JAX shards'. pixellink_tiny at 64x64, float32 (the
``f32_batchnorm`` fixture), one dispatch of 2 steps of 2 images a rank
from 4 scenes a rank, random scale, crop and rotation on, on
``make_mesh(n)`` against n ranks, n = 2 and 4. Tolerances as
tests/test_torch_step_augment.py: the moves of the parameters and their
EMA rtol 1e-2 + atol lr / 10, Adam's moments 1e-2, losses rtol 1e-2, the
positive-pixel count exactly; every rank's state bit-equal.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from tensorflow_ocr_tpu.parallel.mesh import make_mesh
from tensorflow_ocr_tpu.train import trainer as JT
from tensorflow_ocr_tpu_torch.models.convert import convert_train_state
from test_torch_bottleneck import f32_batchnorm  # noqa: F401
from test_torch_dp_step import (LR, SIZE, jax_config, jax_state,
                                same_on_every_rank)
from test_torch_rank_worker import run_ranks, write_inputs
from test_torch_step_augment import AUG, S
from test_torch_step import scene_batch

torch.set_num_threads(1)


def _dataset(rng, n):
    b = scene_batch(rng, n, SIZE)
    k = b["polys"].shape[1]
    b.update(shrunk=np.zeros((n, k, 4, 2), np.float32),
             rects=np.zeros((n, k, 4, 2), np.float32),
             angles=np.zeros((n, k), np.float32))
    return b


@pytest.mark.parametrize("world", [2, 4])
def test_dp_augmented_dispatch_matches_jax(tmp_path, f32_batchnorm, world):
    rng = np.random.RandomState(60 + world)
    spec = {"model": "pixellink_tiny", "augment": True, "data": AUG}
    data = _dataset(rng, 4 * world)
    idx = np.stack([rng.permutation(4 * world)[:2 * world]
                    for _ in range(S)]).astype(np.int32)

    jmodel, tx, jstate, init = jax_state("pixellink_tiny", SIZE, rng)
    jcfg = jax_config(spec)
    for k, v in AUG.items():
        setattr(jcfg.data, k, v)
    mesh = make_mesh(world)
    multi_j = JT.make_multi_train_step(jmodel, tx, jcfg, mesh, augment=True)
    rep = NamedSharding(mesh, P())
    jstate, jm = multi_j(
        jstate, {k: jax.device_put(v, rep) for k, v in data.items()},
        jax.device_put(idx, NamedSharding(mesh, P(None, "data"))))

    write_inputs(tmp_path, spec, init, data=data, idx={"idx": idx})
    outs = run_ranks("multi", world, tmp_path)
    same_on_every_rank(outs)
    m, live = outs[0]["metrics"], outs[0]["state"]
    assert int(live["step"]) == int(jstate.step) == S
    for key in ("total_loss", "model_loss", "pixel_loss", "link_loss"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-2,
                                   err_msg=key)
    assert float(m["n_pos"]) == float(jm["n_pos"]) > 0
    want = convert_train_state(jax.device_get(jstate))
    for part in ("model", "ema"):
        for key in want["ema"]:
            np.testing.assert_allclose(
                (live[part][key] - init[key]).numpy(),
                (want[part][key] - init[key]).numpy(), rtol=1e-2,
                atol=LR / 10, err_msg=f"{part} {key}")
    for key, moments in want["optimizer"].items():
        for okey in ("exp_avg", "exp_avg_sq"):
            v = moments[okey]
            np.testing.assert_allclose(
                live["optimizer"][key][okey].numpy(), v.numpy(), rtol=1e-2,
                atol=1e-2 * float(v.abs().max()), err_msg=f"{key} {okey}")
