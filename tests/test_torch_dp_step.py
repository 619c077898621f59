"""The data-parallel train step on gloo ranks against JAX's on a mesh.

The port's ranks are CPU processes joined by a gloo process group
(``tests/test_torch_rank_worker.py``, no JAX there); each trains on its
rows of the global batch and reduces as ``train/trainer.py``
``train_step`` does: one flat all-reduce of the gradients (mean, or sum
for ``grad_reduce="sum"``), the optimizer and EMA, one of the BN running
statistics (mean), one of the metrics (mean). JAX runs its ``shard_map``
step (``make_train_step``) on ``make_mesh(n)`` over conftest's CPU
devices, from the same converted init and the same global batch:
pixellink_tiny at 64x64, float32 (the ``f32_batchnorm`` fixture), 2
images a rank, on 2 and 4 ranks. And on 2 ranks that each read only
their rows of the global batch (``data/resumable.py`` ``ResumableLoader``
given the group): JAX steps on the first global batch of a world-1
loader, which the two ranks' batches, stacked, must equal.

Compared (:func:`check_against_jax`, tests/test_torch_step_east.py's
tolerances): the metrics rtol 1e-4 (OHEM's per-direction link terms
1e-3); what the step moved each parameter and its EMA by, rtol 1e-2 +
atol lr / 10 where the gradient is at least 1e-2 of the tensor's
largest; Adam's moments and the BN statistics 1e-2 (relative, and of
their largest value). Every rank ends with the same state, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_ocr_tpu.config import Config as JConfig
from tensorflow_ocr_tpu.models import build_model as build_jax_model
from tensorflow_ocr_tpu.parallel.mesh import make_mesh
from tensorflow_ocr_tpu.train import optim as JOptim
from tensorflow_ocr_tpu.train import trainer as JT
from tensorflow_ocr_tpu_torch.config import Config
from tensorflow_ocr_tpu_torch.data import icdar
from tensorflow_ocr_tpu_torch.data.resumable import ResumableLoader
from tensorflow_ocr_tpu_torch.models.convert import (
    convert_train_state,
    convert_variables,
)
from tensorflow_ocr_tpu_torch.parallel.mesh import DataGroup
from tensorflow_ocr_tpu_torch.train import trainer as TT
from test_torch_bottleneck import f32_batchnorm  # noqa: F401
from test_torch_rank_worker import run_ranks, write_inputs
from test_torch_step import numpy_init, scene_batch

torch.set_num_threads(1)
LR, SIZE = 1e-4, 64


def jax_state(name, size, rng, geometry="RBOX"):
    """A converted-init JAX TrainState, its model and optimizer, and the
    port's weights of the same init."""
    jcfg = JConfig()
    jmodel = build_jax_model(name, dtype=jnp.float32, geometry=geometry)
    variables = numpy_init(jmodel, size, rng)
    tx = JOptim.make_optimizer(jcfg.train,
                               weight_decay=jcfg.model.weight_decay)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jstate = JT.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(
            jnp.asarray, variables.get("batch_stats", {})),
        opt_state=tx.init(params), ema_params=params)
    return jmodel, tx, jstate, convert_variables(variables)


def jax_config(spec):
    jcfg = JConfig()
    jcfg.model.name = spec["model"]
    jcfg.model.freeze_bn = spec.get("freeze_bn", False)
    jcfg.loss.name = spec.get("loss", "ohem")
    jcfg.data.geometry = spec.get("geometry", "RBOX")
    jcfg.data.input_size = spec.get("size", SIZE)
    jcfg.train.grad_reduce = spec.get("grad_reduce", "mean")
    jcfg.train.donate_state = False
    for k, v in spec.get("data", {}).items():  # as the ranks' _config
        setattr(jcfg.data, k, v)
    return jcfg


def check_against_jax(got, jstate, jm, init, steps=1):
    """A rank's output (``state``, ``metrics``) against JAX's state and
    metrics after ``steps`` steps from ``init``; see the module
    docstring."""
    m, live = got["metrics"], got["state"]
    assert int(live["step"]) == int(jstate.step) == steps
    assert set(m) == set(jm)
    for key in m:
        rtol = 1e-3 if key.startswith("link_loss/dir") else 1e-4
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=rtol,
                                   atol=1e-7, err_msg=key)
    want = convert_train_state(jax.device_get(jstate))
    for part in ("model", "ema"):
        for key in want["ema"]:
            g = torch.sqrt(want["optimizer"][key]["exp_avg_sq"]
                           / (1 - 0.999 ** steps))
            sure = (g >= max(1e-7, 1e-2 * float(g.max()))).numpy()
            moved = (want[part][key] - init[key]).numpy()
            np.testing.assert_allclose(
                (live[part][key] - init[key]).numpy()[sure], moved[sure],
                rtol=1e-2, atol=LR / 10, err_msg=f"{part} {key}")
    for key, moments in want["optimizer"].items():
        got_m = live["optimizer"][key]
        assert float(got_m["step"]) == float(moments["step"]) == steps, key
        for okey in ("exp_avg", "exp_avg_sq"):
            v = moments[okey]
            np.testing.assert_allclose(
                got_m[okey].numpy(), v.numpy(), rtol=1e-2,
                atol=1e-2 * float(v.abs().max()), err_msg=f"{key} {okey}")
    for key, value in convert_variables(
            {"batch_stats": jstate.batch_stats}).items():
        np.testing.assert_allclose(live["model"][key].numpy(),
                                   value.numpy(), rtol=1e-2,
                                   atol=1e-2 * np.abs(value.numpy()).max(),
                                   err_msg=key)


def same_on_every_rank(outs):
    """Every rank's state and metrics bit-equal to rank 0's."""
    ref = TT.flat_tree(outs[0]["state"])
    for r, out in enumerate(outs[1:], 1):
        flat = TT.flat_tree(out["state"])
        bad = [k for k in ref if not torch.equal(ref[k], flat[k])]
        assert not bad, f"rank {r} differs at {bad[:4]}"
        for k, v in outs[0]["metrics"].items():
            assert torch.equal(v, out["metrics"][k]), (r, k)


def dp_step_matches_jax(tmp_path, spec, world, batch, seed):
    """One step on ``world`` gloo ranks against JAX's on make_mesh(world)
    from one converted init; returns the ranks' outputs."""
    rng = np.random.RandomState(seed)
    jmodel, tx, jstate, init = jax_state(
        spec["model"], spec.get("size", SIZE), rng,
        spec.get("geometry", "RBOX"))
    jcfg = jax_config(spec)
    mesh = make_mesh(world)
    step_fn = JT.make_train_step(jmodel, tx, jcfg, mesh)
    want_east = spec["model"].startswith("east")
    jstate, jm = step_fn(jstate, JT.device_batch(batch, mesh, want_east))

    write_inputs(tmp_path, spec, init, batch=batch)
    outs = run_ranks("step", world, tmp_path)
    same_on_every_rank(outs)
    check_against_jax(outs[0], jstate, jm, init)
    return outs


@pytest.mark.parametrize("world,grad_reduce", [(2, "mean"), (2, "sum"),
                                               (4, "mean")])
def test_dp_step_matches_jax_shard_map(tmp_path, f32_batchnorm, world,
                                       grad_reduce):
    rng = np.random.RandomState(30 + world)
    batch = scene_batch(rng, 2 * world, SIZE)
    outs = dp_step_matches_jax(tmp_path, {
        "model": "pixellink_tiny", "grad_reduce": grad_reduce}, world,
        batch, seed=world)
    assert float(outs[0]["metrics"]["n_pos"]) > 0


def test_dp_step_from_per_rank_readers_matches_jax(tmp_path, f32_batchnorm):
    icdar.make_synthetic_dataset(str(tmp_path / "scenes"), 8, (96, 128),
                                 seed=5, hard="v2")
    data = {"training_data_path": str(tmp_path / "scenes"), "batch_size": 4,
            "max_polys": 16, "min_text_size": 4, "num_workers": 1}
    cfg = Config().data
    cfg.input_size = SIZE
    for k, v in data.items():
        setattr(cfg, k, v)
    whole = ResumableLoader(cfg, seed=9)
    want = next(whole)
    whole.stop()
    parts = []
    for r in range(2):
        it = ResumableLoader(cfg, seed=9, group=DataGroup(r, 2,
                                                         torch.device("cpu")))
        parts.append(next(it))
        it.stop()
    assert parts[0]["fns"] + parts[1]["fns"] == want["fns"]
    batch = {k: np.concatenate([p[k] for p in parts])
             for k in ("images", "polys", "tags", "valid")}
    for k, v in batch.items():
        assert np.array_equal(v, want[k]), k
    outs = dp_step_matches_jax(tmp_path, {
        "model": "pixellink_tiny", "data": data, "reader": 9}, 2, batch,
        seed=12)
    assert float(outs[0]["metrics"]["n_pos"]) > 0
