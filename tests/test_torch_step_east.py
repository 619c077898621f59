"""The EAST train step against JAX's ``make_train_step``, and its
multi-step dispatch.

One step of ``east_tiny`` at 64x64, batch 2, float32 (the JAX ConvBN's
BatchNorm in float32: the ``f32_batchnorm`` fixture), from one converted
init (seeded numpy values in the Flax tree's shapes, BN statistics
perturbed), on one batch of numpy scenes whose EAST geometry (shrunk
polygons, fitted rectangles, angles) comes from ``east_poly_geometry``;
labels made from the polygons on both sides. Arms: RBOX with the EAST
loss, RBOX with focal, QUAD. Compared (:func:`check_step`, as
tests/test_torch_multistep.py compares): the losses and aux values rtol
1e-4 (OHEM's eight per-direction link terms 1e-3: each sums a part of
the link loss, which holds 1e-4, and with fewer pixels); what the step moved each parameter and its EMA by, rtol 1e-2 +
atol lr / 10 (Adam moves a parameter by about lr, so a skipped step or a
sign flip misses by lr or more), where the gradient is at least 1e-2
of the tensor's largest (below, a sign that float32 noise may flip
moves the parameter the other way; the moments hold those gradients);
Adam's moments and the BN statistics 1e-2 (relative, and of their
largest value).

Then ``make_multi_train_step`` on the CPU (its eager steps) over an EAST
``device_dataset`` (the geometry precomputed on the host, the maps on
the device) against as many ``train_step`` calls on the same rows: every
state tensor and the last metrics bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_ocr_tpu.config import Config as JConfig
from tensorflow_ocr_tpu.data import icdar as JI
from tensorflow_ocr_tpu.models import build_model as build_jax_model
from tensorflow_ocr_tpu.parallel.mesh import make_mesh
from tensorflow_ocr_tpu.train import optim as JOptim
from tensorflow_ocr_tpu.train import trainer as JT
from tensorflow_ocr_tpu_torch.config import Config
from tensorflow_ocr_tpu_torch.models.convert import (
    convert_train_state,
    convert_variables,
)
from tensorflow_ocr_tpu_torch.train import trainer as TT
from test_torch_bottleneck import f32_batchnorm  # noqa: F401
from test_torch_step import numpy_init, scene_batch

torch.set_num_threads(1)
LR = 1e-4


def east_batch(rng, b, size):
    """scene_batch with the EAST geometry of its polygons."""
    batch = scene_batch(rng, b, size)
    geo = [JI.east_poly_geometry(p) for p in batch["polys"]]
    for i, key in enumerate(("shrunk", "rects", "angles")):
        batch[key] = np.stack([g[i] for g in geo])
    return batch


def configs(name, loss, geometry, size, impl="xla"):
    cfg, jcfg = Config(), JConfig()
    for c in (cfg, jcfg):
        c.model.name = name
        c.loss.name = loss
        c.data.geometry = geometry
        c.data.input_size = size
    cfg.model.compute_dtype = "float32"
    cfg.model.bottleneck_impl = impl
    jcfg.train.donate_state = False
    return cfg, jcfg


def check_step(name, loss="ohem", geometry="RBOX", size=64, impl="xla",
               seed=0):
    """One train step of the port against JAX's from one converted init
    on one batch; see the module docstring for what is compared."""
    rng = np.random.RandomState(seed)
    batch = east_batch(rng, 2, size)
    cfg, jcfg = configs(name, loss, geometry, size, impl)
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
    mesh = make_mesh(1)
    step_fn = JT.make_train_step(jmodel, tx, jcfg, mesh)
    jstate, jm = step_fn(jstate, JT.device_batch(batch, mesh,
                                                 want_east=True))

    init = convert_variables(variables)
    state = TT.create_train_state(cfg, "cpu", weights=init)
    m = TT.train_step(state, TT.to_device(batch, "cpu"), cfg,
                      TT.make_loss_fn(cfg))
    assert int(state.step) == int(jstate.step) == 1
    assert set(m) == set(jm)
    for key in m:
        rtol = 1e-3 if key.startswith("link_loss/dir") else 1e-4
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=rtol,
                                   atol=1e-7, err_msg=key)
    assert np.isfinite(float(m["total_loss"]))

    live = TT.state_tensors(state)
    want = convert_train_state(jax.device_get(jstate))
    for part in ("model", "ema"):
        for key, _ in state.model.named_parameters():
            # after one step Adam moves by lr g / (|g| + eps): where |g|
            # (the sqrt of its bias-corrected second moment) is below 1e-2
            # of the tensor's largest, the tolerance of the moments below,
            # float32 noise (or an OHEM selection tied at its threshold)
            # can flip the sign of g and the move with it: left out there
            g = torch.sqrt(want["optimizer"][key]["exp_avg_sq"] / 1e-3)
            sure = (g >= max(1e-7, 1e-2 * float(g.max()))).numpy()
            moved = (want[part][key] - init[key]).numpy()
            np.testing.assert_allclose(
                (live[part][key] - init[key]).numpy()[sure], moved[sure],
                rtol=1e-2, atol=LR / 10, err_msg=f"{part} {key}")
    for key, moments in want["optimizer"].items():
        got = live["optimizer"][key]
        assert float(got["step"]) == float(moments["step"]) == 1, key
        for okey in ("exp_avg", "exp_avg_sq"):
            v = moments[okey]
            np.testing.assert_allclose(
                got[okey].numpy(), v.numpy(), rtol=1e-2,
                atol=1e-2 * float(v.abs().max()), err_msg=f"{key} {okey}")
    for key, value in convert_variables(
            {"batch_stats": jstate.batch_stats}).items():
        np.testing.assert_allclose(live["model"][key].numpy(),
                                   value.numpy(), rtol=1e-2,
                                   atol=1e-2 * np.abs(value.numpy()).max(),
                                   err_msg=key)
    return m


@pytest.mark.parametrize("loss,geometry", [("east", "RBOX"),
                                           ("focal", "RBOX"),
                                           ("east", "QUAD")])
def test_east_step_matches_jax(f32_batchnorm, loss, geometry):
    m = check_step("east_tiny", loss, geometry)
    assert float(m["geo_loss"]) > 0


def test_east_multi_step_dispatch_equals_eager_steps():
    rng = np.random.RandomState(5)
    cfg, _ = configs("east_tiny", "east", "RBOX", 64)
    raw = scene_batch(rng, 6, 64)
    ds = TT.device_dataset(raw, cfg, "cpu")
    assert set(TT.EAST_LABEL_KEYS) <= set(ds) and ds["geo"].shape[-1] == 5
    want = TT.east_geometry(torch.from_numpy(raw["polys"]))
    for key, value in want.items():
        assert torch.equal(ds[key], value), key
    assert float(ds["score"].sum()) > 0
    idx = torch.from_numpy(np.stack([rng.permutation(6)[:2]
                                     for _ in range(3)]))
    a = TT.create_train_state(cfg, "cpu")
    b = TT.create_train_state(cfg, "cpu")
    got = TT.make_multi_train_step(a, cfg, TT.label_keys(cfg))(a, ds, idx)
    loss_fn = TT.make_loss_fn(cfg)
    keys = TT.BATCH_KEYS + TT.EAST_LABEL_KEYS
    for row in idx:
        m = TT.train_step(b, {k: ds[k][row] for k in keys}, cfg, loss_fn,
                          include_l2=False)
    la, lb = (TT.flat_tree(TT.state_tensors(s)) for s in (a, b))
    assert int(a.step) == 3
    assert [k for k in la if not torch.equal(la[k], lb[k])] == []
    for key in ("model_loss", "cls_loss", "geo_loss"):
        assert torch.equal(got[key], m[key]), key
