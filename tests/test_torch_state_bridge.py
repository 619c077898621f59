"""The state bridge: a JAX TrainState resumed in the port.

A JAX ``TrainState`` of pixellink_tiny at 64x64, float32 (the JAX
ConvBN's BatchNorm in float32: the ``f32_batchnorm`` fixture), after 2
steps of JAX's ``make_train_step``, goes through
``models.convert.convert_train_state`` and the port's
``restore_checkpoint``: parameters, BN statistics, EMA, Adam's moments
(or momentum's trace) and the step arrive exactly. Then one more step
runs on each side, and the two states agree within the tolerances of
tests/test_torch_step.py: parameters and EMA atol 2 * lr * steps + rtol
1e-3, BN statistics and the optimizer's moments 1e-2 (relative, and of
their largest value: float32 noise in BN over 8 values a channel moves
some gradients by tens of percent).

``scripts/export_torch_weights.py``: its ``export_train_state`` writes
an Orbax checkpoint's whole state as a port checkpoint, and a Predictor
serving it gives the logits of one built from its ``export`` .npz.
"""

import importlib.util
import os

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
from tensorflow_ocr_tpu.train.calibrate import save_operating_point
from tensorflow_ocr_tpu_torch.config import Config
from tensorflow_ocr_tpu_torch.infer import Predictor
from tensorflow_ocr_tpu_torch.models.convert import (
    convert_train_state,
    convert_variables,
)
from tensorflow_ocr_tpu_torch.train import trainer as TT
from test_torch_bottleneck import f32_batchnorm  # noqa: F401
from test_torch_step import numpy_init, scene_batch

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, LR = 64, 1e-4


def _script():
    spec = importlib.util.spec_from_file_location(
        "export_torch_weights",
        os.path.join(REPO, "scripts", "export_torch_weights.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_state(optimizer, rng, steps, batch):
    jcfg = JConfig()
    jcfg.model.name = "pixellink_tiny"
    jcfg.data.input_size = SIZE
    jcfg.train.optimizer = optimizer
    jcfg.train.donate_state = False
    jmodel = build_jax_model("pixellink_tiny", dtype=jnp.float32)
    variables = numpy_init(jmodel, SIZE, rng)
    tx = JOptim.make_optimizer(jcfg.train,
                               weight_decay=jcfg.model.weight_decay)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = JT.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]),
        opt_state=tx.init(params), ema_params=params)
    mesh = make_mesh(1)
    step_fn = JT.make_train_step(jmodel, tx, jcfg, mesh)
    dbatch = JT.device_batch(batch, mesh, want_east=False)
    for _ in range(steps):
        state, _ = step_fn(state, dbatch)
    return state, step_fn, dbatch


def _port_cfg(optimizer):
    cfg = Config()
    cfg.model.name = "pixellink_tiny"
    cfg.model.compute_dtype = "float32"
    cfg.data.input_size = SIZE
    cfg.train.optimizer = optimizer
    return cfg


def _opt_trees(jstate, optimizer):
    """{port optimizer key: converted tree} of the optax state."""
    inner = jstate.opt_state[-1][0]
    if optimizer == "adam":
        return {"exp_avg": inner.mu, "exp_avg_sq": inner.nu}
    return {"momentum_buffer": inner.trace}


def close(got, want, rtol, atol, name):
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=rtol,
                               atol=atol, err_msg=name)


@pytest.mark.parametrize("optimizer", ["adam", "momentum"])
def test_converted_state_resumes_like_jax(f32_batchnorm, tmp_path,
                                          optimizer):
    rng = np.random.RandomState(3)
    batch = scene_batch(rng, 2, SIZE)
    jstate, step_fn, dbatch = _jax_state(optimizer, rng, 2, batch)

    root = str(tmp_path / "port")
    TT.write_checkpoint(root, convert_train_state(jax.device_get(jstate)))
    cfg = _port_cfg(optimizer)
    state = TT.restore_checkpoint(TT.latest_checkpoint(root),
                                  TT.create_train_state(cfg, "cpu"))
    assert int(state.step) == 2
    live = TT.state_tensors(state)
    for key, v in convert_variables({"params": jstate.params,
                                     "batch_stats": jstate.batch_stats}
                                    ).items():
        assert torch.equal(live["model"][key], v), key
    for key, v in convert_variables({"params": jstate.ema_params}).items():
        assert torch.equal(live["ema"][key], v), key
    for okey, tree in _opt_trees(jstate, optimizer).items():
        for key, v in convert_variables({"params": tree}).items():
            assert torch.equal(live["optimizer"][key][okey], v), (key, okey)
    if optimizer == "adam":
        assert all(float(s["step"]) == 2 for s in live["optimizer"].values())

    jstate, jm = step_fn(jstate, dbatch)
    m = TT.train_step(state, TT.to_device(batch, "cpu"), cfg,
                      TT.make_loss_fn(cfg))
    np.testing.assert_allclose(float(m["total_loss"]),
                               float(jm["total_loss"]), rtol=1e-2)
    assert int(state.step) == int(jstate.step) == 3
    live = TT.state_tensors(state)
    atol = 2 * LR * 3
    for key, v in convert_variables({"params": jstate.params}).items():
        close(live["model"][key], v, 1e-3, atol, key)
    for key, v in convert_variables({"params": jstate.ema_params}).items():
        close(live["ema"][key], v, 1e-3, atol, key)
    for key, v in convert_variables({"batch_stats": jstate.batch_stats}
                                    ).items():
        close(live["model"][key], v, 1e-2, 1e-2 * float(v.abs().max()), key)
    for okey, tree in _opt_trees(jstate, optimizer).items():
        for key, v in convert_variables({"params": tree}).items():
            close(live["optimizer"][key][okey], v, 1e-2,
                  1e-2 * float(v.abs().max()), f"{key} {okey}")


def test_exported_train_state_serves_like_the_npz(tmp_path):
    """export_torch_weights.py: the Orbax checkpoint's whole state as a
    port checkpoint (its operating point copied) serves the logits of the
    .npz export of the same checkpoint."""
    rng = np.random.RandomState(4)
    jstate, _, _ = _jax_state("adam", rng, 1, scene_batch(rng, 2, SIZE))
    ema = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + rng.randn(*p.shape).astype(np.float32)
        * 0.05, jstate.ema_params)
    jstate = jstate.replace(ema_params=ema)
    ckpt = str(tmp_path / "jax")
    JT.save_checkpoint(ckpt, jstate)
    save_operating_point(ckpt, {"pixel": 0.61, "link": 0.42})

    script = _script()
    npz = script.export("pixellink_tiny", ckpt, str(tmp_path / "w.npz"))
    out = str(tmp_path / "port")
    d = script.export_train_state("pixellink_tiny", ckpt, out)
    assert d == os.path.join(out, "ckpt_1")
    a = Predictor("pixellink_tiny", weights=npz, device="cpu",
                  dtype=torch.float32)
    b = Predictor("pixellink_tiny", checkpoint_path=out, device="cpu",
                  dtype=torch.float32)
    assert b.calibrated and (b.pixel_thresh, b.link_thresh) == (0.61, 0.42)
    x = torch.from_numpy(rng.randint(0, 256, (2, SIZE, 96, 3)).astype(
        np.uint8))
    with torch.inference_mode():
        got, want = b.model(x), a.model(x)
    for k in want:
        assert torch.equal(got[k], want[k]), k
