"""The augmented multi-step dispatch against JAX's, and
``Trainer.run_device_cached`` on the CPU.

``make_multi_train_step(state, cfg, augment=True)``
(tensorflow_ocr_tpu_torch/train/trainer.py) runs its steps eagerly on the
CPU: the plain version of the card's CUDA graph, in which each step
gathers its rows, augments them (``data/device_augment.py``, keyed by
the state's step) and makes its label maps from the transformed
polygons. It is held against the JAX package's
``make_multi_train_step(augment=True)`` on a mesh of one CPU device:
pixellink_tiny at 64x64, float32 (the ``f32_batchnorm`` fixture), one
dispatch of 2 steps of batch 2 from 6 numpy scenes, random scale, crop
and rotation on, from one converted init. The draws are JAX's (the same
scales, angles and crops), so the tolerances are those of
tests/test_torch_multistep.py: the moves of the parameters and their
EMA rtol 1e-2 + atol lr / 10, Adam's moments 1e-2, losses rtol 1e-2,
the positive-pixel count exactly.

``Trainer.run_device_cached`` then trains 2 steps on a synthetic ICDAR
directory (one dispatch) with augmentation off and on: finite metrics,
the step count, and the dataset's label maps precomputed only when off.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from tensorflow_ocr_tpu.config import Config as JConfig
from tensorflow_ocr_tpu.models import build_model as build_jax_model
from tensorflow_ocr_tpu.parallel.mesh import make_mesh
from tensorflow_ocr_tpu.train import optim as JOptim
from tensorflow_ocr_tpu.train import trainer as JT
from tensorflow_ocr_tpu_torch.config import Config
from tensorflow_ocr_tpu_torch.data import icdar
from tensorflow_ocr_tpu_torch.models.convert import (
    convert_train_state,
    convert_variables,
)
from tensorflow_ocr_tpu_torch.train import trainer as TT
from test_torch_bottleneck import f32_batchnorm  # noqa: F401
from test_torch_step import numpy_init, scene_batch

torch.set_num_threads(1)
SIZE, S, LR, N = 64, 2, 1e-4, 6
AUG = dict(use_random_scale=True, use_crop=True, use_rotate=True)


def _configs():
    cfg, jcfg = Config(), JConfig()
    for c in (cfg, jcfg):
        c.model.name = "pixellink_tiny"
        c.data.input_size = SIZE
        for k, v in AUG.items():
            setattr(c.data, k, v)
    cfg.model.compute_dtype = "float32"
    jcfg.train.donate_state = False
    return cfg, jcfg


def _dataset(rng):
    b = scene_batch(rng, N, SIZE)
    k = b["polys"].shape[1]
    b.update(shrunk=np.zeros((N, k, 4, 2), np.float32),
             rects=np.zeros((N, k, 4, 2), np.float32),
             angles=np.zeros((N, k), np.float32))
    return b


def test_augmented_dispatch_matches_jax(f32_batchnorm):
    rng = np.random.RandomState(21)
    cfg, jcfg = _configs()
    data = _dataset(rng)
    idx = np.stack([rng.permutation(N)[:2] for _ in range(S)])

    jmodel = build_jax_model("pixellink_tiny", dtype=jnp.float32)
    variables = numpy_init(jmodel, SIZE, rng)
    tx = JOptim.make_optimizer(jcfg.train,
                               weight_decay=jcfg.model.weight_decay)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jstate = JT.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]),
        opt_state=tx.init(params), ema_params=params)
    mesh = make_mesh(1)
    multi_j = JT.make_multi_train_step(jmodel, tx, jcfg, mesh, augment=True)
    rep = NamedSharding(mesh, P())
    jds = {k: jax.device_put(v, rep) for k, v in data.items()}
    jstate, jm = multi_j(jstate, jds, jax.device_put(
        idx.astype(np.int32), NamedSharding(mesh, P(None, "data"))))

    init = convert_variables(variables)
    state = TT.create_train_state(cfg, "cpu", weights=init)
    multi = TT.make_multi_train_step(state, cfg, augment=True)
    m = multi(state, {k: torch.from_numpy(v) for k, v in data.items()},
              torch.from_numpy(idx))
    assert int(state.step) == int(jstate.step) == S
    for key in ("total_loss", "model_loss", "pixel_loss", "link_loss"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-2,
                                   err_msg=key)
    assert float(m["n_pos"]) == float(jm["n_pos"]) > 0

    live = TT.state_tensors(state)
    want = convert_train_state(jax.device_get(jstate))
    for part in ("model", "ema"):
        for key, p in state.model.named_parameters():
            moved = want[part][key] - init[key]
            np.testing.assert_allclose(
                (live[part][key] - init[key]).numpy(), moved.numpy(),
                rtol=1e-2, atol=LR / 10, err_msg=f"{part} {key}")
    for key, moments in want["optimizer"].items():
        got = live["optimizer"][key]
        for okey in ("exp_avg", "exp_avg_sq"):
            v = moments[okey]
            np.testing.assert_allclose(
                got[okey].numpy(), v.numpy(), rtol=1e-2,
                atol=1e-2 * float(v.abs().max()), err_msg=f"{key} {okey}")


def test_augmented_dispatch_refuses_precomputed_labels():
    cfg, _ = _configs()
    state = TT.create_train_state(cfg, "cpu")
    with pytest.raises(ValueError, match="precomputed"):
        TT.make_multi_train_step(state, cfg, TT.LABEL_KEYS, augment=True)


@pytest.mark.parametrize("augment", [False, True])
def test_run_device_cached_trains_on_the_cpu(tmp_path, augment, capsys):
    icdar.make_synthetic_dataset(str(tmp_path / "d"), 4, (96, 128), seed=4,
                                 hard="v2")
    cfg = Config()
    cfg.model.name = "pixellink_tiny"
    cfg.model.compute_dtype = "float32"
    cfg.data.training_data_path = str(tmp_path / "d")
    cfg.data.input_size, cfg.data.batch_size = 64, 2
    cfg.data.max_polys, cfg.data.min_text_size = 16, 4
    cfg.train.scan_steps = 2
    cfg.train.checkpoint_path = str(tmp_path / "ck")
    cfg.train.save_checkpoint_steps = 2
    if augment:
        for k, v in AUG.items():
            setattr(cfg.data, k, v)
    trainer = TT.Trainer(cfg, device="cpu")
    last = trainer.run_device_cached(2)
    assert int(trainer.state.step) == 2
    assert all(math.isfinite(v) for v in last.values())
    assert "images_per_sec_steady" not in last  # one dispatch: the first
    assert TT.latest_checkpoint(cfg.train.checkpoint_path).endswith(
        "ckpt_2")
    assert "Step 000002" in capsys.readouterr().out
