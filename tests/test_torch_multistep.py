"""The multi-step dispatch and the device-step schedules against JAX.

``make_multi_train_step`` (tensorflow_ocr_tpu_torch/train/trainer.py) on
the CPU runs its S steps eagerly: the plain version of the card's CUDA
graph. It is held against the JAX package's ``make_multi_train_step`` on
a mesh of one CPU device: pixellink_tiny at 64x64, float32 (the JAX
ConvBN's BatchNorm in float32: the ``f32_batchnorm`` fixture), S = 3
steps of batch 2 drawn from a dataset of 6 numpy scenes with the label
maps precomputed (the port's labels are JAX's bit for bit), from one
converted init, with and without ``freeze_bn``. Compared: what the
dispatch moved each parameter and its EMA by (the value after less the
init), Adam's moments and step count, the BN statistics after the
dispatch, and the last step's metrics, including ``total_loss`` = the
last model loss + the L2 value of the parameters after the S steps.

Tolerances: the moves rtol 1e-2 + atol lr / 10 (Adam moves a parameter
by about lr a step, so a step skipped or applied with the wrong sign
misses by lr or more); Adam's moments 1e-2 (relative, and of their
largest value), as tests/test_torch_state_bridge.py; losses rtol 1e-2
after the first step, n_pos exact, BN statistics 1e-2 of their largest
value (tests/test_torch_step.py); the L2 term rtol 1e-4.

The schedules and the EMA decay, now functions of the step tensor, equal
the float versions they replace (rounded to float32) at every step
across a staircase boundary and the piecewise breakpoints.
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
from tensorflow_ocr_tpu_torch.config import Config, TrainConfig
from tensorflow_ocr_tpu_torch.models.convert import (
    convert_train_state,
    convert_variables,
)
from tensorflow_ocr_tpu_torch.train import optim as TOptim
from tensorflow_ocr_tpu_torch.train import trainer as TT
from test_torch_bottleneck import f32_batchnorm  # noqa: F401
from test_torch_step import numpy_init, scene_batch

torch.set_num_threads(1)
SIZE, S, LR, N = 64, 3, 1e-4, 6


def _configs(freeze_bn, loss_dtype="float32"):
    cfg = Config()
    cfg.model.name = "pixellink_tiny"
    cfg.model.compute_dtype = "float32"
    cfg.model.freeze_bn = freeze_bn
    cfg.loss.compute_dtype = loss_dtype
    cfg.data.input_size = SIZE
    jcfg = JConfig()
    jcfg.model.name = "pixellink_tiny"
    jcfg.model.freeze_bn = freeze_bn
    jcfg.loss.compute_dtype = loss_dtype
    jcfg.data.input_size = SIZE
    jcfg.train.donate_state = False
    return cfg, jcfg


@pytest.mark.parametrize("freeze_bn", [False, True])
def test_multi_matches_jax_make_multi_train_step(f32_batchnorm, freeze_bn):
    multi_parity(freeze_bn)


def multi_parity(freeze_bn, loss_dtype="float32"):
    """One S-step dispatch of each package from one converted init, both
    with the OHEM loss's ``compute_dtype`` ``loss_dtype``, held within the
    tolerances above."""
    rng = np.random.RandomState(10 + freeze_bn)
    cfg, jcfg = _configs(freeze_bn, loss_dtype)
    dataset = TT.device_dataset(scene_batch(rng, N, SIZE), cfg, "cpu")
    assert float(dataset["score"].sum()) > 0
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
    multi_j = JT.make_multi_train_step(jmodel, tx, jcfg, mesh,
                                       extra_keys=TT.LABEL_KEYS)
    rep = NamedSharding(mesh, P())
    jds = {k: jax.device_put(v.numpy(), rep) for k, v in dataset.items()}
    jstate, jm = multi_j(jstate, jds, jax.device_put(
        idx.astype(np.int32), NamedSharding(mesh, P(None, "data"))))

    init = convert_variables(variables)
    state = TT.create_train_state(cfg, "cpu", weights=init)
    multi = TT.make_multi_train_step(state, cfg, TT.LABEL_KEYS)
    m = multi(state, dataset, torch.from_numpy(idx))
    assert int(state.step) == int(jstate.step) == S

    for key in ("total_loss", "model_loss", "pixel_loss", "link_loss"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-2,
                                   err_msg=key)
    assert float(m["n_pos"]) == float(jm["n_pos"]) > 0
    # total_loss: the last model loss plus the L2 value AFTER the S steps
    # (JAX's total minus its model loss cancels to a few float32 ulps of
    # the loss, so the L2 values are compared themselves)
    l2 = TOptim.l2_regularization(state.model, cfg.model.weight_decay)
    assert float(m["total_loss"]) == float(m["model_loss"] + l2)
    np.testing.assert_allclose(float(l2), float(JOptim.l2_regularization(
        jstate.params, jcfg.model.weight_decay)), rtol=1e-4)

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
        assert float(got["step"]) == float(moments["step"]) == S, key
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


def test_multi_is_bound_and_refuses_augmentation():
    cfg, _ = _configs(False)
    state = TT.create_train_state(cfg, "cpu")
    # augmentation makes the labels each step: precomputed maps refused
    # (trainer.py:333-336); the augmented dispatch itself is held against
    # JAX's in tests/test_torch_step_augment.py
    with pytest.raises(ValueError, match="precomputed"):
        TT.make_multi_train_step(state, cfg, TT.LABEL_KEYS, augment=True)
    multi = TT.make_multi_train_step(state, cfg, TT.LABEL_KEYS)
    dataset = TT.device_dataset(scene_batch(np.random.RandomState(0), 2,
                                            SIZE), cfg, "cpu")
    with pytest.raises(ValueError, match="made for"):
        multi(TT.create_train_state(cfg, "cpu"), dataset,
              torch.zeros((1, 2), dtype=torch.int64))
    m = multi(state, dataset, torch.tensor([[0, 1], [1, 0]]))
    assert int(state.step) == 2 and math.isfinite(float(m["total_loss"]))


def _float_exponential(lr, steps, rate, staircase):
    def sched(step):
        p = step / steps
        if staircase:
            p = math.floor(p)
        return lr * rate ** p
    return sched


def _float_piecewise(lr, breakpoints, decays):
    rates = [lr * d for d in decays]

    def sched(step):
        out = rates[0]
        for bp, r in zip(breakpoints, rates[1:]):
            if step >= bp:
                out = r
        return out
    return sched


@pytest.mark.parametrize("kw", [
    dict(learning_rate=1e-4, lr_decay_steps=5, lr_decay_rate=0.94),
    dict(learning_rate=3e-3, lr_decay_steps=4, lr_decay_rate=0.5,
         lr_staircase=False),
    dict(learning_rate=1e-2, lr_breakpoints=(3, 7),
         lr_decays=(1.0, 0.5, 0.1)),
    dict(learning_rate=1e-2, lr_breakpoints=(2,))])
def test_device_step_schedules_equal_the_float_ones(kw):
    tcfg = TrainConfig(**kw)
    sched = TOptim.make_schedule(tcfg)
    if tcfg.lr_breakpoints:
        want = _float_piecewise(
            tcfg.learning_rate, tcfg.lr_breakpoints,
            list(tcfg.lr_decays) or [1.0] * (len(tcfg.lr_breakpoints) + 1))
    else:
        want = _float_exponential(tcfg.learning_rate, tcfg.lr_decay_steps,
                                  tcfg.lr_decay_rate, tcfg.lr_staircase)
    for step in range(13):
        got = sched(torch.tensor(step, dtype=torch.int64))
        assert got.dtype == torch.float32 and got.shape == ()
        assert float(got) == float(np.float32(want(step))), step


def test_ema_decay_and_update_equal_the_float_ones():
    base = 0.997
    gen = torch.Generator().manual_seed(0)
    params = [("a", torch.randn(5, generator=gen)),
              ("b", torch.randn(2, 3, generator=gen))]
    ema_t = {n: p * 0.5 for n, p in params}
    ema_f = {n: p * 0.5 for n, p in params}
    for step in range(20):
        d = TOptim.ema_decay(base, torch.tensor(step, dtype=torch.int64))
        assert float(d) == min(base, (1.0 + step) / (10.0 + step))
        TOptim.ema_update(ema_t, params, d)
        TOptim.ema_update(ema_f, params, float(d))
        assert all(torch.equal(ema_t[n], ema_f[n]) for n in ema_t), step


@pytest.mark.parametrize("optimizer", ["adam", "momentum"])
def test_tensor_rate_optimizer_equals_the_float_rate(monkeypatch, optimizer):
    """make_optimizer's state exists before the first step and its rate is
    a tensor set in place; Adam with capturable=True, and with fused=True
    too (the card's: the capturable device check patched to take the
    CPU), and the CPU's Adam follow torch.optim.Adam with float rates
    within float32 rounding, as does the momentum optimizer
    torch.optim.SGD, across a staircase boundary."""
    import torch.optim.adam as adam_mod

    tcfg = TrainConfig(learning_rate=1e-2, lr_decay_steps=2,
                       lr_decay_rate=0.5, optimizer=optimizer)
    sched = TOptim.make_schedule(tcfg)
    fsched = _float_exponential(1e-2, 2, 0.5, True)

    def nets():
        gen = torch.Generator().manual_seed(1)
        return [torch.nn.Conv2d(3, 4, 1) for _ in range(4)], gen

    (a, b, c, f), gen = nets()
    for m in (b, c, f):
        m.load_state_dict(a.state_dict())
    opt = TOptim.make_optimizer(a, tcfg, 1e-2)
    assert all(isinstance(g["lr"], torch.Tensor) for g in opt.param_groups)
    assert all(len(opt.state[p]) for p in a.parameters())
    groups = lambda m: [{"params": [m.weight], "weight_decay": 1e-2},  # noqa
                        {"params": [m.bias], "weight_decay": 0.0}]
    if optimizer == "adam":
        assert not opt.param_groups[0]["capturable"]
        monkeypatch.setattr(adam_mod, "_get_capturable_supported_devices",
                            lambda *a, **k: ["cpu"])
        cap = torch.optim.Adam(groups(c), lr=torch.tensor(1e-2),
                               capturable=True)
        fused = torch.optim.Adam(groups(f), lr=torch.tensor(1e-2),
                                 capturable=True, fused=True)
        ref = torch.optim.Adam(groups(b), lr=1e-2)
    else:
        cap = TOptim.MomentumSGD(groups(c), torch.tensor(1e-2), 0.9)
        for p in c.parameters():
            cap.state[p]["momentum_buffer"] = torch.zeros_like(p)
        fused = TOptim.MomentumSGD(groups(f), torch.tensor(1e-2), 0.9)
        for p in f.parameters():
            fused.state[p]["momentum_buffer"] = torch.zeros_like(p)
        ref = torch.optim.SGD(groups(b), lr=1e-2, momentum=0.9)
    for step in range(5):
        g = [torch.randn(p.shape, generator=gen) for p in a.parameters()]
        for m in (a, b, c, f):
            for p, gi in zip(m.parameters(), g):
                p.grad = gi.clone()
        for o in (opt, cap, fused):
            TOptim.set_learning_rate(o, sched(torch.tensor(step)))
        for grp in ref.param_groups:
            grp["lr"] = fsched(step)
        for o in (opt, cap, fused, ref):
            o.step()
        for m in (a, c, f):
            for p, q in zip(m.parameters(), b.parameters()):
                # float32 rounding (tests/test_torch_train.py's bounds): the
                # capturable Adam takes its bias corrections in float32
                torch.testing.assert_close(p, q, rtol=1e-5, atol=1e-6)
