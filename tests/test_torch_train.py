"""Port parity: the optimizer, the EMA and the train step as a whole.

Optimizer: the same seeded numpy gradients drive optax (the JAX
package's ``make_optimizer`` chain) and the port's torch optimizer for 5
updates across a learning-rate staircase boundary; parameters and the
EMA must agree within float32 rounding (rtol 1e-5, atol 1e-6: 1e-4 of
one update of lr 1e-2, the two libraries order the Adam arithmetic
differently).

The trainer loop: logging, examples/s and the NaN abort. The whole
train step against JAX is in test_torch_step.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from tensorflow_ocr_tpu.config import TrainConfig as JTrainConfig
from tensorflow_ocr_tpu.train import optim as JOptim
from tensorflow_ocr_tpu_torch.config import Config, TrainConfig
from tensorflow_ocr_tpu_torch.models.layers import BatchNorm
from tensorflow_ocr_tpu_torch.train import optim as TOptim
from tensorflow_ocr_tpu_torch.train import trainer as TT
from test_torch_step import scene_batch

torch.set_num_threads(1)


class _Net(nn.Module):
    """Two conv kernels (decayed), a conv bias and a BN (not decayed)."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 4, 3, bias=False)
        self.bn = BatchNorm(4)
        self.head = nn.Conv2d(4, 2, 1)


def _flax_tree(tree):
    """{state_dict key: OIHW array} -> the Flax-shaped param tree."""
    return {"conv": {"kernel": tree["conv.weight"].transpose(2, 3, 1, 0)},
            "bn": {"scale": tree["bn.weight"], "bias": tree["bn.bias"]},
            "head": {"kernel": tree["head.weight"].transpose(2, 3, 1, 0),
                     "bias": tree["head.bias"]}}


@pytest.mark.parametrize("optimizer,breakpoints", [
    ("adam", ()), ("momentum", ()), ("adam", (2, 4))])
def test_optimizer_and_ema_match_optax(optimizer, breakpoints):
    rng = np.random.RandomState(len(breakpoints) + len(optimizer))
    kw = dict(learning_rate=1e-2, lr_decay_steps=3, lr_decay_rate=0.5,
              optimizer=optimizer, lr_breakpoints=breakpoints,
              lr_decays=(1.0, 0.5, 0.1) if breakpoints else ())
    wd, decay = 1e-2, 0.997
    net = _Net()
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32)))
    opt = TOptim.make_optimizer(net, TrainConfig(**kw), wd)
    ema = {n: p.detach().clone() for n, p in net.named_parameters()}

    params = _flax_tree({k: v.detach().numpy().copy()
                         for k, v in net.named_parameters()})
    params = jax.tree_util.tree_map(jnp.asarray, params)
    tx = JOptim.make_optimizer(JTrainConfig(**kw), weight_decay=wd)
    state, jema = tx.init(params), params
    sched = TOptim.make_schedule(TrainConfig(**kw))
    for step in range(5):
        grads = {k: rng.randn(*p.shape).astype(np.float32)
                 for k, p in net.named_parameters()}
        for k, p in net.named_parameters():
            p.grad = torch.from_numpy(grads[k])
        TOptim.set_learning_rate(opt, sched(step))
        opt.step()
        TOptim.ema_update(ema, net.named_parameters(),
                          TOptim.ema_decay(decay, step))
        upd, state = tx.update(jax.tree_util.tree_map(
            jnp.asarray, _flax_tree(grads)), state, params)
        params = optax.apply_updates(params, upd)
        jema = JOptim.ema_update(jema, params, JOptim.ema_decay_schedule(
            decay, jnp.asarray(step)))
        got = _flax_tree({k: v.detach().numpy()
                          for k, v in net.named_parameters()})
        got_ema = _flax_tree({k: v.numpy() for k, v in ema.items()})
        for g, w in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(params)):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
        for g, w in zip(jax.tree_util.tree_leaves(got_ema),
                        jax.tree_util.tree_leaves(jema)):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        float(TOptim.l2_regularization(net, wd)),
        float(JOptim.l2_regularization(params, wd)), rtol=1e-5)


@pytest.mark.parametrize("decay,wd", [
    (0.5, 0.0), (0.997, 1e-5), (0.1, 1e-2), (1.0, 1.0)])
def test_ema_and_l2_match_the_plain_formulas(decay, wd):
    """The multi-tensor EMA and L2 over a whole model's tree equal the
    per-parameter formulas (float32 rounding: rtol 1e-6 and 1e-5)."""
    from tensorflow_ocr_tpu_torch.models import build_model

    model = build_model("pixellink_tiny", dtype=torch.float32,
                        generator=torch.Generator().manual_seed(0))
    params = dict(model.named_parameters())
    ema = {n: p.detach() * 0.5 + 1.0 for n, p in params.items()}
    want = {n: decay * e + (1.0 - decay) * params[n].detach()
            for n, e in ema.items()}
    TOptim.ema_update(ema, model.named_parameters(), decay)
    for n in want:
        torch.testing.assert_close(ema[n], want[n], rtol=1e-6, atol=1e-6)
    l2 = wd * 0.5 * sum(float(params[n].detach().double().square().sum())
                        for n in TOptim.kernel_names(model))
    np.testing.assert_allclose(
        float(TOptim.l2_regularization(model, wd)), l2, rtol=1e-5)


def test_kernel_names_are_the_conv_weights():
    assert TOptim.kernel_names(_Net()) == ["conv.weight", "head.weight"]


def test_trainer_run_logs_and_stops_on_nan(capsys):
    cfg = Config()
    cfg.model.name = "pixellink_tiny"
    cfg.model.compute_dtype = "float32"
    cfg.data.input_size = 32
    cfg.train.log_every_steps = 2
    trainer = TT.Trainer(cfg, device="cpu")
    trainer.setup()
    batch = scene_batch(np.random.RandomState(3), 2, 32)
    last = trainer.run([batch] * 3, 3)
    assert trainer.state.step == 3 and np.isfinite(last["total_loss"])
    out = capsys.readouterr().out
    assert "Step 000000" in out and "Step 000002" in out
    assert "examples/s" in out
    bad = dict(batch, images=np.full_like(batch["images"], 0))
    with torch.no_grad():
        trainer.state.model.head.pixel_logits.weight.fill_(float("nan"))
    trainer.run(iter([bad] * 3), 3)
    assert "Loss diverged" in capsys.readouterr().out


@pytest.mark.parametrize("entry", ["create_train_state", "Trainer"])
def test_train_entry_points_default_to_the_card(entry):
    """Training runs on the card unless the caller asks for the CPU: the
    default device raises where torch sees no CUDA device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(TT, entry)(Config())


def test_train_state_refuses_unported_settings():
    """"ghost" builds and trains (one CPU step at 96x96, where block1's
    units take the ghost path); a loss the pixellink head has not raises
    ValueError, as JAX's dispatch does, and so does a geometry other than
    RBOX or QUAD."""
    from tensorflow_ocr_tpu_torch.models.resnet import GhostBottleneck

    cfg = Config()
    cfg.model.bottleneck_impl = "ghost"
    cfg.model.compute_dtype = "float32"
    cfg.data.input_size = 96
    state = TT.create_train_state(cfg, device="cpu")
    bb = state.model.backbone
    assert sum(isinstance(m, GhostBottleneck) for m in bb.children()) == 13
    before = bb.block1_unit1.conv2.conv.weight.detach().clone()
    m = TT.train_step(state, TT.to_device(
        scene_batch(np.random.RandomState(0), 1, 96), "cpu"), cfg,
        TT.make_loss_fn(cfg))
    assert np.isfinite(float(m["total_loss"])) and state.step == 1
    assert not torch.equal(before, bb.block1_unit1.conv2.conv.weight)
    cfg = Config()
    cfg.loss.name = "east"
    with pytest.raises(ValueError, match="unsupported for pixellink"):
        TT.make_loss_fn(cfg)
    cfg = Config()
    cfg.data.geometry = "POLY"
    with pytest.raises(ValueError, match="RBOX"):
        TT.create_train_state(cfg, device="cpu")


def test_loss_fn_takes_polys_or_precomputed_labels():
    """Both label inputs of make_loss_fn give the same loss: polygons
    rasterised in the step, or score/link/mask maps made beforehand."""
    from tensorflow_ocr_tpu_torch.ops.labels import pixellink_labels_stride

    cfg = Config()
    cfg.data.input_size = 32
    loss_fn = TT.make_loss_fn(cfg)
    batch = TT.to_device(scene_batch(np.random.RandomState(4), 2, 32), "cpu")
    gen = torch.Generator().manual_seed(0)
    out = {"pixel_logits": torch.randn(2, 8, 8, 2, generator=gen),
           "link_logits": torch.randn(2, 8, 8, 16, generator=gen)}
    s, l, m = pixellink_labels_stride(batch["polys"], batch["tags"],
                                      batch["valid"], 8, 8, 4, 10)
    pre = {"score": s[..., None], "link": l, "mask": m[..., None]}
    a, _ = loss_fn(out, batch)
    b, _ = loss_fn(out, pre)
    assert float(s.sum()) > 0 and torch.equal(a, b)
