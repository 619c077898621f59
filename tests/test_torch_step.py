"""The slice: the port's train step against JAX's ``make_train_step``.

``pixellink_resnet50`` at 64x64, batch 2, float32, 3 steps. The JAX side
is ``make_train_step`` on a 1-device mesh with the plain ("xla")
bottleneck; the port runs ``bottleneck_impl="fused"`` on the plain
versions of the fused kernels (13 fused units). Same converted init
(seeded numpy values in the Flax tree's shapes, BN statistics
perturbed), same batch, labels made from the polygons on both sides.
The JAX ConvBN's BatchNorm computes in float32 here (the
``f32_batchnorm`` fixture of test_torch_bottleneck.py). The freeze_bn
arm is test_torch_step_freeze_bn.py (one file each, to keep each file's
JAX compile and CPU steps within a minute).

Tolerances: the first step's losses rtol 1e-4 (float32 through ~55
layers). Later steps' losses and the BN running statistics 1e-2 (relative, and
of the largest value),
and the parameters after the steps atol 2 * lr * steps + rtol 1e-3:
at 64x64 the deepest BN layers normalise 8
values a channel, so float32 noise moves some gradients by tens of
percent and flips the sign of ~1% of them (the port's plain
"xla" arm shows the same against JAX), and Adam moves each parameter
by ~lr a step in the sign of its gradient, whatever its size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tensorflow_ocr_tpu.config import Config as JConfig
from tensorflow_ocr_tpu.models import build_model as build_jax_model
from tensorflow_ocr_tpu.parallel.mesh import make_mesh
from tensorflow_ocr_tpu.train import optim as JOptim
from tensorflow_ocr_tpu.train import trainer as JT
from tensorflow_ocr_tpu_torch.config import Config
from tensorflow_ocr_tpu_torch.models.convert import convert_variables
from tensorflow_ocr_tpu_torch.train import trainer as TT
from test_torch_bottleneck import f32_batchnorm  # noqa: F401
from test_torch_resnet import perturb_bn

torch.set_num_threads(1)
STEPS, LR, SIZE = 3, 1e-4, 64


def scene_batch(rng, b, size, k=4):
    """uint8 images with k quads each (about 1 in 5 tagged ignored)."""
    polys = np.zeros((b, k, 4, 2), np.float32)
    for i in range(b):
        for j in range(k):
            x0, y0 = rng.uniform(0, 0.6 * size, 2)
            w, h = rng.uniform(0.2, 0.4) * size, rng.uniform(0.2, 0.3) * size
            polys[i, j] = [[x0, y0], [x0 + w, y0 + 2], [x0 + w, y0 + h],
                           [x0, y0 + h - 2]]
    return {"images": rng.randint(0, 256, (b, size, size, 3)).astype(
                np.uint8),
            "polys": polys,
            "tags": rng.rand(b, k) < 0.2,
            "valid": np.ones((b, k), bool)}


def numpy_init(model, size, rng):
    """Flax variables of ``model`` with seeded numpy values: kernels
    normal / sqrt(fan_in), everything else 0, then BN perturbed (no
    compiled init)."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3)))

    def fill(path, s):
        if str(path[-1].key) == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)
        return np.zeros(s.shape, np.float32)

    return perturb_bn(jax.tree_util.tree_map_with_path(fill, shapes), rng)


def run_parity(freeze_bn: bool, steps: int = STEPS, impl: str = "fused",
               size: int = SIZE, later_rtol: float = 1e-2,
               loss_dtype: str = "float32"):
    """``steps`` steps of JAX's make_train_step against the port's
    train_step with ``bottleneck_impl=impl``, from one converted init, at
    ``size``x``size``, both with the OHEM loss's ``compute_dtype``
    ``loss_dtype``; the losses of steps after the first within
    ``later_rtol``."""
    rng = np.random.RandomState(int(freeze_bn))
    batch = scene_batch(rng, 2, size)

    jcfg = JConfig()
    jcfg.data.input_size = size
    jcfg.model.freeze_bn = freeze_bn
    jcfg.loss.compute_dtype = loss_dtype
    jcfg.train.donate_state = False
    jmodel = build_jax_model("pixellink_resnet50", dtype=jnp.float32)
    variables = numpy_init(jmodel, size, rng)
    tx = JOptim.make_optimizer(jcfg.train,
                               weight_decay=jcfg.model.weight_decay)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jstate = JT.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]),
        opt_state=tx.init(params), ema_params=params)
    mesh = make_mesh(1)
    step_fn = JT.make_train_step(jmodel, tx, jcfg, mesh)
    dbatch = JT.device_batch(batch, mesh, want_east=False)

    cfg = Config()
    cfg.data.input_size = size
    cfg.model.compute_dtype = "float32"
    cfg.model.bottleneck_impl = impl
    cfg.model.freeze_bn = freeze_bn
    cfg.loss.compute_dtype = loss_dtype
    state = TT.create_train_state(cfg, device="cpu",
                                  weights=convert_variables(variables))
    loss_fn = TT.make_loss_fn(cfg)
    tbatch = TT.to_device(batch, "cpu")

    for step in range(steps):
        jstate, jm = step_fn(jstate, dbatch)
        m = TT.train_step(state, tbatch, cfg, loss_fn)
        for key in ("total_loss", "model_loss", "pixel_loss", "link_loss"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-4 if step == 0 else later_rtol,
                                       err_msg=f"step {step} {key}")
        assert float(m["n_pos"]) == float(jm["n_pos"]) > 0
    assert state.step == int(jstate.step) == steps

    got = state.model.state_dict()
    atol = 2 * LR * steps
    for key, value in convert_variables({"params": jstate.params}).items():
        np.testing.assert_allclose(got[key].numpy(), value.numpy(),
                                   rtol=1e-3, atol=atol, err_msg=key)
    for key, value in convert_variables(
            {"batch_stats": jstate.batch_stats}).items():
        np.testing.assert_allclose(got[key].numpy(), value.numpy(),
                                   rtol=1e-2,
                                   atol=1e-2 * np.abs(value.numpy()).max(),
                                   err_msg=key)
    want_ema = convert_variables({"params": jstate.ema_params})
    for key, value in want_ema.items():
        np.testing.assert_allclose(state.ema[key].numpy(), value.numpy(),
                                   rtol=1e-3, atol=atol, err_msg=key)


def test_train_steps_match_jax_make_train_step(f32_batchnorm):
    run_parity(freeze_bn=False)
