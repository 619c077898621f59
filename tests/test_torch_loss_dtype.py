"""The OHEM loss's compute dtype, resolved as the JAX package resolves it.

``effective_loss_compute_dtype`` of both packages over every pairing of
``compute_dtype`` (None, "float32", "bfloat16", "float16", "float64"),
``OCR_LOSS_BF16`` (unset, "1", "true", "on", "0", "false", "off",
"TRUE", "yes", "") and the loss's name; then the OHEM loss of the train
step (``make_loss_fn``, which resolves the dtype once, when it is made)
under the settings of JAX's ``tests/test_losses.py:127-160``: the config
argument and the environment variable give bit-equal losses, the
variable overrides the argument both ways, and the loss follows JAX's
under the same setting. ``ohem_pixel_link_loss`` itself reads no
environment. Tolerances: rtol 1e-5 where the setting resolves to float32
(tests/test_torch_losses.py), 1e-2 where it resolves to bfloat16 (CE
terms rounded to bfloat16: torch rounds its softmax once, JAX each
operation).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_ocr_tpu.ops import losses as JLoss
from tensorflow_ocr_tpu_torch.config import Config
from tensorflow_ocr_tpu_torch.ops import losses as TLoss
from tensorflow_ocr_tpu_torch.train import trainer as TT
from test_torch_losses import case

torch.set_num_threads(1)

DTYPES = (None, "float32", "bfloat16", "float16", "float64")
ENVS = (None, "1", "true", "on", "0", "false", "off", "TRUE", "yes", "")
LOSSES = ("ohem", "dice", "positive", "focal", "east")


def set_env(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("OCR_LOSS_BF16", raising=False)
    else:
        monkeypatch.setenv("OCR_LOSS_BF16", value)


@pytest.mark.parametrize("env", ENVS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_effective_dtype_matches_jax(monkeypatch, env, dtype):
    set_env(monkeypatch, env)
    for loss in LOSSES:
        got = TLoss.effective_loss_compute_dtype(dtype, loss)
        assert got == JLoss.effective_loss_compute_dtype(dtype, loss), loss
    assert TLoss.effective_loss_compute_dtype(dtype) == \
        JLoss.effective_loss_compute_dtype(dtype)


def test_effective_dtype_of_dtype_objects(monkeypatch):
    """A torch dtype resolves as JAX resolves its jnp counterpart; a name
    that is no dtype raises TypeError on both sides (with the variable
    unset, where the argument is read)."""
    set_env(monkeypatch, None)
    for t, j in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32),
                 (torch.float16, jnp.float16)):
        assert TLoss.effective_loss_compute_dtype(t) == \
            JLoss.effective_loss_compute_dtype(j)
    for fn in (TLoss.effective_loss_compute_dtype,
               JLoss.effective_loss_compute_dtype):
        with pytest.raises(TypeError):
            fn("foo")


def with_grads(loss, args):
    """loss(labels, pixel logits, links, link logits, mask) -> (total,
    aux) run on the numpy ``args``: the total, the aux and the logit
    gradients."""
    labels, pl, links, ll, mask = args
    tpl = torch.from_numpy(pl).requires_grad_()
    tll = torch.from_numpy(ll).requires_grad_()
    total, aux = loss(torch.from_numpy(labels), tpl, torch.from_numpy(links),
                      tll, torch.from_numpy(mask))
    total.backward()
    return total.detach(), {k: v.detach() for k, v in aux.items()}, (
        tpl.grad, tll.grad)


def torch_loss(args, **kw):
    """The port's loss and its logit gradients."""
    return with_grads(lambda *a: TLoss.ohem_pixel_link_loss(*a, **kw), args)


def step_loss_fn(dtype):
    """The train step's loss (make_loss_fn) with loss.compute_dtype set
    to ``dtype``, made now, under the environment as it stands."""
    cfg = Config()
    cfg.loss.compute_dtype = dtype
    fn = TT.make_loss_fn(cfg)
    return lambda labels, pl, links, ll, mask: fn(
        {"pixel_logits": pl, "link_logits": ll},
        {"score": labels, "link": links, "mask": mask})


def step_loss(args, dtype):
    return with_grads(step_loss_fn(dtype), args)


def jax_loss(args, **kw):
    return JLoss.ohem_pixel_link_loss(*map(jnp.asarray, args), **kw)


# (OCR_LOSS_BF16, compute_dtype, the dtype both resolve to)
SETTINGS = ((None, None, "float32"), ("1", None, "bfloat16"),
            (None, "bfloat16", "bfloat16"), ("0", "bfloat16", "float32"),
            (None, "float16", "float32"))


@pytest.mark.parametrize("env,dtype,resolved", SETTINGS)
def test_ohem_loss_under_the_setting_matches_jax(monkeypatch, env, dtype,
                                                  resolved):
    args = case(np.random.RandomState(13), "random")
    set_env(monkeypatch, env)
    total, aux, grads = step_loss(args, dtype)
    want, jaux = jax_loss(args, compute_dtype=dtype)
    np.testing.assert_allclose(float(total), float(want),
                               rtol=1e-2 if resolved == "bfloat16" else 1e-5)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert float(aux["n_pos"]) == float(jaux["n_pos"]) > 0
    assert torch.equal(total, torch_loss(args, compute_dtype=resolved)[0])


def test_ohem_argument_and_environment_paths_are_bit_equal(monkeypatch):
    """compute_dtype="bfloat16" gives exactly OCR_LOSS_BF16=1's loss, and
    OCR_LOSS_BF16=0 forces float32 over the argument, exactly the plain
    float32 loss (tests/test_losses.py:146-160). A loss function keeps
    the dtype of the environment it was made in, and the loss itself
    reads no environment; torch.bfloat16 and "bfloat16" are one path."""
    args = case(np.random.RandomState(17), "random")
    set_env(monkeypatch, None)
    via_arg = step_loss(args, "bfloat16")
    plain = step_loss(args, "float32")
    set_env(monkeypatch, "1")
    via_env = step_loss(args, "float32")
    made_under_1 = step_loss_fn("float32")
    unread = torch_loss(args, compute_dtype=None)
    set_env(monkeypatch, "0")
    forced = step_loss(args, "bfloat16")
    kept = with_grads(made_under_1, args)
    by_object = torch_loss(args, compute_dtype=torch.bfloat16)
    for a, b in ((via_arg, via_env), (forced, plain), (kept, via_env),
                 (unread, plain), (by_object, via_arg)):
        assert torch.equal(a[0], b[0])
        assert all(torch.equal(a[1][k], b[1][k]) for k in a[1])
        assert all(torch.equal(x, y) for x, y in zip(a[2], b[2]))
    assert not torch.equal(via_arg[0], plain[0])
    # JAX's bound for the lever (tests/test_losses.py:127-143)
    np.testing.assert_allclose(float(via_env[0]), float(plain[0]), rtol=2e-2)


def test_ohem_default_dtype_is_none_and_float32(monkeypatch):
    """compute_dtype=None, JAX's default, is the float32 loss (it raised
    KeyError before); the gradient is finite."""
    set_env(monkeypatch, None)
    args = case(np.random.RandomState(19), "random")
    total, _, grads = torch_loss(args, compute_dtype=None)
    f32, _, _ = torch_loss(args, compute_dtype="float32")
    assert torch.equal(total, f32)
    jtotal, jgrad = jax.value_and_grad(
        lambda p: JLoss.ohem_pixel_link_loss(
            *map(jnp.asarray, args[:1]), p,
            *map(jnp.asarray, args[2:]))[0])(jnp.asarray(args[1]))
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgrad),
                               rtol=1e-4,
                               atol=1e-4 * float(np.abs(jgrad).max()))
