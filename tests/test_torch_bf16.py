"""The bfloat16 model against JAX's bfloat16 model, on the CPU.

Every other parity test runs float32 (``compute_dtype="float32"`` and the
``f32_batchnorm`` fixture); the held-out recipe and the bench train and
serve in bfloat16, the default of both packages. Here the same converted
weights (seeded numpy values, BN perturbed: ``test_torch_step.numpy_init``)
and the same seeded uint8 images go through

- the truth: JAX's float32 model with its BatchNorm in float32,
- JAX's bfloat16 model as it ships (``dtype=jnp.bfloat16``, BN in bf16),
  jitted as every JAX caller runs it,
- the port's bfloat16 model (``build_model(..., dtype=torch.bfloat16)``),

and each bf16 side's error against the truth is read per output. The
port must round no worse than JAX where JAX rounds: its error within
``RATIO`` (1.5x) of JAX's own. The two ``*_logits`` convs are rescaled
so that the truth's eval logits have a spread of about 2, as a trained
model's do (random weights saturate the softmax).

(a) The eval forward (BN folded into the convs), ``pixellink_resnet50``
(the held-out recipe's model) and ``pixellink_tiny`` at 128^2, batch 2:
mean and max |bf16 - truth| per output within 1.5x JAX's; the mean signed
error of ``pixel_logits`` (the "less confident" symptom) and the mean
pixel probability's error within 1.5x JAX's plus 1e-4 of the scale.
Measured port/JAX ratios (pixel / link logits): resnet50 mean 1.00 /
0.97, max 1.05 / 1.04; tiny mean 0.98 / 0.99, max 0.99 / 0.90; the
signed error of the pixel logits -7.3e-5 (JAX -9.1e-5) and -2.8e-4
(-2.9e-4) of the scale; the mean pixel probability 0.95745 (JAX 0.95745,
truth 0.95725) and 0.93718 (0.93717, 0.93746).

(b) The train-mode forward (batch statistics) and the OHEM loss of that
forward, the same models and images: mean |bf16 - truth| per output
and the max within 1.5x JAX's, as in (a); the mean signed error of
``pixel_logits`` within 1.5x JAX's plus 1e-4 of the scale, as in (a)
(measured: resnet50 -8.9e-4 against JAX's -5.5e-4 of the scale, budget
9.3e-4; tiny 1.0e-4 against -2.8e-5, budget 1.4e-4; at random init the
batch statistics make the signed mean noise, JAX's own mean |error|
reading 2.1e-2 and 1.2e-3 of the scale); the loss's nine terms (the
pixel loss and the eight link directions) within 1.5x JAX's mean |error|
plus 1e-4 of their mean size, and the model loss within the sum of JAX's
term errors; the BN batch statistics that the forward writes into the
running buffers (the mean over buffers of the largest error over the
largest value) within 1.5x JAX's. Measured ratios: resnet50 mean 1.01 /
1.25, max 1.09 / 0.99, loss terms 6e-4 against JAX's 6e-4, BN 1.37;
tiny mean 1.18 / 1.21, max 1.07 / 1.24, loss terms 3.7e-4 against
2.4e-4 (both far under a bf16 step of the terms, ~2), BN 1.01.
JAX's jitted program rounds less often than its own ops run one at a
time: the same train-mode forward un-jitted reads 1.19 / 1.28x (tiny)
and 1.01 / 1.26x (resnet50) the jitted error, about the port's ratios.
The port rounds at every op, as JAX's eager ops do.

The BN running statistics after one whole train step of each side are
test_torch_bf16_step.py (one JAX train-step compile a file).
"""

import copy
from unittest import mock

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_ocr_tpu.config import Config as JConfig
from tensorflow_ocr_tpu.models import build_model as build_jax_model
from tensorflow_ocr_tpu.train import trainer as JT
from tensorflow_ocr_tpu_torch.config import Config
from tensorflow_ocr_tpu_torch.models import build_model
from tensorflow_ocr_tpu_torch.models.convert import (convert_variables,
                                                     load_variables)
from tensorflow_ocr_tpu_torch.train import trainer as TT
from test_torch_step import numpy_init, scene_batch

torch.set_num_threads(1)
SIZE, RATIO = 128, 1.5
OUTPUTS = ("pixel_logits", "link_logits")
LOSS_TERMS = ("pixel_loss",) + tuple(f"link_loss/dir{i}" for i in range(8))


def f32_batchnorm():
    """While active, Flax BatchNorm modules built at apply time compute
    and return float32 (test_torch_bottleneck.py's fixture)."""
    orig = flax.linen.BatchNorm

    def batch_norm(*args, **kw):
        kw["dtype"] = jnp.float32
        return orig(*args, **kw)

    return mock.patch.object(flax.linen, "BatchNorm", batch_norm)


def rescale_logits(variables, truth_eval):
    """``variables`` with each ``*_logits`` conv scaled so that the
    truth's eval logits have a standard deviation of 2."""
    out = copy.deepcopy(variables)
    head = out["params"]["head"]
    for key in OUTPUTS:
        tag = key.split("_")[0]
        s = 2.0 / float(np.std(np.asarray(truth_eval[key])))
        conv = head[f"{tag}_logits"]
        conv["kernel"] = (conv["kernel"] * s).astype(np.float32)
        conv["bias"] = (conv["bias"] * s).astype(np.float32)
    return out


@pytest.fixture(scope="module", params=["pixellink_resnet50",
                                        "pixellink_tiny"])
def sides(request):
    """{"truth"|"jax"|"port": {"eval": outputs, "train": outputs,
    "stats": BN buffers after the train-mode forward, "loss": aux}}, and
    the batch."""
    name = request.param
    rng = np.random.RandomState(16)
    j32 = build_jax_model(name, dtype=jnp.float32)
    j16 = build_jax_model(name, dtype=jnp.bfloat16)
    variables = numpy_init(j32, SIZE, rng)
    batch = scene_batch(rng, 2, SIZE)
    x = jnp.asarray(batch["images"])

    def train_apply(model):
        return jax.jit(lambda v, im: model.apply(
            v, im, train=True, mutable=["batch_stats"]))

    with f32_batchnorm():
        eval32, train32 = jax.jit(j32.apply), train_apply(j32)
        variables = rescale_logits(variables, eval32(variables, x))
        out = {"truth": (eval32(variables, x), *train32(variables, x))}
    out["jax"] = (jax.jit(j16.apply)(variables, x),
                  *train_apply(j16)(variables, x))

    jcfg = JConfig()
    jcfg.model.name = name
    jcfg.data.input_size = SIZE
    jloss = jax.jit(JT.make_loss_fn(jcfg))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    res = {}
    for side, (ev, tr, new_vars) in out.items():
        model_loss, aux = jloss(tr, jbatch)
        res[side] = {
            "eval": {k: np.asarray(ev[k], np.float64) for k in OUTPUTS},
            "train": {k: np.asarray(tr[k], np.float64) for k in OUTPUTS},
            "stats": {k: v.numpy().astype(np.float64) for k, v in
                      convert_variables(new_vars).items()},
            "loss": {"model_loss": float(model_loss),
                     **{k: float(v) for k, v in aux.items()}},
        }

    cfg = Config()
    cfg.model.name = name
    cfg.data.input_size = SIZE
    port = load_variables(build_model(name, dtype=torch.bfloat16),
                          variables)
    images = torch.from_numpy(batch["images"])
    with torch.no_grad():
        ev = port.eval()(images)
        tr = port.train()(images, train=True)
        model_loss, aux = TT.make_loss_fn(cfg)(tr, TT.to_device(batch,
                                                                "cpu"))
    state = port.state_dict()
    res["port"] = {
        "eval": {k: ev[k].double().numpy() for k in OUTPUTS},
        "train": {k: tr[k].double().numpy() for k in OUTPUTS},
        "stats": {k: state[k].double().numpy()
                  for k in res["truth"]["stats"]},
        "loss": {"model_loss": float(model_loss),
                 **{k: float(v) for k, v in aux.items()}},
    }
    return name, res


def errors(res, mode, key):
    """(port error, JAX error, scale) of one output against the truth."""
    t = res["truth"][mode][key]
    return (res["port"][mode][key] - t, res["jax"][mode][key] - t,
            np.abs(t).max())


def pixel_prob(logits):
    """Mean softmax probability of the text class."""
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return float((e[..., 1] / e.sum(-1)).mean())


def test_eval_forward_rounds_as_jax_does(sides):
    name, res = sides
    for key in OUTPUTS:
        pe, je, scale = errors(res, "eval", key)
        mean_r = np.abs(pe).mean() / np.abs(je).mean()
        max_r = np.abs(pe).max() / np.abs(je).max()
        print(f"{name} eval {key}: mean |err| port/JAX {mean_r:.3f}, max "
              f"{max_r:.3f}; signed port {pe.mean() / scale:.3e}, JAX "
              f"{je.mean() / scale:.3e} of the scale {scale:.3f}")
        assert mean_r <= RATIO and max_r <= RATIO, key
    pe, je, scale = errors(res, "eval", "pixel_logits")
    assert abs(pe.mean()) <= RATIO * abs(je.mean()) + 1e-4 * scale
    probs = {s: pixel_prob(res[s]["eval"]["pixel_logits"]) for s in res}
    print(f"{name} eval mean pixel probability {probs}")
    assert (abs(probs["port"] - probs["truth"])
            <= RATIO * abs(probs["jax"] - probs["truth"]) + 1e-4)


def test_train_forward_and_loss_round_as_jax_does(sides):
    name, res = sides
    for key in OUTPUTS:
        pe, je, scale = errors(res, "train", key)
        mean_r = np.abs(pe).mean() / np.abs(je).mean()
        max_r = np.abs(pe).max() / np.abs(je).max()
        print(f"{name} train {key}: mean |err| port/JAX {mean_r:.3f}, max "
              f"{max_r:.3f}; signed port {pe.mean() / scale:.3e}, JAX "
              f"{je.mean() / scale:.3e}, JAX mean |err| "
              f"{np.abs(je).mean() / scale:.3e} of the scale {scale:.3f}")
        assert mean_r <= RATIO and max_r <= RATIO, key
    pe, je, scale = errors(res, "train", "pixel_logits")
    assert abs(pe.mean()) <= RATIO * abs(je.mean()) + 1e-4 * scale

    loss = {s: res[s]["loss"] for s in res}
    perr = np.array([loss["port"][k] - loss["truth"][k] for k in LOSS_TERMS])
    jerr = np.array([loss["jax"][k] - loss["truth"][k] for k in LOSS_TERMS])
    print(f"{name} loss terms |err| port {np.abs(perr).mean():.4f}, JAX "
          f"{np.abs(jerr).mean():.4f}; model loss truth "
          f"{loss['truth']['model_loss']:.4f}, port "
          f"{loss['port']['model_loss']:.4f}, JAX "
          f"{loss['jax']['model_loss']:.4f}")
    scale = np.mean([abs(loss["truth"][k]) for k in LOSS_TERMS])
    assert np.abs(perr).mean() <= RATIO * np.abs(jerr).mean() + 1e-4 * scale
    assert (abs(loss["port"]["model_loss"] - loss["truth"]["model_loss"])
            <= np.abs(jerr).sum())
    assert loss["port"]["n_pos"] == loss["truth"]["n_pos"] > 0

    st = {s: res[s]["stats"] for s in res}
    rel = {s: np.mean([np.abs(st[s][k] - st["truth"][k]).max()
                       / np.abs(st["truth"][k]).max() for k in st["truth"]])
           for s in ("port", "jax")}
    print(f"{name} BN buffers after the forward, mean max-rel error: {rel}")
    assert rel["port"] <= RATIO * rel["jax"]
