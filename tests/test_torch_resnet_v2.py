"""ResNet-v2-50 (pre-activation) against the JAX model.

Seeded numpy Flax variables (the preact and postnorm BatchNorms and the
ConvBN ones perturbed) converted into the port; float32 on the CPU with
Flax's BatchNorm in float32 (the ``f32_batchnorm`` fixture: in JAX the
ConvBN's BN computes in bfloat16 whatever the model's dtype).
``pixellink_resnetv2_50`` and ``east_resnetv2_50`` at 64^2, batch 1:
every output within 1e-4 of its largest value (rtol 1e-4). One
``PreactBottleneck`` of each shortcut kind (projection from the
preactivated input at stride 1 and 2, identity strided from x) in train
mode: output and every running statistic within 2e-4 (the unit tolerance
of tests/test_torch_bottleneck.py). The full-width trees load strictly;
in a bfloat16 model the preact BN's output is bfloat16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_ocr_tpu.models import build_model as build_jax_model
from tensorflow_ocr_tpu.models import resnet_v2 as JV2
from tensorflow_ocr_tpu_torch.models import build_model, convert
from tensorflow_ocr_tpu_torch.models import resnet_v2 as TV2
import test_torch_families as FAM
from test_torch_bottleneck import f32_batchnorm  # noqa: F401
from test_torch_resnet import perturb_bn
from test_torch_step import numpy_init

torch.set_num_threads(1)
TOL = 1e-4


def close(got, want, tol, name):
    want = np.asarray(want)
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max(), err_msg=name)


@pytest.mark.parametrize("name", ["pixellink_resnetv2_50",
                                  "east_resnetv2_50"])
def test_forward_matches_jax(f32_batchnorm, name):
    rng = np.random.RandomState(len(name))
    jmodel = build_jax_model(name, dtype=jnp.float32)
    variables = numpy_init(jmodel, 64, rng)
    model = convert.load_variables(build_model(name, dtype=torch.float32),
                                   variables)
    images = rng.randint(0, 256, (1, 64, 64, 3)).astype(np.uint8)
    want = jmodel.apply(variables, jnp.asarray(images))
    with torch.inference_mode():
        got = model(torch.from_numpy(images))
    assert set(got) == set(want)
    for key in want:
        close(got[key].numpy(), want[key], TOL, key)


def unit_variables(junit, x, rng):
    shapes = jax.eval_shape(junit.init, jax.random.PRNGKey(0),
                            jnp.zeros(x.shape))

    def fill(s):
        if len(s.shape) == 4:
            return (rng.standard_normal(s.shape)
                    / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    tree = jax.tree_util.tree_map(fill, shapes)
    tree["batch_stats"] = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes["batch_stats"])
    return perturb_bn(tree, rng)


@pytest.mark.parametrize("cin,depth,stride", [(64, 256, 1), (256, 512, 2),
                                              (512, 512, 2)])
def test_preact_unit_trains_as_jax(f32_batchnorm, cin, depth, stride):
    rng = np.random.RandomState(cin + stride)
    junit = JV2.PreactBottleneck(depth, depth // 4, stride,
                                 dtype=jnp.float32)
    x = rng.standard_normal((2, 8, 12, cin)).astype(np.float32)
    variables = unit_variables(junit, x, rng)
    unit = TV2.PreactBottleneck(cin, depth, depth // 4, stride)
    unit.load_state_dict(convert.convert_variables(variables), strict=True)
    assert (unit.shortcut is None) == (cin == depth)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got_eval = unit(xt)
    close(got_eval.permute(0, 2, 3, 1).numpy(),
          junit.apply(variables, jnp.asarray(x)), TOL, "eval")
    want, upd = junit.apply(variables, jnp.asarray(x), train=True,
                            mutable=["batch_stats"])
    with torch.no_grad():
        got = unit(xt, train=True)
    close(got.permute(0, 2, 3, 1).numpy(), want, 2e-4, "train")
    live = unit.state_dict()
    stats = convert.convert_variables({"batch_stats": upd["batch_stats"]})
    assert any(k.startswith("preact.") for k in stats)
    for key, value in stats.items():
        np.testing.assert_allclose(live[key].numpy(), value.numpy(),
                                   rtol=2e-4, atol=2e-4, err_msg=key)


@pytest.mark.parametrize("name", ["pixellink_resnetv2_50",
                                  "east_resnetv2_50"])
def test_full_width_tree_loads_strictly(name):
    FAM.test_full_width_trees_load_strictly(name)


def test_preact_output_is_rounded_to_the_model_dtype():
    unit = TV2.PreactBottleneck(64, 256, 64, 1)
    seen = []
    unit.conv1.register_forward_pre_hook(
        lambda m, args: seen.append(args[0].dtype))
    x = torch.randn(1, 64, 8, 8).to(torch.bfloat16)
    assert unit(x).dtype == torch.bfloat16 and seen == [torch.bfloat16]
