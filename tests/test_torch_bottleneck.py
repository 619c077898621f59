"""Port parity in train mode: ConvBN with batch statistics, FusedBottleneck.

Flax variables (BN statistics and affines perturbed with seeded numpy
values) go into the port; the same input and cotangent go through both,
in float32 on the CPU. The JAX ConvBN normalises in ``bn_dtype``
(bfloat16 by default, whatever the model's dtype): the ``f32_batchnorm``
fixture makes its BatchNorm compute in float32 for these tests, so that
the comparison is float32 throughout (in the bfloat16 model the port's BN
output dtype, the activation dtype, is bfloat16 as well).
Tolerances: ConvBN rtol = atol = 1e-4 (of the largest value); a
bottleneck unit 2e-4 (three convs and three normalisations in another
summation order, and the fused path's statistics come from the conv's
float32 sums where Flax takes mean and mean square separately).
"""

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_ocr_tpu.models import layers as JL
from tensorflow_ocr_tpu.models import resnet as JR
from tensorflow_ocr_tpu_torch.models import build_model
from tensorflow_ocr_tpu_torch.models import layers as TL
from tensorflow_ocr_tpu_torch.models import resnet as TR
from tensorflow_ocr_tpu_torch.models.convert import (
    convert_variables,
    load_variables,
)
from test_torch_resnet import perturb_bn

torch.set_num_threads(1)


@pytest.fixture
def f32_batchnorm(monkeypatch):
    """Flax BatchNorm modules built while this fixture is active compute
    and return float32."""
    orig = flax.linen.BatchNorm

    def batch_norm(*args, **kw):
        kw["dtype"] = jnp.float32
        return orig(*args, **kw)

    monkeypatch.setattr(flax.linen, "BatchNorm", batch_norm)


def close(got, want, tol, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max(), err_msg=name)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def grads_by_torch_key(jgrads):
    """Flax param gradients -> {state_dict key: NCHW-layout array}."""
    return {k: v.numpy() for k, v in
            convert_variables({"params": jgrads}).items()}


@pytest.mark.parametrize("k,stride,explicit_pad,relu", [
    (1, 1, False, True), (3, 1, False, True), (3, 2, True, True),
    (7, 2, True, False),
])
def test_convbn_train_matches_flax(f32_batchnorm, k, stride, explicit_pad,
                                   relu):
    rng = np.random.RandomState(k + stride)
    cin, cout = 5, 7
    x = (rng.randn(2, 11, 9, cin) * 2 + 0.5).astype(np.float32)
    g = rng.randn(2, -(-11 // stride), -(-9 // stride), cout).astype(
        np.float32)
    ref = JL.ConvBN(cout, (k, k), (stride, stride),
                    explicit_pad=explicit_pad,
                    activation=flax.linen.relu if relu else None,
                    dtype=jnp.float32)
    variables = perturb_bn(ref.init(jax.random.PRNGKey(k), jnp.asarray(x)),
                           rng)

    def fwd(params):
        return ref.apply({"params": params,
                          "batch_stats": variables["batch_stats"]},
                         jnp.asarray(x), train=True,
                         mutable=["batch_stats"])

    want, mutated = fwd(variables["params"])
    jgrads = jax.grad(lambda p: jnp.sum(fwd(p)[0] * g))(variables["params"])

    port = TL.ConvBN(cin, cout, k, stride, relu=relu,
                     explicit_pad=explicit_pad)
    load_variables(port, variables)
    got = port(nchw(x), train=True)
    close(nhwc(got), want, 1e-4, "y")
    stats = convert_variables({"batch_stats": mutated["batch_stats"]})
    for key, value in stats.items():
        close(port.state_dict()[key], value, 1e-5, key)
    (got * nchw(g)).sum().backward()
    for key, value in grads_by_torch_key(jgrads).items():
        close(dict(port.named_parameters())[key].grad, value, 1e-4, key)


def test_convbn_running_update_is_flax_not_torch():
    """Biased batch variance in the running update, momentum on the old
    value: after one step var = 0.997*v0 + 0.003*var_biased."""
    port = TL.ConvBN(1, 1, 1, relu=False)
    with torch.no_grad():
        port.conv.weight.fill_(1.0)
    x = torch.tensor([1.0, 2.0, 3.0, 6.0]).reshape(1, 1, 2, 2)
    port(x, train=True)
    np.testing.assert_allclose(port.bn.running_mean.item(),
                               0.003 * 3.0, rtol=1e-6)
    np.testing.assert_allclose(port.bn.running_var.item(),
                               0.997 + 0.003 * 3.5, rtol=1e-6)


def _unit_case(depth_in, depth, db, seed):
    rng = np.random.RandomState(seed)
    # a unit's input is a relu output: >= 0, with exact zeros
    x = np.maximum(rng.randn(2, 9, 11, depth_in), 0).astype(np.float32)
    g = rng.randn(2, 9, 11, depth).astype(np.float32)
    return rng, x, g


@pytest.mark.parametrize("depth_in,depth,db", [(16, 32, 8), (32, 32, 8)])
def test_fused_bottleneck_train_matches_jax_bottleneck(f32_batchnorm,
                                                       depth_in, depth, db):
    rng, x, g = _unit_case(depth_in, depth, db, depth_in)
    ref = JR.Bottleneck(depth, db, 1, dtype=jnp.float32)
    variables = perturb_bn(ref.init(jax.random.PRNGKey(0), jnp.asarray(x)),
                           rng)

    def loss(params, xin):
        y, mut = ref.apply({"params": params,
                            "batch_stats": variables["batch_stats"]},
                           xin, train=True, mutable=["batch_stats"])
        return jnp.sum(y * g), (y, mut)

    (_, (want, mutated)), (jgrads, jdx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables["params"],
                                            jnp.asarray(x))

    port = load_variables(TR.FusedBottleneck(depth_in, depth, db), variables)
    tx = nchw(x).requires_grad_()
    got = port(tx, train=True)
    close(nhwc(got), want, 2e-4, "y")
    for key, value in convert_variables(
            {"batch_stats": mutated["batch_stats"]}).items():
        close(port.state_dict()[key], value, 2e-4, key)
    (got * nchw(g)).sum().backward()
    for key, value in grads_by_torch_key(jgrads).items():
        close(dict(port.named_parameters())[key].grad, value, 2e-4, key)
    # where the input is exactly 0, the fused convs' prologue relu(x)
    # passes no gradient (the previous unit's relu passes none there
    # either); elsewhere dx is the same
    live = x > 0
    close(nhwc(tx.grad)[live], np.asarray(jdx)[live], 2e-4, "dx")


@pytest.mark.parametrize("depth_in,depth,db", [(16, 32, 8), (32, 32, 8)])
def test_fused_bottleneck_eval_matches_jax_bottleneck(depth_in, depth, db):
    rng, x, _ = _unit_case(depth_in, depth, db, depth_in + 1)
    ref = JR.Bottleneck(depth, db, 1, dtype=jnp.float32)
    variables = perturb_bn(ref.init(jax.random.PRNGKey(1), jnp.asarray(x)),
                           rng)
    want = ref.apply(variables, jnp.asarray(x), train=False)
    port = load_variables(TR.FusedBottleneck(depth_in, depth, db), variables)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    with torch.no_grad():
        got = port(nchw(x), train=False)
    close(nhwc(got), want, 2e-4, "y")
    for k, v in port.state_dict().items():
        assert torch.equal(v, before[k]), k  # eval leaves the stats alone


def test_fused_bottleneck_has_bottleneck_keys():
    for args in ((16, 32, 8), (32, 32, 8)):
        assert (TR.FusedBottleneck(*args).state_dict().keys()
                == TR.Bottleneck(*args, 1).state_dict().keys())
    fused = build_model("pixellink_resnet50", bottleneck_impl="fused")
    xla = build_model("pixellink_resnet50")
    assert fused.state_dict().keys() == xla.state_dict().keys()


def test_resnet50_fuses_every_stride1_unit():
    """The port's own constraint (channels a multiple of 64) takes every
    stride-1 unit of ResNet-50, block4 included: 13 of 16. "ghost" builds
    a GhostBottleneck at each of the same 13 units (which of them take
    the ghost path is decided per call: test_torch_ghost_module.py)."""
    bb = build_model("pixellink_resnet50", bottleneck_impl="fused").backbone
    fused = {n for n, m in bb.named_children()
             if isinstance(m, TR.FusedBottleneck)}
    assert len(fused) == 13
    assert not fused & {"block1_unit3", "block2_unit4", "block3_unit6"}
    ghost = TR.ResNetV1(bottleneck_impl="ghost")
    assert {n for n, m in ghost.named_children()
            if isinstance(m, TR.GhostBottleneck)} == fused
    with pytest.raises(ValueError, match="bottleneck_impl"):
        TR.ResNetV1(bottleneck_impl="dice")


def test_resnet_train_stem_pools_after_relu(f32_batchnorm):
    """Train mode runs conv, BN, relu, then the pool (resnet.py:398-408);
    the pyramid matches Flax's train-mode apply."""
    rng = np.random.RandomState(5)
    x = (rng.randn(1, 64, 64, 3) * 50).astype(np.float32)
    ref = JR.ResNetV1(units=(1, 1, 1, 1), dtype=jnp.float32)
    variables = perturb_bn(
        jax.jit(ref.init)(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    want, _ = jax.jit(lambda v, x: ref.apply(v, x, train=True,
                                             mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    port = load_variables(TR.ResNetV1(units=(1, 1, 1, 1)), variables)
    with torch.no_grad():
        got = port(nchw(x), train=True)
    for key in want:
        close(nhwc(got[key]), want[key], 2e-4, key)
