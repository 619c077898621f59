"""ResNet-101 and ``output_stride`` (atrous) against the JAX models.

Seeded numpy Flax variables (BN statistics perturbed) converted into the
port; float32 on the CPU, the JAX ConvBN's BatchNorm in float32 (the
``f32_batchnorm`` fixture). ``pixellink_resnet101`` and
``east_resnet101`` at 64^2, batch 1: every output map within 1e-4 of
its largest value (rtol 1e-4). ResNet-v1-50 with ``output_stride`` 8 and
16 (JAX's ``ResNetV1(output_stride=...)``: strides become dilation of
the 3x3 once the cap is reached): the pool2..pool5 maps at 64^2, batch
2, to the same tolerance; one dilated unit (rate 2 and 4) in train mode
within 2e-4, its running statistics too. With ``bottleneck_impl``
fused or ghost an atrous unit stays a plain Bottleneck, as in JAX, and
its dilated 3x3 stays off the PALLAS_CONVS route.
(``tests/test_torch_convert.py`` loads the full-width ``east_resnet101``
tree strictly.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_ocr_tpu.models import build_model as build_jax_model
from tensorflow_ocr_tpu.models import resnet as JR
from tensorflow_ocr_tpu_torch.models import build_model, convert
from tensorflow_ocr_tpu_torch.models import resnet as TR
from test_torch_bottleneck import f32_batchnorm  # noqa: F401
from test_torch_step import numpy_init

torch.set_num_threads(1)
TOL = 1e-4


def close(got, want, name):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=TOL * np.abs(want).max(), err_msg=name)


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1)


@pytest.mark.parametrize("name", ["pixellink_resnet101", "east_resnet101"])
def test_resnet101_forward_matches_jax(f32_batchnorm, name):
    rng = np.random.RandomState(101)
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
        close(got[key], want[key], key)


@pytest.mark.parametrize("output_stride", [8, 16])
def test_output_stride_matches_jax(f32_batchnorm, output_stride):
    rng = np.random.RandomState(output_stride)
    jnet = JR.ResNetV1(units=JR.RESNET_UNITS[50], dtype=jnp.float32,
                       output_stride=output_stride)
    variables = numpy_init(jnet, 64, rng)
    net = TR.ResNetV1(TR.RESNET_UNITS[50], output_stride=output_stride)
    net.load_state_dict(convert.convert_variables(variables), strict=True)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    want = jnet.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    # the subsampling stops at the cap: pool5 at 64 / output_stride
    assert tuple(got["pool5"].shape[-2:]) == (64 // output_stride,) * 2
    for key in want:
        close(nhwc(got[key]), want[key], key)


@pytest.mark.parametrize("rate", [2, 4])
def test_dilated_unit_trains_as_jax(f32_batchnorm, rate):
    """One atrous unit in train mode (batch statistics, the running
    update): output and running statistics within 2e-4, the bottleneck
    unit tolerance of tests/test_torch_bottleneck.py. (A whole backbone
    in train mode at these sizes drifts further on either side: batch
    statistics over a few pixels amplify the summation order.)"""
    rng = np.random.RandomState(rate)
    junit = JR.Bottleneck(1024, 256, 1, rate=rate, dtype=jnp.float32)
    x = rng.standard_normal((2, 6, 7, 1024)).astype(np.float32)
    shapes = jax.eval_shape(junit.init, jax.random.PRNGKey(0),
                            jnp.zeros(x.shape))
    from test_torch_step import perturb_bn

    variables = perturb_bn(jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) / np.sqrt(
            np.prod(s.shape[:-1]))).astype(np.float32)
        if len(s.shape) == 4 else np.zeros(s.shape, np.float32), shapes),
        rng)
    unit = TR.Bottleneck(1024, 1024, 256, 1, rate)
    unit.load_state_dict(convert.convert_variables(variables), strict=True)
    want, upd = junit.apply(variables, jnp.asarray(x), train=True,
                            mutable=["batch_stats"])
    with torch.no_grad():
        got = unit(torch.from_numpy(x).permute(0, 3, 1, 2), train=True)
    tol = 2e-4
    w = np.asarray(want)
    np.testing.assert_allclose(nhwc(got).numpy(), w, rtol=tol,
                               atol=tol * np.abs(w).max())
    live = unit.state_dict()
    for key, value in convert.convert_variables(
            {"batch_stats": upd["batch_stats"]}).items():
        np.testing.assert_allclose(live[key].numpy(), value.numpy(),
                                   rtol=tol, atol=tol, err_msg=key)


def test_atrous_units_are_plain_and_undilated_route():
    """Dilated units are plain Bottlenecks whatever ``bottleneck_impl``
    says (resnet.py:436-451), and their dilated 3x3 never takes the
    PALLAS_CONVS route (pallas_conv.py:288)."""
    for impl, cls in (("fused", TR.FusedBottleneck),
                      ("ghost", TR.GhostBottleneck)):
        net = TR.ResNetV1(TR.RESNET_UNITS[50], output_stride=8,
                          bottleneck_impl=impl)
        for b, names in enumerate(net.blocks):
            for name in names:
                unit = getattr(net, name)
                rate = unit.conv2.dilation
                if b >= 2:  # blocks 3 and 4 run at the cap
                    assert rate > 1 and type(unit) is TR.Bottleneck, name
                else:
                    assert rate == 1
        assert any(isinstance(getattr(net, n), cls)
                   for n in net.blocks[0])
    conv = net.block4_unit1.conv2
    x = torch.zeros(2, 512, 8, 8, dtype=torch.bfloat16)
    from tensorflow_ocr_tpu_torch.models import layers as TL

    old = TL.PALLAS_CONVS
    TL.PALLAS_CONVS = True
    try:
        assert conv.dilation == 4 and not conv._routed(x)
        undilated = TL.ConvBN(512, 512, 3)
        assert undilated._routed(x)
    finally:
        TL.PALLAS_CONVS = old
