"""Port parity: ResNet-v1 bottleneck units and the backbone's pyramid.

Flax variables (initialised by JAX, then BN statistics and affines
perturbed with seeded numpy values) are loaded into the PyTorch port,
and the same input goes through both, in float32 on the CPU.
Tolerance: rtol = atol = 1e-4, for summation-order drift through a
stack of convolutions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_ocr_tpu.models import resnet as JR
from tensorflow_ocr_tpu_torch.models import resnet as TR
from tensorflow_ocr_tpu_torch.models.convert import load_variables

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)


def perturb_bn(tree, rng):
    """Copy of a Flax variable tree with random BN scale/bias/mean/var."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = perturb_bn(v, rng)
            continue
        shape = np.shape(v)
        if k == "scale":
            new = rng.uniform(0.5, 1.5, shape)
        elif k == "mean":
            new = rng.randn(*shape) * 0.1
        elif k == "var":
            new = rng.uniform(0.5, 2.0, shape)
        elif k == "bias":
            new = np.asarray(v) + rng.randn(*shape) * 0.1
        else:
            new = np.asarray(v)
        out[k] = new.astype(np.float32)
    return out


@pytest.mark.parametrize("depth_in,depth,db,stride", [
    (16, 32, 8, 1),   # projection shortcut, stride 1
    (32, 32, 8, 2),   # identity shortcut, subsampled x[:, ::2, ::2]
])
def test_bottleneck_matches_flax(depth_in, depth, db, stride):
    rng = np.random.RandomState(depth_in + stride)
    x = rng.randn(2, 10, 12, depth_in).astype(np.float32)
    ref = JR.Bottleneck(depth, db, stride, dtype=jnp.float32)
    variables = perturb_bn(ref.init(jax.random.PRNGKey(0), jnp.asarray(x)),
                           rng)
    want = np.asarray(ref.apply(variables, jnp.asarray(x)))

    port = load_variables(TR.Bottleneck(depth_in, depth, db, stride),
                          variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_resnet_v1_pyramid_matches_flax():
    rng = np.random.RandomState(3)
    x = (rng.randn(1, 64, 64, 3) * 50).astype(np.float32)
    ref = JR.ResNetV1(units=(1, 1, 1, 1), dtype=jnp.float32)
    variables = perturb_bn(
        jax.jit(ref.init)(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    want = jax.jit(ref.apply)(variables, jnp.asarray(x))

    port = load_variables(TR.ResNetV1(units=(1, 1, 1, 1)), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert sorted(got) == sorted(want) == ["pool2", "pool3", "pool4",
                                           "pool5"]
    for key in want:
        g = got[key].permute(0, 2, 3, 1).numpy()
        w = np.asarray(want[key])
        assert g.shape == w.shape, key
        assert g.shape[-1] == port.channels[key]
        np.testing.assert_allclose(g, w, err_msg=key, **TOL)


def test_resnet_v1_output_stride_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TR.ResNetV1(output_stride=16)
