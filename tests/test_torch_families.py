"""Port parity: the VGG-16, EAST and link8 families, forward and weights.

Each model's Flax variables (seeded numpy values in the shapes of
``jax.eval_shape(model.init)``, BN statistics perturbed) go through
``models/convert.py`` and load strictly into the port's model; the same
images go through both in float32 on the CPU (the JAX ConvBN's
BatchNorm in float32: the ``f32_batchnorm`` fixture). Models:
``east_resnet50``, ``link8_resnet50`` (full width and depth),
``pixellink_vgg16``, ``pixellink2s_vgg16`` (the stride-2 head),
``east_vgg16``, ``east_tiny`` with RBOX and QUAD geometry and another
``text_scale``, and a link8 ``Detector`` on the tiny backbone. Tolerance:
rtol 1e-4 (and 1e-4 of the output's largest value). The full-width
``east_resnet50``, ``east_vgg16`` and ``link8_resnet50`` trees load
strictly, every tensor exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_ocr_tpu.models import build_model as build_jax_model
from tensorflow_ocr_tpu.models.detector import Detector as JDetector
from tensorflow_ocr_tpu_torch.models import build_model, convert
from tensorflow_ocr_tpu_torch.models.detector import (
    Detector,
    model_output_stride,
)
from test_torch_bottleneck import f32_batchnorm  # noqa: F401
from test_torch_step import numpy_init

torch.set_num_threads(1)
SIZE = 64

CASES = {
    "east_resnet50": dict(name="east_resnet50"),
    "link8_resnet50": dict(name="link8_resnet50"),
    "pixellink_vgg16": dict(name="pixellink_vgg16"),
    "pixellink2s_vgg16": dict(name="pixellink2s_vgg16"),
    "east_vgg16": dict(name="east_vgg16"),
    "east_tiny_rbox": dict(name="east_tiny", text_scale=256),
    "east_tiny_quad": dict(name="east_tiny", geometry="QUAD"),
    "link8_tiny": dict(backbone_name="tiny", head_name="link8"),
}


def models(case):
    """(JAX model, port model) of a case, float32."""
    kw = dict(CASES[case])
    if "name" in kw:
        name = kw.pop("name")
        return (build_jax_model(name, dtype=jnp.float32, **kw),
                build_model(name, dtype=torch.float32, **kw))
    return (JDetector(dtype=jnp.float32, **kw),
            Detector(dtype=torch.float32, **kw))


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(f32_batchnorm, case):
    rng = np.random.RandomState(len(case))
    jmodel, model = models(case)
    variables = numpy_init(jmodel, SIZE, rng)
    model.load_state_dict(convert.convert_variables(variables), strict=True)
    images = rng.randint(0, 256, (2, SIZE, SIZE + 32, 3)).astype(np.uint8)
    want = jmodel.apply(variables, jnp.asarray(images))
    with torch.inference_mode():
        got = model(torch.from_numpy(images))
    assert set(got) == set(want)
    stride = model.output_stride
    for key, w in want.items():
        w = np.asarray(w)
        assert got[key].shape == w.shape, key
        assert w.shape[1:3] == (SIZE // stride, (SIZE + 32) // stride)
        np.testing.assert_allclose(got[key].numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=key)


@pytest.mark.parametrize("name", ["east_resnet50", "east_vgg16",
                                  "link8_resnet50"])
def test_full_width_trees_load_strictly(name):
    jmodel = build_jax_model(name, dtype=jnp.float32)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3), jnp.float32))
    rng = np.random.RandomState(0)
    variables = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    model = build_model(name, dtype=torch.float32)
    convert.load_variables(model, variables)
    state = model.state_dict()
    flat = convert.flatten_variables(variables)
    assert len(flat) == len(state)
    for key, value in flat.items():
        tkey, is_kernel = convert.torch_key(key)
        want = value.transpose(3, 2, 0, 1) if is_kernel else value
        np.testing.assert_array_equal(state[tkey].numpy(), want,
                                      err_msg=key)


def test_registry_and_output_strides():
    from tensorflow_ocr_tpu.models.detector import (
        MODEL_REGISTRY as JREG,
        model_output_stride as jstride,
    )
    from tensorflow_ocr_tpu_torch.models import detector

    MODEL_REGISTRY = detector.MODEL_REGISTRY
    assert set(MODEL_REGISTRY) == set(JREG) and len(JREG) == 16
    assert not hasattr(detector, "NOT_PORTED")
    for name in MODEL_REGISTRY:
        assert model_output_stride(name) == jstride(name), name
        assert {k: v for k, v in MODEL_REGISTRY[name].items()} == JREG[name]


# the JAX registry's models that the port did not build before the deeper
# backbones came in: each builds, on its own backbone
FORMER_NOT_PORTED = (
    "pixellink_resnet101", "east_resnet101", "pixellink_resnetv2_50",
    "east_resnetv2_50", "pixellink_resnet152", "east_resnet152",
    "pixellink_resnet200", "east_resnet200",
)


@pytest.mark.parametrize("name", FORMER_NOT_PORTED)
def test_former_unported_names_build(name):
    from tensorflow_ocr_tpu_torch.models.detector import MODEL_REGISTRY
    from tensorflow_ocr_tpu_torch.models.resnet import RESNET_UNITS, ResNetV1
    from tensorflow_ocr_tpu_torch.models.resnet_v2 import ResNetV2

    model = build_model(name, dtype=torch.float32)
    v2 = "v2" in name
    depth = int(MODEL_REGISTRY[name]["backbone_name"].split("_" if v2
                                                             else "t")[-1])
    backbone = model.backbone
    assert isinstance(backbone, ResNetV2 if v2 else ResNetV1)
    assert [len(b) for b in backbone.blocks] == list(RESNET_UNITS[depth])
    assert model.head_name == name.split("_")[0]
