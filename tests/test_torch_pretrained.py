"""The slim ImageNet import against the JAX package's.

``tensorflow_ocr_tpu_torch/train/pretrained.py`` against
``tensorflow_ocr_tpu/train/pretrained.py`` followed by the weight bridge
(``models/convert.py`` ``convert_variables``): a synthetic ``.npz`` of
every name of the public slim ``resnet_v1_50`` and ``vgg_16`` checkpoints
(the schemas of tests/test_pretrained_schema.py; VGG's classifier fc6-fc8
at small wrong shapes, which both sides skip as the real ones are
skipped), seeded values:

- each imported tensor is bit-equal to JAX's import after the bridge, and
  the count taken is JAX's (265 for resnet_v1_50: 53 convs and their BNs'
  four tensors; 26 for vgg_16);
- a name of the model with another shape, and a name the map does not
  know, are skipped by both and leave the tensor as it was;
- ``Trainer.setup`` with ``pretrained_model_path`` ending in ``.npz``
  takes the tensors, resets the EMA to them and prints the count.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from tensorflow_ocr_tpu.models import build_model as build_jax_model
from tensorflow_ocr_tpu.train import pretrained as JP
from tensorflow_ocr_tpu_torch.config import Config
from tensorflow_ocr_tpu_torch.models import build_model
from tensorflow_ocr_tpu_torch.models.convert import convert_variables
from tensorflow_ocr_tpu_torch.train import pretrained as P
from tensorflow_ocr_tpu_torch.train import trainer as T

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_pretrained_schema import resnet_v1_50_schema, vgg_16_schema  # noqa

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCHEMAS = {"pixellink_resnet50": resnet_v1_50_schema,
           "pixellink_vgg16": vgg_16_schema}
LOADED = {"pixellink_resnet50": 53 * 5, "pixellink_vgg16": 13 * 2}


def write_npz(path, schema, seed=0, extra=None):
    rng = np.random.RandomState(seed)
    arrays = {}
    for name, shape in schema.items():
        if any(f"/{fc}/" in name for fc in ("fc6", "fc7", "fc8")):
            shape = (1, 1, 2, 3) if name.endswith("weights") else (3,)
        arrays[name] = np.asarray(rng.randn(*shape), np.float32)
    arrays.update(extra or {})
    np.savez(path, **arrays)
    return arrays


def jax_import(model_name, path):
    """JAX's import then the bridge: (state_dict, count)."""
    shapes = jax.eval_shape(build_jax_model(model_name).init,
                            jax.random.PRNGKey(0),
                            np.zeros((1, 64, 64, 3), np.float32))
    variables = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes)
    new_vars, n = JP.import_backbone(dict(variables), path)
    return convert_variables(jax.device_get(new_vars)), n


@pytest.mark.parametrize("model_name", list(SCHEMAS))
def test_import_is_jax_s_bit_for_bit(tmp_path, model_name):
    path = str(tmp_path / "slim.npz")
    write_npz(path, SCHEMAS[model_name]())
    want, n_jax = jax_import(model_name, path)
    model = build_model(model_name, dtype=torch.float32)
    got, n = P.import_backbone(model, path)
    assert n == n_jax == LOADED[model_name]
    assert set(got) == set(model.state_dict())
    taken = [k for k, v in P.load_slim_npz(path).items()
             if k in got and v.shape == got[k].shape]
    assert len(taken) == n
    for k in taken:
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], want[k]), k
    # the model itself is left as it was
    assert not torch.equal(model.state_dict()[taken[0]], got[taken[0]])


def test_mismatched_and_unmapped_names_are_skipped_alike(tmp_path):
    name = "resnet_v1_50/block2/unit_1/bottleneck_v1/conv2/weights"
    schema = resnet_v1_50_schema()
    extra = {name: np.ones((1, 1, 128, 128), np.float32),
             "resnet_v1_50/block9/unit_1/bottleneck_v1/conv1/weights":
                 np.ones((1, 1, 64, 64), np.float32),
             "resnet_v1_50/conv1/weights/Momentum": np.ones(3, np.float32),
             "resnet_v1_50/conv1/odd_leaf": np.ones(3, np.float32)}
    path = str(tmp_path / "slim.npz")
    write_npz(path, schema, seed=1, extra=extra)
    _, n_jax = jax_import("pixellink_resnet50", path)
    model = build_model("pixellink_resnet50", dtype=torch.float32)
    got, n = P.import_backbone(model.state_dict(), path)
    assert n == n_jax == 53 * 5 - 1
    key = "backbone.block2_unit1.conv2.conv.weight"
    assert P.slim_to_torch_key(name) == (key, True)
    assert torch.equal(got[key], model.state_dict()[key])
    for skipped in list(extra)[2:] + ["global_step",
                                      "resnet_v1_50/logits/weights"]:
        assert P.slim_to_torch_key(skipped) is None
    assert P.slim_to_torch_key("vgg_16/conv3/conv3_2/biases") == \
        ("backbone.conv3_2.bias", False)


def test_trainer_setup_imports_an_npz(tmp_path, capsys):
    path = str(tmp_path / "resnet_v1_50.npz")
    arrays = write_npz(path, resnet_v1_50_schema(), seed=2)
    cfg = Config()
    cfg.model.compute_dtype = "float32"
    cfg.train.pretrained_model_path = path
    state = T.Trainer(cfg, device="cpu").setup()
    assert "warm-started 265 tensors" in capsys.readouterr().out
    sd = state.model.state_dict()
    w = arrays["resnet_v1_50/block3/unit_4/bottleneck_v1/conv2/weights"]
    assert torch.equal(sd["backbone.block3_unit4.conv2.conv.weight"],
                       torch.from_numpy(w.transpose(3, 2, 0, 1)))
    assert torch.equal(
        sd["backbone.conv1.bn.running_var"],
        torch.from_numpy(arrays["resnet_v1_50/conv1/BatchNorm/"
                                "moving_variance"]))
    for name, p in state.model.named_parameters():
        assert torch.equal(state.ema[name], p), name


def test_chip_smoke_expects_jax_s_count():
    """chip_smoke.py checks the card's import against this count."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.SLIM_LOADED == LOADED["pixellink_resnet50"]
    assert set(mod.slim_resnet_v1_50_schema()) == set(resnet_v1_50_schema())
    for k, v in resnet_v1_50_schema().items():
        assert tuple(mod.slim_resnet_v1_50_schema()[k]) == tuple(v), k
