"""Weight bridge: the full-width pixellink_resnet50 Flax tree -> state_dict.

The tree's shape comes from ``jax.eval_shape(model.init, ...)`` (no real
init runs); seeded numpy values fill it. Every tensor must arrive
exactly, conv kernels transposed HWIO -> OIHW, with every key on both
sides used (``load_state_dict(strict=True)``), from the nested tree and
from the flat ``.npz``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_ocr_tpu.models import build_model as build_jax_model
from tensorflow_ocr_tpu_torch.models import build_model
from tensorflow_ocr_tpu_torch.models import convert

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def resnet50_variables():
    model = build_jax_model("pixellink_resnet50", dtype=jnp.float32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3), jnp.float32))
    rng = np.random.RandomState(0)
    return jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)


def _assert_loaded(model, variables):
    state = model.state_dict()
    flat = convert.flatten_variables(variables)
    assert len(flat) == len(state)
    for key, value in flat.items():
        tkey, is_kernel = convert.torch_key(key)
        want = value.transpose(3, 2, 0, 1) if is_kernel else value
        np.testing.assert_array_equal(state[tkey].numpy(), want,
                                      err_msg=key)


def test_full_resnet50_tree_loads_exactly(resnet50_variables):
    model = build_model("pixellink_resnet50", dtype=torch.float32)
    convert.load_variables(model, resnet50_variables)
    _assert_loaded(model, resnet50_variables)
    # spot-check the names of the three kinds of leaf
    state = model.state_dict()
    assert state["backbone.conv1.conv.weight"].shape == (64, 3, 7, 7)
    assert state["backbone.block4_unit3.conv3.bn.running_var"].shape == (
        2048,)
    assert state["head.link_logits.bias"].shape == (16,)


def test_flat_npz_round_trip(resnet50_variables, tmp_path):
    path = tmp_path / "weights.npz"
    np.savez(path, **convert.flatten_variables(resnet50_variables))
    model = build_model("pixellink_resnet50", dtype=torch.float32)
    model.load_state_dict(convert.load_npz(str(path)), strict=True)
    _assert_loaded(model, resnet50_variables)


def test_unknown_variable_is_rejected():
    with pytest.raises(ValueError, match="no state_dict counterpart"):
        convert.convert_variables({"params": {"x": {"Dense_0": {
            "weights": np.zeros(3)}}}})


def test_unported_model_names_the_roadmap():
    """Every name of JAX's registry is ported now: the reference's own
    EAST model, east_resnet101 (nets/model.py:33-82), builds and loads
    converted weights strictly; an unknown name still raises."""
    import test_torch_families as FAM

    FAM.test_full_width_trees_load_strictly("east_resnet101")
    with pytest.raises(ValueError, match="unknown model"):
        build_model("no_such_model")
