"""ResNet-200: the port's parameters against JAX's tree, and a forward.

JAX's compile of a 200-layer net on the CPU takes about a minute, so its
tree is read by ``jax.eval_shape`` of ``init`` (no compile): every
Flax variable of ``pixellink_resnet200`` and ``east_resnet200`` maps
through ``models/convert.py`` onto a state_dict entry of the port's
model of the same shape (kernels HWIO -> OIHW), one to one. Then one
float32 forward of the port alone at 64^2: the output maps' shapes, and
finite values; and the fused and ghost arms build the same state_dict.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_ocr_tpu.models import build_model as build_jax_model
from tensorflow_ocr_tpu_torch.models import build_model, convert
from tensorflow_ocr_tpu_torch.models.resnet import RESNET_UNITS

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["pixellink_resnet200", "east_resnet200"])
def test_tree_and_forward(name):
    shapes = jax.eval_shape(build_jax_model(name, dtype=jnp.float32).init,
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3), jnp.float32))
    flat = convert.flatten_variables(jax.tree_util.tree_map(
        lambda s: np.zeros((0,)), shapes))
    model = build_model(name, dtype=torch.float32)
    state = model.state_dict()
    assert len(flat) == len(state)
    want = jax.tree_util.tree_leaves_with_path(shapes)
    for path, s in want:
        key = "/".join(str(getattr(p, "key", p)) for p in path)
        tkey, is_kernel = convert.torch_key(key)
        shape = tuple(s.shape)
        if is_kernel:
            shape = (shape[3], shape[2], shape[0], shape[1])
        assert tuple(state[tkey].shape) == shape, key
    assert [len(b) for b in model.backbone.blocks] == list(RESNET_UNITS[200])
    with torch.inference_mode():
        out = model(torch.randint(0, 256, (1, 64, 64, 3), dtype=torch.uint8))
    for key, t in out.items():
        assert t.shape[:3] == (1, 16, 16), key
        assert bool(torch.isfinite(t).all()), key
    for impl in ("fused", "ghost"):
        other = build_model(name, dtype=torch.float32, bottleneck_impl=impl)
        assert {k: tuple(v.shape) for k, v in other.state_dict().items()} \
            == {k: tuple(v.shape) for k, v in state.items()}
