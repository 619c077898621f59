"""The H-sharded forward on gloo ranks against JAX's single-device apply.

``parallel/spatial.py``: each rank holds its rows of the image, every
conv and pool fetches its halo rows from the ranks that own them, and
the output maps are all-gathered so that every rank holds them whole.
pixellink_vgg16 at 128x64, float32 (JAX's own tests/test_spatial.py
case), 2 images: H split over 2 and 4 ranks (at stride 16 a 4-rank
shard holds 2 rows and fc6's dilation-6 3x3 reads 6 beyond each edge,
so its halo spans three ranks), and a 2x2 (data, space) grid. Every
rank's maps against JAX's ``model.apply`` on the whole batch, rtol 1e-3
and atol 1e-3 of the map's largest value (tests/test_spatial.py's 1e-3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_ocr_tpu.models import build_model as build_jax_model
from tensorflow_ocr_tpu_torch.models.convert import convert_variables
from test_torch_rank_worker import run_ranks, write_inputs
from test_torch_step import numpy_init

torch.set_num_threads(1)
_REFS = {}


def jax_reference(name, hw, seed):
    """(weights, images, JAX's maps) of ``name`` at ``hw``, 2 images,
    from a seeded numpy init; made once per model."""
    if name not in _REFS:
        rng = np.random.RandomState(seed)
        model = build_jax_model(name, dtype=jnp.float32)
        variables = numpy_init(model, max(hw), rng)
        images = (rng.rand(2, *hw, 3) * 255).astype(np.float32)
        out = model.apply(variables, jnp.asarray(images))
        _REFS[name] = (convert_variables(variables), images,
                       {k: np.asarray(v) for k, v in out.items()})
    return _REFS[name]


def check_sharded(tmp_path, name, hw, seed, world, data_axis):
    weights, images, want = jax_reference(name, hw, seed)
    write_inputs(tmp_path, {"model": name, "data_axis": data_axis}, weights,
                 images={"images": images})
    outs = run_ranks("spatial", world, tmp_path)
    for r, out in enumerate(outs):
        assert set(out["maps"]) == set(want)
        for k, v in want.items():
            got = out["maps"][k].numpy()
            assert got.shape == v.shape, (r, k)
            np.testing.assert_allclose(got, v, rtol=1e-3,
                                       atol=1e-3 * np.abs(v).max(),
                                       err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("world,data_axis", [(2, 1), (4, 1), (4, 2)])
def test_vgg_sharded_forward_matches_jax(tmp_path, world, data_axis):
    check_sharded(tmp_path, "pixellink_vgg16", (128, 64), 70, world,
                  data_axis)
