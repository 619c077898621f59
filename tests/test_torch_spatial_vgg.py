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
``check_sharded`` serves the kernel arms' files too
(tests/test_torch_spatial_fused.py, _ghost.py, _route.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_ocr_tpu.models import build_model as build_jax_model
from tensorflow_ocr_tpu_torch.models.convert import convert_variables
from test_torch_rank_worker import (arm_calls, arm_model, run_ranks,
                                    write_inputs)
from test_torch_step import numpy_init

torch.set_num_threads(1)
_REFS, _PORT = {}, {}


def jax_reference(name, hw, seed, *arm):
    """(weights, images, JAX's maps) of ``name`` at ``hw``, 2 images,
    from a seeded numpy init; made once per model and ``arm`` (a key: the
    caller switches JAX's arm on around the first call)."""
    if (name, *arm) not in _REFS:
        rng = np.random.RandomState(seed)
        model = build_jax_model(name, dtype=jnp.float32)
        variables = numpy_init(model, max(hw), rng)
        images = (rng.rand(2, *hw, 3) * 255).astype(np.float32)
        out = model.apply(variables, jnp.asarray(images))
        _REFS[name, *arm] = (convert_variables(variables), images,
                             {k: np.asarray(v) for k, v in out.items()})
    return _REFS[name, *arm]


def port_reference(name, hw, seed, impl="xla", pallas_convs=False):
    """The port's own unsharded forward of the arm on jax_reference's
    weights and images (the caller sets models.layers.PALLAS_CONVS): its
    maps and what it ran (test_torch_rank_worker.arm_calls); made once per
    model and arm."""
    if (name, impl, pallas_convs) not in _PORT:
        weights, images, _ = jax_reference(name, hw, seed, impl,
                                           pallas_convs)
        model = arm_model({"model": name, "bottleneck_impl": impl}, weights)
        with torch.inference_mode(), arm_calls() as calls:
            maps = model(torch.from_numpy(images))
        _PORT[name, impl, pallas_convs] = (
            {k: v.numpy() for k, v in maps.items()}, calls)
    return _PORT[name, impl, pallas_convs]


def check_sharded(tmp_path, name, hw, seed, world, data_axis, impl="xla",
                  pallas_convs=False, unsharded=False):
    """Every rank's maps of the H-sharded forward of the arm (``impl``,
    ``pallas_convs``) against JAX's, and with ``unsharded`` against the
    port's unsharded forward of the same arm (port_reference) within
    1e-5 of the largest value. Returns what each rank wrote."""
    weights, images, want = jax_reference(name, hw, seed, impl,
                                          pallas_convs)
    port = (port_reference(name, hw, seed, impl, pallas_convs)[0]
            if unsharded else None)
    spec = {"model": name, "data_axis": data_axis, "bottleneck_impl": impl,
            "pallas_convs": pallas_convs}
    write_inputs(tmp_path, spec, weights, images={"images": images})
    outs = run_ranks("spatial", world, tmp_path)
    for r, out in enumerate(outs):
        assert set(out["maps"]) == set(want)
        for k, v in want.items():
            got = out["maps"][k].numpy()
            assert got.shape == v.shape, (r, k)
            np.testing.assert_allclose(got, v, rtol=1e-3,
                                       atol=1e-3 * np.abs(v).max(),
                                       err_msg=f"rank {r} {k}")
            if port is not None:
                np.testing.assert_allclose(
                    got, port[k], rtol=0, atol=1e-5 * np.abs(port[k]).max(),
                    err_msg=f"rank {r} {k} against the port's unsharded")
    return outs


@pytest.mark.parametrize("world,data_axis", [(2, 1), (4, 1), (4, 2)])
def test_vgg_sharded_forward_matches_jax(tmp_path, world, data_axis):
    check_sharded(tmp_path, "pixellink_vgg16", (128, 64), 70, world,
                  data_axis)
