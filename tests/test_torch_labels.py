"""Port parity: rasterization and PixelLink training labels, bit-exact.

Seeded numpy polygons (rotated quads, overlapping ones, ignored ones,
padding rows, quads too small for ``min_text_size``, quads across the map
border) go through the JAX functions image by image and through the
port's batched functions; instance ids, score, link and mask maps must be
equal element for element.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_ocr_tpu.ops import labels as JLab
from tensorflow_ocr_tpu.ops import rasterize as JRas
from tensorflow_ocr_tpu_torch.ops import labels as TLab
from tensorflow_ocr_tpu_torch.ops import rasterize as TRas

torch.set_num_threads(1)


def random_polys(rng, b, k, size):
    polys = np.zeros((b, k, 4, 2), np.float32)
    valid = np.zeros((b, k), bool)
    for i in range(b):
        n = rng.randint(1, k + 1)
        for j in range(n):
            cx, cy = rng.uniform(-0.1, 1.1, 2) * size
            w, h = rng.uniform(0.02, 0.5, 2) * size
            th = rng.uniform(-np.pi, np.pi)
            rot = np.array([[np.cos(th), -np.sin(th)],
                            [np.sin(th), np.cos(th)]])
            box = np.array([[-w, -h], [w, -h], [w, h], [-w, h]]) / 2
            polys[i, j] = box @ rot.T + (cx, cy)
        valid[i, :n] = True
    ignored = rng.rand(b, k) < 0.2
    return polys, ignored, valid


@pytest.mark.parametrize("seed,hw", [(0, (24, 32)), (1, (17, 13))])
def test_rasterize_instances_bit_exact(seed, hw):
    rng = np.random.RandomState(seed)
    polys, _, valid = random_polys(rng, 3, 6, max(hw))
    got = TRas.rasterize_instances(torch.from_numpy(polys),
                                   torch.from_numpy(valid), *hw).numpy()
    assert got.dtype == np.int32
    for i in range(3):
        want = np.asarray(JRas.rasterize_instances(
            jnp.asarray(polys[i]), jnp.asarray(valid[i]), *hw))
        np.testing.assert_array_equal(got[i], want)
    assert (got > 0).any() and (got == 0).any()


def test_link_map_bit_exact():
    rng = np.random.RandomState(2)
    inst = rng.randint(0, 4, (2, 9, 11)).astype(np.int32)
    got = TLab.link_map_from_instances(torch.from_numpy(inst)).numpy()
    for i in range(2):
        want = np.asarray(JLab.link_map_from_instances(jnp.asarray(inst[i])))
        np.testing.assert_array_equal(got[i], want)


@pytest.mark.parametrize("seed,size,stride", [(3, 128, 4), (4, 96, 4),
                                              (5, 64, 2)])
def test_pixellink_labels_stride_bit_exact(seed, size, stride):
    rng = np.random.RandomState(seed)
    polys, ignored, valid = random_polys(rng, 4, 8, size)
    out = size // stride
    got = TLab.pixellink_labels_stride(
        torch.from_numpy(polys), torch.from_numpy(ignored),
        torch.from_numpy(valid), out, out, stride, 10)
    for i in range(4):
        want = JLab.pixellink_labels_stride(
            jnp.asarray(polys[i]), jnp.asarray(ignored[i]),
            jnp.asarray(valid[i]), out, out, stride, 10)
        for name, g, w in zip(("score", "link", "mask"), got, want):
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w),
                                          err_msg=name)
    score, _, mask = got
    assert score.sum() > 0 and (mask == 0).any()
