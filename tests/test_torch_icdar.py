"""The ICDAR readers and the host-side sample against the JAX package's.

``tensorflow_ocr_tpu_torch/data/icdar.py`` against
``tensorflow_ocr_tpu/data/icdar.py`` on the same files:

- ``load_annotation`` (BOM, ``###``/``*`` tags, a missing file),
  ``gt_path_for_image``, ``get_images`` and ``ops/geometry.py``
  ``check_and_validate_polys`` exactly;
- ``crop_area`` with the same ``RandomState``: the same crop (image
  slice, polygons, tags) and the same draws left in the generator;
- ``rotate_image_and_polys``: polygons within 1e-4, the image within the
  codec's warp tolerance (1 level on 0.1% of the values);
- ``prepare_sample`` on the same file and ``RandomState`` seed, with no
  augmentation, each flag alone, all three, and a background-crop
  probability: the same outcome (a Sample or None), polygons within
  1e-4, tags and valid exactly, the EAST geometry within 1e-4; images
  within 2 levels on at most 1% of the values (a resize and a warp, each
  1 level on a fraction of the values, tests/test_torch_codec.py).
"""

import os

import numpy as np
import pytest
import torch

from tensorflow_ocr_tpu.config import DataConfig as JData
from tensorflow_ocr_tpu.data import icdar as J
from tensorflow_ocr_tpu.ops import geometry as JG
from tensorflow_ocr_tpu_torch.config import DataConfig
from tensorflow_ocr_tpu_torch.data import icdar as T
from tensorflow_ocr_tpu_torch.ops import geometry as G

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("icdar")
    T.make_synthetic_dataset(str(d), 3, (240, 320), seed=1, hard="v2")
    T.make_synthetic_dataset(str(d), 2, (200, 300), seed=2,
                             start_index=3)
    return str(d)


def test_readers_match_jax(dataset, tmp_path):
    assert T.get_images(dataset) == J.get_images(dataset)
    for fn in T.get_images(dataset):
        gt = T.gt_path_for_image(fn)
        assert gt == J.gt_path_for_image(fn)
        for a, b in zip(T.load_annotation(gt), J.load_annotation(gt)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    odd = tmp_path / "gt_odd.txt"
    odd.write_text("﻿1,2,3,4,5,6,7,8,###\n\n9, 10 ,11,12,13,14,15,16,"
                   "a,b\n1,1,2,2,3,3,4,4,*\n", encoding="utf-8")
    for a, b in zip(T.load_annotation(str(odd)), J.load_annotation(
            str(odd))):
        assert np.array_equal(a, b)
    for a, b in zip(T.load_annotation(str(tmp_path / "none.txt")),
                    J.load_annotation(str(tmp_path / "none.txt"))):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert T.load_annoataion is T.load_annotation


def test_check_and_validate_polys_matches_jax():
    rng = np.random.RandomState(0)
    polys = (rng.rand(20, 4, 2) * 140 - 20).astype(np.float32)
    polys[3] = polys[3, :1]  # degenerate: area 0
    tags = rng.rand(20) < 0.3
    for size in ((100, 120), (50, 200)):
        for a, b in zip(G.check_and_validate_polys(polys, tags, size),
                        JG.check_and_validate_polys(polys, tags, size)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    empty = G.check_and_validate_polys(np.zeros((0, 4, 2)), [], (5, 5))
    assert empty[0].shape == (0, 4, 2)


@pytest.mark.parametrize("background", [False, True])
def test_crop_area_matches_jax(dataset, background):
    for k, fn in enumerate(T.get_images(dataset)):
        im = T.codec.imread(fn)
        polys, tags = T.load_annotation(T.gt_path_for_image(fn))
        polys, tags = G.check_and_validate_polys(polys, tags, im.shape[:2])
        a, b = np.random.RandomState(k), np.random.RandomState(k)
        got = T.crop_area(im, polys, tags, crop_background=background,
                          rng=a)
        want = J.crop_area(im, polys, tags, crop_background=background,
                           rng=b)
        for x, y in zip(got, want):
            assert np.array_equal(x, y)
        assert a.randint(1 << 30) == b.randint(1 << 30)


@pytest.mark.parametrize("deg", [-10.0, 3.3, 7.5])
def test_rotate_image_and_polys_matches_jax(dataset, deg):
    fn = T.get_images(dataset)[0]
    im = T.codec.imread(fn)
    polys, _ = T.load_annotation(T.gt_path_for_image(fn))
    ti, tp = T.rotate_image_and_polys(im, polys, deg)
    ji, jp = J.rotate_image_and_polys(im, polys, deg)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-4)
    d = np.abs(ti.astype(int) - ji)
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3


FLAGS = {
    "none": {}, "scale": dict(use_random_scale=True),
    "rotate": dict(use_rotate=True), "crop": dict(use_crop=True),
    "all": dict(use_random_scale=True, use_rotate=True, use_crop=True),
    "background": dict(use_crop=True, background_ratio=0.5)}


@pytest.mark.parametrize("flags", list(FLAGS))
@pytest.mark.parametrize("want_east", [False, True])
def test_prepare_sample_matches_jax(dataset, flags, want_east):
    jcfg, tcfg = JData(), DataConfig()
    for c in (jcfg, tcfg):
        c.input_size, c.max_polys = 96, 16
        for k, v in FLAGS[flags].items():
            setattr(c, k, v)
    outcomes = []
    for seed in range(3):
        for fn in T.get_images(dataset):
            a, b = np.random.RandomState(seed), np.random.RandomState(seed)
            got = T.prepare_sample(fn, tcfg, a, want_east=want_east)
            want = J.prepare_sample(fn, jcfg, b, want_east=want_east)
            assert (got is None) == (want is None), (fn, seed)
            assert a.randint(1 << 30) == b.randint(1 << 30)
            outcomes.append(got is None)
            if got is None:
                continue
            assert got.image.shape == want.image.shape == (96, 96, 3)
            d = np.abs(got.image.astype(int) - want.image)
            assert d.max() <= 2 and (d > 0).mean() <= 0.01, (fn, seed)
            for key in ("polys", "shrunk", "rects", "angles"):
                np.testing.assert_allclose(getattr(got, key),
                                           getattr(want, key), rtol=0,
                                           atol=1e-4, err_msg=key)
            for key in ("tags", "valid"):
                assert np.array_equal(getattr(got, key), getattr(want, key))
            assert got.fn == want.fn == fn
    assert not all(outcomes)


def test_decode_cache_is_bounded_and_per_path(dataset, monkeypatch):
    monkeypatch.setattr(T, "_DECODE_CACHE", {})
    monkeypatch.setattr(T, "_DECODE_CACHE_MAX", 2)
    files = T.get_images(dataset)
    first = T._read_image(files[0], True)
    assert T._read_image(files[0], True) is first
    for fn in files[1:]:
        T._read_image(fn, True)
    assert len(T._DECODE_CACHE) == 2 and files[0] not in T._DECODE_CACHE
    assert T._read_image(files[0], False) is not first
    assert T._read_image(os.path.join(dataset, "none.jpg"), True) is None
