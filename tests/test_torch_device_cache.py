"""The device dataset against the JAX package's.

``tensorflow_ocr_tpu_torch/data/device_cache.py`` ``DeviceDataset`` on
the CPU (the Python path: ``prepare_sample``) against
``tensorflow_ocr_tpu/data/device_cache.py``'s on the same directory
(its native C++ stage where it is built here, else its Python path):
the same images in the same order (within the codec's resize
tolerance: 1 level on at most 1% of the values), polygons within 1e-4,
tags and valid exactly, ``arrays()`` with the same keys, shapes and
types; the precomputed label maps (PixelLink and EAST) equal but for
pixels on a polygon's edge (at most 0.5% of the map: the polygons agree
to 1e-4, not to the bit, when the frames come from another decoder);
``index_batches`` is JAX's for the same ``RandomState``. On the CPU the
nvJPEG batch loader is its plain version, which equals the Python path
and, as nvJPEG, takes JPEGs only; staging from a batch loader leaves out
what it did not decode, as JAX's native stage does.
"""

import numpy as np
import pytest
import torch

from tensorflow_ocr_tpu.config import DataConfig as JData
from tensorflow_ocr_tpu.data.device_cache import DeviceDataset as JDS
from tensorflow_ocr_tpu_torch.config import DataConfig
from tensorflow_ocr_tpu_torch.data import icdar
from tensorflow_ocr_tpu_torch.data import codec
from tensorflow_ocr_tpu_torch.data.device_cache import (DeviceDataset,
                                                        stage_loaded)
from tensorflow_ocr_tpu_torch.data.nvjpeg_loader import load_batch

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("dev")
    icdar.make_synthetic_dataset(str(d), 3, (256, 320), seed=11, hard="v2")
    icdar.make_synthetic_dataset(str(d), 2, (240, 240), seed=12,
                                 start_index=3)
    return str(d)


def _configs(path):
    j, t = JData(), DataConfig()
    for c in (j, t):
        c.training_data_path, c.input_size, c.max_polys = path, 128, 16
        c.min_text_size = 4
    return j, t


@pytest.mark.parametrize("want_east", [False, True])
def test_device_dataset_matches_jax(dataset, want_east):
    jcfg, tcfg = _configs(dataset)
    jds = JDS(jcfg, want_east=want_east, precompute_labels=True)
    tds = DeviceDataset(tcfg, want_east=want_east, precompute_labels=True,
                        device="cpu")
    assert tds.n == jds.n == 5
    ja, ta = jds.arrays(), tds.arrays()
    assert set(ja) == set(ta)
    for k in ja:
        got, want = ta[k].numpy(), np.asarray(ja[k])
        assert got.shape == want.shape, k
        if k == "images":
            assert got.dtype == np.uint8
            d = np.abs(got.astype(int) - want)
            assert d.max() <= 1 and (d > 0).mean() <= 0.01
        elif k in ("score", "link", "mask", "geo"):
            off = np.abs(got.astype(np.float64) - want).max(-1) > 1e-4
            assert off.mean() <= 5e-3, (k, off.mean())
        elif want.dtype == bool:
            assert np.array_equal(got, want), k
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4,
                                       err_msg=k)
    assert float(ta["score"].sum()) > 0
    a, b = np.random.RandomState(3), np.random.RandomState(3)
    assert np.array_equal(tds.index_batches(2, 7, a),
                          jds.index_batches(2, 7, b))


def test_plain_batch_loader_is_the_python_path(dataset):
    files = icdar.get_images(dataset)
    imgs, ok, src_hw = load_batch(files, 128, 96, "cpu")
    assert ok.all() and imgs.shape == (5, 96, 128, 3)
    for i, fn in enumerate(files):
        im = icdar.codec.imread(fn)
        assert tuple(src_hw[i]) == im.shape[:2]
        want = icdar.codec.resize(im, (128, 96))[:, :, ::-1]
        assert np.array_equal(imgs[i].numpy(), want)
    bad, ok, _ = load_batch([files[0] + ".missing"], 8, 8, "cpu")
    assert not ok[0] and not bad.any()


def test_staging_leaves_out_what_the_loader_did_not_decode(dataset,
                                                          tmp_path, capsys):
    files = icdar.get_images(dataset)
    png = str(tmp_path / "img_9.png")  # a PNG nvJPEG would not take
    codec.imwrite(png, codec.imread(files[0]))
    with open(icdar.gt_path_for_image(files[0])) as a, open(
            icdar.gt_path_for_image(png), "w") as b:
        b.write(a.read())
    paths = [files[0], files[1] + ".missing", png, *files[1:]]
    _, tcfg = _configs(dataset)
    loaded = load_batch(paths, 128, 128, "cpu")
    assert loaded[1].tolist() == [True, False, False] + [True] * 4
    samples = stage_loaded(paths, *loaded, tcfg, False)
    assert [s.fn for s in samples] == files
    assert "did not decode 2 of 7 files" in capsys.readouterr().out
    tds = DeviceDataset(tcfg, device="cpu")
    for s, want in zip(samples, tds.images):
        assert np.array_equal(s.image.numpy(), want.numpy())
