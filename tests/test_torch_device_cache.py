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
nvJPEG batch loader is its plain version, which equals the Python path;
as on the card, a PNG is decoded by the codec (as JAX's native stage
reads it with cv::imread) and a JPEG the decoder refuses raises; staging
from a batch loader leaves out what it did not decode (a missing file),
as JAX's native stage does.
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


def _png_beside(jpg, path):
    """A PNG of ``jpg``'s pixels at ``path``, with a copy of its gt file."""
    codec.imwrite(path, codec.imread(jpg))
    with open(icdar.gt_path_for_image(jpg)) as a, open(
            icdar.gt_path_for_image(path), "w") as b:
        b.write(a.read())
    return path


def test_staging_leaves_out_what_the_loader_did_not_decode(dataset,
                                                          tmp_path, capsys):
    """A PNG is staged, decoded and resized by the codec (cv::imread and
    cv::resize in JAX's native stage); a missing file is left out."""
    files = icdar.get_images(dataset)
    png = _png_beside(files[0], str(tmp_path / "img_9.png"))
    paths = [files[0], files[1] + ".missing", png, *files[1:]]
    _, tcfg = _configs(dataset)
    loaded = load_batch(paths, 128, 128, "cpu")
    assert loaded[1].tolist() == [True, False, True] + [True] * 4
    want = codec.resize(codec.imread(png), (128, 128))[:, :, ::-1]
    assert np.array_equal(loaded[0][2].numpy(), want)
    assert tuple(loaded[2][2]) == codec.imread(png).shape[:2]
    samples = stage_loaded(paths, *loaded, tcfg, False)
    assert [s.fn for s in samples] == [files[0], png, *files[1:]]
    assert "did not decode 1 of 7 files" in capsys.readouterr().out
    tds = DeviceDataset(tcfg, device="cpu")
    for s, want in zip([samples[0], *samples[2:]], tds.images):
        assert np.array_equal(s.image.numpy(), want.numpy())
    # the PNG holds the JPEG's decoded pixels: the same frame staged
    assert np.array_equal(samples[1].image.numpy(),
                          samples[0].image.numpy())


def test_a_jpeg_png_directory_stages_both_as_jax_does(dataset, tmp_path):
    """One JPEG and one PNG: the port's DeviceDataset on the CPU (the
    Python path) and its batch-loader stage (``_stage_nvjpeg``, the
    loader's plain version here) both stage the two frames, as JAX's
    DeviceDataset does on the same directory."""
    import shutil

    src = icdar.get_images(dataset)
    d = tmp_path / "mixed"
    d.mkdir()
    jpg = str(d / "img_1.jpg")
    shutil.copy(src[1], jpg)
    shutil.copy(icdar.gt_path_for_image(src[1]), icdar.gt_path_for_image(jpg))
    png = _png_beside(src[0], str(d / "img_2.png"))
    jcfg, tcfg = _configs(str(d))
    jds = JDS(jcfg)
    tds = DeviceDataset(tcfg, device="cpu")
    assert jds.n == tds.n == 2 and sorted(tds.fns) == sorted([jpg, png])
    got, want = tds.images.numpy().astype(int), np.asarray(jds.images)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.01
    np.testing.assert_allclose(tds.polys.numpy(), np.asarray(jds.polys),
                               rtol=0, atol=1e-4)
    staged = tds._stage_nvjpeg(icdar.get_images(str(d)), tcfg, False)
    assert [s.fn for s in staged] == tds.fns
    for s, im in zip(staged, tds.images):
        assert np.array_equal(s.image.numpy(), im.numpy())


def test_a_jpeg_the_decoder_refuses_raises(dataset, tmp_path):
    """A file with the JPEG magic that does not decode raises, on the CPU
    as nvJPEG's refusal does on the card: it never passes for a dataset
    with one file fewer."""
    bad = tmp_path / "img_8.jpg"
    bad.write_bytes(b"\xff\xd8" + b"not a jpeg" * 16)
    files = icdar.get_images(dataset)
    with pytest.raises(RuntimeError, match="refuses"):
        load_batch([files[0], str(bad)], 64, 64, "cpu")
