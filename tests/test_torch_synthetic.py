"""The synthetic tiers against the JAX package's.

``tensorflow_ocr_tpu_torch/data/icdar.py`` ``make_synthetic_dataset``
against ``tensorflow_ocr_tpu/data/icdar.py``'s for the default tier,
``hard=True`` (v1) and ``hard="v2"``, at 256x256 to 720x1280, two seeds:

- every ``gt_img_*.txt`` is byte-equal (the same draws in the same
  order; the min-area rectangles, box points and homographies are cv2's
  to the float32 bit, see tests/test_torch_codec.py);
- the images handed to the encoder (captured before any JPEG encoding by
  patching each module's writer) differ on at most 0.5% of their pixels
  (the default tier: none; v1 and v2 0.11% read at most: the outlines of
  polygons that cross the border, the thick distractor lines and the
  plates of straight hulls, see tests/test_torch_codec.py);
- the default tier's JPEG files decode (cv2) to the same frames; the
  ``hard="photo..."`` tiers write gt files equal to JAX's
  (tests/test_torch_photo.py holds them in full).
"""

import os

import cv2
import numpy as np
import pytest
import torch

from tensorflow_ocr_tpu.data import icdar as J
from tensorflow_ocr_tpu_torch.data import codec
from tensorflow_ocr_tpu_torch.data import icdar as T

torch.set_num_threads(1)
MAX_PIXELS_OFF = 5e-3


def _write(monkeypatch, mod, writer_owner, name, path, **kw):
    images = {}
    orig = getattr(writer_owner, name)

    def capture(fn, im, *a, **k):
        images[os.path.basename(fn)] = im.copy()
        return orig(fn, im, *a, **k)

    with monkeypatch.context() as m:
        m.setattr(writer_owner, name, capture)
        files = mod.make_synthetic_dataset(path, **kw)
    return files, images


@pytest.mark.parametrize("hard,size,n", [
    (False, (256, 256), 4), (True, (256, 320), 3), (True, (480, 640), 2),
    ("v2", (480, 640), 4), ("v2", (720, 1280), 2)])
@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_tiers_match_jax(tmp_path, monkeypatch, hard, size, n,
                                   seed):
    kw = dict(num_images=n, size=size, seed=seed, hard=hard)
    jfiles, jimgs = _write(monkeypatch, J, J.cv2, "imwrite",
                           str(tmp_path / "jax"), **kw)
    tfiles, timgs = _write(monkeypatch, T, codec, "imwrite",
                           str(tmp_path / "port"), **kw)
    assert [os.path.basename(f) for f in jfiles] == \
        [os.path.basename(f) for f in tfiles]
    for i in range(n):
        gt = f"gt_img_{i}.txt"
        with open(tmp_path / "jax" / gt, "rb") as a, \
                open(tmp_path / "port" / gt, "rb") as b:
            assert a.read() == b.read(), (gt, hard, size, seed)
        im = f"img_{i}.jpg"
        assert timgs[im].shape == (*size, 3)
        off = (np.abs(timgs[im].astype(int) - jimgs[im]).max(-1) > 0).mean()
        assert off <= MAX_PIXELS_OFF, (im, off)
        if hard is False:  # the same frame: the same JPEG
            assert off == 0
            assert np.array_equal(cv2.imread(str(tmp_path / "port" / im)),
                                  cv2.imread(str(tmp_path / "jax" / im)))


def test_start_index_continues_the_numbering(tmp_path):
    files = T.make_synthetic_dataset(str(tmp_path), 2, (128, 128),
                                     hard="v2", start_index=5)
    assert [os.path.basename(f) for f in files] == ["img_5.jpg", "img_6.jpg"]
    assert (tmp_path / "gt_img_6.txt").exists()


@pytest.mark.parametrize("hard", ["photo", "photo:val", "photo2:train"])
def test_photo_tiers_wait_for_item_5(tmp_path, hard):
    """The photo tiers, item 5's last part, are ported: a frame and its
    gt file, byte-equal to JAX's (tests/test_torch_photo.py compares
    them at larger sizes)."""
    if not all(T._photo_sources().values()):
        pytest.skip("no package photographs installed")
    files = T.make_synthetic_dataset(str(tmp_path / "port"), 1, (64, 64),
                                     hard=hard)
    J.make_synthetic_dataset(str(tmp_path / "jax"), 1, (64, 64), hard=hard)
    assert codec.imread(files[0]).shape == (64, 64, 3)
    with open(tmp_path / "jax" / "gt_img_0.txt", "rb") as a, \
            open(tmp_path / "port" / "gt_img_0.txt", "rb") as b:
        assert a.read() == b.read()
