"""The photo tiers against the JAX package's.

``tensorflow_ocr_tpu_torch/data/icdar.py`` ``make_synthetic_dataset``
with ``hard="photo[2]:train|val"`` against
``tensorflow_ocr_tpu/data/icdar.py``'s, same seeds:

- the sources are JAX's (the photographs and textures shipped inside
  installed packages), in the same disjoint train and val sets;
- each background (a crop of a photograph resized to the frame, flipped,
  with gain and bias) is bit-equal to JAX's: ``codec.imread`` decodes the
  sources as ``cv2.imread`` does and ``codec.resize`` is cv2's, its
  border rows included, so no difference below comes from the resize;
- every ``gt_img_*.txt`` is byte-equal;
- the frames handed to the encoder differ on at most 0.5% of their pixels
  (0.06% read: ``fill_poly``'s outline and the hull's straight runs, the
  departures of tests/test_torch_codec.py, through the blurred masks);
  where a frame is equal, its JPEG (at the tier's random quality) is
  byte-equal to cv2's.
"""

import os

import numpy as np
import pytest
import torch

from tensorflow_ocr_tpu.data import icdar as J
from tensorflow_ocr_tpu_torch.data import codec
from tensorflow_ocr_tpu_torch.data import icdar as T

torch.set_num_threads(1)
MAX_PIXELS_OFF = 5e-3
TIERS = ("photo", "photo2")


@pytest.fixture
def sources():
    src = {t: T._photo_sources(t) for t in TIERS}
    if not all(src["photo"].values()):
        pytest.skip("no package photographs installed")
    return src


def test_sources_are_jax_s_and_disjoint(sources):
    for tier in TIERS:
        assert sources[tier] == J._photo_sources(tier)
        assert not set(sources[tier]["train"]) & set(sources[tier]["val"])
    for split in ("train", "val"):
        assert set(sources["photo"][split]) <= set(sources["photo2"][split])


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("split", ["train", "val"])
def test_backgrounds_are_jax_s_bit_for_bit(sources, tier, split):
    for seed, (h, w) in enumerate([(256, 320), (512, 512), (720, 1280),
                                   (128, 96)]):
        got = T._photo_background(np.random.RandomState(seed), h, w, split,
                                  tier)
        want = J._photo_background(np.random.RandomState(seed), h, w, split,
                                   tier)
        assert got.shape == (h, w, 3) and np.array_equal(got, want), seed


def _write(monkeypatch, mod, writer_owner, path, **kw):
    images = {}
    orig = writer_owner.imwrite

    def capture(fn, im, *a, **k):
        images[os.path.basename(fn)] = im.copy()
        return orig(fn, im, *a, **k)

    with monkeypatch.context() as m:
        m.setattr(writer_owner, "imwrite", capture)
        files = mod.make_synthetic_dataset(path, **kw)
    return files, images


@pytest.mark.parametrize("hard,size,n,seed", [
    ("photo:train", (256, 320), 4, 0), ("photo:val", (256, 320), 4, 3),
    ("photo", (512, 512), 2, 1), ("photo2:train", (512, 512), 3, 0),
    ("photo2:val", (720, 1280), 1, 2)])
def test_photo_tiers_match_jax(sources, tmp_path, monkeypatch, hard, size, n,
                               seed):
    kw = dict(num_images=n, size=size, seed=seed, hard=hard)
    jfiles, jimgs = _write(monkeypatch, J, J.cv2, str(tmp_path / "jax"), **kw)
    tfiles, timgs = _write(monkeypatch, T, codec, str(tmp_path / "port"),
                           **kw)
    assert [os.path.basename(f) for f in jfiles] == \
        [os.path.basename(f) for f in tfiles]
    for i in range(n):
        gt = f"gt_img_{i}.txt"
        with open(tmp_path / "jax" / gt, "rb") as a, \
                open(tmp_path / "port" / gt, "rb") as b:
            assert a.read() == b.read(), (gt, hard, seed)
        im = f"img_{i}.jpg"
        assert timgs[im].shape == (*size, 3)
        off = (np.abs(timgs[im].astype(int) - jimgs[im]).max(-1) > 0).mean()
        assert off <= MAX_PIXELS_OFF, (im, off)
        if off == 0:
            with open(tmp_path / "jax" / im, "rb") as a, \
                    open(tmp_path / "port" / im, "rb") as b:
                assert a.read() == b.read(), im


def test_unknown_photo_tier_raises(tmp_path):
    with pytest.raises(ValueError, match="photo"):
        T.make_synthetic_dataset(str(tmp_path), 1, (64, 64),
                                 hard="photo3:train")
    with pytest.raises(ValueError, match="photo"):
        T.make_synthetic_dataset(str(tmp_path), 1, (64, 64),
                                 hard="photo:test")
