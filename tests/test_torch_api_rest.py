"""The JAX package's last public functions against their port.

Each function of the port below is held against its JAX original on the
CPU, the same seeded numpy inputs through both:

- ``ops/decode.py`` ``pixel_link_mask`` (with and without
  ``compat_reference_bugs``), ``ops/labels.py`` ``pixellink_labels`` (full
  resolution), ``subsample_maps`` and ``pixellink_labels_batch`` (its
  shapes with the trailing 1), ``ops/rasterize.py`` ``rasterize_mask``:
  bit-equal;
- ``infer.py`` ``pixel_scores_from_logits`` and
  ``link_scores_from_logits``: within 1e-6, and ``pixel_link_scores``
  equal to them;
- ``ops/geometry.py`` ``min_area_rect_angles``: the four corners equal as
  a set of points within 1e-3 px (JAX leaves the start corner
  unordered).

The JAX functions take one image; the port's label functions are batched,
so each image of the batch is held against JAX's result for it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_ocr_tpu import infer as JI
from tensorflow_ocr_tpu.ops import decode as JD
from tensorflow_ocr_tpu.ops import geometry as JG
from tensorflow_ocr_tpu.ops import labels as JL
from tensorflow_ocr_tpu.ops import rasterize as JR
from tensorflow_ocr_tpu_torch import infer as TI
from tensorflow_ocr_tpu_torch.ops import decode as TD
from tensorflow_ocr_tpu_torch.ops import geometry as TG
from tensorflow_ocr_tpu_torch.ops import labels as TL
from tensorflow_ocr_tpu_torch.ops import rasterize as TR

torch.set_num_threads(1)
H, W, K = 48, 64, 6


def quads(rng, b=3, k=K, h=H, w=W):
    """(b, k, 4, 2) rotated quads in pixels, some past the border and
    some small; ``valid`` drops the last slots of each image at random,
    ``ignored`` flags about 1 in 4."""
    polys = np.zeros((b, k, 4, 2), np.float32)
    for i in range(b):
        for j in range(k):
            cx, cy = rng.uniform(-4, w + 4), rng.uniform(-4, h + 4)
            bw, bh = rng.uniform(2, 0.6 * w), rng.uniform(2, 0.4 * h)
            th = rng.uniform(-0.8, 0.8)
            c, s = np.cos(th), np.sin(th)
            box = np.array([[-bw, -bh], [bw, -bh], [bw, bh], [-bw, bh]]) / 2
            polys[i, j] = box @ np.array([[c, -s], [s, c]]).T + (cx, cy)
    n = rng.randint(1, k + 1, size=b)
    valid = np.arange(k)[None, :] < n[:, None]
    ignored = rng.rand(b, k) < 0.25
    return polys, ignored, valid


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("compat", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_pixel_link_mask(seed, compat):
    rng = np.random.RandomState(seed)
    scores = rng.rand(2, H, W).astype(np.float32)
    links = rng.rand(2, H, W, 8).astype(np.float32) ** 0.1
    links[0, :4, :4] = 0.8  # on the link threshold: kept (>=)
    scores[1, :4, :4] = 0.8  # on the pixel threshold: dropped (>)
    got = TD.pixel_link_mask(*_t(scores, links), 0.8, 0.8,
                             compat_reference_bugs=compat).numpy()
    for i in range(2):
        want = np.asarray(JD.pixel_link_mask(
            jnp.asarray(scores[i]), jnp.asarray(links[i]), 0.8, 0.8,
            compat_reference_bugs=compat))
        assert got[i].dtype == want.dtype == np.bool_
        np.testing.assert_array_equal(got[i], want)
    # the filter drops pixels where it runs, none in compat mode
    assert (got.sum() == (scores > 0.8).sum()) == compat


@pytest.mark.parametrize("which", ["pixel", "link", "pixel_link_scores"])
def test_scores_from_logits(which):
    rng = np.random.RandomState(5)
    pl = (rng.randn(2, H // 4, W // 4, 2) * 4).astype(np.float32)
    ll = (rng.randn(2, H // 4, W // 4, 16) * 4).astype(np.float32)
    if which == "pixel_link_scores":
        ps, ls = TI.pixel_link_scores({"pixel_logits": torch.from_numpy(pl),
                                       "link_logits": torch.from_numpy(ll)})
        assert torch.equal(ps, TI.pixel_scores_from_logits(
            torch.from_numpy(pl)))
        assert torch.equal(ls, TI.link_scores_from_logits(
            torch.from_numpy(ll)))
        return
    port, jax_fn, x, shape = {
        "pixel": (TI.pixel_scores_from_logits, JI.pixel_scores_from_logits,
                  pl, (H // 4, W // 4)),
        "link": (TI.link_scores_from_logits, JI.link_scores_from_logits, ll,
                 (H // 4, W // 4, 8))}[which]
    got = port(torch.from_numpy(x)).numpy()
    for i in range(2):
        want = np.asarray(jax_fn(jnp.asarray(x[i])))
        assert want.shape == got[i].shape == shape
        np.testing.assert_allclose(got[i], want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("fn", ["rasterize_mask", "pixellink_labels",
                                "subsample_maps", "labels_batch_1",
                                "labels_batch_2", "labels_batch_4"])
@pytest.mark.parametrize("seed", [3, 4])
def test_label_maps(seed, fn):
    rng = np.random.RandomState(seed)
    polys, ignored, valid = quads(rng)
    tp, tig, tva = _t(polys, ignored, valid)
    if fn == "rasterize_mask":
        got = [TR.rasterize_mask(tp, tva, H, W)]
        want = [[JR.rasterize_mask(jnp.asarray(polys[i]),
                                   jnp.asarray(valid[i]), H, W)]
                for i in range(len(polys))]
    elif fn.startswith("labels_batch"):
        stride = int(fn[-1])
        got = TL.pixellink_labels_batch(tp, tig, tva, H, W, 6, stride)
        jb = JL.pixellink_labels_batch(jnp.asarray(polys),
                                       jnp.asarray(ignored),
                                       jnp.asarray(valid), H, W, 6, stride)
        h, w = -(-H // stride), -(-W // stride)
        assert [tuple(t.shape) for t in got] == [
            (3, h, w, 1), (3, h, w, 8), (3, h, w, 1)]
        want = [[np.asarray(t)[i] for t in jb] for i in range(len(polys))]
    else:
        full = TL.pixellink_labels(tp, tig, tva, H, W, min_text_size=6)
        jfull = [JL.pixellink_labels(jnp.asarray(polys[i]),
                                     jnp.asarray(ignored[i]),
                                     jnp.asarray(valid[i]), H, W,
                                     min_text_size=6)
                 for i in range(len(polys))]
        if fn == "subsample_maps":
            got = TL.subsample_maps(*full, stride=4)
            want = [JL.subsample_maps(*j, stride=4) for j in jfull]
        else:
            got, want = full, jfull
    for i, w_maps in enumerate(want):
        assert len(got) == len(w_maps)
        for g, w_map in zip(got, w_maps):
            w_map = np.asarray(w_map)
            assert g[i].numpy().dtype == w_map.dtype, fn
            np.testing.assert_array_equal(g[i].numpy(), w_map, err_msg=fn)
    # the cases hold text, masked text and background
    assert got[0].any() and not got[0].all()
    if fn == "pixellink_labels":
        assert (got[2] == 0).any()


def _corner_sets_match(got, want, tol=1e-3):
    """Each corner of ``got`` within ``tol`` px of a distinct corner of
    ``want``."""
    d = np.linalg.norm(got[:, None] - want[None], axis=-1)
    used = set()
    for row in d:
        j = next((j for j in np.argsort(row) if j not in used), None)
        assert j is not None and row[j] <= tol, d
        used.add(j)


@pytest.mark.parametrize("num_angles", [90, 180])
@pytest.mark.parametrize("seed", [6, 7, 8])
def test_min_area_rect_angles(seed, num_angles):
    rng = np.random.RandomState(seed)
    theta = rng.uniform(0, np.pi / 2)
    c, s = np.cos(theta), np.sin(theta)
    pts = rng.uniform(0, 1, size=(160, 2)) * [50, 9]
    pts = (pts @ np.array([[c, -s], [s, c]]).T + 70).astype(np.float32)
    mask = rng.rand(160) < 0.8
    pts[~mask] += 500  # masked points lie far off: they must not count
    got = TG.min_area_rect_angles(*_t(pts, mask), num_angles).numpy()
    want = np.asarray(JG.min_area_rect_angles(
        jnp.asarray(pts), jnp.asarray(mask), num_angles))
    assert got.shape == want.shape == (4, 2)
    _corner_sets_match(got, want)
    assert got.max() < 200  # the masked points were left out
