"""Port parity: the EAST geometry, labels and on-device decode.

- ``ops/geometry.py``'s numpy copies (``polygon_area``, ``shrink_poly``,
  ``point_dist_to_line``, ``rectangle_from_parallelogram``,
  ``sort_rectangle``, ``restore_rectangle_rbox``) and ``data/icdar.py``'s
  ``east_poly_geometry`` and ``_pad_polys``: bit-equal to the JAX
  package's on random, axis-aligned and degenerate quads;
- ``east_labels_batch`` (RBOX and QUAD, stride 4 and 1) on overlapping
  rotated quads, ignored and too-small ones among them: score and mask
  exactly JAX's, the geometry within atol 1e-3 (full-resolution pixels;
  the winner of an overlap is JAX's, since both take the highest index);
- ``restore_rectangle_rbox_torch`` against ``restore_rectangle_rbox_jax``
  for angles of both signs, atol 1e-3;
- ``east_detect`` against JAX's vmapped ``east_detect``: the candidates in
  the same order (ties in index order, as ``jax.lax.top_k``), scores and
  valid equal, quads within atol 1e-3; on continuous scores and on
  scores with many ties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_ocr_tpu.data import icdar as JI
from tensorflow_ocr_tpu.ops import decode as JD
from tensorflow_ocr_tpu.ops import geometry as JG
from tensorflow_ocr_tpu.ops import labels as JL
from tensorflow_ocr_tpu_torch.data import icdar as TI
from tensorflow_ocr_tpu_torch.ops import decode as TD
from tensorflow_ocr_tpu_torch.ops import geometry as TG
from tensorflow_ocr_tpu_torch.ops import labels as TL

torch.set_num_threads(1)


def rotated_quads(rng, k, size, tilt=0.6):
    """(k, 4, 2) clockwise rotated rectangles inside a size x size image,
    some overlapping."""
    out = np.zeros((k, 4, 2), np.float32)
    for j in range(k):
        cx, cy = rng.uniform(0.2 * size, 0.8 * size, 2)
        w, h = rng.uniform(0.15, 0.5) * size, rng.uniform(0.06, 0.2) * size
        th = rng.uniform(-tilt, tilt)
        c, s = np.cos(th), np.sin(th)
        box = np.array([[-w, -h], [w, -h], [w, h], [-w, h]]) / 2
        out[j] = np.clip(box @ np.array([[c, -s], [s, c]]).T + (cx, cy), 0,
                         size - 1)
    return out


def quad_cases(rng):
    """Random rotated quads, random parallelograms, axis-aligned boxes
    and degenerate ones (a zero-width box, a point, an all-zero slot)."""
    para = rng.uniform(0, 100, (6, 4, 2)).astype(np.float32)
    para[:, 2] = para[:, 1] + para[:, 3] - para[:, 0]
    aligned = np.array([[[10, 10], [60, 10], [60, 30], [10, 30]],
                        [[5, 40], [5, 20], [90, 20], [90, 40]]], np.float32)
    degenerate = np.array([[[10, 10], [10, 10], [10, 30], [10, 30]],
                           [[7, 7], [7, 7], [7, 7], [7, 7]],
                           np.zeros((4, 2))], np.float32)
    return np.concatenate([rotated_quads(rng, 8, 128), para, aligned,
                           degenerate])


def same(a, b):
    """Equal, NaNs included, bit for bit."""
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_geometry_copies_are_bit_equal():
    rng = np.random.RandomState(0)
    with np.errstate(all="ignore"):
        for q in quad_cases(rng):
            assert TG.polygon_area(q) == JG.polygon_area(q)
            r = np.array([min(np.linalg.norm(q[j] - q[(j + 1) % 4]),
                              np.linalg.norm(q[j] - q[(j - 1) % 4]))
                          for j in range(4)])
            same(TG.shrink_poly(q, r), JG.shrink_poly(q, r))
            if np.linalg.norm(q[1] - q[0]) > 0:
                assert (TG.point_dist_to_line(q[0], q[1], q[2])
                        == JG.point_dist_to_line(q[0], q[1], q[2]))
            for fn in ("rectangle_from_parallelogram", "sort_rectangle"):
                try:
                    want = getattr(JG, fn)(q)
                except Exception as e:  # the same failure on both sides
                    with pytest.raises(type(e)):
                        getattr(TG, fn)(q)
                    continue
                got = getattr(TG, fn)(q)
                if fn == "sort_rectangle":
                    same(got[0], want[0])
                    assert got[1] == want[1] or (np.isnan(got[1])
                                                 and np.isnan(want[1]))
                else:
                    same(got, want)
    origin = rng.uniform(0, 500, (20, 2)).astype(np.float32)
    geo = np.concatenate([rng.uniform(1, 50, (20, 4)),
                          rng.uniform(-0.78, 0.78, (20, 1))], 1)
    same(TG.restore_rectangle_rbox(origin, geo),
         JG.restore_rectangle_rbox(origin, geo))
    same(TG.restore_rectangle_rbox(origin[:0], geo[:0]),
         JG.restore_rectangle_rbox(origin[:0], geo[:0]))


def test_east_poly_geometry_and_padding_are_bit_equal():
    rng = np.random.RandomState(1)
    polys = quad_cases(rng)
    tags = rng.rand(len(polys)) < 0.3
    for max_polys in (8, 32):
        got = TI._pad_polys(polys, tags, max_polys)
        for g, w in zip(got, JI._pad_polys(polys, tags, max_polys)):
            same(g, w)
        with np.errstate(all="ignore"):
            got = TI.east_poly_geometry(got[0])
            want = JI.east_poly_geometry(JI._pad_polys(polys, tags,
                                                       max_polys)[0])
        for g, w in zip(got, want):
            same(g, w)


def label_batch(seed, b=2, k=6, size=128):
    """Overlapping rotated quads with their EAST geometry, one tagged
    ignored and one too small an image, one empty slot."""
    rng = np.random.RandomState(seed)
    polys = np.stack([rotated_quads(rng, k, size) for _ in range(b)])
    polys[:, 1] = polys[:, 1].mean(1, keepdims=True) + (
        polys[:, 1] - polys[:, 1].mean(1, keepdims=True)) * 0.05
    valid = np.ones((b, k), bool)
    valid[:, -1] = False
    polys[:, -1] = 0
    tags = np.zeros((b, k), bool)
    tags[:, 2] = True
    geo = [JI.east_poly_geometry(p) for p in polys]
    shrunk, rects, angles = (np.stack([g[i] for g in geo]) for i in range(3))
    return polys, shrunk, rects, angles, tags, valid


@pytest.mark.parametrize("geometry,stride", [("RBOX", 4), ("RBOX", 1),
                                             ("QUAD", 4)])
def test_east_labels_match_jax(geometry, stride):
    size = 128
    arrays = label_batch(2 + stride)
    assert (arrays[3] > 0).any() and (arrays[3] < 0).any()
    hw = size // stride
    want = JL.east_labels_batch(*map(jnp.asarray, arrays), hw, hw, stride,
                                10, geometry=geometry)
    got = TL.east_labels_batch(*map(torch.from_numpy, arrays), hw, hw,
                               stride, 10, geometry=geometry)
    score, geo, mask = (np.asarray(w) for w in want)
    assert score.sum() > 0 and (mask == 0).any()
    same(got[0].numpy(), score)
    same(got[2].numpy(), mask)
    assert got[1].shape == geo.shape == (2, hw, hw, 5 if geometry == "RBOX"
                                         else 9)
    np.testing.assert_allclose(got[1].numpy(), geo, rtol=0, atol=1e-3)


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_restore_rectangle_rbox_torch_matches_jax(sign):
    rng = np.random.RandomState(int(sign > 0))
    n = 64
    origin = rng.uniform(0, 1280, (n, 2)).astype(np.float32)
    geo = np.concatenate([rng.uniform(0.5, 200, (n, 4)),
                          sign * rng.uniform(0, 0.78, (n, 1))], 1
                         ).astype(np.float32)
    geo[0, 4] = 0.0
    want = np.asarray(JG.restore_rectangle_rbox_jax(jnp.asarray(origin),
                                                    jnp.asarray(geo)))
    got = TG.restore_rectangle_rbox_torch(torch.from_numpy(origin),
                                          torch.from_numpy(geo)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    # the numpy restore puts the angle >= 0 rows first
    pos = geo[:, 4] >= 0
    np.testing.assert_allclose(
        np.concatenate([got[pos], got[~pos]]),
        TG.restore_rectangle_rbox(origin, geo), rtol=0, atol=1e-3)


@pytest.mark.parametrize("geometry,ties", [("RBOX", False), ("RBOX", True),
                                           ("QUAD", False)])
def test_east_detect_matches_jax(geometry, ties):
    rng = np.random.RandomState(7 + ties)
    b, h, w = 2, 24, 40
    score = rng.rand(b, h, w).astype(np.float32)
    if ties:
        score = np.round(score * 8) / 8  # many equal scores
    if geometry == "RBOX":
        geo = np.concatenate([rng.uniform(1, 60, (b, h, w, 4)),
                              rng.uniform(-0.78, 0.78, (b, h, w, 1))], -1)
    else:
        geo = rng.randn(b, h, w, 8) * 30
    geo = geo.astype(np.float32)
    k = 300
    want = jax.vmap(lambda s, g: JD.east_detect(s, g, 0.8, k))(
        jnp.asarray(score), jnp.asarray(geo))
    got = TD.east_detect(torch.from_numpy(score), torch.from_numpy(geo),
                         0.8, k)
    quads, vals, valid = (np.asarray(x) for x in want)
    same(got[1].numpy(), vals)
    same(got[2].numpy(), valid)
    assert valid.sum() > 0 and not valid.all()
    np.testing.assert_allclose(got[0].numpy(), quads, rtol=0, atol=1e-3)
