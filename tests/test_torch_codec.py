"""The port's cv2-free image calls against cv2.

``tensorflow_ocr_tpu_torch/data/codec.py`` against OpenCV on the same
seeded inputs, with the tolerance each states (read against
opencv-python 5.0):

- ``resize`` (INTER_LINEAR, uint8): byte-equal at the shapes where the
  height grows (cv2's vertical border taps) and where it shrinks; at most
  1 level, on at most 1% of the values, elsewhere (cv2's vector path
  rounds a row's tail apart: 0.34% read at fx = 0.5 on odd sides);
  the same for ``utils/image.py`` ``resize_image`` against JAX's, with
  the same size and ratios;
- ``warp_affine`` (bilinear, border 0): at most 1 level on 0.1% of the
  values (0.021% read: float32 positions summed in another order);
- ``fill_poly``: equal inside the image; a polygon crossing the border
  (its outline clipped) within 0.5% of the image's pixels (0.23% read);
  ``circle`` (filled) and ``rectangle`` (filled) equal; a thick ``line``
  within 1.5% of the pixels (1.19% read: its quad and caps
  approximated);
- ``convex_hull``, ``min_area_rect`` + ``box_points``,
  ``get_perspective_transform`` and ``perspective_transform`` equal, but
  for hulls with straight runs of points (characters along a line):
  OpenCV 5 keeps some of the points inside such a run and drops others,
  which the port does not reproduce; there the min-area box agrees within
  5e-4 px (1.41e-4 read) and the filled hull of integer points within 1%
  of its area (0.50% read);
  ``gaussian_blur`` (3x3) within 1e-6;
- ``imread``: PNG equal, JPEG (PIL) equal to cv2's decode (both
  libjpeg-turbo); ``imwrite``: the JPEG bytes are cv2's at quality 95, a
  PNG reads back equal;
- the committed nvJPEG fixture (``tests/data/nvjpeg_fixture.jpg``) and
  its cv2 decode (``nvjpeg_fixture_cv2.npy``), which ``chip_smoke.py``
  holds nvJPEG's decode against, are what :func:`write_fixture` writes.
"""

import os

import cv2
import numpy as np
import pytest
import torch

from tensorflow_ocr_tpu_torch.data import codec as C
from tensorflow_ocr_tpu_torch.data import icdar

torch.set_num_threads(1)
HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "data", "nvjpeg_fixture.jpg")
FIXTURE_CV2 = os.path.join(HERE, "data", "nvjpeg_fixture_cv2.npy")


def write_fixture(d: str):
    """The nvJPEG fixture: a 128x96 v2 scene of the port's generator
    (seed 5), decoded and encoded again by cv2 (quality 95), and cv2's
    decode of that file. Returns the two paths."""
    src = os.path.join(d, "src")
    icdar.make_synthetic_dataset(src, 1, (96, 128), seed=5, hard="v2")
    jpg, npy = os.path.join(d, "fixture.jpg"), os.path.join(d, "fixture.npy")
    cv2.imwrite(jpg, cv2.imread(os.path.join(src, "img_0.jpg")))
    np.save(npy, cv2.imread(jpg))
    return jpg, npy


def test_committed_fixture_is_what_write_fixture_writes(tmp_path):
    jpg, npy = write_fixture(str(tmp_path))
    with open(jpg, "rb") as a, open(FIXTURE, "rb") as b:
        assert a.read() == b.read()
    assert np.array_equal(np.load(npy), np.load(FIXTURE_CV2))
    assert np.array_equal(np.load(FIXTURE_CV2), cv2.imread(FIXTURE))


def _diff(a, b):
    return np.abs(a.astype(np.int64) - b.astype(np.int64))


@pytest.mark.parametrize("case", ["dsize_down", "dsize_up", "fx_half",
                                  "fx_half_even", "fx_two", "fx_three",
                                  "square"])
def test_resize_is_cv2_s(case):
    rng = np.random.RandomState(len(case))
    img = rng.randint(0, 256, (97, 131, 3), np.uint8)
    if case == "fx_half_even":
        img = img[:96, :130]
    kw = {"dsize_down": dict(dsize=(64, 48)), "dsize_up": dict(
        dsize=(300, 200)), "square": dict(dsize=(64, 64)),
          "fx_half": dict(fx=0.5), "fx_half_even": dict(fx=0.5),
          "fx_two": dict(fx=2.0), "fx_three": dict(fx=3.0)}[case]
    if "fx" in kw:
        want = cv2.resize(img, None, fx=kw["fx"], fy=kw["fx"])
        got = C.resize(img, fx=kw["fx"], fy=kw["fx"])
    else:
        want = cv2.resize(img, kw["dsize"])
        got = C.resize(img, kw["dsize"])
    assert got.shape == want.shape and got.dtype == np.uint8
    d = _diff(got, want)
    assert d.max() <= 1 and (d > 0).mean() <= 0.01


@pytest.mark.parametrize("src,dst", [
    ((136, 200), (256, 256)), ((427, 640), (720, 1280)),
    ((150, 200), (720, 1280)), ((256, 256), (512, 300)),
    ((720, 1280), (512, 512)),
    # the photo tiers' crops to the frame (china.jpg 427x640 and a
    # 0.55-crop of it; a 512x512 PNG texture) and test_pixellink_fast's
    # 1280x768 from a 720p frame and a portrait photo
    ((235, 352), (256, 320)), ((300, 300), (720, 1280)),
    ((512, 512), (512, 512)), ((281, 500), (720, 1280)),
    ((720, 1280), (768, 1280)), ((640, 427), (768, 1280)),
    ((97, 131), (1280, 96))])
def test_resize_border_rows_are_cv2_s(src, dst):
    """Byte-equal to cv2 where the height grows: along y cv2 keeps the
    fraction's weights at the first and last rows and clamps only the row
    index, which the port did not (one level off there)."""
    img = np.random.RandomState(src[0]).randint(0, 256, (*src, 3), np.uint8)
    want = cv2.resize(img, dst[::-1])
    got = C.resize(img, dst[::-1])
    assert got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("hw,cap", [((500, 700), 3000), ((97, 131), 3000),
                                    ((512, 640), 3000), ((300, 1000), 512)])
def test_resize_image_is_jax_s(hw, cap):
    from tensorflow_ocr_tpu.utils.image import resize_image as jax_resize
    from tensorflow_ocr_tpu_torch.utils.image import resize_image

    img = np.random.RandomState(hw[0]).randint(0, 256, (*hw, 3), np.uint8)
    got, gr = resize_image(img, cap)
    want, wr = jax_resize(img, cap)
    assert got.shape == want.shape and got.dtype == np.uint8 and gr == wr
    d = _diff(got, want)
    assert d.max() <= 1 and (d > 0).mean() <= 0.01


@pytest.mark.parametrize("deg", [3.7, -8.2, 10.0, -45.0])
def test_rotation_and_warp_are_cv2_s(deg):
    rng = np.random.RandomState(int(abs(deg)))
    img = rng.randint(0, 256, (97, 131, 3), np.uint8)
    m = cv2.getRotationMatrix2D((131 / 2, 97 / 2), deg, 1.0)
    np.testing.assert_allclose(C.get_rotation_matrix_2d(
        (131 / 2, 97 / 2), deg, 1.0), m, rtol=0, atol=1e-12)
    d = _diff(C.warp_affine(img, m, (131, 97)), cv2.warpAffine(img, m,
                                                               (131, 97)))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3


@pytest.mark.parametrize("where", ["inside", "crossing"])
def test_fill_poly_is_cv2_s(where):
    rng = np.random.RandomState(0 if where == "inside" else 1)
    h, w = 60, 80
    for _ in range(100):
        n = rng.randint(3, 7)
        if where == "inside":
            pts = (rng.rand(n, 2) * [w - 1, h - 1]).astype(np.int32)
        else:
            pts = (rng.rand(n, 2) * [w * 1.3, h * 1.3]
                   - [w * 0.15, h * 0.15]).astype(np.int32)
        a = np.zeros((h, w, 3), np.uint8)
        b = a.copy()
        cv2.fillPoly(a, [pts], (255, 128, 7))
        C.fill_poly(b, [pts], (255, 128, 7))
        if where == "inside":
            assert np.array_equal(a, b), pts.tolist()
        else:
            assert (_diff(a, b).max(-1) > 0).mean() <= 5e-3, pts.tolist()


def test_drawing_is_cv2_s():
    rng = np.random.RandomState(2)
    for _ in range(50):
        a = np.zeros((60, 80, 3), np.uint8)
        b = a.copy()
        c, r = (int(rng.randint(-10, 90)), int(rng.randint(-10, 70))), \
            int(rng.randint(1, 40))
        cv2.circle(a, c, r, (200, 100, 50), -1)
        C.circle(b, c, r, (200, 100, 50), -1)
        assert np.array_equal(a, b), (c, r)
        p0 = (int(rng.randint(0, 80)), int(rng.randint(0, 60)))
        p1 = (int(rng.randint(0, 80)), int(rng.randint(0, 60)))
        cv2.rectangle(a, p0, p1, (1, 2, 3), -1)
        C.rectangle(b, p0, p1, (1, 2, 3), -1)
        assert np.array_equal(a, b), (p0, p1)
        th = int(rng.randint(1, 5))
        cv2.line(a, p0, p1, (9, 8, 7), th)
        C.line(b, p0, p1, (9, 8, 7), th)
        off = (_diff(a, b).max(-1) > 0).mean()
        assert off == 0 if th == 1 else off <= 0.015, (p0, p1, th)


@pytest.mark.parametrize("kind", ["float", "int", "collinear"])
def test_hull_and_min_area_rect_are_cv2_s(kind):
    rng = np.random.RandomState(3)
    for _ in range(200):
        n = rng.randint(3, 30)
        if kind == "float":
            pts = (rng.rand(n, 2) * 500).astype(np.float32)
        elif kind == "int":
            pts = (rng.rand(n, 2) * 60).astype(np.int32)
        else:  # characters along a line: collinear hull points
            t = np.arange(n, dtype=np.float64)[:, None]
            a = rng.uniform(-1, 1)
            pts = (np.concatenate([t * [3.3, 3.3 * a], t * [3.3, 3.3 * a]
                                   + [0.4, 7.0]]) + rng.rand(1, 2) * 50
                   ).astype(np.float32)
        got_box = C.box_points(C.min_area_rect(pts))
        want_box = cv2.boxPoints(cv2.minAreaRect(pts))
        if kind == "collinear":
            assert np.abs(got_box - want_box).max() <= 5e-4
            ip = np.round(pts * 3).astype(np.int32)
            a = np.zeros((400, 400), np.uint8)
            b = a.copy()
            cv2.fillPoly(a, [cv2.convexHull(ip)], 1)
            C.fill_poly(b, [C.convex_hull(ip)], 1)
            assert (a != b).sum() <= 0.01 * a.sum()
            continue
        assert np.array_equal(C.convex_hull(pts), cv2.convexHull(pts))
        if kind == "float":
            assert np.array_equal(got_box, want_box)


def test_box_points_and_perspective_are_cv2_s():
    rng = np.random.RandomState(4)
    for _ in range(200):
        r = ((int(rng.randint(0, 500)), int(rng.randint(0, 500))),
             (int(rng.randint(5, 100)), int(rng.randint(5, 50))),
             float(rng.uniform(-60, 60)))
        assert np.array_equal(C.box_points(r), cv2.boxPoints(r))
    for _ in range(50):
        src = (rng.rand(4, 2) * 100).astype(np.float32)
        dst = src + rng.uniform(-5, 5, (4, 2)).astype(np.float32)
        h = cv2.getPerspectiveTransform(src, dst)
        assert np.array_equal(C.get_perspective_transform(src, dst), h)
        p = (rng.rand(20, 1, 2) * 100).astype(np.float32)
        assert np.array_equal(C.perspective_transform(p, h),
                              cv2.perspectiveTransform(p, h))


def test_gaussian_blur_is_cv2_s():
    rng = np.random.RandomState(5)
    for shape in ((40, 50), (30, 20, 3)):
        f = rng.rand(*shape).astype(np.float32)
        for sigma in (0.8, 0.9):
            np.testing.assert_allclose(C.gaussian_blur(f, sigma),
                                       cv2.GaussianBlur(f, (3, 3), sigma),
                                       rtol=0, atol=1e-6)


def test_files_are_cv2_s(tmp_path):
    rng = np.random.RandomState(6)
    img = cv2.GaussianBlur(rng.randint(0, 256, (120, 160, 3), np.uint8),
                           (7, 7), 3)
    cv2.fillPoly(img, [np.array([[10, 10], [100, 20], [90, 90]],
                                np.int32)], (250, 240, 230))
    a, b = str(tmp_path / "a.jpg"), str(tmp_path / "b.jpg")
    cv2.imwrite(a, img)
    assert C.imwrite(b, img)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    assert np.array_equal(C.imread(a), cv2.imread(a))
    p = str(tmp_path / "c.png")
    C.imwrite(p, img)
    assert np.array_equal(cv2.imread(p), img)
    assert np.array_equal(C.imread(p), img)
    grey = str(tmp_path / "g.png")
    cv2.imwrite(grey, img[:, :, 0])
    assert np.array_equal(C.imread(grey), cv2.imread(grey))
    assert C.imread(str(tmp_path / "missing.jpg")) is None
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"not an image")
    assert C.imread(str(bad)) is None and cv2.imread(str(bad)) is None
