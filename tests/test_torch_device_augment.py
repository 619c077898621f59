"""The on-device augmentation and its draws against the JAX package.

``tensorflow_ocr_tpu_torch/data/device_augment.py`` against
``tensorflow_ocr_tpu/data/device_augment.py`` and ``jax.random`` on the
CPU:

- the threefry2x32 primitives (``PRNGKey``, ``fold_in``, ``split``,
  ``random_bits``, ``randint``) exactly, for several keys and shapes;
  ``uniform`` within 1 ulp of its range's bound, max(|min|, |max|) in
  float32: the random bits are the same, and the scale-and-shift
  ``f * (max - min) + min`` rounds at that magnitude (XLA contracts it,
  torch rounds the product and the sum apart);
- ``sample_similarity_params`` from the train step's key
  (``fold_in(fold_in(PRNGKey(seed ^ 0x5EED), step), 0)``): the scale
  choices exactly, the angle within the same 1 ulp (7.45e-9 read at
  0.17 rad), the focal points within 1e-4;
- ``similarity_matrices`` and ``transform_points`` within 1e-4 of their
  magnitude; ``warp_images`` within WARP_ATOL (2e-3 levels; 1.007e-3
  read: the source position is one float32 sum in another order);
- ``augment_batch`` for PixelLink and EAST: polygons within 1e-4 of the
  frame, tags and valid exactly, EAST rectangles and angles within 1e-4;
- ``sort_rectangle_torch`` against ``sort_rectangle_jax``: the corners
  exactly, the angles within 1e-6 (torch's and XLA's arctan round apart:
  4 ulp read at 0.7 rad).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_ocr_tpu.config import DataConfig as JData
from tensorflow_ocr_tpu.data import device_augment as JA
from tensorflow_ocr_tpu.ops import geometry as JG
from tensorflow_ocr_tpu_torch.config import DataConfig
from tensorflow_ocr_tpu_torch.data import device_augment as DA
from tensorflow_ocr_tpu_torch.data.icdar import east_poly_geometry
from tensorflow_ocr_tpu_torch.ops import geometry as G

torch.set_num_threads(1)
WARP_ATOL = 2e-3
SEEDS = (0, 7, 0x5EED, 123456789)


def _ulp(lo, hi) -> float:
    """1 ulp of the float32 range bound max(|lo|, |hi|)."""
    return float(np.spacing(np.float32(max(abs(lo), abs(hi)))))


def _key(k) -> torch.Tensor:
    return torch.from_numpy(np.asarray(k).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_derivation_is_jax_s(seed):
    k = jax.random.PRNGKey(seed)
    assert np.array_equal(np.asarray(k), DA.prng_key(seed).numpy())
    for data in (0, 1, 5, 1000, 2 ** 31 + 5):
        assert np.array_equal(np.asarray(jax.random.fold_in(k, data)),
                              DA.fold_in(_key(k), data).numpy()), data
    # a step tensor folds in as the integer does
    assert np.array_equal(np.asarray(jax.random.fold_in(k, 17)),
                          DA.fold_in(_key(k), torch.tensor(17)).numpy())
    for n in (2, 3, 5):
        assert np.array_equal(np.asarray(jax.random.split(k, n)),
                              DA.split(_key(k), n).numpy()), n


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(5,), (3, 2), (7,), (32,), (32, 2)])
def test_samplers_are_jax_s(seed, shape):
    k = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    bits = np.asarray(jax.random.bits(k, shape, jnp.uint32)).astype(np.int64)
    assert np.array_equal(bits, DA.random_bits(_key(k), shape).numpy())
    for lo, hi in ((-0.3, 0.7), (-1.0, 1.0), (-0.17453292, 0.17453292)):
        want = np.asarray(jax.random.uniform(k, shape, minval=lo, maxval=hi))
        got = DA.uniform(_key(k), shape, lo, hi).numpy()
        assert got.dtype == np.float32
        assert np.abs(got - want).max() <= _ulp(lo, hi)
    for lo, hi in ((0, 4), (3, 17), (-5, 1000), (0, 1)):
        want = np.asarray(jax.random.randint(k, shape, lo, hi))
        assert np.array_equal(want, DA.randint(_key(k), shape, lo, hi)
                              .numpy()), (lo, hi)


def _configs(size=64, **flags):
    j, t = JData(), DataConfig()
    for c in (j, t):
        c.input_size = size
        for name, v in flags.items():
            setattr(c, name, v)
    return j, t


def _jax_step_key(seed, step):
    return jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(seed ^ 0x5EED), step), 0)


@pytest.mark.parametrize("flags", [
    dict(use_random_scale=True, use_rotate=True, use_crop=True),
    dict(use_rotate=True), dict(use_crop=True, use_random_scale=True),
    dict()])
@pytest.mark.parametrize("step", [0, 1, 17, 4096])
def test_similarity_params_are_jax_s(flags, step):
    jcfg, tcfg = _configs(**flags)
    jp = JA.sample_similarity_params(_jax_step_key(0, step), 8, jcfg)
    tp = DA.sample_similarity_params(
        DA.step_key(0, torch.tensor(step, dtype=torch.int64)), 8, tcfg)
    assert np.array_equal(np.asarray(jp["scale"]), tp["scale"].numpy())
    bound = tcfg.max_rotate_deg * math.pi / 180.0
    assert np.abs(tp["angle"].numpy() - np.asarray(jp["angle"])).max() \
        <= _ulp(-bound, bound)
    np.testing.assert_allclose(tp["focal"].numpy(), np.asarray(jp["focal"]),
                               rtol=0, atol=1e-4)
    jm = JA.similarity_matrices(jp, 64)
    tm = DA.similarity_matrices(tp, 64)
    for a, b in zip(jm, tm):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(a).max()))


def _batch(rng, b=3, size=64, k=5):
    polys = (rng.rand(b, k, 4, 2) * size * 1.2 - 5).astype(np.float32)
    geo = [east_poly_geometry(p) for p in polys]
    return {"images": rng.randint(0, 256, (b, size, size, 3)).astype(
                np.uint8),
            "polys": polys, "tags": rng.rand(b, k) < 0.3,
            "valid": rng.rand(b, k) < 0.8,
            "shrunk": np.stack([g[0] for g in geo]),
            "rects": np.stack([g[1] for g in geo]),
            "angles": np.stack([g[2] for g in geo])}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_warp_and_points_are_jax_s(seed):
    rng = np.random.RandomState(seed)
    batch = _batch(rng)
    jcfg, tcfg = _configs(use_random_scale=True, use_rotate=True,
                          use_crop=True)
    tp = DA.sample_similarity_params(
        DA.step_key(0, torch.tensor(seed)), 3, tcfg)
    jp = {k: jnp.asarray(v.numpy()) for k, v in tp.items()}
    jm, jt, jminv = JA.similarity_matrices(jp, 64)
    tm, tt, tminv = DA.similarity_matrices(tp, 64)
    want = np.asarray(JA.warp_images(jnp.asarray(batch["images"]), jminv,
                                     jt))
    got = DA.warp_images(torch.from_numpy(batch["images"]), tminv, tt)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert float(np.abs(got.numpy() - want).max()) <= WARP_ATOL
    # the out-of-frame fill is the ImageNet means
    far = DA.warp_images(torch.from_numpy(batch["images"][:1]),
                         tminv[:1], tt[:1] + 1e4)
    assert torch.allclose(far[0, 5, 5], torch.tensor(DA.FILL_RGB))
    pts = np.asarray(JA.transform_points(jnp.asarray(batch["polys"]), jm,
                                         jt))
    np.testing.assert_allclose(
        DA.transform_points(torch.from_numpy(batch["polys"]), tm, tt)
        .numpy(), pts, rtol=0, atol=1e-4 * 64)


@pytest.mark.parametrize("want_east", [False, True])
@pytest.mark.parametrize("step", [0, 5, 9])
def test_augment_batch_is_jax_s(want_east, step):
    rng = np.random.RandomState(step)
    batch = _batch(rng)
    jcfg, tcfg = _configs(use_random_scale=True, use_rotate=True,
                          use_crop=True)
    jo = JA.augment_batch(_jax_step_key(0, step),
                          {k: jnp.asarray(v) for k, v in batch.items()},
                          jcfg, want_east)
    to = DA.augment_batch(DA.step_key(0, torch.tensor(step)),
                          {k: torch.from_numpy(v) for k, v in batch.items()},
                          tcfg, want_east)
    assert set(jo) == set(to)
    assert float(np.abs(to["images"].numpy() - np.asarray(jo["images"]))
                 .max()) <= WARP_ATOL
    for key in ("tags", "valid"):
        assert np.array_equal(to[key].numpy(), np.asarray(jo[key])), key
    keys = ("polys", "shrunk", "rects") if want_east else ("polys",)
    for key in keys:
        np.testing.assert_allclose(to[key].numpy(), np.asarray(jo[key]),
                                   rtol=0, atol=1e-4 * 64, err_msg=key)
    np.testing.assert_allclose(to["angles"].numpy(),
                               np.asarray(jo["angles"]), rtol=0, atol=1e-4)
    if not want_east:  # the EAST keys pass through untouched
        assert np.array_equal(to["rects"].numpy(), batch["rects"])


@pytest.mark.parametrize("seed", [0, 1])
def test_sort_rectangle_torch_is_jax_s(seed):
    rng = np.random.RandomState(seed)
    rects = []
    for _ in range(64):  # rotated rectangles, corners in a random order
        c, (w, h), a = rng.rand(2) * 100, rng.rand(2) * 40 + 2, rng.rand()
        u = np.array([math.cos(a * 3), math.sin(a * 3)]) * w / 2
        v = np.array([-u[1], u[0]]) * h / w
        r = np.stack([c - u - v, c + u - v, c + u + v, c - u + v])
        rects.append(np.roll(r, rng.randint(4), 0))
    rects.append(np.array([[0, 0], [10, 0], [10, 5], [0, 5]]))  # the tie
    rects = np.asarray(rects, np.float32)
    jr, ja = JG.sort_rectangle_jax(jnp.asarray(rects))
    tr, ta = G.sort_rectangle_torch(torch.from_numpy(rects))
    assert np.array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=1e-6)
    area = G.polygon_area_torch(torch.from_numpy(rects)).numpy()
    np.testing.assert_allclose(area, np.asarray(JG.polygon_area_jax(
        jnp.asarray(rects))), rtol=1e-6)
