"""On-device augmentation inside the train step, with JAX's draws.

Port of ``tensorflow_ocr_tpu/data/device_augment.py``: each image of a
batch gathered from the device dataset gets a random similarity
transform (a scale from ``random_scale``, a rotation within
``max_rotate_deg``, a translation within the crop budget) applied by one
bilinear warp; its polygons go through the same matrix, and the label
maps are then made from them on the device (``train/trainer.py``
``make_multi_train_step(augment=True)``).

- :func:`sample_similarity_params` :45, :func:`similarity_matrices` :87,
  :func:`warp_images` :104 (plain torch gathers, as JAX's is: out-of-frame
  taps read the ImageNet means, :42), :func:`transform_points` :147 and
  :func:`augment_batch` :156 with the visibility rules (:175-180) and the
  EAST re-sort by ``ops/geometry.py`` ``sort_rectangle_torch``.
- The draws are JAX's, bit for bit: the threefry2x32 hash, ``PRNGKey``,
  ``fold_in``, ``split`` and ``random_bits`` under
  ``jax_threefry_partitionable=True`` (JAX 0.9.0's default), ``uniform``
  and ``randint``, written in torch int64 arithmetic masked to 32 bits.
  The key is ``fold_in(fold_in(PRNGKey(seed ^ 0x5EED), step), 0)`` with
  ``step`` read from the state's device tensor, so the draws are a
  function of the state alone: a replayed CUDA graph, an eager step and a
  resumed run draw the same numbers. torch's own generator would not: in
  a captured graph its draws follow the generator's offset.

Nothing here syncs with the host: every op can be captured in a CUDA
graph (``train/trainer.py`` ``_GraphMulti``).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from tensorflow_ocr_tpu_torch.config import DataConfig
from tensorflow_ocr_tpu_torch.ops.geometry import sort_rectangle_torch

# ImageNet means (reference nets/model.py:18-31): the fill of pixels the
# warp pulls from outside the source frame
FILL_RGB = (123.68, 116.78, 103.94)
SEED_SALT = 0x5EED  # trainer.py:337: PRNGKey(cfg.train.seed ^ 0x5EED)

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


# --------------------------------------------------------------------------
# JAX's threefry2x32 keys and samplers (jax/_src/prng.py, random.py)
# --------------------------------------------------------------------------


def _const(v, dtype, device) -> torch.Tensor:
    """A 0-dim tensor of ``v`` on ``device`` made by a fill there: no copy
    from the host, so it can be captured in a CUDA graph."""
    if torch.is_tensor(v):
        return v.to(dtype)
    return torch.full((), v, dtype=dtype, device=device)


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _MASK


def threefry2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 hash (prng.py ``_threefry2x32_lowering``, 20
    rounds) of the counters (x1, x2) under the key (k1, k2): int64
    tensors holding uint32 values."""
    k1 = _const(k1, torch.int64, x1.device) & _MASK
    k2 = _const(k2, torch.int64, x1.device) & _MASK
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x = [(x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROT[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x[0], x[1]


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: (2,) int64 holding
    [0, seed mod 2^32]."""
    return torch.stack([_const(0, torch.int64, device),
                        _const(int(seed) & _MASK, torch.int64, device)])


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of the counters (0, data mod 2^32);
    ``data`` may be a 0-dim device tensor (no host read)."""
    d = _const(data, torch.int64, key.device) & _MASK
    z = torch.zeros_like(d)
    a, b = threefry2x32(key[0], key[1], z.reshape(1), d.reshape(1))
    return torch.cat([a, b])


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (the partitionable, fold-like form): (num, 2)
    keys, key i the hash of the counters (0, i)."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    a, b = threefry2x32(key[0], key[1], torch.zeros_like(i), i)
    return torch.stack([a, b], 1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits per element (``_threefry_random_bits_partitionable``):
    the two words of the hash of (0, flat index), xored."""
    n = math.prod(shape)
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    a, b = threefry2x32(key[0], key[1], torch.zeros_like(i), i)
    return (a ^ b).reshape(shape)


def uniform(key: torch.Tensor, shape, minval, maxval) -> torch.Tensor:
    """``jax.random.uniform`` float32: 23 random mantissa bits under the
    exponent of 1.0, less 1, scaled, floored at ``minval``."""
    bits = random_bits(key, shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = _const(minval, torch.float32, key.device)
    hi = _const(maxval, torch.float32, key.device)
    return torch.maximum(lo, f * (hi - lo) + lo)


def randint(key: torch.Tensor, shape, minval: int, maxval: int
            ) -> torch.Tensor:
    """``jax.random.randint`` int32 in [minval, maxval): two words of bits
    from a split of the key, reduced mod the span with JAX's
    multiply-and-mod (uint32 arithmetic)."""
    k = split(key, 2)
    hi, lo = random_bits(k[0], shape), random_bits(k[1], shape)
    span = max(int(maxval) - int(minval), 1) if maxval > minval else 1
    mult = (2 ** 16) % span
    mult = (mult * mult) % span
    off = (((hi % span) * mult) & _MASK) + lo % span
    off = (off & _MASK) % span
    return (minval + off).to(torch.int32)


def step_key(seed: int, step: torch.Tensor) -> torch.Tensor:
    """The augment key of a train step (trainer.py:336, :345-347):
    fold_in(fold_in(PRNGKey(seed ^ 0x5EED), step), 0), the 0 being the
    data-axis index on one device; ``step`` a device tensor."""
    base = prng_key(int(seed) ^ SEED_SALT, step.device)
    return fold_in(fold_in(base, step), 0)


# --------------------------------------------------------------------------
# the augmentation (device_augment.py)
# --------------------------------------------------------------------------


def sample_similarity_params(key: torch.Tensor, batch: int, cfg: DataConfig,
                             size: int = 0) -> Dict[str, torch.Tensor]:
    """Per-image scale (a choice of ``random_scale``, else 1), angle in
    radians (uniform within +-max_rotate_deg, else 0) and focal point (the
    source point that lands at the output centre: uniform within the
    translation budget |size/2 - size/(2 scale)| per axis with
    ``use_crop``, else the centre). ``size`` defaults to
    ``cfg.input_size``."""
    k_s, k_a, k_f = split(key, 3)
    size = float(size or cfg.input_size)
    dev = key.device
    if cfg.use_random_scale and len(cfg.random_scale) > 0:
        choices = torch.stack([_const(v, torch.float32, dev)
                               for v in cfg.random_scale])
        scale = choices[randint(k_s, (batch,), 0, len(choices)).long()]
    else:
        scale = torch.ones(batch, dtype=torch.float32, device=dev)
    if cfg.use_rotate:
        max_rad = cfg.max_rotate_deg * math.pi / 180.0
        angle = uniform(k_a, (batch,), -max_rad, max_rad)
    else:
        angle = torch.zeros(batch, dtype=torch.float32, device=dev)
    if cfg.use_crop:
        max_off = (size / 2.0 - size / (2.0 * scale)).abs()
        off = uniform(k_f, (batch, 2), -1.0, 1.0) * max_off[:, None]
    else:
        off = torch.zeros(batch, 2, dtype=torch.float32, device=dev)
    return {"scale": scale, "angle": angle, "focal": size / 2.0 + off}


def similarity_matrices(params: Dict[str, torch.Tensor], size: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forward matrices M (B, 2, 2), translations t (B, 2) with
    dst = M @ src + t, and the inverses Minv (B, 2, 2)."""
    s, th = params["scale"], params["angle"]
    c, sn = torch.cos(th), torch.sin(th)
    m = s[:, None, None] * torch.stack(
        [torch.stack([c, -sn], -1), torch.stack([sn, c], -1)], -2)
    focal = params["focal"]
    # M @ focal written out (two products and a sum, as the einsum)
    mf = torch.stack([m[:, 0, 0] * focal[:, 0] + m[:, 0, 1] * focal[:, 1],
                      m[:, 1, 0] * focal[:, 0] + m[:, 1, 1] * focal[:, 1]],
                     -1)
    t = size / 2.0 - mf
    minv = torch.stack([torch.stack([c, sn], -1),
                        torch.stack([-sn, c], -1)], -2) / s[:, None, None]
    return m, t, minv


def warp_images(images: torch.Tensor, minv: torch.Tensor,
                t: torch.Tensor) -> torch.Tensor:
    """Inverse-warp bilinear resample out[y, x] = img[Minv @ ([x, y] - t)]
    at pixel centres: images (B, H, W, 3) uint8 or float -> float32 RGB,
    taps outside the frame reading the ImageNet means."""
    b, h, w, ch = images.shape
    dev = images.device
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    dx = (xs.reshape(1, -1) + 0.5) - t[:, 0:1]  # (B, HW)
    dy = (ys.reshape(1, -1) + 0.5) - t[:, 1:2]
    sx = dx * minv[:, 0, 0:1] + dy * minv[:, 0, 1:2] - 0.5
    sy = dx * minv[:, 1, 0:1] + dy * minv[:, 1, 1:2] - 0.5
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    flat = images.reshape(b, h * w, ch).float()
    fill = torch.stack([_const(v, torch.float32, dev) for v in FILL_RGB])

    def tap(yi, xi):
        inside = ((xi >= 0) & (xi < w) & (yi >= 0) & (yi < h))[..., None]
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1))
        v = flat.gather(1, idx[..., None].expand(-1, -1, ch))
        return torch.where(inside, v, fill)

    top = tap(y0, x0) * (1 - fx) + tap(y0, x0 + 1) * fx
    bot = tap(y0 + 1, x0) * (1 - fx) + tap(y0 + 1, x0 + 1) * fx
    return (top * (1 - fy) + bot * fy).reshape(b, h, w, ch)


def transform_points(pts: torch.Tensor, m: torch.Tensor,
                     t: torch.Tensor) -> torch.Tensor:
    """dst = M @ p + t for (B, ..., 2) points, image by image."""
    b = pts.shape[0]
    flat = pts.reshape(b, -1, 2)
    x = (m[:, None, 0, 0] * flat[..., 0] + m[:, None, 0, 1] * flat[..., 1]
         + t[:, None, 0])
    y = (m[:, None, 1, 0] * flat[..., 0] + m[:, None, 1, 1] * flat[..., 1]
         + t[:, None, 1])
    return torch.stack([x, y], -1).reshape(pts.shape)


def augment_batch(key: torch.Tensor, batch: Dict[str, torch.Tensor],
                  cfg: DataConfig, want_east: bool
                  ) -> Dict[str, torch.Tensor]:
    """The whole-batch augmentation of one train step: images (B, H, W, 3)
    warped, polygons (B, K, 4, 2) transformed; a polygon with no corner
    left in the frame is invalidated, one partly in it is marked ignored
    (tags). For EAST, ``shrunk`` and ``rects`` are transformed too and the
    rectangles of valid slots re-sorted with their angles. No labels are
    expected in the batch: they are made from the transformed polygons."""
    b, size = batch["images"].shape[0], batch["images"].shape[1]
    params = sample_similarity_params(key, b, cfg, size)
    m, t, minv = similarity_matrices(params, size)
    out = dict(batch)
    out["images"] = warp_images(batch["images"], minv, t)
    polys = transform_points(batch["polys"], m, t)
    out["polys"] = polys
    inside = ((polys[..., 0] >= 0) & (polys[..., 0] <= size)
              & (polys[..., 1] >= 0) & (polys[..., 1] <= size))
    n_in = inside.sum(-1)
    out["valid"] = batch["valid"] & (n_in > 0)
    out["tags"] = batch["tags"] | ((n_in > 0) & (n_in < 4))
    if want_east:
        out["shrunk"] = transform_points(batch["shrunk"], m, t)
        rects = transform_points(batch["rects"], m, t)
        sorted_rects, angles = sort_rectangle_torch(rects)
        live = batch["valid"][..., None, None]
        out["rects"] = torch.where(live, sorted_rects, batch["rects"])
        out["angles"] = torch.where(batch["valid"], angles, batch["angles"])
    return out
