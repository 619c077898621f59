"""ICDAR-2015 data: the readers, the host-side sample, and the synthetic
tiers.

Port of ``tensorflow_ocr_tpu/data/icdar.py`` without ``cv2`` (its calls
are ``data/codec.py``'s):

- ``get_images`` :38, ``load_annotation`` :45, ``gt_path_for_image`` :68;
- ``crop_area`` :75 and ``rotate_image_and_polys`` :124;
- :class:`Sample` :137, ``_pad_polys`` :151, ``east_poly_geometry`` :163;
- ``_read_image`` :202 with its decode cache (per process, bounded);
- ``prepare_sample`` :222: the same file and ``np.random.RandomState``
  give the same scale, rotation and crop, because the draws are made in
  JAX's order;
- ``_chars_along`` :293, ``_v2_instance`` :308, ``_gt_coords`` :487 and
  ``make_synthetic_dataset`` :497 for ``hard=False``, ``True`` (v1),
  ``"v2"`` and the photo tiers (``_photo_sources`` :359,
  ``_photo_background`` :424, ``_render_photo_instance`` :454: the v2
  instances over photographs shipped inside installed packages), every
  draw in JAX's order, so the ``gt_img_*.txt`` files come out byte-equal
  (``tests/test_torch_synthetic.py``, ``tests/test_torch_photo.py``).
"""

from __future__ import annotations

import csv
import glob
import os
import threading
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from tensorflow_ocr_tpu_torch.config import DataConfig
from tensorflow_ocr_tpu_torch.data import codec
from tensorflow_ocr_tpu_torch.ops import geometry as G


def get_images(data_path: str) -> List[str]:
    """The .jpg, .png, .jpeg and .JPG files of a directory, sorted."""
    files: List[str] = []
    for ext in ["jpg", "png", "jpeg", "JPG"]:
        files.extend(glob.glob(os.path.join(data_path, f"*.{ext}")))
    return sorted(files)


def load_annotation(p: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse a gt_*.txt: 8 coords and a label a line; ### and * are
    ignored (tags True). A missing file has no polygons."""
    polys, tags = [], []
    if not os.path.exists(p):
        return np.zeros((0, 4, 2), np.float32), np.zeros((0,), bool)
    with open(p, "r", encoding="utf-8-sig", newline="") as f:
        for line in csv.reader(f):
            if not line:
                continue
            label = line[-1].strip()
            vals = [v.strip().lstrip("\ufeff") for v in line[:8]]
            x1, y1, x2, y2, x3, y3, x4, y4 = map(float, vals)
            polys.append([[x1, y1], [x2, y2], [x3, y3], [x4, y4]])
            tags.append(label in ("*", "###"))
    if not polys:
        return np.zeros((0, 4, 2), np.float32), np.zeros((0,), bool)
    return np.array(polys, np.float32), np.array(tags, bool)


# the reference's (misspelled) public name
load_annoataion = load_annotation


def gt_path_for_image(im_fn: str) -> str:
    """dir/gt_<stem>.txt (reference icdar.py:564)."""
    d, base = os.path.split(im_fn)
    stem = base[: base.rfind(".")]
    return os.path.join(d, f"gt_{stem}.txt")


def crop_area(im, polys, tags, crop_background=False, max_tries=50,
              min_crop_side_ratio=0.1,
              rng: Optional[np.random.RandomState] = None):
    """Random crop that cuts no text (reference icdar.py:138-199)."""
    rng = rng or np.random
    h, w, _ = im.shape
    pad_h, pad_w = h // 10, w // 10
    h_array = np.zeros((h + pad_h * 2,), np.int32)
    w_array = np.zeros((w + pad_w * 2,), np.int32)
    for poly in polys:
        p = np.round(poly).astype(np.int32)
        w_array[p[:, 0].min() + pad_w: p[:, 0].max() + pad_w] = 1
        h_array[p[:, 1].min() + pad_h: p[:, 1].max() + pad_h] = 1
    h_axis = np.where(h_array == 0)[0]
    w_axis = np.where(w_array == 0)[0]
    if len(h_axis) == 0 or len(w_axis) == 0:
        return im, polys, tags
    for _ in range(max_tries):
        xx = rng.choice(w_axis, size=2)
        xmin, xmax = np.clip(np.sort(xx) - pad_w, 0, w - 1)
        yy = rng.choice(h_axis, size=2)
        ymin, ymax = np.clip(np.sort(yy) - pad_h, 0, h - 1)
        if (xmax - xmin < min_crop_side_ratio * w
                or ymax - ymin < min_crop_side_ratio * h):
            continue
        if polys.shape[0] != 0:
            in_area = (
                (polys[:, :, 0] >= xmin) & (polys[:, :, 0] <= xmax)
                & (polys[:, :, 1] >= ymin) & (polys[:, :, 1] <= ymax)
            )
            selected = np.where(in_area.sum(axis=1) == 4)[0]
        else:
            selected = np.array([], np.int64)
        if len(selected) == 0:
            if crop_background:
                return (im[ymin:ymax + 1, xmin:xmax + 1], polys[selected],
                        tags[selected])
            continue
        im = im[ymin:ymax + 1, xmin:xmax + 1]
        polys = polys[selected].copy()
        tags = tags[selected]
        polys[:, :, 0] -= xmin
        polys[:, :, 1] -= ymin
        return im, polys, tags
    return im, polys, tags


def rotate_image_and_polys(im, polys, deg, rng=None):
    """Rotate the image by ``deg`` about its centre (same size, black
    corners) and its polygons with it."""
    h, w = im.shape[:2]
    m = codec.get_rotation_matrix_2d((w / 2, h / 2), deg, 1.0)
    im = codec.warp_affine(im, m, (w, h))
    if polys.shape[0]:
        ones = np.ones((*polys.shape[:2], 1), np.float32)
        hom = np.concatenate([polys, ones], axis=2)  # (K, 4, 3)
        polys = hom @ m.T.astype(np.float32)
    return im, polys


@dataclass
class Sample:
    """One prepared training sample (host side; the labels are made on the
    device)."""

    image: np.ndarray      # (H, W, 3) uint8 RGB
    polys: np.ndarray      # (K, 4, 2) float32, zero-padded
    tags: np.ndarray       # (K,) bool: ignored
    valid: np.ndarray      # (K,) bool: a polygon in the slot
    # EAST extras (zeros when not requested)
    shrunk: np.ndarray     # (K, 4, 2)
    rects: np.ndarray      # (K, 4, 2)
    angles: np.ndarray     # (K,)
    fn: str = ""


def _pad_polys(polys, tags, max_polys: int):
    """(N, 4, 2) polygons and (K,) ignore tags -> the first ``max_polys``
    of them in fixed slots: polys (max_polys, 4, 2) float32, tags and
    valid (max_polys,) bool."""
    k = min(len(polys), max_polys)
    out_p = np.zeros((max_polys, 4, 2), np.float32)
    out_t = np.zeros((max_polys,), bool)
    out_v = np.zeros((max_polys,), bool)
    if k:
        out_p[:k] = polys[:k]
        out_t[:k] = tags[:k]
        out_v[:k] = True
    return out_p, out_t, out_v


def east_poly_geometry(polys: np.ndarray):
    """Per-polygon EAST shrink and rectangle fit (icdar.py:163-195):
    (K, 4, 2) padded polygons -> shrunk polygons (K, 4, 2), fitted
    rectangles sorted clockwise from the top left (K, 4, 2) and their
    angles (K,). An all-zero slot stays zero; a polygon the fit fails on
    keeps itself as its shrunk polygon and rectangle, angle 0."""
    k = polys.shape[0]
    shrunk = np.zeros_like(polys)
    rects = np.zeros_like(polys)
    angles = np.zeros((k,), np.float32)
    for i in range(k):
        poly = polys[i]
        if not poly.any():
            continue
        r = np.array(
            [
                min(np.linalg.norm(poly[j] - poly[(j + 1) % 4]),
                    np.linalg.norm(poly[j] - poly[(j - 1) % 4]))
                for j in range(4)
            ]
        )
        try:
            shrunk[i] = G.shrink_poly(poly, r)
            fitted = G.rectangle_from_parallelogram(poly)
            rect, angle = G.sort_rectangle(fitted)
            rects[i] = rect
            angles[i] = angle
        except Exception:
            shrunk[i] = poly
            rects[i] = poly
    return shrunk, rects, angles


# decoded frames by path, per process; the oldest entry goes first once
# _DECODE_CACHE_MAX are held
_DECODE_CACHE: dict = {}
_DECODE_CACHE_MAX = 256
_DECODE_CACHE_LOCK = threading.Lock()  # loader threads share the cache


def _read_image(im_fn: str, cache: bool):
    """The BGR frame of ``im_fn`` (codec.imread), from the decode cache
    when ``cache`` and it is there; None when unreadable."""
    if cache:
        with _DECODE_CACHE_LOCK:
            hit = _DECODE_CACHE.get(im_fn)
        if hit is not None:
            return hit
    im = codec.imread(im_fn)
    if cache and im is not None:
        with _DECODE_CACHE_LOCK:
            if len(_DECODE_CACHE) >= _DECODE_CACHE_MAX:
                _DECODE_CACHE.pop(next(iter(_DECODE_CACHE)))
            _DECODE_CACHE[im_fn] = im
    return im


def prepare_sample(im_fn: str, cfg: DataConfig,
                   rng: Optional[np.random.RandomState] = None,
                   want_east: bool = False) -> Optional[Sample]:
    """Load, augment and resize one image to ``cfg.input_size`` square;
    the polygons in the resized image's coordinates. None where the image
    or its gt file is missing, or no polygon survives (a background crop
    that still holds text included)."""
    rng = rng or np.random.RandomState()
    im = _read_image(im_fn, getattr(cfg, "cache_decoded_images", True))
    if im is None:
        return None
    h, w = im.shape[:2]
    txt_fn = gt_path_for_image(im_fn)
    if not os.path.exists(txt_fn):
        return None
    polys, tags = load_annotation(txt_fn)
    polys, tags = G.check_and_validate_polys(polys, tags, (h, w))

    if cfg.use_random_scale and polys.shape[0]:
        sc = float(rng.choice(np.asarray(cfg.random_scale)))
        im = codec.resize(im, fx=sc, fy=sc)
        polys = polys * sc
    if cfg.use_rotate:
        deg = float(rng.uniform(-cfg.max_rotate_deg, cfg.max_rotate_deg))
        im, polys = rotate_image_and_polys(im, polys, deg, rng)
        polys, tags = G.check_and_validate_polys(polys, tags, im.shape[:2])
    size = cfg.input_size
    if cfg.use_crop and rng.rand() < cfg.background_ratio:
        # a text-free crop, padded square, trained as pure negatives
        im, polys, tags = crop_area(
            im, polys, tags, crop_background=True,
            min_crop_side_ratio=cfg.min_crop_side_ratio, rng=rng)
        if polys.shape[0] > 0:
            return None
        new_h, new_w = im.shape[:2]
        side = max(new_h, new_w, size)
        im_padded = np.zeros((side, side, 3), im.dtype)
        im_padded[:new_h, :new_w] = im
        im = codec.resize(im_padded, (size, size))
        polys = np.zeros((0, 4, 2), np.float32)
        tags = np.zeros((0,), bool)
    else:
        if cfg.use_crop:
            im, polys, tags = crop_area(
                im, polys, tags, crop_background=False,
                min_crop_side_ratio=cfg.min_crop_side_ratio, rng=rng)
        if polys.shape[0] == 0:
            return None
        new_h, new_w = im.shape[:2]
        im = codec.resize(np.ascontiguousarray(im), (size, size))
        polys = polys.copy()
        polys[:, :, 0] *= size / float(new_w)
        polys[:, :, 1] *= size / float(new_h)

    padded, ptags, pvalid = _pad_polys(polys, tags, cfg.max_polys)
    if want_east:
        shrunk, rects, angles = east_poly_geometry(padded)
    else:
        shrunk = np.zeros_like(padded)
        rects = np.zeros_like(padded)
        angles = np.zeros((cfg.max_polys,), np.float32)
    return Sample(
        image=np.ascontiguousarray(im[:, :, ::-1]),  # BGR -> RGB
        polys=padded, tags=ptags, valid=pvalid,
        shrunk=shrunk, rects=rects, angles=angles, fn=im_fn)


# --------------------------------------------------------------------------
# the synthetic tiers
# --------------------------------------------------------------------------


def _chars_along(ctr, ux, uy, n_ch, ch_w, ch_h, pitch):
    """Character quads placed along direction ux with the given pitch."""
    out = []
    for c in range(n_ch):
        off = (c - (n_ch - 1) / 2.0) * pitch
        cc = ctr + ux * off
        out.append(np.stack([
            cc + ux * ch_w / 2 + uy * ch_h / 2,
            cc - ux * ch_w / 2 + uy * ch_h / 2,
            cc - ux * ch_w / 2 - uy * ch_h / 2,
            cc + ux * ch_w / 2 - uy * ch_h / 2,
        ]))
    return out


def _v2_instance(rng, h, w, cx, cy, bh, ang_deg, kind=None):
    """One v2 text instance at (cx, cy): (char quads, gt quad). ``kind``
    0 straight, 1 curved baseline, 2 perspective (drawn when None). The
    gt quad is the min-area rectangle of the character quads."""
    ang = np.deg2rad(ang_deg)
    ux = np.array([np.cos(ang), np.sin(ang)])
    uy = np.array([-ux[1], ux[0]])
    n_ch = rng.randint(3, 9)
    pitch = bh * rng.uniform(0.7, 0.95)
    ch_w, ch_h = pitch * 0.6, bh * rng.uniform(0.6, 0.8)
    ctr = np.array([cx, cy], np.float32)
    if kind is None:
        kind = rng.randint(3)
    chars = _chars_along(ctr, ux, uy, n_ch, ch_w, ch_h, pitch)
    if kind == 1:
        # a parabolic bow along uy, each character wobbled
        bow = bh * rng.uniform(0.6, 1.6) * rng.choice([-1.0, 1.0])
        for c in range(n_ch):
            t = c / max(n_ch - 1, 1) * 2 - 1
            disp = uy * bow * (1 - t * t)
            rot = np.deg2rad(rng.uniform(-12, 12))
            cr, sr = np.cos(rot), np.sin(rot)
            m = np.array([[cr, -sr], [sr, cr]])
            cc = chars[c].mean(0)
            chars[c] = (chars[c] - cc) @ m.T + cc + disp
    elif kind == 2:
        # a random homography anchored on the instance's box
        ext = n_ch * pitch / 2 + ch_w
        src = np.array([ctr + ux * ext + uy * bh, ctr - ux * ext + uy * bh,
                        ctr - ux * ext - uy * bh, ctr + ux * ext - uy * bh],
                       np.float32)
        dst = src + rng.uniform(-0.22, 0.22, (4, 2)).astype(np.float32) * \
            np.array([ext, bh], np.float32)
        H = codec.get_perspective_transform(src, dst)
        pts = np.concatenate(chars).astype(np.float32).reshape(-1, 1, 2)
        warped = codec.perspective_transform(pts, H).reshape(-1, 4, 2)
        chars = [warped[c] for c in range(n_ch)]
    allpts = np.concatenate(chars).astype(np.float32)
    rect = codec.box_points(codec.min_area_rect(allpts))
    c0 = allpts.mean(0)
    rect = rect[np.argsort(np.arctan2(rect[:, 1] - c0[1],
                                      rect[:, 0] - c0[0]))]
    return chars, rect


def _gt_coords(quad: np.ndarray, w: int, h: int) -> str:
    """A quad as ICDAR gt coords, rounded and clamped to the canvas."""
    pts = np.asarray(quad, np.float64).reshape(-1, 2)
    xs = np.clip(np.round(pts[:, 0]), 0, w - 1).astype(int)
    ys = np.clip(np.round(pts[:, 1]), 0, h - 1).astype(int)
    return ",".join(str(v) for xy in zip(xs, ys) for v in xy)


def _render_plate_instance(rng, im, chars, rect) -> None:
    """The v2 tier's rendering of one instance (in place): a bright plate
    over the characters' hull, the characters in dark ink."""
    allpts = np.concatenate(chars).astype(np.int32)
    hull = codec.convex_hull(allpts)
    plate = tuple(int(c) for c in rng.randint(190, 255, 3))
    codec.fill_poly(im, [hull], plate)
    ink = (int(plate[0] * 0.2),) * 3
    for cb in chars:
        codec.fill_poly(im, [cb.astype(np.int32)], ink)


def _photo_sources(tier: str = "photo") -> dict:
    """Photographs shipped inside installed packages, in disjoint train
    and val sets (icdar.py:359-421): ``"photo"`` the 4 + 4 photographs of
    sklearn, matplotlib and pygame, ``"photo2"`` those and the textures of
    dm_control and gymnasium_robotics (near-duplicates on one side).
    Only the files that exist are listed."""
    import sysconfig

    site = sysconfig.get_paths()["purelib"]
    cands = {
        "train": [
            "sklearn/datasets/images/china.jpg",
            "sklearn/datasets/images/flower.jpg",
            "matplotlib/mpl-data/sample_data/grace_hopper.jpg",
            "pygame/docs/generated/_images/intro_freedom.jpg",
        ],
        "val": [
            "pygame/docs/generated/_images/intro_blade.jpg",
            "pygame/docs/generated/_images/camera_rgb.jpg",
            "pygame/docs/generated/_images/camera_background.jpg",
            "pygame/examples/data/alien1.jpg",
        ],
    }
    if tier == "photo2":
        tex = "gymnasium_robotics/envs/assets/"
        kitchen = tex + "kitchen_franka/kitchen_assets/textures/"
        hand = tex + "adroit_hand/resources/textures/"
        out = "dm_control/locomotion/arenas/assets/outdoor_natural/"
        cands["train"] += [
            kitchen + "wood1.png", kitchen + "white_marble_tile.png",
            kitchen + "white_marble_tile2.png",
            out + "OutdoorGrassFloorD.png",
            "dm_control/suite/dog_assets/skin_texture.png",
        ]
        cands["val"] += [
            kitchen + "tile1.png", hand + "silverRaw.png", hand + "skin.png",
            out + "OutdoorSkybox2048.png",
        ]
    return {k: [os.path.join(site, p) for p in v
                if os.path.exists(os.path.join(site, p))]
            for k, v in cands.items()}


def _photo_background(rng, h, w, split: str,
                      tier: str = "photo") -> np.ndarray:
    """A random crop of the target's aspect from one of the split's
    photographs, resized to (h, w), randomly flipped, with a random gain
    and bias (icdar.py:424-451); BGR uint8."""
    paths = _photo_sources(tier)[split]
    if not paths:
        raise FileNotFoundError(
            f"no package photographs of the {tier!r} tier's {split} split "
            "(sklearn, matplotlib, pygame, dm_control, gymnasium_robotics)")
    src = codec.imread(paths[rng.randint(len(paths))])
    sh, sw = src.shape[:2]
    frac = rng.uniform(0.55, 1.0)
    ch = int(sh * frac)
    cw = int(round(ch * w / h))
    if cw > sw:
        cw = sw
        ch = int(round(cw * h / w))
    y0 = rng.randint(0, max(sh - ch, 0) + 1)
    x0 = rng.randint(0, max(sw - cw, 0) + 1)
    crop = src[y0:y0 + ch, x0:x0 + cw]
    if rng.rand() < 0.5:
        crop = crop[:, ::-1]
    im = codec.resize(np.ascontiguousarray(crop), (w, h))
    gain = rng.uniform(0.75, 1.15)
    bias = rng.uniform(-18, 18)
    return np.clip(im.astype(np.float32) * gain + bias, 0, 255) \
        .astype(np.uint8)


def _render_photo_instance(rng, im, chars, rect) -> None:
    """One instance composited onto the photograph (in place;
    icdar.py:454-486): ink that contrasts the local mean, edges blended
    through a blurred alpha mask, a sign plate under 30% of them."""
    h, w = im.shape[:2]
    hull = codec.convex_hull(np.concatenate(chars).astype(np.int32))
    region = np.zeros((h, w), np.uint8)
    codec.fill_poly(region, [hull], 1)
    local_mean = float(im[region > 0].mean()) if region.any() else 127.0
    if rng.rand() < 0.3:  # sign plate
        plate_lum = 220 if local_mean < 140 else 40
        plate = np.clip(plate_lum + rng.randint(-25, 26, 3), 0, 255)
        pm = codec.gaussian_blur(region.astype(np.float32), 0.8)
        im[:] = (im * (1 - pm[..., None])
                 + plate[None, None, :] * pm[..., None]).astype(np.uint8)
        local_mean = float(plate.mean())
    ink_lum = rng.randint(170, 256) if local_mean < 128 else \
        rng.randint(0, 86)
    ink = np.clip(ink_lum + rng.randint(-40, 41, 3), 0, 255) \
        .astype(np.float32)
    mask = np.zeros((h, w), np.uint8)
    for cb in chars:
        codec.fill_poly(mask, [np.round(cb).astype(np.int32)], 1)
    alpha = codec.gaussian_blur(mask.astype(np.float32), 0.9)
    alpha *= rng.uniform(0.8, 1.0)
    im[:] = (im * (1 - alpha[..., None])
             + ink[None, None, :] * alpha[..., None]).astype(np.uint8)


def _v2_scene(rng, im, h, w, render=_render_plate_instance) -> List[str]:
    """The v2 tier's instances drawn into ``im`` by ``render``: blocks of
    parallel lines and single (straight, curved or perspective) instances
    at log-uniform heights from 7 px to h/3, placed without overlap;
    returns the gt lines."""
    insts = []
    placed = []  # axis-aligned boxes of the accepted instances

    def overlaps(rect):
        x0, y0 = rect.min(0)
        x1, y1 = rect.max(0)
        for (a0, b0, a1, b1) in placed:
            ix = max(0, min(x1, a1) - max(x0, a0))
            iy = max(0, min(y1, b1) - max(y0, b0))
            if ix * iy > 0.05 * min((x1 - x0) * (y1 - y0),
                                    (a1 - a0) * (b1 - b0)):
                return True
        return False

    def register(rect):
        x0, y0 = rect.min(0)
        x1, y1 = rect.max(0)
        placed.append((x0, y0, x1, y1))

    for _ in range(rng.randint(3, 7)):
        for _try in range(8):  # retry the placement on overlap
            bh_i = float(np.exp(rng.uniform(np.log(7.0), np.log(h / 3.0))))
            ext = min(4.0 * bh_i, w / 2.0 - 2)
            cx = rng.uniform(ext, w - ext)
            cy = rng.uniform(ext / 2, h - ext / 2)
            ang = rng.uniform(-60, 60)
            if rng.rand() < 0.4 and bh_i < h / 8:
                # dense crowding: 3-5 parallel lines, small gaps
                n_lines = rng.randint(3, 6)
                gap = bh_i * rng.uniform(1.25, 1.7)
                a = np.deg2rad(ang)
                uy = np.array([-np.sin(a), np.cos(a)])
                block = []
                for li in range(n_lines):
                    off = (li - (n_lines - 1) / 2.0) * gap
                    block.append(_v2_instance(
                        rng, h, w, cx + uy[0] * off, cy + uy[1] * off, bh_i,
                        ang, kind=0))
                hull_pts = np.concatenate(
                    [r for _, r in block]).astype(np.float32)
                if overlaps(hull_pts):
                    continue
                register(hull_pts)
                insts.extend((c, r, bh_i) for c, r in block)
            else:
                chars, rect = _v2_instance(rng, h, w, cx, cy, bh_i, ang)
                if overlaps(rect):
                    continue
                register(rect)
                insts.append((chars, rect, bh_i))
            break
    lines = []
    for chars, rect, bh_i in insts:
        render(rng, im, chars, rect)
        # unreadably small instances are don't-care (ICDAR's ###)
        tag = "###" if bh_i < 8.5 or rng.rand() < 0.15 else "text"
        lines.append(f"{_gt_coords(rect, w, h)},{tag}")
    return lines


def _v1_background(rng, h, w) -> np.ndarray:
    """The v1 tier's background: a low-frequency gradient with noise, and
    2-5 bright distractors (discs, thick lines, squares)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = (40 + 30 * np.sin(xx / w * rng.uniform(2, 8))
            + 30 * np.cos(yy / h * rng.uniform(2, 8)))
    im = np.clip(base[..., None] + rng.randn(h, w, 3) * 12, 0, 120
                 ).astype(np.uint8)
    for _ in range(rng.randint(2, 6)):
        kind = rng.randint(3)
        col = tuple(int(c) for c in rng.randint(160, 255, 3))
        if kind == 0:
            codec.circle(im, (rng.randint(0, w), rng.randint(0, h)),
                         rng.randint(8, 40), col, -1)
        elif kind == 1:
            p0 = (rng.randint(0, w), rng.randint(0, h))
            p1 = (rng.randint(0, w), rng.randint(0, h))
            codec.line(im, p0, p1, col, rng.randint(2, 5))
        else:
            cx0, cy0 = rng.randint(0, w), rng.randint(0, h)
            s = rng.randint(10, 30)
            codec.rectangle(im, (cx0, cy0), (cx0 + s, cy0 + s), col, -1)
    return im


def make_synthetic_dataset(path: str, num_images: int = 10,
                           size: Tuple[int, int] = (480, 640),
                           seed: int = 0, hard=False,
                           start_index: int = 0) -> List[str]:
    """Write a synthetic ICDAR-format dataset: ``img_<i>.jpg`` and
    ``gt_img_<i>.txt`` for i from ``start_index``; returns the image paths.

    ``hard=False``: noise and 1-5 white rotated boxes. ``hard=True`` (v1):
    a textured background, distractors, 3-10 striped plates, ### regions.
    ``hard="v2"``: perspective, curved, crowded and extreme-scale
    instances. ``hard="photo:train"``/``"photo:val"`` (``"photo"`` alone is
    the train split) and ``"photo2:…"``: the v2 instances composited over
    a split's package photographs (:func:`_photo_sources`), written at a
    random JPEG quality from 60 to 92.
    """
    photo = isinstance(hard, str) and hard.startswith("photo")
    if photo:
        tier, _, split = hard.partition(":")
        split = split or "train"
        if tier not in ("photo", "photo2") or split not in ("train", "val"):
            raise ValueError(f"photo tier {hard!r}: photo[2][:train|val]")
    elif hard not in (False, True, "v2"):
        raise ValueError(f"hard must be False, True, 'v2' or a photo tier, "
                         f"got {hard!r}")
    os.makedirs(path, exist_ok=True)
    rng = np.random.RandomState(seed)
    h, w = size
    files = []
    for i in range(start_index, start_index + num_images):
        if photo:
            im = _photo_background(rng, h, w, split, tier)
            lines = _v2_scene(rng, im, h, w, _render_photo_instance)
            fn = os.path.join(path, f"img_{i}.jpg")
            # variable compression, like camera and web imagery
            codec.imwrite(fn, im, quality=int(rng.randint(60, 93)))
            with open(os.path.join(path, f"gt_img_{i}.txt"), "w") as f:
                f.write("\n".join(lines) + "\n")
            files.append(fn)
            continue
        if hard:
            im = _v1_background(rng, h, w)
            n_inst, max_ang = rng.randint(3, 11), 60
        else:
            im = rng.randint(0, 80, (h, w, 3), np.uint8)
            n_inst, max_ang = rng.randint(1, 6), 30
        lines = []
        if hard == "v2":
            lines = _v2_scene(rng, im, h, w)
            n_inst = 0  # the v1 instance loop below is skipped
        for _ in range(n_inst):
            mx, my = max(w // 6, 16), max(h // 6, 12)
            cx, cy = rng.randint(mx, w - mx), rng.randint(my, h - my)
            bw = rng.randint(max(w // 12, 8), max(w // 4, 16))
            bh = rng.randint(max(h // 24, 6), max(h // 10, 10))
            ang = rng.uniform(-max_ang, max_ang)
            box = codec.box_points(((cx, cy), (bw, bh), ang))
            box = box[np.argsort(np.arctan2(box[:, 1] - cy, box[:, 0] - cx))]
            if hard:
                # striped characters on a bright plate
                plate = tuple(int(c) for c in rng.randint(190, 255, 3))
                codec.fill_poly(im, [box.astype(np.int32)], plate)
                n_ch = max(2, int(round(bw / max(bh * 0.7, 4))))
                ux = np.array([np.cos(np.deg2rad(ang)),
                               np.sin(np.deg2rad(ang))])
                uy = np.array([-ux[1], ux[0]])
                for c in range(n_ch):
                    off = (c - (n_ch - 1) / 2.0) * (bw / max(n_ch, 1))
                    ctr = np.array([cx, cy]) + ux * off
                    cw, chh = bw / max(n_ch, 1) * 0.55, bh * 0.6
                    cb = np.stack([
                        ctr + ux * cw / 2 + uy * chh / 2,
                        ctr - ux * cw / 2 + uy * chh / 2,
                        ctr - ux * cw / 2 - uy * chh / 2,
                        ctr + ux * cw / 2 - uy * chh / 2,
                    ])
                    codec.fill_poly(im, [cb.astype(np.int32)],
                                    (int(plate[0] * 0.2),) * 3)
                tag = "###" if rng.rand() < 0.2 else "text"
            else:
                codec.fill_poly(im, [box.astype(np.int32)], (255, 255, 255))
                tag = "###" if rng.rand() < 0.15 else "text"
            lines.append(f"{_gt_coords(box, w, h)},{tag}")
        fn = os.path.join(path, f"img_{i}.jpg")
        codec.imwrite(fn, im)
        with open(os.path.join(path, f"gt_img_{i}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
        files.append(fn)
    return files
