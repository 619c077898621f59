"""Image files, geometry and drawing without ``cv2``.

The JAX package's data tier (``tensorflow_ocr_tpu/data/icdar.py``) reads,
warps and draws through OpenCV. The port imports no ``cv2``: these are
the calls it used, in numpy and torch on the host (and PIL for the
files), with OpenCV's arithmetic where it decides the result:

- :func:`imread` returns HWC uint8 in BGR, as ``cv2.imread`` does (EXIF
  orientation applied, grey and palette images as three channels), so
  that ``prepare_sample``'s ``[:, :, ::-1]`` keeps its meaning;
  :func:`imwrite` writes ``.jpg`` at cv2's default quality 95 (4:2:0)
  and ``.png``. Both go through PIL, on the CPU and on the card's host
  alike; the card's batch decode is ``data/nvjpeg_loader.py``;
- :func:`resize` is ``cv2.resize(INTER_LINEAR)`` on uint8 in cv2's fixed
  point: 11-bit weights, the vector path's rounding, the 2x downscale
  that cv2 hands to ``INTER_AREA``;
- :func:`warp_affine` is ``cv2.warpAffine`` (bilinear, constant-0
  border) as OpenCV 5 computes it, in float32;
- :func:`fill_poly` is ``cv2.fillPoly`` (LINE_8): the spans of cv2's edge
  walk in 16.16 fixed point, plus the outline drawn by its Bresenham line
  (equal to cv2 inside the image; an edge clipped at the border may
  differ by a pixel);
  :func:`circle` and :func:`rectangle` (filled) and :func:`line` draw as
  cv2 does (a thick line approximately: its quad and round caps);
- :func:`convex_hull`, :func:`min_area_rect`, :func:`box_points`,
  :func:`get_perspective_transform`, :func:`perspective_transform`,
  :func:`get_rotation_matrix_2d` and :func:`gaussian_blur` (3x3).

None of these is a Pallas site: they are host code, as the cv2 calls
were. ``tests/test_torch_codec.py`` holds each against cv2 with the
tolerance it states.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

JPEG_QUALITY = 95  # cv2.IMWRITE_JPEG_QUALITY's default

XY_SHIFT = 16  # cv2's drawing fixed point (drawing.cpp)
XY_ONE = 1 << XY_SHIFT
RESIZE_COEF_BITS = 11  # cv2's INTER_RESIZE_COEF_BITS


# --------------------------------------------------------------------------
# files
# --------------------------------------------------------------------------


def imread(path: str) -> Optional[np.ndarray]:
    """(H, W, 3) uint8 BGR, or None where the file is missing or not an
    image (``cv2.imread``'s contract)."""
    from PIL import Image, ImageOps, UnidentifiedImageError

    try:
        with Image.open(path) as im:
            im = ImageOps.exif_transpose(im)
            rgb = np.asarray(im.convert("RGB"))
    except (OSError, UnidentifiedImageError, ValueError):
        return None
    return np.ascontiguousarray(rgb[:, :, ::-1])


def imwrite(path: str, img: np.ndarray, quality: int = JPEG_QUALITY) -> bool:
    """Write an (H, W, 3) uint8 BGR or (H, W) image; ``.jpg``/``.jpeg`` as
    baseline JPEG at ``quality`` with 4:2:0 chroma (cv2's defaults), any
    other extension losslessly by PIL (``.png``)."""
    from PIL import Image

    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"imwrite takes uint8, got {img.dtype}")
    arr = img[:, :, ::-1] if img.ndim == 3 else img
    out = Image.fromarray(np.ascontiguousarray(arr))
    if os.path.splitext(path)[1].lower() in (".jpg", ".jpeg"):
        out.save(path, format="JPEG", quality=int(quality), subsampling=2)
    else:
        out.save(path)
    return True


# --------------------------------------------------------------------------
# resize and warp
# --------------------------------------------------------------------------


def _cv_round(x):
    """cvRound: round half to even (lrint), as int64."""
    return np.rint(x).astype(np.int64)


def _linear_taps(n_out: int, n_in: int, scale: float,
                 clamp_weights: bool = True):
    """cv2's INTER_LINEAR source indices and 11-bit weights along one
    axis (resize.cpp ``resizeGeneric``: the float position,
    ``saturate_cast<short>(w * 2048)``). Along x (``clamp_weights``) cv2
    clamps a position outside the image to the border pixel with weights
    (2048, 0); along y it keeps the unclamped fraction's weights and
    clamps only the two row indices, so at the first and last rows both
    taps read one row with weights that may sum to 2047, and the vector
    path's two truncations may lose a level."""
    f = ((np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5).astype(
        np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp_weights:
        low = s < 0
        f[low], s[low] = 0, 0
        high = s >= n_in - 1
        f[high], s[high] = 0, n_in - 1
    scale_q = float(1 << RESIZE_COEF_BITS)
    w0 = _cv_round((np.float32(1) - f) * np.float32(scale_q))
    w1 = _cv_round(f * np.float32(scale_q))
    return np.clip(s, 0, n_in - 1), np.clip(s + 1, 0, n_in - 1), w0, w1


def resize_plan(w: int, h: int, dsize: Optional[Tuple[int, int]] = None,
                fx: float = 0.0, fy: float = 0.0):
    """cv2.resize's output size and coordinate scales for a (w, h) source:
    ``(dw, dh, sx, sy, area2)``; ``dsize`` is (width, height), without it
    the size is ``round(w * fx), round(h * fy)`` and the scale is 1/fx
    exactly; ``area2`` marks the exact 2x downscale that cv2 hands to
    INTER_AREA."""
    if dsize:
        dw, dh = int(dsize[0]), int(dsize[1])
        inv_x, inv_y = dw / w, dh / h
    else:
        inv_x, inv_y = float(fx), float(fy)
        dw, dh = int(_cv_round(w * inv_x)), int(_cv_round(h * inv_y))
    sx, sy = 1.0 / inv_x, 1.0 / inv_y
    area2 = sx == 2 and sy == 2 and dw * 2 <= w and dh * 2 <= h
    return dw, dh, sx, sy, area2


def resize(img: np.ndarray, dsize: Optional[Tuple[int, int]] = None,
           fx: float = 0.0, fy: float = 0.0) -> np.ndarray:
    """``cv2.resize(img, dsize, fx=fx, fy=fy)`` with INTER_LINEAR on uint8
    (H, W) or (H, W, C) (:func:`resize_plan`)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"resize takes uint8, got {img.dtype}")
    h, w = img.shape[:2]
    dw, dh, sx, sy, area2 = resize_plan(w, h, dsize, fx, fy)
    if (dw, dh) == (w, h):
        return img.copy()
    if area2:
        # cv2 takes INTER_AREA here: the mean of each 2x2 block, rounded
        src = img.astype(np.int64)
        s = (src[0:2 * dh:2, 0:2 * dw:2] + src[0:2 * dh:2, 1:2 * dw:2]
             + src[1:2 * dh:2, 0:2 * dw:2] + src[1:2 * dh:2, 1:2 * dw:2])
        return ((s + 2) >> 2).astype(np.uint8)
    x0, x1, a0, a1 = _linear_taps(dw, w, sx)
    y0, y1, b0, b1 = _linear_taps(dh, h, sy, clamp_weights=False)
    t = torch.from_numpy(np.ascontiguousarray(img)).to(torch.int32)
    ea = (slice(None),) + (None,) * (img.ndim - 2)
    a0, a1 = torch.from_numpy(a0[ea]).int(), torch.from_numpy(a1[ea]).int()
    rows = (t[:, torch.from_numpy(x0)] * a0
            + t[:, torch.from_numpy(x1)] * a1)  # (h, dw, C), x2048
    eb = (slice(None),) + (None,) * (img.ndim - 1)
    b0, b1 = torch.from_numpy(b0[eb]).int(), torch.from_numpy(b1[eb]).int()
    # the vector path of VResizeLinear (32s -> 8u): each row >> 4, the
    # high half of a 16x16 product, then (sum + 2) >> 2
    top = ((rows[torch.from_numpy(y0)] >> 4) * b0) >> 16
    bot = ((rows[torch.from_numpy(y1)] >> 4) * b1) >> 16
    return ((top + bot + 2) >> 2).clamp(0, 255).to(torch.uint8).numpy()


def get_rotation_matrix_2d(center: Tuple[float, float], angle: float,
                           scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: (2, 3) float64, ``angle`` in degrees
    counter-clockwise."""
    a = math.radians(angle)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]],
                    np.float64)


def invert_affine_transform(m: np.ndarray) -> np.ndarray:
    """``cv2.invertAffineTransform`` in float64."""
    m = np.asarray(m, np.float64)
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[1, 1] * d, m[0, 0] * d
    a12, a21 = -m[0, 1] * d, -m[1, 0] * d
    b1 = -a11 * m[0, 2] - a12 * m[1, 2]
    b2 = -a21 * m[0, 2] - a22 * m[1, 2]
    return np.array([[a11, a12, b1], [a21, a22, b2]], np.float64)


def warp_affine(img: np.ndarray, m: np.ndarray,
                dsize: Tuple[int, int]) -> np.ndarray:
    """``cv2.warpAffine(img, m, dsize)``: bilinear, border constant 0, on
    uint8 (H, W) or (H, W, C). As OpenCV 5 computes it: the inverse matrix
    in float32, each destination pixel's source position and the four
    weights in float32, taps outside the image read 0, rounded to
    nearest."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"warp_affine takes uint8, got {img.dtype}")
    h, w = img.shape[:2]
    dw, dh = int(dsize[0]), int(dsize[1])
    mi = torch.from_numpy(invert_affine_transform(m).astype(np.float32))
    ys, xs = torch.meshgrid(torch.arange(dh, dtype=torch.float32),
                            torch.arange(dw, dtype=torch.float32),
                            indexing="ij")
    sx = mi[0, 0] * xs + mi[0, 1] * ys + mi[0, 2]
    sy = mi[1, 0] * xs + mi[1, 1] * ys + mi[1, 2]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    extra = (None,) * (img.ndim - 2)
    fx, fy = (sx - x0)[(...,) + extra], (sy - y0)[(...,) + extra]
    x0, y0 = x0.long(), y0.long()
    flat = torch.from_numpy(np.ascontiguousarray(img)).reshape(h * w, -1)

    def tap(yy, xx):
        inside = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        v = flat[(yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).reshape(-1)]
        v = v.reshape(*yy.shape, -1).float()
        v = v.masked_fill(~inside[..., None], 0.0)
        return v if img.ndim == 3 else v[..., 0]

    top = tap(y0, x0) * (1 - fx) + tap(y0, x0 + 1) * fx
    bot = tap(y0 + 1, x0) * (1 - fx) + tap(y0 + 1, x0 + 1) * fx
    out = top * (1 - fy) + bot * fy
    return torch.round(out).clamp(0, 255).to(torch.uint8).numpy()


def gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """``cv2.GaussianBlur(img, (3, 3), sigma)`` on float32 (H, W) or
    (H, W, C): the separable kernel exp(-x^2 / 2 sigma^2) normalised,
    BORDER_REFLECT_101."""
    img = np.asarray(img, np.float32)
    x = np.arange(3, dtype=np.float64) - 1
    k = np.exp(-x * x / (2 * sigma * sigma))
    k = (k / k.sum()).astype(np.float32)
    pad = [(1, 1), (1, 1)] + [(0, 0)] * (img.ndim - 2)
    p = np.pad(img, pad, mode="reflect")
    h, w = img.shape[:2]
    rows = k[0] * p[:, 0:w] + k[1] * p[:, 1:w + 1] + k[2] * p[:, 2:w + 2]
    return (k[0] * rows[0:h] + k[1] * rows[1:h + 1]
            + k[2] * rows[2:h + 2]).astype(np.float32)


# --------------------------------------------------------------------------
# point sets
# --------------------------------------------------------------------------


def _sign(v) -> int:
    return int(v > 0) - int(v < 0)


def _sklansky(pts, order, start: int, end: int, nsign: int, sign2: int
              ) -> list:
    """cv2's ``Sklansky_`` over the x-sorted points ``pts[order]`` from
    ``start`` to ``end``: the stack of one quarter of the hull (indices
    into ``order``). Differences and the cross product are taken in the
    points' type (float32; Python ints for integer points)."""
    incr = 1 if end > start else -1
    p = [pts[i] for i in order]
    if start == end or (p[start][0] == p[end][0]
                        and p[start][1] == p[end][1]):
        return [start]
    pprev, pcur, pnext = start, start + incr, start + 2 * incr
    stack = [pprev, pcur, pnext]
    after = end + incr
    wide = np.float32 if pts.dtype.kind == "f" else int
    while pnext != after:
        cury, nexty = p[pcur][1], p[pnext][1]
        by = nexty - cury
        if _sign(by) != nsign:
            ax = p[pcur][0] - p[pprev][0]
            bx = p[pnext][0] - p[pcur][0]
            ay = cury - p[pprev][1]
            convexity = wide(ay) * wide(bx) - wide(ax) * wide(by)
            if _sign(convexity) == sign2 and (ax != 0 or ay != 0):
                pprev, pcur = pcur, pnext
                pnext += incr
                stack.append(pnext)
            elif pprev == start:
                pcur = pnext
                stack[1] = pcur
                pnext += incr
                stack[2] = pnext
            else:
                stack[-2] = pnext
                pcur = pprev
                pprev = stack[-4]
                stack.pop()
        else:
            pnext += incr
            stack[-1] = pnext
    return stack[:-1]


def _cyclic_ascending(hb: list) -> list:
    """cv2.convexHull's last step: shift the hull cyclically so that the
    points' input indices run ascending (or descending) where a shift can
    make them so."""
    nout = len(hb)
    if nout < 3:
        return hb
    min_i = max_i = lt = 0
    for i in range(1, nout):
        lt += hb[i - 1] < hb[i]
        if 1 < lt <= i - 2:
            break
        if hb[i] < hb[min_i]:
            min_i = i
        if hb[i] > hb[max_i]:
            max_i = i
    if abs(max_i - min_i) not in (1, nout - 1) or not (
            lt <= 1 or lt >= nout - 2):
        return hb
    ascending = (max_i + 1) % nout == min_i
    j = min_i if ascending else max_i
    if j == 0:
        return hb
    out = []
    for i in range(nout):
        cur, nxt = hb[j], hb[(j + 1) % nout]
        out.append(cur)
        if i < nout - 1 and ascending != (cur < nxt):
            return hb
        j = (j + 1) % nout
    return out


def convex_hull(points: np.ndarray) -> np.ndarray:
    """``cv2.convexHull(points)`` (counter-clockwise flag off): the hull of
    (N, 2) or (N, 1, 2) int32 or float32 points as (M, 1, 2), cv2's
    Sklansky scan in the points' arithmetic, its order and start."""
    pts = np.asarray(points).reshape(-1, 2)
    if pts.dtype.kind == "f":
        pts = pts.astype(np.float32)
    else:
        pts = pts.astype(np.int32)
    total = len(pts)
    order = sorted(range(total), key=lambda i: (pts[i][0], pts[i][1]))
    ys = [pts[i][1] for i in order]
    miny = maxy = 0
    for i in range(1, total):
        if ys[miny] > ys[i]:
            miny = i
        if ys[maxy] < ys[i]:
            maxy = i
    first, last = pts[order[0]], pts[order[-1]]
    if first[0] == last[0] and first[1] == last[1]:
        return pts[[order[0]]].reshape(-1, 1, 2)
    tl = _sklansky(pts, order, 0, maxy, -1, 1)
    tr = _sklansky(pts, order, total - 1, maxy, -1, -1)
    tl, tr = tr, tl  # clockwise=False
    hb = [order[tl[i]] for i in range(len(tl) - 1)]
    hb += [order[tr[i]] for i in range(len(tr) - 1, 0, -1)]
    stop = tr[1] if len(tr) > 2 else tl[-2] if len(tl) > 2 else -1
    bl = _sklansky(pts, order, 0, miny, 1, -1)
    br = _sklansky(pts, order, total - 1, miny, 1, 1)
    if stop >= 0:
        check = (bl[1] if len(bl) > 2 else br[2 - len(bl)]
                 if len(bl) + len(br) > 2 else -1)
        if check == stop or (check >= 0 and np.array_equal(
                pts[order[check]], pts[order[stop]])):
            # all points on one line: the lower half mirrors the upper
            bl, br = bl[:2], br[:2]
    hb += [order[bl[i]] for i in range(len(bl) - 1)]
    hb += [order[br[i]] for i in range(len(br) - 1, 0, -1)]
    return pts[_cyclic_ascending(hb)].reshape(-1, 1, 2)


def _rotating_calipers(pts: np.ndarray):
    """cv2's rotatingCalipers (CALIPERS_MINAREARECT) on the (n, 2) float32
    hull, in float32 as it computes: (corner, side 1, side 2)."""
    f = np.float32
    n = len(pts)
    pts = pts.astype(np.float32)
    vect = np.roll(pts, -1, 0) - pts  # float32 differences
    v64 = vect.astype(np.float64)
    inv_len = (1.0 / np.sqrt(v64[:, 0] ** 2 + v64[:, 1] ** 2)).astype(f)
    left = right = top = bottom = 0
    lx = rx = pts[0, 0]
    ty = by = pts[0, 1]
    for i in range(n):
        x, y = pts[i]
        if x < lx:
            lx, left = x, i
        if x > rx:
            rx, right = x, i
        if y > ty:
            ty, top = y, i
        if y < by:
            by, bottom = y, i
    orientation = f(0)
    ax, ay = float(vect[n - 1, 0]), float(vect[n - 1, 1])
    for i in range(n):
        bx, bpy = float(vect[i, 0]), float(vect[i, 1])
        conv = ax * bpy - ay * bx
        if conv != 0:
            orientation = f(1) if conv > 0 else f(-1)
            break
        ax, ay = bx, bpy
    base_a, base_b = orientation, f(0)
    seq = [bottom, right, top, left]
    minarea = f(np.finfo(np.float32).max)
    best = None
    for _ in range(n):
        v = [vect[s] for s in seq]
        dp = [base_a * v[0][0] + base_b * v[0][1],
              -base_b * v[1][0] + base_a * v[1][1],
              -base_a * v[2][0] - base_b * v[2][1],
              base_b * v[3][0] - base_a * v[3][1]]
        main = 0
        maxcos = dp[0] * inv_len[seq[0]]
        for i in range(1, 4):
            c = dp[i] * inv_len[seq[i]]
            if c > maxcos:
                main, maxcos = i, c
        pi = seq[main]
        lead_x, lead_y = vect[pi, 0] * inv_len[pi], vect[pi, 1] * inv_len[pi]
        base_a, base_b = ((lead_x, lead_y), (lead_y, -lead_x),
                          (-lead_x, -lead_y), (-lead_y, lead_x))[main]
        seq[main] = (seq[main] + 1) % n
        dx = pts[seq[1], 0] - pts[seq[3], 0]
        dy = pts[seq[1], 1] - pts[seq[3], 1]
        width = dx * base_a + dy * base_b
        dx = pts[seq[2], 0] - pts[seq[0], 0]
        dy = pts[seq[2], 1] - pts[seq[0], 1]
        height = -dx * base_b + dy * base_a
        area = width * height
        if area <= minarea:
            minarea = area
            best = (seq[3], base_a, width, base_b, height, seq[0])
    i0, a1, wd, b1, ht, i5 = best
    a2, b2 = -b1, a1
    c1 = a1 * pts[i0, 0] + pts[i0, 1] * b1
    c2 = a2 * pts[i5, 0] + pts[i5, 1] * b2
    idet = f(1) / (a1 * b2 - a2 * b1)
    corner = ((c1 * b2 - c2 * b1) * idet, (a1 * c2 - a2 * c1) * idet)
    return corner, (a1 * wd, b1 * wd), (a2 * ht, b2 * ht)


def min_area_rect(points: np.ndarray):
    """``cv2.minAreaRect``: ``((cx, cy), (w, h), angle_degrees)`` of the
    rotated rectangle of least area around (N, 2) points, by cv2's
    rotating calipers over its hull in float32, so that near ties pick the
    rectangle cv2 picks."""
    hull = convex_hull(np.asarray(points, np.float32)).reshape(-1, 2)
    f = np.float32
    if len(hull) > 2:
        o, s1, s2 = _rotating_calipers(hull)
        cx = o[0] + (s1[0] + s2[0]) * f(0.5)
        cy = o[1] + (s1[1] + s2[1]) * f(0.5)
        w = f(math.sqrt(float(s1[0]) ** 2 + float(s1[1]) ** 2))
        h = f(math.sqrt(float(s2[0]) ** 2 + float(s2[1]) ** 2))
        angle = math.atan2(float(s1[1]), float(s1[0]))
    elif len(hull) == 2:
        p, q = hull.astype(np.float64)
        cx, cy = f((p[0] + q[0]) * 0.5), f((p[1] + q[1]) * 0.5)
        w = f(math.hypot(q[0] - p[0], q[1] - p[1]))
        h = f(0)
        angle = math.atan2(q[1] - p[1], q[0] - p[0])
    else:
        cx, cy = (f(hull[0, 0]), f(hull[0, 1])) if len(hull) else (f(0),
                                                                     f(0))
        w = h = f(0)
        angle = 0.0
    angle = angle * 180 / math.pi
    if angle >= 0:  # cv2 reports an angle in [-90, 0)
        angle, w, h = angle - 90, h, w
        if angle == 0:
            angle, w, h = -90.0, h, w
    angle = f(angle)
    return ((float(cx), float(cy)), (float(w), float(h)), float(angle))


def box_points(rect) -> np.ndarray:
    """``cv2.boxPoints``: the (4, 2) float32 corners of
    ``((cx, cy), (w, h), angle_degrees)``, in float32 arithmetic as
    ``RotatedRect::points`` (the angle taken as float32 first)."""
    (cx, cy), (bw, bh), angle = rect
    f = np.float32
    a_rad = float(f(angle)) * math.pi / 180.0
    b = f(math.cos(a_rad)) * f(0.5)
    a = f(math.sin(a_rad)) * f(0.5)
    cx, cy, bw, bh = f(cx), f(cy), f(bw), f(bh)
    return np.array([(cx - a * bh - b * bw, cy + b * bh - a * bw),
                     (cx + a * bh - b * bw, cy - b * bh - a * bw),
                     (cx + a * bh + b * bw, cy - b * bh + a * bw),
                     (cx - a * bh + b * bw, cy + b * bh + a * bw)],
                    np.float32)


def _lu_solve(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """cv2's DECOMP_LU (``hal::LU``): Gaussian elimination with partial
    pivoting in float64, in its order of operations."""
    a, b = a.copy(), b.copy()
    m = len(b)
    for i in range(m):
        k = i
        for j in range(i + 1, m):
            if abs(a[j, i]) > abs(a[k, i]):
                k = j
        if k != i:
            a[[i, k], i:] = a[[k, i], i:]
            b[[i, k]] = b[[k, i]]
        d = -1.0 / a[i, i]
        for j in range(i + 1, m):
            alpha = a[j, i] * d
            a[j, i + 1:] += alpha * a[i, i + 1:]
            b[j] += alpha * b[i]
    for i in range(m - 1, -1, -1):
        s = b[i]
        for k in range(i + 1, m):
            s -= a[i, k] * b[k]
        b[i] = s / a[i, i]
    return b


def get_perspective_transform(src: np.ndarray, dst: np.ndarray
                              ) -> np.ndarray:
    """``cv2.getPerspectiveTransform``: the (3, 3) float64 homography that
    takes the four ``src`` points to ``dst``, cv2's 8x8 system (its
    products of float32 coordinates taken in float32) solved as cv2
    solves it."""
    src = np.asarray(src, np.float32).reshape(4, 2)
    dst = np.asarray(dst, np.float32).reshape(4, 2)
    a = np.zeros((8, 8))
    b = np.zeros(8)
    for i in range(4):
        (x, y), (u, v) = src[i], dst[i]
        a[i] = (x, y, 1, 0, 0, 0, -(x * u), -(y * u))
        a[i + 4] = (0, 0, 0, x, y, 1, -(x * v), -(y * v))
        b[i], b[i + 4] = u, v
    return np.append(_lu_solve(a, b), 1.0).reshape(3, 3)


def perspective_transform(points: np.ndarray, m: np.ndarray) -> np.ndarray:
    """``cv2.perspectiveTransform`` on (N, 1, 2) float32 points: float64
    arithmetic, a point at w ~ 0 sent to 0, the result float32."""
    p = np.asarray(points, np.float64).reshape(-1, 2)
    m = np.asarray(m, np.float64)
    w = p[:, 0] * m[2, 0] + p[:, 1] * m[2, 1] + m[2, 2]
    w = np.where(np.abs(w) > np.finfo(np.float32).eps, 1.0 / np.where(
        w == 0, 1.0, w), 0.0)
    x = (p[:, 0] * m[0, 0] + p[:, 1] * m[0, 1] + m[0, 2]) * w
    y = (p[:, 0] * m[1, 0] + p[:, 1] * m[1, 1] + m[1, 2]) * w
    return np.stack([x, y], 1).astype(np.float32).reshape(
        np.asarray(points).shape)


# --------------------------------------------------------------------------
# drawing (cv2's drawing.cpp, LINE_8, shift 0), in place
# --------------------------------------------------------------------------


def _color(img: np.ndarray, color) -> np.ndarray:
    c = np.asarray(color, np.float64).reshape(-1)
    ch = img.shape[2] if img.ndim == 3 else 1
    if c.size < ch:
        c = np.concatenate([c, np.zeros(ch - c.size)])
    return np.clip(np.rint(c[:ch]), 0, 255).astype(img.dtype)


def _hline(img, y, x1, x2, col) -> None:
    h, w = img.shape[:2]
    if 0 <= y < h and x1 < w and x2 >= 0:
        img[y, max(x1, 0):min(x2, w - 1) + 1] = col


def _clip_line(w: int, h: int, p1, p2):
    """cv2's clipLine (Cohen-Sutherland with int64 truncation); None when
    the segment misses the image."""
    (x1, y1), (x2, y2) = p1, p2
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return (x1, y1), (x2, y2)


def _line8(img, p1, p2, col) -> None:
    """cv2's ``Line`` (LineIterator, 8-connected, left to right)."""
    h, w = img.shape[:2]
    p1 = (int(p1[0]), int(p1[1]))
    p2 = (int(p2[0]), int(p2[1]))
    if not (0 <= p1[0] < w and 0 <= p2[0] < w and 0 <= p1[1] < h
            and 0 <= p2[1] < h):
        clipped = _clip_line(w, h, p1, p2)
        if clipped is None:
            return
        p1, p2 = clipped
    dx, dy = p2[0] - p1[0], p2[1] - p1[1]
    if dx < 0:
        dx, dy, p1 = -dx, -dy, p2
    sx, sy = 1, 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - 2 * dy
    n = dx + 1
    x, y = p1
    xs = np.empty(n, np.int64)
    ys = np.empty(n, np.int64)
    for i in range(n):
        xs[i], ys[i] = x, y
        minor = err < 0
        err += -2 * dy + (2 * dx if minor else 0)
        if vert:
            y += sy
            x += sx if minor else 0
        else:
            x += sx
            y += sy if minor else 0
    img[ys, xs] = col


def fill_poly(img: np.ndarray, polys: Sequence[np.ndarray], color) -> None:
    """``cv2.fillPoly(img, polys, color)`` in place: each polygon's
    integer vertices, its outline by the 8-connected line, and the spans
    between the edges of cv2's walk (16.16 fixed point, x stepped by the
    edge's truncated slope, [ceil(left), floor(right)] filled), even-odd
    over all polygons together."""
    col = _color(img, color)
    h, w = img.shape[:2]
    edges = []
    for poly in polys:
        v = np.asarray(poly).reshape(-1, 2).astype(np.int64)
        for i in range(len(v)):
            a, b = v[i - 1], v[i]
            _line8(img, a, b, col)
            if a[1] == b[1]:
                continue
            if a[1] < b[1]:
                y0, y1, x0 = a[1], b[1], a[0] << XY_SHIFT
            else:
                y0, y1, x0 = b[1], a[1], b[0] << XY_SHIFT
            num = (int(b[0]) - int(a[0])) << XY_SHIFT
            den = int(b[1]) - int(a[1])
            q = abs(num) // abs(den)
            edges.append((int(y0), int(y1), int(x0),
                          q if (num >= 0) == (den >= 0) else -q))
    if len(edges) < 2:
        return
    ys, xs = [], []
    for y0, y1, x0, dx in edges:
        rows = np.arange(max(y0, 0), min(y1, h), dtype=np.int64)
        ys.append(rows)
        xs.append(x0 + (rows - y0) * dx)
    ys = np.concatenate(ys)
    xs = np.concatenate(xs)
    if not len(ys):
        return
    order = np.lexsort((xs, ys))
    ys, xs = ys[order], xs[order]
    starts = np.flatnonzero(np.r_[True, ys[1:] != ys[:-1]])
    counts = np.diff(np.r_[starts, len(ys)])
    for s, c in zip(starts, counts):
        y = int(ys[s])
        for j in range(s, s + c - 1, 2):
            _hline(img, y, int((xs[j] + XY_ONE - 1) >> XY_SHIFT),
                   int(xs[j + 1] >> XY_SHIFT), col)


def _circle_filled(img, center, radius: int, col) -> None:
    """cv2's ``Circle`` with fill (the midpoint walk, rows clipped)."""
    cx, cy = int(center[0]), int(center[1])
    err, dx, dy, plus, minus = 0, radius, 0, 1, 2 * radius - 1
    while dx >= dy:
        for y, x1, x2 in ((cy - dy, cx - dx, cx + dx), (cy + dy, cx - dx,
                                                        cx + dx),
                          (cy - dx, cx - dy, cx + dy), (cy + dx, cx - dy,
                                                        cx + dy)):
            _hline(img, y, x1, x2, col)
        dy += 1
        err += plus
        plus += 2
        if err > 0:
            err -= minus
            dx -= 1
            minus -= 2


def circle(img: np.ndarray, center, radius: int, color,
           thickness: int = -1) -> None:
    """``cv2.circle`` filled (thickness < 0, the generators' only use), in
    place, as cv2 fills it."""
    if thickness >= 0:
        raise ValueError("circle draws filled discs only (thickness < 0)")
    _circle_filled(img, center, int(radius), _color(img, color))


def line(img: np.ndarray, p0, p1, color, thickness: int = 1) -> None:
    """``cv2.line`` in place: the 8-connected line at thickness 1; thicker,
    the segment's quad at half-width thickness/2 (+1/2 when odd, cv2's
    rule) and a filled cap of that radius at each end."""
    col = _color(img, color)
    if thickness <= 1:
        _line8(img, p0, p1, col)
        return
    (x0, y0), (x1, y1) = p0, p1
    ddx, ddy = x0 - x1, y1 - y0
    half = thickness / 2 + (thickness & 1) * 0.5
    n = math.hypot(ddx, ddy)
    if n > 0:
        ox, oy = ddy * half / n, ddx * half / n
        quad = np.array([[x0 + ox, y0 + oy], [x0 - ox, y0 - oy],
                         [x1 - ox, y1 - oy], [x1 + ox, y1 + oy]])
        fill_poly(img, [np.floor(quad + 0.5).astype(np.int64)], col)
    r = (thickness * (XY_ONE >> 1) + (XY_ONE >> 1)) >> XY_SHIFT
    for c in (p0, p1):
        _circle_filled(img, c, r, col)


def rectangle(img: np.ndarray, p0, p1, color, thickness: int = -1) -> None:
    """``cv2.rectangle`` filled (thickness < 0, the generators' only use)
    between two corners, inclusive, in place."""
    if thickness >= 0:
        raise ValueError("rectangle draws filled boxes only (thickness < 0)")
    h, w = img.shape[:2]
    xa, xb = sorted((int(p0[0]), int(p1[0])))
    ya, yb = sorted((int(p0[1]), int(p1[1])))
    img[max(ya, 0):min(yb, h - 1) + 1, max(xa, 0):min(xb, w - 1) + 1] = \
        _color(img, color)
