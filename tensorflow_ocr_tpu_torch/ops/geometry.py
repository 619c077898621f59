"""Polygon and rotated-box geometry for the EAST labels and decode.

A copy of the numpy half of ``tensorflow_ocr_tpu/ops/geometry.py`` that
the EAST slice needs (``polygon_area`` :28, ``shrink_poly`` :69,
``point_dist_to_line`` :111, the line helpers, ``rectangle_from_parallelogram``
:151, ``sort_rectangle`` :183 and ``restore_rectangle_rbox`` :209), so
that the port imports nothing of the JAX package, and
:func:`restore_rectangle_rbox_torch`, the batched torch form of
``restore_rectangle_rbox_jax`` (:305) that ``ops/decode.py``
``east_detect`` runs on the device. ``tests/test_torch_east_labels.py``
holds the copies bit-equal to the originals.

The data tier adds ``check_and_validate_polys`` (:41), ``restore_rectangle``
(:273), ``order_points`` (:278) and ``sort_poly`` (:290), and the torch
forms of ``polygon_area_jax`` (:355) and ``sort_rectangle_jax`` (:402),
which ``data/device_augment.py`` runs inside the captured train step: no
host sync, every branch a ``torch.where``; and the torch form of
``min_area_rect_angles`` (:362), the angle sweep of one point set.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch


def polygon_area(poly: np.ndarray) -> float:
    """Signed area via the shoelace sum (reference icdar.py:69-81).

    Positive => points are counter-clockwise in image coords (y down), which
    the reference treats as "wrong direction" and reverses.
    """
    p = np.asarray(poly, dtype=np.float64)
    nxt = np.roll(p, -1, axis=0)
    edge = (nxt[:, 0] - p[:, 0]) * (nxt[:, 1] + p[:, 1])
    return float(np.sum(edge) / 2.0)


def check_and_validate_polys(polys, tags, size):
    """Clip to the image, drop polygons of area below 1, and reverse the
    winding of those with a positive signed area (reference icdar.py:108-135:
    the clip bounds w-1/h-1 and the (0, 3, 2, 1) reorder)."""
    h, w = size
    polys = np.asarray(polys, dtype=np.float32)
    tags = np.asarray(tags, dtype=bool)
    if polys.shape[0] == 0:
        return polys.reshape(0, 4, 2), tags
    polys = polys.copy()
    polys[:, :, 0] = np.clip(polys[:, :, 0], 0, w - 1)
    polys[:, :, 1] = np.clip(polys[:, :, 1], 0, h - 1)
    out_p, out_t = [], []
    for poly, tag in zip(polys, tags):
        area = polygon_area(poly)
        if abs(area) < 1:
            continue
        if area > 0:
            poly = poly[(0, 3, 2, 1), :]
        out_p.append(poly)
        out_t.append(tag)
    if not out_p:
        return np.zeros((0, 4, 2), np.float32), np.zeros((0,), bool)
    return np.array(out_p, np.float32), np.array(out_t, bool)


def shrink_poly(poly: np.ndarray, r: np.ndarray, ratio: float = 0.3) -> np.ndarray:
    """EAST poly shrink (reference icdar.py:202-266, R=0.3).

    Moves each vertex inward along its two incident edges by R*r[i], where
    r[i] is the min adjacent edge length. Mutates a copy and returns it.
    """
    poly = np.asarray(poly, dtype=np.float32).copy()
    R = ratio

    def _move_pair(i, j):
        # move p_i toward p_j and p_j toward p_i along edge direction
        theta = np.arctan2(poly[j][1] - poly[i][1], poly[j][0] - poly[i][0])
        poly[i][0] += R * r[i] * np.cos(theta)
        poly[i][1] += R * r[i] * np.sin(theta)
        poly[j][0] -= R * r[j] * np.cos(theta)
        poly[j][1] -= R * r[j] * np.sin(theta)

    def _move_pair_swapped(i, j):
        # reference uses swapped sin/cos for the "vertical" edge pairs
        theta = np.arctan2(poly[j][0] - poly[i][0], poly[j][1] - poly[i][1])
        poly[i][0] += R * r[i] * np.sin(theta)
        poly[i][1] += R * r[i] * np.cos(theta)
        poly[j][0] -= R * r[j] * np.sin(theta)
        poly[j][1] -= R * r[j] * np.cos(theta)

    len_01_23 = np.linalg.norm(poly[0] - poly[1]) + np.linalg.norm(poly[2] - poly[3])
    len_03_12 = np.linalg.norm(poly[0] - poly[3]) + np.linalg.norm(poly[1] - poly[2])
    if len_01_23 > len_03_12:
        _move_pair(0, 1)
        _move_pair(3, 2)
        _move_pair_swapped(0, 3)
        _move_pair_swapped(1, 2)
    else:
        _move_pair_swapped(0, 3)
        _move_pair_swapped(1, 2)
        _move_pair(0, 1)
        _move_pair(3, 2)
    return poly


def point_dist_to_line(p1, p2, p3) -> float:
    """Distance from p3 to line p1-p2 (reference icdar.py:269-271)."""
    p1, p2, p3 = (np.asarray(p, np.float64) for p in (p1, p2, p3))
    a, b = p2 - p1, p1 - p3
    cross = a[0] * b[1] - a[1] * b[0]
    return float(abs(cross) / np.linalg.norm(a))


def _fit_line(xs, ys):
    # reference icdar.py:274-280 (note: its vertical check compares
    # p1[0]==p1[1] — i.e. xs[0]==xs[1] since args are ([x1,x2],[y1,y2]))
    if xs[0] == xs[1]:
        return [1.0, 0.0, -xs[0]]
    k, b = np.polyfit(xs, ys, deg=1)
    return [k, -1.0, b]


def _line_cross_point(line1, line2):
    if line1[1] == 0:
        x = -line1[2]
        y = line2[0] * x + line2[2]
    elif line2[1] == 0:
        x = -line2[2]
        y = line1[0] * x + line1[2]
    else:
        k1, _, b1 = line1
        k2, _, b2 = line2
        if k1 == k2:
            return None
        x = -(b1 - b2) / (k1 - k2)
        y = k1 * x + b1
    return np.array([x, y], dtype=np.float32)


def _line_verticle(line, point):
    if line[1] == 0:
        return [0.0, -1.0, point[1]]
    if line[0] == 0:
        return [1.0, 0.0, -point[0]]
    return [-1.0 / line[0], -1.0, point[1] - (-1.0 / line[0] * point[0])]


def rectangle_from_parallelogram(poly: np.ndarray) -> np.ndarray:
    """Fit a rectangle to a parallelogram (reference icdar.py:317-372)."""
    p0, p1, p2, p3 = np.asarray(poly, np.float32)
    angle_p0 = np.arccos(
        np.dot(p1 - p0, p3 - p0)
        / (np.linalg.norm(p0 - p1) * np.linalg.norm(p3 - p0))
    )
    if angle_p0 < 0.5 * np.pi:
        if np.linalg.norm(p0 - p1) > np.linalg.norm(p0 - p3):
            p2p3 = _fit_line([p2[0], p3[0]], [p2[1], p3[1]])
            new_p3 = _line_cross_point(p2p3, _line_verticle(p2p3, p0))
            p0p1 = _fit_line([p0[0], p1[0]], [p0[1], p1[1]])
            new_p1 = _line_cross_point(p0p1, _line_verticle(p0p1, p2))
            return np.array([p0, new_p1, p2, new_p3], dtype=np.float32)
        p1p2 = _fit_line([p1[0], p2[0]], [p1[1], p2[1]])
        new_p1 = _line_cross_point(p1p2, _line_verticle(p1p2, p0))
        p0p3 = _fit_line([p0[0], p3[0]], [p0[1], p3[1]])
        new_p3 = _line_cross_point(p0p3, _line_verticle(p0p3, p2))
        return np.array([p0, new_p1, p2, new_p3], dtype=np.float32)
    if np.linalg.norm(p0 - p1) > np.linalg.norm(p0 - p3):
        p2p3 = _fit_line([p2[0], p3[0]], [p2[1], p3[1]])
        new_p2 = _line_cross_point(p2p3, _line_verticle(p2p3, p1))
        p0p1 = _fit_line([p0[0], p1[0]], [p0[1], p1[1]])
        new_p0 = _line_cross_point(p0p1, _line_verticle(p0p1, p3))
        return np.array([new_p0, p1, new_p2, p3], dtype=np.float32)
    p0p3 = _fit_line([p0[0], p3[0]], [p0[1], p3[1]])
    new_p0 = _line_cross_point(p0p3, _line_verticle(p0p3, p1))
    p1p2 = _fit_line([p1[0], p2[0]], [p1[1], p2[1]])
    new_p2 = _line_cross_point(p1p2, _line_verticle(p1p2, p3))
    return np.array([new_p0, p1, new_p2, p3], dtype=np.float32)


def sort_rectangle(poly: np.ndarray):
    """Order rect points clockwise from top-left, return (poly, angle).

    Reference icdar.py:375-407. Angle convention: rotation of the bottom
    edge w.r.t. the x-axis, in [-pi/4, pi/4].
    """
    poly = np.asarray(poly, np.float32)
    p_lowest = int(np.argmax(poly[:, 1]))
    if np.count_nonzero(poly[:, 1] == poly[p_lowest, 1]) == 2:
        p0 = int(np.argmin(np.sum(poly, axis=1)))
        idx = [(p0 + k) % 4 for k in range(4)]
        return poly[idx], 0.0
    p_lowest_right = (p_lowest - 1) % 4
    angle = np.arctan(
        -(poly[p_lowest][1] - poly[p_lowest_right][1])
        / (poly[p_lowest][0] - poly[p_lowest_right][0])
    )
    if angle / np.pi * 180 > 45:
        p2 = p_lowest
        idx = [(p2 - 2) % 4, (p2 - 1) % 4, p2, (p2 + 1) % 4]
        return poly[idx], -(np.pi / 2 - angle)
    p3 = p_lowest
    idx = [(p3 + 1) % 4, (p3 + 2) % 4, (p3 + 3) % 4, p3]
    return poly[idx], float(angle)


def restore_rectangle_rbox(origin: np.ndarray, geometry: np.ndarray) -> np.ndarray:
    """Recover quads from per-pixel RBOX (d_top,d_right,d_bottom,d_left,angle).

    Vectorized equivalent of reference icdar.py:410-483 (identical math,
    without the per-sign Python branches; validated against it in tests).

    origin:   (N,2) pixel coords (x,y)
    geometry: (N,5)
    returns:  (N,4,2) quads, rows ordered as the reference output
              (angle>=0 block first, then angle<0 — matching its concat).
    """
    origin = np.asarray(origin, np.float32)
    geometry = np.asarray(geometry, np.float32)
    if origin.shape[0] == 0:
        return np.zeros((0, 4, 2), np.float32)
    d = geometry[:, :4]
    angle = geometry[:, 4]

    def _block(origin_b, d_b, angle_b, positive):
        n = d_b.shape[0]
        if n == 0:
            return np.zeros((0, 4, 2), np.float32)
        z = np.zeros(n, np.float32)
        if positive:
            # 5 anchor points in canonical frame (reference :418-422)
            p = np.stack(
                [
                    z, -d_b[:, 0] - d_b[:, 2],
                    d_b[:, 1] + d_b[:, 3], -d_b[:, 0] - d_b[:, 2],
                    d_b[:, 1] + d_b[:, 3], z,
                    z, z,
                    d_b[:, 3], -d_b[:, 2],
                ],
                axis=0,
            ).T.reshape(-1, 5, 2)
            rot_x = np.stack([np.cos(angle_b), np.sin(angle_b)], axis=1)
            rot_y = np.stack([-np.sin(angle_b), np.cos(angle_b)], axis=1)
        else:
            p = np.stack(
                [
                    -d_b[:, 1] - d_b[:, 3], -d_b[:, 0] - d_b[:, 2],
                    z, -d_b[:, 0] - d_b[:, 2],
                    z, z,
                    -d_b[:, 1] - d_b[:, 3], z,
                    -d_b[:, 1], -d_b[:, 2],
                ],
                axis=0,
            ).T.reshape(-1, 5, 2)
            rot_x = np.stack([np.cos(-angle_b), -np.sin(-angle_b)], axis=1)
            rot_y = np.stack([np.sin(-angle_b), np.cos(-angle_b)], axis=1)
        rot_x = np.repeat(rot_x[:, None, :], 5, axis=1)
        rot_y = np.repeat(rot_y[:, None, :], 5, axis=1)
        p_rot = np.stack(
            [np.sum(rot_x * p, axis=2), np.sum(rot_y * p, axis=2)], axis=2
        )  # N,5,2
        p3_in_origin = origin_b - p_rot[:, 4, :]
        return p_rot[:, :4, :] + p3_in_origin[:, None, :]

    pos = angle >= 0
    out_pos = _block(origin[pos], d[pos], angle[pos], True)
    out_neg = _block(origin[~pos], d[~pos], angle[~pos], False)
    return np.concatenate([out_pos, out_neg], axis=0).astype(np.float32)


def restore_rectangle(origin, geometry):
    """Reference icdar.py:482-483 alias."""
    return restore_rectangle_rbox(origin, geometry)


def order_points(pts: np.ndarray) -> np.ndarray:
    """Order 4 points TL, TR, BR, BL (reference test.py:24-35)."""
    pts = np.asarray(pts, np.float64)
    x_sorted = pts[np.argsort(pts[:, 0]), :]
    left = x_sorted[:2][np.argsort(x_sorted[:2, 1])]
    tl, bl = left
    right = x_sorted[2:]
    d = np.linalg.norm(right - tl, axis=1)
    br, tr = right[np.argsort(d)[::-1]]
    return np.array([tl, tr, br, bl], dtype=np.int32)


def sort_poly(p: np.ndarray) -> np.ndarray:
    """Start at the corner of least x + y; clockwise when the first edge is
    the wider (reference test.py:37-43)."""
    p = np.asarray(p)
    min_axis = int(np.argmin(np.sum(p, axis=1)))
    p = p[[min_axis, (min_axis + 1) % 4, (min_axis + 2) % 4, (min_axis + 3) % 4]]
    if abs(p[0, 0] - p[1, 0]) > abs(p[0, 1] - p[1, 1]):
        return p
    return p[[0, 3, 2, 1]]


def polygon_area_torch(polys: torch.Tensor) -> torch.Tensor:
    """Batched shoelace signed area of (..., K, 2) polygons
    (``polygon_area_jax``)."""
    nxt = polys.roll(-1, dims=-2)
    edge = (nxt[..., 0] - polys[..., 0]) * (nxt[..., 1] + polys[..., 1])
    return edge.sum(-1) / 2.0


def min_area_rect_angles(points: torch.Tensor, mask: torch.Tensor,
                         num_angles: int = 90) -> torch.Tensor:
    """The least-area box of the masked points over ``num_angles``
    rotations in [0, pi/2) (``min_area_rect_angles`` :362-400, in place
    of cv2.minAreaRect). points (P, 2) float32 (x, y), mask (P,) bool.
    Returns (4, 2) corners, clockwise from an unordered start."""
    thetas = torch.arange(num_angles, dtype=torch.float32,
                          device=points.device) * (math.pi / 2 / num_angles)
    c, s = torch.cos(thetas), torch.sin(thetas)
    x, y = points[:, 0:1], points[:, 1:2]
    proj_u = x * c + y * s                                   # (P, A)
    proj_v = -x * s + y * c
    m = mask[:, None]
    u_min = torch.where(m, proj_u, 1e9).amin(0)
    u_max = torch.where(m, proj_u, -1e9).amax(0)
    v_min = torch.where(m, proj_v, 1e9).amin(0)
    v_max = torch.where(m, proj_v, -1e9).amax(0)
    k = ((u_max - u_min) * (v_max - v_min)).argmin()
    u0, du = u_min[k], u_max[k] - u_min[k]
    v0, dv = v_min[k], v_max[k] - v_min[k]
    us = torch.stack([u0, u0 + du, u0 + du, u0])
    vs = torch.stack([v0, v0, v0 + dv, v0 + dv])
    return torch.stack([us * c[k] - vs * s[k], us * s[k] + vs * c[k]], 1)


def sort_rectangle_torch(poly: torch.Tensor, eps: float = 1e-4
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``sort_rectangle_jax`` on (..., 4, 2) float32 corners in any order:
    (corners clockwise from the top left, angle in [-pi/4, pi/4]). The
    reference's branches (the lowest point, two lowest points tied: axis
    aligned, angle 0; above 45 degrees: relabelled) are selects, so it
    runs on the device without a host sync."""
    poly = poly.float()
    y = poly[..., 1]
    p_low = y.argmax(-1)
    ymax = y.gather(-1, p_low[..., None])[..., 0]
    tie = ((y - ymax[..., None]).abs() < eps).sum(-1) >= 2
    p0 = poly.sum(-1).argmin(-1)
    p_right = (p_low - 1) % 4

    def take_pt(i):
        return poly.gather(-2, i[..., None, None].expand(
            *i.shape, 1, 2))[..., 0, :]

    pl, pr = take_pt(p_low), take_pt(p_right)
    dx = pl[..., 0] - pr[..., 0]
    dy = pl[..., 1] - pr[..., 1]
    safe_dx = torch.where(dx.abs() < 1e-9, torch.ones_like(dx), dx)
    angle = torch.atan(-dy / safe_dx)
    steep = angle > math.pi / 4
    four = torch.arange(4, device=poly.device)
    base = p_low[..., None] + four
    idx = torch.where(tie[..., None], (p0[..., None] + four) % 4,
                      torch.where(steep[..., None], (base + 2) % 4,
                                  (base + 1) % 4))
    sorted_poly = poly.gather(-2, idx[..., None].expand(*idx.shape, 2))
    zero = torch.zeros_like(angle)
    out_angle = torch.where(tie, zero, torch.where(
        steep, -(math.pi / 2 - angle), angle))
    return sorted_poly, out_angle


def restore_rectangle_rbox_torch(origin: torch.Tensor,
                                 geometry: torch.Tensor) -> torch.Tensor:
    """Quads from per-pixel RBOX geometry, in the input's row order
    (geometry.py:305-350): origin (..., N, 2) pixel (x, y); geometry
    (..., N, 5) = (d_top, d_right, d_bottom, d_left, angle). Returns
    (..., N, 4, 2). The anchor points of the angle >= 0 and < 0 frames
    are both built and one is picked per row, as the JAX function does;
    the rotation is written out (x' = c px + s py, y' = -s px + c py) in
    float32."""
    d = geometry[..., :4]
    angle = geometry[..., 4]
    z = torch.zeros_like(angle)
    h = -d[..., 0] - d[..., 2]
    w_pos = d[..., 1] + d[..., 3]
    p_pos = torch.stack([z, h, w_pos, h, w_pos, z, z, z,
                         d[..., 3], -d[..., 2]], -1)
    p_neg = torch.stack([-w_pos, h, z, h, z, z, -w_pos, z,
                         -d[..., 1], -d[..., 2]], -1)
    p = torch.where((angle >= 0)[..., None], p_pos, p_neg)
    p = p.reshape(*p.shape[:-1], 5, 2)
    c, s = torch.cos(angle)[..., None], torch.sin(angle)[..., None]
    px, py = p[..., 0], p[..., 1]
    p_rot = torch.stack([c * px + s * py, -s * px + c * py], -1)
    p3_in_origin = origin - p_rot[..., 4, :]
    return p_rot[..., :4, :] + p3_in_origin[..., None, :]
