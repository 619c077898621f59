"""Locality-aware NMS for EAST quads (host-side numpy).

A copy of ``tensorflow_ocr_tpu/utils/nms.py`` (the port imports nothing
of the JAX package): row-adjacent raster-order candidates are merged by
score-weighted averaging (:func:`_chain_merge`), then a greedy polygon
NMS runs on the merged set (:func:`standard_nms`), both on the exact
convex IoU of :func:`batch_quad_iou`. :func:`quad_iou` keeps only the
pure-numpy clip: the JAX copy's ``cv2.intersectConvexConvex`` branch is
left out (the card has no ``cv2``, and neither NMS stage calls
``quad_iou``). ``tests/test_torch_nms.py`` holds the rows equal to the
JAX functions'.
"""

from __future__ import annotations

import numpy as np


def _poly_area(p):
    x, y = p[:, 0], p[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def _clip_polygon(subject, clip):
    """Sutherland-Hodgman convex clip; both (N,2) arrays, clip convex."""
    output = list(subject)
    for i in range(len(clip)):
        a, b = clip[i], clip[(i + 1) % len(clip)]
        input_list, output = output, []
        if not input_list:
            break
        edge = b - a

        def inside(p):
            return edge[0] * (p[1] - a[1]) - edge[1] * (p[0] - a[0]) >= 0

        s = input_list[-1]
        for e in input_list:
            if inside(e):
                if not inside(s):
                    output.append(_intersect(s, e, a, b))
                output.append(e)
            elif inside(s):
                output.append(_intersect(s, e, a, b))
            s = e
    return np.array(output) if output else np.zeros((0, 2))


def _intersect(p1, p2, a, b):
    d1, d2 = p2 - p1, b - a
    denom = d1[0] * d2[1] - d1[1] * d2[0]
    if abs(denom) < 1e-12:
        return p1
    t = ((a[0] - p1[0]) * d2[1] - (a[1] - p1[1]) * d2[0]) / denom
    return p1 + t * d1


def quad_iou(p1: np.ndarray, p2: np.ndarray) -> float:
    """Polygon IoU of two convex quads by an exact Sutherland-Hodgman clip
    (the JAX copy's pure-numpy path)."""
    inter_poly = _clip_polygon(p1.astype(np.float64), p2.astype(np.float64))
    if len(inter_poly) < 3:
        return 0.0
    inter = _poly_area(inter_poly)
    union = _poly_area(p1) + _poly_area(p2) - inter
    return float(inter / union) if union > 0 else 0.0


def _weighted_merge(g: np.ndarray, p: np.ndarray) -> np.ndarray:
    """Score-weighted vertex average of two (9,) rows [8 coords + score]."""
    out = np.empty(9)
    out[:8] = (g[8] * g[:8] + p[8] * p[:8]) / (g[8] + p[8])
    out[8] = g[8] + p[8]
    return out


# --- batched convex-quad IoU (vectorized Sutherland-Hodgman) ------------
# The per-pair Python quad_iou() calls were the cost of both NMS stages:
# at serving batch sizes the pair loop was the one
# remaining host hot loop in the inference path. These batch kernels run
# the same exact convex clip across all pairs in numpy.

_CLIP_M = 12  # vertex buffer: quad∩quad <= 8 vertices; transient <= 10


def _batch_signed_area2(verts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """2x signed shoelace area over the first counts[i] vertices."""
    n, m, _ = verts.shape
    idx = np.arange(m)
    cnt = np.maximum(counts[:, None], 1)
    nxt = (idx[None, :] + 1) % cnt
    x, y = verts[..., 0], verts[..., 1]
    xn = np.take_along_axis(x, nxt, 1)
    yn = np.take_along_axis(y, nxt, 1)
    mask = idx[None, :] < counts[:, None]
    return np.sum((x * yn - y * xn) * mask, axis=1)


def _batch_clip(verts, counts, a, b):
    """Clip each subject polygon by its half-plane (edge a->b), batched.

    verts (N, M, 2) with counts (N,) valid prefix vertices; a, b (N, 2).
    Returns the clipped (N, M, 2) buffer + new counts. Emission order per
    input vertex matches the scalar Sutherland-Hodgman in _clip_polygon:
    crossing intersection first, then the vertex itself if inside.
    """
    n, m, _ = verts.shape
    e = b - a
    d = (e[:, None, 0] * (verts[..., 1] - a[:, None, 1])
         - e[:, None, 1] * (verts[..., 0] - a[:, None, 0]))  # (N, M)
    inside = d >= 0
    idx = np.arange(m)
    valid = idx[None, :] < counts[:, None]
    cnt = np.maximum(counts[:, None], 1)
    prev = (idx[None, :] - 1) % cnt
    s_inside = np.take_along_axis(inside, prev, 1)
    s_d = np.take_along_axis(d, prev, 1)
    s_vert = np.take_along_axis(verts, prev[..., None], 1)
    denom = s_d - d
    safe = np.where(np.abs(denom) > 1e-12, denom, 1.0)
    t = np.where(np.abs(denom) > 1e-12, s_d / safe, 0.0)
    inter_pt = s_vert + t[..., None] * (verts - s_vert)
    emit_inter = valid & (inside ^ s_inside)
    emit_vert = valid & inside
    n_emit = emit_inter.astype(np.int64) + emit_vert.astype(np.int64)
    start = np.cumsum(n_emit, 1) - n_emit
    out = np.zeros((n, m + 1, 2))
    pos_i = np.where(emit_inter, start, m)  # slot m = discard bucket
    np.put_along_axis(out, np.repeat(pos_i[..., None], 2, 2), inter_pt, 1)
    pos_v = np.where(emit_vert, start + emit_inter, m)
    np.put_along_axis(out, np.repeat(pos_v[..., None], 2, 2), verts, 1)
    return out[:, :m], n_emit.sum(1)


def batch_quad_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Exact convex IoU for N pairs of quads a, b: (N, 4, 2) -> (N,).

    Vectorized Sutherland-Hodgman clip — one numpy program for the whole
    batch instead of N Python round-trips; matches quad_iou() to
    float64 clip precision.
    """
    n = len(a)
    if n == 0:
        return np.zeros((0,))
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    # the half-plane convention in _batch_clip assumes CCW clip quads
    ccw = _batch_signed_area2(b, np.full(n, 4)) >= 0
    b = np.where(ccw[:, None, None], b, b[:, ::-1])
    verts = np.zeros((n, _CLIP_M, 2))
    verts[:, :4] = a
    counts = np.full(n, 4)
    for k in range(4):
        verts, counts = _batch_clip(verts, counts, b[:, k],
                                    b[:, (k + 1) % 4])
    inter = 0.5 * np.abs(_batch_signed_area2(verts, counts))
    area_a = 0.5 * np.abs(_batch_signed_area2(a, np.full(n, 4)))
    area_b = 0.5 * np.abs(_batch_signed_area2(b, np.full(n, 4)))
    union = area_a + area_b - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def standard_nms(polys: np.ndarray, thresh: float) -> np.ndarray:
    """Greedy score-ordered NMS on (N, 9) rows.

    Exact greedy semantics (pinned against the naive O(N^2) loop in
    tests/test_nms.py), computed without per-pair Python IoU calls: an
    AABB-overlap prefilter selects candidate pairs, batch_quad_iou scores
    them all in one vectorized pass, and the greedy scan just reads the
    precomputed adjacency.
    """
    if len(polys) == 0:
        return polys
    n = len(polys)
    quads = polys[:, :8].reshape(-1, 4, 2)
    xmin, ymin = quads[:, :, 0].min(1), quads[:, :, 1].min(1)
    xmax, ymax = quads[:, :, 0].max(1), quads[:, :, 1].max(1)
    ov = ((xmin[:, None] <= xmax[None, :]) & (xmax[:, None] >= xmin[None, :])
          & (ymin[:, None] <= ymax[None, :])
          & (ymax[:, None] >= ymin[None, :]))
    iu, ju = np.nonzero(np.triu(ov, 1))
    ious = batch_quad_iou(quads[iu], quads[ju])
    hit = ious > thresh
    adj_i, adj_j = iu[hit], ju[hit]
    # CSR-style neighbor lists over the symmetric IoU>thresh graph
    deg = np.bincount(adj_i, minlength=n) + np.bincount(adj_j, minlength=n)
    nbr_of = np.concatenate([adj_i, adj_j])
    nbr_to = np.concatenate([adj_j, adj_i])
    order_e = np.argsort(nbr_of, kind="stable")
    nbr_to = nbr_to[order_e]
    starts = np.concatenate([[0], np.cumsum(deg)])
    suppressed = np.zeros(n, bool)
    keep = []
    for i in np.argsort(-polys[:, 8]):
        if suppressed[i]:
            continue
        keep.append(i)
        suppressed[nbr_to[starts[i]:starts[i + 1]]] = True
        suppressed[i] = False
    return polys[keep]


def _chain_merge(polys: np.ndarray, thresh: float) -> np.ndarray:
    """Row-adjacency merge, vectorized.

    Consecutive raster-order candidates with IoU > thresh form chains;
    each chain collapses to the score-weighted vertex average with summed
    score. Score-weighted averaging is associative, so a chain merge
    equals the sequential running merge exactly whenever the merge
    decisions agree; decisions here compare ORIGINAL consecutive quads
    (one batched IoU pass) rather than the running average — for the
    near-duplicate raster runs EAST produces the two are identical, and
    the batched form has no Python pair loop.
    """
    n = len(polys)
    if n <= 1:
        return polys.copy()
    q = polys[:, :8].reshape(n, 4, 2)
    link = batch_quad_iou(q[:-1], q[1:]) > thresh  # (n-1,)
    chain = np.concatenate([[0], np.cumsum(~link)])
    k = int(chain[-1]) + 1
    w = polys[:, 8]
    sums = np.zeros((k, 9))
    np.add.at(sums, chain,
              np.concatenate([polys[:, :8] * w[:, None], w[:, None]], 1))
    out = np.empty((k, 9))
    out[:, :8] = sums[:, :8] / sums[:, 8:9]
    out[:, 8] = sums[:, 8]
    return out


def locality_aware_nms(polys: np.ndarray, thresh: float = 0.3,
                       max_candidates: int = 1024) -> np.ndarray:
    """EAST locality-aware NMS, vectorized end to end.

    polys: (N, 9) float — rows are raster-order detections
    [x0,y0,...,x3,y3,score]. Row-adjacent quads with IoU > thresh are
    merged by score-weighted averaging first (vectorized chain merge over
    ALL candidates — no pre-merge cap, so adjacency runs can never be
    split), then standard NMS runs on the merged
    set. ``max_candidates`` now bounds only the post-merge NMS input
    (top-K by score; 0 disables) and in practice never binds: thousands
    of raster candidates merge to a handful of chains.
    """
    if len(polys) == 0:
        return polys.reshape(0, 9)
    merged = _chain_merge(np.asarray(polys, np.float64), thresh)
    if max_candidates and len(merged) > max_candidates:
        import warnings

        warnings.warn(
            f"locality_aware_nms: {len(merged)} merged candidates capped "
            f"to the top {max_candidates} by score "
            f"(cfg.infer.nms_max_candidates; 0 disables)",
            RuntimeWarning, stacklevel=2)
        top = np.argpartition(-merged[:, 8],
                              max_candidates)[:max_candidates]
        merged = merged[np.sort(top)]
    return standard_nms(merged, thresh)
