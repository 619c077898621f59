"""On-device decode: PixelLink components and boxes, EAST candidates.

Port of ``tensorflow_ocr_tpu/ops/decode.py`` (``pixel_link_mask``
:36-53, ``link_adjacency`` :56-85, ``extract_components`` :168-270,
``overflow_retry_needed`` :273-288, ``pixellink_decode`` :308-336,
``east_detect`` :339-367). The
batch dimension is written out where JAX used ``vmap``; segment min/max
become ``scatter_reduce`` on +/-inf buffers. The connected components go
through ``ops/kernels.py``: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors. EAST's locality-aware NMS runs on the host
after :func:`east_detect` (``utils/nms.py``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tensorflow_ocr_tpu_torch.ops.geometry import restore_rectangle_rbox_torch
from tensorflow_ocr_tpu_torch.ops.kernels import connected_components
from tensorflow_ocr_tpu_torch.ops.labels import LINK_OFFSETS, shift_map


def pixel_link_mask(pixel_scores: torch.Tensor, link_scores: torch.Tensor,
                    pixel_thresh: float = 0.8, link_thresh: float = 0.8,
                    compat_reference_bugs: bool = False) -> torch.Tensor:
    """Positive-pixel mask after the link-consistency filter
    (decode.py:36-53): score > ``pixel_thresh`` and every direction's link
    probability >= ``link_thresh``. pixel_scores (..., h, w), link_scores
    (..., h, w, 8). ``compat_reference_bugs`` keeps the reference's net
    effect (its test.py:72 applies no link filter): the score test alone."""
    mask = pixel_scores > pixel_thresh
    if compat_reference_bugs:
        return mask
    return mask & (link_scores >= link_thresh).all(-1)


def link_adjacency(pixel_mask: torch.Tensor, link_scores: torch.Tensor,
                   link_thresh: float = 0.9) -> torch.Tensor:
    """(B, h, w, 8) bool: pixel positive AND link_c > thresh AND the
    neighbour in direction c positive (decode.py:56-70)."""
    return torch.stack(
        [pixel_mask & (link_scores[..., c] > link_thresh)
         & shift_map(pixel_mask, dx, dy, False)
         for c, (dx, dy) in enumerate(LINK_OFFSETS)], dim=-1)


def extract_components(labels: torch.Tensor, max_components: int = 128,
                       min_size: int = 10, num_angles: int = 90,
                       max_pixels: int | None = None):
    """Min-area boxes of the largest components (decode.py:168-270).

    labels (B, h, w) int32 root-index map. Returns boxes (B, K, 4, 2)
    float32 in (x, y) at label-map resolution, sizes (B, K) int32 and
    valid (B, K) bool, K = ``max_components``. ``max_pixels`` bounds the
    foreground pixels fitted (default max(4096, h*w//4)); a component
    that did not fit whole is marked invalid (see overflow_retry_needed).
    """
    b, h, w = labels.shape
    n = h * w
    k_max = max_components
    dev = labels.device
    if max_pixels is None:
        max_pixels = max(4096, n // 4)
    p = min(n, max_pixels)
    flat = labels.reshape(b, n).long()

    sizes_all = torch.zeros((b, n + 1), dtype=torch.int32, device=dev)
    sizes_all.scatter_add_(1, flat, torch.ones_like(flat, dtype=torch.int32))
    # top-K roots by size; ties in index order, as jax.lax.top_k gives them
    top_sizes, top_roots = torch.sort(sizes_all[:, :n], dim=1,
                                      descending=True, stable=True)
    top_sizes, top_roots = top_sizes[:, :k_max], top_roots[:, :k_max]
    valid = top_sizes > min_size

    # compact id per pixel: slot of its root in top_roots, else K
    sorted_roots, order = torch.sort(top_roots, dim=1)
    pos = torch.searchsorted(sorted_roots, flat).clamp_(0, k_max - 1)
    hit = sorted_roots.gather(1, pos) == flat
    compact = torch.where(hit, order.gather(1, pos), k_max)

    ys = torch.arange(h, dtype=torch.float32, device=dev).repeat_interleave(w)
    xs = torch.arange(w, dtype=torch.float32, device=dev).repeat(h)

    # foreground compaction: slot = rank among foreground pixels; overflow
    # and background go to the pad slot p, which is cut off
    fg = compact < k_max
    slot = torch.cumsum(fg.int(), dim=1) - 1
    slot = torch.where(fg & (slot < p), slot, p)
    xs_c = torch.zeros((b, p + 1), device=dev).scatter_(
        1, slot, xs.expand(b, n))[:, :p]
    ys_c = torch.zeros((b, p + 1), device=dev).scatter_(
        1, slot, ys.expand(b, n))[:, :p]
    comp_c = torch.full((b, p + 1), k_max, dtype=torch.long,
                        device=dev).scatter_(1, slot, compact)[:, :p]

    thetas = torch.arange(num_angles, dtype=torch.float32, device=dev) * (
        math.pi / 2 / num_angles)
    c, s = torch.cos(thetas), torch.sin(thetas)
    proj_u = xs_c[..., None] * c + ys_c[..., None] * s       # (B, p, A)
    proj_v = -xs_c[..., None] * s + ys_c[..., None] * c

    seg = comp_c[..., None].expand(b, p, num_angles)

    def segment(values, reduce, init):
        out = torch.full((b, k_max + 1, num_angles), init, device=dev)
        return out.scatter_reduce_(1, seg, values, reduce)[:, :k_max]

    u_min = segment(proj_u, "amin", math.inf)
    u_max = segment(proj_u, "amax", -math.inf)
    v_min = segment(proj_v, "amin", math.inf)
    v_max = segment(proj_v, "amax", -math.inf)

    # only fully compacted components keep valid (decode.py:236-249)
    comp_counts = torch.zeros((b, k_max + 1), dtype=torch.int32, device=dev)
    comp_counts.scatter_add_(1, comp_c, torch.ones_like(comp_c,
                                                        dtype=torch.int32))
    valid = valid & (comp_counts[:, :k_max] == top_sizes)
    u_min, u_max, v_min, v_max = (
        torch.where(torch.isfinite(t), t, 0.0)
        for t in (u_min, u_max, v_min, v_max))

    areas = (u_max - u_min) * (v_max - v_min)                # (B, K, A)
    k = torch.argmin(areas, dim=2, keepdim=True)             # first minimum
    ck, sk = c[k[..., 0]], s[k[..., 0]]
    u0, u1 = u_min.gather(2, k)[..., 0], u_max.gather(2, k)[..., 0]
    v0, v1 = v_min.gather(2, k)[..., 0], v_max.gather(2, k)[..., 0]
    # corners (0,0), (1,0), (1,1), (0,1) in (u, v) box units; built on
    # the device so the decode makes no host->device copy
    du, dv = u1 - u0, v1 - v0
    us = torch.stack([u0, u0 + du, u0 + du, u0], dim=-1)
    vs = torch.stack([v0, v0, v0 + dv, v0 + dv], dim=-1)
    bx = us * ck[..., None] - vs * sk[..., None]
    by = us * sk[..., None] + vs * ck[..., None]
    return torch.stack([bx, by], dim=-1), top_sizes, valid


def overflow_retry_needed(sizes, valid, min_size: int) -> bool:
    """True iff the foreground budget of :func:`extract_components`
    invalidated a size-qualified component (decode.py:273-288); callers
    re-run the decode once with ``max_pixels = h*w``. Host-side numpy."""
    sizes, valid = np.asarray(sizes), np.asarray(valid)
    return bool(np.any((sizes > min_size) & ~valid))


def pixellink_decode(pixel_scores: torch.Tensor, link_scores: torch.Tensor,
                     pixel_thresh: float = 0.8, link_thresh: float = 0.9,
                     min_size: int = 10, max_components: int = 128,
                     num_angles: int = 90, max_pixels: int | None = None):
    """Batched PixelLink decode (decode.py:308-336).

    pixel_scores (B, h, w); link_scores (B, h, w, 8). Returns (boxes,
    sizes, valid) at label-map resolution; callers scale by the stride.
    """
    mask = pixel_scores > pixel_thresh
    edges = link_adjacency(mask, link_scores, link_thresh)
    labels = connected_components(edges, mask)
    return extract_components(labels, max_components, min_size, num_angles,
                              max_pixels=max_pixels)


def east_detect(score_map: torch.Tensor, geo_map: torch.Tensor,
                score_thresh: float = 0.8, max_boxes: int = 2048):
    """EAST decode on the device, batched (decode.py:339-367): the top
    ``max_boxes`` pixels by score (ties in index order, as
    ``jax.lax.top_k`` gives them), their origin at full resolution (the
    pixel times 4, the reference's stride scaling), and their quads: RBOX
    (geo (B, h, w, 5)) restored from the edge distances and angle, QUAD
    (geo (B, h, w, 8)) the origin plus the corner offsets.

    score_map (B, h, w). Returns quads (B, K, 4, 2), scores (B, K) and
    valid (B, K) = score > ``score_thresh``; the host then applies
    locality-aware NMS to the valid rows.
    """
    b, h, w = score_map.shape
    flat = score_map.reshape(b, -1)
    k = min(max_boxes, flat.shape[1])
    vals, idx = torch.sort(flat, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k]
    valid = vals > score_thresh
    origin = torch.stack([(idx % w).float(), (idx // w).float()], -1) * 4.0
    c = geo_map.shape[-1]
    geo = geo_map.reshape(b, -1, c).gather(
        1, idx[..., None].expand(b, k, c))
    if c == 8:  # QUAD: full-resolution offsets from the scaled pixel
        quads = origin[:, :, None, :] + geo.reshape(b, k, 4, 2)
    else:
        quads = restore_rectangle_rbox_torch(origin, geo)
    return quads, vals, valid
