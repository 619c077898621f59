"""PixelLink link order and the training labels of every head.

Port of ``tensorflow_ocr_tpu/ops/labels.py``: the link channel order
shared by the decode and the CC kernel, the shift that reads each
pixel's neighbour in a link direction, the on-device PixelLink label
maps (score, 8-direction links, training mask) rasterized straight onto
the output grid (the train step's) or at full resolution and
subsampled (:func:`pixellink_labels_batch`), and the EAST maps
(:func:`east_labels_batch`: score from the shrunk polygons, RBOX or
QUAD geometry of the instance that wins each pixel, the training mask
from the full polygons).
Batched over images; the scores and masks bit-exact against the JAX
functions, the geometry within float32 rounding.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tensorflow_ocr_tpu_torch.ops.rasterize import rasterize_instances

# (dx, dy) per link channel, matching the reference channel order:
# 0=left, 1=left_down, 2=left_up, 3=right, 4=right_down, 5=right_up,
# 6=up, 7=down. csrc/cc.cu hard-codes the same table.
LINK_OFFSETS = (
    (-1, 0),   # 0 left
    (-1, 1),   # 1 left_down
    (-1, -1),  # 2 left_up
    (1, 0),    # 3 right
    (1, 1),    # 4 right_down
    (1, -1),   # 5 right_up
    (0, -1),   # 6 up
    (0, 1),    # 7 down
)


def shift_map(x: torch.Tensor, dx: int, dy: int, fill) -> torch.Tensor:
    """out[..., y, x] = in[..., y + dy, x + dx], ``fill`` outside."""
    h, w = x.shape[-2:]
    out = torch.full_like(x, fill)
    out[..., max(0, -dy):h - max(0, dy), max(0, -dx):w - max(0, dx)] = \
        x[..., max(0, dy):h - max(0, -dy), max(0, dx):w - max(0, -dx)]
    return out


def link_map_from_instances(inst: torch.Tensor) -> torch.Tensor:
    """(B, H, W) int32 instance ids -> (B, H, W, 8) float32 links.

    Link c is 1 where the pixel belongs to an instance and its neighbour
    in direction c belongs to the same one; instance pixels on the map's
    border link in every direction (labels.py:66-89).
    """
    h, w = inst.shape[-2:]
    fg = inst > 0
    ys = torch.arange(h, device=inst.device)[:, None]
    xs = torch.arange(w, device=inst.device)[None, :]
    on_border = (xs == 0) | (xs == w - 1) | (ys == 0) | (ys == h - 1)
    chans = []
    for dx, dy in LINK_OFFSETS:
        same = fg & (shift_map(inst, dx, dy, 0) == inst)
        chans.append(torch.where(fg & on_border, True, same))
    return torch.stack(chans, -1).float()


def _side(p: torch.Tensor, i: int, j: int) -> torch.Tensor:
    d = p[..., i, :] - p[..., j, :]
    return torch.sqrt((d * d).sum(-1))


def pixellink_labels(polys: torch.Tensor, ignored: torch.Tensor,
                     valid: torch.Tensor, height: int, width: int,
                     min_text_size: int = 10
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-resolution labels (labels.py:93-133), batched.

    polys (B, K, 4, 2) float32 in pixels; ignored, valid (B, K) bool.
    Returns score (B, height, width) (the union raster, ignored polygons
    included), link (B, height, width, 8) and the training mask
    (B, height, width), float32, as :func:`pixellink_labels_stride`
    at stride 1.
    """
    return pixellink_labels_stride(polys, ignored, valid, height, width,
                                   stride=1, min_text_size=min_text_size)


def subsample_maps(score: torch.Tensor, link: torch.Tensor,
                   mask: torch.Tensor, stride: int = 4
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every ``stride``-th row and column of (B, H, W) score and mask
    and (B, H, W, 8) link maps (labels.py:135-142, the reference's
    ``[::4, ::4]``)."""
    return (score[:, ::stride, ::stride], link[:, ::stride, ::stride],
            mask[:, ::stride, ::stride])


def pixellink_labels_batch(polys: torch.Tensor, ignored: torch.Tensor,
                           valid: torch.Tensor, height: int, width: int,
                           min_text_size: int = 10, stride: int = 4
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Labels rasterized at full resolution, then subsampled
    (labels.py:185-206): score (B, h, w, 1), link (B, h, w, 8) and mask
    (B, h, w, 1), h = ceil(height / stride)."""
    score, link, mask = pixellink_labels(polys, ignored, valid, height,
                                         width, min_text_size)
    if stride > 1:
        score, link, mask = subsample_maps(score, link, mask, stride)
    return score[..., None], link, mask[..., None]


def pixellink_labels_stride(polys: torch.Tensor, ignored: torch.Tensor,
                            valid: torch.Tensor, out_height: int,
                            out_width: int, stride: int = 4,
                            min_text_size: int = 10
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Labels on the output grid (labels.py:147-182), batched.

    polys (B, K, 4, 2) float32 in full-resolution pixels; ignored, valid
    (B, K) bool. Pixel (i, j) of the grid samples full-resolution
    (j*stride, i*stride). Returns score (B, h, w), link (B, h, w, 8) and
    training mask (B, h, w), float32; the mask is 0 inside ignored polys
    and polys whose shorter side is below ``min_text_size``.
    """
    inst = rasterize_instances(polys / float(stride), valid, out_height,
                               out_width)
    score = (inst > 0).float()
    link = link_map_from_instances(inst)
    return score, link, _training_mask(polys, ignored, valid, inst,
                                       min_text_size)


def _training_mask(polys: torch.Tensor, ignored: torch.Tensor,
                   valid: torch.Tensor, inst: torch.Tensor,
                   min_text_size: int) -> torch.Tensor:
    """(B, h, w) float32: 0 on the pixels of ``inst`` (the instance
    raster of the full polygons) that belong to an ignored polygon or to
    one whose shorter side is below ``min_text_size``, else 1."""
    poly_h = torch.minimum(_side(polys, 0, 3), _side(polys, 1, 2))
    poly_w = torch.minimum(_side(polys, 0, 1), _side(polys, 2, 3))
    too_small = torch.minimum(poly_h, poly_w) < float(min_text_size)
    mask_out = valid & (too_small | ignored)                    # (B, K)
    flag = torch.cat([torch.zeros_like(mask_out[:, :1]), mask_out], 1)
    masked = torch.gather(flag, 1, inst.reshape(inst.shape[0], -1).long())
    return torch.where(masked.reshape(inst.shape), 0.0, 1.0)


def _grid(height: int, width: int, stride: int, device
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ys, xs) (height, width) float32: the full-resolution coordinates
    of the output grid's pixels, (i * stride, j * stride)."""
    ys = torch.arange(height, device=device).float()[:, None] * stride
    xs = torch.arange(width, device=device).float()[None, :] * stride
    return ys.expand(height, width), xs.expand(height, width)


def _per_pixel(table: torch.Tensor, inst: torch.Tensor) -> torch.Tensor:
    """(B, K, ...) per-instance values -> (B, h, w, ...): each pixel takes
    its instance's row of ``table``, zeros where ``inst`` is 0."""
    pad = torch.cat([torch.zeros_like(table[:, :1]), table], 1)
    b = torch.arange(inst.shape[0], device=inst.device)[:, None, None]
    return pad[b, inst.long()]


def _dist_point_to_segment_line(px, py, ax, ay, bx, by) -> torch.Tensor:
    """Unsigned distance from (px, py) to the line through a and b
    (labels.py:298-305)."""
    cross = (bx - ax) * (ay - py) - (ax - px) * (by - ay)
    denom = torch.sqrt((bx - ax) ** 2 + (by - ay) ** 2)
    return cross.abs() / torch.clamp(denom, min=1e-8)


def east_geo_maps(shrunk_polys: torch.Tensor, rects: torch.Tensor,
                  angles: torch.Tensor, valid: torch.Tensor, height: int,
                  width: int, stride: int = 1
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """EAST RBOX maps (labels.py:308-350), batched: score (B, h, w) from
    the shrunk polygons (B, K, 4, 2), and geo (B, h, w, 5): the distances
    from pixel (i, j), at full-resolution (j * stride, i * stride), to the
    top, right, bottom and left edges of the fitted rectangle (B, K, 4, 2)
    of the instance that wins the pixel, and its angle (B, K); zero off
    the text. Distances in full-resolution units."""
    inst = rasterize_instances(shrunk_polys / float(stride), valid, height,
                               width)
    score = (inst > 0).float()
    ys, xs = _grid(height, width, stride, inst.device)
    r = _per_pixel(rects, inst)                          # (B, h, w, 4, 2)
    a = _per_pixel(angles, inst)                         # (B, h, w)

    def edge_dist(i, j):
        return _dist_point_to_segment_line(
            xs, ys, r[..., i, 0], r[..., i, 1], r[..., j, 0], r[..., j, 1])

    geo = torch.stack([edge_dist(0, 1), edge_dist(1, 2), edge_dist(2, 3),
                       edge_dist(3, 0), a], -1)
    return score, geo * score[..., None]


def east_quad_geo_maps(shrunk_polys: torch.Tensor, polys: torch.Tensor,
                       valid: torch.Tensor, height: int, width: int,
                       stride: int = 1
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """EAST QUAD maps (labels.py:247-290), batched: score (B, h, w) from
    the shrunk polygons, and geo (B, h, w, 9): the offsets from the pixel
    (full-resolution units) to the 4 vertices of its instance's full
    polygon, [dx0, dy0, ..., dx3, dy3], then the polygon's shortest edge
    N_Q; zero off the text."""
    inst = rasterize_instances(shrunk_polys / float(stride), valid, height,
                               width)
    score = (inst > 0).float()
    ys, xs = _grid(height, width, stride, inst.device)
    q = _per_pixel(polys, inst)                          # (B, h, w, 4, 2)
    pix = torch.stack([xs, ys], -1)                      # (h, w, 2)
    offsets = (q - pix[:, :, None, :]).reshape(*inst.shape, 8)
    d = polys - polys.roll(-1, dims=-2)
    short = torch.sqrt((d * d).sum(-1)).amin(-1)         # (B, K)
    nq = _per_pixel(short, inst)
    geo = torch.cat([offsets, nq[..., None]], -1)
    return score, geo * score[..., None]


def east_labels_batch(polys: torch.Tensor, shrunk: torch.Tensor,
                      rects: torch.Tensor, angles: torch.Tensor,
                      ignored: torch.Tensor, valid: torch.Tensor,
                      out_height: int, out_width: int, stride: int = 4,
                      min_text_size: int = 10, geometry: str = "RBOX"
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """EAST labels on the output grid (labels.py:207-244): score
    (B, h, w, 1) from the shrunk polygons, geo (B, h, w, 5) for RBOX
    (:func:`east_geo_maps`) or (B, h, w, 9) for QUAD
    (:func:`east_quad_geo_maps`), and the training mask (B, h, w, 1) from
    the full polygons (ignored and too small ones zeroed, as the PixelLink
    mask)."""
    if geometry == "QUAD":
        score, geo = east_quad_geo_maps(shrunk, polys, valid, out_height,
                                        out_width, stride)
    else:
        score, geo = east_geo_maps(shrunk, rects, angles, valid, out_height,
                                   out_width, stride)
    inst = rasterize_instances(polys / float(stride), valid, out_height,
                               out_width)
    mask = _training_mask(polys, ignored, valid, inst, min_text_size)
    return score[..., None], geo, mask[..., None]
