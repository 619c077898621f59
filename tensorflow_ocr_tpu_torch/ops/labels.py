"""PixelLink link order and training labels.

Port of ``tensorflow_ocr_tpu/ops/labels.py:35-89, 147-182``: the link
channel order shared by the decode and the CC kernel, the shift that
reads each pixel's neighbour in a link direction, and the on-device
label maps of the train step (score, 8-direction links, training mask)
rasterized straight onto the stride-4 output grid. Batched over images;
bit-exact against the JAX functions.
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
    poly_h = torch.minimum(_side(polys, 0, 3), _side(polys, 1, 2))
    poly_w = torch.minimum(_side(polys, 0, 1), _side(polys, 2, 3))
    too_small = torch.minimum(poly_h, poly_w) < float(min_text_size)
    mask_out = valid & (too_small | ignored)                    # (B, K)
    flag = torch.cat([torch.zeros_like(mask_out[:, :1]), mask_out], 1)
    masked = torch.gather(flag, 1, inst.reshape(inst.shape[0], -1).long())
    mask = torch.where(masked.reshape(inst.shape), 0.0, 1.0)
    return score, link, mask
