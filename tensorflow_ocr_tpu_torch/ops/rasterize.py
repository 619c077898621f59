"""Polygon rasterization on the device.

Port of ``tensorflow_ocr_tpu/ops/rasterize.py:20-64``: an even-odd
(crossing-number) test of every pixel centre against every polygon,
batched over images. Where polygons overlap, the higher index wins
(cv2.fillPoly's overwrite order), because the instance id is the max.
The arithmetic follows the JAX function's order, so the rasters are
bit-exact against it.
"""

from __future__ import annotations

import torch


def points_in_polygons(px: torch.Tensor, py: torch.Tensor,
                       polys: torch.Tensor, valid: torch.Tensor
                       ) -> torch.Tensor:
    """px, py (P,) float32; polys (B, K, V, 2); valid (B, K) bool.
    Returns (B, P, K) bool: point p inside polygon k of image b."""
    x1, y1 = polys[..., 0], polys[..., 1]          # (B, K, V)
    x2, y2 = x1.roll(-1, dims=-1), y1.roll(-1, dims=-1)
    pxe = px[None, :, None, None]                  # (1, P, 1, 1)
    pye = py[None, :, None, None]
    x1e, y1e = x1[:, None], y1[:, None]            # (B, 1, K, V)
    straddle = (y1e > pye) != (y2[:, None] > pye)
    dy = y2 - y1
    safe_dy = torch.where(dy == 0, torch.ones_like(dy), dy)[:, None]
    x_cross = (x2 - x1)[:, None] * (pye - y1e) / safe_dy + x1e
    crossings = straddle & (pxe < x_cross)
    inside = crossings.sum(-1, dtype=torch.int32) % 2 == 1  # (B, P, K)
    return inside & valid[:, None, :]


def rasterize_instances(polys: torch.Tensor, valid: torch.Tensor,
                        height: int, width: int) -> torch.Tensor:
    """polys (B, K, V, 2) float32 in pixel coordinates; valid (B, K)
    bool. Returns (B, height, width) int32: 0 background, k+1 inside
    polygon k (the largest such k)."""
    dev = polys.device
    gy, gx = torch.meshgrid(torch.arange(height, dtype=torch.float32,
                                         device=dev),
                            torch.arange(width, dtype=torch.float32,
                                         device=dev), indexing="ij")
    inside = points_in_polygons(gx.reshape(-1), gy.reshape(-1), polys, valid)
    ids = torch.arange(1, polys.shape[1] + 1, dtype=torch.int32, device=dev)
    inst = torch.where(inside, ids, torch.zeros_like(ids)).amax(-1)
    return inst.reshape(-1, height, width)
