"""Inference-time image utilities.

Port of ``tensorflow_ocr_tpu/utils/image.py`` (``resize_image`` :20-34,
``get_test_images`` :37-45) without ``cv2``: the resize is torch's
bilinear interpolation with half-pixel centres and no antialiasing, the
rule ``cv2.resize(INTER_LINEAR)`` follows, rounded back to uint8.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def resize_image(im: np.ndarray, max_side_len: int = 3000
                 ) -> Tuple[np.ndarray, Tuple[float, float]]:
    """Cap the longest side, round each side down to a multiple of 32 by
    the reference's ``(h//32 - 1)*32`` rule; returns (image, (ratio_h,
    ratio_w))."""
    h, w = im.shape[:2]
    if max(h, w) > max_side_len:
        ratio = float(max_side_len) / h if h > w else float(max_side_len) / w
    else:
        ratio = 1.0
    resize_h = int(h * ratio)
    resize_w = int(w * ratio)
    resize_h = resize_h if resize_h % 32 == 0 else (resize_h // 32 - 1) * 32
    resize_w = resize_w if resize_w % 32 == 0 else (resize_w // 32 - 1) * 32
    resize_h = max(resize_h, 32)
    resize_w = max(resize_w, 32)
    if (resize_h, resize_w) != (h, w):
        x = torch.from_numpy(np.ascontiguousarray(im)).permute(2, 0, 1)[None]
        x = F.interpolate(x.float(), size=(resize_h, resize_w),
                          mode="bilinear", align_corners=False,
                          antialias=False)
        im = x[0].permute(1, 2, 0).round().clamp(0, 255).to(
            torch.uint8).numpy()
    return im, (resize_h / float(h), resize_w / float(w))


def get_test_images(test_data_path: str) -> List[str]:
    """Recursive walk for jpg/png/jpeg/JPG files, sorted."""
    files = []
    exts = ("jpg", "png", "jpeg", "JPG")
    for parent, _, filenames in os.walk(test_data_path):
        for filename in filenames:
            if filename.endswith(exts):
                files.append(os.path.join(parent, filename))
    return sorted(files)
