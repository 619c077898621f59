"""Inference-time image utilities.

Port of ``tensorflow_ocr_tpu/utils/image.py`` (``resize_image`` :20-34,
``get_test_images`` :37-45) without ``cv2``: the resize is
``data/codec.py`` ``resize``, ``cv2.resize(INTER_LINEAR)`` in cv2's fixed
point.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from tensorflow_ocr_tpu_torch.data import codec


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
        im = codec.resize(im, (resize_w, resize_h))
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
