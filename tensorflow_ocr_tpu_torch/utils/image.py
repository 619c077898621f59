"""Inference-time image utilities and the ICDAR result writers.

Port of ``tensorflow_ocr_tpu/utils/image.py`` (``resize_image`` :20-34,
``get_test_images`` :37-45, ``write_result_txt`` :48-63, ``draw_boxes``
:66-72, ``write_overlay`` :75-80) without ``cv2``: the resize is
``data/codec.py`` ``resize``, ``cv2.resize(INTER_LINEAR)`` in cv2's fixed
point; the overlay's outlines are ``codec.line`` at thickness 2 (cv2's
``drawContours`` within the thick line's caps and joins) and the file is
``codec.imwrite``'s.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

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


def write_result_txt(output_dir: str, im_fn: str,
                     boxes: Sequence[np.ndarray]) -> str:
    """``<output_dir>/res_<stem>.txt``: a box a line, its 8 coordinates
    cast to int, CRLF line ends (the ICDAR submission format); returns the
    path."""
    os.makedirs(output_dir, exist_ok=True)
    stem = os.path.basename(im_fn).split(".")[0]
    res_file = os.path.join(output_dir, f"res_{stem}.txt")
    with open(res_file, "w", newline="") as f:
        for box in boxes:
            b = np.asarray(box).reshape(4, 2).astype(np.int64)
            f.write("{},{},{},{},{},{},{},{}\r\n".format(
                b[0, 0], b[0, 1], b[1, 0], b[1, 1],
                b[2, 0], b[2, 1], b[3, 0], b[3, 1]))
    return res_file


def draw_boxes(im: np.ndarray, boxes: Sequence[np.ndarray],
               color=(0, 255, 0), thickness: int = 2) -> np.ndarray:
    """A copy of ``im`` with each box's closed outline drawn."""
    out = im.copy()
    for box in boxes:
        b = np.asarray(box).reshape(4, 2).astype(np.int32)
        for k in range(4):
            codec.line(out, tuple(int(v) for v in b[k]),
                       tuple(int(v) for v in b[(k + 1) % 4]), color,
                       thickness)
    return out


def write_overlay(output_dir: str, im_fn: str, im: np.ndarray,
                  boxes: Sequence[np.ndarray]) -> str:
    """``im`` (BGR) with the boxes drawn, written under ``output_dir``
    with the image's own file name; returns the path."""
    os.makedirs(output_dir, exist_ok=True)
    img_path = os.path.join(output_dir, os.path.basename(im_fn))
    codec.imwrite(img_path, draw_boxes(im, boxes))
    return img_path
