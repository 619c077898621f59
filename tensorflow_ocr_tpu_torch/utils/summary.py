"""TensorBoard summaries (scalars + images).

A copy of ``tensorflow_ocr_tpu/utils/summary.py`` (JAX-free; the port
keeps its own so that it imports nothing of the JAX package). Rebuild of the reference's observability surface (SURVEY.md §5.5):
- scalar summaries: model/total loss, learning rate, per-part losses
  (multigpu_train.py:64-65,106; nets/model.py:258-259)
- image summaries: input frame, GT score map, predicted score map
  (multigpu_train.py:50-63)
Writer: torch.utils.tensorboard (TF-free), event files land in the
checkpoint dir like the reference's FileWriter (multigpu_train.py:145).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class SummaryWriter:
    """Lazy TB writer; silently no-ops if tensorboard is unavailable."""

    def __init__(self, logdir: str):
        self._writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter as TBWriter

            self._writer = TBWriter(logdir)
        except Exception:
            pass

    def add_scalar(self, tag: str, value: float, step: int):
        if self._writer is not None:
            self._writer.add_scalar(tag, float(value), step)

    def add_scalars(self, metrics: Dict[str, float], step: int):
        for k, v in metrics.items():
            self.add_scalar(k, v, step)

    def add_histogram(self, tag: str, values, step: int):
        """Grad/score histograms (reference nets/pixellink.py:84-85,
        train_pixellink.py:190-193)."""
        if self._writer is not None:
            self._writer.add_histogram(tag, np.asarray(values), step)

    def add_image_hwc(self, tag: str, img: np.ndarray, step: int):
        """img: (H, W, C) uint8/float in [0,255] or [0,1]."""
        if self._writer is None:
            return
        img = np.asarray(img)
        if img.dtype != np.uint8:
            mx = img.max()
            img = (img * (255.0 / mx) if mx > 1.5 else img * 255.0).clip(0, 255)
            img = img.astype(np.uint8)
        if img.ndim == 2:
            img = img[..., None]
        self._writer.add_image(tag, img, step, dataformats="HWC")

    def add_detection_summaries(self, step: int, images=None,
                                gt_score=None, pred_score=None):
        """The reference's image panel (multigpu_train.py:50-63)."""
        if images is not None:
            self.add_image_hwc("input", np.asarray(images)[0], step)
        if gt_score is not None:
            self.add_image_hwc("score_map", np.asarray(gt_score)[0], step)
        if pred_score is not None:
            self.add_image_hwc(
                "score_map_pred", np.asarray(pred_score)[0], step
            )

    def flush(self):
        if self._writer is not None:
            self._writer.flush()

    def close(self):
        if self._writer is not None:
            self._writer.close()
