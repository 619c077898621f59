"""Inference: forward + on-device PixelLink decode for serving.

Port of the PixelLink half of ``tensorflow_ocr_tpu/infer.py``
(``pixel_link_scores`` :41-52, ``Predictor`` :55-306). Weights come from
a state_dict or from the flat ``.npz`` of Flax variables that
``scripts/export_torch_weights.py`` writes; with neither, the model keeps
its seeded init. There is no Orbax restore (it needs JAX). Only box
scaling stays on the host.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from tensorflow_ocr_tpu_torch.config import InferConfig
from tensorflow_ocr_tpu_torch.models import build_model
from tensorflow_ocr_tpu_torch.models.convert import load_npz
from tensorflow_ocr_tpu_torch.ops import decode as D
from tensorflow_ocr_tpu_torch.utils.image import resize_image

# written next to the checkpoints by tensorflow_ocr_tpu/train/calibrate.py
OPERATING_POINT_FILE = "operating_point.json"


def pixel_link_scores(out: Mapping[str, torch.Tensor]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B,h,w,2) pixel + (B,h,w,16) link logits -> (B,h,w) P(text) and
    (B,h,w,8) P(link); link channels are (direction, class) pairs."""
    pl, ll = out["pixel_logits"], out["link_logits"]
    ps = torch.softmax(pl, dim=-1)[..., 1]
    ls = torch.softmax(ll.reshape(ll.shape[:-1] + (8, 2)), dim=-1)[..., 1]
    return ps, ls


def load_operating_point(weights_dir: str) -> Optional[dict]:
    """The calibrated thresholds stored beside the weights, or None if
    absent or unreadable (train/calibrate.py:118-126)."""
    try:
        with open(os.path.join(weights_dir, OPERATING_POINT_FILE)) as f:
            op = json.load(f)
        return op if isinstance(op, dict) else None
    except (OSError, ValueError):
        return None


class Predictor:
    """PixelLink detect on one device: batched forward + decode.

    ``model_name``: a name of the :func:`build_model` registry.
    ``weights``: a state_dict, or the path of a flat ``.npz`` of Flax
    variables (then an ``operating_point.json`` beside it overrides the
    ``infer`` thresholds); with neither, the seed-0 init of
    :func:`build_model`. ``infer``: thresholds and decode bounds
    (defaults of :class:`InferConfig`). ``device="cuda"`` raises when no
    GPU is present: the predictor never carries on on the CPU unasked.
    """

    # extract_components clamps max_pixels to h*w: any value >= the label
    # map's area is the exact, full budget
    _FULL_BUDGET = 1 << 30

    def __init__(self, model_name: str = "pixellink_resnet50",
                 weights: Union[None, str, os.PathLike,
                                Mapping[str, torch.Tensor]] = None,
                 device: Union[str, torch.device] = "cuda",
                 dtype: torch.dtype = torch.bfloat16,
                 infer: Optional[InferConfig] = None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Predictor(device='cuda'): torch sees no "
                               "CUDA device")
        self.infer = icfg = infer if infer is not None else InferConfig()
        self.model = build_model(model_name, dtype=dtype)
        weights_dir = None
        if isinstance(weights, (str, os.PathLike)):
            weights_dir = os.path.dirname(os.path.abspath(weights))
            weights = load_npz(weights)
        if weights is not None:
            self.model.load_state_dict(weights, strict=True)
        self.model.to(self.device)
        self.stride = float(self.model.output_stride)
        # min_component_size is given on the stride-4 grid; scale by area
        self.min_size = int(round(
            icfg.min_component_size * (4.0 / self.stride) ** 2))
        self.pixel_thresh = icfg.pixel_conf_threshold
        self.link_thresh = icfg.link_conf_threshold
        self.calibrated = False
        if icfg.use_calibrated_thresholds and weights_dir is not None:
            op = load_operating_point(weights_dir)
            if op:
                self.pixel_thresh = float(op.get("pixel", self.pixel_thresh))
                self.link_thresh = float(op.get("link", self.link_thresh))
                self.calibrated = True
        # full-budget decode re-runs (overflow_retry_needed): counted,
        # never a silent zero-box result
        self.overflow_retries = 0

    @torch.inference_mode()
    def _run(self, x: torch.Tensor, full_budget: bool = False):
        ps, ls = pixel_link_scores(self.model(x))
        return D.pixellink_decode(
            ps, ls, pixel_thresh=self.pixel_thresh,
            link_thresh=self.link_thresh, min_size=self.min_size,
            max_components=self.infer.max_components,
            max_pixels=self._FULL_BUDGET if full_budget else None)

    def _to_host(self, out):
        """Start the copy of the decode outputs to the host; returns
        (host tensors, event that marks them complete or None)."""
        if self.device.type != "cuda":
            return out, None
        host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                     .copy_(t, non_blocking=True) for t in out)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def _submit_batch(self, images_rgb: np.ndarray):
        """Enqueue transfer + forward + decode for one batch (async on a
        GPU). Images stay uint8 on the wire and are cast on the device."""
        x = torch.from_numpy(np.ascontiguousarray(images_rgb))
        if self.device.type == "cuda":
            x = x.pin_memory().to(self.device, non_blocking=True)
        # keep x: an overflow retry re-runs on the device-resident images
        return self._to_host(self._run(x)), x, len(images_rgb)

    def _finalize_batch(self, pending, x: torch.Tensor, n: int
                        ) -> List[List[np.ndarray]]:
        """Wait for one batch's results and build per-image box lists."""
        host, done = pending
        if done is not None:
            done.synchronize()
        raw_boxes, sizes, valid = (t.cpu().numpy() for t in host)
        if D.overflow_retry_needed(sizes, valid, self.min_size):
            # a dense map blew the foreground budget: one exact re-run
            self.overflow_retries += 1
            raw_boxes, sizes, valid = (
                t.cpu().numpy() for t in self._run(x, full_budget=True))
        return [[b * self.stride for b in raw_boxes[i][valid[i]]]
                for i in range(n)]

    def detect_batch(self, images_rgb: np.ndarray) -> List[List[np.ndarray]]:
        """Detect on (B, H, W, 3) uint8 images, H and W multiples of 32.
        Returns per-image lists of (4, 2) boxes in input coordinates."""
        return self._finalize_batch(*self._submit_batch(images_rgb))

    def detect_batches(self, batches, depth: int = 2):
        """Pipelined serving over a stream of same-shaped batches: yields
        per-batch results (as :meth:`detect_batch`) while up to ``depth``
        batches are in flight, so batch k+1's transfer and forward are
        queued before batch k's results are awaited."""
        q: deque = deque()
        for imgs in batches:
            q.append(self._submit_batch(imgs))
            while len(q) > depth:
                yield self._finalize_batch(*q.popleft())
        while q:
            yield self._finalize_batch(*q.popleft())

    def detect(self, im_rgb: np.ndarray) -> Tuple[List[np.ndarray], float]:
        """Detect text boxes in one RGB image of any size. Returns (boxes
        in original image coordinates, milliseconds taken)."""
        t0 = time.perf_counter()
        im, (ratio_h, ratio_w) = resize_image(im_rgb,
                                              self.infer.max_side_len)
        boxes = self.detect_batch(im[None])[0]
        net_ms = (time.perf_counter() - t0) * 1000
        ratio = np.array([ratio_w, ratio_h], np.float32)
        return [b / ratio for b in boxes], net_ms
