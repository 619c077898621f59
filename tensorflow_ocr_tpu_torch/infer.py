"""Inference: forward + on-device decode for serving.

Port of ``tensorflow_ocr_tpu/infer.py`` (``pixel_scores_from_logits``
:30, ``link_scores_from_logits`` :35, ``pixel_link_scores`` :41-52,
``Predictor`` :55-306): the PixelLink and link8 heads decode on the
device (components through the CC kernel, min-area boxes); the EAST head
takes its top candidates on the device (``east_detect``) and runs
locality-aware NMS on the host (``utils/nms.py``). Weights come from
a state_dict, from the flat ``.npz`` of Flax variables that
``scripts/export_torch_weights.py`` writes, or from the newest
``ckpt_<step>`` of a port checkpoint root (the EMA or raw parameters and
the BN running statistics, as JAX's ``infer.py:60-110`` restores them);
with none, the model keeps its seeded init. There is no Orbax restore
(it needs JAX). Only box scaling stays on the host.
"""

from __future__ import annotations

import os
import time
from collections import deque
from typing import List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from tensorflow_ocr_tpu_torch.config import InferConfig
from tensorflow_ocr_tpu_torch.models import build_model
from tensorflow_ocr_tpu_torch.models.convert import load_npz
from tensorflow_ocr_tpu_torch.models.detector import model_head
from tensorflow_ocr_tpu_torch.ops import decode as D
# the operating point that checkpoint-time calibration writes beside the
# checkpoints (train/calibrate.py)
from tensorflow_ocr_tpu_torch.train.calibrate import (  # noqa: F401
    OPERATING_POINT_FILE,
    load_operating_point,
)
from tensorflow_ocr_tpu_torch.train.trainer import (
    CKPT_FILE,
    latest_checkpoint,
    load_inference_state,
)
from tensorflow_ocr_tpu_torch.utils import nms as N
from tensorflow_ocr_tpu_torch.utils.image import resize_image


def pixel_scores_from_logits(pixel_logits: torch.Tensor) -> torch.Tensor:
    """(..., 2) pixel logits -> (...) P(text) (infer.py:30-32)."""
    return torch.softmax(pixel_logits, dim=-1)[..., 1]


def link_scores_from_logits(link_logits: torch.Tensor) -> torch.Tensor:
    """(..., 16) link logits, channels in (direction, class) pairs ->
    (..., 8) P(link) (infer.py:35-38)."""
    pairs = link_logits.reshape(link_logits.shape[:-1] + (8, 2))
    return torch.softmax(pairs, dim=-1)[..., 1]


def pixel_link_scores(out: Mapping[str, torch.Tensor]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B,h,w) P(text) and (B,h,w,8) P(link) from either output schema:
    (B,h,w,2) pixel + (B,h,w,16) link logits; or link8's sigmoid
    ``score`` (B,h,w,1) and ``link_probs`` (B,h,w,8)."""
    if "pixel_logits" not in out:
        return out["score"][..., 0], out["link_probs"]
    return (pixel_scores_from_logits(out["pixel_logits"]),
            link_scores_from_logits(out["link_logits"]))


def checkpoint_weights(checkpoint_path: str, use_ema: bool = True
                       ) -> dict:
    """The state_dict to serve from a port checkpoint root (its newest
    ``ckpt_*``) or one ``ckpt_<step>`` directory: the EMA parameters (or
    the raw ones) and the BN running statistics; raises when there is no
    checkpoint. The optimizer's state is never read."""
    ck = latest_checkpoint(checkpoint_path)
    if ck is None and os.path.exists(os.path.join(checkpoint_path,
                                                  CKPT_FILE)):
        ck = checkpoint_path
    if ck is None:
        raise FileNotFoundError(f"no port checkpoint under {checkpoint_path}")
    saved = load_inference_state(ck)
    weights = dict(saved["model"])
    if use_ema:
        weights.update(saved["ema"])
    return weights


class Predictor:
    """Detect on one device: batched forward + decode.

    ``model_name``: a name of the :func:`build_model` registry;
    ``geometry`` and ``text_scale`` shape an EAST head;
    ``bottleneck_impl`` picks the ResNet's units as
    ``ModelConfig.bottleneck_impl`` does ("fused": the stride-1 units on
    the fused kernels, in ``dtype``). PixelLink and
    link8 boxes come from the on-device decode; EAST boxes are the rows
    that locality-aware NMS keeps of the valid ``east_detect`` candidates,
    with a score above ``infer.box_thresh``.
    ``weights``: a state_dict, or the path of a flat ``.npz`` of Flax
    variables (then an ``operating_point.json`` beside it overrides the
    ``infer`` thresholds). ``checkpoint_path``: in place of ``weights``, a
    port checkpoint root (its newest ``ckpt_*``) or one ``ckpt_<step>``
    directory; the EMA parameters (the raw ones with ``use_ema=False``)
    and the BN running statistics are served, and an
    ``operating_point.json`` at that path overrides the thresholds.
    ``infer``: thresholds and decode bounds (defaults of
    :class:`InferConfig`). When the caller passes ``infer`` and neither
    ``weights`` nor ``checkpoint_path``, the newest ``ckpt_*`` under
    ``infer.checkpoint_path`` is served, as JAX's ``Predictor`` does
    (``infer.py:60-110``), or the init where it holds none. Otherwise,
    with no weights, the seed-0 init of :func:`build_model`.
    ``device="cuda"`` raises when no GPU is present: the predictor never
    carries on on the CPU unasked. An operating point overrides ``pixel``,
    ``link``, ``score`` and ``nms`` (infer.py:105-110). ``nms_ms`` is the
    host time of the last batch's NMS (EAST).
    """

    # extract_components clamps max_pixels to h*w: any value >= the label
    # map's area is the exact, full budget
    _FULL_BUDGET = 1 << 30

    def __init__(self, model_name: str = "pixellink_resnet50",
                 weights: Union[None, str, os.PathLike,
                                Mapping[str, torch.Tensor]] = None,
                 device: Union[str, torch.device] = "cuda",
                 dtype: torch.dtype = torch.bfloat16,
                 infer: Optional[InferConfig] = None,
                 checkpoint_path: Optional[str] = None,
                 use_ema: bool = True, geometry: str = "RBOX",
                 text_scale: int = 512, bottleneck_impl: str = "xla"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Predictor(device='cuda'): torch sees no "
                               "CUDA device")
        self.infer = icfg = infer if infer is not None else InferConfig()
        self.model_name = model_name
        self.model = build_model(model_name, dtype=dtype,
                                 text_scale=text_scale, geometry=geometry,
                                 bottleneck_impl=bottleneck_impl)
        self.is_east = model_head(model_name) == "east"
        weights_dir = None
        if (infer is not None and weights is None and checkpoint_path is None
                and latest_checkpoint(icfg.checkpoint_path) is not None):
            checkpoint_path = icfg.checkpoint_path
        if checkpoint_path is not None:
            if weights is not None:
                raise ValueError("pass weights or checkpoint_path, not both")
            weights_dir = checkpoint_path
            weights = checkpoint_weights(checkpoint_path, use_ema)
        elif isinstance(weights, (str, os.PathLike)):
            weights_dir = os.path.dirname(os.path.abspath(weights))
            weights = load_npz(weights)
        if weights is not None:
            self.model.load_state_dict(weights, strict=True)
        self.model.to(self.device)
        # what _run calls: the model, or an H-sharded forward of it
        # (parallel/spatial.py spatial_predictor)
        self.forward = self.model
        self.stride = float(self.model.output_stride)
        # min_component_size is given on the stride-4 grid; scale by area
        self.min_size = int(round(
            icfg.min_component_size * (4.0 / self.stride) ** 2))
        self.pixel_thresh = icfg.pixel_conf_threshold
        self.link_thresh = icfg.link_conf_threshold
        self.score_thresh = icfg.score_map_thresh
        self.nms_thresh = icfg.nms_thresh
        self.calibrated = False
        if icfg.use_calibrated_thresholds and weights_dir is not None:
            op = load_operating_point(weights_dir)
            if op:
                self.pixel_thresh = float(op.get("pixel", self.pixel_thresh))
                self.link_thresh = float(op.get("link", self.link_thresh))
                self.score_thresh = float(op.get("score", self.score_thresh))
                self.nms_thresh = float(op.get("nms", self.nms_thresh))
                self.calibrated = True
        self.nms_ms = 0.0
        # full-budget decode re-runs (overflow_retry_needed): counted,
        # never a silent zero-box result
        self.overflow_retries = 0

    @torch.inference_mode()
    def _run(self, x: torch.Tensor, full_budget: bool = False):
        out = self.forward(x)
        if self.is_east:
            return D.east_detect(out["score"][..., 0], out["geometry"],
                                 score_thresh=self.score_thresh)
        ps, ls = pixel_link_scores(out)
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
        if self.is_east:
            return self._east_boxes(*(t.cpu().numpy() for t in host))
        raw_boxes, sizes, valid = (t.cpu().numpy() for t in host)
        if D.overflow_retry_needed(sizes, valid, self.min_size):
            # a dense map blew the foreground budget: one exact re-run
            self.overflow_retries += 1
            raw_boxes, sizes, valid = (
                t.cpu().numpy() for t in self._run(x, full_budget=True))
        return [[b * self.stride for b in raw_boxes[i][valid[i]]]
                for i in range(n)]

    def _east_boxes(self, quads: np.ndarray, scores: np.ndarray,
                    valid: np.ndarray) -> List[List[np.ndarray]]:
        """Locality-aware NMS of each image's valid candidates on the host
        (infer.py:204-218): the kept quads scored above ``box_thresh``."""
        icfg = self.infer
        t0 = time.perf_counter()
        results = []
        for q, sc, v in zip(quads, scores, valid):
            polys = np.concatenate([q.reshape(-1, 8), sc[:, None]], 1)[v]
            kept = N.locality_aware_nms(polys, self.nms_thresh,
                                        icfg.nms_max_candidates)
            results.append([k[:8].reshape(4, 2) for k in kept
                            if k[8] > icfg.box_thresh])
        self.nms_ms = (time.perf_counter() - t0) * 1000
        return results

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
