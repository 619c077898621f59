"""Eval during training: detection P/R/F of the current weights on a small
set of images with ground truth.

Port of ``tensorflow_ocr_tpu/train/eval_hook.py``. The images are read
once by ``data/codec.py`` (``imread``, then ``resize`` to the square
input size with cv2's fixed-point INTER_LINEAR, then BGR -> RGB), so they
are JAX's pixels; the ground truth is scaled by ``(size/w, size/h)`` in
float32. A call scores the EMA parameters (or the raw ones) with the BN
running statistics, in eval mode, through the decode that serving uses:
``pixel_link_scores`` and ``pixellink_decode`` (the CC kernel on the
card) for the PixelLink and link8 heads, with one full-budget re-decode
where ``overflow_retry_needed`` says so; ``east_detect`` on the device
and ``locality_aware_nms`` on the host for EAST.

The forward runs on a module of the hook's own, built from ``cfg`` (the
"xla" bottleneck, as the Predictor serves) and loaded with copies of the
state's tensors: the live model is only read, never switched to eval
mode or written, so a captured train step and its static tensors are
left as they were. Inside :meth:`cached_forward` the forward runs once
and each call only decodes and matches at its thresholds (the
calibration sweep).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np
import torch

from tensorflow_ocr_tpu_torch.config import Config
from tensorflow_ocr_tpu_torch.data import codec, icdar
from tensorflow_ocr_tpu_torch.eval.metrics import StreamingPRF
from tensorflow_ocr_tpu_torch.models.detector import (
    build_model,
    model_head,
    model_output_stride,
)
from tensorflow_ocr_tpu_torch.ops import decode as D
from tensorflow_ocr_tpu_torch.utils import nms as N

# extract_components clamps max_pixels to h*w: the exact, full budget
FULL_BUDGET = 1 << 30


class EvalDuringTraining:
    """P/R/F of a train state on up to ``max_images`` images of
    ``val_dir`` (each with a gt_*.txt that holds a polygon); ``images``
    is None where there are none."""

    def __init__(self, cfg: Config, val_dir: str, max_images: int = 16):
        self.cfg = cfg
        self.is_east = model_head(cfg.model.name) == "east"
        self.stride = model_output_stride(cfg.model.name)
        # size thresholds are given on the stride-4 grid; scale by area
        self.min_size = int(round(
            cfg.infer.min_component_size * (4.0 / self.stride) ** 2))
        size = cfg.data.input_size
        images, self.gts = [], []
        for fn in icdar.get_images(val_dir)[:max_images]:
            im = codec.imread(fn)
            if im is None:
                continue
            h, w = im.shape[:2]
            gt, ignored = icdar.load_annotation(icdar.gt_path_for_image(fn))
            if gt.shape[0] == 0:
                continue
            scale = np.array([size / w, size / h], np.float32)
            images.append(codec.resize(im, (size, size))[:, :, ::-1].copy())
            self.gts.append((gt * scale, ignored))
        self.images = np.stack(images) if images else None
        # full-budget re-decodes (decode.overflow_retry_needed)
        self.overflow_retries = 0
        self._net = None   # the eval module, built at the first call
        self._x = None     # the images on the eval module's device
        self._caching = False
        self._cache = None  # (use_ema, forward outputs) in cached_forward

    @contextlib.contextmanager
    def cached_forward(self):
        """Within this context the forward runs at the first call and its
        outputs serve every later call with the same ``use_ema``; the
        caller must not change the state meanwhile."""
        self._caching, self._cache = True, None
        try:
            yield self
        finally:
            self._caching, self._cache = False, None

    def _load(self, state, use_ema: bool) -> torch.nn.Module:
        """The eval module on the state's device, holding copies of the
        state's parameters (EMA or raw) and BN running statistics."""
        from tensorflow_ocr_tpu_torch.train.trainer import DTYPES

        dev = state.step.device
        if self._net is None:
            c = self.cfg
            self._net = build_model(
                c.model.name, dtype=DTYPES[c.model.compute_dtype],
                text_scale=c.model.text_scale,
                geometry=c.data.geometry).to(dev)
            self._x = torch.from_numpy(self.images).to(dev)
        src = dict(state.model.state_dict())
        if use_ema:
            src.update(state.ema)
        with torch.no_grad():
            for k, t in self._net.state_dict().items():
                t.copy_(src[k])
        return self._net

    @torch.no_grad()
    def _forward(self, state, use_ema: bool):
        if self._caching and self._cache and self._cache[0] == use_ema:
            return self._cache[1]
        from tensorflow_ocr_tpu_torch.infer import pixel_link_scores

        out = self._load(state, use_ema)(self._x)
        out = ((out["score"][..., 0], out["geometry"]) if self.is_east
               else pixel_link_scores(out))
        if self._caching:
            self._cache = (use_ema, out)
        return out

    def __call__(self, model, state, use_ema: bool = True,
                 pixel_thresh: Optional[float] = None,
                 link_thresh: Optional[float] = None,
                 score_thresh: Optional[float] = None,
                 nms_thresh: Optional[float] = None) -> Dict[str, float]:
        """P/R/F of ``state`` at the given thresholds (the ``infer``
        config's where None); {} without images. ``model`` is accepted
        for JAX's signature: the forward runs on the hook's own module."""
        if self.images is None:
            return {}
        icfg = self.cfg.infer
        prf = StreamingPRF(self.cfg.eval.matching_iou_threshold)
        maps = self._forward(state, use_ema)
        if self.is_east:
            st = (icfg.score_map_thresh if score_thresh is None
                  else score_thresh)
            nt = icfg.nms_thresh if nms_thresh is None else nms_thresh
            quads, scores, valid = (t.cpu().numpy() for t in D.east_detect(
                *maps, score_thresh=st))
            for b, (gt, ignored) in enumerate(self.gts):
                polys = np.concatenate(
                    [quads[b].reshape(-1, 8), scores[b][:, None]], 1
                )[valid[b]]
                kept = N.locality_aware_nms(polys, nt,
                                            icfg.nms_max_candidates)
                boxes = np.array(
                    [k[:8].reshape(4, 2) for k in kept]).reshape(-1, 4, 2)
                prf.update(boxes, np.ones(len(boxes)), gt, ignored)
            return prf.result()
        pt = (icfg.pixel_conf_threshold if pixel_thresh is None
              else pixel_thresh)
        lt = icfg.link_conf_threshold if link_thresh is None else link_thresh

        def decode(max_pixels=None):
            return (t.cpu().numpy() for t in D.pixellink_decode(
                *maps, pixel_thresh=pt, link_thresh=lt,
                min_size=self.min_size, max_components=icfg.max_components,
                max_pixels=max_pixels))

        raw, sizes, valid = decode()
        if D.overflow_retry_needed(sizes, valid, self.min_size):
            # a dense map blew the decode's foreground budget: one exact
            # full-budget re-decode, never a silent F=0
            self.overflow_retries += 1
            raw, sizes, valid = decode(FULL_BUDGET)
        stride = float(self.stride)
        for b, (gt, ignored) in enumerate(self.gts):
            boxes = raw[b][valid[b]] * stride
            prf.update(boxes, np.ones(len(boxes)), gt, ignored)
        return prf.result()
