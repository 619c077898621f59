"""The dataset staged on the device for the in-device training loop.

Port of ``tensorflow_ocr_tpu/data/device_cache.py`` ``DeviceDataset``
(:28): every image of ``cfg.training_data_path`` decoded, resized to
``cfg.input_size`` and held on the device with its padded polygons, so
that a train step gathers its batch by index there
(``train/trainer.py`` ``make_multi_train_step``); with
``precompute_labels`` the label maps are made once at staging by the
same device functions the step would use (``_precompute`` :129: PixelLink
and link8 by ``pixellink_labels_stride``, EAST by
``east_labels_batch``).

Staging, as JAX's (:42-56, ``_stage_native`` :72-127): with the
augmentation flags off and the dataset bound for the card, the frames are
decoded and resized by ``data/nvjpeg_loader.py``: the JPEGs on the card
by nvJPEG, the other images (PNG and the rest that JAX's OpenCV loader
reads) on the host by the codec, equal to cv2, all resized on the card
in cv2's fixed point; a file it does not decode
is left out, as JAX's native stage leaves out what its loader flags, with
a printed count; otherwise every file goes through ``data/icdar.py``
``prepare_sample`` (the Python path) with one ``RandomState(0)``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from tensorflow_ocr_tpu_torch.config import DataConfig
from tensorflow_ocr_tpu_torch.data import icdar
from tensorflow_ocr_tpu_torch.ops import geometry as G


def _sample_from_polys(cfg: DataConfig, want_east: bool, fn: str, image,
                       src_hw) -> Optional[icdar.Sample]:
    """The Sample of a frame already resized to ``input_size``: its gt
    polygons validated at the source size and scaled (device_cache.py
    :98-126); None without a gt file or a polygon."""
    txt = icdar.gt_path_for_image(fn)
    if not os.path.exists(txt):
        return None
    polys, tags = icdar.load_annotation(txt)
    h, w = int(src_hw[0]), int(src_hw[1])
    polys, tags = G.check_and_validate_polys(polys, tags, (h, w))
    if polys.shape[0] == 0:
        return None
    size = cfg.input_size
    polys = polys.copy()
    polys[:, :, 0] *= size / float(w)
    polys[:, :, 1] *= size / float(h)
    padded, ptags, pvalid = icdar._pad_polys(polys, tags, cfg.max_polys)
    if want_east:
        shrunk, rects, angles = icdar.east_poly_geometry(padded)
    else:
        shrunk = np.zeros_like(padded)
        rects = np.zeros_like(padded)
        angles = np.zeros((cfg.max_polys,), np.float32)
    return icdar.Sample(image=image, polys=padded, tags=ptags, valid=pvalid,
                        shrunk=shrunk, rects=rects, angles=angles, fn=fn)


def label_maps(arrays, cfg: DataConfig, stride: int, want_east: bool
               ) -> Dict[str, torch.Tensor]:
    """The label maps of a dataset's ``polys``/``tags``/``valid`` (and,
    for EAST, ``shrunk``/``rects``/``angles``) at ``stride``, made on
    their device (device_cache.py ``_precompute`` :129-162): ``score``,
    ``link``, ``mask`` for PixelLink and link8, ``score``, ``geo``,
    ``mask`` for EAST."""
    from tensorflow_ocr_tpu_torch.ops import labels as label_ops

    hw = cfg.input_size // stride
    if want_east:
        score, geo, mask = label_ops.east_labels_batch(
            arrays["polys"], arrays["shrunk"], arrays["rects"],
            arrays["angles"], arrays["tags"], arrays["valid"], hw, hw,
            stride, cfg.min_text_size, geometry=cfg.geometry)
        return {"score": score, "geo": geo, "mask": mask}
    s, l, m = label_ops.pixellink_labels_stride(
        arrays["polys"], arrays["tags"], arrays["valid"], hw, hw, stride,
        cfg.min_text_size)
    return {"score": s[..., None], "link": l, "mask": m[..., None]}


def stage_loaded(files: List[str], imgs, ok, src_hw, cfg: DataConfig,
                 want_east: bool) -> List[icdar.Sample]:
    """The Samples of a batch loader's ``(imgs, ok, src_hw)`` over
    ``files`` (device_cache.py :93-126): a file the loader did not decode
    is left out, and their count printed."""
    samples, refused = [], []
    for i, fn in enumerate(files):
        if not ok[i]:
            refused.append(os.path.basename(fn))
            continue
        s = _sample_from_polys(cfg, want_east, fn, imgs[i], src_hw[i])
        if s is not None:
            samples.append(s)
    if refused:
        print(f"DeviceDataset: the batch loader did not decode "
              f"{len(refused)} of {len(files)} files, left out: "
              f"{refused[:4]}")
    return samples


class DeviceDataset:
    """The dataset as tensors on ``device`` (the card unless the caller
    asks for the CPU): ``images`` (N, H, W, 3) uint8 RGB, ``polys``,
    ``tags``, ``valid``, the EAST keys with ``want_east``, and the label
    maps in ``labels`` with ``precompute_labels``."""

    def __init__(self, cfg: DataConfig, want_east: bool = False,
                 max_images: Optional[int] = None,
                 precompute_labels: bool = False, label_stride: int = 4,
                 device="cuda"):
        self.device = torch.device(device)
        files = icdar.get_images(cfg.training_data_path)
        if max_images:
            files = files[:max_images]
        augment = cfg.use_crop or cfg.use_rotate or cfg.use_random_scale
        if self.device.type == "cuda" and not augment:
            samples = self._stage_nvjpeg(files, cfg, want_east)
        else:
            rng = np.random.RandomState(0)
            samples = [icdar.prepare_sample(fn, cfg, rng, want_east=want_east)
                       for fn in files]
            samples = [s for s in samples if s is not None]
        if not samples:
            raise FileNotFoundError(
                f"no usable training images in {cfg.training_data_path}")
        dev = self.device

        def stack(key):
            vals = [getattr(s, key) for s in samples]
            if torch.is_tensor(vals[0]):
                return torch.stack(vals).to(dev)
            return torch.from_numpy(np.stack(vals)).to(dev)

        self.images = stack("image")
        self.polys = stack("polys")
        self.tags = stack("tags")
        self.valid = stack("valid")
        self.want_east = want_east
        if want_east:
            self.shrunk = stack("shrunk")
            self.rects = stack("rects")
            self.angles = stack("angles")
        self.n = len(samples)
        self.fns = [s.fn for s in samples]
        self.labels: Dict[str, torch.Tensor] = {}
        if precompute_labels:
            self._precompute(cfg, label_stride)

    def _stage_nvjpeg(self, files: List[str], cfg: DataConfig,
                      want_east: bool) -> List[icdar.Sample]:
        """Decode and resize the whole dataset in one batch call, the JPEGs
        on the card (stage_loaded)."""
        from tensorflow_ocr_tpu_torch.data.nvjpeg_loader import load_batch

        size = cfg.input_size
        return stage_loaded(files, *load_batch(files, size, size,
                                               self.device), cfg, want_east)

    def _precompute(self, cfg: DataConfig, stride: int):
        self.labels = label_maps(self.arrays(), cfg, stride, self.want_east)

    def arrays(self) -> Dict[str, torch.Tensor]:
        """The dataset of make_multi_train_step: the batch keys (zero EAST
        keys when not ``want_east``) and the label maps."""
        out = {"images": self.images, "polys": self.polys,
               "tags": self.tags, "valid": self.valid}
        if self.want_east:
            out.update(shrunk=self.shrunk, rects=self.rects,
                       angles=self.angles)
        else:
            n, k = self.polys.shape[:2]
            z = dict(dtype=torch.float32, device=self.device)
            out.update(shrunk=torch.zeros((n, k, 4, 2), **z),
                       rects=torch.zeros((n, k, 4, 2), **z),
                       angles=torch.zeros((n, k), **z))
        out.update(self.labels)
        return out

    def index_batches(self, batch_size: int, steps: int,
                      rng: np.random.RandomState) -> np.ndarray:
        """(steps, batch_size) int32 shuffled sample indices."""
        need = steps * batch_size
        reps = -(-need // self.n)
        idx = np.concatenate([rng.permutation(self.n) for _ in range(reps)])
        return idx[:need].reshape(steps, batch_size).astype(np.int32)
