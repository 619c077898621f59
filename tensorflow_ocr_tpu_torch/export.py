"""Serving export: the detector as a ``torch.export`` program.

The counterpart of ``tensorflow_ocr_tpu/export.py:40-159``. JAX
serializes its jitted forward (and decode) to StableHLO; the port
serializes the same function with ``torch.export.export`` and
``torch.export.save``. A bundle::

    <dir>/program.pt2   the ExportedProgram (torch.export.save)
    <dir>/meta.json     model name, input shape, stride, the decode's
                        operating point (the calibrated one where the
                        checkpoint carries it), the weights contract

The program takes ``images``, (B, H, W, 3) float32 RGB in 0..255 (JAX's
layout), and returns with ``with_decode`` the boxes of the fixed-budget
decode (PixelLink and link8: ``boxes``, ``sizes``, ``valid`` at map
resolution; EAST: the ``quads``, ``scores`` and ``valid`` candidates of
``east_detect``, whose locality-aware NMS stays on the host as in JAX),
without it the probability maps. Like JAX's ``_serving_fn`` it makes no
overflow retry.

Two weight contracts, as in JAX:

- ``bake_weights=True``: the weights are the ExportedProgram's own state;
  the program is ``(images,) -> outputs``;
- ``bake_weights=False``: the program is ``(weights, images) -> outputs``
  through ``torch.func.functional_call``, ``weights`` a state_dict of the
  model (a port checkpoint's, :func:`~tensorflow_ocr_tpu_torch.infer.
  checkpoint_weights`).

Unlike a StableHLO bundle, which a runtime loads without JAX, a torch
bundle needs torch and this package's ops at load time: the decode calls
``tensorflow_ocr_tpu_torch::connected_components``, which
:func:`load_serving_bundle` registers by importing ``ops/kernels.py``.
The program runs on the device it was exported on (``platforms``).
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from tensorflow_ocr_tpu_torch.infer import pixel_link_scores
from tensorflow_ocr_tpu_torch.ops import decode as D

PROGRAM_FILE = "program.pt2"
META_FILE = "meta.json"


class _Serving(nn.Module):
    """The predictor's forward and, with ``with_decode``, its decode at
    the predictor's operating point, as one module."""

    def __init__(self, predictor, with_decode: bool):
        super().__init__()
        self.model = predictor.model
        self.with_decode = with_decode
        self.is_east = predictor.is_east
        self.pixel_thresh = predictor.pixel_thresh
        self.link_thresh = predictor.link_thresh
        self.min_size = predictor.min_size
        self.max_components = predictor.infer.max_components
        self.score_thresh = predictor.score_thresh

    def outputs(self, out: Mapping[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        if self.is_east:
            if not self.with_decode:
                return {"score": out["score"], "geometry": out["geometry"]}
            q, s, v = D.east_detect(out["score"][..., 0], out["geometry"],
                                    score_thresh=self.score_thresh)
            return {"quads": q, "scores": s, "valid": v}
        ps, ls = pixel_link_scores(out)
        if not self.with_decode:
            return {"pixel_scores": ps.float(), "link_scores": ls.float()}
        boxes, sizes, valid = D.pixellink_decode(
            ps, ls, pixel_thresh=self.pixel_thresh,
            link_thresh=self.link_thresh, min_size=self.min_size,
            max_components=self.max_components)
        return {"boxes": boxes, "sizes": sizes, "valid": valid}

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.outputs(self.model(images))


class _ExternalServing(nn.Module):
    """``(weights, images)``: the same function with the weights an
    input. The model is held outside the module tree, so its own tensors
    are not the program's state."""

    def __init__(self, predictor, with_decode: bool):
        super().__init__()
        self.__dict__["serving"] = _Serving(predictor, with_decode)

    def forward(self, weights: Dict[str, torch.Tensor], images: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        s = self.__dict__["serving"]
        out = torch.func.functional_call(s.model, weights, (images,))
        return s.outputs(out)


def serving_weights(predictor) -> Dict[str, torch.Tensor]:
    """The external contract's ``weights``: the predictor's state_dict,
    keys sorted (the order the program was traced with)."""
    return _sorted(predictor.model.state_dict())


def _sorted(weights: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: weights[k] for k in sorted(weights)}


def export_predictor(predictor, batch: int, height: int, width: int,
                     with_decode: bool = True, bake_weights: bool = False
                     ) -> torch.export.ExportedProgram:
    """The predictor's serving function as an ExportedProgram on the
    predictor's device, for (batch, height, width, 3) float32 images."""
    images = torch.zeros((batch, height, width, 3), dtype=torch.float32,
                         device=predictor.device)
    predictor.model.eval()
    if bake_weights:
        return torch.export.export(_Serving(predictor, with_decode),
                                   (images,), strict=False)
    return torch.export.export(_ExternalServing(predictor, with_decode),
                               (serving_weights(predictor), images),
                               strict=False)


def save_serving_bundle(path: str, predictor, batch: int, height: int,
                        width: int, with_decode: bool = True,
                        bake_weights: bool = False,
                        weights_source: Optional[str] = None) -> str:
    """Write ``program.pt2`` and ``meta.json`` under ``path``; returns
    ``path``. ``weights_source`` names where the external contract's
    weights come from (default ``predictor.infer.checkpoint_path``)."""
    os.makedirs(path, exist_ok=True)
    program = export_predictor(predictor, batch, height, width,
                               with_decode=with_decode,
                               bake_weights=bake_weights)
    # the example inputs would be saved with the program: for the
    # external contract, a copy of the weights
    program.example_inputs = None
    torch.export.save(program, os.path.join(path, PROGRAM_FILE))
    source = weights_source or predictor.infer.checkpoint_path
    meta: Dict[str, Any] = {
        "model": predictor.model_name,
        "input": {"batch": batch, "height": height, "width": width,
                  "layout": "NHWC float32 RGB, 0..255"},
        "with_decode": with_decode,
        "weights": "baked" if bake_weights else
                   f"external (port checkpoint: {source})",
        "platforms": [predictor.device.type],
        "output_stride": predictor.stride,
        "operating_point": (
            {"score": predictor.score_thresh, "nms": predictor.nms_thresh}
            if predictor.is_east else
            {"pixel": predictor.pixel_thresh,
             "link": predictor.link_thresh,
             "min_component_size": predictor.min_size}),
        "calibrated": predictor.calibrated,
        "torch_version": torch.__version__,
        "note": ("EAST bundles return per-pixel RBOX candidates; run "
                 "utils/nms.locality_aware_nms host-side with the "
                 "operating_point nms threshold" if predictor.is_east
                 else "boxes are min-area rects at map resolution x "
                      "output_stride"),
    }
    with open(os.path.join(path, META_FILE), "w") as f:
        json.dump(meta, f, indent=1)
        f.write("\n")
    return path


def load_serving_bundle(path: str) -> Tuple[Callable, Dict[str, Any]]:
    """(callable, meta) of a bundle: the callable takes ``(images,)`` for
    a baked bundle, ``(weights, images)`` for the external contract
    (``weights`` any mapping of the model's state_dict keys, e.g. a port
    checkpoint's), and runs without autograd."""
    import tensorflow_ocr_tpu_torch.ops.kernels  # noqa: F401  (the CC op)

    module = torch.export.load(os.path.join(path, PROGRAM_FILE)).module()
    with open(os.path.join(path, META_FILE)) as f:
        meta = json.load(f)

    def call(*args):
        if len(args) == 2:  # (weights, images): any mapping, any key order
            args = (_sorted(args[0]), args[1])
        with torch.no_grad():
            return module(*args)

    return call, meta
