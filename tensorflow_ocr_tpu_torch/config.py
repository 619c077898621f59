"""Inference settings of the port.

The fields of ``tensorflow_ocr_tpu/config.py`` ``InferConfig`` that the
PixelLink :class:`~tensorflow_ocr_tpu_torch.infer.Predictor` reads, with
the same defaults. The port keeps its own copy so that it imports nothing
of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class InferConfig:
    max_side_len: int = 3000  # longest side after resize_image
    pixel_conf_threshold: float = 0.8
    link_conf_threshold: float = 0.8
    # minimum component size in stride-4 pixels (components > this stay)
    min_component_size: int = 10
    # static bound on components per image for the batched decode
    max_components: int = 128
    # adopt operating_point.json beside the weights in place of the
    # static thresholds above
    use_calibrated_thresholds: bool = True
