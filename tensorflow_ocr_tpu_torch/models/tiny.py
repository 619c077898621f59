"""Tiny convolutional backbone for cheap whole-slice tests.

Port of ``tensorflow_ocr_tpu/models/tiny.py:22-47``: a stride-4 stem,
then x2 per stage, with the same pool2..pool5 endpoints as ResNetV1.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from tensorflow_ocr_tpu_torch.models.layers import ConvBN


class TinyConvNet(nn.Module):
    """4-stage strided convnet; endpoint strides match ResNetV1."""

    def __init__(self, widths: Sequence[int] = (16, 24, 32, 48)):
        super().__init__()
        w2, w3, w4, w5 = widths
        self.stem1 = ConvBN(3, w2, 3, 2)
        self.stem2 = ConvBN(w2, w2, 3, 2)
        cin = w2
        for i, w in enumerate((w3, w4, w5)):
            self.add_module(f"down{i + 3}", ConvBN(cin, w, 3, 2))
            self.add_module(f"conv{i + 3}", ConvBN(w, w, 3))
            cin = w
        self.channels = {"pool2": w2, "pool3": w3, "pool4": w4, "pool5": w5}

    def forward(self, x: torch.Tensor, train: bool = False
                ) -> Dict[str, torch.Tensor]:
        x = self.stem2(self.stem1(x, train), train)
        ep = {"pool2": x}
        for i in (3, 4, 5):
            x = getattr(self, f"down{i}")(x, train)
            x = getattr(self, f"conv{i}")(x, train)
            ep[f"pool{i}"] = x
        return ep
