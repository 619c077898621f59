"""VGG-16 backbone with the dilated fc6/fc7 of the FCN variant.

Port of ``tensorflow_ocr_tpu/models/vgg.py``: conv1_1..conv5_3 as plain
3x3 conv + bias + relu (no BN), 2x2 stride-2 SAME max-pools, a 3x3
stride-1 SAME ``pool5``, ``fc6`` a 3x3 conv at rate 6 (1024 channels) and
``fc7`` a 1x1 (1024). The end points are conv1_2 .. conv5_3, fc6 and
fc7. Module names follow the Flax tree (``conv1_1``, ...,  ``fc7``), so
``models/convert.py`` maps its ``kernel``/``bias`` leaves by renaming.
Parameters stay float32 and are cast to the activation dtype per call;
the convs are ``nn.Conv`` in JAX, never on the ``PALLAS_CONVS`` route.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from tensorflow_ocr_tpu_torch.models.layers import (
    conv2d_pads,
    full_height,
    max_pool_pads,
    same_pads,
)

# (name, channels) of each stage's convs
STAGES = (
    (("conv1_1", 64), ("conv1_2", 64)),
    (("conv2_1", 128), ("conv2_2", 128)),
    (("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256)),
    (("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512)),
    (("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512)),
)


def max_pool_same(x: torch.Tensor, window: int, stride: int
                  ) -> torch.Tensor:
    """Flax ``max_pool(padding="SAME")``: TF-SAME pads of -inf, then the
    pool. NCHW."""
    top, bottom = same_pads(full_height(x), window, stride)
    left, right = same_pads(x.shape[-1], window, stride)
    return max_pool_pads(x, window, stride, (left, right, top, bottom))


class VGG16(nn.Module):
    """Backbone returning the VGG end points (NCHW)."""

    def __init__(self):
        super().__init__()
        cin = 3
        for stage in STAGES:
            for name, cout in stage:
                self.add_module(name, nn.Conv2d(cin, cout, 3, padding=1))
                cin = cout
        self.fc6 = nn.Conv2d(cin, 1024, 3, padding=6, dilation=6)
        self.fc7 = nn.Conv2d(1024, 1024, 1)
        self.channels = {"conv1_2": 64, "conv2_2": 128, "conv3_3": 256,
                         "conv4_3": 512, "conv5_3": 512, "fc6": 1024,
                         "fc7": 1024}

    @staticmethod
    def _conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        p, d = conv.padding[0], conv.dilation[0]
        return F.relu(conv2d_pads(x, conv.weight.to(x.dtype),
                                  conv.bias.to(x.dtype), 1, d, (p,) * 4))

    def forward(self, x: torch.Tensor, train: bool = False
                ) -> Dict[str, torch.Tensor]:
        ep: Dict[str, torch.Tensor] = {}
        for s, stage in enumerate(STAGES):
            if s:
                x = max_pool_same(x, 2, 2)
            for name, _ in stage:
                x = self._conv(getattr(self, name), x)
            ep[stage[-1][0]] = x
        x = self._conv(self.fc6, max_pool_same(x, 3, 1))
        ep["fc6"] = x
        ep["fc7"] = x = self._conv(self.fc7, x)
        return ep
