"""PixelLink detection head (port of tensorflow_ocr_tpu/models/heads.py:34-67).

1x1 conv+BN+relu projections of pool5..pool2, fused coarsest first by
2x unpool and add, then a 1x1 ``*_logits`` conv with a bias and no BN.
The outputs leave in JAX's layout: float32 NHWC, link channels in
(direction, class) pairs.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from tensorflow_ocr_tpu_torch.models.layers import ConvBN, unpool

PIXEL_OUTPUT = 2
LINK_OUTPUT = 16
# backbone endpoints the head fuses, coarsest first
FEATURE_KEYS = ("pool5", "pool4", "pool3", "pool2")


class PixelLinkHead(nn.Module):
    """Upsample-and-add fusion head over :data:`FEATURE_KEYS`."""

    def __init__(self, in_channels: Mapping[str, int]):
        super().__init__()
        for tag, out_ch in (("pixel", PIXEL_OUTPUT), ("link", LINK_OUTPUT)):
            for i, k in enumerate(FEATURE_KEYS):
                self.add_module(f"{tag}_proj{i}",
                                ConvBN(in_channels[k], out_ch, 1))
            self.add_module(f"{tag}_logits", nn.Conv2d(out_ch, out_ch, 1))

    def _branch(self, tag: str, ep: Dict[str, torch.Tensor],
                train: bool) -> torch.Tensor:
        feats = [ep[k] for k in FEATURE_KEYS]
        x = getattr(self, f"{tag}_proj0")(feats[0], train)
        for i, f in enumerate(feats[1:], start=1):
            x = unpool(x) + getattr(self, f"{tag}_proj{i}")(f, train)
        logits = getattr(self, f"{tag}_logits")
        y = F.conv2d(x, logits.weight.to(x.dtype), logits.bias.to(x.dtype))
        return y.permute(0, 2, 3, 1).float()

    def forward(self, ep: Dict[str, torch.Tensor], train: bool = False
                ) -> Dict[str, torch.Tensor]:
        return {"pixel_logits": self._branch("pixel", ep, train),
                "link_logits": self._branch("link", ep, train)}
