"""Detection heads (port of tensorflow_ocr_tpu/models/heads.py).

- :class:`PixelLinkHead` (:34-67): 1x1 conv+BN+relu projections of the
  backbone's endpoints, fused coarsest first by 2x unpool and add, then a
  1x1 ``*_logits`` conv with a bias and no BN, for the pixel (2) and link
  (16) logits. ``upsample_first=False`` fuses the two coarsest endpoints
  at one stride (VGG's fc7 and conv5_3).
- :class:`EASTMerge` (:70-102): the EAST feature merge, concat then 1x1
  and 3x3 conv+BN+relu with [-, 128, 64, 32] channels and an unpool
  between stages, and a last 3x3 (``merge3_final``).
- :class:`EASTHead` (:105-133): sigmoid score, and RBOX geometry (4
  sigmoid distances times ``text_scale`` and the angle
  (sigmoid - 0.5) pi/2) or QUAD geometry (8 linear corner offsets).
- :class:`Link8Head` (:136-151): sigmoid score and 8 sigmoid link
  probabilities.

The final 1x1 convs are plain convs with a bias (``nn.Conv`` in JAX),
never on the ``PALLAS_CONVS`` route. The outputs leave in JAX's layout:
float32 NHWC, link logits in (direction, class) pairs.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tensorflow_ocr_tpu_torch.models.layers import ConvBN, unpool

PIXEL_OUTPUT = 2
LINK_OUTPUT = 16
# the ResNet endpoints the heads fuse, coarsest first
FEATURE_KEYS = ("pool5", "pool4", "pool3", "pool2")


def _project(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A final 1x1 conv with its bias, in x's dtype, as float32 NHWC."""
    y = F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype))
    return y.permute(0, 2, 3, 1).float()


class PixelLinkHead(nn.Module):
    """Upsample-and-add fusion head over ``feature_keys``."""

    def __init__(self, in_channels: Mapping[str, int],
                 feature_keys: Sequence[str] = FEATURE_KEYS,
                 upsample_first: bool = True):
        super().__init__()
        self.feature_keys = tuple(feature_keys)
        self.upsample_first = upsample_first
        for tag, out_ch in (("pixel", PIXEL_OUTPUT), ("link", LINK_OUTPUT)):
            for i, k in enumerate(self.feature_keys):
                self.add_module(f"{tag}_proj{i}",
                                ConvBN(in_channels[k], out_ch, 1))
            self.add_module(f"{tag}_logits", nn.Conv2d(out_ch, out_ch, 1))

    def _branch(self, tag: str, ep: Dict[str, torch.Tensor],
                train: bool) -> torch.Tensor:
        feats = [ep[k] for k in self.feature_keys]
        x = getattr(self, f"{tag}_proj0")(feats[0], train)
        for i, f in enumerate(feats[1:], start=1):
            if i > 1 or self.upsample_first:
                x = unpool(x)
            x = x + getattr(self, f"{tag}_proj{i}")(f, train)
        return _project(getattr(self, f"{tag}_logits"), x)

    def forward(self, ep: Dict[str, torch.Tensor], train: bool = False
                ) -> Dict[str, torch.Tensor]:
        return {"pixel_logits": self._branch("pixel", ep, train),
                "link_logits": self._branch("link", ep, train)}


class EASTMerge(nn.Module):
    """The EAST merge over ``feature_keys`` (coarsest first): returns the
    32-channel map at the finest endpoint's stride (NCHW)."""

    num_outputs = (0, 128, 64, 32)

    def __init__(self, in_channels: Mapping[str, int],
                 feature_keys: Sequence[str] = FEATURE_KEYS,
                 upsample_first: bool = True):
        super().__init__()
        self.feature_keys = tuple(feature_keys)
        self.upsample_first = upsample_first
        g_ch = in_channels[self.feature_keys[0]]
        for i in range(1, 4):
            out = self.num_outputs[i]
            self.add_module(f"merge{i}_1x1", ConvBN(
                g_ch + in_channels[self.feature_keys[i]], out, 1))
            self.add_module(f"merge{i}_3x3", ConvBN(out, out, 3))
            g_ch = out
        self.merge3_final = ConvBN(g_ch, g_ch, 3)

    def forward(self, ep: Dict[str, torch.Tensor], train: bool = False
                ) -> torch.Tensor:
        f = [ep[k] for k in self.feature_keys]
        g = None
        for i in range(4):
            if i == 0:
                h = f[0]
            else:
                c = getattr(self, f"merge{i}_1x1")(
                    torch.cat([g, f[i]], 1), train)
                h = getattr(self, f"merge{i}_3x3")(c, train)
            if i <= 2:
                g = unpool(h) if (i > 0 or self.upsample_first) else h
            else:
                g = self.merge3_final(h, train)
        return g


class EASTHead(nn.Module):
    """Score and geometry from the merged map (32 channels)."""

    def __init__(self, in_channels: int = 32, text_scale: int = 512,
                 geometry: str = "RBOX"):
        super().__init__()
        if geometry not in ("RBOX", "QUAD"):
            raise ValueError(f"geometry must be RBOX or QUAD, got "
                             f"{geometry!r}")
        self.text_scale, self.geometry = text_scale, geometry
        self.score = nn.Conv2d(in_channels, 1, 1)
        if geometry == "QUAD":
            self.geo = nn.Conv2d(in_channels, 8, 1)
        else:
            self.geo = nn.Conv2d(in_channels, 4, 1)
            self.angle = nn.Conv2d(in_channels, 1, 1)

    def forward(self, g: torch.Tensor, train: bool = False
                ) -> Dict[str, torch.Tensor]:
        score = torch.sigmoid(_project(self.score, g))
        if self.geometry == "QUAD":
            return {"score": score, "geometry": _project(self.geo, g)}
        geo = torch.sigmoid(_project(self.geo, g)) * float(self.text_scale)
        angle = (torch.sigmoid(_project(self.angle, g)) - 0.5) * (
            math.pi / 2)
        return {"score": score, "geometry": torch.cat([geo, angle], -1)}


class Link8Head(nn.Module):
    """Sigmoid score (1 channel) and link probabilities (8)."""

    def __init__(self, in_channels: int = 32):
        super().__init__()
        self.score = nn.Conv2d(in_channels, 1, 1)
        self.links = nn.Conv2d(in_channels, 8, 1)

    def forward(self, g: torch.Tensor, train: bool = False
                ) -> Dict[str, torch.Tensor]:
        return {"score": torch.sigmoid(_project(self.score, g)),
                "link_probs": torch.sigmoid(_project(self.links, g))}
