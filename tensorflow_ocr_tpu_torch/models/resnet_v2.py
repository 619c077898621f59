"""ResNet-v2 (pre-activation) backbone exporting the pool2..pool5 pyramid.

Port of ``tensorflow_ocr_tpu/models/resnet_v2.py``: slim's resnet_v2
bottleneck (a BN+ReLU before the convs, the projection shortcut taken
from the PREACTIVATED input, an identity shortcut strided from ``x``), a
root conv with a bias and no BN, the stride on the last unit of blocks
1-3 as in v1, and a final BN+ReLU (``postnorm``). The preact and
postnorm BNs are plain BatchNorms (momentum 0.997, eps 1e-5) computed in
float32 and rounded to the activation dtype; the root, ``shortcut`` and
``conv3`` are biased convs on the library; only the two ``ConvBN``s of a
unit take the ``PALLAS_CONVS`` route, as in JAX. Submodule names follow
the Flax tree, so ``models/convert.py`` maps it by renaming.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tensorflow_ocr_tpu_torch.models.layers import (
    BatchNorm,
    ConvBN,
    batch_norm,
    conv2d_pads,
    stem_max_pool,
)
from tensorflow_ocr_tpu_torch.models.resnet import RESNET_UNITS


def _conv(conv: nn.Conv2d, x: torch.Tensor, stride: int = 1,
          padding: int = 0) -> torch.Tensor:
    """A biased Flax ``nn.Conv`` in the activation dtype."""
    dt = x.dtype
    return conv2d_pads(x, conv.weight.to(dt), conv.bias.to(dt), stride, 1,
                       (padding,) * 4)


class PreactBottleneck(nn.Module):
    """slim resnet_v2 bottleneck (resnet_v2.py:24-57)."""

    def __init__(self, depth_in: int, depth: int, depth_bottleneck: int,
                 stride: int):
        super().__init__()
        self.stride = stride
        self.preact = BatchNorm(depth_in)
        # a 1x1 with SAME padding reads x[::s, ::s]: no padding
        self.shortcut = (nn.Conv2d(depth_in, depth, 1, stride)
                         if depth_in != depth else None)
        self.conv1 = ConvBN(depth_in, depth_bottleneck, 1)
        self.conv2 = ConvBN(depth_bottleneck, depth_bottleneck, 3, stride,
                            explicit_pad=True)
        self.conv3 = nn.Conv2d(depth_bottleneck, depth, 1)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        s = self.stride
        preact = F.relu(batch_norm(self.preact, x, train))
        if self.shortcut is None:
            shortcut = x[:, :, ::s, ::s] if s > 1 else x
        else:
            shortcut = _conv(self.shortcut, preact, s)
        y = self.conv2(self.conv1(preact, train), train)
        return shortcut + _conv(self.conv3, y)


class ResNetV2(nn.Module):
    """Backbone returning ``{"pool2": ..., "pool5": ...}`` (NCHW)."""

    base_depths = (256, 512, 1024, 2048)
    bottlenecks = (64, 128, 256, 512)

    def __init__(self, units: Sequence[int] = RESNET_UNITS[50]):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2)
        self.blocks = []  # unit names per block
        depth_in = 64
        for b, (n_units, depth, depth_b) in enumerate(
                zip(units, self.base_depths, self.bottlenecks)):
            names = []
            for u in range(n_units):
                stride = 2 if (u == n_units - 1 and b < 3) else 1
                names.append(f"block{b + 1}_unit{u + 1}")
                self.add_module(names[-1], PreactBottleneck(
                    depth_in, depth, depth_b, stride))
                depth_in = depth
            self.blocks.append(names)
        self.postnorm = BatchNorm(depth_in)
        self.channels = {"pool2": 64, "pool3": 256, "pool4": 512,
                         "pool5": 2048}

    def forward(self, x: torch.Tensor, train: bool = False
                ) -> Dict[str, torch.Tensor]:
        # the root: conv (padding 3 each side), no BN or relu, then the pool
        x = stem_max_pool(_conv(self.conv1, x, 2, 3))
        ep = {"pool2": x}
        for b, names in enumerate(self.blocks):
            for name in names:
                x = getattr(self, name)(x, train)
            if b < 2:
                ep[f"pool{b + 3}"] = x
        ep["pool5"] = F.relu(batch_norm(self.postnorm, x, train))
        return ep
