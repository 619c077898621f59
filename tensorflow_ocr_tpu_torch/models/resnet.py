"""ResNet-v1 backbone exporting the pool2..pool5 pyramid.

Port of ``tensorflow_ocr_tpu/models/resnet.py:314-457`` in eval mode:
slim-v1 bottlenecks with the stride on the last unit of blocks 1-3, the
identity subsample ``x[..., ::s, ::s]``, the projection shortcut on a
depth change, and the stem that pools before the relu. Submodule names
follow the Flax tree (``conv1``, ``block1_unit1``, ...), so the weight
bridge (``models/convert.py``) is a rename.

Not ported: ``output_stride`` (atrous) and the fused and ghost
bottleneck variants (ROADMAP.md, Queue 2).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tensorflow_ocr_tpu_torch.models.layers import ConvBN, stem_max_pool

# (num_units,) per block for each variant (models/resnet.py:314-319).
RESNET_UNITS = {
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
    200: (3, 24, 36, 3),
}


class Bottleneck(nn.Module):
    """slim resnet_v1 bottleneck (models/resnet.py:322-354)."""

    def __init__(self, depth_in: int, depth: int, depth_bottleneck: int,
                 stride: int):
        super().__init__()
        self.stride = stride
        self.shortcut = (ConvBN(depth_in, depth, 1, stride, relu=False)
                         if depth_in != depth else None)
        self.conv1 = ConvBN(depth_in, depth_bottleneck, 1)
        self.conv2 = ConvBN(depth_bottleneck, depth_bottleneck, 3, stride,
                            explicit_pad=True)
        self.conv3 = ConvBN(depth_bottleneck, depth, 1, relu=False)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        s = self.stride
        if self.shortcut is None:
            shortcut = x[:, :, ::s, ::s] if s > 1 else x
        else:
            shortcut = self.shortcut(x, train)
        y = self.conv3(self.conv2(self.conv1(x, train), train), train)
        return F.relu(shortcut + y)


class ResNetV1(nn.Module):
    """Backbone returning ``{"pool2": ..., "pool5": ...}`` (NCHW)."""

    base_depths = (256, 512, 1024, 2048)
    bottlenecks = (64, 128, 256, 512)

    def __init__(self, units: Sequence[int] = RESNET_UNITS[50],
                 output_stride: int | None = None):
        super().__init__()
        if output_stride is not None:
            raise NotImplementedError(
                "ResNetV1 output_stride (atrous) is not ported yet "
                "(ROADMAP.md Queue 1: other families)")
        self.conv1 = ConvBN(3, 64, 7, 2, relu=False, explicit_pad=True)
        self.blocks = []  # unit names per block
        depth_in = 64
        for b, (n_units, depth, depth_b) in enumerate(
                zip(units, self.base_depths, self.bottlenecks)):
            names = []
            for u in range(n_units):
                # stride 2 on the last unit of blocks 1-3
                stride = 2 if (u == n_units - 1 and b < 3) else 1
                names.append(f"block{b + 1}_unit{u + 1}")
                self.add_module(names[-1], Bottleneck(depth_in, depth,
                                                      depth_b, stride))
                depth_in = depth
            self.blocks.append(names)
        self.channels = {"pool2": 64, "pool3": 256, "pool4": 512,
                         "pool5": 2048}

    def forward(self, x: torch.Tensor, train: bool = False
                ) -> Dict[str, torch.Tensor]:
        # eval order (models/resnet.py:398-408): conv, pool, then relu —
        # exact, since relu and max commute
        x = F.relu(stem_max_pool(self.conv1(x, train)))
        ep = {"pool2": x}
        for b, names in enumerate(self.blocks):
            for name in names:
                x = getattr(self, name)(x, train)
            if b < 2:
                ep[f"pool{b + 3}"] = x
        ep["pool5"] = x
        return ep
