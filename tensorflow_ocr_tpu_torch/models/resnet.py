"""ResNet-v1 backbone exporting the pool2..pool5 pyramid.

Port of ``tensorflow_ocr_tpu/models/resnet.py:98-181, 314-457``:
slim-v1 bottlenecks with the stride on the last unit of blocks 1-3, the
identity subsample ``x[..., ::s, ::s]``, the projection shortcut on a
depth change, and a stem that pools before the relu in eval mode and
after it in train mode. ``bottleneck_impl="fused"`` runs every stride-1
unit that the fused kernels take as a :class:`FusedBottleneck`
(``ops/fused.py``); ``bottleneck_impl="ghost"`` runs every stride-1 unit
as a :class:`GhostBottleneck` (``ops/ghost.py``), which takes the ghost
path where ``pick_gh`` admits the shape it is called with.
Submodule names follow the Flax tree (``conv1``, ``block1_unit1``, ...),
so the weight bridge (``models/convert.py``) is a rename, for every
bottleneck.

Not ported: ``output_stride`` (atrous; ROADMAP.md, Queue 1).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tensorflow_ocr_tpu_torch.models.layers import (
    ConvBN,
    stem_max_pool,
    update_running_stats,
)
from tensorflow_ocr_tpu_torch.ops import fused as FU
from tensorflow_ocr_tpu_torch.ops import ghost as GH

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


class FusedBottleneck(Bottleneck):
    """Stride-1 bottleneck on the fused kernels (models/resnet.py:98-181).

    The unit keeps RAW conv outputs; each conv applies the previous BN and
    relu as a prologue and returns its own output's statistics, which
    :meth:`_affine` turns into the next prologue's (a, b); the boundary
    kernel applies BN3, the shortcut's affine, the residual add and the
    relu. Children and state_dict keys are :class:`Bottleneck`'s.
    """

    def __init__(self, depth_in: int, depth: int, depth_bottleneck: int):
        super().__init__(depth_in, depth, depth_bottleneck, 1)

    @staticmethod
    def supported(depth_in: int, depth: int, depth_bottleneck: int) -> bool:
        """Whether the fused kernels take every conv of the unit."""
        db = depth_bottleneck
        return (FU.kernel_takes(depth_in, db, 1) and FU.kernel_takes(db, db, 3)
                and FU.kernel_takes(db, depth, 1)
                and FU.kernel_takes(depth_in, depth, 1))

    @staticmethod
    def _affine(cbn: ConvBN, stats: torch.Tensor, count: float,
                train: bool) -> torch.Tensor:
        """(2, C) table [a, b] from the batch statistics (train, updating
        the running ones) or the running statistics (eval)."""
        bn = cbn.bn
        if train:
            mu = stats[0] / count
            var = torch.clamp(stats[1] / count - mu * mu, min=0.0)
            update_running_stats(bn, mu, var)
        else:
            mu, var = bn.running_mean, bn.running_var
        a = bn.weight * torch.rsqrt(var + cbn.eps)
        return torch.stack([a, bn.bias - mu * a])

    def forward(self, o: torch.Tensor, train: bool = False) -> torch.Tensor:
        o = o.contiguous(memory_format=torch.channels_last)
        n, cin, h, w = o.shape
        count = float(n * h * w)
        dt = o.dtype

        def ident(c):
            return torch.stack([torch.ones(c, device=o.device),
                                torch.zeros(c, device=o.device)])

        z1, s1 = FU.fused_conv1x1(o, ident(cin), self.conv1.conv.weight.to(dt))
        ab1 = self._affine(self.conv1, s1, count, train)
        z2, s2 = FU.fused_conv3x3(z1, ab1, self.conv2.conv.weight.to(dt))
        ab2 = self._affine(self.conv2, s2, count, train)
        z3, s3 = FU.fused_conv1x1(z2, ab2, self.conv3.conv.weight.to(dt))
        ab3 = self._affine(self.conv3, s3, count, train)
        if self.shortcut is not None:
            zs, ss = FU.fused_conv1x1(o, ident(cin),
                                      self.shortcut.conv.weight.to(dt))
            abs_ = self._affine(self.shortcut, ss, count, train)
        else:
            zs, abs_ = o, ident(cin)
        return FU.fused_boundary(z3, ab3, zs, abs_)


class GhostBottleneck(Bottleneck):
    """Stride-1 bottleneck on the ghost-BN unit (models/resnet.py:206-310).

    JAX picks the unit's class when it is called, from the input's shape:
    a ghost unit where ``pick_gh`` gives a band height, a plain
    Bottleneck elsewhere (resnet.py:436-451). This module is built before
    any shape is seen, so it makes the same choice in :meth:`forward`:
    :meth:`Bottleneck.forward` where ``pick_gh`` returns None. Otherwise
    training runs ``ops.ghost``'s unit (statistics per (image, band of gh
    rows); the running statistics take the global sums) and eval applies
    the running-statistics affine after bf16 products, in float32
    (resnet.py:275-302), with plain torch ops. Children and state_dict
    keys are :class:`Bottleneck`'s.
    """

    def __init__(self, depth_in: int, depth: int, depth_bottleneck: int):
        super().__init__(depth_in, depth, depth_bottleneck, 1)

    def band_height(self, shape: Tuple[int, ...]) -> Optional[int]:
        """``pick_gh`` for an (N, C, H, W) input: the band height, or None
        where the unit runs as a plain Bottleneck."""
        _, cin, h, w = shape
        return GH.pick_gh(h, w, cin, self.conv1.conv.out_channels,
                          self.conv3.conv.out_channels,
                          proj=self.shortcut is not None)

    def forward(self, o: torch.Tensor, train: bool = False) -> torch.Tensor:
        gh = self.band_height(o.shape)
        if gh is None:
            return super().forward(o, train)
        dt = o.dtype
        convs = [self.conv1, self.conv2, self.conv3]
        if self.shortcut is not None:
            convs.append(self.shortcut)
        if not train:
            return self._eval(o)
        args = []
        for cbn in convs:
            args += [cbn.conv.weight.to(dt),
                     torch.stack([cbn.bn.weight, cbn.bn.bias])]
        eps = self.conv1.eps
        if self.shortcut is not None:
            out, *stats = GH.ghost_unit_proj(o, *args, gh, eps)
        else:
            out, *stats = GH.ghost_unit_id(o, *args, gh, eps)
        n, _, h, w = o.shape
        cnt = float(n * h * w)
        for cbn, s in zip(convs, stats):
            mu = s[0] / cnt
            update_running_stats(cbn.bn, mu,
                                 torch.clamp(s[1] / cnt - mu * mu, min=0.0))
        return out

    def _eval(self, o: torch.Tensor) -> torch.Tensor:
        dt = o.dtype

        def aff(cbn):
            a = cbn.bn.weight * torch.rsqrt(cbn.bn.running_var + cbn.eps)
            return (a[:, None, None],
                    (cbn.bn.bias - cbn.bn.running_mean * a)[:, None, None])

        def bn_relu(z, cbn):
            a, b = aff(cbn)
            return torch.relu(z.float() * a + b).to(dt)

        def conv(x, cbn):
            k = cbn.kernel
            return F.conv2d(x, cbn.conv.weight.to(dt), padding=k // 2)

        act2 = bn_relu(conv(bn_relu(conv(o, self.conv1), self.conv1),
                            self.conv2), self.conv2)
        z3 = conv(act2, self.conv3)
        if self.shortcut is not None:
            a, b = aff(self.shortcut)
            sc = conv(o, self.shortcut).float() * a + b
        else:
            sc = o.float()
        a, b = aff(self.conv3)
        return torch.relu(z3.float() * a + b + sc).to(dt)


class ResNetV1(nn.Module):
    """Backbone returning ``{"pool2": ..., "pool5": ...}`` (NCHW)."""

    base_depths = (256, 512, 1024, 2048)
    bottlenecks = (64, 128, 256, 512)

    def __init__(self, units: Sequence[int] = RESNET_UNITS[50],
                 output_stride: int | None = None,
                 bottleneck_impl: str = "xla"):
        super().__init__()
        if output_stride is not None:
            raise NotImplementedError(
                "ResNetV1 output_stride (atrous) is not ported yet "
                "(ROADMAP.md Queue 1: other families)")
        if bottleneck_impl not in ("xla", "fused", "ghost"):
            raise ValueError(f"unknown bottleneck_impl {bottleneck_impl!r}")
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
                if bottleneck_impl == "ghost" and stride == 1:
                    unit = GhostBottleneck(depth_in, depth, depth_b)
                elif (bottleneck_impl == "fused" and stride == 1
                        and FusedBottleneck.supported(depth_in, depth,
                                                      depth_b)):
                    unit = FusedBottleneck(depth_in, depth, depth_b)
                else:
                    unit = Bottleneck(depth_in, depth, depth_b, stride)
                self.add_module(names[-1], unit)
                depth_in = depth
            self.blocks.append(names)
        self.channels = {"pool2": 64, "pool3": 256, "pool4": 512,
                         "pool5": 2048}

    def forward(self, x: torch.Tensor, train: bool = False
                ) -> Dict[str, torch.Tensor]:
        # models/resnet.py:398-408: conv, pool, then relu in eval (exact,
        # since relu and max commute); conv, BN, relu, then pool in train
        if train:
            x = stem_max_pool(F.relu(self.conv1(x, train)))
        else:
            x = F.relu(stem_max_pool(self.conv1(x, train)))
        ep = {"pool2": x}
        for b, names in enumerate(self.blocks):
            for name in names:
                x = getattr(self, name)(x, train)
            if b < 2:
                ep[f"pool{b + 3}"] = x
        ep["pool5"] = x
        return ep
