"""Shared layers: conv+BN (eval-mode fold), TF-SAME padding, stem pool, unpool.

Port of ``tensorflow_ocr_tpu/models/layers.py`` as far as the serving
path needs it. Modules take NCHW tensors (the model keeps them in the
channels-last memory format, so the data is laid out as JAX's NHWC);
parameters stay float32 and are cast to the activation dtype per call,
like the Flax modules' ``dtype``/``param_dtype`` split.

Deliberately not ported (TPU/XLA rewrites that compute nothing new):
the space-to-depth stem, the equality-mask max-pool VJP and the
``POINTWISE_DOT`` 1x1 route.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

# ImageNet channel means, RGB order (models/layers.py:17).
IMAGENET_MEANS = (123.68, 116.78, 103.94)


def mean_image_subtraction(images: torch.Tensor,
                           means: Union[Sequence[float], torch.Tensor]
                           = IMAGENET_MEANS
                           ) -> torch.Tensor:
    """NHWC images minus the per-channel means (models/layers.py:150).
    ``means`` may be a tensor already on the images' device."""
    return images - torch.as_tensor(means, dtype=images.dtype,
                                    device=images.device)


def unpool(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample with half-pixel centres, as jax.image.resize
    does it (models/layers.py:157-166). NCHW."""
    h, w = x.shape[-2:]
    return F.interpolate(x, size=(2 * h, 2 * w), mode="bilinear",
                         align_corners=False, antialias=False)


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TF/XLA "SAME" padding of one spatial dim: (before, after).

    The total goes mostly after, so a stride-2 window on an even size pads
    0 before and 1 after — torch's symmetric ``padding=`` cannot say that.
    """
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def stem_max_pool(x: torch.Tensor) -> torch.Tensor:
    """The ResNet stem's 3x3/2 SAME max-pool (models/layers.py:256-261).

    In eval mode it runs before the relu, so it sees negative values: pad
    with -inf by hand, then pool with no padding.
    """
    (top, bottom), (left, right) = (same_pads(d, 3, 2) for d in x.shape[-2:])
    x = F.pad(x, (left, right, top, bottom), value=-math.inf)
    return F.max_pool2d(x, 3, 2)


class BatchNorm(nn.Module):
    """BatchNorm's parameters and running statistics, with the names of
    ``nn.BatchNorm2d`` (no ``num_batches_tracked``: the Flax tree has none).
    Initialised like Flax: scale 1, bias 0, mean 0, var 1."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))


class ConvBN(nn.Module):
    """slim conv2d + BatchNorm + optional relu (models/layers.py:329-383).

    The parameters stay unfolded; in eval mode each forward folds the
    running-stats affine into the conv: ``w' = w·γ/√(σ²+ε)`` and
    ``shift = β − μ·γ/√(σ²+ε)``. ``explicit_pad`` is slim's
    ``conv2d_same`` for stride > 1: fixed ``(k-1)//2`` before and ``k//2``
    after. Every other conv pads TF-SAME.
    """

    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 stride: int = 1, relu: bool = True,
                 explicit_pad: bool = False, eps: float = 1e-5):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, features, kernel, stride,
                              bias=False)
        self.bn = BatchNorm(features)
        self.kernel, self.stride = kernel, stride
        self.relu, self.explicit_pad, self.eps = relu, explicit_pad, eps

    def _pads(self, h: int, w: int) -> Tuple[int, int, int, int]:
        k, s = self.kernel, self.stride
        if self.explicit_pad and s > 1:
            (top, bottom) = (left, right) = ((k - 1) // 2, k // 2)
        else:
            top, bottom = same_pads(h, k, s)
            left, right = same_pads(w, k, s)
        return left, right, top, bottom

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            raise NotImplementedError(
                "training-mode BatchNorm is not ported yet "
                "(ROADMAP.md Queue 1: training-mode BN and the train step)")
        bn = self.bn
        mul = bn.weight * torch.rsqrt(bn.running_var + self.eps)
        shift = bn.bias - bn.running_mean * mul
        wgt = (self.conv.weight * mul[:, None, None, None]).to(x.dtype)
        left, right, top, bottom = self._pads(*x.shape[-2:])
        if left == right and top == bottom:
            y = F.conv2d(x, wgt, stride=self.stride, padding=(top, left))
        else:
            y = F.conv2d(F.pad(x, (left, right, top, bottom)), wgt,
                         stride=self.stride)
        y = y + shift.to(x.dtype)[:, None, None]
        return F.relu(y) if self.relu else y


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init matching the Flax initialisers: convs lecun_normal
    (truncated normal, fan-in scaled), conv biases 0, BatchNorm scale 1,
    bias 0, mean 0, var 1."""
    # flax variance_scaling("truncated_normal"): std of the unit normal
    # truncated to [-2, 2]
    trunc_std = 0.87962566103423978
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                std = math.sqrt(1.0 / fan_in) / trunc_std
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, BatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
