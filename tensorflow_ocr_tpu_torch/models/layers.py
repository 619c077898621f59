"""Shared layers: conv+BN, TF-SAME padding, stem pool, unpool.

Port of ``tensorflow_ocr_tpu/models/layers.py`` as far as the detect
path and the train step need it. Modules take NCHW tensors (the model
keeps them in the channels-last memory format, so the data is laid out
as JAX's NHWC); parameters stay float32 and are cast to the activation
dtype per call, like the Flax modules' ``dtype``/``param_dtype`` split.

Deliberately not ported (TPU/XLA rewrites that compute nothing new):
the space-to-depth stem, the equality-mask max-pool VJP and the
``POINTWISE_DOT`` 1x1 route.

``PALLAS_CONVS`` routes the stride-1 1x1 and 3x3 convs (and 1x1 convs at
a stride that divides H and W) of :class:`ConvBN` through the
hand-written conv kernels of ``ops/conv.py``, as models/layers.py:26-42
and :131-135 route them to the Pallas kernels: False (the default:
cuDNN on the card), True, or None for on with CUDA tensors. The kernels
take bfloat16 only, so with the route on a float32 model on the card
raises; the JAX route takes float32 convs too.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from tensorflow_ocr_tpu_torch.ops import conv as CV

# ImageNet channel means, RGB order (models/layers.py:17).
IMAGENET_MEANS = (123.68, 116.78, 103.94)
# BN decay (models/layers.py:353): Flax's momentum multiplies the OLD
# running value, torch's the new one.
BN_MOMENTUM = 0.997
# Route supported convs through ops/conv.py (see the module docstring).
PALLAS_CONVS: Optional[bool] = False


def _pallas_convs_enabled(x: torch.Tensor) -> bool:
    """``PALLAS_CONVS``, with None read as "on for CUDA tensors"."""
    if PALLAS_CONVS is not None:
        return PALLAS_CONVS
    return x.device.type == "cuda"


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
    """slim conv2d + BatchNorm + optional relu (models/layers.py:329-425).

    The parameters stay unfolded. In eval mode each forward folds the
    running-stats affine into the conv: ``w' = w·γ/√(σ²+ε)`` and
    ``shift = β − μ·γ/√(σ²+ε)`` (gradients flow through the fold, as in
    the freeze_bn step). In train mode BN uses the batch statistics with
    Flax's conventions (:meth:`_batch_norm`). ``explicit_pad`` is slim's
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

    def _routed(self, x: torch.Tensor) -> bool:
        """Whether this conv takes the ``PALLAS_CONVS`` route: SAME
        padding (not slim's explicit pad at stride > 1), and a shape that
        ``ops.conv.supported`` takes (models/layers.py:131-135)."""
        k, s = self.kernel, self.stride
        n, ci, h, w = x.shape
        return (_pallas_convs_enabled(x)
                and not (self.explicit_pad and s > 1)
                and CV.supported((n, h, w, ci), (k, k), (s, s), (1, 1),
                                 self.conv.out_channels))

    def _conv(self, x: torch.Tensor, wgt: torch.Tensor) -> torch.Tensor:
        if self._routed(x):
            return CV.conv2d(x, wgt, (self.stride, self.stride))
        left, right, top, bottom = self._pads(*x.shape[-2:])
        if left == right and top == bottom:
            return F.conv2d(x, wgt, stride=self.stride, padding=(top, left))
        return F.conv2d(F.pad(x, (left, right, top, bottom)), wgt,
                        stride=self.stride)

    def _batch_norm(self, y: torch.Tensor) -> torch.Tensor:
        """Flax ``nn.BatchNorm(use_running_average=False)``: statistics in
        float32 over (N, H, W) with the fast variance max(E[y²]−E[y]², 0),
        which is biased and also feeds the running update; the running
        values update as ``m·old + (1−m)·new`` (m = ``BN_MOMENTUM``). ``F.batch_norm(training=True)`` would update them with
        the unbiased variance and torch's momentum, so the buffers are
        updated here by hand."""
        bn, yf = self.bn, y.float()
        mu = yf.mean((0, 2, 3))
        var = torch.clamp((yf * yf).mean((0, 2, 3)) - mu * mu, min=0.0)
        update_running_stats(bn, mu, var)
        mul = torch.rsqrt(var + self.eps) * bn.weight
        out = (yf - mu[:, None, None]) * mul[:, None, None] \
            + bn.bias[:, None, None]
        return out.to(y.dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        bn = self.bn
        if train:
            y = self._batch_norm(self._conv(x, self.conv.weight.to(x.dtype)))
        else:
            mul = bn.weight * torch.rsqrt(bn.running_var + self.eps)
            shift = bn.bias - bn.running_mean * mul
            wgt = (self.conv.weight * mul[:, None, None, None]).to(x.dtype)
            y = self._conv(x, wgt) + shift.to(x.dtype)[:, None, None]
        return F.relu(y) if self.relu else y


def update_running_stats(bn: BatchNorm, mean: torch.Tensor,
                         var: torch.Tensor) -> None:
    """Flax's running update of BN statistics, in place, outside autograd:
    ``running = m·running + (1 − m)·batch``, m = ``BN_MOMENTUM``."""
    m = BN_MOMENTUM
    with torch.no_grad():
        bn.running_mean.copy_(m * bn.running_mean + (1 - m) * mean)
        bn.running_var.copy_(m * bn.running_var + (1 - m) * var)


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
