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
take bfloat16 and float32, as the JAX route does: a float32 model's
routed convs run on the float32 kernels (split TF32 on the tensor cores,
a float32 product).

``SPATIAL`` is set only inside an H-sharded forward
(``parallel/spatial.py``): the convs, max-pools and unpools below then
take the pads of the whole image's height and fetch the rows outside
their shard from the ranks that hold them; a kernel that pads a 3x3
itself runs on the shard's rows and their halo (:func:`kernel_rows`);
the route decides on the whole image's shape.
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
# The row exchange of an H-sharded forward (parallel/spatial.py
# ``HaloRows``), or None: every other path.
SPATIAL = None


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


class _Unpool(torch.autograd.Function):
    """2x bilinear upsample whose backward sums in a fixed order: the
    forward is ``F.interpolate``'s (each output computed on its own), the
    backward its adjoint, the gradient padded by one pixel (edge
    replicated: the clamped neighbour) and convolved, in float32, with the
    separable taps (1/4, 3/4, 3/4, 1/4) at stride 2 (dx[i] = g[2i-1]/4 +
    3 g[2i]/4 + 3 g[2i+1]/4 + g[2i+2]/4 along each axis). The library's
    bilinear backward adds with atomics, so a train step on the card would
    not be deterministic."""

    @staticmethod
    def forward(ctx, x):
        h, w = x.shape[-2:]
        return F.interpolate(x, size=(2 * h, 2 * w), mode="bilinear",
                             align_corners=False, antialias=False)

    @staticmethod
    def backward(ctx, g):
        # the taps 1 - |u|/2 at u = -1.5, -0.5, 0.5, 1.5, made on g's
        # device (no copy from the host, so a CUDA graph can capture this)
        t = torch.linspace(-1.5, 1.5, 4, device=g.device).abs_()
        t = t.mul_(-0.5).add_(1.0)
        c = g.shape[1]
        k = torch.outer(t, t).expand(c, 1, 4, 4)
        gp = F.pad(g.float(), (1, 1, 1, 1), mode="replicate")
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False  # float32 products
        try:
            return F.conv2d(gp, k, stride=2, groups=c).to(g.dtype)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32


def unpool(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample with half-pixel centres, as jax.image.resize
    does it (models/layers.py:157-166). NCHW. Its backward sums in a
    fixed order (:class:`_Unpool`)."""
    if SPATIAL is not None:
        return SPATIAL.unpool(x)
    return _Unpool.apply(x)


def full_height(x: torch.Tensor) -> int:
    """The image's height at ``x``'s level: its own, or under an
    H-sharded forward the sum of every shard's."""
    return SPATIAL.full(x) if SPATIAL is not None else x.shape[-2]


def full_batch(x: torch.Tensor) -> int:
    """The batch ``x`` is part of: its own, or under an H-sharded forward
    on a (data, space) grid the sum over the data axis."""
    return SPATIAL.batch(x) if SPATIAL is not None else x.shape[0]


def kernel_rows(x: torch.Tensor, kernel: int, op):
    """``op(x)`` for a stride-1 SAME window of ``kernel`` rows that ``op``
    pads itself (a conv kernel). Under an H-sharded forward ``op`` runs on
    the shard's rows extended by their halo (``HaloRows.halo``) and its
    output, or the first item of the tuple it returns, is cropped to the
    shard's rows, channels-last; the tuple's other items are the extended
    rows' (the fused kernels' sums, which eval does not read)."""
    if SPATIAL is None:
        return op(x)
    xe, off = SPATIAL.halo(x, kernel)
    out = op(xe)
    y = out[0] if isinstance(out, tuple) else out
    y = y[:, :, off:off + x.shape[-2]].contiguous(
        memory_format=torch.channels_last)
    return (y, *out[1:]) if isinstance(out, tuple) else y


def conv2d_pads(x: torch.Tensor, wgt: torch.Tensor,
                bias: Optional[torch.Tensor], stride: int, dilation: int,
                pads: Tuple[int, int, int, int]) -> torch.Tensor:
    """``F.conv2d`` with zero pads (left, right, top, bottom): the conv's
    own symmetric padding where the pads allow it, else ``F.pad`` first.
    Under an H-sharded forward the rows come from ``SPATIAL``, and only
    the global top and bottom pad."""
    left, right, top, bottom = pads
    if SPATIAL is not None:
        k = (wgt.shape[-2] - 1) * dilation + 1
        x, top, bottom = SPATIAL.window(x, k, stride, top, bottom)
    if left == right and top == bottom:
        return F.conv2d(x, wgt, bias, stride, (top, left), dilation)
    return F.conv2d(F.pad(x, (left, right, top, bottom)), wgt, bias, stride,
                    dilation=dilation)


def max_pool_pads(x: torch.Tensor, window: int, stride: int,
                  pads: Tuple[int, int, int, int]) -> torch.Tensor:
    """``F.max_pool2d`` after -inf pads (left, right, top, bottom); rows
    from ``SPATIAL`` under an H-sharded forward, as :func:`conv2d_pads`."""
    left, right, top, bottom = pads
    if SPATIAL is not None:
        x, top, bottom = SPATIAL.window(x, window, stride, top, bottom)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom), value=-math.inf)
    return F.max_pool2d(x, window, stride)


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
    (top, bottom) = same_pads(full_height(x), 3, 2)
    (left, right) = same_pads(x.shape[-1], 3, 2)
    return max_pool_pads(x, 3, 2, (left, right, top, bottom))


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
    Flax's conventions (:func:`batch_norm`). ``explicit_pad`` is slim's
    ``conv2d_same`` for stride > 1: fixed ``(k-1)//2`` before and ``k//2``
    after. Every other conv pads TF-SAME. ``dilation`` dilates the kernel
    (the atrous 3x3 of ``output_stride``); SAME padding then counts the
    dilated extent.
    """

    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 stride: int = 1, relu: bool = True,
                 explicit_pad: bool = False, eps: float = 1e-5,
                 dilation: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, features, kernel, stride,
                              bias=False)
        self.bn = BatchNorm(features)
        self.kernel, self.stride, self.dilation = kernel, stride, dilation
        self.relu, self.explicit_pad, self.eps = relu, explicit_pad, eps

    def _pads(self, h: int, w: int) -> Tuple[int, int, int, int]:
        k, s = self.kernel, self.stride
        if self.explicit_pad and s > 1:
            (top, bottom) = (left, right) = ((k - 1) // 2, k // 2)
        else:
            k = (k - 1) * self.dilation + 1
            top, bottom = same_pads(h, k, s)
            left, right = same_pads(w, k, s)
        return left, right, top, bottom

    def _routed(self, x: torch.Tensor) -> bool:
        """Whether this conv takes the ``PALLAS_CONVS`` route: SAME
        padding (not slim's explicit pad at stride > 1), no dilation, and
        a shape that ``ops.conv.supported`` takes (models/layers.py:
        131-135), the whole image's under an H-sharded forward (JAX
        decides on the global shape)."""
        k, s, d = self.kernel, self.stride, self.dilation
        ci, w = x.shape[1], x.shape[3]
        return (_pallas_convs_enabled(x)
                and not (self.explicit_pad and s > 1)
                and CV.supported((full_batch(x), full_height(x), w, ci),
                                 (k, k), (s, s), (d, d),
                                 self.conv.out_channels))

    def _conv(self, x: torch.Tensor, wgt: torch.Tensor) -> torch.Tensor:
        if self._routed(x):
            if self.kernel == 3:  # SAME inside the kernel
                return kernel_rows(x, 3, lambda t: CV.conv2d(t, wgt))
            return CV.conv2d(x, wgt, (self.stride, self.stride))
        return conv2d_pads(x, wgt, None, self.stride, self.dilation,
                           self._pads(full_height(x), x.shape[-1]))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        bn = self.bn
        if train:
            y = batch_norm(bn, self._conv(x, self.conv.weight.to(x.dtype)),
                           True, self.eps)
        else:
            mul = bn.weight * torch.rsqrt(bn.running_var + self.eps)
            shift = bn.bias - bn.running_mean * mul
            wgt = (self.conv.weight * mul[:, None, None, None]).to(x.dtype)
            y = self._conv(x, wgt) + shift.to(x.dtype)[:, None, None]
        return F.relu(y) if self.relu else y


def batch_norm(bn: BatchNorm, y: torch.Tensor, train: bool,
               eps: float = 1e-5) -> torch.Tensor:
    """Flax ``nn.BatchNorm`` on NCHW ``y``, computed in float32 and
    rounded to ``y.dtype``. ``train``: the batch statistics over (N, H, W)
    with the fast variance max(E[y²]−E[y]², 0), which is biased and also
    feeds the running update ``m·old + (1−m)·new`` (m = ``BN_MOMENTUM``;
    ``F.batch_norm(training=True)`` would update with the unbiased
    variance and torch's momentum, so the buffers are updated here by
    hand); else the running statistics."""
    yf = y.float()
    if train:
        mu = yf.mean((0, 2, 3))
        var = torch.clamp((yf * yf).mean((0, 2, 3)) - mu * mu, min=0.0)
        update_running_stats(bn, mu, var)
    else:
        mu, var = bn.running_mean, bn.running_var
    mul = torch.rsqrt(var + eps) * bn.weight
    out = (yf - mu[:, None, None]) * mul[:, None, None] \
        + bn.bias[:, None, None]
    return out.to(y.dtype)


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
