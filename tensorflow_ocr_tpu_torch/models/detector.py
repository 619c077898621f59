"""Top-level detector and the model registry.

Port of ``tensorflow_ocr_tpu/models/detector.py`` for the PixelLink
family on ResNet-v1-50 and the tiny CI backbone. Module names follow the
Flax tree (``backbone``, ``head``), so ``models/convert.py`` maps the JAX
variables onto :meth:`Detector.state_dict` by renaming leaves.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from tensorflow_ocr_tpu_torch.models.heads import PixelLinkHead
from tensorflow_ocr_tpu_torch.models.layers import (
    IMAGENET_MEANS,
    init_weights,
    mean_image_subtraction,
)
from tensorflow_ocr_tpu_torch.models.resnet import RESNET_UNITS, ResNetV1
from tensorflow_ocr_tpu_torch.models.tiny import TinyConvNet


class Detector(nn.Module):
    """Backbone + PixelLink head. Input NHWC RGB in [0, 255], any dtype
    (uint8 on the wire); output NHWC float32 logits."""

    def __init__(self, backbone_name: str = "resnet50",
                 dtype: torch.dtype = torch.bfloat16,
                 bottleneck_impl: str = "xla"):
        super().__init__()
        if backbone_name == "tiny":
            self.backbone = TinyConvNet()
        else:
            self.backbone = ResNetV1(
                RESNET_UNITS[int(backbone_name[len("resnet"):])],
                bottleneck_impl=bottleneck_impl)
        self.head = PixelLinkHead(self.backbone.channels)
        self.dtype = dtype
        self.output_stride = 4
        # kept on the model's device, so a forward copies nothing to it
        self.register_buffer("means", torch.tensor(IMAGENET_MEANS),
                             persistent=False)

    def forward(self, images: torch.Tensor, train: bool = False
                ) -> Dict[str, torch.Tensor]:
        x = mean_image_subtraction(images.float(), self.means)
        # NHWC -> NCHW view with channels-last strides: no copy, and the
        # convolutions see JAX's data layout
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        return self.head(self.backbone(x, train), train)


MODEL_REGISTRY = {
    "pixellink_resnet50": dict(backbone_name="resnet50"),
    "pixellink_tiny": dict(backbone_name="tiny"),
}

# The JAX registry's other models (tensorflow_ocr_tpu/models/detector.py).
NOT_PORTED = (
    "pixellink_resnet101", "pixellink_vgg16", "pixellink2s_vgg16",
    "east_resnet50", "east_resnet101", "east_vgg16", "link8_resnet50",
    "pixellink_resnetv2_50", "east_resnetv2_50", "pixellink_resnet152",
    "east_resnet152", "pixellink_resnet200", "east_resnet200", "east_tiny",
)


def build_model(name: str, dtype: torch.dtype = torch.bfloat16,
                generator: Optional[torch.Generator] = None,
                bottleneck_impl: str = "xla") -> Detector:
    """Build a registry model with float32 parameters initialised from
    ``generator`` (seed 0 when None); ``dtype`` is the activation type.
    ``bottleneck_impl`` "fused" puts the ResNet's stride-1 units on the
    fused kernels, "ghost" on the ghost-BN units (the tiny backbone has no
    bottleneck and ignores it); the state_dict is the same every way."""
    if name not in MODEL_REGISTRY:
        if name in NOT_PORTED:
            raise NotImplementedError(
                f"model {name} is not ported yet (ROADMAP.md Queue 1: "
                "other families)")
        raise ValueError(f"unknown model {name}; have {sorted(MODEL_REGISTRY)}")
    model = Detector(dtype=dtype, bottleneck_impl=bottleneck_impl,
                     **MODEL_REGISTRY[name])
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_weights(model, generator)
    return model.eval()
