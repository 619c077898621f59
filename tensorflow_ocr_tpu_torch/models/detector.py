"""Top-level detector and the model registry.

Port of ``tensorflow_ocr_tpu/models/detector.py``: every model of its
registry, on the ResNet-v1 (50, 101, 152, 200), ResNet-v2-50, VGG-16 and
tiny CI backbones under the PixelLink, EAST (RBOX or QUAD) and link8
heads (``pixellink2s_vgg16`` puts the PixelLink head one level finer, on
conv2_2 at stride 2). Module names follow the Flax tree
(``backbone``, ``merge``, ``head``), so ``models/convert.py`` maps the
JAX variables onto :meth:`Detector.state_dict` by renaming leaves.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from tensorflow_ocr_tpu_torch.models.heads import (
    EASTHead,
    EASTMerge,
    FEATURE_KEYS,
    Link8Head,
    PixelLinkHead,
)
from tensorflow_ocr_tpu_torch.models.layers import (
    IMAGENET_MEANS,
    init_weights,
    mean_image_subtraction,
)
from tensorflow_ocr_tpu_torch.models.resnet import RESNET_UNITS, ResNetV1
from tensorflow_ocr_tpu_torch.models.resnet_v2 import ResNetV2
from tensorflow_ocr_tpu_torch.models.tiny import TinyConvNet
from tensorflow_ocr_tpu_torch.models.vgg import VGG16

# the VGG endpoints the heads fuse, coarsest first (detector.py:34-37);
# the 2s variant adds conv2_2, one level finer
VGG_PIXELLINK_KEYS = ("fc7", "conv5_3", "conv4_3", "conv3_3")
VGG_PIXELLINK_2S_KEYS = VGG_PIXELLINK_KEYS + ("conv2_2",)


class Detector(nn.Module):
    """Backbone + head. Input NHWC RGB in [0, 255], any dtype (uint8 on
    the wire); outputs NHWC float32: ``pixel_logits``/``link_logits``
    (pixellink), ``score``/``geometry`` (east) or ``score``/``link_probs``
    (link8).

    ``backbone_name``: resnet<depth> | resnetv2_<depth> | tiny | vgg16
    (depth 50, 101, 152 or 200); ``head_name``: pixellink |
    east | link8; ``text_scale`` and ``geometry`` (RBOX | QUAD) shape the
    EAST head; ``output_stride`` 2 fuses VGG's conv2_2 (detector.py:
    42-108). ``bottleneck_impl`` picks the ResNet's units (models/resnet.py).
    """

    def __init__(self, backbone_name: str = "resnet50",
                 head_name: str = "pixellink", text_scale: int = 512,
                 geometry: str = "RBOX", output_stride: int = 4,
                 dtype: torch.dtype = torch.bfloat16,
                 bottleneck_impl: str = "xla"):
        super().__init__()
        if backbone_name == "tiny":
            self.backbone = TinyConvNet()
            keys, upsample_first = FEATURE_KEYS, True
        elif backbone_name == "vgg16":
            self.backbone = VGG16()
            keys = (VGG_PIXELLINK_2S_KEYS if output_stride == 2
                    else VGG_PIXELLINK_KEYS)
            # fc7 and conv5_3 share stride 16: no upsample before the
            # first fuse (detector.py:67-69)
            upsample_first = False
        elif backbone_name.startswith("resnetv2_"):
            # the unit is always a PreactBottleneck (detector.py:52-58)
            self.backbone = ResNetV2(
                RESNET_UNITS[int(backbone_name[len("resnetv2_"):])])
            keys, upsample_first = FEATURE_KEYS, True
        elif backbone_name.startswith("resnet"):
            self.backbone = ResNetV1(
                RESNET_UNITS[int(backbone_name[len("resnet"):])],
                bottleneck_impl=bottleneck_impl)
            keys, upsample_first = FEATURE_KEYS, True
        else:
            raise ValueError(f"unknown backbone {backbone_name}")
        ch = self.backbone.channels
        if head_name == "pixellink":
            self.merge = None
            self.head = PixelLinkHead(ch, keys, upsample_first)
        elif head_name in ("east", "link8"):
            self.merge = EASTMerge(ch, keys, upsample_first)
            self.head = (EASTHead(32, text_scale, geometry)
                         if head_name == "east" else Link8Head(32))
        else:
            raise ValueError(f"unknown head {head_name}")
        self.head_name = head_name
        self.dtype = dtype
        self.output_stride = output_stride
        # kept on the model's device, so a forward copies nothing to it
        self.register_buffer("means", torch.tensor(IMAGENET_MEANS),
                             persistent=False)

    def forward(self, images: torch.Tensor, train: bool = False
                ) -> Dict[str, torch.Tensor]:
        x = mean_image_subtraction(images.float(), self.means)
        # NHWC -> NCHW view with channels-last strides: no copy, and the
        # convolutions see JAX's data layout
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        ep = self.backbone(x, train)
        if self.merge is not None:
            return self.head(self.merge(ep, train), train)
        return self.head(ep, train)


# the JAX registry (detector.py:111-127), entry for entry
MODEL_REGISTRY = {
    "pixellink_resnet50": dict(backbone_name="resnet50",
                               head_name="pixellink"),
    "pixellink_resnet101": dict(backbone_name="resnet101",
                                head_name="pixellink"),
    "pixellink_vgg16": dict(backbone_name="vgg16", head_name="pixellink"),
    "pixellink2s_vgg16": dict(backbone_name="vgg16", head_name="pixellink",
                              output_stride=2),
    "east_resnet50": dict(backbone_name="resnet50", head_name="east"),
    "east_resnet101": dict(backbone_name="resnet101", head_name="east"),
    "east_vgg16": dict(backbone_name="vgg16", head_name="east"),
    "link8_resnet50": dict(backbone_name="resnet50", head_name="link8"),
    "pixellink_resnetv2_50": dict(backbone_name="resnetv2_50",
                                  head_name="pixellink"),
    "east_resnetv2_50": dict(backbone_name="resnetv2_50", head_name="east"),
    "pixellink_resnet152": dict(backbone_name="resnet152",
                                head_name="pixellink"),
    "east_resnet152": dict(backbone_name="resnet152", head_name="east"),
    "pixellink_resnet200": dict(backbone_name="resnet200",
                                head_name="pixellink"),
    "east_resnet200": dict(backbone_name="resnet200", head_name="east"),
    "pixellink_tiny": dict(backbone_name="tiny", head_name="pixellink"),
    "east_tiny": dict(backbone_name="tiny", head_name="east"),
}


def model_output_stride(name: str) -> int:
    """Output-map stride of a registry model (2 for the 2s variant)."""
    return MODEL_REGISTRY[name].get("output_stride", 4)


def model_head(name: str) -> str:
    """The head of a registry model: pixellink | east | link8."""
    return MODEL_REGISTRY[name]["head_name"]


def build_model(name: str, dtype: torch.dtype = torch.bfloat16,
                generator: Optional[torch.Generator] = None,
                bottleneck_impl: str = "xla", text_scale: int = 512,
                geometry: str = "RBOX") -> Detector:
    """Build a registry model with float32 parameters initialised from
    ``generator`` (seed 0 when None); ``dtype`` is the activation type.
    ``bottleneck_impl`` "fused" puts the ResNet's stride-1 units on the
    fused kernels, "ghost" on the ghost-BN units (the tiny and VGG
    backbones have no bottleneck and ignore it); the state_dict is the
    same every way (ResNet-v2 always runs its pre-activation unit, as in
    JAX). ``text_scale`` and ``geometry`` shape the EAST head."""
    if name not in MODEL_REGISTRY:
        raise ValueError(f"unknown model {name}; have {sorted(MODEL_REGISTRY)}")
    model = Detector(dtype=dtype, bottleneck_impl=bottleneck_impl,
                     text_scale=text_scale, geometry=geometry,
                     **MODEL_REGISTRY[name])
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_weights(model, generator)
    return model.eval()
