"""Settings of the port.

The fields of ``tensorflow_ocr_tpu/config.py`` that the port reads, with
the same defaults: ``InferConfig`` for the PixelLink
:class:`~tensorflow_ocr_tpu_torch.infer.Predictor`, and the data, model,
loss and train sections that the train step
(:mod:`tensorflow_ocr_tpu_torch.train.trainer`) reads. The port keeps its
own copy so that it imports nothing of the JAX package;
``tests/test_torch_config.py`` holds every default equal to the original.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence


@dataclass
class InferConfig:
    max_side_len: int = 3000  # longest side after resize_image
    pixel_conf_threshold: float = 0.8
    link_conf_threshold: float = 0.8
    # minimum component size in stride-4 pixels (components > this stay)
    min_component_size: int = 10
    # static bound on components per image for the batched decode
    max_components: int = 128
    # adopt operating_point.json beside the weights in place of the
    # static thresholds above
    use_calibrated_thresholds: bool = True


@dataclass
class DataConfig:
    input_size: int = 512
    # polys whose shorter side is below this are masked out of the loss
    min_text_size: int = 10


@dataclass
class ModelConfig:
    name: str = "pixellink_resnet50"
    weight_decay: float = 1e-5
    # activation dtype; parameters and BN statistics stay float32
    compute_dtype: str = "bfloat16"
    # running statistics in BN during training (no batch reductions)
    freeze_bn: bool = False
    # "xla": plain Bottleneck (cuDNN convs); "fused": FusedBottleneck on
    # the hand-written kernels of ops/fused.py; "ghost": GhostBottleneck,
    # ghost-BN units on the kernels of ops/ghost.py where pick_gh admits
    bottleneck_impl: str = "xla"


@dataclass
class LossConfig:
    name: str = "ohem"  # only OHEM is ported (ops/losses.py)
    max_neg_pos_ratio: int = 3
    # hardest negatives selected on images with no positive pixel
    bg_neg_budget: int = 0
    pixel_loss_weight: float = 2.0
    # CE-term dtype of the OHEM loss: "float32" | "bfloat16"
    compute_dtype: str = "float32"


@dataclass
class TrainConfig:
    learning_rate: float = 1e-4
    lr_decay_rate: float = 0.94
    lr_decay_steps: int = 5000
    lr_staircase: bool = True
    # piecewise-constant staircase; replaces the exponential schedule
    # when non-empty (lr_decays has len(lr_breakpoints) + 1 factors)
    lr_breakpoints: Sequence[int] = ()
    lr_decays: Sequence[float] = ()
    optimizer: str = "adam"  # adam | momentum
    momentum: float = 0.9
    max_steps: int = 100_000
    moving_average_decay: float = 0.997
    seed: int = 0
    log_every_steps: int = 10


@dataclass
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    infer: InferConfig = field(default_factory=InferConfig)
