"""Settings of the port.

The fields of ``tensorflow_ocr_tpu/config.py`` that the port reads, with
the same defaults: ``InferConfig`` for the
:class:`~tensorflow_ocr_tpu_torch.infer.Predictor` (PixelLink, link8
and EAST), the data, model, loss and train sections that the train step
and the trainer loop (:mod:`tensorflow_ocr_tpu_torch.train.trainer`)
read, with the checkpoint-time calibration
(``calibrate_at_checkpoint``, ``calibrate_max_images``:
``train/calibrate.py``) and the eval hook's cadence
(``eval_every_steps``: ``train/eval_hook.py``), and ``EvalConfig`` (the
matching IoU and the validation directory of the eval hook). The port
keeps its own copy so that it imports nothing of the JAX package;
``tests/test_torch_config.py`` holds every default equal to the original.

The command-line surface is JAX's too: :func:`parse_flags` with the
reference's flag names (:data:`FLAG_ALIASES`) and dotted paths, the
same coercions and the same error on an unknown flag
(``config.py:237-348``).

Every dotted path JAX's ``parse_flags`` takes parses here too
(``tests/test_torch_surface.py``). Five of JAX's fields have no field
here: their paths stand in :data:`IGNORED_PATHS`, accepted and ignored
as ``--gpu_list`` is. They are ``model.bn_momentum`` and
``model.bn_epsilon`` (JAX reads neither; the models take the same values
as their own, ``models/layers.py`` ``BN_MOMENTUM``),
``infer.compat_reference_bugs`` (JAX reads it nowhere), and
``train.donate_state`` and ``train.xla_options`` (XLA's buffer donation
and compiler options). ``TrainConfig.num_devices``
is the data-parallel world: one process per GPU over ``torch.distributed``
(``parallel/``); ``validate`` refuses a count other than the process
group's size.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence


@dataclass
class InferConfig:
    # the test entry points' image directory and result directory
    test_data_path: str = "./exhibition"
    # checkpoint root whose newest ckpt_* a Predictor given this config
    # and no weights serves (its checkpoint_path= argument overrides it)
    checkpoint_path: str = "/tmp/east_icdar2015_resnet_v1_50_rbox/"
    output_dir: str = "/tmp/res/"
    max_side_len: int = 3000  # longest side after resize_image
    pixel_conf_threshold: float = 0.8
    link_conf_threshold: float = 0.8
    # minimum component size in stride-4 pixels (components > this stay)
    min_component_size: int = 10
    # static bound on components per image for the batched decode
    max_components: int = 128
    # EAST decode: score map threshold of the candidates, score of a box
    # after NMS, the NMS IoU, and the cap on NMS input after the merge
    # (0: none)
    score_map_thresh: float = 0.8
    box_thresh: float = 0.1
    nms_thresh: float = 0.2
    nms_max_candidates: int = 1024
    # adopt operating_point.json beside the weights in place of the
    # static thresholds above
    use_calibrated_thresholds: bool = True


@dataclass
class DataConfig:
    training_data_path: str = "/data/ocr/icdar2015/"
    max_image_large_side: int = 1280
    max_text_size: int = 800
    # polys whose shorter side is below this are masked out of the loss
    min_text_size: int = 10
    min_crop_side_ratio: float = 0.1
    geometry: str = "RBOX"  # EAST labels and head: RBOX | QUAD
    input_size: int = 512
    batch_size: int = 14
    num_workers: int = 8
    max_queue_size: int = 24
    # polygon slots of an image (fixed shapes for the device labels)
    max_polys: int = 64
    # augmentation: a scale drawn from random_scale, a random crop, a
    # background crop with probability background_ratio (needs use_crop),
    # a rotation within +-max_rotate_deg
    random_scale: Sequence[float] = (0.5, 1.0, 2.0, 3.0)
    use_random_scale: bool = False
    use_crop: bool = False
    background_ratio: float = 0.0
    use_rotate: bool = False
    max_rotate_deg: float = 10.0
    # keep decoded frames (before augmentation) across epochs
    cache_decoded_images: bool = True


@dataclass
class ModelConfig:
    name: str = "pixellink_resnet50"
    # EAST distance scale: the geometry head's sigmoid times this
    text_scale: int = 512
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
    # pixellink head: ohem | dice | positive | focal; link8: dice (any
    # name); EAST: focal, else the EAST loss (QUAD: its own loss)
    name: str = "ohem"
    max_neg_pos_ratio: int = 3
    # hardest negatives selected on images with no positive pixel
    bg_neg_budget: int = 0
    pixel_loss_weight: float = 2.0
    # CE-term dtype of the OHEM loss: "float32" | "bfloat16"; the
    # OCR_LOSS_BF16 environment variable overrides it when the step's
    # loss is made (ops/losses.py effective_loss_compute_dtype)
    compute_dtype: str = "float32"
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    # EAST: the geometry term's weight under the focal and QUAD losses
    # (the RBOX EAST loss adds it unweighted, as trainer.py:186-193
    # does), and the angle term's inside the RBOX geometry
    east_geo_weight: float = 1.0
    east_angle_weight: float = 10.0


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
    # the gradients' cross-rank reduction: "mean" (multigpu_train.py:70-85)
    # or "sum" (train_pixellink.py sum_gradients :179-194)
    grad_reduce: str = "mean"
    max_steps: int = 100_000
    moving_average_decay: float = 0.997
    # ckpt_<step>/ directories are written under this root
    checkpoint_path: str = "/tmp/east_resnet_v1_50_rbox/"
    # Trainer.setup resumes from the newest checkpoint of checkpoint_path
    restore: bool = False
    save_checkpoint_steps: int = 1000
    # time cadence of the saves (0: steps only); whichever fires first
    save_interval_secs: float = 0.0
    # ckpt_* directories kept (0: all)
    max_checkpoints_to_keep: int = 0
    # image summaries every this many steps (with a summary writer)
    save_summary_steps: int = 20
    # sweep the decode thresholds on a slice of the train split after each
    # checkpoint save and store the operating point beside the checkpoints
    # (train/calibrate.py; the Predictor adopts it)
    calibrate_at_checkpoint: bool = True
    # train images of that slice (never the validation set)
    calibrate_max_images: int = 8
    # a port checkpoint (root or ckpt_<step>) whose tensors of matching
    # name and shape warm-start the model
    pretrained_model_path: Optional[str] = None
    log_every_steps: int = 10
    # warn (never kill) when no step completes for this many seconds; 0
    # disables
    stall_warn_secs: float = 300.0
    seed: int = 0
    # ranks of the data-parallel group (None: the whole world); must be
    # the process group's size (1 with none)
    num_devices: Optional[int] = None
    # train through Trainer.run_device_cached: the dataset staged on the
    # device, scan_steps steps a dispatch
    use_device_cache: bool = False
    # steps a make_multi_train_step dispatch runs (one graph replay each)
    scan_steps: int = 16
    # the eval hook every this many steps (0: off); needs eval.gt_path, a
    # directory of images and gt_*.txt
    eval_every_steps: int = 0


@dataclass
class EvalConfig:
    matching_iou_threshold: float = 0.5  # eval/bboxes.py matching
    gt_path: str = ""


@dataclass
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    infer: InferConfig = field(default_factory=InferConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)

    def replace(self, **kw: Any) -> "Config":
        """A copy with the sections in ``kw`` replaced (config.py:215)."""
        return dataclasses.replace(self, **kw)

    def validate(self) -> "Config":
        """Reject values that would otherwise be ignored
        (config.py:218-235)."""
        if self.data.geometry not in ("RBOX", "QUAD"):
            raise ValueError(
                f"data.geometry must be 'RBOX' or 'QUAD', got "
                f"{self.data.geometry!r}")
        if self.train.save_interval_secs < 0:
            raise ValueError("train.save_interval_secs must be >= 0")
        if self.train.max_checkpoints_to_keep < 0:
            raise ValueError("train.max_checkpoints_to_keep must be >= 0")
        if self.train.grad_reduce not in ("mean", "sum"):
            raise ValueError(f"train.grad_reduce must be 'mean' or 'sum', "
                             f"got {self.train.grad_reduce!r}")
        from tensorflow_ocr_tpu_torch.parallel.mesh import world_size

        world = world_size()
        if self.train.num_devices not in (None, world):
            raise ValueError(
                f"train.num_devices={self.train.num_devices} but the process "
                f"group has {world} rank(s): launch {self.train.num_devices} "
                "ranks (python -m torch.distributed.run "
                f"--nproc_per_node={self.train.num_devices} ...)")
        return self


def _set_by_path(cfg: Config, dotted: str, raw: str) -> None:
    """Set ``cfg.section.field`` from a string, coerced to the type of the
    field's current value (config.py:237-270)."""
    parts = dotted.split(".")
    obj: Any = cfg
    for p in parts[:-1]:
        obj = getattr(obj, p)
    name = parts[-1]
    current = getattr(obj, name)
    value: Any
    if isinstance(current, bool):
        value = raw.lower() in ("1", "true", "yes", "y")
    elif isinstance(current, int):
        value = int(raw)
    elif isinstance(current, float):
        value = float(raw)
    elif isinstance(current, (tuple, list)):
        value = tuple(float(x) for x in raw.split(","))
    elif current is None:
        # optional fields: an int, else a float, else the string
        if raw.lower() in ("none", "null"):
            value = None
        else:
            try:
                value = int(raw)
            except ValueError:
                try:
                    value = float(raw)
                except ValueError:
                    value = raw
    else:
        value = raw
    setattr(obj, name, value)


# the reference's public flag names -> config paths (config.py:273-301);
# None: accepted and ignored (the device is the port's --device)
FLAG_ALIASES = {
    "training_data_path": "data.training_data_path",
    "max_image_large_side": "data.max_image_large_side",
    "max_text_size": "data.max_text_size",
    "min_text_size": "data.min_text_size",
    "min_crop_side_ratio": "data.min_crop_side_ratio",
    "geometry": "data.geometry",
    "input_size": "data.input_size",
    "batch_size_per_gpu": "data.batch_size",
    "num_readers": "data.num_workers",
    "text_scale": "model.text_scale",
    "learning_rate": "train.learning_rate",
    "max_steps": "train.max_steps",
    "moving_average_decay": "train.moving_average_decay",
    "checkpoint_path": "train.checkpoint_path",
    "restore": "train.restore",
    "save_checkpoint_steps": "train.save_checkpoint_steps",
    "save_summary_steps": "train.save_summary_steps",
    "pretrained_model_path": "train.pretrained_model_path",
    "test_data_path": "infer.test_data_path",
    "output_dir": "infer.output_dir",
    "pixel_conf_threshold": "infer.pixel_conf_threshold",
    "link_conf_threshold": "infer.link_conf_threshold",
    "gpu_list": None,
    "gpu_memory_fraction": None,
    "image_width": None,
    "image_height": None,
}

# dotted paths of JAX's Config fields that nothing reads in the port:
# accepted and ignored (module docstring)
IGNORED_PATHS = frozenset({
    "model.bn_momentum", "model.bn_epsilon", "train.donate_state",
    "train.xla_options", "infer.compat_reference_bugs"})


def parse_flags(argv: Sequence[str], cfg: Optional[Config] = None,
                aliases: Optional[dict] = None) -> Config:
    """``--flag=value`` / ``--flag value`` / ``--flag`` (true) arguments
    into a validated Config (config.py:304-348): the reference's names
    through ``aliases`` (default :data:`FLAG_ALIASES`; an entry point may
    remap one, as the test entries map ``checkpoint_path`` to
    ``infer.checkpoint_path``) and dotted paths
    (``--train.learning_rate=3e-4``; :data:`IGNORED_PATHS` ignored); any
    other flag raises ValueError.
    Arguments without ``--`` are skipped."""
    cfg = cfg or Config()
    if aliases is None:
        aliases = FLAG_ALIASES
    args = list(argv)
    i = 0
    while i < len(args):
        a = args[i]
        if not a.startswith("--"):
            i += 1
            continue
        body = a[2:]
        if "=" in body:
            key, val = body.split("=", 1)
        else:
            key = body
            if i + 1 < len(args) and not args[i + 1].startswith("--"):
                val = args[i + 1]
                i += 1
            else:
                val = "true"
        if key in aliases:
            if aliases[key] is not None:
                _set_by_path(cfg, aliases[key], val)
        elif key in IGNORED_PATHS:
            pass
        elif "." in key:
            _set_by_path(cfg, key, val)
        else:
            raise ValueError(f"unknown flag --{key}")
        i += 1
    return cfg.validate()
