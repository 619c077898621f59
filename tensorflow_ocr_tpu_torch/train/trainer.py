"""Train state, the train step and the trainer loop.

Port of ``tensorflow_ocr_tpu/train/trainer.py:43-79, 95-267, 674-866``
for one device and the PixelLink OHEM recipe:

- :class:`TrainState`: the step count, the model (parameters and BN
  running statistics), the optimizer and the EMA of the parameters;
- :func:`make_loss_fn`: PixelLink labels made on the device from the
  padded polygons (or taken precomputed from ``score``/``link``/``mask``)
  and the OHEM loss;
- :func:`train_step`: forward (batch-statistics BN, or running
  statistics with ``freeze_bn``), backward, optimizer update with the
  learning rate of the step, EMA update; the reported ``total_loss`` adds
  the L2 value of the parameters before the update;
- :class:`Trainer`: ``setup`` and ``run(batches, max_steps)`` with the
  NaN abort and the examples/s meter.

Not ported yet (ROADMAP.md Queue 1): checkpoints, warm start,
calibration, preemption, the multi-step dispatch, the device dataset,
augmentation and data parallelism.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from tensorflow_ocr_tpu_torch.config import Config
from tensorflow_ocr_tpu_torch.models.detector import Detector, build_model
from tensorflow_ocr_tpu_torch.ops.labels import pixellink_labels_stride
from tensorflow_ocr_tpu_torch.ops.losses import (
    check_loss_ported,
    ohem_pixel_link_loss,
)
from tensorflow_ocr_tpu_torch.train import optim

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
OUTPUT_STRIDE = 4  # the PixelLink models of the registry


@dataclass
class TrainState:
    step: int
    model: Detector
    optimizer: torch.optim.Optimizer
    ema: Dict[str, torch.Tensor]  # parameter name -> EMA value


def require_device(device, who: str) -> torch.device:
    """``device`` as a torch.device; raises when it is a CUDA device and
    torch sees none: training never carries on on the CPU unasked."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}(device='cuda'): torch sees no CUDA "
                           "device")
    return device


def create_train_state(cfg: Config, device="cuda",
                       generator: Optional[torch.Generator] = None,
                       weights: Optional[Mapping[str, torch.Tensor]] = None
                       ) -> TrainState:
    """Model of ``cfg.model`` (seeded from ``cfg.train.seed`` unless a
    generator or a state_dict is given), a fresh optimizer and
    ``ema = copy(params)``, on ``device`` (the card unless the caller asks
    for the CPU; raises when there is no card)."""
    device = require_device(device, "create_train_state")
    check_loss_ported(cfg.loss.name)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.train.seed)
    model = build_model(cfg.model.name, dtype=DTYPES[cfg.model.compute_dtype],
                        generator=generator,
                        bottleneck_impl=cfg.model.bottleneck_impl)
    if weights is not None:
        model.load_state_dict(weights, strict=True)
    model.to(device)
    opt = optim.make_optimizer(model, cfg.train, cfg.model.weight_decay)
    ema = {n: p.detach().clone() for n, p in model.named_parameters()}
    return TrainState(0, model, opt, ema)


def make_loss_fn(cfg: Config) -> Callable:
    """loss(outputs, batch) -> (model_loss, aux) for PixelLink + OHEM."""
    check_loss_ported(cfg.loss.name)
    out_hw = cfg.data.input_size // OUTPUT_STRIDE
    lcfg = cfg.loss

    def labels(batch):
        if "score" in batch:  # precomputed label maps
            return batch["score"], batch["link"], batch["mask"]
        s, l, m = pixellink_labels_stride(
            batch["polys"], batch["tags"], batch["valid"], out_hw, out_hw,
            OUTPUT_STRIDE, cfg.data.min_text_size)
        return s[..., None], l, m[..., None]

    def loss_fn(outputs, batch):
        score, link, mask = labels(batch)
        return ohem_pixel_link_loss(
            score, outputs["pixel_logits"], link, outputs["link_logits"],
            mask, max_neg_pos_ratio=lcfg.max_neg_pos_ratio,
            pixel_loss_weight=lcfg.pixel_loss_weight,
            bg_neg_budget=lcfg.bg_neg_budget,
            compute_dtype=lcfg.compute_dtype)

    return loss_fn


def loss_and_grads(model: Detector, batch: Mapping[str, torch.Tensor],
                   cfg: Config, loss_fn: Callable
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward and backward of one batch: (model_loss, aux), with the
    gradients left in the parameters' ``.grad``. ``freeze_bn`` runs BN on
    the running statistics (the eval-mode model, gradients through the
    fold); otherwise BN uses the batch statistics and updates the running
    ones."""
    for p in model.parameters():
        p.grad = None
    out = model(batch["images"], train=not cfg.model.freeze_bn)
    model_loss, aux = loss_fn(out, batch)
    model_loss.backward()
    return model_loss.detach(), {k: v.detach() for k, v in aux.items()}


def train_step(state: TrainState, batch: Mapping[str, torch.Tensor],
               cfg: Config, loss_fn: Callable) -> Dict[str, torch.Tensor]:
    """One step on the device; returns the metrics as device scalars (no
    host sync): total_loss, model_loss and the loss's aux values."""
    l2 = optim.l2_regularization(state.model, cfg.model.weight_decay)
    model_loss, aux = loss_and_grads(state.model, batch, cfg, loss_fn)
    optim.set_learning_rate(state.optimizer,
                            optim.make_schedule(cfg.train)(state.step))
    state.optimizer.step()
    optim.ema_update(state.ema, state.model.named_parameters(),
                     optim.ema_decay(cfg.train.moving_average_decay,
                                     state.step))
    state.step += 1
    return {"total_loss": model_loss + l2, "model_loss": model_loss, **aux}


def to_device(batch: Mapping[str, np.ndarray], device
              ) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in batch.items()}


class Trainer:
    """The train loop (trainer.py:674-866) on one device (the card unless
    the caller asks for the CPU; raises when there is no card): NaN abort
    and an examples/s meter every ``cfg.train.log_every_steps`` steps."""

    def __init__(self, cfg: Config, device="cuda"):
        self.cfg = cfg
        self.device = require_device(device, "Trainer")
        self.state: Optional[TrainState] = None
        self.loss_fn = make_loss_fn(cfg)

    def setup(self, weights: Optional[Mapping[str, torch.Tensor]] = None,
              generator: Optional[torch.Generator] = None) -> TrainState:
        self.state = create_train_state(self.cfg, self.device, generator,
                                        weights)
        return self.state

    def run(self, batches, max_steps: Optional[int] = None
            ) -> Dict[str, float]:
        """Train on ``batches`` (an iterator, or a sequence indexed by
        step) for ``max_steps`` steps; returns the last logged metrics."""
        max_steps = max_steps or self.cfg.train.max_steps
        window = self.cfg.train.log_every_steps
        last: Dict[str, float] = {}
        last_log_step = -1  # the first window holds a single step
        t0 = time.perf_counter()
        for step in range(max_steps):
            batch = (next(batches) if hasattr(batches, "__next__")
                     else batches[step])
            db = to_device(batch, self.device)
            metrics = train_step(self.state, db, self.cfg, self.loss_fn)
            if step % window:
                continue
            last = {k: float(v) for k, v in metrics.items()}  # syncs
            if math.isnan(last["total_loss"]):
                print("Loss diverged, stop training")
                break
            dt = time.perf_counter() - t0
            t0 = time.perf_counter()
            n_steps, last_log_step = step - last_log_step, step
            n_img = db["images"].shape[0] * n_steps
            print(f"Step {step:06d}, model loss {last['model_loss']:.4f}, "
                  f"total loss {last['total_loss']:.4f}, "
                  f"{dt / n_steps:.3f} s/step, {n_img / dt:.1f} examples/s")
        return last
