"""LR schedules, the optimizer, the EMA and the reported L2 term.

Port of ``tensorflow_ocr_tpu/train/optim.py``:

- exponential staircase ``lr * rate ** floor(step / steps)`` and the
  piecewise-constant table, both read at the step count BEFORE the
  update, as optax's ``scale_by_schedule`` reads it;
- ``optax.chain(add_decayed_weights(wd, mask=kernels), adam(lr))`` is
  ``torch.optim.Adam`` with ``weight_decay=wd`` on a parameter group of
  the conv kernels and 0 on the rest: both add ``wd * w`` to the gradient
  before the moments (``tests/test_torch_train.py`` holds the two
  against each other); momentum SGD likewise;
- the EMA ``min(d, (1+t)/(10+t))`` over the parameters (not the BN
  buffers), t the step count before the update;
- ``l2_regularization``: ``wd/2 * Σ w²`` over the kernels, reported in
  the total loss only (the decay itself is in the optimizer).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Sequence, Tuple

import torch
from torch import nn

from tensorflow_ocr_tpu_torch.config import TrainConfig


def exponential_staircase(lr: float, decay_steps: int, decay_rate: float,
                          staircase: bool = True) -> Callable[[int], float]:
    def sched(step: int) -> float:
        p = step / decay_steps
        if staircase:
            p = math.floor(p)
        return lr * decay_rate ** p
    return sched


def piecewise_staircase(lr: float, breakpoints: Sequence[int],
                        decays: Sequence[float]) -> Callable[[int], float]:
    rates = [lr * d for d in decays]

    def sched(step: int) -> float:
        out = rates[0]
        for bp, r in zip(breakpoints, rates[1:]):
            if step >= bp:
                out = r
        return out
    return sched


def make_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    if cfg.lr_breakpoints:
        return piecewise_staircase(
            cfg.learning_rate, cfg.lr_breakpoints,
            list(cfg.lr_decays) or [1.0] * (len(cfg.lr_breakpoints) + 1))
    return exponential_staircase(cfg.learning_rate, cfg.lr_decay_steps,
                                 cfg.lr_decay_rate, cfg.lr_staircase)


def kernel_names(model: nn.Module) -> List[str]:
    """Names of the conv kernels: the weights of every ``nn.Conv2d`` (the
    Flax ``kernel`` leaves; BN scales and biases are not among them)."""
    return [f"{name}.weight" if name else "weight"
            for name, m in model.named_modules() if isinstance(m, nn.Conv2d)]


def make_optimizer(model: nn.Module, cfg: TrainConfig,
                   weight_decay: float = 0.0) -> torch.optim.Optimizer:
    """Adam (or momentum SGD) with ``weight_decay`` on the kernels only.
    The learning rate is set per step by :func:`set_learning_rate`."""
    kernels = set(kernel_names(model))
    named = list(model.named_parameters())
    groups = [
        {"params": [p for n, p in named if n in kernels],
         "weight_decay": weight_decay},
        {"params": [p for n, p in named if n not in kernels],
         "weight_decay": 0.0},
    ]
    lr = make_schedule(cfg)(0)
    if cfg.optimizer == "adam":
        return torch.optim.Adam(groups, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if cfg.optimizer == "momentum":
        return torch.optim.SGD(groups, lr=lr, momentum=cfg.momentum)
    raise ValueError(f"unknown optimizer {cfg.optimizer}")


def set_learning_rate(opt: torch.optim.Optimizer, lr: float) -> None:
    for g in opt.param_groups:
        g["lr"] = lr


def ema_decay(base_decay: float, step: int) -> float:
    """TF ExponentialMovingAverage(num_updates=step) warm-up."""
    return min(base_decay, (1.0 + step) / (10.0 + step))


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor],
               params: Iterable[Tuple[str, torch.Tensor]],
               decay: float) -> None:
    """ema = decay * ema + (1 - decay) * params, in place (one multi-tensor
    lerp: ema + (1 - decay) * (params - ema))."""
    names, ps = zip(*params)
    torch._foreach_lerp_([ema[n] for n in names], list(ps), 1.0 - decay)


@torch.no_grad()
def l2_regularization(model: nn.Module, weight_decay: float
                      ) -> torch.Tensor:
    """wd * Σ w² / 2 over the conv kernels (float32 parameters)."""
    if weight_decay == 0.0:
        return torch.zeros((), dtype=torch.float32,
                           device=next(model.parameters()).device)
    params = dict(model.named_parameters())
    norms = torch._foreach_norm([params[n] for n in kernel_names(model)])
    return weight_decay * 0.5 * torch.stack(norms).square().sum()
