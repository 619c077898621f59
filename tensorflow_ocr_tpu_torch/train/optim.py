"""LR schedules, the optimizer, the EMA and the reported L2 term.

Port of ``tensorflow_ocr_tpu/train/optim.py``:

- exponential staircase ``lr * rate ** floor(step / steps)`` and the
  piecewise-constant table, both read at the step count BEFORE the
  update, as optax's ``scale_by_schedule`` reads it. Like JAX's, they
  are functions of the step on the device (an int64 tensor), computed
  in float64 and rounded to a float32 tensor, so that a captured CUDA
  graph replays each step's rate;
- ``optax.chain(add_decayed_weights(wd, mask=kernels), adam(lr))`` is
  ``torch.optim.Adam`` with ``weight_decay=wd`` on a parameter group of
  the conv kernels and 0 on the rest: both add ``wd * w`` to the gradient
  before the moments (``tests/test_torch_train.py`` holds the two
  against each other); momentum SGD likewise (:class:`MomentumSGD`).
  The learning rate is a float32 tensor on the parameters' device, set
  in place each step; Adam is ``capturable`` and ``fused`` on the card
  (the capturable multi-tensor Adam divides by its per-parameter 0-dim
  bias corrections one parameter at a time, a launch each), and the
  optimizer state exists from the start (zero moments, step 0, as
  optax's ``init``), so that its tensors never move;
- the EMA ``min(d, (1+t)/(10+t))`` over the parameters (not the BN
  buffers), t the step count before the update, multi-tensor ops with a
  tensor weight;
- ``l2_regularization``: ``wd/2 * Σ w²`` over the kernels, reported in
  the total loss only (the decay itself is in the optimizer).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Sequence, Tuple, Union

import torch
from torch import nn

from tensorflow_ocr_tpu_torch.config import TrainConfig

# step (an int64 tensor, or an int on the host) -> float32 rate tensor
Schedule = Callable[[torch.Tensor], torch.Tensor]


def exponential_staircase(lr: float, decay_steps: int, decay_rate: float,
                          staircase: bool = True) -> Schedule:
    def sched(step: torch.Tensor) -> torch.Tensor:
        p = torch.as_tensor(step).to(torch.float64) / decay_steps
        if staircase:
            p = torch.floor(p)
        return (lr * torch.pow(decay_rate, p)).to(torch.float32)
    return sched


def piecewise_staircase(lr: float, breakpoints: Sequence[int],
                        decays: Sequence[float]) -> Schedule:
    rates = [lr * d for d in decays]

    def sched(step: torch.Tensor) -> torch.Tensor:
        step = torch.as_tensor(step)
        out = torch.full(step.shape, rates[0], dtype=torch.float64,
                         device=step.device)
        for bp, r in zip(breakpoints, rates[1:]):
            out = torch.where(step >= bp, r, out)
        return out.to(torch.float32)
    return sched


def make_schedule(cfg: TrainConfig) -> Schedule:
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


class MomentumSGD(torch.optim.Optimizer):
    """``optax.sgd(lr, momentum)`` after ``add_decayed_weights``: g += wd*w,
    buf = m*buf + g, w -= lr*buf, with a tensor learning rate and no host
    read (``torch.optim.SGD`` reads a tensor rate back to the host, which a
    captured graph cannot)."""

    def __init__(self, params, lr: torch.Tensor, momentum: float):
        super().__init__(params, {"lr": lr, "momentum": momentum,
                                  "weight_decay": 0.0})

    @torch.no_grad()
    def step(self, closure=None):
        for g in self.param_groups:
            ps = [p for p in g["params"] if p.grad is not None]
            if not ps:
                continue
            grads = [p.grad for p in ps]
            if g["weight_decay"]:
                grads = torch._foreach_add(grads, ps,
                                           alpha=g["weight_decay"])
            bufs = [self.state[p]["momentum_buffer"] for p in ps]
            torch._foreach_mul_(bufs, g["momentum"])
            torch._foreach_add_(bufs, grads)
            torch._foreach_sub_(ps, torch._foreach_mul(bufs, g["lr"]))


def make_optimizer(model: nn.Module, cfg: TrainConfig,
                   weight_decay: float = 0.0) -> torch.optim.Optimizer:
    """Adam (or momentum SGD) with ``weight_decay`` on the kernels only,
    its state made at once. The learning rate is a float32 tensor, set
    per step by :func:`set_learning_rate`."""
    kernels = set(kernel_names(model))
    named = list(model.named_parameters())
    groups = [
        {"params": [p for n, p in named if n in kernels],
         "weight_decay": weight_decay},
        {"params": [p for n, p in named if n not in kernels],
         "weight_decay": 0.0},
    ]
    device = named[0][1].device
    lr = make_schedule(cfg)(torch.zeros((), dtype=torch.int64,
                                        device=device))
    on_card = device.type == "cuda"
    if cfg.optimizer == "adam":
        opt = torch.optim.Adam(groups, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                               capturable=on_card, fused=on_card or None)
        for _, p in named:
            opt.state[p].update(
                step=torch.zeros((), dtype=torch.float32,
                                 device=device if on_card else "cpu"),
                exp_avg=torch.zeros_like(p, memory_format=torch.preserve_format),
                exp_avg_sq=torch.zeros_like(
                    p, memory_format=torch.preserve_format))
    elif cfg.optimizer == "momentum":
        opt = MomentumSGD(groups, lr, cfg.momentum)
        for _, p in named:
            opt.state[p]["momentum_buffer"] = torch.zeros_like(p)
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer}")
    for g in opt.param_groups:  # one rate tensor of each group's own
        g["lr"] = lr.clone()
    return opt


@torch.no_grad()
def set_learning_rate(opt: torch.optim.Optimizer, lr: torch.Tensor) -> None:
    """Write the rate tensor ``lr`` into each group's rate, in place."""
    for g in opt.param_groups:
        g["lr"].copy_(lr)


def ema_decay(base_decay: float, step: torch.Tensor) -> torch.Tensor:
    """TF ExponentialMovingAverage(num_updates=step) warm-up, a float64
    tensor (``step`` a tensor, or an int on the host)."""
    t = torch.as_tensor(step).to(torch.float64)
    return torch.clamp((1.0 + t) / (10.0 + t), max=base_decay)


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor],
               params: Iterable[Tuple[str, torch.Tensor]],
               decay: Union[float, torch.Tensor]) -> None:
    """ema = decay * ema + (1 - decay) * params, in place: ema + (1 -
    decay) * (params - ema) in three multi-tensor ops, the weight 1 -
    decay taken in float64 and rounded to a float32 tensor (``decay`` a
    tensor on the parameters' device, or a float). ``_foreach_lerp_`` has
    no single-tensor weight, and a list of 0-dim weights takes its
    per-tensor path: a launch a parameter."""
    names, ps = zip(*params)
    w = (1.0 - torch.as_tensor(decay, dtype=torch.float64)).to(torch.float32)
    es = [ema[n] for n in names]
    moves = torch._foreach_sub(list(ps), es)
    torch._foreach_mul_(moves, w)
    torch._foreach_add_(es, moves)


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
