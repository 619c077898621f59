"""Train state, the train step, checkpoints, the multi-step dispatch and
the trainer loop.

Port of ``tensorflow_ocr_tpu/train/trainer.py`` for every head and loss
of the registry's models, on one device or data-parallel over
``torch.distributed`` (one process a GPU, ``parallel/``):

- :class:`TrainState`: the step count (an int64 tensor on the device,
  like JAX's ``jnp.int32`` step), the model (parameters and BN running
  statistics), the optimizer and the EMA of the parameters;
- :func:`make_loss_fn` (:95-193): the labels made on the device from the
  padded polygons at the model's output stride (PixelLink and link8:
  score, links, mask; EAST: score, RBOX or QUAD geometry, mask, from the
  shrunk polygons, fitted rectangles and angles of ``data/icdar.py``
  ``east_poly_geometry``), or taken precomputed from the batch, and the
  loss that JAX's dispatch picks for the head: OHEM, dice, positive or
  focal for PixelLink, dice for link8, the EAST loss, focal or QUAD for
  EAST;
- :func:`train_step`: forward (batch-statistics BN, or running
  statistics with ``freeze_bn``), backward, optimizer update with the
  learning rate of the step, EMA update, all on the device; the reported
  ``total_loss`` adds the L2 value of the parameters before the update;
- :func:`make_multi_train_step` (:310-376): S steps a dispatch over a
  dataset of device tensors; on the card one step is captured into a
  CUDA graph and replayed S times, the port's form of ``lax.scan``;
- checkpoints (:404-583): ``ckpt_<step>/state.pt`` under the checkpoint
  root, the data iterator's state beside it, written whole or not at
  all, async writes joined in order, pruning, strict restore, restore
  for inference, and :func:`warm_start` (:585-606);
- :class:`StallWatchdog` (:614-672) and :class:`Trainer` (:674-866,
  :985-1030): ``setup`` (seeded, given weights, resumed or warm-started),
  ``run(batches, max_steps)`` with the NaN abort, the examples/s meter,
  checkpoints on the step and time cadence (with the data iterator's
  position), summaries and SIGTERM preemption, and
  ``run_device_cached`` (:868-983) over ``data/device_cache.py``
  ``DeviceDataset``, augmented on the device inside the captured step
  when the augmentation flags are on; after each save in either loop
  the decode thresholds are calibrated on the train split
  (``_maybe_calibrate`` :701-739, ``train/calibrate.py``), and with
  ``eval_every_steps`` and ``eval.gt_path`` the eval hook
  (``train/eval_hook.py``) logs P/R/F in both loops (JAX's ``run`` has
  no eval hook).

``setup`` also warm-starts from a converted slim ImageNet ``.npz``
(``train/pretrained.py``, :770-791). Data parallel (JAX's ``shard_map``
step, :201-267, :310-376): :func:`train_step` and
:func:`make_multi_train_step` take a ``group`` (``parallel/mesh.py``
``DataGroup``) and reduce the gradients, the BN running statistics and
the metrics over it; :class:`Trainer` broadcasts the state from rank 0,
trains each rank on its rows, and leaves checkpoints, summaries, the
eval hook and calibration to rank 0.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import shutil
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from tensorflow_ocr_tpu_torch.config import Config
from tensorflow_ocr_tpu_torch.data.icdar import east_poly_geometry
from tensorflow_ocr_tpu_torch.models.detector import (
    Detector,
    build_model,
    model_head,
    model_output_stride,
)
from tensorflow_ocr_tpu_torch.models.layers import BatchNorm
from tensorflow_ocr_tpu_torch.ops import losses as L
from tensorflow_ocr_tpu_torch.ops.labels import (
    east_labels_batch,
    pixellink_labels_stride,
)
from tensorflow_ocr_tpu_torch.parallel.mesh import (
    DataGroup,
    make_mesh,
    rank_rows,
)
from tensorflow_ocr_tpu_torch.train import optim

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# the keys of a batch that the multi-step dispatch gathers (trainer.py:198)
BATCH_KEYS = ("images", "polys", "tags", "valid", "shrunk", "rects", "angles")
# precomputed label maps (data/device_cache.py DeviceDataset.labels) of
# the PixelLink and link8 heads, and of EAST
LABEL_KEYS = ("score", "link", "mask")
EAST_LABEL_KEYS = ("score", "geo", "mask")
# the losses of the pixellink head (trainer.py:127-163); link8 trains
# dice and EAST its own loss or focal, whatever the name
PIXELLINK_LOSSES = ("ohem", "dice", "positive", "focal")


def label_keys(cfg: Config) -> Tuple[str, ...]:
    """The precomputed label maps of ``cfg.model.name``'s head."""
    return (EAST_LABEL_KEYS if model_head(cfg.model.name) == "east"
            else LABEL_KEYS)


@dataclass
class TrainState:
    step: torch.Tensor  # int64, on the model's device
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
    cfg.validate()
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.train.seed)
    model = build_model(cfg.model.name, dtype=DTYPES[cfg.model.compute_dtype],
                        generator=generator,
                        bottleneck_impl=cfg.model.bottleneck_impl,
                        text_scale=cfg.model.text_scale,
                        geometry=cfg.data.geometry)
    if weights is not None:
        model.load_state_dict(weights, strict=True)
    model.to(device)
    opt = optim.make_optimizer(model, cfg.train, cfg.model.weight_decay)
    ema = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = torch.zeros((), dtype=torch.int64, device=device)
    return TrainState(step, model, opt, ema)


def make_labels_fn(cfg: Config) -> Callable:
    """labels(batch) -> the label maps of the model's head at its output
    stride: (score (B,h,w,1), link (B,h,w,8), mask (B,h,w,1)) for
    PixelLink and link8, (score, geo (B,h,w,5|9), mask) for EAST. The
    precomputed maps where the batch has them (``score``, and ``geo``
    for EAST), else made on the device from the padded polygons (and for
    EAST from ``shrunk``/``rects``/``angles``)."""
    stride = model_output_stride(cfg.model.name)
    out_hw = cfg.data.input_size // stride
    min_ts = cfg.data.min_text_size

    if model_head(cfg.model.name) == "east":
        def labels(batch):
            if "geo" in batch:  # precomputed label maps
                return batch["score"], batch["geo"], batch["mask"]
            return east_labels_batch(
                batch["polys"], batch["shrunk"], batch["rects"],
                batch["angles"], batch["tags"], batch["valid"], out_hw,
                out_hw, stride, min_ts, geometry=cfg.data.geometry)
        return labels

    def labels(batch):
        if "score" in batch:  # precomputed label maps
            return batch["score"], batch["link"], batch["mask"]
        s, l, m = pixellink_labels_stride(
            batch["polys"], batch["tags"], batch["valid"], out_hw, out_hw,
            stride, min_ts)
        return s[..., None], l, m[..., None]

    return labels


def _link_probs(link_logits: torch.Tensor) -> torch.Tensor:
    """(B,h,w,16) logits in (direction, class) pairs -> (B,h,w,8) P(link)
    (trainer.py:84-89)."""
    pairs = link_logits.reshape(*link_logits.shape[:-1], 8, 2)
    return torch.softmax(pairs, -1)[..., 1]


def make_loss_fn(cfg: Config) -> Callable:
    """loss(outputs, batch) -> (model_loss, aux): JAX's dispatch by head
    and loss (trainer.py:95-193). PixelLink: ohem, dice (on the softmax
    probabilities), positive, or focal (the pixel focal loss times
    ``pixel_loss_weight`` plus the positive loss's link term); an other
    name raises ValueError. link8: the dice loss. EAST: QUAD's loss
    (classification + ``east_geo_weight`` x geometry) whatever the name;
    RBOX: focal (binary focal classification + ``east_geo_weight`` x the
    EAST geometry term), else the EAST loss."""
    labels = make_labels_fn(cfg)
    lcfg = cfg.loss
    head = model_head(cfg.model.name)
    if head == "pixellink" and lcfg.name not in PIXELLINK_LOSSES:
        raise ValueError(f"loss {lcfg.name} unsupported for pixellink")
    # the OHEM loss's dtype, OCR_LOSS_BF16 read here and only here
    ohem_dtype = L.effective_loss_compute_dtype(lcfg.compute_dtype,
                                                lcfg.name)

    def pixellink_loss(outputs, batch):
        score, link, mask = labels(batch)
        pl, ll = outputs["pixel_logits"], outputs["link_logits"]
        if lcfg.name == "ohem":
            return L.ohem_pixel_link_loss(
                score, pl, link, ll, mask,
                max_neg_pos_ratio=lcfg.max_neg_pos_ratio,
                pixel_loss_weight=lcfg.pixel_loss_weight,
                bg_neg_budget=lcfg.bg_neg_budget,
                compute_dtype=ohem_dtype)
        if lcfg.name == "dice":
            return L.dice_pixel_link_loss(
                score, torch.softmax(pl, -1)[..., 1:2], link,
                _link_probs(ll), mask)
        if lcfg.name == "positive":
            return L.positive_pixel_link_loss(
                score, pl, link, ll,
                pixel_loss_weight=lcfg.pixel_loss_weight)
        fl = L.focal_loss(score, pl, mask, alpha=lcfg.focal_alpha,
                          gamma=lcfg.focal_gamma)
        _, aux = L.positive_pixel_link_loss(score, pl, link, ll)
        total = fl * lcfg.pixel_loss_weight + aux["link_loss"]
        return total, {"pixel_loss": fl, "link_loss": aux["link_loss"]}

    def link8_loss(outputs, batch):
        score, link, mask = labels(batch)
        return L.dice_pixel_link_loss(score, outputs["score"], link,
                                      outputs["link_probs"], mask)

    def east_loss(outputs, batch):
        score, geo, mask = labels(batch)
        if cfg.data.geometry == "QUAD":
            _, aux = L.east_quad_loss(score, outputs["score"], geo,
                                      outputs["geometry"], mask)
            return aux["cls_loss"] + aux["geo_loss"] * lcfg.east_geo_weight, \
                aux
        if lcfg.name == "focal":
            cls = L.focal_loss_binary(score, outputs["score"], mask,
                                      alpha=lcfg.focal_alpha,
                                      gamma=lcfg.focal_gamma)
            _, aux = L.east_loss(score, outputs["score"], geo,
                                 outputs["geometry"], mask,
                                 angle_weight=lcfg.east_angle_weight)
            total = cls + aux["geo_loss"] * lcfg.east_geo_weight
            return total, {"cls_loss": cls, "geo_loss": aux["geo_loss"]}
        return L.east_loss(score, outputs["score"], geo, outputs["geometry"],
                           mask, angle_weight=lcfg.east_angle_weight)

    return {"pixellink": pixellink_loss, "link8": link8_loss,
            "east": east_loss}[head]


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


def bn_buffers(model: torch.nn.Module) -> list:
    """The BN running statistics of ``model`` in module order: each
    BatchNorm's ``running_mean`` and ``running_var`` (those of ConvBN's
    BN, of the fused and ghost units, of ResNet-v2's pre-activations)."""
    out = []
    for m in model.modules():
        if isinstance(m, BatchNorm):
            out += [m.running_mean, m.running_var]
    return out


def apply_update(state: TrainState, cfg: Config) -> None:
    """The optimizer step with the learning rate of ``state.step``, the
    EMA update and the step count, from the gradients in ``.grad``."""
    optim.set_learning_rate(state.optimizer,
                            optim.make_schedule(cfg.train)(state.step))
    state.optimizer.step()
    optim.ema_update(state.ema, state.model.named_parameters(),
                     optim.ema_decay(cfg.train.moving_average_decay,
                                     state.step))
    state.step += 1


def train_step(state: TrainState, batch: Mapping[str, torch.Tensor],
               cfg: Config, loss_fn: Callable, include_l2: bool = True,
               group: Optional[DataGroup] = None) -> Dict[str, torch.Tensor]:
    """One step on the device, the state updated in place; returns the
    metrics as device scalars (no host sync): total_loss, model_loss and
    the loss's aux values. The learning rate and the EMA decay are read
    from ``state.step`` on the device. ``include_l2=False`` leaves the L2
    value out of total_loss (the multi-step dispatch adds it once).

    With a ``group`` (``parallel/mesh.py``; ``batch`` is this rank's
    shard) the step is JAX's ``shard_map`` step (trainer.py:201-267):
    after the backward one flat all-reduce of the gradients in parameter
    order, divided by the world size for ``grad_reduce="mean"`` (psum or
    pmean, :236-240); the optimizer and the EMA; one flat all-reduce
    (mean) of the BN running statistics that the forward updated from
    this rank's batch (``pmean(new_bs)``, :247: per-rank statistics, not
    synchronised BN; none under ``freeze_bn``); one flat all-reduce (mean)
    of the model loss and the aux values (:241-246, :263-264), the L2
    value added after it."""
    l2 = (optim.l2_regularization(state.model, cfg.model.weight_decay)
          if include_l2 else None)
    model_loss, aux = loss_and_grads(state.model, batch, cfg, loss_fn)
    if group is not None and group.reduces:
        group.all_reduce_([p.grad for p in state.model.parameters()
                           if p.grad is not None],
                          mean=cfg.train.grad_reduce == "mean")
    apply_update(state, cfg)
    metrics = {"model_loss": model_loss, **aux}
    if group is not None and group.reduces:
        if not cfg.model.freeze_bn:
            group.all_reduce_(bn_buffers(state.model))
        metrics = group.mean_metrics(metrics)
    model_loss = metrics["model_loss"]
    total = model_loss + l2 if include_l2 else model_loss
    return {"total_loss": total, **metrics}


def to_device(batch: Mapping[str, np.ndarray], device
              ) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in batch.items()}


def device_batch(batch: Mapping[str, Any], device, want_east: bool = False,
                 group: Optional[DataGroup] = None,
                 global_batch_size: Optional[int] = None
                 ) -> Dict[str, torch.Tensor]:
    """A host or device batch on ``device`` (trainer.py:379-396): its
    arrays (a tensor already there is not copied; the file names stay
    behind), and zero ``shrunk``/``rects``/``angles`` where an EAST
    model's batch lacks them. With a ``group`` of several ranks, a batch
    of ``global_batch_size`` rows is cut to this rank's
    (``parallel/mesh.py`` ``rank_rows``, JAX's ``P("data")``), one of
    ``global / world`` rows is taken as this rank's already, and any other
    size is refused."""
    batch = rank_rows(group, batch, global_batch_size)
    out = to_device({k: v for k, v in batch.items() if k != "fns"}, device)
    if want_east:
        b, k = out["polys"].shape[:2]
        for key, shape in (("shrunk", (b, k, 4, 2)), ("rects", (b, k, 4, 2)),
                           ("angles", (b, k))):
            if key not in out:
                out[key] = torch.zeros(shape, dtype=torch.float32,
                                       device=device)
    return out


def east_geometry(polys) -> Dict[str, torch.Tensor]:
    """``shrunk``, ``rects`` and ``angles`` of a batch's (B, K, 4, 2)
    padded polygons (host or device), from ``data/icdar.py``
    ``east_poly_geometry`` on the host, image by image; on the polygons'
    device."""
    host = polys.detach().cpu().numpy() if torch.is_tensor(polys) \
        else np.asarray(polys, np.float32)
    parts = [east_poly_geometry(p) for p in host]
    device = polys.device if torch.is_tensor(polys) else "cpu"
    return {k: torch.from_numpy(np.stack([p[i] for p in parts])).to(device)
            for i, k in enumerate(("shrunk", "rects", "angles"))}


def device_dataset(batch: Mapping[str, Any], cfg: Config, device
                   ) -> Dict[str, torch.Tensor]:
    """The dataset of :func:`make_multi_train_step` from a host or device
    batch of ``images``/``polys``/``tags``/``valid``: those on ``device``,
    the EAST keys (:func:`east_geometry` for an EAST model, zeros
    otherwise), and the label maps of the model's head precomputed on the
    device (``data/device_cache.py`` ``label_maps``, as ``DeviceDataset``
    makes them for a directory)."""
    from tensorflow_ocr_tpu_torch.data.device_cache import label_maps

    out = to_device({k: batch[k] for k in ("images", "polys", "tags",
                                           "valid")}, device)
    polys = out["polys"]
    east = model_head(cfg.model.name) == "east"
    if east:
        out.update(east_geometry(polys))
    else:
        out["shrunk"] = torch.zeros_like(polys)
        out["rects"] = torch.zeros_like(polys)
        out["angles"] = torch.zeros(polys.shape[:2], dtype=torch.float32,
                                    device=polys.device)
    out.update(label_maps(out, cfg.data, model_output_stride(cfg.model.name),
                          east))
    return out


# --------------------------------------------------------------------------
# the multi-step dispatch (trainer.py:310-376)
# --------------------------------------------------------------------------

# eager steps on a side stream before the capture: they build the kernels
# at first use and let the libraries pick their plans; their effect on the
# state is undone before the capture
WARMUP_STEPS = 2


def state_tensors(state: TrainState) -> Dict[str, Any]:
    """The state as a nested mapping of its own tensors (no copies):
    step, model (parameters and BN buffers), optimizer (each parameter's
    state, by parameter name) and ema. What a checkpoint holds."""
    opt = state.optimizer
    return {"step": state.step,
            "model": state.model.state_dict(),
            "optimizer": {n: dict(opt.state[p])
                          for n, p in state.model.named_parameters()},
            "ema": state.ema}


def flat_tree(tree: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A nested mapping of tensors (e.g. :func:`state_tensors`) as one
    mapping keyed by ``/``-joined paths."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flat_tree(v, key))
        else:
            out[key] = v
    return out


class _GraphMulti:
    """The card's multi-step dispatch: one train step captured into a
    CUDA graph that gathers its batch from the dataset by a static index
    buffer; a dispatch copies each row of ``idx`` into the buffer and
    replays. The capture is redone when the dataset's tensors change.
    The state's tensors are the graph's: restore a checkpoint into them in
    place (:func:`restore_checkpoint`), never by replacing them."""

    def __init__(self, state: TrainState, one: Callable, keys,
                 group: Optional[DataGroup] = None):
        self.state, self.one, self.keys = state, one, keys
        self.group = group
        self.graph = None
        self.key = None
        self.idx = self.out = None
        self.captures = 0

    def release(self) -> None:
        """Free the graph and its pool (the gradients live there)."""
        self.graph = self.out = self.idx = None
        self.key = None
        for p in self.state.model.parameters():
            p.grad = None

    def _capture(self, dataset, row: torch.Tensor) -> None:
        self.release()
        live = list(flat_tree(state_tensors(self.state)).values())
        saved = [t.clone() for t in live]
        self.idx = row.to(torch.int64).clone()
        if self.group is not None:
            self.group.barrier()  # the communicator exists before capture
        stream = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(stream)
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")  # a host sync cannot replay
        try:
            with torch.cuda.stream(side):
                for _ in range(WARMUP_STEPS):
                    self.one(dataset, self.idx)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        stream.wait_stream(side)
        with torch.no_grad():
            torch._foreach_copy_(live, saved)
        del saved
        for p in self.state.model.parameters():
            p.grad = None
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.out = self.one(dataset, self.idx)
        self.graph = graph
        self.captures += 1

    def __call__(self, dataset, idx: torch.Tensor) -> Dict[str, torch.Tensor]:
        device = self.state.step.device
        idx = idx.to(device)
        key = tuple((k, dataset[k].data_ptr(), tuple(dataset[k].shape))
                    for k in self.keys) + (tuple(idx.shape[1:]),)
        if self.graph is None or key != self.key:
            self._capture(dataset, idx[0])
            self.key = key
        for row in idx:
            self.idx.copy_(row)
            self.graph.replay()
        return self.out


def make_multi_train_step(state: TrainState, cfg: Config,
                          extra_keys: Sequence[str] = (),
                          augment: bool = False,
                          group: Optional[DataGroup] = None) -> Callable:
    """S train steps a dispatch over a dataset of device tensors.

    Returns ``multi(state, dataset, idx)``: ``dataset`` maps JAX's keys
    (:data:`BATCH_KEYS`, plus ``extra_keys``, e.g. the precomputed label
    maps of :func:`device_dataset`, :func:`label_keys`) to tensors on
    the state's device; ``idx`` is an (S, B) int tensor of dataset rows.
    Step s trains on ``dataset[k][idx[s]]``; the state is updated in place
    and the metrics of the last step come back, with ``total_loss`` the
    last step's model loss plus the L2 value of the parameters after the
    S steps (trainer.py:328, :358-362). ``multi`` is bound to ``state``.

    On the card one step is captured into a CUDA graph (after
    ``WARMUP_STEPS`` eager steps on a side stream, whose effect on the
    state is undone) and replayed S times; a failed capture raises, and
    nothing carries on eagerly. On the CPU the same step runs eagerly: the
    plain version. ``multi.release()`` frees the graph and its pool.

    ``augment=True`` (trainer.py:330-351): after the row gather, each step
    augments its batch on the device (``data/device_augment.py``
    ``augment_batch``, keyed by ``fold_in(fold_in(PRNGKey(seed ^ 0x5EED),
    state.step), rank)`` with the step read from the device) and makes its
    label maps from the transformed polygons; precomputed label maps
    (``extra_keys``) are refused.

    With a ``group`` (trainer.py:310-376's ``shard_map``) every rank holds
    the whole dataset and the same ``idx``, trains on its columns of it
    (``idx[:, r·B/n:(r+1)·B/n]``) and reduces as :func:`train_step` does;
    the rank is folded into the augmentation key (JAX's ``axis_index``,
    :346-347). On the card the NCCL all-reduces are captured inside the
    graph (the communicator is made by a collective before the capture);
    gloo on CUDA tensors syncs with the host, which a graph cannot
    capture, so it is refused here rather than run eagerly.
    """
    if augment and extra_keys:
        raise ValueError(
            "on-device augmentation makes the labels every step; "
            "precomputed label maps (extra_keys) cannot be used with it")
    cuda = state.step.device.type == "cuda"
    reduces = group is not None and group.reduces
    if reduces and cuda and group.backend != "nccl":
        raise ValueError(
            f"make_multi_train_step on CUDA tensors over the "
            f"{group.backend} backend: its collectives sync with the "
            "host, which a CUDA graph cannot capture, and the dispatch "
            "never runs eagerly on the card; use NCCL")
    keys = BATCH_KEYS + tuple(extra_keys)
    loss_fn = make_loss_fn(cfg)
    rank = group.rank if reduces else 0
    if augment:
        from tensorflow_ocr_tpu_torch.data import device_augment as DA

        want_east = model_head(cfg.model.name) == "east"
        # made once, outside any capture: the graph folds in the step
        base_key = DA.prng_key(cfg.train.seed ^ DA.SEED_SALT,
                               state.step.device)

    def one(dataset, row):
        batch = {k: dataset[k][row] for k in keys}
        if augment:
            key = DA.fold_in(DA.fold_in(base_key, state.step), rank)
            batch = DA.augment_batch(key, batch, cfg.data, want_east)
        return train_step(state, batch, cfg, loss_fn, include_l2=False,
                          group=group)

    graph = _GraphMulti(state, one, keys, group if reduces else None) \
        if cuda else None

    def multi(st: TrainState, dataset: Mapping[str, torch.Tensor],
              idx: torch.Tensor) -> Dict[str, torch.Tensor]:
        if st is not state:
            raise ValueError("multi runs the state it was made for")
        if reduces:
            idx = idx[:, group.rows(idx.shape[1])]
        if graph is not None:
            last = graph(dataset, idx)
        else:
            for row in idx:
                last = one(dataset, row)
        out = {k: v.clone() for k, v in last.items()}
        out["total_loss"] = out["total_loss"] + optim.l2_regularization(
            state.model, cfg.model.weight_decay)
        return out

    multi.graph = graph
    multi.release = graph.release if graph is not None else (lambda: None)
    return multi


# --------------------------------------------------------------------------
# checkpoints (trainer.py:404-583)
# --------------------------------------------------------------------------

CKPT_FILE = "state.pt"
DATA_ITER_STATE_FILE = "grain_iter_state.bin"

_PENDING_SAVE: Optional[threading.Thread] = None
_PENDING_SAVE_ERROR: Optional[BaseException] = None


def _ckpt_dir(path: str, step: int) -> str:
    return os.path.join(os.path.abspath(path), f"ckpt_{step}")


def _ckpt_steps(path: str):
    if not os.path.isdir(path):
        return []
    steps = []
    for name in os.listdir(path):
        if name.startswith("ckpt_"):
            try:
                steps.append(int(name.split("_")[1]))
            except ValueError:
                continue
    return sorted(steps)


def wait_for_pending_save() -> None:
    """Join the in-flight async checkpoint write, if any; re-raise what
    the writer hit, so a failed async save cannot pass for a success."""
    global _PENDING_SAVE, _PENDING_SAVE_ERROR
    if _PENDING_SAVE is not None:
        _PENDING_SAVE.join()
        _PENDING_SAVE = None
    if _PENDING_SAVE_ERROR is not None:
        err, _PENDING_SAVE_ERROR = _PENDING_SAVE_ERROR, None
        raise RuntimeError("async checkpoint write failed") from err


def prune_checkpoints(path: str, max_to_keep: int) -> list:
    """Delete the oldest ``ckpt_*`` dirs beyond ``max_to_keep`` (by step;
    0 keeps all). Returns the removed directory paths."""
    if not max_to_keep:
        return []
    removed = []
    for s in _ckpt_steps(path)[:-max_to_keep]:
        d = _ckpt_dir(path, s)
        shutil.rmtree(d, ignore_errors=True)
        removed.append(d)
    return removed


def _to_host(tree):
    """A copy of every tensor of ``tree`` on the host (a sync)."""
    if isinstance(tree, Mapping):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree.detach().to("cpu", copy=True)


def write_checkpoint(path: str, tree: Mapping, iter_state: Optional[bytes]
                     = None, max_to_keep: int = 0) -> str:
    """Write a host state ``tree`` (the mapping of :func:`state_tensors`)
    to ``<path>/ckpt_<step>/`` and prune to ``max_to_keep``: the file goes
    into a temporary directory under ``path`` that is then renamed, so a
    reader never sees half a checkpoint. Returns the directory."""
    d = _ckpt_dir(path, int(tree["step"]))
    root = os.path.abspath(path)
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f".{os.path.basename(d)}.", dir=root)
    try:
        torch.save(tree, os.path.join(tmp, CKPT_FILE))
        if iter_state is not None:
            with open(os.path.join(tmp, DATA_ITER_STATE_FILE), "wb") as f:
                f.write(iter_state)
        if os.path.isdir(d):  # a checkpoint of this step is replaced
            shutil.rmtree(d)
        os.replace(tmp, d)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    prune_checkpoints(path, max_to_keep)
    return d


def save_checkpoint(path: str, state: TrainState, data_iter=None,
                    block: bool = True, max_to_keep: int = 0) -> str:
    """Save the state to ``<path>/ckpt_<step>/state.pt``
    (:func:`write_checkpoint`), and the data position beside it where
    ``data_iter`` has ``get_state()``.

    The state is copied to the host before this returns (the next step
    updates the device tensors in place). ``block=False`` writes on a
    non-daemon thread; saves are strictly ordered (a new one joins the
    previous first), and :func:`wait_for_pending_save` joins the last and
    re-raises its error.
    """
    host = _to_host(state_tensors(state))
    d = _ckpt_dir(path, int(host["step"]))
    iter_state = (data_iter.get_state()
                  if data_iter is not None and hasattr(data_iter, "get_state")
                  else None)

    def write():
        write_checkpoint(path, host, iter_state, max_to_keep)

    def write_async():
        global _PENDING_SAVE_ERROR
        try:
            write()
        except BaseException as e:  # surfaced by wait_for_pending_save()
            logging.getLogger(__name__).exception(
                "async checkpoint write to %s failed", d)
            _PENDING_SAVE_ERROR = e

    wait_for_pending_save()
    if block:
        write()
    else:
        global _PENDING_SAVE
        _PENDING_SAVE = threading.Thread(
            target=write_async, daemon=False, name="ckpt-writer")
        _PENDING_SAVE.start()
    return d


def restore_data_iter(ckpt_dir: str, data_iter) -> bool:
    """Restore a data iterator's position (its ``set_state``), if saved."""
    p = os.path.join(ckpt_dir, DATA_ITER_STATE_FILE)
    if data_iter is None or not hasattr(data_iter, "set_state"):
        return False
    if not os.path.exists(p):
        return False
    with open(p, "rb") as f:
        data_iter.set_state(f.read())
    return True


def latest_checkpoint(path: str) -> Optional[str]:
    steps = _ckpt_steps(path)
    return _ckpt_dir(path, steps[-1]) if steps else None


def load_checkpoint(ckpt_dir: str, device="cpu", mmap: bool = False) -> dict:
    """The nested mapping :func:`save_checkpoint` wrote (tensors only:
    ``weights_only``). ``mmap`` maps the file and reads a tensor's bytes
    only where it is used."""
    return torch.load(os.path.join(ckpt_dir, CKPT_FILE), map_location=device,
                      weights_only=True, mmap=mmap)


def _copy_into(live: Mapping, saved: Mapping, where: str = "") -> None:
    """Copy ``saved`` into the tensors of ``live`` in place; raises on a
    missing key, an extra key or a shape that differs."""
    missing = sorted(set(live) - set(saved))
    extra = sorted(set(saved) - set(live))
    if missing or extra:
        raise KeyError(f"checkpoint {where or 'state'}: missing {missing}, "
                       f"unexpected {extra}")
    for k, t in live.items():
        name = f"{where}/{k}" if where else str(k)
        if isinstance(t, Mapping):
            if not isinstance(saved[k], Mapping):
                raise KeyError(f"checkpoint {name}: not a mapping")
            _copy_into(t, saved[k], name)
            continue
        s = saved[k]
        if not isinstance(s, torch.Tensor) or s.shape != t.shape:
            raise ValueError(f"checkpoint {name}: shape "
                             f"{tuple(getattr(s, 'shape', ()))} where the "
                             f"state has {tuple(t.shape)}")
        with torch.no_grad():
            t.copy_(s)


def restore_checkpoint(path: str, template: TrainState) -> TrainState:
    """Restore a checkpoint directory into ``template`` in place (so a
    captured graph keeps its tensors) and return it. Strict: a missing
    key, an extra key or a shape mismatch raises."""
    saved = load_checkpoint(path, template.step.device)
    _copy_into(state_tensors(template), saved)
    return template


def load_inference_state(path: str) -> dict:
    """``{step, model, ema}`` of a checkpoint directory, on the host; the
    optimizer's state is never read (the file is memory-mapped)."""
    saved = load_checkpoint(path, "cpu", mmap=True)
    return {k: saved[k] for k in ("step", "model", "ema")}


def restore_checkpoint_for_inference(path: str, template: TrainState
                                     ) -> TrainState:
    """Restore only what inference needs (step, parameters, BN buffers and
    EMA) into ``template``; the optimizer's state is left as it is and
    never read, so a checkpoint stays loadable across optimizer changes."""
    saved = load_inference_state(path)
    live = state_tensors(template)
    _copy_into({k: live[k] for k in saved}, saved)
    return template


def warm_start(params: Mapping[str, torch.Tensor],
               pretrained: Mapping[str, torch.Tensor],
               exclude_scopes: Sequence[str] = ()
               ) -> Tuple[Dict[str, torch.Tensor], int]:
    """Merge the pretrained tensors whose name and shape match (the
    ``ignore_missing_vars`` semantics, multigpu_train.py:149-151);
    ``exclude_scopes`` skips every tensor under a module of that name (a
    component of its dotted name, e.g. the ``head``). Returns the merged
    mapping and the count of tensors taken."""
    out, n = {}, 0
    for name, t in params.items():
        pre = pretrained.get(name)
        if (not set(name.split(".")) & set(exclude_scopes)
                and pre is not None and pre.shape == t.shape):
            out[name] = pre.to(dtype=t.dtype)
            n += 1
        else:
            out[name] = t
    return out, n


# --------------------------------------------------------------------------
# the trainer loop
# --------------------------------------------------------------------------


class StallWatchdog:
    """Prints when no train step completes within ``interval_s`` seconds.

    A hung launch or a dead input pipeline blocks the train loop inside a
    sync with no Python traceback. Blocked CUDA syncs release the GIL, so
    a daemon thread can still report. Diagnostic only: it never kills
    anything. Repeated warnings back off linearly (1x, 2x, 3x the
    interval)."""

    def __init__(self, interval_s: float, name: str = "train"):
        self.interval = float(interval_s or 0)
        self.name = name
        self._last = time.time()
        self._last_step = -1
        self._warned = 0
        self._stop = threading.Event()
        self._thread = None
        if self.interval > 0:
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name=f"stall-watchdog-{name}")
            self._thread.start()

    def beat(self, step: int):
        self._last = time.time()
        self._last_step = step
        self._warned = 0

    def _loop(self):
        poll = min(self.interval, 30.0)
        while not self._stop.wait(poll):
            idle = time.time() - self._last
            if idle > self.interval * (self._warned + 1):
                self._warned += 1
                if self._last_step < 0:
                    # before the first heartbeat the likeliest causes are
                    # the kernels' nvcc builds at first use and a CUDA
                    # graph's warm-up and capture
                    print(
                        f"[watchdog:{self.name}] first step not complete "
                        f"after {idle:.0f}s — the nvcc build of the kernels "
                        f"at first use or the CUDA-graph capture in "
                        f"progress, or the card is hung", flush=True)
                else:
                    print(
                        f"[watchdog:{self.name}] no step completed for "
                        f"{idle:.0f}s (last step {self._last_step}; "
                        f"heartbeats fire every log window); a kernel or "
                        f"the input pipeline may be hung", flush=True)

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)


class Trainer:
    """The train loop (trainer.py:674-866) on one device (the card unless
    the caller asks for the CPU; raises when there is no card): NaN abort,
    an examples/s meter every ``cfg.train.log_every_steps`` steps,
    checkpoints on the step and time cadence, scalar and image summaries
    to ``summary_writer``, the stall watchdog, and SIGTERM preemption
    (a checkpoint, then a clean stop) once
    :meth:`install_preemption_handler` has run.

    Data parallel (trainer.py:680-683, :897-901): ``group``
    (``parallel/mesh.py``; by default ``make_mesh(cfg.train.num_devices)``
    over the process group, if any, which refuses a world of another
    size) is this rank. The state is broadcast from rank 0 after
    :meth:`setup` (and so after a restore); each step trains on the
    rank's rows of the global batch that every rank's loader draws alike
    and reduces as :func:`train_step` does; rank 0 alone writes
    checkpoints (the others wait at a barrier), summaries, the eval hook
    and calibration, and prints; the ranks agree on the time cadence and
    on a preemption flag at each check, so all stop at the same step; the
    examples/s are the whole world's (JAX :978)."""

    def __init__(self, cfg: Config, device="cuda", summary_writer=None,
                 install_signal_handler: bool = False,
                 group: Optional[DataGroup] = None):
        self.cfg = cfg
        device = require_device(device, "Trainer")
        if group is None:
            group = make_mesh(cfg.train.num_devices, device)
        elif group.device.type != device.type:
            raise ValueError(f"Trainer(device={device}) with a group on "
                             f"{group.device}")
        self.group = group
        self.device = group.device
        self.chief = group.rank == 0
        self.state: Optional[TrainState] = None
        self.loss_fn = make_loss_fn(cfg)
        self.want_east = model_head(cfg.model.name) == "east"
        self.summary_writer = summary_writer if self.chief else None
        self._preempted = False
        self._restored_from: Optional[str] = None
        self.eval_hook = None
        if cfg.train.eval_every_steps and cfg.eval.gt_path and self.chief:
            from tensorflow_ocr_tpu_torch.train.eval_hook import (
                EvalDuringTraining,
            )

            self.eval_hook = EvalDuringTraining(cfg, cfg.eval.gt_path)
        self._calib_hook = None  # built at the first checkpoint save
        if install_signal_handler:
            self.install_preemption_handler()

    def _maybe_calibrate(self) -> Optional[Dict[str, float]]:
        """Checkpoint-time calibration (trainer.py:701-739): sweep the
        decode thresholds on ``calibrate_max_images`` images of the train
        split and write ``operating_point.json`` at the checkpoint root,
        which the Predictor adopts. Returns the operating point, or None
        where calibration is off, finds no image, or fails: a failure is
        logged as a warning and never stops training, as in JAX."""
        tcfg = self.cfg.train
        if not tcfg.calibrate_at_checkpoint or not self.chief:
            return None
        try:
            from tensorflow_ocr_tpu_torch.train.calibrate import (
                calibrate_and_store,
            )
            from tensorflow_ocr_tpu_torch.train.eval_hook import (
                EvalDuringTraining,
            )

            path = self.cfg.data.training_data_path
            if self._calib_hook is None:
                self._calib_hook = EvalDuringTraining(
                    self.cfg, path, max_images=tcfg.calibrate_max_images)
            if self._calib_hook.images is None:
                return None
            op = calibrate_and_store(self.state.model, self.state, self.cfg,
                                     path, tcfg.checkpoint_path,
                                     hook=self._calib_hook)
            if op:
                print(f"calibrated decode thresholds @ step "
                      f"{int(self.state.step)}: {op}")
            return op
        except Exception as e:  # calibration never stops training
            logging.getLogger(__name__).warning(
                "threshold calibration failed: %s: %s", type(e).__name__, e,
                exc_info=True)
            return None

    def _maybe_eval(self, step: int, every: int) -> None:
        """The eval hook's P/R/F at ``step``, printed and written to the
        summary writer as ``val/precision``, ``val/recall``,
        ``val/fmean``, where ``every`` (0: never) divides ``step``."""
        if self.eval_hook is None or not every or step % every:
            return
        r = self.eval_hook(self.state.model, self.state)
        if not r:
            return
        print(f"eval @ step {step}: P {r['precision']:.3f} R "
              f"{r['recall']:.3f} F {r['fmean']:.3f}")
        if self.summary_writer is not None:
            for k in ("precision", "recall", "fmean"):
                self.summary_writer.add_scalar(f"val/{k}", r[k], step)

    def install_preemption_handler(self):
        import signal

        def handler(signum, frame):
            self._preempted = True

        signal.signal(signal.SIGTERM, handler)

    def _log(self, msg: str) -> None:
        if self.chief:
            print(msg)

    def save(self, data_iter=None, block: bool = True,
             max_to_keep: int = 0) -> Optional[str]:
        """:func:`save_checkpoint` of the state to
        ``train.checkpoint_path`` by rank 0; every rank waits at a barrier
        until it has the state on the host. Returns the directory (None on
        the other ranks)."""
        path = None
        if self.chief:
            path = save_checkpoint(self.cfg.train.checkpoint_path,
                                   self.state, data_iter, block=block,
                                   max_to_keep=max_to_keep)
        self.group.barrier()
        return path

    def _agree(self, time_due: bool) -> bool:
        """Whether the time cadence is due, alike on every rank: rank 0's
        clock decides; and the preemption flag set on every rank where it
        is set on any, so all stop at the same step (one all-reduce where
        there are several ranks)."""
        if self.group.world == 1:
            return bool(time_due)
        due, self._preempted = self.group.any_(time_due and self.chief,
                                               self._preempted)
        return due

    def _maybe_handle_preemption(self, data_iter=None) -> bool:
        if self._preempted:
            path = self.save(data_iter)
            self._log(f"preempted: checkpoint saved to {path}")
            return True
        return False

    def setup(self, weights: Optional[Mapping[str, torch.Tensor]] = None,
              generator: Optional[torch.Generator] = None) -> TrainState:
        """The state of ``cfg``; with ``train.restore``, the newest
        checkpoint of ``train.checkpoint_path`` restored into it; else,
        with ``train.pretrained_model_path``, a warm start from that port
        checkpoint (tensors of matching name and shape, the BN running
        statistics included) or, for a path ending in ``.npz``, from a
        converted slim ImageNet checkpoint (:meth:`_import_slim`)."""
        self.state = create_train_state(self.cfg, self.device, generator,
                                        weights)
        self._setup_weights()
        # every rank starts from rank 0's state
        self.group.broadcast_(list(flat_tree(state_tensors(
            self.state)).values()))
        return self.state

    def _setup_weights(self) -> None:
        tcfg = self.cfg.train
        if tcfg.restore:
            wait_for_pending_save()  # this process's own last save, whole
            self.group.barrier()  # and rank 0's
            ck = latest_checkpoint(tcfg.checkpoint_path)
            if ck:
                restore_checkpoint(ck, self.state)
                self._restored_from = ck
                self._log(f"restored from {ck} at step "
                          f"{int(self.state.step)}")
        elif tcfg.pretrained_model_path:
            path = tcfg.pretrained_model_path
            if path.endswith(".npz"):
                self._import_slim(path)
                return
            pre = load_checkpoint(latest_checkpoint(path) or path,
                                  self.device)["model"]
            live = self.state.model.state_dict()
            params = dict(self.state.model.named_parameters())
            merged, n = warm_start(params, pre)
            # the running BN statistics come along: the freeze_bn
            # fine-tune normalises with them
            buffers, _ = warm_start({k: v for k, v in live.items()
                                     if k not in params}, pre)
            with torch.no_grad():
                for name, t in {**merged, **buffers}.items():
                    live[name].copy_(t)
            self._log(f"warm-started {n} tensors from {path}")

    def _import_slim(self, path: str) -> int:
        """The backbone of a converted slim ImageNet ``.npz``
        (``train/pretrained.py``) copied into the state's model, its BN
        running statistics included, and the EMA reset to the new
        parameters (trainer.py:770-791); returns the count taken."""
        from tensorflow_ocr_tpu_torch.train.pretrained import import_backbone

        model = self.state.model
        merged, n = import_backbone(model, path)
        live = model.state_dict()
        with torch.no_grad():
            for name, t in merged.items():
                live[name].copy_(t)
            for name, p in model.named_parameters():
                self.state.ema[name].copy_(p)
        self._log(f"warm-started {n} tensors from {path}")
        return n

    def run(self, batches, max_steps: Optional[int] = None
            ) -> Dict[str, float]:
        """Train on ``batches`` (an iterator, or a sequence indexed by
        step) for ``max_steps`` steps; returns the last logged metrics.
        Each batch is the global batch, or this rank's rows of it (a
        ``DevicePrefetcher`` given the group): :func:`device_batch`."""
        cfg = self.cfg.train
        max_steps = max_steps or cfg.max_steps
        if self._restored_from is not None:
            if restore_data_iter(self._restored_from, batches):
                self._log(f"data iterator resumed from "
                          f"{self._restored_from}")
            self._restored_from = None
        window = cfg.log_every_steps
        last: Dict[str, float] = {}
        last_log_step = -1  # the first window holds a single step
        last_save_t = time.time()
        dog = StallWatchdog(cfg.stall_warn_secs)
        t0 = time.perf_counter()
        try:
            for step in range(max_steps):
                batch = (next(batches) if hasattr(batches, "__next__")
                         else batches[step])
                db = device_batch(batch, self.device, self.want_east,
                                  self.group, self.cfg.data.batch_size)
                metrics = train_step(self.state, db, self.cfg, self.loss_fn,
                                     group=self.group)
                if step % window == 0:
                    last = {k: float(v) for k, v in metrics.items()}  # syncs
                    dog.beat(step)
                    if math.isnan(last["total_loss"]):
                        self._log("Loss diverged, stop training")
                        break
                    dt = time.perf_counter() - t0
                    t0 = time.perf_counter()
                    n_steps, last_log_step = step - last_log_step, step
                    n_img = (db["images"].shape[0] * self.group.world
                             * n_steps)
                    self._log(f"Step {step:06d}, model loss "
                              f"{last['model_loss']:.4f}, total loss "
                              f"{last['total_loss']:.4f}, "
                              f"{dt / n_steps:.3f} s/step, "
                              f"{n_img / dt:.1f} examples/s")
                    if self.summary_writer is not None:
                        for k, v in last.items():
                            self.summary_writer.add_scalar(k, v, step)
                if (self.summary_writer is not None
                        and cfg.save_summary_steps
                        and step % cfg.save_summary_steps == 0
                        and hasattr(self.summary_writer,
                                    "add_detection_summaries")):
                    self._emit_image_summaries(db, step)
                step_due = (cfg.save_checkpoint_steps and step > 0
                            and step % cfg.save_checkpoint_steps == 0)
                time_due = self._agree(
                    cfg.save_interval_secs and time.time() - last_save_t
                    >= cfg.save_interval_secs)
                if step_due or time_due:
                    self.save(batches, block=False,
                              max_to_keep=cfg.max_checkpoints_to_keep)
                    last_save_t = time.time()
                    self._maybe_calibrate()
                if step > 0:
                    self._maybe_eval(step, cfg.eval_every_steps)
                if self._maybe_handle_preemption(batches):
                    break
        finally:
            dog.stop()
            wait_for_pending_save()
        self.group.barrier()  # rank 0's checkpoints are whole on return
        return last

    def run_device_cached(self, max_steps: Optional[int] = None
                          ) -> Dict[str, float]:
        """Train over the dataset of ``cfg.data.training_data_path`` staged
        on the device (``data/device_cache.py`` ``DeviceDataset``),
        ``cfg.train.scan_steps`` steps a :func:`make_multi_train_step`
        dispatch; the host only draws the shuffled rows
        (``index_batches`` from ``RandomState(seed)``). With any of
        ``use_crop``, ``use_rotate`` or ``use_random_scale`` the frames are
        staged unaugmented and each step augments on the device and makes
        its labels there; otherwise the labels are precomputed at staging.
        The last metrics come back with ``images_per_sec_steady`` (the
        median dispatch after the first, which pays the capture)."""
        from tensorflow_ocr_tpu_torch.data.device_cache import DeviceDataset

        cfg = self.cfg
        augment = bool(cfg.data.use_crop or cfg.data.use_rotate
                       or cfg.data.use_random_scale)
        stage_cfg = cfg.data
        if augment:  # the staging must not consume the augmentation flags
            stage_cfg = dataclasses.replace(
                cfg.data, use_crop=False, use_rotate=False,
                use_random_scale=False)
        ds = DeviceDataset(stage_cfg, want_east=self.want_east,
                           precompute_labels=not augment,
                           label_stride=model_output_stride(cfg.model.name),
                           device=self.device)
        if self.state is None:
            self.setup()
        data = ds.arrays()
        multi = make_multi_train_step(self.state, cfg,
                                      extra_keys=tuple(ds.labels),
                                      augment=augment, group=self.group)
        rng = np.random.RandomState(cfg.train.seed)
        max_steps = max_steps or cfg.train.max_steps
        dog = StallWatchdog(cfg.train.stall_warn_secs, name="scan")
        try:
            last = self._device_cached_loop(ds, data, multi, rng,
                                            max_steps, dog)
        finally:
            dog.stop()
            multi.release()
            wait_for_pending_save()
        self.group.barrier()  # rank 0's checkpoints are whole on return
        return last

    def _device_cached_loop(self, ds, data, multi, rng, max_steps, dog
                            ) -> Dict[str, float]:
        tcfg = self.cfg.train
        s, batch = tcfg.scan_steps, self.cfg.data.batch_size
        last: Dict[str, float] = {}
        last_save_t = time.time()
        step = 0
        dispatch_dts = []  # dispatch walls after the first (the capture)
        while step < max_steps:
            t0 = time.perf_counter()  # index draw + dispatch + sync only
            idx = torch.from_numpy(ds.index_batches(batch, s, rng))
            metrics = multi(self.state, data, idx.to(self.device))
            step += s
            last = {k: float(v) for k, v in metrics.items()}  # syncs
            dog.beat(step)
            if math.isnan(last.get("total_loss", 0.0)):
                self._log("Loss diverged, stop training")
                break
            dt = time.perf_counter() - t0
            if step > s:
                dispatch_dts.append(dt)
            # batch is the global batch: the whole world's examples/s
            self._log(f"Step {step:06d}, model loss "
                      f"{last.get('model_loss', 0):.4f}, total loss "
                      f"{last.get('total_loss', 0):.4f}, {dt / s:.4f} "
                      f"s/step, {s * batch / dt:.1f} examples/s")
            if self.summary_writer is not None:
                for k, v in last.items():
                    self.summary_writer.add_scalar(k, v, step)
            step_due = (tcfg.save_checkpoint_steps
                        and step % max(tcfg.save_checkpoint_steps, s) == 0)
            time_due = self._agree(
                tcfg.save_interval_secs and time.time() - last_save_t
                >= tcfg.save_interval_secs)
            if step_due or time_due:
                self.save(block=False,
                          max_to_keep=tcfg.max_checkpoints_to_keep)
                last_save_t = time.time()
                self._maybe_calibrate()
            if tcfg.eval_every_steps:  # at most once a dispatch
                self._maybe_eval(step, max(tcfg.eval_every_steps, s))
            if self._maybe_handle_preemption():
                break
        if dispatch_dts:
            last["images_per_sec_steady"] = (
                s * batch / float(np.median(dispatch_dts)))
        return last

    def _emit_image_summaries(self, batch, step: int):
        """The reference's image panel (multigpu_train.py:50-63): input
        frame, label score map and predicted score map of the first image.
        Never allowed to stop training."""
        try:
            img = batch["images"][:1]
            with torch.no_grad():
                out = self.state.model(img, train=False)
            if "pixel_logits" in out:
                pred = torch.softmax(out["pixel_logits"].float(), -1)[..., 1:]
            else:
                pred = out["score"]
            score = make_labels_fn(self.cfg)(
                {k: v[:1] for k, v in batch.items()})[0]
            self.summary_writer.add_detection_summaries(
                step, images=img.float().cpu().numpy(),
                gt_score=score.float().cpu().numpy(),
                pred_score=pred.cpu().numpy())
        except Exception as e:  # observability must never stop training
            logging.getLogger(__name__).warning(
                "image summaries failed at step %d: %s: %s",
                step, type(e).__name__, e)
