"""The data-parallel group and its collectives.

Port of ``tensorflow_ocr_tpu/parallel/mesh.py:20-57``. JAX lays the
devices of one process (or of every process, after
``jax.distributed.initialize``) along a 1-D ``data`` mesh axis and lets
XLA place the arrays; the port runs one process per GPU over
``torch.distributed``, so a rank holds one device and :class:`DataGroup`
says which rank it is, how many there are, its device and its process
group:

- :func:`make_mesh` builds it from the process group that
  ``parallel/multihost.py`` ``initialize`` set up (or from none: world
  1, no collective runs, every single-device path unchanged);
- :func:`shard_batch` keeps this rank's rows of a global batch, JAX's
  ``P("data")`` split (the same global batch reaches the same shard);
  :func:`rank_rows` cuts a global batch so and passes a batch that a
  per-rank reader already cut;
- the collectives the train step runs (:meth:`DataGroup.all_reduce_`),
  the state broadcast from rank 0 (:meth:`DataGroup.broadcast_`), the
  barrier around a checkpoint written by rank 0 and the agreed stop
  flags of the trainer loop.

JAX's ``batch_sharding`` and ``replicated_sharding`` are placement
objects with no torch value: :func:`shard_batch` and the state broadcast
from rank 0 take their places.

The backend follows the device and only the device: NCCL for CUDA
tensors, gloo for CPU tensors; gloo on CUDA tensors only where the
caller asks for it by name (``initialize(backend="gloo")``), and then
nothing that a CUDA graph captures can run (gloo's CUDA path syncs with
the host).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

# the device that parallel/multihost.py initialize bound (cuda:LOCAL_RANK
# on the card, the CPU under gloo); None before it ran
_BOUND_DEVICE: Optional[torch.device] = None


def backend_for(device) -> str:
    """The process group backend of a device: ``nccl`` for a CUDA
    device, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _dist():
    import torch.distributed as dist

    return dist


def is_initialized() -> bool:
    """Whether a default process group exists (importing the port never
    makes one)."""
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


@dataclass(frozen=True)
class DataGroup:
    """One rank of the data-parallel group.

    ``group`` is the process group the collectives run over, or None
    where there is none (one process that no launcher started): then
    every collective is skipped and the step is the single-device step.
    A group of one rank still runs its collectives, so a world-1 NCCL
    group captures them into a CUDA graph as a larger world would."""

    rank: int
    world: int
    device: torch.device
    group: Any = None
    backend: Optional[str] = None

    @property
    def reduces(self) -> bool:
        """Whether the collectives run (a process group exists)."""
        return self.group is not None

    def rows(self, batch_size: int) -> slice:
        """This rank's contiguous rows of a global batch of
        ``batch_size``: ``[r·B/n, (r+1)·B/n)``."""
        if batch_size % self.world:
            raise ValueError(f"global batch {batch_size} not divisible by "
                             f"{self.world} ranks")
        b = batch_size // self.world
        return slice(self.rank * b, (self.rank + 1) * b)

    def all_reduce_(self, tensors: Sequence[torch.Tensor],
                    mean: bool = True) -> None:
        """Sum ``tensors`` over the ranks in place, as one flat
        all-reduce (one dtype, in the order given), then divide by the
        world size where ``mean``. No host sync, so a CUDA graph can
        capture it on NCCL."""
        if not self.reduces or not tensors:
            return
        flat = torch.cat([t.reshape(-1) for t in tensors])
        _dist().all_reduce(flat, group=self.group)
        if mean:
            flat.div_(self.world)
        _unflatten_into(flat, tensors)

    def mean_metrics(self, metrics: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        """The mean over the ranks of each 0-dim metric (JAX's ``pmean``),
        in one flat all-reduce of float32 values; floating metrics keep
        their dtype, others come back as float32."""
        if not self.reduces:
            return metrics
        keys = list(metrics)
        vals = [metrics[k].float().reshape(1) for k in keys]
        self.all_reduce_(vals)
        out = {}
        for k, v in zip(keys, vals):
            dt = metrics[k].dtype
            out[k] = v.reshape(()).to(dt if dt.is_floating_point
                                      else torch.float32)
        return out

    def broadcast_(self, tensors: Sequence[torch.Tensor], src: int = 0
                   ) -> None:
        """Copy rank ``src``'s values of ``tensors`` into every rank's,
        one flat broadcast per dtype."""
        if not self.reduces:
            return
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for group in by_dtype.values():
            flat = torch.cat([t.reshape(-1).to(self.device) for t in group])
            _dist().broadcast(flat, src, group=self.group)
            _unflatten_into(flat, group)

    def any_(self, *flags: bool) -> List[bool]:
        """Each flag true on any rank (an all-reduce of maxima; a host
        sync): the ranks decide alike where a decision reads the host's
        clock or a signal."""
        if not self.reduces:
            return [bool(f) for f in flags]
        t = torch.tensor([float(bool(f)) for f in flags], device=self.device)
        _dist().all_reduce(t, op=_dist().ReduceOp.MAX, group=self.group)
        return [bool(v) for v in t.tolist()]

    def barrier(self) -> None:
        """Every rank waits here for the others (a one-element all-reduce
        on the group's device, then a host sync)."""
        if not self.reduces:
            return
        t = torch.zeros(1, device=self.device)
        _dist().all_reduce(t, group=self.group)
        t.cpu()


def _unflatten_into(flat: torch.Tensor, tensors: Sequence[torch.Tensor]
                    ) -> None:
    offset = 0
    with torch.no_grad():
        for t in tensors:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view(t.shape))
            offset += n


def local_device(device=None) -> torch.device:
    """``device`` with the rank's GPU filled in: a CUDA device with no
    index is the one ``initialize`` bound (cuda:LOCAL_RANK), else it is
    left as given (the current device)."""
    device = torch.device(device if device is not None else "cuda")
    if (device.type == "cuda" and device.index is None
            and _BOUND_DEVICE is not None and _BOUND_DEVICE.type == "cuda"):
        return _BOUND_DEVICE
    return device


def make_mesh(num_devices: Optional[int] = None, device=None) -> DataGroup:
    """This rank's :class:`DataGroup` over the default process group, or
    a group of one with no collectives where none exists.

    Like JAX's ``make_mesh`` (mesh.py:23-34) a world smaller than
    ``num_devices`` is refused rather than run at reduced scale; a larger
    one is refused too, since ranks are processes, not devices to slice
    off. ``device`` (default: the card) is where the rank's tensors live;
    NCCL refuses a CPU device."""
    device = local_device(device)
    if is_initialized():
        dist = _dist()
        world, rank = dist.get_world_size(), dist.get_rank()
        group, backend = dist.group.WORLD, dist.get_backend()
    else:
        world, rank, group, backend = 1, 0, None, None
    if num_devices is not None and world != num_devices:
        raise ValueError(
            f"requested a {num_devices}-device mesh but the process group "
            f"has {world} rank(s); refusing to run at another scale "
            f"(launch {num_devices} ranks, or set num_devices=None for the "
            "whole world)")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"the NCCL process group needs a CUDA device, got "
                         f"{device}")
    return DataGroup(rank, world, device, group, backend)


def shard_batch(group: DataGroup, batch: Dict[str, Any]) -> Dict[str, Any]:
    """This rank's rows of a global batch (JAX's ``P("data")`` split):
    ``[r·B/n, (r+1)·B/n)`` of every numpy array or tensor; other entries
    (file name lists) are dropped. Refuses B not divisible by n."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, (np.ndarray, torch.Tensor)):
            out[k] = v[group.rows(v.shape[0])]
    return out


def rank_rows(group: Optional[DataGroup], batch: Dict[str, Any],
              global_batch_size: Optional[int]) -> Dict[str, Any]:
    """This rank's rows of ``batch``, cut at most once: a batch of
    ``global_batch_size`` rows is cut (:func:`shard_batch`, the file names
    too), one of ``global / world`` rows is this rank's already (a
    per-rank reader's, ``data/resumable.py``) and goes through as it is,
    any other size is refused. Without a group of several ranks the
    batch is returned as it is."""
    if group is None or group.world == 1:
        return batch
    b = len(batch["images"])
    if b == global_batch_size:
        out = shard_batch(group, batch)
        if batch.get("fns") is not None:
            out["fns"] = list(batch["fns"])[group.rows(b)]
        return out
    if b * group.world != global_batch_size:
        raise ValueError(
            f"a batch of {b} rows on rank {group.rank}: neither the global "
            f"batch {global_batch_size} nor its {group.world}-rank shard")
    return batch


def world_size() -> int:
    """The default process group's size, 1 where there is none."""
    return _dist().get_world_size() if is_initialized() else 1

