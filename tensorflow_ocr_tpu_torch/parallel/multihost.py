"""Process-group start-up and per-rank batches across hosts.

Port of ``tensorflow_ocr_tpu/parallel/multihost.py:28-82``. JAX joins
hosts with ``jax.distributed.initialize`` and assembles global arrays
from per-host batches; the port runs one process per GPU, on one host or
many, joined by ``torch.distributed``:

    # on every rank, e.g. under
    # python -m torch.distributed.run --nproc_per_node=8 ...
    from tensorflow_ocr_tpu_torch.parallel import multihost, make_mesh
    multihost.initialize()           # torchrun's env, or explicit args
    group = make_mesh()              # this rank of the whole world
    local = multihost.global_batch_from_local(group, local_batch, 224)

A rank's batch is its shard of the global batch: nothing is gathered.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from tensorflow_ocr_tpu_torch.parallel import mesh as M


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None, device="cuda",
               backend: Optional[str] = None,
               timeout_s: float = 600.0) -> bool:
    """Start the default process group; returns whether one exists.

    Reads torchrun's environment (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) or takes explicit
    arguments (``init_method`` such as ``tcp://host:port`` or
    ``file:///shared/path``). Idempotent: a second call returns at once.
    With nothing set it is a single-process run and starts nothing, as
    JAX's auto-detection finds no cluster (multihost.py:52-60); a launch
    that sets the environment or passes arguments and fails raises.

    The backend follows ``device``: NCCL for the card, with the rank
    bound to ``cuda:LOCAL_RANK`` and its communicator made now; gloo for
    the CPU. ``backend="gloo"`` with a CUDA device is taken only when
    asked for by name (eager steps only: gloo syncs with the host)."""
    if M.is_initialized():
        return True
    env = os.environ
    explicit = (init_method is not None or world_size is not None
                or rank is not None)
    if not explicit and "WORLD_SIZE" not in env:
        return False
    import torch.distributed as dist

    world_size = int(env["WORLD_SIZE"]) if world_size is None else world_size
    rank = int(env["RANK"]) if rank is None else rank
    device = torch.device(device)
    backend = backend or M.backend_for(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("NCCL needs a CUDA device; the CPU takes gloo")
    device_id = None
    if device.type == "cuda":
        local = int(env.get("LOCAL_RANK", rank))
        if device.index is not None:
            local = device.index
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
        if backend == "nccl":
            device_id = device
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        world_size=world_size, rank=rank, device_id=device_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    M._BOUND_DEVICE = device
    return True


def local_batch_size(global_batch_size: int) -> int:
    """The rows of a global batch that one rank trains on."""
    n = M.world_size()
    if global_batch_size % n:
        raise ValueError(f"global batch {global_batch_size} not divisible "
                         f"by {n} ranks")
    return global_batch_size // n


def global_batch_from_local(group: M.DataGroup, local_batch: Dict[str, Any],
                            global_batch_size: int) -> Dict[str, Any]:
    """The rank's part of a global batch from the batch it loaded itself
    (JAX's ``make_array_from_process_local_data``, multihost.py:70-82):
    each array must hold ``global / world`` rows; it is placed on the
    rank's device. Non-arrays are dropped."""
    want = global_batch_size // group.world
    if global_batch_size % group.world:
        raise ValueError(f"global batch {global_batch_size} not divisible "
                         f"by {group.world} ranks")
    out = {}
    for k, v in local_batch.items():
        if not isinstance(v, (np.ndarray, torch.Tensor)):
            continue
        if v.shape[0] != want:
            raise ValueError(f"{k}: {v.shape[0]} rows on rank {group.rank}; "
                             f"a global batch of {global_batch_size} over "
                             f"{group.world} ranks gives each {want}")
        out[k] = torch.as_tensor(v).to(group.device)
    return out
