"""Serving sharded on image height, with the halo rows exchanged.

Port of ``tensorflow_ocr_tpu/parallel/spatial.py:20-92``. JAX splits the
image's H axis over a ``space`` mesh axis (and the batch over ``data``
in the 2-D layout) and lets GSPMD insert the halo exchanges of every
conv and pool. The port runs one process per GPU: each rank holds its
rows of the image, the eval model (BN folded) runs on them, and every
op that reads across a shard's edge fetches those rows from the ranks
that own them (NCCL ``batch_isend_irecv`` on the card, gloo
send/recv on the CPU). The output maps are then all-gathered, so every
rank holds them whole (JAX replicates its outputs, spatial.py:63-64),
and a :class:`~tensorflow_ocr_tpu_torch.infer.Predictor` decodes them
with the CC kernel as it decodes its own (:func:`spatial_predictor`).

The ops that read across rows (``models/layers.py``): ConvBN (the
slim ``conv2d_same`` 7x7/2 and 3x3/2 of the ResNet included), the stem
max-pool, the bilinear unpool, VGG's max-pools and convs (``fc6``'s 3x3
at dilation 6), ResNet-v2's convs, the ghost unit's eval 3x3, and
through ConvBN the EAST merge's 3x3s. Each derives its halo from the
output rows its shard owns: rows ``[o0·s - top, (o1-1)·s - top + k)``
of the input for outputs ``[o0, o1)`` of a k-row window at stride s
with the whole image's pads (top, bottom); zero, -inf or edge rows fill
only past the image's top and bottom. A halo may span several ranks
(``fc6`` at stride 16 of a 128-row image over 4 ranks: 2 rows a shard,
6 needed each side).

The image's height must be a multiple of 32·space (spatial.py:77, :89),
so every level up to stride 32 splits evenly. The kernel arms serve
sharded too (``bottleneck_impl`` "fused" and "ghost", the
``PALLAS_CONVS`` route, bfloat16 and float32), with every kernel run on
its shard's rows: JAX's GSPMD gathers a ``pallas_call``'s operands and
runs it whole, the port computes the same function without a gather.
Row-local kernels (1x1 convs, the fused boundary) take the shard as it
is. A kernel that pads a stride-1 3x3 itself (the fused 3x3, the
route's 3x3) takes the shard's rows extended by one halo row each side
(:meth:`HaloRows.halo`) and its output is cropped to the shard's rows:
the halo rows are real rows, so the fused prologue relu(x·a + b) sees
them as on the whole image, and the kernel's own zero fill lands only
past the image or on rows the crop drops. Decisions JAX takes from the
global shape (the route's ``supported``, the ghost unit's band) are
taken from the whole image's (``models/layers.py`` ``full_height``,
``full_batch``), so every shard runs the convs and units the whole
image runs. Serving only: a train step sharded on H is not in the JAX
package either.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from tensorflow_ocr_tpu_torch.models import layers
from tensorflow_ocr_tpu_torch.parallel import mesh as M


@dataclass(frozen=True)
class SpatialMesh:
    """This rank's place in a (data, space) grid of ranks, space the
    fastest-varying: global rank = d·space + s. ``space_ranks`` and
    ``data_ranks`` are the global ranks of its row and its column;
    ``space_group``/``data_group`` their process groups (None where
    there is no process group, or the axis has one rank)."""

    data: int
    space: int
    data_index: int
    space_index: int
    space_ranks: Tuple[int, ...]
    data_ranks: Tuple[int, ...]
    device: torch.device
    space_group: Any = None
    data_group: Any = None


def _groups_of(data: int, space: int, device) -> SpatialMesh:
    device = M.local_device(device)
    world = M.world_size()
    if world != data * space:
        raise ValueError(f"a {data}x{space} (data, space) mesh needs "
                         f"{data * space} ranks, the world has {world}")
    rank = M._dist().get_rank() if M.is_initialized() else 0
    d, s = divmod(rank, space)
    rows = [tuple(r * space + c for c in range(space)) for r in range(data)]
    cols = [tuple(r * space + c for r in range(data)) for c in range(space)]
    space_group = data_group = None
    if M.is_initialized():
        dist = M._dist()
        # every rank makes every group, in the same order
        made_rows = [dist.new_group(list(r)) for r in rows]
        made_cols = [dist.new_group(list(c)) for c in cols]
        space_group, data_group = made_rows[d], made_cols[s]
        # the first call on a group involves all its ranks (NCCL's rule
        # for batch_isend_irecv)
        for g in (space_group, data_group):
            t = torch.zeros(1, device=device)
            dist.all_reduce(t, group=g)
        t.cpu()
    return SpatialMesh(data, space, d, s, rows[d], cols[s], device,
                       space_group, data_group)


def make_spatial_mesh(num_devices: Optional[int] = None, device=None
                      ) -> SpatialMesh:
    """Every rank on the ``space`` axis (JAX spatial.py:23-28); refuses a
    world of another size than ``num_devices`` where it is given."""
    world = M.world_size()
    if num_devices is not None and num_devices != world:
        raise ValueError(f"a {num_devices}-rank spatial mesh, the world "
                         f"has {world}")
    return _groups_of(1, world, device)


def make_hybrid_mesh(data: int, space: int, device=None) -> SpatialMesh:
    """A (data, space) grid: batch split ``data`` ways, each image's H
    ``space`` ways (JAX spatial.py:31-46); ``space`` varies fastest, so
    the halo exchanges run between neighbouring ranks. One process group
    per row and per column, made on every rank in the same order."""
    return _groups_of(data, space, device)


def window_rows(height: int, shards: int, index: int, kernel: int,
                stride: int, top: int, bottom: int) -> Tuple[int, int]:
    """The input rows ``[a, b)`` (global, may pass the image's edges)
    that shard ``index`` of ``shards`` reads for its share of the outputs
    of a ``kernel``-row window at ``stride`` over ``height`` rows with
    the pads ``top``/``bottom``."""
    out = (height + top + bottom - kernel) // stride + 1
    if out % shards:
        raise ValueError(f"{out} output rows do not split over {shards} "
                         "shards: the image's height must be a multiple "
                         "of 32 x space")
    o0, o1 = index * out // shards, (index + 1) * out // shards
    return o0 * stride - top, (o1 - 1) * stride - top + kernel


def unpool_rows(rows: int, index: int) -> Tuple[int, int]:
    """The input rows the 2x bilinear unpool of shard ``index`` (``rows``
    rows a shard) reads: one beyond each side of its own."""
    return index * rows - 1, (index + 1) * rows + 1


class HaloRows:
    """``models/layers.py`` ``SPATIAL`` for one rank of an H-sharded
    forward: shard ``index`` of ``size``, every shard the same height,
    the batch split ``data`` ways beside it. :meth:`rows` gathers global
    rows from their owners (:meth:`_exchange`)."""

    def __init__(self, index: int, size: int, ranks=(), group=None,
                 data: int = 1):
        self.index, self.size = index, size
        self.ranks, self.group = tuple(ranks), group
        self.data = data

    def full(self, x: torch.Tensor) -> int:
        return x.shape[-2] * self.size

    def batch(self, x: torch.Tensor) -> int:
        return x.shape[0] * self.data

    def rows(self, x: torch.Tensor, need: Callable[[int], Tuple[int, int]]
             ) -> Tuple[torch.Tensor, int, int]:
        """The global rows ``need(index)`` of the tensor whose shard
        ``x`` is, clipped to the image, with the counts of rows left to
        fill above and below it. ``need(q)`` must give every shard's
        rows alike on every rank: each rank sends what the others need
        of its own."""
        a, b = need(self.index)
        lo, hi = max(a, 0), min(b, self.full(x))
        return self._exchange(x, need, lo, hi), lo - a, b - hi

    def _exchange(self, x, need, lo, hi) -> torch.Tensor:
        h = x.shape[-2]
        me = self.index
        parts: List[torch.Tensor] = []
        ops = []
        dist = M._dist() if self.size > 1 else None
        for q in range(self.size):  # what this shard reads of shard q's
            qa, qb = max(lo, q * h), min(hi, (q + 1) * h)
            if qa >= qb:
                continue
            if q == me:
                parts.append(x[:, :, qa - q * h:qb - q * h])
                continue
            buf = x.new_empty((x.shape[0], x.shape[1], qb - qa, x.shape[3]))
            parts.append(buf)
            ops.append(dist.P2POp(dist.irecv, buf, self.ranks[q],
                                  self.group))
        for q in range(self.size):  # what shard q reads of this one's
            if q == me:
                continue
            qa, qb = need(q)
            ma, mb = max(qa, me * h), min(qb, (me + 1) * h)
            if ma < mb:
                ops.append(dist.P2POp(
                    dist.isend, x[:, :, ma - me * h:mb - me * h].contiguous(),
                    self.ranks[q], self.group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        if len(parts) == 1:
            return parts[0]
        return torch.cat(parts, 2).contiguous(
            memory_format=torch.channels_last)

    def window(self, x: torch.Tensor, kernel: int, stride: int, top: int,
               bottom: int) -> Tuple[torch.Tensor, int, int]:
        """The rows this shard's outputs of a window op read (see
        :func:`window_rows`) and the pads left at the image's edges."""
        height = self.full(x)
        return self.rows(x, lambda q: window_rows(
            height, self.size, q, kernel, stride, top, bottom))

    def halo(self, x: torch.Tensor, kernel: int
             ) -> Tuple[torch.Tensor, int]:
        """The rows a stride-1 SAME window of ``kernel`` rows reads for
        this shard's outputs where the op pads itself (a conv kernel):
        the shard's rows extended by ``kernel // 2`` halo rows each side,
        not past the image's top and bottom, channels-last contiguous, and
        the offset of the shard's first row in them. The op runs on the
        extended rows, its own padding and all; rows ``[offset, offset +
        h)`` of its output are the shard's."""
        p = kernel // 2
        xe, above, _ = self.window(x, kernel, 1, p, p)
        return xe.contiguous(memory_format=torch.channels_last), p - above

    def unpool(self, x: torch.Tensor) -> torch.Tensor:
        """The 2x bilinear unpool of this shard's rows, bit for bit the
        rows of the whole image's: one neighbour row each side, and at
        the image's edges F.interpolate's own clamp (the edge row
        replicated)."""
        h, w = x.shape[-2:]
        xe, above, _ = self.rows(x, lambda q: unpool_rows(h, q))
        y = F.interpolate(xe, size=(2 * xe.shape[-2], 2 * w),
                          mode="bilinear", align_corners=False,
                          antialias=False)
        start = 2 * (1 - above)
        return y[:, :, start:start + 2 * h]


def _all_gather(t: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    if group is None or n == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    M._dist().all_gather(parts, t, group=group)
    return torch.cat(parts, dim)


def _sharded_forward(model: torch.nn.Module, mesh: SpatialMesh
                     ) -> Callable[[Any], Dict[str, torch.Tensor]]:
    rows = HaloRows(mesh.space_index, mesh.space, mesh.space_ranks,
                    mesh.space_group, mesh.data)

    @torch.inference_mode()
    def run(images) -> Dict[str, torch.Tensor]:
        x = torch.as_tensor(images)
        b, h = x.shape[:2]
        if h % (32 * mesh.space):
            raise ValueError(f"image height {h} is not a multiple of "
                             f"32 x {mesh.space} (pad it first)")
        if b % mesh.data:
            raise ValueError(f"batch {b} not divisible by the data axis's "
                             f"{mesh.data} ranks")
        bd, hs = b // mesh.data, h // mesh.space
        x = x[mesh.data_index * bd:(mesh.data_index + 1) * bd,
              mesh.space_index * hs:(mesh.space_index + 1) * hs]
        x = x.to(mesh.device)
        prev, layers.SPATIAL = layers.SPATIAL, rows
        try:
            out = model(x)
        finally:
            layers.SPATIAL = prev
        out = {k: _all_gather(v, 1, mesh.space_group, mesh.space)
               for k, v in out.items()}
        return {k: _all_gather(v, 0, mesh.data_group, mesh.data)
                for k, v in out.items()}

    return run


def spatial_forward(model: torch.nn.Module, mesh: SpatialMesh
                    ) -> Callable[[Any], Dict[str, torch.Tensor]]:
    """``run(images)``: the eval forward of ``model`` (its weights, on
    ``mesh.device``) on the (B, H, W, 3) images that every rank passes,
    each rank computing its H shard; returns the output maps whole on
    every rank. H must be a multiple of 32·space."""
    if mesh.data != 1:
        raise ValueError("spatial_forward takes a 1-D space mesh; "
                         "hybrid_forward takes the (data, space) grid")
    return _sharded_forward(model, mesh)


def hybrid_forward(model: torch.nn.Module, mesh: SpatialMesh
                   ) -> Callable[[Any], Dict[str, torch.Tensor]]:
    """As :func:`spatial_forward` on a (data, space) grid: the batch
    split over ``data``, each image's H over ``space``; B must divide by
    the data axis."""
    return _sharded_forward(model, mesh)


def spatial_predictor(predictor, mesh: SpatialMesh):
    """``predictor`` serving through the H-sharded forward: its
    ``detect_batch`` runs :func:`hybrid_forward` on ``mesh`` (every rank
    passing the same images) and decodes the gathered maps on its own
    device as it decodes its own forward's, CC kernel included. Returns
    the predictor."""
    predictor.forward = hybrid_forward(predictor.model, mesh)
    return predictor
