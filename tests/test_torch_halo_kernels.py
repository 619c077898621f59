"""The kernel arms of the H-sharded forward, one layer at a time, in one
process.

As tests/test_torch_halo.py: each shard runs under ``SPATIAL`` with the
rows it fetches sliced from the whole tensor (no process group): a
one-shard forward of the whole input records the tensor of each row
read, and each shard slices its reads from those. The shards' outputs,
stacked, are held against the layer on the whole tensor within 1e-6 of
the largest value. float32, the kernels'
plain versions (their wrappers' CPU path), 2 and 4 shards, eval:

- a routed ``ConvBN`` (``PALLAS_CONVS`` on), 3x3 and 1x1, at a height
  where only the whole image's shape is routed: the route decides on it
  (``layers.full_height``, ``full_batch``), the 3x3 runs on the shard's
  rows and one halo row each side (``HaloRows.halo``), the 1x1 on the
  shard's rows;
- a ``FusedBottleneck`` (projection and identity): ``fused_conv3x3`` on
  the shard's rows and their halo, the 1x1s and the boundary on the
  shard's;
- a ``GhostBottleneck`` where the whole image's height gives a band and
  a shard's does not: every shard runs the ghost eval (``_eval``
  counted), as the whole image does.

A planted fault, reads that return zeros for the rows of the other
shards, must fail each comparison that reads a halo.
"""

import pytest
import torch

from tensorflow_ocr_tpu_torch.models import layers
from tensorflow_ocr_tpu_torch.models import resnet as TR
from tensorflow_ocr_tpu_torch.ops import conv as CV
from tensorflow_ocr_tpu_torch.ops import fused as FU
from tensorflow_ocr_tpu_torch.ops import ghost as G
from tensorflow_ocr_tpu_torch.parallel import spatial

torch.set_num_threads(1)


class Recorded(spatial.HaloRows):
    """Shard ``index`` of ``size``: the rows of each read come from that
    read's whole tensor, as a one-shard forward of the whole input
    recorded them (``record``); ``zero_halo``, the planted fault, reads
    the rows of the other shards as zeros."""

    def __init__(self, seen, index, size, zero_halo=False):
        super().__init__(index, size)
        self.reads, self.zero_halo = iter(seen), zero_halo

    def _exchange(self, x, need, lo, hi):
        rows = next(self.reads)[:, :, lo:hi].clone()
        if self.zero_halo:
            h = x.shape[2]
            a, b = self.index * h - lo, (self.index + 1) * h - lo
            rows[:, :, :max(a, 0)] = 0
            rows[:, :, max(b, 0):] = 0
        return rows


def record(op, x):
    """``op(x)`` under a one-shard SPATIAL, and the whole tensor of each
    row read, in order."""
    seen = []

    class Record(spatial.HaloRows):
        def _exchange(self, t, need, lo, hi):
            seen.append(t)
            return t[:, :, lo:hi]

    layers.SPATIAL = Record(0, 1)
    try:
        return op(x), seen
    finally:
        layers.SPATIAL = None


def sharded(op, x, seen, n, zero_halo=False):
    """``op`` run on each of n H shards of ``x`` under SPATIAL (the rows
    from ``seen``), stacked."""
    h = x.shape[2] // n
    outs = []
    for q in range(n):
        layers.SPATIAL = Recorded(seen, q, n, zero_halo)
        try:
            outs.append(op(x[:, :, q * h:(q + 1) * h]))
        finally:
            layers.SPATIAL = None
    return torch.cat(outs, 2)


def err(got, want) -> float:
    """The largest difference over the largest value."""
    return float((got - want).abs().max() / want.abs().max())


def check_shards(op, x, n, halo=True):
    """The stacked shards within 1e-6 of the largest value of ``op`` on
    the whole ``x``; the planted fault beyond it where ``op`` reads a halo
    (a row-local op reads none: there it changes nothing)."""
    with torch.inference_mode():
        want = op(x)
        whole, seen = record(op, x)
        got = sharded(op, x, seen, n)
        planted = sharded(op, x, seen, n, zero_halo=True)
    assert torch.equal(whole, want)
    assert got.shape == want.shape
    assert err(got, want) <= 1e-6
    if halo:
        assert err(planted, want) > 1e-6
    else:
        assert torch.equal(planted, got)


def perturbed(module, seed):
    """``module`` in eval with seeded weights and BN statistics."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.2)
        for m in module.modules():
            if isinstance(m, layers.BatchNorm):
                c = m.weight.numel()
                m.weight.uniform_(0.8, 1.2, generator=g)
                m.running_mean.copy_(torch.randn(c, generator=g) * 0.1)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    return module.eval()


def channels_last(t):
    return t.contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("k", [1, 3])
def test_routed_convbn_runs_on_the_shard_and_its_halo(monkeypatch, n, k):
    monkeypatch.setattr(layers, "PALLAS_CONVS", True)
    cbn = perturbed(layers.ConvBN(16, 24, k), k)
    g = torch.Generator().manual_seed(10 * n + k)
    x = torch.randn(2, 16, 8, 16, generator=g)
    # the route takes 2 x 8 x 16 (a 3x3 banded by 8 rows, a 1x1 of 256
    # rows), not a shard's 2 x 8/n x 16
    assert cbn._routed(x)
    assert not CV.supported((2, 8 // n, 16, 16), (k, k), (1, 1), (1, 1), 24)
    heights = []
    conv2d = CV.conv2d

    def route(t, w, *a):
        heights.append(t.shape[2])
        return conv2d(t, w, *a)

    monkeypatch.setattr(CV, "conv2d", route)
    check_shards(cbn, x, n, halo=k == 3)
    # the whole image twice (plain, then recorded), then each shard
    # (extended by the halo where the image goes on), then the planted run
    h = 8 // n
    want = [h + (k == 3) * ((q > 0) + (q < n - 1)) for q in range(n)]
    assert heights == [8, 8] + want + want


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("depth_in", [64, 256])
def test_fused_bottleneck_runs_its_3x3_on_the_shard_and_its_halo(
        monkeypatch, n, depth_in):
    unit = perturbed(TR.FusedBottleneck(depth_in, 256, 64), n + depth_in)
    g = torch.Generator().manual_seed(n)
    x = channels_last(torch.relu(torch.randn(2, depth_in, 8, 8,
                                             generator=g)))
    heights = []
    fused3 = FU.fused_conv3x3

    def fused3x3(t, ab, w):
        heights.append(t.shape[2])
        return fused3(t, ab, w)

    monkeypatch.setattr(FU, "fused_conv3x3", fused3x3)
    check_shards(unit, x, n)
    h = 8 // n
    want = [h + (q > 0) + (q < n - 1) for q in range(n)]
    assert heights == [8, 8] + want + want


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("depth_in", [64, 256])
def test_ghost_bottleneck_takes_the_ghost_eval_on_every_shard(
        monkeypatch, n, depth_in):
    unit = perturbed(TR.GhostBottleneck(depth_in, 256, 64), n + depth_in)
    g = torch.Generator().manual_seed(n)
    x = channels_last(torch.relu(torch.randn(2, depth_in, 8, 8,
                                             generator=g)))
    # the whole image's 8 rows give a band, a shard's 8/n rows none
    proj = depth_in != 256
    assert G.pick_gh(8, 8, depth_in, 64, 256, proj) == 8
    assert G.pick_gh(8 // n, 8, depth_in, 64, 256, proj) is None
    calls = []
    ghost_eval = TR.GhostBottleneck._eval

    def counted(self, o):
        calls.append(o.shape[2])
        return ghost_eval(self, o)

    monkeypatch.setattr(TR.GhostBottleneck, "_eval", counted)
    check_shards(unit, x, n)
    # the whole image twice, each shard, each shard of the planted run
    assert calls == [8, 8] + [8 // n] * (2 * n)
