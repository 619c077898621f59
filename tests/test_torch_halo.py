"""The halo rows of the H-sharded forward, one op at a time.

``parallel/spatial.py`` derives each op's halo from the output rows a
shard owns (``window_rows``, ``unpool_rows``). Here the plans are checked
row for row, and each op of ``models/layers.py`` is run shard by shard
under ``SPATIAL`` with the rows taken from the whole tensor (an
``HaloRows`` whose exchange slices it, in place of gloo or NCCL): the
shards' outputs, stacked, equal the op on the whole tensor. Ops: the
ResNet stem's 7x7/2 and the units' 3x3/2 ``conv2d_same`` (pads 3 and 1
each side), the SAME 3x3/2 max-pool (0 above, 1 below, -inf), VGG fc6's
3x3 at dilation 6 (a halo over three shards of 2 rows) and the 2x
bilinear unpool (the edge row replicated at the image's edges). Max-pool
and unpool are bit-equal; the convs within 1e-6 of their largest value
(the CPU library may pick another kernel for a shard's shape). Then
pixellink_resnet50 and pixellink_vgg16 whole, shard by shard.
"""

import numpy as np
import pytest
import torch

from tensorflow_ocr_tpu_torch.models import layers
from tensorflow_ocr_tpu_torch.parallel import spatial

torch.set_num_threads(1)


class SlicedRows(spatial.HaloRows):
    """Shard ``index`` of ``size`` of ``whole``: rows come from it."""

    def __init__(self, whole, index, size):
        super().__init__(index, size)
        self.whole = whole

    def _exchange(self, x, need, lo, hi):
        return self.whole[:, :, lo:hi]


def sharded(op, x, n):
    """``op`` run on each of n H shards of ``x`` under SPATIAL, stacked."""
    h = x.shape[2] // n
    outs = []
    for q in range(n):
        layers.SPATIAL = SlicedRows(x, q, n)
        try:
            outs.append(op(x[:, :, q * h:(q + 1) * h]))
        finally:
            layers.SPATIAL = None
    return torch.cat(outs, 2)


def test_plans_follow_the_output_rows():
    # conv2d_same 3x3/2, pads (1, 1), 4 shards of 8 rows: one row above,
    # none below, zero rows only above the image
    assert [spatial.window_rows(32, 4, q, 3, 2, 1, 1) for q in range(4)] \
        == [(-1, 8), (7, 16), (15, 24), (23, 32)]
    # the stem's 7x7/2, pads (3, 3): three above, two below
    assert spatial.window_rows(64, 2, 1, 7, 2, 3, 3) == (29, 66)
    # SAME 3x3/2 max-pool, pads (0, 1): none above, one below
    assert spatial.window_rows(32, 2, 0, 3, 2, 0, 1) == (0, 17)
    # fc6: 3x3 at dilation 6 (13 rows), 4 shards of 2 rows: 6 each side
    assert spatial.window_rows(8, 4, 1, 13, 1, 6, 6) == (-4, 10)
    # a stride-2 1x1 reads every other row of its shard only
    assert spatial.window_rows(16, 2, 1, 1, 2, 0, 0) == (8, 15)
    assert spatial.unpool_rows(4, 0) == (-1, 5)
    with pytest.raises(ValueError, match="32 x space"):
        spatial.window_rows(30, 4, 0, 3, 2, 1, 1)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kernel,stride,dilation,pad", [
    (7, 2, 1, 3), (3, 2, 1, 1), (3, 1, 6, 6), (3, 1, 1, 1)])
def test_conv_halos(n, kernel, stride, dilation, pad):
    g = torch.Generator().manual_seed(kernel * 10 + n)
    x = torch.randn(2, 5, 8 * n, 12, generator=g)
    w = torch.randn(6, 5, kernel, kernel, generator=g)
    b = torch.randn(6, generator=g)

    def op(t):
        return layers.conv2d_pads(t, w, b, stride, dilation, (pad,) * 4)

    want = op(x)
    got = sharded(op, x, n)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("n", [2, 4])
def test_pool_and_unpool_halos_are_exact(n):
    g = torch.Generator().manual_seed(n)
    x = torch.randn(2, 3, 8 * n, 10, generator=g) - 1.0  # pools see < 0
    for op in (layers.stem_max_pool, layers.unpool,
               lambda t: layers.max_pool_pads(t, 3, 1, (1, 1, 1, 1))):
        want, got = op(x), sharded(op, x, n)
        assert got.shape == want.shape
        assert torch.equal(got, want)


def test_resnet_and_vgg_forwards_shard_in_rows():
    """Whole models, shard by shard, with each op's rows sliced from the
    whole image's activation at that op, which a forward of the whole
    image under a one-shard SPATIAL records (that forward is bit-equal to
    the plain one): the shards' maps, stacked, equal the whole image's
    within 1e-5 of their largest value."""
    from tensorflow_ocr_tpu_torch.models import build_model

    for name in ("pixellink_resnet50", "pixellink_vgg16"):
        model = build_model(name, dtype=torch.float32)
        x = torch.from_numpy(np.random.RandomState(3).rand(
            1, 64, 32, 3).astype(np.float32) * 255)
        with torch.no_grad():
            want = model(x)
        n = 2
        # every op's input of the whole forward, in call order
        seen = []

        class Record(spatial.HaloRows):
            def _exchange(self, t, need, lo, hi):
                seen.append(t)
                return t[:, :, lo:hi]

        layers.SPATIAL = Record(0, 1)
        try:
            with torch.no_grad():
                assert all(torch.equal(a, want[k]) for k, a in
                           model(x).items())
        finally:
            layers.SPATIAL = None
        outs = []
        for q in range(n):
            calls = iter(seen)

            class FromWhole(spatial.HaloRows):
                def _exchange(self, t, need, lo, hi):
                    return next(calls)[:, :, lo:hi]

            layers.SPATIAL = FromWhole(q, n)
            try:
                with torch.no_grad():
                    outs.append(model(x[:, q * 32:(q + 1) * 32]))
            finally:
                layers.SPATIAL = None
        for k, v in want.items():
            got = torch.cat([o[k] for o in outs], 1)
            torch.testing.assert_close(got, v, rtol=0,
                                       atol=1e-5 * float(v.abs().max()))
