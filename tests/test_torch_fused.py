"""Port parity: the fused conv and boundary ops (ops/fused.py, plain path).

The same seeded numpy inputs go through the JAX references and their
VJPs (``pallas_fused.reference_conv_bn_act`` and ``fused_boundary`` at an
M that takes its jnp branches) and through the port's autograd functions
on the CPU, in float32, with both cotangents of a conv (dy and ds).
Tolerance: rtol = 1e-4 and atol = 1e-4 of the largest value, for float32
sums in another order (up to 9*64 products a conv output, up to ~200
rows a statistic). A float64 gradcheck holds each autograd function to
finite differences.

The kernels' tiling is emulated by tests/test_torch_fwd_staged.py (the
forward: csrc/conv_bwd.cuh's tdx in its forward mode, x staged through
the prologue, the sums one entry a CTA) and tests/test_torch_conv_bwd.py
(the backward: the dW split over pixel tiles and clusters, the dX tiles
with their staged dy_eff); here both must equal the plain whole-map
result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_ocr_tpu.ops import pallas_fused as PF
from tensorflow_ocr_tpu_torch.ops import fused as FU
from test_torch_conv_bwd import emulate_fused_bwd
from test_torch_fwd_staged import emulate_fused_fwd

torch.set_num_threads(1)
RTOL = 1e-4


def close(got, want, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max(), err_msg=name)


def nchw(x):
    """NHWC numpy -> NCHW channels-last torch (JAX's layout in memory)."""
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def conv_case(rng, n, h, w, ci, co, k):
    x = rng.randn(n, h, w, ci).astype(np.float32)
    # nonzero b: relu(b) != 0 at a pad, so the pad-after-prologue matters
    ab = np.stack([rng.uniform(0.5, 1.5, ci),
                   rng.randn(ci) * 0.5 + 0.3]).astype(np.float32)
    wk = (rng.randn(k, k, ci, co) / np.sqrt(k * k * ci)).astype(np.float32)
    dy = rng.randn(n, h, w, co).astype(np.float32)
    ds = np.stack([rng.randn(co) * 0.3, rng.randn(co) * 0.1]).astype(
        np.float32)
    return x, ab, wk, dy, ds


def torch_weight(wk):
    return torch.from_numpy(np.ascontiguousarray(wk.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("k,ci,co,hw", [
    (1, 8, 16, (5, 7)),
    (1, 16, 8, (4, 6)),
    (3, 8, 8, (5, 7)),
    (3, 6, 10, (7, 5)),
    (3, 16, 12, (1, 9)),
])
def test_fused_conv_matches_jax_reference_and_vjp(k, ci, co, hw):
    rng = np.random.RandomState(k * 100 + ci + co)
    x, ab, wk, dy, ds = conv_case(rng, 2, *hw, ci, co, k)

    def ref(x, ab, wk):
        return PF.reference_conv_bn_act(x, ab, wk, (k, k))

    (jy, js), vjp = jax.vjp(ref, jnp.asarray(x), jnp.asarray(ab),
                            jnp.asarray(wk))
    jdx, jdab, jdw = vjp((jnp.asarray(dy), jnp.asarray(ds)))

    tx = nchw(x).requires_grad_()
    tab = torch.from_numpy(ab).requires_grad_()
    tw = torch_weight(wk).requires_grad_()
    op = FU.fused_conv1x1 if k == 1 else FU.fused_conv3x3
    y, s = op(tx, tab, tw)
    assert y.is_contiguous(memory_format=torch.channels_last)
    close(nhwc(y), jy, "y")
    close(s.detach(), js, "s")
    ((y * nchw(dy)).sum() + (s * torch.from_numpy(ds)).sum()).backward()
    close(nhwc(tx.grad), jdx, "dx")
    close(tab.grad, jdab, "dab")
    close(tw.grad.permute(2, 3, 1, 0), jdw, "dw")


def test_fused_conv_backward_takes_no_ds():
    """ds is None where the statistics are unused (eval, freeze_bn): it
    reads as zero, as a zero cotangent gives in JAX."""
    rng = np.random.RandomState(3)
    x, ab, wk, dy, _ = conv_case(rng, 1, 4, 5, 4, 6, 3)
    args = (nchw(x), torch.from_numpy(ab), torch_weight(wk))
    y, _ = FU.conv_fwd(*args)
    got = FU.conv_bwd(*args, y, nchw(dy), None)
    want = FU.conv_bwd(*args, y, nchw(dy), torch.zeros(2, 6))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("m_hw", [(3, 7), (5, 11)])
def test_fused_boundary_matches_jax_and_vjp(m_hw):
    rng = np.random.RandomState(sum(m_hw))
    n, c = 2, 24
    assert (n * m_hw[0] * m_hw[1]) % 256  # JAX takes its jnp branches
    z, zs, g = (rng.randn(n, *m_hw, c).astype(np.float32) for _ in range(3))
    ab, abs_ = (np.stack([rng.uniform(0.5, 1.5, c), rng.randn(c)]).astype(
        np.float32) for _ in range(2))
    jout, vjp = jax.vjp(PF.fused_boundary, *map(jnp.asarray,
                                                (z, ab, zs, abs_)))
    jdz, jdab, jdzs, jdabs = vjp(jnp.asarray(g))

    tz, tzs = nchw(z).requires_grad_(), nchw(zs).requires_grad_()
    tab = torch.from_numpy(ab).requires_grad_()
    tabs = torch.from_numpy(abs_).requires_grad_()
    out = FU.fused_boundary(tz, tab, tzs, tabs)
    close(nhwc(out), jout, "out")
    (out * nchw(g)).sum().backward()
    close(nhwc(tz.grad), jdz, "dz")
    close(nhwc(tzs.grad), jdzs, "dzs")
    close(tab.grad, jdab, "dab")
    close(tabs.grad, jdabs, "dabs")


@pytest.mark.parametrize("k", [1, 3])
def test_fused_conv_gradcheck_float64(k):
    gen = torch.Generator().manual_seed(k)
    x = torch.randn(1, 3, 4, 5, generator=gen, dtype=torch.float64)
    x = x.contiguous(memory_format=torch.channels_last).requires_grad_()
    ab = torch.stack([torch.rand(3, generator=gen, dtype=torch.float64) + .5,
                      torch.randn(3, generator=gen, dtype=torch.float64)])
    w = torch.randn(2, 3, k, k, generator=gen, dtype=torch.float64)
    op = FU.fused_conv1x1 if k == 1 else FU.fused_conv3x3
    assert torch.autograd.gradcheck(
        op, (x, ab.requires_grad_(), w.requires_grad_()))


def test_fused_boundary_gradcheck_float64():
    gen = torch.Generator().manual_seed(9)

    def t(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64)

    z = t(1, 4, 3, 5).contiguous(memory_format=torch.channels_last)
    zs = t(1, 4, 3, 5).contiguous(memory_format=torch.channels_last)
    args = (z, t(2, 4), zs, t(2, 4))
    assert torch.autograd.gradcheck(
        FU.fused_boundary, tuple(a.requires_grad_() for a in args))


# --------------------------------------------------------------------------
# CPU emulation of the kernels' split (csrc/fused_conv.cu)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("k,ci,co,nhw", [
    (3, 64, 64, (2, 9, 11)),     # ragged tiles against H and W
    (3, 32, 64, (1, 12, 13)),    # a channel box past Ci (TMA's zero fill)
    (1, 64, 128, (3, 5, 9)),
])
def test_kernel_split_emulation_equals_whole_map(k, ci, co, nhw):
    rng = np.random.RandomState(k + ci + co)
    x, ab, wk, dy, ds = conv_case(rng, nhw[0], nhw[1], nhw[2], ci, co, k)
    args = (nchw(x), torch.from_numpy(ab), torch_weight(wk))
    y, s = FU.conv_fwd_reference(*args)
    # a small SM count: several CTAs walk several tiles each
    ey, es, _ = emulate_fused_fwd(*args, 4)
    close(ey, y.permute(0, 2, 3, 1).reshape(-1, co), "y")
    close(es, s, "s")
    if not FU.kernel_takes(ci, co, k):
        # the kernels' TMA boxes take 64-channel multiples only: the
        # wrapper refuses the rest before it reaches the card
        with pytest.raises(ValueError, match="multiple of 64"):
            FU._conv_shapes(*args)
        return
    dx, dab, dw = FU.conv_bwd_reference(*args, y, nchw(dy),
                                        torch.from_numpy(ds))
    # the dW split has several pixel ranges
    edx, edab, edw, _, _ = emulate_fused_bwd(*args, y, nchw(dy),
                                             torch.from_numpy(ds), 4)
    close(edx, dx.permute(0, 2, 3, 1).reshape(-1, ci), "dx")
    close(edab, dab, "dab")
    close(edw, dw.reshape(co, ci, k, k).permute(2, 3, 1, 0).reshape(-1, co),
          "dw")


def test_kernel_takes_the_units_of_resnet50():
    """The model's fuse decision: every stride-1 unit of ResNet-50 has
    channels the conv kernel takes (multiples of 64), at any H and W."""
    for db, depth in ((64, 256), (128, 512), (256, 1024), (512, 2048)):
        for cin in (db, depth):
            assert FU.kernel_takes(cin, db, 1)
        assert FU.kernel_takes(db, db, 3) and FU.kernel_takes(db, depth, 1)
    assert not FU.kernel_takes(16, 64, 1)
    assert not FU.kernel_takes(64, 64, 5)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros(1, 64, 4, 4)
    ab = torch.zeros(2, 64)
    w = torch.zeros(64, 64, 1, 1)
    with pytest.raises(ValueError, match="CUDA"):
        FU._check(x, x=x)
    with pytest.raises(ValueError, match="multiple of 64"):
        FU._conv_shapes(torch.zeros(1, 16, 4, 4), torch.zeros(2, 16),
                        torch.zeros(64, 16, 1, 1))
    with pytest.raises(ValueError, match="do not fit"):
        FU._conv_shapes(x, torch.zeros(2, 32), w)
    with pytest.raises(ValueError, match="1x1"):
        FU.fused_conv1x1(x, ab, torch.zeros(64, 64, 3, 3))
