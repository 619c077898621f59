"""Port parity: conv+BN (eval fold), stem max-pool, unpool, mean subtraction.

The same seeded numpy inputs and Flax variables go through the JAX layer
and its PyTorch port, both in float32 on the CPU. Tolerance: float32,
atol = rtol = 1e-5 (the convs sum at most 7*7*3 products in different
orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn

from tensorflow_ocr_tpu.models import layers as JL
from tensorflow_ocr_tpu_torch.models import layers as TL
from tensorflow_ocr_tpu_torch.models.convert import load_variables

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _convbn_variables(rng, k, cin, cout):
    """Flax ConvBN variables with non-trivial running statistics."""
    return {
        "params": {
            "Conv_0": {"kernel": rng.randn(k, k, cin, cout).astype(np.float32)
                       / np.sqrt(k * k * cin)},
            "BatchNorm_0": {
                "scale": rng.uniform(0.5, 1.5, cout).astype(np.float32),
                "bias": rng.randn(cout).astype(np.float32) * 0.1},
        },
        "batch_stats": {
            "BatchNorm_0": {
                "mean": rng.randn(cout).astype(np.float32) * 0.2,
                "var": rng.uniform(0.5, 2.0, cout).astype(np.float32)},
        },
    }


@pytest.mark.parametrize("k,stride,explicit_pad,relu,hw", [
    (1, 1, False, True, (9, 12)),      # 1x1
    (3, 1, False, True, (9, 12)),      # 3x3 s1 SAME
    (3, 2, True, True, (10, 13)),      # 3x3 s2 conv2d_same (bottleneck)
    (7, 2, True, False, (16, 18)),     # 7x7 s2 stem, no relu
    (3, 2, False, True, (10, 12)),     # 3x3 s2 TF-SAME, even (tiny)
    (3, 2, False, True, (11, 13)),     # 3x3 s2 TF-SAME, odd
    (1, 2, False, False, (10, 13)),    # 1x1 s2 projection shortcut
])
def test_convbn_eval_matches_flax(k, stride, explicit_pad, relu, hw):
    rng = np.random.RandomState(k * 10 + stride)
    cin, cout = 5, 7
    variables = _convbn_variables(rng, k, cin, cout)
    x = rng.randn(2, *hw, cin).astype(np.float32) * 3
    ref = JL.ConvBN(cout, (k, k), (stride, stride), explicit_pad=explicit_pad,
                    activation=nn.relu if relu else None, dtype=jnp.float32)
    want = np.asarray(ref.apply(variables, jnp.asarray(x), train=False))

    port = TL.ConvBN(cin, cout, k, stride, relu=relu,
                     explicit_pad=explicit_pad)
    load_variables(port, variables)
    with torch.no_grad():
        got = _nhwc(port(_nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_convbn_train_mode_not_ported():
    """Train mode is ported with Flax's BN conventions; torch's own
    (unbiased running variance, momentum on the new value) is what is
    not ported: after one step the port's running statistics are Flax's
    and differ from ``nn.BatchNorm2d``'s."""
    gen = torch.Generator().manual_seed(0)
    port = TL.ConvBN(3, 4, 3, relu=False)
    TL.init_weights(port, gen)
    x = torch.randn(2, 3, 5, 6, generator=gen)
    port(x, train=True)
    with torch.no_grad():
        y = port._conv(x, port.conv.weight)
    mu, var = y.mean((0, 2, 3)), y.var((0, 2, 3), unbiased=False)
    torch.testing.assert_close(port.bn.running_mean, 0.003 * mu)
    torch.testing.assert_close(port.bn.running_var, 0.997 + 0.003 * var)
    ref = torch.nn.BatchNorm2d(4, momentum=0.003)
    ref(y)
    assert not torch.allclose(ref.running_var, port.bn.running_var,
                              rtol=0, atol=1e-7)


@pytest.mark.parametrize("hw", [(8, 10), (9, 11), (8, 11)])
def test_stem_max_pool_on_negative_inputs(hw):
    rng = np.random.RandomState(sum(hw))
    x = -np.abs(rng.randn(2, *hw, 3)).astype(np.float32) - 1.0
    want = np.asarray(JL.stem_max_pool(jnp.asarray(x)))
    got = _nhwc(TL.stem_max_pool(_nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_unpool_matches_jax_image_resize():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, 7, 3).astype(np.float32)
    want = np.asarray(JL.unpool(jnp.asarray(x)))
    got = _nhwc(TL.unpool(_nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 3, 5, 7), (1, 16, 1, 1), (2, 2, 1, 4)])
def test_unpool_backward_is_the_adjoint(shape, dtype):
    """unpool's forward is F.interpolate's; its fixed-order backward (pad,
    conv with the taps) gives F.interpolate's float32 gradient, rounded
    once to the input's dtype (float32: within 1e-6 of the largest), and
    the same bits on a second call; a 1-pixel axis and channels_last
    included."""
    gen = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(shape, generator=gen).to(dtype)
    g = torch.randn((*shape[:2], 2 * shape[2], 2 * shape[3]),
                    generator=gen).to(dtype)
    ref = x.float().requires_grad_()
    y = F.interpolate(ref, size=g.shape[-2:], mode="bilinear",
                      align_corners=False)
    (want,) = torch.autograd.grad(y, ref, g.float())
    for memory_format in (torch.contiguous_format, torch.channels_last):
        xi = x.contiguous(memory_format=memory_format).requires_grad_()
        out = TL.unpool(xi)
        assert torch.equal(out.float(), F.interpolate(
            x, size=g.shape[-2:], mode="bilinear",
            align_corners=False).float())
        (got,) = torch.autograd.grad(out, xi, g)
        (again,) = torch.autograd.grad(TL.unpool(xi), xi, g)
        assert got.dtype == dtype and torch.equal(got, again)
        tol = 1e-6 if dtype == torch.float32 else 2.0 ** -7
        torch.testing.assert_close(got.float(), want, rtol=tol,
                                   atol=tol * float(want.abs().max()))


def test_mean_image_subtraction():
    rng = np.random.RandomState(2)
    x = rng.uniform(0, 255, (2, 4, 6, 3)).astype(np.float32)
    want = np.asarray(JL.mean_image_subtraction(jnp.asarray(x)))
    got = TL.mean_image_subtraction(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("size,k,s", [(10, 3, 2), (11, 3, 2), (16, 7, 2),
                                      (9, 3, 1), (10, 1, 2)])
def test_same_pads_follow_tf(size, k, s):
    out = -(-size // s)
    before, after = TL.same_pads(size, k, s)
    # TF-SAME: the output covers ceil(size/stride), extra pad goes after
    assert (size + before + after - k) // s + 1 == out
    assert after - before in (0, 1)
