"""The pallas_conv route: ops/conv.py against tensorflow_ocr_tpu's
ops/pallas_conv.py, and the kernels' split emulated on the CPU.

The JAX side runs ``pallas_conv.conv2d`` in interpret mode (the Pallas
kernels themselves, on the CPU) and its custom VJP through ``jax.vjp``;
the port runs ``ops.conv.conv2d`` (the plain versions on CPU tensors) and
its autograd functions, on the same seeded numpy inputs and cotangents.
Tolerances: float32 outputs and gradients within 1e-4 of the largest
value (sums in another order); bfloat16 ones within one bf16 ulp at the
largest value (both sides round the same float32 sum, accumulated in
another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_ocr_tpu.models import build_model as build_jax_model
from tensorflow_ocr_tpu.models import layers as JL
from tensorflow_ocr_tpu.ops import pallas_conv as PCV
from tensorflow_ocr_tpu_torch.models import build_model, layers as TL
from tensorflow_ocr_tpu_torch.models.convert import convert_variables
from tensorflow_ocr_tpu_torch.ops import conv as CV
from test_torch_resnet import perturb_bn

torch.set_num_threads(1)
CL = torch.channels_last


@pytest.fixture
def interpret():
    PCV.set_interpret(True)
    yield
    PCV.set_interpret(False)


def nchw(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2) \
        .to(dtype).contiguous(memory_format=CL)


def nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def assert_close(got, want, dtype, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    top = np.abs(want).max()
    if dtype == "float32":
        tol = 1e-4 * top
    else:  # one bf16 ulp (8 bits of mantissa) at the largest value
        tol = 2.0 ** (np.floor(np.log2(top)) - 7)
    err = np.abs(got - want).max()
    assert err <= tol, f"{name}: max err {err:.3e} > {tol:.3e}"


# (kernel, stride, (N, H, W, Ci)): shapes the JAX route takes
# (M a multiple of 256 for the 1x1s; W % 8 == 0 and H % 8 == 0 for 3x3)
CASES = {"1x1": (1, 1, (2, 16, 16, 16)), "1x1_s2": (1, 2, (2, 32, 32, 16)),
         "3x3": (3, 1, (1, 8, 16, 8))}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("co", [2, 16, 64])
@pytest.mark.parametrize("case", sorted(CASES))
def test_conv2d_and_its_vjp_match_pallas_conv(interpret, case, co, dtype):
    k, s, shape = CASES[case]
    rng = np.random.RandomState(k * 100 + s * 10 + co)
    x = rng.randn(*shape).astype(np.float32)
    w = (rng.randn(k, k, shape[-1], co) / np.sqrt(k * k * shape[-1])
         ).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    assert PCV.supported(x.shape, (k, k), (s, s), (1, 1), co)
    assert CV.supported(x.shape, (k, k), (s, s), (1, 1), co)

    jy, vjp = jax.vjp(lambda a, b: PCV.conv2d(a, b, (s, s)),
                      jnp.asarray(x, jdt), jnp.asarray(w, jdt))
    dy = rng.randn(*jy.shape).astype(np.float32)
    jdx, jdw = vjp(jnp.asarray(dy, jdt))

    tdt = getattr(torch, dtype)
    tx = nchw(x, tdt).requires_grad_()
    tw = torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).to(tdt) \
        .requires_grad_()
    ty = CV.conv2d(tx, tw, (s, s))
    tdx, tdw = torch.autograd.grad(ty, (tx, tw), nchw(dy, tdt))
    assert ty.dtype == tdx.dtype == tdw.dtype == tdt
    assert_close(nhwc(ty), jy.astype(jnp.float32), dtype, "y")
    assert_close(nhwc(tdx), jdx.astype(jnp.float32), dtype, "dx")
    assert_close(tdw.float().permute(2, 3, 1, 0).numpy(),
                 jdw.astype(jnp.float32), dtype, "dw")


@pytest.mark.parametrize("k,stride", [(1, 1), (1, 2), (3, 1)])
def test_conv2d_gradcheck_float64(k, stride):
    gen = torch.Generator().manual_seed(k + stride)
    x = torch.randn(2, 3, 4, 6, generator=gen, dtype=torch.float64)
    w = torch.randn(5, 3, k, k, generator=gen, dtype=torch.float64)
    assert torch.autograd.gradcheck(
        lambda a, b: CV.conv2d(a, b, (stride, stride)),
        (x.contiguous(memory_format=CL).requires_grad_(), w.requires_grad_()))


def test_rounding_points_in_bfloat16():
    """y and dX are rounded once from the float32 sum; dW is summed in
    float32 and rounded to the weight's bf16; the eval fold rounds w·mul
    to bf16 before the conv (models/layers.py:375-380)."""
    gen = torch.Generator().manual_seed(3)
    bf = torch.bfloat16
    x = torch.randn(2, 24, 6, 8, generator=gen).to(bf).contiguous(
        memory_format=CL).requires_grad_()
    w = torch.randn(16, 24, 3, 3, generator=gen).to(bf).requires_grad_()
    dy = torch.randn(2, 16, 6, 8, generator=gen).to(bf)
    y = CV.conv2d(x, w)
    dx, dw = torch.autograd.grad(y, (x, w), dy)
    x32, w32, dy32 = x.detach().float(), w.detach().float(), dy.float()
    y32 = torch.nn.functional.conv2d(x32, w32, padding=1)
    assert torch.equal(y.float(), y32.to(bf).float())
    dx32 = torch.nn.grad.conv2d_input(x.shape, w32, dy32, padding=1)
    assert dx.dtype == bf  # within one ulp: dX sums in another order
    assert bool(((dx.float() - dx32).abs()
                 <= 2.0 ** -8 * dx32.abs() + 1e-6).all())
    dw32 = torch.nn.grad.conv2d_weight(x32, w.shape, dy32, padding=1)
    assert dw.dtype == bf
    assert torch.equal(dw.float(), dw32.to(bf).float())

    # the eval fold on the route: w·mul in bf16 before the conv
    cbn = TL.ConvBN(24, 16, 3)
    with torch.no_grad():
        cbn.conv.weight.copy_(torch.randn(16, 24, 3, 3, generator=gen))
        cbn.bn.weight.uniform_(0.5, 3.0, generator=gen)
        cbn.bn.running_var.uniform_(0.1, 2.0, generator=gen)
    mul = cbn.bn.weight * torch.rsqrt(cbn.bn.running_var + cbn.eps)
    shift = cbn.bn.bias - cbn.bn.running_mean * mul
    xe = x.detach()
    folded = CV.conv3_reference(xe, (cbn.conv.weight * mul[:, None, None,
                                                          None]).to(bf))
    want = torch.relu(folded + shift.to(bf)[:, None, None])
    unrounded = CV.conv3_reference(
        xe.float(), cbn.conv.weight * mul[:, None, None, None]).to(bf)
    assert not torch.equal(unrounded, folded)
    old = TL.PALLAS_CONVS
    try:
        TL.PALLAS_CONVS = True
        with torch.no_grad():
            got = cbn(xe)
    finally:
        TL.PALLAS_CONVS = old
    assert torch.equal(got, want)


# --------------------------------------------------------------------------
# CPU emulation of the kernels' split (csrc/conv.cu, csrc/igemm.cuh; the
# dW of csrc/conv_dw.cu)
# --------------------------------------------------------------------------


def tap_pixel(m, t, n, h, w, ks):
    """csrc/igemm.cuh tap_pixel: pixel of output row m under tap t, or -1
    at the SAME pad and past the last row."""
    ow, oh = m % w, (m // w) % h
    ky, kx = t // ks, t % ks
    hh, ww = oh + ky - ks // 2, ow + kx - ks // 2
    ok = (m < n * h * w) & (hh >= 0) & (hh < h) & (ww >= 0) & (ww < w)
    return torch.where(ok, m + (ky - ks // 2) * w + (kx - ks // 2), -1)


def im2col_tile(src, pix_rows, k0, kdim, ch, geo, ks):
    """A (len(pix_rows), BK) staged K slice: element (r, k0 + j) is
    src[tap_pixel(row r, tap), channel] with (tap, channel) =
    divmod(k0 + j, ch), zero past kdim or at a pad (the kernels'
    predicated loads; the vector loads read the same 8 values)."""
    k = torch.arange(k0, k0 + CV.BK)
    tap, c = k // ch, k % ch
    pix = tap_pixel(pix_rows[:, None], tap[None, :], *geo, ks)
    live = (pix >= 0) & (k < kdim)[None, :]
    vals = src[pix.clamp(min=0), c.clamp(max=ch - 1)[None, :].expand_as(pix)]
    return torch.where(live, vals, torch.zeros_like(vals))


def emulate_fwd(x2, wt, geo, ks, ci, co):
    """igemm_fwd: 128-row pixel tiles (the last one ragged), BK-wide K
    slices, column tiles of fwd_tile(co) (the last predicated)."""
    m, kdim, bn = x2.shape[0], ks * ks * ci, CV.fwd_tile(co)
    y = torch.zeros(m, co)
    for m0 in range(0, m, CV.FWD_ROWS):
        r = torch.arange(m0, m0 + CV.FWD_ROWS)
        for n0 in range(0, co, bn):
            n = torch.arange(n0, n0 + bn)
            acc = torch.zeros(CV.FWD_ROWS, bn)
            for k0 in range(0, kdim, CV.BK):
                a = im2col_tile(x2, r, k0, kdim, ci, geo, ks)
                b = im2col_tile(wt, n, k0, kdim, kdim, (1, 1, co), 1)
                acc += a @ b.T
            live_r, live_n = r < m, n < co
            y[r[live_r][:, None], n[live_n][None, :]] = \
                acc[live_r][:, live_n]
    return y


def emulate_dw(x2, dy2, geo, ks, ci, co, sms):
    """igemm_dw + sum_splits: pixel chunks of dw_plan, each a partial
    (kdim, co) table from bm x bn tiles, added in split order."""
    m, kdim = x2.shape[0], ks * ks * ci
    bm, bn, chunk, splits = CV.dw_plan(m, kdim, co, sms)
    part = torch.zeros(splits, kdim, co)
    for s in range(splits):
        p0, pend = s * chunk, min(m, (s + 1) * chunk)
        assert p0 < pend
        for q0 in range(0, kdim, bm):
            for n0 in range(0, co, bn):
                acc = torch.zeros(bm, bn)
                for kt in range(p0, pend, CV.BK):
                    pix = torch.arange(kt, kt + CV.BK)
                    pix = torch.where(pix < pend, pix, m)  # m: no pixel
                    a = torch.cat([im2col_tile(x2, pix, q, kdim, ci, geo, ks)
                                   for q in range(q0, q0 + bm, CV.BK)], 1)
                    b = torch.cat([im2col_tile(dy2, pix, q, co, co, geo, 1)
                                   for q in range(n0, n0 + bn, CV.BK)], 1)
                    acc += a.T @ b
                part[s, q0:q0 + bm, n0:n0 + bn] = \
                    acc[:min(bm, kdim - q0), :min(bn, co - n0)]
    return part.sum(0), splits


def tma_box(t, img, h0, w0, c0, hb, wb):
    """A TMA box of t (N, H, W, C): the (hb*wb, 64) elements of channels
    c0..c0+63 at pixels (h0.., w0..) of image img, rows in (h, w) order,
    zero outside t (the coordinates may be negative)."""
    _, h, w, c = t.shape
    hh = torch.arange(h0, h0 + hb)[:, None].expand(hb, wb).reshape(-1, 1)
    ww = torch.arange(w0, w0 + wb)[None, :].expand(hb, wb).reshape(-1, 1)
    cc = torch.arange(c0, c0 + 64)[None, :]
    live = (hh >= 0) & (hh < h) & (ww >= 0) & (ww < w) & (cc < c)
    vals = t[img, hh.clamp(0, h - 1), ww.clamp(0, w - 1), cc.clamp(max=c - 1)]
    return torch.where(live, vals, torch.zeros_like(vals))


def emulate_tma_dw(x4, dy4, ks, sms, aux=0, xbox=None, dybox=None):
    """conv_dw.cu's tma_dw + sum_tables on the CPU: x4 (N, H, W, Ci), dy4
    (N, H, W, Co) (a 1x1 dW's rows as (1, 1, M, C)). For each CTA of
    tma_dw_plan's grid: the pixel tiles of its split, each a wb x hb box
    of one image, X shifted by the tap with zeros outside the image; each
    warpgroup's 64-row chunk (or, with one chunk, its half of every
    tile's k16 steps) accumulated from the boxes; then each cluster's
    table summed in rank order (warpgroup order within a rank) and the
    tables in cluster order. The staged backward's tdw (csrc/conv_bwd.cuh)
    is the same split under tma_dw_plan(..., aux) with its boxes rewritten
    after they arrive: ``xbox(img, h0, w0, ky, kx, c0, hb, wb)`` and
    ``dybox(img, h0, w0, c0, hb, wb)`` give the staged boxes (default: the
    raw TMA boxes of x4 and dy4)."""
    n, h, w, ci = x4.shape
    co = dy4.shape[-1]
    p = CV.tma_dw_plan(n, h, w, ci, co, ks, sms, aux)
    if xbox is None:
        def xbox(img, h0, w0, ky, kx, c0, hb, wb):
            return tma_box(x4, img, h0 + ky - ks // 2, w0 + kx - ks // 2, c0,
                           hb, wb)
    if dybox is None:
        def dybox(img, h0, w0, c0, hb, wb):
            return tma_box(dy4, img, h0, w0, c0, hb, wb)
    tiles_w, tiles_h = -(-w // p.wb), -(-h // p.hb)
    ntiles, cch = n * tiles_w * tiles_h, -(-ci // 64)
    rchunks, kp = ks * ks * cch, p.wb * p.hb
    assert p.splits % p.cluster == 0 and p.splits <= ntiles
    tables = torch.zeros(p.splits // p.cluster, ks * ks * ci, co)
    for bx in range(-(-rchunks // 2) if p.two else 1):
        chunks = [min(2 * bx + j, rchunks - 1) for j in (0, 1)] \
            if p.two else [0, 0]
        for co0 in range(0, co, p.bn):
            parked = []
            for s in range(p.splits):
                t0, t1 = s * ntiles // p.splits, (s + 1) * ntiles // p.splits
                assert t0 < t1  # every split non-empty
                slots = [torch.zeros(64, p.bn), torch.zeros(64, p.bn)]
                for t in range(t0, t1):
                    w0 = t % tiles_w * p.wb
                    h0 = t // tiles_w % tiles_h * p.hb
                    img = t // (tiles_w * tiles_h)
                    b = torch.cat([dybox(img, h0, w0, co0 + 64 * j, p.hb,
                                         p.wb)
                                   for j in range(p.bn // 64)], 1)
                    for j in (0, 1):
                        ky, kx = divmod(chunks[j] // cch, ks)
                        a = xbox(img, h0, w0, ky, kx,
                                 chunks[j] % cch * 64, p.hb, p.wb)
                        rows = (slice(0, kp) if p.two
                                else slice(j * kp // 2, (j + 1) * kp // 2))
                        slots[j] += a[rows].T @ b[rows]
                parked.append(slots)
            for cl in range(len(tables)):
                acc = torch.zeros(128 if p.two else 64, p.bn)
                for q in range(p.cluster):
                    slots = parked[cl * p.cluster + q]
                    if p.two:
                        acc[:64] += slots[0]
                        acc[64:] += slots[1]
                    else:
                        acc += slots[0]
                        acc += slots[1]
                for j in (0, 1) if p.two else (0,):
                    if 2 * bx + j >= rchunks:
                        continue  # an odd last chunk's duplicate
                    tap, c0 = divmod(chunks[j], cch)
                    r0, nr = tap * ci + c0 * 64, min(64, ci - c0 * 64)
                    nc = min(p.bn, co - co0)
                    tables[cl, r0:r0 + nr, co0:co0 + nc] = \
                        acc[64 * j:64 * j + nr, :nc]
    dw = tables[0]
    for t in tables[1:]:
        dw = dw + t
    return dw, p


def emulated_dw(x, dy, ks, sms):
    """The dW of x (N, Ci, H, W) and dy on the kernel tma_takes picks,
    emulated: (table, splits)."""
    n, ci, h, w = x.shape
    co = dy.shape[1]
    x2, dy2 = CV.rows(x), CV.rows(dy)
    if CV.tma_takes(ci, co):
        if ks == 1:
            x4, dy4 = x2.reshape(1, 1, -1, ci), dy2.reshape(1, 1, -1, co)
        else:
            x4, dy4 = x.permute(0, 2, 3, 1), dy.permute(0, 2, 3, 1)
        dw, p = emulate_tma_dw(x4, dy4, ks, sms)
        return dw, p.splits
    return emulate_dw(x2, dy2, (n, h, w), ks, ci, co, sms)


@pytest.mark.parametrize("ks,ci,co,nhw,sms", [
    (3, 24, 2, (2, 9, 11), 1),    # K slices across taps, Co = 2, M = 198
    (3, 64, 64, (1, 12, 13), 16),  # two taps a CTA, 3 splits
    (1, 64, 16, (3, 5, 9), 2),    # the head's 16 channels, one 64-row chunk
    (1, 5, 3, (2, 7, 10), 4),     # odd channel counts: K and Co tails
])
def test_kernel_split_emulation_equals_whole_map(ks, ci, co, nhw, sms):
    gen = torch.Generator().manual_seed(ks + ci + co)
    n, h, w = nhw
    x = torch.randn(n, ci, h, w, generator=gen).contiguous(memory_format=CL)
    wk = torch.randn(co, ci, ks, ks, generator=gen)
    dy = torch.randn(n, co, h, w, generator=gen).contiguous(memory_format=CL)
    x2, dy2 = CV.rows(x), CV.rows(dy)
    wt = wk.permute(0, 2, 3, 1).reshape(co, ks * ks * ci)
    if ks == 1:
        want_y = CV.matmul_rows_reference(x2, wt.T)
        want_dw = CV.dw_rows_reference(x2, dy2)
    else:
        want_y = CV.rows(CV.conv3_reference(x, wk))
        want_dw = CV.dw3_reference(x, dy)
    geo = (n, h, w)
    got_y = emulate_fwd(x2, wt, geo, ks, ci, co)
    torch.testing.assert_close(got_y, want_y, rtol=1e-5, atol=1e-4)
    got_dw, splits = emulated_dw(x, dy, ks, sms)
    assert splits > 1
    torch.testing.assert_close(got_dw, want_dw, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("ks,ci,co,nhw,sms,tables", [
    (3, 24, 40, (1, 7, 13), 132, 1),   # W % wb, H % hb, N = 1, Ci = 24
    (1, 8, 16, (2, 5, 9), 132, 1),     # Ci = 8, Co = 16: one 64-row chunk
    (3, 64, 64, (2, 9, 70), 40, 4),    # Ci = 64: two taps a CTA, W > wb
    (3, 128, 96, (1, 6, 10), 132, 1),  # chunk pairs of one tap, 9 % 2
    (1, 64, 64, (4, 16, 16), 16, 8),   # 16 splits: 8 clusters of 2
    (1, 16, 8, (2, 8, 32), 8, 4),      # 8 splits: 4 clusters of 2
    (3, 16, 8, (3, 4, 5), 40, 3),      # H < hb: 3 clusters of 1
    (1, 256, 256, (1, 4, 32), 132, 1),  # BN = 256, two wgmmas a k16 step
])
def test_tma_dw_split_emulation_equals_the_plain_dw(ks, ci, co, nhw, sms,
                                                    tables):
    gen = torch.Generator().manual_seed(ks * 1000 + ci + co)
    n, h, w = nhw
    x = torch.randn(n, ci, h, w, generator=gen).contiguous(memory_format=CL)
    dy = torch.randn(n, co, h, w, generator=gen).contiguous(memory_format=CL)
    assert CV.tma_takes(ci, co)
    p = CV.tma_dw_plan(*((1, 1, n * h * w) if ks == 1 else (n, h, w)), ci,
                       co, ks, sms)
    assert p.splits // p.cluster == tables
    want = (CV.dw_rows_reference(CV.rows(x), CV.rows(dy)) if ks == 1
            else CV.dw3_reference(x, dy))
    got, _ = emulated_dw(x, dy, ks, sms)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


def test_dw_plan_tiles_and_chunks():
    # conv_dw.cu: boxes of <= 256 a dimension and KP pixels (a multiple of
    # 16: whole k16 steps), the ring and the parked accumulators within
    # the shared memory, clusters of <= 8 that divide the splits, every
    # split non-empty, one wave at most
    shapes = [(1, 1, 524288, 64, 64, 1), (1, 1, 524288, 256, 16, 1),
              (1, 1, 8192, 1024, 2048, 1), (32, 128, 128, 64, 64, 3),
              (32, 16, 16, 512, 512, 3), (1, 7, 13, 24, 40, 3),
              (2, 9, 130, 64, 64, 3), (1, 1, 90, 8, 16, 1), (1, 1, 1, 8, 8, 1),
              (3, 1, 5, 8, 8, 3)]
    for n, h, w, ci, co, ks in shapes:
        p = CV.tma_dw_plan(n, h, w, ci, co, ks, 132)
        assert max(p.wb, p.hb) <= 256 and p.wb * p.hb == CV.KP
        assert CV.KP % 16 == 0 and p.bn in (64, 128, 256)
        two = p.two + 1
        stage = (two + p.bn // 64) * CV.BOX
        assert p.stages >= 2
        assert p.stages * (stage + 16) + 1024 <= 227 * 1024
        assert 2 * 64 * (p.bn + 8) * 4 <= p.stages * stage
        assert p.two == (ks * ks * -(-ci // 64) > 1)
        ntiles = n * -(-h // p.hb) * -(-w // p.wb)
        assert 1 <= p.splits <= ntiles and p.cluster in (1, 2, 4, 8)
        assert p.splits % p.cluster == 0
        tiles = -(-ks * ks * -(-ci // 64) // two) * -(-co // p.bn)
        assert tiles * p.splits <= max(132, tiles)
    # the narrow shapes (a channel count that is not a multiple of 8, the
    # head's Co = 2) take igemm_dw: 64-row tiles where kdim <= 64; its
    # chunks cover M exactly
    assert not CV.tma_takes(256, 2) and not CV.tma_takes(5, 8)
    assert CV.tma_takes(8, 16) and CV.tma_takes(24, 40)
    for m, kdim, co in ((524288, 64, 2), (8192, 2048, 2), (198, 216, 2),
                        (1, 9, 1), (140, 5, 3)):
        bm, bn, chunk, splits = CV.dw_plan(m, kdim, co, 132)
        assert bm == (64 if kdim <= 64 else 128)
        assert (bm, bn) in ((128, 128), (128, 64), (128, 32), (64, 128),
                            (64, 64))
        assert chunk % CV.BK == 0 and chunk * (splits - 1) < m <= \
            chunk * splits


# --------------------------------------------------------------------------
# what the route takes
# --------------------------------------------------------------------------


def resnet50_convs(n, h, w):
    """(x_shape NHWC, kernel, stride, SAME?, Co) of every ConvBN conv of
    pixellink_resnet50 on an (n, h, w) input, in JAX's terms: the 7x7/2
    stem and the stride-2 3x3s use slim's explicit pad (not SAME)."""
    convs = [((n, h, w, 3), 7, 2, False, 64)]
    hh, ww = -(-(-(-h // 2)) // 2), -(-(-(-w // 2)) // 2)  # stem, pool
    feats, cin = {"pool2": (hh, ww, 64)}, 64
    for b, (units, depth, db) in enumerate(zip(
            (3, 4, 6, 3), (256, 512, 1024, 2048), (64, 128, 256, 512))):
        for u in range(units):
            s = 2 if (u == units - 1 and b < 3) else 1
            if cin != depth:
                convs.append(((n, hh, ww, cin), 1, s, True, depth))
            convs.append(((n, hh, ww, cin), 1, 1, True, db))
            convs.append(((n, hh, ww, db), 3, s, s == 1, db))
            hh, ww = -(-hh // s), -(-ww // s)
            convs.append(((n, hh, ww, db), 1, 1, True, depth))
            cin = depth
        if b < 2:
            feats[f"pool{b + 3}"] = (hh, ww, cin)
    feats["pool5"] = (hh, ww, cin)
    for co in (2, 16):
        for key in ("pool5", "pool4", "pool3", "pool2"):
            fh, fw, c = feats[key]
            convs.append(((n, fh, fw, c), 1, 1, True, co))
    return convs


@pytest.mark.parametrize("nhw,counts", [
    ((32, 512, 512), (44, 13)), ((8, 768, 1280), (44, 13))])
def test_supported_takes_every_conv_the_jax_route_takes(nhw, counts):
    taken = {1: 0, 3: 0}
    for x_shape, k, s, same, co in resnet50_convs(*nhw):
        jax_takes = same and PCV.supported(x_shape, (k, k), (s, s), (1, 1),
                                           co)
        if jax_takes:
            assert CV.supported(x_shape, (k, k), (s, s), (1, 1), co), (
                x_shape, k, s, co)
            taken[k] += 1
    assert (taken[1], taken[3]) == counts


def test_supported_and_conv2d_refuse_what_the_kernels_do_not_take():
    ok = ((2, 8, 16, 16), (3, 3), (1, 1), (1, 1), 32)
    assert CV.supported(*ok)
    assert not CV.supported((2, 8, 16, 16), (3, 3), (1, 1), (2, 2), 32)
    assert not CV.supported((2, 8, 16, 16), (3, 3), (2, 2), (1, 1), 32)
    assert not CV.supported((1, 3, 5, 16), (1, 1), (2, 2), (1, 1), 32)
    assert not CV.supported((2, 8, 16, 16), (7, 7), (1, 1), (1, 1), 32)
    assert not CV.supported((2 ** 16, 64, 64, 8), (3, 3), (1, 1), (1, 1), 8)
    with pytest.raises(ValueError, match="does not take"):
        CV.conv2d(torch.zeros(1, 4, 6, 6), torch.zeros(4, 4, 5, 5))
    # the card's kernels take bfloat16 and float32, as the JAX route does:
    # float16 and float64 off the CPU raise
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match="bfloat16 or float32"):
            CV.conv2d(torch.zeros(1, 4, 6, 6, device="meta", dtype=dtype),
                      torch.zeros(4, 4, 3, 3, device="meta", dtype=dtype))
    # a tensor that is not on the CPU launches the kernel or raises: it
    # never falls back to the plain version
    meta = torch.zeros(4, 8, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        CV.matmul_rows(meta, torch.zeros(8, 2, device="meta",
                                         dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="CUDA"):
        CV.dw3(torch.zeros(1, 4, 6, 6, device="meta"),
               torch.zeros(1, 4, 6, 6, device="meta"))


def test_detect_forward_with_the_route_matches_jax(interpret, monkeypatch):
    """pixellink_tiny's eval forward (the BN fold) with PALLAS_CONVS on
    both sides: logits within 1e-4, and both sides routed convs."""
    rng = np.random.RandomState(5)
    images = rng.randint(0, 256, (2, 128, 128, 3)).astype(np.uint8)
    jmodel = build_jax_model("pixellink_tiny", dtype=jnp.float32)
    variables = perturb_bn(
        jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                             jnp.zeros((1, 128, 128, 3), jnp.float32)), rng)
    calls = {"jax": 0, "port": 0}

    def counted(side, fn):
        def wrapped(*args, **kw):
            calls[side] += 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(JL, "PALLAS_CONVS", True)
    monkeypatch.setattr(PCV, "conv2d", counted("jax", PCV.conv2d))
    monkeypatch.setattr(TL, "PALLAS_CONVS", True)
    monkeypatch.setattr(CV, "conv2d", counted("port", CV.conv2d))
    jout = jmodel.apply(variables, jnp.asarray(images))
    model = build_model("pixellink_tiny", dtype=torch.float32)
    model.load_state_dict(convert_variables(variables))
    with torch.inference_mode():
        tout = model(torch.from_numpy(images))
    # JAX: the 3x3s at 32x32 and 16x16 and the head's 1x1s from pool2 and
    # pool3; the port's route takes the same convs
    assert calls["jax"] == 6 and calls["port"] == 6
    for key in ("pixel_logits", "link_logits"):
        np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]),
                                   rtol=0, atol=1e-4, err_msg=key)


@pytest.mark.parametrize("flag,k,stride,explicit,hw,routed", [
    (True, 1, 1, False, (8, 16), True),   # M = 256 rows: _pick_bm blocks
    (True, 3, 1, False, (8, 16), True),   # W % 8 == 0, H banded by 8
    (True, 1, 2, False, (16, 32), True),  # SAME reads x[::2, ::2]
    (True, 1, 2, False, (15, 32), False),  # odd H: SAME pads
    (True, 1, 1, False, (6, 8), False),   # M = 96: no TPU row block
    (True, 3, 1, False, (8, 12), False),  # W % 8 != 0
    (True, 3, 2, True, (8, 16), False),   # slim's explicit pad, stride 2
    (True, 7, 1, False, (8, 16), False),
    (False, 3, 1, False, (8, 16), False),
    (None, 3, 1, False, (8, 16), False),  # None: on for CUDA tensors only
])
def test_convbn_takes_the_route_under_the_jax_conditions(
        monkeypatch, flag, k, stride, explicit, hw, routed):
    """models/layers.py:131-135: the route under PALLAS_CONVS, with SAME
    padding and a conv that ``supported`` takes, which are the shapes
    ``pallas_conv.supported`` takes; the output is the same either
    way."""
    monkeypatch.setattr(TL, "PALLAS_CONVS", flag)
    cbn = TL.ConvBN(8, 4, k, stride, explicit_pad=explicit)
    x = torch.randn(2, 8, *hw, generator=torch.Generator().manual_seed(k))
    assert cbn._routed(x) == routed
    with torch.no_grad():
        got = cbn(x)
        monkeypatch.setattr(TL, "PALLAS_CONVS", False)
        want = cbn(x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
