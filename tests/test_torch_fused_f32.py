"""The fused arm's float32 kernels, emulated on the CPU and held against
tensorflow_ocr_tpu's pallas_fused kernels in float32 (interpret mode).

The card's float32 fused kernels compute float32 products, not TF32 ones:
each operand is split into two TF32 values (hi = tf32(v), lo = tf32(v -
hi)) and the tensor cores sum lo.hi' + hi.lo' + hi.hi'
(csrc/wgmma.cuh). The emulations below follow the kernels' order:

- the forward and dX (csrc/conv_bwd.cuh tdx_f32, fused_conv.cu
  fused_conv_fwd_f32 / fused_conv_bwd_f32): each value of the A operand
  is put through the transform in float32 first (relu(x*a + b), or dy_eff
  = dy + ds0 + 2*y*ds1), zero where the pixel read lies outside the
  image, then split; a K step is 32 channels of one tap (in halo mode,
  ops/conv.py's plan with wb >= 64: the taps of one ky, kx innermost) and
  its twelve k8 instructions (4 of lo.hi', 4 of hi.lo', 4 of hi.hi') go
  to a fresh accumulator, then added to the f32 sum (at BN 64 or 128, the
  weight resident or streamed, each product's fragment prepared under the
  previous one's or after it: none of which changes a product); the
  statistics and dab are summed a tile at a time (each thread its two
  rows, the warp's 8 row slots by the xor shuffles' tree, the 8 warps in
  order), a CTA's tiles (the plan's tiles_of) in order in double, and the
  CTAs' entries in order in double;
- the dW (tdw_f32_tr with FusedTr32): X through relu(x*a + b) in the
  register A fragment and dY to dy_eff as it is transposed, in float32
  before the split, zero where the pixel read lies outside the image;
  then the route's dW order (test_torch_conv_f32.py dw_table) on
  ops/conv.py tma_dw_plan (aux and element size 4): the pixel tiles split
  over CTAs, runs of R k8 steps of 8 pixels (R = ops/conv.py DW32_RUN)
  each in a fresh accumulator pass by pass, added to the CTA's sum, the
  CTAs of a cluster in rank order, the clusters' tables in order in
  double (sum_tables_wide), as the CTAs' entries of the sums
  (reduce_parts_wide).

Each tensor-core instruction is emulated as its exact sum of products
added to the accumulator and rounded to nearest (test_torch_conv_f32.py).

Tolerance (test_torch_conv_f32.py's rule): against the float64 product
of the same float32 operands, the emulation and JAX's interpreted kernel
each lie within 4x the plain float32 version's error (the port's plain
versions on the CPU), so within 8x of each other; a one-pass TF32 emulation (hi.hi' alone)
misses by more than 10x that bound. The statistics and dab: the same 4x
rule, without the one-pass check. The boundary's plain versions against
JAX's float32 fused_boundary and its VJP: atol 1e-6 of the largest value
(the same float32 operations in the same order), sums rtol 1e-5 (another
order of summation).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_ocr_tpu.models import resnet as JR
from tensorflow_ocr_tpu.ops import pallas_fused as PF
from tensorflow_ocr_tpu_torch.models import resnet as TR
from tensorflow_ocr_tpu_torch.models.convert import (
    convert_variables,
    load_variables,
)
from tensorflow_ocr_tpu_torch.ops import conv as CV
from tensorflow_ocr_tpu_torch.ops import fused as FU
from test_torch_bottleneck import close, f32_batchnorm  # noqa: F401
from test_torch_conv_f32 import (MULTIPLE, SMS, dw_table, hold, im2col,
                                 max_err, passes)
from test_torch_fused_f32_plans import check_dx32
from test_torch_resnet import perturb_bn

torch.set_num_threads(1)
f32, f64 = np.float32, np.float64


@pytest.fixture
def interpret():
    PF.set_interpret(True)
    yield
    PF.set_interpret(False)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(
        0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def prologue(x, ab):
    """relu(x*a + b) in float32, rounded after each operation."""
    return np.maximum((x * ab[0]).astype(f32) + ab[1], 0).astype(f32)


def dy_eff(dy, y, ds):
    """dy + ds0 + 2*y*ds1 in float32, in the plain version's order."""
    return ((dy + ds[0]).astype(f32) + (2 * y * ds[1]).astype(f32)).astype(
        f32)


def geo_of(n, h, w, k):
    """The kernels' geometry: a 1x1's rows as one row of M pixels."""
    return (1, 1, n * h * w) if k == 1 else (n, h, w)


def tile_pixels(p, geo, t):
    """The 128 rows of tdx tile t (plan p) in order: row i is pixel (x0 +
    i % wb, y0 + i // wb) of its box, as a flat pixel index, -1 outside
    the image."""
    n, h, w = geo
    r = t // p.col_tiles
    tw, th = -(-w // p.wb), -(-h // p.hb)
    img, r = divmod(r, tw * th)
    y0, x0 = (r // tw) * p.hb, (r % tw) * p.wb
    return [(img * h + y0 + i // p.wb) * w + x0 + i % p.wb
            if x0 + i % p.wb < w and y0 + i // p.wb < h else -1
            for i in range(p.wb * p.hb)]


def fold(u, w, warps):
    """Column sums of u (or of u*w, fused multiply-adds) over a run of
    row blocks (T, 16 * warps, C), as the kernels add them in float32: each
    thread (warp, g) its rows g and g + 8 of the warp's 16, block by block;
    the warp's 8 threads by xor shuffles (4, 8, 16 lanes); then the warps
    in order."""
    t, _, c = u.shape
    us = u.reshape(t, warps, 2, 8, c).astype(f64)
    ws = None if w is None else w.reshape(t, warps, 2, 8, c).astype(f64)
    acc = np.zeros((warps, 8, c), f32)
    for i in range(t):
        for e2 in range(2):
            term = us[i, :, e2] if ws is None else us[i, :, e2] * ws[i, :, e2]
            acc = (acc + term).astype(f32)
    g = np.arange(8)
    for bit in (1, 2, 4):
        acc = (acc + acc[:, g ^ bit]).astype(f32)
    out = np.zeros(c, f32)
    for wi in range(warps):
        out = (out + acc[wi, 0]).astype(f32)
    return out


def tile_entries(p, geo, u, w=None):
    """tdx_f32's column sums of u (M, C) (or of u*w): one entry a row tile
    (row_tiles, C), each the fold of the tile's 128 rows (zero outside the
    image) over its 8 warps."""
    pad = np.zeros((1, u.shape[1]), f32)
    up = np.concatenate([u, pad])  # row -1: outside the image
    wp = None if w is None else np.concatenate([w, pad])
    entries = np.zeros((p.row_tiles, u.shape[1]), f32)
    for r in range(p.row_tiles):
        idx = np.array(tile_pixels(p, geo, r * p.col_tiles))
        entries[r] = fold(up[idx][None], None if w is None else wp[idx][None],
                          8)
    return entries


def cta_sums(p, geo, u, w=None):
    """Column sums of u (M, C) (or u*w) as the fused tdx_f32 adds them:
    each tile's fold (tile_entries), a CTA's tiles (the plan's tiles_of)
    added in order in double and rounded once into its entry, a column's
    entries added in order in double (reduce_parts_wide), rounded once."""
    entries = tile_entries(p, geo, u, w)
    out = np.zeros(u.shape[1], f32)
    for col in range(p.col_tiles):
        cols = slice(col * p.bn, (col + 1) * p.bn)
        tot = np.zeros(p.bn, f64)
        for cta in range(col, p.grid, p.col_tiles):
            run = np.zeros(p.bn, f64)
            for t in p.tiles_of(cta):
                run = run + entries[t // p.col_tiles, cols]
            tot = tot + run.astype(f32)
        out[cols] = tot
    return out


def emulate_tdx(a, wt, k, halo, one_pass=False):
    """tdx_f32's product: a (N, H, W, C) the transformed A operand, wt
    (Co, k*k*C) with K in (ky, kx, c) order; per K step (tap, 32
    channels) in the kernel's order, 4 k8 steps of each pass into a fresh
    accumulator added to the f32 sum. Returns (N*H*W, Co)."""
    c = a.shape[-1]
    cols = im2col(a, k)
    if halo:
        steps = [(ky * k + kx, c0) for ky in range(k)
                 for c0 in range(0, c, 32) for kx in range(k)]
    else:
        steps = [(tap, c0) for tap in range(k * k) for c0 in range(0, c, 32)]
    out = np.zeros((cols.shape[0], wt.shape[0]), f32)
    for tap, c0 in steps:
        ks = slice(tap * c + c0, tap * c + c0 + 32)
        acc = np.zeros_like(out)
        for pa, pb in passes(cols[:, ks], wt[:, ks], one_pass):
            for k8 in range(0, 32, 8):
                acc = (acc.astype(f64) + pa[:, k8:k8 + 8].astype(f64)
                       @ pb[:, k8:k8 + 8].T.astype(f64)).astype(f32)
        out = out + acc
    return out


def emulate_dw(xa, dye, k, one_pass=False, run=CV.DW32_RUN):
    """tdw_f32_tr with FusedTr32 on the transformed xa (N, H, W, Ci) and
    dye (N, H, W, Co), runs of `run` k8 steps: the (k*k*Ci, Co) table in
    the kernel's order of summation (module docstring), on
    tma_dw_plan(..., aux=4, esize=4)."""
    n, h, w, ci = xa.shape
    co = dye.shape[-1]
    geo = geo_of(n, h, w, k)
    p = CV.tma_dw_plan(*geo, ci, co, k, SMS, 4, 4)
    return dw_table(im2col(xa, k).reshape(*geo, k * k * ci),
                    dye.reshape(*geo, co), p, one_pass, run)


def wflip_rows(wk):
    """(k, k, Ci, Co) -> the dX weight (Ci, k*k*Co), K in (ky, kx, co)
    order of the flipped kernel."""
    k, _, ci, co = wk.shape
    return np.ascontiguousarray(
        wk[::-1, ::-1].transpose(2, 0, 1, 3).reshape(ci, k * k * co))


def fused_case(seed, n, h, w, ci, co, k):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h, w, ci).astype(f32)
    # nonzero b: relu(b) != 0 at a pad, so the pad-after-prologue matters
    ab = np.stack([rng.uniform(0.5, 1.5, ci),
                   rng.randn(ci) * 0.5 + 0.3]).astype(f32)
    wk = (rng.randn(k, k, ci, co) / np.sqrt(k * k * ci)).astype(f32)
    dy = rng.randn(n, h, w, co).astype(f32)
    ds = np.stack([rng.randn(co) * 0.3, rng.randn(co) * 0.1]).astype(f32)
    return x, ab, wk, dy, ds


def hold_sums(name, emu, plain, jax_out, exact):
    """The 4x rule for the float32 sums (s, dab): the emulation and JAX's
    kernel each within MULTIPLE x the plain version's error."""
    e_plain = max_err(plain, exact)
    assert max_err(emu, exact) <= MULTIPLE * e_plain, (name, e_plain)
    assert max_err(jax_out, exact) <= MULTIPLE * e_plain, (name, e_plain)


def jax_fused(x, ab, wk, dy, ds, y):
    """JAX's float32 fused kernels (interpret mode): (y (M, Co), s, dx (M,
    Ci), dab, dw (k*k*Ci, Co)); the backward at the port's plain y."""
    n, h, w, ci = x.shape
    k, co = wk.shape[0], wk.shape[-1]
    m = n * h * w
    j = jnp.asarray
    if k == 1:
        bm = PF.pick_bm(m, ci, co)
        jy, js = PF._f1x1(j(x.reshape(m, ci)), j(ab), j(wk[0, 0]), bm)
        dx, dab, dw = PF._fused_conv1x1_bwd(
            bm, (j(x), j(ab), j(wk[0, 0]), j(y)), (j(dy), j(ds)))
    else:
        th = PF.pick_th(h, w, ci, co)
        w2 = j(wk.reshape(9 * ci, co))
        xp = jnp.pad(j(x), ((0, 0), (1, 1), (0, 0), (0, 0)))
        jy, js = PF._f3x3(xp, j(ab), w2, th)
        dx, dab, dw = PF._fused_conv3x3_bwd(th, (j(x), j(ab), w2, j(y)),
                                            (j(dy), j(ds)))
    return [np.asarray(v) for v in (jy.reshape(m, co), js,
                                    dx.reshape(m, ci), dab,
                                    dw.reshape(k * k * ci, co))]


@pytest.mark.parametrize("n,h,w,ci,co,k", [
    # 1x1 over 512 rows: 4 tiles of 128; the forward at BN 128, both
    # weights resident
    (2, 16, 16, 64, 128, 1),
    # the forward's weight resident at BN 64, the dX at BN 128 streamed
    (1, 16, 32, 128, 64, 1),
    (1, 16, 20, 64, 64, 3),     # 32 x 4 boxes: a ragged edge, the pad taps
    (1, 8, 120, 64, 64, 3),     # halo mode: 128-pixel rows, ragged at 120
    (1, 8, 32, 128, 128, 3),    # a 3x3 at BN 128: 32 x 4 boxes
    # 64-pixel rows at 128 columns: 32 x 4 boxes at BN 128, not halo mode
    (1, 8, 64, 128, 128, 3),
])
def test_fused_f32_kernels_emulated_against_jax(interpret, n, h, w, ci, co,
                                                k):
    x, ab, wk, dy, ds = fused_case(ci + co + w, n, h, w, ci, co, k)
    m = n * h * w
    geo = geo_of(n, h, w, k)
    tw = torch.from_numpy(np.ascontiguousarray(wk.transpose(3, 2, 0, 1)))
    targs = (nchw(x), torch.from_numpy(ab), tw)
    py, ps = FU.conv_fwd_reference(*targs)
    y = nhwc(py)  # the forward's output, an input of the backward
    pdx, pdab, pdw = FU.conv_bwd_reference(*targs, py, nchw(dy),
                                           torch.from_numpy(ds))
    jy, js, jdx, jdab, jdw = jax_fused(x, ab, wk, dy, ds, y)

    # the forward: tdx_f32 on relu(x*a + b), the kernel's plan
    pf = CV.tma_staged_fwd_plan(*geo, ci, co, k, SMS, esize=4)
    check_dx32(pf, 0, k * k * ci, co, k)
    assert pf.halo == (k == 3 and w >= 64 and co % 128 != 0)
    xa = prologue(x, ab)
    wt = np.ascontiguousarray(wk.reshape(k * k * ci, co).T)
    ey = emulate_tdx(xa, wt, k, pf.halo)
    exact_y = im2col(xa, k).astype(f64) @ wk.reshape(-1, co).astype(f64)
    hold("y", ey, emulate_tdx(xa, wt, k, pf.halo, one_pass=True),
         py.permute(0, 2, 3, 1).reshape(m, co).numpy(), jy, exact_y)
    es = np.stack([cta_sums(pf, geo, ey), cta_sums(pf, geo, ey, ey)])
    hold_sums("s", es, ps.numpy(), js,
              np.stack([exact_y.sum(0), (exact_y ** 2).sum(0)]))

    # dX: tdx_f32 on dy_eff with the flipped kernel, masked in the
    # epilogue; dab per CTA
    px = CV.tma_bwd_dx_plan(*geo, ci, co, k, SMS, 4, True, esize=4)
    check_dx32(px, 4, k * k * co, ci, k)
    dye = dy_eff(dy, y, ds)
    wf = wflip_rows(wk)
    live = ((x * ab[0]).astype(f32) + ab[1] > 0).reshape(m, ci)
    x2 = x.reshape(m, ci)
    exact_g = im2col(dye, k).astype(f64) @ wf.T.astype(f64)

    def finish(g):
        gm = np.where(live, g, 0).astype(g.dtype)
        return gm, (gm * ab[0]).astype(g.dtype)

    gm, edx = finish(emulate_tdx(dye, wf, k, px.halo))
    hold("dx", edx, finish(emulate_tdx(dye, wf, k, px.halo, True))[1],
         pdx.permute(0, 2, 3, 1).reshape(m, ci).numpy(), jdx,
         finish(exact_g)[1])
    edab = np.stack([cta_sums(px, geo, gm, x2), cta_sums(px, geo, gm)])
    xgm = finish(exact_g)[0]
    hold_sums("dab", edab, pdab.numpy(), jdab,
              np.stack([(xgm * x2).sum(0), xgm.sum(0)]))

    # dW: tdw_f32 on the staged relu(x*a + b) and dy_eff
    pdw = pdw.permute(2, 3, 1, 0).reshape(k * k * ci, co).numpy()
    hold("dw", emulate_dw(xa, dye, k), emulate_dw(xa, dye, k, True), pdw,
         jdw, im2col(xa, k).astype(f64).T @ dye.reshape(m, co).astype(f64))


@pytest.mark.parametrize("run", [1, 2, 4])
@pytest.mark.parametrize("n,h,w,ci,co,k", [
    (2, 16, 16, 64, 128, 1),    # one chunk: each warpgroup half a tile
    (1, 16, 32, 128, 64, 1),    # two chunks: a warpgroup each, whole tiles
    (1, 16, 20, 64, 64, 3),     # a 3x3: the pad taps, a ragged edge
])
def test_dw_runs(interpret, run, n, h, w, ci, co, k):
    """The fused backward's dW emulated with each run length the kernel
    takes (1, 2 or 4 k8 steps a fresh accumulator; DW32_RUN picks one)
    against JAX's interpreted _fused_conv1x1_bwd / _fused_conv3x3_bwd and
    the plain float32 version, under the float32 rule (a one-pass TF32
    emulation failing it)."""
    x, ab, wk, dy, ds = fused_case(ci + co + w + run, n, h, w, ci, co, k)
    tw = torch.from_numpy(np.ascontiguousarray(wk.transpose(3, 2, 0, 1)))
    targs = (nchw(x), torch.from_numpy(ab), tw)
    py, _ = FU.conv_fwd_reference(*targs)
    y = nhwc(py)
    _, _, pdw = FU.conv_bwd_reference(*targs, py, nchw(dy),
                                      torch.from_numpy(ds))
    jdw = jax_fused(x, ab, wk, dy, ds, y)[4]
    xa, dye = prologue(x, ab), dy_eff(dy, y, ds)
    pdw = pdw.permute(2, 3, 1, 0).reshape(k * k * ci, co).numpy()
    hold(f"dw run {run}", emulate_dw(xa, dye, k, run=run),
         emulate_dw(xa, dye, k, True, run), pdw, jdw,
         im2col(xa, k).astype(f64).T
         @ dye.reshape(n * h * w, co).astype(f64))


def boundary_blocks32(m, c, sms):
    """(rows a pass of a block, blocks) of csrc/fused_boundary.cu shape()
    in float32: 4 channels a 16-byte vector."""
    cvecs = c // 4
    rows = 1 if cvecs >= 256 else 256 // cvecs
    return rows, min(-(-m // rows), 8 * sms)


def emulate_boundary_bwd_sums32(g, z, ab, zs, abs_, sms, stride_rows=True):
    """dab, dabs of fused_boundary_bwd_f32 summed as the kernel sums them
    (test_torch_fused.py's emulation at 4 channels a thread): thread
    (block b, row group r) adds rows b*rows + r + k*stride, the block its
    row groups' partials in order, bnd_sum the blocks' in 32 runs of
    consecutive blocks, then the runs."""
    m, c = z.shape
    pre = ((((z * ab[0]).astype(f32) + ab[1]).astype(f32)
            + (zs * abs_[0]).astype(f32)).astype(f32) + abs_[1]).astype(f32)
    gm = np.where(pre > 0, g, f32(0))
    vals = np.stack([gm * z, gm * zs, gm])
    rows, blocks = boundary_blocks32(m, c, sms)
    stride = blocks * rows if stride_rows else rows
    acc = np.zeros((3, blocks, rows, c), f32)
    for bi in range(blocks):
        for r in range(rows):
            for row in range(bi * rows + r, m, stride):
                acc[:, bi, r] += vals[:, row]
    part = np.zeros((3, blocks, c), f32)
    for r in range(rows):
        part += acc[:, :, r]
    run_len = -(-blocks // 32)
    tot = np.zeros((3, c), f32)
    for y in range(32):
        run = np.zeros((3, c), f32)
        for bi in range(y * run_len, min(blocks, (y + 1) * run_len)):
            run += part[:, bi]
        tot += run
    return np.stack([tot[0], tot[2]]), np.stack([tot[1], tot[2]])


def boundary_case(seed, n, h, w, c):
    rng = np.random.RandomState(seed)
    z, zs, g = (rng.randn(n, h, w, c).astype(f32) for _ in range(3))
    ab, abs_ = (np.stack([rng.uniform(0.5, 1.5, c), rng.randn(c)]).astype(
        f32) for _ in range(2))
    return z, zs, g, ab, abs_


def test_fused_boundary_f32_matches_jax_kernel_and_vjp(interpret):
    """JAX's float32 fused_boundary on its Pallas kernels (M a multiple of
    256) and their VJP against the port's plain versions."""
    n, h, w, c = 2, 16, 16, 64
    assert PF.pick_bm_bnd(n * h * w, c) and PF.pick_bm_bnd(n * h * w, c, 5)
    z, zs, g, ab, abs_ = boundary_case(7, n, h, w, c)
    j = jnp.asarray
    jout, vjp = jax.vjp(PF.fused_boundary, j(z), j(ab), j(zs), j(abs_))
    jdz, jdab, jdzs, jdabs = vjp(j(g))
    targs = (nchw(z), torch.from_numpy(ab), nchw(zs), torch.from_numpy(abs_))
    out = FU.boundary_fwd_reference(*targs)
    dz, dab, dzs, dabs = FU.boundary_bwd_reference(nchw(g), *targs)
    assert out.dtype == dz.dtype == dzs.dtype == torch.float32
    for name, got, want in (("out", nhwc(out), jout), ("dz", nhwc(dz), jdz),
                            ("dzs", nhwc(dzs), jdzs)):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max(),
                                   err_msg=name)
    for name, got, want in (("dab", dab, jdab), ("dabs", dabs, jdabs)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)


# one SM: 8 blocks, fewer than the rows need, so every block's threads
# take several passes of the grid-stride loop
@pytest.mark.parametrize("n,h,w,c,sms", [
    (2, 20, 20, 24, 1),    # 42 row groups a block of 252 threads
    (1, 12, 10, 256, 1),   # 4 row groups a block of 256
    (1, 3, 5, 4096, 1),    # one row a block of 1024 threads
])
def test_boundary_bwd_f32_block_split_emulation(n, h, w, c, sms):
    z, zs, g, ab, abs_ = boundary_case(c + sms, n, h, w, c)
    _, dab, _, dabs = FU.boundary_bwd_reference(
        nchw(g), nchw(z), torch.from_numpy(ab), nchw(zs),
        torch.from_numpy(abs_))
    m = n * h * w
    flat = [a.reshape(m, c) for a in (g, z, zs)]
    edab, edabs = emulate_boundary_bwd_sums32(*flat[:2], ab, flat[2], abs_,
                                              sms)
    close(edab, dab, 1e-4, "dab")
    close(edabs, dabs, 1e-4, "dabs")
    rows, blocks = boundary_blocks32(m, c, sms)
    assert blocks * rows < m and rows * c // 4 <= 1024
    bad, _ = emulate_boundary_bwd_sums32(*flat[:2], ab, flat[2], abs_, sms,
                                         stride_rows=False)
    with pytest.raises(AssertionError):
        close(bad, dab, 1e-4, "dab")


@pytest.mark.parametrize("depth_in,depth,db", [(64, 64, 64), (64, 128, 64)])
def test_fused_bottleneck_f32_matches_jax_fused_bottleneck(
        interpret, f32_batchnorm, depth_in, depth, db):
    """A float32 train-mode unit: JAX's FusedBottleneck on its float32
    Pallas kernels (interpreted) against the port's FusedBottleneck in
    float32 (the plain versions on the CPU): output, BN running
    statistics, parameter gradients and dx within rtol 1e-4 and atol 1e-4
    of the largest value (tests/test_torch_fused.py's tolerance)."""
    rng = np.random.RandomState(depth + db)
    x = np.maximum(rng.randn(2, 16, 16, depth_in), 0).astype(f32)
    g = rng.randn(2, 16, 16, depth).astype(f32)
    ref = JR.FusedBottleneck(depth, db, dtype=jnp.float32)
    variables = perturb_bn(ref.init(jax.random.PRNGKey(0), jnp.asarray(x)),
                           rng)

    def loss(params, xin):
        y, mut = ref.apply({"params": params,
                            "batch_stats": variables["batch_stats"]},
                           xin, train=True, mutable=["batch_stats"])
        return jnp.sum(y * g), (y, mut)

    (_, (want, mutated)), (jgrads, jdx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables["params"],
                                            jnp.asarray(x))
    port = load_variables(TR.FusedBottleneck(depth_in, depth, db), variables)
    tx = nchw(x).requires_grad_()
    got = port(tx, train=True)
    assert got.dtype == torch.float32
    close(nhwc(got), want, 1e-4, "y")
    for key, value in convert_variables(
            {"batch_stats": mutated["batch_stats"]}).items():
        close(port.state_dict()[key], value, 1e-4, key)
    (got * nchw(g)).sum().backward()
    for key, value in convert_variables({"params": jgrads}).items():
        close(dict(port.named_parameters())[key].grad, value.numpy(), 1e-4,
              key)
    close(nhwc(tx.grad), jdx, 1e-4, "dx")
