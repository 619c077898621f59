"""The route's float32 kernels, emulated on the CPU and held against
tensorflow_ocr_tpu's pallas_conv kernels in float32 (interpret mode).

The card's float32 kernels compute a float32 product, not a TF32 one: each
operand is split into two TF32 values, hi = tf32(x) and lo = tf32(x - hi),
rounded to nearest with ties away from zero (cvt.rna), and the tensor cores
sum hi.hi' + hi.lo' + lo.hi' (csrc/wgmma.cuh). The emulations below follow
the kernels' order of summation:

- the forward (csrc/conv_fwd.cu conv_fwd_tma_f32: matmul_rows, conv3 and
  their dX): a K step is 32 channels of one tap; its twelve k8
  instructions (4 of lo.hi', 4 of hi.lo', 4 of hi.hi') go to a fresh
  accumulator, which is then added to the f32 sum;
- the dW (csrc/conv_bwd.cuh tdw_f32_wg: dw_rows, dw3): the pixel tiles
  of ops/conv.py tma_dw_plan (4-byte elements) split over CTAs; in each
  64-pixel tile (a warpgroup's half of it where both take one chunk) a run
  of R k8 steps of 8 pixels (R = ops/conv.py DW32_RUN) goes to a fresh
  accumulator pass by pass (the run's lo.hi' products, then its hi.lo',
  then its hi.hi'), which is then added to the CTA's sum; the CTAs of a
  cluster summed in rank order (the two warpgroups' halves within a rank),
  the clusters' tables in order in double (sum_tables_wide; dw_table,
  which the fused and ghost backwards' emulations share).

Each tensor-core instruction is emulated as its exact sum of products
added to the accumulator and rounded to nearest (the hardware truncates;
the kernels keep that inside a K step or a tile).

Tolerance: the emulation's largest error against the float64 product is at
most 4x the plain float32 version's (the port's plain versions on the CPU,
TF32 off), and so is JAX's interpreted kernel's: two float32 products,
each within that bound of the exact one, so within twice it of each other
(their sums run in other orders). A one-pass TF32 emulation (hi.hi' alone)
misses the bound by far.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_ocr_tpu.ops import pallas_conv as PCV
from tensorflow_ocr_tpu_torch.ops import conv as CV

torch.set_num_threads(1)
CL = torch.channels_last
MULTIPLE = 4.0
SMS = 132  # the H100's SMs: the dW split of the card


@pytest.fixture
def interpret():
    PCV.set_interpret(True)
    yield
    PCV.set_interpret(False)


def tf32(a):
    """a (float32) rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero: cvt.rna.tf32.f32."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def split(a):
    hi = tf32(a)
    return hi, tf32(a - hi)


def passes(a, b, one_pass):
    """The (A, B) operand pairs of the kernels' products, in order."""
    (ah, al), (bh, bl) = split(a), split(b)
    return [(ah, bh)] if one_pass else [(al, bh), (ah, bl), (ah, bh)]


def im2col(x, k):
    """x (N, H, W, C) -> (N*H*W, k*k*C), K in (ky, kx, c) order, SAME."""
    n, h, w, c = x.shape
    if k == 1:
        return x.reshape(-1, c)
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    cols = [xp[:, ky:ky + h, kx:kx + w] for ky in range(3)
            for kx in range(3)]
    return np.concatenate(cols, axis=-1).reshape(n * h * w, 9 * c)


def emulate_fwd(a, wt, taps, ci, one_pass=False):
    """conv_fwd_tma_f32 on im2col rows a (M, taps*ci) and wt (Co,
    taps*ci): per K step (tap, 32 channels) 4 k8 steps of each pass into a
    fresh accumulator, added to the f32 sum."""
    out = np.zeros((a.shape[0], wt.shape[0]), np.float32)
    for tap in range(taps):
        for c0 in range(0, ci, 32):
            ks = slice(tap * ci + c0, tap * ci + min(c0 + 32, ci))
            acc = np.zeros_like(out)
            for pa, pb in passes(a[:, ks], wt[:, ks], one_pass):
                for k8 in range(0, pa.shape[1], 8):
                    acc = (acc.astype(np.float64)
                           + pa[:, k8:k8 + 8].astype(np.float64)
                           @ pb[:, k8:k8 + 8].T.astype(np.float64)
                           ).astype(np.float32)
            out = out + acc
    return out


def emulate_dw(x, dy, k, one_pass=False, run=CV.DW32_RUN):
    """tdw_f32_wg on x (N, H, W, Ci), dy (N, H, W, Co) with runs of `run`
    k8 steps: the (k*k*Ci, Co) table in the kernel's order of summation
    (module docstring)."""
    n, h, w, ci = x.shape
    co = dy.shape[-1]
    geo = (1, 1, n * h * w) if k == 1 else (n, h, w)
    p = CV.tma_dw_plan(*geo, ci, co, k, SMS, 0, 4)
    return dw_table(im2col(x, k).reshape(*geo, k * k * ci),
                    dy.reshape(*geo, co), p, one_pass, run)


def dw_table(cols, dys, p, one_pass=False, run=CV.DW32_RUN):
    """The float32 dW's table (csrc/conv_bwd.cuh tdw_f32_wg, and
    tdw_f32_tr on its staged operands) from cols (N, H, W, K) and dys (N,
    H, W, Co) of the plan p: the pixel tiles (wb x hb boxes, zero past the
    image) split over CTAs; in each tile (a warpgroup's half of it where
    both take one chunk) a run of `run` k8 steps of 8 pixels goes to a
    fresh accumulator pass by pass (the run's lo.hi' products, then its
    hi.lo', then its hi.hi'), then added to the CTA's sum; the CTAs of a
    cluster in rank order (then a rank's halves), the clusters' tables in
    order in double (sum_tables_wide)."""
    n, h, w, kdim = cols.shape
    co = dys.shape[-1]
    tw, th = -(-w // p.wb), -(-h // p.hb)
    ntiles = n * th * tw

    def tile(t):
        """The tile's pixels (box rows in order), zero past the image."""
        img, t = divmod(t, th * tw)
        y0, x0 = (t // tw) * p.hb, (t % tw) * p.wb
        a = np.zeros((p.hb, p.wb, kdim), np.float32)
        d = np.zeros((p.hb, p.wb, co), np.float32)
        ca = cols[img, y0:y0 + p.hb, x0:x0 + p.wb]
        a[:ca.shape[0], :ca.shape[1]] = ca
        d[:ca.shape[0], :ca.shape[1]] = dys[img, y0:y0 + p.hb, x0:x0 + p.wb]
        return a.reshape(64, -1), d.reshape(64, co)

    halves = (slice(0, 64),) if p.two else (slice(0, 32), slice(32, 64))
    sums = []  # per split: per warpgroup half, the CTA's sum
    for z in range(p.splits):
        lo, hi = z * ntiles // p.splits, (z + 1) * ntiles // p.splits
        part = [np.zeros((kdim, co), np.float32) for _ in halves]
        for t in range(lo, hi):
            a, d = tile(t)
            for i, px in enumerate(halves):
                for r0 in range(px.start, px.stop, 8 * run):
                    acc = np.zeros((kdim, co), np.float32)
                    rs = slice(r0, r0 + 8 * run)
                    for pa, pb in passes(a[rs], d[rs], one_pass):
                        for k8 in range(0, 8 * run, 8):
                            acc = (acc.astype(np.float64) + pa[k8:k8 + 8].T
                                   .astype(np.float64)
                                   @ pb[k8:k8 + 8].astype(np.float64)
                                   ).astype(np.float32)
                    part[i] = part[i] + acc
        sums.append(part)
    out = np.zeros((kdim, co), np.float64)
    for c0 in range(0, p.splits, p.cluster):
        s = np.zeros((kdim, co), np.float32)
        for q in range(c0, c0 + p.cluster):  # ranks in order, then halves
            for half in sums[q]:
                s = s + half
        out = out + s
    return out.astype(np.float32)


def max_err(got, want):
    return float(np.abs(np.asarray(got, np.float64)
                        - np.asarray(want, np.float64)).max())


def hold(name, emu, one, plain, jax_out, exact):
    """The float32 rule: the emulation and JAX's kernel each within
    MULTIPLE x the plain version's error of the float64 product (so within
    twice that of each other); the one-pass TF32 emulation beyond it."""
    e_plain = max_err(plain, exact)
    e_emu, e_jax = max_err(emu, exact), max_err(emu, jax_out)
    e_one = max_err(one, exact)
    assert max_err(jax_out, exact) <= MULTIPLE * e_plain, name
    assert e_emu <= MULTIPLE * e_plain, (name, e_emu, e_plain)
    assert e_jax <= 2 * MULTIPLE * e_plain, (name, e_jax, e_plain)
    assert e_one > 10 * MULTIPLE * e_plain, (name, e_one, e_plain)


def inputs(seed, *shapes):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("ci,co", [(64, 64), (64, 256), (256, 64),
                                   (40, 16)])
def test_matmul_rows_and_dw_rows(interpret, ci, co):
    """1x1 forward, dX and dW over 64x64 pixel rows of two images."""
    m = 2 * 64 * 64
    x2, w2, dy2 = inputs(ci + co, (m, ci), (ci, co), (m, co))
    w2 /= np.sqrt(ci)
    bm = PCV._pick_bm(m, max(ci, co), co)
    jy = np.asarray(PCV._matmul_rows(jnp.asarray(x2), jnp.asarray(w2), bm))
    jdx = np.asarray(PCV._matmul_rows(jnp.asarray(dy2),
                                      jnp.asarray(w2.T.copy()), bm))
    jdw = np.asarray(PCV._dw_rows(jnp.asarray(x2), jnp.asarray(dy2), bm))
    t = torch.from_numpy
    for name, a, wt, jout in (("y", x2, w2.T, jy), ("dx", dy2, w2, jdx)):
        wt = np.ascontiguousarray(wt)
        kin = wt.shape[1]
        hold(name, emulate_fwd(a, wt, 1, kin),
             emulate_fwd(a, wt, 1, kin, one_pass=True),
             CV.matmul_rows_reference(t(a), t(wt.T.copy())).numpy(), jout,
             a.astype(np.float64) @ wt.T.astype(np.float64))
    x4, dy4 = x2.reshape(1, 1, m, ci), dy2.reshape(1, 1, m, co)
    hold("dw", emulate_dw(x4, dy4, 1), emulate_dw(x4, dy4, 1, True),
         CV.dw_rows_reference(t(x2), t(dy2)).numpy(), jdw,
         x2.T.astype(np.float64) @ dy2.astype(np.float64))


@pytest.mark.parametrize("ci,co,hw", [(32, 32, (64, 64)), (64, 64, (32, 48)),
                                      (128, 32, (16, 16))])
def test_conv3_and_dw3(interpret, ci, co, hw):
    """3x3 forward, dX (the flipped, channel-swapped kernel) and dW."""
    h, w = hw
    x, wk, dy = inputs(ci * co + h, (1, h, w, ci), (3, 3, ci, co),
                       (1, h, w, co))
    wk /= np.sqrt(9 * ci)
    th = PCV._pick_th(h, w, max(ci, co))
    w2 = wk.reshape(9 * ci, co)
    wflip = np.ascontiguousarray(
        np.swapaxes(wk[::-1, ::-1], 2, 3).reshape(9 * co, ci))
    pad = ((0, 0), (1, 1), (0, 0), (0, 0))
    jy = np.asarray(PCV._conv3(jnp.pad(jnp.asarray(x), pad), jnp.asarray(w2),
                               th)).reshape(-1, co)
    jdx = np.asarray(PCV._conv3(jnp.pad(jnp.asarray(dy), pad),
                                jnp.asarray(wflip), th)).reshape(-1, ci)
    jdw = np.asarray(PCV._dw3(jnp.pad(jnp.asarray(x), pad), jnp.asarray(dy),
                              th)).reshape(9 * ci, co)

    def nchw(a):
        return torch.from_numpy(a).permute(0, 3, 1, 2).contiguous(
            memory_format=CL)

    def plain_fwd(a, wmat, cin, cout):
        wt = torch.from_numpy(wmat.reshape(3, 3, cin, cout)).permute(3, 2, 0,
                                                                      1)
        return CV.conv3_reference(nchw(a), wt).permute(0, 2, 3, 1).reshape(
            -1, cout).numpy()

    for name, a, wmat, cin, cout, jout in (
            ("y", x, w2, ci, co, jy), ("dx", dy, wflip, co, ci, jdx)):
        cols = im2col(a, 3)
        wt = np.ascontiguousarray(wmat.T)  # (Co, 9*Ci): the kernel's wt
        hold(name, emulate_fwd(cols, wt, 9, cin),
             emulate_fwd(cols, wt, 9, cin, one_pass=True),
             plain_fwd(a, wmat, cin, cout), jout,
             cols.astype(np.float64) @ wmat.astype(np.float64))
    hold("dw", emulate_dw(x, dy, 3), emulate_dw(x, dy, 3, True),
         CV.dw3_reference(nchw(x), nchw(dy)).numpy(), jdw,
         im2col(x, 3).T.astype(np.float64) @ dy.reshape(-1, co).astype(
             np.float64))



@pytest.mark.parametrize("run", [1, 2, 4])
@pytest.mark.parametrize("ci,co,k,hw", [(64, 256, 1, (64, 64)),
                                        (256, 64, 1, (64, 64)),
                                        (32, 32, 3, (64, 64))])
def test_dw_runs(interpret, run, ci, co, k, hw):
    """The dW emulated with each run length the kernel takes (1, 2 or 4 k8
    steps a fresh accumulator; DW32_RUN picks one) against JAX's
    interpreted _dw_rows / _dw3: one chunk (both warpgroups on halves of a
    tile, a run of 4 a whole half) and two chunks of a 1x1, and a 3x3."""
    h, w = hw
    x, dy = inputs(ci + co + k + run, (2, h, w, ci), (2, h, w, co))
    x2, dy2 = x.reshape(-1, ci), dy.reshape(-1, co)
    t = torch.from_numpy
    if k == 1:
        bm = PCV._pick_bm(x2.shape[0], max(ci, co), co)
        jdw = np.asarray(PCV._dw_rows(jnp.asarray(x2), jnp.asarray(dy2), bm))
        geo = (1, 1, x2.shape[0])
        plain = CV.dw_rows_reference(t(x2), t(dy2)).numpy()
    else:
        pad = ((0, 0), (1, 1), (0, 0), (0, 0))
        th = PCV._pick_th(h, w, max(ci, co))
        jdw = np.asarray(PCV._dw3(jnp.pad(jnp.asarray(x), pad),
                                  jnp.asarray(dy), th)).reshape(9 * ci, co)
        geo = (2, h, w)

        def nchw(a):
            return t(a).permute(0, 3, 1, 2).contiguous(memory_format=CL)

        plain = CV.dw3_reference(nchw(x), nchw(dy)).numpy()
    xs, dys = x.reshape(*geo, ci), dy.reshape(*geo, co)
    hold(f"dw run {run}", emulate_dw(xs, dys, k, run=run),
         emulate_dw(xs, dys, k, True, run=run), plain, jdw,
         im2col(x, k).T.astype(np.float64)
         @ dy2.astype(np.float64))

def test_tf32_split_is_the_rna_rounding():
    """hi keeps 10 mantissa bits, rounded to nearest with ties away from
    zero; hi + lo is x to within 2^-22 |x|."""
    x = np.array([1 + 2 ** -11, 1 + 3 * 2 ** -11, -(1 + 2 ** -11), 1.0,
                  1 + 2 ** -12], np.float32)
    np.testing.assert_array_equal(
        tf32(x), np.array([1 + 2 ** -10, 1 + 2 ** -9, -(1 + 2 ** -10), 1.0,
                           1.0], np.float32))
    r = np.random.RandomState(0).randn(10000).astype(np.float32)
    hi, lo = split(r)
    assert np.all(np.abs(r.astype(np.float64) - hi - lo)
                  <= 2.0 ** -22 * np.abs(r))
    assert np.all((hi.view(np.uint32) & 0x1FFF) == 0)
    assert np.all((lo.view(np.uint32) & 0x1FFF) == 0)
