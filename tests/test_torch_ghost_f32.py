"""The ghost unit's float32 kernels, emulated on the CPU and held against a
float64 product and against tensorflow_ocr_tpu's pallas_unit in float32
(interpret mode).

The card's float32 ghost kernels compute float32 products, not TF32 ones:
each operand is split into two TF32 values (hi = tf32(v), lo = tf32(v -
hi)) and the tensor cores sum lo.hi' + hi.lo' + hi.hi' (csrc/wgmma.cuh).
The emulations below follow the kernels' order:

- the forward (csrc/conv_bwd.cuh tdx_f32 with ghost_unit.cu's
  BandActTr32): each value of the A operand is put through relu(x*a + b)
  under the table of the OUTPUT pixel's band in float32 (a 3x3's halo rows,
  read from the neighbouring band, under the reading band's table), zero
  only outside the image, then split; a K step is 32 channels of one tap
  (halo mode: the taps of one ky, kx innermost), its twelve k8
  instructions in a fresh accumulator added to the f32 sum; each band's
  [Σy, Σy²] summed one entry a tile (a tile lies in one band), a band's
  entries added in order in double;
- dz = g*a + c1 + 2z*c2 under the table of the band of the pixel read,
  plus the seam term on a band's first and last rows (GhostTr32), in
  float32 in the plain version's order of rounding;
- the dW (tdw_f32_tr with GhostTr32): x under the output pixel's band in
  the register A fragment and dz as dY is transposed, the route's dW
  order (test_torch_conv_f32.py dw_table) on ops/conv.py tma_dw_plan (aux
  and element size 4, the box height a divisor of gh: a tile lies in one
  band): runs of R k8 steps each in a fresh accumulator pass by pass, the
  CTAs of a cluster in rank order, the clusters' tables in double; the
  kernel's index map (which thread stages which pixel and channel, the
  pad taps, the ragged edge, the tile's band, the seam rows) emulated
  thread by thread against the tensors it stages;
- the dX (tdx_f32 with GhostTr32): dz formed in registers, the 3x3's reads
  kept in the output row's band, the flipped kernel; gm's band sums one
  entry a tile, added in order in double;
- the seam (ghost_unit.cu tseam32): each band's halo rows, dz of the
  neighbouring band's edge row under that band's table, the flipped
  kernel's ky row, a K step of 32 channels with kx innermost, masked
  under the reading band's (a1, b1), the sums one entry a 64-pixel
  segment added in order in double.

Each tensor-core instruction is emulated as its exact sum of products
added to the accumulator and rounded to nearest (test_torch_conv_f32.py).

Tolerance (test_torch_conv_f32.py's rule): against the float64 result of
the same float32 inputs (the port's plain versions in float64), the
emulation lies within 4x the plain float32 version's error; at the unit,
the emulated unit and JAX's interpreted one each within 4x, within 8x of
each other, and within 1e-4 of each other's largest value (the bf16 unit
test's bound, test_torch_seam_staged.py); one TF32 pass (hi.hi' alone)
misses by more than 10x the 4x bound; each planted fault (the halo rows
under their own band's table, the seam term dropped, the 3x3 dX reading
across bands) breaks the rule. The boundary's plain versions against
JAX's float32 boundary expressions at atol 1e-6 of the largest value,
sums rtol 1e-5; the kernel's block split of the sums (4 channels a
vector) at rtol 1e-5.

Sizes: batch 2, 24 rows of 64 pixels (3 bands of 8 rows; 64-pixel rows
put the 3x3 in halo mode), 64-128 channels.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_ocr_tpu.ops import pallas_unit as PU
from tensorflow_ocr_tpu_torch.ops import conv as CV
from tensorflow_ocr_tpu_torch.ops import ghost as G
from test_torch_conv_f32 import (MULTIPLE, SMS, dw_table, im2col, max_err,
                                 passes, split)
from test_torch_fused_f32 import (dy_eff, fold, tile_entries,
                                  wflip_rows)
from test_torch_fused_f32_plans import check_dx32

torch.set_num_threads(1)
f32, f64 = np.float32, np.float64
CL = torch.channels_last
N, H, W, GH, EPS = 2, 24, 64, 8, 1e-5


# --------------------------------------------------------------------------
# the kernels' arithmetic, in their order
# --------------------------------------------------------------------------


def steps(k, c, halo):
    """tdx_f32's K steps: 32 channels of one tap (halo mode: the taps of
    one ky, kx innermost), as slices of the (ky, kx, c) K axis."""
    if halo:
        taps = [(3 * ky + kx, c0) for ky in range(3) for c0 in range(0, c, 32)
                for kx in range(3)]
    else:
        taps = [(t, c0) for t in range(k * k) for c0 in range(0, c, 32)]
    return [slice(t * c + c0, t * c + c0 + 32) for t, c0 in taps]


def product(cols, wt, stp, one_pass=False):
    """cols (M, K) . wt (Co, K)ᵀ as tdx_f32 sums it: each K step's twelve
    k8 instructions (4 of lo.hi', hi.lo', hi.hi') into a fresh
    accumulator, then added to the f32 sum."""
    out = np.zeros((cols.shape[0], wt.shape[0]), f32)
    for ks in stp:
        acc = np.zeros_like(out)
        for pa, pb in passes(cols[:, ks], wt[:, ks], one_pass):
            for k8 in range(0, 32, 8):
                acc = (acc.astype(f64) + pa[:, k8:k8 + 8].astype(f64)
                       @ pb[:, k8:k8 + 8].T.astype(f64)).astype(f32)
        out = out + acc
    return out


def taps(k):
    return [(ky, kx) for ky in range(3) for kx in range(3)] if k == 3 \
        else [(1, 1)]


def act_cols(x, tab, gh, k, own_band=False):
    """(M, k*k*C): x at each tap's pixel through relu(x*a + b) under the
    table (N, nb, 2, C) of the OUTPUT pixel's band (own_band: the read
    row's band, the planted fault), zero outside the image; x as it is
    where tab is None."""
    n, h, w, c = x.shape
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    inside = np.pad(np.ones((n, h, w, 1), bool), ((0, 0), (1, 1), (1, 1),
                                                  (0, 0)))
    rows = np.arange(h)
    cols = []
    for ky, kx in taps(k):
        v = xp[:, ky:ky + h, kx:kx + w]
        if tab is not None:
            band = (np.clip(rows + ky - 1, 0, h - 1) if own_band
                    else rows) // gh
            a, b = tab[:, band, 0, None, :], tab[:, band, 1, None, :]
            v = np.maximum((v * a).astype(f32) + b, 0).astype(f32)
        cols.append(np.where(inside[:, ky:ky + h, kx:kx + w], v, 0)
                    .astype(f32))
    return np.concatenate(cols, -1).reshape(n * h * w, -1)


def dz_of(g, z, td, gh, edge=None):
    """dz = g*a + c1 + 2z*c2 (+ edge on a band's first and last rows)
    under each pixel's band's td (N, nb, 3, C), in float32."""
    band = np.arange(z.shape[1]) // gh
    a, c1, c2 = (td[:, band, i, None, :] for i in range(3))
    dz = (((g * a).astype(f32) + c1).astype(f32)
          + ((2 * z).astype(f32) * c2).astype(f32)).astype(f32)
    if edge is not None:
        e = np.zeros_like(dz)
        e[:, 0::gh] = edge[:, :, 0]
        e[:, gh - 1::gh] = edge[:, :, 1]
        dz = (dz + e).astype(f32)
    return dz


def dz_cols(dz, gh, k, in_band=True):
    """(M, k*k*C) of dz read by the dX: zero outside the image and, for
    the 3x3, outside the output row's band (in_band False: the planted
    fault)."""
    n, h, w, c = dz.shape
    dp = np.pad(dz, ((0, 0), (1, 1), (1, 1), (0, 0)))
    rows = np.arange(h)
    cols = []
    for ky, kx in taps(k):
        v = dp[:, ky:ky + h, kx:kx + w]
        if in_band and k == 3:
            same = ((np.clip(rows + ky - 1, -1, h) // gh) == rows // gh)
            v = np.where(same[None, :, None, None], v, 0)
        cols.append(v)
    return np.concatenate(cols, -1).reshape(n * h * w, -1).astype(f32)


def band_entries(p, geo, u, w, gh):
    """Each band's column sums (N, nb, C) of u (M, C) (or u*w) as the
    kernels add them: one entry a tile (test_torch_fused_f32.py
    tile_entries), a band's entries in order in double."""
    n, h, wd = geo
    entries = tile_entries(p, geo, u, w)
    per = gh // p.hb * -(-wd // p.wb)  # a band's row tiles, consecutive
    return entries.reshape(n, h // gh, per, -1).astype(f64).sum(2).astype(f32)


def emu_fwd(x, tab, wk, gh, one_pass=False, own_band=False):
    """ghost_conv_fwd_f32: y (N, H, W, Co) and the band sums (N, nb, 2,
    Co); x NHWC, tab (N, nb, 2, Ci) or None, wk (k, k, Ci, Co)."""
    n, h, w, ci = x.shape
    k, co = wk.shape[0], wk.shape[-1]
    p = CV.tma_staged_fwd_plan(n, h, w, ci, co, k, SMS, gh, esize=4)
    check_dx32(p, 0, k * k * ci, co, k)
    assert p.halo == (k == 3 and w >= 64 and co % 128 != 0)
    assert gh % p.hb == 0
    y = product(act_cols(x, tab, gh, k, own_band),
                np.ascontiguousarray(wk.reshape(-1, co).T),
                steps(k, ci, p.halo), one_pass)
    s = np.stack([band_entries(p, (n, h, w), y, None, gh),
                  band_entries(p, (n, h, w), y, y, gh)], 2)
    return y.reshape(n, h, w, co), s


def emu_dw(cols, dz, geo, ci, k, one_pass=False, run=CV.DW32_RUN, gh=GH):
    """tdw_f32_tr with GhostTr32 on the transformed cols (M, k*k*Ci) and
    dz (M, Co), runs of `run` k8 steps: the (k*k*Ci, Co) table in the
    kernel's order of summation, on tma_dw_plan(..., aux=4, esize=4, gh)
    over the image geometry."""
    co = dz.shape[-1]
    p = CV.tma_dw_plan(*geo, ci, co, k, SMS, 4, 4, gh)
    assert gh % p.hb == 0
    return dw_table(cols.reshape(*geo, -1), dz.reshape(*geo, co), p,
                    one_pass, run)


def emu_bwd(x, tx, g, z, td, wk, gh, edge=None, addend=None, out="gm",
            one_pass=False, in_band=True):
    """ghost_conv_bwd_f32: (dx (N, H, W, Ci), sums (N, nb, 2, Ci) or None,
    dw (k*k*Ci, Co))."""
    n, h, w, ci = x.shape
    k, co = wk.shape[0], wk.shape[-1]
    dz = dz_of(g, z, td, gh, edge)
    dw = emu_dw(act_cols(x, tx, gh, k), dz.reshape(-1, co), (n, h, w), ci,
                k, one_pass, gh=gh)
    px = CV.tma_bwd_dx_plan(n, h, w, ci, co, k, SMS, 4, True, gh, esize=4)
    check_dx32(px, 4, k * k * co, ci, k)
    gx = product(dz_cols(dz, gh, k, in_band), wflip_rows(wk),
                 steps(k, co, px.halo), one_pass)
    if out != "gm":
        if addend is not None:
            gx = (gx + addend.reshape(-1, ci)).astype(f32)
        return gx.reshape(n, h, w, ci), None, dw
    band = np.arange(h) // gh
    a, b = tx[:, band, 0, None, :], tx[:, band, 1, None, :]
    live = ((x * a).astype(f32) + b > 0).reshape(-1, ci)
    gm = np.where(live, gx, 0).astype(f32)
    x2 = x.reshape(-1, ci)
    sums = np.stack([band_entries(px, (n, h, w), gm, x2, gh),
                     band_entries(px, (n, h, w), gm, None, gh)], 2)
    return gm.reshape(n, h, w, ci), sums, dw


def emu_seam(g, z, td, x, tx, wk, gh, one_pass=False):
    """ghost_seam_bwd_f32: (edge (N, nb, 2, W, C), sums (N, nb, 2, C))."""
    n, h, w, c = x.shape
    nb = h // gh
    dz = dz_of(g, z, td, gh)
    wf = wflip_rows(wk)                          # (C, 9C), K (ky, kx, co)
    p = G.seam_plan(n, h, w, c, gh, SMS, 4)
    assert p.nseg == 2  # every plan's output is the same
    edge = np.zeros((n, nb, 2, w, c), f32)
    entries = np.zeros((n, nb, 2 * p.segs, 2, c), f32)
    stp = [slice(kx * c + c0, kx * c + c0 + 32) for c0 in range(0, c, 32)
           for kx in range(3)]
    for img in range(n):
        for b in range(nb):
            for side in (0, 1):
                rb = b + (1 if side else -1)
                if not 0 <= rb < nb:
                    continue  # the slot and the entry stay zero
                q = b * gh + (gh - 1 if side else 0)
                qa, ky = q + (1 if side else -1), 2 if side else 0
                row = np.pad(dz[img, qa], ((1, 1), (0, 0)))
                cols = np.concatenate([row[kx:kx + w] for kx in range(3)], -1)
                gm = product(cols, wf[:, 3 * c * ky:3 * c * (ky + 1)], stp,
                             one_pass)
                a1, b1 = tx[img, rb, 0], tx[img, rb, 1]
                xq = x[img, q]
                gm = np.where((xq * a1).astype(f32) + b1 > 0, gm, 0)
                edge[img, b, side] = (gm * a1).astype(f32)
                # a ragged segment's rows past w add zeros
                pad = ((0, 64 * p.segs - w), (0, 0))
                gm, xq = np.pad(gm, pad), np.pad(xq, pad)
                for s in range(p.segs):
                    seg = slice(64 * s, 64 * (s + 1))
                    e = (0 if side else p.segs) + s
                    entries[img, rb, e] = [fold(gm[None, seg], xq[None, seg],
                                                4),
                                           fold(gm[None, seg], None, 4)]
    return edge, entries.astype(f64).sum(2).astype(f32)


# --------------------------------------------------------------------------
# torch glue: the emulations as the wrappers of ops/ghost.py
# --------------------------------------------------------------------------


def act(t):
    """An NCHW activation tensor as NHWC numpy."""
    return t.detach().permute(0, 2, 3, 1).numpy()


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(
        0, 3, 1, 2).contiguous(memory_format=CL)


def wk_of(w):
    """(Co, Ci, k, k) -> (k, k, Ci, Co) numpy."""
    return np.ascontiguousarray(w.detach().permute(2, 3, 1, 0).numpy())


class Emulated:
    """conv_fwd, conv_bwd and seam_bwd of ops/ghost.py on the emulations
    (the boundary's float32 kernel is the plain version's arithmetic), with
    one TF32 pass or a planted fault."""

    def __init__(self, one_pass=False, fault=None):
        self.one_pass, self.fault = one_pass, fault

    def conv_fwd(self, x, tab, w, gh):
        y, s = emu_fwd(act(x), None if tab is None else tab.numpy(),
                       wk_of(w), gh, self.one_pass,
                       self.fault == "own_band")
        return nchw(y), torch.from_numpy(s)

    def conv_bwd(self, x, tx, g, z, td, w, gh, edge=None, addend=None,
                 out="gm"):
        k, ci, co = w.shape[-1], w.shape[1], w.shape[0]
        dx, sums, dw = emu_bwd(
            act(x), None if tx is None else tx.numpy(), act(g), act(z),
            td.numpy(), wk_of(w), gh,
            None if edge is None else edge.numpy(),
            None if addend is None else act(addend), out, self.one_pass,
            self.fault != "cross_band")
        dw = torch.from_numpy(dw).view(k, k, ci, co).permute(3, 2, 0, 1)
        return (nchw(dx), None if sums is None else torch.from_numpy(sums),
                dw.contiguous())

    def seam_bwd(self, g, z, td, x, tx, w, gh):
        edge, sums = emu_seam(act(g), act(z), td.numpy(), act(x), tx.numpy(),
                              wk_of(w), gh, self.one_pass)
        if self.fault == "no_seam":
            edge, sums = np.zeros_like(edge), np.zeros_like(sums)
        return torch.from_numpy(edge), torch.from_numpy(sums)

    def install(self, monkeypatch):
        for name in ("conv_fwd", "conv_bwd", "seam_bwd"):
            monkeypatch.setattr(G, name, getattr(self, name))


# --------------------------------------------------------------------------
# each kernel's product against the float64 one
# --------------------------------------------------------------------------


def rng_case(seed, ci, co, k):
    rng = np.random.RandomState(seed)
    x = rng.randn(N, H, W, ci).astype(f32)
    nb = H // GH
    tab = np.stack([rng.uniform(0.5, 1.5, (N, nb, ci)),
                    rng.randn(N, nb, ci) * 0.5 + 0.3], 2).astype(f32)
    wk = (rng.randn(k, k, ci, co) / np.sqrt(k * k * ci)).astype(f32)
    return rng, x, tab, wk


def ratio(got, plain, exact):
    return max_err(got, exact) / max_err(plain, exact)


@pytest.mark.parametrize("k,ci,co", [
    (1, 64, 64), (3, 64, 64),
    (1, 64, 128),   # BN 128, the weight resident
    (1, 256, 128),  # BN 128, the weight streamed
    (3, 128, 128),  # 32 x 4 boxes at BN 128, the halo rows as taps
])
def test_forward_band_tables_and_halo_rows(k, ci, co):
    """The forward under each band's table (the 3x3's halo rows under the
    reading band's): y and its band sums within 4x the plain version's
    error of float64; one TF32 pass far beyond; the 3x3's halo rows under
    their own band's table beyond."""
    _, x, tab, wk = rng_case(3 + k + (ci + co - 128), ci, co, k)
    tx, tt = nchw(x), torch.from_numpy(tab)
    tw = torch.from_numpy(wk).permute(3, 2, 0, 1).contiguous()
    py, ps = G.conv_fwd_reference(tx, tt, tw, GH)
    ey, es = G.conv_fwd_reference(tx.double(), tt.double(), tw.double(), GH)
    py, ey = act(py), act(ey)
    y, s = emu_fwd(x, tab, wk, GH)
    assert ratio(y, py, ey) <= MULTIPLE
    assert ratio(s, ps.numpy(), es.numpy()) <= MULTIPLE
    y1, _ = emu_fwd(x, tab, wk, GH, one_pass=True)
    assert ratio(y1, py, ey) > 10 * MULTIPLE
    if k == 3:
        bad, _ = emu_fwd(x, tab, wk, GH, own_band=True)
        assert ratio(bad, py, ey) > 10 * MULTIPLE


def bwd_case(k, out, ci=64, co=64):
    """A conv backward's inputs (x, tx, g, z, td, wk, edge, addend) and its
    plain float32 and float64 results: "act" (conv1) with the seam term
    and an addend and no tx, "gm" without."""
    rng, x, tab, wk = rng_case(11 + k + (ci + co - 128), ci, co, k)
    co = wk.shape[-1]
    g = (rng.randn(N, H, W, co) * 0.1).astype(f32)
    z = rng.randn(N, H, W, co).astype(f32)
    nb = H // GH
    td = np.stack([rng.uniform(0.5, 1.5, (N, nb, co)),
                   rng.randn(N, nb, co) * 1e-2,
                   rng.randn(N, nb, co) * 1e-3], 2).astype(f32)
    edge = addend = None
    if out == "act":
        edge = (rng.randn(N, nb, 2, W, co) * 0.1).astype(f32)
        addend = rng.randn(N, H, W, ci).astype(f32)
    txn = None if out == "act" else tab
    targs = [nchw(x), None if txn is None else torch.from_numpy(txn),
             nchw(g), nchw(z), torch.from_numpy(td),
             torch.from_numpy(wk).permute(3, 2, 0, 1).contiguous(), GH,
             None if edge is None else torch.from_numpy(edge),
             None if addend is None else nchw(addend), out]
    plain = G.conv_bwd_reference(*targs)
    exact = G.conv_bwd_reference(*[t.double() if isinstance(t, torch.Tensor)
                                   else t for t in targs])
    return (x, txn, g, z, td, wk, edge, addend), plain, exact


def dw_rows_of(dw):
    """(Co, Ci, k, k) -> the (k*k*Ci, Co) table."""
    return dw.permute(2, 3, 1, 0).reshape(-1, dw.shape[0]).numpy()


@pytest.mark.parametrize("k,out,ci,co", [
    (1, "act", 64, 64), (1, "gm", 64, 64), (3, "gm", 64, 64),
    (1, "act", 128, 64),  # BN 128, the weight streamed
    (1, "gm", 128, 128),  # BN 128
    (1, "gm", 64, 128),   # BN 64, the weight resident
    (3, "gm", 128, 128),  # 32 x 4 boxes at BN 128, reads in the band
])
def test_backward_dz_edge_term_and_in_band_dx(k, out, ci, co):
    """The conv backward: dz staged with the seam term on the bands' edge
    rows (conv1's "act", with its addend) or without (gm), the 3x3's dX
    kept in its output row's band; dx, gm's band sums and dW within 4x the
    plain version's error of float64; one TF32 pass beyond; the seam term
    dropped, or the 3x3 dX read across bands, beyond."""
    (x, txn, g, z, td, wk, edge, addend), plain, exact = bwd_case(k, out,
                                                                  ci, co)
    want = [(act(plain[0]), act(exact[0])),
            (dw_rows_of(plain[2]), dw_rows_of(exact[2]))]
    if out == "gm":
        want.append((plain[1].numpy(), exact[1].numpy()))
    got = emu_bwd(x, txn, g, z, td, wk, GH, edge, addend, out)
    for i, (pv, ev) in zip((0, 2, 1), want):
        assert ratio(got[i], pv, ev) <= MULTIPLE, i
    one = emu_bwd(x, txn, g, z, td, wk, GH, edge, addend, out, True)
    assert ratio(one[0], *want[0]) > 10 * MULTIPLE
    assert ratio(one[2], *want[1]) > 10 * MULTIPLE
    if out == "act":
        bad = emu_bwd(x, txn, g, z, td, wk, GH, None, addend, out)
        assert ratio(bad[0], *want[0]) > 10 * MULTIPLE
        assert ratio(bad[2], *want[1]) > 10 * MULTIPLE
    if k == 3:
        bad = emu_bwd(x, txn, g, z, td, wk, GH, out=out, in_band=False)
        assert ratio(bad[0], *want[0]) > 10 * MULTIPLE


@pytest.mark.parametrize("run", [1, 2, 4])
@pytest.mark.parametrize("k,out", [(1, "act"), (3, "gm")])
def test_dw_runs(run, k, out):
    """The ghost backward's dW emulated with each run length the kernel
    takes (1, 2 or 4 k8 steps a fresh accumulator; DW32_RUN picks one): x
    under its band (or as it is) and dz with the seam term (conv1's "act")
    or without, within 4x the plain version's error of float64; one TF32
    pass beyond."""
    (x, txn, g, z, td, wk, edge, _), plain, exact = bwd_case(k, out)
    ci, co = wk.shape[2], wk.shape[3]
    cols = act_cols(x, txn, GH, k)
    dz = dz_of(g, z, td, GH, edge).reshape(-1, co)
    want = (dw_rows_of(plain[2]), dw_rows_of(exact[2]))
    assert ratio(emu_dw(cols, dz, (N, H, W), ci, k, run=run),
                 *want) <= MULTIPLE
    assert ratio(emu_dw(cols, dz, (N, H, W), ci, k, True, run),
                 *want) > 10 * MULTIPLE


# --------------------------------------------------------------------------
# the staged dW's index map (csrc/conv_bwd.cuh dw32_body), thread by thread
# --------------------------------------------------------------------------


def xpose_block(blk):
    """conv_bwd.cuh xpose_block: the transpose's 4x4 block blk -> (cq, pq),
    channels 4 cq.. and pixels 4 pq.. of the tile."""
    t = blk & 7
    return 8 * (blk >> 7) + (t ^ ((blk >> 3) & 7)), 8 * ((blk >> 6) & 1) + t


class FusedStage:
    """fused_conv.cu FusedTr32's x1 and d1 (one key), in float32."""
    banded = False

    def __init__(self, ab, ds):
        self.ab, self.ds = ab, ds

    def x1(self, v, key, c):
        return np.maximum((v * self.ab[0][c]).astype(f32) + self.ab[1][c],
                          0).astype(f32)

    def d1(self, d, y, key, c):
        return ((d + self.ds[0][c]).astype(f32)
                + ((2 * y).astype(f32) * self.ds[1][c]).astype(f32)
                ).astype(f32)


class GhostStage:
    """ghost_unit.cu GhostTr32's x1, d1 and edge_at, in float32; key the
    global band (image, band) of the tile."""
    banded = True

    def __init__(self, tab, td, edge, gh, w):
        self.tab = None if tab is None else tab.reshape(-1, 2, tab.shape[-1])
        self.td = td.reshape(-1, 3, td.shape[-1])
        self.edge = None if edge is None else edge.reshape(
            -1, 2, w, edge.shape[-1])
        self.gh, self.band_px = gh, gh * w

    def x1(self, v, key, c):
        if self.tab is None:
            return v
        return np.maximum((v * self.tab[key, 0, c]).astype(f32)
                          + self.tab[key, 1, c], 0).astype(f32)

    def d1(self, z, g, key, c):
        t = self.td[key]
        return (((g * t[0, c]).astype(f32) + t[1, c]).astype(f32)
                + ((2 * z).astype(f32) * t[2, c]).astype(f32)).astype(f32)

    def edge_at(self, key, brow, ow, c):
        """The seam term at row brow of band key (0 off its edge rows)."""
        if self.edge is None:
            return np.zeros(np.shape(c), f32)
        first, last = brow == 0, brow == self.gh - 1
        e = self.edge[key, np.where(last, 1, 0), ow, c]
        return np.where(first | last, e, 0).astype(f32)


def staged_tiles(tr, p, geo, k, x, dy, aux):
    """Every tile's operands as dw32_body stages them, by its threads'
    index map: {(tile, chunk): A (64 channels, 64 pixels)} of T_x(X) (the
    lanes' fragments of each k8 step), {(tile, co0): B (64 pixels, bn)} of
    T_dy (the transpose's 4x4 blocks). Each element is asserted written
    once. x, dy, aux NHWC of the geometry; a box reads 0 outside the image
    (TMA's zero fill)."""
    n, h, w = geo
    ci, co = x.shape[-1], dy.shape[-1]
    wm, lwb = p.wb - 1, p.wb.bit_length() - 1
    tw, th = -(-w // p.wb), -(-h // p.hb)
    cchunks = ci // 64
    rchunks = k * k * cchunks
    half = k // 2
    pad = 2  # wide enough for a tap's shift past the ragged edge

    def padded(t):
        return np.pad(t, ((0, 0), (pad, pad + p.hb), (pad, pad + p.wb),
                          (0, 0)))

    xp, dyp, auxp = padded(x), padded(dy), padded(aux)
    a_tiles, b_tiles = {}, {}
    for t in range(n * th * tw):
        w0, tt = (t % tw) * p.wb, t // tw
        h0, img = (tt % th) * p.hb, tt // th
        key = ((img * h + h0) * w + w0) // tr.band_px if tr.banded else 0
        # B: thread ct's blocks ct + 256 xb, 4 pixels x 4 columns each
        ct, xb = np.meshgrid(np.arange(256), np.arange(p.bn // 64),
                             indexing="ij")
        cq, pq = xpose_block(ct + 256 * xb)
        px = (4 * pq)[..., None, None] + np.arange(4)[:, None]
        col = (4 * cq)[..., None, None] + np.arange(4)
        px, col = np.broadcast_arrays(px, col)
        c, rr = px & wm, px >> lwb
        inn = (c < w - w0) & (rr < h - h0)
        for co0 in range(0, co, p.bn):
            at = (img, h0 + rr + pad, w0 + c + pad, co0 + col)
            v = tr.d1(dyp[at], auxp[at], key, co0 + col)
            if tr.banded:
                brow = img * h + h0 + rr - key * tr.gh
                v = np.where(inn, (v + tr.edge_at(
                    key, brow, np.minimum(w0 + c, w - 1), co0 + col)
                    ).astype(f32), v)
            b = np.full((64, p.bn), np.nan, f32)
            seen = np.zeros((64, p.bn), int)
            np.add.at(seen, (px, col), 1)
            assert (seen == 1).all()
            b[px, col] = np.where(inn, v, 0)
            b_tiles[t, co0] = b
        # A: warpgroup wg's lanes (warp, g, t4), k8 steps s, pixels q + t4
        # (+ 4), channels 16 warp + g (+ 8) of the warpgroup's chunk
        for bx in range(-(-rchunks // 2) if p.two else 1):
            for wg in range(2):
                aslot = wg if p.two else 0
                if p.two and 2 * bx + aslot >= rchunks:
                    continue  # an odd last chunk's duplicate: not stored
                chunk = 2 * bx + aslot if p.two else 0
                tap = chunk // cchunks
                dx, dyt = tap % k - half, tap // k - half
                clo = max(0, -w0 - dx)
                cspan = max(0, min(w - w0, w - w0 - dx) - clo)
                rlo = max(0, -h0 - dyt)
                rspan = max(0, min(h - h0, h - h0 - dyt) - rlo)
                p0, k8 = (0, 8) if p.two else (32 * wg, 4)
                # the lane's liveness mask: bit k for pixel p0 + t4 + 4 k
                t4_, k_ = np.meshgrid(np.arange(4), np.arange(2 * k8),
                                      indexing="ij")
                pk = p0 + t4_ + 4 * k_
                bits = (((pk & wm) - clo >= 0) & ((pk & wm) - clo < cspan)
                        & ((pk >> lwb) - rlo >= 0)
                        & ((pk >> lwb) - rlo < rspan))
                warp, g, t4, s, e, j = np.meshgrid(
                    np.arange(4), np.arange(8), np.arange(4), np.arange(k8),
                    np.arange(2), np.arange(2), indexing="ij")
                q = p0 + 8 * s + t4 + 4 * e  # the fragment's pixel
                ch = 16 * warp + g + 8 * j
                cg = (chunk % cchunks) * 64 + ch
                c, rr = q & wm, q >> lwb
                live = bits[t4, 2 * s + e]
                raw = xp[img, h0 + rr + dyt + pad, w0 + c + dx + pad, cg]
                a = a_tiles.setdefault((t, chunk), np.full((64, 64), np.nan,
                                                           f32))
                assert np.isnan(a[ch, q]).all()
                a[ch, q] = np.where(live, tr.x1(raw, key, cg), 0)
    return a_tiles, b_tiles


def reference_tiles(p, geo, k, ci, cols, dys):
    """The same tiles cut from the tensors the plain versions stage: cols
    (N, H, W, k*k*Ci) im2col of T_x(x) (zero at the pad taps) and dys (N,
    H, W, Co) T_dy; zero past the image."""
    n, h, w = geo
    tw, th = -(-w // p.wb), -(-h // p.hb)
    a_tiles, b_tiles = {}, {}
    for t in range(n * th * tw):
        w0, tt = (t % tw) * p.wb, t // tw
        h0, img = (tt % th) * p.hb, tt // th
        ca = np.zeros((p.hb, p.wb, cols.shape[-1]), f32)
        cd = np.zeros((p.hb, p.wb, dys.shape[-1]), f32)
        part = cols[img, h0:h0 + p.hb, w0:w0 + p.wb]
        ca[:part.shape[0], :part.shape[1]] = part
        cd[:part.shape[0], :part.shape[1]] = dys[img, h0:h0 + p.hb,
                                                 w0:w0 + p.wb]
        ca, cd = ca.reshape(64, -1), cd.reshape(64, -1)
        for chunk in range(k * k * ci // 64):
            a_tiles[t, chunk] = ca[:, 64 * chunk:64 * chunk + 64].T
        for co0 in range(0, cd.shape[1], p.bn):
            b_tiles[t, co0] = cd[:, co0:co0 + p.bn]
    return a_tiles, b_tiles


@pytest.mark.parametrize("kind,geo,ci,co,k", [
    ("fused", (1, 1, 200), 128, 64, 1),   # rows: two chunks, a ragged tile
    ("fused", (2, 9, 20), 64, 128, 3),    # pad taps, ragged rows and columns
    ("ghost", (2, 16, 20), 64, 128, 3),   # bands of 8 rows, the seam rows
    ("ghost", (1, 16, 4), 64, 64, 1),     # 4 wide: the box widened to 8
    ("ghost", (2, 16, 20), 64, 64, 1),    # x as it is (no tx), the seam
])
def test_staged_dw_index_map(kind, geo, ci, co, k):
    """dw32_body's staging, thread by thread (each lane's A fragment
    values, each thread's transpose blocks), with each transform: every
    element of each tile's A (T_x(X)^T of each chunk) and B (T_dy) staged
    once and equal to the plain versions' staged tensors cut into the
    plan's tiles: zero at the pad taps and past the ragged edge, x under
    the tile's band (the output pixel's), dz under the band of the pixel
    read, the seam term on the bands' first and last rows."""
    rng = np.random.RandomState(ci + co + k)
    n, h, w = geo
    x = rng.randn(n, h, w, ci).astype(f32)
    dy = rng.randn(n, h, w, co).astype(f32)
    aux = rng.randn(n, h, w, co).astype(f32)
    gh = GH if kind == "ghost" else 0
    p = CV.tma_dw_plan(*geo, ci, co, k, SMS, 4, 4, gh)
    if kind == "fused":
        ab = np.stack([rng.uniform(0.5, 1.5, ci),
                       rng.randn(ci) * 0.5 + 0.3]).astype(f32)
        ds = np.stack([rng.randn(co) * 0.3, rng.randn(co) * 0.1]).astype(f32)
        tr = FusedStage(ab, ds)
        cols = im2col(np.maximum((x * ab[0]).astype(f32) + ab[1], 0)
                      .astype(f32), k)
        dys = dy_eff(dy, aux, ds)
    else:
        assert gh % p.hb == 0 and (w > 4 or p.wb == 8)
        nb = h // gh
        tab = None if k == 1 else np.stack(
            [rng.uniform(0.5, 1.5, (n, nb, ci)),
             rng.randn(n, nb, ci) * 0.5 + 0.3], 2).astype(f32)
        td = np.stack([rng.uniform(0.5, 1.5, (n, nb, co)),
                       rng.randn(n, nb, co) * 1e-2,
                       rng.randn(n, nb, co) * 1e-3], 2).astype(f32)
        edge = (rng.randn(n, nb, 2, w, co) * 0.1).astype(f32)
        tr = GhostStage(tab, td, edge, gh, w)
        cols = act_cols(x, tab, gh, k)
        dys = dz_of(aux, dy, td, gh, edge)
    got = staged_tiles(tr, p, geo, k, x, dy, aux)
    want = reference_tiles(p, geo, k, ci,
                           cols.reshape(n, h, w, -1), dys.reshape(n, h, w,
                                                                  co))
    for g_, w_ in zip(got, want):
        assert g_.keys() == w_.keys()
        for key in w_:
            np.testing.assert_array_equal(g_[key], w_[key], err_msg=key)


@pytest.mark.parametrize("seed,c,w", [
    (21, 64, W),    # two K steps, the weight resident at 64 columns
    (185, 64, 100),  # a ragged row: its second segment 36 pixels wide
    (213, 128, W),   # four K steps, the weight streamed
])
def test_seam_product(seed, c, w):
    """The seam's 1x3 product of each band's halo rows: the seam terms and
    the band sums within 4x the plain version's error of float64; one TF32
    pass beyond."""
    rng = np.random.RandomState(seed)
    nb = H // GH
    x = rng.randn(N, H, w, c).astype(f32)
    tab = np.stack([rng.uniform(0.5, 1.5, (N, nb, c)),
                    rng.randn(N, nb, c) * 0.5 + 0.3], 2).astype(f32)
    wk = (rng.randn(3, 3, c, c) / np.sqrt(9 * c)).astype(f32)
    g = (rng.randn(N, H, w, c) * 0.1).astype(f32)
    z = rng.randn(N, H, w, c).astype(f32)
    td = np.stack([rng.uniform(0.5, 1.5, (N, nb, c)),
                   rng.randn(N, nb, c) * 1e-2,
                   rng.randn(N, nb, c) * 1e-3], 2).astype(f32)
    targs = [nchw(g), nchw(z), torch.from_numpy(td), nchw(x),
             torch.from_numpy(tab),
             torch.from_numpy(wk).permute(3, 2, 0, 1).contiguous(), GH]
    pe, ps = G.seam_bwd_reference(*targs)
    ee, es = G.seam_bwd_reference(*[t.double() if isinstance(t, torch.Tensor)
                                    else t for t in targs])
    edge, sums = emu_seam(g, z, td, x, tab, wk, GH)
    assert ratio(edge, pe.numpy(), ee.numpy()) <= MULTIPLE
    assert ratio(sums, ps.numpy(), es.numpy()) <= MULTIPLE
    one, _ = emu_seam(g, z, td, x, tab, wk, GH, one_pass=True)
    assert ratio(one, pe.numpy(), ee.numpy()) > 10 * MULTIPLE


def emu_wsplit32(w):
    """csrc/ghost_unit.cu seam_wsplit32, thread by thread: w (Co, Ci, 3, 3)
    through each block's shared tile t[co - co0][(ci - ci0) * 9 + tap] (32
    x 8 of (co, ci), thread x's values x + 256 j) into (2, Ci, 9, Co), hi
    then lo."""
    c = w.shape[0]
    flat = w.reshape(-1)
    out = np.full(2 * 9 * c * c, np.nan, f32)
    i = (np.arange(256)[:, None] + 256 * np.arange(9)).ravel()
    r, e = np.divmod(i, 72)                    # the read loop
    e2, r2 = np.divmod(i, 32)                  # the write loop
    for co0 in range(0, c, 32):
        for ci0 in range(0, c, 8):
            t = np.full((32, 73), np.nan, f32)
            t[r, e] = flat[((co0 + r) * c + ci0) * 9 + e]
            hi, lo = split(t[r2, e2])
            o = ((ci0 + e2 // 9) * 9 + e2 % 9) * c + co0 + r2
            out[o], out[9 * c * c + o] = hi, lo
    return out.reshape(2, c, 9, c)


@pytest.mark.parametrize("c", [64, 128])
def test_seam_weight_split_layout(c):
    """seam_wsplit32's index map writes every element once: the flipped
    taps' layout the bf16 seam's permute gave, (Ci, 9, Co), split into
    TF32 hi and lo."""
    w = np.random.RandomState(c).randn(c, c, 3, 3).astype(f32)
    got = emu_wsplit32(w)
    want = np.ascontiguousarray(w.transpose(1, 2, 3, 0)).reshape(c, 9, c)
    hi, lo = split(want)
    np.testing.assert_array_equal(got[0], hi)
    np.testing.assert_array_equal(got[1], lo)


# --------------------------------------------------------------------------
# the unit: emulated kernels, the plain versions and JAX's kernels
# --------------------------------------------------------------------------


def unit_inputs(proj, seed):
    """JAX-layout numpy inputs of one unit (db 64, Co 128) and the output
    cotangent."""
    rng = np.random.RandomState(seed)
    ci, db, co = (64, 64, 128) if proj else (128, 64, 128)
    gb = lambda c: np.stack([rng.uniform(0.5, 1.5, c),  # noqa: E731
                             rng.randn(c) * 0.1]).astype(f32)
    args = [(rng.randn(N, H, W, ci) ** 2).astype(f32),
            (rng.randn(ci, db) / np.sqrt(ci)).astype(f32), gb(db),
            (rng.randn(9 * db, db) / np.sqrt(9 * db)).astype(f32), gb(db),
            (rng.randn(db, co) / np.sqrt(db)).astype(f32), gb(co)]
    if proj:
        args += [(rng.randn(ci, co) / np.sqrt(ci)).astype(f32), gb(co)]
    return args, rng.randn(N, H, W, co).astype(f32)


def port_leaves(args, dtype):
    o, w1, gb1, w2, gb2, w3, gb3, *sc = args
    db = w1.shape[1]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    out = [t(o).permute(0, 3, 1, 2).contiguous(memory_format=CL),
           t(w1.T[:, :, None, None]), t(gb1),
           t(w2.reshape(3, 3, db, db).transpose(3, 2, 0, 1)), t(gb2),
           t(w3.T[:, :, None, None]), t(gb3)]
    if sc:
        out += [t(sc[0].T[:, :, None, None]), t(sc[1])]
    return [a.to(dtype).requires_grad_() for a in out]


def port_unit(args, wy, proj, dtype=torch.float32):
    """The port's unit (whatever ops/ghost.py's wrappers are): outputs and
    the gradients of Σ out·wy, in JAX's layouts, float64 numpy."""
    leaves = port_leaves(args, dtype)
    fn = G.ghost_unit_proj if proj else G.ghost_unit_id
    outs = fn(*leaves, GH, EPS)
    grads = torch.autograd.grad(
        (outs[0] * torch.from_numpy(wy).permute(0, 3, 1, 2).to(dtype)).sum(),
        leaves)
    db = args[1].shape[1]
    g = [x.detach().double() for x in grads]
    got = [g[0].permute(0, 2, 3, 1), g[1][:, :, 0, 0].T, g[2],
           g[3].permute(2, 3, 1, 0).reshape(9 * db, db), g[4],
           g[5][:, :, 0, 0].T, g[6]]
    if proj:
        got += [g[7][:, :, 0, 0].T, g[8]]
    o = [outs[0].detach().double().permute(0, 2, 3, 1)] + [
        s.detach().double() for s in outs[1:]]
    return [v.numpy() for v in o + got]


@functools.lru_cache(maxsize=None)
def references(proj):
    """(JAX's interpreted float32 unit, the port's plain float32 unit, the
    port's float64 unit): outputs then gradients, as float64 numpy."""
    args, wy = unit_inputs(proj, 31 + proj)
    plain = port_unit(args, wy, proj)
    exact = port_unit(args, wy, proj, torch.float64)
    PU.set_interpret(True)
    try:
        jfn = PU.ghost_unit_proj if proj else PU.ghost_unit_id
        jouts, vjp = jax.vjp(lambda *a: jfn(*a, GH, EPS),
                             *map(jnp.asarray, args))
        jgrads = vjp((jnp.asarray(wy),)
                     + tuple(jnp.zeros_like(s) for s in jouts[1:]))
    finally:
        PU.set_interpret(False)
    jax_out = [np.asarray(v, f64) for v in (*jouts, *jgrads)]
    return args, wy, jax_out, plain, exact


@pytest.mark.parametrize("proj", [False, True], ids=["identity", "proj"])
@pytest.mark.parametrize("mode", ["kernels", "one_pass", "own_band",
                                  "no_seam"])
def test_f32_unit_on_the_emulated_kernels_against_jax(monkeypatch, proj,
                                                      mode):
    """A float32 ghost unit's outputs (out, the BN statistics) and every
    gradient: on the emulated kernels ("kernels") each within 4x the plain
    float32 unit's error against the float64 unit, as JAX's interpreted
    unit is, the two within 8x of each other and within 1e-4 of JAX's
    largest value; one TF32 pass, the halo rows under their own band's
    table and the seam terms dropped each break the rule."""
    args, wy, jax_out, plain, exact = references(proj)
    Emulated(mode == "one_pass",
             None if mode in ("kernels", "one_pass") else mode
             ).install(monkeypatch)
    got = port_unit(args, wy, proj)
    ratios = []
    for i, (gv, jv, pv, ev) in enumerate(zip(got, jax_out, plain, exact)):
        e_plain = max(max_err(pv, ev), 1e-30)
        ratios.append(max_err(gv, ev) / e_plain)
        if mode == "kernels":
            assert max_err(jv, ev) <= MULTIPLE * e_plain, i
            assert max_err(gv, jv) <= 2 * MULTIPLE * e_plain, i
            assert max_err(gv, jv) <= 1e-4 * np.abs(jv).max(), i
    if mode == "kernels":
        assert max(ratios) <= MULTIPLE, ratios
    else:
        assert max(ratios) > 10 * MULTIPLE, ratios


# --------------------------------------------------------------------------
# the boundary
# --------------------------------------------------------------------------


def boundary_case(seed, c):
    rng = np.random.RandomState(seed)
    nb = H // GH
    z, zs, dout = (rng.randn(N, H, W, c).astype(f32) for _ in range(3))
    tabs = [np.stack([rng.uniform(0.5, 1.5, (N, nb, c)),
                      rng.randn(N, nb, c)], 2).astype(f32) for _ in range(2)]
    return z, zs, dout, tabs


def rows_of(tab):
    """(N, nb, C) -> each pixel row's (N, H, 1, C)."""
    return np.repeat(tab, GH, 1)[:, :, None, :]


@pytest.mark.parametrize("proj", [False, True], ids=["identity", "proj"])
def test_f32_boundary_against_jax(proj):
    """The boundary's plain versions in float32 against JAX's float32
    boundary (pallas_unit.py's out = relu(z3·a3 + b3 + sc) and, through
    jax.vjp, gm3 and its band sums): out and gm at atol 1e-6 of the
    largest value, the sums at rtol 1e-5."""
    z, zs, dout, (t, ts) = boundary_case(5 + proj, 64)
    j = jnp.asarray

    def jax_boundary(z, zs):
        sc = zs * j(rows_of(ts[:, :, 0])) + j(rows_of(ts[:, :, 1])) \
            if proj else zs
        return jnp.maximum(z * j(rows_of(t[:, :, 0]))
                           + j(rows_of(t[:, :, 1])) + sc, 0.0)

    jout, vjp = jax.vjp(jax_boundary, j(z), j(zs))
    targs = (nchw(z), torch.from_numpy(t), nchw(zs),
             torch.from_numpy(ts) if proj else None, GH)
    out = act(G.boundary_fwd_reference(*targs))
    np.testing.assert_allclose(out, jout, rtol=0,
                               atol=1e-6 * np.abs(jout).max())
    gm, sums = G.boundary_bwd_reference(nchw(dout), *targs)
    # gm3 = dout·[pre > 0]: the vjp's cotangent of z through the relu
    # divided by a3 is not exact; JAX's kernel forms it as the mask
    pre_pos = np.asarray(jax_boundary(j(z), j(zs))) > 0
    jgm = np.where(pre_pos, dout, 0)
    np.testing.assert_allclose(act(gm), jgm, rtol=0,
                               atol=1e-6 * np.abs(jgm).max())
    dz = np.asarray(vjp(j(dout))[0])
    np.testing.assert_allclose(dz, jgm * rows_of(t[:, :, 0]), rtol=1e-6,
                               atol=1e-6 * np.abs(dz).max())
    bands = lambda v: v.reshape(N, H // GH, GH * W, -1).sum(2)  # noqa: E731
    want = np.stack([bands(jgm * z), bands(jgm), bands(jgm * zs)], 2)
    np.testing.assert_allclose(sums.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def emulate_boundary_sums32(dout, z, t, zs, ts, gh, w, mis_order=False):
    """ghost_boundary_f32's band sums (N, nb, 3, C) as gboundary32 adds
    them: a block of 16 row groups by 16 vectors of 4 channels a band,
    thread (r, v) adding the band's rows r, r + 16, ... in order, then the
    block's 16 row groups' partials in row-group order (mis_order: the
    rows of all groups in one sequence, the planted fault)."""
    n, h, _, c = z.shape
    nb, band_px = h // gh, gh * w
    pre = (((z * rows_of(t[:, :, 0])).astype(f32) + rows_of(t[:, :, 1]))
           .astype(f32) + (((zs * rows_of(ts[:, :, 0])).astype(f32)
                            + rows_of(ts[:, :, 1])).astype(f32)
                           if ts is not None else zs)).astype(f32)
    gm = np.where(pre > 0, dout, 0).astype(f32)
    vals = np.stack([gm * z, gm, gm * zs], -2).reshape(n, nb, band_px, 3, c)
    out = np.zeros((n, nb, 3, c), f32)
    for r in range(16):
        part = np.zeros((n, nb, 3, c), f32)
        for row in range(r, band_px, 16):
            part = part + vals[:, :, row]
        out = out + part if not mis_order else out
    if mis_order:
        for row in range(band_px):
            out = out + vals[:, :, row]
    return out


def test_f32_boundary_block_split_emulation():
    """gboundary32's block split (4 channels a vector, 16 row groups, the
    partials in row-group order) against the plain version's band sums at
    rtol 1e-5; the 4-channel vectors cover every channel (c a multiple of
    64); a sum in one sequence lies elsewhere than the split."""
    z, zs, dout, (t, ts) = boundary_case(17, 128)
    _, sums = G.boundary_bwd_reference(nchw(dout), nchw(z),
                                       torch.from_numpy(t), nchw(zs),
                                       torch.from_numpy(ts), GH)
    got = emulate_boundary_sums32(dout, z, t, zs, ts, GH, W)
    np.testing.assert_allclose(got, sums.numpy(), rtol=1e-5,
                               atol=1e-5 * np.abs(got).max())
    seq = emulate_boundary_sums32(dout, z, t, zs, ts, GH, W, True)
    assert not np.array_equal(seq, got)
