"""csrc/conv_bwd.cuh's dW split and dX tiling emulated on the CPU, with the
staging transforms of fused_conv.cu (FusedTr) and ghost_unit.cu
(GhostTr), held against the plain conv_bwd_reference of ops/fused.py and
ops/ghost.py; and the plans of ops/conv.py (tma_dw_plan with aux boxes,
tma_bwd_dx_plan).

dW (tdw) is conv_dw.cu's split (emulate_tma_dw) with its boxes rewritten
after they arrive: X through T_x (relu(x*a + b), per channel or under the
band of the OUTPUT pixel) and the dY box through T_dy from the raw box and
its aux box (dy_eff from dy and y; dz from z and g under the band of the
pixel read, plus the seam term on a band's edge rows), every element
whose source pixel lies outside the image zeroed after the transform.
dX (tdx) walks tma_bwd_dx_plan's persistent tiles: each K step's A box is
the raw box at the tile shifted by the tap, staged through T_dy and zeroed
where the pixel read lies outside the image (or, in a ghost 3x3, in
another band than the output row); the epilogue masks with the conv's
input, stores each element once and sums the columns into one entry a CTA
(fused) or a row tile (ghost), which are added in order. Float32 on the
CPU: sums in another order, within 1e-5 relative and 1e-4 absolute.

The faults the transform is prone to are planted and must be caught: the
transform applied to TMA's zero fill without the re-zero (relu(b) and
ds0 at the pad taps), and a ghost halo row under its own band's affine.
"""

import ctypes

import pytest
import torch

from tensorflow_ocr_tpu_torch.ops import conv as CV
from tensorflow_ocr_tpu_torch.ops import fused as FU
from tensorflow_ocr_tpu_torch.ops import ghost as G
from test_torch_conv import emulate_tma_dw, tma_box
from test_torch_conv_fwd import weight_box

torch.set_num_threads(1)
CL = torch.channels_last
TOL = dict(rtol=1e-5, atol=1e-4)


def box_pixels(img, h0, w0, hb, wb, h, w):
    """The rows of a wb x hb box at (h0, w0) of image img, in (h, w)
    order: whether each lies in the image, and its linear pixel index
    (clamped where it does not)."""
    hh = torch.arange(h0, h0 + hb)[:, None].expand(hb, wb).reshape(-1)
    ww = torch.arange(w0, w0 + wb)[None, :].expand(hb, wb).reshape(-1)
    inside = (hh >= 0) & (hh < h) & (ww >= 0) & (ww < w)
    return inside, (img * h + hh.clamp(0, h - 1)) * w + ww.clamp(0, w - 1)


class FusedT:
    """fused_conv.cu's FusedTr on 64-channel boxes (rows x 64)."""

    def __init__(self, ab, ds):
        self.ab, self.ds = ab, ds

    def x(self, v, pix, c0):
        return torch.relu(v * self.ab[0, c0:c0 + 64]
                          + self.ab[1, c0:c0 + 64])

    def dy(self, d, y, pix, c0):
        return (d + self.ds[0, c0:c0 + 64]) + 2.0 * y * self.ds[1, c0:c0 + 64]

    def mask_ab(self, pix, c0, nc):
        return self.ab[0, c0:c0 + nc], self.ab[1, c0:c0 + nc]


class GhostT:
    """ghost_unit.cu's GhostTr: tables (N, nb, rows, C) of each band of
    gh rows of width w; ``own_band`` plants the fault of a halo row under
    its own band's affine (the X transform reads the source's band)."""

    def __init__(self, tx, td, edge, gh, w, own_band=False):
        flat = lambda t: None if t is None else t.reshape(  # noqa: E731
            -1, *t.shape[2:])
        self.tx, self.td, self.edge = flat(tx), flat(td), flat(edge)
        self.gh, self.w, self.px, self.own = gh, w, gh * w, own_band

    def x(self, v, pix, c0, src=None):
        if self.tx is None:
            return v
        band = (src if self.own else pix) // self.px
        t = self.tx[band, :, c0:c0 + 64]
        return torch.relu(v * t[:, 0] + t[:, 1])

    def dy(self, z, g, pix, c0):
        band = pix // self.px
        t = self.td[band, :, c0:c0 + 64]
        d = (g * t[:, 0] + t[:, 1]) + 2.0 * z * t[:, 2]
        if self.edge is not None:
            off = pix - band * self.px
            row = off // self.w
            e = self.edge[band, (row != 0).long(), off % self.w, c0:c0 + 64]
            edge_row = ((row == 0) | (row == self.gh - 1))[:, None]
            d = d + torch.where(edge_row, e, torch.zeros_like(e))
        return d

    def mask_ab(self, pix, c0, nc):
        t = self.tx[pix // self.px, :, c0:c0 + nc]
        return t[:, 0], t[:, 1]


def emulate_dw(x4, d4, a4, ks, sms, tr, aux, rezero=True):
    """tdw + sum_tables: the (ks*ks*ci, co) table and the plan."""
    n, h, w, _ = x4.shape

    def xbox(img, h0, w0, ky, kx, c0, hb, wb):
        sh, sw = h0 + ky - ks // 2, w0 + kx - ks // 2
        inside, pix = box_pixels(img, h0, w0, hb, wb, h, w)
        src_in, src = box_pixels(img, sh, sw, hb, wb, h, w)
        raw = tma_box(x4, img, sh, sw, c0, hb, wb)
        v = (tr.x(raw, pix, c0, src) if isinstance(tr, GhostT)
             else tr.x(raw, pix, c0))
        live = (inside & src_in)[:, None]
        return torch.where(live, v, torch.zeros_like(v)) if rezero else v

    def dybox(img, h0, w0, c0, hb, wb):
        inside, pix = box_pixels(img, h0, w0, hb, wb, h, w)
        v = tr.dy(tma_box(d4, img, h0, w0, c0, hb, wb),
                  tma_box(a4, img, h0, w0, c0, hb, wb), pix, c0)
        live = inside[:, None]
        return torch.where(live, v, torch.zeros_like(v)) if rezero else v

    dw, _ = emulate_tma_dw(x4, d4, ks, sms, aux, xbox, dybox)
    return dw, CV.tma_dw_plan(n, h, w, x4.shape[-1], d4.shape[-1], ks, sms,
                              aux)


def emulate_dx(d4, a4, wflip, ks, sms, tr, aux, kind, x4=None, addend=None,
               gh=0, rezero=True):
    """tdx + reduce_parts: dX of the staged d4 (N, H, W, Co) (dy or z; a4
    its aux, y or g) with wflip (Ci, ks*ks*Co), finished as ``kind``
    ("fused": dx = gm*a, sums per CTA; "gm": gm, sums per row tile of a
    band; "act"/"f32": dX + addend). Returns ((N*H*W, Ci) rows, sums
    (groups, 2, Ci) or None, the plan)."""
    n, h, w, co = d4.shape
    ci = wflip.shape[0]
    p = CV.tma_bwd_dx_plan(n, h, w, ci, co, ks, sms, aux, kind != "f32", gh)
    assert p.halo == (ks == 3 and p.wb >= 64)
    wt3 = wflip.reshape(ci, ks * ks, co)
    tiles_w, tiles_h, cb = -(-w // p.wb), -(-h // p.hb), co // 64
    per_cta, sums = kind == "fused", kind in ("fused", "gm")
    entries = torch.zeros(p.grid // p.col_tiles if per_cta else p.row_tiles,
                          2, ci)
    out = torch.zeros(n * h * w, ci)
    written = torch.zeros(n * h * w, ci, dtype=torch.int32)
    x2 = None if x4 is None else x4.reshape(-1, ci)
    half = ks // 2
    rows = torch.arange(CV.TM)
    # halo mode: output row r reads halo row (r // wb) * (wb + 2) + r % wb
    # + kx of the (ky, channel box) halo box
    hrow = rows // p.wb * (p.wb + 2) + rows % p.wb
    assert p.grid % p.col_tiles == 0
    for cta in range(p.grid):
        for t in p.tiles_of(cta):
            col, r = t % p.col_tiles, t // p.col_tiles
            assert col == cta % p.col_tiles  # a CTA's tiles share a column
            x0, y0 = r % tiles_w * p.wb, r // tiles_w % tiles_h * p.hb
            img = r // (tiles_w * tiles_h)
            inside, pix = box_pixels(img, y0, x0, p.hb, p.wb, h, w)
            acc = torch.zeros(CV.TM, p.bn)
            for k in range(ks * ks * cb):
                tap, c0 = k // cb, k % cb * 64
                ky, kx = divmod(tap, ks)
                if p.halo:
                    if kx:
                        continue  # the ky step's box serves all three taps
                    # the halo box: pixels x0 - 1 .. x0 + wb of rows y0 +
                    # ky - 1 .., read by the output rows y0 ..
                    src_in, src = box_pixels(img, y0 + ky - 1, x0 - 1, p.hb,
                                             p.wb + 2, h, w)
                    _, orow = box_pixels(img, y0, x0 - 1, p.hb, p.wb + 2,
                                         h, w)
                    live = src_in
                    if gh:  # a 3x3 reads only its own band
                        live &= src // (gh * w) == orow // (gh * w)
                    a = tr.dy(tma_box(d4, img, y0 + ky - 1, x0 - 1, c0,
                                      p.hb, p.wb + 2),
                              tma_box(a4, img, y0 + ky - 1, x0 - 1, c0,
                                      p.hb, p.wb + 2), src, c0)
                    if rezero:
                        a = torch.where(live[:, None], a, torch.zeros_like(a))
                    for kx2 in range(3):
                        acc += a[hrow + kx2] @ weight_box(
                            wt3, 3 * ky + kx2, c0, col * p.bn, p.bn).T
                    continue
                sy, sx = y0 + ky - half, x0 + kx - half
                src_in, src = box_pixels(img, sy, sx, p.hb, p.wb, h, w)
                live = inside & src_in
                if gh and ks == 3:  # a 3x3 reads only its own band
                    live &= src // (gh * w) == pix // (gh * w)
                a = tr.dy(tma_box(d4, img, sy, sx, c0, p.hb, p.wb),
                          tma_box(a4, img, sy, sx, c0, p.hb, p.wb), src, c0)
                if rezero:
                    a = torch.where(live[:, None], a, torch.zeros_like(a))
                acc += a @ weight_box(wt3, tap, c0, col * p.bn, p.bn).T
            m, v = pix[inside], acc[inside]
            cols = slice(col * p.bn, (col + 1) * p.bn)
            if sums:
                xv = x2[m, cols]
                ma, mb = tr.mask_ab(m, col * p.bn, p.bn)
                gm = torch.where(xv * ma + mb > 0, v, torch.zeros_like(v))
                out[m, cols] = gm * ma if kind == "fused" else gm
                entry = cta // p.col_tiles if per_cta else r
                entries[entry, :, cols] += torch.stack([(gm * xv).sum(0),
                                                        gm.sum(0)])
            else:
                out[m, cols] = v if addend is None else v + addend[m, cols]
            written[m, cols] += 1
    assert bool((written == 1).all())
    if not sums:
        return out, None, p
    if per_cta:
        return out, entries.sum(0, keepdim=True), p
    # a band's entries: gh / hb rows of tiles_w row tiles, consecutive
    assert gh % p.hb == 0 and tiles_h * p.hb == h
    per = gh // p.hb * tiles_w
    return out, entries.reshape(-1, per, 2, ci).sum(1), p


def nhwc(t):
    return t.permute(0, 2, 3, 1)


def table_rows(dw, k, ci, co):
    """A (co, ci, k, k) weight gradient as the kernel's (k*k*ci, co)."""
    return dw.permute(2, 3, 1, 0).reshape(k * k * ci, co)


def rand(gen, *shape, scale=1.0):
    return torch.randn(*shape, generator=gen) * scale


# --------------------------------------------------------------------------
# fused
# --------------------------------------------------------------------------


def fused_case(k, ci, co, nhw, seed):
    gen = torch.Generator().manual_seed(seed)
    n, h, w = nhw
    x = rand(gen, n, ci, h, w).contiguous(memory_format=CL)
    # b > 0 in most channels: relu(0*a + b) = b at a pad tap is not zero
    ab = torch.stack([torch.rand(ci, generator=gen) + 0.5,
                      rand(gen, ci, scale=0.5) + 0.3])
    wk = rand(gen, co, ci, k, k) / (k * k * ci) ** 0.5
    y = rand(gen, n, co, h, w).contiguous(memory_format=CL)
    dy = rand(gen, n, co, h, w, scale=0.1).contiguous(memory_format=CL)
    ds = torch.stack([rand(gen, co, scale=0.1), rand(gen, co, scale=0.05)])
    return x, ab, wk, y, dy, ds


def emulate_fused_bwd(x, ab, wk, y, dy, ds, sms, rezero=True):
    """fused_conv_bwd on the CPU: (dx rows, dab, dw table) and the two
    plans, over the geometry the wrapper passes (a 1x1's rows)."""
    n, ci, h, w = x.shape
    co, k = wk.shape[0], wk.shape[-1]
    as4 = ((lambda t: CV.rows(t).reshape(1, 1, -1, t.shape[1])) if k == 1
           else nhwc)
    x4, y4, dy4 = as4(x), as4(y), as4(dy)
    tr = FusedT(ab, ds)
    dw, pw = emulate_dw(x4, dy4, y4, k, sms, tr, 2, rezero)
    wflip = wk.flip(2, 3).permute(1, 2, 3, 0).reshape(ci, k * k * co)
    dx, dab, px = emulate_dx(dy4, y4, wflip, k, sms, tr, 2, "fused", x4,
                             rezero=rezero)
    return dx, dab[0], dw, pw, px


@pytest.mark.parametrize("k,ci,co,nhw,sms", [
    (3, 64, 64, (2, 9, 11), 8),      # ragged W and H against the boxes
    (3, 64, 128, (1, 12, 13), 40),   # two chunks a CTA, bn 128 dW
    (3, 128, 64, (1, 5, 70), 3),     # a row wider than the dW box; halo
    (3, 64, 64, (1, 4, 64), 5),      # halo boxes of 2 rows (wb 64)
    (1, 64, 128, (3, 5, 9), 4),      # rows, resident weight, M % 128
    (1, 128, 64, (2, 4, 33), 6),     # dX bn 128, two column tiles
    (1, 256, 256, (1, 8, 40), 132),  # dW two chunks, bn 128, 2 col tiles
])
def test_fused_bwd_emulation_equals_the_plain_backward(k, ci, co, nhw, sms):
    x, ab, wk, y, dy, ds = fused_case(k, ci, co, nhw, k * 1000 + ci + co)
    pdx, pdab, pdw = FU.conv_bwd_reference(x, ab, wk, y, dy, ds)
    dx, dab, dw, pw, px = emulate_fused_bwd(x, ab, wk, y, dy, ds, sms)
    torch.testing.assert_close(dx, CV.rows(pdx), **TOL)
    torch.testing.assert_close(dab, pdab, **TOL)
    torch.testing.assert_close(dw, table_rows(pdw, k, ci, co), **TOL)
    assert px.grid % px.col_tiles == 0 and pw.splits >= 1


@pytest.mark.parametrize("k", [1, 3])
def test_fused_bwd_emulation_catches_the_pad_tap_trap(k):
    """The transform applied to TMA's zero fill without the re-zero:
    relu(0*a + b) at a 3x3's pad taps and past the image, dy_eff = ds0 on
    pixels outside it. The plain backward must disagree."""
    nhw = (1, 5, 7) if k == 3 else (1, 3, 45)  # M = 135: a ragged row tile
    x, ab, wk, y, dy, ds = fused_case(k, 64, 64, nhw, 7 + k)
    pdx, pdab, pdw = FU.conv_bwd_reference(x, ab, wk, y, dy, ds)
    dx, dab, dw, _, _ = emulate_fused_bwd(x, ab, wk, y, dy, ds, 4,
                                          rezero=False)
    want = (CV.rows(pdx), pdab, table_rows(pdw, k, 64, 64))
    caught = []
    for got, ref in zip((dx, dab, dw), want):
        try:
            torch.testing.assert_close(got, ref, **TOL)
            caught.append(False)
        except AssertionError:
            caught.append(True)
    # the 3x3's pad taps move dW and dX (a pad tap's dy_eff = ds0 enters
    # the dX of the border pixels); the 1x1's rows past M move dW (ds0
    # there times relu(b)), while its dX rows past M are not stored
    assert caught[2]
    assert caught[0] == (k == 3)


# --------------------------------------------------------------------------
# ghost
# --------------------------------------------------------------------------


def ghost_case(k, ci, co, nhwgh, seed, g_f32=True, edge=False):
    gen = torch.Generator().manual_seed(seed)
    n, h, w, gh = nhwgh
    nb = h // gh
    x = rand(gen, n, ci, h, w).contiguous(memory_format=CL)
    tx = torch.stack([torch.rand(n, nb, ci, generator=gen) + 0.5,
                      rand(gen, n, nb, ci, scale=0.5) + 0.2], 2)
    g = rand(gen, n, co, h, w, scale=0.1).contiguous(memory_format=CL)
    if not g_f32:
        g = g.to(torch.bfloat16).float().contiguous(memory_format=CL)
    z = rand(gen, n, co, h, w).contiguous(memory_format=CL)
    td = torch.stack([torch.rand(n, nb, co, generator=gen) + 0.5,
                      rand(gen, n, nb, co, scale=0.05),
                      rand(gen, n, nb, co, scale=0.02)], 2)
    wk = rand(gen, co, ci, k, k) / (k * k * ci) ** 0.5
    e = rand(gen, n, nb, 2, w, co, scale=0.1) if edge else None
    return x, tx, g, z, td, wk, e


def emulate_ghost_bwd(x, tx, g, z, td, wk, gh, edge, addend, out, sms,
                      aux, rezero=True, own_band=False):
    n, ci, h, w = x.shape
    co, k = wk.shape[0], wk.shape[-1]
    tr = GhostT(tx, td, edge, gh, w, own_band)
    dw, pw = emulate_dw(nhwc(x), nhwc(z), nhwc(g), k, sms, tr, aux, rezero)
    wflip = wk.flip(2, 3).permute(1, 2, 3, 0).reshape(ci, k * k * co)
    dx, sums, px = emulate_dx(
        nhwc(z), nhwc(g), wflip, k, sms, tr, aux, out, nhwc(x),
        None if addend is None else CV.rows(addend), gh, rezero)
    return dx, sums, dw, pw, px


@pytest.mark.parametrize("k,ci,co,nhwgh,out,aux,sms", [
    # conv2 (3x3, f32 g): 3 bands of 2 rows, W ragged against the boxes
    (3, 64, 64, (1, 6, 10, 2), "gm", 4, 8),
    (3, 64, 64, (1, 6, 70, 2), "gm", 4, 8),    # halo mode, 3 bands
    (3, 64, 128, (1, 12, 64, 4), "gm", 4, 9),  # halo boxes of 2 rows
    (3, 64, 128, (2, 8, 12, 4), "gm", 4, 40),  # 2 bands an image, bn 128
    (1, 128, 64, (1, 6, 20, 2), "gm", 2, 4),   # conv3 (1x1, bf16 g)
    (1, 64, 128, (2, 6, 9, 3), "act", 4, 6),   # conv1: edge, addend, bf16 out
    (1, 64, 64, (1, 9, 16, 3), "f32", 2, 5),   # the shortcut's f32 dX
])
def test_ghost_bwd_emulation_equals_the_plain_backward(k, ci, co, nhwgh, out,
                                                       aux, sms):
    n, h, w, gh = nhwgh
    edge = out == "act"
    x, tx, g, z, td, wk, e = ghost_case(k, ci, co, nhwgh, 100 * k + ci + co,
                                        g_f32=aux == 4, edge=edge)
    if out != "gm":
        tx = None  # conv1 and the shortcut read the unit's input as it is
    addend = (rand(torch.Generator().manual_seed(3), n, ci, h, w)
              .contiguous(memory_format=CL) if out == "act" else None)
    pdx, psums, pdw = G.conv_bwd_reference(x, tx, g, z, td, wk, gh, e, addend,
                                           out)
    dx, sums, dw, pw, px = emulate_ghost_bwd(x, tx, g, z, td, wk, gh, e,
                                             addend, out, sms, aux)
    torch.testing.assert_close(dx, CV.rows(pdx), **TOL)
    torch.testing.assert_close(dw, table_rows(pdw, k, ci, co), **TOL)
    if out == "gm":
        torch.testing.assert_close(sums, psums.reshape(-1, 2, ci), **TOL)
    assert gh % px.hb == 0 and h // gh >= 2


@pytest.mark.parametrize("w", [10, 70], ids=["per_tap", "halo"])
@pytest.mark.parametrize("fault", ["pad", "own_band"])
def test_ghost_bwd_emulation_catches_planted_faults(fault, w):
    """On 3 bands of 2 rows: the transform without the re-zero (dz = c1 at
    the pad and past the image, relu(b) at the pad taps), and the 3x3's
    halo rows under their own band's affine instead of the reading
    band's. The plain backward must disagree with each."""
    gh = 2
    x, tx, g, z, td, wk, e = ghost_case(3, 64, 64, (1, 6, w, gh), 11)
    pdx, psums, pdw = G.conv_bwd_reference(x, tx, g, z, td, wk, gh)
    dx, sums, dw, _, _ = emulate_ghost_bwd(
        x, tx, g, z, td, wk, gh, None, None, "gm", 8, 4,
        rezero=fault != "pad", own_band=fault == "own_band")
    # the halo fault moves dW (X under the wrong affine); the pad fault
    # moves dW and dX
    with pytest.raises(AssertionError):
        torch.testing.assert_close(dw, table_rows(pdw, 3, 64, 64), **TOL)
    if fault == "pad":
        with pytest.raises(AssertionError):
            torch.testing.assert_close(dx, CV.rows(pdx), **TOL)


def test_ghost_edge_lands_on_band_edges():
    """The seam term enters dz on each band's first and last rows only:
    with a zero g and tables (dz = edge), the emulated 1x1 dW equals the
    plain one and differs from it when the edge term is spread over every
    row of the band."""
    gh, nhwgh = 3, (1, 9, 8, 3)
    x, _, g, z, td, wk, e = ghost_case(1, 64, 64, nhwgh, 21, edge=True)
    td = torch.zeros_like(td)
    pdx, _, pdw = G.conv_bwd_reference(x, None, g, z, td, wk, gh, e,
                                       None, "f32")
    dx, _, dw, _, _ = emulate_ghost_bwd(x, None, g, z, td, wk, gh, e, None,
                                        "f32", 4, 4)
    torch.testing.assert_close(dw, table_rows(pdw, 1, 64, 64), **TOL)
    torch.testing.assert_close(dx, CV.rows(pdx), **TOL)
    assert float(dw.abs().max()) > 0

    class Everywhere(GhostT):
        def dy(self, z, g, pix, c0):
            band = pix // self.px
            off = pix - band * self.px
            return self.edge[band, 0, off % self.w, c0:c0 + 64]

    tr = Everywhere(None, td, e, gh, 8)
    wrong, _ = emulate_dw(nhwc(x), nhwc(z), nhwc(g), 1, 4, tr, 4)
    assert not torch.allclose(wrong, dw, **TOL)


# --------------------------------------------------------------------------
# the plans
# --------------------------------------------------------------------------

# the fused convs of the 512^2 batch-32 step as each plan sees them (a
# 1x1's rows), the ghost convs (image geometry, gh 8), and small shapes
BWD_SHAPES = [(1, 1, 524288, 64, 256, 1, 0), (1, 1, 524288, 256, 64, 1, 0),
              (1, 1, 8192, 1024, 2048, 1, 0), (1, 1, 8192, 2048, 512, 1, 0),
              (32, 128, 128, 64, 64, 3, 0), (32, 16, 16, 512, 512, 3, 0),
              (32, 128, 128, 64, 64, 3, 8), (32, 64, 64, 128, 128, 3, 8),
              (32, 128, 128, 256, 64, 1, 8), (32, 64, 64, 512, 128, 1, 8),
              (1, 6, 10, 64, 64, 3, 2), (2, 6, 9, 64, 128, 1, 3),
              (1, 1, 135, 64, 64, 1, 0)]


@pytest.mark.parametrize("n,h,w,ci,co,ks,gh", BWD_SHAPES)
@pytest.mark.parametrize("aux", [2, 4])
def test_staged_bwd_plans_fit_the_card(n, h, w, ci, co, ks, gh, aux):
    # dW: boxes of KP pixels, the ring with its aux boxes and the parked
    # accumulators within the shared memory, bn dividing Co, clusters of
    # <= 2 that divide the splits, every split non-empty
    p = CV.tma_dw_plan(n, h, w, ci, co, ks, 132, aux)
    assert p.wb * p.hb == CV.KP and max(p.wb, p.hb) <= 256
    assert p.bn in (64, 128) and co % p.bn == 0
    stage = ((2 if p.two else 1) + p.bn // 64) * CV.BOX \
        + p.bn // 64 * CV.KP * 64 * aux
    assert 2 <= p.stages <= CV.MAX_STAGES
    assert p.stages * (stage + 16) + 1024 <= CV.MAX_SMEM
    assert 2 * 64 * (p.bn + 8) * 4 <= p.stages * stage
    ntiles = n * -(-h // p.hb) * -(-w // p.wb)
    assert 1 <= p.splits <= ntiles and p.cluster in (1, 2)
    assert p.splits % p.cluster == 0
    # dX: TM-pixel boxes whose height divides gh, the ring (halo boxes for
    # a 3x3 of a 64- or 128-pixel box), the resident weight, the epilogue
    # slots, the column sums and the mask within the shared memory, every
    # tile visited once, a CTA's tiles in one column
    for slot in (False, True):
        q = CV.tma_bwd_dx_plan(n, h, w, ci, co, ks, 132, aux, slot, gh)
        assert q.wb * q.hb == CV.TM and max(q.wb, q.hb) <= 256
        assert not gh or gh % q.hb == 0
        assert q.bn in (64, 128) and ci % q.bn == 0
        assert q.halo == (ks == 3 and q.wb >= 64)
        ksteps = (3 if q.halo else ks * ks) * co // 64
        if q.halo:
            rows = (q.wb + 2) * q.hb
            stage = (CV.round1k(rows * 128) + CV.round1k(rows * 64 * aux)
                     + 3 * q.bn * 128)
        else:
            stage = CV.TM * 128 + CV.TM * 64 * aux + (0 if q.resident
                                                      else q.bn * 128)
        assert q.eslots == 0 if not slot else q.eslots in (1, 2, 3)
        smem = (q.stages * (stage + 16) + q.resident * ksteps * q.bn * 128
                + q.eslots * CV.TM * q.bn * 2 + 9 * 2 * q.bn * 4 + 56 + 1024)
        assert 2 <= q.stages <= CV.MAX_FWD_STAGES and smem <= CV.MAX_SMEM
        assert not q.resident or (ks == 1 and q.stages >= CV.MIN_A_SLOTS)
        tiles = q.row_tiles * q.col_tiles
        assert 1 <= q.grid <= min(132, tiles) and q.grid % q.col_tiles == 0
        seen = [t for cta in range(q.grid) for t in q.tiles_of(cta)]
        assert sorted(seen) == list(range(tiles))


def test_staged_dw_plan_leaves_conv_dw_as_it_was():
    """aux = 0 is conv_dw.cu's plan: bn up to 256, no aux boxes."""
    p = CV.tma_dw_plan(1, 1, 524288, 64, 256, 1, 132)
    assert p.bn == 256 and p == CV.tma_dw_plan(1, 1, 524288, 64, 256, 1,
                                               132, 0)
    assert CV.tma_dw_plan(1, 1, 524288, 64, 256, 1, 132, 2).bn == 128


def test_staged_dw_split_fills_the_waves():
    """The staged dW's split (tma_dw_plan with aux boxes) counts waves of
    CTAs: the 512-channel 3x3 at 16^2 has 144 table tiles for 132 SMs,
    so one split would run a second wave of 12 CTAs as long as the first;
    the plan's split takes fewer pixel tiles a wave than one split does,
    and no split is empty."""
    p = CV.tma_dw_plan(32, 16, 16, 512, 512, 3, 132, 2)
    tiles, ntiles = 36 * 512 // p.bn, 32 * 16 * 16 // CV.KP

    def cost(s):
        return -(-tiles * s // 132) * (-(-ntiles // s) + CV.DW_CTA_TILES)
    assert p.splits > 1 and cost(p.splits) < cost(1)
    assert p.splits == CV.staged_dw_splits(tiles, ntiles, 132)
    assert all(cost(p.splits) <= cost(s) for s in range(1, ntiles + 1))
    # where the tiles fit one wave, one wave of splits
    q = CV.tma_dw_plan(32, 128, 128, 64, 64, 3, 132, 2)
    assert 5 * q.splits <= 132 < 5 * (q.splits + 1)


def c_entry_points(source):
    """{name: [ctypes type of each parameter]} of the extern "C" functions
    of csrc/<source>.cu: pointers (void*, const void*) and ints."""
    import re
    from tensorflow_ocr_tpu_torch.ops.kernels import CSRC_DIR

    text = (CSRC_DIR / f"{source}.cu").read_text()
    out = {}
    for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text):
        kinds = []
        for p in params.split(","):
            p = " ".join(p.split())
            assert p.startswith(("int ", "void* ", "const void* ")), p
            kinds.append(ctypes.c_int if p.startswith("int ")
                         else ctypes.c_void_p)
        out[name] = kinds
    return out


@pytest.mark.parametrize("source,sigs", [
    ("fused_conv", FU.SIGNATURES["fused_conv"]),
    ("fused_boundary", FU.SIGNATURES["fused_boundary"]),
    ("ghost_unit", G.SIGNATURES)])
def test_ctypes_signatures_match_the_c_entry_points(source, sigs):
    """The wrappers' ctypes argument types are the C functions' own, one
    for one: a missing int would pass the stream as a 32-bit int."""
    assert c_entry_points(source) == sigs


@pytest.mark.parametrize("source,name,sigs,geometry", [
    ("fused_conv", "fused_conv_fwd", FU.SIGNATURES["fused_conv"], 6),
    ("ghost_unit", "ghost_conv_fwd", G.SIGNATURES, 7)])
def test_forward_entry_points_take_the_staged_plan(source, name, sigs,
                                                   geometry):
    """The staged forwards take x, the table, the weight, y, the sums and
    the sums' scratch entries (six pointers), the geometry (n, h, w, ci,
    co, ks, and gh for the ghost conv), the seven fields of
    tma_staged_fwd_plan that the kernel reads (wb, hb, bn, resident,
    stages, grid, eslots) and the stream, in the C function and in the
    wrapper's ctypes list alike."""
    fields = ("wb", "hb", "bn", "resident", "stages", "grid", "eslots")
    assert set(fields) <= set(CV.TmaBwdDxPlan._fields)
    want = [ctypes.c_void_p] * 6 + [ctypes.c_int] * (geometry + len(fields)) \
        + [ctypes.c_void_p]
    assert c_entry_points(source)[name] == sigs[name] == want
