"""The staged forward (csrc/conv_bwd.cuh ``tdx`` in its forward mode, run
by fused_conv.cu's fused_conv_fwd and ghost_unit.cu's ghost_conv_fwd)
emulated on the CPU, held against the plain versions (ops/fused.py and
ops/ghost.py ``conv_fwd_reference``) and through them against JAX; and its
plan (ops/conv.py tma_staged_fwd_plan) at every shape of the train step.

The emulation walks tma_staged_fwd_plan's persistent tiles: a tile is a
wb x hb box of one image by bn output channels; each K step's A box is
x's box at the tile shifted by the tap (halo mode: one (wb + 2) x hb box
a ky and 64 channels, read by the three kx taps), zero outside the image
(TMA's fill), rewritten through relu(x*a + b) under the table of the
tile's key (one table for the fused conv, the band of the tile for the
ghost conv, which for a 3x3's halo rows is the reading band's) and
zeroed again where the pixel read lies outside the image; the epilogue
stores y once and sums the column values of the pixels inside the image,
[Σv, Σv²] with v the float32 accumulator (fused, one entry a CTA) or the
rounded y (ghost: over each run of a CTA's tiles in one band, into the
entry of the run's last row tile, the others zero), and the entries are
added in order. Float32 on the CPU: sums in another order, within 1e-5 relative
and 1e-4 absolute (against JAX, 1e-5 of the largest value).

Planted faults, each of which must be caught: relu(b) left at the pad
taps (no re-zero after the transform), a ghost 3x3's halo rows zeroed as
the dX zeroes them, the halo rows under their own band's affine, and the
sums taken over the rows of a tile that lie past the image.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tensorflow_ocr_tpu.ops import pallas_fused as PF
from tensorflow_ocr_tpu.ops import pallas_unit as PU
from tensorflow_ocr_tpu_torch.ops import conv as CV
from tensorflow_ocr_tpu_torch.ops import fused as FU
from tensorflow_ocr_tpu_torch.ops import ghost as G
from test_torch_conv import tma_box
from test_torch_conv_bwd import box_pixels
from test_torch_conv_fwd import weight_box

torch.set_num_threads(1)
CL = torch.channels_last
TOL = dict(rtol=1e-5, atol=1e-4)
FAULTS = ("pad", "halo_zeroed", "own_band", "sums_outside")


def emulate_staged_fwd(x4, wt, ks, sms, tab, gh=0, per_cta=True,
                       rounded=False, fault=None):
    """tdx's forward mode and reduce_parts: x4 (N, H, W, Ci) (a 1x1's rows
    as (1, 1, M, Ci)), wt (Co, ks*ks*Ci), tab (keys, 2, Ci) or None (x as
    it is), key = the band of gh rows of the tile (gh > 0) or 0. Returns
    (y rows (N*H*W, Co), sums (1 or N*H/gh, 2, Co), the plan).

    ``fault`` plants one of FAULTS."""
    n, h, w, ci = x4.shape
    co = wt.shape[0]
    p = CV.tma_staged_fwd_plan(n, h, w, ci, co, ks, sms, gh)
    assert p.halo == (ks == 3 and p.wb >= 64)
    assert not gh or (gh % p.hb == 0 and h % gh == 0)
    wt3 = wt.reshape(co, ks * ks, ci)
    tiles_w, tiles_h = -(-w // p.wb), -(-h // p.hb)
    cb, half, band_px = -(-ci // 64), ks // 2, gh * w
    if tab is not None:  # TMA's boxes run 64 channels past a ragged ci
        tab = F.pad(tab, (0, cb * 64 - ci))
    entries = torch.zeros(p.grid // p.col_tiles if per_cta else p.row_tiles,
                          2, co)
    y = torch.zeros(n * h * w, co, dtype=x4.dtype)
    written = torch.zeros(n * h * w, co, dtype=torch.int32)
    rows = torch.arange(CV.TM)
    # halo mode: output row r reads halo row (r // wb) * (wb + 2) + r % wb
    # + kx of the (ky, channel box) halo box
    hrow = rows // p.wb * (p.wb + 2) + rows % p.wb

    def stage(raw, c0, key, src, out_px, live):
        """The A box rewritten: T_x under the table of ``key`` (the tile's
        band), zero where ``live`` is false."""
        if fault == "own_band":
            key = src // band_px  # each row under its own band's affine
        if fault == "halo_zeroed":  # the dX's restriction to one band
            live = live & (src // band_px == out_px // band_px)
        if tab is None:
            return torch.where(live[:, None], raw, torch.zeros_like(raw))
        t = tab[key] if torch.is_tensor(key) else tab[key][None]
        v = torch.relu(raw * t[:, 0, c0:c0 + 64] + t[:, 1, c0:c0 + 64])
        if fault == "pad":  # relu(b) left where TMA filled zeros
            return v
        return torch.where(live[:, None], v, torch.zeros_like(v))

    def key_of(t):
        r = t // p.col_tiles
        img, y0 = r // (tiles_w * tiles_h), r // tiles_w % tiles_h * p.hb
        return (img * h + y0) * w // band_px if gh else 0

    for cta in range(p.grid):
        tiles = p.tiles_of(cta)
        run = torch.zeros(2, p.bn)  # the sums of the run of tiles so far
        for i, t in enumerate(tiles):
            col, r = t % p.col_tiles, t // p.col_tiles
            assert col == cta % p.col_tiles  # a CTA's tiles share a column
            x0, y0 = r % tiles_w * p.wb, r // tiles_w % tiles_h * p.hb
            img = r // (tiles_w * tiles_h)
            inside, pix = box_pixels(img, y0, x0, p.hb, p.wb, h, w)
            key = key_of(t)  # a tile lies in one band
            acc = torch.zeros(CV.TM, p.bn)
            for k in range(ks * ks * cb):
                tap, c0 = k // cb, k % cb * 64
                ky, kx = divmod(tap, ks)
                if p.halo:
                    if kx:
                        continue  # the ky step's box serves all three taps
                    src_in, src = box_pixels(img, y0 + ky - 1, x0 - 1, p.hb,
                                             p.wb + 2, h, w)
                    _, opx = box_pixels(img, y0, x0 - 1, p.hb, p.wb + 2, h, w)
                    a = stage(tma_box(x4, img, y0 + ky - 1, x0 - 1, c0, p.hb,
                                      p.wb + 2), c0, key, src, opx, src_in)
                    for kx2 in range(3):
                        acc += a[hrow + kx2] @ weight_box(
                            wt3, 3 * ky + kx2, c0, col * p.bn, p.bn).T
                    continue
                sy, sx = y0 + ky - half, x0 + kx - half
                src_in, src = box_pixels(img, sy, sx, p.hb, p.wb, h, w)
                a = stage(tma_box(x4, img, sy, sx, c0, p.hb, p.wb), c0, key,
                          src, pix, inside & src_in)
                acc += a @ weight_box(wt3, tap, c0, col * p.bn, p.bn).T
            cols = slice(col * p.bn, (col + 1) * p.bn)
            yv = acc.to(x4.dtype)
            y[pix[inside], cols] = yv[inside]
            written[pix[inside], cols] += 1
            v = yv.float() if rounded else acc
            if fault != "sums_outside":
                v = torch.where(inside[:, None], v, torch.zeros_like(v))
            run += torch.stack([v.sum(0), (v * v).sum(0)])
            if per_cta:  # one entry a CTA, at its end
                if i + 1 == len(tiles):
                    entries[cta // p.col_tiles, :, cols] = run
            elif i + 1 == len(tiles) or key_of(tiles[i + 1]) != key:
                entries[r, :, cols] = run  # the run's entry; the others 0
                run = torch.zeros(2, p.bn)
    assert bool((written == 1).all())
    # reduce_parts: each group's entries added in order
    per = len(entries) if per_cta else gh // p.hb * tiles_w
    groups = entries.reshape(-1, per, 2, co)
    sums = torch.zeros(groups.shape[0], 2, co)
    for e in range(per):
        sums += groups[:, e]
    return y, sums, p


def nhwc(t):
    return t.permute(0, 2, 3, 1)


def emulate_fused_fwd(x, ab, wk, sms, fault=None):
    """fused_conv_fwd on the CPU: (y rows, s, plan), over the geometry the
    wrapper passes (a 1x1's rows)."""
    n, ci, h, w = x.shape
    co, k = wk.shape[0], wk.shape[-1]
    x4 = CV.rows(x).reshape(1, 1, -1, ci) if k == 1 else nhwc(x)
    wt = wk.permute(0, 2, 3, 1).reshape(co, k * k * ci)
    y, s, p = emulate_staged_fwd(x4, wt, k, sms, ab[None], fault=fault)
    return y, s[0], p


def emulate_ghost_fwd(x, tab, wk, gh, sms, fault=None):
    """ghost_conv_fwd on the CPU: (y rows, band sums (N, nb, 2, Co),
    plan)."""
    n, ci, h, w = x.shape
    co, k = wk.shape[0], wk.shape[-1]
    wt = wk.permute(0, 2, 3, 1).reshape(co, k * k * ci)
    flat = None if tab is None else tab.reshape(-1, 2, ci)
    y, s, p = emulate_staged_fwd(nhwc(x), wt, k, sms, flat, gh, False, True,
                                 fault)
    return y, s.reshape(n, h // gh, 2, co), p


def rand(gen, *shape, scale=1.0):
    return torch.randn(*shape, generator=gen) * scale


def fused_case(k, ci, co, nhw, seed):
    gen = torch.Generator().manual_seed(seed)
    n, h, w = nhw
    x = rand(gen, n, ci, h, w).contiguous(memory_format=CL)
    # b > 0 in most channels: relu(0*a + b) = b at a pad tap is not zero
    ab = torch.stack([torch.rand(ci, generator=gen) + 0.5,
                      rand(gen, ci, scale=0.5) + 0.3])
    wk = rand(gen, co, ci, k, k) / (k * k * ci) ** 0.5
    return x, ab, wk


def ghost_case(k, ci, co, nhwgh, seed, with_tab=True):
    gen = torch.Generator().manual_seed(seed)
    n, h, w, gh = nhwgh
    nb = h // gh
    x = rand(gen, n, ci, h, w).contiguous(memory_format=CL)
    # each band its own affine, b > 0 in most channels
    tab = torch.stack([torch.rand(n, nb, ci, generator=gen) + 0.5,
                       rand(gen, n, nb, ci, scale=0.5) + 0.3], 2)
    wk = rand(gen, co, ci, k, k) / (k * k * ci) ** 0.5
    return x, tab if with_tab else None, wk


def caught(got, want):
    try:
        torch.testing.assert_close(got, want, **TOL)
    except AssertionError:
        return True
    return False


# --------------------------------------------------------------------------
# fused
# --------------------------------------------------------------------------


@pytest.mark.parametrize("k,ci,co,nhw,sms", [
    (3, 64, 64, (2, 9, 11), 8),      # ragged W and H against the boxes
    (3, 64, 128, (1, 5, 70), 3),     # halo mode, a row wider than the box
    (3, 128, 64, (1, 4, 64), 5),     # halo boxes of 2 rows, two K boxes
    (3, 128, 128, (2, 6, 16), 7),    # per tap, bn 128, a CTA of several
    (1, 64, 128, (3, 5, 9), 4),      # rows, resident weight, M % 128
    (1, 128, 256, (2, 4, 33), 6),    # bn 128, two column tiles
    (1, 256, 64, (1, 8, 40), 132),   # one tile a CTA
])
def test_fused_fwd_emulation_equals_the_plain_forward(k, ci, co, nhw, sms):
    x, ab, wk = fused_case(k, ci, co, nhw, k * 1000 + ci + co)
    py, ps = FU.conv_fwd_reference(x, ab, wk)
    y, s, p = emulate_fused_fwd(x, ab, wk, sms)
    torch.testing.assert_close(y, CV.rows(py), **TOL)
    torch.testing.assert_close(s, ps, **TOL)
    assert p.grid % p.col_tiles == 0 and p.eslots >= 1


@pytest.mark.parametrize("k,nhw", [(1, (2, 5, 7)), (3, (2, 6, 7))])
def test_fused_fwd_emulation_matches_the_interpreted_jax_kernels(k, nhw):
    """The emulated forward against pallas_fused's _f1x1 / _f3x3 run in
    interpret mode (one block an image: bm = M, th = H)."""
    n, h, w = nhw
    x, ab, wk = fused_case(k, 64, 128, nhw, 31 + k)
    y, s, _ = emulate_fused_fwd(x, ab, wk, 5)
    xj = jnp.asarray(nhwc(x).numpy())
    wj = jnp.asarray(wk.permute(2, 3, 1, 0).reshape(k * k * 64, 128).numpy())
    PF.set_interpret(True)
    try:
        if k == 1:
            jy, js = PF.fused_conv1x1(xj, jnp.asarray(ab.numpy()), wj,
                                      n * h * w)
        else:
            jy, js = PF.fused_conv3x3(xj, jnp.asarray(ab.numpy()), wj, h)
    finally:
        PF.set_interpret(False)
    jy = np.asarray(jy).reshape(-1, 128)
    for got, want in ((y, jy), (s, np.asarray(js))):
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err < 1e-5, err


@pytest.mark.parametrize("k", [1, 3])
def test_fused_fwd_emulation_catches_the_pad_tap_trap(k):
    """relu(b) left where TMA filled zeros: a 3x3's pad taps move y and s;
    a 1x1 has no pad taps, and its rows past M are neither stored nor
    summed, so it stays right."""
    nhw = (1, 5, 7) if k == 3 else (1, 3, 45)  # M = 135: a ragged row tile
    x, ab, wk = fused_case(k, 64, 64, nhw, 7 + k)
    py, ps = FU.conv_fwd_reference(x, ab, wk)
    y, s, _ = emulate_fused_fwd(x, ab, wk, 4, fault="pad")
    assert caught(y, CV.rows(py)) == (k == 3)
    assert caught(s, ps) == (k == 3)


def test_fused_fwd_emulation_catches_sums_past_the_image():
    """A halo box reads live pixels for the rows of a tile past the image
    (W = 120 against 128-pixel boxes): their products are not y, and the
    sums must leave them out."""
    x, ab, wk = fused_case(3, 64, 64, (1, 4, 120), 12)
    py, ps = FU.conv_fwd_reference(x, ab, wk)
    y, s, p = emulate_fused_fwd(x, ab, wk, 4, fault="sums_outside")
    assert p.halo
    torch.testing.assert_close(y, CV.rows(py), **TOL)
    assert caught(s, ps)


# --------------------------------------------------------------------------
# ghost
# --------------------------------------------------------------------------


@pytest.mark.parametrize("k,ci,co,nhwgh,sms,with_tab", [
    (3, 64, 64, (1, 6, 10, 2), 8, True),     # 3 bands of 2 rows, halo mode
    (3, 64, 128, (1, 12, 10, 4), 5, True),   # 3 bands of 4, per tap (wb 32)
    (3, 128, 64, (2, 8, 64, 4), 40, True),   # 2 bands an image, 2 K boxes
    (1, 64, 128, (2, 6, 9, 3), 6, True),     # conv3: a 1x1 under the bands
    (1, 128, 64, (1, 9, 16, 3), 5, False),   # conv1 and the shortcut: as is
    (1, 64, 256, (1, 8, 70, 2), 9, True),    # ragged W, two column tiles
])
def test_ghost_fwd_emulation_equals_the_plain_forward(k, ci, co, nhwgh, sms,
                                                      with_tab):
    n, h, w, gh = nhwgh
    x, tab, wk = ghost_case(k, ci, co, nhwgh, 100 * k + ci + co, with_tab)
    py, ps = G.conv_fwd_reference(x, tab, wk, gh)
    y, s, p = emulate_ghost_fwd(x, tab, wk, gh, sms)
    torch.testing.assert_close(y, CV.rows(py), **TOL)
    torch.testing.assert_close(s, ps, **TOL)
    assert gh % p.hb == 0 and h // gh >= 2


@pytest.mark.parametrize("w", [10, 120], ids=["per_tap", "halo"])
@pytest.mark.parametrize("fault", FAULTS)
def test_ghost_fwd_emulation_catches_planted_faults(fault, w):
    """On 3 bands of 4 rows (W = 10: per tap, wb 32; W = 120: halo mode,
    wb 128 against a ragged W): relu(b) at the pad taps, the 3x3's halo rows
    zeroed as in the dX, the halo rows under their own band's affine, and
    sums over the rows past the image. The plain forward must disagree
    with each, bar the last in per-tap mode, whose rows past the image
    read nothing."""
    gh = 4
    x, tab, wk = ghost_case(3, 64, 64, (1, 12, w, gh), 11)
    py, ps = G.conv_fwd_reference(x, tab, wk, gh)
    y, s, p = emulate_ghost_fwd(x, tab, wk, gh, 8, fault=fault)
    assert p.halo == (w == 120)
    if fault == "sums_outside":
        torch.testing.assert_close(y, CV.rows(py), **TOL)
        assert caught(s, ps) == p.halo
    else:
        assert caught(y, CV.rows(py)) and caught(s, ps)


N, H, W, GH, EPS = 1, 24, 16, 8, 1e-5


def unit_inputs(proj, seed):
    """JAX-layout numpy inputs of one unit at 3 bands of GH rows: o, w1
    (ci, db), gb1, w2 (9db, db), gb2, w3 (db, co), gb3[, ws, gbs]."""
    rng = np.random.RandomState(seed)
    ci, db, co = (64, 64, 128) if proj else (128, 64, 128)
    f = np.float32
    gb = lambda c: np.stack([rng.uniform(0.5, 1.5, c),  # noqa: E731
                             rng.randn(c) * 0.1]).astype(f)
    args = [(rng.randn(N, H, W, ci) ** 2).astype(f),
            (rng.randn(ci, db) / np.sqrt(ci)).astype(f), gb(db),
            (rng.randn(9 * db, db) / np.sqrt(9 * db)).astype(f), gb(db),
            (rng.randn(db, co) / np.sqrt(db)).astype(f), gb(co)]
    if proj:
        args += [(rng.randn(ci, co) / np.sqrt(ci)).astype(f), gb(co)]
    return args


def port_args(args):
    """JAX layouts -> the port's: NCHW channels-last, OIHW weights."""
    o, w1, gb1, w2, gb2, w3, gb3, *sc = args
    db = w1.shape[1]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    out = [t(o).permute(0, 3, 1, 2).contiguous(memory_format=CL),
           t(w1.T[:, :, None, None]), t(gb1),
           t(w2.reshape(3, 3, db, db).transpose(3, 2, 0, 1)), t(gb2),
           t(w3.T[:, :, None, None]), t(gb3)]
    if sc:
        out += [t(sc[0].T[:, :, None, None]), t(sc[1])]
    return out


@pytest.mark.parametrize("proj", [False, True], ids=["identity", "proj"])
def test_ghost_unit_on_the_emulated_forward_matches_interpreted_jax(
        monkeypatch, proj):
    """One unit's forward (ops/ghost.py _unit_forward: z1, z2 with its halo
    rows, z3, zs and the boundary) with every conv on the emulated staged
    forward, against pallas_unit's _unit_fwd run in interpret mode, at 3
    bands an image: out and the statistics within 1e-5 of their largest
    value."""
    args = unit_inputs(proj, 4 + proj)

    def staged(x, tab, w, gh):
        y, s, _ = emulate_ghost_fwd(x, tab, w, gh, 6)
        n, _, h, wd = x.shape
        return CV.unrows(y, n, h, wd).contiguous(memory_format=CL), s

    monkeypatch.setattr(G, "conv_fwd", staged)
    targs = port_args(args)
    if not proj:
        targs += [None, None]
    outs, _ = G._unit_forward(*targs, GH, EPS)
    PU.set_interpret(True)
    try:
        fn = PU.ghost_unit_proj if proj else PU.ghost_unit_id
        want = fn(*map(jnp.asarray, args), GH, EPS)
    finally:
        PU.set_interpret(False)
    got = [nhwc(outs[0]).numpy()] + [s.numpy() for s in outs[1:len(want)]]
    for i, (g, wv) in enumerate(zip(got, want)):
        wv = np.asarray(wv)
        err = np.abs(g - wv).max() / np.abs(wv).max()
        assert err < 1e-5, (i, err)


# --------------------------------------------------------------------------
# the plan at the train step's shapes
# --------------------------------------------------------------------------

# (N, H, W, Ci, Co, k) of every fused conv of the 512^2 batch-32 step
FUSED_SHAPES = (
    (32, 128, 128, 64, 64, 1), (32, 128, 128, 64, 256, 1),
    (32, 128, 128, 256, 64, 1), (32, 128, 128, 64, 64, 3),
    (32, 64, 64, 256, 128, 1), (32, 64, 64, 256, 512, 1),
    (32, 64, 64, 512, 128, 1), (32, 64, 64, 128, 512, 1),
    (32, 64, 64, 128, 128, 3),
    (32, 32, 32, 512, 256, 1), (32, 32, 32, 512, 1024, 1),
    (32, 32, 32, 1024, 256, 1), (32, 32, 32, 256, 1024, 1),
    (32, 32, 32, 256, 256, 3),
    (32, 16, 16, 1024, 512, 1), (32, 16, 16, 1024, 2048, 1),
    (32, 16, 16, 2048, 512, 1), (32, 16, 16, 512, 2048, 1),
    (32, 16, 16, 512, 512, 3))
# (N, H, W, Ci, db, Co, gh) of the step's ghost units; their convs are
# z1 (Ci -> db, 1x1), z2 (db -> db, 3x3), z3 (db -> Co, 1x1), zs (Ci ->
# Co, 1x1, where Ci != Co)
GHOST_UNITS = ((32, 128, 128, 64, 64, 256, 8), (32, 128, 128, 256, 64, 256, 8),
               (32, 64, 64, 256, 128, 512, 8), (32, 64, 64, 512, 128, 512, 8))
STEP_SHAPES = (
    [((1, 1, n * h * w) if k == 1 else (n, h, w), ci, co, k, 0)
     for n, h, w, ci, co, k in FUSED_SHAPES]
    + [((n, h, w), a, b, k, gh) for n, h, w, ci, db, co, gh in GHOST_UNITS
       for a, b, k in ((ci, db, 1), (db, db, 3), (db, co, 1))
       + (((ci, co, 1),) if ci != co else ())])


def test_the_step_has_every_forward_shape():
    """19 fused convs and 14 ghost unit convs (4 of them shortcuts)."""
    assert len(STEP_SHAPES) == 19 + 14


@pytest.mark.parametrize("geo,ci,co,k,gh", STEP_SHAPES)
def test_staged_fwd_plan_fits_the_card(geo, ci, co, k, gh):
    """At every forward of the step: the ring (halo boxes for a 3x3 of a
    64- or 128-pixel box), the resident weight, the epilogue slots, the
    warps' sums and the barriers within 232,448 bytes of shared memory, as
    run_dx counts them; the box height a divisor of gh; every tile visited
    once, a CTA's tiles in one column."""
    p = CV.tma_staged_fwd_plan(*geo, ci, co, k, 132, gh)
    n, h, w = geo
    assert p.wb * p.hb == CV.TM and not gh or gh % p.hb == 0
    assert p.bn in (64, 128) and co % p.bn == 0
    assert p.halo == (k == 3 and p.wb >= 64)
    ksteps = (3 if p.halo else k * k) * ci // 64
    if p.halo:
        stage = CV.round1k((p.wb + 2) * p.hb * 128) + 3 * p.bn * 128
    else:
        stage = CV.TM * 128 + (0 if p.resident else p.bn * 128)
    smem = (p.stages * stage + p.resident * ksteps * p.bn * 128
            + p.eslots * CV.TM * p.bn * 2 + 9 * 2 * p.bn * 4
            + 8 * (2 * p.stages + 7) + 1024)
    assert smem <= CV.MAX_SMEM == 232448
    assert 2 <= p.stages <= CV.MAX_FWD_STAGES and 1 <= p.eslots <= 3
    assert not p.resident or (k == 1 and p.stages >= CV.MIN_A_SLOTS)
    tiles = p.row_tiles * p.col_tiles
    assert 1 <= p.grid <= min(132, tiles) and p.grid % p.col_tiles == 0
    seen = [t for cta in range(p.grid) for t in p.tiles_of(cta)]
    assert sorted(seen) == list(range(tiles))
    assert p.row_tiles == n * -(-h // p.hb) * -(-w // p.wb)
