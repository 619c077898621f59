"""The seam pass (csrc/ghost_unit.cu ``tseam``, run by ghost_seam_bwd)
emulated on the CPU, held against the plain version (ops/ghost.py
``seam_bwd_reference``) and, through a whole ghost unit's backward,
against JAX's pallas_unit kernels interpreted; and its plan (ops/ghost.py
``seam_plan``) at the step's ghost units.

The emulation walks seam_plan's persistent tiles. A side is the slot
written: a band b's first row q (slot 0) or its last (slot 1); q is the
halo row of the neighbouring band rb = b - 1 or b + 1, and q' = q - 1 or
q + 1 the edge row of rb. A seam row (image, band) of a side is cut into
64-pixel segments; a tile is two segments by 64 columns (c = 64, one a
warpgroup) or one by 128 (the two warpgroups 64 columns each). A K step
is a channel box: the segment's 66-pixel halo box of z and g at q' (zero
outside the image: TMA's fill), rewritten into dz = g·a + c1 + 2z·c2
under rb's table, rounded to z's dtype and zeroed where the pixel read
lies outside the image; the three kx taps read it kx rows in against the
flipped kernel's ky row (2 for slot 1, 0 for slot 0), which the kernel
reads unflipped (its row 2 - ky, column 2 - kx). The epilogue masks
with x_q under rb's (a1, b1), writes gm·a1 into edge[b][slot] (zero where
rb lies outside the image) and [Σ gm·x_q, Σ gm] into one entry of rb
(rb modulo nb: the zero entries that no segment reads into), side 0's
(slot 1's) segments before side 1's; the entries are added in order.
Float32 on the CPU (and bf16 activations with a float32 g): sums in
another order, within 1e-5 relative and 1e-4 absolute.

Planted faults, each of which must be caught: the mask under q's own
band, the sides' ky rows swapped, the unread slots left unwritten (the
output starts NaN, a stand-in for torch.empty), the w pad's taps not
zeroed after the rewrite, and a tile's two segments of two bands summed
into one entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_ocr_tpu.ops import pallas_unit as PU
from tensorflow_ocr_tpu_torch.ops import conv as CV
from tensorflow_ocr_tpu_torch.ops import ghost as G
from test_torch_conv import tma_box

torch.set_num_threads(1)
CL = torch.channels_last
TOL = dict(rtol=1e-5, atol=1e-4)
FAULTS = ("q_band", "ky_swapped", "unread", "pad", "one_entry")
SEG = G.SEAM_SEG


def nhwc(t):
    return t.permute(0, 2, 3, 1)


def emulate_seam(g, z, td, x, tx, w, gh, sms, fault=None):
    """tseam and reduce_parts on the CPU, in the layouts of
    :func:`G.seam_bwd`. Returns (edge (N, nb, 2, W, C), sums (N, nb, 2, C),
    plan). ``fault`` plants one of FAULTS."""
    n, c, h, wd = x.shape
    nb, cb = h // gh, c // 64
    p = G.seam_plan(n, h, wd, c, gh, sms)
    g4, z4, x4 = nhwc(g), nhwc(z), nhwc(x)
    tdf, txf = td.reshape(-1, 3, c), tx.reshape(-1, 2, c)
    # the kernel unflipped as (out row, tap, K): the flipped kernel's row
    # ky, column kx is its row 2 - ky, column 2 - kx
    wt = w.permute(1, 2, 3, 0).reshape(c, 9, c).float()
    edge = torch.full((n, nb, 2, wd, c), float("nan"))
    written = torch.zeros(n, nb, 2, wd, c, dtype=torch.int32)
    part = torch.full((n * nb, 2 * p.segs, 2, c), float("nan"))
    px = torch.arange(SEG)
    hx = torch.arange(SEG + 2)
    for cta in range(p.grid):
        side, col, tiles = p.tiles_of(cta)
        kyw = 0 if side else 2  # the flipped kernel's row 2 or 0
        if fault == "ky_swapped":
            kyw = 2 - kyw
        for t in tiles:
            sums_of_tile = []
            for wg in (0, 1):
                s = 2 * t + wg if p.nseg == 2 else t
                if s >= p.count:
                    continue  # past the last image: zero boxes, no store
                row, seg = divmod(s, p.segs)
                img, b = divmod(row, nb)
                x0 = seg * SEG
                q = b * gh + (gh - 1 if side else 0)
                qa, rb = q + (1 if side else -1), b + (1 if side else -1)
                reads = 0 <= rb < nb
                n0 = col * p.ct + (64 * wg if p.nseg == 1 else 0)
                cols = slice(n0, n0 + 64)
                acc = torch.zeros(SEG, 64)
                for k in range(cb):
                    c0 = 64 * k
                    zb = tma_box(z4, img, qa, x0 - 1, c0, 1, SEG + 2)
                    gb = tma_box(g4, img, qa, x0 - 1, c0, 1, SEG + 2)
                    dz = torch.zeros(SEG + 2, 64)
                    if reads:
                        t3 = tdf[img * nb + rb, :, c0:c0 + 64]
                        v = (gb.float() * t3[0] + t3[1]
                             + 2.0 * zb.float() * t3[2]).to(z.dtype).float()
                        sx = x0 - 1 + hx
                        live = (sx >= 0) & (sx < wd)
                        if fault == "pad":  # dz = c1 left at the w pad
                            live = torch.ones_like(live)
                        dz = torch.where(live[:, None], v, dz)
                    for kx in range(3):
                        acc += dz[kx:kx + SEG] @ wt[cols, 3 * kyw + 2 - kx,
                                                    c0:c0 + 64].T
                xq = tma_box(x4, img, q, x0, n0, 1, SEG).float()
                gm = torch.zeros(SEG, 64)
                a1 = torch.zeros(64)
                if reads:
                    band = img * nb + (b if fault == "q_band" else rb)
                    a1, b1 = txf[band, 0, cols], txf[band, 1, cols]
                    inside = (x0 + px < wd)[:, None]
                    gm = torch.where(inside & (xq * a1 + b1 > 0), acc, gm)
                live_px = slice(x0, min(x0 + SEG, wd))
                nlive = live_px.stop - live_px.start
                if reads or fault != "unread":
                    edge[img, b, side, live_px, cols] = (gm * a1)[:nlive]
                    written[img, b, side, live_px, cols] += 1
                entry = ((img * nb + rb % nb), (0 if side else p.segs) + seg)
                sums_of_tile.append(
                    (entry, torch.stack([(gm * xq).sum(0), gm.sum(0)]), cols))
            if fault == "one_entry" and len(sums_of_tile) == 2:
                # both warpgroups' sums into the tile's first entry
                (e0, v0, cols), (e1, v1, _) = sums_of_tile
                sums_of_tile = [(e0, v0 + v1, cols), (e1, torch.zeros_like(v1),
                                                      cols)]
            for entry, v, cols in sums_of_tile:
                part[entry[0], entry[1], :, cols] = v
    if fault is None:
        assert bool((written == 1).all())
        assert not bool(part.isnan().any())
    sums = torch.zeros(n * nb, 2, c)
    for e in range(2 * p.segs):  # reduce_parts: each band's entries in order
        sums = sums + part[:, e]
    return edge, sums.reshape(n, nb, 2, c), p


def seam_case(c, nhwgh, seed, dtype=torch.float32):
    """The seam's inputs: g (f32), z2, td2, z1, t1 (each band its own
    table, b1 around 0 so the mask varies), the 3x3 weight."""
    gen = torch.Generator().manual_seed(seed)
    n, h, w, gh = nhwgh
    nb = h // gh

    def act(scale=1.0):
        return (torch.randn(n, c, h, w, generator=gen) * scale).to(
            dtype).contiguous(memory_format=CL)

    g = act().float().contiguous(memory_format=CL)
    z, x = act(), act()
    td = torch.stack([torch.rand(n, nb, c, generator=gen) + 0.5,
                      torch.randn(n, nb, c, generator=gen) * 0.3,
                      torch.randn(n, nb, c, generator=gen) * 0.1], 2)
    tx = torch.stack([torch.rand(n, nb, c, generator=gen) + 0.5,
                      torch.randn(n, nb, c, generator=gen) * 0.5], 2)
    wk = (torch.randn(c, c, 3, 3, generator=gen) / (9 * c) ** 0.5).to(dtype)
    return g, z, td, x, tx, wk


def caught(got, want):
    try:
        torch.testing.assert_close(got, want, **TOL)
    except AssertionError:
        return True
    return False


@pytest.mark.parametrize("c,nhwgh,sms,dtype", [
    (64, (2, 12, 64, 4), 6, torch.float32),    # a tile: two bands' rows
    (64, (2, 24, 128, 8), 5, torch.float32),   # a tile: one seam row
    (128, (2, 12, 64, 4), 4, torch.float32),   # one segment, 128 columns
    (64, (2, 12, 100, 4), 3, torch.float32),   # ragged W: a 36-pixel segment
    (192, (2, 8, 40, 2), 9, torch.float32),    # three 64-column tiles
    (64, (2, 12, 64, 4), 132, torch.bfloat16),  # bf16 dz, one tile a CTA
    (128, (1, 9, 16, 3), 2, torch.float32),    # an odd count, W < 64
])
def test_seam_emulation_equals_the_plain_version(c, nhwgh, sms, dtype):
    n, h, w, gh = nhwgh
    args = seam_case(c, nhwgh, c + w + gh, dtype)
    want_edge, want_sums = G.seam_bwd_reference(*args, gh)
    edge, sums, p = emulate_seam(*args, gh, sms)
    torch.testing.assert_close(edge, want_edge, **TOL)
    torch.testing.assert_close(sums, want_sums, **TOL)
    assert h // gh >= 3 and p.grid % p.groups == 0
    # the unread slots are written, and 0
    assert bool((edge[:, 0, 0] == 0).all() and (edge[:, -1, 1] == 0).all())


@pytest.mark.parametrize("fault", FAULTS)
def test_seam_emulation_catches_planted_faults(fault):
    """N = 2, 3 bands of 4 rows, W = 64, c = 64: a tile holds two seam rows
    of two bands, so each fault moves edge or the sums."""
    gh = 4
    args = seam_case(64, (2, 12, 64, gh), 17)
    want_edge, want_sums = G.seam_bwd_reference(*args, gh)
    edge, sums, p = emulate_seam(*args, gh, 6, fault=fault)
    assert p.nseg == 2 and p.segs == 1
    if fault == "one_entry":
        torch.testing.assert_close(edge, want_edge, **TOL)
        assert caught(sums, want_sums)
    elif fault == "unread":
        assert bool(edge.isnan().any()) and caught(edge, want_edge)
    else:
        assert caught(edge, want_edge) and caught(sums, want_sums)


def test_one_entry_fault_is_harmless_where_a_tile_is_one_row():
    """At W = 128 a two-segment tile is the two halves of one seam row, in
    one band: one entry for both is the same sum. The fault needs a tile
    over two bands (previous test) to show."""
    gh = 4
    args = seam_case(64, (2, 12, 128, gh), 18)
    _, want_sums = G.seam_bwd_reference(*args, gh)
    _, sums, p = emulate_seam(*args, gh, 6, fault="one_entry")
    assert p.segs == 2
    torch.testing.assert_close(sums, want_sums, **TOL)


# --------------------------------------------------------------------------
# through a whole unit against the interpreted JAX kernels
# --------------------------------------------------------------------------

N, H, W, GH, EPS = 2, 24, 16, 8, 1e-5


def unit_inputs(proj, seed):
    """JAX-layout numpy inputs of one unit at 3 bands of GH rows (db 64:
    a seam tile holds two bands' rows), and the output cotangent."""
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
    return args, rng.randn(N, H, W, co).astype(f)


def port_args(args):
    """JAX layouts -> the port's: NCHW channels-last, OIHW weights; each a
    leaf that takes a gradient."""
    o, w1, gb1, w2, gb2, w3, gb3, *sc = args
    db = w1.shape[1]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    out = [t(o).permute(0, 3, 1, 2).contiguous(memory_format=CL),
           t(w1.T[:, :, None, None]), t(gb1),
           t(w2.reshape(3, 3, db, db).transpose(3, 2, 0, 1)), t(gb2),
           t(w3.T[:, :, None, None]), t(gb3)]
    if sc:
        out += [t(sc[0].T[:, :, None, None]), t(sc[1])]
    return [a.requires_grad_() for a in out]


@pytest.mark.parametrize("proj", [False, True], ids=["identity", "proj"])
def test_ghost_unit_on_the_emulated_seam_matches_interpreted_jax(
        monkeypatch, proj):
    """One unit's exact backward (ops/ghost.py _unit_backward) with the
    seam pass on the emulation, against jax.vjp of pallas_unit's
    ghost_unit_id / ghost_unit_proj run in interpret mode, at 3 bands an
    image: every gradient within 1e-4 of its largest value."""
    args, wy = unit_inputs(proj, 6 + proj)
    monkeypatch.setattr(
        G, "seam_bwd",
        lambda *a: emulate_seam(*a, 3)[:2])
    targs = port_args(args)
    fn = G.ghost_unit_proj if proj else G.ghost_unit_id
    outs = fn(*targs, GH, EPS)
    grads = torch.autograd.grad(
        (outs[0] * torch.from_numpy(wy).permute(0, 3, 1, 2)).sum(), targs)
    PU.set_interpret(True)
    try:
        jfn = PU.ghost_unit_proj if proj else PU.ghost_unit_id
        jouts, vjp = jax.vjp(lambda *a: jfn(*a, GH, EPS),
                             *map(jnp.asarray, args))
        want = vjp((jnp.asarray(wy),)
                   + tuple(jnp.zeros_like(s) for s in jouts[1:]))
    finally:
        PU.set_interpret(False)
    db = args[1].shape[1]
    got = [grads[0].permute(0, 2, 3, 1), grads[1][:, :, 0, 0].T, grads[2],
           grads[3].permute(2, 3, 1, 0).reshape(9 * db, db), grads[4],
           grads[5][:, :, 0, 0].T, grads[6]]
    if proj:
        got += [grads[7][:, :, 0, 0].T, grads[8]]
    for i, (gv, wv) in enumerate(zip(got, want)):
        wv = np.asarray(wv)
        err = np.abs(gv.detach().numpy() - wv).max() / np.abs(wv).max()
        assert err < 1e-4, (i, err)


# --------------------------------------------------------------------------
# the plan at the step's ghost units
# --------------------------------------------------------------------------

# (N, H, W, db, gh) of the seam of each ghost unit of the 512^2 batch-32
# step (chip_smoke.py GHOST_SHAPES)
SEAM_SHAPES = ((32, 128, 128, 64, 8), (32, 64, 64, 128, 8))


@pytest.mark.parametrize("n,h,w,c,gh", SEAM_SHAPES + (
    (32, 32, 32, 256, 8), (32, 16, 16, 512, 8), (2, 24, 100, 192, 8)))
def test_seam_plan_fits_the_card(n, h, w, c, gh):
    """The ring, the weight (resident at the step's shapes), the epilogue
    slot, the warps' sums and the barriers within 232,448 bytes of shared
    memory; every TMA stride a multiple of 16 bytes (the NHWC bf16 and
    f32 tensors, the weight, edge as (c, w, 2 nb, n)); every segment of
    each (side, column tile) group in exactly one tile, every CTA at
    least one."""
    p = G.seam_plan(n, h, w, c, gh, 132)
    assert p.smem == G.seam_smem(p.nseg, p.ct, c // 64, p.resident,
                                 p.stages) <= CV.MAX_SMEM
    assert 2 <= p.stages <= G.SEAM_MAX_STAGES
    assert p.resident == (c <= 192)
    nb = h // gh
    strides = [c * 2, w * c * 2, h * w * c * 2,       # z, z1 (bf16)
               c * 4, w * c * 4, h * w * c * 4,       # g (f32)
               c * 2, 9 * c * 2,                      # the weight
               w * c * 4, 2 * nb * w * c * 4]         # edge
    assert all(s % 16 == 0 for s in strides)
    assert p.grid % p.groups == 0 and p.groups <= p.grid <= 132
    seen = {}
    for cta in range(p.grid):
        side, col, tiles = p.tiles_of(cta)
        assert len(tiles) >= 1
        for t in tiles:
            seen[(side, col, t)] = seen.get((side, col, t), 0) + 1
    assert seen == {(s, col, t): 1 for s in (0, 1)
                    for col in range(c // p.ct) for t in range(p.tiles)}
    assert p.tiles * p.nseg >= p.count == n * nb * p.segs


def test_the_seam_signature_takes_the_plan():
    """ghost_seam_bwd takes nine pointers (g, z, td, x, tx, wflip, edge,
    sums, the entries), the geometry (n, h, w, c, gh), the plan's four
    fields (ct, resident, stages, grid) and the stream."""
    from test_torch_conv_bwd import c_entry_points
    import ctypes
    want = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    assert c_entry_points("ghost_unit")["ghost_seam_bwd"] == want \
        == G.SIGNATURES["ghost_seam_bwd"]
