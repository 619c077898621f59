"""The float32 plans of the ghost unit's kernels, and the dtypes the ghost
wrappers take on the card.

Every float32 plan (ops/conv.py tma_staged_fwd_plan and tma_bwd_dx_plan
with the band height and 4-byte elements, tma_dw_plan with g's float32
aux boxes; ops/ghost.py seam_plan with 4-byte elements) must fit the
232,448 bytes of shared memory a CTA may take, in the bytes the kernels
themselves count (csrc/conv_bwd.cuh run_dx_f32 and run_dw_f32,
csrc/ghost_unit.cu run_seam32), with at least 2 ring stages and each
tile's box height a divisor of the band height, at every conv of the 4
ghost unit shapes of the 512^2 batch-32 step (forward, dX and dW), and
the seam at the 4 unit shapes and smaller ones (c = 64, 128 and 192).
"""

import pytest
import torch

from tensorflow_ocr_tpu_torch.ops import conv as CV
from tensorflow_ocr_tpu_torch.ops import ghost as G
from test_torch_conv_bwd import c_entry_points
from test_torch_fused_f32_plans import Fake, check_dx32, dw32_smem

SMS = 132
# (N, H, W, Ci, db, Co, gh) of the ghost units of the 512^2 batch-32 step
# (chip_smoke.py GHOST_SHAPES)
GHOST_SHAPES = ((32, 128, 128, 64, 64, 256, 8),
                (32, 128, 128, 256, 64, 256, 8),
                (32, 64, 64, 256, 128, 512, 8),
                (32, 64, 64, 512, 128, 512, 8))


def unit_convs(ci, db, co):
    """(Ci, Co, k) of a unit's convs: conv1, the 3x3, conv3 and, where the
    shortcut projects, its 1x1."""
    return [(ci, db, 1), (db, db, 3), (db, co, 1)] + (
        [(ci, co, 1)] if ci != co else [])


@pytest.mark.parametrize("shape", GHOST_SHAPES)
def test_float32_ghost_plans_fit_shared_memory(shape):
    """The forward, dX and dW plans of each of the unit's convs in
    float32: within 232,448 bytes as the kernels count them, 2 or more ring
    stages, bn 128 where it divides the columns outside halo mode, a
    resident weight only in a 1x1, an epilogue slot, the box height a
    divisor of gh (a tile lies in one band), the 3x3 in halo mode at 64
    columns and outside it at 128 (a 32-pixel box, BN 128); the dW
    plan with gh is the one without (gh widens no box at these widths),
    its box height a divisor of gh too."""
    n, h, w, ci, db, co, gh = shape
    for a, b, k in unit_convs(ci, db, co):
        fwd = CV.tma_staged_fwd_plan(n, h, w, a, b, k, SMS, gh, esize=4)
        dx = CV.tma_bwd_dx_plan(n, h, w, a, b, k, SMS, 4, True, gh,
                                esize=4)
        for p, aux, cols, kdim in ((fwd, 0, b, k * k * a),
                                   (dx, 4, a, k * k * b)):
            check_dx32(p, aux, kdim, cols, k)
            assert gh % p.hb == 0 and p.halo == (k == 3 and cols % 128 != 0)
        dw = CV.tma_dw_plan(n, h, w, a, b, k, SMS, aux=4, esize=4, gh=gh)
        assert dw == CV.tma_dw_plan(n, h, w, a, b, k, SMS, aux=4, esize=4)
        smem, ring = dw32_smem(dw)
        assert dw.stages >= 2 and smem <= CV.MAX_SMEM, (a, b, k, dw)
        assert gh % dw.hb == 0  # tdw_f32_tr keys a tile by one band
        # the parked accumulators overlay the ring
        assert 2 * 64 * (dw.bn + 8) * 4 <= ring
        assert b % dw.bn == 0 and dw.splits % dw.cluster == 0


@pytest.mark.parametrize("w,gh,wb", [(4, 8, 8), (2, 8, 8), (1, 16, 4),
                                     (4, 2, 32), (5, 8, 8), (64, 8, 64)])
def test_float32_ghost_dw_box_divides_the_band(w, gh, wb):
    """tma_dw_plan's gh: the box is widened until its height divides the
    band's (ghost_conv_bwd_f32 refuses another), which only images at most
    4 pixels wide need; the rest of the plan is the one without gh."""
    p = CV.tma_dw_plan(2, 16, w, 64, 64, 3, SMS, aux=4, esize=4, gh=gh)
    q = CV.tma_dw_plan(2, 16, w, 64, 64, 3, SMS, aux=4, esize=4)
    assert p.wb == wb and p.wb * p.hb == CV.KP and gh % p.hb == 0
    assert (p.bn, p.two, p.stages) == (q.bn, q.two, q.stages)
    assert (p.wb == q.wb) == (w > 4 or gh % q.hb == 0)


def seam32_smem(p, c):
    """run_seam32's dynamic shared memory: the ring (two segments' z and g
    boxes of 32 f32 channels, 9,216 bytes each, and the streamed weight's
    hi and lo boxes of the three taps), the resident weight (3 taps x c /
    32 boxes x hi, lo), the warps' sums and the two warpgroups' (a1, b1)
    of 64 columns, the full and empty barriers and the weight's, the
    alignment; no epilogue slot."""
    wbox = p.ct * 128
    stage = 4 * 9216 + (0 if p.resident else 6 * wbox)
    return (p.stages * stage + p.resident * 6 * (c // 32) * wbox
            + 8 * 2 * 64 * 4 + 2 * 2 * 64 * 4 + 8 * (2 * p.stages + 1)
            + 1024)


# the seams of the 4 unit shapes (N, H, W, db, gh) and the tests' small ones
SEAM32_SHAPES = tuple(sorted({(n, h, w, db, gh)
                              for n, h, w, _, db, _, gh in GHOST_SHAPES})) + (
    (2, 24, 100, 192, 8), (2, 24, 64, 64, 8), (2, 24, 100, 64, 8),
    (2, 24, 64, 128, 8))


@pytest.mark.parametrize("n,h,w,c,gh", SEAM32_SHAPES)
def test_float32_seam_plan_fits_the_card(n, h, w, c, gh):
    """The float32 seam plan: 64-column tiles of two segments at every c,
    within 232,448 bytes as run_seam32 counts them, as many ring slots as
    fit: at c = 64 the weight resident beside three, from c = 128 (where
    its resident row, 6 x c / 32 boxes of 8 KB, does not fit beside two)
    streamed on two; every segment of each (side, column tile) group in
    exactly one tile."""
    p = G.seam_plan(n, h, w, c, gh, SMS, 4)
    assert p.ct == 64 and p.nseg == 2 and p.groups == 2 * (c // 64)
    assert p.smem == seam32_smem(p, c) <= CV.MAX_SMEM
    assert p.resident == (c == 64) and p.stages == (3 if c == 64 else 2)
    assert p.grid % p.groups == 0 and p.groups <= p.grid <= SMS
    seen = {}
    for cta in range(p.grid):
        side, col, tiles = p.tiles_of(cta)
        assert len(tiles) >= 1
        for t in tiles:
            seen[(side, col, t)] = seen.get((side, col, t), 0) + 1
    assert seen == {(s, col, t): 1 for s in (0, 1)
                    for col in range(c // 64) for t in range(p.tiles)}
    # the bfloat16 plan is as it was: 128-column tiles where c allows
    assert G.seam_plan(n, h, w, c, gh, SMS).ct == (128 if c % 128 == 0
                                                   else 64)


def test_the_float32_entry_points_take_their_plans():
    """The float32 entries' ctypes argument types are the C functions'
    own: ghost_conv_fwd_f32 seven pointers (x, tab, wt, the split, y,
    stats, the entries), 15 ints (geometry, gh, the plan with residency
    and overlap); ghost_conv_bwd_f32 14 pointers and 25 ints (the dX's
    residency and overlap among them, the dW's run last);
    ghost_boundary_f32 as the
    bf16 one; ghost_seam_bwd_f32 ten pointers (the split beside the nine)
    and 8 ints (no column tile: 64 at every c)."""
    import ctypes
    entries = c_entry_points("ghost_unit")
    p, i = ctypes.c_void_p, ctypes.c_int
    want = {"ghost_conv_fwd_f32": [p] * 7 + [i] * 15 + [p],
            "ghost_conv_bwd_f32": [p] * 14 + [i] * 25 + [p],
            "ghost_boundary_f32": [p] * 7 + [i] * 5 + [p],
            "ghost_seam_bwd_f32": [p] * 10 + [i] * 8 + [p]}
    for name, sig in want.items():
        assert entries[name] == sig == G.SIGNATURES[name], name


class Tensor(Fake):
    """Fake with numel (ops/ghost.py checks the int32 index range)."""

    def numel(self):
        out = 1
        for d in self.shape:
            out *= d
        return out


def acts(dtype, **others):
    """The activations of a conv backward's check, in ``dtype`` but for
    ``others``."""
    return {k: Tensor(others.get(k, dtype))
            for k in ("x", "z", "g", "addend")}


@pytest.mark.parametrize("dtype,raises", [
    (torch.float32, None), (torch.bfloat16, None),
    (torch.float16, TypeError), (torch.float64, TypeError)])
def test_ghost_wrappers_take_float32_or_bfloat16(dtype, raises):
    """The activations bfloat16 or float32, all of one type, the tables
    float32 whatever the activations' type; float16 and float64 raise."""
    args = acts(dtype)
    table = Tensor(torch.float32, (1, 1, 2, 64))
    if raises:
        with pytest.raises(raises, match="bfloat16 or float32"):
            G._check(args["x"], 4, tx=table, **args)
    else:
        G._check(args["x"], 4, tx=table, **args)
        G._check_weight(args["x"], Tensor(dtype, (64, 64, 1, 1)))


@pytest.mark.parametrize("ref,mixed", [
    (torch.float32, dict(z=torch.bfloat16)),
    (torch.float32, dict(g=torch.bfloat16)),
    (torch.float32, dict(addend=torch.float16)),
    (torch.bfloat16, dict(z=torch.float32)),
    (torch.float32, dict(w=torch.bfloat16)),
    (torch.bfloat16, dict(w=torch.float32))])
def test_ghost_wrappers_refuse_mixed_types(ref, mixed):
    """An activation of another type than x's (but a float32 g or addend
    beside bfloat16 ones), and a weight of another type, raise before any
    launch; so does a table in bfloat16."""
    args = acts(ref, **{k: v for k, v in mixed.items() if k != "w"})
    with pytest.raises(TypeError):
        if "w" in mixed:
            G._check_weight(args["x"], Tensor(mixed["w"], (64, 64, 1, 1)))
        else:
            G._check(args["x"], 4, **args)
    with pytest.raises(TypeError):
        G._check(args["x"], 4, x=args["x"],
                 tx=Tensor(torch.bfloat16, (1, 1, 2, 64)))


def test_bf16_activations_take_a_float32_g():
    """A bfloat16 model's g and addend may be float32 (gm and the
    shortcut's dX come float32), as before."""
    args = acts(torch.bfloat16, g=torch.float32, addend=torch.float32)
    G._check(args["x"], 4, **args)


def test_float32_cuda_tensors_go_to_the_float32_kernels(monkeypatch):
    """conv_fwd, boundary_fwd, boundary_bwd, conv_bwd and seam_bwd send a
    float32 tensor off the CPU to the float32 wrappers, which count their
    own launches (and the bf16 ones none); conv_bwd.by_kernel counts tdw_f32
    and tdx_f32; the float32 wrappers refuse bfloat16; there is no
    fallback to the plain versions."""
    calls = []

    def launch(name, out):
        def fn(*a, **k):
            calls.append(name)
            return out
        return fn

    monkeypatch.setattr(G, "_launch_conv_fwd", launch("fwd", ("y", "s")))
    monkeypatch.setattr(G, "_boundary", launch("boundary", "out"))
    monkeypatch.setattr(G, "_launch_seam", launch("seam", ("e", "s")))
    for ref in ("conv_fwd_reference", "conv_bwd_reference",
                "boundary_fwd_reference", "boundary_bwd_reference",
                "seam_bwd_reference"):
        monkeypatch.setattr(G, ref, lambda *a, **k: pytest.fail("a fallback"))
    fns = (G.conv_fwd, G.boundary_fwd, G.boundary_bwd, G.conv_bwd,
           G.seam_bwd, G.conv_fwd32, G.boundary_fwd32, G.boundary_bwd32,
           G.conv_bwd32, G.seam_bwd32)
    for fn in fns:
        monkeypatch.setattr(fn, "launches", 0)
    monkeypatch.setattr(G.conv_bwd, "by_kernel",
                        {"tdw": 0, "tdx": 0, "tdw_f32": 0, "tdx_f32": 0})

    def launch_bwd(*a):
        # the real counting of _launch_conv_bwd without the launch
        for kernel in G.conv_bwd.by_kernel:
            if kernel.endswith("_f32") == (a[0].dtype == torch.float32):
                G.conv_bwd.by_kernel[kernel] += 1
        calls.append("bwd")
        return "dx", "sums", "dw"

    monkeypatch.setattr(G, "_launch_conv_bwd", launch_bwd)
    x, t = Tensor(torch.float32), Tensor(torch.float32, (1, 1, 2, 64))

    class Dout(Tensor):
        def contiguous(self, memory_format=None):
            return self

    G.conv_fwd(x, t, x, 4)
    G.boundary_fwd(x, t, x, t, 4)
    G.boundary_bwd(Dout(torch.float32), x, t, x, t, 4)
    G.conv_bwd(x, t, x, x, t, x, 4)
    G.seam_bwd(x, x, t, x, t, x, 4)
    assert calls == ["fwd", "boundary", "boundary", "bwd", "seam"]
    assert [fn.launches for fn in fns] == [0] * 5 + [1] * 5
    assert G.conv_bwd.by_kernel == {"tdw": 0, "tdx": 0, "tdw_f32": 1,
                                    "tdx_f32": 1}
    b = Tensor(torch.bfloat16)
    G.conv_fwd(b, t, b, 4)
    assert G.conv_fwd.launches == 1 and G.conv_fwd32.launches == 1
    for fn, args in ((G.conv_fwd32, (b, t, b, 4)),
                     (G.boundary_fwd32, (b, t, b, t, 4)),
                     (G.conv_bwd32, (b, t, b, b, t, b, 4)),
                     (G.seam_bwd32, (b, b, t, b, t, b, 4))):
        with pytest.raises(TypeError, match="float32"):
            fn(*args)
