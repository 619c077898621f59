"""csrc/conv_fwd.cu's tiling emulated on the CPU, its plan, and the
forward dispatch between it and csrc/conv.cu's igemm_fwd.

The emulation follows ops/conv.py tma_fwd_plan exactly: each CTA of the
persistent grid walks its tiles in the plan's order; a tile is a box of
wb x hb pixels of one image by bn columns; each K step loads the A box
of 64 channels at the tile's origin shifted by the tap and the weight
box of 64 K by bn rows, both zero outside their tensors (TMA's fill);
where Co is a multiple of 8 the epilogue stores each warpgroup's 64 rows
as TMA boxes of 64 (16) columns by a 64-pixel box, and TMA skips what
lies outside the tensor; else it maps accumulator row r to pixel (x0 +
r % wb, y0 + r // wb) and skips pixels outside the image and columns
past Co. Float32 on the CPU against the plain versions: sums in another
order, within 1e-5 relative and 1e-4 absolute.
"""

import pytest
import torch

from tensorflow_ocr_tpu_torch.ops import conv as CV
from test_torch_conv import resnet50_convs, tma_box

torch.set_num_threads(1)
CL = torch.channels_last


def weight_box(wt3, tap, c0, n0, bn):
    """The TMA box of the (Co, KS*KS, Ci) weight: rows n0..n0+bn of tap
    `tap`, channels c0..c0+63, zero past Co and Ci."""
    co, _, ci = wt3.shape
    n = torch.arange(n0, n0 + bn)[:, None]
    c = torch.arange(c0, c0 + 64)[None, :]
    live = (n < co) & (c < ci)
    vals = wt3[n.clamp(max=co - 1), tap, c.clamp(max=ci - 1)]
    return torch.where(live, vals, torch.zeros_like(vals))


def emulate_tma_fwd(x4, wt, ks, sms):
    """conv_fwd_tma on the CPU: x4 (N, H, W, Ci) (a 1x1's rows as (1, 1,
    M, Ci)), wt (Co, KS*KS*Ci) -> (N*H*W, Co) and the plan. Each output
    element is written exactly once."""
    n, h, w, ci = x4.shape
    co = wt.shape[0]
    p = CV.tma_fwd_plan(n, h, w, ci, co, ks, sms)
    wt3 = wt.reshape(co, ks * ks, ci)
    tiles_w, tiles_h, cb = -(-w // p.wb), -(-h // p.hb), -(-ci // 64)
    assert p.row_tiles == n * tiles_w * tiles_h
    y = torch.zeros(n * h * w, co)
    written = torch.zeros(n * h * w, co, dtype=torch.int32)
    half = ks // 2
    for cta in range(p.grid):
        for t in p.tiles_of(cta):
            col, r = t % p.col_tiles, t // p.col_tiles
            if p.resident:  # the weight of the CTA's first column serves all
                assert col == cta % p.col_tiles
            x0, r = r % tiles_w * p.wb, r // tiles_w
            y0, img = r % tiles_h * p.hb, r // tiles_h
            acc = torch.zeros(CV.TM, p.bn)
            for k in range(ks * ks * cb):
                tap, c0 = divmod(k, cb)
                a = tma_box(x4, img, y0 + tap // ks - half,
                            x0 + tap % ks - half, c0 * 64, p.hb, p.wb)
                b = weight_box(wt3, tap, c0 * 64, col * p.bn, p.bn)
                acc += a @ b.T
            if co % 8 == 0:  # TMA stores of each warpgroup's staged rows
                sw = min(p.wb, 64)
                cbox, rows = min(p.bn, 64), torch.arange(64)
                for q in (0, 1):
                    sx = x0 + 64 * q if p.wb == CV.TM else x0
                    sy = y0 if p.wb == CV.TM else y0 + q * p.hb // 2
                    px, py = sx + rows % sw, sy + rows // sw
                    live = (px < w) & (py < h)
                    m = (img * h + py[live]) * w + px[live]
                    for c0 in range(0, p.bn, cbox):
                        c1 = min(col * p.bn + c0 + cbox, co)
                        if col * p.bn + c0 >= co:
                            continue
                        cols = slice(col * p.bn + c0, c1)
                        part = acc[64 * q:64 * q + 64][live]
                        y[m, cols] = part[:, c0:c1 - col * p.bn]
                        written[m, cols] += 1
            else:  # from registers: row r is pixel (x0 + r % wb, ...)
                rows = torch.arange(CV.TM)
                px, py = x0 + rows % p.wb, y0 + rows // p.wb
                live = (px < w) & (py < h)
                m = (img * h + py[live]) * w + px[live]
                nc = min(p.bn, co - col * p.bn)
                cols = slice(col * p.bn, col * p.bn + nc)
                y[m, cols] = acc[live][:, :nc]
                written[m, cols] += 1
    assert bool((written == 1).all())
    return y, p


@pytest.mark.parametrize("ks,ci,co,nhw,sms,resident", [
    (3, 24, 40, (1, 7, 13), 132, False),  # ragged W and H, N = 1, Ci = 24
    (3, 8, 2, (2, 5, 9), 3, False),      # Ci = 8, Co = 2: bn 16, 3 CTAs
    (3, 8, 12, (1, 20, 70), 3, False),   # Co = 12: stored from registers
    (3, 64, 16, (1, 9, 130), 4, False),  # a row wider than the box (128)
    (3, 192, 256, (1, 6, 10), 132, False),  # 3 channel boxes a tap
    (3, 24, 320, (1, 5, 6), 2, False),   # Co past bn: two column tiles
    (1, 8, 2, (1, 1, 300), 2, True),     # the head's Co = 2, M % 128
    (1, 64, 256, (1, 1, 520), 3, True),  # block1's shape, resident W
    (1, 192, 40, (1, 1, 200), 132, True),
    (1, 24, 320, (1, 1, 260), 4, True),  # resident, 2 columns, grid 4
    (1, 16, 256, (1, 1, 140), 5, True),  # a dX with K = 16
    (1, 640, 200, (1, 1, 150), 3, False),  # streamed W: 10 K steps of 128
])
def test_tma_fwd_tiling_emulation_equals_the_plain_forward(
        ks, ci, co, nhw, sms, resident):
    gen = torch.Generator().manual_seed(ks * 1000 + ci + co)
    n, h, w = nhw
    x = torch.randn(n, ci, h, w, generator=gen).contiguous(memory_format=CL)
    wk = torch.randn(co, ci, ks, ks, generator=gen) / (ks * ks * ci) ** 0.5
    wt = wk.permute(0, 2, 3, 1).reshape(co, ks * ks * ci)
    assert CV.tma_fwd_takes(ci)
    if ks == 1:
        x2 = CV.rows(x)
        want = CV.matmul_rows_reference(x2, wt.T)
        got, p = emulate_tma_fwd(x2.reshape(1, 1, -1, ci), wt, 1, sms)
    else:
        want = CV.rows(CV.conv3_reference(x, wk))
        got, p = emulate_tma_fwd(x.permute(0, 2, 3, 1), wt, 3, sms)
    assert p.resident == resident
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


# the forward shapes (N, H, W, Ci, Co, ks) of a 512^2 batch-32 step and
# of detect at 8 x 1280x768 (forward and dX), and tail shapes
PLAN_SHAPES = [
    (1, 1, 524288, 64, 256, 1), (1, 1, 524288, 256, 64, 1),
    (1, 1, 8192, 1024, 2048, 1), (1, 1, 8192, 2048, 512, 1),
    (1, 1, 8192, 2048, 2, 1), (1, 1, 8192, 16, 2048, 1),
    (1, 1, 491520, 64, 16, 1), (32, 128, 128, 64, 64, 3),
    (32, 16, 16, 512, 512, 3), (8, 192, 320, 64, 64, 3),
    (8, 24, 40, 512, 512, 3), (1, 7, 13, 24, 40, 3), (1, 9, 130, 64, 16, 3),
    (1, 1, 1, 8, 8, 1), (3, 1, 5, 8, 300, 3)]


@pytest.mark.parametrize("n,h,w,ci,co,ks", PLAN_SHAPES)
def test_tma_fwd_plan_invariants(n, h, w, ci, co, ks):
    # boxes of <= 256 a dimension and TM pixels, the box that covers the
    # fewest pixels outside the image; the ring, the resident
    # weight, the output's staging and the barriers within the shared
    # memory; every tile
    # visited once, by one CTA; a resident weight only where the CTA's
    # tiles share one column
    p = CV.tma_fwd_plan(n, h, w, ci, co, ks, 132)
    assert max(p.wb, p.hb) <= 256 and p.wb * p.hb == CV.TM
    def covered(wb):  # pixels the tiles of a wb x (TM / wb) box cover
        hb = CV.TM // wb
        return -(-w // wb) * wb * -(-h // hb) * hb
    assert covered(p.wb) == min(covered(1 << i) for i in range(8))
    assert p.bn in CV.FWD_BN
    i = CV.FWD_BN.index(p.bn)  # the narrowest that covers Co
    assert p.bn >= min(co, CV.FWD_BN[-1])
    assert i == 0 or CV.FWD_BN[i - 1] < co
    ksteps = ks * ks * -(-ci // 64)
    box, bbox = CV.TM * 128, p.bn * 128
    wbytes = ksteps * bbox if p.resident else 0
    stage = box + (0 if p.resident else bbox)
    staging = CV.TM * p.bn * 2  # the output tile, for the TMA store
    smem = (p.stages * stage + wbytes + staging + 8 * (2 * p.stages + 1)
            + 1024)
    assert 2 <= p.stages <= CV.MAX_FWD_STAGES and smem <= 232448
    assert not p.resident or (ks == 1 and p.stages >= CV.MIN_A_SLOTS)
    assert p.row_tiles == n * -(-h // p.hb) * -(-w // p.wb)
    assert p.col_tiles == -(-co // p.bn)
    tiles = p.row_tiles * p.col_tiles
    assert 1 <= p.grid <= min(132, tiles)
    seen = [t for cta in range(p.grid) for t in p.tiles_of(cta)]
    assert sorted(seen) == list(range(tiles))
    if p.resident:
        assert p.grid % p.col_tiles == 0
        assert all(t % p.col_tiles == cta % p.col_tiles
                   for cta in range(p.grid) for t in p.tiles_of(cta))


def test_forward_dispatch_over_the_train_step():
    """Which forward products of a 512^2 batch-32 step take tma_fwd: every
    1x1 and 3x3 forward and every dX whose contracted count (Ci of the
    conv, Co of its dX) is a multiple of 8; the dX of the head's four
    projections to 2 channels (K = 2) takes narrow_fwd."""
    routed = [(x_shape, k, s, co) for x_shape, k, s, same, co
              in resnet50_convs(32, 512, 512)
              if same and CV.supported(x_shape, (k, k), (s, s), (1, 1), co)]
    assert len(routed) == 57
    launches = {"matmul_rows": {"tma": 0, "narrow": 0},
                "conv3": {"tma": 0, "narrow": 0}}
    narrow = set()
    for (n, h, w, ci), k, s, co in routed:
        name = "matmul_rows" if k == 1 else "conv3"
        for kdim in (ci, co):  # the forward contracts Ci, its dX Co
            route = "tma" if CV.tma_fwd_takes(kdim) else "narrow"
            launches[name][route] += 1
            if route == "narrow":
                narrow.add((n, h // s, w // s, kdim, ci, k))
    assert launches == {"matmul_rows": {"tma": 84, "narrow": 4},
                        "conv3": {"tma": 26, "narrow": 0}}
    # the head's dX from 2 channels back to pool5..pool2's
    assert narrow == {(32, 16, 16, 2, 2048, 1), (32, 32, 32, 2, 512, 1),
                      (32, 64, 64, 2, 256, 1), (32, 128, 128, 2, 64, 1)}
    assert not CV.tma_fwd_takes(2) and not CV.tma_fwd_takes(12)
    assert CV.tma_fwd_takes(8) and CV.tma_fwd_takes(16)


def test_tma_fwd_refuses_what_tma_does_not_take():
    """The wrapper raises, with the reason, on a contracted count that is
    not a multiple of 8 and on a base that is not 16-byte aligned, before
    it reaches the card: no fallback to igemm_fwd or the plain version."""
    bf = torch.bfloat16
    x, wt = torch.zeros(64, 2, dtype=bf), torch.zeros(8, 2, dtype=bf)
    with pytest.raises(ValueError, match="multiple of 8"):
        CV.tma_fwd(x, wt, 1, 1, 64, 2, 8, 1)
    buf = torch.zeros(64 * 8 + 1, dtype=bf)
    x = buf[1:].view(64, 8)  # 2 bytes past an aligned base
    with pytest.raises(ValueError, match="16-byte aligned"):
        CV.tma_fwd(x, torch.zeros(8, 8, dtype=bf), 1, 1, 64, 8, 8, 1)
