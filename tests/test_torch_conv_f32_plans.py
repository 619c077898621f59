"""The float32 plans of the route's kernels, and the dtypes the route
takes on the card.

Every float32 plan (ops/conv.py tma_fwd_plan and tma_dw_plan with 4-byte
elements) must fit the 232,448 bytes of shared memory a CTA may take, in
the bytes the kernels themselves count (csrc/conv_fwd.cu conv_fwd_tma_f32,
csrc/conv_dw.cu conv_dw_tma_f32), at every conv that the route takes in
the 512^2 batch-32 train step and in detect at 1280x768, batch 8: each
forward and dX product on conv_fwd.cu and each dW on conv_dw.cu (detect's
convs as a step at that size would take them), and at chip_smoke.py's dW
tail shapes. The dW's split dY tiles (csrc/conv_bwd.cuh split_offset) are
held to what the K-major descriptors of its wgmma read.
"""

import pytest
import torch

from tensorflow_ocr_tpu_torch.ops import conv as CV
from test_torch_conv import resnet50_convs

SMS = 132
ABOX = 128 * 128


def fwd_smem(p, ci, ks):
    """conv_fwd_tma_f32's dynamic shared memory: the ring (the A box, and
    the weight's hi and lo boxes unless resident), the resident weight,
    the f32 staging of both warpgroups, the barriers, the alignment."""
    bbox, ksteps = p.bn * 128, ks * ks * -(-ci // 32)
    return (p.stages * (ABOX + (0 if p.resident else 2 * bbox))
            + (ksteps * 2 * bbox if p.resident else 0) + 2 * 64 * p.bn * 4
            + 8 * (2 * p.stages + 1) + 1024)


def dw_smem(p):
    """conv_dw_tma_f32's: the ring (a stage: two X boxes of 32 f32
    channels a 64-row chunk, bn / 32 dY boxes, which the split's hi tile
    then overlays, and the lo tile of as many bytes), its barriers, the
    alignment; and the parked sums of both warpgroups, which overlay the
    ring."""
    boxes = (2 if p.two else 1) * 2 + p.bn // 32
    stage = (boxes + p.bn // 32) * 64 * 128
    return p.stages * stage + 16 * p.stages + 1024, p.stages * stage


# chip_smoke.py's DW_TAIL_SHAPES (N, H, W, Ci, Co, k)
DW_TAIL_SHAPES = ((1, 7, 13, 24, 40, 3), (2, 5, 9, 8, 16, 1),
                  (2, 9, 130, 64, 64, 3), (2, 16, 16, 2048, 2, 1))


def check_dw_plan(geo, ci, co, k):
    p = CV.tma_dw_plan(*geo, ci, co, k, SMS, 0, 4)
    smem, ring = dw_smem(p)
    assert p.stages >= 2 and smem <= CV.MAX_SMEM, (geo, ci, co, k, p)
    assert 2 * 64 * (p.bn + 8) * 4 <= ring and p.bn in (64, 128)
    assert p.bn == (CV.DW32_BN if co >= CV.DW32_BN else 64)
    assert p.splits % p.cluster == 0 and p.wb * p.hb == CV.KP


def route_convs(n, h, w):
    """(N, H, W, Ci, Co, k) of every conv the route takes (the strided 1x1s
    at their output size)."""
    out = []
    for (nn, hh, ww, ci), k, s, same, co in resnet50_convs(n, h, w):
        if same and CV.supported((nn, hh, ww, ci), (k, k), (s, s), (1, 1),
                                 co):
            out.append((nn, hh // s, ww // s, ci, co, k))
    return out


@pytest.mark.parametrize("nhw,train", [((32, 512, 512), True),
                                       ((8, 768, 1280), False)])
def test_float32_plans_fit_shared_memory(nhw, train):
    convs = route_convs(*nhw)
    assert len(convs) == 57
    fwd = dw = 0
    for n, h, w, ci, co, k in convs:
        geo = (1, 1, n * h * w) if k == 1 else (n, h, w)
        # the forward, and in a train step its dX (ci and co swapped)
        for a, b in ((ci, co), (co, ci)) if train else ((ci, co),):
            if not CV.tma_fwd_takes(a):
                continue
            p = CV.tma_fwd_plan(*geo, a, b, k, SMS, 4)
            assert p.stages >= 2 and fwd_smem(p, a, k) <= CV.MAX_SMEM, (
                n, h, w, a, b, k, p)
            assert p.bn in CV.FWD_BN and p.grid <= SMS
            assert not p.resident or p.grid % p.col_tiles == 0
            fwd += 1
        if CV.tma_takes(ci, co):
            check_dw_plan(geo, ci, co, k)
            dw += 1
    # a step: 57 forwards and 53 dX on conv_fwd.cu, 53 dW on conv_dw.cu
    # (the head's projections to 2 channels on conv.cu); detect: 57
    # forwards, and the 53 dW plans a step at its size would take
    assert (fwd, dw) == ((110, 53) if train else (57, 53))
    for n, h, w, ci, co, k in DW_TAIL_SHAPES:
        if CV.tma_takes(ci, co):
            check_dw_plan((1, 1, n * h * w) if k == 1 else (n, h, w), ci,
                          co, k)


def test_float32_plans_halve_what_a_stage_holds():
    """A float32 K step carries 32 channels where a bfloat16 one carries
    64, each weight box twice (hi and lo); a float32 dW stage holds twice
    the bytes of a bfloat16 one and the split dY's lo tile, and no
    256-column tile."""
    bf = CV.tma_fwd_plan(1, 1, 32 * 64 * 64, 256, 512, 1, SMS)
    f32 = CV.tma_fwd_plan(1, 1, 32 * 64 * 64, 256, 512, 1, SMS, 4)
    assert (bf.bn, f32.bn) == (128, 128) and f32.stages <= bf.stages
    dbf = CV.tma_dw_plan(32, 16, 16, 512, 512, 3, SMS)
    d32 = CV.tma_dw_plan(32, 16, 16, 512, 512, 3, SMS, 0, 4)
    assert (dbf.bn, d32.bn) == (256, 128)
    assert (dw_smem(d32)[1] // d32.stages
            == 2 * (2 + 128 // 64) * 64 * 128 + 128 * 64 * 4)
    chunk, splits = CV.narrow_dw32_plan(32 * 128 * 128, 64, 2, SMS)
    assert chunk * (splits - 1) < 32 * 128 * 128 <= chunk * splits


@pytest.mark.parametrize("bn", [64, 128])
def test_split_tile_map(bn):
    """The split dY tile of the route's float32 dW (ops/conv.py
    split_offset = csrc/conv_bwd.cuh's): (output channel n, pixel p) onto
    the tile's bn x 64 floats is a bijection, each thread's 4 pixels one
    16-byte chunk; the K-major descriptor of the k8 step at pixel 8s
    (start split_offset(bn, 0, 8s), 128-byte rows, 8-row groups 1024 bytes
    apart, the 128-byte swizzle XORing address bits 4-6 with bits 7-9)
    reads row n, element k at (n, 8s + k); and the transpose's blocks (4
    channels x 4 pixels a thread, 256 threads) cover the tile once, the 8
    threads of a phase on 8 distinct 16-byte chunks of a 128-byte row
    both where they read the raw dY box and where they write the tile."""
    at = {CV.split_offset(bn, n, p): (n, p)
          for n in range(bn) for p in range(64)}
    assert sorted(at) == list(range(0, bn * 64 * 4, 4))
    for n in range(bn):
        for p in range(0, 64, 4):
            o = CV.split_offset(bn, n, p)
            assert o % 16 == 0 and [at[o + 4 * i] for i in range(4)] == [
                (n, p + i) for i in range(4)]
    for s in range(8):
        start = CV.split_offset(bn, 0, 8 * s)
        for n in range(bn):
            for k in range(8):
                lin = start + (n // 8) * 1024 + (n % 8) * 128 + 4 * k
                assert at[lin ^ (((lin >> 7) & 7) << 4)] == (n, 8 * s + k)
    blocks = set()
    for x in range(bn // 64):
        for phase in range(0, 256, 8):
            read, write = set(), set()
            for ct in range(phase, phase + 8):
                blk = ct + 256 * x
                t = blk & 7
                cq = 8 * (blk >> 7) + (t ^ ((blk >> 3) & 7))
                pq = 8 * ((blk >> 6) & 1) + t
                blocks.add((cq, pq))
                for r in range(4):  # row 4 pq + r of box cq // 8
                    p = 4 * pq + r
                    read.add((r, ((cq % 8) ^ p) & 7))
                    write.add((r, (CV.split_offset(bn, 4 * cq + r, 4 * pq)
                                   % 128) // 16))
            assert len(read) == len(write) == 32, (x, phase)
    assert blocks == {(c, p) for c in range(bn // 4) for p in range(16)}

@pytest.mark.parametrize("dtype,raises", [
    (torch.float32, None), (torch.bfloat16, None),
    (torch.float16, TypeError), (torch.float64, TypeError)])
@pytest.mark.parametrize("k", [1, 3])
def test_conv2d_takes_float32_off_the_cpu(dtype, raises, k):
    """conv2d on meta tensors: bfloat16 and float32 pass the dtype check
    and reach the device check (the kernels need CUDA); float16 and
    float64 raise TypeError first."""
    x = torch.zeros(1, 8, 16, 16, device="meta", dtype=dtype)
    w = torch.zeros(8, 8, k, k, device="meta", dtype=dtype)
    with pytest.raises(raises or ValueError,
                       match="bfloat16 or float32" if raises else "CUDA"):
        CV.conv2d(x, w)


def test_kernels_refuse_mixed_dtypes():
    """The wrappers take operands of one type: a float32 activation with a
    bfloat16 weight raises before any launch."""
    x = torch.zeros(16, 8, device="meta")
    w = torch.zeros(8, 4, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        CV.matmul_rows(x, w)
    cuda = torch.device("cuda", 0)

    class Fake:
        def __init__(self, dtype):
            self.device, self.dtype = cuda, dtype

    with pytest.raises(TypeError, match="of one type"):
        CV._check(Fake(torch.float32), x2=Fake(torch.float32),
                  w2=Fake(torch.bfloat16))
    CV._check(Fake(torch.float32), x2=Fake(torch.float32),
              w2=Fake(torch.float32))
