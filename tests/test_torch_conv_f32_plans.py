"""The float32 plans of the route's kernels, and the dtypes the route
takes on the card.

Every float32 plan (ops/conv.py tma_fwd_plan and tma_dw_plan with 4-byte
elements) must fit the 232,448 bytes of shared memory a CTA may take, in
the bytes the kernels themselves count (csrc/conv_fwd.cu conv_fwd_tma_f32,
csrc/conv_bwd.cuh run_dw_f32), at every conv that the route takes in the
512^2 batch-32 train step and in detect at 1280x768, batch 8: each
forward and dX product on conv_fwd.cu and each dW on conv_dw.cu.
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
    """run_dw_f32's: the ring (two X boxes of 32 f32 channels a 64-row
    chunk, bn / 32 dY boxes), its barriers, the alignment; and the parked
    accumulators of both warpgroups, which overlay the ring."""
    stage = ((2 if p.two else 1) * 2 + p.bn // 32) * 64 * 128
    return p.stages * stage + 16 * p.stages + 1024, p.stages * stage


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
        if train and CV.tma_takes(ci, co):
            p = CV.tma_dw_plan(*geo, ci, co, k, SMS, 0, 4)
            smem, ring = dw_smem(p)
            assert p.stages >= 2 and smem <= CV.MAX_SMEM, (ci, co, k, p)
            assert 2 * 64 * (p.bn + 8) * 4 <= ring and p.bn in (64, 128)
            assert p.splits % p.cluster == 0
            dw += 1
    # a step: 57 forwards and 53 dX on conv_fwd.cu, 53 dW on conv_dw.cu
    # (the head's projections to 2 channels on conv.cu); detect: 57
    assert (fwd, dw) == ((110, 53) if train else (57, 0))


def test_float32_plans_halve_what_a_stage_holds():
    """A float32 K step carries 32 channels where a bfloat16 one carries
    64, each weight box twice (hi and lo); a float32 dW stage holds twice
    the bytes of a bfloat16 one, and no 256-column tile."""
    bf = CV.tma_fwd_plan(1, 1, 32 * 64 * 64, 256, 512, 1, SMS)
    f32 = CV.tma_fwd_plan(1, 1, 32 * 64 * 64, 256, 512, 1, SMS, 4)
    assert (bf.bn, f32.bn) == (128, 128) and f32.stages <= bf.stages
    dbf = CV.tma_dw_plan(32, 16, 16, 512, 512, 3, SMS)
    d32 = CV.tma_dw_plan(32, 16, 16, 512, 512, 3, SMS, 0, 4)
    assert (dbf.bn, d32.bn) == (256, 128)
    assert dw_smem(d32)[1] // d32.stages == 2 * (2 + 128 // 64) * 64 * 128
    chunk, splits = CV.narrow_dw32_plan(32 * 128 * 128, 64, 2, SMS)
    assert chunk * (splits - 1) < 32 * 128 * 128 <= chunk * splits


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
