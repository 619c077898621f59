"""The float32 plans of the fused arm's kernels, and the dtypes the fused
wrappers take on the card.

Every float32 plan (ops/conv.py tma_staged_fwd_plan and tma_bwd_dx_plan
with 4-byte elements, tma_dw_plan with y's float32 aux boxes) must fit the
232,448 bytes of shared memory a CTA may take, in the bytes the kernels
themselves count (csrc/conv_bwd.cuh run_dx_f32 and run_dw_f32), with at
least 2 ring stages, at every fused conv of the 512^2 batch-32 train step
(forward, dX and dW) and of detect at 1280x768, batch 8 (forward).
"""

import pytest
import torch

from tensorflow_ocr_tpu_torch.models import build_model
from tensorflow_ocr_tpu_torch.models.resnet import FusedBottleneck
from tensorflow_ocr_tpu_torch.ops import conv as CV
from tensorflow_ocr_tpu_torch.ops import fused as FU

SMS = 132
TM, ABOX = 128, 128 * 128


def round1k(nbytes):
    return -(-nbytes // 1024) * 1024


def dx32_smem(p, aux, kdim):
    """run_dx_f32's dynamic shared memory: the ring (the A box and, with
    aux, y's box of 32 f32 channels, beside the weight's hi and lo boxes:
    three of each in halo mode, none where the weight is resident), the
    resident weight (the hi and lo boxes of each of the kdim / 32 K steps;
    kdim the contracted channels times the taps), the epilogue slots of TM
    x bn f32, the 8 warps' sums and the mask, the CTA's running sums in
    double, the barriers, the alignment."""
    if p.halo:
        stage = round1k((p.wb + 2) * p.hb * 128) * (2 if aux else 1) \
            + 6 * p.bn * 128
    else:
        stage = ABOX * (2 if aux else 1) + (0 if p.resident
                                            else 2 * p.bn * 128)
    return (p.stages * stage + p.resident * kdim // 32 * 2 * p.bn * 128
            + p.eslots * TM * p.bn * 4 + 9 * 2 * p.bn * 4 + 2 * p.bn * 8
            + 8 * (2 * p.stages + 7) + 1024)


def check_dx32(p, aux, kdim, cols, k):
    """A float32 forward or dX plan: it fits, 2 or more ring stages, BN 128
    where it divides the columns outside halo mode (a halo slot at BN 128,
    six 16 KiB weight boxes beside the halo box, is too large for two), a
    resident weight only in a 1x1, 1 to 3 epilogue slots, the products
    overlapped where the ring keeps three slots or in halo mode (a product
    prepared under its predecessor holds two slots), the grid a multiple
    of the column tiles."""
    assert p.stages >= 2 and dx32_smem(p, aux, kdim) <= CV.MAX_SMEM, p
    assert p.bn == (128 if cols % 128 == 0 and not p.halo else 64), p
    assert k == 1 or not p.resident
    assert 1 <= p.eslots <= 3 and p.overlap == (p.halo or p.stages >= 3)
    assert p.col_tiles == cols // p.bn and p.grid % p.col_tiles == 0


def dw32_smem(p):
    """run_dw_f32's with the staging transform (tdw_f32_tr): the ring (two
    X boxes of 32 f32 channels a 64-row chunk, bn / 32 dY boxes, which the
    split's hi tile then overlays, and as many y or g boxes, which its lo
    tile overlays), its barriers, the alignment; and the parked sums,
    which overlay the ring."""
    stage = ((2 if p.two else 1) * 2 + 2 * (p.bn // 32)) * 64 * 128
    return p.stages * stage + 16 * p.stages + 1024, p.stages * stage


def fused_convs(n, h, w):
    """(N, H, W, Ci, Co, k) of every conv of the fused units of
    pixellink_resnet50 at n images of h x w (block b at 1/4 / 2^(b-1))."""
    model = build_model("pixellink_resnet50", bottleneck_impl="fused")
    out = []
    for name, m in model.backbone.named_children():
        if isinstance(m, FusedBottleneck):
            s = 4 << (int(name[len("block")]) - 1)
            for conv in (m.conv1, m.conv2, m.conv3, m.shortcut):
                if conv is not None:
                    co, ci, k, _ = conv.conv.weight.shape
                    out.append((n, h // s, w // s, ci, co, k))
    return out


@pytest.mark.parametrize("nhw,train", [((32, 512, 512), True),
                                       ((8, 768, 1280), False)])
def test_float32_fused_plans_fit_shared_memory(nhw, train):
    convs = fused_convs(*nhw)
    assert len(convs) == 43
    for n, h, w, ci, co, k in set(convs):
        assert FU.kernel_takes(ci, co, k)
        geo = (1, 1, n * h * w) if k == 1 else (n, h, w)
        plans = [(CV.tma_staged_fwd_plan(*geo, ci, co, k, SMS, esize=4), 0,
                  co, k * k * ci)]
        if train:
            plans.append((CV.tma_bwd_dx_plan(*geo, ci, co, k, SMS, 4, True,
                                             esize=4), 4, ci, k * k * co))
        for p, aux, cols, kdim in plans:
            check_dx32(p, aux, kdim, cols, k)
            assert p.grid <= SMS and p.halo == (k == 3 and p.wb >= 64)
            assert not p.halo or cols % 128
        if train:
            p = CV.tma_dw_plan(*geo, ci, co, k, SMS, aux=4, esize=4)
            smem, ring = dw32_smem(p)
            assert p.stages >= 2 and smem <= CV.MAX_SMEM, (ci, co, k, p)
            assert 2 * 64 * (p.bn + 8) * 4 <= ring and co % p.bn == 0
            assert p.splits % p.cluster == 0


def test_float32_fused_plans_double_what_a_stage_holds():
    """A float32 K step carries 32 channels where a bfloat16 one carries
    64, each weight box twice (hi and lo); so the halo forward keeps 2
    ring slots where bf16 keeps more, and a float32 staged dW stage holds
    twice the bf16 one's bytes."""
    geo = (32, 128, 128)
    bf = CV.tma_staged_fwd_plan(*geo, 64, 64, 3, SMS)
    f32 = CV.tma_staged_fwd_plan(*geo, 64, 64, 3, SMS, esize=4)
    assert bf.halo and f32.halo and f32.stages < bf.stages
    d16 = CV.tma_dw_plan(*geo, 64, 64, 3, SMS, aux=2)
    d32 = CV.tma_dw_plan(*geo, 64, 64, 3, SMS, aux=4, esize=4)
    assert d16.bn == d32.bn == 64
    stage16 = ((2 if d16.two else 1) + 1) * 64 * 128 + 64 * 64 * 2
    assert dw32_smem(d32)[1] // d32.stages == 2 * stage16


@pytest.mark.parametrize("geo,ci,co,k,fwd,bn,resident,stages", [
    # block1's 1x1s over 32 x 128^2 rows: the weight resident where it
    # fits beside three A slots and an epilogue slot
    ((1, 1, 524288), 64, 64, 1, True, 64, True, 7),
    ((1, 1, 524288), 64, 256, 1, True, 128, True, 5),
    ((1, 1, 524288), 256, 64, 1, True, 64, True, 3),
    ((1, 1, 524288), 64, 64, 1, False, 64, True, 3),
    # dX 256 -> 64: 64 KiB of weight, three 32 KiB slots and a 64 KiB
    # epilogue slot exceed the card: streamed, two slots
    ((1, 1, 524288), 256, 64, 1, False, 128, False, 2),
    ((1, 1, 524288), 64, 256, 1, False, 64, False, 3),
    # a 3x3 at 64 columns: halo mode over 128-pixel rows at BN 64; at
    # 128 columns a box of 32 pixels a row keeps BN 128 (a halo slot at
    # BN 128 does not fit twice)
    ((32, 128, 128), 64, 64, 3, True, 64, False, 2),
    ((32, 64, 64), 128, 128, 3, True, 128, False, 3),
    ((32, 64, 64), 128, 128, 3, False, 128, False, 2),
    ((8, 96, 160), 128, 128, 3, True, 128, False, 3),
    ((8, 96, 160), 128, 128, 3, False, 128, False, 2),
])
def test_float32_dx_plan_choices(geo, ci, co, k, fwd, bn, resident, stages):
    """The float32 plan's choices at the step's shapes: BN, the resident
    weight and the ring."""
    if fwd:
        p = CV.tma_staged_fwd_plan(*geo, ci, co, k, SMS, esize=4)
        check_dx32(p, 0, k * k * ci, co, k)
    else:
        p = CV.tma_bwd_dx_plan(*geo, ci, co, k, SMS, 4, True, esize=4)
        check_dx32(p, 4, k * k * co, ci, k)
    assert (p.bn, p.resident, p.stages) == (bn, resident, stages)


def test_float32_dx_plan_knobs(monkeypatch):
    """DX32_BN, DX32_RESIDENT and DX32_OVERLAP steer the float32 plan
    (the probes' sweep) and leave the bfloat16 one as it is."""
    geo = (1, 1, 524288)
    bf = CV.tma_staged_fwd_plan(*geo, 64, 256, 1, SMS)
    monkeypatch.setattr(CV, "DX32_BN", (64,))
    monkeypatch.setattr(CV, "DX32_RESIDENT", False)
    monkeypatch.setattr(CV, "DX32_OVERLAP", False)
    CV.tma_bwd_dx_plan.cache_clear()
    try:
        p = CV.tma_staged_fwd_plan(*geo, 64, 256, 1, SMS, esize=4)
        assert (p.bn, p.resident, p.overlap) == (64, False, False)
        assert CV.tma_staged_fwd_plan(*geo, 64, 256, 1, SMS) == bf
        assert not bf.overlap
    finally:
        CV.tma_bwd_dx_plan.cache_clear()


def test_float32_staged_dw_stage_is_the_routes():
    """tdw_f32_tr's stage (the X boxes, the dY boxes then hi, the aux boxes
    then lo) has the bytes of the route's tdw_f32_wg stage (whose lo tile
    no box fills) at the same bn and chunks: the plan keeps its BN 128
    where it divides Co and its stages, 96 KiB and 2 stages at BN 128 with
    two chunks, a fresh run's accumulator and the sums in registers."""
    from test_torch_conv_f32_plans import dw_smem

    p = CV.tma_dw_plan(32, 64, 64, 128, 128, 3, SMS, aux=4, esize=4)
    assert p.bn == 128 and p.two and p.stages == 2
    assert dw32_smem(p)[1] == 2 * 96 * 1024 and dw32_smem(p)[0] <= \
        CV.MAX_SMEM
    r = CV.tma_dw_plan(32, 64, 64, 128, 128, 3, SMS, 0, 4)
    assert (r.bn, r.two, r.stages) == (p.bn, p.two, p.stages)
    assert dw_smem(r) == dw32_smem(p)
    # a Co that 128 does not divide takes BN 64, a single chunk both
    # warpgroups' halves of a tile
    q = CV.tma_dw_plan(1, 1, 524288, 64, 192, 1, SMS, aux=4, esize=4)
    assert q.bn == 64 and not q.two and q.stages >= 2
    assert dw32_smem(q)[0] <= CV.MAX_SMEM


class Fake:
    """A stand-in for a CUDA tensor: device, dtype and shape, contiguous
    in every memory format."""

    def __init__(self, dtype, shape=(1, 64, 4, 4)):
        self.device, self.dtype, self.shape = (torch.device("cuda", 0),
                                               dtype, torch.Size(shape))

    def dim(self):
        return len(self.shape)

    def is_contiguous(self, memory_format=None):
        return True


@pytest.mark.parametrize("dtype,raises", [
    (torch.float32, None), (torch.bfloat16, None),
    (torch.float16, TypeError), (torch.float64, TypeError)])
def test_wrappers_take_float32_or_bfloat16(dtype, raises):
    """The activations bfloat16 or float32, the tables float32 whatever
    the activations' type."""
    table = Fake(torch.float32, (2, 64))
    args = dict(x=Fake(dtype), y=Fake(dtype), ab=table)
    if raises:
        with pytest.raises(raises, match="bfloat16 or float32"):
            FU._check(args["x"], **args)
    else:
        FU._check(args["x"], **args)
        FU._check_weight(args["x"], Fake(dtype, (64, 64, 1, 1)))


@pytest.mark.parametrize("mixed", [
    dict(y=torch.bfloat16), dict(dy=torch.float16), dict(w=torch.bfloat16)])
def test_wrappers_refuse_mixed_types(mixed):
    """A float32 activation beside a bfloat16 or float16 one, or beside a
    bfloat16 weight, raises before any launch."""
    x = Fake(torch.float32)
    with pytest.raises(TypeError):
        if "w" in mixed:
            FU._check_weight(x, Fake(mixed["w"], (64, 64, 1, 1)))
        else:
            FU._check(x, x=x, **{k: Fake(v) for k, v in mixed.items()})
    with pytest.raises(TypeError, match="need a contiguous float32 table"):
        FU._check(x, x=x, ab=Fake(torch.bfloat16, (2, 64)))


def test_float32_cuda_tensors_go_to_the_float32_kernels(monkeypatch):
    """conv_fwd, conv_bwd, boundary_fwd and boundary_bwd send a float32
    tensor off the CPU to the float32 wrappers, which count their own
    launches (and the bf16 ones none); the float32 wrappers refuse
    bfloat16; there is no fallback to the plain versions."""
    calls = []
    for name in ("_launch_fwd", "_launch_bwd", "_launch_boundary_fwd",
                 "_launch_boundary_bwd"):
        monkeypatch.setattr(FU, name,
                            lambda *a, _n=name: calls.append(_n) or _n)
    for ref in ("conv_fwd_reference", "conv_bwd_reference",
                "boundary_fwd_reference", "boundary_bwd_reference"):
        monkeypatch.setattr(FU, ref, lambda *a: pytest.fail("a fallback"))
    fns = (FU.conv_fwd, FU.conv_bwd, FU.boundary_fwd, FU.boundary_bwd,
           FU.conv_fwd32, FU.conv_bwd32, FU.boundary_fwd32,
           FU.boundary_bwd32)
    for fn in fns:
        monkeypatch.setattr(fn, "launches", 0)
    x, t = Fake(torch.float32), Fake(torch.float32, (2, 64))
    FU.conv_fwd(x, t, x)
    FU.conv_bwd(x, t, x, x, x, t)
    FU.boundary_fwd(x, t, x, t)
    FU.boundary_bwd(x, x, t, x, t)
    assert calls == ["_launch_fwd", "_launch_bwd", "_launch_boundary_fwd",
                     "_launch_boundary_bwd"]
    assert [fn.launches for fn in fns] == [0] * 4 + [1] * 4
    b = Fake(torch.bfloat16)
    FU.conv_fwd(b, t, b)
    assert FU.conv_fwd.launches == 1 and FU.conv_fwd32.launches == 1
    for fn in (FU.conv_fwd32, FU.boundary_fwd32):
        with pytest.raises(TypeError, match="float32"):
            fn(b, t, b, t) if fn is FU.boundary_fwd32 else fn(b, t, b)


def test_boundary_takes_4096_float32_channels():
    """A row of the float32 boundary is C / 4 vectors, one a thread, at
    most 1024: C <= 4096 in float32 (8192 in bfloat16)."""
    def shapes(c, dtype):
        z = torch.zeros(1, c, 2, 2, dtype=dtype, device="meta")
        t = torch.zeros(2, c, device="meta")
        return FU._boundary_shapes(z, t, z, t)

    assert shapes(4096, torch.float32) == (4, 4096)
    assert shapes(8192, torch.bfloat16) == (4, 8192)
    with pytest.raises(ValueError, match="C <= 4096"):
        shapes(8192, torch.float32)
