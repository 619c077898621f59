"""Stride-1 1x1 and 3x3 convolutions on hand-written kernels.

Port of ``tensorflow_ocr_tpu/ops/pallas_conv.py``, the route that
``models/layers.py`` takes under ``PALLAS_CONVS``. Four wrappers carry
the work, each with a hand-written CUDA kernel and a plain PyTorch
version beside it (the forwards in ``csrc/conv_fwd.cu``, the dW products
in ``csrc/conv_dw.cu``, the narrow shapes of both in ``csrc/conv.cu``):

- :func:`matmul_rows` <- ``_matmul_rows`` (:81): y = x·W over pixel rows,
  the 1x1 forward and (with Wᵀ) its dX;
- :func:`dw_rows`     <- ``_dw_rows`` (:108): Xᵀ·dY over all rows, the
  1x1 dW;
- :func:`conv3`       <- ``_conv3`` (:148): the 3x3 stride-1 SAME conv,
  the 3x3 forward and (with the flipped, channel-swapped kernel) its dX;
- :func:`dw3`         <- ``_dw3`` (:190): the nine tap contractions of
  the 3x3 dW.

CPU tensors take the plain version; CUDA tensors launch the kernel
(counted in each wrapper's ``launches``) or raise. Products accumulate in
float32; y and dX are rounded once to the activation dtype, dW is
returned in float32 and rounded to the weight's dtype by the autograd
functions (``dw.astype(w.dtype)``, pallas_conv.py:238, 267).

The kernels take bfloat16 or float32 operands, all of one type, as the
Pallas kernels do (pallas_conv.py:308). The float32 ones are kernels of
their own beside the bfloat16 ones, each counting its launches
(:func:`tma_fwd32`, :func:`tma_dw32`, :func:`narrow_fwd32`,
:func:`narrow_dw32`): the same tiles, a K step or a box holding 32 f32
channels (128 bytes) where it holds 64 bf16, and a float32 product, not a
TF32 one: the tensor cores take each operand split into two TF32 values
(hi = tf32(x), lo = tf32(x - hi)) and sum hi.hi' + hi.lo' + lo.hi' in f32
(csrc/wgmma.cuh), both on TF32 wgmma (the dW transposes dY once a stage
into K-major tiles: TF32 wgmma takes no pixel-major operand); the narrow
shapes by f32 FMAs.

Tensors are NCHW in the channels-last memory format, so an (N, C, H, W)
tensor is JAX's (N, H, W, C) array in memory and its rows are the
kernels' (M, C) matrices. Weights are (Co, Ci, k, k) in the activation
dtype, as the Flax module casts its kernel before the call.

The kernels take any channel counts (the PixelLink head's projections
to 2 and 16 channels included) and any N, H, W within int32 indices.
Both kinds of product dispatch by shape between two kernels, each of
which counts its own launches. The forwards (:func:`tma_fwd_takes`):
``csrc/conv_fwd.cu`` (TMA, K-major wgmma, a persistent tile loop) where
the contracted channel count is a multiple of 8, ``csrc/conv.cu``'s
``igemm_fwd`` for the rest (the dX of the head's projections to 2
channels) (:func:`tma_fwd`, :func:`narrow_fwd`). The dW products
(:func:`tma_takes`): ``csrc/conv_dw.cu`` (TMA and wgmma) where Ci and Co
are multiples of 8, ``csrc/conv.cu``'s ``igemm_dw`` for the rest (the
head's 2 channels) (:func:`tma_dw`, :func:`narrow_dw`); float32 takes the
same dispatch. :func:`supported` says exactly that, and replaces the TPU
tile pickers ``_pick_bm``/``_pick_th``, which encode VMEM budgets that
Hopper does not have. float16 and float64 CUDA tensors raise (CPU tensors
of any float type take the plain versions).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from tensorflow_ocr_tpu_torch.ops.fused import (
    cuda_stream,
    full_f32,
    on_cpu,
    raise_on,
    up_f32,
)
from tensorflow_ocr_tpu_torch.ops.kernels import build_library

_CL = torch.channels_last
# the kernels' tiles (csrc/conv.cu, csrc/igemm.cuh): pixel rows of the
# forward, the K slice, and the narrow dW split's target of CTAs an SM
FWD_ROWS, BK, DW_WAVES = 128, 32, 4
# csrc/conv_dw.cu: pixels a tile (the box wb x hb), bytes of one box of 64
# bf16 channels (or 32 f32), the shared memory a CTA may use, the ring's
# most slots and the largest cluster (at this shared memory an H100 holds 66
# clusters of 2 at once, 132 CTAs, but only 30 of 4:
# scripts/conv_dw_probe.py)
KP, BOX, MAX_SMEM, MAX_STAGES, MAX_CLUSTER = 64, 64 * 128, 232448, 8, 2
# csrc/conv_fwd.cu: pixels a tile (the box wb x hb), its column tiles (the
# narrowest that covers Co, 128 above), the fewest A slots beside a
# resident weight, the ring's most slots
TM, FWD_BN, MIN_A_SLOTS, MAX_FWD_STAGES = 128, (16, 64, 128), 3, 8
# the staged forward's ring slots kept before a second epilogue slot (per
# tap, and in halo mode)
FWD_KEEP, FWD_KEEP_HALO = 6, 4
# csrc/conv_bwd.cuh's float32 dW (tdw_f32_wg, the route's, and tdw_f32_tr,
# the fused and ghost backwards'): k8 steps a run in one accumulator (1, 2
# or 4; the tensor cores truncate as they accumulate, so the largest whose
# error stays within 3x the plain float32 version's on the route and 4x in
# the backwards, PERF.md), and the route's widest column tile (64 or 128)
DW32_RUN, DW32_BN = 4, 128
# csrc/conv_bwd.cuh's float32 forward and dX (tdx_f32): the column tiles
# its plan tries in order (each where it divides the columns and the ring
# keeps two slots), whether a 1x1's weight may stay resident, and whether
# each product's A fragment is prepared under the previous product's
# wgmmas (OVL); scripts/fused_f32_probe.py --sweep times the choices
DX32_BN, DX32_RESIDENT, DX32_OVERLAP = (128, 64), True, True


def rows(t: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) channels-last -> its (N*H*W, C) row matrix (a view)."""
    return t.permute(0, 2, 3, 1).reshape(-1, t.shape[1])


def unrows(t2: torch.Tensor, n: int, h: int, w: int) -> torch.Tensor:
    """(N*H*W, C) rows -> (N, C, H, W) channels-last (a view)."""
    return t2.reshape(n, h, w, t2.shape[1]).permute(0, 3, 1, 2)


# --------------------------------------------------------------------------
# the plain versions
# --------------------------------------------------------------------------


def matmul_rows_reference(x2: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`matmul_rows`."""
    with full_f32():
        return (up_f32(x2) @ up_f32(w2)).to(x2.dtype)


def dw_rows_reference(x2: torch.Tensor, dy2: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`dw_rows`."""
    with full_f32():
        return up_f32(x2).t() @ up_f32(dy2)


def conv3_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`conv3`."""
    with full_f32():
        y = F.conv2d(up_f32(x), up_f32(w), padding=1)
    return y.to(x.dtype).contiguous(memory_format=_CL)


def dw3_reference(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`dw3`."""
    co, ci = dy.shape[1], x.shape[1]
    with full_f32():
        dw = torch.nn.grad.conv2d_weight(up_f32(x), (co, ci, 3, 3),
                                         up_f32(dy), padding=1)
    return dw.permute(2, 3, 1, 0).reshape(9 * ci, co)


# --------------------------------------------------------------------------
# the kernels' wrappers
# --------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib():
    lib = ctypes.CDLL(str(build_library("conv")))
    for fn, args in (("conv_fwd", [_P] * 3 + [_I] * 7 + [_P]),
                     ("conv_dw", [_P] * 4 + [_I] * 10 + [_P]),
                     ("conv_fwd_f32", [_P] * 3 + [_I] * 6 + [_P]),
                     ("conv_dw_f32", [_P] * 4 + [_I] * 8 + [_P])):
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = ctypes.c_int
    return lib


@functools.cache
def _fwd_lib():
    lib = ctypes.CDLL(str(build_library("conv_fwd")))
    lib.conv_fwd_tma.argtypes = [_P] * 3 + [_I] * 12 + [_P]
    lib.conv_fwd_tma_f32.argtypes = [_P] * 4 + [_I] * 12 + [_P]
    for fn in (lib.conv_fwd_tma, lib.conv_fwd_tma_f32):
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _dw_lib():
    lib = ctypes.CDLL(str(build_library("conv_dw")))
    lib.conv_dw_tma.argtypes = [_P] * 4 + [_I] * 13 + [_P]
    lib.conv_dw_tma_f32.argtypes = [_P] * 4 + [_I] * 14 + [_P]
    for fn in (lib.conv_dw_tma, lib.conv_dw_tma_f32):
        fn.restype = ctypes.c_int
    return lib


def fwd_tile(co: int) -> int:
    """The narrow forward's column tile (csrc/conv.cu ``igemm_fwd``'s
    BN)."""
    return 128 if co > 64 else 64 if co > 32 else 32


def dw_plan(m: int, kdim: int, co: int, sms: int
            ) -> Tuple[int, int, int, int]:
    """(bm, bn, chunk, splits) of a dW product over m pixels into a
    (kdim, co) table: 64-row tiles where kdim <= 64 (no half-empty
    tiles), the pixels split into chunks of a multiple of BK so that
    ~DW_WAVES CTAs an SM run, every chunk non-empty."""
    bm = 64 if kdim <= 64 else 128
    bn = 128 if co > 64 else 64 if co > 32 or bm == 64 else 32
    tiles = -(-kdim // bm) * -(-co // bn)
    splits = max(1, -(-DW_WAVES * sms // tiles))
    chunk = -(-(-(-m // splits)) // BK) * BK
    return bm, bn, chunk, max(1, -(-m // chunk))


def narrow_dw32_plan(m: int, kdim: int, co: int, sms: int
                     ) -> Tuple[int, int]:
    """(chunk, splits) of csrc/conv.cu's float32 narrow dW: one table
    entry a thread in blocks of 256, the m pixels split into chunks so that
    ~DW_WAVES blocks an SM run, every chunk non-empty."""
    blocks = -(-kdim * co // 256)
    splits = max(1, -(-DW_WAVES * sms // blocks))
    chunk = -(-m // splits)
    return chunk, max(1, -(-m // chunk))


class TmaDwPlan(NamedTuple):
    """The work split of csrc/conv_dw.cu's dW kernel."""
    wb: int        # the pixel box: wb x hb pixels of one image, KP in all
    hb: int
    bn: int        # columns (of Co) a CTA: 64, 128 or 256
    two: bool      # the CTA's two warpgroups own two 64-row chunks
    stages: int    # slots of the TMA ring
    splits: int    # pixel-tile ranges, one a CTA along the grid's z
    cluster: int   # CTAs a cluster along the splits (splits a multiple)


class TmaFwdPlan(NamedTuple):
    """The tiling of csrc/conv_fwd.cu's forward kernel."""
    wb: int         # the pixel box: wb x hb pixels of one image, TM in all
    hb: int
    bn: int         # columns (of Co) a tile: one of FWD_BN
    resident: bool  # the CTA loads its K x bn weight once (1x1 only)
    stages: int     # slots of the TMA ring
    grid: int       # persistent CTAs (a multiple of col_tiles if resident)
    row_tiles: int  # pixel tiles: n * ceil(h / hb) * ceil(w / wb)
    col_tiles: int  # ceil(Co / bn)

    def tiles_of(self, cta: int) -> range:
        """The tiles CTA ``cta`` computes, in its order: tile t is pixel
        tile t // col_tiles, column tile t % col_tiles."""
        return range(cta, self.row_tiles * self.col_tiles, self.grid)


def tma_fwd_takes(k: int) -> bool:
    """Whether csrc/conv_fwd.cu takes a forward product that contracts k
    channels (Ci of a conv, Co of its dX): TMA reads rows of a multiple of
    16 bytes, which 8 channels are in bfloat16 and in float32 alike. The
    rest (the dX of the PixelLink head's 2-channel projections) take
    conv.cu's igemm_fwd (narrow_fwd_f32 in float32)."""
    return k % 8 == 0


@functools.lru_cache(maxsize=None)
def tma_fwd_plan(n: int, h: int, w: int, ci: int, co: int, ks: int,
                 sms: int, esize: int = 2) -> TmaFwdPlan:
    """The tiling of a forward product of n images of h x w, ci channels in
    and co out, ks x ks taps (a 1x1 over M rows: n = h = 1, w = M). The
    box is wb x hb pixels, wb a power of two up to TM and hb = TM / wb,
    the one whose tiles cover the fewest pixels outside the image (the
    widest among equals: TM x 1 for a 1x1 of M >= TM rows; 64 x 2 rather
    than 128 x 1 at detect's W = 320, where 128 x 1 covers 384); bn the
    narrowest of FWD_BN that covers Co (capped at 128). The output tile's
    staging for the TMA store takes 128 x bn elements. A 1x1's weight is
    resident where its ceil(ci/64) boxes of bn rows fit beside
    MIN_A_SLOTS A slots. As many ring slots as fit, up to MAX_FWD_STAGES;
    one CTA an SM (a multiple of the column tiles where the weight is
    resident), at most one a tile.

    ``esize`` 4 plans the float32 kernel: a K step and a box are 32
    channels (a 128-byte row), and each K step's weight comes as two boxes
    (its TF32 hi and lo), so the weight takes twice the K steps and each
    twice the bytes; the staging takes 128 x bn f32."""
    wb = min((1 << i for i in range(TM.bit_length())),
             key=lambda b: (-(-w // b) * b * -(-h // (TM // b)) * (TM // b),
                            -b))
    hb = TM // wb
    bn = next((b for b in FWD_BN if b >= co), FWD_BN[-1])
    ksteps = ks * ks * -(-ci // (128 // esize))
    abox, bbox = TM * 128, bn * 128 * (esize // 2)
    fixed = TM * bn * esize + 8 + 1024
    wbytes = ksteps * bbox
    resident = (ks == 1 and
                wbytes + MIN_A_SLOTS * (abox + 16) + fixed <= MAX_SMEM)
    stage = abox + (0 if resident else bbox)
    stages = min(MAX_FWD_STAGES, (MAX_SMEM - fixed - resident * wbytes)
                 // (stage + 16))
    row_tiles = n * -(-h // hb) * -(-w // wb)
    col_tiles = -(-co // bn)
    grid = min(row_tiles * col_tiles, sms)
    if resident:
        grid = max(col_tiles, grid - grid % col_tiles)
    return TmaFwdPlan(wb, hb, bn, resident, stages, grid, row_tiles,
                      col_tiles)


def tma_takes(ci: int, co: int) -> bool:
    """Whether csrc/conv_dw.cu takes a dW of these channel counts: TMA
    reads rows of a multiple of 16 bytes (8 channels in either element
    type). The rest (the PixelLink head's 2-channel projections) take
    conv.cu's igemm_dw (narrow_dw_f32 in float32)."""
    return ci % 8 == 0 and co % 8 == 0


@functools.lru_cache(maxsize=None)
def tma_dw_plan(n: int, h: int, w: int, ci: int, co: int, ks: int,
                sms: int, aux: int = 0, esize: int = 2,
                gh: int = 0) -> TmaDwPlan:
    """The split of a (ks*ks*ci, co) dW over n images of h x w (a 1x1 dW
    over M rows: n = h = 1, w = M). The box is the narrowest power of two
    that covers a row, up to KP pixels (KP x 1 for the 1x1's rows), the
    rest of KP in rows. The table's rows come in 64-row chunks (64
    channels of one tap), two a CTA where there are two or more; BN as
    wide as Co allows, up to 256. The pixel tiles are split so that one
    wave of CTAs (one an SM) fills the card, every split non-empty, a
    multiple of MAX_CLUSTER from 16 splits on; clusters of up to
    MAX_CLUSTER splits, the largest that divides them. As many ring slots
    as fit, up to MAX_STAGES.

    ``aux`` > 0 plans the staged backward's dW (csrc/conv_bwd.cuh ``tdw``):
    each 64 columns of dY come with an aux box of the same pixels in
    elements of ``aux`` bytes (y or g: 2 for bf16, 4 for f32), and BN is
    128 where it divides Co, else 64 (the rewrite of the larger stage
    keeps more slots in flight).

    ``esize`` 4 plans the float32 kernels: each 64 channels arrive as two
    boxes of 32 f32, twice the bytes of a stage. Without ``aux`` (the
    route's dW, csrc/conv_bwd.cuh ``tdw_f32_wg``) a stage also holds the
    lo tile of the split dY, as many bytes as its boxes (the hi tile goes
    over them), and BN is DW32_BN where Co reaches it, else 64; with
    ``aux`` 4 (the fused and ghost backwards in float32, ``tdw_f32_tr``)
    each 64 columns of dY come with two f32 boxes of y or g, the same
    bytes (the lo tile goes over them), and BN is 128 where it divides Co
    (a thread keeps a run's accumulator beside the sum).

    ``gh`` > 0 (the ghost backward in float32, whose dW keys each pixel
    tile by one band of gh rows) widens the box until its height divides
    gh: only images at most 4 pixels wide have a taller one."""
    wb = min(KP, 1 << max(w - 1, 0).bit_length())
    while gh and gh % (KP // wb):
        wb *= 2
    hb = KP // wb
    if aux:
        bn = 128 if co % 128 == 0 else 64
    elif esize == 4:
        bn = DW32_BN if co >= DW32_BN else 64
    else:
        bn = 256 if co >= 256 else 128 if co >= 128 else 64
    rchunks = ks * ks * -(-ci // 64)
    two = rchunks > 1
    tiles = (-(-rchunks // 2) if two else 1) * -(-co // bn)
    stage = (esize // 2 * ((2 if two else 1) + bn // 64) * BOX
             + bn // 64 * KP * 64 * aux)
    if esize == 4 and not aux:
        stage += bn * KP * 4  # the split dY's lo tile
    stages = min(MAX_STAGES, (MAX_SMEM - 1024) // (stage + 16))
    ntiles = n * -(-h // hb) * -(-w // wb)
    if aux:
        splits = staged_dw_splits(tiles, ntiles, sms)
    else:
        splits = max(1, min(ntiles, sms // tiles))
    if splits >= 16:
        splits -= splits % MAX_CLUSTER
    cluster = next(c for c in (8, 4, 2, 1)
                   if c <= MAX_CLUSTER and splits % c == 0)
    return TmaDwPlan(wb, hb, bn, two, stages, splits, cluster)


def split_offset(bn: int, n: int, p: int) -> int:
    """Byte offset of (output channel n, pixel p) in a split dY tile (hi
    or lo) of the route's float32 dW (csrc/conv_bwd.cuh ``split_offset``):
    two blocks of 32 pixels (p // 32), each bn rows of 128 bytes, row n's
    16-byte chunk (p % 32) // 4 permuted by n % 8 (the 128-byte swizzle of
    a K-major TF32 operand)."""
    return ((p // 32) * bn * 128 + n * 128
            + ((((p % 32) >> 2) ^ n) & 7) * 16 + (p % 4) * 4)


# the staged dW's fixed cost of a CTA (the ring's fill, the parking and
# the cluster's reduction), in pixel tiles
DW_CTA_TILES = 8


def staged_dw_splits(tiles: int, ntiles: int, sms: int) -> int:
    """The pixel split of the staged dW: the one whose waves of CTAs (one
    an SM) take the fewest pixel tiles, each CTA counting DW_CTA_TILES
    more for its fixed cost; the fewest splits among equals. Where the
    table's tiles alone exceed the SMs (a 512-channel 3x3 at bn 128: 144
    tiles), one split would leave a second wave of 12 CTAs as long as the
    first."""
    def cost(s):
        return -(-tiles * s // sms) * (-(-ntiles // s) + DW_CTA_TILES)
    return min(range(1, min(ntiles, 2 * sms) + 1), key=lambda s: (cost(s), s))


class TmaBwdDxPlan(NamedTuple):
    """The tiling of the staged backward's dX (csrc/conv_bwd.cuh tdx)."""
    wb: int         # the pixel box: wb x hb pixels of one image, TM in all
    hb: int
    bn: int         # columns (of Ci) a tile: 64 or 128
    resident: bool  # the CTA loads its K x bn weight once (1x1 only)
    stages: int     # slots of the TMA ring
    grid: int       # persistent CTAs, a multiple of col_tiles
    row_tiles: int  # pixel tiles: n * ceil(h / hb) * ceil(w / wb)
    col_tiles: int  # Ci / bn
    halo: bool      # a 3x3 whose K steps are (ky, channel box) halo boxes
    eslots: int     # epilogue slots (input and staged output of a tile)
    overlap: bool = False  # tdx_f32: each fragment prepared under the
    #                        previous product's wgmmas

    def tiles_of(self, cta: int) -> list:
        """The tiles CTA ``cta`` computes, in its order: tile t is pixel
        tile t // col_tiles, column tile t % col_tiles; a CTA takes a
        contiguous range of pixel tiles in column cta % col_tiles, each of
        the grid / col_tiles groups of a column an equal share."""
        col, grp = cta % self.col_tiles, cta // self.col_tiles
        groups = self.grid // self.col_tiles
        lo = grp * self.row_tiles // groups
        hi = (grp + 1) * self.row_tiles // groups
        return [r * self.col_tiles + col for r in range(lo, hi)]


def round1k(nbytes: int) -> int:
    return -(-nbytes // 1024) * 1024


@functools.lru_cache(maxsize=None)
def tma_bwd_dx_plan(n: int, h: int, w: int, ci: int, co: int, ks: int,
                    sms: int, aux: int, slot: bool, gh: int = 0,
                    fwd: bool = False, esize: int = 2) -> TmaBwdDxPlan:
    """The tiling of the staged backward's dX (csrc/conv_bwd.cuh ``tdx``):
    dX (n, h, w, ci) of dY (n, h, w, co) through ks x ks taps, ci and co
    multiples of 64 (a 1x1 over M rows: n = h = 1, w = M). As
    tma_fwd_plan, with: the box's height a divisor of ``gh`` where gh > 0
    (a ghost conv: each tile lies in one band); bn 128 where it divides ci
    and the ring keeps two slots, else 64; each ring slot holds the A box and its aux box (elements of
    ``aux`` bytes) beside the weight box unless the weight is resident; a
    3x3 whose box is a 64- or 128-pixel row segment in halo mode (a slot:
    the (wb + 2) x hb halo box of one ky and channel box, its aux box and
    the three kx weight boxes); ``slot``: the epilogue takes an input tile
    or stages a bf16 output (the fused dx, the ghost gm and do), in up to
    three epilogue slots of TM x bn bf16, as many as leave the ring 3 slots
    (2 in halo mode), at least one; the shared memory also holds the 8 warps'
    column sums and the tile's mask (a, b); the grid is always a multiple
    of the column tiles (a CTA's tiles share one column, so the fused
    epilogue sums them into one entry). ``fwd`` (the staged forward, whose
    epilogue slot only stages y) favours the ring: a second or third
    epilogue slot only where the ring keeps FWD_KEEP slots (FWD_KEEP_HALO
    in halo mode).

    ``esize`` 4 plans the float32 kernel (csrc/conv_bwd.cuh ``tdx_f32``):
    a K step is 32 channels (a 128-byte row of the A box and of its aux
    box, ``aux`` 4), each weight box comes twice (its TF32 hi and lo: six
    a halo slot, so a halo slot at bn 128 is too large for two, and a
    3x3 whose columns take bn 128 takes a box of at most 32 pixels a row,
    outside halo mode), bn the first of DX32_BN that divides ci and keeps
    the ring two slots, a 1x1's
    weight (hi and lo) resident where it fits beside MIN_A_SLOTS slots
    and DX32_RESIDENT allows, an epilogue slot holds TM x bn f32, the
    shared memory also holds the CTA's running sums in double, and
    ``overlap`` (each product's fragment prepared under the previous
    product's wgmmas, which keeps two slots held) is DX32_OVERLAP where
    the ring keeps three slots or a halo slot feeds three products."""
    boxes = [1 << i for i in range(TM.bit_length())
             if not gh or gh % (TM >> i) == 0]
    if esize == 4 and ks == 3 and 128 in DX32_BN and ci % 128 == 0:
        # a float32 halo slot at BN 128 (six 16 KiB weight boxes) does not
        # fit twice: a box of at most 32 pixels a row keeps BN 128
        boxes = [b for b in boxes if b < 64] or boxes
    wb = min(boxes, key=lambda b: (
        -(-w // b) * b * -(-h // (TM // b)) * (TM // b), -b))
    hb = TM // wb
    halo = ks == 3 and wb >= 64
    # channels a K step, and weight boxes a tap (the f32 hi and lo)
    kc, parts = 128 // esize, esize // 2
    ksteps = (3 if halo else ks * ks) * (co // kc)
    fixed = 8 * 7 + 1024
    if esize == 2:
        bns = (128, 64) if ci % 128 == 0 else (64,)
    else:
        bns = tuple(b for b in DX32_BN if ci % b == 0) or (64,)
    for bn in bns:
        # a halo slot with three 128-row weight boxes beside an f32 aux
        # box leaves the ring one slot: then two column tiles of 64
        bbox, sbytes = parts * bn * 128, TM * bn * esize
        # the 8 warps' sums and the mask; in float32 the CTA's running sums
        # in double too
        room = MAX_SMEM - fixed - 9 * 2 * bn * 4 - (esize == 4) * 16 * bn
        if halo:
            rows = (wb + 2) * hb
            stage = (round1k(rows * 128) + round1k(rows * kc * aux)
                     + 3 * bbox)
        else:
            stage = TM * 128 + TM * kc * aux
        wbytes = ksteps * bbox
        resident = (ks == 1 and (esize == 2 or DX32_RESIDENT)
                    and wbytes + MIN_A_SLOTS
                    * (stage + 16) + slot * sbytes <= room)
        if not halo and not resident:
            stage += bbox
        room -= resident * wbytes
        # epilogue slots: as many as leave the ring its fewest slots (2 in
        # halo mode, else MIN_A_SLOTS), up to 3, at least one
        eslots = 0
        if slot:
            keep = ((FWD_KEEP_HALO if halo else FWD_KEEP) if fwd else
                    2 if halo else MIN_A_SLOTS)
            eslots = max([1] + [e for e in (2, 3) if (room - e * sbytes)
                                // (stage + 16) >= keep])
        stages = min(MAX_FWD_STAGES,
                     (room - eslots * sbytes) // (stage + 16))
        if stages >= 2:
            break
    row_tiles = n * -(-h // hb) * -(-w // wb)
    col_tiles = ci // bn
    grid = min(row_tiles * col_tiles, sms)
    grid = max(col_tiles, grid - grid % col_tiles)
    # a product prepared under its predecessor holds two slots, so only
    # where the ring keeps three, or a halo slot feeds three products
    overlap = esize == 4 and DX32_OVERLAP and (halo or stages >= 3)
    return TmaBwdDxPlan(wb, hb, bn, resident, stages, grid, row_tiles,
                        col_tiles, halo, eslots, overlap)


def tma_staged_fwd_plan(n: int, h: int, w: int, ci: int, co: int, ks: int,
                        sms: int, gh: int = 0, esize: int = 2
                        ) -> TmaBwdDxPlan:
    """The tiling of the staged forward (csrc/conv_bwd.cuh ``tdx`` in its
    forward mode: fused_conv_fwd and ghost_conv_fwd), a conv of ci -> co
    channels through ks x ks taps over n images of h x w (a 1x1 over M
    rows: n = h = 1, w = M): tdx's plan with the channel counts swapped
    (its columns are the conv's co, its K steps the conv's ci), no aux
    box, the output y staged in epilogue slots (``fwd``: the ring first);
    gh > 0, a ghost conv: the box height divides gh, so each tile lies in
    one band; ``esize`` 4, the float32 kernel (``tdx_f32``)."""
    return tma_bwd_dx_plan(n, h, w, co, ci, ks, sms, 0, True, gh, True,
                           esize)


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# the element types the kernels take
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def _check(ref: torch.Tensor, **tensors) -> None:
    """Every tensor on ref's CUDA device, bfloat16 or float32, all of
    ref's type. Raises otherwise."""
    if ref.device.type != "cuda":
        raise ValueError(f"tensors on {ref.device}: the kernels need a "
                         "CUDA device (or every tensor on the CPU)")
    for name, t in tensors.items():
        if t.device != ref.device:
            raise ValueError(f"{name} on {t.device}, expected {ref.device}")
        if t.dtype not in KERNEL_DTYPES or t.dtype != ref.dtype:
            raise TypeError(f"{name}: the kernels take bfloat16 or float32 "
                            f"operands of one type, got {t.dtype} beside "
                            f"{ref.dtype}")


def _indices_fit(m: int, c: int, k: int) -> bool:
    return m * max(c, 1) * k * k < 2 ** 31


def _fwd(x, wt, n, h, w, ci, co, k, name):
    """The forward of rows of x (n*h*w, ci) contiguous and wt (co, k*k*ci)
    contiguous -> (n*h*w, co) in x's dtype, on the kernel that
    :func:`tma_fwd_takes` picks by shape."""
    if not _indices_fit(n * h * w, max(ci, co), k):
        raise ValueError("shape overflows the kernel's int32 indices")
    if x.dtype == torch.float32:
        kernel = tma_fwd32 if tma_fwd_takes(ci) else narrow_fwd32
    else:
        kernel = tma_fwd if tma_fwd_takes(ci) else narrow_fwd
    return kernel(x, wt, n, h, w, ci, co, k, name)


def _on_device(index: int):
    """The device guard, only where ``index`` is not the current device:
    the wrappers' host time is of the order of a small shape's device
    time."""
    return (contextlib.nullcontext() if index == torch.cuda.current_device()
            else torch.cuda.device(index))


def tma_fwd(x, wt, n, h, w, ci, co, k, name="tma_fwd"):
    """conv_fwd_tma of csrc/conv_fwd.cu (:func:`tma_fwd_plan`'s tiling).
    Raises on a contracted channel count that is not a multiple of 8 and
    on bases that are not 16-byte aligned: TMA takes neither."""
    return _tma_fwd(x, wt, n, h, w, ci, co, k, name, tma_fwd)


def tma_fwd32(x, wt, n, h, w, ci, co, k, name="tma_fwd32"):
    """conv_fwd_tma_f32 of csrc/conv_fwd.cu: the float32 forward on
    :func:`tma_fwd_plan`'s tiling with 4-byte elements, split TF32 on the
    tensor cores; the weight's split goes to a scratch of twice its size.
    Raises as :func:`tma_fwd`."""
    return _tma_fwd(x, wt, n, h, w, ci, co, k, name, tma_fwd32)


def _tma_fwd(x, wt, n, h, w, ci, co, k, name, counter):
    if not tma_fwd_takes(ci):
        raise ValueError(f"{name}: TMA needs the contracted channel count "
                         f"to be a multiple of 8, got {ci}")
    if x.data_ptr() % 16 or wt.data_ptr() % 16:
        raise ValueError(f"{name}: TMA needs 16-byte aligned operands")
    index = x.device.index
    f32 = x.dtype == torch.float32
    p = tma_fwd_plan(n, h, w, ci, co, k, _sms(index), 4 if f32 else 2)
    y = torch.empty((n * h * w, co), dtype=x.dtype, device=x.device)
    plan = (n, h, w, ci, co, k, p.wb, p.hb, p.bn, int(p.resident), p.stages,
            p.grid, torch._C._cuda_getCurrentRawStream(index))
    lib = _fwd_lib()
    with _on_device(index):
        if f32:
            wsplit = torch.empty((2, co, k * k * ci), dtype=x.dtype,
                                 device=x.device)
            err = lib.conv_fwd_tma_f32(x.data_ptr(), wt.data_ptr(),
                                       wsplit.data_ptr(), y.data_ptr(), *plan)
        else:
            err = lib.conv_fwd_tma(x.data_ptr(), wt.data_ptr(), y.data_ptr(),
                                   *plan)
    raise_on(err, name)
    counter.launches += 1
    return y


def narrow_fwd(x, wt, n, h, w, ci, co, k, name="narrow_fwd"):
    """conv_fwd of csrc/conv.cu (igemm_fwd, 128-row tiles by
    :func:`fwd_tile`): any channel counts, predicated loads."""
    y = torch.empty((n * h * w, co), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _lib().conv_fwd(x.data_ptr(), wt.data_ptr(), y.data_ptr(), n, h,
                              w, ci, co, k, fwd_tile(co), cuda_stream())
    raise_on(err, name)
    narrow_fwd.launches += 1
    return y


def narrow_fwd32(x, wt, n, h, w, ci, co, k, name="narrow_fwd32"):
    """conv_fwd_f32 of csrc/conv.cu: the float32 forward of any channel
    counts, one f32 FMA chain an output element."""
    y = torch.empty((n * h * w, co), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _lib().conv_fwd_f32(x.data_ptr(), wt.data_ptr(), y.data_ptr(),
                                  n, h, w, ci, co, k, cuda_stream())
    raise_on(err, name)
    narrow_fwd32.launches += 1
    return y


def _dw(x, dy, n, h, w, ci, co, k, name):
    """The dW of rows of x (m, ci) and dy (m, co), contiguous -> (k*k*ci,
    co) float32, on the kernel that :func:`tma_takes` picks by shape."""
    if not _indices_fit(n * h * w, max(ci, co), k):
        raise ValueError("shape overflows the kernel's int32 indices")
    if x.dtype == torch.float32:
        kernel = tma_dw32 if tma_takes(ci, co) else narrow_dw32
    else:
        kernel = tma_dw if tma_takes(ci, co) else narrow_dw
    return kernel(x, dy, n, h, w, ci, co, k, name)


def tma_dw(x, dy, n, h, w, ci, co, k, name="tma_dw"):
    """conv_dw_tma of csrc/conv_dw.cu (:func:`tma_dw_plan`'s split). Raises
    on channel counts that are not multiples of 8 and on bases that are
    not 16-byte aligned: TMA takes neither."""
    return _tma_dw(x, dy, n, h, w, ci, co, k, name, tma_dw)


def tma_dw32(x, dy, n, h, w, ci, co, k, name="tma_dw32"):
    """conv_dw_tma_f32 of csrc/conv_dw.cu: the float32 dW on
    :func:`tma_dw_plan`'s split with 4-byte elements, split TF32 on TF32
    wgmma, runs of DW32_RUN k8 steps a fresh accumulator. Raises as
    :func:`tma_dw`."""
    return _tma_dw(x, dy, n, h, w, ci, co, k, name, tma_dw32)


def _tma_dw(x, dy, n, h, w, ci, co, k, name, counter):
    if not tma_takes(ci, co):
        raise ValueError(f"{name}: TMA needs Ci and Co multiples of 8, got "
                         f"{ci}, {co}")
    if x.data_ptr() % 16 or dy.data_ptr() % 16:
        raise ValueError(f"{name}: TMA needs 16-byte aligned operands")
    index = x.device.index
    f32 = x.dtype == torch.float32
    p = tma_dw_plan(n, h, w, ci, co, k, _sms(index), 0, 4 if f32 else 2)
    # the table and the clusters' partial tables in one allocation: the
    # wrapper's host time is of the order of a small shape's device time
    tables = p.splits // p.cluster
    buf = torch.empty((1 + tables if tables > 1 else 1, k * k * ci, co),
                      dtype=torch.float32, device=x.device)
    dw, ws = buf[0], buf[1:] if tables > 1 else buf
    lib = _dw_lib()
    args = (x.data_ptr(), dy.data_ptr(), dw.data_ptr(), ws.data_ptr(), n, h,
            w, ci, co, k, p.wb, p.hb, p.bn, int(p.two), p.stages, p.splits,
            p.cluster)
    stream = torch._C._cuda_getCurrentRawStream(index)
    with _on_device(index):
        if f32:
            err = lib.conv_dw_tma_f32(*args, DW32_RUN, stream)
        else:
            err = lib.conv_dw_tma(*args, stream)
    raise_on(err, name)
    counter.launches += 1
    return dw


def narrow_dw(x, dy, n, h, w, ci, co, k, name="narrow_dw"):
    """conv_dw of csrc/conv.cu (igemm_dw, :func:`dw_plan`'s split): any
    channel counts, predicated loads."""
    m, kdim = n * h * w, k * k * ci
    bm, bn, chunk, splits = dw_plan(m, kdim, co, _sms(x.device.index or 0))
    dw = torch.empty((kdim, co), dtype=torch.float32, device=x.device)
    ws = (torch.empty((splits, kdim, co), dtype=torch.float32,
                      device=x.device) if splits > 1 else dw)
    with torch.cuda.device(x.device):
        err = _lib().conv_dw(x.data_ptr(), dy.data_ptr(), dw.data_ptr(),
                             ws.data_ptr(), n, h, w, ci, co, k, bm, bn, chunk,
                             splits, cuda_stream())
    raise_on(err, name)
    narrow_dw.launches += 1
    return dw


def narrow_dw32(x, dy, n, h, w, ci, co, k, name="narrow_dw32"):
    """conv_dw_f32 of csrc/conv.cu (:func:`narrow_dw32_plan`'s split): the
    float32 dW of any channel counts, one f32 FMA chain a table entry and
    chunk."""
    m, kdim = n * h * w, k * k * ci
    chunk, splits = narrow_dw32_plan(m, kdim, co, _sms(x.device.index or 0))
    dw = torch.empty((kdim, co), dtype=torch.float32, device=x.device)
    ws = (torch.empty((splits, kdim, co), dtype=torch.float32,
                      device=x.device) if splits > 1 else dw)
    with torch.cuda.device(x.device):
        err = _lib().conv_dw_f32(x.data_ptr(), dy.data_ptr(), dw.data_ptr(),
                                 ws.data_ptr(), n, h, w, ci, co, k, chunk,
                                 splits, cuda_stream())
    raise_on(err, name)
    narrow_dw32.launches += 1
    return dw


def matmul_rows(x2: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """y = x2·w2 with float32 accumulation, rounded to x2's dtype.

    x2 (M, Ci), w2 (Ci, Co). The 1x1 forward (w2 = W) and its dX (x2 =
    dY, w2 = Wᵀ)."""
    if on_cpu(x2, w2):
        return matmul_rows_reference(x2, w2)
    _check(x2, x2=x2, w2=w2)
    m, ci = x2.shape
    if w2.shape[0] != ci:
        raise ValueError(f"x2 {tuple(x2.shape)}, w2 {tuple(w2.shape)}")
    co = w2.shape[1]
    y = _fwd(x2.contiguous(), w2.t().contiguous(), 1, 1, m, ci, co, 1,
             "matmul_rows")
    matmul_rows.launches += 1
    return y


def dw_rows(x2: torch.Tensor, dy2: torch.Tensor) -> torch.Tensor:
    """x2ᵀ·dy2 summed in float32 over all M rows: (Ci, Co) float32.
    x2 (M, Ci), dy2 (M, Co). The 1x1 dW."""
    if on_cpu(x2, dy2):
        return dw_rows_reference(x2, dy2)
    _check(x2, x2=x2, dy2=dy2)
    m, ci = x2.shape
    if dy2.shape[0] != m:
        raise ValueError(f"x2 {tuple(x2.shape)}, dy2 {tuple(dy2.shape)}")
    dw = _dw(x2.contiguous(), dy2.contiguous(), 1, 1, m, ci, dy2.shape[1],
             1, "dw_rows")
    dw_rows.launches += 1
    return dw


def conv3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The 3x3 stride-1 SAME conv of x (N, Ci, H, W) with w (Co, Ci, 3, 3),
    float32 accumulation, rounded to x's dtype; channels-last out."""
    if on_cpu(x, w):
        return conv3_reference(x, w)
    _check(x, x=x, w=w)
    n, ci, h, wd = x.shape
    if w.shape[1:] != (ci, 3, 3):
        raise ValueError(f"x {tuple(x.shape)}, w {tuple(w.shape)}")
    co = w.shape[0]
    wt = w.permute(0, 2, 3, 1).reshape(co, 9 * ci).contiguous()
    y = _fwd(rows(x.contiguous(memory_format=_CL)), wt, n, h, wd, ci, co, 3,
             "conv3")
    conv3.launches += 1
    return unrows(y, n, h, wd)


def dw3(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The 3x3 dW: for each tap (ky, kx), Σ over pixels of the shifted x
    (zero past the border) times dy, into a (9·Ci, Co) float32 table with
    rows in (ky, kx, ci) order. x (N, Ci, H, W), dy (N, Co, H, W)."""
    if on_cpu(x, dy):
        return dw3_reference(x, dy)
    _check(x, x=x, dy=dy)
    n, ci, h, wd = x.shape
    if dy.shape[0] != n or dy.shape[2:] != (h, wd):
        raise ValueError(f"x {tuple(x.shape)}, dy {tuple(dy.shape)}")
    dw = _dw(rows(x.contiguous(memory_format=_CL)),
             rows(dy.contiguous(memory_format=_CL)), n, h, wd, ci,
             dy.shape[1], 3, "dw3")
    dw3.launches += 1
    return dw


for _fn in (matmul_rows, dw_rows, conv3, dw3, tma_fwd, narrow_fwd, tma_dw,
            narrow_dw, tma_fwd32, narrow_fwd32, tma_dw32, narrow_dw32):
    _fn.launches = 0


# --------------------------------------------------------------------------
# autograd: the custom-VJP convs
# --------------------------------------------------------------------------


class _Conv1x1(torch.autograd.Function):
    """``_conv1x1_p`` (pallas_conv.py:217-248), stride 1 or 2."""

    @staticmethod
    def forward(ctx, x, w, stride):
        xs = x[:, :, ::stride, ::stride] if stride > 1 else x
        xs = xs.contiguous(memory_format=_CL)
        n, _, h, wd = xs.shape
        ctx.save_for_backward(xs, w)
        ctx.stride, ctx.x_shape = stride, x.shape
        return unrows(matmul_rows(rows(xs), w[:, :, 0, 0].t()), n, h, wd)

    @staticmethod
    def backward(ctx, dy):
        xs, w = ctx.saved_tensors
        n, ci, h, wd = xs.shape
        dy2 = rows(dy.contiguous(memory_format=_CL))
        dx = dw = None
        if ctx.needs_input_grad[1]:
            dw = dw_rows(rows(xs), dy2).t()[:, :, None, None].to(w.dtype)
        if ctx.needs_input_grad[0]:
            dxs = unrows(matmul_rows(dy2, w[:, :, 0, 0].to(dy.dtype)),
                         n, h, wd).to(xs.dtype)
            if ctx.stride > 1:
                s = ctx.stride
                dx = torch.empty(ctx.x_shape, dtype=xs.dtype,
                                 device=xs.device, memory_format=_CL)
                dx.zero_()[:, :, ::s, ::s] = dxs
            else:
                dx = dxs
        return dx, dw, None


class _Conv3x3(torch.autograd.Function):
    """``_conv3x3_p`` (pallas_conv.py:251-276)."""

    @staticmethod
    def forward(ctx, x, w):
        x = x.contiguous(memory_format=_CL)
        ctx.save_for_backward(x, w)
        return conv3(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        ci, co = x.shape[1], w.shape[0]
        dy = dy.contiguous(memory_format=_CL)
        dx = dw = None
        if ctx.needs_input_grad[1]:
            dw = dw3(x, dy).reshape(3, 3, ci, co).permute(3, 2, 0, 1)
            dw = dw.to(w.dtype)
        if ctx.needs_input_grad[0]:
            # dX: the SAME conv of dy with the kernel flipped in (ky, kx)
            # and Ci, Co swapped, a (Ci, Co, 3, 3) weight
            wflip = w.flip(2, 3).transpose(0, 1).to(dy.dtype)
            dx = conv3(dy, wflip).to(x.dtype)
        return dx, dw


# --------------------------------------------------------------------------
# public dispatch
# --------------------------------------------------------------------------


def _pick_bm(m: int, c: int, co: int) -> Optional[int]:
    """pallas_conv.py:52-60 verbatim: the TPU row block of a 1x1 conv, or
    None where none fits its VMEM budget. The route takes the 1x1 convs
    the JAX route takes; the Hopper kernels tile otherwise."""
    for bm in (2048, 1024, 512, 256):
        if m % bm:
            continue
        if bm * (c + co) * 4 + c * co * 2 <= (8 << 20):
            return bm
    return None


def _pick_th(h: int, wd: int, ci: int) -> Optional[int]:
    """pallas_conv.py:63-68 verbatim: the TPU band height of a 3x3 conv,
    or None; the route takes the 3x3 convs the JAX route takes."""
    for th in (32, 16, 8):
        if h % th == 0 and th * wd * 9 * ci * 2 <= (4 << 20):
            return th
    return None


def kernels_take(x_shape: Tuple[int, ...], kernel: Tuple[int, int],
                 stride: Tuple[int, int], dilation: Tuple[int, int],
                 co: int) -> bool:
    """Whether the conv kernels take this conv's shape (what
    :func:`conv2d` accepts): 1x1 convs at stride s in both dims with H
    and W multiples of s (SAME then reads x[::s, ::s]), and 3x3 convs at
    stride 1; dilation 1; indices within int32. x_shape is JAX's
    (N, H, W, Ci)."""
    if len(x_shape) != 4 or tuple(dilation) != (1, 1):
        return False
    n, h, wd, ci = x_shape
    if min(n, h, wd, ci, co) < 1:
        return False
    kernel, stride = tuple(kernel), tuple(stride)
    if kernel == (1, 1):
        sh, sw = stride
        if sh != sw or sh < 1 or h % sh or wd % sw:
            return False
        return _indices_fit(n * (h // sh) * (wd // sw), max(ci, co), 1)
    if kernel == (3, 3) and stride == (1, 1):
        return _indices_fit(n * h * wd, max(ci, co), 3)
    return False


def supported(x_shape: Tuple[int, ...], kernel: Tuple[int, int],
              stride: Tuple[int, int], dilation: Tuple[int, int],
              co: int) -> bool:
    """Whether the ``PALLAS_CONVS`` route takes this conv: exactly the
    convs that ``pallas_conv.supported`` (pallas_conv.py:284-301) takes,
    so that the route puts the same convs on the kernels as JAX's (a 1x1
    whose rows ``_pick_bm`` blocks; a 3x3 with W a multiple of 8 and H
    banded by ``_pick_th``), where :func:`kernels_take` the shape too.
    x_shape is JAX's (N, H, W, Ci)."""
    if not kernels_take(x_shape, kernel, stride, dilation, co):
        return False
    n, h, wd, ci = x_shape
    if tuple(kernel) == (1, 1):
        s = stride[0]
        return _pick_bm(n * (h // s) * (wd // s), ci, co) is not None
    return wd % 8 == 0 and _pick_th(h, wd, ci) is not None


def conv2d(x: torch.Tensor, w: torch.Tensor,
           stride: Tuple[int, int] = (1, 1)) -> torch.Tensor:
    """The conv of x (N, Ci, H, W) with w (Co, Ci, k, k), SAME padding,
    differentiable in both (pallas_conv.py:304-321). Raises on a conv that
    the kernels do not take (:func:`kernels_take`), and on activations off
    the CPU that are neither bfloat16 nor float32 (the kernels' types)."""
    k = w.shape[-1]
    n, ci, h, wd = x.shape
    if not kernels_take((n, h, wd, ci), tuple(w.shape[-2:]), stride,
                        (1, 1), w.shape[0]):
        raise ValueError(f"conv2d does not take x {tuple(x.shape)} "
                         f"on {x.device}, w {tuple(w.shape)}, "
                         f"stride {tuple(stride)}")
    if x.device.type != "cpu" and x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"conv2d: the conv kernels take bfloat16 or "
                        f"float32, got {x.dtype} on {x.device}; run the "
                        "model in either or turn PALLAS_CONVS off")
    if k == 1:
        return _Conv1x1.apply(x, w, stride[0])
    return _Conv3x3.apply(x, w)

