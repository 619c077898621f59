"""Unit-fused ghost-BN bottleneck units on hand-written kernels.

Port of ``tensorflow_ocr_tpu/ops/pallas_unit.py``. A stride-1 bottleneck
unit takes its BatchNorm statistics per (image, band of ``gh`` rows)
instead of over the batch (ghost normalization):

    z1 = o·W1;            act1 = relu(z1·a1 + b1)
    z2 = conv3x3(act1);   act2 = relu(z2·a2 + b2)
    z3 = act2·W3;         out  = relu(z3·a3 + b3 + shortcut)

with (a, b) of each BN from the band's [Σz, Σz²] over its own ``gh``
rows (``cnt = gh·W``), taken from z rounded to the activation dtype.
Band j's 3x3 conv reads one row of ``z1`` above and below the band and
normalises those halo rows with band j's own (a1, b1), so no single
``act1`` tensor exists; rows outside the image are zero after the
activation. The backward is exact: ``jax.grad`` of the band-local
reference, seam terms included (pallas_unit.py:318-330, 467-606).

The TPU runs one grid step per (image, band) with the whole band in VMEM
(sites ``_unit_fwd`` :303, ``_unit_bwd`` :677 and :700). Here the same
function is a short sequence of launches over full NHWC tensors with
per-(image, band) tables, in ``csrc/ghost_unit.cu``:

- :func:`conv_fwd`     a 1x1 or 3x3 conv whose operand is staged through
                       relu(x·a + b) with the (a, b) of the OUTPUT pixel's
                       band, and whose epilogue sums the rounded output
                       per band: z1, z2 (halo rows under the reading
                       band's affine), z3 and zs;
- :func:`boundary_fwd` relu(z3·a3 + b3 + sc) per band;
- :func:`boundary_bwd` gm3 = dout·[pre > 0] and its band sums;
- :func:`conv_bwd`     the backward of one conv of the unit: dz =
                       g·a + c1 + 2z·c2 (the band's statistic
                       corrections, plus the seam rows' terms for dz1)
                       staged into dW = act(x)ᵀ·dz and dX = dz ⋆ Wᵀ, the
                       3x3's dX restricted to the band of its output
                       row; dX ends as gm = dX·[x·a + b > 0] with its band
                       sums, or as do;
- :func:`seam_bwd`     the two halo rows of each band's 3x3 backward:
                       their gm1 under the reading band's (a1, b1), added
                       to that band's sums, and passed on to the rows'
                       own band as the seam term of dz1.

CPU tensors take each wrapper's plain version (the ``*_reference``
functions, which emulate the kernels' split and rounding); CUDA tensors
launch the kernel (counted in each wrapper's ``launches``) or raise.
:func:`reference_ghost_unit` is the band-local unit written directly,
differentiable by autograd: its gradient is the exact ghost gradient.

Tensors are NCHW in the channels-last memory format; weights are
(Co, Ci, k, k) in the activation dtype; per-band tables are float32
(N, H/gh, rows, C), band-major, so a band's rows are contiguous.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from tensorflow_ocr_tpu_torch.ops import conv as CV
from tensorflow_ocr_tpu_torch.ops.fused import (
    KERNEL_CHANNELS,
    aligned16,
    cuda_stream,
    full_f32,
    on_cpu,
    raise_on,
    up_f32,
)
from tensorflow_ocr_tpu_torch.ops.kernels import build_library

_CL = torch.channels_last


def pick_gh(h: int, wd: int, ci: int, db: int, co: int,
            proj: bool = False) -> Optional[int]:
    """Band height of a unit (verbatim copy of ``pallas_unit.pick_gh``).

    It decides which pixels share a ghost statistic, so it is part of the
    function computed, VMEM arithmetic included; None means the unit runs
    as a plain Bottleneck.
    """
    # weights + their transposes live in VMEM for the whole sweep
    w_all = (2 * ci * db + 2 * 9 * db * db + 2 * db * co) * 2
    if proj:
        w_all += 2 * ci * co * 2
    for gh in (32, 16, 8):
        if h % gh:
            continue
        act = (gh + 4) * wd * (2 * ci + 2 * db) * 2      # o/do + z1/act1
        # co-sized f32 chain temps stay live through the sweep (measured
        # on-chip: Mosaic's stack allocator barely reuses them): ~3 for
        # the identity unit (z3/gm3/dz3), ~6 with a projection shortcut
        # (plus zs/sc/pre).
        mids = ((gh + 2) * wd * co * 4 * (6 if proj else 3)
                + (gh + 2) * wd * db * 4 * 2)
        if act * 2 + mids + w_all <= (12 << 20):
            return gh
    return None


# --------------------------------------------------------------------------
# band math (pallas_unit.py:60-109)
# --------------------------------------------------------------------------


def band_sums(u: torch.Tensor, v: torch.Tensor, gh: int) -> torch.Tensor:
    """(N, C, H, W) u and v -> (N, H/gh, 2, C) [Σu, Σv] over each band's
    rows."""
    n, c, h, w = u.shape
    s = torch.stack([u.reshape(n, c, h // gh, gh * w).sum(3),
                     v.reshape(n, c, h // gh, gh * w).sum(3)], 2)
    return s.permute(0, 3, 2, 1)


def band_stats(z: torch.Tensor, gh: int) -> torch.Tensor:
    """(N, H/gh, 2, C) float32 [Σz, Σz²] over each band's rows
    (``_band_stats``)."""
    zf = up_f32(z)
    return band_sums(zf, zf * zf, gh)


def affine_of(stats: torch.Tensor, gb: torch.Tensor, cnt: float,
              eps: float) -> torch.Tensor:
    """[a, b] with bn(z) = z·a + b from [Σz, Σz²] over ``cnt`` values and
    gb = [γ, β] (``_affine_of``); stats (..., 2, C) -> (..., 2, C)."""
    mu = stats[..., 0, :] / cnt
    var = torch.clamp(stats[..., 1, :] / cnt - mu * mu, min=0.0)
    a = gb[0] * torch.rsqrt(var + eps)
    return torch.stack([a, gb[1] - mu * a], -2)


def stat_corr(dab: torch.Tensor, stats: torch.Tensor, gb: torch.Tensor,
              cnt: float, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradient from (a, b) back into the band statistics
    (``_stat_corr``): dab = [Σ gm·z, Σ gm] -> ([c1, c2] so that dz +=
    c1 + 2z·c2, [dγ, dβ]); all (..., 2, C)."""
    mu = stats[..., 0, :] / cnt
    var = torch.clamp(stats[..., 1, :] / cnt - mu * mu, min=0.0)
    r = torch.rsqrt(var + eps)
    da, db = dab[..., 0, :], dab[..., 1, :]
    dvar = -0.5 * gb[0] * r * r * r * (da - mu * db)
    dmu = -gb[0] * r * db
    corr = torch.stack([(dmu - 2.0 * mu * dvar) / cnt, dvar / cnt], -2)
    return corr, torch.stack([r * (da - mu * db), db], -2)


def _rows(tab: torch.Tensor, k: int, gh: int) -> torch.Tensor:
    """Row k of an (N, nb, rows, C) band table, broadcast over the
    (N, C, H, W) pixels of each band."""
    return tab[:, :, k, :].permute(0, 2, 1).repeat_interleave(gh, 2)[..., None]


def _halo_bands(t: torch.Tensor, gh: int) -> torch.Tensor:
    """(N, C, H, W) -> (N·nb, C, gh+2, W): each band with the row above
    and below it (zero rows outside the image)."""
    n, c, h, w = t.shape
    nb = h // gh
    idx = (torch.arange(nb)[:, None] * gh
           + torch.arange(gh + 2)[None, :]).flatten().to(t.device)
    tp = F.pad(t, (0, 0, 1, 1))
    out = tp.index_select(2, idx).reshape(n, c, nb, gh + 2, w)
    return out.permute(0, 2, 1, 3, 4).reshape(n * nb, c, gh + 2, w)


def _bands(t: torch.Tensor, gh: int) -> torch.Tensor:
    """(N, C, H, W) -> (N·nb, C, gh, W)."""
    n, c, h, w = t.shape
    return t.reshape(n, c, h // gh, gh, w).permute(0, 2, 1, 3, 4).reshape(
        -1, c, gh, w)


def _unbands(t: torch.Tensor, n: int) -> torch.Tensor:
    """(N·nb, C, rows, W) -> (N, C, nb·rows, W) channels-last."""
    nnb, c, rows, w = t.shape
    nb = nnb // n
    out = t.reshape(n, nb, c, rows, w).permute(0, 2, 1, 3, 4).reshape(
        n, c, nb * rows, w)
    return out.contiguous(memory_format=_CL)


def _edge_mask(n: int, nb: int, gh: int, device) -> torch.Tensor:
    """(N·nb, 1, gh+2, 1): 0 on the halo rows that lie outside the image
    (the first band's top, the last band's bottom), else 1."""
    m = torch.ones(nb, gh + 2, device=device)
    m[0, 0] = 0.0
    m[nb - 1, gh + 1] = 0.0
    return m.repeat(n, 1)[:, None, :, None]


def _total(s: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Per-band sums (..., bands, 2, C) -> the global (2, C)."""
    return None if s is None else s.sum((0, 1))


def _conv(x: torch.Tensor, w: torch.Tensor, padding) -> torch.Tensor:
    """conv2d with float32 products (TF32 off)."""
    with full_f32():
        return F.conv2d(up_f32(x), up_f32(w), padding=padding)


# --------------------------------------------------------------------------
# the band-local unit (pallas_unit.py:124-182)
# --------------------------------------------------------------------------


def reference_ghost_unit(o, w1, gb1, w2, gb2, w3, gb3, ws, gbs, gh: int,
                         eps: float = 1e-5):
    """The ghost-BN unit band by band, in plain PyTorch. o (N, Ci, H, W);
    w1 (db, Ci, 1, 1), w2 (db, db, 3, 3), w3 (Co, db, 1, 1), ws
    (Co, Ci, 1, 1) or None for the identity shortcut; gb* (2, C) [γ, β].
    Returns (out, s1, s2, s3, ss) with s* the global [Σz, Σz²] (2, C) of
    each BN (ss None for identity). Differentiable: autograd of this is
    the exact ghost gradient, seam terms included."""
    n, _, h, wd = o.shape
    nb, dt = h // gh, o.dtype
    cnt = float(gh * wd)
    oh = _halo_bands(o, gh)                         # (N·nb, Ci, gh+2, W)
    z1 = _conv(oh, w1, 0).to(dt)
    s1 = band_stats(z1[:, :, 1:gh + 1], gh)          # (N·nb, 1, 2, db)
    t1 = affine_of(s1, gb1, cnt, eps)[:, 0]          # (N·nb, 2, db)
    act1 = torch.relu(up_f32(z1) * t1[:, 0, :, None, None]
                      + t1[:, 1, :, None, None])
    act1 = (act1 * _edge_mask(n, nb, gh, o.device)).to(dt)
    z2 = _conv(act1, w2, (0, 1)).to(dt)              # (N·nb, db, gh, W)
    s2 = band_stats(z2, gh)
    t2 = affine_of(s2, gb2, cnt, eps)[:, 0]
    act2 = torch.relu(up_f32(z2) * t2[:, 0, :, None, None]
                      + t2[:, 1, :, None, None]).to(dt)
    z3 = _conv(act2, w3, 0).to(dt)
    s3 = band_stats(z3, gh)
    t3 = affine_of(s3, gb3, cnt, eps)[:, 0]
    oc = oh[:, :, 1:gh + 1]
    if ws is not None:
        zs = _conv(oc, ws, 0).to(dt)
        ss = band_stats(zs, gh)
        tss = affine_of(ss, gbs, cnt, eps)[:, 0]
        sc = up_f32(zs) * tss[:, 0, :, None, None] + tss[:, 1, :, None, None]
    else:
        ss, sc = None, up_f32(oc)
    out = torch.relu(up_f32(z3) * t3[:, 0, :, None, None]
                     + t3[:, 1, :, None, None] + sc).to(dt)
    return (_unbands(out, n), _total(s1), _total(s2), _total(s3),
            _total(ss))


# --------------------------------------------------------------------------
# the kernels' plain versions (the split of csrc/ghost_unit.cu)
# --------------------------------------------------------------------------


def _act(x: torch.Tensor, tab: Optional[torch.Tensor], gh: int
         ) -> torch.Tensor:
    """relu(x·a + b) with each pixel's own band's (a, b), rounded to x's
    dtype; x itself where tab is None."""
    if tab is None:
        return x
    return torch.relu(up_f32(x) * _rows(tab, 0, gh)
                      + _rows(tab, 1, gh)).to(x.dtype)


def _act_halo(x: torch.Tensor, tab: Optional[torch.Tensor], gh: int
              ) -> torch.Tensor:
    """(N·nb, C, gh+2, W): each band and its halo rows through the band's
    own (a, b), zero outside the image, rounded to x's dtype."""
    n, c, h, w = x.shape
    xb = _halo_bands(x, gh)
    if tab is None:
        return xb
    t = tab.reshape(-1, 2, c)
    act = torch.relu(up_f32(xb) * t[:, 0, :, None, None]
                     + t[:, 1, :, None, None])
    return (act * _edge_mask(n, h // gh, gh, x.device)).to(x.dtype)


def conv_fwd_reference(x, tab, w, gh):
    """Plain version of :func:`conv_fwd`."""
    n, k = x.shape[0], w.shape[-1]
    if k == 1:
        y = _conv(_act(x, tab, gh), w, 0)
    else:
        y = _unbands(_conv(_act_halo(x, tab, gh), w, (0, 1)), n)
    y = y.to(x.dtype).contiguous(memory_format=_CL)
    return y, band_stats(y, gh).contiguous()


def boundary_fwd_reference(z, tab, sc, tabs, gh):
    """Plain version of :func:`boundary_fwd`."""
    return torch.relu(_pre(z, tab, sc, tabs, gh)).to(z.dtype).contiguous(
        memory_format=_CL)


def _pre(z, tab, sc, tabs, gh):
    """z·a + b + (sc·as + bs, or sc for the identity shortcut), float32,
    in the TPU kernel's order (pallas_unit.py:223-227)."""
    s = up_f32(sc)
    if tabs is not None:
        s = s * _rows(tabs, 0, gh) + _rows(tabs, 1, gh)
    return up_f32(z) * _rows(tab, 0, gh) + _rows(tab, 1, gh) + s


def boundary_bwd_reference(dout, z, tab, sc, tabs, gh):
    """Plain version of :func:`boundary_bwd`."""
    gm = up_f32(dout) * (_pre(z, tab, sc, tabs, gh) > 0)
    s = band_sums(gm * up_f32(z), gm, gh)
    third = band_sums(gm * up_f32(sc), gm, gh)[:, :, :1]
    return (gm.to(z.dtype).contiguous(memory_format=_CL),
            torch.cat([s, third], 2).contiguous())


def _dz(g, z, td, gh, edge=None):
    """dz = g·a + c1 + 2z·c2 (+ the seam term on a band's first and last
    rows) in float32, rounded to z's dtype; td (N, nb, 3, C) [a, c1, c2],
    edge (N, nb, 2, W, C)."""
    dz = (up_f32(g) * _rows(td, 0, gh) + _rows(td, 1, gh)
          + 2.0 * up_f32(z) * _rows(td, 2, gh))
    if edge is not None:
        n, nb, _, w, c = edge.shape
        e = torch.zeros(n, nb, gh, w, c, dtype=edge.dtype,
                        device=edge.device)
        e[:, :, 0] = edge[:, :, 0]
        e[:, :, gh - 1] = edge[:, :, 1]
        dz = dz + e.reshape(n, nb * gh, w, c).permute(0, 3, 1, 2)
    return dz.to(z.dtype)


def conv_bwd_reference(x, tx, g, z, td, w, gh, edge=None, addend=None,
                       out: str = "gm"):
    """Plain version of :func:`conv_bwd`."""
    n, k = x.shape[0], w.shape[-1]
    dz = _dz(g, z, td, gh, edge)
    with full_f32():
        if k == 1:
            xa, dzf = up_f32(_act(x, tx, gh)), up_f32(dz)
            dw = torch.nn.grad.conv2d_weight(xa, w.shape, dzf)
            gx = torch.nn.grad.conv2d_input(x.shape, up_f32(w), dzf)
        else:
            xb, dzb = up_f32(_act_halo(x, tx, gh)), up_f32(_bands(dz, gh))
            dw = torch.nn.grad.conv2d_weight(xb, w.shape, dzb, padding=(0, 1))
            gxb = torch.nn.grad.conv2d_input(xb.shape, up_f32(w), dzb,
                                             padding=(0, 1))
            gx = _unbands(gxb[:, :, 1:gh + 1], n)  # own band's rows only
    if out == "gm":
        xf = up_f32(x)
        gm = gx * (xf * _rows(tx, 0, gh) + _rows(tx, 1, gh) > 0)
        return (gm.contiguous(memory_format=_CL),
                band_sums(gm * xf, gm, gh).contiguous(), dw)
    if addend is not None:
        gx = gx + up_f32(addend)
    dtype = torch.float32 if out == "f32" else x.dtype
    return gx.to(dtype).contiguous(memory_format=_CL), None, dw


def seam_terms(g, z, td, x, tx, w, gh):
    """The seam's gm at band j's halo row above and below it, each
    (N·nb, C, W), the rows' x_q, and band j's a1 (N·nb, C, 1): gm is zero
    where the halo row lies outside the image."""
    n, c, h, wd = x.shape
    nb = h // gh
    dzb = up_f32(_bands(_dz(g, z, td, gh), gh))
    with full_f32():
        gxb = torch.nn.grad.conv2d_input((n * nb, c, gh + 2, wd),
                                         up_f32(w), dzb, padding=(0, 1))
    xh = up_f32(_halo_bands(x, gh))
    t = tx.reshape(n * nb, 2, c)
    a, b = t[:, 0, :, None], t[:, 1, :, None]
    live = _edge_mask(n, nb, gh, x.device)   # (N·nb, 1, gh+2, 1)
    xs = [xh[:, :, 0], xh[:, :, gh + 1]]     # the halo row above, below
    gms = [gxb[:, :, row] * (xr * a + b > 0) * live[:, :, row]
           for row, xr in zip((0, gh + 1), xs)]
    return gms, xs, a


def seam_bwd_reference(g, z, td, x, tx, w, gh):
    """Plain version of :func:`seam_bwd`."""
    n, c, h, wd = x.shape
    nb = h // gh
    gms, xs, a = seam_terms(g, z, td, x, tx, w, gh)
    sums = torch.stack([gms[0] * xs[0] + gms[1] * xs[1],
                        gms[0] + gms[1]], 1).sum(3)       # (N·nb, 2, C)
    # a halo row is the last row of the band above, the first of the one
    # below: its term goes there, times the reading band's a1
    top = (gms[0] * a).reshape(n, nb, c, wd).permute(0, 1, 3, 2)
    bot = (gms[1] * a).reshape(n, nb, c, wd).permute(0, 1, 3, 2)
    edge = torch.zeros(n, nb, 2, wd, c, dtype=top.dtype, device=x.device)
    edge[:, :-1, 1] = top[:, 1:]
    edge[:, 1:, 0] = bot[:, :-1]
    return edge, sums.reshape(n, nb, 2, c).contiguous()


# --------------------------------------------------------------------------
# the kernels' wrappers
# --------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int


# the extern "C" entry points of csrc/ghost_unit.cu: argument types
SIGNATURES = {
    "ghost_conv_fwd": [_P] * 6 + [_I] * 14 + [_P],
    "ghost_conv_bwd": [_P] * 13 + [_I] * 24 + [_P],
    "ghost_boundary": [_P] * 7 + [_I] * 5 + [_P],
    "ghost_seam_bwd": [_P] * 9 + [_I] * 9 + [_P]}


@functools.cache
def _lib():
    lib = ctypes.CDLL(str(build_library("ghost_unit")))
    for fn, args in SIGNATURES.items():
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


# tensors that are float32 tables (per band, or the seam terms), and the
# activations that may be float32 as well as bfloat16
_TABLES = ("tab", "tabs", "tx", "td", "edge")
_F32_OK = ("g", "addend")


def _check(ref: torch.Tensor, gh: int, **tensors) -> None:
    """Activations channels-last bfloat16 (g and addend also float32)
    with channels a multiple of KERNEL_CHANNELS at ref's N, H, W; tables
    contiguous float32; all on ref's CUDA device; H a multiple of gh.
    Raises on anything else."""
    if ref.device.type != "cuda":
        raise ValueError(f"tensors on {ref.device}: the kernels need a "
                         "CUDA device (or every tensor on the CPU)")
    n, c, h, w = ref.shape
    if gh < 2 or h % gh:
        raise ValueError(f"H={h} is not a multiple of the band height {gh}")
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device != ref.device:
            raise ValueError(f"{name} on {t.device}, expected {ref.device}")
        ok = ((torch.float32,) if name in _TABLES else
              (torch.bfloat16, torch.float32) if name in _F32_OK else
              (torch.bfloat16,))
        if t.dtype not in ok:
            raise TypeError(f"{name}: the kernels take {ok}, got {t.dtype}")
        if name not in _TABLES:
            if not t.is_contiguous(memory_format=_CL):
                raise ValueError(f"{name} must be channels-last contiguous")
            if t.shape[1] % KERNEL_CHANNELS or t.shape[0] != n \
                    or t.shape[2:] != (h, w):
                raise ValueError(f"{name} {tuple(t.shape)}: need channels a "
                                 f"multiple of {KERNEL_CHANNELS} at "
                                 f"{n}x{h}x{w}")
            if t.numel() * 9 >= 2 ** 31:
                raise ValueError("shape overflows the kernel's int32 indices")
        elif not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _table(t, n, nb, rows, c, name):
    if t is not None and tuple(t.shape) != (n, nb, rows, c):
        raise ValueError(f"{name} {tuple(t.shape)}, need {(n, nb, rows, c)}")


def conv_fwd(x: torch.Tensor, tab: Optional[torch.Tensor], w: torch.Tensor,
             gh: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """y = conv_k(act(x), w), stride 1, SAME, with act(x) = relu(x·a + b)
    under the (a, b) of the OUTPUT pixel's band (tab (N, nb, 2, Ci); None:
    x as it is), zero outside the image; k in (1, 3). Returns y in x's
    dtype and the per-band [Σy, Σy²] of the rounded y, (N, nb, 2, Co).
    One launch on csrc/conv_bwd.cuh's ``tdx`` in its forward mode (tiled
    by ops/conv.py tma_staged_fwd_plan, each tile in one band, x put
    through the band's affine on its way from shared memory into the
    product) and one that adds each band's entries in order: no atomics,
    so two calls on the same inputs are bit-equal."""
    if on_cpu(x, tab, w):
        return conv_fwd_reference(x, tab, w, gh)
    n, ci, h, wd = x.shape
    co, k = w.shape[0], w.shape[-1]
    _check(x, gh, x=x, tab=tab)
    _table(tab, n, h // gh, 2, ci, "tab")
    if w.dtype != torch.bfloat16 or w.device != x.device or k not in (1, 3) \
            or co % KERNEL_CHANNELS or w.shape[1] != ci:
        raise ValueError(f"w {tuple(w.shape)} {w.dtype}: need bfloat16 "
                         f"(Co, {ci}, k, k), k in (1, 3), Co a multiple of "
                         f"{KERNEL_CHANNELS}, on {x.device}")
    wt = w.permute(0, 2, 3, 1).reshape(co, k * k * ci).contiguous()
    aligned16(x=x, tab=tab)
    index = x.device.index
    p = CV.tma_staged_fwd_plan(n, h, wd, ci, co, k, CV._sms(index), gh)
    y = torch.empty((n, co, h, wd), dtype=x.dtype, device=x.device,
                    memory_format=_CL)
    # the band sums and the tiles' entries in one buffer, both written
    # whole
    nbs = n * (h // gh) * 2 * co
    buf = torch.empty(nbs + p.row_tiles * 2 * co, dtype=torch.float32,
                      device=x.device)
    s, ws = buf[:nbs].view(n, h // gh, 2, co), buf[nbs:]
    with CV._on_device(index):
        err = _lib().ghost_conv_fwd(
            x.data_ptr(), _ptr(tab), wt.data_ptr(), y.data_ptr(),
            s.data_ptr(), ws.data_ptr(), n, h, wd, ci, co, k, gh, p.wb,
            p.hb, p.bn, int(p.resident), p.stages, p.grid, p.eslots,
            torch._C._cuda_getCurrentRawStream(index))
    raise_on(err, "ghost_conv_fwd")
    conv_fwd.launches += 1
    return y, s


def boundary_fwd(z, tab, sc, tabs, gh):
    """relu(z·a3 + b3 + (sc·as + bs, or sc where tabs is None)) with each
    pixel's band's tables (N, nb, 2, C); out in z's dtype."""
    if on_cpu(z, tab, sc, tabs):
        return boundary_fwd_reference(z, tab, sc, tabs, gh)
    return _boundary(None, z, tab, sc, tabs, gh)


def boundary_bwd(dout, z, tab, sc, tabs, gh):
    """gm = dout·[pre > 0] in z's dtype (exact: dout or 0) and its band
    sums (N, nb, 3, C) [Σ gm·z, Σ gm, Σ gm·sc] (the last one used by the
    projection shortcut only)."""
    if on_cpu(dout, z, tab, sc, tabs):
        return boundary_bwd_reference(dout, z, tab, sc, tabs, gh)
    dout = dout.contiguous(memory_format=_CL)
    return _boundary(dout, z, tab, sc, tabs, gh)


def _boundary(dout, z, tab, sc, tabs, gh):
    n, c, h, wd = z.shape
    nb = h // gh
    _check(z, gh, dout=dout, z=z, sc=sc, tab=tab, tabs=tabs)
    _table(tab, n, nb, 2, c, "tab")
    _table(tabs, n, nb, 2, c, "tabs")
    if sc.shape != z.shape:
        raise ValueError(f"sc {tuple(sc.shape)} vs z {tuple(z.shape)}")
    out = torch.empty_like(z, memory_format=_CL)
    sums = (None if dout is None else
            torch.zeros((n, nb, 3, c), dtype=torch.float32, device=z.device))
    with torch.cuda.device(z.device):
        err = _lib().ghost_boundary(
            _ptr(dout), z.data_ptr(), tab.data_ptr(), sc.data_ptr(),
            _ptr(tabs), out.data_ptr(), _ptr(sums), n, h, wd, c, gh,
            cuda_stream())
    raise_on(err, "ghost_boundary")
    if dout is None:
        boundary_fwd.launches += 1
        return out
    boundary_bwd.launches += 1
    return out, sums


_OUT = {"gm": 0, "act": 1, "f32": 2}


def conv_bwd(x, tx, g, z, td, w, gh, edge=None, addend=None,
             out: str = "gm"):
    """The backward of one conv y = conv_k(act(x), w) of the unit, from
    the band-corrected output gradient dz = g·a + c1 + 2z·c2 (td
    (N, nb, 3, Co) [a, c1, c2] of each band; ``edge`` (N, nb, 2, W, Co)
    added on each band's first and last rows), rounded to z's dtype.

    Returns (dx, sums, dw): dw = act(x)ᵀ·dz in float32 in w's shape; the
    3x3's dX takes only the dz rows of its output row's band. ``out``:
    "gm": dx = dX·[x·a + b > 0] in float32 (tx's (a, b)) and sums
    (N, nb, 2, Ci) [Σ dx·x, Σ dx]; "act": dx = dX + addend in x's dtype,
    "f32": in float32 (sums None). Two launches on csrc/conv_bwd.cuh: dW
    (``tdw``, split over the pixels by ops/conv.py tma_dw_plan and summed
    in a fixed order), then dX (``tdx``, tiled by tma_bwd_dx_plan, its band
    sums one entry a tile, added in tile order); no atomics, so two calls
    on the same inputs are bit-equal. Each kernel's launches are counted
    in ``conv_bwd.by_kernel``.
    """
    if on_cpu(x, tx, g, z, td, w, edge, addend):
        return conv_bwd_reference(x, tx, g, z, td, w, gh, edge, addend, out)
    n, ci, h, wd = x.shape
    nb = h // gh
    co, k = w.shape[0], w.shape[-1]
    _check(x, gh, x=x, g=g, z=z, addend=addend, tx=tx, td=td, edge=edge)
    _table(tx, n, nb, 2, ci, "tx")
    _table(td, n, nb, 3, co, "td")
    if edge is not None and tuple(edge.shape) != (n, nb, 2, wd, co):
        raise ValueError(f"edge {tuple(edge.shape)}")
    if out == "gm" and tx is None:
        raise ValueError("out='gm' needs the (a, b) table tx")
    if w.dtype != torch.bfloat16 or w.device != x.device or k not in (1, 3) \
            or w.shape[1] != ci or g.shape[1] != co or z.shape[1] != co:
        raise ValueError(f"w {tuple(w.shape)} {w.dtype} does not fit x, g, z")
    if k == 3 and g.dtype != torch.float32:
        raise TypeError("the 3x3's backward takes a float32 g")
    wflip = w.flip(2, 3).permute(1, 2, 3, 0).reshape(ci, k * k * co)
    wflip = wflip.contiguous()
    aligned16(x=x, tx=tx, g=g, z=z, td=td, edge=edge, addend=addend)
    index = x.device.index
    sms, aux = CV._sms(index), g.element_size()
    pw = CV.tma_dw_plan(n, h, wd, ci, co, k, sms, aux=aux)
    px = CV.tma_bwd_dx_plan(n, h, wd, ci, co, k, sms, aux, out != "f32", gh)
    # dW, the clusters' tables and the band sums' entries (one a row tile)
    # in one buffer: the wrapper's host time is of the order of a small
    # shape's device time
    kdim, tables = k * k * ci * co, pw.splits // pw.cluster
    parts = px.row_tiles * 2 * ci if out == "gm" else 0
    ws_dw = kdim * tables if tables > 1 else 0
    buf = torch.empty(kdim + ws_dw + parts, dtype=torch.float32,
                      device=x.device)
    dw = buf[:kdim]
    dx = torch.empty((n, ci, h, wd), device=x.device, memory_format=_CL,
                     dtype=x.dtype if out == "act" else torch.float32)
    sums = (torch.empty((n, nb, 2, ci), dtype=torch.float32, device=x.device)
            if out == "gm" else None)
    add_kind = 0 if addend is None else (
        2 if addend.dtype == torch.float32 else 1)
    with torch.cuda.device(x.device):
        err = _lib().ghost_conv_bwd(
            x.data_ptr(), _ptr(tx), g.data_ptr(), z.data_ptr(),
            td.data_ptr(), _ptr(edge), wflip.data_ptr(), dx.data_ptr(),
            _ptr(sums), dw.data_ptr(), _ptr(addend),
            buf[kdim:].data_ptr() if ws_dw else None,
            buf[kdim + ws_dw:].data_ptr() if parts else None,
            int(g.dtype == torch.float32), add_kind, _OUT[out], n, h, wd,
            ci, co, k, gh, pw.wb, pw.hb, pw.bn, int(pw.two), pw.stages,
            pw.splits, pw.cluster, px.wb, px.hb, px.bn, int(px.resident),
            px.stages, px.grid, px.eslots,
            torch._C._cuda_getCurrentRawStream(index))
    raise_on(err, "ghost_conv_bwd")
    conv_bwd.launches += 1
    for kernel in conv_bwd.by_kernel:
        conv_bwd.by_kernel[kernel] += 1
    dw = dw.view(k, k, ci, co).permute(3, 2, 0, 1).contiguous()
    return dx, sums, dw


class SeamPlan(NamedTuple):
    """The tiling of the seam pass (csrc/ghost_unit.cu tseam)."""
    ct: int         # columns a tile: 64 (two segments a tile, one a
                    # warpgroup) or 128 (one segment, 64 columns a
                    # warpgroup)
    segs: int       # 64-pixel segments of a seam row
    count: int      # segments of one side: n * nb * segs
    tiles: int      # tiles of one (side, column tile) group
    groups: int     # 2 sides x c / ct column tiles
    resident: bool  # the ky row's weight boxes loaded once a CTA
    stages: int     # slots of the TMA ring
    grid: int       # persistent CTAs, a multiple of groups
    smem: int       # dynamic shared memory, bytes

    @property
    def nseg(self) -> int:
        return 2 if self.ct == 64 else 1

    def tiles_of(self, cta: int) -> Tuple[int, int, range]:
        """(side, column tile, tiles) of CTA ``cta``: the group cta %
        groups, a contiguous share of its tiles."""
        gid, me = cta % self.groups, cta // self.groups
        ctas = self.grid // self.groups
        cols = self.groups // 2
        return (gid // cols, gid % cols,
                range(me * self.tiles // ctas,
                      (me + 1) * self.tiles // ctas))


# the seam kernel's shared memory (csrc/ghost_unit.cu namespace seam)
SEAM_SEG = 64                     # pixels a segment
SEAM_HBOX = 9216                  # a segment's 66-pixel bf16 halo box
SEAM_GBOX = 66 * 256              # its f32 g box
SEAM_OUT = SEAM_SEG * 64 * 4      # a warpgroup's f32 output (x_q in)
SEAM_RED = 8 * 2 * 64 * 4         # the warps' column sums
SEAM_MAX_STAGES = 4


def seam_smem(nseg: int, ct: int, cb: int, resident: bool,
              stages: int) -> int:
    """Bytes of tseam's dynamic shared memory, as run_seam counts them:
    the ring, the resident weight, one epilogue slot (x_q in, gm*a1 out),
    the warps' sums and the barriers."""
    stage = (CV.round1k(nseg * (SEAM_HBOX + SEAM_GBOX))
             + (0 if resident else 3 * ct * 128))
    return (stages * stage + resident * 3 * cb * ct * 128
            + 2 * SEAM_OUT + SEAM_RED + 8 * (2 * stages + 3) + 1024)


@functools.lru_cache(maxsize=None)
def seam_plan(n: int, h: int, w: int, c: int, gh: int, sms: int) -> SeamPlan:
    """The seam pass's tiling: two sides (the slot written: a band's first
    or last row), each row of a side cut into 64-pixel segments, a tile one
    or two of them by ``ct`` columns; the flipped kernel's ky row resident
    where it fits beside a ring of 2, else streamed with each K step; as
    many ring slots as fit (up to 4) beside the one epilogue slot; the grid the SM count rounded down to a
    multiple of the groups (side, column tile), each CTA a contiguous
    share of one group's tiles. c a multiple of 64."""
    nb, cb = h // gh, c // 64
    ct = 128 if c % 128 == 0 else 64
    nseg = 2 if ct == 64 else 1
    segs = -(-w // SEAM_SEG)
    count = n * nb * segs
    tiles = -(-count // nseg)
    groups = 2 * (c // ct)
    resident = seam_smem(nseg, ct, cb, True, 2) <= CV.MAX_SMEM
    stages = max(st for st in range(2, SEAM_MAX_STAGES + 1)
                 if seam_smem(nseg, ct, cb, resident, st) <= CV.MAX_SMEM)
    grid = min(groups * tiles, max(sms, groups))
    grid -= grid % groups
    return SeamPlan(ct, segs, count, tiles, groups, resident, stages, grid,
                    seam_smem(nseg, ct, cb, resident, stages))


def seam_bwd(g, z, td, x, tx, w, gh):
    """The halo rows of each band's 3x3 backward (pallas_unit.py:557-598).
    g, z: gm2 and z2; td (N, nb, 3, C) [a2, c12, c22]; x: z1; tx
    (N, nb, 2, C) [a1, b1]; w: the 3x3 weight. For band j's halo row q
    (above and below it), gm = (dz2 of band j's edge row ⋆ Wᵀ at q)·
    [x_q·a1_j + b1_j > 0]. Returns the seam terms gm·a1_j at the rows'
    own bands, (N, nb, 2, W, C) (slot 0: a band's first row, 1: its last),
    and band j's sums (N, nb, 2, C) [Σ gm·x_q, Σ gm]. One launch of
    csrc/ghost_unit.cu's tseam (TMA, wgmma; tiled by :func:`seam_plan`,
    every slot written, the unread ones 0) and one that adds each band's
    entries in order: no atomics, so two calls on the same inputs are
    bit-equal."""
    if on_cpu(g, z, td, x, tx, w):
        return seam_bwd_reference(g, z, td, x, tx, w, gh)
    n, c, h, wd = x.shape
    nb = h // gh
    _check(x, gh, g=g, z=z, x=x, td=td, tx=tx)
    _table(td, n, nb, 3, c, "td")
    _table(tx, n, nb, 2, c, "tx")
    if tuple(w.shape) != (c, c, 3, 3) or w.dtype != torch.bfloat16 \
            or w.device != x.device:
        raise ValueError(f"w {tuple(w.shape)} {w.dtype}: need bfloat16 "
                         f"({c}, {c}, 3, 3) on {x.device}")
    if g.dtype != torch.float32:
        raise TypeError("the seam pass takes a float32 g")
    # the kernel as (Ci, 9·Co), K-major: the kernel reads its taps flipped
    wt = w.permute(1, 2, 3, 0).reshape(c, 9 * c).contiguous()
    aligned16(g=g, z=z, td=td, x=x, tx=tx)
    index = x.device.index
    p = seam_plan(n, h, wd, c, gh, CV._sms(index))
    # edge, the band sums and the segments' entries in one buffer, each
    # written whole: no memset
    ne, ns = n * nb * 2 * wd * c, n * nb * 2 * c
    buf = torch.empty(ne + ns + 2 * p.count * 2 * c, dtype=torch.float32,
                      device=x.device)
    edge = buf[:ne].view(n, nb, 2, wd, c)
    sums = buf[ne:ne + ns].view(n, nb, 2, c)
    base = buf.data_ptr()
    with CV._on_device(index):
        err = _lib().ghost_seam_bwd(
            g.data_ptr(), z.data_ptr(), td.data_ptr(), x.data_ptr(),
            tx.data_ptr(), wt.data_ptr(), base, base + 4 * ne,
            base + 4 * (ne + ns), n, h, wd, c, gh,
            p.ct, int(p.resident), p.stages, p.grid,
            torch._C._cuda_getCurrentRawStream(index))
    raise_on(err, "ghost_seam_bwd")
    seam_bwd.launches += 1
    return edge, sums


for _fn in (conv_fwd, conv_bwd, boundary_fwd, boundary_bwd, seam_bwd):
    _fn.launches = 0
# the conv backward's two kernels (csrc/conv_bwd.cuh): dW and dX
conv_bwd.by_kernel = {"tdw": 0, "tdx": 0}


# --------------------------------------------------------------------------
# the unit: forward and exact backward over the wrappers
# --------------------------------------------------------------------------


def _unit_forward(o, w1, gb1, w2, gb2, w3, gb3, ws, gbs, gh, eps):
    cnt = float(gh * o.shape[-1])
    z1, b1 = conv_fwd(o, None, w1, gh)
    t1 = affine_of(b1, gb1, cnt, eps)
    z2, b2 = conv_fwd(z1, t1, w2, gh)
    t2 = affine_of(b2, gb2, cnt, eps)
    z3, b3 = conv_fwd(z2, t2, w3, gh)
    t3 = affine_of(b3, gb3, cnt, eps)
    if ws is not None:
        zs, bs = conv_fwd(o, None, ws, gh)
        ts = affine_of(bs, gbs, cnt, eps)
    else:
        zs, bs, ts = o, None, None
    out = boundary_fwd(z3, t3, zs, ts, gh)
    saved = (o, z1, z2, z3, zs, b1, b2, b3, bs, t1, t2, t3, ts)
    return (out, _total(b1), _total(b2), _total(b3), _total(bs)), saved


def _unit_backward(dout, saved, w1, gb1, w2, gb2, w3, gb3, ws, gbs, gh,
                   eps):
    """The exact backward, in primal order: (do, dw1, dgb1, dw2, dgb2,
    dw3, dgb3, dws, dgbs) (the last two None for identity)."""
    o, z1, z2, z3, zs, b1, b2, b3, bs, t1, t2, t3, ts = saved
    cnt = float(gh * o.shape[-1])
    proj = ws is not None

    def corr(dab, stats, gb, t):
        c, dgb = stat_corr(dab, stats, gb, cnt, eps)
        return torch.cat([t[:, :, :1], c], 2).contiguous(), dgb.sum((0, 1))

    gm3, s3 = boundary_bwd(dout, z3, t3, zs, ts, gh)
    td3, dgb3 = corr(s3[:, :, :2], b3, gb3, t3)
    gm2, s2, dw3 = conv_bwd(z2, t2, gm3, z3, td3, w3, gh)
    td2, dgb2 = corr(s2, b2, gb2, t2)
    gm1, s1, dw2 = conv_bwd(z1, t1, gm2, z2, td2, w2, gh)
    edge, s1_seam = seam_bwd(gm2, z2, td2, z1, t1, w2, gh)
    td1, dgb1 = corr(s1 + s1_seam, b1, gb1, t1)
    dws = dgbs = None
    if proj:
        tds, dgbs = corr(s3[:, :, [2, 1]], bs, gbs, ts)
        addend, _, dws = conv_bwd(o, None, gm3, zs, tds, ws, gh, out="f32")
        dws = dws.to(ws.dtype)
    else:
        addend = gm3
    do, _, dw1 = conv_bwd(o, None, gm1, z1, td1, w1, gh, edge=edge,
                          addend=addend, out="act")
    return (do, dw1.to(w1.dtype), dgb1, dw2.to(w2.dtype), dgb2,
            dw3.to(w3.dtype), dgb3, dws, dgbs)


class _GhostUnitId(torch.autograd.Function):
    @staticmethod
    def forward(ctx, o, w1, gb1, w2, gb2, w3, gb3, gh, eps):
        outs, saved = _unit_forward(o, w1, gb1, w2, gb2, w3, gb3, None,
                                    None, gh, eps)
        ctx.save_for_backward(w1, gb1, w2, gb2, w3, gb3, *saved[:9])
        ctx.tables, ctx.gh, ctx.eps = saved[9:], gh, eps
        ctx.mark_non_differentiable(*outs[1:4])
        return outs[:4]

    @staticmethod
    def backward(ctx, dout, *_):
        w1, gb1, w2, gb2, w3, gb3, *saved = ctx.saved_tensors
        grads = _unit_backward(dout, (*saved, *ctx.tables), w1, gb1, w2,
                               gb2, w3, gb3, None, None, ctx.gh, ctx.eps)
        return grads[:7] + (None, None)


class _GhostUnitProj(torch.autograd.Function):
    @staticmethod
    def forward(ctx, o, w1, gb1, w2, gb2, w3, gb3, ws, gbs, gh, eps):
        outs, saved = _unit_forward(o, w1, gb1, w2, gb2, w3, gb3, ws, gbs,
                                    gh, eps)
        ctx.save_for_backward(w1, gb1, w2, gb2, w3, gb3, ws, gbs,
                              *saved[:9])
        ctx.tables, ctx.gh, ctx.eps = saved[9:], gh, eps
        ctx.mark_non_differentiable(*outs[1:])
        return outs

    @staticmethod
    def backward(ctx, dout, *_):
        w1, gb1, w2, gb2, w3, gb3, ws, gbs, *saved = ctx.saved_tensors
        grads = _unit_backward(dout, (*saved, *ctx.tables), w1, gb1, w2,
                               gb2, w3, gb3, ws, gbs, ctx.gh, ctx.eps)
        return grads + (None, None)


def ghost_unit_id(o, w1, gb1, w2, gb2, w3, gb3, gh: int, eps: float):
    """Identity-shortcut ghost unit (``pallas_unit.ghost_unit_id``):
    (out, s1, s2, s3), the statistics global [Σz, Σz²] side outputs with
    no gradient."""
    return _GhostUnitId.apply(o.contiguous(memory_format=_CL), w1, gb1, w2,
                              gb2, w3, gb3, gh, eps)


def ghost_unit_proj(o, w1, gb1, w2, gb2, w3, gb3, ws, gbs, gh: int,
                    eps: float):
    """Projection-shortcut ghost unit (``pallas_unit.ghost_unit_proj``):
    (out, s1, s2, s3, ss)."""
    return _GhostUnitProj.apply(o.contiguous(memory_format=_CL), w1, gb1,
                                w2, gb2, w3, gb3, ws, gbs, gh, eps)
