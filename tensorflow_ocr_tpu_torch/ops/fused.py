"""Fused conv+BN+relu and the residual boundary of a bottleneck unit.

Port of ``tensorflow_ocr_tpu/ops/pallas_fused.py``. The bottleneck keeps
RAW conv outputs; each conv applies the previous BatchNorm as a
per-channel affine+relu prologue on its operand and emits its own
output's BN statistics as an epilogue:

    z1, s1 = fused_conv1x1(o,  (1, 0),  W1)     # prologue relu(x*a + b)
    z2, s2 = fused_conv3x3(z1, ab(s1), W2)      # epilogue [Σy, Σy²]
    z3, s3 = fused_conv1x1(z2, ab(s2), W3)
    o'     = fused_boundary(z3, ab(s3), zs, abs)  # relu(z*a+b + zs*as+bs)

Four wrappers carry the work, each with a hand-written CUDA kernel and a
plain PyTorch version beside it:

- :func:`conv_fwd`      <- ``_f1x1`` (:112) and ``_f3x3`` (:153);
- :func:`conv_bwd`      <- ``_fused_conv1x1_bwd`` (:267) and
                           ``_fused_conv3x3_bwd`` (:318);
- :func:`boundary_fwd`  <- ``fused_boundary`` (:420);
- :func:`boundary_bwd`  <- ``_fused_boundary_bwd`` (:456).

CPU tensors take the plain version; CUDA tensors launch the kernel
(``csrc/fused_conv.cu``, ``csrc/fused_boundary.cu``; counted in each
wrapper's ``launches``) or raise. The kernels take bfloat16 or float32
activations, all of one type, as the Pallas kernels take ``x.dtype``;
float32 ones go to kernels of their own, each counting its launches
(:func:`conv_fwd32`, :func:`conv_bwd32`, :func:`boundary_fwd32`,
:func:`boundary_bwd32`), whose conv products are float32 products by
split TF32 (csrc/wgmma.cuh), not TF32 ones. The plain versions round
where the kernels round: the prologue and ``dy_eff`` in the activation
dtype, the products in float32 (TF32 off), the statistics from the
float32 result.

Tensors are NCHW in the channels-last memory format, so a (N, C, H, W)
tensor is JAX's (N, H, W, C) array in memory and its rows are the
kernels' (M, C) matrices. Weights are (Co, Ci, k, k) in the activation
dtype, as the Flax module casts its kernel before the call.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from tensorflow_ocr_tpu_torch.ops.kernels import build_library

_CL = torch.channels_last
# the conv kernel's tiles: channel counts a multiple of this, k in (1, 3)
KERNEL_CHANNELS = 64


def kernel_takes(ci: int, co: int, k: int) -> bool:
    """Whether the conv kernels take a k x k stride-1 conv of ci -> co
    channels (any N, H, W)."""
    return k in (1, 3) and ci % KERNEL_CHANNELS == 0 \
        and co % KERNEL_CHANNELS == 0


@contextlib.contextmanager
def full_f32():
    """Float32 products without TF32, in cuDNN and in matmuls: the plain
    versions' products are f32."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def up_f32(t: torch.Tensor) -> torch.Tensor:
    """t in float32, or in float64 where it is float64 (gradcheck)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _vec(ab: torch.Tensor, i: int) -> torch.Tensor:
    """Row ``i`` of a (2, C) table, broadcast over NCHW."""
    return ab[i][:, None, None]


def _prologue(x: torch.Tensor, ab: torch.Tensor) -> torch.Tensor:
    """relu(x*a + b) in float32, rounded to x's dtype (``_prologue``)."""
    return torch.relu(up_f32(x) * _vec(ab, 0) + _vec(ab, 1)).to(x.dtype)


def _dy_eff(dy: torch.Tensor, y: torch.Tensor,
            ds: Optional[torch.Tensor]) -> torch.Tensor:
    """dy + ds0 + 2*y*ds1 in float32, rounded to dy's dtype: the gradient
    of the statistics s = [Σy, Σy²] folded into dy (``_dy_eff``)."""
    if ds is None:
        return dy
    return (up_f32(dy) + _vec(ds, 0)
            + 2.0 * up_f32(y) * _vec(ds, 1)).to(dy.dtype)


def conv_fwd_reference(x: torch.Tensor, ab: torch.Tensor, w: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`conv_fwd`."""
    k = w.shape[-1]
    xn = _prologue(x, ab)  # zero padding comes after the prologue
    with full_f32():
        y = F.conv2d(up_f32(xn), up_f32(w), padding=k // 2)
    s = torch.stack([y.sum((0, 2, 3)), (y * y).sum((0, 2, 3))])
    return y.to(x.dtype).contiguous(memory_format=_CL), s


def conv_bwd_reference(x, ab, w, y, dy, ds):
    """Plain version of :func:`conv_bwd`."""
    k = w.shape[-1]
    xn = up_f32(_prologue(x, ab))
    dye = up_f32(_dy_eff(dy, y, ds))
    with full_f32():
        dw = torch.nn.grad.conv2d_weight(xn, w.shape, dye, padding=k // 2)
        g = torch.nn.grad.conv2d_input(x.shape, up_f32(w), dye,
                                       padding=k // 2)
    xf = up_f32(x)
    gm = g * (xf * _vec(ab, 0) + _vec(ab, 1) > 0)
    dx = (gm * _vec(ab, 0)).to(x.dtype).contiguous(memory_format=_CL)
    dab = torch.stack([(gm * xf).sum((0, 2, 3)), gm.sum((0, 2, 3))])
    return dx, dab, dw.to(w.dtype)


def boundary_fwd_reference(z, ab, zs, abs_):
    """Plain version of :func:`boundary_fwd`."""
    pre = (up_f32(z) * _vec(ab, 0) + _vec(ab, 1)
           + up_f32(zs) * _vec(abs_, 0) + _vec(abs_, 1))
    return torch.relu(pre).to(z.dtype).contiguous(memory_format=_CL)


def boundary_bwd_reference(g, z, ab, zs, abs_):
    """Plain version of :func:`boundary_bwd`."""
    zf, zsf = up_f32(z), up_f32(zs)
    pre = zf * _vec(ab, 0) + _vec(ab, 1) + zsf * _vec(abs_, 0) + _vec(abs_, 1)
    gm = up_f32(g) * (pre > 0)
    gsum = gm.sum((0, 2, 3))
    dab = torch.stack([(gm * zf).sum((0, 2, 3)), gsum])
    dabs = torch.stack([(gm * zsf).sum((0, 2, 3)), gsum])
    dz = (gm * _vec(ab, 0)).to(z.dtype).contiguous(memory_format=_CL)
    dzs = (gm * _vec(abs_, 0)).to(zs.dtype).contiguous(memory_format=_CL)
    return dz, dab, dzs, dabs


# --------------------------------------------------------------------------
# the kernels' wrappers
# --------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int


# the extern "C" entry points of csrc/<library>.cu: argument types
SIGNATURES = {
    "fused_conv": {
        "fused_conv_fwd": [_P] * 6 + [_I] * 13 + [_P],
        "fused_conv_bwd": [_P] * 11 + [_I] * 20 + [_P],
        "fused_conv_fwd_f32": [_P] * 7 + [_I] * 14 + [_P],
        "fused_conv_bwd_f32": [_P] * 12 + [_I] * 22 + [_P],
        "fused_tdx32_attrs": [_I] * 3 + [_P],
    },
    "fused_boundary": {
        "fused_boundary_fwd": [_P] * 5 + [_I] * 2 + [_P],
        "fused_boundary_bwd_blocks": [_I] * 2,
        "fused_boundary_bwd": [_P] * 10 + [_I] * 3 + [_P],
        "fused_boundary_fwd_f32": [_P] * 5 + [_I] * 2 + [_P],
        "fused_boundary_bwd_blocks_f32": [_I] * 2,
        "fused_boundary_bwd_f32": [_P] * 10 + [_I] * 3 + [_P],
    },
}
# the activation dtypes the kernels take, each on kernels of its own
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


@functools.cache
def _lib(name: str):
    lib = ctypes.CDLL(str(build_library(name)))
    for fn, args in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def on_cpu(*ts) -> bool:
    return all(t is None or t.device.type == "cpu" for t in ts)


def _check(ref: torch.Tensor, **tensors) -> None:
    """All activations of ref's dtype, bfloat16 or float32, channels-last,
    on ref's CUDA device; all tables float32 and contiguous there. Raises
    on anything else."""
    if ref.device.type != "cuda":
        raise ValueError(f"tensors on {ref.device}: the kernels need a "
                         "CUDA device (or every tensor on the CPU)")
    for name, t in tensors.items():
        if t.device != ref.device:
            raise ValueError(f"{name} on {t.device}, expected {ref.device}")
        if t.dim() == 4:
            if t.dtype not in KERNEL_DTYPES or t.dtype != ref.dtype:
                raise TypeError(f"{name}: the kernels take bfloat16 or "
                                f"float32 activations of one type, got "
                                f"{t.dtype} beside {ref.dtype}")
            if not t.is_contiguous(memory_format=_CL):
                raise ValueError(f"{name} must be channels-last contiguous")
        elif t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"{name}: need a contiguous float32 table, got "
                            f"{t.dtype}")


def _check_weight(x: torch.Tensor, w: torch.Tensor) -> None:
    """The weight in the activations' dtype, on their device."""
    if w.dtype != x.dtype or w.device != x.device:
        raise TypeError(f"w: need {x.dtype} on {x.device}, got {w.dtype} "
                        f"on {w.device}")


def _need_f32(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 activations, got {t.dtype}")


def cuda_stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def _conv_shapes(x, ab, w):
    n, ci, h, wd = x.shape
    co, wci, kh, kw = w.shape
    if wci != ci or kh != kw or tuple(ab.shape) != (2, ci):
        raise ValueError(f"x {tuple(x.shape)}, ab {tuple(ab.shape)}, "
                         f"w {tuple(w.shape)} do not fit")
    if not kernel_takes(ci, co, kh):
        raise ValueError(f"the conv kernel takes k in (1, 3) and channels "
                         f"a multiple of {KERNEL_CHANNELS}, got k={kh}, "
                         f"{ci}->{co}")
    if n * h * wd * max(ci, co) * kh * kh >= 2 ** 31:
        raise ValueError("shape overflows the kernel's int32 indices")
    return n, ci, h, wd, co, kh


def conv_fwd(x: torch.Tensor, ab: torch.Tensor, w: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """y = conv_k(relu(x*a + b), w) (stride 1, SAME), s = [Σy, Σy²].

    x (N, Ci, H, W) channels-last; ab (2, Ci) float32; w (Co, Ci, k, k)
    with k in (1, 3), in x's dtype. Returns y (N, Co, H, W) channels-last
    in x's dtype and s (2, Co) float32 taken from the float32 products.
    One launch on csrc/conv_bwd.cuh's ``tdx`` in its forward mode (tiled
    by ops/conv.py tma_staged_fwd_plan, x put through relu(x*a + b) on its
    way from shared memory into the product) and one that adds the CTAs'
    sums in order: no atomics, so two calls on the same inputs are
    bit-equal. Float32 tensors go to :func:`conv_fwd32`.
    """
    if on_cpu(x, ab, w):
        return conv_fwd_reference(x, ab, w)
    if x.dtype == torch.float32:
        return conv_fwd32(x, ab, w)
    out = _launch_fwd(x, ab, w)
    conv_fwd.launches += 1
    return out


def conv_fwd32(x: torch.Tensor, ab: torch.Tensor, w: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`conv_fwd` in float32 on CUDA tensors (x and w float32):
    ``fused_conv_fwd_f32``, csrc/conv_bwd.cuh's ``tdx_f32`` in its forward
    mode (tma_staged_fwd_plan with 4-byte elements), a float32 product by
    split TF32; the weight's split goes to a scratch of twice its size."""
    _need_f32("conv_fwd32", x)
    out = _launch_fwd(x, ab, w)
    conv_fwd32.launches += 1
    return out


def _launch_fwd(x, ab, w):
    """The forward's launch on the kernel of x's dtype (CUDA tensors)."""
    from tensorflow_ocr_tpu_torch.ops import conv as CV

    _check(x, x=x, ab=ab)
    n, ci, h, wd, co, k = _conv_shapes(x, ab, w)
    _check_weight(x, w)
    wt = w.permute(0, 2, 3, 1).reshape(co, k * k * ci).contiguous()
    aligned16(x=x, ab=ab)
    index = x.device.index
    f32 = x.dtype == torch.float32
    geo = (1, 1, n * h * wd) if k == 1 else (n, h, wd)  # a 1x1's rows
    p = CV.tma_staged_fwd_plan(*geo, ci, co, k, CV._sms(index),
                               esize=4 if f32 else 2)
    y = torch.empty((n, co, h, wd), dtype=x.dtype, device=x.device,
                    memory_format=_CL)
    # s, the entries of the sums (a CTA's; float32: a row tile's) and
    # (float32) the weight's split in one buffer, each written whole
    entries = 2 * co * (1 + (p.row_tiles if f32 else p.grid // p.col_tiles))
    buf = torch.empty(entries + 2 * wt.numel() * f32, dtype=torch.float32,
                      device=x.device)
    s, ws = buf[:2 * co].view(2, co), buf[2 * co:entries]
    stream = torch._C._cuda_getCurrentRawStream(index)
    with CV._on_device(index):
        lib = _lib("fused_conv")
        if f32:
            err = lib.fused_conv_fwd_f32(
                x.data_ptr(), ab.data_ptr(), wt.data_ptr(),
                buf[entries:].data_ptr(), y.data_ptr(), s.data_ptr(),
                ws.data_ptr(), *geo, ci, co, k, p.wb, p.hb, p.bn,
                int(p.resident), p.stages, p.grid, p.eslots, int(p.overlap),
                stream)
        else:
            err = lib.fused_conv_fwd(
                x.data_ptr(), ab.data_ptr(), wt.data_ptr(), y.data_ptr(),
                s.data_ptr(), ws.data_ptr(), *geo, ci, co, k, p.wb, p.hb,
                p.bn, int(p.resident), p.stages, p.grid, p.eslots, stream)
    raise_on(err, "fused_conv_fwd_f32" if f32 else "fused_conv_fwd")
    return y, s


def conv_bwd(x, ab, w, y, dy, ds):
    """Backward of :func:`conv_fwd` for the cotangents dy of y and ds of
    s (``None`` reads as zero). Returns dx (x's dtype), dab (2, Ci)
    float32 and dw (w's shape and dtype), with dy_eff = dy + ds0 + 2y·ds1
    and gm = (dy_eff ⋆ wᵀ)·[x*a + b > 0]: dx = gm*a, dab = [Σ gm*x, Σ gm].
    Two launches on csrc/conv_bwd.cuh: dW = im2col(relu(x*a+b))ᵀ·dy_eff
    (``tdw``, split over the pixels by ops/conv.py tma_dw_plan and summed
    in a fixed order), then dx and dab (``tdx``, tiled by
    tma_bwd_dx_plan); no atomics, so two calls on the same inputs are
    bit-equal. Each kernel's launches are counted in
    ``conv_bwd.by_kernel`` (in float32 ``tdw_f32``, the kernel
    ``tdw_f32_tr``, and ``tdx_f32``).
    Float32 tensors go to :func:`conv_bwd32`.
    """
    if on_cpu(x, ab, w, y, dy, ds):
        return conv_bwd_reference(x, ab, w, y, dy, ds)
    if x.dtype == torch.float32:
        return conv_bwd32(x, ab, w, y, dy, ds)
    out = _launch_bwd(x, ab, w, y, dy, ds)
    conv_bwd.launches += 1
    return out


def conv_bwd32(x, ab, w, y, dy, ds):
    """:func:`conv_bwd` in float32 on CUDA tensors: ``fused_conv_bwd_f32``,
    csrc/conv_bwd.cuh's ``tdw_f32_tr`` (TF32 wgmma: relu(x*a + b) on its
    register A fragment, dy_eff formed as dY is transposed into its K-major
    tiles, runs of ops/conv.py DW32_RUN k8 steps a fresh accumulator) and
    ``tdx_f32`` (dy_eff formed in registers before the split), both
    float32 products by split TF32."""
    _need_f32("conv_bwd32", x)
    out = _launch_bwd(x, ab, w, y, dy, ds)
    conv_bwd32.launches += 1
    return out


def _launch_bwd(x, ab, w, y, dy, ds):
    """The backward's launches on the kernels of x's dtype (CUDA tensors)."""
    from tensorflow_ocr_tpu_torch.ops import conv as CV

    dy = dy.contiguous(memory_format=_CL)
    n, ci, h, wd, co, k = _conv_shapes(x, ab, w)
    if ds is None:
        ds = torch.zeros((2, co), dtype=torch.float32, device=x.device)
    _check(x, x=x, ab=ab, y=y, dy=dy, ds=ds)
    _check_weight(x, w)
    if tuple(y.shape) != (n, co, h, wd) or dy.shape != y.shape \
            or tuple(ds.shape) != (2, co):
        raise ValueError(f"y {tuple(y.shape)}, dy {tuple(dy.shape)}, ds "
                         f"{tuple(ds.shape)} do not fit w {tuple(w.shape)}")
    wflip = w.flip(2, 3).permute(1, 2, 3, 0).reshape(ci, k * k * co)
    wflip = wflip.contiguous()
    aligned16(x=x, ab=ab, y=y, dy=dy, ds=ds)
    index = x.device.index
    sms = CV._sms(index)
    f32 = x.dtype == torch.float32
    esize = 4 if f32 else 2
    geo = (1, 1, n * h * wd) if k == 1 else (n, h, wd)  # a 1x1's rows
    pw = CV.tma_dw_plan(*geo, ci, co, k, sms, aux=esize, esize=esize)
    px = CV.tma_bwd_dx_plan(*geo, ci, co, k, sms, esize, True, esize=esize)
    # dW, the clusters' tables, dab, its partial entries and (float32)
    # wflip's split in one buffer: the wrapper's host time is of the order
    # of a small shape's device time
    kdim, tables = k * k * ci * co, pw.splits // pw.cluster
    parts = (px.row_tiles if f32 else px.grid // px.col_tiles) * 2 * ci
    split = 2 * kdim * f32
    buf = torch.empty(kdim * (1 + (tables if tables > 1 else 0)) + 2 * ci
                      + parts + split, dtype=torch.float32, device=x.device)
    dw, dab = buf[:kdim], buf[kdim:kdim + 2 * ci].view(2, ci)
    end = buf.numel() - split
    ws_dw, ws_dab = buf[kdim + 2 * ci:end - parts], buf[end - parts:end]
    dx = torch.empty_like(x, memory_format=_CL)
    stream = torch._C._cuda_getCurrentRawStream(index)
    with torch.cuda.device(x.device):
        lib = _lib("fused_conv")
        if f32:
            err = lib.fused_conv_bwd_f32(
                x.data_ptr(), ab.data_ptr(), wflip.data_ptr(),
                buf[end:].data_ptr(), y.data_ptr(), dy.data_ptr(),
                ds.data_ptr(), dx.data_ptr(), dab.data_ptr(), dw.data_ptr(),
                ws_dw.data_ptr(), ws_dab.data_ptr(), *geo, ci, co, k, pw.wb,
                pw.hb, pw.bn, int(pw.two), pw.stages, pw.splits, pw.cluster,
                px.wb, px.hb, px.bn, int(px.resident), px.stages, px.grid,
                px.eslots, int(px.overlap), CV.DW32_RUN, stream)
        else:
            err = lib.fused_conv_bwd(
                x.data_ptr(), ab.data_ptr(), wflip.data_ptr(), y.data_ptr(),
                dy.data_ptr(), ds.data_ptr(), dx.data_ptr(), dab.data_ptr(),
                dw.data_ptr(), ws_dw.data_ptr(), ws_dab.data_ptr(), *geo, ci,
                co, k, pw.wb, pw.hb, pw.bn, int(pw.two), pw.stages,
                pw.splits, pw.cluster, px.wb, px.hb, px.bn,
                int(px.resident), px.stages, px.grid, px.eslots, stream)
    raise_on(err, "fused_conv_bwd_f32" if f32 else "fused_conv_bwd")
    for kernel in conv_bwd.by_kernel:
        if kernel.endswith("_f32") == f32:
            conv_bwd.by_kernel[kernel] += 1
    dw = dw.view(k, k, ci, co).permute(3, 2, 0, 1).to(w.dtype)
    return dx, dab, dw.contiguous()


def aligned16(**tensors) -> None:
    """Raise unless every tensor's base is 16-byte aligned: TMA boxes and
    the kernels' 16-byte table loads need it."""
    for name, t in tensors.items():
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernels need a 16-byte aligned "
                             "base")


def _boundary_shapes(z, ab, zs, abs_):
    c = z.shape[1]
    if zs.shape != z.shape or tuple(ab.shape) != (2, c) \
            or tuple(abs_.shape) != (2, c):
        raise ValueError(f"z {tuple(z.shape)}, zs {tuple(zs.shape)}, ab "
                         f"{tuple(ab.shape)}, abs {tuple(abs_.shape)}")
    # a row's 16-byte vectors, one a thread, at most 1024
    cmax = 4096 if z.dtype == torch.float32 else 8192
    if c % 8 or c > cmax:
        raise ValueError(f"the boundary kernel takes C % 8 == 0, C <= "
                         f"{cmax} in {z.dtype}; got {c}")
    m = z.numel() // c
    if z.numel() >= 2 ** 31:
        raise ValueError("shape overflows the kernel's int32 indices")
    return m, c


def boundary_fwd(z, ab, zs, abs_):
    """relu(z*a + b + zs*as + bs): BN3's affine, the shortcut's affine,
    the residual add and the relu in one pass. z, zs (N, C, H, W)
    channels-last; ab, abs_ (2, C) float32. Float32 tensors go to
    :func:`boundary_fwd32`."""
    if on_cpu(z, ab, zs, abs_):
        return boundary_fwd_reference(z, ab, zs, abs_)
    if z.dtype == torch.float32:
        return boundary_fwd32(z, ab, zs, abs_)
    out = _launch_boundary_fwd(z, ab, zs, abs_)
    boundary_fwd.launches += 1
    return out


def boundary_fwd32(z, ab, zs, abs_):
    """:func:`boundary_fwd` in float32 on CUDA tensors
    (``fused_boundary_fwd_f32``: 16-byte vectors of 4 channels)."""
    _need_f32("boundary_fwd32", z)
    out = _launch_boundary_fwd(z, ab, zs, abs_)
    boundary_fwd32.launches += 1
    return out


def _launch_boundary_fwd(z, ab, zs, abs_):
    _check(z, z=z, ab=ab, zs=zs, abs_=abs_)
    m, c = _boundary_shapes(z, ab, zs, abs_)
    out = torch.empty_like(z, memory_format=_CL)
    entry = ("fused_boundary_fwd_f32" if z.dtype == torch.float32
             else "fused_boundary_fwd")
    with torch.cuda.device(z.device):
        err = getattr(_lib("fused_boundary"), entry)(
            z.data_ptr(), ab.data_ptr(), zs.data_ptr(), abs_.data_ptr(),
            out.data_ptr(), m, c, cuda_stream())
    raise_on(err, entry)
    return out


def boundary_bwd(g, z, ab, zs, abs_):
    """Backward of :func:`boundary_fwd`: dz, dab, dzs, dabs with
    gm = g·[pre > 0]: dz = gm*a, dzs = gm*as, dab = [Σ gm*z, Σ gm],
    dabs = [Σ gm*zs, Σ gm]. Float32 tensors go to
    :func:`boundary_bwd32`."""
    if on_cpu(g, z, ab, zs, abs_):
        return boundary_bwd_reference(g, z, ab, zs, abs_)
    if z.dtype == torch.float32:
        return boundary_bwd32(g, z, ab, zs, abs_)
    out = _launch_boundary_bwd(g, z, ab, zs, abs_)
    boundary_bwd.launches += 1
    return out


def boundary_bwd32(g, z, ab, zs, abs_):
    """:func:`boundary_bwd` in float32 on CUDA tensors
    (``fused_boundary_bwd_f32``: the same per-block partials and the same
    fixed-order second pass)."""
    _need_f32("boundary_bwd32", z)
    out = _launch_boundary_bwd(g, z, ab, zs, abs_)
    boundary_bwd32.launches += 1
    return out


def _launch_boundary_bwd(g, z, ab, zs, abs_):
    g = g.contiguous(memory_format=_CL)
    _check(z, g=g, z=z, ab=ab, zs=zs, abs_=abs_)
    m, c = _boundary_shapes(z, ab, zs, abs_)
    if g.shape != z.shape:
        raise ValueError(f"g {tuple(g.shape)} vs z {tuple(z.shape)}")
    f32 = z.dtype == torch.float32
    sfx = "_f32" if f32 else ""
    dz = torch.empty_like(z, memory_format=_CL)
    dzs = torch.empty_like(zs, memory_format=_CL)
    dab = torch.empty((2, c), dtype=torch.float32, device=z.device)
    dabs = torch.empty((2, c), dtype=torch.float32, device=z.device)
    with torch.cuda.device(z.device):
        lib = _lib("fused_boundary")
        # each block's partial sums, added in block order by a second pass
        blocks = getattr(lib, f"fused_boundary_bwd_blocks{sfx}")(m, c)
        part = torch.empty((blocks, 3, c), dtype=torch.float32,
                           device=z.device)
        err = getattr(lib, f"fused_boundary_bwd{sfx}")(
            g.data_ptr(), z.data_ptr(), ab.data_ptr(), zs.data_ptr(),
            abs_.data_ptr(), dz.data_ptr(), dzs.data_ptr(), dab.data_ptr(),
            dabs.data_ptr(), part.data_ptr(), m, c, blocks, cuda_stream())
    raise_on(err, f"fused_boundary_bwd{sfx}")
    return dz, dab, dzs, dabs


for _fn in (conv_fwd, conv_bwd, boundary_fwd, boundary_bwd, conv_fwd32,
            conv_bwd32, boundary_fwd32, boundary_bwd32):
    _fn.launches = 0
# the backward's two kernels (csrc/conv_bwd.cuh): dW and dX, in bfloat16
# and in float32 (tdw_f32 counts tdw_f32_tr)
conv_bwd.by_kernel = {"tdw": 0, "tdx": 0, "tdw_f32": 0, "tdx_f32": 0}


# --------------------------------------------------------------------------
# autograd: the custom-VJP layer ops
# --------------------------------------------------------------------------


class _FusedConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ab, w):
        y, s = conv_fwd(x, ab, w)
        ctx.save_for_backward(x, ab, w, y)
        ctx.set_materialize_grads(False)
        return y, s

    @staticmethod
    def backward(ctx, dy, ds):
        x, ab, w, y = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(y)
        return conv_bwd(x, ab, w, y, dy, ds)


class _FusedBoundary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, ab, zs, abs_):
        ctx.save_for_backward(z, ab, zs, abs_)
        return boundary_fwd(z, ab, zs, abs_)

    @staticmethod
    def backward(ctx, g):
        return boundary_bwd(g, *ctx.saved_tensors)


def fused_conv1x1(x: torch.Tensor, ab: torch.Tensor, w: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable :func:`conv_fwd` with a (Co, Ci, 1, 1) weight
    (``pallas_fused.fused_conv1x1``)."""
    if w.shape[-2:] != (1, 1):
        raise ValueError(f"need a 1x1 weight, got {tuple(w.shape)}")
    return _FusedConv.apply(x, ab, w)


def fused_conv3x3(x: torch.Tensor, ab: torch.Tensor, w: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable :func:`conv_fwd` with a (Co, Ci, 3, 3) weight, SAME
    padding applied after the prologue (``pallas_fused.fused_conv3x3``)."""
    if w.shape[-2:] != (3, 3):
        raise ValueError(f"need a 3x3 weight, got {tuple(w.shape)}")
    return _FusedConv.apply(x, ab, w)


def fused_boundary(z, ab, zs, abs_) -> torch.Tensor:
    """Differentiable :func:`boundary_fwd`
    (``pallas_fused.fused_boundary``)."""
    return _FusedBoundary.apply(z, ab, zs, abs_)
