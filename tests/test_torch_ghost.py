"""The ghost-BN unit ops (ops/ghost.py) against JAX's ops/pallas_unit.py.

Units of N=2, H=24, W=16, db 8, Co 32 at gh 8 (3 bands, so two seams an
image), identity (Ci 32) and projection (Ci 16) shortcuts; the same
numpy inputs go through JAX's ``ghost_unit_id``/``ghost_unit_proj`` with
the Pallas kernels interpreted, and through the port's ops (the plain
versions of its kernels, composed as the kernels compose) and its
band-local ``reference_ghost_unit``.

Tolerances, relative to the largest value of each output: forward out
and statistics 1e-5 in float32 (the same arithmetic summed in another
order); every gradient 1e-4 against ``jax.grad`` in float32 (the
backward is exact, so only summation order separates them); bfloat16
5e-2 (the JAX package's own test_pallas_unit.py bound: one bf16 rounding
of each intermediate, placed alike on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_ocr_tpu.ops import pallas_unit as PU
from tensorflow_ocr_tpu_torch.ops import ghost as G

torch.set_num_threads(1)
N, H, W, DB, CO, GH, EPS = 2, 24, 16, 8, 32, 8, 1e-5


@pytest.fixture
def interpret():
    PU.set_interpret(True)
    yield
    PU.set_interpret(False)


def inputs(proj, seed=0):
    """JAX-layout numpy inputs: o, w1 (ci, db), gb1, w2 (9db, db), gb2,
    w3 (db, co), gb3[, ws (ci, co), gbs], and the output cotangent."""
    rng = np.random.RandomState(seed)
    ci = 16 if proj else 32
    f = np.float32
    gb = lambda c: np.stack([rng.uniform(0.5, 1.5, c),  # noqa: E731
                             rng.randn(c) * 0.1]).astype(f)
    args = [(rng.randn(N, H, W, ci) ** 2).astype(f),
            (rng.randn(ci, DB) * 0.3).astype(f), gb(DB),
            (rng.randn(9 * DB, DB) * 0.15).astype(f), gb(DB),
            (rng.randn(DB, CO) * 0.3).astype(f), gb(CO)]
    if proj:
        args += [(rng.randn(ci, CO) * 0.3).astype(f), gb(CO)]
    return args, rng.randn(N, H, W, CO).astype(f)


def to_port(args, dtype=torch.float32):
    """JAX-layout arrays -> the port's (NCHW channels-last activations,
    OIHW weights, (2, C) tables)."""
    o, w1, gb1, w2, gb2, w3, gb3, *sc = args
    db = w1.shape[1]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    out = [t(o).permute(0, 3, 1, 2).to(dtype).contiguous(
               memory_format=torch.channels_last),
           t(w1.T[:, :, None, None]).to(dtype), t(gb1),
           t(w2.reshape(3, 3, db, db).transpose(3, 2, 0, 1)).to(dtype),
           t(gb2), t(w3.T[:, :, None, None]).to(dtype), t(gb3)]
    if sc:
        out += [t(sc[0].T[:, :, None, None]).to(dtype), t(sc[1])]
    return [a.requires_grad_() for a in out]


def grads_to_jax_layout(grads, proj):
    """The port's gradients in JAX's layouts, as numpy."""
    g = [x.detach().float() for x in grads]
    db = g[1].shape[0]
    out = [g[0].permute(0, 2, 3, 1).numpy(), g[1][:, :, 0, 0].T.numpy(),
           g[2].numpy(),
           g[3].permute(2, 3, 1, 0).reshape(9 * db, db).numpy(),
           g[4].numpy(), g[5][:, :, 0, 0].T.numpy(), g[6].numpy()]
    if proj:
        out += [g[7][:, :, 0, 0].T.numpy(), g[8].numpy()]
    return out


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def jax_unit(args, wy, fn):
    """(outputs, gradients of Σ out·wy) of a JAX unit function."""
    jargs = [jnp.asarray(a) for a in args]
    outs, vjp = jax.vjp(lambda *a: fn(*a), *jargs)
    cts = (jnp.asarray(wy, outs[0].dtype),) + tuple(
        jnp.zeros_like(s) for s in outs[1:])
    return [np.asarray(x, np.float32) for x in outs], [
        np.asarray(g, np.float32) for g in vjp(cts)]


def jax_kernel_fn(proj):
    if proj:
        return lambda *a: PU.ghost_unit_proj(*a, GH, EPS)
    return lambda *a: PU.ghost_unit_id(*a, GH, EPS)


def jax_reference_fn(proj):
    def fn(*a):
        ws, gbs = (a[7], a[8]) if proj else (None, None)
        out = PU.reference_ghost_unit(*a[:7], ws, gbs, GH, EPS)
        return out if proj else out[:4]
    return fn


def port_unit(targs, wy, proj, band_local=False):
    """(outputs, gradients of Σ out·wy) of the port's unit: the ops (the
    plain versions of the kernels) or the band-local reference."""
    if band_local:
        extra = [] if proj else [None, None]
        outs = G.reference_ghost_unit(*targs, *extra, GH, EPS)
        outs = outs if proj else outs[:4]
    else:
        fn = G.ghost_unit_proj if proj else G.ghost_unit_id
        outs = fn(*targs, GH, EPS)
    wt = torch.from_numpy(wy).permute(0, 3, 1, 2)
    grads = torch.autograd.grad((outs[0].float() * wt).sum(), targs)
    o = [outs[0].detach().float().permute(0, 2, 3, 1).numpy()] + [
        s.detach().numpy() for s in outs[1:]]
    return o, grads_to_jax_layout(grads, proj)


@pytest.mark.parametrize("proj", [False, True], ids=["identity", "proj"])
def test_unit_matches_interpreted_jax_kernels(interpret, proj):
    args, wy = inputs(proj)
    want_out, want_grads = jax_unit(args, wy, jax_kernel_fn(proj))
    for band_local in (False, True):
        got_out, got_grads = port_unit(to_port(args), wy, proj, band_local)
        for i, (g, w) in enumerate(zip(got_out, want_out)):
            assert rel(g, w) < 1e-5, (band_local, "output", i)
        for i, (g, w) in enumerate(zip(got_grads, want_grads)):
            assert rel(g, w) < 1e-4, (band_local, "gradient", i)


def test_unit_bf16_matches_interpreted_jax_kernels(interpret):
    args, wy = inputs(True, seed=1)
    bf = [a.astype(jnp.bfloat16) if i in (0, 1, 3, 5, 7) else a
          for i, a in enumerate(args)]
    want_out, want_grads = jax_unit(bf, wy, jax_kernel_fn(True))
    got_out, got_grads = port_unit(to_port(args, torch.bfloat16), wy, True)
    for i, (g, w) in enumerate(zip(got_out, want_out)):
        assert rel(g, w) < 5e-2, ("output", i)
    for i, (g, w) in enumerate(zip(got_grads, want_grads)):
        assert rel(g, w) < 5e-2, ("gradient", i)


def halo_under_own_band(monkeypatch):
    """Plant trap 2: every z1 row normalised with its own band's affine
    and one SAME 3x3 conv over the result."""
    orig = G.conv_fwd_reference

    def wrong(x, tab, w, gh):
        if w.shape[-1] == 1:
            return orig(x, tab, w, gh)
        y = G._conv(G._act(x, tab, gh), w, 1).to(x.dtype)
        return y, G.band_stats(y, gh)
    monkeypatch.setattr(G, "conv_fwd_reference", wrong)


def no_seam_terms(monkeypatch):
    """Plant trap 5: the halo rows' terms of the 3x3 backward dropped."""
    orig = G.seam_bwd_reference

    def wrong(*a):
        edge, sums = orig(*a)
        return torch.zeros_like(edge), torch.zeros_like(sums)
    monkeypatch.setattr(G, "seam_bwd_reference", wrong)


@pytest.mark.parametrize("fault", [None, "halo", "seam"])
@pytest.mark.parametrize("proj", [False, True], ids=["identity", "proj"])
def test_kernel_split_matches_jax_grad_and_catches_faults(monkeypatch, proj,
                                                          fault):
    """The plain versions composed as the kernels compose them, against
    jax.grad of JAX's band-local reference at nb 3; a planted fault of
    either trap puts the worst output or gradient beyond the tolerance."""
    args, wy = inputs(proj, seed=2)
    want_out, want_grads = jax_unit(args, wy, jax_reference_fn(proj))
    if fault == "halo":
        halo_under_own_band(monkeypatch)
    elif fault == "seam":
        no_seam_terms(monkeypatch)
    got_out, got_grads = port_unit(to_port(args), wy, proj)
    worst = max([rel(g, w) for g, w in zip(got_out, want_out)]
                + [rel(g, w) for g, w in zip(got_grads, want_grads)])
    if fault is None:
        assert worst < 1e-4
    else:
        assert worst > 1e-2, worst


def test_pick_gh_is_jax_pick_gh():
    chans = ((64, 64, 256), (256, 64, 256), (256, 128, 512),
             (512, 128, 512), (512, 256, 1024), (1024, 256, 1024),
             (1024, 512, 2048), (2048, 512, 2048))
    for h in (16, 24, 32, 64, 128):
        for w in (16, 24, 32, 64, 128):
            for ci, db, co in chans:
                for proj in (False, True):
                    assert (G.pick_gh(h, w, ci, db, co, proj)
                            == PU.pick_gh(h, w, ci, db, co, proj)), \
                        (h, w, ci, db, co, proj)


def test_band_tables_follow_the_pallas_band_math():
    """band_stats, affine_of and stat_corr against the JAX helpers on
    one band's values."""
    rng = np.random.RandomState(4)
    z = rng.randn(1, 5, GH, 7).astype(np.float32)
    gb = np.stack([rng.uniform(0.5, 1.5, 5), rng.randn(5)]).astype(np.float32)
    dab = rng.randn(2, 5).astype(np.float32)
    cnt = float(GH * 7)
    zj = jnp.asarray(z[0].transpose(1, 2, 0))
    want_s = PU._band_stats(zj)
    got_s = G.band_stats(torch.from_numpy(z), GH)[0, 0]
    assert rel(got_s, want_s) < 1e-6
    a, b = PU._affine_of(want_s, jnp.asarray(gb), cnt, EPS)
    got_ab = G.affine_of(got_s, torch.from_numpy(gb), cnt, EPS)
    assert rel(got_ab, np.stack([a, b])) < 1e-6
    c1, c2, dg, dbe = PU._stat_corr(jnp.asarray(dab), want_s,
                                    jnp.asarray(gb), cnt, EPS)
    corr, dgb = G.stat_corr(torch.from_numpy(dab), got_s,
                            torch.from_numpy(gb), cnt, EPS)
    assert rel(corr, np.stack([c1, c2])) < 1e-5
    assert rel(dgb, np.stack([dg, dbe])) < 1e-5


def test_wrappers_take_cpu_tensors_and_refuse_other_devices():
    """CPU tensors take the plain versions (no launch counted); tensors
    on any other device than a CUDA one raise, with no fallback."""
    args, _ = inputs(False)
    targs = to_port(args)
    before = G.conv_fwd.launches, G.conv_bwd.launches
    out = G.ghost_unit_id(*targs, GH, EPS)
    out[0].float().sum().backward()
    assert out[0].shape == (N, CO, H, W)
    assert (G.conv_fwd.launches, G.conv_bwd.launches) == before
    x = torch.empty((N, 64, H, W), dtype=torch.bfloat16, device="meta")
    w = torch.empty((64, 64, 1, 1), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        G.conv_fwd(x, None, w, GH)
