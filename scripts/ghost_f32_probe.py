#!/usr/bin/env python3
"""Probe of the ghost unit's float32 kernels on one CUDA GPU.

    python3 scripts/ghost_f32_probe.py [--arm] [--graph] [--faults]
                                       [--split] [--sweep] [--sweep-dw]
                                       [--rate] [--seam] [--tree DIR]

1. builds ghost_unit.cu with -Xptxas -v and prints the registers, shared
   memory and spills of each float32 kernel (tdx_f32, the dW tdw_f32_tr,
   gboundary32, tseam32) and each float32 dW kernel's tensor-core
   instructions in its machine code (cuobjdump -sass: HGMMA, wgmma;
   HMMA, mma.sync);
2. chip_smoke.py's phase 14b: each ghost kernel in float32 along one
   unit's chain at the 4 ghost unit shapes of the 512^2 batch-32 step,
   each output's error against the float64 result beside the plain
   float32 version's, two launches bit-equal, kernel, plain and
   conv-alone ms;
3. with --graph: phase 17's graph = eager check of the float32 ghost arm;
4. with --arm: chip_smoke.py's phase 16b (3 float32 ghost steps through
   Trainer.run, the launches, img/s, peak memory, the arm check against
   the plain versions: from the augmented state with --faults, else from
   the seeded one; a float32 freeze_bn step);
5. with --faults: the readings that set chip_smoke.py's F32_GHOST_ARM_*
   bounds, 3 sound runs and phase 15's planted faults (the seam terms
   dropped, the halo rows under their own band's affine, dW2 x 0.9), from
   the augmented state (chip_smoke.py's phase 10b: the synthetic tiers
   written and 768 augmented steps);
6. with --split: the float32 conv backward of each unit's convs at the
   4 unit shapes (conv3 and the 3x3 to gm, conv1 with the seam term and
   an addend, the projecting shortcut to f32), its dW and its dX kernels'
   device ms apart (torch.profiler: the dW kernel, tdw_f32_tr or an older
   checkout's tdw_f32, and sum_tables_wide; tdx_f32, its sums' reductions
   and the weight's tf32_split_rows), summed over the calls and over a
   train step (each shape's units), and the dX's own bound
   (ghost_dx_bound);
7. with --sweep (this checkout's kernels only): tdx_f32 in each float32
   conv forward and backward of step 6's calls (and each unit's forwards)
   under each of tdx_f32's choices, as fused_f32_probe.py's --sweep; with
   --sweep-dw, phase 14b at each run length the dW takes (ops/conv.py
   DW32_RUN 1, 2, 4), its checks recorded rather than raised: the worst
   dW error ratio to the plain version's and the conv backward's ms at
   each.

8. with --rate: the float32 ghost arm's eager train img/s alone (3
   steps through Trainer.run from the seeded state, then chip_smoke.py's
   eager_rate over 3 windows of at least 5 s): run in fresh processes on
   two checkouts (--tree), it compares their steps.

9. with --seam (steps 1 and 9 alone: no phase 14b): the float32 seam
   call (ops/ghost.py seam_bwd on float32 tensors) at the 4 unit shapes,
   held against its plain version (f32_rule) and bit-equal twice; the
   device ms of each of its launches by kernel name (torch.profiler:
   tseam32, the weight's layout and split, the band sums' reduction and
   any other kernel of the call, such as an older tree's permute copy),
   the call's device ms by CUDA-graph replay, the wrapper's host ms a call
   and phase 14b's reading (CUDA events over 5 calls), each summed over the shapes and over a train step (each
   shape's units); then --windows windows of at least --window-s seconds
   of CUDA events over runs of 20 calls at each shape in turn. tseam32's
   registers and spills are step 1's.

--tree DIR runs the kernels and phases of another checkout (e.g. a `git
archive` of the parent under the gitignored _smoke_checkout/), and skips
step 1 (the resource report is this checkout's). Exits 2 without CUDA.
"""

import argparse
import functools
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ("tdx_f32", "tdw_f32", "gboundary32", "tseam32", "seam_wsplit32")
# the float32 conv backward's kernels by name, this checkout's and an
# older one's: its dW and its dX
F32_BWD_PARTS = {"dW": ("tdw_f32", "sum_tables_wide"),
                 "dX": ("tdx_f32", "reduce_parts_wide", "reduce_groups_wide",
                        "tf32_split_rows")}
# the float32 seam call's launches by kernel name, this checkout's and an
# older one's (the weight's permute copy, an elementwise kernel, is any
# other device kernel of the call)
SEAM32_LAUNCHES = (("tseam32", ("tseam32",)),
                   ("weight split", ("seam_wsplit32", "tf32_split_rows")),
                   ("band sums", ("reduce_groups_wide",)))


def ptxas_report():
    """ghost_unit.cu built with -Xptxas -v: the resource lines of its
    float32 kernels."""
    from tensorflow_ocr_tpu_torch.ops import kernels as K

    K.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = K.BUILD_DIR / "ghost_unit_ptxas.so"
    proc = subprocess.run(
        [K._nvcc(), *K.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out),
         str(K.CSRC_DIR / "ghost_unit.cu")], capture_output=True, text=True)
    if proc.returncode:
        print(proc.stderr[-6000:])
        raise SystemExit("nvcc failed on ghost_unit.cu")
    name = None
    for line in proc.stderr.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "warning" in line.lower() or (
                name and any(k in name for k in KERNELS) and (
                    "registers" in line or "spill" in line)):
            print(f"ptxas ghost_unit.cu {name}: {line.strip()}")
    from conv_f32_probe import sass_counts

    sass_counts(K, out, "ghost_unit")


def unit_calls(c, device, gen):
    """(label, units a step, "fwd" or "bwd", the arguments) of each
    float32 conv forward of a unit (G.conv_fwd: z1, the 3x3's z2, z3 and a
    projecting shortcut's) and each conv backward of step 6 (G.conv_bwd)
    at the 4 unit shapes, the inputs made from gen on its device."""
    import torch

    cl = torch.channels_last

    def rand(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=gen.device).mul_(
            scale).to(device)

    for (n, h, wd, ci, db, co, gh), units in zip(c.GHOST_SHAPES,
                                                 c.GHOST_SHAPE_UNITS):
        nb = h // gh

        def act(ch, scale=1.0):
            return rand(n, ch, h, wd, scale=scale).contiguous(
                memory_format=cl)

        def tx(ch):
            return torch.stack([rand(n, nb, ch).abs_().add_(0.5),
                                rand(n, nb, ch, scale=0.1)], 2)

        def td(ch):
            return torch.stack([rand(n, nb, ch).abs_().add_(0.5),
                                rand(n, nb, ch, scale=1e-2),
                                rand(n, nb, ch, scale=1e-3)], 2)

        def wt(cout, cin, k):
            return rand(cout, cin, k, k, scale=(k * k * cin) ** -0.5)

        what = f"{ci}/{db}/{co} at {n}x{h}x{wd} gh {gh}"
        for name, cin, cout, k in (("z1", ci, db, 1), ("z2", db, db, 3),
                                   ("z3", db, co, 1)):
            yield (f"fwd {name} {what}", units, "fwd",
                   (act(cin), tx(cin), wt(cout, cin, k), gh))
        calls = [("conv3", (act(db), tx(db), act(co, 1e-2), act(co), td(co),
                            wt(co, db, 1), gh)),
                 ("conv2", (act(db), tx(db), act(db, 1e-2), act(db),
                            td(db), wt(db, db, 3), gh)),
                 ("conv1", (act(ci), None, act(db, 1e-2), act(db), td(db),
                            wt(db, ci, 1), gh,
                            rand(n, nb, 2, wd, db, scale=1e-2),
                            act(ci), "act"))]
        if ci != co:
            calls.append(("shortcut", (act(ci), None, act(co, 1e-2),
                                       act(co), td(co), wt(co, ci, 1), gh,
                                       None, None, "f32")))
        if ci != co:
            yield (f"fwd shortcut {what}", units, "fwd",
                   (act(ci), None, wt(co, ci, 1), gh))
        for name, args in calls:
            yield f"bwd {name} {what}", units, "bwd", args
        del calls
        torch.cuda.empty_cache()


def ghost_dx_bound(c, args):
    """A float32 ghost conv backward's dX bound (fused_f32_probe.py
    dx_bound) from G.conv_bwd's arguments: it reads z and g (f32), x for
    gm or the addend, the seam rows, the weight and the band tables once,
    and writes dx (f32) and gm's band sums."""
    from fused_f32_probe import dx_bound

    x, tx, g, z, td, w, gh, edge, addend, out = (
        *args, *(None, None, "gm")[len(args) - 7:])
    n, ci, h, wd = x.shape
    co, k = w.shape[0], w.shape[-1]
    m, nbt = n * h * wd, n * (h // gh)
    nbytes = (8 * m * co + 4 * m * ci * (1 + (out == "gm")
                                        + (addend is not None))
              + 4 * k * k * ci * co + (0 if edge is None else 4 * edge.numel())
              + 4 * nbt * (3 * co + (4 * ci if out == "gm" else 0)))
    return dx_bound(c, m, ci, co, k, nbytes)


def split(c, device):
    """Step 6 of the module docstring."""
    import torch
    from tensorflow_ocr_tpu_torch.ops import ghost as G

    tot = {part: [0.0, 0.0] for part in F32_BWD_PARTS}
    bound = [0.0, 0.0]
    for what, units, kind, args in unit_calls(
            c, device, torch.Generator().manual_seed(22)):
        if kind != "bwd":
            continue
        ms = c.kernel_device_ms(lambda: G.conv_bwd(*args), F32_BWD_PARTS)
        for part, v in ms.items():
            tot[part][0] += v
            tot[part][1] += units * v
        b = ghost_dx_bound(c, args)
        bound[0] += b
        bound[1] += units * b
        print(f"split ghost {what} f32 ({units} a step): device dW "
              f"{ms['dW']:.4f} ms, dX {ms['dX']:.4f} ms")
    print(f"split ghost bwd f32 dX bound: {bound[0]:.4f} ms over the "
          f"calls, {bound[1]:.4f} a train step")
    print(f"split ghost bwd f32 over the calls: dW {tot['dW'][0]:.4f} ms, "
          f"dX {tot['dX'][0]:.4f} ms; a train step: dW "
          f"{tot['dW'][1]:.4f} ms, dX {tot['dX'][1]:.4f} ms; "
          f"{c.card_line()}")


def seam_inputs(shape, device, gen):
    """The float32 seam call's arguments (G.seam_bwd) of one unit shape
    (n, h, w, ci, db, co, gh): gm2, z2, the 3x3's dz table, z1, its
    (a1, b1) table and the 3x3 weight, at db channels."""
    import torch

    n, h, wd, _, c, _, gh = shape
    nb = h // gh

    def rand(*s, scale=1.0):
        return (torch.randn(*s, generator=gen) * scale).to(device)

    def act(scale=1.0):
        return rand(n, c, h, wd, scale=scale).contiguous(
            memory_format=torch.channels_last)

    td = torch.stack([rand(n, nb, c).abs_().add_(0.5),
                      rand(n, nb, c, scale=1e-2),
                      rand(n, nb, c, scale=1e-3)], 2)
    tx = torch.stack([rand(n, nb, c).abs_().add_(0.5),
                      rand(n, nb, c, scale=0.1)], 2)
    return (act(1e-2), act(), td, act(), tx,
            rand(c, c, 3, 3, scale=(9 * c) ** -0.5), gh)


def launch_ms(fn, iters=20):
    """{kernel name: device ms a call of fn} from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / iters
            for e in prof.key_averages() if e.self_device_time_total > 0}


def by_launch(names):
    """launch_ms's kernels grouped as SEAM32_LAUNCHES, the rest "other"."""
    out = {label: 0.0 for label, _ in SEAM32_LAUNCHES}
    out["other"] = 0.0
    for key, ms in names.items():
        label = next((lb for lb, keys in SEAM32_LAUNCHES
                      if any(k in key for k in keys)), "other")
        out[label] += ms
    return out


def host_ms(fn, iters=20):
    """Host ms a call of fn: the host clock around calls that enqueue
    without waiting, after a synchronise."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * t / iters


def seam(c, device, windows, window_s):
    """Step 9 of the module docstring."""
    import torch
    from tensorflow_ocr_tpu_torch.ops import ghost as G

    gen = torch.Generator().manual_seed(23)
    f64 = torch.float64
    calls = []
    for shape, units in zip(c.GHOST_SHAPES, c.GHOST_SHAPE_UNITS):
        args = seam_inputs(shape, device, gen)
        n, h, wd, ci, db, co, gh = shape
        label = f"{ci}/{db}/{co} at {n}x{h}x{wd} gh {gh}"
        got, again = G.seam_bwd(*args), G.seam_bwd(*args)
        torch.cuda.synchronize()
        c.check(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"seam f32 {label}: two launches differ")
        want = G.seam_bwd_reference(*args)
        exact = G.seam_bwd_reference(*[t.to(f64) if torch.is_tensor(t)
                                        else t for t in args])
        errs = [c.f32_rule(f"seam f32 {nm} {label}", got[i], want[i],
                           exact[i]) for i, nm in enumerate(("edge", "sums"))]
        del want, exact
        print(f"seam f32 {label}: error against float64 x"
              f"{max(q for _, q in errs):.2f} the plain version's; "
              f"bit-equal twice; {units} a step")
        calls.append((label, units, args, got))
    step = {}
    over = {}
    for label, units, args, _ in calls:
        fn = lambda args=args: G.seam_bwd(*args)  # noqa: E731
        names = launch_ms(fn)
        parts = by_launch(names)
        parts["device"] = sum(names.values())
        parts["graph"] = c.graph_ms(fn, 20)
        parts["host"] = host_ms(fn)
        parts["events 5"] = c.cuda_ms(fn, 5)
        for k, v in parts.items():
            over[k] = over.get(k, 0.0) + v
            step[k] = step.get(k, 0.0) + units * v
        print(f"seam f32 {label}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in parts.items()) + " ms; kernels "
            + "; ".join(f"{k[:60]} {v:.4f}" for k, v in names.items()))
    for what, d in (("over the shapes", over), ("a train step", step)):
        print(f"seam f32 {what}: " + ", ".join(f"{k} {v:.4f}"
                                               for k, v in d.items())
              + f" ms; {c.card_line()}")
    for wi in range(windows):
        tot, cnt = [0.0] * len(calls), [0] * len(calls)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < window_s:
            for i, (_, _, args, _) in enumerate(calls):
                tot[i] += c.cuda_ms(lambda args=args: G.seam_bwd(*args), 20)
                cnt[i] += 1
        ms = [t / k for t, k in zip(tot, cnt)]
        print(f"seam f32 window {wi} ({time.perf_counter() - t0:.1f} s, "
              f"{cnt[0]} runs of 20 calls a shape): "
              + ", ".join(f"{m:.4f}" for m in ms)
              + f" ms; over the shapes {sum(ms):.4f}, a train step "
              f"{sum(u * m for (_, u, _, _), m in zip(calls, ms)):.4f}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arm", action="store_true")
    ap.add_argument("--graph", action="store_true")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--sweep-dw", action="store_true")
    ap.add_argument("--rate", action="store_true")
    ap.add_argument("--seam", action="store_true")
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--window-s", type=float, default=5.0)
    ap.add_argument("--tree", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ghost_f32_probe: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.tree or REPO))
    import chip_smoke as c

    t0 = time.perf_counter()
    device = torch.device("cuda", 0)
    print(f"card: {c.card_line()}; torch {torch.__version__}; tree "
          f"{args.tree or REPO}")
    if args.tree is None:
        ptxas_report()
    c.build_all()
    if args.seam:
        seam(c, device, args.windows, args.window_s)
        print(f"ghost_f32_probe: {time.perf_counter() - t0:.1f} s; "
              f"{c.card_line()}")
        return 0
    if args.sweep_dw:
        from fused_f32_probe import sweep

        sweep(c, device, c.phase_ghost_kernels_f32, c.GHOST_F32_KERNELS,
              "ghost_conv_bwd_f32")
    if args.sweep:
        from fused_f32_probe import dx_sweep
        from tensorflow_ocr_tpu_torch.ops import ghost as G

        gen = torch.Generator(device=device).manual_seed(24)
        dx_sweep(c, ((what, units,
                      functools.partial(G.conv_fwd if kind == "fwd"
                                        else G.conv_bwd, *args))
                     for what, units, kind, args in unit_calls(c, device,
                                                               gen)))
    reports = {n: {} for n in c.GHOST_F32_KERNELS}
    c.phase_ghost_kernels_f32(device, reports)
    if args.split:
        split(c, device)
    if args.rate:
        from fused_f32_probe import rate

        rate(c, device, "ghost")
    if not (args.arm or args.graph or args.faults):
        return 0
    import numpy as np

    batch = c.train_batch(np.random.RandomState(7), device, c.TRAIN_BATCH,
                          c.TRAIN_SIZE)
    snap = start = c.seeded_snap(device)
    if args.faults:  # first: the augmented state is --arm's start too
        import shutil

        root, _ = c.phase_data_write()
        start, _ = c.augmented_start(device, root, snap)
        shutil.rmtree(root)
        c.phase_ghost_faults(device, start, batch, "augmented", "float32")
    if args.graph:
        c.graph_equal(device, snap, c.scene_dataset(device),
                      np.random.RandomState(31), "ghost float32",
                      c.train_config("ghost", dtype="float32"))
    if args.arm:
        c.phase_ghost_train_f32(device, reports, snap, batch, start)
    print(f"ghost_f32_probe: {time.perf_counter() - t0:.1f} s; "
          f"{c.card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
