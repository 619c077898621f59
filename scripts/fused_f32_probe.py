#!/usr/bin/env python3
"""Probe of the fused arm's float32 kernels on one CUDA GPU.

    python3 scripts/fused_f32_probe.py [--arm] [--graph] [--faults]
                                       [--split] [--sweep] [--sweep-dw]
                                       [--rate] [--tree DIR]

1. builds fused_conv.cu, fused_boundary.cu and conv_dw.cu with -Xptxas
   -v, all at once, and prints the registers, shared memory and spills of
   each float32 kernel (tdx_f32, the dW tdw_f32_tr, bnd_fwd_f32,
   bnd_bwd_f32) and each float32 dW kernel's tensor-core instructions in
   its machine code (cuobjdump -sass: HGMMA, wgmma; HMMA, mma.sync);
2. chip_smoke.py's phase 11b: every fused conv and boundary shape of the
   512^2 batch-32 step in float32, each output's error against the
   float64 result beside the plain float32 version's, two launches
   bit-equal, kernel, plain and conv-alone ms;
3. with --graph: phase 17's graph = eager check of the float32 fused arm;
4. with --arm: chip_smoke.py's float32 fused detect (phase 9c) and the
   float32 fused arm (phase 11c: 3 steps through Trainer.run, the
   launches, img/s, peak memory, the arm check against the float32 "xla"
   arm: from the augmented state with --faults, else from the seeded
   one);
5. with --faults: the readings that set chip_smoke.py's F32_FUSED_ARM_*
   bounds, 3 sound runs and the planted backward faults (dW, dX and the
   boundary's dz x 0.9), from the augmented state (chip_smoke.py's phase
   10b: the synthetic tiers written and 768 augmented steps);
6. with --split: the float32 backward at each conv shape of phase 11b,
   its dW and its dX kernels' device ms apart (torch.profiler: the dW
   kernel, tdw_f32_tr or an older checkout's tdw_f32, and sum_tables_wide;
   tdx_f32, reduce_parts_wide and the weight's tf32_split_rows), summed
   over the shapes and over a train step (each shape's launches), beside
   the dX's own bound (fused_dx_bounds);
7. with --sweep (this checkout's kernels only): the float32 forward and
   dX kernel (tdx_f32, with its sums' reduction and the weight's split)
   at every conv shape of phase 11b under each of tdx_f32's choices
   (ops/conv.py DX32_BN (64,) or (128, 64), DX32_OVERLAP, DX32_RESIDENT):
   device ms by torch.profiler, a line a shape, and each choice's sum
   over the shapes and over a train step; with --sweep-dw, phase 11b at
   each run length the dW takes (ops/conv.py DW32_RUN 1, 2, 4), its
   checks recorded rather than raised: the worst dW error ratio to the
   plain version's and the backward's ms over the shapes at each.

8. with --rate: the float32 fused arm's eager train img/s alone (3
   steps through Trainer.run from the seeded state, then chip_smoke.py's
   eager_rate over 3 windows of at least 5 s): run in fresh processes on
   two checkouts (--tree), it compares their steps.

--tree DIR runs the kernels and phases of another checkout (e.g. a `git
archive` of the parent under the gitignored _smoke_checkout/), and skips
step 1 (the resource report is this checkout's). Exits 2 without CUDA.
"""

import argparse
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ("tdx_f32", "tdw_f32", "bnd_fwd_f32", "bnd_bwd_f32")
# the float32 conv backward's kernels by name, this checkout's and an
# older one's: its dW and its dX
F32_BWD_PARTS = {"dW": ("tdw_f32", "sum_tables_wide"),
                 "dX": ("tdx_f32", "reduce_parts_wide", "tf32_split_rows")}


def ptxas_report():
    """Each of fused_conv.cu, fused_boundary.cu and conv_dw.cu built with
    -Xptxas -v: the resource lines of its float32 kernels."""
    from tensorflow_ocr_tpu_torch.ops import kernels as K

    K.BUILD_DIR.mkdir(parents=True, exist_ok=True)

    def one(src):
        out = K.BUILD_DIR / f"{src}_ptxas.so"
        return src, subprocess.run(
            [K._nvcc(), *K.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out),
             str(K.CSRC_DIR / f"{src}.cu")],
            capture_output=True, text=True)

    srcs = ("fused_conv", "fused_boundary", "conv_dw")
    with ThreadPoolExecutor(len(srcs)) as pool:
        for src, proc in pool.map(one, srcs):
            if proc.returncode:
                print(proc.stderr[-6000:])
                raise SystemExit(f"nvcc failed on {src}.cu")
            name = None
            for line in proc.stderr.splitlines():
                if "Compiling entry function" in line:
                    name = line.split("'")[1]
                elif "warning" in line.lower() or (
                        name and any(k in name for k in KERNELS) and (
                            "registers" in line or "spill" in line)):
                    print(f"ptxas {src}.cu {name}: {line.strip()}")
            if src == "fused_conv":
                from conv_f32_probe import sass_counts

                sass_counts(K, K.BUILD_DIR / f"{src}_ptxas.so", src)


def dx_bound(c, m, ci, co, k, nbytes):
    """The float32 dX's least time on the card (ms): its operations (2 m
    k^2 ci co, split TF32) over chip_smoke's PEAK_F32_SPLIT or ``nbytes``
    over PEAK_HBM, the larger."""
    return 1e3 * max(2 * m * k * k * ci * co / c.PEAK_F32_SPLIT,
                     nbytes / c.PEAK_HBM)


def fused_dx_bounds(c):
    """The fused float32 dX's bound over phase 11b's shapes and over a
    train step (each shape's launches): it reads dy, y and x once and
    writes dx (f32), reads the weight, ds and the table, writes dab."""
    counts = c.fused_shape_counts()
    over = step = 0.0
    for n, h, w, ci, co, k in c.CONV_SHAPES:
        m = n * h * w
        b = dx_bound(c, m, ci, co, k, 4 * m * (2 * co + 2 * ci)
                     + 4 * k * k * ci * co + 8 * (ci + co) + 8 * ci)
        over += b
        step += counts[(n, h, w, ci, co, k)] * b
    return over, step


def split(c, device):
    """Step 6 of the module docstring."""
    import torch
    from tensorflow_ocr_tpu_torch.ops import fused as FU

    gen = torch.Generator().manual_seed(21)
    counts = c.fused_shape_counts()
    tot = {part: [0.0, 0.0] for part in F32_BWD_PARTS}

    def rand(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen).mul_(scale).to(device)

    for n, h, w, ci, co, k in c.CONV_SHAPES:
        launches = counts[(n, h, w, ci, co, k)]
        cl = torch.channels_last
        x = rand(n, ci, h, w).contiguous(memory_format=cl)
        y = rand(n, co, h, w).contiguous(memory_format=cl)
        dy = rand(n, co, h, w, scale=1e-2).contiguous(memory_format=cl)
        ab = torch.stack([rand(ci).abs_().add_(0.5), rand(ci, scale=0.5)])
        ds = torch.stack([rand(co, scale=1e-3), rand(co, scale=1e-4)])
        wt = rand(co, ci, k, k, scale=(k * k * ci) ** -0.5)
        ms = c.kernel_device_ms(lambda: FU.conv_bwd(x, ab, wt, y, dy, ds),
                                F32_BWD_PARTS)
        for part, v in ms.items():
            tot[part][0] += v
            tot[part][1] += launches * v
        print(f"split fused bwd f32 {k}x{k} {ci}->{co} at {n}x{h}x{w} "
              f"({launches} a step): device dW {ms['dW']:.4f} ms, dX "
              f"{ms['dX']:.4f} ms")
        del x, y, dy
    bover, bstep = fused_dx_bounds(c)
    print(f"split fused bwd f32 over the {len(c.CONV_SHAPES)} shapes: dW "
          f"{tot['dW'][0]:.4f} ms, dX {tot['dX'][0]:.4f} ms (bound "
          f"{bover:.4f}); a train step: dW {tot['dW'][1]:.4f} ms, dX "
          f"{tot['dX'][1]:.4f} ms (bound {bstep:.4f}); {c.card_line()}")


# tdx_f32 and the launches around it: its sums' reductions and the
# weight's split
DX32_PARTS = {"tdx": ("tdx_f32", "reduce_parts_wide", "reduce_groups_wide",
                      "tf32_split_rows")}
# tdx_f32's choices the sweep times: (ops/conv.py DX32_BN, DX32_OVERLAP,
# DX32_RESIDENT)
DX32_CHOICES = [(bn, ovl, res) for bn in ((64,), (128, 64))
                for ovl in (False, True) for res in (False, True)]


def dx_sweep(c, calls):
    """Step 7 of the module docstring (and of ghost_f32_probe.py's): calls
    are (label, launches a step, fn) with fn one call of a float32 forward
    or backward; tdx_f32's device ms in each under each choice, a line a
    call, then each choice's sums."""
    from tensorflow_ocr_tpu_torch.ops import conv as CV

    saved = CV.DX32_BN, CV.DX32_OVERLAP, CV.DX32_RESIDENT
    tot = {ch: [0.0, 0.0] for ch in DX32_CHOICES}
    try:
        for label, launches, fn in calls:
            row = []
            for ch in DX32_CHOICES:
                CV.DX32_BN, CV.DX32_OVERLAP, CV.DX32_RESIDENT = ch
                CV.tma_bwd_dx_plan.cache_clear()
                ms = c.kernel_device_ms(fn, DX32_PARTS)["tdx"]
                tot[ch][0] += ms
                tot[ch][1] += launches * ms
                row.append(f"{ms:.4f}")
            print(f"sweep tdx_f32 {label} ({launches} a step): "
                  + " ".join(row))
    finally:
        CV.DX32_BN, CV.DX32_OVERLAP, CV.DX32_RESIDENT = saved
        CV.tma_bwd_dx_plan.cache_clear()
    print("sweep tdx_f32 columns: " + " ".join(
        f"bn{ch[0][0]}/ovl{int(ch[1])}/res{int(ch[2])}"
        for ch in DX32_CHOICES))
    for ch, (over, step) in tot.items():
        print(f"sweep tdx_f32 BN {ch[0]} overlap {ch[1]} resident {ch[2]}: "
              f"{over:.4f} ms over the calls, {step:.4f} ms a train step; "
              f"{c.card_line()}")


def fused_calls(c, device):
    """(label, launches a step, fn) of the float32 fused forward and
    backward at every conv shape of phase 11b (random inputs made on the
    card from a seed)."""
    import torch
    from tensorflow_ocr_tpu_torch.ops import fused as FU

    gen = torch.Generator(device=device).manual_seed(23)
    counts = c.fused_shape_counts()
    cl = torch.channels_last

    def rand(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=device).mul_(scale)

    for n, h, w, ci, co, k in c.CONV_SHAPES:
        launches = counts[(n, h, w, ci, co, k)]
        x = rand(n, ci, h, w).contiguous(memory_format=cl)
        y = rand(n, co, h, w).contiguous(memory_format=cl)
        dy = rand(n, co, h, w, scale=1e-2).contiguous(memory_format=cl)
        ab = torch.stack([rand(ci).abs_().add_(0.5), rand(ci, scale=0.5)])
        ds = torch.stack([rand(co, scale=1e-3), rand(co, scale=1e-4)])
        wt = rand(co, ci, k, k, scale=(k * k * ci) ** -0.5)
        what = f"{k}x{k} {ci}->{co} at {n}x{h}x{w}"
        yield (f"fused fwd {what}", launches,
               lambda: FU.conv_fwd(x, ab, wt))
        yield (f"fused dX {what}", launches,
               lambda: FU.conv_bwd(x, ab, wt, y, dy, ds))


def sweep(c, device, phase, kernels, bwd):
    """--sweep-dw (and ghost_f32_probe.py's): the phase at each run
    length, chip_smoke's check and f32_rule wrapped so that a failed check
    is recorded and the dW's worst ratio kept."""
    from tensorflow_ocr_tpu_torch.ops import conv as CV

    saved = CV.DW32_RUN, c.check, c.f32_rule
    rule = c.f32_rule
    for run in (1, 2, 4):
        CV.DW32_RUN, failed, worst = run, [], [0.0]

        def f32_rule(name, got, want, exact):
            err, ratio = rule(name, got, want, exact)
            if " dw " in name:
                worst[0] = max(worst[0], ratio)
            return err, ratio

        c.check = lambda cond, msg: cond or failed.append(msg)
        c.f32_rule = f32_rule
        reports = {name: {} for name in kernels}
        print(f"sweep R {run}:")
        phase(device, reports)
        print(f"sweep R {run}: worst dW error ratio {worst[0]:.3f}; {bwd} "
              f"{reports[bwd]['ms']:.4f} ms over the shapes; "
              f"{len(failed)} checks failed"
              + "".join(f"\n  {m}" for m in failed))
    CV.DW32_RUN, c.check, c.f32_rule = saved


def rate(c, device, impl="fused"):
    """Step 8 of the module docstring (and of ghost_f32_probe.py's, with
    impl "ghost")."""
    import numpy as np
    from tensorflow_ocr_tpu_torch.train import trainer as T

    batch = c.train_batch(np.random.RandomState(7), device, c.TRAIN_BATCH,
                          c.TRAIN_SIZE)
    cfg = c.train_config(impl, dtype="float32")
    base = c.arm_memory_start()
    trainer = T.Trainer(cfg, device)
    trainer.setup(weights=c.seeded_snap(device))
    trainer.run([batch] * c.TRAIN_STEPS, c.TRAIN_STEPS)
    c.eager_rate(trainer.state, batch, cfg, f"{impl} float32", 3, 5.0, base)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arm", action="store_true")
    ap.add_argument("--graph", action="store_true")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--sweep-dw", action="store_true")
    ap.add_argument("--rate", action="store_true")
    ap.add_argument("--tree", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("fused_f32_probe: torch sees no CUDA device", file=sys.stderr)
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
    if args.sweep_dw:
        sweep(c, device, c.phase_fused_kernels_f32, c.FUSED_F32_KERNELS,
              "fused_conv_bwd_f32")
    if args.sweep:
        dx_sweep(c, fused_calls(c, device))
    reports = {n: {} for n in c.FUSED_F32_KERNELS}
    c.phase_fused_kernels_f32(device, reports)
    if args.split:
        split(c, device)
    if args.rate:
        rate(c, device)
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
        c.phase_fused_faults(device, start, batch, "augmented", "float32")
    if args.graph:
        c.graph_equal(device, snap, c.scene_dataset(device),
                      np.random.RandomState(31), "fused float32",
                      c.train_config("fused", dtype="float32"))
    if args.arm:
        pred, images = c.phase_main_path(device, {})
        c.phase_fused_detect_f32(pred, images)
        del pred
        c.phase_fused_train_f32(device, reports, snap, batch, start)
    print(f"fused_f32_probe: {time.perf_counter() - t0:.1f} s; "
          f"{c.card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
