#!/usr/bin/env python3
"""Probe of the route's float32 conv kernels on one CUDA GPU.

    python3 scripts/conv_f32_probe.py [--arm] [--faults] [--sweep]
                                      [--rate] [--tree DIR]

1. builds conv_fwd.cu, conv_dw.cu and conv.cu with -Xptxas -v, all at
   once, and prints the registers, shared memory and spills of each float32
   kernel (conv_fwd_tma_f32, tdw_f32_wg, narrow_fwd_f32, narrow_dw_f32),
   ptxas's warnings and performance notes, and each conv_dw.cu float32
   kernel's tensor-core instructions in its machine code (cuobjdump
   -sass: HGMMA, wgmma; HMMA, mma.sync);
2. chip_smoke.py's float32 kernel phase: every train-step, tail and
   detect shape of the route, each kernel's error against the float64
   product beside the plain float32 version's, two launches bit-equal,
   kernel, plain and library ms;
3. with --faults: the readings that set chip_smoke.py's F32_ARM_* bounds,
   3 sound runs and the planted backward faults, from the augmented state
   (chip_smoke.py's phase 10b: the synthetic tiers written and 768
   augmented steps);
4. with --arm: the float32 detect with the route and chip_smoke.py's
   float32 arm (3 steps through Trainer.run, the launches, img/s, peak
   memory, the arm check against cuDNN in float32: from the augmented
   state with --faults, else from the seeded one, where even float32
   reads a gradient error of ~1.7e-2, PERF.md);
5. with --sweep (this checkout's kernels only): the route's float32 dW
   (conv_dw.cu) at each run length and widest column tile it takes
   (ops/conv.py DW32_RUN in 1, 2, 4 x DW32_BN in 64, 128), at every dW
   shape of phase 8b (the train step's and the tails): the largest error
   ratio against float64 over the plain float32 version's, bit-equal
   twice, and the kernel's ms summed over the train shapes and a step,
   beside the library's (torch.matmul / conv2d_weight in float32, TF32
   off), each pair's shapes timed in turn;
6. with --rate: the float32 pallas-conv arm's eager train img/s alone
   (chip_smoke.py's eager_rate after 3 steps through Trainer.run, from
   the seeded state), 3 windows of at least 5 s: run in fresh processes
   on two checkouts (--tree), it compares their steps.

--tree DIR runs the kernels of another checkout (e.g. a `git archive` of
the parent under the gitignored _smoke_checkout/). Exits 2 without CUDA.
"""

import argparse
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ("conv_fwd_tma_f32", "tdw_f32", "narrow_fwd_f32", "narrow_dw_f32")


def ptxas_report():
    """Each of conv_fwd.cu, conv_dw.cu and conv.cu built with -Xptxas -v:
    the resource lines of its float32 kernels."""
    from tensorflow_ocr_tpu_torch.ops import kernels as K

    K.BUILD_DIR.mkdir(parents=True, exist_ok=True)

    def one(src):
        out = K.BUILD_DIR / f"{src}_ptxas.so"
        return src, subprocess.run(
            [K._nvcc(), *K.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out),
             str(K.CSRC_DIR / f"{src}.cu")],
            capture_output=True, text=True)

    with ThreadPoolExecutor(3) as pool:
        for src, proc in pool.map(one, ("conv_fwd", "conv_dw", "conv")):
            if proc.returncode:
                print(proc.stderr[-6000:])
                raise SystemExit(f"nvcc failed on {src}.cu")
            name = None
            for line in proc.stderr.splitlines():
                if "Compiling entry function" in line:
                    name = line.split("'")[1]
                elif "warning" in line.lower() or "Performance" in line or (
                        name and any(k in name for k in KERNELS) and (
                            "registers" in line or "spill" in line)):
                    print(f"ptxas {src}.cu {name}: {line.strip()}")
            if src == "conv_dw":
                sass_counts(K, K.BUILD_DIR / f"{src}_ptxas.so", src)


def sass_counts(K, lib, src):
    """HGMMA and HMMA instructions of each float32 dW kernel (tdw_f32_wg,
    tdw_f32_tr) in lib, built from csrc/<src>.cu."""
    sass = subprocess.run(
        [os.path.join(os.path.dirname(K._nvcc()), "cuobjdump"), "-sass",
         str(lib)], capture_output=True, text=True, check=True).stdout
    name, counts = None, {}
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = [0, 0]
        elif name is not None:
            counts[name][0] += " HGMMA." in line
            counts[name][1] += " HMMA." in line
    for name, (hg, hm) in counts.items():
        if "tdw_f32" in name:
            print(f"sass {src}.cu {name}: {hg} HGMMA, {hm} HMMA")


def sweep(device):
    """Step 5 of the module docstring."""
    import torch
    import chip_smoke as c
    from tensorflow_ocr_tpu_torch.ops import conv as CV
    from tensorflow_ocr_tpu_torch.ops.fused import full_f32

    gen = torch.Generator().manual_seed(17)
    f64 = torch.float64
    counts = c.route_shape_counts(c.TRAIN_BATCH, (c.TRAIN_SIZE,) * 2)
    q = c.TRAIN_SIZE // 4
    train = [((n, h // s, w // s, ci, co, k), counts.get(
        (n, h, w, ci, co, k, s), 0)) for n, h, w, ci, co, k, s in
        tuple(counts) + ((c.TRAIN_BATCH, q, q, 256, 512, 1, 2),)]
    shapes = train + [(shape, None) for shape in c.DW_TAIL_SHAPES]
    configs = [(r, bn) for bn in (64, 128) for r in (1, 2, 4)]
    worst = dict.fromkeys(configs, 0.0)
    ms = {key: [0.0, 0.0] for key in configs + ["library"]}

    def act(n, ch, h, w):
        return torch.randn(n, h, w, ch, generator=gen).to(device).reshape(
            -1, ch)

    for (n, h, w, ci, co, k), launches in shapes:
        if not CV.tma_takes(ci, co):
            continue
        x2, dy2 = act(n, ci, h, w), act(n, co, h, w)
        if k == 1:
            def kernel():
                return CV.dw_rows(x2, dy2)
            exact = x2.to(f64).t() @ dy2.to(f64)
            plain = CV.dw_rows_reference(x2, dy2)

            def library():
                return torch.matmul(x2.t(), dy2)
        else:
            x = CV.unrows(x2, n, h, w)
            dy = CV.unrows(dy2, n, h, w)

            def kernel():
                return CV.dw3(x, dy)
            exact = CV.dw3_reference(x.to(f64), dy.to(f64))
            plain = CV.dw3_reference(x, dy)

            def library():
                return torch.nn.grad.conv2d_weight(x, (co, ci, 3, 3), dy,
                                                   padding=1)
        perr = float((plain.to(f64) - exact).abs().max())
        line = []
        for key in configs:
            CV.DW32_RUN, CV.DW32_BN = key
            CV.tma_dw_plan.cache_clear()
            got = kernel()
            ratio = float((got.to(f64) - exact).abs().max()) / perr
            c.check(torch.equal(got, kernel()), f"sweep R {key[0]} BN "
                    f"{key[1]} at {(n, h, w, ci, co, k)}: two launches "
                    "differ")
            worst[key] = max(worst[key], ratio)
            line.append(f"R{key[0]}/BN{key[1]} x{ratio:.2f}")
            if launches is not None:
                t = c.cuda_ms(kernel, 10)
                ms[key][0] += t
                ms[key][1] += launches * t
                line[-1] += f" {t:.4f}"
        if launches is not None:
            with full_f32():
                library()
                t = c.cuda_ms(library, 10)
            ms["library"][0] += t
            ms["library"][1] += launches * t
            line.append(f"library {t:.4f}")
        print(f"sweep {k}x{k} {ci}->{co} at {n}x{h}x{w}: " + ", ".join(line))
        del x2, dy2, exact, plain
    for key in configs:
        print(f"sweep R {key[0]} BN {key[1]}: worst error ratio "
              f"{worst[key]:.3f}; train shapes {ms[key][0]:.4f} ms, a step "
              f"{ms[key][1]:.4f} ms")
    print(f"sweep library: train shapes {ms['library'][0]:.4f} ms, a step "
          f"{ms['library'][1]:.4f} ms")
    CV.tma_dw_plan.cache_clear()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arm", action="store_true")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--rate", action="store_true")
    ap.add_argument("--tree", default=REPO)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("conv_f32_probe: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.tree))
    import chip_smoke as c

    t0 = time.perf_counter()
    device = torch.device("cuda", 0)
    print(f"card: {c.card_line()}; torch {torch.__version__}")
    ptxas_report()
    c.build_all()
    if args.sweep:
        from tensorflow_ocr_tpu_torch.ops import conv as CV

        chosen = CV.DW32_RUN, CV.DW32_BN
        sweep(device)
        CV.DW32_RUN, CV.DW32_BN = chosen
    reports = {n: {} for n in c.CONV_F32_KERNELS}
    c.phase_conv_kernels_f32(device, reports)
    if args.arm or args.faults or args.rate:
        import numpy as np

        batch = c.train_batch(np.random.RandomState(7), device,
                              c.TRAIN_BATCH, c.TRAIN_SIZE)
        snap = start = c.seeded_snap(device)
    if args.faults:
        import shutil

        root, _ = c.phase_data_write()
        start, _ = c.augmented_start(device, root, snap)
        shutil.rmtree(root)
        c.phase_conv_faults(device, start, batch, "augmented", "float32")
    if args.rate:
        from tensorflow_ocr_tpu_torch.train import trainer as T

        cfg = c.train_config("xla", dtype="float32")
        base = c.arm_memory_start()
        with c.pallas_convs(True):
            trainer = T.Trainer(cfg, device)
            trainer.setup(weights=snap)
            trainer.run([batch] * c.TRAIN_STEPS, c.TRAIN_STEPS)
            c.eager_rate(trainer.state, batch, cfg,
                         "xla pallas-conv float32", 3, 5.0, base)
        del trainer
    if args.arm:
        pred, images = c.phase_main_path(device, {})
        c.phase_conv_detect_f32(pred, images)
        del pred
        c.phase_conv_train_f32(device, reports, snap, batch, start)
    print(f"conv_f32_probe: {time.perf_counter() - t0:.1f} s; {c.card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
