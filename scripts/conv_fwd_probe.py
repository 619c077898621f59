#!/usr/bin/env python3
"""Probe of csrc/conv_fwd.cu on one CUDA GPU: what ptxas makes of it, the
kernel against its plain version at every forward shape of the route,
and its device time beside igemm_fwd's and the library's.

    python3 scripts/conv_fwd_probe.py [--check-only | --sweep]

1. builds conv_fwd.cu once more with -Xptxas -v and prints the
   registers, shared memory and spills of each conv_fwd_tma<BN>;
2. holds matmul_rows and conv3 (tma_fwd) against their plain versions,
   within one bf16 ulp, and two launches bit-equal, at chip_smoke.py's
   forward tail shapes, then at every forward and dX shape of the 512^2
   batch-32 train step and every forward shape of detect at 8 x
   1280x768;
3. unless --check-only: the device time of each of those calls on
   conv_fwd.cu (tma_fwd), on conv.cu's igemm_fwd (narrow_fwd, which takes
   any shape) and of the library call (torch.matmul; F.conv2d, and for
   the 3x3 dX the faster of conv2d_input and F.conv2d of dY with the
   flipped weight), each from torch.profiler (the sum of the device
   entries of 5 calls, over 5: the wrappers' host time is left out;
   CUDA events where the profiler records nothing);
   the sums over the train shapes and a train step (each shape times its
   launches), and over detect's shapes;
4. with --sweep, in place of 3: the device time of conv_fwd.cu at each
   of those shapes under each column tile bn (64, 128; 16 where Co <=
   16) with the weight streamed and, for a 1x1 where it fits, resident,
   beside the plan's choice.

Exits 2 without CUDA.
"""

import argparse
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def device_ms(fn, iters=5):
    """Device ms a call: the profiler's device entries of `iters` calls,
    over `iters`; where it records none, CUDA events around 20 calls
    (which then include the host's launch time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ms = sum(e.self_device_time_total for e in prof.key_averages())
    if ms > 0:
        return ms / 1e3 / iters
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    for _ in range(20):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 20


def ptxas_report():
    """conv_fwd.cu built with -Xptxas -v: each kernel's resource lines."""
    from tensorflow_ocr_tpu_torch.ops import kernels as K

    K.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = K.BUILD_DIR / "conv_fwd_ptxas.so"
    proc = subprocess.run(
        [K._nvcc(), *K.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out),
         str(K.CSRC_DIR / "conv_fwd.cu")],
        capture_output=True, text=True, check=True)
    name = None
    for line in proc.stderr.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "warning" in line.lower() or (
                name and "conv_fwd_tma" in name and (
                    "registers" in line or "spill" in line)):
            print(f"ptxas {name}: {line.split(':', 1)[-1].strip()}")


def sweep(CV, kernel, xs, ws, device_ms):
    """Device ms of ``kernel`` (a tma_fwd product of x shape xs, weight
    shape ws) under each column tile and weight residency, by patching
    the plan's constants; the plan's own choice first."""
    n, ci, h, w = xs
    co, k = ws[0], ws[2]
    geo = (1, 1, n * h * w) if k == 1 else (n, h, w)
    p = CV.tma_fwd_plan(*geo, ci, co, k, CV._sms(0))
    out = [f"plan {p.bn}/{'r' if p.resident else 's'} {device_ms(kernel):.4f}"]
    saved = CV.FWD_BN, CV.MIN_A_SLOTS
    try:
        for bn in (16, 64, 128):
            if bn == 16 and co > 16:
                continue
            for res in ((False, True) if k == 1 else (False,)):
                CV.FWD_BN, CV.MIN_A_SLOTS = (bn,), (3 if res else 1 << 30)
                CV.tma_fwd_plan.cache_clear()
                q = CV.tma_fwd_plan(*geo, ci, co, k, CV._sms(0))
                if q.resident != res:
                    continue
                out.append(f"{bn}/{'r' if res else 's'} "
                           f"{device_ms(kernel):.4f}")
    finally:
        CV.FWD_BN, CV.MIN_A_SLOTS = saved
        CV.tma_fwd_plan.cache_clear()
    return "sweep: " + ", ".join(out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check-only", action="store_true",
                    help="build and check, time nothing")
    ap.add_argument("--sweep", action="store_true",
                    help="time conv_fwd.cu under each column tile and "
                    "weight residency instead")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("conv_fwd_probe: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as C
    from tensorflow_ocr_tpu_torch.ops import conv as CV

    print(C.card_line())
    ptxas_report()
    gen = torch.Generator().manual_seed(0)
    bf, cl = torch.bfloat16, torch.channels_last

    def act(n, c, h, w):
        return torch.randn(n, c, h, w, generator=gen).to(
            "cuda", bf).contiguous(memory_format=cl)

    def weight(co, ci, k):
        return (torch.randn(co, ci, k, k, generator=gen)
                / (k * k * ci) ** 0.5).to("cuda", bf)

    def calls(x, wt, k):
        """(kernel, plain, igemm_fwd, {label: library call}) of the
        forward of x (N, Ci, H, W) with wt (Co, Ci, k, k)."""
        n, ci, h, w = x.shape
        co = wt.shape[0]
        if k == 1:
            x2, w2 = CV.rows(x), wt[:, :, 0, 0].t()
            wk = w2.t().contiguous()
            return (lambda: CV.matmul_rows(x2, w2),
                    lambda: CV.matmul_rows_reference(x2, w2),
                    lambda: CV.narrow_fwd(x2, wk, 1, 1, n * h * w, ci, co, 1),
                    {"matmul": lambda: torch.matmul(x2, w2)})
        wk = wt.permute(0, 2, 3, 1).reshape(co, 9 * ci).contiguous()
        xr = CV.rows(x)
        return (lambda: CV.conv3(x, wt), lambda: CV.conv3_reference(x, wt),
                lambda: CV.narrow_fwd(xr, wk, n, h, w, ci, co, 3),
                {"conv2d": lambda: F.conv2d(
                    x, wt.contiguous(memory_format=cl), padding=1)})

    counts = C.route_shape_counts(C.TRAIN_BATCH, (C.TRAIN_SIZE,) * 2)
    cases = []  # (group, tag, launches a step, x, wt, k)
    for n, h, w, ci, co, k in C.FWD_TAIL_SHAPES:
        cases.append(("tail", f"{k}x{k} {ci}->{co} at {n}x{h}x{w}", 0,
                      (n, ci, h, w), (co, ci, k)))
    for (n, h, w, ci, co, k, s), c in counts.items():
        tag = f"{k}x{k} {ci}->{co} at {n}x{h}x{w}"
        cases.append(("train", f"fwd {tag}", c, (n, ci, h, w), (co, ci, k)))
        cases.append(("train", f"dx {tag}", c, (n, co, h, w), (ci, co, k)))
    for n, h, w, ci, co, k, _ in C.route_shapes(8, C.IMAGE_HW):
        cases.append(("detect", f"fwd {k}x{k} {ci}->{co} at {n}x{h}x{w}", 0,
                      (n, ci, h, w), (co, ci, k)))

    sums = {}
    for group, tag, launches, xs, ws in cases:
        # a dX is the forward of dY (N, Co, H, W) with the flipped,
        # channel-swapped weight (Ci, Co, k, k): random here as well
        x, wt = act(*xs), weight(*ws)
        k = ws[2]
        kernel, plain, narrow, library = calls(x, wt, k)
        name = "matmul_rows" if k == 1 else "conv3"
        if group == "train" and tag.startswith("dx") and k == 3:
            # the same function as conv2d_input of the forward weight
            wfwd = wt.flip(2, 3).transpose(0, 1).contiguous(
                memory_format=cl)
            shape = (xs[0], ws[0], xs[2], xs[3])
            library["conv2d_input"] = lambda: torch.nn.grad.conv2d_input(
                shape, wfwd, x, padding=1)
        route = "tma_fwd" if CV.tma_fwd_takes(xs[1]) else "narrow_fwd"
        got = kernel()
        torch.cuda.synchronize()
        err = C.bf16_close(f"{name} {group} {tag}", got, plain())
        C.check(torch.equal(got, kernel()), f"{name} {group} {tag}: two "
                "launches differ")
        line = f"{name} {group} {tag} ({route}): max abs err {err:.3e}"
        if args.sweep and route == "tma_fwd" and group != "tail":
            line += "; " + sweep(CV, kernel, xs, ws, device_ms)
        elif not args.check_only and not args.sweep:
            ms, nms = device_ms(kernel), device_ms(narrow)
            lib = {label: device_ms(fn) for label, fn in library.items()}
            lms = min(lib.values())
            bound = C.add_bound({}, 2 * x.numel() * ws[0] * k * k,
                                2 * (x.numel() * (1 + ws[0] / xs[1])
                                     + ws[0] * ws[1] * k * k))
            keys = ((group, 1), (f"{group}, a step", launches)) \
                if group == "train" else ((group, 1),)
            for key, mult in keys:
                acc = sums.setdefault((name, key), [0.0, 0.0, 0.0, 0.0])
                for i, v in enumerate((ms, nms, lms, bound)):
                    acc[i] += mult * v
            line += (f"; device ms: tma_fwd {ms:.4f}, igemm_fwd {nms:.4f}, "
                     f"library {lms:.4f} ({', '.join(f'{a} {b:.4f}' for a, b in lib.items())}), "
                     f"bound {bound:.4f}; kernel/library {ms / lms:.2f}")
        print(line, flush=True)
        del x, wt, got
    for (name, key), (ms, nms, lms, bound) in sums.items():
        print(f"{name} {key}: device ms tma_fwd {ms:.4f}, igemm_fwd "
              f"{nms:.4f}, library {lms:.4f}, bound {bound:.4f}")
    print("conv_fwd_probe: ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
