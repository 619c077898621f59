#!/usr/bin/env python3
"""Probe of the seam pass (csrc/ghost_unit.cu tseam, through ops/ghost.py
seam_bwd) and of the connected-components kernel (csrc/cc.cu) on one
CUDA GPU.

    python3 scripts/seam_cc_probe.py [--plans]

1. the seam at the 4 ghost unit shapes of the 512^2 batch-32 step
   (chip_smoke.py GHOST_SHAPES): against its plain version, whether two
   launches are bit-equal, its time by CUDA events, its device time (tseam and
   reduce_parts, torch.profiler) and its wrapper's host time (the host
   clock around calls that enqueue without waiting) beside the bytes
   bound; then at two wider seams of ghost units that smaller images run
   (256 and 512 channels, the weight streamed); with --plans, every
   other plan that fits (weight resident or streamed x ring slots), each
   held bit-equal to the default plan's output;
2. the connected components on chip_smoke.py's cases: labels against the
   plain version, the time by CUDA events, the wrapper's host time, and
   the device time of each of the three launches (cc_local, cc_border,
   cc_flatten).

Both read only names that chip_smoke.py has had since the port's ghost
slice, and name the kernels of either design (the seam's gseam or tseam
with reduce_parts; the connected components' cc_* launches), so the
script also runs from a checkout of an earlier tree, copied into its
scripts/, to time that tree's kernels in the same call.

Exits 2 without CUDA.
"""

import argparse
import itertools
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# device time by kernel name, either design's
SEAM_PARTS = {"seam": ("tseam<", "gseam<", "reduce_parts")}
# seams of ghost units that smaller images run (256 and 512 channels: the
# weight streamed with each K step, not resident), after the step's four
WIDE_SHAPES = ((32, 32, 32, 256, 256, 1024, 8), (32, 16, 16, 512, 512, 2048, 8))
CC_NAMES = ("cc_init", "cc_local", "cc_merge", "cc_border", "cc_flatten")


def host_ms(fn, iters=20):
    """Milliseconds of host time a call of ``fn``: the host clock around
    ``iters`` calls that enqueue without waiting, after a synchronise."""
    import time
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * t / iters


def seam(C, device, plans):
    import torch
    from tensorflow_ocr_tpu_torch.ops import conv as CV
    from tensorflow_ocr_tpu_torch.ops import ghost as G

    gen = torch.Generator().manual_seed(9)
    cl = torch.channels_last
    default_plan = getattr(G, "seam_plan", None)
    total = dict(ms=0.0, device=0.0, bound=0.0)
    for shape in C.GHOST_SHAPES + WIDE_SHAPES:
        n, h, w, _, c, _, gh = shape
        nb = h // gh

        def act(dtype=torch.bfloat16):
            return torch.randn(n, c, h, w, generator=gen).to(
                device=device, dtype=dtype).contiguous(memory_format=cl)

        tab = lambda k: torch.randn(n, nb, k, c, generator=gen).to(device)  # noqa: E731
        td, tx = tab(3), tab(2)
        tx[:, :, 0] = tx[:, :, 0].abs() + 0.5
        args = (act(torch.float32), act(), td, act(), tx,
                (torch.randn(c, c, 3, 3, generator=gen) / (9 * c) ** 0.5).to(
                    device=device, dtype=torch.bfloat16), gh)
        want = G.seam_bwd_reference(*args)
        got, again = G.seam_bwd(*args), G.seam_bwd(*args)
        torch.cuda.synchronize()
        # recorded, not required: an earlier tree's seam summed with
        # atomics
        equal = all(torch.equal(a, b) for a, b in zip(got, again))
        C.f32_close("seam edge", got[0], want[0])
        ms = C.cuda_ms(lambda: G.seam_bwd(*args), 20)
        host = host_ms(lambda: G.seam_bwd(*args))
        dev = C.kernel_device_ms(lambda: G.seam_bwd(*args), SEAM_PARTS,
                                 20)["seam"]
        bound = 1e3 * (2 * n * nb * w * c * 12 + 18 * c * c) / C.PEAK_HBM
        p = default_plan and default_plan(n, h, w, c, gh, CV._sms(0))
        print(f"seam c {c} at {n}x{h}x{w} gh {gh}: {ms:.4f} ms by events, "
              f"device {dev:.4f}, host {host:.4f}, bound {bound:.4f}; "
              f"bit-equal twice: {'yes' if equal else 'no'}; plan {p}")
        if shape in C.GHOST_SHAPES:
            for k, v in (("ms", ms), ("device", dev), ("bound", bound)):
                total[k] += v
        if not plans or p is None:
            continue
        for resident, stages in itertools.product(
                (True, False), range(2, G.SEAM_MAX_STAGES + 1)):
            q = p._replace(
                resident=resident, stages=stages,
                smem=G.seam_smem(p.nseg, p.ct, c // 64, resident, stages))
            if q.smem > CV.MAX_SMEM or q == p:
                continue
            G.seam_plan = lambda *a, q=q: q  # noqa: E731
            try:
                out = G.seam_bwd(*args)
                torch.cuda.synchronize()
                C.check(all(torch.equal(a, b) for a, b in zip(out, got)),
                        f"seam plan {q}: differs from the default's")
                d = C.kernel_device_ms(lambda: G.seam_bwd(*args),
                                       SEAM_PARTS, 20)["seam"]
            finally:
                G.seam_plan = default_plan
            print(f"  resident {int(resident)} stages {stages}: "
                  f"device {d:.4f}")
    print(f"seam over the {len(C.GHOST_SHAPES)} shapes: {total['ms']:.4f} ms "
          f"by events, device {total['device']:.4f}, bound "
          f"{total['bound']:.4f}")


def cc(C, device):
    import torch
    from tensorflow_ocr_tpu_torch.ops import kernels as K

    gen = torch.Generator().manual_seed(0)
    cases = ([("blobs", *C.blob_maps(gen, C.SHAPE, device))]
             + C.hand_cases(device)
             + [("ragged_blobs", *C.blob_maps(gen, (3, 100, 150), device))])
    parts = {k: (k,) for k in CC_NAMES}
    for name, edges, mask in cases:
        got = K.connected_components(edges, mask)
        want = K.connected_components_reference(edges, mask,
                                                max_iters=1 << 20)
        C.check(torch.equal(got, want), f"cc {name}: labels differ")
        ms = C.cuda_ms(lambda: K.connected_components(edges, mask), 50)
        host = host_ms(lambda: K.connected_components(edges, mask))
        dev = C.kernel_device_ms(lambda: K.connected_components(edges, mask),
                                 parts, 20)
        print(f"cc {name} {tuple(mask.shape)}: {ms:.4f} ms by events, host "
              f"{host:.4f}; device "
              + ", ".join(f"{k} {v:.4f}" for k, v in dev.items() if v)
              + f", all {sum(dev.values()):.4f}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--plans", action="store_true",
                    help="also time every seam plan that fits")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("seam_cc_probe: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as C

    device = torch.device("cuda", 0)
    print(C.card_line())
    C.build_all()
    seam(C, device, args.plans)
    cc(C, device)
    print(C.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
