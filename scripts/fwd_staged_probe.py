#!/usr/bin/env python3
"""Where the staged forward's time goes (csrc/conv_bwd.cuh ``tdx`` in its
forward mode, through fused_conv.cu's fused_conv_fwd) on one CUDA GPU.

    python3 scripts/fwd_staged_probe.py [--plans]

At six forward shapes of the 512^2 batch-32 train step, prints the device
ms (torch.profiler, the wrapper's host time left out) of:

- ``built``: fused_conv_fwd as the checkout builds it, and conv_fwd_tma
  (ops/conv.py tma_fwd: the unstaged forward of the PALLAS_CONVS route,
  no transform and no sums) on the same x and weight;
- three variants of fused_conv_fwd, each built in a process of its own
  from a copy of the checkout (under tensorflow_ocr_tpu_torch/build/)
  with one edit to csrc/conv_bwd.cuh: ``norewrite`` (x enters as it is),
  ``noact`` (the register path's loads and products without the
  arithmetic of relu(x*a + b)), ``tabconst`` (that arithmetic on
  constant tables, no table loads). The variants compute other
  functions: they only split the time.

With --plans, also the device ms of fused_conv_fwd under every plan that
fits the shared memory (box, bn, resident weight, epilogue slots, the
most ring slots), the best six and the default, each y checked equal to
the default's where the K order is the same. Exits 2 without CUDA.
"""

import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADER = os.path.join("tensorflow_ocr_tpu_torch", "csrc", "conv_bwd.cuh")
# (N, H, W, Ci, Co, k)
SHAPES = ((32, 32, 32, 512, 1024, 1), (32, 128, 128, 64, 256, 1),
          (32, 16, 16, 1024, 2048, 1), (32, 32, 32, 256, 1024, 1),
          (32, 32, 32, 256, 256, 3), (32, 64, 64, 128, 128, 3))
VARIANTS = {
    "norewrite": [("const bool rewrite = !FWD || tr.x_on();",
                   "const bool rewrite = !FWD;")],
    "noact": [("    return live ? *reinterpret_cast<const uint32_t*>(&h)"
               " : 0u;", "    return live ? x : 0u;")],
    "tabconst": [("const float4 lo = tr.ab2(key, ch), hi = tr.ab2(key, ch"
                  " + 8);", "const float4 lo = make_float4(1.f, 1.f, 0.5f, "
                  "0.5f), hi = lo;")],
}
PARTS = {"k": ("tdx<", "reduce_parts", "conv_fwd_tma")}


def inputs(n, h, w, ci, co, k):
    import torch

    gen = torch.Generator().manual_seed(ci * co + k)
    dev, bf = torch.device("cuda", 0), torch.bfloat16
    x = torch.randn(n, ci, h, w, generator=gen).to(dev, bf).contiguous(
        memory_format=torch.channels_last)
    ab = torch.stack([torch.rand(ci, generator=gen) + 0.5,
                      torch.randn(ci, generator=gen)]).to(dev)
    wt = (torch.randn(co, ci, k, k, generator=gen)
          / (k * k * ci) ** 0.5).to(dev, bf)
    return x, ab, wt


def measure(label):
    """One line of device ms at SHAPES for fused_conv_fwd (and, for the
    checkout as built, conv_fwd_tma beside it)."""
    sys.path.insert(0, REPO)
    import chip_smoke as C
    from tensorflow_ocr_tpu_torch.ops import conv as CV
    from tensorflow_ocr_tpu_torch.ops import fused as FU

    out = []
    for n, h, w, ci, co, k in SHAPES:
        x, ab, wt = inputs(n, h, w, ci, co, k)
        ms = C.kernel_device_ms(lambda: FU.conv_fwd(x, ab, wt), PARTS,
                                iters=10)["k"]
        item = f"{k}x{k} {ci}->{co} {h}^2 {ms:.4f}"
        if label == "built":
            x2 = x.permute(0, 2, 3, 1).reshape(-1, ci)
            w2 = wt.permute(0, 2, 3, 1).reshape(co, k * k * ci).contiguous()
            geo = (1, 1, n * h * w) if k == 1 else (n, h, w)
            tma = C.kernel_device_ms(
                lambda: CV.tma_fwd(x2, w2, *geo, ci, co, k), PARTS,
                iters=10)["k"]
            item += f" (conv_fwd_tma {tma:.4f})"
        out.append(item)
    print(f"{label}: " + "; ".join(out), flush=True)


def variant(name):
    """Build and measure one variant in a copy of the checkout."""
    dst = os.path.join(REPO, "tensorflow_ocr_tpu_torch", "build",
                       f"probe_{name}")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(REPO, dst, ignore=shutil.ignore_patterns(
        "build", "chiprun_out", "_smoke_checkout", ".git", "__pycache__"))
    path = os.path.join(dst, HEADER)
    with open(path) as f:
        text = f.read()
    for old, new in VARIANTS[name]:
        if old not in text:
            raise RuntimeError(f"variant {name}: {old!r} not in {HEADER}")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    subprocess.run([sys.executable,
                    os.path.join("scripts", "fwd_staged_probe.py"),
                    "--measure", name], cwd=dst, check=True)
    shutil.rmtree(dst, ignore_errors=True)


def plans():
    """fused_conv_fwd under every plan that fits, at SHAPES."""
    sys.path.insert(0, REPO)
    import chip_smoke as C
    import torch
    from tensorflow_ocr_tpu_torch.ops import conv as CV
    from tensorflow_ocr_tpu_torch.ops import fused as FU

    default = CV.tma_staged_fwd_plan

    def smem(p, ci, k):
        ksteps = (3 if p.halo else k * k) * (ci // 64)
        if p.halo:
            stage = CV.round1k((p.wb + 2) * p.hb * 128) + 3 * p.bn * 128
        else:
            stage = CV.TM * 128 + (0 if p.resident else p.bn * 128)
        return (p.stages * stage + p.resident * ksteps * p.bn * 128
                + p.eslots * CV.TM * p.bn * 2 + 9 * 2 * p.bn * 4
                + 8 * (2 * p.stages + 7) + 1024)

    for n, h, w, ci, co, k in SHAPES:
        x, ab, wt = inputs(n, h, w, ci, co, k)
        geo = (1, 1, n * h * w) if k == 1 else (n, h, w)
        ref = FU.conv_fwd(x, ab, wt)[0]
        base = default(*geo, ci, co, k, CV._sms(0))
        cands = [("default", base)]
        for wb in ((128, 64, 32, 16) if k == 3 else (128,)):
            hb = CV.TM // wb
            for bn in (64, 128):
                for res in ((0, 1) if k == 1 else (0,)):
                    for es in (1, 2, 3):
                        rt = geo[0] * -(-geo[1] // hb) * -(-geo[2] // wb)
                        ct = co // bn
                        grid = min(rt * ct, CV._sms(0))
                        grid = max(ct, grid - grid % ct)
                        fits = [st for st in range(2, CV.MAX_FWD_STAGES + 1)
                                if smem(CV.TmaBwdDxPlan(
                                    wb, hb, bn, bool(res), st, grid, rt, ct,
                                    k == 3 and wb >= 64, es), ci, k)
                                <= CV.MAX_SMEM]
                        if fits:
                            cands.append((f"wb{wb} bn{bn} res{res} es{es} "
                                          f"st{fits[-1]}", CV.TmaBwdDxPlan(
                                              wb, hb, bn, bool(res), fits[-1],
                                              grid, rt, ct,
                                              k == 3 and wb >= 64, es)))
        res_ms = []
        for name, p in cands:
            CV.tma_staged_fwd_plan = lambda *a, _p=p: _p
            try:
                y = FU.conv_fwd(x, ab, wt)[0]
                same = p.halo != base.halo or torch.equal(y, ref)
                ms = C.kernel_device_ms(lambda: FU.conv_fwd(x, ab, wt),
                                        PARTS, iters=10)["k"]
                res_ms.append((ms, name, same))
            finally:
                CV.tma_staged_fwd_plan = default
        res_ms.sort()
        best = "; ".join(f"{nm} {ms:.4f}{'' if ok else ' y differs'}"
                         for ms, nm, ok in res_ms[:6])
        dflt = next(ms for ms, nm, _ in res_ms if nm == "default")
        print(f"plans {k}x{k} {ci}->{co} at {n}x{h}x{w}: {best} | default "
              f"{dflt:.4f}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("fwd_staged_probe: torch sees no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--measure"]:
        measure(sys.argv[2])
        return 0
    sys.path.insert(0, REPO)
    import chip_smoke as C

    print(C.card_line())
    C.build_all()
    measure("built")
    for name in VARIANTS:
        variant(name)
    if "--plans" in sys.argv[1:]:
        plans()
    print(C.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
