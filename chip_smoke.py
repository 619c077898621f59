#!/usr/bin/env python3
"""Smoke test of the PyTorch port (tensorflow_ocr_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py [--profile]

Phases, in order; any failure raises and exits non-zero:

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build the connected-components kernel from csrc/ (nvcc, sm_90a);
3. hold the kernel against its plain PyTorch version on the card:
   (8, 192, 320) text-like blob maps plus hand cases; int32 labels must
   be equal; print both times;
4. full-width pixellink_resnet50 forward, float32, TF32 off, 256x256 on
   the card against the same seeded weights on the CPU;
5. the main path: Predictor.detect_batch at full width, bfloat16, on
   8 x 1280x768 uint8 images; the kernel's launch count must rise, and
   the boxes must equal those decoded from the same logits with the
   plain connected components;
6. time detect (p50, batch 1, 1280x768) and detect_batches (img/s,
   batch 8) after a warm-up, each over 3 windows of at least 10 s;
   print each window and the median of the three;
7. with --profile only: a torch.profiler trace of serve and of detect,
   printing wall time, device busy time, the device's idle share and
   the largest device entries.

The line before the last is a JSON object describing the kernels; the
last line is {"ok": true, "device": {...}}. Weights are random (seeded):
the check is that the port runs and agrees with itself and its plain
versions, not detection quality.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SHAPE = (8, 192, 320)          # label maps of a 1280x768 batch of 8
IMAGE_HW = (768, 1280)
MODEL = "pixellink_resnet50"
# phase 4: float32 on the card (TF32 off) vs the CPU differ only in the
# order of summation (and cuDNN's choice of algorithm) over ~55 convs
FWD_REL_TOL = 1e-4
# phase 6: each metric is read over WINDOWS windows of at least WINDOW_S
WINDOW_S = 10.0
WINDOWS = 3


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
    import torch

    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def blob_maps(gen, shape, device):
    """Text-like maps: random horizontal bars and noise pixels, links
    mostly on; returns (edges, mask) through the port's link_adjacency."""
    import torch
    from tensorflow_ocr_tpu_torch.ops.decode import link_adjacency

    b, h, w = shape
    mask = torch.zeros(shape, dtype=torch.bool)
    for i in range(b):
        n = int(torch.randint(10, 60, (1,), generator=gen))
        y0 = torch.randint(0, h - 4, (n,), generator=gen)
        x0 = torch.randint(0, w - 8, (n,), generator=gen)
        hh = torch.randint(2, 12, (n,), generator=gen)
        ww = torch.randint(4, 80, (n,), generator=gen)
        for y, x, dy, dx in zip(y0.tolist(), x0.tolist(), hh.tolist(),
                                ww.tolist()):
            mask[i, y:y + dy, x:x + dx] = True
    mask |= torch.rand(shape, generator=gen) < 0.02
    links = torch.rand(shape + (8,), generator=gen)
    mask, links = mask.to(device), links.to(device)
    return link_adjacency(mask, links, 0.15), mask


def hand_cases(device):
    """(name, edges, mask) for the edge cases of the labelling."""
    import torch
    from tensorflow_ocr_tpu_torch.ops.decode import link_adjacency

    b, h, w = SHAPE
    cases = []

    def add(name, mask):
        mask = mask.to(device)
        on = torch.ones(mask.shape + (8,), device=device)
        cases.append((name, link_adjacency(mask, on, 0.5), mask))

    add("empty", torch.zeros(1, h, w, dtype=torch.bool))
    add("full", torch.ones(1, h, w, dtype=torch.bool))
    single = torch.zeros(1, h, w, dtype=torch.bool)
    single[0, ::3, ::3] = True
    add("single_pixels", single)
    diag = torch.zeros(1, h, w, dtype=torch.bool)
    idx = torch.arange(min(h, w))
    diag[0, idx, idx] = True
    add("diagonal_chain", diag)
    serp = torch.zeros(1, h, w, dtype=torch.bool)
    serp[0, 0::2, :] = True
    for y in range(1, h, 2):
        serp[0, y, w - 1 if (y // 2) % 2 == 0 else 0] = True
    add("serpentine", serp)
    return cases


def phase_cc(device, report):
    import torch
    from tensorflow_ocr_tpu_torch.ops import kernels as K

    gen = torch.Generator().manual_seed(0)
    cases = [("blobs", *blob_maps(gen, SHAPE, device))] + hand_cases(device)
    max_err = 0
    for name, edges, mask in cases:
        got = K.connected_components(edges, mask)
        torch.cuda.synchronize()
        want = K.connected_components_reference(edges, mask)
        if name == "serpentine":
            uncapped = K.connected_components_reference(edges, mask,
                                                        max_iters=1 << 20)
            check(torch.equal(want, uncapped),
                  "serpentine: the plain version did not converge in its cap")
        check(got.dtype == torch.int32 and got.shape == mask.shape,
              f"{name}: labels {got.dtype} {tuple(got.shape)}")
        err = int((got.long() - want.long()).abs().max())
        max_err = max(max_err, err)
        check(torch.equal(got, want), f"{name}: kernel labels differ from "
              f"the plain version (max abs diff {err})")
    edges, mask = cases[0][1], cases[0][2]
    ms = cuda_ms(lambda: K.connected_components(edges, mask), 50)
    plain_ms = cuda_ms(
        lambda: K.connected_components_reference(edges, mask), 5)
    print(f"cc: {len(cases)} cases equal, labels (8,192,320): kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms")
    report.update(max_abs_err=max_err, ms=ms, plain_ms=plain_ms)


def perturb_bn(model, gen):
    """Non-trivial running statistics, so the eval-mode fold is exercised."""
    import torch
    from tensorflow_ocr_tpu_torch.models.layers import BatchNorm

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                n = m.weight.numel()
                m.weight.uniform_(0.8, 1.2, generator=gen)
                m.bias.copy_(torch.randn(n, generator=gen) * 0.05)
                m.running_mean.copy_(torch.randn(n, generator=gen) * 0.05)
                m.running_var.uniform_(0.8, 1.25, generator=gen)


def phase_forward(device):
    import torch
    from tensorflow_ocr_tpu_torch.models import build_model

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_model(MODEL, dtype=torch.float32,
                        generator=torch.Generator().manual_seed(1))
    perturb_bn(model, torch.Generator().manual_seed(2))
    x = torch.randint(0, 256, (1, 256, 256, 3), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(3))
    with torch.inference_mode():
        want = model(x)
        model.to(device)
        got = model(x.to(device))
    for key in ("pixel_logits", "link_logits"):
        g, w = got[key].cpu(), want[key]
        check(g.shape == w.shape == (1, 64, 64, w.shape[-1]),
              f"{key}: shape {tuple(g.shape)}")
        check(bool(torch.isfinite(g).all()), f"{key}: non-finite")
        rel = float((g - w).abs().max() / w.abs().max())
        print(f"forward f32 {key}: max|gpu-cpu|/max|cpu| = {rel:.3e} "
              f"(tol {FWD_REL_TOL:g})")
        check(rel <= FWD_REL_TOL, f"{key}: GPU and CPU forwards disagree")
    torch.backends.cudnn.allow_tf32 = True


def scene_images(rng, n):
    """uint8 (n, H, W, 3) scenes: flat colour patches crossed by dark
    text-like bars, so that even random weights give coherent maps."""
    import numpy as np

    h, w = IMAGE_HW
    coarse = rng.randint(0, 256, (n, h // 64 + 1, w // 64 + 1, 3))
    images = coarse.repeat(64, 1).repeat(64, 2)[:, :h, :w].astype(np.uint8)
    for img in images:
        for _ in range(rng.randint(8, 24)):
            y, x = rng.randint(0, h - 24), rng.randint(0, w - 200)
            img[y:y + rng.randint(8, 24), x:x + rng.randint(40, 200)] = (
                rng.randint(0, 60))
    return images


def phase_main_path(device, report):
    import numpy as np
    import torch
    from tensorflow_ocr_tpu_torch.infer import Predictor, pixel_link_scores
    from tensorflow_ocr_tpu_torch.ops import decode as D
    from tensorflow_ocr_tpu_torch.ops import kernels as K

    pred = Predictor(MODEL, device=device)
    images = scene_images(np.random.RandomState(0), 8)
    x = torch.from_numpy(images).to(device)
    # random weights saturate the softmax: scale the logits to unit
    # spread, then put the thresholds where components exist
    with torch.inference_mode():
        out = pred.model(x)
    with torch.no_grad():
        for tag in ("pixel", "link"):
            conv = getattr(pred.model.head, f"{tag}_logits")
            spread = float(out[f"{tag}_logits"].std())
            conv.weight /= spread
            conv.bias /= spread
    with torch.inference_mode():
        ps, ls = pixel_link_scores(pred.model(x))
    pred.pixel_thresh = float(torch.quantile(ps.float().flatten()[::7], 0.8))
    pred.link_thresh = float(torch.quantile(ls.float().flatten()[::7], 0.3))

    K.connected_components.launches = 0
    boxes = pred.detect_batch(images)
    torch.cuda.synchronize()
    launches = K.connected_components.launches
    check(launches > 0, "detect_batch did not launch the CC kernel")
    n_boxes = [len(b) for b in boxes]
    print(f"detect_batch 8x1280x768 bf16: boxes per image {n_boxes}, "
          f"cc launches {launches}, overflow retries {pred.overflow_retries}")
    check(len(boxes) == 8 and sum(n_boxes) > 0, "no boxes at all")
    check(all(np.isfinite(b).all() and b.shape == (4, 2)
              for bs in boxes for b in bs), "malformed boxes")

    # the same logits decoded with the plain connected components
    mask = ps > pred.pixel_thresh
    edges = D.link_adjacency(mask, ls, pred.link_thresh)
    labels = K.connected_components_reference(edges, mask)
    max_pixels = None if pred.overflow_retries == 0 else pred._FULL_BUDGET
    rb, _, rv = (t.cpu().numpy() for t in D.extract_components(
        labels, pred.infer.max_components, pred.min_size,
        max_pixels=max_pixels))
    for i in range(8):
        want = rb[i][rv[i]] * pred.stride
        check(len(boxes[i]) == len(want), f"image {i}: {len(boxes[i])} "
              f"boxes vs {len(want)} from the plain CC")
        check(all(np.array_equal(g, w) for g, w in zip(boxes[i], want)),
              f"image {i}: boxes differ from the plain CC decode")
    report["launches"] = launches
    return pred, images


def phase_timing(pred, images):
    import torch
    from tensorflow_ocr_tpu_torch.infer import pixel_link_scores
    from tensorflow_ocr_tpu_torch.ops.decode import pixellink_decode

    x = torch.from_numpy(images).to(pred.device)
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: pred.model(x), 20)
        ps, ls = pixel_link_scores(pred.model(x))
        dec_ms = cuda_ms(lambda: pixellink_decode(
            ps, ls, pred.pixel_thresh, pred.link_thresh, pred.min_size,
            pred.infer.max_components), 20)
    print(f"batch 8 1280x768 stages: forward {fwd_ms:.3f} ms, decode "
          f"{dec_ms:.3f} ms (CUDA events, mean of 20)")

    one = images[0]
    for _ in range(5):
        pred.detect(one)
    p50s = []
    for i in range(WINDOWS):
        lat = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < WINDOW_S:
            lat.append(pred.detect(one)[1])
        p50s.append(statistics.median(lat))
        print(f"detect window {i}: p50 {p50s[-1]:.3f} ms (min "
              f"{min(lat):.3f}, max {max(lat):.3f}, n={len(lat)})")
    print(f"detect 1280x768 batch 1: p50 {statistics.median(p50s):.3f} ms "
          f"(median of {WINDOWS} windows of >= {WINDOW_S:g} s; window p50s "
          f"{min(p50s):.3f}..{max(p50s):.3f})")

    for _ in pred.detect_batches([images] * 3):
        pass
    rates = []
    for i in range(WINDOWS):
        sent = 0
        t0 = time.perf_counter()

        def stream():
            nonlocal sent
            while time.perf_counter() - t0 < WINDOW_S:
                sent += 1
                yield images

        n = sum(len(r) for r in pred.detect_batches(stream(), depth=2))
        dt = time.perf_counter() - t0
        check(n == 8 * sent, "detect_batches lost results")
        rates.append(n / dt)
        print(f"serve window {i}: {rates[-1]:.2f} img/s ({sent} batches in "
              f"{dt:.3f} s)")
    print(f"detect_batches 1280x768 batch 8 depth 2: "
          f"{statistics.median(rates):.2f} img/s (median of {WINDOWS} "
          f"windows of >= {WINDOW_S:g} s; windows {min(rates):.2f}.."
          f"{max(rates):.2f})")


def device_busy_ms(prof) -> float:
    """Union of the device intervals in a profiler trace, in ms."""
    import torch

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1000


def phase_profile(pred, images):
    """Trace serve (6 batches of 8) and detect (5 calls at batch 1): wall
    time, device busy time, idle share, and the largest device entries.
    The profiler adds host time, so wall times are above phase 6's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    runs = (("serve batch 8 depth 2, 6 batches",
             lambda: list(pred.detect_batches([images] * 6, depth=2))),
            ("detect batch 1, 5 calls",
             lambda: [pred.detect(images[0]) for _ in range(5)]))
    for name, run in runs:
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1000
        busy = device_busy_ms(prof)
        check(busy > 0, f"profile {name}: no device events in the trace")
        print(f"profile {name}: wall {wall:.3f} ms, device busy {busy:.3f} "
              f"ms, idle share {1 - busy / wall:.3f}")
        print(prof.key_averages().table(sort_by="self_device_time_total",
                                        row_limit=15,
                                        max_name_column_width=60))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace serve and detect with torch.profiler")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "tensorflow_ocr_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    device = torch.device("cuda", 0)
    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"card: {card}")

    from tensorflow_ocr_tpu_torch.ops import kernels as K

    t0 = time.perf_counter()
    lib = K.build_library("cc")
    K._cc_label()
    print(f"build: {lib.name} in {time.perf_counter() - t0:.2f} s")

    report = {"name": "connected_components", "route": "cuda",
              "source": "tensorflow_ocr_tpu_torch/csrc/cc.cu",
              "replaces": "tensorflow_ocr_tpu/ops/pallas_kernels.py:91"}
    phase_cc(device, report)
    phase_forward(device)
    pred, images = phase_main_path(device, report)
    phase_timing(pred, images)
    if args.profile:
        phase_profile(pred, images)

    kernel = {k: report[k] for k in ("name", "route", "source", "replaces",
                                     "launches", "max_abs_err", "ms",
                                     "plain_ms")}
    print(card)
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
