#!/usr/bin/env python3
"""Smoke test of the PyTorch port (tensorflow_ocr_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py [--profile] [--faults]

Phases, in order; any failure raises and exits non-zero:

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build the seven CUDA sources of csrc/ (nvcc, sm_90a), one nvcc each,
   all started together;
3. hold the connected-components kernel against its plain PyTorch
   version on the card: (8, 192, 320) text-like blob maps, hand cases
   (the diagonal chains and the serpentines cross the kernel's tiles at
   their sides and corners) and a (3, 100, 150) batch of ragged tiles;
   int32 labels must be equal, and equal on two launches; print both
   times and the kernel's device time (replayed from a CUDA graph);
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
   the largest device entries;
8. hold each of the four conv kernels of the PALLAS_CONVS route
   (csrc/conv_fwd.cu, csrc/conv_dw.cu, and csrc/conv.cu for the narrow
   shapes) against its plain version at every distinct shape the route
   gives it in the 512^2 batch-32 train step (recorded from the model),
   plus one stride-2 1x1: forward y, dX and dW (each launched twice,
   bit-equal), plus the forward and dW tail shapes; then the forward y
   at every distinct shape of detect's forward (8 x 1280x768); print
   kernel, plain and library-call ms, the FLOPs, bytes and bound, and
   each kernel's ms a train step;
9. detect_batch with PALLAS_CONVS on: 44 + 13 conv launches a forward,
   all on conv_fwd.cu, logits within CONV_DETECT_REL of the cuDNN
   forward's, the CC kernel still launched;
10. hold each fused kernel against its plain version at every shape the
   train step gives it (the 15 1x1 and 4 3x3 convs of the fused units,
   the boundary of each block): forward y and s, backward dx, dab and
   dw (each forward and backward launched twice and held bit-equal);
   print kernel and plain ms, the forward's device ms and its conv-alone
   yardstick, the backward's dW and dX device ms (torch.profiler) and
   each conv kernel's ms a train step;
11. the train step at full width: pixellink_resnet50, bottleneck_impl
   "fused", 512x512, batch 32, bf16, labels made on the card from the
   polygons of numpy scenes; 3 steps through Trainer.run with finite
   losses and every fused kernel's launch count risen, the backward's
   launches by kernel (conv_bwd.cuh tdw and tdx) at 43 a step; one step
   each of the fused and the "xla" arm (plain Bottleneck, cuDNN convs) from one
   state (residual BN scales tempered, see ARM_RESIDUAL_SCALE) and
   batch: loss, gradient and the worst parameter's direction within the
   stated tolerances; one freeze_bn step;
12. with --faults only: the readings of the pallas-conv arm check
   (phase 13) in 3 sound runs and under planted backward faults, which
   set the CONV_ARM_* bounds;
13. the PALLAS_CONVS arm ("xla" bottlenecks, the supported convs on the
   conv kernels): 3 steps through Trainer.run with the four kernels'
   launch counts at their expected values, and the dW launches of each
   of the two dW kernels; one step against the same
   arm on cuDNN from the tempered state (CONV_ARM_* bounds); one
   freeze_bn step with the route on (the BN fold path);
14. hold each of the five ghost-BN kernels (csrc/ghost_unit.cu) against
   its plain version along one unit's forward and backward chain at
   each of the 4 ghost unit shapes of the 512^2 batch-32 step (each conv
   forward and backward, the boundary's backward and the seam pass
   launched twice and held bit-equal); print kernel and plain ms, the
   FLOPs, bytes and bound of each call, the conv forward's device ms and
   conv-alone yardstick, the conv backward's dW and dX and the seam's
   device ms, and each conv kernel's and the seam's ms a train step;
15. with --faults only: the readings of the ghost arm check (phase 16)
   in 3 sound runs and under planted faults, which set GHOST_ARM_*;
16. the ghost arm (bottleneck_impl "ghost": 5 ghost units, the other 8
   stride-1 units plain): 3 steps through Trainer.run with the five
   kernels' launch counts at their expected values (the conv backward's
   by kernel too); one step on the
   kernels against one on the plain versions from the tempered state
   (GHOST_ARM_* bounds); one freeze_bn step (no ghost kernel);
17. train img/s for the fused, xla, freeze_bn-fused, xla pallas-conv and
   ghost arms, each over 3 windows of at least 10 s (median and range);
18. with --profile only: a torch.profiler trace of 3 train steps of the
   fused, the xla pallas-conv and the ghost arm.

The line before the last is a JSON object describing the fourteen
kernels (launches from the main path of each: detect for the CC kernel,
the fused steps for the fused kernels, the pallas-conv steps for the
conv kernels, the ghost steps for the ghost kernels; times summed over
the shapes of each kernel's check); the last
line is {"ok": true, "device": {...}}. Weights are random (seeded):
the check is that the port runs and agrees with itself and its plain
versions, not detection quality.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SHAPE = (8, 192, 320)          # label maps of a 1280x768 batch of 8
RAGGED_SHAPE = (3, 100, 150)   # a batch of label maps of another size
IMAGE_HW = (768, 1280)
MODEL = "pixellink_resnet50"
# phase 4: float32 on the card (TF32 off) vs the CPU differ only in the
# order of summation (and cuDNN's choice of algorithm) over ~55 convs
FWD_REL_TOL = 1e-4
# phase 6: each metric is read over WINDOWS windows of at least WINDOW_S
WINDOW_S = 10.0
WINDOWS = 3
# the train phases: bench.py's train shape, steps of the main path, and
# train img/s read over TRAIN_WINDOWS windows of at least TRAIN_WINDOW_S
TRAIN_SIZE = 512
TRAIN_BATCH = 32
TRAIN_STEPS = 3
TRAIN_WINDOW_S = 10.0
TRAIN_WINDOWS = 3
# fused vs xla arm, one step each from one state and batch, in bf16. At
# the seeded init (every BN scale 1) the bf16 step is chaotic: two runs
# of the fused arm alone differ by a gradient relative error of ~1, as
# rounding noise grows through the batch-statistics backward of ~55 BN
# layers, so no tolerance could tell a fault from noise there. The check
# runs from the same state with the scale of each residual branch's last
# BN (conv3.bn.weight) times ARM_RESIDUAL_SCALE, as zero-init-residual
# schemes start: the step is then near-linear and the two arms agree to
# ~1.7e-2. The gradient bounds lie between the sound runs' largest
# reading and the smallest reading of a planted backward fault (PERF.md,
# Findings, which names the commit that holds the table; readings on an
# H100 80GB HBM3 at 700 W). The loss bound only catches coarse forward
# faults: a 1% error in the statistics moves the loss by ~3e-4 (phase 10
# holds the statistics to 1e-4).
ARM_RESIDUAL_SCALE = 0.05
ARM_LOSS_REL = 5e-4    # relative loss gap; sound <= 1.5e-4
ARM_GRAD_REL = 2.5e-2  # |g_fused - g_xla| / |g_xla|; sound <= 1.71e-2,
#                        planted faults >= 4.43e-2
ARM_COS_MIN = 0.98     # cosine of the two at the worst parameter; sound
#                        >= 0.9933, faults that turn it <= 0.335
# the PALLAS_CONVS arm against the same arm on cuDNN, one step each from
# the tempered state: the gradient bounds lie between the sound runs'
# largest reading and the planted backward faults' smallest (--faults;
# PERF.md, Findings; readings on an H100 80GB HBM3 at 700 W). The loss
# bound has no fault reading above it (the backward faults leave the
# loss as it is): it only catches coarse forward faults, and the kernel
# phase holds y to one bf16 ulp.
CONV_ARM_LOSS_REL = 5e-4  # sound 4.56e-5
CONV_ARM_GRAD_REL = 2.5e-2  # sound <= 1.118e-2; faults >= 4.623e-2
CONV_ARM_COS_MIN = 0.98   # sound >= 0.99618; the unflipped 3x3 dX 0.4608
# detect with the route on against cuDNN: bf16 logits after 57 routed
# convs rounded in another order, relative to the largest logit (sound
# 1.128e-2 on the H100)
CONV_DETECT_REL = 3e-2
# the H100 SXM's dense bf16 tensor-core rate, float32 rate outside the
# tensor cores, and HBM rate (NVIDIA's data sheet): the bounds
PEAK_BF16, PEAK_F32, PEAK_HBM = 989e12, 67e12, 3.35e12


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


def graph_ms(fn, iters: int) -> float:
    """Milliseconds a call of ``fn`` replayed from a CUDA graph (CUDA
    events around ``iters`` replays): its launches' device time without
    the wrapper's host time, and without torch.profiler, which early in
    the process made every later profiler reading read low (PERF.md,
    Findings)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the capturing stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, iters)


def kernel_device_ms(fn, groups, iters=5):
    """{group: device ms a call of ``fn``} from torch.profiler: the device
    entries whose kernel name contains one of the group's substrings, over
    ``iters`` calls (the wrapper's host time left out). Zero where the
    profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(groups, 0.0)
    for e in prof.key_averages():
        for group, keys in groups.items():
            if any(k in e.key for k in keys):
                out[group] += e.self_device_time_total / 1e3 / iters
    return out


# the two launches of the staged conv backward (csrc/conv_bwd.cuh) by
# kernel name: dW (tdw, and sum_tables where the pixels are split over
# more than one cluster) and dX (tdx, and reduce_parts of its sums)
BWD_PARTS = {"dW": ("tdw<", "sum_tables"), "dX": ("tdx<", "reduce_parts")}
# the staged forward: tdx in its forward mode and reduce_parts of its sums
FWD_PARTS = {"fwd": ("tdx<", "reduce_parts")}
# the seam pass (csrc/ghost_unit.cu): tseam and reduce_parts of its sums
SEAM_PARTS = {"seam": ("tseam<", "reduce_parts")}


def conv_alone_ms(xn, w, iters):
    """The ms of one library call of the conv product alone on the
    pre-activated xn (N, Ci, H, W) bf16 channels-last, after a warm-up
    call: torch.matmul over its pixel rows for a 1x1, F.conv2d (cuDNN) for
    a 3x3. A yardstick for the product of the staged forwards, not the
    same function (no prologue, no sums)."""
    import torch
    import torch.nn.functional as F

    k = w.shape[-1]
    if k == 1:
        x2 = xn.permute(0, 2, 3, 1).reshape(-1, xn.shape[1])
        w2 = w[:, :, 0, 0].t()
        fn = lambda: torch.matmul(x2, w2)  # noqa: E731
    else:
        fn = lambda: F.conv2d(xn, w, padding=k // 2)  # noqa: E731
    fn()
    return cuda_ms(fn, iters)


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
    anti = torch.zeros(1, h, w, dtype=torch.bool)
    anti[0, h - 1 - idx, idx] = True
    add("anti_diagonal_chain", anti)  # up-right through the tiles' corners
    serp = torch.zeros(1, h, w, dtype=torch.bool)
    serp[0, 0::2, :] = True
    for y in range(1, h, 2):
        serp[0, y, w - 1 if (y // 2) % 2 == 0 else 0] = True
    add("serpentine", serp)
    # every other column, joined at alternate ends: one path across every
    # tile border of each row of tiles, up and down
    cols = torch.zeros(1, h, w, dtype=torch.bool)
    cols[0, :, 0::2] = True
    for x in range(1, w, 2):
        cols[0, h - 1 if (x // 2) % 2 == 0 else 0, x] = True
    add("serpentine_columns", cols)
    return cases


def phase_cc(device, report):
    import torch
    from tensorflow_ocr_tpu_torch.ops import kernels as K

    gen = torch.Generator().manual_seed(0)
    cases = [("blobs", *blob_maps(gen, SHAPE, device))] + hand_cases(device)
    # a batch of another size, no multiple of the kernel's 32 x 32 tiles
    cases.append(("ragged_blobs", *blob_maps(gen, RAGGED_SHAPE, device)))
    max_err = 0
    for name, edges, mask in cases:
        got = K.connected_components(edges, mask)
        again = K.connected_components(edges, mask)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"{name}: two launches differ")
        want = K.connected_components_reference(edges, mask)
        if name.startswith("serpentine"):
            uncapped = K.connected_components_reference(edges, mask,
                                                        max_iters=1 << 20)
            check(torch.equal(want, uncapped),
                  f"{name}: the plain version did not converge in its cap")
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
    # bytes: the (B,h,w,8) bool links and (B,h,w) bool mask read, the
    # int32 labels written; no tensor-core work, and no library call
    # computes connected components
    bound = add_bound(report, 0, mask.numel() * (8 + 1 + 4))
    dev = graph_ms(lambda: K.connected_components(edges, mask), 50)
    print(f"cc: {len(cases)} cases equal ({', '.join(c[0] for c in cases)})"
          f", each launched twice and equal; labels (8,192,320): kernel "
          f"{ms:.4f} ms (device {dev:.4f}, replayed from a CUDA graph), "
          f"plain {plain_ms:.4f} ms, bound {bound:.4f} ms (bytes)")
    report.update(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                  library_ms=None)


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


# ------------------------------------------------- the PALLAS_CONVS route

CONV_KERNELS = {
    # name (= the wrapper in ops/conv.py): (source, the site replaced)
    "matmul_rows": ("tensorflow_ocr_tpu_torch/csrc/conv_fwd.cu",
                    "tensorflow_ocr_tpu/ops/pallas_conv.py:81 (_matmul_rows)"),
    "dw_rows": ("tensorflow_ocr_tpu_torch/csrc/conv_dw.cu",
                "tensorflow_ocr_tpu/ops/pallas_conv.py:108 (_dw_rows)"),
    "conv3": ("tensorflow_ocr_tpu_torch/csrc/conv_fwd.cu",
              "tensorflow_ocr_tpu/ops/pallas_conv.py:148 (_conv3)"),
    "dw3": ("tensorflow_ocr_tpu_torch/csrc/conv_dw.cu",
            "tensorflow_ocr_tpu/ops/pallas_conv.py:190 (_dw3)"),
}
# launches of each conv kernel in one pixellink_resnet50 train step with
# the route on: 44 routed 1x1 convs (36 in the backbone, 8 in the head)
# and 13 stride-1 3x3s, each a forward, a dX and a dW product
CONV_STEP_LAUNCHES = {"matmul_rows": 88, "dw_rows": 44, "conv3": 26,
                      "dw3": 13}
# the dW products of a step by kernel (ops/conv.py tma_takes): conv_dw.cu
# takes the 40 dw_rows with channel counts that are multiples of 8 and the
# 13 dw3; conv.cu's igemm_dw the head's 4 projections to 2 channels
DW_STEP_KERNELS = {"tma_dw": 53, "narrow_dw": 4}
# the forward products of a step by kernel (ops/conv.py tma_fwd_takes):
# conv_fwd.cu takes the 44 1x1 and 13 3x3 forwards and every dX whose
# contracted count (the conv's Co) is a multiple of 8, 40 + 13; conv.cu's
# igemm_fwd the dX of the head's 4 projections to 2 channels
FWD_STEP_KERNELS = {"tma_fwd": 110, "narrow_fwd": 4}
# detect's forward: every routed conv contracts a multiple of 8 channels
DETECT_FWD_KERNELS = {"tma_fwd": 57, "narrow_fwd": 0}
# forward shapes (N, H, W, Ci, Co, k) that the train step never reaches,
# each held against its plain version and launched twice: a ragged 3x3
# (W % 16, H % 8, Ci = 24), K = 8, a row wider than one pixel box, the
# head's Co = 2 and 16 at another size, and a dX from 2 channels (K = 2,
# on igemm_fwd)
FWD_TAIL_SHAPES = ((1, 7, 13, 24, 40, 3), (2, 5, 9, 8, 16, 1),
                   (2, 9, 130, 64, 64, 3), (2, 16, 16, 2048, 2, 1),
                   (2, 24, 40, 512, 16, 1), (2, 16, 16, 2, 2048, 1))
# dW shapes (N, H, W, Ci, Co, k) that the train step never reaches, each
# held against its plain version: a ragged 3x3 (W % 16, H % 4, Ci = 24),
# the narrowest TMA channels, a row wider than one pixel box, and a
# head-like projection to 2 channels at another size
DW_TAIL_SHAPES = ((1, 7, 13, 24, 40, 3), (2, 5, 9, 8, 16, 1),
                  (2, 9, 130, 64, 64, 3), (2, 16, 16, 2048, 2, 1))


@contextlib.contextmanager
def pallas_convs(on: bool):
    """models.layers.PALLAS_CONVS set to ``on`` inside the block."""
    from tensorflow_ocr_tpu_torch.models import layers as TL

    old, TL.PALLAS_CONVS = TL.PALLAS_CONVS, on
    try:
        yield
    finally:
        TL.PALLAS_CONVS = old


def reset_conv_counts():
    from tensorflow_ocr_tpu_torch.ops import conv as CV

    for name in (*CONV_KERNELS, *DW_STEP_KERNELS, *FWD_STEP_KERNELS):
        getattr(CV, name).launches = 0


def conv_counts(names=CONV_KERNELS):
    """{name: launches} of the wrappers of ops/conv.py in ``names``."""
    from tensorflow_ocr_tpu_torch.ops import conv as CV

    return {name: getattr(CV, name).launches for name in names}


def route_shape_counts(batch, hw):
    """{(N, H, W, Ci, Co, k, stride): convs of that shape} over every conv
    the route takes in a forward of the model at ``batch`` images of
    ``hw`` (recorded from a batch-1 float32 forward on the CPU; in a train
    step each conv is also one dX and one dW product of its shape)."""
    import torch
    from tensorflow_ocr_tpu_torch.models import build_model
    from tensorflow_ocr_tpu_torch.ops import conv as CV

    seen, orig = {}, CV.conv2d

    def record(x, w, stride=(1, 1)):
        _, ci, h, wd = x.shape
        key = (batch, h, wd, ci, w.shape[0], w.shape[-1], stride[0])
        seen[key] = seen.get(key, 0) + 1
        return orig(x, w, stride)

    model = build_model(MODEL, dtype=torch.float32)
    CV.conv2d = record
    try:
        with pallas_convs(True), torch.inference_mode():
            model(torch.zeros(1, *hw, 3, dtype=torch.uint8))
    finally:
        CV.conv2d = orig
    return seen


def route_shapes(batch, hw):
    """The distinct shapes of route_shape_counts, in order."""
    return tuple(route_shape_counts(batch, hw))


def phase_conv_kernels(device, reports):
    """Each conv kernel against its plain version at every distinct shape
    of the route in the train step (route_shapes at TRAIN_SIZE, batch
    TRAIN_BATCH, plus one stride-2 1x1, which the route takes and
    ResNet-v1-50 does not have): the forward y and dX (bf16, one ulp) and
    dW (float32 sums, SUM_REL of the sum of magnitudes); then the forward
    y at every distinct shape of detect's forward (IMAGE_HW, batch 8).
    Each call is launched twice and the two results must be bit-equal;
    the forward and dW tail shapes (FWD_TAIL_SHAPES, DW_TAIL_SHAPES) are
    held too. Prints kernel, plain and library-call ms (CUDA events; the
    3x3 dX beside two library calls, conv2d_input and the conv of dY with
    the flipped weight, the faster of which is the yardstick), the FLOPs,
    bytes and bound of each call, and each kernel's ms a train step (each
    shape's time times its launches in a step). The reports sum the train
    shapes' times and bounds; max_abs_err covers every shape."""
    import torch
    import torch.nn.functional as F
    from tensorflow_ocr_tpu_torch.ops import conv as CV

    gen = torch.Generator().manual_seed(6)
    bf, cl = torch.bfloat16, torch.channels_last
    for r in reports.values():
        r.update(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0)

    def act(n, c, h, w):
        return torch.randn(n, c, h, w, generator=gen).to(
            device=device, dtype=bf).contiguous(memory_format=cl)

    def run(name, what, kernel, plain, library, terms, flops, nbytes,
            sums=reports):
        """``library``: one call, or {label: call} of which the faster
        is the yardstick."""
        calls = library if isinstance(library, dict) else {"": library}
        got, want = kernel(), plain()
        for fn in calls.values():
            fn()
        torch.cuda.synchronize()
        err = (bf16_close(f"{name} {what}", got, want) if terms is None
               else sum_close(f"{name} {what}", got, want, terms))
        check(torch.equal(got, kernel()), f"{name} {what}: two launches "
              "on the same inputs differ")
        ms, pms = cuda_ms(kernel, 10), cuda_ms(plain, 3)
        times = {label: cuda_ms(fn, 10) for label, fn in calls.items()}
        lms = min(times.values())
        reports[name]["max_abs_err"] = max(reports[name]["max_abs_err"], err)
        r = sums[name]
        bound = add_bound(r, flops, nbytes)
        r["ms"] += ms
        r["plain_ms"] += pms
        r["library_ms"] += lms
        lib = ", ".join(f"{label} {t:.4f}" for label, t in times.items()
                        if label)
        print(f"{name} {what}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} "
              f"TFLOP/s, {nbytes / ms / 1e9:.3f} TB/s), plain {pms:.4f}, "
              f"library {lms:.4f}{f' ({lib})' if lib else ''}; "
              f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB, bound "
              f"{bound:.4f} ms; max abs err {err:.3e}")
        return ms, lms

    def partial_mb(n, h, w, ci, co, k):
        """MB of partial tables a dW call writes and reads back (beyond
        the bytes of its bound): one f32 table a cluster of conv_dw.cu
        (a split of igemm_dw) where there is more than one."""
        table, sms = 4 * k * k * ci * co, CV._sms(0)
        if CV.tma_takes(ci, co):
            geo = (1, 1, n * h * w) if k == 1 else (n, h, w)
            p = CV.tma_dw_plan(*geo, ci, co, k, sms)
            tables = p.splits // p.cluster
        else:
            tables = CV.dw_plan(n * h * w, k * k * ci, co, sms)[3]
        return 2 * tables * table / 1e6 if tables > 1 else 0.0

    def run_dw(x, dy, k, what, sums=reports):
        """One dW product (dw_rows for k = 1, dw3 for k = 3) against its
        plain version and its library call; returns (ms, library ms)."""
        n, ci, h, w = x.shape
        co, m = dy.shape[1], n * h * w
        flops, nbytes = 2 * m * k * k * ci * co, \
            2 * m * (ci + co) + 4 * k * k * ci * co
        tag = (f"dw {what} (partial tables "
               f"{partial_mb(n, h, w, ci, co, k):.2f} MB)")
        if k == 1:
            x2, dy2 = CV.rows(x), CV.rows(dy)
            return run("dw_rows", tag, lambda: CV.dw_rows(x2, dy2),
                       lambda: CV.dw_rows_reference(x2, dy2),
                       lambda: torch.matmul(x2.t(), dy2),
                       CV.dw_rows_reference(x2.abs(), dy2.abs()), flops,
                       nbytes, sums)
        return run("dw3", tag, lambda: CV.dw3(x, dy),
                   lambda: CV.dw3_reference(x, dy),
                   lambda: torch.nn.grad.conv2d_weight(x, (co, ci, 3, 3), dy,
                                                       padding=1),
                   CV.dw3_reference(x.abs(), dy.abs()), flops, nbytes, sums)

    q = TRAIN_SIZE // 4
    counts = route_shape_counts(TRAIN_BATCH, (TRAIN_SIZE, TRAIN_SIZE))
    shapes = tuple(counts) + ((TRAIN_BATCH, q, q, 256, 512, 1, 2),)
    step = {n: [0.0, 0.0] for n in CONV_KERNELS}
    print(f"conv route at {TRAIN_SIZE}^2, batch {TRAIN_BATCH}: "
          f"{len(shapes)} distinct convs (N, H, W, Ci, Co, k, stride): "
          f"{shapes}")
    for n, h, w, ci, co, k, s in shapes:
        x = act(n, ci, h, w)
        xs = x[:, :, ::s, ::s].contiguous(memory_format=cl)
        m = n * xs.shape[2] * xs.shape[3]
        wt = (torch.randn(co, ci, k, k, generator=gen)
              / (k * k * ci) ** 0.5).to(device=device, dtype=bf)
        dy = act(n, co, xs.shape[2], xs.shape[3])
        tag = f"{k}x{k}/{s} {ci}->{co} at {n}x{h}x{w}"
        flops = 2 * m * k * k * ci * co
        io = 2 * (m * ci + k * k * ci * co + m * co)
        launches = counts.get((n, h, w, ci, co, k, s), 0)
        if k == 1:
            x2, dy2 = CV.rows(xs), CV.rows(dy)
            w2, w2t = wt[:, :, 0, 0].t(), wt[:, :, 0, 0]
            fwd = run("matmul_rows", f"fwd {tag}",
                      lambda: CV.matmul_rows(x2, w2),
                      lambda: CV.matmul_rows_reference(x2, w2),
                      lambda: torch.matmul(x2, w2), None, flops, io)
            dx = run("matmul_rows", f"dx {tag}",
                     lambda: CV.matmul_rows(dy2, w2t),
                     lambda: CV.matmul_rows_reference(dy2, w2t),
                     lambda: torch.matmul(dy2, w2t), None, flops, io)
        else:
            wflip = wt.flip(2, 3).transpose(0, 1).contiguous()
            wcl = wt.contiguous(memory_format=cl)
            wflip_cl = wflip.contiguous(memory_format=cl)
            fwd = run("conv3", f"fwd {tag}", lambda: CV.conv3(x, wt),
                      lambda: CV.conv3_reference(x, wt),
                      lambda: F.conv2d(x, wcl, padding=1), None, flops, io)
            dx = run("conv3", f"dx {tag}", lambda: CV.conv3(dy, wflip),
                     lambda: CV.conv3_reference(dy, wflip),
                     {"conv2d_input": lambda: torch.nn.grad.conv2d_input(
                         x.shape, wcl, dy, padding=1),
                      "conv2d(dy, wflip)": lambda: F.conv2d(
                          dy, wflip_cl, padding=1)},
                     None, flops, io)
        name = "matmul_rows" if k == 1 else "conv3"
        for ms, lms in (fwd, dx):
            step[name][0] += launches * ms
            step[name][1] += launches * lms
        ms, lms = run_dw(xs, dy, k, tag)
        name = "dw_rows" if k == 1 else "dw3"
        step[name][0] += launches * ms
        step[name][1] += launches * lms
        del x, xs, dy
    for name, (ms, lms) in step.items():
        r = reports[name]
        print(f"{name} a train step (each shape's ms times its launches in "
              f"a step, {CONV_STEP_LAUNCHES[name]} in all): kernel {ms:.4f} "
              f"ms, library {lms:.4f}; over the distinct shapes: kernel "
              f"{r['ms']:.4f}, library {r['library_ms']:.4f}, bound "
              f"{r['bound_ms']:.4f} ({r['bound_by']})")

    tail = {n: dict(ms=0.0, plain_ms=0.0, library_ms=0.0) for n in reports}
    for n, h, w, ci, co, k in FWD_TAIL_SHAPES:
        x = act(n, ci, h, w)
        wt = (torch.randn(co, ci, k, k, generator=gen)
              / (k * k * ci) ** 0.5).to(device=device, dtype=bf)
        m, tag = n * h * w, f"tail {k}x{k} {ci}->{co} at {n}x{h}x{w}"
        flops = 2 * m * k * k * ci * co
        io = 2 * (m * ci + k * k * ci * co + m * co)
        if k == 1:
            x2, w2 = CV.rows(x), wt[:, :, 0, 0].t()
            run("matmul_rows", f"fwd {tag}", lambda: CV.matmul_rows(x2, w2),
                lambda: CV.matmul_rows_reference(x2, w2),
                lambda: torch.matmul(x2, w2), None, flops, io, tail)
        else:
            wcl = wt.contiguous(memory_format=cl)
            run("conv3", f"fwd {tag}", lambda: CV.conv3(x, wt),
                lambda: CV.conv3_reference(x, wt),
                lambda: F.conv2d(x, wcl, padding=1), None, flops, io, tail)
    for n, h, w, ci, co, k in DW_TAIL_SHAPES:
        run_dw(act(n, ci, h, w), act(n, co, h, w), k,
               f"tail {k}x{k} {ci}->{co} at {n}x{h}x{w}", tail)

    # detect's forward (the eval fold: the same convs on w*mul)
    detect = route_shapes(8, IMAGE_HW)
    print(f"conv route in detect at {IMAGE_HW[1]}x{IMAGE_HW[0]}, batch 8: "
          f"{len(detect)} distinct convs: {detect}")
    sub = {n: dict(ms=0.0, plain_ms=0.0, library_ms=0.0) for n in reports}
    for n, h, w, ci, co, k, _ in detect:
        x = act(n, ci, h, w)
        wt = (torch.randn(co, ci, k, k, generator=gen)
              / (k * k * ci) ** 0.5).to(device=device, dtype=bf)
        m, tag = n * h * w, f"{k}x{k} {ci}->{co} at {n}x{h}x{w}"
        flops = 2 * m * k * k * ci * co
        io = 2 * (m * ci + k * k * ci * co + m * co)
        if k == 1:
            x2, w2 = CV.rows(x), wt[:, :, 0, 0].t()
            run("matmul_rows", f"detect fwd {tag}",
                lambda: CV.matmul_rows(x2, w2),
                lambda: CV.matmul_rows_reference(x2, w2),
                lambda: torch.matmul(x2, w2), None, flops, io, sub)
        else:
            wcl = wt.contiguous(memory_format=cl)
            run("conv3", f"detect fwd {tag}", lambda: CV.conv3(x, wt),
                lambda: CV.conv3_reference(x, wt),
                lambda: F.conv2d(x, wcl, padding=1), None, flops, io, sub)
        del x
    for name in ("matmul_rows", "conv3"):
        r = sub[name]
        print(f"{name} over detect's shapes: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f}, library {r['library_ms']:.4f}, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    print("conv kernels: ms, plain_ms, library_ms and bound_ms in the "
          f"kernels line are sums over the {len(shapes)} train-step shapes "
          "(forward and dX for matmul_rows and conv3); max_abs_err also "
          "covers detect's and the tail shapes; library: torch.matmul "
          "(cuBLAS, bf16 out) for the 1x1s, F.conv2d, the faster of "
          "torch.nn.grad.conv2d_input and F.conv2d(dy, wflip) for the dX, "
          "and conv2d_weight (cuDNN, channels-last bf16) for the 3x3s")


def phase_conv_detect(pred, images):
    """detect_batch with PALLAS_CONVS on: every routed conv of the
    forward on the conv kernels, the CC kernel still launched, logits
    within CONV_DETECT_REL of the cuDNN forward's."""
    import numpy as np
    import torch
    from tensorflow_ocr_tpu_torch.ops import kernels as K

    x = torch.from_numpy(images).to(pred.device)
    with torch.inference_mode():
        want = pred.model(x)
    with pallas_convs(True):
        reset_conv_counts()
        K.connected_components.launches = 0
        boxes = pred.detect_batch(images)
        torch.cuda.synchronize()
        counts, cc = conv_counts(), K.connected_components.launches
        fwd_kernels = conv_counts(FWD_STEP_KERNELS)
        with torch.inference_mode():
            got = pred.model(x)
    print(f"detect_batch 8x1280x768 with PALLAS_CONVS: conv kernel launches "
          f"{counts} (by kernel {fwd_kernels}), cc launches {cc}, boxes per "
          f"image {[len(b) for b in boxes]}")
    check(counts == {"matmul_rows": 44, "dw_rows": 0, "conv3": 13,
                     "dw3": 0}, "detect with the route: conv launches")
    check(fwd_kernels == DETECT_FWD_KERNELS, "detect with the route: "
          "forward launches by kernel")
    check(cc > 0, "detect with the route did not launch the CC kernel")
    check(len(boxes) == len(images) and all(
        np.isfinite(b).all() and b.shape == (4, 2)
                                  for bs in boxes for b in bs),
          "detect with the route: malformed boxes")
    for key in ("pixel_logits", "link_logits"):
        g, w = got[key], want[key]
        check(g.shape == w.shape and bool(torch.isfinite(g).all()),
              f"{key}: shape {tuple(g.shape)} or non-finite")
        rel = float((g - w).abs().max() / w.abs().max())
        print(f"detect with PALLAS_CONVS {key}: max|routed-cudnn|/max|cudnn|"
              f" = {rel:.3e} (tol {CONV_DETECT_REL:g})")
        check(rel <= CONV_DETECT_REL, f"{key}: routed and cuDNN logits "
              "disagree")


# ---------------------------------------------------------------- training

FUSED_KERNELS = {
    # name: (wrapper attribute in ops/fused.py, source, the sites replaced)
    "fused_conv_fwd": (
        "conv_fwd", "tensorflow_ocr_tpu_torch/csrc/fused_conv.cu",
        "tensorflow_ocr_tpu/ops/pallas_fused.py:112 (_f1x1), "
        "tensorflow_ocr_tpu/ops/pallas_fused.py:153 (_f3x3)"),
    "fused_conv_bwd": (
        "conv_bwd", "tensorflow_ocr_tpu_torch/csrc/fused_conv.cu",
        "tensorflow_ocr_tpu/ops/pallas_fused.py:267 (_fused_conv1x1_bwd), "
        "tensorflow_ocr_tpu/ops/pallas_fused.py:318 (_fused_conv3x3_bwd)"),
    "fused_boundary_fwd": (
        "boundary_fwd", "tensorflow_ocr_tpu_torch/csrc/fused_boundary.cu",
        "tensorflow_ocr_tpu/ops/pallas_fused.py:420 (fused_boundary)"),
    "fused_boundary_bwd": (
        "boundary_bwd", "tensorflow_ocr_tpu_torch/csrc/fused_boundary.cu",
        "tensorflow_ocr_tpu/ops/pallas_fused.py:456 (_fused_boundary_bwd)"),
}
# (N, H, W, Ci, Co, k) of every fused conv at 512^2, batch 32, block by
# block (M = 524,288 / 131,072 / 32,768 / 8,192 rows): the first unit's
# conv1 and projection shortcut, the later units' conv1, conv3, the 3x3
CONV_SHAPES = (
    (32, 128, 128, 64, 64, 1), (32, 128, 128, 64, 256, 1),
    (32, 128, 128, 256, 64, 1), (32, 128, 128, 64, 64, 3),
    (32, 64, 64, 256, 128, 1), (32, 64, 64, 256, 512, 1),
    (32, 64, 64, 512, 128, 1), (32, 64, 64, 128, 512, 1),
    (32, 64, 64, 128, 128, 3),
    (32, 32, 32, 512, 256, 1), (32, 32, 32, 512, 1024, 1),
    (32, 32, 32, 1024, 256, 1), (32, 32, 32, 256, 1024, 1),
    (32, 32, 32, 256, 256, 3),
    (32, 16, 16, 1024, 512, 1), (32, 16, 16, 1024, 2048, 1),
    (32, 16, 16, 2048, 512, 1), (32, 16, 16, 512, 2048, 1),
    (32, 16, 16, 512, 512, 3))
# (N, H, W, C) of the boundary of each block
BOUNDARY_SHAPES = ((32, 128, 128, 256), (32, 64, 64, 512),
                   (32, 32, 32, 1024), (32, 16, 16, 2048))
# fused conv launches a step: 13 fused units of 3 convs, 4 with a
# projection shortcut
FUSED_CONV_STEP_LAUNCHES = 43


def fused_shape_counts():
    """{(N, H, W, Ci, Co, k): fused convs of that shape in one train step}
    (each one forward and one backward), from the fused units of the model
    (block b at TRAIN_SIZE / 4 / 2^(b-1))."""
    from tensorflow_ocr_tpu_torch.models import build_model
    from tensorflow_ocr_tpu_torch.models.resnet import FusedBottleneck

    model = build_model(MODEL, bottleneck_impl="fused")
    counts = {}
    for name, m in model.backbone.named_children():
        if isinstance(m, FusedBottleneck):
            hw = TRAIN_SIZE // 4 >> (int(name[len("block")]) - 1)
            for conv in (m.conv1, m.conv2, m.conv3, m.shortcut):
                if conv is not None:
                    co, ci, k, _ = conv.conv.weight.shape
                    key = (TRAIN_BATCH, hw, hw, ci, co, k)
                    counts[key] = counts.get(key, 0) + 1
    check(set(counts) == set(CONV_SHAPES)
          and sum(counts.values()) == FUSED_CONV_STEP_LAUNCHES,
          f"the fused units' convs {counts} are not CONV_SHAPES")
    return counts


# bf16 outputs (y, dx, dw, dz, dzs): kernel and plain version round the
# same f32 value, summed in another order, so they may differ by one bf16
# ulp (2^-8 relative, 2^-7 at the rounding edge) plus f32 order noise,
# bounded here by 1e-3 of the tensor's largest value
BF16_ULP, BF16_NOISE = 2.0 ** -7, 1e-3
# f32 sums over up to 524,288 rows (s, dab, dabs), in another order (and,
# for s and the boundary's sums, with atomics): within 1e-4 of the sum of
# the magnitudes
SUM_REL = 1e-4


def bf16_close(name, got, want):
    import torch

    got, want = got.float(), want.float()
    err = (got - want).abs()
    bound = (BF16_ULP * torch.maximum(got.abs(), want.abs())
             + BF16_NOISE * float(want.abs().max()))
    check(bool((err <= bound).all()), f"{name}: max err {float(err.max()):.3e}"
          f" beyond one bf16 ulp (worst excess "
          f"{float((err - bound).max()):.3e})")
    return float(err.max())


def sum_close(name, got, want, scale):
    """f32 per-channel sums against the plain version; ``scale`` is the
    sum of the magnitudes of the summed terms, per channel."""
    err = (got - want).abs()
    check(bool((err <= SUM_REL * scale + 1e-30).all()),
          f"{name}: max err {float(err.max()):.3e}, beyond "
          f"{SUM_REL:g} x the sum of magnitudes")
    return float(err.max())


def add_bound(report, flops, nbytes, peak=PEAK_BF16):
    """Add one call's least time on the card (the larger of its
    operations over ``peak`` and its bytes over the HBM rate, in ms) to
    a kernel's report; returns it. The report's ``bound_by`` says which
    of the two sums is the larger."""
    t_ops, t_bytes = 1e3 * flops / peak, 1e3 * nbytes / PEAK_HBM
    report["bound_ms"] = report.get("bound_ms", 0.0) + max(t_ops, t_bytes)
    report["_ops_ms"] = report.get("_ops_ms", 0.0) + t_ops
    report["_bytes_ms"] = report.get("_bytes_ms", 0.0) + t_bytes
    report["bound_by"] = ("operations" if report["_ops_ms"]
                          >= report["_bytes_ms"] else "bytes")
    return max(t_ops, t_bytes)


def build_all():
    """Build the seven CUDA sources, one nvcc each, all started together,
    and load each library."""
    from concurrent.futures import ThreadPoolExecutor

    from tensorflow_ocr_tpu_torch.ops import conv as CV
    from tensorflow_ocr_tpu_torch.ops import fused as FU
    from tensorflow_ocr_tpu_torch.ops import ghost as G
    from tensorflow_ocr_tpu_torch.ops import kernels as K

    loaders = {"cc": K._cc_label, "fused_conv": lambda: FU._lib("fused_conv"),
               "fused_boundary": lambda: FU._lib("fused_boundary"),
               "conv": CV._lib, "conv_fwd": CV._fwd_lib,
               "conv_dw": CV._dw_lib, "ghost_unit": G._lib}

    def one(name):
        t0 = time.perf_counter()
        lib = K.build_library(name)
        loaders[name]()
        return lib.name, time.perf_counter() - t0

    with ThreadPoolExecutor(len(loaders)) as pool:
        for lib, dt in pool.map(one, loaders):
            print(f"build: {lib} in {dt:.2f} s")


def phase_fused_kernels(device, reports):
    """Each fused kernel against its plain version at the slice's shapes:
    forward y and s, backward dx, dab and dw, boundary out, dz, dzs, dab,
    dabs; each conv kernel launched twice and held bit-equal. Prints
    kernel and plain ms per shape (CUDA events), each conv kernel's device
    ms (torch.profiler) and the forward's conv-alone yardstick, and each
    conv kernel's ms a train step."""
    import torch
    from tensorflow_ocr_tpu_torch.ops import fused as FU

    gen = torch.Generator().manual_seed(5)
    bf = torch.bfloat16
    cl = torch.channels_last

    def act(n, c, h, w, scale=1.0):
        return (torch.randn(n, c, h, w, generator=gen) * scale).to(
            device=device, dtype=bf).contiguous(memory_format=cl)

    def table(c, lo, hi, shift):
        a = torch.empty(c).uniform_(lo, hi, generator=gen)
        b = torch.randn(c, generator=gen) * shift
        return torch.stack([a, b]).to(device)

    # no one PyTorch call computes a conv with an affine+relu prologue and
    # a statistics epilogue, or the boundary's two affines, add and relu
    for r in reports.values():
        r.update(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=None)

    def timed(name, kernel, plain, iters):
        ms = cuda_ms(kernel, iters)
        pms = cuda_ms(plain, max(1, iters // 4))
        reports[name]["ms"] += ms
        reports[name]["plain_ms"] += pms
        return ms, pms

    counts = fused_shape_counts()
    # the forward and the backward a train step: each shape's times its
    # launches
    step = dict(ms=0.0, dW=0.0, dX=0.0, bound=0.0)
    fstep = dict(ms=0.0, fwd=0.0, bound=0.0, alone=0.0)
    alone_sum = 0.0
    for n, h, w, ci, co, k in CONV_SHAPES:
        m, kk = n * h * w, k * k * ci * co
        launches = counts[(n, h, w, ci, co, k)]
        fbound = add_bound(reports["fused_conv_fwd"], 2 * m * kk,
                           2 * m * (ci + co) + 2 * kk + 8 * (ci + co))
        bound = add_bound(reports["fused_conv_bwd"], 4 * m * kk,
                          2 * m * (2 * ci + 2 * co) + 6 * kk + 16 * (ci + co))
        x = act(n, ci, h, w)
        ab = table(ci, 0.5, 1.5, 0.5)
        wt = (torch.randn(co, ci, k, k, generator=gen)
              / (k * k * ci) ** 0.5).to(device=device, dtype=bf)
        y, s = FU.conv_fwd(x, ab, wt)
        again = FU.conv_fwd(x, ab, wt)
        py, ps = FU.conv_fwd_reference(x, ab, wt)
        torch.cuda.synchronize()
        check(torch.equal(y, again[0]) and torch.equal(s, again[1]),
              f"fused conv_fwd {k}x{k} {ci}->{co}: two launches on the same "
              "inputs differ")
        del again
        e = bf16_close("fwd y", y, py)
        mag = py.float().abs().sum((0, 2, 3))
        es = max(sum_close("fwd s0", s[0], ps[0], mag),
                 sum_close("fwd s1", s[1], ps[1], ps[1]))
        dy = act(n, co, h, w, 1e-2)
        ds = torch.stack([torch.randn(co, generator=gen) * 1e-3,
                          torch.randn(co, generator=gen) * 1e-4]).to(device)
        dx, dab, dw = FU.conv_bwd(x, ab, wt, y, dy, ds)
        again = FU.conv_bwd(x, ab, wt, y, dy, ds)
        pdx, pdab, pdw = FU.conv_bwd_reference(x, ab, wt, y, dy, ds)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip((dx, dab, dw), again)),
              f"fused conv_bwd {k}x{k} {ci}->{co}: two launches on the same "
              "inputs differ")
        del again
        eb = max(bf16_close("bwd dx", dx, pdx), bf16_close("bwd dw", dw, pdw))
        # dab's terms: |gm*x| and |gm|, bounded via the plain dx = gm*a
        gm = (pdx.float() / ab[0][:, None, None]).abs()
        es = max(es, sum_close("bwd dab0", dab[0], pdab[0],
                               (gm * x.float().abs()).sum((0, 2, 3))),
                 sum_close("bwd dab1", dab[1], pdab[1], gm.sum((0, 2, 3))))
        torch.cuda.synchronize()
        reports["fused_conv_fwd"]["max_abs_err"] = max(
            reports["fused_conv_fwd"]["max_abs_err"], e)
        reports["fused_conv_bwd"]["max_abs_err"] = max(
            reports["fused_conv_bwd"]["max_abs_err"], eb)
        fms = timed("fused_conv_fwd", lambda: FU.conv_fwd(x, ab, wt),
                    lambda: FU.conv_fwd_reference(x, ab, wt), 20)
        fdev = kernel_device_ms(lambda: FU.conv_fwd(x, ab, wt),
                                FWD_PARTS)["fwd"]
        ams = conv_alone_ms(FU._prologue(x, ab), wt, 20)
        alone_sum += ams
        for key, v in (("ms", fms[0]), ("fwd", fdev), ("bound", fbound),
                       ("alone", ams)):
            fstep[key] += launches * v
        bms = timed("fused_conv_bwd",
                    lambda: FU.conv_bwd(x, ab, wt, y, dy, ds),
                    lambda: FU.conv_bwd_reference(x, ab, wt, y, dy, ds), 20)
        parts = kernel_device_ms(lambda: FU.conv_bwd(x, ab, wt, y, dy, ds),
                                 BWD_PARTS)
        for key, v in (("ms", bms[0]), ("bound", bound), *parts.items()):
            step[key] += launches * v
        print(f"fused conv {k}x{k} {ci}->{co} at {n}x{h}x{w} ({launches} a "
              f"step): fwd {fms[0]:.4f} ms (plain {fms[1]:.4f}; device "
              f"{fdev:.4f}; bound {fbound:.4f}; conv alone {ams:.4f}), bwd "
              f"{bms[0]:.4f} ms (plain {bms[1]:.4f}; device dW "
              f"{parts['dW']:.4f}, dX {parts['dX']:.4f}; bound "
              f"{bound:.4f}); max abs err y {e:.3e}, dx/dw {eb:.3e}, f32 "
              f"sums s/dab {es:.3e}; fwd and bwd bit-equal twice")
        del x, y, dy, dx, py, pdx

    for n, h, w, c in BOUNDARY_SHAPES:
        mc = n * h * w * c  # ~5 float32 operations an element forward, ~10
        add_bound(reports["fused_boundary_fwd"], 5 * mc, 6 * mc + 16 * c,
                  PEAK_F32)
        add_bound(reports["fused_boundary_bwd"], 10 * mc, 10 * mc + 32 * c,
                  PEAK_F32)
        z, zs = act(n, c, h, w), act(n, c, h, w)
        ab, abs_ = table(c, 0.5, 1.5, 0.5), table(c, 0.5, 1.5, 0.5)
        out = FU.boundary_fwd(z, ab, zs, abs_)
        e = bf16_close("boundary out", out,
                       FU.boundary_fwd_reference(z, ab, zs, abs_))
        g = act(n, c, h, w, 1e-2)
        got = FU.boundary_bwd(g, z, ab, zs, abs_)
        want = FU.boundary_bwd_reference(g, z, ab, zs, abs_)
        gm = (want[0].float() / ab[0][:, None, None]).abs()
        eb = max(bf16_close("boundary dz", got[0], want[0]),
                 bf16_close("boundary dzs", got[2], want[2]))
        es = 0.0
        for name, i, terms in (("dab0", 1, z), ("dabs0", 3, zs)):
            es = max(es, sum_close(name, got[i][0], want[i][0],
                                   (gm * terms.float().abs()).sum((0, 2, 3))))
            es = max(es, sum_close(name[:-1] + "1", got[i][1], want[i][1],
                                   gm.sum((0, 2, 3))))
        torch.cuda.synchronize()
        reports["fused_boundary_fwd"]["max_abs_err"] = max(
            reports["fused_boundary_fwd"]["max_abs_err"], e)
        reports["fused_boundary_bwd"]["max_abs_err"] = max(
            reports["fused_boundary_bwd"]["max_abs_err"], eb)
        fms = timed("fused_boundary_fwd",
                    lambda: FU.boundary_fwd(z, ab, zs, abs_),
                    lambda: FU.boundary_fwd_reference(z, ab, zs, abs_), 20)
        bms = timed("fused_boundary_bwd",
                    lambda: FU.boundary_bwd(g, z, ab, zs, abs_),
                    lambda: FU.boundary_bwd_reference(g, z, ab, zs, abs_), 20)
        print(f"fused boundary C={c} at {n}x{h}x{w}: fwd {fms[0]:.4f} ms "
              f"(plain {fms[1]:.4f}), bwd {bms[0]:.4f} ms (plain "
              f"{bms[1]:.4f}); max abs err out {e:.3e}, dz/dzs {eb:.3e}, "
              f"f32 sums dab/dabs {es:.3e}")
    print(f"fused_conv_fwd a train step (each shape's ms times its "
          f"launches, {FUSED_CONV_STEP_LAUNCHES} in all): {fstep['ms']:.4f} "
          f"ms by events (device {fstep['fwd']:.4f}), bound "
          f"{fstep['bound']:.4f}, conv alone {fstep['alone']:.4f}; over the "
          f"{len(CONV_SHAPES)} shapes: {reports['fused_conv_fwd']['ms']:.4f}"
          f", bound {reports['fused_conv_fwd']['bound_ms']:.4f}, conv alone "
          f"{alone_sum:.4f}")
    print(f"fused_conv_bwd a train step (each shape's ms times its "
          f"launches, {FUSED_CONV_STEP_LAUNCHES} in all): {step['ms']:.4f} ms "
          f"by events (device: dW {step['dW']:.4f}, dX {step['dX']:.4f}), "
          f"bound {step['bound']:.4f}; over the {len(CONV_SHAPES)} shapes: "
          f"{reports['fused_conv_bwd']['ms']:.4f}, bound "
          f"{reports['fused_conv_bwd']['bound_ms']:.4f}")
    print("fused kernels: ms and plain_ms in the kernels line are sums over "
          f"the {len(CONV_SHAPES)} conv / {len(BOUNDARY_SHAPES)} boundary "
          "shapes above; max_abs_err is over the bf16 outputs (the f32 "
          "sums are checked against SUM_REL and printed above); conv alone "
          "is torch.matmul / F.conv2d of the pre-activated input, a "
          "yardstick for the forward's product, not the same function "
          "(library_ms stays null: no one call computes the whole function)")


def train_config(impl: str, freeze_bn: bool = False):
    """bench.py's train configuration: pixellink_resnet50, OHEM, 512^2,
    bf16 activations (its batch of 32 with 16 polygon slots an image is
    train_batch's)."""
    from tensorflow_ocr_tpu_torch.config import Config

    cfg = Config()
    cfg.model.name = MODEL
    cfg.model.bottleneck_impl = impl
    cfg.model.freeze_bn = freeze_bn
    cfg.loss.name = "ohem"
    cfg.data.input_size = TRAIN_SIZE
    cfg.train.log_every_steps = 1
    return cfg


def train_batch(rng, device, n, size, max_polys=16):
    """A device batch of numpy scenes: flat colour patches with 4-16
    rotated text-like quads an image (about 1 in 10 tagged ignored),
    painted on the card by the port's rasterizer."""
    import numpy as np
    import torch
    from tensorflow_ocr_tpu_torch.ops.rasterize import rasterize_instances

    polys = np.zeros((n, max_polys, 4, 2), np.float32)
    valid = np.zeros((n, max_polys), bool)
    tags = np.zeros((n, max_polys), bool)
    for i in range(n):
        k = rng.randint(4, max_polys + 1)
        for j in range(k):
            cx, cy = rng.uniform(0.1 * size, 0.9 * size, 2)
            w, h = rng.uniform(0.08, 0.3) * size, rng.uniform(0.03, 0.1) * size
            th = rng.uniform(-0.6, 0.6)
            c, s = np.cos(th), np.sin(th)
            rot = np.array([[c, -s], [s, c]])
            box = np.array([[-w, -h], [w, -h], [w, h], [-w, h]]) / 2
            polys[i, j] = np.clip(box @ rot.T + (cx, cy), 0, size - 1)
        valid[i, :k] = True
        tags[i, :k] = rng.rand(k) < 0.1
    coarse = rng.randint(0, 256, (n, size // 64 + 1, size // 64 + 1, 3))
    images = coarse.repeat(64, 1).repeat(64, 2)[:, :size, :size]
    batch = {"images": torch.from_numpy(images.astype(np.uint8)).to(device),
             "polys": torch.from_numpy(polys).to(device),
             "tags": torch.from_numpy(tags).to(device),
             "valid": torch.from_numpy(valid).to(device)}
    ink = torch.from_numpy(rng.randint(0, 60, (n, 3)).astype(np.uint8))
    for i in range(n):
        inst = rasterize_instances(batch["polys"][i:i + 1],
                                   batch["valid"][i:i + 1], size, size)[0]
        batch["images"][i][inst > 0] = ink[i].to(device)
    return batch


def reset_fused_counts():
    from tensorflow_ocr_tpu_torch.ops import fused as FU

    for attr, _, _ in FUSED_KERNELS.values():
        getattr(FU, attr).launches = 0
    FU.conv_bwd.by_kernel = dict.fromkeys(FU.conv_bwd.by_kernel, 0)


def fused_counts():
    from tensorflow_ocr_tpu_torch.ops import fused as FU

    return {name: getattr(FU, attr).launches
            for name, (attr, _, _) in FUSED_KERNELS.items()}


def grads_of(model, batch, cfg):
    """(model loss, {parameter name: flat float32 gradient}) of one
    forward and backward."""
    from tensorflow_ocr_tpu_torch.train import trainer as T

    loss, _ = T.loss_and_grads(model, batch, cfg, T.make_loss_fn(cfg))
    return float(loss), {n: p.grad.float().flatten()
                         for n, p in model.named_parameters()}


def tempered(weights):
    """``weights`` with each residual branch's last BN scale times
    ARM_RESIDUAL_SCALE (the state of the fused/xla comparison)."""
    out = dict(weights)
    for k, v in weights.items():
        if k.endswith("conv3.bn.weight"):
            out[k] = v * ARM_RESIDUAL_SCALE
    return out


def arm_grads(device, weights, batch, impl):
    """(loss, gradients) of one bf16 step of ``impl`` from a state_dict."""
    import torch
    from tensorflow_ocr_tpu_torch.models import build_model

    model = build_model(MODEL, dtype=torch.bfloat16, bottleneck_impl=impl)
    model.load_state_dict(weights, strict=True)
    out = grads_of(model.to(device), batch, train_config(impl))
    del model
    torch.cuda.empty_cache()
    return out


def cosine(a, b) -> float:
    """Cosine of two vectors, in float64."""
    import torch

    a, b = a.double(), b.double()
    return float(torch.dot(a, b)) / max(float(a.norm() * b.norm()), 1e-300)


def arm_readings(fused, xla):
    """The fused arm's (loss, gradients) against the xla arm's: relative
    loss gap, gradient norms, the relative error of the whole gradient
    and the worst parameter's cosine."""
    import torch

    (lf, gf), (lx, gx) = fused, xla
    vf, vx = torch.cat(list(gf.values())), torch.cat(list(gx.values()))
    leaf_cos = {n: cosine(gf[n], gx[n]) for n in gf}
    worst = min(leaf_cos, key=leaf_cos.get)
    return {"loss": (lf, lx), "rel_loss": abs(lf - lx) / abs(lx),
            "norm": (float(vf.norm()), float(vx.norm())),
            "grad_rel": float((vf - vx).norm() / vx.norm()),
            "worst": (worst, leaf_cos[worst])}


def check_arms(r) -> None:
    check(r["rel_loss"] <= ARM_LOSS_REL, "fused and xla losses disagree")
    check(r["grad_rel"] <= ARM_GRAD_REL, "fused and xla gradients disagree")
    check(r["worst"][1] >= ARM_COS_MIN, f"the fused gradient of "
          f"{r['worst'][0]} points elsewhere than the xla one")


def phase_train(device, reports):
    """The train step at full width: 3 fused steps through Trainer.run,
    each of the four fused kernels launched; one step each of the fused
    and the xla arm from one tempered state and batch, compared
    (check_arms); one freeze_bn step."""
    import copy

    import numpy as np
    import torch
    from tensorflow_ocr_tpu_torch.models.resnet import FusedBottleneck
    from tensorflow_ocr_tpu_torch.ops import fused as FU
    from tensorflow_ocr_tpu_torch.train import trainer as T

    cfg = train_config("fused")
    batch = train_batch(np.random.RandomState(7), device, TRAIN_BATCH,
                        TRAIN_SIZE)
    trainer = T.Trainer(cfg, device)
    state = trainer.setup(generator=torch.Generator().manual_seed(11))
    fused_units = [n for n, m in state.model.backbone.named_children()
                   if isinstance(m, FusedBottleneck)]
    print(f"fused units at {TRAIN_SIZE}^2: {len(fused_units)} of 16 "
          f"({', '.join(fused_units)})")
    snap = copy.deepcopy(state.model.state_dict())

    reset_fused_counts()
    last = trainer.run([batch] * TRAIN_STEPS, TRAIN_STEPS)
    torch.cuda.synchronize()
    counts = fused_counts()
    by_kernel = dict(FU.conv_bwd.by_kernel)
    print(f"train {TRAIN_STEPS} steps fused: last metrics "
          f"{json.dumps({k: round(v, 5) for k, v in last.items()})}; "
          f"kernel launches {counts}; fused_conv_bwd by kernel {by_kernel} "
          f"(conv_bwd.cuh tdw, tdx; expected "
          f"{FUSED_CONV_STEP_LAUNCHES} a step each)")
    check(by_kernel == dict.fromkeys(
        by_kernel, TRAIN_STEPS * FUSED_CONV_STEP_LAUNCHES)
          and counts["fused_conv_bwd"] == TRAIN_STEPS
          * FUSED_CONV_STEP_LAUNCHES, "fused train: backward launches by "
          "kernel")
    check(state.step == TRAIN_STEPS and last and all(
        np.isfinite(v) for v in last.values()), "fused train: non-finite "
          "or missing metrics")
    check(last["n_pos"] > 0, "fused train: the labels have no positives")
    for name, n in counts.items():
        check(n > 0, f"train_step did not launch {name}")
        reports[name]["launches"] = n

    # one step of the fused and the xla arm from the same tempered state
    start = tempered(snap)
    r = arm_readings(arm_grads(device, start, batch, "fused"),
                     arm_grads(device, start, batch, "xla"))
    print(f"fused vs xla, one step from one state (residual BN scales x "
          f"{ARM_RESIDUAL_SCALE:g}): loss {r['loss'][0]:.6f} / "
          f"{r['loss'][1]:.6f} (rel {r['rel_loss']:.3e}, tol "
          f"{ARM_LOSS_REL:g}); gradient norm {r['norm'][0]:.6f} / "
          f"{r['norm'][1]:.6f}, rel err {r['grad_rel']:.4e} (tol "
          f"{ARM_GRAD_REL:g}); worst parameter cosine {r['worst'][1]:.6f} "
          f"at {r['worst'][0]} (min {ARM_COS_MIN:g})")
    check_arms(r)

    # freeze_bn: running statistics, the fused kernels with ds = None
    fcfg = train_config("fused", freeze_bn=True)
    reset_fused_counts()
    m = T.train_step(state, batch, fcfg, T.make_loss_fn(fcfg))
    loss = float(m["total_loss"])
    counts = fused_counts()
    print(f"freeze_bn step fused: total loss {loss:.6f}, kernel launches "
          f"{counts}")
    check(np.isfinite(loss), "freeze_bn step: non-finite loss")
    check(all(counts.values()), "freeze_bn step skipped a fused kernel")
    return trainer, batch, snap


def conv_arm_readings(device, start, batch):
    """One xla-arm step with PALLAS_CONVS on against one with it off
    (cuDNN), from the state ``start`` and one batch (arm_readings)."""
    with pallas_convs(True):
        routed = arm_grads(device, start, batch, "xla")
    return arm_readings(routed, arm_grads(device, start, batch, "xla"))


def print_conv_arms(label, r):
    print(f"{label}: loss {r['loss'][0]:.6f} / {r['loss'][1]:.6f} (rel "
          f"{r['rel_loss']:.3e}, tol {CONV_ARM_LOSS_REL:g}); gradient norm "
          f"{r['norm'][0]:.6f} / {r['norm'][1]:.6f}, rel err "
          f"{r['grad_rel']:.4e} (tol {CONV_ARM_GRAD_REL:g}); worst parameter "
          f"cosine {r['worst'][1]:.6f} at {r['worst'][0]} (min "
          f"{CONV_ARM_COS_MIN:g})")


def phase_conv_train(device, reports, snap, batch):
    """The PALLAS_CONVS arm at full width: 3 xla-arm steps through
    Trainer.run with the route on, each conv kernel launched
    CONV_STEP_LAUNCHES times a step; one step against the cuDNN arm from
    the tempered state (CONV_ARM_* bounds); one freeze_bn step with the
    route on (the BN fold path)."""
    import numpy as np
    import torch
    from tensorflow_ocr_tpu_torch.train import trainer as T

    want = {k: TRAIN_STEPS * v for k, v in CONV_STEP_LAUNCHES.items()}
    with pallas_convs(True):
        trainer = T.Trainer(train_config("xla"), device)
        trainer.setup(weights=snap)
        reset_conv_counts()
        last = trainer.run([batch] * TRAIN_STEPS, TRAIN_STEPS)
        torch.cuda.synchronize()
        counts, dw_kernels = conv_counts(), conv_counts(DW_STEP_KERNELS)
        fwd_kernels = conv_counts(FWD_STEP_KERNELS)
    print(f"train {TRAIN_STEPS} steps xla with PALLAS_CONVS: last metrics "
          f"{json.dumps({k: round(v, 5) for k, v in last.items()})}; "
          f"kernel launches {counts} (expected {want})")
    narrow = dw_kernels["narrow_dw"] // TRAIN_STEPS
    print(f"dw_rows launches a step by kernel: "
          f"{counts['dw_rows'] // TRAIN_STEPS - narrow} on conv_dw.cu "
          f"(tma_dw, with dw3's {counts['dw3'] // TRAIN_STEPS}: "
          f"{dw_kernels['tma_dw'] // TRAIN_STEPS}), {narrow} on conv.cu's "
          f"igemm_dw (narrow_dw); expected {DW_STEP_KERNELS}")
    print(f"forward products a step by kernel: "
          f"{ {k: v // TRAIN_STEPS for k, v in fwd_kernels.items()} } "
          f"(conv_fwd.cu: tma_fwd; conv.cu's igemm_fwd: narrow_fwd); "
          f"expected {FWD_STEP_KERNELS}")
    check(trainer.state.step == TRAIN_STEPS and last and all(
        np.isfinite(v) for v in last.values()), "pallas-conv train: "
          "non-finite or missing metrics")
    check(counts == want, "pallas-conv train: conv kernel launches")
    check(dw_kernels == {k: TRAIN_STEPS * v
                         for k, v in DW_STEP_KERNELS.items()},
          "pallas-conv train: dW launches by kernel")
    check(fwd_kernels == {k: TRAIN_STEPS * v
                          for k, v in FWD_STEP_KERNELS.items()},
          "pallas-conv train: forward launches by kernel")
    for name, n in counts.items():
        reports[name]["launches"] = n
    del trainer
    torch.cuda.empty_cache()

    r = conv_arm_readings(device, tempered(snap), batch)
    print_conv_arms(f"xla with PALLAS_CONVS vs cuDNN, one step from one state "
                    f"(residual BN scales x {ARM_RESIDUAL_SCALE:g})", r)
    check(r["rel_loss"] <= CONV_ARM_LOSS_REL, "pallas-conv and cuDNN "
          "losses disagree")
    check(r["grad_rel"] <= CONV_ARM_GRAD_REL, "pallas-conv and cuDNN "
          "gradients disagree")
    check(r["worst"][1] >= CONV_ARM_COS_MIN, f"the pallas-conv gradient of "
          f"{r['worst'][0]} points elsewhere than the cuDNN one")

    fcfg = train_config("xla", freeze_bn=True)
    with pallas_convs(True):
        state = T.create_train_state(fcfg, device, weights=snap)
        reset_conv_counts()
        loss = float(T.train_step(state, batch, fcfg,
                                  T.make_loss_fn(fcfg))["total_loss"])
        counts = conv_counts()
        by_kernel = conv_counts((*FWD_STEP_KERNELS, *DW_STEP_KERNELS))
    print(f"freeze_bn step xla with PALLAS_CONVS: total loss {loss:.6f}, "
          f"kernel launches {counts} (by kernel {by_kernel})")
    check(np.isfinite(loss), "pallas-conv freeze_bn step: non-finite loss")
    check(counts == CONV_STEP_LAUNCHES, "pallas-conv freeze_bn step: conv "
          "kernel launches")
    check(by_kernel == {**FWD_STEP_KERNELS, **DW_STEP_KERNELS},
          "pallas-conv freeze_bn step: launches by kernel")
    del state
    torch.cuda.empty_cache()


def phase_conv_faults(device, snap, batch):
    """The readings that set the CONV_ARM_* bounds: the pallas-conv arm
    against cuDNN from the tempered state, 3 sound runs, then one run
    under each planted backward fault of ops/conv.py's autograd: dW x 0.9,
    dX x 0.9, and the 3x3 dX with the kernel channel-swapped but not
    flipped."""
    import torch
    from tensorflow_ocr_tpu_torch.ops import conv as CV

    c1, c3 = CV._Conv1x1.backward, CV._Conv3x3.backward

    def scaled(dx_by, dw_by):
        def patch():
            def b1(ctx, dy):
                dx, dw, s = c1(ctx, dy)
                return dx * dx_by, dw * dw_by, s

            def b3(ctx, dy):
                dx, dw = c3(ctx, dy)
                return dx * dx_by, dw * dw_by
            return b1, b3
        return patch

    def unflipped():
        def b3(ctx, dy):
            _, w = ctx.saved_tensors
            _, dw = c3(ctx, dy)
            dy = dy.contiguous(memory_format=torch.channels_last)
            return CV.conv3(dy, w.transpose(0, 1).to(dy.dtype)), dw
        return c1, b3

    start = tempered(snap)
    for i in range(3):
        print_conv_arms(f"faults: sound run {i}",
                        conv_arm_readings(device, start, batch))
    for label, patch in (("dW x 0.9", scaled(1.0, 0.9)),
                         ("dX x 0.9", scaled(0.9, 1.0)),
                         ("3x3 dX kernel not flipped", unflipped)):
        CV._Conv1x1.backward, CV._Conv3x3.backward = map(
            staticmethod, patch())
        try:
            print_conv_arms(f"faults: {label}",
                            conv_arm_readings(device, start, batch))
        finally:
            CV._Conv1x1.backward = staticmethod(c1)
            CV._Conv3x3.backward = staticmethod(c3)


def phase_train_timing(trainer, batch):
    """Train img/s at 512^2, batch 32, for the fused, xla, freeze_bn-fused,
    xla pallas-conv and ghost arms: host clock around TRAIN_WINDOWS windows of at
    least TRAIN_WINDOW_S of train_step calls on one device-resident batch
    (labels made on the card inside each step), each window ending in a
    sync; reported as the median with the range."""
    import torch
    from tensorflow_ocr_tpu_torch.train import trainer as T

    weights = trainer.state.model.state_dict()
    for arm, impl, freeze, route in (
            ("fused", "fused", False, False), ("xla", "xla", False, False),
            ("freeze_bn fused", "fused", True, False),
            ("xla pallas-conv", "xla", False, True),
            ("ghost", "ghost", False, False)):
        cfg = train_config(impl, freeze)
        state = T.create_train_state(cfg, batch["images"].device,
                                     weights=weights)
        loss_fn = T.make_loss_fn(cfg)
        rates = []
        with pallas_convs(route):
            for _ in range(2):
                T.train_step(state, batch, cfg, loss_fn)
            torch.cuda.synchronize()
            for i in range(TRAIN_WINDOWS):
                steps, t0 = 0, time.perf_counter()
                while time.perf_counter() - t0 < TRAIN_WINDOW_S:
                    T.train_step(state, batch, cfg, loss_fn)
                    steps += 1
                    if steps % 4 == 0:
                        torch.cuda.synchronize()
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                rates.append(steps * TRAIN_BATCH / dt)
                print(f"train {arm} window {i}: {rates[-1]:.2f} img/s "
                      f"({steps} steps in {dt:.3f} s)")
        print(f"train {arm} {TRAIN_SIZE}^2 batch {TRAIN_BATCH}: "
              f"{statistics.median(rates):.2f} img/s (median of "
              f"{TRAIN_WINDOWS} windows of >= {TRAIN_WINDOW_S:g} s; windows "
              f"{min(rates):.2f}..{max(rates):.2f}); peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del state
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def phase_profile_train(trainer, batch):
    """torch.profiler over 3 train steps of the fused, the xla pallas-conv
    and the ghost arm: wall, device busy, idle share and the largest
    device entries."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from tensorflow_ocr_tpu_torch.train import trainer as T

    weights = trainer.state.model.state_dict()
    for arm, impl, route in (("fused", "fused", False),
                             ("xla pallas-conv", "xla", True),
                             ("ghost", "ghost", False)):
        cfg = train_config(impl)
        state = T.create_train_state(cfg, batch["images"].device,
                                     weights=weights)
        loss_fn = T.make_loss_fn(cfg)
        with pallas_convs(route):
            T.train_step(state, batch, cfg, loss_fn)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(3):
                    T.train_step(state, batch, cfg, loss_fn)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1000
        busy = device_busy_ms(prof)
        check(busy > 0, "train profile: no device events in the trace")
        print(f"profile train {arm} 3 steps: wall {wall:.3f} ms, device "
              f"busy {busy:.3f} ms, idle share {1 - busy / wall:.3f}")
        print(prof.key_averages().table(sort_by="self_device_time_total",
                                        row_limit=40,
                                        max_name_column_width=60))
        del state
        torch.cuda.empty_cache()


# ------------------------------------------------- the ghost-BN train step

GHOST_SRC = "tensorflow_ocr_tpu_torch/csrc/ghost_unit.cu"
GHOST_KERNELS = {
    # name: (wrapper attribute in ops/ghost.py, the sites replaced)
    "ghost_conv_fwd": (
        "conv_fwd", "tensorflow_ocr_tpu/ops/pallas_unit.py:270 (_unit_fwd, "
        "pallas_call :303): the unit's convs"),
    "ghost_boundary_fwd": (
        "boundary_fwd", "tensorflow_ocr_tpu/ops/pallas_unit.py:270 "
        "(_unit_fwd, pallas_call :303): BN3, shortcut, add, relu"),
    "ghost_boundary_bwd": (
        "boundary_bwd", "tensorflow_ocr_tpu/ops/pallas_unit.py:627 "
        "(_unit_bwd sweep 1, pallas_call :677): gm3 and its band sums"),
    "ghost_conv_bwd": (
        "conv_bwd", "tensorflow_ocr_tpu/ops/pallas_unit.py:627 (_unit_bwd "
        "sweeps 1 and 2, pallas_calls :677, :700): dW1-3, dWs, do and the "
        "interior chain"),
    "ghost_seam_bwd": (
        "seam_bwd", "tensorflow_ocr_tpu/ops/pallas_unit.py:627 (_unit_bwd "
        "sweep 2, pallas_call :700): the seam rows"),
}
# the ghost units of the 512^2 batch-32 step (pick_gh; block3 and block4
# are plain Bottlenecks): (N, H, W, Ci, db, Co, gh), block1_unit1 and
# block2_unit1 with a projection shortcut; block2_unit2-3 share a shape
GHOST_SHAPES = ((32, 128, 128, 64, 64, 256, 8), (32, 128, 128, 256, 64, 256, 8),
                (32, 64, 64, 256, 128, 512, 8), (32, 64, 64, 512, 128, 512, 8))
# ghost units of each of those shapes in a step
GHOST_SHAPE_UNITS = (1, 1, 1, 2)
# launches a step: 2 projection units (4 convs, 4 conv backwards) and 3
# identity units (3 and 3), one boundary and one seam pass each way a unit
GHOST_STEP_LAUNCHES = {"ghost_conv_fwd": 17, "ghost_boundary_fwd": 5,
                       "ghost_boundary_bwd": 5, "ghost_conv_bwd": 17,
                       "ghost_seam_bwd": 5}
# float32 tensor outputs (gm, the seam terms, the shortcut's dX): kernel
# and plain version sum the same bf16 products in another order, within
# this much of the tensor's largest value
F32_REL = 1e-4
# the ghost arm with its kernels against the same arm on the plain
# versions, one step each from the tempered state: the bounds lie between
# the sound runs' largest reading and the planted faults' smallest
# (--faults; PERF.md, Findings; readings on an H100 80GB HBM3 at 700 W).
# Each fault passes one reading and fails another: the dropped seam terms
# fail the cosine and the ghost-unit reading, the halo rows under their
# own band's affine all three, dW2 x 0.9 the ghost-unit reading only. The
# loss bound only catches coarse forward faults (the halo fault read
# 1.2e-4 to 2.3e-4, under the bound).
GHOST_ARM_LOSS_REL = 5e-4  # sound <= 1.64e-4
GHOST_ARM_GRAD_REL = 2.5e-2  # sound <= 1.60e-2; the halo fault >= 3.23e-2
GHOST_ARM_COS_MIN = 0.98   # sound >= 0.9930; seam 0.931, halo 0.978
# the worst relative error over the ghost units' parameters: sound <=
# 4.92e-2 (block2_unit2.conv1), faults >= 0.106 (dW2 x 0.9)
GHOST_ARM_UNIT_REL = 7.5e-2
# the ghost units of the step (the worst-parameter reading above)
GHOST_UNIT_NAMES = ("block1_unit1", "block1_unit2", "block2_unit1",
                    "block2_unit2", "block2_unit3")


def reset_ghost_counts():
    from tensorflow_ocr_tpu_torch.ops import ghost as G

    for attr, _ in GHOST_KERNELS.values():
        getattr(G, attr).launches = 0
    G.conv_bwd.by_kernel = dict.fromkeys(G.conv_bwd.by_kernel, 0)


def ghost_counts():
    from tensorflow_ocr_tpu_torch.ops import ghost as G

    return {name: getattr(G, attr).launches
            for name, (attr, _) in GHOST_KERNELS.items()}


def f32_close(name, got, want):
    err = float((got.float() - want.float()).abs().max())
    check(err <= F32_REL * float(want.float().abs().max()) + 1e-30,
          f"{name}: max err {err:.3e} beyond {F32_REL:g} of the largest value")
    return err


def phase_ghost_kernels(device, reports):
    """Each ghost kernel against its plain version at each unit shape of
    the step (GHOST_SHAPES), on one unit's chain: the forward's four
    convs and boundary, then the backward from a random dout, each
    kernel fed the plain version's outputs of the stage before. bf16
    outputs within one bf16 ulp, float32 tensors within F32_REL of their
    largest value, float32 sums within SUM_REL of the sum of their terms'
    magnitudes. Prints each call's kernel and plain ms, FLOPs, bytes and
    bound; the reports sum every call over the shapes."""
    import torch
    from tensorflow_ocr_tpu_torch.ops import ghost as G

    gen = torch.Generator().manual_seed(8)
    bf, cl = torch.bfloat16, torch.channels_last
    eps = 1e-5
    # no one PyTorch call computes a ghost-BN unit or a part of it
    for r in reports.values():
        r.update(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=None)

    def act(n, c, h, w, scale=1.0, relu=False):
        t = torch.randn(n, c, h, w, generator=gen) * scale
        t = torch.relu(t) if relu else t
        return t.to(device=device, dtype=bf).contiguous(memory_format=cl)

    def weight(co, ci, k):
        return (torch.randn(co, ci, k, k, generator=gen)
                / (k * k * ci) ** 0.5).to(device=device, dtype=bf)

    def gbt(c):
        return torch.stack([torch.empty(c).uniform_(0.5, 1.5, generator=gen),
                            torch.randn(c, generator=gen) * 0.1]).to(device)

    def timed(name, what, kernel, plain, errs, flops, nbytes, peak=PEAK_BF16):
        r = reports[name]
        r["max_abs_err"] = max(r["max_abs_err"], *errs)
        ms, pms = cuda_ms(kernel, 10), cuda_ms(plain, 2)
        bound = add_bound(r, flops, nbytes, peak)
        r["ms"] += ms
        r["plain_ms"] += pms
        print(f"{name} {what}: kernel {ms:.4f} ms, plain {pms:.4f}; "
              f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB, bound "
              f"{bound:.4f} ms; max abs err {max(errs):.3e}")
        return ms, bound

    fstep = dict(ms=0.0, fwd=0.0, bound=0.0, alone=0.0)

    def conv_fwd(what, x, tab, w, gh):
        got, want = G.conv_fwd(x, tab, w, gh), G.conv_fwd_reference(x, tab,
                                                                  w, gh)
        again = G.conv_fwd(x, tab, w, gh)
        torch.cuda.synchronize()
        check(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]),
              f"ghost conv_fwd {what}: two launches on the same inputs "
              "differ")
        del again
        # the statistics are of each side's own rounded y, and the two y
        # may round apart by an ulp: the kernel's sums are held against
        # the plain sums of its own y
        y = got[0].float()
        errs = [bf16_close(f"{what} y", got[0], want[0]),
                sum_close(f"{what} s", got[1], G.band_stats(got[0], gh),
                          G.band_sums(y.abs(), y * y, gh))]
        n, ci, h, wd = x.shape
        co, k = w.shape[0], w.shape[-1]
        m, nbt = n * h * wd, n * (h // gh)
        ms, bound = timed(
            "ghost_conv_fwd", what, lambda: G.conv_fwd(x, tab, w, gh),
            lambda: G.conv_fwd_reference(x, tab, w, gh), errs,
            2 * m * k * k * ci * co,
            2 * m * (ci + co) + 2 * k * k * ci * co + 8 * nbt * (ci + co))
        dev = kernel_device_ms(lambda: G.conv_fwd(x, tab, w, gh),
                               FWD_PARTS)["fwd"]
        ams = conv_alone_ms(G._act(x, tab, gh), w, 10)
        for key, v in (("ms", ms), ("fwd", dev), ("bound", bound),
                       ("alone", ams)):
            fstep[key] += units * v
        print(f"ghost_conv_fwd {what}: device {dev:.4f} ms, conv alone "
              f"{ams:.4f}; {units} a step; bit-equal twice")
        return want

    step = dict(ms=0.0, dW=0.0, dX=0.0, bound=0.0)
    sstep = dict(ms=0.0, device=0.0, bound=0.0)

    def conv_bwd(what, x, tx, g, z, td, w, gh, edge=None, addend=None,
                 out="gm"):
        args = (x, tx, g, z, td, w, gh, edge, addend, out)
        got, want = G.conv_bwd(*args), G.conv_bwd_reference(*args)
        again = G.conv_bwd(*args)
        torch.cuda.synchronize()
        check(all((a is None and b is None) or torch.equal(a, b)
                  for a, b in zip(got, again)),
              f"ghost conv_bwd {what}: two launches on the same inputs "
              "differ")
        del again
        n, ci, h, wd = x.shape
        co, k = w.shape[0], w.shape[-1]
        dz = G._dz(g, z, td, gh, edge).float().abs()
        with G.full_f32():
            if k == 1:
                scale = torch.nn.grad.conv2d_weight(
                    G._act(x, tx, gh).float().abs(), w.shape, dz)
            else:
                scale = torch.nn.grad.conv2d_weight(
                    G._act_halo(x, tx, gh).float().abs(), w.shape,
                    G._bands(dz, gh), padding=(0, 1))
        errs = [sum_close(f"{what} dw", got[2], want[2], scale)]
        if out == "gm":
            gm, xf = want[0], x.float()
            errs += [f32_close(f"{what} gm", got[0], gm),
                     sum_close(f"{what} sums", got[1], want[1],
                               G.band_sums((gm * xf).abs(), gm.abs(), gh))]
        elif out == "f32":
            errs.append(f32_close(f"{what} dx", got[0], want[0]))
        else:
            errs.append(bf16_close(f"{what} dx", got[0], want[0]))
        m, nbt = n * h * wd, n * (h // gh)
        gb, ob = g.element_size(), (2 if out == "act" else 4)
        nbytes = (m * ci * (2 + ob) + m * co * (gb + 2) + 6 * k * k * ci * co
                  + (0 if addend is None else m * ci * addend.element_size())
                  + (0 if edge is None else edge.numel() * 4)
                  + 4 * nbt * (5 * co + 4 * ci))
        ms, bound = timed("ghost_conv_bwd", what, lambda: G.conv_bwd(*args),
                          lambda: G.conv_bwd_reference(*args), errs,
                          4 * m * k * k * ci * co, nbytes)
        parts = kernel_device_ms(lambda: G.conv_bwd(*args), BWD_PARTS)
        for key, v in (("ms", ms), ("bound", bound), *parts.items()):
            step[key] += units * v
        print(f"ghost_conv_bwd {what}: device dW {parts['dW']:.4f} ms, dX "
              f"{parts['dX']:.4f}; {units} a step; bit-equal twice")
        return want

    for (n, h, wd, ci, db, co, gh), units in zip(GHOST_SHAPES,
                                                 GHOST_SHAPE_UNITS):
        proj, cnt = ci != co, float(gh * wd)
        tag = f"{'proj' if proj else 'identity'} {ci}/{db}/{co} at {n}x{h}x{wd} gh {gh}"
        m, nbt = n * h * wd, n * (h // gh)
        o = act(n, ci, h, wd, relu=True)
        w1, w2, w3 = weight(db, ci, 1), weight(db, db, 3), weight(co, db, 1)
        gb1, gb2, gb3 = gbt(db), gbt(db), gbt(co)
        z1, s1 = conv_fwd(f"z1 {tag}", o, None, w1, gh)
        t1 = G.affine_of(s1, gb1, cnt, eps)
        z2, s2 = conv_fwd(f"z2 {tag}", z1, t1, w2, gh)
        t2 = G.affine_of(s2, gb2, cnt, eps)
        z3, s3 = conv_fwd(f"z3 {tag}", z2, t2, w3, gh)
        t3 = G.affine_of(s3, gb3, cnt, eps)
        if proj:
            ws, gbs = weight(co, ci, 1), gbt(co)
            zs, ss = conv_fwd(f"zs {tag}", o, None, ws, gh)
            ts = G.affine_of(ss, gbs, cnt, eps)
        else:
            zs, ts = o, None
        out = G.boundary_fwd(z3, t3, zs, ts, gh)
        want = G.boundary_fwd_reference(z3, t3, zs, ts, gh)
        torch.cuda.synchronize()
        timed("ghost_boundary_fwd", tag,
              lambda: G.boundary_fwd(z3, t3, zs, ts, gh),
              lambda: G.boundary_fwd_reference(z3, t3, zs, ts, gh),
              [bf16_close(f"out {tag}", out, want)], 5 * m * co,
              6 * m * co + 16 * nbt * co, PEAK_F32)
        del out, want

        dout = act(n, co, h, wd, 1e-2)
        got = G.boundary_bwd(dout, z3, t3, zs, ts, gh)
        again = G.boundary_bwd(dout, z3, t3, zs, ts, gh)
        gm3, sb = G.boundary_bwd_reference(dout, z3, t3, zs, ts, gh)
        torch.cuda.synchronize()
        check(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]),
              f"ghost boundary_bwd {tag}: two launches on the same inputs "
              "differ")
        del again
        gf = gm3.float().abs()
        scale = torch.cat([G.band_sums(gf * z3.float().abs(), gf, gh),
                           G.band_sums(gf * zs.float().abs(), gf, gh)[:, :, :1]],
                          2)
        timed("ghost_boundary_bwd", tag,
              lambda: G.boundary_bwd(dout, z3, t3, zs, ts, gh),
              lambda: G.boundary_bwd_reference(dout, z3, t3, zs, ts, gh),
              [bf16_close(f"gm3 {tag}", got[0], gm3),
               sum_close(f"gm3 sums {tag}", got[1], sb, scale)],
              8 * m * co, 8 * m * co + 28 * nbt * co, PEAK_F32)
        del got

        def corr(dab, stats, gb, t):
            c, _ = G.stat_corr(dab, stats, gb, cnt, eps)
            return torch.cat([t[:, :, :1], c], 2).contiguous()

        td3 = corr(sb[:, :, :2], s3, gb3, t3)
        gm2, sb2, _ = conv_bwd(f"conv3 {tag}", z2, t2, gm3, z3, td3, w3, gh)
        td2 = corr(sb2, s2, gb2, t2)
        gm1, sb1, _ = conv_bwd(f"conv2 {tag}", z1, t1, gm2, z2, td2, w2, gh)
        args = (gm2, z2, td2, z1, t1, w2, gh)
        got, again = G.seam_bwd(*args), G.seam_bwd(*args)
        edge, sh = G.seam_bwd_reference(*args)
        torch.cuda.synchronize()
        check(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]),
              f"ghost seam_bwd {tag}: two launches on the same inputs differ")
        del again
        gms, xs, _ = G.seam_terms(*args)
        scale = torch.stack([(gms[0] * xs[0]).abs() + (gms[1] * xs[1]).abs(),
                             gms[0].abs() + gms[1].abs()], 1).sum(3)
        rows = 2 * nbt * wd
        ms, bound = timed(
            "ghost_seam_bwd", tag, lambda: G.seam_bwd(*args),
            lambda: G.seam_bwd_reference(*args),
            [f32_close(f"seam edge {tag}", got[0], edge),
             sum_close(f"seam sums {tag}", got[1], sh,
                       scale.reshape(sh.shape))],
            2 * rows * 3 * db * db,
            rows * db * (4 + 2 + 2 + 4) + 18 * db * db + 8 * nbt * db)
        dev = kernel_device_ms(lambda: G.seam_bwd(*args),
                               SEAM_PARTS)["seam"]
        for key, v in (("ms", ms), ("device", dev), ("bound", bound)):
            sstep[key] += units * v
        print(f"ghost_seam_bwd {tag}: device {dev:.4f} ms; {units} a step; "
              "bit-equal twice")
        del got, gms, xs, scale
        td1 = corr(sb1 + sh, s1, gb1, t1)
        if proj:
            tds = corr(sb[:, :, [2, 1]], ss, gbs, ts)
            addend = conv_bwd(f"shortcut {tag}", o, None, gm3, zs, tds, ws,
                              gh, out="f32")[0]
        else:
            addend = gm3
        conv_bwd(f"conv1 {tag}", o, None, gm1, z1, td1, w1, gh, edge=edge,
                 addend=addend, out="act")
        del o, z1, z2, z3, zs, dout, gm3, gm2, gm1, edge, addend
        torch.cuda.empty_cache()
    print(f"ghost_conv_fwd a train step (each call's ms times its units in "
          f"a step, {GHOST_STEP_LAUNCHES['ghost_conv_fwd']} in all): "
          f"{fstep['ms']:.4f} ms by events (device {fstep['fwd']:.4f}), "
          f"bound {fstep['bound']:.4f}, conv alone {fstep['alone']:.4f}")
    print(f"ghost_conv_bwd a train step (each call's ms times its units in "
          f"a step, {GHOST_STEP_LAUNCHES['ghost_conv_bwd']} in all): "
          f"{step['ms']:.4f} ms by events (device: dW {step['dW']:.4f}, dX "
          f"{step['dX']:.4f}), bound {step['bound']:.4f}")
    print(f"ghost_seam_bwd a train step (each call's ms times its units in "
          f"a step, {GHOST_STEP_LAUNCHES['ghost_seam_bwd']} in all): "
          f"{sstep['ms']:.4f} ms by events (device {sstep['device']:.4f}), "
          f"bound {sstep['bound']:.4f}")
    print("ghost kernels: ms, plain_ms and bound_ms in the kernels line are "
          "sums over every call of one unit's chain at each of the "
          f"{len(GHOST_SHAPES)} unit shapes; max_abs_err over its "
          "tensor outputs (the f32 sums are checked against SUM_REL above); "
          "conv alone is torch.matmul / F.conv2d of the input activated "
          "under its own band (the 3x3's halo rows aside), a yardstick for "
          "the forward's product, not the same function")


@contextlib.contextmanager
def plain_ghost():
    """The ghost unit's wrappers replaced by their plain versions inside
    the block, so that its autograd Functions compose the plain versions
    (the plain arm of the ghost check)."""
    from tensorflow_ocr_tpu_torch.ops import ghost as G

    saved = {attr: getattr(G, attr) for attr, _ in GHOST_KERNELS.values()}
    for attr in saved:
        setattr(G, attr, getattr(G, f"{attr}_reference"))
    try:
        yield
    finally:
        for attr, fn in saved.items():
            setattr(G, attr, fn)


def ghost_readings(kernel, plain):
    """arm_readings of the kernel arm against the plain arm, plus the
    worst relative gradient error over the ghost units' parameters (a
    fault in one of their gradients hardly moves the whole gradient)."""
    r = arm_readings(kernel, plain)
    gk, gp = kernel[1], plain[1]
    unit = {n: float((gk[n] - gp[n]).norm() / gp[n].norm()) for n in gp
            if n.split(".")[1] in GHOST_UNIT_NAMES}
    worst = max(unit, key=unit.get)
    r["unit"] = (worst, unit[worst])
    return r


def ghost_arm_readings(device, start, batch):
    """One ghost-arm step on the kernels against one on the plain
    versions, from the state ``start`` and one batch (ghost_readings)."""
    kernel = arm_grads(device, start, batch, "ghost")
    with plain_ghost():
        plain = arm_grads(device, start, batch, "ghost")
    return ghost_readings(kernel, plain)


def print_ghost_arms(label, r):
    print(f"{label}: loss {r['loss'][0]:.6f} / {r['loss'][1]:.6f} (rel "
          f"{r['rel_loss']:.3e}, tol {GHOST_ARM_LOSS_REL:g}); gradient norm "
          f"{r['norm'][0]:.6f} / {r['norm'][1]:.6f}, rel err "
          f"{r['grad_rel']:.4e} (tol {GHOST_ARM_GRAD_REL:g}); worst "
          f"parameter cosine {r['worst'][1]:.6f} at {r['worst'][0]} (min "
          f"{GHOST_ARM_COS_MIN:g}); worst ghost-unit parameter rel err "
          f"{r['unit'][1]:.4e} at {r['unit'][0]} (tol "
          f"{GHOST_ARM_UNIT_REL:g})")


def phase_ghost_train(device, reports, snap, batch):
    """The ghost arm at full width: 3 steps through Trainer.run, each
    ghost kernel launched GHOST_STEP_LAUNCHES times a step; one step on
    the kernels against one on the plain versions from the tempered
    state (GHOST_ARM_* bounds); one freeze_bn step (eval-mode ghost
    units: no kernel)."""
    import numpy as np
    import torch
    from tensorflow_ocr_tpu_torch.models.resnet import GhostBottleneck
    from tensorflow_ocr_tpu_torch.ops import ghost as G
    from tensorflow_ocr_tpu_torch.train import trainer as T

    want = {k: TRAIN_STEPS * v for k, v in GHOST_STEP_LAUNCHES.items()}
    trainer = T.Trainer(train_config("ghost"), device)
    state = trainer.setup(weights=snap)
    ghost = []
    hooks = [m.register_forward_pre_hook(
        lambda m, a, name=name: ghost.append(name)
        if m.band_height(a[0].shape) else None)
        for name, m in state.model.backbone.named_children()
        if isinstance(m, GhostBottleneck)]
    reset_ghost_counts()
    last = trainer.run([batch] * TRAIN_STEPS, TRAIN_STEPS)
    torch.cuda.synchronize()
    counts = ghost_counts()
    by_kernel = dict(G.conv_bwd.by_kernel)
    for h in hooks:
        h.remove()
    units = sorted(set(ghost))
    print(f"ghost units at {TRAIN_SIZE}^2: {len(units)} ({', '.join(units)})")
    print(f"train {TRAIN_STEPS} steps ghost: last metrics "
          f"{json.dumps({k: round(v, 5) for k, v in last.items()})}; "
          f"kernel launches {counts} (expected {want})")
    check(units == sorted(GHOST_UNIT_NAMES), "ghost train: the ghost units "
          f"are not {GHOST_UNIT_NAMES}")
    check(state.step == TRAIN_STEPS and last and all(
        np.isfinite(v) for v in last.values()), "ghost train: non-finite "
          "or missing metrics")
    print(f"ghost_conv_bwd by kernel: {by_kernel} (conv_bwd.cuh tdw, tdx; "
          f"expected {want['ghost_conv_bwd']} each)")
    check(counts == want, "ghost train: ghost kernel launches")
    check(by_kernel == dict.fromkeys(by_kernel, want["ghost_conv_bwd"]),
          "ghost train: conv backward launches by kernel")
    for name, n in counts.items():
        reports[name]["launches"] = n
    del trainer, state
    torch.cuda.empty_cache()

    r = ghost_arm_readings(device, tempered(snap), batch)
    print_ghost_arms(f"ghost kernels vs plain versions, one step from one "
                     f"state (residual BN scales x {ARM_RESIDUAL_SCALE:g})", r)
    check(r["rel_loss"] <= GHOST_ARM_LOSS_REL, "ghost kernel and plain "
          "losses disagree")
    check(r["grad_rel"] <= GHOST_ARM_GRAD_REL, "ghost kernel and plain "
          "gradients disagree")
    check(r["worst"][1] >= GHOST_ARM_COS_MIN, f"the ghost kernels' "
          f"gradient of {r['worst'][0]} points elsewhere than the plain one")
    check(r["unit"][1] <= GHOST_ARM_UNIT_REL, f"the ghost kernels' "
          f"gradient of {r['unit'][0]} differs from the plain one")

    fcfg = train_config("ghost", freeze_bn=True)
    state = T.create_train_state(fcfg, device, weights=snap)
    reset_ghost_counts()
    loss = float(T.train_step(state, batch, fcfg,
                              T.make_loss_fn(fcfg))["total_loss"])
    counts = ghost_counts()
    print(f"freeze_bn step ghost: total loss {loss:.6f}, ghost kernel "
          f"launches {counts}")
    check(np.isfinite(loss), "ghost freeze_bn step: non-finite loss")
    check(not any(counts.values()), "ghost freeze_bn step launched a ghost "
          "kernel (eval-mode units have none)")
    del state
    torch.cuda.empty_cache()


def phase_ghost_faults(device, snap, batch):
    """The readings that set the GHOST_ARM_* bounds: the ghost arm on the
    kernels against the plain versions from the tempered state, 3 sound
    runs, then one run under each fault planted in the kernel arm: the
    seam terms dropped, the 3x3's halo rows under their own band's affine
    (one SAME conv over one act1 tensor), dW2 x 0.9."""
    import torch
    from tensorflow_ocr_tpu_torch.ops import ghost as G

    fwd, bwd, seam = G.conv_fwd, G.conv_bwd, G.seam_bwd

    def no_seam(*a):
        edge, sums = seam(*a)
        return edge.zero_(), sums.zero_()

    def own_band_halo(x, tab, w, gh):
        if w.shape[-1] == 1:
            return fwd(x, tab, w, gh)
        act = G._act(x, tab, gh).contiguous(memory_format=torch.channels_last)
        return fwd(act, None, w, gh)

    def dw2_scaled(*a, **k):
        dx, sums, dw = bwd(*a, **k)
        return dx, sums, dw * 0.9 if dw.shape[-1] == 3 else dw

    for fn in (no_seam, own_band_halo, dw2_scaled):
        # the wrappers count on the names they replace
        fn.launches, fn.by_kernel = 0, {}
    start = tempered(snap)
    for i in range(3):
        print_ghost_arms(f"ghost faults: sound run {i}",
                         ghost_arm_readings(device, start, batch))
    for label, attr, fn in (("seam terms dropped", "seam_bwd", no_seam),
                            ("halo rows under their own band's affine",
                             "conv_fwd", own_band_halo),
                            ("dW2 x 0.9", "conv_bwd", dw2_scaled)):
        orig = getattr(G, attr)
        setattr(G, attr, fn)
        try:
            kernel = arm_grads(device, start, batch, "ghost")
        finally:
            setattr(G, attr, orig)
        with plain_ghost():
            plain = arm_grads(device, start, batch, "ghost")
        print_ghost_arms(f"ghost faults: {label}",
                         ghost_readings(kernel, plain))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace serve, detect and train steps with "
                    "torch.profiler")
    ap.add_argument("--faults", action="store_true",
                    help="also read the pallas-conv and ghost arm checks "
                    "under planted faults")
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
    build_all()

    report = {"name": "connected_components", "route": "cuda",
              "source": "tensorflow_ocr_tpu_torch/csrc/cc.cu",
              "replaces": "tensorflow_ocr_tpu/ops/pallas_kernels.py:91"}
    fused = {name: {"name": name, "route": "cuda", "source": src,
                    "replaces": sites}
             for name, (_, src, sites) in FUSED_KERNELS.items()}
    conv = {name: {"name": name, "route": "cuda", "source": src,
                   "replaces": site}
            for name, (src, site) in CONV_KERNELS.items()}
    ghost = {name: {"name": name, "route": "cuda", "source": GHOST_SRC,
                    "replaces": sites}
             for name, (_, sites) in GHOST_KERNELS.items()}
    phase_cc(device, report)
    phase_forward(device)
    pred, images = phase_main_path(device, report)
    phase_timing(pred, images)
    if args.profile:
        phase_profile(pred, images)
    phase_conv_kernels(device, conv)
    phase_conv_detect(pred, images)
    del pred
    torch.cuda.empty_cache()

    phase_fused_kernels(device, fused)
    trainer, batch, snap = phase_train(device, fused)
    if args.faults:
        phase_conv_faults(device, snap, batch)
    phase_conv_train(device, conv, snap, batch)
    phase_ghost_kernels(device, ghost)
    if args.faults:
        phase_ghost_faults(device, snap, batch)
    phase_ghost_train(device, ghost, snap, batch)
    phase_train_timing(trainer, batch)
    if args.profile:
        phase_profile_train(trainer, batch)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{k: r[k] for k in keys}
               for r in [report, *fused.values(), *conv.values(),
                         *ghost.values()]]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
