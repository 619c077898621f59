#!/usr/bin/env python3
"""Smoke test of the PyTorch port (tensorflow_ocr_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py [--profile] [--faults]

Phases, in order; any failure raises and exits non-zero:

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build the eight CUDA sources of csrc/ (nvcc, sm_90a; nvjpeg_loader.cu
   linked with -lnvjpeg), one nvcc each, all started together;
3. hold the connected-components kernel (launched through its
   torch.library op) against its plain PyTorch version on the card: (8, 192, 320) text-like blob maps, hand cases
   (the diagonal chains and the serpentines cross the kernel's tiles at
   their sides and corners) and a (3, 100, 150) batch of ragged tiles;
   int32 labels must be equal, and equal on two launches; print both
   times and the kernel's device time (replayed from a CUDA graph);
4. full-width pixellink_resnet50 and east_resnet50 forwards, float32,
   TF32 off, 256x256 on the card against the same seeded weights on the
   CPU;
5. the main path: Predictor.detect_batch at full width, bfloat16, on
   8 x 1280x768 uint8 images; the kernel's launch count must rise, and
   the boxes must equal those decoded from the same logits with the
   plain connected components;
6. time detect (p50, batch 1, 1280x768) and detect_batches (img/s,
   batch 8) after a warm-up, each over 2 windows of at least 1 s;
   print each window and their median;
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
   each kernel's ms a train step; then the same at the shapes that
   east_resnet50's route adds (its merge: 1x1s from 2560, 384 and 128
   channels, 3x3s at 128, 64 and 32), train and detect, summed apart;
9. detect_batch with PALLAS_CONVS on: 44 + 13 conv launches a forward,
   all on conv_fwd.cu, logits within CONV_DETECT_REL of the cuDNN
   forward's, the CC kernel still launched;
8b. the route's four kernels in float32 (conv_fwd.cu conv_fwd_tma_f32,
   conv_dw.cu conv_dw_tma_f32, conv.cu's narrow float32 kernels) at the
   shapes of phase 8 (train, tails, detect): y, dX and dW each within
   F32_ERR_MULTIPLE times the plain float32 version's error (TF32 off)
   against the float64 product, launched twice and bit-equal; at the
   train shapes kernel, plain and library (float32, TF32 off) ms, FLOPs,
   bytes and bound;
9b. Predictor(dtype=torch.float32) detect_batch with PALLAS_CONVS on: 57
   launches, all on the float32 kernels, the CC kernel launched, logits
   within FWD_REL_TOL of the cuDNN float32 forward's (TF32 off on both);
9c. Predictor(dtype=torch.float32, bottleneck_impl="fused") detect_batch:
   43 fused_conv_fwd_f32 and 13 fused_boundary_fwd_f32 launches, no
   bfloat16 fused kernel, the CC kernel launched, logits within
   F32_FUSED_DETECT_REL of the largest logit of the float32 "xla"
   Predictor's on the same weights (TF32 off on both);
10. hold each fused kernel against its plain version at every shape the
   train step gives it (the 15 1x1 and 4 3x3 convs of the fused units,
   the boundary of each block): forward y and s, backward dx, dab and
   dw (each forward and backward launched twice and held bit-equal);
   print kernel and plain ms, the forward's device ms and its conv-alone
   yardstick, the backward's dW and dX device ms (torch.profiler) and
   each conv kernel's ms a train step;
10b. (before phase 10) phase 32's dataset written, and the state the arm
   checks of phases 11, 13 and 16 start from: AUG_TRAINED_STEPS fused
   steps of run_device_cached with augmentation on it, from the seeded
   state (the residual BN scales' spread printed before and after);
10c. the bfloat16 eval forward against the float32 one (TF32 off) from
   that state on 8 v2 frames at 512^2: per output the mean and largest
   |bf16 - f32| over the largest logit, the mean signed error of the
   pixel logits and the mean pixel probability, each within
   BF16_CARD_MULTIPLE times the CPU budget of tests/test_torch_bf16.py;
11. the train step at full width: pixellink_resnet50, bottleneck_impl
   "fused", 512x512, batch 32, bf16, labels made on the card from the
   polygons of numpy scenes; 3 steps through Trainer.run with finite
   losses and every fused kernel's launch count risen, the backward's
   launches by kernel (conv_bwd.cuh tdw and tdx) at 43 a step; one step
   each of the fused and the "xla" arm (plain Bottleneck, cuDNN convs) from the
   augmented state (phase 10b) and one batch: loss, gradient, the worst
   parameter's direction and the fused units' readings within the stated
   tolerances; one freeze_bn step; then bench.py's fine-tune recipe
   (freeze_bn, the OHEM loss in bfloat16) from the augmented state under
   torch.use_deterministic_algorithms: one frozen fused step with the
   bfloat16 loss beside one with the float32 loss (every fused kernel
   launched, the loss within LOSS_BF16_REL of the float32 one, the
   gradient's cosine at least LOSS_BF16_COS_MIN), and the loss dtype
   resolved through OCR_LOSS_BF16 (1 over a float32 config, 0 over a
   bfloat16 one): parameters, BN buffers, Adam moments, EMA and metrics
   bit-equal to the config's step of the same dtype;
11b. the four fused kernels in float32 (fused_conv.cu fused_conv_fwd_f32
   and fused_conv_bwd_f32 on conv_bwd.cuh tdx_f32 and tdw_f32_tr,
   fused_boundary.cu's float32 entries) at the shapes of phase 10: y, s,
   dx, dab and dw each within F32_ERR_MULTIPLE times the plain float32
   version's error (TF32 off) against the float64 result, the boundary's
   out, dz and dzs within F32_BOUNDARY_ULPS of the plain version's and
   its sums to the same rule; each launched twice and bit-equal; kernel
   and plain ms, bound and the float32 conv-alone yardsticks; each
   shape's tdx_f32 plans (bn, resident, stages, eslots, overlap) with
   their instantiations' registers and spilled bytes; each tdx_f32
   instantiation (DX32_INSTANCES: BN 64 and 128, overlap off and on) at
   one 1x1 shape against the plain version;
11c. the fused arm in float32 (model.compute_dtype "float32"): 3 steps
   through Trainer.run, FUSED_F32_STEP_LAUNCHES a step on the float32
   kernels (the dW tdw_f32_tr, counted as tdw_f32, and tdx_f32 43 a step
   each) and none on a bfloat16
   one; eager img/s and the peak memory; one step against the float32
   "xla" arm (cuDNN, TF32 off) from the augmented state (F32_FUSED_ARM_*
   bounds); one float32 freeze_bn step on the float32 kernels;
12. with --faults only: the readings of the fused arm check (phase 11:
   dW, dX and the boundary's dz x 0.9 planted; and in float32, phase 11c)
   and of the pallas-conv
   arm check (phase 13) in 3 sound runs and under planted backward
   faults, which set the ARM_* and CONV_ARM_* bounds, from the augmented
   state (phase 10b);
13. the PALLAS_CONVS arm ("xla" bottlenecks, the supported convs on the
   conv kernels): 3 steps through Trainer.run with the four kernels'
   launch counts at their expected values, and the dW launches of each
   of the two dW kernels; one step against the same
   arm on cuDNN from the augmented state (CONV_ARM_* bounds); one
   freeze_bn step with the route on (the BN fold path);
13b. the same arm in float32 (model.compute_dtype "float32"): 3 steps
   through Trainer.run, every routed product on a float32 kernel
   (CONV_STEP_LAUNCHES a step, none on a bfloat16 one), eager img/s over
   ARM_WINDOWS windows of ARM_WINDOW_S and the peak memory; one step
   against the float32 cuDNN arm (TF32 off) from the augmented state
   (F32_ARM_* bounds); with --faults (phase 12) its readings too;
14. hold each of the five ghost-BN kernels (csrc/ghost_unit.cu) against
   its plain version along one unit's forward and backward chain at
   each of the 4 ghost unit shapes of the 512^2 batch-32 step (each conv
   forward and backward, the boundary's backward and the seam pass
   launched twice and held bit-equal); print kernel and plain ms, the
   FLOPs, bytes and bound of each call, the conv forward's device ms and
   conv-alone yardstick, the conv backward's dW and dX and the seam's
   device ms, and each conv kernel's and the seam's ms a train step;
14b. the five ghost kernels in float32 (ghost_unit.cu's float32 entries:
   conv_bwd.cuh tdx_f32 with BandActTr32 and GhostTr32, tdw_f32_tr with
   GhostTr32, gboundary32, tseam32) along one unit's chain at the 4 ghost
   unit shapes: y, the band sums, dw, gm, its sums, dx, the seam's terms
   and sums each within F32_ERR_MULTIPLE times the plain float32
   version's error (TF32 off) against the float64 result, the boundary's
   out within F32_BOUNDARY_ULPS of the plain version's, its gm equal and
   its sums to the same rule; each launched twice and bit-equal; kernel
   and plain ms, bound and the float32 conv-alone yardsticks, each
   kernel's ms a train step; the tdx_f32 plans and instantiations as
   phase 11b's (conv3's forward and backward at one unit shape);
15. with --faults only: the readings of the ghost arm check (phase 16)
   in 3 sound runs and under planted faults, which set GHOST_ARM_*, from
   the augmented state; and in float32 (phase 16b's), which set
   F32_GHOST_ARM_*;
16. the ghost arm (bottleneck_impl "ghost": 5 ghost units, the other 8
   stride-1 units plain): 3 steps through Trainer.run with the five
   kernels' launch counts at their expected values (the conv backward's
   by kernel too); one step on the
   kernels against one on the plain versions from the augmented state
   (GHOST_ARM_* bounds); one freeze_bn step (no ghost kernel);
16b. the ghost arm in float32 (model.compute_dtype "float32"): 3 steps
   through Trainer.run, GHOST_F32_STEP_LAUNCHES a step on the float32
   kernels (the dW tdw_f32_tr, counted as tdw_f32, and tdx_f32 17 a step
   each) and none on a bfloat16
   one; eager img/s and the peak memory; one step on the kernels against
   one on the plain float32 versions (TF32 off) from the augmented state
   (F32_GHOST_ARM_* bounds); one float32 freeze_bn step (no ghost
   kernel);
17. multi-step = eager: for the fused, ghost, xla, xla pallas-conv,
   float32 xla pallas-conv, float32 fused and float32 ghost arms, and
   bench.py's frozen arms with the bfloat16 OHEM loss (freeze_bn on the
   xla and on the fused arm), one
   make_multi_train_step dispatch of 4 steps (one step
   captured into a CUDA graph after 2 warm-up steps, replayed 4 times)
   against 4 eager train_step calls from the same state and dataset rows
   (64 numpy scenes on the card, labels precomputed there), under
   torch.use_deterministic_algorithms: parameters, BN buffers, Adam
   moments, EMA, step and the last metrics bit-equal; each arm's kernels
   launched at the capture and not at the replays (a second dispatch
   launches none and is bit-equal again); fused arm: a checkpoint
   restored into the captured state in place, then replayed, gives the
   same state;
18. resume = uninterrupted on the fused arm: 4 steps through Trainer.run
   against 2 steps, save_checkpoint(block=False) and a fresh Trainer
   with restore=True for 2 more (the data iterator resumed): bit-equal;
   the checkpoint's size, and the seconds of its copy to the host, its
   write and a restore;
   max_checkpoints_to_keep 1 keeps one ckpt_*; a SIGTERM sent in the
   middle of run leaves a checkpoint and stops the loop;
19. serve from that checkpoint: Predictor(checkpoint_path=...) on 8 x
   1280x768 uint8 images launches the CC kernel and returns the boxes of
   a Predictor given the same EMA parameters and BN buffers; a planted
   operating_point.json moves its thresholds;
20. with --faults only: the readings of phases 12 and 15 again, from a
   port checkpoint trained 50 steps (one graph dispatch) on the numpy
   scenes in place of the augmented state;
21. train img/s for the fused, xla, freeze_bn-fused, xla pallas-conv and
   ghost arms, each over 2 windows of at least 1 s (median and range);
22. the same five arms through make_multi_train_step, 16 steps a
   dispatch (the graph replayed), over 1 window of at least 1 s; with
   --profile also the device idle share of one dispatch of the fused and
   ghost arms;
23. with --profile only: a torch.profiler trace of 3 train steps of the
   fused, the xla pallas-conv and the ghost arm;
24. pixellink_resnet50 on the fused arm with the dice, positive and
   focal losses: one step each (finite loss and gradients, the fused
   backward 43 a step), and with dice a 4-step graph dispatch bit-equal
   to eager steps;
25. the slice's main path, east_resnet50 RBOX with the EAST loss on the
   fused arm at 512^2, batch 32, EAST labels made on the card: 2
   warm-up steps (every fused kernel launched), eager img/s over 3
   windows of at least 2 s on one batch, whose loss must fall from step
   0's; on 64 scenes with the EAST maps precomputed, a 4-step graph
   dispatch bit-equal to eager steps (and a restore under the graph),
   graph img/s over 3 windows of 9 dispatches of 16 steps, and the
   trained state (448 steps) saved;
26. east_resnet50 with PALLAS_CONVS: one xla step and detect at 8 x
   1280x768, each conv kernel launched as the route's convs give, the
   outputs within EAST_DETECT_REL of cuDNN's;
27. east_resnet50 with the focal loss and with QUAD geometry: one fused
   step each, finite loss and gradients;
28. EAST serving from the checkpoint of phase 25: Predictor(checkpoint_path)
   on 8 x 1280x768 scenes (an operating point planted if few pixels pass
   the score threshold), east_detect on the card equal to the CPU's on
   the same maps, the boxes NMS keeps equal to the CPU decode's; detect
   p50 and serve img/s over 1 window of 2 s, with the host NMS ms;
29. pixellink2s_vgg16 (OHEM, labels at stride 2): eager train img/s and
   peak memory; detect through the CC kernel, held against its plain
   version at the stride-2 maps (8, 384, 640); detect and serve timed;
30. link8_resnet50: one fused dice step; detect through the link8 schema
   and the CC kernel, boxes equal to a plain-CC decode's;
31. one detect_batch each of east_vgg16, pixellink_vgg16 (the CC kernel)
   and east_tiny;
32. the data tier, pixellink_resnet50 on the fused arm at 512^2, batch 32,
   16 polygon slots, OHEM, bf16: make_synthetic_dataset writes bench.py's
   16 default images and 16 "v2" images at 1280x720 (timed); nvJPEG's
   decode of a committed fixture against its committed cv2 decode
   (DECODE_*_LEVELS), the card's resize bit-equal to codec.resize, and
   an upscale of a 150x200 crop to 1280x720 (the border rows) bit-equal
   too, and the decode-and-resize img/s of the 16 v2 frames; a directory
   of the fixture and a PNG of its pixels staged by DeviceDataset: both
   frames, the PNG decoded on the host (load_batch.host_decoded up by 1),
   resized on the card and bit-equal to codec.resize of codec.imread (a
   second check of the card's resize), the JPEG by nvJPEG
   (launches up by 1); a file with the JPEG magic that nvJPEG refuses
   raises;
   Trainer.run_device_cached for two dispatches of 16 steps without
   augmentation (nvJPEG staging, labels precomputed) and with random
   scale, crop and rotation inside the captured step (finite losses, the
   fused kernels launched at the capture, images_per_sec_steady of each);
   16 augmented graph steps bit-equal to 16 eager ones under
   deterministic algorithms, the augment draws on the card equal to the
   CPU's, the warp on the card within WARP_ATOL of the CPU's; host ingest
   (ResumableLoader -> PrefetchLoader -> DevicePrefetcher, crop and
   rotation on the host) through Trainer.run with a mid-epoch checkpoint,
   a fresh trainer and loader restored from it taking the uninterrupted
   run's next 2 batches image for image, and the host's cost of a sample
   with all three augmentations; Predictor(checkpoint_path=...) from the
   checkpoint of phase 10b's augmented state on 8 v2 images read by
   codec.imread: the CC kernel launched, a box on every image, the boxes
   those of a plain-CC decode of the same maps;
33. checkpoint-time calibration on that checkpoint (768 augmented steps):
   train/calibrate.py calibrate_and_store with phase 32's dataset as the
   train split (8 images, the 20 pixel x link points): operating_point.json
   with the step and grid values, the CC kernel launched by the sweep,
   Predictor(checkpoint_path=...) calibrated, F at the pick >= F at
   (0.8, 0.8) less 0.015 on the slice; the sweep's seconds and overflow
   retries;
34. calibration inside the loop: run_device_cached for 3 dispatches of
   16 steps on phase 32's dataset with a save after each and
   calibrate_at_checkpoint on: an operating point with the step after
   each save; the state bit-equal to the same run with calibration off;
35. EAST calibration: phase 25's 448-step checkpoint trained 448 more
   graph steps on its scenes, then the 15 score x NMS points on 2 of
   them, written as an ICDAR directory (PNG and gt_*.txt), timed; the
   sweep's best F > 0 and the pick within 0.015 of it and of F at the
   default thresholds (written apart: phase 28's serving keeps its
   thresholds);
36. the deeper backbones: east_resnet101 and pixellink_resnetv2_50
   forwards in float32 against the CPU (phase 4's check);
   east_resnet101 fused-arm steps at 512^2, batch 32 (fused kernels
   launched, img/s over 1 window of >= 3 s, peak memory);
   pixellink_resnet152 and pixellink_resnet200 one fused and one ghost
   step each at batch 8
   (the ghost units on the ghost path, peak memory);
   pixellink_resnetv2_50 one step with PALLAS_CONVS (its ConvBNs on the
   conv kernels); one east_resnet101 detect_batch at 8 x 1280x768 (NMS
   input capped at 128 candidates an image), a box on every image;
37. the entry points at full width (pixellink_resnet50): 8 default-tier
   frames at 1280x720; python -m tensorflow_ocr_tpu_torch.cli.multigpu_train
   in a fresh process, 20 steps of 8 at 512^2 on the fused arm (finite
   losses, every fused kernel launched, a ckpt_20 and its
   operating_point.json); cli.test and cli.test_pixellink_fast in
   another (a res_*.txt per frame, the CC kernel launched), cli.test's
   files equal an in-process Predictor(checkpoint_path=...)'s; presets
   1-4 one step each through the train entry and, from a synthetic slim
   resnet_v1_50 .npz of every name at its real shape, Trainer.setup
   taking SLIM_LOADED tensors equal to the file and one step through
   --pretrained_model_path (finite losses); pixellink_resnet50 serving
   bundles at 8 x 1280x768 (decode + baked weights, maps + external
   weights) exported, each loaded in a fresh process: the boxes equal
   Predictor.detect_batch's, the CC kernel launched there, the maps within
   BUNDLE_MAPS_ATOL of the live forward; export seconds, sizes, batch ms
   beside the Predictor's; the package photographs this machine has, and
   4 photo:train and 4 photo2:val frames where it has them;
38. multi-GPU (tensorflow_ocr_tpu_torch/parallel/), in processes that
   python -m torch.distributed.run starts (the card machine has one
   H100, so NCCL runs a world of one; within MGPU_TIME_S): (a) a world-1
   NCCL group as torchrun sets it up: the fused arm's 4-step dispatch at
   512^2, batch 32, its NCCL all-reduces captured in the CUDA graph,
   bit-equal to the same dispatch with no process group under
   deterministic algorithms, the fused kernels launched at the capture;
   spatial_forward of the Predictor's model at 8 x 1280x768 at world 1:
   maps and boxes equal to the Predictor's, the CC kernel launched, and
   of a fused-arm Predictor on the same weights, equal to its own, its
   fused kernels launched; (b)
   two gloo ranks on the one card (gloo chosen by name): one eager fused
   step of the global batch of 32, 16 a rank, bit-equal on both ranks to
   one process running the two halves in turn from the same state and
   summing the gradients, BN buffers and metrics in rank order, halved
   (a two-rank sum is one addition); the same emulation with rank 1's
   gradients x 0.9 planted must differ; each rank's step ms, gradient
   all-reduce ms and peak memory, with the card's name and power limit;
   then per-rank shard reading of 8 synthetic 1280x720 frames (global
   batch 8, 512^2, crop and rotation on the host): each rank's
   ResumableLoader(group) batches bit-equal to its rows of a world-1
   loader's, file names too, prepare_sample run 4 times a batch against
   8, the state bytes equal on both ranks and to world-1's, batch 1
   resumed from rank 0's state bit-equal; one eager fused step from
   DevicePrefetcher(group) over the per-rank chain bit-equal to the step
   on the whole reader's rows and across ranks, the fused kernels
   launched; each rank's host seconds a batch, per-rank and whole;
39. the kernel arms served sharded on H (parallel/spatial.py), each
   shard emulated on the one card: a one-shard forward of the whole
   images (equal to the plain one) records each row read, then each shard
   runs under a SPATIAL that slices its reads from the records;
   pixellink_resnet50 at 2 x 1280x768 over 2 and 4 shards in five arms
   (fused bf16 and float32, the PALLAS_CONVS route bf16 and float32, and
   the ghost eval bf16 at 2 x 512^2: at 1280x768 pick_gh admits no ghost
   unit): the stacked shard maps within 1e-5 (float32) or
   1e-2 (bf16) of the whole forward's largest value, and in float32 the
   boxes the CC kernel decodes from them equal; fused_conv_fwd(_f32) and
   fused_boundary_fwd(_f32), or conv_fwd_tma(_f32), launched on every
   shard at the extended heights printed (the 3x3s on the shard's rows
   and one halo row each side), each held against its plain version at
   every shape the shards give it; the ghost eval on every shard in the
   units the whole image takes; a zero-halo planted fault beyond the
   bound; one shard's device ms and peak memory beside the whole
   forward's, with the card's name and power limit.

The line before the last is a JSON object describing the fourteen
kernels and the route's four float32 kernels (launches from the main
path of each: detect for the CC kernel, the fused steps for the fused
kernels, the pallas-conv steps for the conv kernels, the float32
pallas-conv steps for their float32 rows, the ghost steps for the ghost
kernels; times summed over the shapes of each kernel's check); the last
line is {"ok": true, "device": {...}}. Weights are random (seeded):
the check is that the port runs and agrees with itself and its plain
versions, not detection quality.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SHAPE = (8, 192, 320)          # label maps of a 1280x768 batch of 8
RAGGED_SHAPE = (3, 100, 150)   # a batch of label maps of another size
IMAGE_HW = (768, 1280)
MODEL = "pixellink_resnet50"
LOSS = "ohem"  # train_config's loss by default
# the slice's main model (EAST RBOX, the east loss) and the other models
# of the families the port added beside it
EAST_MODEL = "east_resnet50"
VGG_MODEL = "pixellink2s_vgg16"
LINK8_MODEL = "link8_resnet50"
# phase 4: float32 on the card (TF32 off) vs the CPU differ only in the
# order of summation (and cuDNN's choice of algorithm) over ~55 convs
FWD_REL_TOL = 1e-4
# EAST detect and serve: each metric is read over EAST_WINDOWS windows of
# at least WINDOW_S; the PixelLink detect and serve of phase 6 and the VGG
# model's over windows of PIXELLINK_WINDOW_S (shortened when the EAST
# phases came, to keep the script within half its time limit; the EAST
# windows, 10 s before, when the data phase came; 2 windows, 3 before,
# since the multi-GPU phase 38 came; 3 s, 5 before, since the float32
# route's phases came; 2 s, 3 before, since the float32 fused arm's
# phases came; the PixelLink and VGG windows 1 s, 2 before, since the
# sharded kernel arms' phase 39 came)
WINDOW_S = 2.0
WINDOWS = 2
PIXELLINK_WINDOW_S = 1.0
# EAST detect and serve: one window each (each serve window holds 3
# batches of ~4 s of host NMS; 2 windows until the float32 ghost arm's
# phases came)
EAST_WINDOWS = 1
# the train phases: bench.py's train shape, steps of the main path, and
# the EAST eager train img/s read over TRAIN_WINDOWS windows of at least
# TRAIN_WINDOW_S (10 s until the data phase came, 5 s until the float32
# fused arm's phases came, 3 s until phase 39 came); the EAST graph img/s
# over TRAIN_WINDOWS windows of EAST_GRAPH_DISPATCHES dispatches of 16
# steps, whose state, 16 + 3 x 9 x 16 = 448 steps from the seeded one,
# is the EAST serving checkpoint (its step count fixed, not set by the
# clock: PR 11's 10 s windows took 9 dispatches each)
TRAIN_SIZE = 512
TRAIN_BATCH = 32
TRAIN_STEPS = 3
TRAIN_WINDOW_S = 2.0
TRAIN_WINDOWS = 3
EAST_GRAPH_DISPATCHES = 9
EAST_SERVE_STEPS = 448
# the five PixelLink arms' eager and graph img/s: ARM_WINDOWS windows of
# at least ARM_WINDOW_S (scripts/trainer_probe.py times them longer, in
# fresh processes; 5 s until the multi-GPU phase 38 came, 3 s until the
# float32 route's phases came, 2 s until the float32 fused arm's came)
ARM_WINDOWS = 2
ARM_WINDOW_S = 1.0
# the graph dispatch's img/s (phase 22): one window an arm (a dispatch
# of 16 steps takes 2-3 s; 2 windows until the float32 ghost arm's
# phases came)
GRAPH_WINDOWS = 1
# fused vs xla arm, one step each from one state and batch, in bf16. At
# the seeded init (every BN scale 1) the bf16 step is chaotic: two runs
# of the fused arm alone differ by a gradient relative error of ~1, as
# rounding noise grows through the batch-statistics backward of ~55 BN
# layers, so no tolerance could tell a fault from noise there. The check
# ran first (PRs 4-11) from the seeded state with each residual branch's
# last BN scale (conv3.bn.weight) times 0.05; it now runs from the
# augmented state: AUG_TRAINED_STEPS steps of run_device_cached with
# augmentation on the synthetic tiers (phase 32's dataset), after which
# the residual BN scales spread (std 0.0102, 0.943-1.097) and the step is
# near-linear: sound runs read a gradient relative error of 1.4255e-2,
# every planted backward fault >= 8.2434e-2 (--faults; readings on an
# H100 80GB HBM3 at 700 W, PERF.md Findings). The loss bound only
# catches coarse forward faults: a 1% error in the statistics moves the
# loss by ~3e-4 (phase 10 holds the statistics to 1e-4).
ARM_LOSS_REL = 5e-4    # relative loss gap; sound 1.750e-4 (augmented)
ARM_GRAD_REL = 2.5e-2  # |g_fused - g_xla| / |g_xla|; augmented: sound
#                        1.4255e-2, planted faults >= 8.2434e-2
ARM_COS_MIN = 0.98     # cosine of the two at the worst parameter;
#                        augmented: sound 0.995755, dX x 0.9 0.935227
# fused_readings over the 13 fused units' parameters, fused against xla.
# From the tempered state of PRs 4-11 the boundary's dz x 0.9 passed the
# two gates above and only these caught it, with little margin (sound
# 1.1066e-1 against 0.15). Re-read from the augmented state, where it
# now runs: the worst relative gradient error over the units' parameters
# reads
# 4.4446e-2 sound (3 runs, block3_unit1.conv1.bn.bias) and 1.0393e-1,
# 5.8186e-1, 2.7833e-1 under dW, dX and the boundary's dz x 0.9; the norm
# ratio of the two gradients is off 1 by 5.8117e-3 sound and by
# 1.0086e-1, 5.5518e-1, 2.6354e-1 under the three faults. Each bound lies
# between the sound reading and the smallest fault's, with a margin of
# 1.4x or more on either side (--faults; H100 80GB HBM3 at 700 W)
FUSED_ARM_UNIT_REL = 0.075
FUSED_ARM_UNIT_SCALE = 2.5e-2
# the PALLAS_CONVS arm against the same arm on cuDNN, one step each: the
# gradient bounds lie between the sound runs' largest reading and the
# planted backward faults' smallest (--faults; PERF.md, Findings;
# readings on an H100 80GB HBM3 at 700 W), set from the tempered state
# of PRs 4-11 (sound <= 1.118e-2, faults >= 4.623e-2) and holding from
# the augmented state where the gate now runs (sound 5.5655e-3, faults
# >= 8.9662e-2; cosine 0.995012 sound, 0.184528 with the 3x3 dX unflipped).
# The loss bound has no fault reading above it (the backward faults leave
# the loss as it is): it only catches coarse forward faults, and the
# kernel phase holds y to one bf16 ulp.
CONV_ARM_LOSS_REL = 5e-4  # sound 4.56e-5 tempered, 2.087e-6 augmented
CONV_ARM_GRAD_REL = 2.5e-2
CONV_ARM_COS_MIN = 0.98
# detect with the route on against cuDNN: bf16 logits after 57 routed
# convs rounded in another order, relative to the largest logit (sound
# 1.128e-2 on the H100)
CONV_DETECT_REL = 3e-2
# the same for east_resnet50's sigmoid score and geometry (the distances
# sigmoid x 512) from its seeded weights, relative to the largest value:
# the seeded bf16 network saturates, and where a logit lies near 0 the
# sigmoid passes on its reordered rounding (read 5.198e-2 and 7.357e-2 on
# the H100; each routed conv is held to one bf16 ulp by the route phase)
EAST_DETECT_REL = 0.15
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


def phase_forward(device, model_name=MODEL):
    """``model_name``'s full-width forward, float32 with TF32 off, at
    256x256 on the card against the same seeded weights (BN statistics
    perturbed) on the CPU: every output within FWD_REL_TOL of the
    largest value."""
    import torch
    from tensorflow_ocr_tpu_torch.models import build_model

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_model(model_name, dtype=torch.float32,
                        generator=torch.Generator().manual_seed(1))
    perturb_bn(model, torch.Generator().manual_seed(2))
    x = torch.randint(0, 256, (1, 256, 256, 3), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(3))
    with torch.inference_mode():
        want = model(x)
        model.to(device)
        got = model(x.to(device))
    for key in want:
        g, w = got[key].cpu(), want[key]
        check(g.shape == w.shape == (1, 64, 64, w.shape[-1]),
              f"{key}: shape {tuple(g.shape)}")
        check(bool(torch.isfinite(g).all()), f"{key}: non-finite")
        rel = float((g - w).abs().max() / w.abs().max())
        print(f"forward f32 {model_name} {key}: max|gpu-cpu|/max|cpu| = "
              f"{rel:.3e} (tol {FWD_REL_TOL:g})")
        check(rel <= FWD_REL_TOL, f"{key}: GPU and CPU forwards disagree")
    torch.backends.cudnn.allow_tf32 = True


def scene_images(rng, n, hw=None):
    """uint8 (n, H, W, 3) scenes of ``hw`` (H, W; IMAGE_HW by default):
    flat colour patches crossed by dark text-like bars, so that even
    random weights give coherent maps."""
    import numpy as np

    h, w = hw or IMAGE_HW
    coarse = rng.randint(0, 256, (n, h // 64 + 1, w // 64 + 1, 3))
    images = coarse.repeat(64, 1).repeat(64, 2)[:, :h, :w].astype(np.uint8)
    for img in images:
        for _ in range(rng.randint(8, 24)):
            y, x = rng.randint(0, h - 24), rng.randint(0, w - 200)
            img[y:y + rng.randint(8, 24), x:x + rng.randint(40, 200)] = (
                rng.randint(0, 60))
    return images


def head_logit_scale(pred, x, convs):
    """Scale each final conv of ``convs`` (names under pred.model.head) to
    unit logit spread on the images ``x`` (random weights saturate the
    scores; phase_main_path does this for PixelLink)."""
    import torch
    import torch.nn.functional as F
    from tensorflow_ocr_tpu_torch.models.layers import mean_image_subtraction

    m = pred.model
    with torch.inference_mode():
        xx = mean_image_subtraction(x.float(), m.means).permute(
            0, 3, 1, 2).to(m.dtype)
        ep = m.backbone(xx)
        feats = m.merge(ep) if m.merge is not None else None
    for name in convs:
        conv = getattr(m.head, name)
        with torch.inference_mode():
            if feats is None:  # the pixellink head: its logits
                spread = float(m.head(ep)[name].std())
            else:
                spread = float(F.conv2d(feats, conv.weight.to(feats.dtype),
                                        conv.bias.to(feats.dtype)).std())
        with torch.no_grad():
            conv.weight /= spread
            conv.bias /= spread


def decode_check(pred, images, label, every_image=False):
    """Thresholds at quantiles of the maps (pixel 0.8, link 0.3), then
    detect_batch: the CC kernel launched, boxes found (on every image with
    ``every_image``), the boxes equal to those of a decode of the same
    maps with the plain connected components. Returns the CC launches."""
    import numpy as np
    import torch
    from tensorflow_ocr_tpu_torch.infer import pixel_link_scores
    from tensorflow_ocr_tpu_torch.ops import decode as D
    from tensorflow_ocr_tpu_torch.ops import kernels as K

    x = torch.from_numpy(images).to(pred.device)
    with torch.inference_mode():
        ps, ls = pixel_link_scores(pred.model(x))
    pred.pixel_thresh = float(torch.quantile(ps.float().flatten()[::7], 0.8))
    pred.link_thresh = float(torch.quantile(ls.float().flatten()[::7], 0.3))
    K.connected_components.launches = 0
    boxes = pred.detect_batch(images)
    torch.cuda.synchronize()
    launches = K.connected_components.launches
    mask = ps > pred.pixel_thresh
    edges = D.link_adjacency(mask, ls, pred.link_thresh)
    labels = K.connected_components_reference(edges, mask)
    max_pixels = None if pred.overflow_retries == 0 else pred._FULL_BUDGET
    rb, _, rv = (t.cpu().numpy() for t in D.extract_components(
        labels, pred.infer.max_components, pred.min_size,
        max_pixels=max_pixels))
    n = [len(b) for b in boxes]
    n_img, h, w = images.shape[:3]
    print(f"{label} detect_batch {n_img}x{w}x{h} bf16: maps "
          f"{tuple(ps.shape)}, boxes per image {n}, cc launches {launches}, "
          f"overflow retries {pred.overflow_retries}")
    check(launches > 0, f"{label}: detect did not launch the CC kernel")
    check(len(boxes) == len(images) and sum(n) > 0, f"{label}: no boxes")
    check(not every_image or min(n) > 0, f"{label}: an image without a box")
    check(all(np.isfinite(b).all() and b.shape == (4, 2)
              for bs in boxes for b in bs), f"{label}: malformed boxes")
    for i in range(len(images)):
        w = rb[i][rv[i]] * pred.stride
        check(len(boxes[i]) == len(w) and all(
            np.array_equal(g, v) for g, v in zip(boxes[i], w)),
              f"{label} image {i}: boxes differ from the plain CC decode")
    return launches, edges, mask


def phase_main_path(device, report):
    """Predictor.detect_batch at 8 x 1280x768 bf16: the final convs scaled
    to unit logit spread (random weights saturate the softmax) and the
    thresholds put where components exist, then decode_check (the CC
    kernel launched, the boxes those of a plain-CC decode)."""
    import numpy as np
    import torch
    from tensorflow_ocr_tpu_torch.infer import Predictor

    pred = Predictor(MODEL, device=device)
    images = scene_images(np.random.RandomState(0), 8)
    head_logit_scale(pred, torch.from_numpy(images).to(device),
                     ("pixel_logits", "link_logits"))
    report["launches"] = decode_check(pred, images, MODEL)[0]
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
    time_detect_serve(pred, images, PIXELLINK_WINDOW_S)


def time_detect_serve(pred, images, window_s, label="", windows=WINDOWS):
    """Detect p50 at batch 1 (pred.detect on images[0]) and serve img/s
    at batch 8 (detect_batches, depth 2), each over ``windows`` windows of
    at least ``window_s`` after a warm-up, printed with the medians of the
    windows. With an EAST predictor also the host NMS ms of each call
    (pred.nms_ms) and the boxes of the last."""
    one = images[0]
    for _ in range(5):
        pred.detect(one)
    east = pred.is_east
    p50s, nms = [], []
    for i in range(windows):
        lat = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < window_s:
            boxes, ms = pred.detect(one)
            lat.append(ms)
            nms.append(pred.nms_ms)
        p50s.append(statistics.median(lat))
        print(f"{label}detect window {i}: p50 {p50s[-1]:.3f} ms (min "
              f"{min(lat):.3f}, max {max(lat):.3f}, n={len(lat)})")
    print(f"{label}detect 1280x768 batch 1: p50 "
          f"{statistics.median(p50s):.3f} ms "
          f"(median of {windows} windows of >= {window_s:g} s; window p50s "
          f"{min(p50s):.3f}..{max(p50s):.3f})"
          + (f"; host NMS p50 {statistics.median(nms):.3f} ms of it, "
             f"{len(boxes)} boxes" if east else ""))

    for _ in pred.detect_batches([images] * 3):
        pass
    rates, nms = [], []
    for i in range(windows):
        sent = 0
        t0 = time.perf_counter()

        def stream():
            nonlocal sent
            while time.perf_counter() - t0 < window_s:
                sent += 1
                yield images

        n = 0
        for r in pred.detect_batches(stream(), depth=2):
            n += len(r)
            nms.append(pred.nms_ms)
        dt = time.perf_counter() - t0
        check(n == len(images) * sent, "detect_batches lost results")
        rates.append(n / dt)
        print(f"{label}serve window {i}: {rates[-1]:.2f} img/s ({sent} "
              f"batches in {dt:.3f} s)")
    print(f"{label}detect_batches 1280x768 batch {len(images)} depth 2: "
          f"{statistics.median(rates):.2f} img/s (median of {windows} "
          f"windows of >= {window_s:g} s; windows {min(rates):.2f}.."
          f"{max(rates):.2f})"
          + (f"; host NMS p50 {statistics.median(nms):.3f} ms a batch"
             if east else ""))


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
# each conv kernel's launches in detect's forward (8 x 1280x768)
DETECT_CONV_LAUNCHES = {"matmul_rows": 44, "dw_rows": 0, "conv3": 13,
                        "dw3": 0}
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


# the route's float32 kernels (ops/conv.py: tma_fwd32 on conv_fwd.cu and
# tma_dw32 on conv_dw.cu, split TF32 on the tensor cores; narrow_fwd32 and
# narrow_dw32 on conv.cu for the narrow shapes, f32 FMAs): rows of their
# own in the kernels line, beside the bfloat16 ones, replacing the same
# sites (the Pallas kernels take float32 as they take bfloat16)
CONV_F32_KERNELS = {f"{name}_f32": spec for name, spec in CONV_KERNELS.items()}
# the float32 products of a step by kernel: the bfloat16 dispatch's
F32_FWD_STEP_KERNELS = {"tma_fwd32": 110, "narrow_fwd32": 4}
F32_DW_STEP_KERNELS = {"tma_dw32": 53, "narrow_dw32": 4}
F32_DETECT_FWD_KERNELS = {"tma_fwd32": 57, "narrow_fwd32": 0}
# a float32 kernel's largest error against the float64 product, at most
# this many times the plain float32 version's (cuBLAS / cuDNN with TF32
# off) against the same product: a float32 product, not a TF32 one (one
# TF32 pass misses it by far: tests/test_torch_conv_f32.py)
F32_ERR_MULTIPLE = 4.0
# the route's float32 dW on conv_dw.cu (tdw_f32_wg): its runs of
# ops/conv.py DW32_RUN k8 steps a fresh accumulator are the longest whose
# error stays within this many times the plain version's at every dW shape
# of phase 8b (the tensor cores truncate as they accumulate; PERF.md)
DW32_ERR_MULTIPLE = 3.0
# the split-TF32 products' least time: three TF32 passes at 495 TFLOP/s
# (the H100 SXM's dense TF32 rate, NVIDIA's data sheet)
PEAK_F32_SPLIT = 495e12 / 3
# the float32 PALLAS_CONVS arm against the same arm on cuDNN in float32
# (TF32 off), one step each from the augmented state: bounds between the
# sound runs' largest reading and the planted backward faults' smallest
# (--faults, scripts/conv_f32_probe.py --faults; PERF.md, Findings; H100
# 80GB HBM3 at 700 W): gradient relative error sound 8.2263e-5 (4 runs),
# dW x 0.9 8.9791e-2, dX x 0.9 4.6295e-1, the 3x3 dX unflipped
# 5.1831e-1; worst cosine sound 1.000000, faults 0.922046 and 0.189591
# (dW x 0.9 keeps the direction). From the seeded state even float32
# reads 1.7012e-2 (the chaotic step of the bf16 note above). The loss
# reads 0 sound and under every backward fault: it only catches coarse
# forward faults, and phase 8b holds y to the float32 rule.
F32_ARM_LOSS_REL = 1e-5
F32_ARM_GRAD_REL = 2.5e-3
F32_ARM_COS_MIN = 0.999


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

    for name in (*CONV_KERNELS, *DW_STEP_KERNELS, *FWD_STEP_KERNELS,
                 *F32_DW_STEP_KERNELS, *F32_FWD_STEP_KERNELS):
        getattr(CV, name).launches = 0


def conv_counts(names=CONV_KERNELS):
    """{name: launches} of the wrappers of ops/conv.py in ``names``."""
    from tensorflow_ocr_tpu_torch.ops import conv as CV

    return {name: getattr(CV, name).launches for name in names}


def route_shape_counts(batch, hw, model=MODEL):
    """{(N, H, W, Ci, Co, k, stride): convs of that shape} over every conv
    the route takes in a forward of ``model`` at ``batch`` images of
    ``hw`` (recorded from a forward on the meta device, at the batch's
    size, since the route's choice depends on it; in a train step each
    conv is also one dX and one dW product of its shape)."""
    import torch
    import torch.nn.functional as F
    from tensorflow_ocr_tpu_torch.models import build_model
    from tensorflow_ocr_tpu_torch.ops import conv as CV

    seen, orig = {}, CV.conv2d

    def record(x, w, stride=(1, 1)):
        n, ci, h, wd = x.shape
        key = (n, h, wd, ci, w.shape[0], w.shape[-1], stride[0])
        seen[key] = seen.get(key, 0) + 1
        return F.conv2d(x, w, stride=stride, padding=w.shape[-1] // 2)

    net = build_model(model, dtype=torch.bfloat16).to("meta")
    CV.conv2d = record
    try:
        with pallas_convs(True), torch.inference_mode():
            net(torch.zeros(batch, *hw, 3, dtype=torch.uint8,
                            device="meta"))
    finally:
        CV.conv2d = orig
    return seen


def route_shapes(batch, hw, model=MODEL):
    """The distinct shapes of route_shape_counts, in order."""
    return tuple(route_shape_counts(batch, hw, model))


def route_launches(batch, hw, model=MODEL, train=True):
    """{conv kernel: launches} of ``model``'s forward at ``batch`` images
    of ``hw`` with the route on (route_shape_counts), and with ``train``
    of its backward too: a forward and a dX product of each routed conv
    (matmul_rows, conv3) and a dW (dw_rows, dw3)."""
    n = {1: 0, 3: 0}
    for key, c in route_shape_counts(batch, hw, model).items():
        n[key[5]] += c
    k = 2 if train else 1
    return {"matmul_rows": k * n[1], "dw_rows": n[1] * train,
            "conv3": k * n[3], "dw3": n[3] * train}


def phase_conv_kernels(device, reports, model=MODEL):
    """Each conv kernel against its plain version at every distinct shape
    of the route in ``model``'s train step (route_shapes at TRAIN_SIZE,
    batch TRAIN_BATCH, plus one stride-2 1x1, which the route takes and
    ResNet-v1-50 does not have): the forward y and dX (bf16, one ulp) and
    dW (float32 sums, SUM_REL of the sum of magnitudes); then the forward
    y at every distinct shape of detect's forward (IMAGE_HW, batch 8).
    For another model than MODEL, only the shapes that MODEL's route does
    not have (EAST: the merge's), with no tail shapes, and their times
    summed apart from the kernels line's (max_abs_err covers them).
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
    main = model == MODEL
    if main:
        for r in reports.values():
            r.update(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0)
        train_sums = reports
    else:
        train_sums = {n: dict(ms=0.0, plain_ms=0.0, library_ms=0.0)
                      for n in reports}

    def act(n, c, h, w):
        return torch.randn(n, c, h, w, generator=gen).to(
            device=device, dtype=bf).contiguous(memory_format=cl)

    def run(name, what, kernel, plain, library, terms, flops, nbytes,
            sums=None):
        """``library``: one call, or {label: call} of which the faster
        is the yardstick. Times and bounds add to ``sums`` (the train
        shapes' sums by default)."""
        sums = train_sums if sums is None else sums
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

    def run_dw(x, dy, k, what, sums=None):
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
    counts = route_shape_counts(TRAIN_BATCH, (TRAIN_SIZE, TRAIN_SIZE), model)
    if main:
        shapes = tuple(counts) + ((TRAIN_BATCH, q, q, 256, 512, 1, 2),)
    else:
        old = set(route_shapes(TRAIN_BATCH, (TRAIN_SIZE, TRAIN_SIZE)))
        shapes = tuple(k for k in counts if k not in old)
    step = {n: [0.0, 0.0] for n in CONV_KERNELS}
    print(f"conv route of {model} at {TRAIN_SIZE}^2, batch {TRAIN_BATCH}: "
          f"{len(shapes)} distinct convs (N, H, W, Ci, Co, k, stride)"
          f"{'' if main else ' beyond ' + MODEL + chr(39) + 's'}: {shapes}")
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
        r = train_sums[name]
        if "bound_ms" not in r:
            continue
        print(f"{name} a train step{'' if main else ' of ' + model} (each "
              f"shape's ms times its launches in a step"
              f"{f', {CONV_STEP_LAUNCHES[name]} in all' if main else ''}):"
              f" kernel {ms:.4f} ms, library {lms:.4f}; over the distinct "
              f"shapes: kernel {r['ms']:.4f}, library "
              f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} "
              f"({r['bound_by']})")

    tail = {n: dict(ms=0.0, plain_ms=0.0, library_ms=0.0) for n in reports}
    for n, h, w, ci, co, k in FWD_TAIL_SHAPES if main else ():
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
    for n, h, w, ci, co, k in DW_TAIL_SHAPES if main else ():
        run_dw(act(n, ci, h, w), act(n, co, h, w), k,
               f"tail {k}x{k} {ci}->{co} at {n}x{h}x{w}", tail)

    # detect's forward (the eval fold: the same convs on w*mul)
    detect = route_shapes(8, IMAGE_HW, model)
    if not main:
        old = set(route_shapes(8, IMAGE_HW))
        detect = tuple(k for k in detect if k not in old)
    print(f"conv route of {model} in detect at {IMAGE_HW[1]}x{IMAGE_HW[0]}, "
          f"batch 8: {len(detect)} distinct convs"
          f"{'' if main else ' beyond ' + MODEL + chr(39) + 's'}: {detect}")
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
        if "bound_ms" not in r:
            continue
        print(f"{name} over detect's shapes: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f}, library {r['library_ms']:.4f}, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    if not main:
        return
    print("conv kernels: ms, plain_ms, library_ms and bound_ms in the "
          f"kernels line are sums over the {len(shapes)} train-step shapes "
          "(forward and dX for matmul_rows and conv3); max_abs_err also "
          "covers detect's and the tail shapes; library: torch.matmul "
          "(cuBLAS, bf16 out) for the 1x1s, F.conv2d, the faster of "
          "torch.nn.grad.conv2d_input and F.conv2d(dy, wflip) for the dX, "
          "and conv2d_weight (cuDNN, channels-last bf16) for the 3x3s")


def phase_conv_kernels_f32(device, reports):
    """Each conv kernel in float32 against the float64 product at every
    distinct shape of the route in the train step (route_shapes at
    TRAIN_SIZE, batch TRAIN_BATCH, plus one stride-2 1x1), the forward and
    dW tail shapes, and every distinct forward shape of detect (IMAGE_HW,
    batch 8): y, dX and dW, each within F32_ERR_MULTIPLE times the plain
    float32 version's error (TF32 off) against the same float64 product
    (the dW on conv_dw.cu within DW32_ERR_MULTIPLE, one launch of
    tma_dw32 a call on the card); each call launched twice and bit-equal.
    Prints, at the train shapes
    (the tail and detect shapes are checked, not timed), kernel, plain and
    library-call ms (CUDA events; the library call in float32, TF32 off:
    torch.matmul for the 1x1s, F.conv2d, conv2d_input and conv2d_weight
    for the 3x3s), the FLOPs, bytes and bound (operations at
    PEAK_F32_SPLIT on the TMA kernels, at PEAK_F32 on the narrow ones;
    bytes at the HBM rate), and each kernel's ms a train step. The reports
    sum the train shapes; max_abs_err covers every shape."""
    import torch
    import torch.nn.functional as F
    from tensorflow_ocr_tpu_torch.ops import conv as CV
    from tensorflow_ocr_tpu_torch.ops.fused import full_f32

    gen = torch.Generator().manual_seed(17)
    f32, f64, cl = torch.float32, torch.float64, torch.channels_last
    for r in reports.values():
        r.update(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0)
    worst = {n: 0.0 for n in reports}

    def act(n, c, h, w):
        return torch.randn(n, c, h, w, generator=gen).to(
            device=device, dtype=f32).contiguous(memory_format=cl)

    def in_f32(fn):
        def call():
            with full_f32():
                return fn()
        return call

    def run(name, what, kernel, plain, exact, library, flops, nbytes,
            narrow, sums, multiple=F32_ERR_MULTIPLE):
        """``exact``: the float64 product; ``library``: one call, or
        {label: call} of which the faster is the yardstick. ``sums`` None
        (the tail and detect shapes): the checks alone, no timing; the
        error within ``multiple`` x the plain version's."""
        calls = library if isinstance(library, dict) else {"": library}
        got, want, ref = kernel(), plain(), exact()
        for fn in calls.values():
            fn()
        torch.cuda.synchronize()
        check(got.shape == ref.shape and bool(torch.isfinite(got).all()),
              f"{name} {what}: shape {tuple(got.shape)} or non-finite")
        err = float((got.to(f64) - ref).abs().max())
        perr = float((want.to(f64) - ref).abs().max())
        del ref
        check(err <= multiple * perr, f"{name} {what}: error "
              f"{err:.3e} against float64 beyond {multiple:g} x the "
              f"plain float32 version's {perr:.3e}")
        check(torch.equal(got, kernel()), f"{name} {what}: two launches on "
              "the same inputs differ")
        key = f"{name}_f32"
        reports[key]["max_abs_err"] = max(reports[key]["max_abs_err"], err)
        worst[key] = max(worst[key], err / max(perr, 1e-300))
        if sums is None:
            print(f"{key} {what}: max abs err {err:.3e}, plain's {perr:.3e} "
                  f"(x{err / max(perr, 1e-300):.2f}); bit-equal twice")
            return 0.0, 0.0, 0.0
        ms, pms = cuda_ms(kernel, 10), cuda_ms(plain, 3)
        times = {label: cuda_ms(fn, 10) for label, fn in calls.items()}
        lms = min(times.values())
        r = sums[key]
        bound = add_bound(r, flops, nbytes,
                          PEAK_F32 if narrow else PEAK_F32_SPLIT)
        r["ms"] += ms
        r["plain_ms"] += pms
        r["library_ms"] += lms
        lib = ", ".join(f"{label} {t:.4f}" for label, t in times.items()
                        if label)
        print(f"{key} {what}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} "
              f"TFLOP/s, {nbytes / ms / 1e9:.3f} TB/s), plain {pms:.4f}, "
              f"library {lms:.4f}{f' ({lib})' if lib else ''}; "
              f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB, bound "
              f"{bound:.4f} ms ({'f32 FMA' if narrow else 'split TF32'}); "
              f"max abs err {err:.3e}, plain's {perr:.3e} (x{err / max(perr, 1e-300):.2f})")
        return ms, lms, bound

    def weight(co, ci, k):
        return (torch.randn(co, ci, k, k, generator=gen)
                / (k * k * ci) ** 0.5).to(device=device, dtype=f32)

    def fwd(x, wt, tag, sums):
        """The forward of x with wt (matmul_rows or conv3)."""
        n, ci, h, w = x.shape
        co, k = wt.shape[0], wt.shape[-1]
        m = n * h * w
        flops, io = 2 * m * k * k * ci * co, 4 * (m * ci + k * k * ci * co
                                                  + m * co)
        narrow = not CV.tma_fwd_takes(ci)
        if k == 1:
            x2, w2 = CV.rows(x), wt[:, :, 0, 0].t()
            return run("matmul_rows", tag, lambda: CV.matmul_rows(x2, w2),
                       lambda: CV.matmul_rows_reference(x2, w2),
                       lambda: x2.to(f64) @ w2.to(f64),
                       in_f32(lambda: torch.matmul(x2, w2)), flops, io,
                       narrow, sums)
        wcl = wt.contiguous(memory_format=cl)
        library = in_f32(lambda: F.conv2d(x, wcl, padding=1))
        if tag.startswith("dx"):
            wf = wt.flip(2, 3).transpose(0, 1).contiguous(memory_format=cl)
            library = {"conv2d_input": in_f32(
                lambda: torch.nn.grad.conv2d_input(
                    (n, co, h, w), wf, x, padding=1)),
                       "conv2d(dy, wflip)": library}
        return run("conv3", tag, lambda: CV.conv3(x, wt),
                   lambda: CV.conv3_reference(x, wt),
                   lambda: F.conv2d(x.to(f64), wt.to(f64), padding=1),
                   library, flops, io, narrow, sums)

    def dw(x, dy, k, tag, sums):
        """The dW of x and dy: on conv_dw.cu (tdw_f32_wg, its plan
        printed: R, BN, stages, splits, cluster; within DW32_ERR_MULTIPLE)
        or conv.cu (narrow_dw32), one launch of that kernel a call."""
        n, ci, h, w = x.shape
        co, m = dy.shape[1], n * h * w
        flops = 2 * m * k * k * ci * co
        nbytes = 4 * (m * (ci + co) + k * k * ci * co)
        narrow = not CV.tma_takes(ci, co)
        counter = CV.narrow_dw32 if narrow else CV.tma_dw32
        if not narrow:
            p = CV.tma_dw_plan(*((1, 1, m) if k == 1 else (n, h, w)), ci,
                               co, k, CV._sms(device.index or 0), 0, 4)
            tag += (f" [R {CV.DW32_RUN}, BN {p.bn}, {p.stages} stages, "
                    f"{p.splits} splits, cluster {p.cluster}]")

        def launched(fn):
            def call():
                before = counter.launches
                out = fn()
                check(device.type != "cuda" or counter.launches == before + 1,
                      f"dw {tag}: "
                      f"{counter.launches - before} launches of "
                      f"{counter.__name__}, not 1")
                return out
            return call

        multiple = F32_ERR_MULTIPLE if narrow else DW32_ERR_MULTIPLE
        if k == 1:
            x2, dy2 = CV.rows(x), CV.rows(dy)
            return run("dw_rows", tag, launched(lambda: CV.dw_rows(x2, dy2)),
                       lambda: CV.dw_rows_reference(x2, dy2),
                       lambda: x2.to(f64).t() @ dy2.to(f64),
                       in_f32(lambda: torch.matmul(x2.t(), dy2)), flops,
                       nbytes, narrow, sums, multiple)
        return run("dw3", tag, launched(lambda: CV.dw3(x, dy)),
                   lambda: CV.dw3_reference(x, dy),
                   lambda: CV.dw3_reference(x.to(f64), dy.to(f64)),
                   in_f32(lambda: torch.nn.grad.conv2d_weight(
                       x, (co, ci, 3, 3), dy, padding=1)),
                   flops, nbytes, narrow, sums, multiple)

    q = TRAIN_SIZE // 4
    counts = route_shape_counts(TRAIN_BATCH, (TRAIN_SIZE, TRAIN_SIZE))
    shapes = tuple(counts) + ((TRAIN_BATCH, q, q, 256, 512, 1, 2),)
    step = {n: [0.0, 0.0, 0.0] for n in reports}
    print(f"float32 conv route at {TRAIN_SIZE}^2, batch {TRAIN_BATCH}: "
          f"{len(shapes)} distinct convs (N, H, W, Ci, Co, k, stride)")
    for n, h, w, ci, co, k, s in shapes:
        x = act(n, ci, h, w)
        xs = x[:, :, ::s, ::s].contiguous(memory_format=cl)
        dy = act(n, co, xs.shape[2], xs.shape[3])
        wt = weight(co, ci, k)
        tag = f"{k}x{k}/{s} {ci}->{co} at {n}x{h}x{w}"
        launches = counts.get((n, h, w, ci, co, k, s), 0)
        name = "matmul_rows_f32" if k == 1 else "conv3_f32"
        for got in (fwd(xs, wt, f"fwd {tag}", reports),
                    fwd(dy, wt.flip(2, 3).transpose(0, 1).contiguous(),
                        f"dx {tag}", reports)):
            for i in range(3):
                step[name][i] += launches * got[i]
        got = dw(xs, dy, k, f"dw {tag}", reports)
        name = "dw_rows_f32" if k == 1 else "dw3_f32"
        for i in range(3):
            step[name][i] += launches * got[i]
        del x, xs, dy
    for name, (ms, lms, bound) in step.items():
        r = reports[name]
        print(f"{name} a train step (each shape's ms times its launches in "
              f"a step, {CONV_STEP_LAUNCHES[name[:-4]]} in all): kernel "
              f"{ms:.4f} ms, library {lms:.4f}, bound {bound:.4f}; over the "
              "distinct shapes: "
              f"kernel {r['ms']:.4f}, library {r['library_ms']:.4f}, bound "
              f"{r['bound_ms']:.4f} ({r['bound_by']})")

    for n, h, w, ci, co, k in FWD_TAIL_SHAPES:
        fwd(act(n, ci, h, w), weight(co, ci, k),
            f"tail fwd {k}x{k} {ci}->{co} at {n}x{h}x{w}", None)
    for n, h, w, ci, co, k in DW_TAIL_SHAPES:
        dw(act(n, ci, h, w), act(n, co, h, w), k,
           f"tail {k}x{k} {ci}->{co} at {n}x{h}x{w}", None)
    detect = route_shapes(8, IMAGE_HW)
    for n, h, w, ci, co, k, _ in detect:
        fwd(act(n, ci, h, w), weight(co, ci, k),
            f"detect fwd {k}x{k} {ci}->{co} at {n}x{h}x{w}", None)
    print(f"float32 conv kernels: {len(shapes)} train shapes (forward, dX, "
          f"dW), {len(FWD_TAIL_SHAPES)} + {len(DW_TAIL_SHAPES)} tail shapes "
          f"and {len(detect)} detect forwards, each error against float64 "
          f"at most {F32_ERR_MULTIPLE:g} x the plain float32 version's; the "
          f"largest ratio by kernel "
          f"{ {n: round(v, 3) for n, v in worst.items()} }; ms, plain_ms, "
          "library_ms and bound_ms in the kernels line are sums over the "
          "train shapes")


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
    check(counts == DETECT_CONV_LAUNCHES, "detect with the route: conv "
          "launches")
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
# boundary launches a step: one a fused unit
FUSED_BOUNDARY_STEP_LAUNCHES = 13
# the fused arm's float32 kernels (ops/fused.py conv_fwd32, conv_bwd32,
# boundary_fwd32, boundary_bwd32): the same sources and sites
FUSED_F32_KERNELS = {f"{name}_f32": (f"{attr}32", src, sites)
                     for name, (attr, src, sites) in FUSED_KERNELS.items()}
# a float32 train step's launches of each
FUSED_F32_STEP_LAUNCHES = {
    "fused_conv_fwd_f32": FUSED_CONV_STEP_LAUNCHES,
    "fused_conv_bwd_f32": FUSED_CONV_STEP_LAUNCHES,
    "fused_boundary_fwd_f32": FUSED_BOUNDARY_STEP_LAUNCHES,
    "fused_boundary_bwd_f32": FUSED_BOUNDARY_STEP_LAUNCHES}
# the float32 boundary's elementwise outputs (out, dz, dzs) against the
# plain version's: the same operations in the same order, so within this
# many float32 ulps
F32_BOUNDARY_ULPS = 2
# the fused arm in float32 against the "xla" arm in float32 (cuDNN, TF32
# off), one step each from the augmented state: fused_readings' five
# readings, bounds between the sound runs' largest and the planted
# backward faults' smallest (--faults, scripts/fused_f32_probe.py
# --faults; PERF.md, Findings)
F32_FUSED_ARM_LOSS_REL = 1e-5
F32_FUSED_ARM_GRAD_REL = 2.5e-3
F32_FUSED_ARM_COS_MIN = 0.999
F32_FUSED_ARM_UNIT_REL = 1e-2
F32_FUSED_ARM_UNIT_SCALE = 5e-3
# float32 fused detect against the float32 "xla" Predictor's logits,
# relative to the largest (TF32 off on both)
F32_FUSED_DETECT_REL = 1e-5


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
# f32 sums over up to 524,288 rows (s, dab, dabs), in another order than
# the plain version's: within 1e-4 of the sum of the magnitudes (each
# kernel adds them in a fixed order, so two launches are bit-equal)
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
    """Build the eight CUDA sources, one nvcc each, all started together,
    and load each library."""
    from concurrent.futures import ThreadPoolExecutor

    from tensorflow_ocr_tpu_torch.ops import conv as CV
    from tensorflow_ocr_tpu_torch.ops import fused as FU
    from tensorflow_ocr_tpu_torch.ops import ghost as G
    from tensorflow_ocr_tpu_torch.ops import kernels as K

    from tensorflow_ocr_tpu_torch.data import nvjpeg_loader as NJ

    loaders = {"cc": K._cc_label, "fused_conv": lambda: FU._lib("fused_conv"),
               "fused_boundary": lambda: FU._lib("fused_boundary"),
               "conv": CV._lib, "conv_fwd": CV._fwd_lib,
               "conv_dw": CV._dw_lib, "ghost_unit": G._lib,
               "nvjpeg_loader": NJ._lib}
    links = {"nvjpeg_loader": ("-lnvjpeg",)}

    def one(name):
        t0 = time.perf_counter()
        lib = K.build_library(name, links.get(name, ()))
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
        check(torch.equal(out, FU.boundary_fwd(z, ab, zs, abs_)),
              f"fused boundary_fwd C={c}: two launches on the same inputs "
              "differ")
        got = FU.boundary_bwd(g, z, ab, zs, abs_)
        again = FU.boundary_bwd(g, z, ab, zs, abs_)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"fused boundary_bwd C={c}: two launches on the same inputs "
              "differ (dz, dab, dzs, dabs)")
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
              f"f32 sums dab/dabs {es:.3e}; fwd and bwd (dab, dabs "
              f"included) bit-equal twice")
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


def f32_rule(name, got, want, exact):
    """The float32 rule: ``got``'s largest error against the float64
    ``exact`` at most F32_ERR_MULTIPLE times the plain float32 version's
    (``want``). Returns (error, its ratio to the plain version's)."""
    import torch

    f64 = torch.float64
    err = float((got.to(f64) - exact).abs().max())
    perr = float((want.to(f64) - exact).abs().max())
    check(err <= F32_ERR_MULTIPLE * perr, f"{name}: error {err:.3e} against "
          f"float64 beyond {F32_ERR_MULTIPLE:g} x the plain float32 "
          f"version's {perr:.3e}")
    return err, err / max(perr, 1e-300)


# tdx_f32's instantiations, each as (ops/conv.py DX32_BN, DX32_OVERLAP):
# BN 64 and 128, each product's fragment prepared after or under the
# previous product's wgmmas
DX32_INSTANCES = (((64,), False), ((64,), True), ((128, 64), False),
                  ((128, 64), True))


@contextlib.contextmanager
def dx32_choice(bns, overlap):
    """ops/conv.py's tdx_f32 plans under DX32_BN = bns and DX32_OVERLAP =
    overlap inside the block."""
    from tensorflow_ocr_tpu_torch.ops import conv as CV

    saved = CV.DX32_BN, CV.DX32_OVERLAP
    CV.DX32_BN, CV.DX32_OVERLAP = bns, overlap
    CV.tma_bwd_dx_plan.cache_clear()
    try:
        yield
    finally:
        CV.DX32_BN, CV.DX32_OVERLAP = saved
        CV.tma_bwd_dx_plan.cache_clear()


def dx32_plan(attrs, fwd, p):
    """A tdx_f32 plan (bn, resident, stages, eslots, overlap) and its
    instantiation's registers and spilled bytes, read by ``attrs`` (the
    library's fused_tdx32_attrs or ghost_tdx32_attrs: the forward's
    instantiation where fwd, else the dX's)."""
    import ctypes

    out = (ctypes.c_int * 2)()
    err = attrs(int(fwd), p.bn, int(p.overlap), ctypes.addressof(out))
    check(err == 0, f"tdx_f32 attributes: CUDA error {err}")
    return (f"[bn {p.bn}, resident {int(p.resident)}, {p.stages} stages, "
            f"{p.eslots} eslots, overlap {int(p.overlap)}; {out[0]} "
            f"registers, {out[1]} bytes spilled]")


def ulps_close(name, got, want, ulps):
    """float32 ``got`` within ``ulps`` ulps of ``want``, elementwise;
    returns the largest absolute difference."""
    import torch

    err = (got - want).abs()
    tol = ulps * torch.finfo(torch.float32).eps * torch.maximum(
        got.abs(), want.abs())
    check(bool((err <= tol).all()), f"{name}: beyond {ulps} float32 ulps of "
          f"the plain version (max err {float(err.max()):.3e})")
    return float(err.max())


def bwd_alone_ms(xn, w, dye, iters):
    """The ms of the library's two products of a conv backward alone, on
    the pre-activated xn and dy_eff: torch.matmul over the pixel rows for a
    1x1 (Xᵀ·dY and dY·W), conv2d_weight and conv2d_input for a 3x3. A
    yardstick for the staged backward's products, not the same function
    (no staging transform, no mask, no sums)."""
    import torch

    k = w.shape[-1]
    if k == 1:
        x2 = xn.permute(0, 2, 3, 1).reshape(-1, xn.shape[1])
        d2 = dye.permute(0, 2, 3, 1).reshape(-1, dye.shape[1])
        w2 = w[:, :, 0, 0]

        def fn():
            torch.matmul(x2.t(), d2)
            torch.matmul(d2, w2)
    else:
        def fn():
            torch.nn.grad.conv2d_weight(xn, w.shape, dye, padding=1)
            torch.nn.grad.conv2d_input(xn.shape, w, dye, padding=1)
    fn()
    return cuda_ms(fn, iters)


def phase_fused_kernels_f32(device, reports):
    """Each fused kernel in float32 against its plain float32 version at
    the shapes of phase 10 (CONV_SHAPES, BOUNDARY_SHAPES): forward y and
    s, backward dx, dab and dw, each within F32_ERR_MULTIPLE times the
    plain version's error (TF32 off) against the float64 result of the
    plain versions; the boundary's out, dz and dzs within
    F32_BOUNDARY_ULPS of the plain version's and its dab, dabs to the same
    rule; every call launched twice and bit-equal. Prints kernel and plain
    ms (CUDA events), the bound (split TF32 at PEAK_F32_SPLIT for the
    convs, PEAK_F32 for the boundary, bytes at the HBM rate) and the
    conv-alone yardsticks in float32 (TF32 off: torch.matmul / F.conv2d of
    the forward's product, and the backward's two products), and each
    kernel's ms a train step, and each shape's dW plan (R, BN, stages,
    splits, cluster) and tdx_f32 plans (dx32_plan); then each tdx_f32
    instantiation (DX32_INSTANCES) at one shape to the same rule, twice
    and bit-equal. max_abs_err: the convs' against float64, the
    boundary's elementwise outputs' against the plain version."""
    import torch
    from tensorflow_ocr_tpu_torch.ops import conv as CV
    from tensorflow_ocr_tpu_torch.ops import fused as FU
    from tensorflow_ocr_tpu_torch.ops.fused import full_f32

    gen = torch.Generator().manual_seed(18)
    f32, f64, cl = torch.float32, torch.float64, torch.channels_last

    def act(n, c, h, w, scale=1.0):
        return (torch.randn(n, c, h, w, generator=gen) * scale).to(
            device=device, dtype=f32).contiguous(memory_format=cl)

    def table(c, lo, hi, shift):
        a = torch.empty(c).uniform_(lo, hi, generator=gen)
        b = torch.randn(c, generator=gen) * shift
        return torch.stack([a, b]).to(device)

    def up(*ts):
        return [t.to(f64) for t in ts]

    # library_ms stays null, as for the bf16 rows: no one call computes
    # the whole function; the conv-alone yardsticks are printed
    for r in reports.values():
        r.update(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=None)
    ratio = dict.fromkeys(reports, 0.0)
    counts = fused_shape_counts()
    step = dict(fwd=0.0, bwd=0.0, falone=0.0, balone=0.0, fbound=0.0,
                bbound=0.0)
    attrs = FU._lib("fused_conv").fused_tdx32_attrs
    for n, h, w, ci, co, k in CONV_SHAPES:
        m, kk = n * h * w, k * k * ci * co
        launches = counts[(n, h, w, ci, co, k)]
        tag = f"{k}x{k} {ci}->{co} at {n}x{h}x{w}"
        fbound = add_bound(reports["fused_conv_fwd_f32"], 2 * m * kk,
                           4 * m * (ci + co) + 4 * kk + 8 * (ci + co),
                           PEAK_F32_SPLIT)
        bbound = add_bound(reports["fused_conv_bwd_f32"], 4 * m * kk,
                           4 * m * (2 * ci + 2 * co) + 8 * kk
                           + 16 * (ci + co), PEAK_F32_SPLIT)
        x = act(n, ci, h, w)
        ab = table(ci, 0.5, 1.5, 0.5)
        wt = (torch.randn(co, ci, k, k, generator=gen)
              / (k * k * ci) ** 0.5).to(device=device, dtype=f32)
        y, s = FU.conv_fwd(x, ab, wt)
        again = FU.conv_fwd(x, ab, wt)
        torch.cuda.synchronize()
        check(torch.equal(y, again[0]) and torch.equal(s, again[1]),
              f"fused conv_fwd f32 {tag}: two launches differ")
        del again
        py, ps = FU.conv_fwd_reference(x, ab, wt)
        ey, es = FU.conv_fwd_reference(*up(x, ab, wt))
        e, r = f32_rule(f"fused fwd f32 y {tag}", y, py, ey)
        rs = max(f32_rule(f"fused fwd f32 s{i} {tag}", s[i], ps[i], es[i])[1]
                 for i in range(2))
        bwd = {}
        del py, ey
        dy = act(n, co, h, w, 1e-2)
        ds = torch.stack([torch.randn(co, generator=gen) * 1e-3,
                          torch.randn(co, generator=gen) * 1e-4]).to(device)
        got = FU.conv_bwd(x, ab, wt, y, dy, ds)
        again = FU.conv_bwd(x, ab, wt, y, dy, ds)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"fused conv_bwd f32 {tag}: two launches differ")
        del again
        plain = FU.conv_bwd_reference(x, ab, wt, y, dy, ds)
        exact = FU.conv_bwd_reference(*up(x, ab, wt, y, dy, ds))
        for name, g, p_, x_ in (("dx", got[0], plain[0], exact[0]),
                                ("dab0", got[1][0], plain[1][0], exact[1][0]),
                                ("dab1", got[1][1], plain[1][1], exact[1][1]),
                                ("dw", got[2], plain[2], exact[2])):
            bwd[name] = f32_rule(f"fused bwd f32 {name} {tag}", g, p_, x_)
        eb = max(v[0] for v in bwd.values())
        rb = max(v[1] for v in bwd.values())
        del plain, exact
        for key, err, rr in (("fused_conv_fwd_f32", e, max(r, rs)),
                             ("fused_conv_bwd_f32", eb, rb)):
            reports[key]["max_abs_err"] = max(reports[key]["max_abs_err"],
                                              err)
            ratio[key] = max(ratio[key], rr)
        fms = cuda_ms(lambda: FU.conv_fwd(x, ab, wt), 5)
        fpms = cuda_ms(lambda: FU.conv_fwd_reference(x, ab, wt), 2)
        bms = cuda_ms(lambda: FU.conv_bwd(x, ab, wt, y, dy, ds), 5)
        bpms = cuda_ms(lambda: FU.conv_bwd_reference(x, ab, wt, y, dy, ds),
                       2)
        xn, dye = FU._prologue(x, ab), FU._dy_eff(dy, y, ds)
        with full_f32():
            falone = conv_alone_ms(xn, wt, 5)
            balone = bwd_alone_ms(xn, wt, dye, 5)
        del xn, dye
        for key, ms, pms in (("fused_conv_fwd_f32", fms, fpms),
                             ("fused_conv_bwd_f32", bms, bpms)):
            reports[key]["ms"] += ms
            reports[key]["plain_ms"] += pms
        for key, v in (("fwd", fms), ("bwd", bms), ("falone", falone),
                       ("balone", balone), ("fbound", fbound),
                       ("bbound", bbound)):
            step[key] += launches * v
        geo = (1, 1, m) if k == 1 else (n, h, w)
        sms = CV._sms(device.index or 0)
        pw = CV.tma_dw_plan(*geo, ci, co, k, sms, aux=4, esize=4)
        pf = CV.tma_staged_fwd_plan(*geo, ci, co, k, sms, esize=4)
        px = CV.tma_bwd_dx_plan(*geo, ci, co, k, sms, 4, True, esize=4)
        print(f"fused conv f32 {tag} ({launches} a step; fwd "
              f"{dx32_plan(attrs, True, pf)}, dX {dx32_plan(attrs, False, px)}"
              f"; dW [R "
              f"{CV.DW32_RUN}, BN {pw.bn}, {pw.stages} stages, {pw.splits} "
              f"splits, cluster {pw.cluster}]): fwd {fms:.4f} ms "
              f"(plain {fpms:.4f}; bound {fbound:.4f}; conv alone "
              f"{falone:.4f}), bwd {bms:.4f} ms (plain {bpms:.4f}; bound "
              f"{bbound:.4f}; conv alone {balone:.4f}); max abs err against "
              f"float64 y {e:.3e} (x{r:.2f} the plain's, s x{rs:.2f}), "
              f"dx/dab/dw {eb:.3e} (" + ", ".join(
                  f"{k_} x{v[1]:.2f}" for k_, v in bwd.items())
              + "); fwd and bwd bit-equal twice")
        del x, y, s, dy, got

    for n, h, w, c in BOUNDARY_SHAPES:
        mc = n * h * w * c  # ~5 float32 operations an element forward, ~10
        add_bound(reports["fused_boundary_fwd_f32"], 5 * mc, 12 * mc + 16 * c,
                  PEAK_F32)
        add_bound(reports["fused_boundary_bwd_f32"], 10 * mc,
                  20 * mc + 32 * c, PEAK_F32)
        tag = f"C={c} at {n}x{h}x{w}"
        z, zs = act(n, c, h, w), act(n, c, h, w)
        ab, abs_ = table(c, 0.5, 1.5, 0.5), table(c, 0.5, 1.5, 0.5)
        g = act(n, c, h, w, 1e-2)
        out = FU.boundary_fwd(z, ab, zs, abs_)
        check(torch.equal(out, FU.boundary_fwd(z, ab, zs, abs_)),
              f"fused boundary_fwd f32 {tag}: two launches differ")
        e = ulps_close(f"boundary f32 out {tag}", out,
                       FU.boundary_fwd_reference(z, ab, zs, abs_),
                       F32_BOUNDARY_ULPS)
        got = FU.boundary_bwd(g, z, ab, zs, abs_)
        again = FU.boundary_bwd(g, z, ab, zs, abs_)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"fused boundary_bwd f32 {tag}: two launches differ (dz, dab, "
              "dzs, dabs)")
        del again
        want = FU.boundary_bwd_reference(g, z, ab, zs, abs_)
        exact = FU.boundary_bwd_reference(*up(g, z, ab, zs, abs_))
        eb = max(ulps_close(f"boundary f32 dz {tag}", got[0], want[0],
                            F32_BOUNDARY_ULPS),
                 ulps_close(f"boundary f32 dzs {tag}", got[2], want[2],
                            F32_BOUNDARY_ULPS))
        rs = max(f32_rule(f"boundary f32 {name}{j} {tag}", got[i][j],
                          want[i][j], exact[i][j])[1]
                 for name, i in (("dab", 1), ("dabs", 3)) for j in range(2))
        del want, exact
        for key, err in (("fused_boundary_fwd_f32", e),
                         ("fused_boundary_bwd_f32", eb)):
            reports[key]["max_abs_err"] = max(reports[key]["max_abs_err"],
                                              err)
        ratio["fused_boundary_bwd_f32"] = max(
            ratio["fused_boundary_bwd_f32"], rs)
        fms = cuda_ms(lambda: FU.boundary_fwd(z, ab, zs, abs_), 5)
        fpms = cuda_ms(lambda: FU.boundary_fwd_reference(z, ab, zs, abs_), 2)
        bms = cuda_ms(lambda: FU.boundary_bwd(g, z, ab, zs, abs_), 5)
        bpms = cuda_ms(lambda: FU.boundary_bwd_reference(g, z, ab, zs, abs_),
                       2)
        for key, ms, pms in (("fused_boundary_fwd_f32", fms, fpms),
                             ("fused_boundary_bwd_f32", bms, bpms)):
            reports[key]["ms"] += ms
            reports[key]["plain_ms"] += pms
        print(f"fused boundary f32 {tag}: fwd {fms:.4f} ms (plain "
              f"{fpms:.4f}), bwd {bms:.4f} ms (plain {bpms:.4f}); max abs "
              f"err out {e:.3e}, dz/dzs {eb:.3e} (within "
              f"{F32_BOUNDARY_ULPS} ulps), dab/dabs x{rs:.2f} the plain's "
              f"error; bit-equal twice")
        del z, zs, g, out, got

    # each tdx_f32 instantiation (DX32_INSTANCES) at the first 1x1 shape
    # where the forward and the dX both take BN 128, against the plain
    # version, launched twice and bit-equal
    for n, h, w, ci, co, k in [sh for sh in CONV_SHAPES if sh[5] == 1
                               and sh[3] % 128 == 0 and sh[4] % 128 == 0][:1]:
        tag = f"{k}x{k} {ci}->{co} at {n}x{h}x{w}"
        geo, sms = (1, 1, n * h * w), CV._sms(device.index or 0)
        x, ab = act(n, ci, h, w), table(ci, 0.5, 1.5, 0.5)
        wt = (torch.randn(co, ci, k, k, generator=gen)
              / (k * k * ci) ** 0.5).to(device=device, dtype=f32)
        y, ps = FU.conv_fwd_reference(x, ab, wt)
        ey, es = FU.conv_fwd_reference(*up(x, ab, wt))
        dy = act(n, co, h, w, 1e-2)
        ds = torch.stack([torch.randn(co, generator=gen) * 1e-3,
                          torch.randn(co, generator=gen) * 1e-4]).to(device)
        plain = FU.conv_bwd_reference(x, ab, wt, y, dy, ds)
        exact = FU.conv_bwd_reference(*up(x, ab, wt, y, dy, ds))
        for bns, ovl in DX32_INSTANCES:
            with dx32_choice(bns, ovl):
                pf = CV.tma_staged_fwd_plan(*geo, ci, co, k, sms, esize=4)
                px = CV.tma_bwd_dx_plan(*geo, ci, co, k, sms, 4, True,
                                        esize=4)
                what = f"tdx_f32 BN {pf.bn} overlap {int(ovl)} {tag}"
                got = FU.conv_fwd(x, ab, wt)
                again = FU.conv_fwd(x, ab, wt)
                torch.cuda.synchronize()
                check(all(torch.equal(a, b) for a, b in zip(got, again)),
                      f"fused fwd f32 {what}: two launches differ")
                rf = max(f32_rule(f"fused fwd f32 y {what}", got[0], y,
                                  ey)[1],
                         *(f32_rule(f"fused fwd f32 s{i} {what}", got[1][i],
                                    ps[i], es[i])[1] for i in range(2)))
                got = FU.conv_bwd(x, ab, wt, y, dy, ds)
                again = FU.conv_bwd(x, ab, wt, y, dy, ds)
                torch.cuda.synchronize()
                check(all(torch.equal(a, b) for a, b in zip(got, again)),
                      f"fused bwd f32 {what}: two launches differ")
                rb = max(f32_rule(f"fused bwd f32 {nm} {what}", g_, p_,
                                  x_)[1]
                         for nm, g_, p_, x_ in (
                             ("dx", got[0], plain[0], exact[0]),
                             ("dab0", got[1][0], plain[1][0], exact[1][0]),
                             ("dab1", got[1][1], plain[1][1], exact[1][1])))
                del got, again
                print(f"fused {what}: fwd {dx32_plan(attrs, True, pf)} y/s "
                      f"x{rf:.2f} the plain's error, dX "
                      f"{dx32_plan(attrs, False, px)} dx/dab x{rb:.2f}; "
                      "bit-equal twice")
        del x, y, dy, plain, exact
    print(f"fused float32 kernels a train step (each shape's ms times its "
          f"launches, {FUSED_CONV_STEP_LAUNCHES} each): fwd "
          f"{step['fwd']:.4f} ms (bound {step['fbound']:.4f}, conv alone "
          f"{step['falone']:.4f}), bwd {step['bwd']:.4f} ms (bound "
          f"{step['bbound']:.4f}, conv alone {step['balone']:.4f}); over the "
          f"{len(CONV_SHAPES)} shapes: fwd "
          f"{reports['fused_conv_fwd_f32']['ms']:.4f}, bound "
          f"{reports['fused_conv_fwd_f32']['bound_ms']:.4f}; bwd "
          f"{reports['fused_conv_bwd_f32']['ms']:.4f}, bound "
          f"{reports['fused_conv_bwd_f32']['bound_ms']:.4f}; the largest "
          f"error ratio to the plain version's by kernel "
          f"{ {k: round(v, 3) for k, v in ratio.items()} }")


def train_config(impl: str, freeze_bn: bool = False, model=None,
                 loss=None, geometry: str = "RBOX", dtype="bfloat16",
                 loss_dtype="float32"):
    """bench.py's train configuration: ``model`` (MODEL by default), its
    ``loss`` (LOSS by default: OHEM), 512^2, bf16 activations (its batch
    of 32 with 16 polygon slots an image is train_batch's), or ``dtype``'s
    (model.compute_dtype); the OHEM loss's ``loss_dtype``
    (loss.compute_dtype: bench.py's frozen arm takes "bfloat16")."""
    from tensorflow_ocr_tpu_torch.config import Config

    cfg = Config()
    cfg.model.name = model or MODEL
    cfg.model.compute_dtype = dtype
    cfg.model.bottleneck_impl = impl
    cfg.model.freeze_bn = freeze_bn
    cfg.loss.name = loss or LOSS
    cfg.loss.compute_dtype = loss_dtype
    cfg.data.input_size = TRAIN_SIZE
    cfg.data.geometry = geometry
    cfg.train.log_every_steps = 1
    return cfg


def train_batch(rng, device, n, size, max_polys=16, hw=None):
    """A device batch of numpy scenes of ``hw`` (size x size by default):
    flat colour patches with 4-16 rotated text-like quads an image (about
    1 in 10 tagged ignored), painted on the card by the port's
    rasterizer; with the EAST keys (shrunk polygons, fitted rectangles,
    angles) made on the host (trainer.east_geometry)."""
    import numpy as np
    import torch
    from tensorflow_ocr_tpu_torch.ops.rasterize import rasterize_instances
    from tensorflow_ocr_tpu_torch.train.trainer import east_geometry

    ih, iw = hw or (size, size)
    polys = np.zeros((n, max_polys, 4, 2), np.float32)
    valid = np.zeros((n, max_polys), bool)
    tags = np.zeros((n, max_polys), bool)
    for i in range(n):
        k = rng.randint(4, max_polys + 1)
        for j in range(k):
            cx, cy = rng.uniform(0.1, 0.9, 2) * (iw, ih)
            w, h = rng.uniform(0.08, 0.3) * size, rng.uniform(0.03, 0.1) * size
            th = rng.uniform(-0.6, 0.6)
            c, s = np.cos(th), np.sin(th)
            rot = np.array([[c, -s], [s, c]])
            box = np.array([[-w, -h], [w, -h], [w, h], [-w, h]]) / 2
            polys[i, j] = np.clip(box @ rot.T + (cx, cy), 0,
                                  (iw - 1, ih - 1))
        valid[i, :k] = True
        tags[i, :k] = rng.rand(k) < 0.1
    coarse = rng.randint(0, 256, (n, ih // 64 + 1, iw // 64 + 1, 3))
    images = coarse.repeat(64, 1).repeat(64, 2)[:, :ih, :iw]
    batch = {"images": torch.from_numpy(images.astype(np.uint8)).to(device),
             "polys": torch.from_numpy(polys).to(device),
             "tags": torch.from_numpy(tags).to(device),
             "valid": torch.from_numpy(valid).to(device)}
    ink = torch.from_numpy(rng.randint(0, 60, (n, 3)).astype(np.uint8))
    for i in range(n):
        inst = rasterize_instances(batch["polys"][i:i + 1],
                                   batch["valid"][i:i + 1], ih, iw)[0]
        batch["images"][i][inst > 0] = ink[i].to(device)
    batch.update(east_geometry(batch["polys"]))
    return batch


def reset_fused_counts():
    from tensorflow_ocr_tpu_torch.ops import fused as FU

    for attr, _, _ in (*FUSED_KERNELS.values(), *FUSED_F32_KERNELS.values()):
        getattr(FU, attr).launches = 0
    FU.conv_bwd.by_kernel = dict.fromkeys(FU.conv_bwd.by_kernel, 0)


def fused_counts(kernels=None):
    """{name: launches} of the fused kernels (FUSED_KERNELS, the bfloat16
    ones, by default; FUSED_F32_KERNELS for the float32 ones)."""
    from tensorflow_ocr_tpu_torch.ops import fused as FU

    return {name: getattr(FU, attr).launches
            for name, (attr, _, _) in (kernels or FUSED_KERNELS).items()}


def bf16_by_kernel(n):
    """conv_bwd.by_kernel after n bfloat16 fused backwards and no float32
    one."""
    return {"tdw": n, "tdx": n, "tdw_f32": 0, "tdx_f32": 0}


def grads_of(model, batch, cfg):
    """(model loss, {parameter name: flat float32 gradient}) of one
    forward and backward."""
    from tensorflow_ocr_tpu_torch.train import trainer as T

    loss, _ = T.loss_and_grads(model, batch, cfg, T.make_loss_fn(cfg))
    return float(loss), {n: p.grad.float().flatten()
                         for n, p in model.named_parameters()}


def arm_grads(device, weights, batch, impl, dtype="bfloat16"):
    """(loss, gradients) of one step of ``impl`` from a state_dict, in
    bf16 or ``dtype``."""
    import torch
    from tensorflow_ocr_tpu_torch.models import build_model

    model = build_model(MODEL, dtype=getattr(torch, dtype),
                        bottleneck_impl=impl)
    model.load_state_dict(weights, strict=True)
    out = grads_of(model.to(device), batch, train_config(impl, dtype=dtype))
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


def fused_unit_names():
    """The backbone units of MODEL that the fused arm runs as
    FusedBottleneck (the 13 stride-1 units)."""
    from tensorflow_ocr_tpu_torch.models import build_model
    from tensorflow_ocr_tpu_torch.models.resnet import FusedBottleneck

    model = build_model(MODEL, bottleneck_impl="fused")
    return tuple(n for n, m in model.backbone.named_children()
                 if isinstance(m, FusedBottleneck))


def fused_readings(fused, xla):
    """arm_readings of the fused arm against the xla arm, plus two
    readings over the fused units' parameters (a fault in one unit's
    gradients hardly moves the whole gradient: the boundary's dz x 0.9
    read 1.8614e-2 there, inside ARM_GRAD_REL): the worst relative
    gradient error (``unit``), and the worst departure of the ratio of
    the two gradients' norms from 1 (``scale``: bf16 noise turns a
    gradient's direction, a scaled backward its length)."""
    r = arm_readings(fused, xla)
    units = set(fused_unit_names())
    gf, gx = fused[1], xla[1]
    names = [n for n in gx if n.split(".")[1] in units]
    unit = {n: float((gf[n] - gx[n]).norm() / gx[n].norm()) for n in names}
    scale = {n: abs(1.0 - float(gf[n].norm() / gx[n].norm()))
             for n in names}
    worst = max(unit, key=unit.get)
    r["unit"] = (worst, unit[worst])
    worst = max(scale, key=scale.get)
    r["scale"] = (worst, scale[worst])
    return r


def unit_text(r) -> str:
    return (f"worst fused-unit parameter rel err {r['unit'][1]:.4e} at "
            f"{r['unit'][0]} (tol {FUSED_ARM_UNIT_REL:g}), norm ratio off 1 "
            f"by {r['scale'][1]:.4e} at {r['scale'][0]} (tol "
            f"{FUSED_ARM_UNIT_SCALE:g})")


def check_arms(r) -> None:
    check(r["rel_loss"] <= ARM_LOSS_REL, "fused and xla losses disagree")
    check(r["grad_rel"] <= ARM_GRAD_REL, "fused and xla gradients disagree")
    check(r["worst"][1] >= ARM_COS_MIN, f"the fused gradient of "
          f"{r['worst'][0]} points elsewhere than the xla one")
    check(r["unit"][1] <= FUSED_ARM_UNIT_REL, f"the fused gradient of "
          f"{r['unit'][0]} differs from the xla one")
    check(r["scale"][1] <= FUSED_ARM_UNIT_SCALE, f"the fused gradient of "
          f"{r['scale'][0]} is scaled against the xla one")


def phase_train(device, reports, arm_start):
    """The train step at full width: 3 fused steps through Trainer.run,
    each of the four fused kernels launched; one step each of the fused
    and the xla arm from the state ``arm_start`` (augmented_start) and one
    batch, compared (check_arms); one freeze_bn step; bench.py's frozen
    recipe with the bfloat16 loss (phase_frozen_bf16_loss)."""
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
    check(by_kernel == bf16_by_kernel(TRAIN_STEPS * FUSED_CONV_STEP_LAUNCHES)
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

    # one step of the fused and the xla arm from the augmented state
    r = fused_readings(arm_grads(device, arm_start, batch, "fused"),
                       arm_grads(device, arm_start, batch, "xla"))
    print(f"fused vs xla, one step from the augmented state: loss "
          f"{r['loss'][0]:.6f} / "
          f"{r['loss'][1]:.6f} (rel {r['rel_loss']:.3e}, tol "
          f"{ARM_LOSS_REL:g}); gradient norm {r['norm'][0]:.6f} / "
          f"{r['norm'][1]:.6f}, rel err {r['grad_rel']:.4e} (tol "
          f"{ARM_GRAD_REL:g}); worst parameter cosine {r['worst'][1]:.6f} "
          f"at {r['worst'][0]} (min {ARM_COS_MIN:g}); {unit_text(r)}")
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
    phase_frozen_bf16_loss(device, arm_start, batch)
    return trainer, batch, snap


# bench.py's fine-tune recipe: freeze_bn with the OHEM loss in bfloat16.
# The loss against the float32 loss's: JAX's bound for the lever
# (tests/test_losses.py:127-143); read 8.434e-3 from the augmented state
# on the H100 (the bfloat16 CE of confident pixels rounds low; 8.9e-6 from
# the seeded state). The cosine of the two steps' gradients (all
# parameters, float64): read 0.999980 there (rel err 7.12e-3), so the
# floor leaves 25 times that reading's 1 - cosine
LOSS_BF16_REL = 2e-2
LOSS_BF16_COS_MIN = 0.9995


@contextlib.contextmanager
def loss_bf16_env(value):
    """OCR_LOSS_BF16 set to ``value`` inside the block (unset for None),
    restored after it."""
    old = os.environ.pop("OCR_LOSS_BF16", None)
    if value is not None:
        os.environ["OCR_LOSS_BF16"] = value
    try:
        yield
    finally:
        os.environ.pop("OCR_LOSS_BF16", None)
        if old is not None:
            os.environ["OCR_LOSS_BF16"] = old


def frozen_step(device, weights, batch, cfg, env):
    """One train_step of ``cfg`` from the model tensors ``weights``, its
    loss made (make_loss_fn, which reads OCR_LOSS_BF16) with the variable
    at ``env``: (the state's tensors, the metrics, the flat float32
    gradient, the fused kernels' launches)."""
    import torch
    from tensorflow_ocr_tpu_torch.train import trainer as T

    state = T.create_train_state(cfg, device, weights=weights)
    reset_fused_counts()
    with loss_bf16_env(env):
        m = T.train_step(state, batch, cfg, T.make_loss_fn(cfg))
    torch.cuda.synchronize()
    counts = fused_counts()
    grad = torch.cat([p.grad.float().flatten()
                      for p in state.model.parameters()])
    out = ({k: v.clone() for k, v in leaves(state).items()}, dict(m), grad,
           counts)
    del state
    return out


def phase_frozen_bf16_loss(device, start, batch):
    """bench.py's frozen arm on the fused kernels, eagerly, from the model
    tensors ``start`` (the augmented state: a fine-tune starts from a
    trained model) and ``batch``, under deterministic(): one step with the
    bfloat16 OHEM loss against one with the float32 loss (each fused
    kernel launched; loss within LOSS_BF16_REL, gradient cosine at least
    LOSS_BF16_COS_MIN), then the dtype resolved through OCR_LOSS_BF16:
    "1" over the float32 config equals the bfloat16 config's step, "0"
    over the bfloat16 config the float32 one's, bit for bit."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    f32 = train_config("fused", freeze_bn=True)
    bf16 = train_config("fused", freeze_bn=True, loss_dtype="bfloat16")
    with deterministic():
        ref = frozen_step(device, start, batch, f32, None)
        got = frozen_step(device, start, batch, bf16, None)
        env1 = frozen_step(device, start, batch, f32, "1")
        env0 = frozen_step(device, start, batch, bf16, "0")
    loss, want = float(got[1]["total_loss"]), float(ref[1]["total_loss"])
    rel = abs(loss - want) / abs(want)
    cos = cosine(got[2], ref[2])
    rel_grad = float((got[2] - ref[2]).norm() / ref[2].norm())
    diff1 = unequal(env1[0], got[0]) + unequal(env1[1], got[1])
    diff0 = unequal(env0[0], ref[0]) + unequal(env0[1], ref[1])
    print(f"freeze_bn fused, OHEM loss in bfloat16 against float32 from the "
          f"augmented state: total loss {loss:.6f} / {want:.6f} (rel "
          f"{rel:.3e}, tol {LOSS_BF16_REL:g}); n_pos "
          f"{float(got[1]['n_pos']):.0f} / {float(ref[1]['n_pos']):.0f}; "
          f"pixel loss {float(got[1]['pixel_loss']):.6f} / "
          f"{float(ref[1]['pixel_loss']):.6f}; gradient cosine {cos:.6f} "
          f"(min {LOSS_BF16_COS_MIN:g}), rel err {rel_grad:.4e}; kernel "
          f"launches {got[3]}")
    print(f"freeze_bn fused, OCR_LOSS_BF16=1 over the float32 config: "
          f"tensors not bit-equal to the bfloat16 config's step "
          f"{len(diff1)} {diff1[:4]}; OCR_LOSS_BF16=0 over the bfloat16 "
          f"config: not bit-equal to the float32 config's {len(diff0)} "
          f"{diff0[:4]}; {time.perf_counter() - t0:.1f} s")
    check(all(got[3].values()) and all(env1[3].values()),
          "bf16-loss freeze_bn step skipped a fused kernel")
    check(np.isfinite(loss), "bf16-loss freeze_bn step: non-finite loss")
    check(rel <= LOSS_BF16_REL, "bf16-loss freeze_bn step: loss off the "
          "float32 loss's")
    check(cos >= LOSS_BF16_COS_MIN, "bf16-loss freeze_bn step: gradient "
          "off the float32 loss's")
    check(unequal(got[0], ref[0]), "bf16-loss freeze_bn step: equal to the "
          "float32 loss's step (the loss dtype did nothing)")
    check(not diff1, "OCR_LOSS_BF16=1 differs from compute_dtype bfloat16")
    check(not diff0, "OCR_LOSS_BF16=0 differs from compute_dtype float32")
    del ref, got, env1, env0
    torch.cuda.empty_cache()


def fused_f32_readings(device, start, batch):
    """fused_readings of one float32 fused-arm step against one float32
    "xla"-arm step (cuDNN), both with TF32 off, from the state ``start``
    and one batch."""
    from tensorflow_ocr_tpu_torch.ops.fused import full_f32

    with full_f32():
        return fused_readings(
            arm_grads(device, start, batch, "fused", "float32"),
            arm_grads(device, start, batch, "xla", "float32"))


def check_f32_fused_arm(r) -> None:
    check(r["rel_loss"] <= F32_FUSED_ARM_LOSS_REL, "float32 fused and xla "
          "losses disagree")
    check(r["grad_rel"] <= F32_FUSED_ARM_GRAD_REL, "float32 fused and xla "
          "gradients disagree")
    check(r["worst"][1] >= F32_FUSED_ARM_COS_MIN, f"the float32 fused "
          f"gradient of {r['worst'][0]} points elsewhere than the xla one")
    check(r["unit"][1] <= F32_FUSED_ARM_UNIT_REL, f"the float32 fused "
          f"gradient of {r['unit'][0]} differs from the xla one")
    check(r["scale"][1] <= F32_FUSED_ARM_UNIT_SCALE, f"the float32 fused "
          f"gradient of {r['scale'][0]} is scaled against the xla one")


def f32_fused_text(r) -> str:
    return (f"loss {r['loss'][0]:.6f} / {r['loss'][1]:.6f} (rel "
            f"{r['rel_loss']:.3e}, tol {F32_FUSED_ARM_LOSS_REL:g}); gradient "
            f"norm {r['norm'][0]:.6f} / {r['norm'][1]:.6f}, rel err "
            f"{r['grad_rel']:.4e} (tol {F32_FUSED_ARM_GRAD_REL:g}); worst "
            f"parameter cosine {r['worst'][1]:.6f} at {r['worst'][0]} (min "
            f"{F32_FUSED_ARM_COS_MIN:g}); worst fused-unit parameter rel err "
            f"{r['unit'][1]:.4e} at {r['unit'][0]} (tol "
            f"{F32_FUSED_ARM_UNIT_REL:g}), norm ratio off 1 by "
            f"{r['scale'][1]:.4e} at {r['scale'][0]} (tol "
            f"{F32_FUSED_ARM_UNIT_SCALE:g})")


def fused_f32_launches(label, want, counts, by_kernel, bf):
    """Check a float32 fused run's launches: ``counts`` of the float32
    kernels equal to ``want``, conv_bwd.by_kernel's float32 keys at the
    backward's count and no bfloat16 fused kernel launched."""
    n = want["fused_conv_bwd_f32"]
    check(counts == want, f"{label}: float32 fused launches {counts}, "
          f"expected {want}")
    check(by_kernel == {"tdw": 0, "tdx": 0, "tdw_f32": n, "tdx_f32": n},
          f"{label}: backward launches by kernel {by_kernel}")
    check(not any(bf.values()), f"{label}: a bfloat16 fused kernel "
          f"launched {bf}")


def phase_fused_train_f32(device, reports, snap, batch, arm_start):
    """The fused arm in float32 (model.compute_dtype "float32",
    bottleneck_impl "fused"): 3 steps through Trainer.run, every fused
    product on a float32 kernel (FUSED_F32_STEP_LAUNCHES a step; the
    backward's tdw_f32 and tdx_f32 43 a step each) and none on a bfloat16
    one; eager img/s over ARM_WINDOWS windows of ARM_WINDOW_S and the peak
    memory; one step against the float32 "xla" arm (cuDNN, TF32 off) from
    the state ``arm_start`` (F32_FUSED_ARM_* bounds), after one float32
    freeze_bn step on the float32 kernels."""
    import numpy as np
    import torch
    from tensorflow_ocr_tpu_torch.ops import fused as FU
    from tensorflow_ocr_tpu_torch.train import trainer as T

    cfg = train_config("fused", dtype="float32")
    want = {k: TRAIN_STEPS * v for k, v in FUSED_F32_STEP_LAUNCHES.items()}
    base = arm_memory_start()
    trainer = T.Trainer(cfg, device)
    trainer.setup(weights=snap)
    reset_fused_counts()
    t0 = time.perf_counter()
    last = trainer.run([batch] * TRAIN_STEPS, TRAIN_STEPS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts, bf = fused_counts(FUSED_F32_KERNELS), fused_counts()
    by_kernel = dict(FU.conv_bwd.by_kernel)
    print(f"train {TRAIN_STEPS} steps fused float32 ({run_s:.2f} s, first "
          f"steps included): last metrics "
          f"{json.dumps({k: round(v, 6) for k, v in last.items()})}; "
          f"launches {counts} (expected {want}); backward by kernel "
          f"{by_kernel}; the bfloat16 kernels' {bf}; {arm_memory(base)}")
    check(trainer.state.step == TRAIN_STEPS and last and all(
        np.isfinite(v) for v in last.values()), "float32 fused train: "
          "non-finite or missing metrics")
    fused_f32_launches("float32 fused train", want, counts, by_kernel, bf)
    for name, n in counts.items():
        reports[name]["launches"] = n
    eager_rate(trainer.state, batch, cfg, "fused float32", ARM_WINDOWS,
               ARM_WINDOW_S, base)
    del trainer
    torch.cuda.empty_cache()

    fcfg = train_config("fused", freeze_bn=True, dtype="float32")
    state = T.create_train_state(fcfg, device, weights=snap)
    reset_fused_counts()
    loss = float(T.train_step(state, batch, fcfg,
                              T.make_loss_fn(fcfg))["total_loss"])
    counts, bf = fused_counts(FUSED_F32_KERNELS), fused_counts()
    by_kernel = dict(FU.conv_bwd.by_kernel)
    print(f"freeze_bn step fused float32: total loss {loss:.6f}, launches "
          f"{counts}, backward by kernel {by_kernel}")
    check(np.isfinite(loss), "float32 fused freeze_bn step: non-finite loss")
    fused_f32_launches("float32 fused freeze_bn step",
                       FUSED_F32_STEP_LAUNCHES, counts, by_kernel, bf)
    del state
    torch.cuda.empty_cache()

    r = fused_f32_readings(device, arm_start, batch)
    print(f"fused float32 vs xla float32 (TF32 off), one step from the "
          f"augmented state: {f32_fused_text(r)}")
    check_f32_fused_arm(r)


def phase_fused_detect_f32(pred, images):
    """Predictor(dtype=torch.float32, bottleneck_impl="fused") on the
    weights of ``pred``: detect_batch launches fused_conv_fwd_f32 (43) and
    fused_boundary_fwd_f32 (13) a forward and no bfloat16 fused kernel,
    the CC kernel, and finds the boxes; the logits within
    F32_FUSED_DETECT_REL of the largest logit of the float32 "xla"
    Predictor's on the same state_dict (TF32 off on both)."""
    import torch
    from tensorflow_ocr_tpu_torch.infer import Predictor
    from tensorflow_ocr_tpu_torch.ops import kernels as K
    from tensorflow_ocr_tpu_torch.ops.fused import full_f32

    weights = pred.model.state_dict()
    xla = Predictor(MODEL, weights=weights, device=pred.device,
                    dtype=torch.float32)
    p32 = Predictor(MODEL, weights=weights, device=pred.device,
                    dtype=torch.float32, bottleneck_impl="fused")
    p32.pixel_thresh, p32.link_thresh = pred.pixel_thresh, pred.link_thresh
    x = torch.from_numpy(images).to(pred.device)
    with full_f32(), torch.inference_mode():
        want = xla.model(x)
    del xla
    reset_fused_counts()
    K.connected_components.launches = 0
    boxes = p32.detect_batch(images)
    torch.cuda.synchronize()
    counts, bf = fused_counts(FUSED_F32_KERNELS), fused_counts()
    cc = K.connected_components.launches
    with full_f32(), torch.inference_mode():
        got = p32.model(x)
    expect = {"fused_conv_fwd_f32": FUSED_CONV_STEP_LAUNCHES,
              "fused_conv_bwd_f32": 0,
              "fused_boundary_fwd_f32": FUSED_BOUNDARY_STEP_LAUNCHES,
              "fused_boundary_bwd_f32": 0}
    print(f"detect_batch 8x1280x768 float32 fused: launches {counts} "
          f"(expected {expect}), bfloat16 fused kernels {bf}, cc launches "
          f"{cc}, boxes per image {[len(b) for b in boxes]}")
    check(counts == expect and not any(bf.values()), "float32 fused "
          "detect: launches")
    check(cc > 0 and len(boxes) == len(images) and sum(map(len, boxes)) > 0,
          "float32 fused detect: the CC kernel or the boxes")
    for key in ("pixel_logits", "link_logits"):
        g, w = got[key], want[key]
        check(g.dtype == torch.float32 and g.shape == w.shape
              and bool(torch.isfinite(g).all()),
              f"float32 fused {key}: dtype, shape or non-finite")
        rel = float((g - w).abs().max() / w.abs().max())
        print(f"float32 fused detect {key}: max|fused-xla|/max|xla| = "
              f"{rel:.3e} (tol {F32_FUSED_DETECT_REL:g})")
        check(rel <= F32_FUSED_DETECT_REL, f"float32 fused {key}: fused and "
              "xla logits disagree")
    del p32


def conv_arm_readings(device, start, batch, dtype="bfloat16"):
    """One xla-arm step with PALLAS_CONVS on against one with it off
    (cuDNN), from the state ``start`` and one batch (arm_readings); in
    float32 both with TF32 off (the convs off the route too)."""
    from tensorflow_ocr_tpu_torch.ops.fused import full_f32

    with (full_f32() if dtype == "float32" else contextlib.nullcontext()):
        with pallas_convs(True):
            routed = arm_grads(device, start, batch, "xla", dtype)
        return arm_readings(routed,
                            arm_grads(device, start, batch, "xla", dtype))


def conv_arm_bounds(dtype="bfloat16"):
    """(loss, gradient, cosine) bounds of the conv arm check in ``dtype``."""
    if dtype == "float32":
        return F32_ARM_LOSS_REL, F32_ARM_GRAD_REL, F32_ARM_COS_MIN
    return CONV_ARM_LOSS_REL, CONV_ARM_GRAD_REL, CONV_ARM_COS_MIN


def print_conv_arms(label, r, dtype="bfloat16"):
    loss_rel, grad_rel, cos_min = conv_arm_bounds(dtype)
    print(f"{label}: loss {r['loss'][0]:.6f} / {r['loss'][1]:.6f} (rel "
          f"{r['rel_loss']:.3e}, tol {loss_rel:g}); gradient norm "
          f"{r['norm'][0]:.6f} / {r['norm'][1]:.6f}, rel err "
          f"{r['grad_rel']:.4e} (tol {grad_rel:g}); worst parameter "
          f"cosine {r['worst'][1]:.6f} at {r['worst'][0]} (min "
          f"{cos_min:g})")


def phase_conv_train(device, reports, snap, batch, arm_start):
    """The PALLAS_CONVS arm at full width: 3 xla-arm steps through
    Trainer.run with the route on, each conv kernel launched
    CONV_STEP_LAUNCHES times a step; one step against the cuDNN arm from
    the state ``arm_start`` (CONV_ARM_* bounds); one freeze_bn step with
    the route on (the BN fold path)."""
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

    r = conv_arm_readings(device, arm_start, batch)
    print_conv_arms("xla with PALLAS_CONVS vs cuDNN, one step from the "
                    "augmented state", r)
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


def phase_conv_train_f32(device, reports, snap, batch, arm_start):
    """The PALLAS_CONVS arm in float32 (model.compute_dtype "float32"): 3
    xla-arm steps through Trainer.run with the route on, each conv wrapper
    launched CONV_STEP_LAUNCHES times a step, on the float32 kernels
    (F32_FWD_STEP_KERNELS, F32_DW_STEP_KERNELS) and none of the bfloat16
    ones; eager img/s over ARM_WINDOWS windows of ARM_WINDOW_S and the peak
    memory; one step against the same arm on cuDNN in float32, TF32 off,
    from the state ``arm_start`` (F32_ARM_* bounds)."""
    import numpy as np
    import torch
    from tensorflow_ocr_tpu_torch.train import trainer as T

    cfg = train_config("xla", dtype="float32")
    want = {k: TRAIN_STEPS * v for k, v in CONV_STEP_LAUNCHES.items()}
    base = arm_memory_start()
    with pallas_convs(True):
        trainer = T.Trainer(cfg, device)
        trainer.setup(weights=snap)
        reset_conv_counts()
        t0 = time.perf_counter()
        last = trainer.run([batch] * TRAIN_STEPS, TRAIN_STEPS)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = conv_counts()
        f32 = conv_counts((*F32_FWD_STEP_KERNELS, *F32_DW_STEP_KERNELS))
        bf = conv_counts((*FWD_STEP_KERNELS, *DW_STEP_KERNELS))
    print(f"train {TRAIN_STEPS} steps xla float32 with PALLAS_CONVS "
          f"({run_s:.2f} s, first steps included): last metrics "
          f"{json.dumps({k: round(v, 6) for k, v in last.items()})}; "
          f"launches {counts} (expected {want}); by kernel {f32}, the "
          f"bfloat16 kernels' {bf}; {arm_memory(base)}")
    check(trainer.state.step == TRAIN_STEPS and last and all(
        np.isfinite(v) for v in last.values()), "float32 pallas-conv "
          "train: non-finite or missing metrics")
    check(counts == want, "float32 pallas-conv train: conv launches")
    check(f32 == {k: TRAIN_STEPS * v for k, v in {
        **F32_FWD_STEP_KERNELS, **F32_DW_STEP_KERNELS}.items()},
          "float32 pallas-conv train: launches by kernel")
    check(not any(bf.values()), "float32 pallas-conv train: a bfloat16 "
          "kernel launched")
    for name, n in counts.items():
        reports[f"{name}_f32"]["launches"] = n
    with pallas_convs(True):
        eager_rate(trainer.state, batch, cfg, "xla pallas-conv float32",
                   ARM_WINDOWS, ARM_WINDOW_S, base)
    del trainer
    torch.cuda.empty_cache()

    r = conv_arm_readings(device, arm_start, batch, "float32")
    print_conv_arms("xla float32 with PALLAS_CONVS vs cuDNN float32 (TF32 "
                    "off), one step from the augmented state", r, "float32")
    check(r["rel_loss"] <= F32_ARM_LOSS_REL, "float32 pallas-conv and "
          "cuDNN losses disagree")
    check(r["grad_rel"] <= F32_ARM_GRAD_REL, "float32 pallas-conv and "
          "cuDNN gradients disagree")
    check(r["worst"][1] >= F32_ARM_COS_MIN, f"the float32 pallas-conv "
          f"gradient of {r['worst'][0]} points elsewhere than cuDNN's")


def phase_conv_detect_f32(pred, images):
    """Predictor(dtype=torch.float32) on the weights of ``pred`` with
    PALLAS_CONVS on: detect_batch launches the float32 kernels as the
    route's convs give (no bfloat16 one) and the CC kernel; the logits
    within FWD_REL_TOL of the cuDNN float32 forward's, both with TF32 off
    (cuDNN's default TF32 in the convs off the route moves the logits by
    5.0e-4 of the largest: PERF.md)."""
    import torch
    from tensorflow_ocr_tpu_torch.infer import Predictor
    from tensorflow_ocr_tpu_torch.ops import kernels as K
    from tensorflow_ocr_tpu_torch.ops.fused import full_f32

    p32 = Predictor(MODEL, weights=pred.model.state_dict(),
                    device=pred.device, dtype=torch.float32)
    p32.pixel_thresh, p32.link_thresh = pred.pixel_thresh, pred.link_thresh
    x = torch.from_numpy(images).to(pred.device)
    with full_f32(), torch.inference_mode():
        want = p32.model(x)
    with pallas_convs(True):
        reset_conv_counts()
        K.connected_components.launches = 0
        boxes = p32.detect_batch(images)
        torch.cuda.synchronize()
        counts, cc = conv_counts(), K.connected_components.launches
        f32 = conv_counts(F32_FWD_STEP_KERNELS)
        bf = conv_counts(FWD_STEP_KERNELS)
        with full_f32(), torch.inference_mode():
            got = p32.model(x)
    print(f"detect_batch 8x1280x768 float32 with PALLAS_CONVS: conv "
          f"launches {counts} (by kernel {f32}, bfloat16 kernels {bf}), cc "
          f"launches {cc}, boxes per image {[len(b) for b in boxes]}")
    check(counts == DETECT_CONV_LAUNCHES and f32 == F32_DETECT_FWD_KERNELS
          and not any(bf.values()), "float32 detect with the route: conv "
          "launches")
    check(cc > 0 and len(boxes) == len(images), "float32 detect with the "
          "route: the CC kernel or the boxes")
    for key in ("pixel_logits", "link_logits"):
        g, w = got[key], want[key]
        check(g.dtype == torch.float32 and g.shape == w.shape
              and bool(torch.isfinite(g).all()),
              f"float32 {key}: dtype, shape or non-finite")
        rel = float((g - w).abs().max() / w.abs().max())
        print(f"float32 detect with PALLAS_CONVS {key}: "
              f"max|routed-cudnn|/max|cudnn| = {rel:.3e} (tol "
              f"{FWD_REL_TOL:g})")
        check(rel <= FWD_REL_TOL, f"float32 {key}: routed and cuDNN logits "
              "disagree")
    del p32


def phase_conv_faults(device, start, batch, where, dtype="bfloat16"):
    """The readings that set the CONV_ARM_* bounds (F32_ARM_* in float32):
    the pallas-conv arm against cuDNN from the state ``start`` (the
    augmented one, or a trained checkpoint's), 3 sound runs, then one run
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

    where = where if dtype == "bfloat16" else f"{where} {dtype}"
    for i in range(3):
        print_conv_arms(f"faults {where}: sound run {i}",
                        conv_arm_readings(device, start, batch, dtype), dtype)
    for label, patch in (("dW x 0.9", scaled(1.0, 0.9)),
                         ("dX x 0.9", scaled(0.9, 1.0)),
                         ("3x3 dX kernel not flipped", unflipped)):
        CV._Conv1x1.backward, CV._Conv3x3.backward = map(
            staticmethod, patch())
        try:
            print_conv_arms(f"faults {where}: {label}",
                            conv_arm_readings(device, start, batch, dtype),
                            dtype)
        finally:
            CV._Conv1x1.backward = staticmethod(c1)
            CV._Conv3x3.backward = staticmethod(c3)


def arm_memory_start() -> int:
    """Free the cached blocks, reset the peak and return the bytes
    allocated: the start of one timed arm."""
    import torch

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def arm_memory(base: int) -> str:
    """The peak since :func:`arm_memory_start`, and the part of it above
    the bytes allocated then (the arm's own state, step and graph pool)."""
    import torch

    peak = torch.cuda.max_memory_allocated()
    return (f"peak memory {peak / 2**30:.2f} GiB, "
            f"{(peak - base) / 2**30:.2f} GiB of it the arm's own")


def phase_train_timing(trainer, batch):
    """Train img/s at 512^2, batch 32, for TIMING_ARMS (fused, xla,
    freeze_bn-fused, xla pallas-conv, ghost): 2 warm-up steps, then
    eager_rate over ARM_WINDOWS windows of at least ARM_WINDOW_S of
    train_step calls on one device-resident batch (labels made on the
    card inside each step), with each arm's peak memory."""
    import torch
    from tensorflow_ocr_tpu_torch.train import trainer as T

    weights = trainer.state.model.state_dict()
    for arm, impl, freeze, route in TIMING_ARMS:
        cfg = train_config(impl, freeze)
        base = arm_memory_start()
        state = T.create_train_state(cfg, batch["images"].device,
                                     weights=weights)
        loss_fn = T.make_loss_fn(cfg)
        with pallas_convs(route):
            for _ in range(2):
                T.train_step(state, batch, cfg, loss_fn)
            torch.cuda.synchronize()
            eager_rate(state, batch, cfg, arm, ARM_WINDOWS, ARM_WINDOW_S,
                       base)
        del state
        torch.cuda.empty_cache()


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
# versions, one step each. The bounds were set from the tempered state of
# PRs 4-11 (sound loss <= 1.64e-4, gradient <= 1.60e-2, cosine >= 0.9930, unit
# <= 4.92e-2; the halo fault >= 3.23e-2, seam cosine 0.931, dW2's unit
# 0.106). From the augmented state, where the gate now runs (--faults;
# H100 80GB HBM3 at 700 W): sound loss 1.445e-4, gradient
# 8.9636e-3, cosine 0.998836, unit 1.9768e-2; the dropped seam terms
# 1.1581e-1 / 0.971779 / 2.5150e-1, the halo rows under their own band's
# affine loss 1.831e-3 and gradient 6.5322e-2, dW2 x 0.9 gradient
# 5.4947e-2 and unit 1.0212e-1: every fault fails the gradient bound
# there.
GHOST_ARM_LOSS_REL = 5e-4
GHOST_ARM_GRAD_REL = 2.5e-2
GHOST_ARM_COS_MIN = 0.98
GHOST_ARM_UNIT_REL = 7.5e-2
# the float32 ghost arm on its kernels against the same arm on the plain
# float32 versions (TF32 off in both), one step each from the augmented
# state: bounds between the sound runs' largest reading and the planted
# faults' smallest (--faults, scripts/ghost_f32_probe.py --faults; PERF.md,
# Findings; H100 80GB HBM3 at 700 W): sound loss 0, gradient 1.2483e-4,
# cosine 0.999999, unit 2.6350e-4 (4 runs); the dropped seam terms
# gradient 1.1618e-1, cosine 0.972100, unit 2.5222e-1; the halo rows under
# their own band's affine loss 2.055e-3, gradient 6.6969e-2, cosine
# 0.980702, unit 1.0917e-1; dW2 x 0.9 gradient 5.4650e-2, unit 9.9999e-2
# (cosine 0.999999): every fault fails the gradient and unit bounds
F32_GHOST_ARM_LOSS_REL = 1e-5
F32_GHOST_ARM_GRAD_REL = 2.5e-3
F32_GHOST_ARM_COS_MIN = 0.999
F32_GHOST_ARM_UNIT_REL = 1e-2
# the ghost units of the step (the worst-parameter reading above)
GHOST_UNIT_NAMES = ("block1_unit1", "block1_unit2", "block2_unit1",
                    "block2_unit2", "block2_unit3")


def reset_ghost_counts():
    from tensorflow_ocr_tpu_torch.ops import ghost as G

    for attr, _ in (*GHOST_KERNELS.values(), *GHOST_F32_KERNELS.values()):
        getattr(G, attr).launches = 0
    G.conv_bwd.by_kernel = dict.fromkeys(G.conv_bwd.by_kernel, 0)


def ghost_counts(kernels=None):
    """{name: launches} of the ghost kernels (GHOST_KERNELS, the bfloat16
    ones, by default; GHOST_F32_KERNELS for the float32 ones)."""
    from tensorflow_ocr_tpu_torch.ops import ghost as G

    return {name: getattr(G, attr).launches
            for name, (attr, _) in (kernels or GHOST_KERNELS).items()}


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


# the ghost unit's float32 kernels (ops/ghost.py conv_fwd32,
# boundary_fwd32, boundary_bwd32, conv_bwd32, seam_bwd32): the same source
# and sites, the same launches a step as the bfloat16 ones
GHOST_F32_KERNELS = {f"{name}_f32": (f"{attr}32", sites)
                     for name, (attr, sites) in GHOST_KERNELS.items()}
GHOST_F32_STEP_LAUNCHES = {f"{name}_f32": n
                           for name, n in GHOST_STEP_LAUNCHES.items()}


def phase_ghost_kernels_f32(device, reports):
    """Each ghost kernel in float32 against its plain float32 version at
    each unit shape of the step (GHOST_SHAPES), along one unit's chain as
    phase 14 (each kernel fed the plain version's outputs of the stage
    before): the conv forwards' y and band sums, the conv backwards' dw,
    gm, its sums and dx, the seam's terms and sums, each within
    F32_ERR_MULTIPLE times the plain version's error (TF32 off) against
    the float64 result of the plain versions; the boundary's out within
    F32_BOUNDARY_ULPS of the plain version's, its gm equal to it (dout or
    0) and its sums to the 4x rule; every kernel launched twice and
    bit-equal. Prints kernel and plain ms (CUDA events), the bound (split
    TF32 at PEAK_F32_SPLIT for the convs and the seam, PEAK_F32 for the
    boundary, bytes at the HBM rate) and the conv-alone yardsticks in
    float32 (TF32 off: torch.matmul / F.conv2d of the forward's product
    on the input activated under its own band, and the backward's two
    products on it and dz), and each kernel's ms a train step.
    Each conv backward's dW plan is printed (R, BN, stages, splits,
    cluster), and each conv's tdx_f32 plan (dx32_plan); then each tdx_f32
    instantiation (DX32_INSTANCES) in conv3's forward and backward at one
    unit shape, to the same rule, twice and bit-equal. max_abs_err:
    against float64, the boundary's out against the plain version."""
    import torch
    from tensorflow_ocr_tpu_torch.ops import conv as CV
    from tensorflow_ocr_tpu_torch.ops import ghost as G
    from tensorflow_ocr_tpu_torch.ops.fused import full_f32

    gen = torch.Generator().manual_seed(19)
    f32, f64, cl = torch.float32, torch.float64, torch.channels_last
    eps = 1e-5
    # no one PyTorch call computes a ghost-BN unit or a part of it; the
    # conv-alone yardsticks are printed
    for r in reports.values():
        r.update(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=None)
    ratio = dict.fromkeys(reports, 0.0)

    def act(n, c, h, w, scale=1.0, relu=False):
        t = torch.randn(n, c, h, w, generator=gen) * scale
        t = torch.relu(t) if relu else t
        return t.to(device=device, dtype=f32).contiguous(memory_format=cl)

    def weight(co, ci, k):
        return (torch.randn(co, ci, k, k, generator=gen)
                / (k * k * ci) ** 0.5).to(device=device, dtype=f32)

    def gbt(c):
        return torch.stack([torch.empty(c).uniform_(0.5, 1.5, generator=gen),
                            torch.randn(c, generator=gen) * 0.1]).to(device)

    def up(*ts):
        return [None if t is None else t.to(f64).contiguous(memory_format=cl)
                if t.dim() == 4 else t.to(f64) for t in ts]

    def twice(name, fn):
        got, again = fn(), fn()
        torch.cuda.synchronize()
        check(all((a is None and b is None) or torch.equal(a, b)
                  for a, b in zip(got, again)),
              f"{name}: two launches on the same inputs differ")
        return got

    def note(name, errs):
        r = reports[name]
        r["max_abs_err"] = max(r["max_abs_err"], *(e for e, _ in errs))
        ratio[name] = max(ratio[name], *(q for _, q in errs))
        return max(e for e, _ in errs), max(q for _, q in errs)

    step = {k: 0.0 for k in ("fwd", "fbound", "falone", "bwd", "bbound",
                             "balone", "seam", "sbound", "bnd", "bndb")}
    attrs = G._lib().ghost_tdx32_attrs
    sms = CV._sms(device.index or 0)

    def timed(name, kernel, plain, flops, nbytes, peak):
        ms, pms = cuda_ms(kernel, 5), cuda_ms(plain, 2)
        bound = add_bound(reports[name], flops, nbytes, peak)
        reports[name]["ms"] += ms
        reports[name]["plain_ms"] += pms
        return ms, pms, bound

    def conv_fwd(what, x, tab, w, gh):
        got = twice(f"ghost conv_fwd f32 {what}",
                    lambda: G.conv_fwd(x, tab, w, gh))
        want = G.conv_fwd_reference(x, tab, w, gh)
        exact = G.conv_fwd_reference(*up(x, tab, w), gh)
        e, q = note("ghost_conv_fwd_f32", [
            f32_rule(f"ghost fwd f32 y {what}", got[0], want[0], exact[0]),
            f32_rule(f"ghost fwd f32 s {what}", got[1], want[1], exact[1])])
        del exact
        n, ci, h, wd = x.shape
        co, k = w.shape[0], w.shape[-1]
        m, nbt = n * h * wd, n * (h // gh)
        ms, pms, bound = timed(
            "ghost_conv_fwd_f32", lambda: G.conv_fwd(x, tab, w, gh),
            lambda: G.conv_fwd_reference(x, tab, w, gh),
            2 * m * k * k * ci * co,
            4 * m * (ci + co) + 4 * k * k * ci * co + 8 * nbt * (ci + co),
            PEAK_F32_SPLIT)
        with full_f32():
            alone = conv_alone_ms(G._act(x, tab, gh), w, 5)
        for key, v in (("fwd", ms), ("fbound", bound), ("falone", alone)):
            step[key] += units * v
        pf = CV.tma_staged_fwd_plan(n, h, wd, ci, co, k, sms, gh, esize=4)
        print(f"ghost_conv_fwd_f32 {what} ({dx32_plan(attrs, True, pf)}): "
              f"kernel {ms:.4f} ms, plain "
              f"{pms:.4f}, bound {bound:.4f}, conv alone (f32, TF32 off) "
              f"{alone:.4f}; max abs err against float64 {e:.3e} (x{q:.2f} "
              f"the plain's); {units} a step; bit-equal twice")
        return want

    def conv_bwd(what, x, tx, g, z, td, w, gh, edge=None, addend=None,
                 out="gm"):
        args = (x, tx, g, z, td, w, gh, edge, addend, out)
        got = twice(f"ghost conv_bwd f32 {what}", lambda: G.conv_bwd(*args))
        want = G.conv_bwd_reference(*args)
        exact = G.conv_bwd_reference(*up(x, tx, g, z, td, w), gh,
                                     *up(edge, addend), out)
        rules = [f32_rule(f"ghost bwd f32 dw {what}", got[2], want[2],
                          exact[2]),
                 f32_rule(f"ghost bwd f32 dx {what}", got[0], want[0],
                          exact[0])]
        if out == "gm":
            rules += [f32_rule(f"ghost bwd f32 sums {what}", got[1],
                               want[1], exact[1])]
        e, q = note("ghost_conv_bwd_f32", rules)
        del exact
        n, ci, h, wd = x.shape
        co, k = w.shape[0], w.shape[-1]
        m, nbt = n * h * wd, n * (h // gh)
        nbytes = (8 * m * (ci + co) + 8 * k * k * ci * co
                  + (0 if addend is None else 4 * m * ci)
                  + (0 if edge is None else edge.numel() * 4)
                  + 4 * nbt * (5 * co + 4 * ci))
        ms, pms, bound = timed("ghost_conv_bwd_f32",
                               lambda: G.conv_bwd(*args),
                               lambda: G.conv_bwd_reference(*args),
                               4 * m * k * k * ci * co, nbytes,
                               PEAK_F32_SPLIT)
        dz = G._dz(g, z, td, gh, edge).contiguous(memory_format=cl)
        with full_f32():
            alone = bwd_alone_ms(G._act(x, tx, gh), w, dz, 5)
        del dz
        for key, v in (("bwd", ms), ("bbound", bound), ("balone", alone)):
            step[key] += units * v
        pw = CV.tma_dw_plan(n, h, wd, ci, co, k, sms, aux=4, esize=4, gh=gh)
        px = CV.tma_bwd_dx_plan(n, h, wd, ci, co, k, sms, 4, True, gh,
                                esize=4)
        print(f"ghost_conv_bwd_f32 {what} (dX {dx32_plan(attrs, False, px)}"
              f"; dW [R {CV.DW32_RUN}, BN "
              f"{pw.bn}, {pw.stages} stages, {pw.splits} splits, cluster "
              f"{pw.cluster}]): kernel {ms:.4f} ms, plain "
              f"{pms:.4f}, bound {bound:.4f}, conv alone (f32, TF32 off) "
              f"{alone:.4f}; max abs err against float64 {e:.3e} (x{q:.2f} "
              f"the plain's); {units} a step; bit-equal twice")
        return want

    for (n, h, wd, ci, db, co, gh), units in zip(GHOST_SHAPES,
                                                 GHOST_SHAPE_UNITS):
        proj, cnt = ci != co, float(gh * wd)
        tag = (f"{'proj' if proj else 'identity'} {ci}/{db}/{co} at "
               f"{n}x{h}x{wd} gh {gh}")
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
        out = twice(f"ghost boundary_fwd f32 {tag}",
                    lambda: (G.boundary_fwd(z3, t3, zs, ts, gh),))[0]
        e = ulps_close(f"ghost boundary f32 out {tag}", out,
                       G.boundary_fwd_reference(z3, t3, zs, ts, gh),
                       F32_BOUNDARY_ULPS)
        note("ghost_boundary_fwd_f32", [(e, 0.0)])
        fms, fpms, fb = timed(
            "ghost_boundary_fwd_f32",
            lambda: G.boundary_fwd(z3, t3, zs, ts, gh),
            lambda: G.boundary_fwd_reference(z3, t3, zs, ts, gh),
            5 * m * co, 12 * m * co + 16 * nbt * co, PEAK_F32)
        del out

        dout = act(n, co, h, wd, 1e-2)
        got = twice(f"ghost boundary_bwd f32 {tag}",
                    lambda: G.boundary_bwd(dout, z3, t3, zs, ts, gh))
        gm3, sb = G.boundary_bwd_reference(dout, z3, t3, zs, ts, gh)
        exact = G.boundary_bwd_reference(*up(dout, z3, t3, zs, ts), gh)
        check(torch.equal(got[0], gm3), f"ghost boundary_bwd f32 {tag}: gm "
              "differs from the plain version's (dout or 0)")
        eb, qb = note("ghost_boundary_bwd_f32", [
            f32_rule(f"ghost boundary f32 sums {tag}", got[1], sb,
                     exact[1])])
        del got, exact
        bms, bpms, bb = timed(
            "ghost_boundary_bwd_f32",
            lambda: G.boundary_bwd(dout, z3, t3, zs, ts, gh),
            lambda: G.boundary_bwd_reference(dout, z3, t3, zs, ts, gh),
            8 * m * co, 16 * m * co + 28 * nbt * co, PEAK_F32)
        for key, v in (("bnd", fms + bms), ("bndb", fb + bb)):
            step[key] += units * v
        print(f"ghost boundary f32 {tag}: fwd {fms:.4f} ms (plain "
              f"{fpms:.4f}, bound {fb:.4f}), bwd {bms:.4f} ms (plain "
              f"{bpms:.4f}, bound {bb:.4f}); out within {e:.3e} of the "
              f"plain's ({F32_BOUNDARY_ULPS} ulps), gm equal, sums "
              f"x{qb:.2f} the plain's error; bit-equal twice")

        def corr(dab, stats, gb, t):
            c, _ = G.stat_corr(dab, stats, gb, cnt, eps)
            return torch.cat([t[:, :, :1], c], 2).contiguous()

        td3 = corr(sb[:, :, :2], s3, gb3, t3)
        gm2, sb2, _ = conv_bwd(f"conv3 {tag}", z2, t2, gm3, z3, td3, w3, gh)
        td2 = corr(sb2, s2, gb2, t2)
        gm1, sb1, _ = conv_bwd(f"conv2 {tag}", z1, t1, gm2, z2, td2, w2, gh)
        args = (gm2, z2, td2, z1, t1, w2, gh)
        got = twice(f"ghost seam_bwd f32 {tag}", lambda: G.seam_bwd(*args))
        edge, sh = G.seam_bwd_reference(*args)
        exact = G.seam_bwd_reference(*up(gm2, z2, td2, z1, t1, w2), gh)
        e, q = note("ghost_seam_bwd_f32", [
            f32_rule(f"ghost seam f32 edge {tag}", got[0], edge, exact[0]),
            f32_rule(f"ghost seam f32 sums {tag}", got[1], sh, exact[1])])
        del got, exact
        rows = 2 * nbt * wd
        ms, pms, bound = timed(
            "ghost_seam_bwd_f32", lambda: G.seam_bwd(*args),
            lambda: G.seam_bwd_reference(*args), 2 * rows * 3 * db * db,
            rows * db * 16 + 72 * db * db + 8 * nbt * db, PEAK_F32_SPLIT)
        for key, v in (("seam", ms), ("sbound", bound)):
            step[key] += units * v
        sp = G.seam_plan(n, h, wd, db, gh, sms, 4)
        print(f"ghost_seam_bwd_f32 {tag} (resident {int(sp.resident)}, "
              f"{sp.stages} slots): "
              f"kernel {ms:.4f} ms, plain {pms:.4f}, bound {bound:.4f}; max "
              f"abs err against float64 {e:.3e} (x{q:.2f} the plain's); "
              f"{units} a step; bit-equal twice")
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

    # each tdx_f32 instantiation (DX32_INSTANCES) in conv3's forward and
    # backward (to gm) at the first unit shape whose db and co 128 divides,
    # against the plain version, launched twice and bit-equal
    for n, h, wd, ci, db, co, gh in [sh for sh in GHOST_SHAPES
                                     if sh[4] % 128 == 0
                                     and sh[5] % 128 == 0][:1]:
        tag = f"conv3 {db}->{co} at {n}x{h}x{wd} gh {gh}"
        nb = h // gh
        x, w3 = act(n, db, h, wd), weight(co, db, 1)
        tx = torch.stack([torch.empty(n, nb, db).uniform_(0.5, 1.5,
                                                          generator=gen),
                          torch.randn(n, nb, db, generator=gen) * 0.1],
                         2).to(device)
        g, z = act(n, co, h, wd, 1e-2), act(n, co, h, wd)
        td = torch.stack([torch.empty(n, nb, co).uniform_(0.5, 1.5,
                                                          generator=gen),
                          torch.randn(n, nb, co, generator=gen) * 1e-2,
                          torch.randn(n, nb, co, generator=gen) * 1e-3],
                         2).to(device)
        fwant = G.conv_fwd_reference(x, tx, w3, gh)
        fexact = G.conv_fwd_reference(*up(x, tx, w3), gh)
        args = (x, tx, g, z, td, w3, gh, None, None, "gm")
        bwant = G.conv_bwd_reference(*args)
        bexact = G.conv_bwd_reference(*up(x, tx, g, z, td, w3), gh, None,
                                      None, "gm")
        for bns, ovl in DX32_INSTANCES:
            with dx32_choice(bns, ovl):
                pf = CV.tma_staged_fwd_plan(n, h, wd, db, co, 1, sms, gh,
                                            esize=4)
                px = CV.tma_bwd_dx_plan(n, h, wd, db, co, 1, sms, 4, True,
                                        gh, esize=4)
                what = f"tdx_f32 BN {pf.bn} overlap {int(ovl)} {tag}"
                got = twice(f"ghost fwd f32 {what}",
                            lambda: G.conv_fwd(x, tx, w3, gh))
                rf = max(f32_rule(f"ghost fwd f32 {nm} {what}", got[i],
                                  fwant[i], fexact[i])[1]
                         for i, nm in enumerate(("y", "s")))
                got = twice(f"ghost bwd f32 {what}",
                            lambda: G.conv_bwd(*args))
                rb = max(f32_rule(f"ghost bwd f32 {nm} {what}", got[i],
                                  bwant[i], bexact[i])[1]
                         for i, nm in ((0, "gm"), (1, "sums")))
                del got
                print(f"ghost {what}: fwd {dx32_plan(attrs, True, pf)} y/s "
                      f"x{rf:.2f} the plain's error, dX "
                      f"{dx32_plan(attrs, False, px)} gm/sums x{rb:.2f}; "
                      "bit-equal twice")
        del x, g, z, fwant, fexact, bwant, bexact
        torch.cuda.empty_cache()
    print(f"ghost float32 kernels a train step (each call's ms times its "
          f"units in a step): conv_fwd {step['fwd']:.4f} ms (bound "
          f"{step['fbound']:.4f}, conv alone {step['falone']:.4f}), conv_bwd "
          f"{step['bwd']:.4f} ms (bound {step['bbound']:.4f}, conv alone "
          f"{step['balone']:.4f}), seam {step['seam']:.4f} ms (bound "
          f"{step['sbound']:.4f}), boundary fwd + bwd {step['bnd']:.4f} ms "
          f"(bound {step['bndb']:.4f}); the largest error ratio to the "
          f"plain version's by kernel "
          f"{ {k: round(v, 3) for k, v in ratio.items()} }")
    print("ghost float32 kernels: ms, plain_ms and bound_ms in the kernels "
          "line are sums over every call of one unit's chain at each of the "
          f"{len(GHOST_SHAPES)} unit shapes; max_abs_err against float64 "
          "(the boundary's out against the plain version); library_ms null: "
          "no one call computes the function")


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


def ghost_arm_readings(device, start, batch, dtype="bfloat16"):
    """One ghost-arm step on the kernels against one on the plain
    versions, from the state ``start`` and one batch (ghost_readings), in
    bf16 or ``dtype`` (float32: TF32 off in both)."""
    with tf32_off(dtype):
        kernel = arm_grads(device, start, batch, "ghost", dtype)
        with plain_ghost():
            plain = arm_grads(device, start, batch, "ghost", dtype)
    return ghost_readings(kernel, plain)


def tf32_off(dtype):
    """full_f32() for a float32 arm (its plain products in float32, TF32
    off), nothing for a bfloat16 one."""
    from tensorflow_ocr_tpu_torch.ops.fused import full_f32

    return full_f32() if dtype == "float32" else contextlib.nullcontext()


def ghost_arm_bounds(dtype="bfloat16"):
    """(loss rel, gradient rel, cosine min, unit rel) of the ghost arm
    check in ``dtype``."""
    if dtype == "float32":
        return (F32_GHOST_ARM_LOSS_REL, F32_GHOST_ARM_GRAD_REL,
                F32_GHOST_ARM_COS_MIN, F32_GHOST_ARM_UNIT_REL)
    return (GHOST_ARM_LOSS_REL, GHOST_ARM_GRAD_REL, GHOST_ARM_COS_MIN,
            GHOST_ARM_UNIT_REL)


def ghost_arm_passes(r, dtype="bfloat16") -> bool:
    loss, grad, cos, unit = ghost_arm_bounds(dtype)
    return (r["rel_loss"] <= loss and r["grad_rel"] <= grad
            and r["worst"][1] >= cos and r["unit"][1] <= unit)


def print_ghost_arms(label, r, dtype="bfloat16"):
    loss, grad, cos, unit = ghost_arm_bounds(dtype)
    print(f"{label}: loss {r['loss'][0]:.6f} / {r['loss'][1]:.6f} (rel "
          f"{r['rel_loss']:.3e}, tol {loss:g}); gradient norm "
          f"{r['norm'][0]:.6f} / {r['norm'][1]:.6f}, rel err "
          f"{r['grad_rel']:.4e} (tol {grad:g}); worst "
          f"parameter cosine {r['worst'][1]:.6f} at {r['worst'][0]} (min "
          f"{cos:g}); worst ghost-unit parameter rel err "
          f"{r['unit'][1]:.4e} at {r['unit'][0]} (tol {unit:g})")


def ghost_units_of(state):
    """Forward pre-hooks that record the names of the backbone's
    GhostBottlenecks that take the ghost path (pick_gh admits their
    input), and the list they append to."""
    from tensorflow_ocr_tpu_torch.models.resnet import GhostBottleneck

    ghost = []
    hooks = [m.register_forward_pre_hook(
        lambda m, a, name=name: ghost.append(name)
        if m.band_height(a[0].shape) else None)
        for name, m in state.model.backbone.named_children()
        if isinstance(m, GhostBottleneck)]
    return hooks, ghost


def phase_ghost_train(device, reports, snap, batch, arm_start):
    """The ghost arm at full width: 3 steps through Trainer.run, each
    ghost kernel launched GHOST_STEP_LAUNCHES times a step; one step on
    the kernels against one on the plain versions from the state
    ``arm_start`` (GHOST_ARM_* bounds); one freeze_bn step (eval-mode
    ghost units: no kernel)."""
    import numpy as np
    import torch
    from tensorflow_ocr_tpu_torch.ops import ghost as G
    from tensorflow_ocr_tpu_torch.train import trainer as T

    want = {k: TRAIN_STEPS * v for k, v in GHOST_STEP_LAUNCHES.items()}
    trainer = T.Trainer(train_config("ghost"), device)
    state = trainer.setup(weights=snap)
    hooks, ghost = ghost_units_of(state)
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
          f"expected {want['ghost_conv_bwd']} each, no float32 one)")
    check(counts == want, "ghost train: ghost kernel launches")
    check(by_kernel == bf16_by_kernel(want["ghost_conv_bwd"]),
          "ghost train: conv backward launches by kernel")
    for name, n in counts.items():
        reports[name]["launches"] = n
    del trainer, state
    torch.cuda.empty_cache()

    r = ghost_arm_readings(device, arm_start, batch)
    print_ghost_arms("ghost kernels vs plain versions, one step from the "
                     "augmented state", r)
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


def phase_ghost_train_f32(device, reports, snap, batch, arm_start):
    """The ghost arm in float32 (model.compute_dtype "float32",
    bottleneck_impl "ghost"): 3 steps through Trainer.run, every ghost
    kernel launched on its float32 kernel (GHOST_F32_STEP_LAUNCHES a step;
    the backward's tdw_f32 and tdx_f32 17 a step each) and none on a
    bfloat16 one, the ghost units GHOST_UNIT_NAMES; eager img/s over
    ARM_WINDOWS windows of ARM_WINDOW_S and the peak memory; one step on
    the kernels against one on the plain float32 versions (TF32 off) from
    the state ``arm_start`` (F32_GHOST_ARM_* bounds); one float32 freeze_bn
    step (eval-mode ghost units: no kernel)."""
    import numpy as np
    import torch
    from tensorflow_ocr_tpu_torch.ops import ghost as G
    from tensorflow_ocr_tpu_torch.train import trainer as T

    cfg = train_config("ghost", dtype="float32")
    want = {k: TRAIN_STEPS * v for k, v in GHOST_F32_STEP_LAUNCHES.items()}
    base = arm_memory_start()
    trainer = T.Trainer(cfg, device)
    state = trainer.setup(weights=snap)
    hooks, ghost = ghost_units_of(state)
    reset_ghost_counts()
    t0 = time.perf_counter()
    last = trainer.run([batch] * TRAIN_STEPS, TRAIN_STEPS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts, bf = ghost_counts(GHOST_F32_KERNELS), ghost_counts()
    by_kernel = dict(G.conv_bwd.by_kernel)
    for h in hooks:
        h.remove()
    units = sorted(set(ghost))
    n = want["ghost_conv_bwd_f32"]
    print(f"train {TRAIN_STEPS} steps ghost float32 ({run_s:.2f} s, first "
          f"steps included): last metrics "
          f"{json.dumps({k: round(v, 6) for k, v in last.items()})}; "
          f"launches {counts} (expected {want}); backward by kernel "
          f"{by_kernel}; the bfloat16 kernels' {bf}; ghost units "
          f"{', '.join(units)}; {arm_memory(base)}")
    check(units == sorted(GHOST_UNIT_NAMES), "float32 ghost train: the "
          f"ghost units are not {GHOST_UNIT_NAMES}")
    check(state.step == TRAIN_STEPS and last and all(
        np.isfinite(v) for v in last.values()), "float32 ghost train: "
          "non-finite or missing metrics")
    check(counts == want, f"float32 ghost train: launches {counts}")
    check(by_kernel == {"tdw": 0, "tdx": 0, "tdw_f32": n, "tdx_f32": n},
          f"float32 ghost train: backward launches by kernel {by_kernel}")
    check(not any(bf.values()), f"float32 ghost train: a bfloat16 ghost "
          f"kernel launched {bf}")
    for name, k in counts.items():
        reports[name]["launches"] = k
    eager_rate(state, batch, cfg, "ghost float32", ARM_WINDOWS,
               ARM_WINDOW_S, base)
    del trainer, state
    torch.cuda.empty_cache()

    r = ghost_arm_readings(device, arm_start, batch, "float32")
    print_ghost_arms("ghost float32 kernels vs plain float32 versions (TF32 "
                     "off), one step from the augmented state", r, "float32")
    check(r["rel_loss"] <= F32_GHOST_ARM_LOSS_REL, "float32 ghost kernel "
          "and plain losses disagree")
    check(r["grad_rel"] <= F32_GHOST_ARM_GRAD_REL, "float32 ghost kernel "
          "and plain gradients disagree")
    check(r["worst"][1] >= F32_GHOST_ARM_COS_MIN, f"the float32 ghost "
          f"kernels' gradient of {r['worst'][0]} points elsewhere than the "
          "plain one")
    check(r["unit"][1] <= F32_GHOST_ARM_UNIT_REL, f"the float32 ghost "
          f"kernels' gradient of {r['unit'][0]} differs from the plain one")

    fcfg = train_config("ghost", freeze_bn=True, dtype="float32")
    state = T.create_train_state(fcfg, device, weights=snap)
    reset_ghost_counts()
    loss = float(T.train_step(state, batch, fcfg,
                              T.make_loss_fn(fcfg))["total_loss"])
    counts = {**ghost_counts(), **ghost_counts(GHOST_F32_KERNELS)}
    print(f"freeze_bn step ghost float32: total loss {loss:.6f}, ghost "
          f"kernel launches {counts}")
    check(np.isfinite(loss), "float32 ghost freeze_bn step: non-finite loss")
    check(not any(counts.values()), "float32 ghost freeze_bn step launched "
          "a ghost kernel (eval-mode units have none)")
    del state
    torch.cuda.empty_cache()


def phase_ghost_faults(device, start, batch, where, dtype="bfloat16"):
    """The readings that set the GHOST_ARM_* bounds (F32_GHOST_ARM_* with
    ``dtype`` "float32"): the ghost arm on the kernels against the plain
    versions from the state ``start`` (the augmented one, or a trained
    checkpoint's), 3 sound runs, then one run under each fault planted in
    the kernel arm: the seam terms dropped, the 3x3's halo rows under their
    own band's affine (one SAME conv over one act1 tensor), dW2 x 0.9."""
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
    where = f"{where}{' float32' * (dtype == 'float32')}"
    for i in range(3):
        print_ghost_arms(f"ghost faults {where}: sound run {i}",
                         ghost_arm_readings(device, start, batch, dtype),
                         dtype)
    for label, attr, fn in (("seam terms dropped", "seam_bwd", no_seam),
                            ("halo rows under their own band's affine",
                             "conv_fwd", own_band_halo),
                            ("dW2 x 0.9", "conv_bwd", dw2_scaled)):
        orig = getattr(G, attr)
        setattr(G, attr, fn)
        try:
            with tf32_off(dtype):
                kernel = arm_grads(device, start, batch, "ghost", dtype)
        finally:
            setattr(G, attr, orig)
        with plain_ghost(), tf32_off(dtype):
            plain = arm_grads(device, start, batch, "ghost", dtype)
        r = ghost_readings(kernel, plain)
        print_ghost_arms(f"ghost faults {where}: {label}", r, dtype)
        print(f"ghost faults {where}: {label}: passes the arm check "
              f"{ghost_arm_passes(r, dtype)}")


# ------------------------------------ graph dispatch, checkpoints, serving

# a dataset of numpy scenes on the card, labels precomputed there
# (trainer.device_dataset), and the rows of one multi-step dispatch
DATASET_SCENES = 64
MULTI_STEPS = 4
# the arms of the graph = eager check: (label, bottleneck_impl, route)
GRAPH_ARMS = (("fused", "fused", False), ("ghost", "ghost", False),
              ("xla", "xla", False), ("xla pallas-conv", "xla", True))
# the bottlenecks of bench.py's frozen arm checked (and timed by
# scripts/trainer_probe.py --loss-dtype): its own ("xla") and the fused
FROZEN_IMPLS = ("xla", "fused")
# the arms of the graph dispatch speed: (label, impl, freeze_bn, route)
TIMING_ARMS = (("fused", "fused", False, False), ("xla", "xla", False, False),
               ("freeze_bn fused", "fused", True, False),
               ("xla pallas-conv", "xla", False, True),
               ("ghost", "ghost", False, False))
# the resume check's steps: run whole, or split in two at RESUME_AT
RESUME_STEPS, RESUME_AT = 4, 2
# the steps of the checkpoint the --faults arm readings start from
TRAINED_STEPS = 50


def scratch_dir(prefix: str) -> str:
    """A fresh directory under the port's gitignored build directory, for
    checkpoints that a phase writes and removes."""
    import tempfile
    from tensorflow_ocr_tpu_torch.ops.kernels import BUILD_DIR

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return tempfile.mkdtemp(prefix=prefix, dir=BUILD_DIR)


@contextlib.contextmanager
def deterministic(warn_only=False):
    """torch.use_deterministic_algorithms and cuDNN's benchmark off inside
    the block: the library calls of the xla arms (cuDNN convs) take their
    deterministic algorithms, so two runs of a step can be bit-equal.
    ``warn_only``: an op with no deterministic form warns instead of
    raising (phase 34: the calibration sweep's decode, which reads the
    state and writes none of it)."""
    import torch

    bench = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=warn_only)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.benchmark = bench


def arm_counts(impl, route, f32=False):
    """{kernel: launches} of the hand-written kernels of an arm (the fused
    arm's float32 kernels with ``f32``)."""
    if route:
        return conv_counts()
    if impl == "fused" and f32:
        return fused_counts(FUSED_F32_KERNELS)
    if impl == "ghost" and f32:
        return ghost_counts(GHOST_F32_KERNELS)
    return {"fused": fused_counts, "ghost": ghost_counts}.get(
        impl, dict)()


def reset_arm_counts():
    reset_conv_counts()
    reset_fused_counts()
    reset_ghost_counts()


def scene_dataset(device):
    """DATASET_SCENES numpy scenes (train_batch's) at TRAIN_SIZE on the
    card, with their label maps precomputed there."""
    import numpy as np
    from tensorflow_ocr_tpu_torch.train import trainer as T

    batch = train_batch(np.random.RandomState(21), device, DATASET_SCENES,
                        TRAIN_SIZE)
    ds = T.device_dataset(batch, train_config("fused"), device)
    check(float(ds["score"].sum()) > 0, "dataset: no text pixels")
    return ds


def dispatch_rows(rng, steps, device):
    """(steps, TRAIN_BATCH) dataset rows: each run of the dataset a fresh
    permutation, as data/device_cache.py index_batches draws them."""
    import numpy as np
    import torch

    need = steps * TRAIN_BATCH
    perm = np.concatenate([rng.permutation(DATASET_SCENES)
                           for _ in range(-(-need // DATASET_SCENES))])
    return torch.from_numpy(perm[:need].reshape(steps, TRAIN_BATCH)).to(
        device)


def leaves(state):
    from tensorflow_ocr_tpu_torch.train import trainer as T

    return T.flat_tree(T.state_tensors(state))


def unequal(a, b):
    """Names of the tensors of two state (or metric) mappings that are not
    bit-equal."""
    import torch

    return [k for k in a if not torch.equal(a[k], b[k])]


def eager_dispatch(state, ds, idx, cfg):
    """make_multi_train_step's steps run eagerly: the metrics of the last,
    total_loss with the L2 value after them."""
    from tensorflow_ocr_tpu_torch.train import optim, trainer as T

    loss_fn = T.make_loss_fn(cfg)
    keys = T.BATCH_KEYS + T.label_keys(cfg)
    for row in idx:
        m = T.train_step(state, {k: ds[k][row] for k in keys}, cfg, loss_fn,
                         include_l2=False)
    m = dict(m)
    m["total_loss"] = m["total_loss"] + optim.l2_regularization(
        state.model, cfg.model.weight_decay)
    return m


def phase_graph_step(device, snap, ds):
    """multi-step = eager (graph_equal) for each of GRAPH_ARMS, the
    float32 arms and bench.py's frozen arms with the bfloat16 OHEM loss
    (FROZEN_IMPLS), from ``snap`` on the dataset ``ds``; the fused arm
    also restores a checkpoint under the captured graph."""
    import numpy as np

    rng = np.random.RandomState(31)
    for label, impl, route in GRAPH_ARMS:
        graph_equal(device, snap, ds, rng, label, train_config(impl), route,
                    restore=impl == "fused")
    graph_equal(device, snap, ds, rng, "xla pallas-conv float32",
                train_config("xla", dtype="float32"), True)
    graph_equal(device, snap, ds, rng, "fused float32",
                train_config("fused", dtype="float32"))
    graph_equal(device, snap, ds, rng, "ghost float32",
                train_config("ghost", dtype="float32"))
    # bench.py's frozen arm (value_freeze_bn_finetune) as it is, xla, and
    # on the fused kernels with ds = None
    t0 = time.perf_counter()
    for impl in FROZEN_IMPLS:
        graph_equal(device, snap, ds, rng, f"freeze_bn {impl} bf16-loss",
                    train_config(impl, True, loss_dtype="bfloat16"))
    print(f"graph step, bench.py's frozen arms: "
          f"{time.perf_counter() - t0:.1f} s")


def graph_equal(device, snap, ds, rng, label, cfg, route=False,
                restore=False):
    """One make_multi_train_step dispatch of MULTI_STEPS steps (a CUDA
    graph replayed) against as many eager train_step calls from the state
    ``snap`` and the same rows of ``ds``, under deterministic():
    parameters, BN buffers, Adam moments, EMA, step and the last metrics
    bit-equal. The arm's kernels are launched at the capture (warm-up and
    captured step) and not at the replays: a second dispatch on the same
    graph launches none, and equals the eager steps again. With
    ``restore``: a checkpoint saved between the two dispatches and
    restored into the captured state in place, then the second dispatch
    replayed once more, gives the same state."""
    import shutil

    import numpy as np
    import torch
    from tensorflow_ocr_tpu_torch.train import trainer as T

    cuda = device.type == "cuda"
    impl = cfg.model.bottleneck_impl
    f32 = cfg.model.compute_dtype == "float32"
    with pallas_convs(route), deterministic():
        a = T.create_train_state(cfg, device, weights=snap)
        b = T.create_train_state(cfg, device, weights=snap)
        multi = T.make_multi_train_step(a, cfg, T.label_keys(cfg))
        idx = dispatch_rows(rng, MULTI_STEPS, device)
        reset_arm_counts()
        t0 = time.perf_counter()
        got = multi(a, ds, idx)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        captured = arm_counts(impl, route, f32)
        want = eager_dispatch(b, ds, idx, cfg)
        diff = unequal(leaves(a), leaves(b)) + unequal(got, want)
        print(f"graph step {label}: one dispatch of {MULTI_STEPS} steps "
              f"(capture with {T.WARMUP_STEPS} warm-up steps included) "
              f"{first_s:.3f} s; kernel launches at the capture "
              f"{captured}; last metrics total_loss "
              f"{float(got['total_loss']):.6f}; tensors not bit-equal "
              f"to {MULTI_STEPS} eager steps: {len(diff)} {diff[:4]}")
        check(not diff, f"graph step {label}: the dispatch differs from "
              f"the eager steps at {diff[:4]}")
        check(int(a.step) == MULTI_STEPS, f"graph step {label}: step")
        check(np.isfinite(float(got["total_loss"])),
              f"graph step {label}: non-finite loss")
        if impl != "xla" or route:
            # the capture runs the warm-up steps and records one (a CPU
            # rehearsal runs the dispatch's steps eagerly)
            n = T.WARMUP_STEPS + 1 if cuda else MULTI_STEPS
            per_step = {k: v // n for k, v in captured.items()}
            check(all(captured.values()) and all(
                v == per_step[k] * n for k, v in captured.items()),
                  f"graph step {label}: kernels at the capture")
            if impl == "fused":
                check(per_step["fused_conv_bwd" + "_f32" * f32]
                      == FUSED_CONV_STEP_LAUNCHES,
                      f"graph step {label}: fused launches a step")
            if route:
                check(per_step == CONV_STEP_LAUNCHES,
                      f"graph step {label}: conv launches a step")
            if impl == "ghost":
                check(per_step == (GHOST_F32_STEP_LAUNCHES if f32
                                   else GHOST_STEP_LAUNCHES),
                      f"graph step {label}: ghost launches a step")
        ckpt = None
        if restore:
            root = scratch_dir("graph_ckpt_")
            ckpt = T.save_checkpoint(root, a)
        idx2 = dispatch_rows(rng, MULTI_STEPS, device)
        reset_arm_counts()
        got = multi(a, ds, idx2)
        replayed = arm_counts(impl, route, f32)
        want = eager_dispatch(b, ds, idx2, cfg)
        diff = unequal(leaves(a), leaves(b)) + unequal(got, want)
        print(f"graph step {label}: a second dispatch (replays only): "
              f"kernel launches {replayed}; tensors not bit-equal: "
              f"{len(diff)} {diff[:4]}")
        check(not (cuda and any(replayed.values())) and not diff,
              f"graph step {label}: the second dispatch")
        if ckpt is not None:
            end = {k: v.clone() for k, v in leaves(a).items()}
            T.restore_checkpoint(ckpt, a)
            check(int(a.step) == MULTI_STEPS, "restore: step")
            again = multi(a, ds, idx2)
            diff = unequal(leaves(a), end) + unequal(again, got)
            print(f"graph step {label}: checkpoint at step "
                  f"{MULTI_STEPS} restored into the captured state, the "
                  f"second dispatch replayed again: tensors not "
                  f"bit-equal {len(diff)}; captures "
                  f"{getattr(multi.graph, 'captures', 1)}")
            check(not diff and getattr(multi.graph, "captures", 1) == 1,
                  "graph step: restore under the captured graph")
            shutil.rmtree(root)
    multi.release()
    del a, b, multi
    torch.cuda.empty_cache()


class RowBatches:
    """A data iterator over a list of batches that saves and restores its
    position (the get_state/set_state protocol of restore_data_iter)."""

    def __init__(self, batches, on_next=None):
        self.batches, self.i, self.on_next = batches, 0, on_next

    def __next__(self):
        if self.on_next is not None:
            self.on_next(self.i)
        self.i += 1
        return self.batches[self.i - 1]

    def get_state(self) -> bytes:
        return str(self.i).encode()

    def set_state(self, state: bytes) -> None:
        self.i = int(state)


def phase_resume(device, start, ds):
    """Resume = uninterrupted on the fused arm: RESUME_STEPS steps through
    Trainer.run against RESUME_AT steps, save_checkpoint(block=False), a
    fresh Trainer with restore=True and the remaining steps, under
    deterministic(): every state tensor bit-equal; the resumed run saves
    on the step cadence with max_checkpoints_to_keep 1, so one ckpt_*
    remains. Then a SIGTERM sent to the process in the middle of run:
    the loop saves a checkpoint and stops. Returns (checkpoint root, the
    state_dict it serves: EMA parameters and BN buffers)."""
    import shutil
    import signal

    import numpy as np
    import torch
    from tensorflow_ocr_tpu_torch.train import trainer as T

    keys = T.BATCH_KEYS + T.LABEL_KEYS
    rows = dispatch_rows(np.random.RandomState(41), RESUME_STEPS, device)
    batches = [{k: ds[k][r] for k in keys} for r in rows]
    root = scratch_dir("resume_")
    cfg = train_config("fused")
    cfg.train.checkpoint_path = root
    cfg.train.save_checkpoint_steps = 0
    with deterministic():
        whole = T.Trainer(cfg, device)
        whole.setup(weights=start)
        whole.run(RowBatches(batches), RESUME_STEPS)
        want = {k: v.clone() for k, v in leaves(whole.state).items()}
        del whole
        torch.cuda.empty_cache()

        first = T.Trainer(cfg, device)
        first.setup(weights=start)
        it = RowBatches(batches)
        first.run(it, RESUME_AT)
        t0 = time.perf_counter()
        ck = T.save_checkpoint(root, first.state, it, block=False,
                               max_to_keep=1)
        snap_s = time.perf_counter() - t0  # the copy to the host
        T.wait_for_pending_save()
        write_s = time.perf_counter() - t0 - snap_s
        del first

        cfg.train.restore = True
        cfg.train.save_checkpoint_steps = 1
        cfg.train.max_checkpoints_to_keep = 1
        resumed = T.Trainer(cfg, device)
        resumed.setup()
        t0 = time.perf_counter()
        T.restore_checkpoint(ck, resumed.state)  # again: the same state
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        mb = os.path.getsize(os.path.join(ck, T.CKPT_FILE)) / 2**20
        print(f"checkpoint of {MODEL}: {mb:.1f} MiB; save_checkpoint("
              f"block=False) returned after {snap_s:.3f} s (the copy to the "
              f"host), the write took {write_s:.3f} s more; restore_checkpoint"
              f" {restore_s:.3f} s")
        it = RowBatches(batches)
        resumed.run(it, RESUME_STEPS - RESUME_AT)
        diff = unequal(want, leaves(resumed.state))
    kept = sorted(d for d in os.listdir(root) if d.startswith("ckpt_"))
    print(f"resume fused: {RESUME_AT} steps, save_checkpoint(block=False), a "
          f"fresh Trainer(restore=True) from batch {RESUME_AT} (the data "
          f"iterator's state) and {RESUME_STEPS - RESUME_AT} more steps, "
          f"against {RESUME_STEPS} steps whole: tensors not bit-equal "
          f"{len(diff)} of {len(want)} {diff[:4]}; checkpoints kept {kept}")
    check(not diff, f"resume differs from the uninterrupted run at "
          f"{diff[:4]}")
    check(it.i == RESUME_STEPS and int(resumed.state.step) == RESUME_STEPS,
          "resume: the data iterator or the step did not resume")
    check(kept == [f"ckpt_{RESUME_STEPS}"], "resume: max_to_keep 1")
    state = resumed.state
    served = {k: v.detach().cpu().clone()
              for k, v in state.model.state_dict().items()}
    served.update({k: v.detach().cpu().clone() for k, v in state.ema.items()})
    del resumed, state
    torch.cuda.empty_cache()

    # SIGTERM in the middle of run: a checkpoint, then a clean stop
    term_root = scratch_dir("preempt_")
    cfg = train_config("fused")
    cfg.train.checkpoint_path = term_root
    cfg.train.save_checkpoint_steps = 0
    prev = signal.getsignal(signal.SIGTERM)
    try:
        trainer = T.Trainer(cfg, device, install_signal_handler=True)
        trainer.setup(weights=start)

        def kill_at(i):
            if i == 1:
                os.kill(os.getpid(), signal.SIGTERM)

        trainer.run(RowBatches(batches, kill_at), RESUME_STEPS)
    finally:
        signal.signal(signal.SIGTERM, prev)
    step = int(trainer.state.step)
    ck = T.latest_checkpoint(term_root)
    print(f"SIGTERM before step 1 of {RESUME_STEPS}: stopped after {step} "
          f"steps, checkpoint {os.path.basename(ck or 'none')}")
    check(step == 2 and ck is not None and ck.endswith("ckpt_2"),
          "SIGTERM: no checkpoint, or the loop did not stop")
    shutil.rmtree(term_root)
    del trainer
    torch.cuda.empty_cache()
    return root, served


def serving_start(device, snap, images):
    """``snap`` with the two *_logits convs scaled to unit logit spread on
    ``images`` (random weights saturate the softmax; phase_main_path does
    the same), so that a checkpoint trained from it decodes components."""
    import torch
    from tensorflow_ocr_tpu_torch.infer import Predictor

    pred = Predictor(MODEL, weights=snap, device=device)
    with torch.inference_mode():
        out = pred.model(torch.from_numpy(images).to(device))
    start = dict(snap)
    for tag in ("pixel", "link"):
        spread = float(out[f"{tag}_logits"].std())
        for leaf in ("weight", "bias"):
            key = f"head.{tag}_logits.{leaf}"
            start[key] = snap[key] / spread
    del pred
    return start


def phase_serve_checkpoint(device, root, served, images):
    """Serve from the checkpoint: Predictor(checkpoint_path=root) detects on
    8 x 1280x768 uint8 images with the CC kernel launched, and its boxes
    equal those of a Predictor given the same EMA parameters and BN
    buffers as a state_dict at the same thresholds; a planted
    operating_point.json moves the thresholds."""
    import shutil

    import numpy as np
    import torch
    from tensorflow_ocr_tpu_torch.config import InferConfig
    from tensorflow_ocr_tpu_torch.infer import (
        OPERATING_POINT_FILE,
        Predictor,
        pixel_link_scores,
    )
    from tensorflow_ocr_tpu_torch.ops import kernels as K

    plain = Predictor(MODEL, checkpoint_path=root, device=device)
    check(not plain.calibrated and plain.pixel_thresh == InferConfig()
          .pixel_conf_threshold, "serve: thresholds without an operating "
          "point")
    with torch.inference_mode():
        ps, ls = pixel_link_scores(plain.model(
            torch.from_numpy(images).to(device)))
    op = {"pixel": float(torch.quantile(ps.float().flatten()[::7], 0.8)),
          "link": float(torch.quantile(ls.float().flatten()[::7], 0.3))}
    with open(os.path.join(root, OPERATING_POINT_FILE), "w") as f:
        json.dump(op, f)
    del plain
    pred = Predictor(MODEL, checkpoint_path=root, device=device)
    check(pred.calibrated and (pred.pixel_thresh, pred.link_thresh)
          == (op["pixel"], op["link"]), "serve: the planted operating point "
          "did not move the thresholds")
    K.connected_components.launches = 0
    boxes = pred.detect_batch(images)
    torch.cuda.synchronize()
    launches = K.connected_components.launches
    ref = Predictor(MODEL, weights=served, device=device, infer=InferConfig(
        pixel_conf_threshold=op["pixel"], link_conf_threshold=op["link"]))
    want = ref.detect_batch(images)
    n = [len(b) for b in boxes]
    print(f"serve from {os.path.basename(root)}/ckpt_{RESUME_STEPS} (EMA): "
          f"operating point {op}; boxes per image {n}, CC launches "
          f"{launches}; against the state_dict Predictor: "
          f"{[len(b) for b in want]}")
    check(launches > 0, "serve from the checkpoint: no CC launch")
    check(sum(n) > 0, "serve from the checkpoint: no boxes")
    check(all(len(g) == len(w) and all(np.array_equal(x, y)
                                       for x, y in zip(g, w))
              for g, w in zip(boxes, want)),
          "serve from the checkpoint: boxes differ from the state_dict's")
    del pred, ref
    torch.cuda.empty_cache()
    shutil.rmtree(root)


def phase_graph_timing(snap, ds, profile_arms=False, arms=TIMING_ARMS,
                       loss_dtype="float32"):
    """Train img/s through make_multi_train_step at 512^2, batch 32, S =
    scan_steps (16) steps a dispatch, for ``arms`` (TIMING_ARMS) from
    ``snap`` with the OHEM loss in ``loss_dtype`` (graph_rate over
    GRAPH_WINDOWS windows of at least ARM_WINDOW_S). With
    ``profile_arms``, the device idle share of one dispatch of the fused
    and ghost arms under torch.profiler."""
    import numpy as np
    import torch
    from tensorflow_ocr_tpu_torch.train import trainer as T

    rng = np.random.RandomState(51)
    for arm, impl, freeze, route in arms:
        cfg = train_config(impl, freeze, loss_dtype=loss_dtype)
        base = arm_memory_start()
        with pallas_convs(route):
            state = T.create_train_state(cfg, ds["images"].device,
                                         weights=snap)
            graph_rate(state, ds, cfg, rng, arm, GRAPH_WINDOWS,
                       ARM_WINDOW_S, base,
                       profile_arms and arm in ("fused", "ghost"))
        del state
        torch.cuda.empty_cache()


def trained_start(device, snap, ds):
    """The model tensors (parameters, BN buffers) of a port checkpoint
    trained TRAINED_STEPS fused steps (one graph dispatch) on the numpy
    scenes from ``snap``."""
    import shutil

    import numpy as np
    import torch
    from tensorflow_ocr_tpu_torch.train import trainer as T

    cfg = train_config("fused")
    state = T.create_train_state(cfg, device, weights=snap)
    multi = T.make_multi_train_step(state, cfg, T.LABEL_KEYS)
    m = multi(state, ds, dispatch_rows(np.random.RandomState(61),
                                       TRAINED_STEPS, device))
    root = scratch_dir("trained_")
    ck = T.save_checkpoint(root, state)
    print(f"trained start: {TRAINED_STEPS} fused steps from the seeded "
          f"state, last model loss {float(m['model_loss']):.6f}; checkpoint "
          f"{ck}")
    multi.release()
    del state, multi
    torch.cuda.empty_cache()
    start = dict(T.load_checkpoint(ck)["model"])
    shutil.rmtree(root)
    return start


def phase_fused_faults(device, start, batch, label, dtype="bfloat16"):
    """The fused arm against the xla arm from ``start``: 3 sound runs, then
    one run under each fault planted in the fused backward: dW x 0.9, dX
    x 0.9, the boundary's dz x 0.9. In float32 both arms in float32 (TF32
    off), read against the F32_FUSED_ARM_* bounds."""
    from tensorflow_ocr_tpu_torch.ops import fused as FU

    f32 = dtype == "float32"

    def readings():
        if f32:
            return fused_f32_readings(device, start, batch)
        return fused_readings(arm_grads(device, start, batch, "fused"),
                              arm_grads(device, start, batch, "xla"))

    def show(name, r):
        try:
            (check_f32_fused_arm if f32 else check_arms)(r)
            verdict = "passes the arm check"
        except RuntimeError as e:
            verdict = f"fails the arm check ({e})"
        if f32:
            print(f"fused faults {label} float32: {name}: "
                  f"{f32_fused_text(r)}: {verdict}")
            return
        print(f"fused faults {label}: {name}: loss rel {r['rel_loss']:.3e} "
              f"(tol {ARM_LOSS_REL:g}); grad rel err {r['grad_rel']:.4e} "
              f"(tol {ARM_GRAD_REL:g}); worst cosine {r['worst'][1]:.6f} at "
              f"{r['worst'][0]} (min {ARM_COS_MIN:g}); {unit_text(r)}: "
              f"{verdict}")

    for i in range(3):
        show(f"sound run {i}", readings())
    cb, bb = FU.conv_bwd, FU.boundary_bwd

    def dw_scaled(*a):
        dx, dab, dw = cb(*a)
        return dx, dab, dw * 0.9

    def dx_scaled(*a):
        dx, dab, dw = cb(*a)
        return dx * 0.9, dab, dw

    def dz_scaled(*a):
        dz, dab, dzs, dabs = bb(*a)
        return dz * 0.9, dab, dzs, dabs

    for name, attr, fn in (("dW x 0.9", "conv_bwd", dw_scaled),
                           ("dX x 0.9", "conv_bwd", dx_scaled),
                           ("boundary dz x 0.9", "boundary_bwd", dz_scaled)):
        fn.launches, fn.by_kernel = 0, {}
        orig = getattr(FU, attr)
        setattr(FU, attr, fn)
        try:
            show(name, readings())
        finally:
            setattr(FU, attr, orig)


# ------------------------------------------ the other heads and families


def east_config(impl="fused", loss="east", geometry="RBOX"):
    """The EAST train configuration: EAST_MODEL, ``loss`` (the EAST loss
    by default), ``geometry``, 512^2, batch TRAIN_BATCH, bf16."""
    return train_config(impl, model=EAST_MODEL, loss=loss, geometry=geometry)


def finite_step(state, batch, cfg, label):
    """One train_step of ``cfg``: (model loss, fused kernel launches);
    fails where the loss or a parameter's gradient is not finite."""
    import numpy as np
    import torch
    from tensorflow_ocr_tpu_torch.train import trainer as T

    reset_fused_counts()
    m = T.train_step(state, batch, cfg, T.make_loss_fn(cfg))
    torch.cuda.synchronize()
    counts = fused_counts()
    loss = float(m["model_loss"])
    bad = [n for n, p in state.model.named_parameters()
           if p.grad is None or not bool(torch.isfinite(p.grad).all())]
    print(f"{label}: one step, model loss {loss:.6f}, metrics "
          f"{json.dumps({k: round(float(v), 5) for k, v in m.items()})}; "
          f"fused kernel launches {counts}; parameters without a finite "
          f"gradient {len(bad)} {bad[:3]}")
    check(np.isfinite(loss) and not bad, f"{label}: non-finite loss or "
          "gradient")
    return loss, counts


def eager_rate(state, batch, cfg, label, windows, window_s, base=None):
    """Eager train img/s of ``cfg``'s train_step on one device-resident
    batch over ``windows`` windows of at least ``window_s`` (each ending in
    a sync), printed with the median and range (and the peak memory since
    arm_memory_start's ``base``); returns the last step's metrics."""
    import torch
    from tensorflow_ocr_tpu_torch.train import trainer as T

    loss_fn = T.make_loss_fn(cfg)
    rates = []
    for i in range(windows):
        steps, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < window_s:
            last = T.train_step(state, batch, cfg, loss_fn)
            steps += 1
            if steps % 4 == 0:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rates.append(steps * batch["images"].shape[0] / dt)
        print(f"train {label} window {i}: {rates[-1]:.2f} img/s ({steps} "
              f"steps in {dt:.3f} s)")
    print(f"train {label} {TRAIN_SIZE}^2 batch {batch['images'].shape[0]}: "
          f"{statistics.median(rates):.2f} img/s (median of {windows} "
          f"windows of >= {window_s:g} s; windows {min(rates):.2f}.."
          f"{max(rates):.2f})"
          + ("" if base is None else f"; {arm_memory(base)}"))
    return last


def graph_rate(state, ds, cfg, rng, label, windows, window_s, base=None,
               profile_run=False, dispatches=None):
    """Train img/s of ``state`` through make_multi_train_step (scan_steps
    steps a dispatch): the first dispatch (with the capture) untimed, then
    ``windows`` windows of at least ``window_s`` of dispatches (each ending
    in a sync), or of ``dispatches`` dispatches each where it is given,
    printed with the median, range and the peak memory since ``base``;
    with ``profile_run`` the device idle share of one more
    dispatch under torch.profiler. The graph is released; the state,
    trained in place, stays."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from tensorflow_ocr_tpu_torch.train import trainer as T

    device = ds["images"].device
    steps = cfg.train.scan_steps
    multi = T.make_multi_train_step(state, cfg, T.label_keys(cfg))
    idxs = [dispatch_rows(rng, steps, device) for _ in range(4)]
    t0 = time.perf_counter()
    multi(state, ds, idxs[0])
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    rates = []
    for i in range(windows):
        n, t0 = 0, time.perf_counter()
        while (n < dispatches if dispatches
               else time.perf_counter() - t0 < window_s):
            last = multi(state, ds, idxs[n % len(idxs)])
            n += 1
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rates.append(n * steps * TRAIN_BATCH / dt)
        print(f"graph train {label} window {i}: {rates[-1]:.2f} img/s ({n} "
              f"dispatches of {steps} steps in {dt:.3f} s)")
    check(np.isfinite(float(last["total_loss"])),
          f"graph train {label}: non-finite loss")
    span = (f"{dispatches} dispatches" if dispatches
            else f">= {window_s:g} s")
    print(f"graph train {label} {TRAIN_SIZE}^2 batch {TRAIN_BATCH}, {steps} "
          f"steps a dispatch: {statistics.median(rates):.2f} img/s (median "
          f"of {windows} windows of {span}; windows "
          f"{min(rates):.2f}..{max(rates):.2f})"
          f"; first dispatch with the capture {first:.3f} s; last model "
          f"loss {float(last['model_loss']):.6f} at step {int(state.step)}"
          + ("" if base is None else f"; {arm_memory(base)}"))
    if profile_run:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            multi(state, ds, idxs[0])
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1000
        busy = device_busy_ms(prof)
        check(busy > 0, "graph profile: no device events")
        print(f"profile graph train {label}, one dispatch of {steps} steps: "
              f"wall {wall:.3f} ms, device busy {busy:.3f} ms, idle share "
              f"{1 - busy / wall:.3f}")
    multi.release()
    del multi
    torch.cuda.empty_cache()


def phase_east_train(device):
    """The slice's main path: east_resnet50 RBOX with the EAST loss, the
    fused arm, 512^2, batch 32, labels made on the card from the polygons
    and their EAST geometry. 2 warm-up steps (the loss at step 0 is the
    first's), every fused kernel launched (the backward's tdw and tdx 43 a
    step), then TRAIN_WINDOWS windows of eager img/s on the same batch;
    the loss after them must be finite and below step 0's. Then on a
    dataset of DATASET_SCENES scenes with the EAST maps precomputed on the
    card: a 4-step graph dispatch bit-equal to 4 eager steps
    (graph_equal), and graph img/s from the seeded state over
    TRAIN_WINDOWS windows of EAST_GRAPH_DISPATCHES dispatches, whose
    trained state (EAST_SERVE_STEPS steps) is saved as a port checkpoint.
    Returns (seeded state_dict, batch, checkpoint root)."""
    import copy

    import numpy as np
    import torch
    from tensorflow_ocr_tpu_torch.ops import fused as FU
    from tensorflow_ocr_tpu_torch.train import trainer as T

    cfg = east_config()
    batch = train_batch(np.random.RandomState(71), device, TRAIN_BATCH,
                        TRAIN_SIZE)
    base = arm_memory_start()
    state = T.create_train_state(cfg, device,
                                 generator=torch.Generator().manual_seed(13))
    snap = copy.deepcopy(state.model.state_dict())
    loss_fn = T.make_loss_fn(cfg)
    reset_fused_counts()
    m0 = T.train_step(state, batch, cfg, loss_fn)
    T.train_step(state, batch, cfg, loss_fn)
    torch.cuda.synchronize()
    counts, by_kernel = fused_counts(), dict(FU.conv_bwd.by_kernel)
    loss0 = float(m0["model_loss"])
    print(f"east fused: 2 warm-up steps, step 0 metrics "
          f"{json.dumps({k: round(float(v), 5) for k, v in m0.items()})}; "
          f"kernel launches {counts}; fused_conv_bwd by kernel {by_kernel}")
    check(all(counts.values()), "east train: a fused kernel was not "
          "launched")
    check(by_kernel == bf16_by_kernel(2 * FUSED_CONV_STEP_LAUNCHES),
          "east train: backward launches by kernel")
    last = eager_rate(state, batch, cfg, "east fused", TRAIN_WINDOWS,
                      TRAIN_WINDOW_S, base)
    lossn = float(last["model_loss"])
    print(f"east fused eager: model loss {loss0:.6f} at step 0, {lossn:.6f} "
          f"after {int(state.step)} steps on the same batch (cls "
          f"{float(last['cls_loss']):.6f}, geo {float(last['geo_loss']):.6f})")
    check(np.isfinite(lossn) and lossn < loss0, "east train: the loss did "
          "not fall on a fixed batch")
    del state
    torch.cuda.empty_cache()

    rng = np.random.RandomState(73)
    ds = T.device_dataset(train_batch(np.random.RandomState(75), device,
                                      DATASET_SCENES, TRAIN_SIZE), cfg,
                          device)
    check(float(ds["score"].sum()) > 0 and ds["geo"].shape[-1] == 5,
          "east dataset: no text pixels, or not RBOX maps")
    graph_equal(device, snap, ds, rng, "east fused", cfg, restore=True)
    base = arm_memory_start()
    state = T.create_train_state(cfg, device, weights=snap)
    graph_rate(state, ds, cfg, rng, "east fused", TRAIN_WINDOWS,
               TRAIN_WINDOW_S, base, dispatches=EAST_GRAPH_DISPATCHES)
    check(int(state.step) == EAST_SERVE_STEPS, "east train: the serving "
          "checkpoint's step count")
    root = scratch_dir("east_")
    ck = T.save_checkpoint(root, state)
    print(f"east checkpoint {os.path.basename(ck)} for serving")
    del state, ds
    torch.cuda.empty_cache()
    return snap, batch, root


def phase_east_route(device, snap, batch):
    """The PALLAS_CONVS route on east_resnet50: one xla-arm train step
    with the route on, each conv kernel launched as often as the route's
    convs of the step give (route_shape_counts: a forward and a dX of
    each, a dW of each); and detect at 8 x 1280x768 with the route on,
    every routed conv of the forward on conv_fwd.cu, the score and
    geometry within CONV_DETECT_REL of the cuDNN forward's."""
    import numpy as np
    import torch
    from tensorflow_ocr_tpu_torch.infer import Predictor
    from tensorflow_ocr_tpu_torch.train import trainer as T

    want = route_launches(TRAIN_BATCH, (TRAIN_SIZE, TRAIN_SIZE), EAST_MODEL)
    cfg = east_config("xla")
    with pallas_convs(True):
        state = T.create_train_state(cfg, device, weights=snap)
        reset_conv_counts()
        loss = float(T.train_step(state, batch, cfg,
                                  T.make_loss_fn(cfg))["model_loss"])
        torch.cuda.synchronize()
        counts = conv_counts()
        by_kernel = conv_counts((*FWD_STEP_KERNELS, *DW_STEP_KERNELS))
    print(f"east xla step with PALLAS_CONVS: model loss {loss:.6f}; conv "
          f"kernel launches {counts} (expected {want}; by kernel "
          f"{by_kernel})")
    check(np.isfinite(loss), "east route step: non-finite loss")
    check(counts == want, "east route step: conv kernel launches")
    del state
    torch.cuda.empty_cache()

    expected = route_launches(8, IMAGE_HW, EAST_MODEL, train=False)
    pred = Predictor(EAST_MODEL, weights=snap, device=device)
    images = train_batch(np.random.RandomState(77), device, 8, TRAIN_SIZE,
                         hw=IMAGE_HW)["images"]
    with torch.inference_mode():
        want = pred.model(images)
        with pallas_convs(True):
            reset_conv_counts()
            got = pred.model(images)
            torch.cuda.synchronize()
            counts = conv_counts()
            fwd = conv_counts(FWD_STEP_KERNELS)
    print(f"east detect forward 8x1280x768 with PALLAS_CONVS: conv kernel "
          f"launches {counts} (by kernel {fwd}; expected {expected})")
    # (on the CPU the wrappers take their plain versions: no tma_fwd)
    on_card = device.type == "cuda"
    check(counts == expected
          and fwd["tma_fwd"] == sum(expected.values()) * on_card,
          "east detect with the route: conv launches")
    for key in ("score", "geometry"):
        g, w = got[key], want[key]
        check(g.shape == w.shape and bool(torch.isfinite(g).all()),
              f"east {key}: shape {tuple(g.shape)} or non-finite")
        rel = float((g - w).abs().max() / w.abs().max())
        print(f"east detect with PALLAS_CONVS {key}: max|routed-cudnn|/"
              f"max|cudnn| = {rel:.3e} (tol {EAST_DETECT_REL:g})")
        check(rel <= EAST_DETECT_REL, f"east {key}: routed and cuDNN "
              "outputs disagree")
    del pred
    torch.cuda.empty_cache()


def phase_east_variants(device, snap, batch):
    """One fused-arm step each of east_resnet50 with the focal loss
    (preset #4's) and with QUAD geometry (its own head, seeded): finite
    loss and gradients, the fused kernels launched."""
    import torch
    from tensorflow_ocr_tpu_torch.train import trainer as T

    cfg = east_config(loss="focal")
    state = T.create_train_state(cfg, device, weights=snap)
    _, counts = finite_step(state, batch, cfg, "east fused focal")
    check(all(counts.values()), "east focal: a fused kernel not launched")
    del state
    cfg = east_config(geometry="QUAD")
    state = T.create_train_state(cfg, device,
                                 generator=torch.Generator().manual_seed(14))
    _, counts = finite_step(state, batch, cfg, "east fused QUAD")
    check(all(counts.values()), "east QUAD: a fused kernel not launched")
    del state
    torch.cuda.empty_cache()


def phase_east_serve(device, root):
    """EAST detect and serve from the checkpoint phase_east_train saved:
    Predictor(checkpoint_path=root) (EMA parameters) on 8 x 1280x768
    scenes. Where fewer than 64 pixels an image pass the default score
    threshold, a planted operating_point.json sets the score threshold at
    the maps' 0.98 quantile and the NMS IoU (both adopted). The boxes of
    detect_batch must equal those of east_detect run on the CPU on the
    same maps, then the same NMS; the candidates, the boxes NMS keeps and
    its host ms are printed; then detect p50 at batch 1 and serve img/s
    at batch 8 over EAST_WINDOWS windows of at least WINDOW_S."""

    import numpy as np
    import torch
    from tensorflow_ocr_tpu_torch.config import InferConfig
    from tensorflow_ocr_tpu_torch.infer import OPERATING_POINT_FILE, Predictor
    from tensorflow_ocr_tpu_torch.ops import decode as D
    from tensorflow_ocr_tpu_torch.train.trainer import latest_checkpoint

    images = train_batch(np.random.RandomState(79), device, 8, TRAIN_SIZE,
                         hw=IMAGE_HW)["images"].cpu().numpy()
    pred = Predictor(EAST_MODEL, checkpoint_path=root, device=device)
    x = torch.from_numpy(images).to(device)
    with torch.inference_mode():
        score = pred.model(x)["score"][..., 0]
    passing = int((score > pred.score_thresh).sum())
    print(f"east serve: {passing} pixels of 8 images above the default "
          f"score threshold {pred.score_thresh:g}")
    if passing < 64 * len(images):
        op = {"score": float(torch.quantile(score.float().flatten()[::7],
                                            0.98)),
              "nms": InferConfig().nms_thresh + 0.05}
        with open(os.path.join(root, OPERATING_POINT_FILE), "w") as f:
            json.dump(op, f)
        del pred
        pred = Predictor(EAST_MODEL, checkpoint_path=root, device=device)
        check(pred.calibrated and (pred.score_thresh, pred.nms_thresh)
              == (op["score"], op["nms"]), "east serve: the planted "
              "operating point did not move the thresholds")
        print(f"east serve: planted operating point {op}")
    with torch.inference_mode():
        out = pred.model(x)
    got = [t.cpu() for t in D.east_detect(out["score"][..., 0],
                                          out["geometry"],
                                          pred.score_thresh)]
    ref = D.east_detect(out["score"][..., 0].cpu(), out["geometry"].cpu(),
                        pred.score_thresh)
    check(torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2]),
          "east_detect on the card: candidates or scores differ from the "
          "CPU's")
    qerr = float((got[0] - ref[0]).abs().max())
    check(qerr <= 1e-2, f"east_detect on the card: quads {qerr:.3e} from "
          "the CPU's")
    boxes = pred.detect_batch(images)
    nms_ms = pred.nms_ms
    want = pred._east_boxes(*(t.numpy() for t in ref))
    cand = [int(v.sum()) for v in got[2]]
    n = [len(b) for b in boxes]
    print(f"east serve from {os.path.basename(latest_checkpoint(root))}: "
          f"candidates per image {cand} (of {got[2].shape[1]}), boxes NMS "
          f"kept above "
          f"box_thresh {n}, host NMS {nms_ms:.3f} ms for the batch; quads "
          f"on the card within {qerr:.3e} of the CPU's")
    check(sum(n) > 0, "east serve: no boxes")
    check(all(np.isfinite(b).all() and b.shape == (4, 2)
              for bs in boxes for b in bs), "east serve: malformed boxes")
    check(all(len(g) == len(w) and all(np.allclose(a, b, atol=1e-2)
                                       for a, b in zip(g, w))
              for g, w in zip(boxes, want)),
          "east serve: boxes differ from the CPU decode's")
    time_detect_serve(pred, images, WINDOW_S, "east ", EAST_WINDOWS)
    del pred
    torch.cuda.empty_cache()


def phase_vgg(device, report):
    """pixellink2s_vgg16 (OHEM, preset #3) at 512^2, batch 32, labels on
    the stride-2 grid (256^2): 2 steps, then eager train img/s over
    TRAIN_WINDOWS windows of at least ARM_WINDOW_S and the step's peak
    memory; detect on 8 x 1280x768 scenes through the CC kernel, whose
    labels at the stride-2 maps (8, 384, 640) equal the plain version's
    (launched twice, bit-equal); detect and serve timed over windows of
    PIXELLINK_WINDOW_S."""
    import numpy as np
    import torch
    from tensorflow_ocr_tpu_torch.infer import Predictor
    from tensorflow_ocr_tpu_torch.ops import kernels as K
    from tensorflow_ocr_tpu_torch.train import trainer as T

    cfg = train_config("xla", model=VGG_MODEL)
    batch = train_batch(np.random.RandomState(81), device, TRAIN_BATCH,
                        TRAIN_SIZE)
    base = arm_memory_start()
    state = T.create_train_state(cfg, device,
                                 generator=torch.Generator().manual_seed(15))
    loss0, _ = finite_step(state, batch, cfg, f"{VGG_MODEL} ohem")
    score = T.make_labels_fn(cfg)(batch)[0]
    check(tuple(score.shape[1:3]) == (TRAIN_SIZE // 2, TRAIN_SIZE // 2),
          f"{VGG_MODEL}: labels not on the stride-2 grid")
    last = eager_rate(state, batch, cfg, VGG_MODEL, TRAIN_WINDOWS,
                      ARM_WINDOW_S, base)
    print(f"{VGG_MODEL}: labels {tuple(score.shape)}, model loss "
          f"{loss0:.6f} at step 0, {float(last['model_loss']):.6f} at step "
          f"{int(state.step)}")
    del state
    torch.cuda.empty_cache()

    images = train_batch(np.random.RandomState(83), device, 8, TRAIN_SIZE,
                         hw=IMAGE_HW)["images"].cpu().numpy()
    pred = Predictor(VGG_MODEL, device=device)
    head_logit_scale(pred, torch.from_numpy(images).to(device),
                     ("pixel_logits", "link_logits"))
    launches, edges, mask = decode_check(pred, images, VGG_MODEL)
    check(tuple(mask.shape) == (8, IMAGE_HW[0] // 2, IMAGE_HW[1] // 2),
          f"{VGG_MODEL}: maps not at stride 2")
    got = K.connected_components(edges, mask)
    again = K.connected_components(edges, mask)
    want = K.connected_components_reference(edges, mask)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    check(torch.equal(got, again) and torch.equal(got, want),
          f"cc at {tuple(mask.shape)}: kernel labels differ (max abs diff "
          f"{err})")
    ms = cuda_ms(lambda: K.connected_components(edges, mask), 20)
    plain_ms = cuda_ms(
        lambda: K.connected_components_reference(edges, mask), 3)
    bound = 1e3 * mask.numel() * (8 + 1 + 4) / PEAK_HBM
    print(f"cc at the stride-2 maps {tuple(mask.shape)}: equal to the plain "
          f"version, launched twice and equal; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound:.4f} ms (bytes)")
    report["max_abs_err"] = max(report["max_abs_err"], err)
    time_detect_serve(pred, images, PIXELLINK_WINDOW_S, f"{VGG_MODEL} ")
    del pred
    torch.cuda.empty_cache()


def phase_link8(device, batch):
    """link8_resnet50: one fused-arm dice step (finite loss and
    gradients), and detect on 8 x 1280x768 scenes through pixel_link_scores'
    link8 schema and the CC kernel (decode_check)."""
    import numpy as np
    import torch
    from tensorflow_ocr_tpu_torch.infer import Predictor
    from tensorflow_ocr_tpu_torch.train import trainer as T

    cfg = train_config("fused", model=LINK8_MODEL, loss="dice")
    state = T.create_train_state(cfg, device,
                                 generator=torch.Generator().manual_seed(16))
    _, counts = finite_step(state, batch, cfg, f"{LINK8_MODEL} fused dice")
    check(all(counts.values()), "link8: a fused kernel not launched")
    del state
    torch.cuda.empty_cache()
    images = train_batch(np.random.RandomState(85), device, 8, TRAIN_SIZE,
                         hw=IMAGE_HW)["images"].cpu().numpy()
    pred = Predictor(LINK8_MODEL, device=device)
    head_logit_scale(pred, torch.from_numpy(images).to(device),
                     ("score", "links"))
    decode_check(pred, images, LINK8_MODEL)
    del pred
    torch.cuda.empty_cache()


def phase_pixellink_losses(device, snap, batch, ds):
    """pixellink_resnet50 on the fused arm with the dice, positive and
    focal losses: one step each (finite loss and gradients, the backward
    launched FUSED_CONV_STEP_LAUNCHES times); then with dice one graph
    dispatch bit-equal to eager steps (graph_equal)."""
    import numpy as np
    from tensorflow_ocr_tpu_torch.train import trainer as T

    for loss in ("dice", "positive", "focal"):
        cfg = train_config("fused", loss=loss)
        state = T.create_train_state(cfg, device, weights=snap)
        _, counts = finite_step(state, batch, cfg, f"{MODEL} fused {loss}")
        check(all(counts.values()) and counts["fused_conv_bwd"]
              == FUSED_CONV_STEP_LAUNCHES, f"{loss}: fused launches")
        del state
    graph_equal(device, snap, ds, np.random.RandomState(87), "fused dice",
                train_config("fused", loss="dice"))


def phase_other_forwards(device):
    """One detect_batch each of east_vgg16, pixellink_vgg16 (through the CC
    kernel) and east_tiny on 2 x 1280x768 scenes: outputs of the expected
    shapes, finite."""
    import numpy as np
    import torch
    from tensorflow_ocr_tpu_torch.infer import Predictor, pixel_link_scores
    from tensorflow_ocr_tpu_torch.ops import kernels as K

    images = train_batch(np.random.RandomState(89), device, 2, TRAIN_SIZE,
                         hw=IMAGE_HW)["images"].cpu().numpy()
    x = torch.from_numpy(images).to(device)
    for name in ("east_vgg16", "pixellink_vgg16", "east_tiny"):
        pred = Predictor(name, device=device)
        with torch.inference_mode():
            out = pred.model(x)
        shapes = {k: tuple(v.shape) for k, v in out.items()}
        check(all(bool(torch.isfinite(v).all()) for v in out.values())
              and all(s[1:3] == (IMAGE_HW[0] // 4, IMAGE_HW[1] // 4)
                      for s in shapes.values()), f"{name}: outputs {shapes}")
        if name == "pixellink_vgg16":
            ps, _ = pixel_link_scores(out)
            pred.pixel_thresh = float(torch.quantile(ps.float().flatten(),
                                                     0.8))
        K.connected_components.launches = 0
        boxes = pred.detect_batch(images)
        torch.cuda.synchronize()
        print(f"{name} forward 2x1280x768: outputs {shapes}; boxes per image "
              f"{[len(b) for b in boxes]}; cc launches "
              f"{K.connected_components.launches}")
        if name == "pixellink_vgg16":
            check(K.connected_components.launches > 0,
                  f"{name}: detect did not launch the CC kernel")
        del pred
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# the data tier: the synthetic dataset, the decoder, run_device_cached with
# and without augmentation, host ingest with resume, detect on read images
# --------------------------------------------------------------------------

DATA_HW = (720, 1280)        # bench.py:266's make_synthetic_dataset size
DATA_IMAGES = 16             # of each tier: the default and "v2"
DATA_MAX_POLYS = 16
DATA_SCAN = 16               # steps a dispatch; two dispatches a run
HOST_STEPS, HOST_SAVE_AT = 6, 3  # host ingest: a checkpoint at step 3
FIXTURE = "tests/data/nvjpeg_fixture.jpg"
FIXTURE_CV2 = "tests/data/nvjpeg_fixture_cv2.npy"
# nvJPEG's decode of the fixture against cv2's (libjpeg-turbo): levels.
# Read 16 at most and 1.6074 on average on an H100 (PERF.md §6): their
# chroma upsampling and colour conversion round apart; the fixture and
# both decoders are fixed, so the reading repeats
DECODE_MAX_LEVELS = 16
DECODE_MEAN_LEVELS = 1.7
# the warp on the card against the CPU's (the port's warp against JAX's
# on the CPU reads 1.007e-3 at most: tests/test_torch_device_augment.py)
WARP_ATOL = 2e-3


def data_config(path, augment=False):
    """train_config("fused") reading the dataset at ``path``: batch 32,
    DATA_MAX_POLYS slots, DATA_SCAN steps a dispatch; with ``augment``
    JAX's random scale, crop and rotation on."""
    cfg = train_config("fused")
    cfg.data.training_data_path = path
    cfg.data.batch_size = TRAIN_BATCH
    cfg.data.max_polys = DATA_MAX_POLYS
    cfg.data.num_workers = 8
    cfg.data.max_queue_size = 2  # batches the host loader reads ahead
    cfg.train.scan_steps = DATA_SCAN
    cfg.train.save_checkpoint_steps = 0
    if augment:
        cfg.data.use_crop = cfg.data.use_rotate = True
        cfg.data.use_random_scale = True
    return cfg


def phase_data_write():
    """The dataset of bench.py:266 (16 default images at 720x1280) and 16
    "v2" images, written by the port's make_synthetic_dataset."""
    from tensorflow_ocr_tpu_torch.data.icdar import make_synthetic_dataset

    root = scratch_dir("data_")
    t0 = time.perf_counter()
    make_synthetic_dataset(root, DATA_IMAGES, DATA_HW)
    t1 = time.perf_counter()
    v2 = make_synthetic_dataset(root, DATA_IMAGES, DATA_HW, hard="v2",
                                start_index=DATA_IMAGES)
    t2 = time.perf_counter()
    print(f"data: make_synthetic_dataset wrote {DATA_IMAGES} default and "
          f"{DATA_IMAGES} v2 images at {DATA_HW[1]}x{DATA_HW[0]} (PIL JPEG "
          f"q95 on the host) in {t1 - t0:.3f} s and {t2 - t1:.3f} s")
    return root, v2


def phase_data_decode(device, files):
    """nvJPEG's decode of the committed fixture against its committed cv2
    decode (levels), the card's resize against codec.resize (equal), and
    the decode-and-resize img/s of ``files``."""
    import numpy as np
    import torch
    from tensorflow_ocr_tpu_torch.data import codec
    from tensorflow_ocr_tpu_torch.data import nvjpeg_loader as NJ

    want = np.load(os.path.join(REPO, FIXTURE_CV2))[:, :, ::-1]  # RGB
    h, w = want.shape[:2]
    got, ok, hw = NJ.load_batch([os.path.join(REPO, FIXTURE)], w, h, device)
    d = np.abs(got[0].cpu().numpy().astype(int) - want)
    print(f"data: nvJPEG decode of {FIXTURE} ({w}x{h}) against cv2's: max "
          f"{int(d.max())} levels, mean {d.mean():.4f}, pixels off "
          f"{float((d.max(-1) > 0).mean()):.4f}")
    check(bool(ok[0]) and tuple(hw[0]) == (h, w), "decode: the fixture")
    check(d.max() <= DECODE_MAX_LEVELS and d.mean() <= DECODE_MEAN_LEVELS,
          "decode: nvJPEG differs from cv2 beyond the stated levels")
    full, ok, _ = NJ.load_batch(files[:1], DATA_HW[1], DATA_HW[0], device)
    small = torch.empty((TRAIN_SIZE, TRAIN_SIZE, 3), dtype=torch.uint8,
                        device=device)
    NJ.resize_on_card(full[0].contiguous(), small)
    host = codec.resize(full[0].cpu().numpy(), (TRAIN_SIZE, TRAIN_SIZE))
    check(bool(ok[0]) and np.array_equal(small.cpu().numpy(), host),
          "decode: the card's resize differs from codec.resize")
    # an upscale whose height grows: cv2's vertical border taps
    src = full[0][:150, :200].contiguous()
    big = torch.empty((720, 1280, 3), dtype=torch.uint8, device=device)
    NJ.resize_on_card(src, big)
    check(np.array_equal(big.cpu().numpy(),
                         codec.resize(src.cpu().numpy(), (1280, 720))),
          "decode: the card's upscale differs from codec.resize")
    rates = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, ok, _ = NJ.load_batch(files, TRAIN_SIZE, TRAIN_SIZE, device)
        torch.cuda.synchronize()
        rates.append(len(files) / (time.perf_counter() - t0))
    check(bool(ok.all()), "decode: a synthetic frame was refused")
    print(f"data: nvJPEG decode + resize to {TRAIN_SIZE}^2 of {len(files)} "
          f"frames {DATA_HW[1]}x{DATA_HW[0]}: "
          f"{statistics.median(rates):.2f} img/s (median of 3: "
          f"{', '.join(f'{r:.2f}' for r in rates)}); the card's resize = "
          f"codec.resize on the host, bit for bit")
    phase_data_mixed(device)


def phase_data_cached(device, root, augment):
    """Trainer.run_device_cached for two dispatches of DATA_SCAN steps on
    the dataset at ``root`` (staged by nvJPEG; with ``augment`` the
    augmentation and the labels inside the captured step): finite losses,
    the fused kernels launched at the capture (its warm-up steps and the
    captured one: the replays do not pass through the wrappers' counts),
    images_per_sec_steady. Returns (steady img/s, checkpoint root)."""
    import math

    import torch
    from tensorflow_ocr_tpu_torch.train import trainer as T

    cfg = data_config(root, augment)
    ck_root = scratch_dir("data_ckpt_")
    cfg.train.checkpoint_path = ck_root
    cfg.train.save_checkpoint_steps = 2 * DATA_SCAN
    # the rate is the train loop's: phases 33-34 read the calibration
    cfg.train.calibrate_at_checkpoint = False
    trainer = T.Trainer(cfg, device)
    trainer.setup(generator=torch.Generator().manual_seed(12))
    reset_fused_counts()
    t0 = time.perf_counter()
    last = trainer.run_device_cached(2 * DATA_SCAN)
    wall = time.perf_counter() - t0
    counts = fused_counts()
    label = "augment on" if augment else "augment off"
    steady = last.get("images_per_sec_steady", float("nan"))
    print(f"data: run_device_cached {label}: {2 * DATA_SCAN} steps of batch "
          f"{TRAIN_BATCH} in {wall:.3f} s (staging and capture included); "
          f"images_per_sec_steady {steady:.2f}; last total_loss "
          f"{last['total_loss']:.6f}; fused launches {counts}")
    n = T.WARMUP_STEPS + 1
    check(all(math.isfinite(v) for v in last.values()),
          f"run_device_cached {label}: a metric is not finite")
    check(counts["fused_conv_bwd"] == n * FUSED_CONV_STEP_LAUNCHES
          and all(counts.values()),
          f"run_device_cached {label}: fused launches at the capture")
    check(int(trainer.state.step) == 2 * DATA_SCAN,
          f"run_device_cached {label}: step")
    del trainer
    torch.cuda.empty_cache()
    return steady, ck_root


def phase_data_augment_checks(device, root, snap):
    """With augmentation: DATA_SCAN graph steps against as many eager
    augmented steps from ``snap`` under deterministic() (every state
    tensor and the metrics bit-equal); the draws on the card equal the
    CPU's for the same (seed, step); the warp on the card within
    WARP_ATOL of the CPU's on the same frames."""
    import dataclasses

    import numpy as np
    import torch
    from tensorflow_ocr_tpu_torch.data import device_augment as DA
    from tensorflow_ocr_tpu_torch.data.device_cache import DeviceDataset
    from tensorflow_ocr_tpu_torch.train import optim, trainer as T

    cfg = data_config(root, augment=True)
    stage = dataclasses.replace(cfg.data, use_crop=False, use_rotate=False,
                                use_random_scale=False)
    ds = DeviceDataset(stage, device=device)
    data = ds.arrays()
    idx = torch.from_numpy(ds.index_batches(
        TRAIN_BATCH, DATA_SCAN, np.random.RandomState(5))).to(device)
    with deterministic():
        a = T.create_train_state(cfg, device, weights=snap)
        b = T.create_train_state(cfg, device, weights=snap)
        multi = T.make_multi_train_step(a, cfg, augment=True)
        got = multi(a, data, idx)
        loss_fn = T.make_loss_fn(cfg)
        for row in idx:
            key = DA.step_key(cfg.train.seed, b.step)
            batch = DA.augment_batch(key, {k: data[k][row]
                                           for k in T.BATCH_KEYS},
                                     cfg.data, False)
            want = T.train_step(b, batch, cfg, loss_fn, include_l2=False)
        want = dict(want)
        want["total_loss"] = want["total_loss"] + optim.l2_regularization(
            b.model, cfg.model.weight_decay)
        diff = unequal(leaves(a), leaves(b)) + unequal(got, want)
    print(f"data: {DATA_SCAN} augmented graph steps against {DATA_SCAN} "
          f"eager ones: tensors not bit-equal {len(diff)} {diff[:4]}; "
          f"total_loss {float(got['total_loss']):.6f}")
    check(not diff, f"augmented graph != eager at {diff[:4]}")
    multi.release()
    del a, b, multi
    torch.cuda.empty_cache()

    worst = 0
    for step in (0, 1, 17, 1000):
        p_gpu = DA.sample_similarity_params(DA.step_key(
            cfg.train.seed, torch.tensor(step, device=device)), TRAIN_BATCH,
            cfg.data)
        p_cpu = DA.sample_similarity_params(DA.step_key(
            cfg.train.seed, torch.tensor(step)), TRAIN_BATCH, cfg.data)
        check(all(torch.equal(p_gpu[k].cpu(), p_cpu[k]) for k in p_cpu),
              f"augment draws at step {step}: card != CPU")
        _, t, minv = DA.similarity_matrices(p_cpu, TRAIN_SIZE)
        k = min(4, TRAIN_BATCH)
        frames = data["images"][:k]
        w_gpu = DA.warp_images(frames, minv[:k].to(device), t[:k].to(device))
        w_cpu = DA.warp_images(frames.cpu(), minv[:k], t[:k])
        worst = max(worst, float((w_gpu.cpu() - w_cpu).abs().max()))
    print(f"data: augment draws on the card = the CPU's at 4 steps; warp "
          f"card vs CPU max abs {worst:.3e} (tolerance {WARP_ATOL})")
    check(worst <= WARP_ATOL, "warp: the card differs from the CPU")
    del ds, data
    torch.cuda.empty_cache()


class RecordingBatches:
    """A data iterator that records what it hands out (file names, images,
    the time of each request) and passes the resume protocol through to
    the iterator it wraps."""

    def __init__(self, it):
        self.it, self.seen, self.stamps = it, [], []

    def __next__(self):
        self.stamps.append(time.perf_counter())
        batch = next(self.it)
        self.seen.append((list(batch["fns"]), batch["images"].cpu().numpy()))
        return batch

    def get_state(self):
        return self.it.get_state()

    def set_state(self, state):
        self.it.set_state(state)


def host_chain(cfg, device):
    """ResumableLoader -> PrefetchLoader -> DevicePrefetcher."""
    from tensorflow_ocr_tpu_torch.data.pipeline import (DevicePrefetcher,
                                                        PrefetchLoader)
    from tensorflow_ocr_tpu_torch.data.resumable import ResumableLoader

    src = ResumableLoader(cfg.data, seed=cfg.train.seed)
    return DevicePrefetcher(PrefetchLoader(cfg.data, source=src), device)


def phase_data_host(device, root, snap):
    """Trainer.run over ResumableLoader -> PrefetchLoader ->
    DevicePrefetcher with the host's crop and rotation on: HOST_STEPS
    steps, a checkpoint after batch HOST_SAVE_AT; a fresh trainer and
    loader chain restored from it take the next batches, which must be
    the uninterrupted stream's, image for image. Also the host's cost of a
    sample with random scale on as well. Returns (img/s, ckpt root)."""
    import numpy as np
    import torch
    from tensorflow_ocr_tpu_torch.data import icdar
    from tensorflow_ocr_tpu_torch.data.resumable import ResumableLoader
    from tensorflow_ocr_tpu_torch.train import trainer as T

    cfg = data_config(root)
    cfg.data.use_crop = cfg.data.use_rotate = True
    ck_root = scratch_dir("host_ckpt_")
    cfg.train.checkpoint_path = ck_root
    cfg.train.save_checkpoint_steps = HOST_SAVE_AT
    # the rate is the host chain's: phases 33-34 read the calibration
    cfg.train.calibrate_at_checkpoint = False
    trainer = T.Trainer(cfg, device)
    trainer.setup(weights=snap)
    chain = host_chain(cfg, device)
    it = RecordingBatches(chain)
    try:
        trainer.run(it, HOST_STEPS)  # each step's metrics read: a sync
    finally:
        chain.stop()
    # from the request of batch 1 to that of the last: steps 1 .. n-2
    stamps = it.stamps
    rate = (len(stamps) - 2) * TRAIN_BATCH / (stamps[-1] - stamps[1])
    ck = T.latest_checkpoint(ck_root)
    print(f"data: host ingest (crop + rotate on the host, 8 loader threads) "
          f"-> Trainer.run: {rate:.2f} img/s over steps 1-{HOST_STEPS - 2}; "
          f"checkpoint {os.path.basename(ck)}")
    check(ck is not None and ck.endswith(f"ckpt_{HOST_SAVE_AT + 1}"),
          "host ingest: the mid-epoch checkpoint")
    del trainer
    torch.cuda.empty_cache()

    cfg.train.restore = True
    cfg.train.checkpoint_path = ck_root
    cfg.train.save_checkpoint_steps = 0
    resumed = T.Trainer(cfg, device)
    resumed.setup()
    chain = host_chain(cfg, device)
    it2 = RecordingBatches(chain)
    try:
        resumed.run(it2, 2)
    finally:
        chain.stop()
    want = it.seen[HOST_SAVE_AT + 1:HOST_SAVE_AT + 3]
    same = (len(it2.seen) == 2 and all(
        a[0] == b[0] and np.array_equal(a[1], b[1])
        for a, b in zip(it2.seen, want)))
    print(f"data: resumed from {os.path.basename(ck)}: the next 2 batches "
          f"equal the uninterrupted run's image for image: {same}; step "
          f"{int(resumed.state.step)}")
    check(same and int(resumed.state.step) == HOST_SAVE_AT + 3,
          "host ingest: the resumed batches differ")
    del resumed
    torch.cuda.empty_cache()

    full = data_config(root, augment=True)
    src = ResumableLoader(full.data, seed=1)
    t0 = time.perf_counter()
    for g in range(8):
        src._sample(g)
    src.stop()
    print(f"data: host prepare_sample with random scale, crop and rotation "
          f"at {DATA_HW[1]}x{DATA_HW[0]}: "
          f"{(time.perf_counter() - t0) / 8 * 1e3:.1f} ms a sample (one "
          f"thread); decode cache {len(icdar._DECODE_CACHE)} frames")
    return rate, ck_root


def phase_data_detect(device, ck_root, v2_files):
    """Predictor(checkpoint_path=...) from the checkpoint of the augmented
    state (AUG_TRAINED_STEPS steps on this dataset) on 8 v2 images read by
    the port's reader (codec.imread, cut to multiples of 32 by
    resize_image): decode_check with a box on every image."""
    import numpy as np
    import torch
    from tensorflow_ocr_tpu_torch.data import codec
    from tensorflow_ocr_tpu_torch.infer import Predictor
    from tensorflow_ocr_tpu_torch.train import trainer as T
    from tensorflow_ocr_tpu_torch.utils.image import resize_image

    images = np.stack([resize_image(codec.imread(f)[:, :, ::-1])[0]
                       for f in v2_files[:8]])
    pred = Predictor(MODEL, checkpoint_path=ck_root, device=device)
    ck = os.path.basename(T.latest_checkpoint(ck_root))
    decode_check(pred, images, f"data: from {ck} on v2 images read by "
                 "codec.imread,", every_image=True)
    del pred
    torch.cuda.empty_cache()


# the state the arm gates are read from (phases 11, 13, 16): trained on
# phase 32's dataset with augmentation (ROADMAP.md Queue 3 #1): steps and
# learning rate
AUG_TRAINED_STEPS = 768
AUG_TRAINED_LR = 1e-3


def residual_scales(weights) -> str:
    """The spread of the residual branches' last BN scales (conv3.bn)."""
    import torch

    v = torch.cat([t.detach().float().flatten().cpu()
                   for k, t in weights.items()
                   if k.endswith("conv3.bn.weight")])
    q = torch.quantile(v, torch.tensor([0.05, 0.5, 0.95]))
    return (f"min {float(v.min()):.4f}, 5% {float(q[0]):.4f}, median "
            f"{float(q[1]):.4f}, 95% {float(q[2]):.4f}, max "
            f"{float(v.max()):.4f}, std {float(v.std()):.4f}")


def seeded_snap(device):
    """The model tensors of the seeded fused-arm state phase_train starts
    from (generator seed 11)."""
    import torch
    from tensorflow_ocr_tpu_torch.train import trainer as T

    state = T.create_train_state(train_config("fused"), device,
                                 generator=torch.Generator().manual_seed(11))
    snap = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    del state
    torch.cuda.empty_cache()
    return snap


def augmented_start(device, root, snap):
    """The model tensors after AUG_TRAINED_STEPS fused steps of
    run_device_cached with augmentation on the dataset at ``root`` (the
    v2 and default tiers), from ``snap``, at AUG_TRAINED_LR, and the root
    of the checkpoint saved there (phase 32's detect); prints the
    residual BN scales' spread before and after."""
    import torch
    from tensorflow_ocr_tpu_torch.train import trainer as T

    cfg = data_config(root, augment=True)
    cfg.train.learning_rate = AUG_TRAINED_LR
    trainer = T.Trainer(cfg, device)
    trainer.setup(weights=snap)
    t0 = time.perf_counter()
    last = trainer.run_device_cached(AUG_TRAINED_STEPS)
    start = {k: v.detach().clone()
             for k, v in trainer.state.model.state_dict().items()}
    ck_root = scratch_dir("aug_ckpt_")
    T.save_checkpoint(ck_root, trainer.state)
    print(f"augmented start: {AUG_TRAINED_STEPS} augmented fused steps at "
          f"lr {AUG_TRAINED_LR:g} in {time.perf_counter() - t0:.1f} s, last "
          f"model loss {last['model_loss']:.6f}; residual BN scales before: "
          f"{residual_scales(snap)}; after: {residual_scales(start)}")
    del trainer
    torch.cuda.empty_cache()
    return start, ck_root


# The CPU budget of tests/test_torch_bf16.py (a) for pixellink_resnet50:
# the port's bf16 eval forward within 1.5x JAX's own bf16 error against
# the float32 truth, which reads there (over the largest logit) mean
# |err| 1.080e-3 (pixel logits) and 1.909e-3 (link logits), the pixel
# logits' mean signed error -9.11e-5 (budget 1.5x that + 1e-4), the mean
# pixel probability 2.0e-4 (budget 1.5x that + 1e-4). On the card the
# port's bf16 forward (cuDNN's bf16 kernels) against its f32 one, from
# the augmented state, must stay within BF16_CARD_MULTIPLE times these.
BF16_CARD_MULTIPLE = 3.0
BF16_MEAN_REL = {"pixel_logits": 1.5 * 1.080e-3,
                 "link_logits": 1.5 * 1.909e-3}
BF16_SIGNED_REL = 1.5 * 9.11e-5 + 1e-4
BF16_PROB = 1.5 * 2.0e-4 + 1e-4
BF16_FRAMES = 8


def phase_bf16_forward(device, start, v2):
    """Phase 10c: the eval forward of ``start`` (the augmented state) in
    bfloat16 against float32 (TF32 off) on BF16_FRAMES of the v2 frames
    read by the codec at TRAIN_SIZE, per output (the held-out F gap's
    "less confident" maps would show as a negative signed error and a
    lower mean pixel probability)."""
    import numpy as np
    import torch
    from tensorflow_ocr_tpu_torch.data import codec
    from tensorflow_ocr_tpu_torch.models import build_model
    from tensorflow_ocr_tpu_torch.ops.fused import full_f32

    t0 = time.perf_counter()
    x = torch.from_numpy(np.stack([
        codec.resize(codec.imread(f), (TRAIN_SIZE, TRAIN_SIZE))[:, :, ::-1]
        for f in v2[:BF16_FRAMES]])).to(device)
    outs = {}
    for dtype in (torch.bfloat16, torch.float32):
        model = build_model(MODEL, dtype=dtype).to(device).eval()
        model.load_state_dict(start)
        with torch.no_grad(), (full_f32() if dtype == torch.float32
                               else contextlib.nullcontext()):
            outs[dtype] = {k: v.float() for k, v in model(x).items()}
        del model
    lo, hi = outs[torch.bfloat16], outs[torch.float32]
    m = BF16_CARD_MULTIPLE
    for key, budget in BF16_MEAN_REL.items():
        d = lo[key] - hi[key]
        scale = float(hi[key].abs().max())
        mean, top = float(d.abs().mean()) / scale, float(d.abs().max()) / scale
        print(f"bf16: {key} against f32 over the largest logit "
              f"{scale:.4f}: mean |d| {mean:.4e} (budget {m * budget:.4e}), "
              f"max {top:.4e}, mean signed {float(d.mean()) / scale:.4e}")
        check(mean <= m * budget, f"bf16: {key}'s mean error on the card")
    d = lo["pixel_logits"] - hi["pixel_logits"]
    signed = float(d.mean()) / float(hi["pixel_logits"].abs().max())
    probs = [float(torch.softmax(o["pixel_logits"], -1)[..., 1].mean())
             for o in (lo, hi)]
    print(f"bf16: pixel logits' mean signed error {signed:.4e} of the scale "
          f"(budget {m * BF16_SIGNED_REL:.4e}); mean pixel probability bf16 "
          f"{probs[0]:.6f}, f32 {probs[1]:.6f} (budget "
          f"{m * BF16_PROB:.4e}); {time.perf_counter() - t0:.1f} s")
    check(abs(signed) <= m * BF16_SIGNED_REL,
          "bf16: the pixel logits' signed error on the card")
    check(abs(probs[0] - probs[1]) <= m * BF16_PROB,
          "bf16: the mean pixel probability on the card")


def phase_data_mixed(device):
    """A directory of the committed fixture JPEG and a PNG of its pixels,
    each with a gt file, staged on the card by DeviceDataset: the JPEG by
    nvJPEG, the PNG decoded on the host and resized on the card, bit-equal
    to codec.resize of codec.imread; a file with the JPEG magic that
    nvJPEG refuses raises."""
    import numpy as np
    from tensorflow_ocr_tpu_torch.data import codec, icdar
    from tensorflow_ocr_tpu_torch.data import nvjpeg_loader as NJ
    from tensorflow_ocr_tpu_torch.data.device_cache import DeviceDataset

    d = scratch_dir("mixed_")
    jpg, png = os.path.join(d, "img_1.jpg"), os.path.join(d, "img_2.png")
    shutil.copy(os.path.join(REPO, FIXTURE), jpg)
    codec.imwrite(png, codec.imread(jpg))
    for p in (jpg, png):
        with open(icdar.gt_path_for_image(p), "w") as f:
            f.write("20,20,100,20,100,60,20,60,text\n")
    launches, host = NJ.load_batch.launches, NJ.load_batch.host_decoded
    ds = DeviceDataset(data_config(d).data, device=device)
    launches = NJ.load_batch.launches - launches
    host = NJ.load_batch.host_decoded - host
    check(ds.n == 2 and sorted(ds.fns) == [jpg, png],
          f"decode: a JPEG and a PNG staged {ds.n} frames")
    want = codec.resize(codec.imread(png), (TRAIN_SIZE, TRAIN_SIZE))
    same = np.array_equal(ds.images[ds.fns.index(png)].cpu().numpy(),
                          want[:, :, ::-1])
    check(same, "decode: the staged PNG differs from the host decode")
    check(host == 1 and launches == 1,
          f"decode: host decodes {host}, nvJPEG launches {launches}")
    bad = os.path.join(d, "img_3.jpg")
    with open(bad, "wb") as f:
        f.write(b"\xff\xd8" + b"not a jpeg" * 16)
    try:
        NJ.load_batch([bad], 64, 64, device)
        refused = "no error"
    except RuntimeError as e:
        refused = str(e)
    check(refused != "no error", "decode: a JPEG nvJPEG refuses was taken")
    shutil.rmtree(d)
    print(f"data: a JPEG and a PNG staged by DeviceDataset on the card: "
          f"{ds.n} frames, nvJPEG launches {launches}, host decodes {host}, "
          f"the PNG (resized on the card) bit-equal to codec.resize of "
          f"codec.imread; a refused "
          f"JPEG raises: {refused}")


def phase_data(device, snap, root, v2, aug_ck):
    """The data tier on the card (fused arm, 512^2, batch 32, OHEM, bf16)
    over the dataset phase_data_write wrote at ``root`` (``v2`` its v2
    images): the decoder checked, run_device_cached without and with
    augmentation, the augmented graph against eager steps, host ingest
    with a mid-epoch resume, detect on images the port read from the
    augmented state's checkpoint at ``aug_ck``; then calibration on that
    checkpoint (phase 33) and inside the loop (phase 34)."""
    import shutil

    from tensorflow_ocr_tpu_torch.data.icdar import get_images

    t0 = time.perf_counter()

    phase_data_decode(device, v2)
    off, ck_off = phase_data_cached(device, root, augment=False)
    on, ck_on = phase_data_cached(device, root, augment=True)
    shutil.rmtree(ck_off)
    shutil.rmtree(ck_on)
    print(f"data: images_per_sec_steady augment off {off:.2f}, augment on "
          f"{on:.2f} ({len(get_images(root))} images staged)")
    phase_data_augment_checks(device, root, snap)
    _, ck_host = phase_data_host(device, root, snap)
    shutil.rmtree(ck_host)
    phase_data_detect(device, aug_ck, v2)
    print(f"data: the phase took {time.perf_counter() - t0:.1f} s (the "
          f"dataset written before phase 10)")
    t0 = time.perf_counter()
    phase_calibrate(device, root, aug_ck)
    shutil.rmtree(aug_ck)
    phase_calibrate_loop(device, root, snap)
    print(f"calibrate: phases 33-34 took {time.perf_counter() - t0:.1f} s")


# --------------------------------------------------------------------------
# the quality loop and the deeper backbones (phases 33-36)
# --------------------------------------------------------------------------

CALIB_IMAGES = 8          # calibrate_max_images's default
CALIB_EPS = 0.015         # _plateau_pick's eps: the pick is within it
LOOP_DISPATCHES = 3       # run_device_cached dispatches, a save after each
# the EAST sweep is its host NMS, ~17-19 s an image on an H100 from the
# 448-step state (the time phase 35 prints), so 2 images
EAST_CALIB_IMAGES = 2
# graph steps phase 35 trains the serving state on before it calibrates:
# at 448 steps no box reaches IoU 0.5 on its own train scenes, at 896 F
# reads 0.38-0.49 (scripts/east_calib_probe.py on an H100, PERF.md §6)
EAST_CALIB_STEPS = 448
DEEP_BATCH = 8            # ResNet-152/200 steps at 512^2
# east_resnet101's eager img/s: DEEP_WINDOWS windows of >= DEEP_WINDOW_S
# (3 windows until the float32 route's phases came, 2 until phase 39)
DEEP_WINDOWS = 1
DEEP_WINDOW_S = 3.0
DEEP_NMS_CANDIDATES = 128  # east_resnet101 detect's cap on NMS input


def restored_state(cfg, device, root):
    """A train state of ``cfg`` with the newest checkpoint under ``root``
    restored into it."""
    from tensorflow_ocr_tpu_torch.train import trainer as T

    state = T.create_train_state(cfg, device)
    return T.restore_checkpoint(T.latest_checkpoint(root), state)


def phase_calibrate(device, root, aug_ck):
    """Checkpoint-time calibration on the augmented state's checkpoint
    (AUG_TRAINED_STEPS steps on phase 32's dataset): calibrate_and_store
    with that dataset as the train split (CALIB_IMAGES images, the 20
    pixel x link points): operating_point.json written with the step and
    grid values, the CC kernel launched by the sweep, a Predictor from the
    checkpoint adopting it, and F at the pick >= F at (0.8, 0.8) less
    CALIB_EPS on the slice; the sweep's seconds and overflow retries."""
    import torch
    from tensorflow_ocr_tpu_torch.infer import Predictor
    from tensorflow_ocr_tpu_torch.ops import kernels as K
    from tensorflow_ocr_tpu_torch.train import calibrate as C
    from tensorflow_ocr_tpu_torch.train.eval_hook import EvalDuringTraining

    cfg = data_config(root, augment=True)
    state = restored_state(cfg, device, aug_ck)
    hook = EvalDuringTraining(cfg, root, max_images=CALIB_IMAGES)
    check(hook.images is not None and len(hook.images) == CALIB_IMAGES,
          "calibrate: the train slice staged no images")
    K.connected_components.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    op = C.calibrate_and_store(state.model, state, cfg, root, aug_ck,
                               hook=hook)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = K.connected_components.launches
    stored = C.load_operating_point(aug_ck)
    at_default = hook(state.model, state, pixel_thresh=0.8, link_thresh=0.8)
    at_pick = hook(state.model, state, pixel_thresh=op["pixel"],
                   link_thresh=op["link"])
    print(f"calibrate: {AUG_TRAINED_STEPS}-step augmented checkpoint on "
          f"{len(hook.images)} train images: operating point {stored}; "
          f"the sweep of {len(C.PIXEL_GRID) * len(C.LINK_GRID)} points took "
          f"{secs:.3f} s, cc launches {launches}, overflow retries "
          f"{hook.overflow_retries}; slice F at the pick "
          f"{at_pick['fmean']:.4f} (P {at_pick['precision']:.4f} R {at_pick['recall']:.4f}), at "
          f"(0.8, 0.8) {at_default['fmean']:.4f} (P "
          f"{at_default['precision']:.4f} R {at_default['recall']:.4f})")
    check(stored is not None and stored.get("step") == AUG_TRAINED_STEPS
          and stored["pixel"] in C.PIXEL_GRID
          and stored["link"] in C.LINK_GRID,
          "calibrate: operating_point.json missing, or not the step's and "
          "the grid's")
    check(launches > 0, "calibrate: the sweep did not launch the CC kernel")
    check(at_pick["fmean"] >= at_default["fmean"] - CALIB_EPS,
          "calibrate: F at the pick below F at (0.8, 0.8) less eps")
    pred = Predictor(MODEL, checkpoint_path=aug_ck, device=device)
    check(pred.calibrated and (pred.pixel_thresh, pred.link_thresh)
          == (stored["pixel"], stored["link"]),
          "calibrate: the Predictor did not adopt the operating point")
    print(f"calibrate: Predictor(checkpoint_path=...) calibrated, "
          f"thresholds {pred.pixel_thresh}/{pred.link_thresh}")
    del pred, state, hook
    torch.cuda.empty_cache()


def phase_calibrate_loop(device, root, snap):
    """Calibration inside the captured loop: run_device_cached for
    LOOP_DISPATCHES dispatches of DATA_SCAN steps from ``snap`` on phase
    32's dataset (no augmentation), a checkpoint after each dispatch and
    calibrate_at_checkpoint on: an operating point with the saved step
    after each save; then the same run with calibration off: every state
    tensor bit-equal (the eval forward leaves the captured graph's tensors
    and the running statistics alone)."""
    import warnings

    import torch
    from tensorflow_ocr_tpu_torch.train import calibrate as C
    from tensorflow_ocr_tpu_torch.train import trainer as T

    steps = LOOP_DISPATCHES * DATA_SCAN
    states, roots = {}, []
    for on in (True, False):
        cfg = data_config(root)
        cfg.train.checkpoint_path = ck = scratch_dir("loop_ckpt_")
        roots.append(ck)
        cfg.train.save_checkpoint_steps = DATA_SCAN
        cfg.train.calibrate_at_checkpoint = on
        trainer = T.Trainer(cfg, device)
        trainer.setup(weights=snap)
        seen = []
        calibrate = trainer._maybe_calibrate

        def spy(calibrate=calibrate, trainer=trainer, seen=seen, ck=ck):
            t0 = time.perf_counter()
            op = calibrate()
            seen.append((int(trainer.state.step), op,
                         C.load_operating_point(ck),
                         time.perf_counter() - t0))
            return op

        trainer._maybe_calibrate = spy
        t0 = time.perf_counter()
        with deterministic(warn_only=True), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            trainer.run_device_cached(steps)
        wall = time.perf_counter() - t0
        states[on] = {k: v.detach().cpu().clone()
                      for k, v in leaves(trainer.state).items()}
        print(f"calibrate in the loop ({'on' if on else 'off'}): {steps} "
              f"steps in {wall:.3f} s; saves at steps "
              f"{[s for s, _, _, _ in seen]}, operating points "
              f"{[o for _, _, o, _ in seen]}, calibration seconds "
              f"{[round(t, 3) for _, _, _, t in seen]}")
        want_steps = list(range(DATA_SCAN, steps + 1, DATA_SCAN))
        check([s for s, _, _, _ in seen] == want_steps,
              "calibrate loop: a save per dispatch")
        if on:
            check(all(o is not None and stored == dict(o, step=s)
                      for s, o, stored, _ in seen),
                  "calibrate loop: no operating point after a save")
        else:
            check(all(o is None and stored is None
                      for _, o, stored, _ in seen),
                  "calibrate loop: an operating point with calibration off")
        del trainer
        torch.cuda.empty_cache()
    bad = unequal(states[True], states[False])
    print(f"calibrate in the loop: state with calibration on vs off: "
          f"{len(states[True]) - len(bad)} of {len(states[True])} tensors "
          f"bit-equal {bad[:3]}")
    check(not bad, "calibrate loop: calibration changed the train state")
    import shutil

    for ck in roots:
        shutil.rmtree(ck)


class SweepScores:
    """An eval hook that records the F of each threshold pair a sweep
    asks it for (calibrate_thresholds returns only its pick)."""

    def __init__(self, hook):
        self.hook, self.images, self.scores = hook, hook.images, {}

    def cached_forward(self):
        return self.hook.cached_forward()

    def __call__(self, model, state, use_ema=True, score_thresh=None,
                 nms_thresh=None):
        r = self.hook(model, state, use_ema=use_ema,
                      score_thresh=score_thresh, nms_thresh=nms_thresh)
        self.scores[(score_thresh, nms_thresh)] = r.get("fmean", 0.0)
        return r


def east_scenes(device):
    """The DATASET_SCENES numpy scenes phase 25's EAST state trains on
    (train_batch's, seed 75), on the card."""
    import numpy as np

    return train_batch(np.random.RandomState(75), device, DATASET_SCENES,
                       TRAIN_SIZE)


def east_scene_dir(batch, n):
    """The first ``n`` scenes of ``batch`` as an ICDAR directory:
    img_<i>.png (the pixels the eval hook reads back, BGR on disk) and
    gt_img_<i>.txt (### for the ignored quads). Returns its path."""
    from tensorflow_ocr_tpu_torch.data import codec

    out = scratch_dir("east_scenes_")
    for i in range(n):
        img = batch["images"][i].cpu().numpy()
        check(codec.imwrite(os.path.join(out, f"img_{i}.png"),
                            img[:, :, ::-1].copy()),
              "east calibrate: a scene was not written")
        polys = batch["polys"][i].cpu().numpy()
        valid = batch["valid"][i].cpu().numpy()
        tags = batch["tags"][i].cpu().numpy()
        with open(os.path.join(out, f"gt_img_{i}.txt"), "w") as f:
            for quad, tag in zip(polys[valid], tags[valid]):
                coords = ",".join(f"{v:.2f}" for v in quad.reshape(-1))
                f.write(f"{coords},{'###' if tag else 'text'}\n")
    return out


def phase_east_calibrate(device, east_root):
    """EAST calibration: the serving checkpoint (EAST_SERVE_STEPS steps)
    trained EAST_CALIB_STEPS more graph steps on the same scenes (at 448
    its boxes miss IoU 0.5: scripts/east_calib_probe.py), then the 15
    score x NMS points on EAST_CALIB_IMAGES of those scenes
    (east_scene_dir), the point written into a directory of its own (the
    serving checkpoint keeps the thresholds its phase measured): the
    sweep's best F above 0, the pick within CALIB_EPS of it and of F at
    the default thresholds; the training's and the sweep's seconds."""
    import shutil

    import numpy as np
    import torch
    from tensorflow_ocr_tpu_torch.train import calibrate as C
    from tensorflow_ocr_tpu_torch.train import trainer as T
    from tensorflow_ocr_tpu_torch.train.eval_hook import EvalDuringTraining

    cfg = east_config()
    state = restored_state(cfg, device, east_root)
    batch = east_scenes(device)
    scenes = east_scene_dir(batch, EAST_CALIB_IMAGES)
    ds = T.device_dataset(batch, cfg, device)
    del batch
    multi = T.make_multi_train_step(state, cfg, T.label_keys(cfg))
    rng = np.random.RandomState(77)
    target = EAST_SERVE_STEPS + EAST_CALIB_STEPS
    t0 = time.perf_counter()
    while int(state.step) < target:
        last = multi(state, ds, dispatch_rows(rng, cfg.train.scan_steps,
                                              device))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    multi.release()
    del multi, ds
    torch.cuda.empty_cache()
    check(int(state.step) == target and np.isfinite(
        float(last["model_loss"])), "east calibrate: the extra training")
    hook = SweepScores(EvalDuringTraining(cfg, scenes,
                                          max_images=EAST_CALIB_IMAGES))
    check(hook.images is not None and len(hook.images) == EAST_CALIB_IMAGES,
          "east calibrate: the scenes staged no images")
    out = scratch_dir("east_op_")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    op = C.calibrate_and_store(state.model, state, cfg, scenes, out,
                               hook=hook)
    secs = time.perf_counter() - t0
    stored = C.load_operating_point(out)
    best = max(hook.scores, key=hook.scores.get)
    default = (cfg.infer.score_map_thresh, cfg.infer.nms_thresh)
    print(f"east calibrate: the {EAST_SERVE_STEPS}-step checkpoint trained "
          f"{EAST_CALIB_STEPS} more steps in {train_s:.3f} s (model loss "
          f"{float(last['model_loss']):.6f}), on {len(hook.images)} of its "
          f"train scenes: operating point {stored}; best F "
          f"{hook.scores[best]:.4f} at {best}, F at the defaults {default} "
          f"{hook.scores.get(default, float('nan')):.4f}; the sweep of "
          f"{len(hook.scores)} points took {secs:.3f} s "
          f"({secs / len(hook.images):.3f} s an image)")
    check(op is not None and stored == dict(op, step=target)
          and op["score"] in C.SCORE_GRID and op["nms"] in C.NMS_GRID,
          "east calibrate: no operating point, or not on the grid")
    check(len(hook.scores) == len(C.SCORE_GRID) * len(C.NMS_GRID)
          and default in hook.scores,
          "east calibrate: the sweep missed a grid point")
    check(hook.scores[best] > 0, "east calibrate: F 0 at every point on "
          "the scenes the state was trained on")
    check(op["fmean"] >= hook.scores[best] - CALIB_EPS
          and op["fmean"] >= hook.scores[default] - CALIB_EPS,
          "east calibrate: F at the pick below the best or the defaults' "
          "less eps")
    shutil.rmtree(out)
    shutil.rmtree(scenes)
    del state, hook
    torch.cuda.empty_cache()


def deep_step(device, model, impl, batch, label, loss="ohem", windows=0,
              route=False):
    """One train step of ``model`` with ``impl`` on ``batch`` from a
    seeded state, then with ``windows`` its eager img/s over that many
    windows of at least DEEP_WINDOW_S (eager_rate): finite losses; prints
    the hand-written kernels' launches in the first step and the peak
    memory. Returns (launches, peak bytes)."""
    import math

    import torch
    from tensorflow_ocr_tpu_torch.train import trainer as T

    base = arm_memory_start()
    cfg = train_config(impl, model=model, loss=loss)
    state = T.create_train_state(cfg, device,
                                 generator=torch.Generator().manual_seed(23))
    loss_fn = T.make_loss_fn(cfg)
    reset_fused_counts()
    reset_ghost_counts()
    reset_conv_counts()
    with pallas_convs(route):
        m = T.train_step(state, batch, cfg, loss_fn)
        torch.cuda.synchronize()
        counts = {**fused_counts(), **ghost_counts(), **conv_counts()}
        if windows:
            m = eager_rate(state, batch, cfg, f"{label} {model} {impl}",
                           windows, DEEP_WINDOW_S)
    loss_v = float(m["model_loss"])
    peak = torch.cuda.max_memory_allocated()
    n = batch["images"].shape[0]
    print(f"{label}: {model} {impl}{' PALLAS_CONVS' * route} {TRAIN_SIZE}^2 "
          f"batch {n}: model loss {loss_v:.6f}; first step's launches "
          f"{ {k: v for k, v in counts.items() if v} }; {arm_memory(base)}")
    check(math.isfinite(loss_v), f"{label}: non-finite loss")
    del state
    torch.cuda.empty_cache()
    return counts, peak


def phase_backbones(device):
    """The deeper backbones: east_resnet101 and pixellink_resnetv2_50
    forwards in float32 on the card against the CPU (phase 4's check);
    east_resnet101 on the fused arm at 512^2, batch 32: the fused kernels
    launched, img/s over DEEP_WINDOWS windows of >= DEEP_WINDOW_S and the
    peak memory;
    pixellink_resnet152 and pixellink_resnet200 one fused and one ghost
    step each at batch DEEP_BATCH (the ghost units counted by
    ghost_boundary_fwd's launches); pixellink_resnetv2_50 one step with
    the PALLAS_CONVS route on its ConvBNs; one detect_batch of
    east_resnet101 at 8 x 1280x768, a box on every image (NMS's input
    capped at DEEP_NMS_CANDIDATES: seeded weights pass ~1,200 candidates
    an image)."""
    import warnings

    import numpy as np
    import torch
    from tensorflow_ocr_tpu_torch.infer import Predictor

    t0 = time.perf_counter()
    phase_forward(device, "east_resnet101")
    phase_forward(device, "pixellink_resnetv2_50")
    batch = train_batch(np.random.RandomState(91), device, TRAIN_BATCH,
                        TRAIN_SIZE)
    counts, _ = deep_step(device, "east_resnet101", "fused", batch,
                          "deep", loss="east", windows=DEEP_WINDOWS)
    check(all(counts[k] for k in FUSED_KERNELS),
          "east_resnet101: a fused kernel not launched")
    small = {k: v[:DEEP_BATCH] for k, v in batch.items()}
    del batch
    for depth in (152, 200):
        name = f"pixellink_resnet{depth}"
        counts, _ = deep_step(device, name, "fused", small, "deep")
        check(all(counts[k] for k in FUSED_KERNELS),
              f"{name}: a fused kernel not launched")
        counts, _ = deep_step(device, name, "ghost", small, "deep")
        units = counts["ghost_boundary_fwd"]
        print(f"deep: {name} ghost units on the ghost path: {units}")
        check(units > 0 and all(counts[k] for k in GHOST_KERNELS),
              f"{name}: a ghost kernel not launched")
    counts, _ = deep_step(device, "pixellink_resnetv2_50", "xla", small,
                          "deep", route=True)
    check(any(counts[k] for k in CONV_KERNELS),
          "pixellink_resnetv2_50: no conv kernel on its ConvBNs")
    del small
    torch.cuda.empty_cache()
    pred = Predictor("east_resnet101", device=device)
    # seeded weights pass ~1,200 candidates an image after the merge
    # (30 s of host NMS for the batch at the default cap of 1024)
    pred.infer.nms_max_candidates = DEEP_NMS_CANDIDATES
    images = scene_images(np.random.RandomState(93), 8)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the cap's warning, per image
        boxes = pred.detect_batch(images)
    ms = (time.perf_counter() - t1) * 1000
    n = [len(b) for b in boxes]
    check(len(boxes) == 8 and min(n) > 0
          and all(np.isfinite(b).all() and b.shape == (4, 2)
                  for bs in boxes for b in bs),
          "east_resnet101 detect: an image without a box, or malformed "
          "boxes")
    print(f"deep: east_resnet101 detect_batch 8x1280x768 bf16 (seeded "
          f"weights, NMS input capped at {DEEP_NMS_CANDIDATES}): {ms:.3f} "
          f"ms, boxes per image {n}, host NMS {pred.nms_ms:.3f} ms")
    del pred
    torch.cuda.empty_cache()
    print(f"deep: the phase took {time.perf_counter() - t0:.1f} s")


# --------------------------------------------------------------------------
# 37. the entry points, the presets, the slim import, export, photo tiers
# --------------------------------------------------------------------------

ENTRY_FRAMES = 8      # default-tier frames at DATA_HW the entries read
ENTRY_BATCH = 8
ENTRY_STEPS = 20
ENTRY_SIZE = 512
# bf16 probabilities of the maps bundle against the live forward: one
# ulp is 3.9e-3 near 1, and another process may pick other cuDNN kernels
BUNDLE_MAPS_ATOL = 1e-2
BOX_ATOL = 1e-3       # tests/test_torch_decode.py's corner tolerance
SLIM_LOADED = 53 * 5  # resnet_v1_50's tensors JAX's import takes

# runs each (module, argv) of sys.argv[1] as `python -m module argv`, in
# order, in this one process, then prints the kernels' launch counts
ENTRY_PROBE = r"""
import json, runpy, sys
import torch
from tensorflow_ocr_tpu_torch.ops import fused as FU
from tensorflow_ocr_tpu_torch.ops import kernels as K
for module, args in json.loads(sys.argv[1]):
    sys.argv = [module] + args
    runpy.run_module(module, run_name="__main__", alter_sys=True)
if torch.cuda.is_available():
    torch.cuda.synchronize()
counts = {"connected_components": K.connected_components.launches}
counts.update({a: getattr(FU, a).launches for a in
               ("conv_fwd", "conv_bwd", "boundary_fwd", "boundary_bwd")})
print("LAUNCHES " + json.dumps(counts))
"""

# loads a serving bundle in a fresh process, runs it on the saved images
# (the weights file for the external contract), saves the outputs
BUNDLE_PROBE = r"""
import json, statistics, sys, time
import numpy as np
import torch
from tensorflow_ocr_tpu_torch.export import load_serving_bundle
from tensorflow_ocr_tpu_torch.ops import kernels as K
bundle, images, weights, out = sys.argv[1:5]
t0 = time.perf_counter()
run, meta = load_serving_bundle(bundle)
load_s = time.perf_counter() - t0
dev = torch.device(meta["platforms"][0])
sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
x = torch.from_numpy(np.load(images)).float().to(dev)
args = ((x,) if meta["weights"] == "baked" else
        (torch.load(weights, map_location=dev, weights_only=True), x))
K.connected_components.launches = 0
res = run(*args)
sync()
launches = K.connected_components.launches
times = []
for _ in range(5):
    t0 = time.perf_counter()
    run(*args)
    sync()
    times.append((time.perf_counter() - t0) * 1000)
np.savez(out, **{k: v.cpu().numpy() for k, v in res.items()})
print("BUNDLE " + json.dumps({"cc_launches": launches, "load_s": load_s,
                              "batch_ms": statistics.median(times),
                              "meta": meta}))
"""


def run_probe(code, args, label, timeout=600):
    """``python -c code args`` from the checkout; its output printed and
    returned; raises when it fails."""
    env = dict(os.environ, PYTHONPATH=REPO)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code, *args], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)
    dt = time.perf_counter() - t0
    tail = "\n".join(proc.stdout.strip().splitlines()[-12:])
    print(f"entries: {label} ({dt:.1f} s, rc {proc.returncode}):\n{tail}")
    if proc.returncode != 0:
        print(proc.stderr[-4000:], file=sys.stderr)
    check(proc.returncode == 0, f"entries: {label} failed")
    return proc.stdout, dt


def probe_line(out, tag):
    return json.loads([ln for ln in out.splitlines()
                       if ln.startswith(tag + " ")][-1][len(tag) + 1:])


def run_entries(runs, label):
    """The (module, argv) entry runs in one fresh process: (stdout, launch
    counts, seconds)."""
    out, dt = run_probe(ENTRY_PROBE, [json.dumps(runs)], label)
    return out, probe_line(out, "LAUNCHES"), dt


def step_losses(out):
    """(model loss, total loss) of every "Step ..." line of a train run."""
    import re

    return [tuple(float(v) for v in m.groups()) for m in re.finditer(
        r"model loss (\S+), total loss ([^,\s]+)", out)]


def slim_resnet_v1_50_schema():
    """Every variable of the public slim resnet_v1_50 ImageNet checkpoint
    and its shape (tests/test_pretrained_schema.py's schema)."""
    v = {"global_step": ()}

    def add(prefix, kshape):
        v[f"{prefix}/weights"] = kshape
        for leaf in ("gamma", "beta", "moving_mean", "moving_variance"):
            v[f"{prefix}/BatchNorm/{leaf}"] = (kshape[-1],)

    add("resnet_v1_50/conv1", (7, 7, 3, 64))
    block_in = 64
    for b, (n, out, db) in enumerate(zip((3, 4, 6, 3),
                                         (256, 512, 1024, 2048),
                                         (64, 128, 256, 512)), 1):
        for u in range(1, n + 1):
            cin = block_in if u == 1 else out
            base = f"resnet_v1_50/block{b}/unit_{u}/bottleneck_v1"
            if u == 1:
                add(f"{base}/shortcut", (1, 1, cin, out))
            add(f"{base}/conv1", (1, 1, cin, db))
            add(f"{base}/conv2", (3, 3, db, db))
            add(f"{base}/conv3", (1, 1, db, out))
        block_in = out
    v["resnet_v1_50/logits/weights"] = (1, 1, 2048, 1000)
    v["resnet_v1_50/logits/biases"] = (1000,)
    v["resnet_v1_50/mean_rgb"] = (3,)
    return v


def same_boxes(got, want) -> bool:
    """Corners within BOX_ATOL, or at a min-area angle tie the same area
    (tests/test_torch_decode.py assert_same_boxes)."""
    import numpy as np

    def area(q):
        x, y = q[:, 0].astype(np.float64), q[:, 1].astype(np.float64)
        return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))

    return len(got) == len(want) and all(
        np.allclose(g, w, rtol=0, atol=BOX_ATOL)
        or abs(area(g) - area(w)) <= BOX_ATOL for g, w in zip(got, want))


def phase_entries_train(root, ck):
    """(a) cli.multigpu_train on the frames, fused arm, 512^2, batch 8."""
    out, counts, dt = run_entries([[
        "tensorflow_ocr_tpu_torch.cli.multigpu_train",
        [f"--training_data_path={root}", f"--input_size={ENTRY_SIZE}",
         f"--batch_size_per_gpu={ENTRY_BATCH}", f"--max_steps={ENTRY_STEPS}",
         f"--checkpoint_path={ck}", "--save_checkpoint_steps=0",
         "--model.bottleneck_impl=fused", "--data.max_polys=16",
         "--gpu_list=0"]]], "multigpu_train")
    losses = step_losses(out)
    print(f"entries: multigpu_train {ENTRY_STEPS} steps of {ENTRY_BATCH} "
          f"at {ENTRY_SIZE}^2 (fused) in {dt:.1f} s of process: losses {losses}; "
          f"launches {counts}")
    check(len(losses) >= 1 and all(math.isfinite(v) for lv in losses
                                   for v in lv),
          "entries: train losses missing or not finite")
    check(all(counts[a] > 0 for a in ("conv_fwd", "conv_bwd", "boundary_fwd",
                                      "boundary_bwd")),
          f"entries: the train entry launched no fused kernel: {counts}")
    names = os.listdir(ck)
    check(f"ckpt_{ENTRY_STEPS}" in names and "operating_point.json" in names,
          f"entries: no checkpoint or operating point in {names}")


def phase_entries_test(root, ck, device):
    """(a) cli.test and cli.test_pixellink_fast on the frames; cli.test's
    res files equal an in-process Predictor(checkpoint_path=...)'s."""
    import numpy as np
    from tensorflow_ocr_tpu_torch.data import codec
    from tensorflow_ocr_tpu_torch.infer import Predictor
    from tensorflow_ocr_tpu_torch.ops.geometry import order_points
    from tensorflow_ocr_tpu_torch.utils.image import (get_test_images,
                                                      write_result_txt)

    res, fast, mine = (scratch_dir(p) for p in ("res_", "fast_", "mine_"))
    common = [f"--test_data_path={root}", f"--checkpoint_path={ck}"]
    out, counts, dt = run_entries([
        ["tensorflow_ocr_tpu_torch.cli.test", common + [f"--output_dir={res}"]],
        ["tensorflow_ocr_tpu_torch.cli.test_pixellink_fast",
         common + [f"--output_dir={fast}",
                   "--model.name=pixellink_resnet50"]]],
        "test and test_pixellink_fast")
    check(counts["connected_components"] > 0,
          f"entries: the test entries launched no CC kernel: {counts}")
    files = get_test_images(root)
    for d in (res, fast):
        got = sorted(n for n in os.listdir(d) if n.startswith("res_"))
        check(len(got) == len(files), f"entries: {len(got)} res files in {d}")
    pred = Predictor(MODEL, device=device, checkpoint_path=ck)
    n_boxes = 0
    for fn in files:
        im = codec.imread(fn)
        boxes, _ = pred.detect(im[:, :, ::-1])
        n_boxes += len(boxes)
        write_result_txt(mine, fn, [order_points(np.asarray(b))
                                    for b in boxes])
    for name in os.listdir(mine):
        with open(os.path.join(res, name), "rb") as a, \
                open(os.path.join(mine, name), "rb") as b:
            check(a.read() == b.read(),
                  f"entries: cli.test's {name} differs from the Predictor's")
    print(f"entries: cli.test and test_pixellink_fast wrote {len(files)} "
          f"res files each ({dt:.1f} s of process, CC launches "
          f"{counts['connected_components']}); cli.test's equal an "
          f"in-process Predictor(checkpoint_path=...)'s ({n_boxes} boxes, "
          f"calibrated {pred.calibrated})")
    for d in (res, fast, mine):
        shutil.rmtree(d, ignore_errors=True)


def phase_entries_presets_slim(root, device):
    """(b) presets 1-4 one step each through the train entry; (c) a slim
    resnet_v1_50 .npz of every name at its real shape: Trainer.setup takes
    SLIM_LOADED tensors, each equal to the file, then one step through the
    entry with --pretrained_model_path. The checks in this process run
    here; returns a function that runs the entries' process and checks
    it (phase 37 runs that beside the test and export entries)."""
    import numpy as np
    import torch
    from tensorflow_ocr_tpu_torch.config import Config
    from tensorflow_ocr_tpu_torch.train import trainer as T

    work = scratch_dir("presets_")
    rng = np.random.RandomState(7)
    arrays = {k: np.asarray(rng.randn(*s) * 0.05, np.float32)
              for k, s in slim_resnet_v1_50_schema().items()}
    for k in arrays:
        if k.endswith("moving_variance"):
            arrays[k] = np.abs(arrays[k]) + 0.5
    npz = os.path.join(work, "resnet_v1_50.npz")
    np.savez(npz, **arrays)
    cfg = Config()
    cfg.train.pretrained_model_path = npz
    state = T.Trainer(cfg, device).setup()
    sd = state.model.state_dict()
    from tensorflow_ocr_tpu_torch.train.pretrained import slim_to_torch_key

    equal = 0
    for name, v in arrays.items():
        mapped = slim_to_torch_key(name)
        if mapped is None or mapped[0] not in sd:
            continue
        key, kernel = mapped
        want = torch.from_numpy(v.transpose(3, 2, 0, 1) if kernel else v)
        check(torch.equal(sd[key].cpu(), want),
              f"slim: {key} differs from the .npz after setup")
        equal += 1
    check(equal == SLIM_LOADED, f"slim: {equal} tensors imported, JAX's "
          f"schema count is {SLIM_LOADED}")
    del state, sd
    torch.cuda.empty_cache()
    runs = [["tensorflow_ocr_tpu_torch.cli.multigpu_train",
             [f"--preset={n}", f"--training_data_path={root}",
              "--max_steps=1", f"--checkpoint_path={work}/p{n}",
              "--train.calibrate_at_checkpoint=false"]] for n in (1, 2, 3, 4)]
    runs.append(["tensorflow_ocr_tpu_torch.cli.multigpu_train",
                 [f"--training_data_path={root}", "--max_steps=1",
                  f"--batch_size_per_gpu={ENTRY_BATCH}",
                  f"--pretrained_model_path={npz}",
                  f"--checkpoint_path={work}/slim",
                  "--train.calibrate_at_checkpoint=false"]])
    def run():
        out, _, dt = run_entries(runs, "presets 1-4 and the slim warm start")
        losses = step_losses(out)
        check(len(losses) == 5 and all(math.isfinite(v) for lv in losses
                                       for v in lv),
              f"entries: preset or slim losses {losses}")
        check(f"warm-started {SLIM_LOADED} tensors" in out,
              "slim: the entry did not report the schema's count")
        print(f"entries: presets 1-4 (east_vgg16 512 b2, east_resnet50 512 "
              f"b14, pixellink2s_vgg16 512 b14, east_resnet50 focal 768 b8 "
              f"augmented) and the slim warm start ({SLIM_LOADED} tensors "
              f"equal to the .npz after setup) one step each: losses "
              f"{losses} ({dt:.1f} s of process)")
        shutil.rmtree(work, ignore_errors=True)

    return run


def phase_entries_export(ck, device):
    """(d) pixellink_resnet50 bundles at 8 x 1280x768: decode + baked and
    maps-only + external, each loaded in a fresh process; boxes equal to
    Predictor.detect_batch's, the CC kernel launched there, the maps
    within BUNDLE_MAPS_ATOL of the live forward."""
    import numpy as np
    import torch
    from tensorflow_ocr_tpu_torch.export import save_serving_bundle
    from tensorflow_ocr_tpu_torch.infer import Predictor, pixel_link_scores

    pred = Predictor(MODEL, device=device, checkpoint_path=ck)
    images = scene_images(np.random.RandomState(3), 8)
    head_logit_scale(pred, torch.from_numpy(images).to(device),
                     ("pixel_logits", "link_logits"))
    decode_check(pred, images, "export")
    want = pred.detect_batch(images)
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred.detect_batch(images)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1000)
    x = torch.from_numpy(images).to(device)
    with torch.inference_mode():
        ps, ls = (t.float().cpu().numpy()
                  for t in pixel_link_scores(pred.model(x)))
    work = scratch_dir("bundle_")
    img_file = os.path.join(work, "images.npy")
    np.save(img_file, images)
    w_file = os.path.join(work, "weights.pt")
    torch.save(pred.model.state_dict(), w_file)
    h, w = IMAGE_HW
    for decode, bake in ((True, True), (False, False)):
        kind = ("decode+baked" if decode else "maps+external")
        path = os.path.join(work, kind)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_serving_bundle(path, pred, 8, h, w, with_decode=decode,
                            bake_weights=bake, weights_source=w_file)
        export_s = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(path, f))
                   for f in os.listdir(path))
        out_file = os.path.join(work, f"{kind}.npz")
        out, _ = run_probe(BUNDLE_PROBE, [path, img_file, w_file, out_file],
                           f"load the {kind} bundle")
        r = probe_line(out, "BUNDLE")
        got = dict(np.load(out_file))
        check(r["meta"]["platforms"] == [pred.device.type],
              f"export: {kind} platforms {r['meta']['platforms']}")
        if decode:
            check(r["cc_launches"] > 0,
                  f"export: the {kind} bundle launched no CC kernel")
            for i in range(len(images)):
                b = got["boxes"][i][got["valid"][i]] * pred.stride
                check(same_boxes(b, want[i]),
                      f"export: {kind} boxes of image {i} differ from "
                      f"detect_batch's ({len(b)} against {len(want[i])})")
            err = "boxes equal"
        else:
            err = max(float(np.abs(got["pixel_scores"] - ps).max()),
                      float(np.abs(got["link_scores"] - ls).max()))
            check(err <= BUNDLE_MAPS_ATOL,
                  f"export: {kind} maps {err} from the live forward")
            err = f"maps max abs err {err:.4e}"
        print(f"export: {kind} pixellink_resnet50 8x{w}x{h}: export "
              f"{export_s:.3f} s, bundle {size / 2 ** 20:.2f} MiB, load "
              f"{r['load_s']:.3f} s, batch {r['batch_ms']:.3f} ms (median of "
              f"5) against Predictor.detect_batch "
              f"{statistics.median(times):.3f} ms; CC launches "
              f"{r['cc_launches']}; {err}")
    shutil.rmtree(work, ignore_errors=True)


def phase_entries_photo():
    """(e) the package photographs this machine has, and the photo tiers'
    frames where it has them."""
    from tensorflow_ocr_tpu_torch.data import codec
    from tensorflow_ocr_tpu_torch.data import icdar

    found = {t: {k: len(v) for k, v in icdar._photo_sources(t).items()}
             for t in ("photo", "photo2")}
    print(f"photo: package photographs on this machine: {found} (17 in all "
          f"where sklearn, matplotlib, pygame, dm_control and "
          f"gymnasium_robotics are installed)")
    work = scratch_dir("photo_")
    for hard in ("photo:train", "photo2:val"):
        tier, split = hard.split(":")
        if not found[tier][split]:
            print(f"photo: no {hard} sources here, so no {hard} frames: "
                  f"missing data on this machine, not a device or kernel "
                  f"fallback")
            continue
        t0 = time.perf_counter()
        files = icdar.make_synthetic_dataset(os.path.join(work, tier), 4,
                                             DATA_HW, seed=0, hard=hard)
        dt = time.perf_counter() - t0
        check(len(files) == 4 and all(
            codec.imread(f).shape == (*DATA_HW, 3) for f in files),
              f"photo: {hard} frames")
        print(f"photo: 4 {hard} frames at {DATA_HW[1]}x{DATA_HW[0]} in "
              f"{dt:.3f} s")
    shutil.rmtree(work, ignore_errors=True)


def phase_entry_points(device):
    """Phase 37: the entry points (train, test, presets, the slim warm
    start), the serving export and the photo tiers; the presets' process
    beside the test and export ones, so the export's times read beside
    it."""
    from concurrent.futures import ThreadPoolExecutor

    import torch
    from tensorflow_ocr_tpu_torch.data.icdar import make_synthetic_dataset

    t0 = time.perf_counter()
    root = scratch_dir("entries_")
    make_synthetic_dataset(root, ENTRY_FRAMES, DATA_HW, seed=11)
    ck = scratch_dir("entries_ckpt_")
    torch.cuda.empty_cache()
    phase_entries_train(root, ck)
    # the presets' process runs beside the test and export entries (each
    # process mostly host-bound): its checks are raised when it is joined
    presets = phase_entries_presets_slim(root, device)
    with ThreadPoolExecutor(1) as pool:
        running = pool.submit(presets)
        phase_entries_test(root, ck, device)
        phase_entries_export(ck, device)
        running.result()
    phase_entries_photo()
    shutil.rmtree(ck, ignore_errors=True)
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"entries: phase 37 took {time.perf_counter() - t0:.1f} s")


# --------------------------------------------------------------------------
# phase 38: multi-GPU (parallel/), in processes that torch.distributed.run
# starts; the card machine has one H100, so NCCL runs a world of one and
# gloo joins two ranks on the one card
# --------------------------------------------------------------------------

MGPU_STEPS = 4        # (a): the captured dispatch's steps
MGPU_TIME_S = 120.0   # the phase's budget, both process groups included
MGPU_TIMED = 3        # timed repeats of each step and all-reduce
MGPU_FRAMES = 8       # (b): 1280x720 synthetic frames the readers read
MGPU_READ_BATCH = 8   # (b): the readers' global batch, 4 a rank
MGPU_READ_TIMED = 2   # (b): batches each reader is timed over


def mgpu_line(tag, **fields):
    print(f"MGPU {json.dumps(dict(fields, tag=tag))}", flush=True)


def two_halves(state, batch, cfg, loss_fn, scale1=1.0):
    """Rank by rank in one process, what two data-parallel ranks do with
    the two halves of ``batch`` from ``state``: each half's forward and
    backward from the same BN buffers, the gradients summed in rank order
    (rank 1's times ``scale1``: a planted fault) and halved, the optimizer
    and EMA, the BN buffers and the metrics summed in rank order and
    halved, the L2 value of the parameters before the update added."""
    import torch
    from tensorflow_ocr_tpu_torch.train import optim, trainer as T

    model = state.model
    l2 = optim.l2_regularization(model, cfg.model.weight_decay)
    bufs = T.bn_buffers(model)
    start = [b.clone() for b in bufs]
    half = len(batch["images"]) // 2
    grads, after, metrics = [], [], []
    for r in range(2):
        with torch.no_grad():
            for b, s in zip(bufs, start):
                b.copy_(s)
        part = {k: v[r * half:(r + 1) * half] for k, v in batch.items()}
        ml, aux = T.loss_and_grads(model, part, cfg, loss_fn)
        grads.append([p.grad.clone() for p in model.parameters()
                      if p.grad is not None])
        after.append([b.clone() for b in bufs])
        metrics.append({"model_loss": ml, **aux})
    with torch.no_grad():
        live = [p for p in model.parameters() if p.grad is not None]
        for p, g0, g1 in zip(live, *grads):
            p.grad = (g0 + g1 * scale1) / 2
        T.apply_update(state, cfg)
        for b, a0, a1 in zip(bufs, *after):
            b.copy_((a0 + a1) / 2)
    out = {k: ((metrics[0][k].float() + metrics[1][k].float()) / 2).to(
        v.dtype if v.dtype.is_floating_point else torch.float32)
        for k, v in metrics[0].items()}
    return {"total_loss": out["model_loss"] + l2, **out}


def max_rel(a, b) -> float:
    """The largest |a - b| / max|b| over the tensors of two mappings."""
    return max(float((a[k].float() - b[k].float()).abs().max()
                     / b[k].float().abs().max().clamp_min(1e-30))
               for k in b)


def timed_ms(fn, n=MGPU_TIMED) -> float:
    """Median wall ms of ``fn`` with the card synced around each call."""
    import torch

    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1000)
    return statistics.median(times)


def allreduce_ms(group, model):
    """The train step's gradient all-reduce alone (one flat buffer of
    every parameter's size), timed; (ms, bytes)."""
    import torch

    grads = [torch.zeros_like(p) for p in model.parameters()]
    ms = timed_ms(lambda: group.all_reduce_(grads))
    return ms, 4 * sum(g.numel() for g in grads)


def mgpu_graph_rank(device="cuda") -> int:
    """(a) One rank of a world-1 NCCL group from torchrun's environment:
    the fused arm's MGPU_STEPS-step dispatch with the group (its NCCL
    all-reduces captured in the graph) against the same dispatch with no
    group, under deterministic(): every state tensor and metric bit-equal,
    the fused kernels launched at the capture; then spatial_forward of
    the Predictor's model at 8 x 1280x768, maps and boxes equal to the
    Predictor's own, the CC kernel launched; the same through a fused-arm
    Predictor on the same weights, its fused kernels launched."""
    import numpy as np
    import torch
    from tensorflow_ocr_tpu_torch.infer import Predictor
    from tensorflow_ocr_tpu_torch.ops import kernels as K
    from tensorflow_ocr_tpu_torch.parallel import make_mesh, multihost
    from tensorflow_ocr_tpu_torch.parallel import spatial
    from tensorflow_ocr_tpu_torch.train import trainer as T

    check(multihost.initialize(device=device), "no torchrun environment")
    group = make_mesh(1, device)
    device = group.device
    cuda = device.type == "cuda"
    check(group.backend == ("nccl" if cuda else "gloo")
          and group.world == 1 and group.reduces,
          f"the world-1 group: {group}")
    cfg = train_config("fused")
    snap = seeded_snap(device)
    ds = scene_dataset(device)
    idx = dispatch_rows(np.random.RandomState(38), MGPU_STEPS, device)
    torch.cuda.reset_peak_memory_stats(device)
    with deterministic():
        a = T.create_train_state(cfg, device, weights=snap)
        b = T.create_train_state(cfg, device, weights=snap)
        multi_a = T.make_multi_train_step(a, cfg, T.label_keys(cfg),
                                          group=group)
        multi_b = T.make_multi_train_step(b, cfg, T.label_keys(cfg))
        reset_fused_counts()
        got = multi_a(a, ds, idx)
        torch.cuda.synchronize()
        captured = fused_counts()
        want = multi_b(b, ds, idx)
        diff = unequal(leaves(a), leaves(b)) + unequal(got, want)
        reset_fused_counts()
        ms_group = timed_ms(lambda: multi_a(a, ds, idx), 1) / MGPU_STEPS
        ms_plain = timed_ms(lambda: multi_b(b, ds, idx), 1) / MGPU_STEPS
        replayed = fused_counts()
        diff += unequal(leaves(a), leaves(b))
    # the capture runs the warm-up steps and records one (a CPU rehearsal
    # runs the dispatch's steps eagerly)
    n = T.WARMUP_STEPS + 1 if cuda else MGPU_STEPS
    check(not diff, f"phase 38 (a): the dispatch with the NCCL group "
          f"differs from the one without at {diff[:4]}")
    check(all(captured.values()) and all(v % n == 0 for v in
                                         captured.values()),
          f"phase 38 (a): fused launches at the capture {captured}")
    check(not (cuda and any(replayed.values())),
          f"phase 38 (a): launches at the replays {replayed}")
    ar_ms, ar_bytes = allreduce_ms(group, a.model)
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    multi_a.release()
    multi_b.release()
    del a, b, multi_a, multi_b, ds
    torch.cuda.empty_cache()

    pred = Predictor(MODEL, device=device)
    images = scene_images(np.random.RandomState(0), 8)
    x = torch.from_numpy(images).to(device)
    head_logit_scale(pred, x, ("pixel_logits", "link_logits"))
    decode_check(pred, images, "phase 38 Predictor")
    with torch.inference_mode():
        want_maps = pred.model(x)
    want_boxes = pred.detect_batch(images)
    spatial.spatial_predictor(pred, spatial.make_spatial_mesh(1, device))
    K.connected_components.launches = 0
    got_boxes = pred.detect_batch(images)
    torch.cuda.synchronize()
    cc = K.connected_components.launches
    got_maps = pred.forward(x)
    maps_diff = unequal(got_maps, want_maps)
    same_boxes = all(len(g) == len(w) and all(
        np.array_equal(u, v) for u, v in zip(g, w))
        for g, w in zip(got_boxes, want_boxes))
    check(not maps_diff and same_boxes and cc > 0,
          f"phase 38 (a): spatial_forward at world 1: maps differ at "
          f"{maps_diff}, boxes equal {same_boxes}, cc launches {cc}")
    # the fused arm on the same weights, served through the same path
    fused = Predictor(MODEL, weights=pred.model.state_dict(), device=device,
                      bottleneck_impl="fused")
    fused.pixel_thresh, fused.link_thresh = pred.pixel_thresh, pred.link_thresh
    with torch.inference_mode():
        want_maps = fused.model(x)
    want_boxes = fused.detect_batch(images)
    spatial.spatial_predictor(fused, spatial.make_spatial_mesh(1, device))
    reset_fused_counts()
    got_fused = fused.detect_batch(images)
    torch.cuda.synchronize()
    launches = fused_counts()
    maps_diff = unequal(fused.forward(x), want_maps)
    same_fused = all(len(g) == len(w) and all(
        np.array_equal(u, v) for u, v in zip(g, w))
        for g, w in zip(got_fused, want_boxes))
    check(not maps_diff and same_fused
          and launches["fused_conv_fwd"] == FUSED_CONV_STEP_LAUNCHES
          and launches["fused_boundary_fwd"] == FUSED_BOUNDARY_STEP_LAUNCHES,
          f"phase 38 (a): the fused arm through spatial_forward at world 1:"
          f" maps differ at {maps_diff}, boxes equal {same_fused}, fused "
          f"launches {launches}")
    mgpu_line("graph", rank=0, steps=MGPU_STEPS, unequal=len(diff),
              captured=captured, step_ms_group=ms_group,
              step_ms_plain=ms_plain, allreduce_ms=ar_ms,
              allreduce_bytes=ar_bytes, peak_gib=peak,
              spatial_boxes=sum(len(g) for g in got_boxes),
              spatial_cc_launches=cc,
              spatial_fused_boxes=sum(len(g) for g in got_fused),
              spatial_fused_launches=launches)
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


def mgpu_gloo_rank(frames, device=None) -> int:
    """(b) One of two gloo ranks on the one card (backend chosen by
    name): one eager fused step of the global batch of TRAIN_BATCH, half
    a rank; rank 0 then runs two_halves from the same state and holds
    the ranks' state and metrics against it (bit-equal: a two-rank sum
    is one addition), and reads the same step with rank 1's gradients
    x 0.9 planted, which must differ; then each rank times its step and
    its gradient all-reduce; then per-rank shard reading of the frames
    at ``frames`` (mgpu_reader)."""
    import numpy as np
    import torch
    from tensorflow_ocr_tpu_torch.parallel import make_mesh, multihost
    from tensorflow_ocr_tpu_torch.parallel.dryrun import _agree
    from tensorflow_ocr_tpu_torch.train import trainer as T

    device = torch.device(device or "cuda:0")
    check(multihost.initialize(device=device, backend="gloo"),
          "no torchrun environment")
    group = make_mesh(2, device)
    check(group.backend == "gloo", f"the gloo group: {group}")
    cfg = train_config("fused")
    loss_fn = T.make_loss_fn(cfg)
    snap = seeded_snap(device)
    batch = train_batch(np.random.RandomState(38), device, TRAIN_BATCH,
                        TRAIN_SIZE)
    local = T.device_batch(batch, device, False, group, TRAIN_BATCH)
    torch.cuda.reset_peak_memory_stats(device)
    sound = planted = None
    with deterministic():
        state = T.create_train_state(cfg, device, weights=snap)
        m = T.train_step(state, local, cfg, loss_fn, group=group)
        torch.cuda.synchronize()
        check(float(m["n_pos"]) > 0, "phase 38 (b): no text in the batch")
        _agree(group, state, "phase 38 (b)")
        if group.rank == 0:
            ref = T.create_train_state(cfg, device, weights=snap)
            want = two_halves(ref, batch, cfg, loss_fn)
            diff = unequal(leaves(state), leaves(ref)) + unequal(m, want)
            sound = max_rel(leaves(state), leaves(ref))
            bad = T.create_train_state(cfg, device, weights=snap)
            two_halves(bad, batch, cfg, loss_fn, scale1=0.9)
            planted = max_rel(leaves(bad), leaves(state))
            del ref, bad
            check(not diff, f"phase 38 (b): two gloo ranks differ from "
                  f"the two-halves emulation at {diff[:4]} (max rel "
                  f"{sound:.3e})")
            check(planted > 0, "phase 38 (b): the planted fault (rank 1's "
                  "gradients x 0.9) reads as sound")
        step_ms = timed_ms(lambda: T.train_step(state, local, cfg, loss_fn,
                                                group=group))
    ar_ms, ar_bytes = allreduce_ms(group, state.model)
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    del state
    reader = mgpu_reader(group, device, frames, snap)
    mgpu_line("gloo", rank=group.rank, step_ms=step_ms, allreduce_ms=ar_ms,
              allreduce_bytes=ar_bytes, peak_gib=peak, max_rel=sound,
              planted_max_rel=planted,
              total_loss=float(m["total_loss"]), **reader)
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


def mgpu_reader(group, device, frames, snap):
    """(b) Per-rank shard reading on one gloo rank: ResumableLoader given
    the group (global batch MGPU_READ_BATCH of the frames at ``frames``,
    512^2, the host's crop and rotation on) against a world-1 loader on
    the same frames: its batches 0 .. MGPU_READ_TIMED bit-equal to the
    rank's rows of the world-1 batches, file names too; prepare_sample
    run B/2 times a batch against B; the state bytes equal on both ranks
    and to world-1's, and a fresh per-rank loader given rank 0's state
    after batch 0 replaying batch 1; one eager fused step from
    DevicePrefetcher(group) over the per-rank chain, bit-equal to the
    step on the rows the group cuts from the world-1 batch 0 and on both
    ranks, the fused kernels launched. The host seconds of a batch,
    per-rank and whole, timed over batches 1 .. MGPU_READ_TIMED (the
    frames decoded and cached by then: a warm read). Returns the fields
    of the rank's MGPU line."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from tensorflow_ocr_tpu_torch.data import icdar
    from tensorflow_ocr_tpu_torch.data.pipeline import (DevicePrefetcher,
                                                        PrefetchLoader)
    from tensorflow_ocr_tpu_torch.data.resumable import ResumableLoader
    from tensorflow_ocr_tpu_torch.parallel.dryrun import _agree
    from tensorflow_ocr_tpu_torch.train import trainer as T

    cfg = data_config(frames)
    cfg.data.batch_size = big = MGPU_READ_BATCH
    cfg.data.use_crop = cfg.data.use_rotate = True
    rows, seed = group.rows(big), 38
    calls = []
    prepare = icdar.prepare_sample

    def counted(*a, **k):
        calls.append(a[0])
        return prepare(*a, **k)

    def read(it):
        group.barrier()  # both ranks read alike at once
        n, t0 = len(calls), time.perf_counter()
        batch = next(it)
        return batch, len(calls) - n, time.perf_counter() - t0

    def same_rows(got, whole):
        return got["fns"] == whole["fns"][rows] and all(
            np.array_equal(got[k], whole[k][rows])
            for k in whole if k != "fns")

    icdar.prepare_sample = counted
    try:
        whole = ResumableLoader(cfg.data, seed=seed)
        mine = ResumableLoader(cfg.data, seed=seed, group=group)
        # batch 0: the whole reader decodes every frame (an epoch is one
        # batch), so the timed batches after it read the cache alike
        reads = [(read(whole), read(mine))]
        state = mine.get_state()
        for _ in range(MGPU_READ_TIMED):
            reads.append((read(whole), read(mine)))
        whole.stop()
        mine.stop()
        states = [None] * group.world
        dist.all_gather_object(states, state, group=group.group)
        fresh = ResumableLoader(cfg.data, seed=seed, group=group)
        fresh.set_state(states[0])  # rank 0's
        again = next(fresh)
        fresh.stop()
    finally:
        icdar.prepare_sample = prepare
    rows_equal = all(same_rows(m[0], w[0]) for w, m in reads)
    counts = sorted({(m[1], w[1]) for w, m in reads})
    check(rows_equal, f"phase 38 (b) reader: rank {group.rank}'s batches "
          f"differ from its rows of the world-1 batches")
    check(counts == [(big // group.world, big)],
          f"phase 38 (b) reader: prepare_sample calls (per rank, whole) a "
          f"batch {counts}")
    check(len(set(states)) == 1 and states[0] == whole.state_at(1),
          f"phase 38 (b) reader: the state bytes differ across the ranks "
          f"or from world-1's: {states}")
    check(same_rows(again, reads[1][0][0]),
          "phase 38 (b) reader: batch 1 resumed from rank 0's state differs")

    loss_fn = T.make_loss_fn(cfg)
    chain = DevicePrefetcher(
        PrefetchLoader(cfg.data, source=ResumableLoader(
            cfg.data, seed=seed, group=group)), device, group=group)
    with deterministic():
        try:
            batch = next(chain)
        finally:
            chain.stop()
        check(len(batch["images"]) == big // group.world,
              f"phase 38 (b) reader: the prefetcher gave "
              f"{len(batch['images'])} rows")
        a = T.create_train_state(cfg, device, weights=snap)
        reset_fused_counts()
        ma = T.train_step(a, T.device_batch(batch, device, False, group, big),
                          cfg, loss_fn, group=group)
        torch.cuda.synchronize()
        launched = fused_counts()
        b = T.create_train_state(cfg, device, weights=snap)
        mb = T.train_step(b, T.device_batch(reads[0][0][0], device, False,
                                            group, big),
                          cfg, loss_fn, group=group)
        diff = unequal(leaves(a), leaves(b)) + unequal(ma, mb)
        _agree(group, a, "phase 38 (b) reader step")
    check(not diff, f"phase 38 (b) reader: the step from the per-rank "
          f"reader differs from the step on the whole reader's rows at "
          f"{diff[:4]}")
    check(all(launched.values()), f"phase 38 (b) reader: fused launches "
          f"{launched}")
    check(float(ma["n_pos"]) > 0, "phase 38 (b) reader: no text")
    del a, b
    torch.cuda.empty_cache()
    return {"read_s_rank": [m[2] for _, m in reads[1:]],
            "read_s_whole": [w[2] for w, _ in reads[1:]],
            "read_calls": counts[0], "read_launches": launched,
            "read_loss": float(ma["total_loss"])}


def run_ranks(n, mode, frames=None):
    """``python -m torch.distributed.run --standalone --nproc_per_node=n
    chip_smoke.py --multigpu-rank mode [--multigpu-frames frames]``: its
    MGPU lines and seconds."""
    env = dict(os.environ, PYTHONPATH=REPO)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc_per_node={n}", os.path.join(REPO, "chip_smoke.py"),
         "--multigpu-rank", mode]
        + (["--multigpu-frames", frames] if frames else []),
        cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    dt = time.perf_counter() - t0
    lines = [json.loads(ln[5:]) for ln in proc.stdout.splitlines()
             if ln.startswith("MGPU ")]
    tail = "\n".join(ln for ln in proc.stdout.strip().splitlines()[-8:]
                     if not ln.startswith("MGPU "))
    print(f"phase 38 {mode}: {n} process(es), {dt:.1f} s, rc "
          f"{proc.returncode}\n{tail}")
    if proc.returncode != 0:
        print(proc.stdout[-3000:] + proc.stderr[-5000:], file=sys.stderr)
    check(proc.returncode == 0 and len(lines) == n,
          f"phase 38 {mode} failed")
    return lines, dt


def phase_multigpu():
    """Phase 38: (a) in a world-1 NCCL group, (b) on two gloo ranks of
    the one card (mgpu_graph_rank, mgpu_gloo_rank); prints each rank's
    step ms, all-reduce ms and peak memory with the card's name and
    power limit; the whole phase within MGPU_TIME_S."""
    t0 = time.perf_counter()
    card = card_line()
    (a,), _ = run_ranks(1, "graph")
    print(f"phase 38 (a) NCCL world 1 [{card}]: {a['steps']} captured "
          f"fused steps of {TRAIN_BATCH} at {TRAIN_SIZE}^2 bit-equal to "
          f"the steps with no group; fused launches at the capture "
          f"{a['captured']}; graph step {a['step_ms_group']:.3f} ms with "
          f"the all-reduces, {a['step_ms_plain']:.3f} ms without; the "
          f"gradient all-reduce alone {a['allreduce_ms']:.3f} ms for "
          f"{a['allreduce_bytes']} bytes; peak memory "
          f"{a['peak_gib']:.2f} GiB; spatial_forward at world 1: "
          f"{a['spatial_boxes']} boxes equal to the Predictor's, cc "
          f"launches {a['spatial_cc_launches']}; the fused arm's "
          f"{a['spatial_fused_boxes']} boxes and maps equal to its "
          f"Predictor's, launches {a['spatial_fused_launches']}")
    from tensorflow_ocr_tpu_torch.data.icdar import make_synthetic_dataset

    frames = scratch_dir("mgpu_frames_")
    make_synthetic_dataset(frames, MGPU_FRAMES, DATA_HW, seed=38)
    try:
        ranks, _ = run_ranks(2, "gloo", frames)
    finally:
        shutil.rmtree(frames, ignore_errors=True)
    for r in sorted(ranks, key=lambda r: r["rank"]):
        print(f"phase 38 (b) gloo rank {r['rank']} of 2 on one card "
              f"[{card}]: eager fused step of {TRAIN_BATCH // 2} "
              f"{r['step_ms']:.3f} ms, gradient all-reduce "
              f"{r['allreduce_ms']:.3f} ms for {r['allreduce_bytes']} "
              f"bytes, peak memory {r['peak_gib']:.2f} GiB"
              + ("" if r["max_rel"] is None else
                 f"; against the two-halves emulation max rel "
                 f"{r['max_rel']:.3e} (bit-equal), with rank 1's "
                 f"gradients x 0.9 planted {r['planted_max_rel']:.3e}"))
        per, whole = r["read_calls"]
        print(f"phase 38 (b) gloo rank {r['rank']} per-rank reader "
              f"[{card}]: {MGPU_READ_TIMED + 1} global batches of "
              f"{MGPU_READ_BATCH} from {MGPU_FRAMES} {DATA_HW[1]}x"
              f"{DATA_HW[0]} frames at {TRAIN_SIZE}^2 (crop and rotate "
              f"on the host), rows and file names bit-equal to the "
              f"world-1 loader's, prepare_sample {per} a batch against "
              f"{whole}; state bytes equal on both ranks and world-1's, "
              f"batch 1 resumed from rank 0's state bit-equal; one eager "
              f"fused step from DevicePrefetcher(group) bit-equal to the "
              f"whole reader's rows and across ranks, total loss "
              f"{r['read_loss']:.6f}, fused launches {r['read_launches']}; "
              f"host s a batch (warm) per-rank "
              f"{', '.join(f'{t:.4f}' for t in r['read_s_rank'])}, whole "
              f"{', '.join(f'{t:.4f}' for t in r['read_s_whole'])}; "
              f"ratio {sum(r['read_s_rank']) / sum(r['read_s_whole']):.3f}")
    dt = time.perf_counter() - t0
    print(f"phase 38: {dt:.1f} s (budget {MGPU_TIME_S:g} s)")
    check(dt <= MGPU_TIME_S, f"phase 38 took {dt:.1f} s")


# ----------------------------------- H-sharded serving of the kernel arms

SPATIAL_IMAGES = 2
SPATIAL_SHARDS = (2, 4)
# (label, bottleneck_impl, PALLAS_CONVS, float32, image (H, W), None for
# IMAGE_HW); at 1280x768 pick_gh admits no unit (its TPU VMEM arithmetic:
# block1's 320-pixel rows), so the ghost arm there would be the xla
# model: it runs at 512^2, where block1 and block2 take the ghost eval
# (5 units)
SPATIAL_ARMS = (("fused", "fused", False, False, None),
                ("fused f32", "fused", False, True, None),
                ("route", "xla", True, False, None),
                ("route f32", "xla", True, True, None),
                ("ghost", "ghost", False, False, (512, 512)))
# the stacked shards' maps against the whole image's, over the largest
# value: float32 runs the same kernels on the same rows (a shard's cuDNN
# convs, TF32 off, may take another algorithm than the whole image's);
# bfloat16 rounds once more or less where they do
SPATIAL_REL = {False: 1e-2, True: 1e-5}
SPATIAL_PROFILED = 10  # calls a forward's device time is read over


def spatial_kernels(impl, route, f32):
    """{name: wrapper} of the kernels an arm's sharded forward must launch
    on every shard (none for the ghost eval: plain ops, as in JAX)."""
    from tensorflow_ocr_tpu_torch.ops import conv as CV
    from tensorflow_ocr_tpu_torch.ops import fused as FU

    sfx = "_f32" if f32 else ""
    if impl == "fused":
        return {f"fused_conv_fwd{sfx}": FU.conv_fwd32 if f32 else FU.conv_fwd,
                f"fused_boundary_fwd{sfx}": (FU.boundary_fwd32 if f32
                                             else FU.boundary_fwd)}
    if route:
        return {f"conv_fwd_tma{sfx}": CV.tma_fwd32 if f32 else CV.tma_fwd}
    return {}


@contextlib.contextmanager
def spatial_kernel_checks(done, launched):
    """Inside the block each launch of the fused forward, the fused
    boundary and the route's forward products (ops/fused.py _launch_fwd,
    _launch_boundary_fwd, ops/conv.py _fwd) is listed in ``launched`` as
    (kernel, k, rows: a 3x3's height, a 1x1's pixel rows) and, at a shape
    not yet in ``done``, held against its plain version on the same
    inputs: bfloat16 outputs within one ulp (bf16_close), float32 by the
    float32 rule against the float64 result (f32_rule; the boundary within
    F32_BOUNDARY_ULPS of its plain version), the fused sums by sum_close.
    The plain versions launch no kernel."""
    import torch
    from tensorflow_ocr_tpu_torch.ops import conv as CV
    from tensorflow_ocr_tpu_torch.ops import fused as FU

    fwd, bnd, cfwd = FU._launch_fwd, FU._launch_boundary_fwd, CV._fwd
    f64 = torch.float64

    def new(key):
        fresh = key not in done
        done.add(key)
        return fresh

    def fused_fwd(x, ab, w):
        y, s = fwd(x, ab, w)
        f32, k = x.dtype == torch.float32, w.shape[-1]
        name = "fused_conv_fwd" + "_f32" * f32
        launched.append((name, k, x.shape[2] if k == 3 else x[:, 0].numel()))
        if new((name, tuple(x.shape), tuple(w.shape))):
            label = f"sharded {name} {tuple(x.shape)} {k}x{k}"
            py, ps = FU.conv_fwd_reference(x, ab, w)
            if f32:
                exact = FU.conv_fwd_reference(x.to(f64), ab.to(f64),
                                              w.to(f64))[0]
                f32_rule(label, y, py, exact)
            else:
                bf16_close(label, y, py)
            sum_close(f"{label} s0", s[0], ps[0],
                      py.float().abs().sum((0, 2, 3)))
            sum_close(f"{label} s1", s[1], ps[1], ps[1])
        return y, s

    def boundary_fwd(z, ab, zs, abs_):
        out = bnd(z, ab, zs, abs_)
        name = "fused_boundary_fwd" + "_f32" * (z.dtype == torch.float32)
        launched.append((name, 1, z[:, 0].numel()))
        if new((name, tuple(z.shape))):
            want = FU.boundary_fwd_reference(z, ab, zs, abs_)
            label = f"sharded {name} {tuple(z.shape)}"
            if z.dtype == torch.float32:
                ulps_close(label, out, want, F32_BOUNDARY_ULPS)
            else:
                bf16_close(label, out, want)
        return out

    def route_fwd(x, wt, n, h, w, ci, co, k, name):
        y = cfwd(x, wt, n, h, w, ci, co, k, name)
        f32 = x.dtype == torch.float32
        kernel = "conv_fwd_tma" + "_f32" * f32
        launched.append((kernel, k, h if k == 3 else n * h * w))
        if new((kernel, n, h, w, ci, co, k)):
            label = f"sharded {kernel} ({n}, {h}, {w}, {ci}) -> {co} {k}x{k}"

            def plain(xx, ww):
                if k == 1:
                    return CV.matmul_rows_reference(xx, ww.t())
                w4 = ww.reshape(co, 3, 3, ci).permute(0, 3, 1, 2)
                return CV.rows(CV.conv3_reference(CV.unrows(xx, n, h, w),
                                                  w4))

            py = plain(x, wt)
            if f32:
                f32_rule(label, y, py, plain(x.to(f64), wt.to(f64)))
            else:
                bf16_close(label, y, py)
        return y

    FU._launch_fwd, FU._launch_boundary_fwd = fused_fwd, boundary_fwd
    CV._fwd = route_fwd
    try:
        yield
    finally:
        FU._launch_fwd, FU._launch_boundary_fwd, CV._fwd = fwd, bnd, cfwd


def spatial_reads(seen, index, size, mode="sound"):
    """``models/layers.py`` SPATIAL for shard ``index`` of ``size`` on one
    card. ``mode`` "record" (one shard): each read of the whole images'
    forward appends its tensor to ``seen``; "sound": each read comes from
    that read's whole tensor in ``seen``, in order; "zero_halo", the
    planted fault: as "sound", with the rows of the other shards zeros."""
    from tensorflow_ocr_tpu_torch.parallel import spatial

    class Reads(spatial.HaloRows):
        def __init__(self):
            super().__init__(index, size)
            self.reads = iter(seen)

        def _exchange(self, x, need, lo, hi):
            if mode == "record":
                seen.append(x)
                return x[:, :, lo:hi]
            rows = next(self.reads)[:, :, lo:hi]
            if mode == "zero_halo":
                h = x.shape[2]
                a = max(self.index * h - lo, 0)
                b = max((self.index + 1) * h - lo, 0)
                rows = rows.clone()
                rows[:, :, :a] = 0
                rows[:, :, b:] = 0
            return rows

    return Reads()


@contextlib.contextmanager
def spatial_as(rows):
    """models.layers.SPATIAL set to ``rows`` inside the block."""
    from tensorflow_ocr_tpu_torch.models import layers as TL

    old, TL.SPATIAL = TL.SPATIAL, rows
    try:
        yield
    finally:
        TL.SPATIAL = old


def forward_cost(fn):
    """A forward's device busy ms by torch.profiler and its ms by CUDA
    events, each a call over SPATIAL_PROFILED calls, and the peak bytes
    one call allocates above what was allocated before it; after a
    warm-up call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    ms = cuda_ms(fn, SPATIAL_PROFILED)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(SPATIAL_PROFILED):
            fn()
        torch.cuda.synchronize()
    return device_busy_ms(prof) / SPATIAL_PROFILED, ms, peak


def phase_spatial_arms(device):
    """Phase 39: the kernel arms served sharded on H, each shard emulated
    on the one card (tests/test_torch_halo.py's pattern): a one-shard
    forward of the whole images records each row read (and must equal the
    plain forward), then each shard runs under a SPATIAL that slices its
    reads from those records. pixellink_resnet50 at full width,
    SPATIAL_IMAGES images (1280x768; the ghost arm 512^2), seeded weights
    (logits at unit spread), 2 and 4 shards, the five SPATIAL_ARMS
    (spatial_arm)."""
    import numpy as np
    import torch
    from tensorflow_ocr_tpu_torch.infer import Predictor
    from tensorflow_ocr_tpu_torch.models import resnet as TR

    t0 = time.perf_counter()
    card = card_line()
    images = {hw: scene_images(np.random.RandomState(39), SPATIAL_IMAGES,
                               hw)
              for hw in {None} | {a[-1] for a in SPATIAL_ARMS}}
    base = Predictor(MODEL, device=device)
    head_logit_scale(base, torch.from_numpy(images[None]).to(device),
                     ("pixel_logits", "link_logits"))
    weights = base.model.state_dict()
    del base
    ghost_eval = TR.GhostBottleneck._eval
    evals = []

    def counted_eval(self, o):
        evals.append(o.shape[2])
        return ghost_eval(self, o)

    TR.GhostBottleneck._eval = counted_eval
    try:
        for *arm, hw in SPATIAL_ARMS:
            spatial_arm(device, card, weights, images[hw], evals, *arm)
            torch.cuda.empty_cache()
    finally:
        TR.GhostBottleneck._eval = ghost_eval
    print(f"phase 39: {time.perf_counter() - t0:.1f} s")


def spatial_arm(device, card, weights, images, evals, label, impl, route,
                f32):
    """One arm of phase 39: the stacked shard maps within SPATIAL_REL of
    the whole forward's largest value; in float32 the boxes the CC kernel
    decodes from them equal to the whole forward's; the arm's kernels
    launched on every shard, at the extended heights printed, each held
    against its plain version at every shape the shards give it
    (spatial_kernel_checks); the ghost eval (``evals``: the units a
    forward ran it in) on every shard in the units the whole image takes;
    the zero-halo planted fault beyond the bound; one shard's device ms
    and peak memory beside the whole forward's, with the card's name and
    power limit. Each shard launches each kernel as often as the whole
    forward does: the route and the ghost band decide on the whole
    image's shape."""
    import numpy as np
    import torch
    from tensorflow_ocr_tpu_torch.infer import Predictor, pixel_link_scores
    from tensorflow_ocr_tpu_torch.ops import kernels as K
    from tensorflow_ocr_tpu_torch.ops.fused import full_f32

    dt = torch.float32 if f32 else torch.bfloat16
    p = Predictor(MODEL, weights=weights, device=device, dtype=dt,
                  bottleneck_impl=impl)
    kernels = spatial_kernels(impl, route, f32)
    bound = SPATIAL_REL[f32]
    x = torch.from_numpy(images).to(device)
    hs = images.shape[1]
    done, launched, seen = set(), [], []

    def shard_forward(n, q, mode="sound"):
        with spatial_as(spatial_reads(seen, q, n, mode)):
            return p.model(x[:, q * hs // n:(q + 1) * hs // n])

    def shards(n, mode="sound", checked=False):
        """The maps of the n shards stacked, and each shard's (launches,
        3x3 heights, ghost eval units)."""
        outs, per = [], []
        for q in range(n):
            for w in kernels.values():
                w.launches = 0
            launched.clear()
            evals.clear()
            with (spatial_kernel_checks(done, launched) if checked
                  else contextlib.nullcontext()):
                outs.append(shard_forward(n, q, mode))
            torch.cuda.synchronize()
            per.append(({k: w.launches for k, w in kernels.items()},
                        sorted({h for _, k, h in launched if k == 3},
                               reverse=True), len(evals)))
        return {k: torch.cat([o[k] for o in outs], 1) for k in outs[0]}, per

    with contextlib.ExitStack() as stack:
        stack.enter_context(pallas_convs(route))
        stack.enter_context(torch.inference_mode())
        if f32:
            stack.enter_context(full_f32())
        evals.clear()
        for w in kernels.values():
            w.launches = 0
        whole = p.model(x)
        whole_units = len(evals)
        whole_counts = {k: w.launches for k, w in kernels.items()}
        recorded = shard_forward(1, 0, "record")
        check(not unequal(recorded, whole), f"phase 39 {label}: the "
              "one-shard forward differs from the plain one")

        def rel(maps):
            return max(float((maps[k].float() - v.float()).abs().max()
                             / v.float().abs().max())
                       for k, v in whole.items())

        ps, ls = pixel_link_scores(whole)
        p.pixel_thresh = float(torch.quantile(ps.float().flatten()[::7],
                                              0.8))
        p.link_thresh = float(torch.quantile(ls.float().flatten()[::7], 0.3))
        K.connected_components.launches = 0
        want_boxes = p.detect_batch(images)
        torch.cuda.synchronize()
        check(K.connected_components.launches > 0 and sum(map(
            len, want_boxes)) > 0, f"phase 39 {label}: no CC launch or no "
            "box")
        check((whole_units > 0) == (impl == "ghost"),
              f"phase 39 {label}: {whole_units} ghost eval units")
        w_cost = forward_cost(lambda: p.model(x))
        for n in SPATIAL_SHARDS:
            stacked, per = shards(n, checked=True)
            err = rel(stacked)
            p.forward = lambda _, m=stacked: m
            got_boxes = p.detect_batch(images)
            p.forward = p.model
            same = all(len(g) == len(w) and all(
                np.array_equal(u, v) for u, v in zip(g, w))
                for g, w in zip(got_boxes, want_boxes))
            planted = rel(shards(n, "zero_halo")[0])
            s_cost = forward_cost(lambda: shard_forward(n, 1))
            for i, (counts, heights, units) in enumerate(per):
                print(f"phase 39 {label} {n} shards, shard {i}: launches "
                      f"{counts}, 3x3 kernel rows {heights}, ghost eval "
                      f"units {units} (whole image: {whole_counts}, "
                      f"{whole_units})")
            print(f"phase 39 {label} {n} shards [{card}]: maps "
                  f"max|stacked-whole|/max|whole| {err:.3e} (bound "
                  f"{bound:g}), zero-halo fault {planted:.3e}; boxes "
                  f"{[len(b) for b in got_boxes]} "
                  f"{'equal' if same else 'not equal'} to the whole "
                  f"forward's {[len(b) for b in want_boxes]}; shard 1 of "
                  f"{n}: device {s_cost[0]:.3f} ms, events "
                  f"{s_cost[1]:.3f} ms, peak {s_cost[2] / 2**20:.1f} MiB; "
                  f"whole: device {w_cost[0]:.3f} ms, events "
                  f"{w_cost[1]:.3f} ms, peak {w_cost[2] / 2**20:.1f} MiB")
            check(err <= bound, f"phase 39 {label} {n} shards: the stacked "
                  f"maps differ by {err:.3e}")
            check(planted > bound, f"phase 39 {label} {n} shards: the "
                  "zero-halo fault reads as sound")
            check(same or not f32, f"phase 39 {label} {n} shards: the "
                  "boxes differ from the whole forward's")
            check(all(all(c.values()) and c == whole_counts
                      and u == whole_units for c, _, u in per),
                  f"phase 39 {label} {n} shards: a shard did not launch "
                  "the whole image's kernels or run its ghost units")
    print(f"phase 39 {label}: {len(done)} kernel shapes held against their "
          "plain versions")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace serve, detect and train steps with "
                    "torch.profiler")
    ap.add_argument("--faults", action="store_true",
                    help="also read the fused, pallas-conv and ghost arm "
                    "checks under planted faults, from the augmented state "
                    "and from a trained checkpoint")
    ap.add_argument("--multigpu-rank", choices=("graph", "gloo"),
                    help=argparse.SUPPRESS)  # phase 38's ranks
    ap.add_argument("--multigpu-frames", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import shutil

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "tensorflow_ocr_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    if args.multigpu_rank == "graph":
        return mgpu_graph_rank()
    if args.multigpu_rank == "gloo":
        return mgpu_gloo_rank(args.multigpu_frames)
    t_start = time.perf_counter()
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
    conv32 = {name: {"name": name, "route": "cuda", "source": src,
                     "replaces": site}
              for name, (src, site) in CONV_F32_KERNELS.items()}
    fused32 = {name: {"name": name, "route": "cuda", "source": src,
                      "replaces": sites}
               for name, (_, src, sites) in FUSED_F32_KERNELS.items()}
    ghost = {name: {"name": name, "route": "cuda", "source": GHOST_SRC,
                    "replaces": sites}
             for name, (_, sites) in GHOST_KERNELS.items()}
    ghost32 = {name: {"name": name, "route": "cuda", "source": GHOST_SRC,
                      "replaces": sites}
               for name, (_, sites) in GHOST_F32_KERNELS.items()}
    phase_cc(device, report)
    phase_forward(device)
    phase_forward(device, EAST_MODEL)
    pred, images = phase_main_path(device, report)
    phase_timing(pred, images)
    if args.profile:
        phase_profile(pred, images)
    phase_conv_kernels(device, conv)
    phase_conv_kernels(device, conv, EAST_MODEL)
    phase_conv_detect(pred, images)
    phase_conv_kernels_f32(device, conv32)
    phase_conv_detect_f32(pred, images)
    phase_fused_detect_f32(pred, images)
    del pred
    torch.cuda.empty_cache()

    # the dataset of phase 32, and the state the arm gates are read from
    data_root, v2 = phase_data_write()
    arm_start, aug_ck = augmented_start(device, data_root,
                                        seeded_snap(device))
    phase_bf16_forward(device, arm_start, v2)

    phase_fused_kernels(device, fused)
    trainer, batch, snap = phase_train(device, fused, arm_start)
    phase_fused_kernels_f32(device, fused32)
    phase_fused_train_f32(device, fused32, snap, batch, arm_start)
    if args.faults:
        phase_fused_faults(device, arm_start, batch, "augmented")
        phase_fused_faults(device, arm_start, batch, "augmented", "float32")
        phase_conv_faults(device, arm_start, batch, "augmented")
        phase_conv_faults(device, arm_start, batch, "augmented", "float32")
    phase_conv_train(device, conv, snap, batch, arm_start)
    phase_conv_train_f32(device, conv32, snap, batch, arm_start)
    phase_ghost_kernels(device, ghost)
    phase_ghost_kernels_f32(device, ghost32)
    if args.faults:
        phase_ghost_faults(device, arm_start, batch, "augmented")
        phase_ghost_faults(device, arm_start, batch, "augmented", "float32")
    phase_ghost_train(device, ghost, snap, batch, arm_start)
    phase_ghost_train_f32(device, ghost32, snap, batch, arm_start)
    del arm_start

    ds = scene_dataset(device)
    phase_graph_step(device, snap, ds)
    root, served = phase_resume(device, serving_start(device, snap, images),
                                ds)
    phase_serve_checkpoint(device, root, served, images)
    if args.faults:
        trained = trained_start(device, snap, ds)
        phase_fused_faults(device, trained, batch, "trained")
        phase_conv_faults(device, trained, batch, "trained")
        phase_ghost_faults(device, trained, batch, "trained")
    phase_train_timing(trainer, batch)
    phase_graph_timing(trainer.state.model.state_dict(), ds, args.profile)
    if args.profile:
        phase_profile_train(trainer, batch)
    phase_pixellink_losses(device, snap, batch, ds)
    del trainer, ds
    torch.cuda.empty_cache()
    phase_data(device, snap, data_root, v2, aug_ck)
    shutil.rmtree(data_root)

    east_snap, east_batch, east_root = phase_east_train(device)
    phase_east_route(device, east_snap, east_batch)
    phase_east_variants(device, east_snap, east_batch)
    phase_east_serve(device, east_root)
    phase_east_calibrate(device, east_root)
    shutil.rmtree(east_root)
    del east_snap, east_batch
    phase_vgg(device, report)
    phase_link8(device, batch)
    phase_other_forwards(device)
    phase_backbones(device)
    phase_entry_points(device)
    phase_multigpu()
    phase_spatial_arms(device)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{k: r[k] for k in keys}
               for r in [report, *fused.values(), *conv.values(),
                         *conv32.values(), *fused32.values(),
                         *ghost.values(), *ghost32.values()]]
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s, builds "
          f"included")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
