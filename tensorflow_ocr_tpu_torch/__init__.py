"""tensorflow_ocr_tpu_torch — the PyTorch/CUDA port of tensorflow_ocr_tpu.

The JAX package beside it is the reference; this package mirrors its
layout so each module has a counterpart:

- ``models``   — ResNet-v1, ResNet-v2, VGG-16 and tiny backbones, the
                 PixelLink, EAST and link8 heads, the detector registry,
                 and the Flax-tree -> state_dict bridge
                 (``models/convert.py``).
- ``eval``     — detection matching and streaming P/R/F.
- ``train``    — the train step, the trainer, the eval hook and
                 checkpoint-time threshold calibration.
- ``ops``      — PixelLink decode (link adjacency, connected components,
                 min-area boxes) and the hand-written CUDA connected-
                 components kernel with its plain PyTorch version
                 (``ops/kernels.py``, sources in ``csrc/``).
- ``parallel`` — multi-GPU: the data-parallel group and its collectives
                 (``mesh.py``), process-group start-up (``multihost.py``),
                 serving sharded on image height with halo exchange
                 (``spatial.py``) and a multi-rank dry run
                 (``dryrun.py``); one process a GPU over
                 ``torch.distributed`` (NCCL on the card, gloo on the CPU).
- ``utils``    — image resize.
- ``infer.py`` — Predictor: forward + on-device decode for serving.

Importing this package needs neither ``nvcc`` nor a GPU: the CUDA kernel
is compiled on first use on a CUDA tensor.
"""

__version__ = "0.1.0"
