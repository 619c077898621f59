"""tensorflow_ocr_tpu_torch — the PyTorch/CUDA port of tensorflow_ocr_tpu.

The JAX package beside it is the reference; this package mirrors its
layout so each module has a counterpart:

- ``models``   — ResNet-v1 and tiny backbones, the PixelLink head, the
                 detector registry, and the Flax-tree -> state_dict bridge
                 (``models/convert.py``).
- ``ops``      — PixelLink decode (link adjacency, connected components,
                 min-area boxes) and the hand-written CUDA connected-
                 components kernel with its plain PyTorch version
                 (``ops/kernels.py``, sources in ``csrc/``).
- ``utils``    — image resize.
- ``infer.py`` — Predictor: forward + on-device decode for serving.

Importing this package needs neither ``nvcc`` nor a GPU: the CUDA kernel
is compiled on first use on a CUDA tensor.
"""

__version__ = "0.1.0"
