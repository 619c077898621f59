#!/usr/bin/env python
"""Export a JAX checkpoint's inference weights for the PyTorch port.

Usage:
    python scripts/export_torch_weights.py --checkpoint /tmp/ckpt/ \
        --model pixellink_resnet50 --out /tmp/torch/weights.npz [--no-ema]

Restores the checkpoint with the JAX package (EMA parameters and BN
running statistics, as tensorflow_ocr_tpu/infer.py does for inference)
and writes one flat ``.npz`` keyed by ``/``-joined Flax paths
(``params/backbone/conv1/Conv_0/kernel``, ``batch_stats/...``).
``tensorflow_ocr_tpu_torch.models.convert.load_npz`` and
``tensorflow_ocr_tpu_torch.infer.Predictor(weights=path)`` read it. A
calibrated ``operating_point.json`` in the checkpoint directory is copied
beside the ``.npz``, where the port's Predictor looks for it. Needs JAX,
not torch.
"""

from __future__ import annotations

import argparse
import os
import shutil
from collections.abc import Mapping

import numpy as np


def flatten(tree: Mapping, prefix: str = "") -> dict:
    """Nested variables -> {"params/a/b": np.ndarray}."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(flatten(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def restore_variables(model_name: str, checkpoint: str,
                      use_ema: bool = True) -> dict:
    """{"params": ..., "batch_stats": ...} of the newest checkpoint under
    ``checkpoint`` (or of ``checkpoint`` itself, a ``ckpt_<step>`` dir)."""
    import jax
    import jax.numpy as jnp

    from tensorflow_ocr_tpu.config import Config
    from tensorflow_ocr_tpu.train import trainer as T

    cfg = Config()
    cfg.model.name = model_name
    _, template, _ = T.create_train_state(
        cfg, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32))
    ckpt = T.latest_checkpoint(checkpoint) or checkpoint
    state = T.restore_checkpoint_for_inference(ckpt, template)
    variables = {"params": state.ema_params if use_ema else state.params}
    if state.batch_stats:
        variables["batch_stats"] = state.batch_stats
    return jax.device_get(variables)


def export(model_name: str, checkpoint: str, out: str,
           use_ema: bool = True) -> str:
    """Write the flat ``.npz`` (and the operating point, if any)."""
    from tensorflow_ocr_tpu.train.calibrate import OPERATING_POINT_FILE

    variables = restore_variables(model_name, checkpoint, use_ema)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "wb") as f:
        np.savez(f, **flatten(variables))
    op = os.path.join(checkpoint, OPERATING_POINT_FILE)
    if os.path.exists(op):
        shutil.copy(op, os.path.join(os.path.dirname(os.path.abspath(out)),
                                     OPERATING_POINT_FILE))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", required=True,
                    help="checkpoint root (newest ckpt_* is used) or one "
                         "ckpt_<step> directory")
    ap.add_argument("--model", default="pixellink_resnet50")
    ap.add_argument("--out", required=True, help="path of the .npz")
    ap.add_argument("--no-ema", action="store_true",
                    help="export the raw parameters instead of the EMA")
    args = ap.parse_args(argv)
    out = export(args.model, args.checkpoint, args.out,
                 use_ema=not args.no_ema)
    print(f"wrote {out} (model={args.model}, ema={not args.no_ema})")


if __name__ == "__main__":
    main()
