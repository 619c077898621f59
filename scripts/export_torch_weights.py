#!/usr/bin/env python
"""Export a JAX checkpoint's inference weights, or its whole train state,
for the PyTorch port.

Usage:
    python scripts/export_torch_weights.py --checkpoint /tmp/ckpt/ \
        --model pixellink_resnet50 --out /tmp/torch/weights.npz [--no-ema]
    python scripts/export_torch_weights.py --checkpoint /tmp/ckpt/ \
        --model east_resnet50 --geometry QUAD --out /tmp/torch/weights.npz
    python scripts/export_torch_weights.py --checkpoint /tmp/ckpt/ \
        --model pixellink_resnet50 --out /tmp/torch_ckpt/ --train-state \
        [--optimizer adam|momentum] [--weight-decay 1e-5]

Restores the checkpoint with the JAX package (EMA parameters and BN
running statistics, as tensorflow_ocr_tpu/infer.py does for inference)
and writes one flat ``.npz`` keyed by ``/``-joined Flax paths
(``params/backbone/conv1/Conv_0/kernel``, ``batch_stats/...``).
``tensorflow_ocr_tpu_torch.models.convert.load_npz`` and
``tensorflow_ocr_tpu_torch.infer.Predictor(weights=path)`` read it. A
calibrated ``operating_point.json`` in the checkpoint directory is copied
beside the ``.npz``, where the port's Predictor looks for it. Needs JAX,
not torch.

With ``--train-state`` the whole train state is restored (parameters, BN
statistics, the optimizer's state and the EMA: the optimizer and weight
decay given must be the ones it was trained with, since they shape the
optax state) and written as a port checkpoint, ``<out>/ckpt_<step>/``
(``tensorflow_ocr_tpu_torch.models.convert.convert_train_state``), that
the port's ``Trainer`` resumes from with ``restore=True`` and its
``Predictor(checkpoint_path=out)`` serves; the operating point is copied
to ``<out>``. That needs JAX and torch, so it runs where both are
installed, not on the card.
"""

from __future__ import annotations

import argparse
import os
import shutil
from collections.abc import Mapping

import numpy as np

# the models of the port's registry (tensorflow_ocr_tpu_torch/models/
# detector.py MODEL_REGISTRY; tests/test_torch_export.py holds the two
# equal): the ones whose weights the port can load
PORT_MODELS = ("pixellink_resnet50", "pixellink_resnet101",
               "pixellink_vgg16", "pixellink2s_vgg16", "east_resnet50",
               "east_resnet101", "east_vgg16", "link8_resnet50",
               "pixellink_resnetv2_50", "east_resnetv2_50",
               "pixellink_resnet152", "east_resnet152",
               "pixellink_resnet200", "east_resnet200",
               "pixellink_tiny", "east_tiny")


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
                      use_ema: bool = True, geometry: str = "RBOX") -> dict:
    """{"params": ..., "batch_stats": ...} of the newest checkpoint under
    ``checkpoint`` (or of ``checkpoint`` itself, a ``ckpt_<step>`` dir)."""
    import jax
    import jax.numpy as jnp

    from tensorflow_ocr_tpu.config import Config
    from tensorflow_ocr_tpu.train import trainer as T

    cfg = Config()
    cfg.model.name = model_name
    cfg.data.geometry = geometry
    _, template, _ = T.create_train_state(
        cfg, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32))
    ckpt = T.latest_checkpoint(checkpoint) or checkpoint
    state = T.restore_checkpoint_for_inference(ckpt, template)
    variables = {"params": state.ema_params if use_ema else state.params}
    if state.batch_stats:
        variables["batch_stats"] = state.batch_stats
    return jax.device_get(variables)


def export(model_name: str, checkpoint: str, out: str,
           use_ema: bool = True, geometry: str = "RBOX") -> str:
    """Write the flat ``.npz`` (and the operating point, if any)."""
    from tensorflow_ocr_tpu.train.calibrate import OPERATING_POINT_FILE

    variables = restore_variables(model_name, checkpoint, use_ema, geometry)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "wb") as f:
        np.savez(f, **flatten(variables))
    op = os.path.join(checkpoint, OPERATING_POINT_FILE)
    if os.path.exists(op):
        shutil.copy(op, os.path.join(os.path.dirname(os.path.abspath(out)),
                                     OPERATING_POINT_FILE))
    return out


def export_train_state(model_name: str, checkpoint: str, out: str,
                       optimizer: str = "adam",
                       weight_decay: float = 1e-5,
                       geometry: str = "RBOX") -> str:
    """Write the newest checkpoint's whole train state under ``checkpoint``
    as a port checkpoint under the root ``out``; returns its directory."""
    import jax
    import jax.numpy as jnp

    from tensorflow_ocr_tpu.config import Config
    from tensorflow_ocr_tpu.train import trainer as T
    from tensorflow_ocr_tpu.train.calibrate import OPERATING_POINT_FILE
    from tensorflow_ocr_tpu_torch.models.convert import convert_train_state
    from tensorflow_ocr_tpu_torch.train.trainer import write_checkpoint

    cfg = Config()
    cfg.model.name = model_name
    cfg.model.weight_decay = weight_decay
    cfg.train.optimizer = optimizer
    cfg.data.geometry = geometry
    _, template, _ = T.create_train_state(
        cfg, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32))
    ckpt = T.latest_checkpoint(checkpoint) or checkpoint
    state = jax.device_get(T.restore_checkpoint(ckpt, template))
    d = write_checkpoint(out, convert_train_state(state))
    op = os.path.join(checkpoint, OPERATING_POINT_FILE)
    if os.path.exists(op):
        shutil.copy(op, os.path.join(out, OPERATING_POINT_FILE))
    return d


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", required=True,
                    help="checkpoint root (newest ckpt_* is used) or one "
                         "ckpt_<step> directory")
    ap.add_argument("--model", default="pixellink_resnet50",
                    choices=PORT_MODELS)
    ap.add_argument("--geometry", default="RBOX", choices=("RBOX", "QUAD"),
                    help="the EAST head's geometry the checkpoint was "
                         "trained with")
    ap.add_argument("--out", required=True,
                    help="path of the .npz, or with --train-state the port "
                         "checkpoint root")
    ap.add_argument("--no-ema", action="store_true",
                    help="export the raw parameters instead of the EMA")
    ap.add_argument("--train-state", action="store_true",
                    help="export the whole train state as a port checkpoint")
    ap.add_argument("--optimizer", default="adam", choices=("adam",
                                                            "momentum"),
                    help="the optimizer the state was trained with")
    ap.add_argument("--weight-decay", type=float, default=1e-5,
                    help="the weight decay the state was trained with")
    args = ap.parse_args(argv)
    if args.train_state:
        out = export_train_state(args.model, args.checkpoint, args.out,
                                 args.optimizer, args.weight_decay,
                                 args.geometry)
        print(f"wrote {out} (model={args.model}, train state)")
        return
    out = export(args.model, args.checkpoint, args.out,
                 use_ema=not args.no_ema, geometry=args.geometry)
    print(f"wrote {out} (model={args.model}, ema={not args.no_ema})")


if __name__ == "__main__":
    main()
