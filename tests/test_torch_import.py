"""The port imports without JAX, the JAX package, cv2, triton, nvcc or a GPU.

Every module, the train step, the checkpoints and the multi-step dispatch
(train/trainer.py), the summaries and the profiling helpers, the data
tier (the codec, the readers, the loaders, the device dataset and the
augmentation), the quality loop (eval/, the eval hook, calibration) and
ResNet-v2 included, and since the entry points' slice the command-line
entries (``cli/``), the presets, the serving export and the slim import,
and the multi-GPU modules (``parallel/``): ``triton`` stays out of
``sys.modules``, no kernel is built at import time and no process group
is started.

Runs in a subprocess: tests/conftest.py imports jax into every pytest
process, so only a fresh interpreter can show what the port pulls in.
"""

import json
import os
import subprocess
import sys

import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, json, pkgutil, sys
import tensorflow_ocr_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import torch.distributed as dist
print(json.dumps({"modules": names,
                  "loaded": [m for m in ("jax", "tensorflow_ocr_tpu", "cv2",
                                         "triton") if m in sys.modules],
                  "process_group": dist.is_initialized()}))
"""


def test_port_imports_without_jax_or_cv2():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []
    # importing the port starts no process group
    assert out["process_group"] is False
    for mod in ("cli", "cli.multigpu_train", "cli.test",
                "cli.test_pixellink", "cli.test_pixellink_fast",
                "cli.train_pixellink", "config", "configs", "export",
                "train.pretrained", "data.codec", "data.device_augment",
                "data.device_cache", "data.icdar", "data.nvjpeg_loader",
                "data.pipeline", "data.resumable", "eval.bboxes",
                "eval.metrics", "infer", "models.convert",
                "models.detector", "models.heads", "models.resnet",
                "models.resnet_v2", "models.vgg", "ops.conv", "ops.decode",
                "parallel", "parallel.dryrun", "parallel.mesh",
                "parallel.multihost", "parallel.spatial",
                "ops.fused", "ops.geometry", "ops.kernels", "ops.labels",
                "ops.losses", "ops.rasterize", "train.calibrate",
                "train.eval_hook", "train.optim", "train.trainer",
                "utils.image", "utils.nms", "utils.profiling",
                "utils.summary"):
        assert f"tensorflow_ocr_tpu_torch.{mod}" in out["modules"]
