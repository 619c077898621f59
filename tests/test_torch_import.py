"""The port imports without JAX, the JAX package, cv2, triton, nvcc or a GPU.

Every module, the train step's included: ``triton`` stays out of
``sys.modules`` and no kernel is built at import time.

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
print(json.dumps({"modules": names,
                  "loaded": [m for m in ("jax", "tensorflow_ocr_tpu", "cv2",
                                         "triton") if m in sys.modules]}))
"""


def test_port_imports_without_jax_or_cv2():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []
    for mod in ("config", "infer", "models.convert", "models.detector",
                "models.resnet", "ops.conv", "ops.decode", "ops.fused",
                "ops.kernels", "ops.labels", "ops.losses", "ops.rasterize",
                "train.optim", "train.trainer", "utils.image"):
        assert f"tensorflow_ocr_tpu_torch.{mod}" in out["modules"]
