"""The train entry under torchrun on 2 CPU ranks.

``python -m torch.distributed.run --standalone --nproc_per_node=2 -m
tensorflow_ocr_tpu_torch.cli.multigpu_train ... --device=cpu``: each
rank starts a gloo group from torchrun's environment
(``parallel/multihost.py`` ``initialize``), the global batch is
``batch_size_per_gpu`` x 2, and 2 steps of pixellink_tiny at 64x64 train
on a 4-image synthetic set. Rank 0 alone prints the step lines and
writes ``ckpt_2`` and its operating point; both ranks exit 0.
"""

import os
import subprocess
import sys

import torch

from tensorflow_ocr_tpu_torch.data.icdar import make_synthetic_dataset
from test_torch_rank_worker import REPO

torch.set_num_threads(1)


def test_multigpu_train_under_torchrun(tmp_path):
    data = str(tmp_path / "scenes")
    make_synthetic_dataset(data, num_images=4, size=(128, 128), seed=43)
    ck = str(tmp_path / "ckpt") + "/"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2", "-m",
         "tensorflow_ocr_tpu_torch.cli.multigpu_train",
         f"--training_data_path={data}", "--input_size=64",
         "--batch_size_per_gpu=2", "--max_steps=2",
         f"--checkpoint_path={ck}", "--save_checkpoint_steps=0",
         "--model.name=pixellink_tiny", "--data.max_polys=8",
         "--train.num_devices=2", "--train.log_every_steps=1",
         "--device=cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    out = proc.stdout
    # one line a step, rank 0's, with the whole world's 4 images a step
    assert out.count("Step 000000, model loss") == 1, out
    assert out.count("Step 000001, model loss") == 1, out
    assert sorted(n for n in os.listdir(ck) if n.startswith("ckpt_")) == \
        ["ckpt_2"]
    assert "operating_point.json" in os.listdir(ck)
