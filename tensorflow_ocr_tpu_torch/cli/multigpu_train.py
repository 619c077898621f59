"""Training entry point: the port's ``multigpu_train.py``.

    python -m tensorflow_ocr_tpu_torch.cli.multigpu_train \
        --training_data_path=/data/ocr/icdar2015/ --input_size=512 \
        --batch_size_per_gpu=14 --checkpoint_path=/tmp/east_resnet_v1_50_rbox/

The root script's flags (``config.py`` ``FLAG_ALIASES`` and dotted paths;
``--gpu_list`` accepted and ignored), ``--preset=N`` for a
``configs.py`` preset (applied before the other flags), and ``--device``.
The global batch is ``batch_size_per_gpu`` x the ranks, as JAX's
``batch_size_per_gpu`` x the devices. Data parallel, one process per GPU
(NCCL; ``--device=cpu`` runs gloo ranks on the CPU):

    python -m torch.distributed.run --nproc_per_node=8 \
        -m tensorflow_ocr_tpu_torch.cli.multigpu_train --preset=5 ...

Each rank's loader prepares only its rows of each global batch
(``ResumableLoader(group=...)``), and the loader state in rank 0's
checkpoint resumes every rank; rank 0 alone prints, writes summaries,
checkpoints and the operating point. With
``--train.use_device_cache`` the data is staged on the device
(``Trainer.run_device_cached``), else it streams from the host
(``ResumableLoader -> PrefetchLoader -> DevicePrefetcher`` into
``Trainer.run``). Ends with a checkpoint and its calibrated operating
point (multigpu_train.py:20-75).
"""

from __future__ import annotations

import os
import sys


def train(cfg, device: str):
    """Train ``cfg`` on ``device`` (this rank's part of the process group
    where there is one), save the final checkpoint and calibrate it;
    returns the Trainer."""
    from tensorflow_ocr_tpu_torch.data.pipeline import (DevicePrefetcher,
                                                        PrefetchLoader)
    from tensorflow_ocr_tpu_torch.data.resumable import ResumableLoader
    from tensorflow_ocr_tpu_torch.parallel.mesh import make_mesh
    from tensorflow_ocr_tpu_torch.train.trainer import Trainer
    from tensorflow_ocr_tpu_torch.utils.summary import SummaryWriter

    group = make_mesh(cfg.train.num_devices, device)
    # reference semantics: global batch = batch_size_per_gpu * ranks
    cfg.data.batch_size *= group.world
    writer = None
    if group.rank == 0:
        os.makedirs(cfg.train.checkpoint_path, exist_ok=True)
        writer = SummaryWriter(cfg.train.checkpoint_path)
    trainer = Trainer(cfg, device, summary_writer=writer, group=group)
    if cfg.train.use_device_cache:
        trainer.run_device_cached(max_steps=cfg.train.max_steps)
    else:
        trainer.setup()
        source = ResumableLoader(cfg.data, want_east=trainer.want_east,
                                 seed=cfg.train.seed, group=group)
        loader = DevicePrefetcher(
            PrefetchLoader(cfg.data, want_east=trainer.want_east,
                           source=source),
            trainer.device, want_east=trainer.want_east, group=group)
        try:
            trainer.run(loader, max_steps=cfg.train.max_steps)
        finally:
            loader.stop()
    trainer.save()
    trainer._maybe_calibrate()  # the operating point of the final save
    return trainer


def main(argv):
    from tensorflow_ocr_tpu_torch.cli import take_flag
    from tensorflow_ocr_tpu_torch.config import Config, parse_flags
    from tensorflow_ocr_tpu_torch.configs import baseline_config

    from tensorflow_ocr_tpu_torch.parallel import multihost

    argv = list(argv)
    device = take_flag(argv, "device", "cuda")
    preset = take_flag(argv, "preset")
    # before the flags: validate reads the process group's size
    started = multihost.initialize(device=device)
    try:
        cfg = baseline_config(int(preset)) if preset is not None \
            else Config()
        return train(parse_flags(argv, cfg), device)
    finally:
        if started:
            import torch.distributed as dist

            dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
