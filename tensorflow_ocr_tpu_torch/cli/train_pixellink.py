"""PixelLink training entry point: the port's ``train_pixellink.py``.

    python -m tensorflow_ocr_tpu_torch.cli.train_pixellink \
        --training_data_path=... --checkpoint_path=./ohem_logs/ \
        --learning_rate=1e-3

The recipe's defaults (train_pixellink.py:18-48): ``pixellink_vgg16``,
the OHEM loss, the momentum optimizer; then the flags as
``cli/multigpu_train.py`` takes them, and the same loop.
"""

from __future__ import annotations

import sys


def main(argv):
    from tensorflow_ocr_tpu_torch.cli import take_flag
    from tensorflow_ocr_tpu_torch.cli.multigpu_train import train
    from tensorflow_ocr_tpu_torch.config import Config, parse_flags

    argv = list(argv)
    device = take_flag(argv, "device", "cuda")
    cfg = Config()
    cfg.model.name = "pixellink_vgg16"
    cfg.loss.name = "ohem"
    cfg.train.optimizer = "momentum"
    return train(parse_flags(argv, cfg), device)


if __name__ == "__main__":
    main(sys.argv[1:])
