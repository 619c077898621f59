"""The port's entry points, counterparts of the repository's root scripts
with the same flags (``config.py`` ``parse_flags``), plus ``--device``
(default ``cuda``; the CPU only when asked, ``--device=cpu``):

    python -m tensorflow_ocr_tpu_torch.cli.multigpu_train ...  # train
    python -m tensorflow_ocr_tpu_torch.cli.train_pixellink ... # VGG recipe
    python -m tensorflow_ocr_tpu_torch.cli.test ...            # detect
    python -m tensorflow_ocr_tpu_torch.cli.test_pixellink_fast ...
    python -m tensorflow_ocr_tpu_torch.cli.test_pixellink ...
"""

from __future__ import annotations

from typing import List, Optional


def take_flag(argv: List[str], name: str, default: Optional[str] = None
              ) -> Optional[str]:
    """Remove ``--name=value`` or ``--name value`` from ``argv`` (in place)
    and return its value, else ``default``."""
    for i, a in enumerate(argv):
        if a == f"--{name}" and i + 1 < len(argv):
            value = argv[i + 1]
            del argv[i:i + 2]
            return value
        if a.startswith(f"--{name}="):
            del argv[i]
            return a.split("=", 1)[1]
    return default
