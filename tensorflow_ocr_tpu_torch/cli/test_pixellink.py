"""PixelLink detection with the larger group threshold: the port's
``test_pixellink.py``: ``cli/test_pixellink_fast.py`` with
``--infer.min_component_size=12`` appended (test_pixellink.py:16-23).
"""

from __future__ import annotations

import sys


def main(argv):
    from tensorflow_ocr_tpu_torch.cli import test_pixellink_fast

    return test_pixellink_fast.main(
        list(argv) + ["--infer.min_component_size=12"])


if __name__ == "__main__":
    main(sys.argv[1:])
