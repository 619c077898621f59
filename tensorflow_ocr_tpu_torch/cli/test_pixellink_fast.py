"""PixelLink detection at a fixed 1280x768: the port's
``test_pixellink_fast.py``.

    python -m tensorflow_ocr_tpu_torch.cli.test_pixellink_fast \
        --test_data_path=./icdar_test/ --checkpoint_path=./ohem_logs/ \
        --output_dir=./tmp/

Defaults of the root script (test_pixellink_fast.py:31-40):
``pixellink_vgg16``, link threshold 0.9, and the flag thresholds as given
(no calibrated operating point unless
``--infer.use_calibrated_thresholds=true``). Each image is resized to
1280x768 (``codec.resize``), decoded on the stride-4 grid, its boxes
scaled back to the image (:47-97) and written as ``res_*.txt`` and an
overlay; two images are in flight while the oldest is finished
(``Predictor.detect_batches``, depth 2).
"""

from __future__ import annotations

import sys
from collections import deque

WIDTH, HEIGHT = 1280, 768  # test_pixellink_fast.py:41


def main(argv):
    import numpy as np

    from tensorflow_ocr_tpu_torch.cli import take_flag
    from tensorflow_ocr_tpu_torch.cli.test import predictor_for, inference_aliases
    from tensorflow_ocr_tpu_torch.config import Config, parse_flags
    from tensorflow_ocr_tpu_torch.data import codec
    from tensorflow_ocr_tpu_torch.utils.image import (get_test_images,
                                                      write_overlay,
                                                      write_result_txt)

    argv = list(argv)
    device = take_flag(argv, "device", "cuda")
    cfg = Config()
    cfg.model.name = "pixellink_vgg16"
    cfg.infer.link_conf_threshold = 0.9
    cfg.infer.use_calibrated_thresholds = False
    cfg = parse_flags(argv, cfg, inference_aliases())
    icfg = cfg.infer
    predictor = predictor_for(cfg, device)
    read: deque = deque()

    def batches():
        for im_fn in get_test_images(icfg.test_data_path):
            im_bgr = codec.imread(im_fn)
            if im_bgr is None:
                continue
            read.append((im_fn, im_bgr))
            yield codec.resize(im_bgr, (WIDTH, HEIGHT))[None, :, :, ::-1]

    for (boxes,) in predictor.detect_batches(batches(), depth=2):
        im_fn, im_bgr = read.popleft()
        h0, w0 = im_bgr.shape[:2]
        scale = np.array([w0 / WIDTH, h0 / HEIGHT], np.float32)
        boxes = [b * scale for b in boxes]
        print(f"{im_fn}: {len(boxes)} boxes")
        write_result_txt(icfg.output_dir, im_fn, boxes)
        write_overlay(icfg.output_dir, im_fn, im_bgr, boxes)


if __name__ == "__main__":
    main(sys.argv[1:])
