"""Detection entry point: the port's ``test.py`` (ICDAR submission).

    python -m tensorflow_ocr_tpu_torch.cli.test --test_data_path=./exhibition \
        --checkpoint_path=/tmp/east_icdar2015_resnet_v1_50_rbox/ \
        --output_dir=/tmp/res/

Serves the EMA weights of the newest checkpoint under
``--checkpoint_path`` (here ``infer.checkpoint_path``, test.py:31-33) with
its calibrated operating point, detects each image of
``--test_data_path`` (read by ``codec.imread``, resized by
``resize_image``), orders each box's points and writes ``res_<name>.txt``
(CRLF, 8 ints a line) and the overlay to ``--output_dir``. ``--device``
as in the train entry.
"""

from __future__ import annotations

import sys


def predictor_for(cfg, device: str):
    """The Predictor of ``cfg``: its model, compute dtype, EAST geometry
    and scale, and ``cfg.infer`` (thresholds, ``checkpoint_path``)."""
    from tensorflow_ocr_tpu_torch.infer import Predictor
    from tensorflow_ocr_tpu_torch.train.trainer import DTYPES

    return Predictor(cfg.model.name, device=device,
                     dtype=DTYPES[cfg.model.compute_dtype], infer=cfg.infer,
                     geometry=cfg.data.geometry,
                     text_scale=cfg.model.text_scale)


def inference_aliases() -> dict:
    """FLAG_ALIASES with ``checkpoint_path`` read as the inference
    checkpoint (test.py:31-33)."""
    from tensorflow_ocr_tpu_torch.config import FLAG_ALIASES

    aliases = dict(FLAG_ALIASES)
    aliases["checkpoint_path"] = "infer.checkpoint_path"
    return aliases


def main(argv):
    import numpy as np

    from tensorflow_ocr_tpu_torch.cli import take_flag
    from tensorflow_ocr_tpu_torch.config import Config, parse_flags
    from tensorflow_ocr_tpu_torch.data import codec
    from tensorflow_ocr_tpu_torch.ops.geometry import order_points
    from tensorflow_ocr_tpu_torch.utils.image import (get_test_images,
                                                      write_overlay,
                                                      write_result_txt)

    argv = list(argv)
    device = take_flag(argv, "device", "cuda")
    aliases = inference_aliases()
    aliases["input_size"] = "data.input_size"
    cfg = parse_flags(argv, Config(), aliases)
    predictor = predictor_for(cfg, device)
    for im_fn in get_test_images(cfg.infer.test_data_path):
        im_bgr = codec.imread(im_fn)
        if im_bgr is None:
            continue
        boxes, net_ms = predictor.detect(im_bgr[:, :, ::-1])
        print(f"{im_fn}: {len(boxes)} boxes, net time {net_ms:.1f} ms")
        ordered = [order_points(np.asarray(b)) for b in boxes]
        write_result_txt(cfg.infer.output_dir, im_fn, ordered)
        write_overlay(cfg.infer.output_dir, im_fn, im_bgr, ordered)


if __name__ == "__main__":
    main(sys.argv[1:])
