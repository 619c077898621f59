"""The five BASELINE.json configurations as presets of the port.

Port of ``tensorflow_ocr_tpu/configs.py:22-60``: ``baseline_config(n)``
sets the fields JAX's preset ``n`` sets, on the port's
:class:`~tensorflow_ocr_tpu_torch.config.Config`. The train entry points
take it as ``--preset=N`` (``cli/multigpu_train.py``).

1. EAST VGG-16 at 512, batch 2, one step on one device;
2. EAST ResNet-50 RBOX at 512, batch 14, the EAST loss;
3. PixelLink VGG-16 (2s head), OHEM, link threshold 0.9;
4. EAST ResNet-50 with the focal loss at 768, batch 8, random scale, crop
   and rotation;
5. data-parallel EAST ResNet-50 RBOX at 512, a global batch of 224 over
   16 ranks (``num_devices`` 16: its Trainer and ``Config.validate``
   refuse a world of another size).
"""

from __future__ import annotations

from tensorflow_ocr_tpu_torch.config import Config


def baseline_config(n: int) -> Config:
    cfg = Config()
    if n == 1:
        cfg.model.name = "east_vgg16"
        cfg.loss.name = "east"
        cfg.data.input_size = 512
        cfg.data.batch_size = 2
        cfg.train.num_devices = 1
        cfg.train.max_steps = 1
    elif n == 2:
        cfg.model.name = "east_resnet50"
        cfg.loss.name = "east"
        cfg.data.input_size = 512
        cfg.data.batch_size = 14
        cfg.data.geometry = "RBOX"
    elif n == 3:
        cfg.model.name = "pixellink2s_vgg16"
        cfg.loss.name = "ohem"
        cfg.data.input_size = 512
        cfg.data.batch_size = 14
        cfg.infer.link_conf_threshold = 0.9
        cfg.infer.min_component_size = 10
    elif n == 4:
        cfg.model.name = "east_resnet50"
        cfg.loss.name = "focal"
        cfg.data.input_size = 768
        cfg.data.batch_size = 8
        cfg.data.use_random_scale = True
        cfg.data.use_crop = True
        cfg.data.use_rotate = True
    elif n == 5:
        cfg.model.name = "east_resnet50"
        cfg.loss.name = "east"
        cfg.data.input_size = 512
        cfg.data.batch_size = 14 * 16  # the global batch over 16 ranks
        cfg.train.num_devices = 16
    else:
        raise ValueError(f"baseline config {n} not in 1..5")
    return cfg
