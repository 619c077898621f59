"""PyTorch model zoo: ResNet-v1 / tiny backbones + PixelLink head."""

from tensorflow_ocr_tpu_torch.models.detector import build_model, MODEL_REGISTRY  # noqa: F401
