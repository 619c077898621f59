"""bench.py's fine-tune recipe on the CPU: freeze_bn with the OHEM loss
in bfloat16 (``cfg.loss.compute_dtype = "bfloat16"``, bench.py:325-366).

Three frozen fused steps (pixellink_resnet50 at 64x64, batch 2, float32
model, the fused kernels' plain versions with ds = None) against JAX's
``make_train_step`` with ``jcfg.loss.compute_dtype = "bfloat16"``
(tests/test_torch_step.py's ``run_parity``), and the multi-step dispatch
of bench.py's frozen arm (freeze_bn, bfloat16 loss, S = 3,
pixellink_tiny) against JAX's ``make_multi_train_step``
(tests/test_torch_multistep.py's ``multi_parity``). ``OCR_LOSS_BF16`` is
unset, so the config decides on both sides.

Tolerances are those files', unwidened: the first step's losses rtol
1e-4 hold (at this init the two bfloat16 losses read equal, and the
float32 loss sits 3.7e-4 from them, so a step that resolved the other
dtype fails).
"""

import pytest
import torch

from test_torch_bottleneck import f32_batchnorm  # noqa: F401
from test_torch_multistep import multi_parity
from test_torch_step import run_parity

torch.set_num_threads(1)


@pytest.fixture
def no_env(monkeypatch):
    monkeypatch.delenv("OCR_LOSS_BF16", raising=False)


def test_freeze_bn_bf16_loss_steps_match_jax(f32_batchnorm, no_env):
    run_parity(freeze_bn=True, loss_dtype="bfloat16")


def test_freeze_bn_bf16_loss_multi_matches_jax(f32_batchnorm, no_env):
    multi_parity(True, "bfloat16")
