"""The ghost-BN train step: the port's ``bottleneck_impl="ghost"`` step
(ops/ghost.py, the plain versions of its kernels on the CPU) against
JAX's ``make_train_step`` with its ghost units switched on
(``resnet.GHOST_BOTTLENECKS``) and the Pallas kernels interpreted.

pixellink_resnet50 at 96x96, batch 2, float32, 3 steps. At 96x96 block1
runs at 24x24, where pick_gh gives bands of 8 rows (3 an image, so the
seams are crossed) and admits block1's two stride-1 units and no other:
block2 at 12x12 has no band height, so it runs plain Bottlenecks on both
sides.
Setup and tolerances are test_torch_step.py's; the ghost statistics
groups (8 rows of 24) are larger than the 8 values a channel of the
deepest batch-BN layers there. The freeze_bn arm is
test_torch_step_ghost_freeze_bn.py.
"""

import pytest
import torch

from tensorflow_ocr_tpu.models import resnet as JR
from tensorflow_ocr_tpu.ops import pallas_unit as PU
from tensorflow_ocr_tpu_torch.models import resnet as TR
from tensorflow_ocr_tpu_torch.ops import ghost as G
from test_torch_bottleneck import f32_batchnorm  # noqa: F401
from test_torch_step import run_parity

torch.set_num_threads(1)
GHOST_SIZE = 96
# the third step's losses: float32 noise through ~55 BN layers and the
# OHEM selection moves them by 8.9e-3 in the xla arm at 96x96 and by
# 2.3e-2 (the link loss; pixel loss 1.7e-3) in the ghost arm, where the
# first step agrees to 3.1e-6 and the second to 2.1e-3
GHOST_LATER_RTOL = 5e-2


@pytest.fixture
def ghost(monkeypatch):
    """JAX's ghost units on (its kernels interpreted); counts the ghost
    units the port runs on the ghost path (units x steps) and JAX's
    ghost_unit calls at trace time."""
    calls = {"jax": 0, "port": 0}
    monkeypatch.delenv("OCR_GHOST_UNITS", raising=False)
    monkeypatch.setattr(JR, "GHOST_BOTTLENECKS", True)
    monkeypatch.setattr(JR, "FUSED_BOTTLENECKS", False)
    for name in ("ghost_unit_id", "ghost_unit_proj"):
        fn = getattr(PU, name)

        def counted(*a, _fn=fn, **k):
            calls["jax"] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(PU, name, counted)
    orig = TR.GhostBottleneck.band_height

    def band_height(self, shape):
        gh = orig(self, shape)
        calls["port"] += gh is not None and torch.is_grad_enabled()
        return gh
    monkeypatch.setattr(TR.GhostBottleneck, "band_height", band_height)
    PU.set_interpret(True)
    yield calls
    PU.set_interpret(False)


def test_ghost_train_steps_match_jax_make_train_step(f32_batchnorm, ghost):
    run_parity(freeze_bn=False, impl="ghost", size=GHOST_SIZE,
               later_rtol=GHOST_LATER_RTOL)
    assert ghost["jax"] > 0         # JAX's units trace the ghost ops
    assert ghost["port"] == 2 * 3   # 2 units, 3 steps
    assert G.pick_gh(24, 24, 64, 64, 256, True) == 8
