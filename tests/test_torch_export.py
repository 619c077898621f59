"""scripts/export_torch_weights.py: JAX checkpoint -> .npz -> the port.

A pixellink_tiny train state (EMA parameters made to differ from the raw
ones) is saved as an Orbax checkpoint with its calibrated operating
point, exported, and loaded by the port's Predictor. Its float32 logits
must equal the JAX model's on the EMA weights within 1e-4, and the
thresholds must come from the operating point.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_ocr_tpu.config import Config
from tensorflow_ocr_tpu.models import build_model as build_jax_model
from tensorflow_ocr_tpu.train import trainer as T
from tensorflow_ocr_tpu.train.calibrate import save_operating_point
from tensorflow_ocr_tpu_torch.infer import Predictor

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script():
    spec = importlib.util.spec_from_file_location(
        "export_torch_weights",
        os.path.join(REPO, "scripts", "export_torch_weights.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_export_then_load_gives_equal_logits(tmp_path):
    cfg = Config()
    cfg.model.name = "pixellink_tiny"
    _, state, _ = T.create_train_state(
        cfg, jax.random.PRNGKey(0), np.zeros((1, 64, 64, 3), np.float32))
    rng = np.random.RandomState(0)
    ema = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + rng.randn(*p.shape).astype(np.float32)
        * 0.05, state.ema_params)
    state = state.replace(ema_params=ema)
    ckpt_root = str(tmp_path / "ckpt")
    T.save_checkpoint(ckpt_root, state)
    save_operating_point(ckpt_root, {"pixel": 0.61, "link": 0.42})

    out = _script().export("pixellink_tiny", ckpt_root,
                           str(tmp_path / "torch" / "weights.npz"))
    pred = Predictor("pixellink_tiny", weights=out, device="cpu",
                     dtype=torch.float32)
    assert pred.calibrated
    assert (pred.pixel_thresh, pred.link_thresh) == (0.61, 0.42)

    images = rng.randint(0, 256, (2, 64, 96, 3)).astype(np.uint8)
    variables = {"params": ema, "batch_stats": state.batch_stats}
    want = build_jax_model("pixellink_tiny", dtype=jnp.float32).apply(
        variables, jnp.asarray(images))
    with torch.inference_mode():
        got = pred.model(torch.from_numpy(images))
    for key in ("pixel_logits", "link_logits"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=1e-4, err_msg=key)


def test_export_model_choices_are_the_port_registry():
    """--model takes every model the port's registry builds, and no
    other."""
    from tensorflow_ocr_tpu_torch.models.detector import MODEL_REGISTRY

    script = _script()
    assert set(script.PORT_MODELS) == set(MODEL_REGISTRY)
    with pytest.raises(SystemExit):
        script.main(["--checkpoint", "x", "--out", "y", "--model",
                     "no_such_model"])
