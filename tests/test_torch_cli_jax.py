"""The port's ``cli.test`` against JAX's ``test.py`` on the same weights.

JAX's ``multigpu_train.main`` trains ``pixellink_tiny`` 2 steps on a
3-image 128^2 synthetic set (as tests/test_cli_entries.py does); its EMA
is moved by seeded noise (0.02 a value) and saved as a JAX checkpoint,
which
``scripts/export_torch_weights.py`` ``export_train_state`` carries over
as a port checkpoint. JAX's ``test.main`` and the port's ``cli.test``
then detect each image in float32 (JAX's ``Predictor`` builds its model
in bfloat16 whatever the config says: patched here), keeping components
above 2 stride-4 pixels (8 boxes over the 3 images): every
``res_*.txt`` is byte-equal, or its boxes are the same under
tests/test_torch_decode.py's rule: each corner within 1 of one of the
other box's after the int cast (a 45-degree box's corners sit on
integers, where an ulp of the angle's cos/sin casts to the next int, and
``order_points`` may start it at either of two corners that tie on x;
2 of the 3 files read so), or the same area at a min-area angle tie.
"""

import importlib.util
import os
import sys

import jax
import numpy as np
import torch

from tensorflow_ocr_tpu.config import Config
from tensorflow_ocr_tpu.data import icdar
from tensorflow_ocr_tpu.train import trainer as JT
from tensorflow_ocr_tpu_torch.cli import test as port_test

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
torch.set_num_threads(1)


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _parse(path):
    with open(path, "rb") as f:
        raw = f.read()
    lines = raw.split(b"\r\n")
    assert lines[-1] == b""
    return raw, np.array([[int(v) for v in ln.split(b",")]
                          for ln in lines[:-1]], np.int64).reshape(-1, 4, 2)


def _area(q):
    x, y = q[:, 0].astype(np.float64), q[:, 1].astype(np.float64)
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def test_cli_test_writes_jax_s_results(tmp_path, monkeypatch):
    import multigpu_train as jax_train
    import test as jax_test
    from tensorflow_ocr_tpu import infer as JI
    from tensorflow_ocr_tpu.models import build_model

    data = str(tmp_path / "data")
    icdar.make_synthetic_dataset(data, num_images=3, size=(128, 128),
                                 seed=41)
    trained = str(tmp_path / "jax_trained") + "/"
    jax_train.main([f"--training_data_path={data}", "--input_size=64",
                    "--batch_size_per_gpu=2", "--max_steps=2",
                    f"--checkpoint_path={trained}",
                    "--save_checkpoint_steps=0",
                    "--model.name=pixellink_tiny", "--data.max_polys=8",
                    "--train.num_devices=1"])
    cfg = Config()
    cfg.model.name = "pixellink_tiny"
    _, template, _ = JT.create_train_state(
        cfg, jax.random.PRNGKey(0), np.zeros((1, 64, 64, 3), np.float32))
    state = jax.device_get(JT.restore_checkpoint(
        JT.latest_checkpoint(trained), template))
    rng = np.random.RandomState(0)
    ema = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + rng.randn(*p.shape).astype(np.float32)
        * 0.02, state.ema_params)
    jax_ck = str(tmp_path / "jax_ck")
    JT.save_checkpoint(jax_ck, state.replace(ema_params=ema))
    port_ck = str(tmp_path / "port_ck")
    _script("export_torch_weights").export_train_state(
        "pixellink_tiny", jax_ck, port_ck)

    # JAX's Predictor builds its model in bfloat16 whatever the config
    # says; both detect in float32 here, where the point is the path
    monkeypatch.setattr(JI, "build_model", lambda name, **kw: build_model(
        name, dtype=jax.numpy.float32, **kw))
    flags = [f"--test_data_path={data}", "--model.name=pixellink_tiny",
             "--infer.max_side_len=128", "--infer.min_component_size=2"]
    jax_test.main(flags + [f"--checkpoint_path={jax_ck}",
                           f"--output_dir={tmp_path / 'jax_res'}"])
    port_test.main(flags + ["--model.compute_dtype=float32",
                            f"--checkpoint_path={port_ck}",
                            f"--output_dir={tmp_path / 'port_res'}",
                            "--device=cpu"])
    n_boxes = 0
    for i in range(3):
        name = f"res_img_{i}.txt"
        raw_p, got = _parse(tmp_path / "port_res" / name)
        raw_j, want = _parse(tmp_path / "jax_res" / name)
        n_boxes += len(want)
        if raw_p == raw_j:
            continue
        assert got.shape == want.shape, name
        for g, w in zip(got, want):
            # each corner within 1 of one of the other's: the int cast of
            # x.9999 against x+1.0000, and order_points starting a
            # 45-degree box at either of two corners that tie on x
            near = max(np.abs(b - c).max(1).min() for a, b in ((g, w), (w, g))
                       for c in a)
            if near > 1:
                assert abs(_area(g) - _area(w)) <= 1e-3 * _area(w) + 2, \
                    (name, g, w)
    assert n_boxes >= 6
