"""The port's entry points (``tensorflow_ocr_tpu_torch/cli/``) on the CPU.

As tests/test_cli_entries.py drives the root scripts: a 3-image 128^2
synthetic set, ``cli.multigpu_train`` (host loader and ``Trainer.run``;
then the device-cached loop; then ``--preset=3``), ``cli.train_pixellink``,
and the three test entries on the checkpoint, each writing one
``res_*.txt`` and one overlay per image, with ``--device=cpu``; without
it an entry raises when torch sees no card. The result writers
(``utils/image.py``) against JAX's: ``res_*.txt`` byte-equal for the same
boxes; the overlay within 1.5% of the pixels of cv2's ``drawContours``
at thickness 2 (0.69% read on 8 boxes over 200x300: the thick line's caps
and joins, as for ``codec.line``, tests/test_torch_codec.py), written by
``codec.imwrite``. tests/test_torch_cli_jax.py holds ``cli.test`` against
JAX's ``test.py`` on the same weights.
"""

import os

import cv2
import numpy as np
import pytest
import torch

from tensorflow_ocr_tpu.utils import image as JI
from tensorflow_ocr_tpu_torch.cli import (multigpu_train, test,
                                          test_pixellink, test_pixellink_fast,
                                          train_pixellink)
from tensorflow_ocr_tpu_torch.data import codec
from tensorflow_ocr_tpu_torch.data.icdar import make_synthetic_dataset
from tensorflow_ocr_tpu_torch.utils import image as TI

torch.set_num_threads(1)
MAX_OVERLAY_OFF = 0.015


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("icdar_cli"))
    make_synthetic_dataset(path, num_images=3, size=(128, 128), seed=41)
    return path


TINY = ["--input_size=64", "--batch_size_per_gpu=2",
        "--save_checkpoint_steps=0", "--model.name=pixellink_tiny",
        "--data.max_polys=8", "--train.num_devices=1", "--device=cpu"]


def _results(out):
    names = sorted(os.listdir(out))
    assert [n for n in names if n.startswith("res_")] == \
        [f"res_img_{i}.txt" for i in range(3)]
    assert [n for n in names if n.endswith(".jpg")] == \
        [f"img_{i}.jpg" for i in range(3)]
    for i in range(3):
        assert codec.imread(os.path.join(out, f"img_{i}.jpg")).shape == \
            (128, 128, 3)
        with open(os.path.join(out, f"res_img_{i}.txt"), "rb") as f:
            for line in f.read().split(b"\r\n")[:-1]:
                assert len(line.split(b",")) == 8


def test_train_then_test_entries(dataset, tmp_path, capsys):
    ck = str(tmp_path / "ckpt") + "/"
    trainer = multigpu_train.main([f"--training_data_path={dataset}",
                                   "--max_steps=2", f"--checkpoint_path={ck}",
                                   *TINY])
    assert trainer.device.type == "cpu" and int(trainer.state.step) == 2
    assert "ckpt_2" in os.listdir(ck)
    assert "operating_point.json" in os.listdir(ck)
    out = capsys.readouterr().out
    assert "Step 000000, model loss" in out
    for entry, name in ((test, "test"), (test_pixellink_fast, "fast"),
                        (test_pixellink, "slow")):
        res = str(tmp_path / name) + "/"
        entry.main([f"--test_data_path={dataset}", f"--checkpoint_path={ck}",
                    f"--output_dir={res}", "--model.name=pixellink_tiny",
                    "--infer.max_side_len=128", "--device=cpu"])
        _results(res)
    assert capsys.readouterr().out.count("boxes") == 9


def test_train_entries_device_cache_preset_and_recipe(dataset, tmp_path):
    ck = str(tmp_path / "cached")
    trainer = multigpu_train.main([
        f"--training_data_path={dataset}", "--max_steps=2",
        f"--checkpoint_path={ck}", "--train.use_device_cache=true",
        "--train.scan_steps=2", *TINY])
    assert int(trainer.state.step) == 2 and "ckpt_2" in os.listdir(ck)
    trainer = multigpu_train.main([
        "--preset=3", f"--training_data_path={dataset}", "--input_size=64",
        "--batch_size_per_gpu=1", "--max_steps=1", "--data.max_polys=8",
        f"--checkpoint_path={tmp_path / 'preset'}",
        "--train.calibrate_at_checkpoint=false", "--device", "cpu"])
    assert trainer.cfg.model.name == "pixellink2s_vgg16"
    assert trainer.cfg.infer.link_conf_threshold == 0.9
    assert trainer.cfg.data.batch_size == 1
    trainer = train_pixellink.main([
        f"--training_data_path={dataset}", "--max_steps=1",
        f"--checkpoint_path={tmp_path / 'vgg'}", *TINY])
    assert trainer.cfg.train.optimizer == "momentum"
    assert trainer.cfg.loss.name == "ohem"
    assert type(trainer.state.optimizer).__name__ == "MomentumSGD"
    assert int(trainer.state.step) == 1


def test_entries_default_to_the_card(dataset, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        multigpu_train.main([f"--training_data_path={dataset}",
                             "--max_steps=1", "--model.name=pixellink_tiny",
                             f"--checkpoint_path={tmp_path}"])
    with pytest.raises(RuntimeError, match="CUDA"):
        test.main([f"--test_data_path={dataset}",
                   f"--checkpoint_path={tmp_path}",
                   "--model.name=pixellink_tiny"])


def _boxes(rng, n, h, w):
    boxes = []
    for _ in range(n):
        c = rng.uniform(-10, (w + 10, h + 10))
        a = rng.uniform(0, np.pi)
        u = np.array([np.cos(a), np.sin(a)])
        v = np.array([-u[1], u[0]])
        bw, bh = rng.uniform(10, 80), rng.uniform(5, 30)
        boxes.append(np.array([c + u * bw + v * bh, c - u * bw + v * bh,
                               c - u * bw - v * bh, c + u * bw - v * bh],
                              np.float32))
    return boxes


def test_result_writers_are_jax_s(tmp_path):
    rng = np.random.RandomState(0)
    im = rng.randint(0, 256, (200, 300, 3)).astype(np.uint8)
    boxes = _boxes(rng, 8, 200, 300)
    a = TI.write_result_txt(str(tmp_path / "port"), "/x/img_7.jpg", boxes)
    b = JI.write_result_txt(str(tmp_path / "jax"), "/x/img_7.jpg", boxes)
    assert os.path.basename(a) == os.path.basename(b) == "res_img_7.txt"
    with open(a, "rb") as fa, open(b, "rb") as fb:
        got = fa.read()
        assert got == fb.read() and got.count(b"\r\n") == 8
    drawn, want = TI.draw_boxes(im, boxes), JI.draw_boxes(im, boxes)
    off = (np.abs(drawn.astype(int) - want).max(-1) > 0).mean()
    inked = (np.abs(want.astype(int) - im).max(-1) > 0).mean()
    assert off <= MAX_OVERLAY_OFF and inked > 5 * off, (off, inked)
    path = TI.write_overlay(str(tmp_path / "port"), "/x/img_7.jpg", im, boxes)
    assert os.path.basename(path) == "img_7.jpg"
    codec.imwrite(str(tmp_path / "direct.jpg"), drawn)
    with open(path, "rb") as f, open(tmp_path / "direct.jpg", "rb") as g:
        assert f.read() == g.read()
    assert cv2.imread(path).shape == im.shape
