"""The port's command-line surface against the JAX package's.

``tensorflow_ocr_tpu_torch/config.py`` ``parse_flags`` against
``tensorflow_ocr_tpu/config.py``'s on the argv of
``tests/test_cli_entries.py`` and of the root shells: every field both
configs have comes out equal; an unknown flag raises in both. The presets
of ``tensorflow_ocr_tpu_torch/configs.py`` equal JAX's
``baseline_config(n)`` field by field for n = 1-5; preset 5 (16 ranks)
builds, and ``validate`` refuses a ``num_devices`` other than the process
group's size (1 here, with none), naming both numbers.
"""

import dataclasses

import pytest
import torch

from tensorflow_ocr_tpu import config as J
from tensorflow_ocr_tpu.configs import baseline_config as jax_preset
from tensorflow_ocr_tpu_torch import config as T
from tensorflow_ocr_tpu_torch.cli import take_flag
from tensorflow_ocr_tpu_torch.configs import baseline_config

torch.set_num_threads(1)

SECTIONS = ("data", "model", "loss", "train", "infer", "eval")

ARGVS = {
    # tests/test_cli_entries.py test_flag_parsing_reference_names
    "reference_names": ["--gpu_list=0,1", "--input_size=768",
                        "--batch_size_per_gpu=7", "--learning_rate=0.001",
                        "--moving_average_decay=0.99", "--restore",
                        "--geometry=RBOX", "--min_text_size=12",
                        "--train.scan_steps=8"],
    # tests/test_cli_entries.py test_multigpu_train_then_test_entry
    "train_entry": ["--training_data_path=/tmp/d", "--input_size=64",
                    "--batch_size_per_gpu=2", "--max_steps=2",
                    "--checkpoint_path=/tmp/ck/", "--save_checkpoint_steps=0",
                    "--model.name=pixellink_vgg16", "--data.max_polys=8",
                    "--train.num_devices=1"],
    "test_entry": ["--test_data_path=/tmp/d", "--checkpoint_path=/tmp/ck/",
                   "--output_dir=/tmp/res/", "--model.name=pixellink_vgg16",
                   "--infer.max_side_len=128"],
    # train.sh / test.sh shapes: spaces, tuples, None, floats, bare bools
    "shell_forms": ["--gpu_list", "0", "--input_size", "512",
                    "--num_readers", "4", "--text_scale", "640",
                    "--data.random_scale=0.5,1.5", "--data.use_crop",
                    "--train.pretrained_model_path=none",
                    "--pretrained_model_path", "/tmp/resnet_v1_50.npz",
                    "--pixel_conf_threshold=0.6", "--link_conf_threshold",
                    "0.7", "--train.restore=false", "stray-positional",
                    "--gpu_memory_fraction=0.5", "--loss.focal_gamma=3"],
}


def _shared_fields(port, jax_):
    for sec in SECTIONS:
        p, j = getattr(port, sec), getattr(jax_, sec)
        for f in dataclasses.fields(p):
            if hasattr(j, f.name):
                yield f"{sec}.{f.name}", getattr(p, f.name), \
                    getattr(j, f.name)


@pytest.mark.parametrize("argv", list(ARGVS), ids=list(ARGVS))
def test_parse_flags_gives_jax_fields(argv):
    args = ARGVS[argv]
    aliases, jaliases = None, None
    if argv == "test_entry":  # test.py's alias of checkpoint_path
        aliases = dict(T.FLAG_ALIASES, checkpoint_path="infer.checkpoint_path")
        jaliases = dict(J.FLAG_ALIASES, checkpoint_path="infer.checkpoint_path")
    port = T.parse_flags(args, T.Config(), aliases)
    jax_ = J.parse_flags(args, J.Config(), jaliases)
    n = 0
    for name, p, j in _shared_fields(port, jax_):
        assert p == j and type(p) is type(j), name
        n += 1
    assert n >= 70
    assert T.FLAG_ALIASES == J.FLAG_ALIASES


def test_unknown_flag_raises_like_jax():
    for parse, cfg in ((T.parse_flags, T.Config), (J.parse_flags, J.Config)):
        with pytest.raises(ValueError, match="unknown flag --not_a_flag"):
            parse(["--not_a_flag=1"], cfg())


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_presets_are_jax_s(n):
    port, jax_ = baseline_config(n), jax_preset(n)
    for name, p, j in _shared_fields(port, jax_):
        assert p == j, (n, name)
    # every field a JAX preset sets exists in the port
    for sec in SECTIONS:
        d = getattr(J.Config(), sec)
        for f in dataclasses.fields(d):
            if getattr(getattr(jax_, sec), f.name) != getattr(d, f.name):
                assert hasattr(getattr(port, sec), f.name), (n, sec, f.name)


def test_preset_5_and_many_devices_name_item_7():
    cfg = baseline_config(5)
    assert cfg.train.num_devices == 16 and cfg.data.batch_size == 224
    # one process and no process group: a world of 1
    with pytest.raises(ValueError, match="num_devices=16 .* 1 rank"):
        cfg.validate()
    with pytest.raises(ValueError):
        baseline_config(6)
    with pytest.raises(ValueError, match="num_devices=2 .* 1 rank"):
        T.parse_flags(["--train.num_devices=2"])
    assert T.parse_flags(["--train.num_devices=1"]).train.num_devices == 1
    assert T.Config().train.num_devices is None


def test_take_flag_removes_the_port_s_own_flags():
    argv = ["--device=cpu", "--preset", "3", "--input_size=64"]
    assert take_flag(argv, "device", "cuda") == "cpu"
    assert take_flag(argv, "preset") == "3"
    assert take_flag(argv, "device", "cuda") == "cuda"
    assert argv == ["--input_size=64"]
