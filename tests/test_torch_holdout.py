"""scripts/holdout_eval_torch.py: the port's held-out evaluation.

On the CPU at a tiny size (``pixellink_tiny``, 64^2, a 2-step pretrain
and one dispatch of the augmented device-cached loop): the script runs
end to end and appends a record with every field of
scripts/holdout_eval.py's record (QUALITY_r05.json's ``runs``), the
calibrated operating point on the grid, and a second run appends to the
same file. ``--scenes photo*`` writes holdout_eval.py's photo splits.
The flags and their defaults are those of holdout_eval.py.
"""

import importlib.util
import json
import os

import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the fields of scripts/holdout_eval.py's record (:295-340)
JAX_RECORD = ("model", "geometry", "steps", "batch", "lr", "loss",
              "loss_compute_dtype", "input_size", "recipe", "data",
              "train_images_per_sec", "train_images_per_sec_steady", "val",
              "train", "calibrated_thresholds", "val_at_calibrated",
              "thresholds", "val_at_best_thresholds")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def script():
    return _load("holdout_eval_torch")


def test_runs_and_appends_the_record(script, tmp_path):
    out = tmp_path / "q.json"
    args = ["--model", "pixellink_tiny", "--steps", "2",
            "--pretrain-steps", "2", "--augment", "--scenes", "v2",
            "--train-images", "4", "--val-images", "2", "--batch", "2",
            "--input-size", "64", "--sweep-thresholds", "--device", "cpu",
            "--work-dir", str(tmp_path / "work"), "--json", str(out),
            "--note", "cpu"]
    script.main(args)
    script.main(args[:-2])
    runs = json.loads(out.read_text())["runs"]
    assert len(runs) == 2
    rec = runs[0]
    assert set(JAX_RECORD) <= set(rec)
    assert rec["note"] == "cpu" and "note" not in runs[1]
    assert rec["recipe"]["augment_path"] == "device"
    # the config's train path, as holdout_eval.py trains
    assert rec["recipe"]["bottleneck_impl"] == "xla"
    assert rec["data"] == {"train_images": 4, "val_images": 2,
                           "train_seed": 0, "val_seed": 1, "scenes": "v2"}
    op = rec["calibrated_thresholds"]
    assert op["pixel"] in (0.5, 0.6, 0.7, 0.8, 0.9)
    assert op["link"] in (0.5, 0.7, 0.8, 0.9)
    for key in ("val", "train", "val_at_calibrated",
                "val_at_best_thresholds"):
        assert set(rec[key]) == {"precision", "recall", "fmean"}


@pytest.mark.parametrize("scenes", ["photo", "photo_mix", "photo2"])
def test_photo_scenes_name_the_roadmap(script, tmp_path, monkeypatch, scenes):
    """``--scenes photo*`` (ROADMAP.md Queue 1 item 5, ported) writes the
    splits holdout_eval.py writes: the directories' suffix, the tiers of
    each split and photo_mix's half v2, half photo:train. The data sets
    alone: the training after them is the v2 run's above."""
    from tensorflow_ocr_tpu_torch.data import icdar

    if not all(icdar._photo_sources().values()):
        pytest.skip("no package photographs installed")
    calls = []

    class Written(Exception):
        pass

    def fake(path, n, size, seed=0, hard=False, start_index=0):
        calls.append((os.path.basename(path), n, seed, hard, start_index))
        if os.path.basename(path).startswith("val"):
            raise Written
        return []

    monkeypatch.setattr(icdar, "make_synthetic_dataset", fake)
    with pytest.raises(Written):
        script.main(["--scenes", scenes, "--train-images", "4",
                     "--val-images", "2", "--device", "cpu", "--work-dir",
                     str(tmp_path)])
    tier = "photo2" if scenes == "photo2" else "photo"
    train = ([(f"train_{scenes}", 2, 0, "v2", 0),
              (f"train_{scenes}", 2, 2, "photo:train", 2)]
             if scenes == "photo_mix" else
             [(f"train_{scenes}", 4, 0, f"{tier}:train", 0)])
    assert calls == train + [(f"val_{scenes}", 2, 1, f"{tier}:val", 0)]


def test_flags_and_defaults_are_holdout_evals(script, monkeypatch):
    """Every flag of scripts/holdout_eval.py exists here with its
    default (read from its argparse without running it)."""
    import argparse

    seen = {}

    class Stop(Exception):
        pass

    def parse_args(self, args=None, namespace=None):
        seen.update(vars(orig(self, [])))
        raise Stop

    orig = argparse.ArgumentParser.parse_args
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse_args)
    with pytest.raises(Stop):
        _load("holdout_eval").main()
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", orig)
    ours = vars(script.parse_args([]))
    for flag, default in seen.items():
        assert flag in ours and ours[flag] == default, flag
