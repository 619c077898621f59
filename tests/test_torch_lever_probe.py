"""scripts/holdout_lever_probe.py: the levers on the held-out F gap.

On the CPU at a tiny size (the recipe's flags overridden after ``--``:
``pixellink_tiny``, 64^2, 2-step pretrain and training): L0 and L1 each
run in a fresh process and append a record with the lever, the model's
compute dtype (float32 under L1), the staging counts and, for L0, the
final state scored at the default thresholds four ways (EMA and raw,
bf16 and f32) with the bf16/f32 logit differences; the table ends the
output. Each lever's patch lives in its own process only.
"""

import importlib.util
import json
import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_levers_run_and_record(tmp_path, capsys):
    spec = importlib.util.spec_from_file_location(
        "holdout_lever_probe",
        os.path.join(REPO, "scripts", "holdout_lever_probe.py"))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    out = tmp_path / "levers.json"
    rc = probe.main(["L0:0", "L1:1", "--json", str(out), "--",
                     "--model", "pixellink_tiny", "--steps", "2",
                     "--pretrain-steps", "2", "--train-images", "4",
                     "--val-images", "2", "--batch", "2", "--input-size",
                     "64", "--device", "cpu", "--work-dir",
                     str(tmp_path / "work")])
    assert rc == 0
    runs = json.loads(out.read_text())["runs"]
    assert [(r["lever"], r["recipe"]["seed"]) for r in runs] == [
        ("L0", 0), ("L1", 1)]
    assert [r["model_compute_dtype"] for r in runs] == ["bfloat16",
                                                        "float32"]
    assert all(r["recipe"]["augment_path"] == "device" for r in runs)
    assert all(r["recipe"]["bottleneck_impl"] == "xla" for r in runs)
    l0 = runs[0]["l0"]
    for kind in ("ema_bfloat16", "raw_bfloat16", "ema_float32",
                 "raw_float32"):
        assert {"default_f", "best_f", "mean_pixel_prob",
                "share_above_default"} <= set(l0[kind])
        assert 0.0 <= l0[kind]["mean_pixel_prob"] <= 1.0
    d = l0["ema_pixel_logits_bf16_vs_f32"]
    assert 0 < d["mean_abs_over_scale"] < 1e-2
    text = capsys.readouterr().out
    assert "| lever | seed | default F |" in text
    assert "| L1 | 1 |" in text
    assert not (tmp_path / "levers.json.L0_0.tmp").exists()
    assert not (tmp_path / "work").exists()
