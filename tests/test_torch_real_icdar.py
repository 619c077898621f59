"""scripts/real_icdar_torch.sh: the port's one-command real-ICDAR rehearsal.

Its smoke mode on the CPU (``DEVICE=cpu``, ``SIZE=128``, ``BATCH=2``, 3
steps; about 50 s): synthetic scenes in ICDAR layout written by the
port's ``data/icdar.py``, three train steps through
``tensorflow_ocr_tpu_torch.cli.multigpu_train``, the submission files of
``cli.test``, and the ICDAR P/R/F dict of the port's
``evaluate_icdar_directory``. A ``jax`` that raises on import stands
first on the path, so the pipeline shows that it imports no JAX.
"""

import ast
import os
import subprocess

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_smoke_rehearsal_trains_infers_and_scores_on_the_cpu(tmp_path):
    block = tmp_path / "nojax" / "jax"
    block.mkdir(parents=True)
    (block / "__init__.py").write_text(
        'raise ImportError("the port imports no JAX")\n')
    env = dict(os.environ, DEVICE="cpu", SIZE="128", BATCH="2",
               WORK=str(tmp_path / "work"),
               PYTHONPATH=os.pathsep.join(
                   [str(block.parent), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        ["bash", os.path.join(REPO, "scripts", "real_icdar_torch.sh")],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    out = proc.stdout.splitlines()
    assert "== smoke mode: synthetic scenes in ICDAR layout, 3 steps ==" in out
    i = out.index("== eval: ICDAR IoU-0.5 greedy matching ==")
    prf = ast.literal_eval(out[i + 1])
    assert {"precision", "recall", "fmean", "n_gt"} <= set(prf)
    assert prf["n_gt"] > 0 and 0.0 <= prf["fmean"] <= 1.0
    res = sorted(os.listdir(tmp_path / "work" / "res"))
    assert [f for f in res if f.endswith(".txt")] == [
        f"res_img_{i}.txt" for i in range(4)]
    assert os.path.isdir(tmp_path / "work" / "ckpt")
