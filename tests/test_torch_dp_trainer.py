"""The Trainer on 2 gloo ranks (``train/trainer.py``).

Each rank runs ``Trainer.run`` from the host loader (``ResumableLoader ->
PrefetchLoader -> DevicePrefetcher`` given the group, so each rank copies
its rows of the global batch that every rank's loader draws alike):
pixellink_tiny at 64x64, float32, a global batch of 4 from a synthetic
ICDAR directory. Checked in the ranks (``tests/test_torch_rank_worker.py``
``task_trainer``) and here:

- 3 steps with a save at step 2 (``ckpt_3``, written by rank 0 alone),
  then a fresh Trainer with ``restore=True`` and a fresh loader resumed
  from the checkpoint for 1 step: every state tensor bit-equal to 4
  uninterrupted steps, on both ranks, and the ranks equal;
- the same with per-rank readers (``ResumableLoader(group=...)``: each
  rank prepares only its 2 rows of each global batch): 4 steps bit-equal
  to the whole reader's 4, and 3 steps, a save, and 1 step resumed from
  rank 0's checkpoint bit-equal to them too;
- a preemption flag raised on rank 1 alone stops both ranks after the
  same step, with one checkpoint of that step;
- ``num_devices`` 4 (Trainer and ``Config.validate``) and preset 5 (16)
  are refused on a world of 2, naming both sizes; 2 is taken.

And without a process group: ``initialize`` with no launcher's
environment starts none and the port's group is the single-device one.
"""

import numpy as np
import torch

from tensorflow_ocr_tpu_torch.data import icdar
from test_torch_rank_worker import run_ranks, write_inputs
from test_torch_step import scene_batch

torch.set_num_threads(1)


def test_trainer_on_two_ranks(tmp_path):
    icdar.make_synthetic_dataset(str(tmp_path / "scenes"), 8, (96, 128),
                                 seed=5, hard="v2")
    write_inputs(tmp_path, {}, batch=scene_batch(np.random.RandomState(7),
                                                 4, 64))
    outs = run_ranks("trainer", 2, tmp_path)
    for r, out in enumerate(outs):
        assert out["saved"] == ["ckpt_3"], r
        assert out["unequal"] == [], (r, out["unequal"][:4])
        assert out["rows_unequal"] == [], (r, out["rows_unequal"][:4])
        assert out["rows_saved"] == ["ckpt_3"], r
        assert out["rows_resumed_unequal"] == [], (
            r, out["rows_resumed_unequal"][:4])
        assert int(out["state"]["step"]) == 4
        # flag seen at step 2's check: both ranks stop after 3 steps
        assert out["preempt_step"] == 3, r
        assert out["preempt_saved"] == ["ckpt_3"], r
        assert len(out["errors"]) == 3, out["errors"]
        assert "4-device mesh" in out["errors"][0] and "2 rank" in \
            out["errors"][0]
        assert "16-device mesh" in out["errors"][1]
        assert "num_devices=4" in out["errors"][2] and "2 rank" in \
            out["errors"][2]
        assert out["world_ok"] == 2
    for k, v in outs[0]["state"].items():
        assert torch.equal(v, outs[1]["state"][k]), k


def test_initialize_without_a_launcher_is_single_process(monkeypatch):
    from tensorflow_ocr_tpu_torch.parallel import make_mesh, multihost
    from tensorflow_ocr_tpu_torch.parallel import mesh as M

    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.initialize() is False
    assert not M.is_initialized()
    g = make_mesh(device="cpu")
    assert (g.rank, g.world, g.reduces) == (0, 1, False)
    assert multihost.local_batch_size(6) == 6
    local = multihost.global_batch_from_local(
        g, {"images": np.zeros((6, 2, 2, 3), np.uint8), "fns": ["a"] * 6},
        6)
    assert set(local) == {"images"} and local["images"].shape[0] == 6
