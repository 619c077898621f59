"""The resumable loader: exact replay, permutations, worker counts and the
round trip through a checkpoint.

``tensorflow_ocr_tpu_torch/data/resumable.py`` ``ResumableLoader`` (the
port's counterpart of ``grain_pipeline.py`` ``CheckpointableLoader``),
on the CPU:

- after ``set_state`` a fresh loader replays the exact rest of the
  sequence (every array equal, the same files), mid-epoch and across an
  epoch's end, and refuses a state of another seed or batch size;
- each epoch's files are a permutation of the dataset, and epochs
  differ; ``num_epochs`` drops the last partial batch;
- the batches do not depend on the worker count (1, 2 or 4 threads);
- the position round-trips through ``train/trainer.py``
  ``save_checkpoint(data_iter=...)`` and ``restore_data_iter``, and a
  Trainer restored from a mid-epoch checkpoint takes the uninterrupted
  run's next batches, through PrefetchLoader and DevicePrefetcher.
"""

import numpy as np
import pytest
import torch

from tensorflow_ocr_tpu_torch.config import Config
from tensorflow_ocr_tpu_torch.data import icdar
from tensorflow_ocr_tpu_torch.data.pipeline import (DevicePrefetcher,
                                                    PrefetchLoader)
from tensorflow_ocr_tpu_torch.data.resumable import ResumableLoader
from tensorflow_ocr_tpu_torch.train import trainer as TT

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("res")
    icdar.make_synthetic_dataset(str(d), 5, (120, 160), seed=7, hard="v2")
    return str(d)


def _cfg(path, **kw):
    cfg = Config()
    cfg.model.name = "pixellink_tiny"
    cfg.model.compute_dtype = "float32"
    d = cfg.data
    d.training_data_path, d.input_size, d.batch_size = path, 64, 2
    d.max_polys, d.num_workers, d.max_queue_size = 8, 2, 2
    d.use_crop = d.use_rotate = True
    d.min_text_size = 2
    for k, v in kw.items():
        setattr(d, k, v)
    return cfg


def _same(a, b):
    assert a["fns"] == b["fns"]
    for k in set(a) - {"fns"}:
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("at", [1, 3, 4])
def test_set_state_replays_the_rest(dataset, at):
    cfg = _cfg(dataset).data
    whole = ResumableLoader(cfg, seed=3)
    want = [next(whole) for _ in range(at + 3)]
    first = ResumableLoader(cfg, seed=3)
    for _ in range(at):
        next(first)
    state = first.get_state()
    fresh = ResumableLoader(cfg, seed=3)
    fresh.set_state(state)
    for b in want[at:]:
        _same(next(fresh), b)
    with pytest.raises(ValueError):
        ResumableLoader(cfg, seed=4).set_state(state)
    for it in (whole, first, fresh):
        it.stop()


def test_epochs_are_permutations(dataset):
    cfg = _cfg(dataset, batch_size=5).data
    it = ResumableLoader(cfg, seed=1)
    files = icdar.get_images(dataset)
    epochs = [next(it)["fns"] for _ in range(3)]
    for e in epochs:
        assert sorted(e) == files
    assert epochs[0] != epochs[1] or epochs[1] != epochs[2]
    it.stop()
    short = ResumableLoader(_cfg(dataset, batch_size=2).data, seed=1,
                            num_epochs=1)
    assert len(list(short)) == len(short) == 2  # 5 // 2: remainder dropped
    short.stop()


def test_batches_do_not_depend_on_the_worker_count(dataset):
    runs = []
    for workers in (1, 2, 4):
        it = ResumableLoader(_cfg(dataset, num_workers=workers).data, seed=5)
        runs.append([next(it) for _ in range(4)])
        it.stop()
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            _same(a, b)


def test_position_round_trips_through_a_checkpoint(dataset, tmp_path):
    cfg = _cfg(dataset)
    state = TT.create_train_state(cfg, "cpu")
    it = ResumableLoader(cfg.data, seed=0)
    for _ in range(3):
        next(it)
    ck = TT.save_checkpoint(str(tmp_path), state, it)
    fresh = ResumableLoader(cfg.data, seed=0)
    assert TT.restore_data_iter(ck, fresh)
    assert fresh.position == 3
    _same(next(fresh), next(it))
    it.stop()
    fresh.stop()


def _chain(cfg):
    src = ResumableLoader(cfg.data, seed=cfg.train.seed)
    return DevicePrefetcher(PrefetchLoader(cfg.data, source=src), "cpu")


class _Recorder:
    def __init__(self, it):
        self.it, self.seen = it, []

    def __next__(self):
        b = next(self.it)
        self.seen.append((b["fns"], b["images"].numpy().copy()))
        return b

    def get_state(self):
        return self.it.get_state()

    def set_state(self, s):
        self.it.set_state(s)


def test_trainer_resumes_the_data_mid_epoch(dataset, tmp_path):
    cfg = _cfg(dataset)
    cfg.train.checkpoint_path = str(tmp_path)
    cfg.train.save_checkpoint_steps = 2
    cfg.train.log_every_steps = 1
    first = TT.Trainer(cfg, device="cpu")
    first.setup()
    chain = _chain(cfg)
    whole = _Recorder(chain)
    try:
        # a checkpoint at step 2, after 3 batches: sample 6 of 5 files,
        # the middle of the second epoch
        first.run(whole, 4)
    finally:
        chain.stop()
    assert TT.latest_checkpoint(str(tmp_path)).endswith("ckpt_3")
    cfg.train.restore = True
    cfg.train.save_checkpoint_steps = 0
    resumed = TT.Trainer(cfg, device="cpu")
    resumed.setup()
    assert int(resumed.state.step) == 3
    chain = _chain(cfg)
    again = _Recorder(chain)
    try:
        resumed.run(again, 2)
    finally:
        chain.stop()
    assert len(again.seen) == 2
    fns, img = whole.seen[3]  # the uninterrupted run's batch 3
    assert again.seen[0][0] == fns and np.array_equal(again.seen[0][1], img)
    ref = ResumableLoader(cfg.data, seed=cfg.train.seed)
    for _ in range(4):
        next(ref)
    b = next(ref)  # batch 4, which the first run never took
    assert again.seen[1][0] == b["fns"] and np.array_equal(
        again.seen[1][1], b["images"])
    ref.stop()
