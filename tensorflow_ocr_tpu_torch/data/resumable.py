"""A batch loader with exact mid-epoch resume, without grain.

The counterpart of ``tensorflow_ocr_tpu/data/grain_pipeline.py:64-134``
(``CheckpointableLoader`` over grain's ``DataLoader``), with the same
contract:

- the files of ``cfg.training_data_path`` in an order shuffled afresh
  every epoch, from (seed, epoch);
- each sample prepared by ``data/icdar.py`` ``prepare_sample`` with its
  own ``np.random.RandomState`` seeded from (seed, epoch, record), so the
  augmentation is a fresh draw every epoch and the same on a replay; a
  sample that comes back None is an empty image with no valid polygon,
  as ``_prepare`` emits one;
- batches of ``cfg.batch_size`` consecutive samples of that stream (an
  epoch's end does not cut a batch); with ``num_epochs`` the last partial
  batch is dropped (``drop_remainder``);
- ``get_state()``/``set_state(bytes)``: the position is the next batch's
  index, so a fresh loader given a saved state replays the exact rest of
  the sequence (``train/trainer.py`` ``save_checkpoint(data_iter=...)``
  and ``restore_data_iter``);
- ``num_workers`` threads prepare a batch's samples, in order: the
  batches do not depend on the worker count;
- given a data-parallel ``group`` (``parallel/mesh.py`` ``DataGroup``) of
  n ranks, rank r prepares only its rows of each global batch of
  ``cfg.batch_size`` = B: the samples of global index
  ``[p·B + r·B/n, p·B + (r+1)·B/n)`` for batch p, each with the seeds it
  has in the whole stream. So its batch p is bit-equal to
  ``shard_batch(group, ·)`` of a world-1 loader's batch p; the length,
  the position and the state bytes are the global batch's and name no
  rank, so rank 0's checkpoint resumes every rank. This is not grain's
  ``ShardByJaxProcess`` (``grain_pipeline.py:118-124``), which gives each
  process a fixed 1/n of the records: here a shard is rows of one global
  stream, so the samples the model sees do not depend on n and there is
  one loader state.

The device-staged path (``train/trainer.py`` ``run_device_cached``) does
not read through this loader: every rank stages the whole dataset, as
JAX replicates it (``tensorflow_ocr_tpu/train/trainer.py:893-894``), and
takes its rows of each step's index batch.

It does not reproduce grain's own order (its index sampler's shuffle and
its per-record seeds): the sequence is this module's, deterministic in
(seed, files, batch_size).
"""

from __future__ import annotations

import json
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np

from tensorflow_ocr_tpu_torch.config import DataConfig
from tensorflow_ocr_tpu_torch.data import icdar
from tensorflow_ocr_tpu_torch.data.pipeline import Batcher


def _seed(*words: int) -> int:
    """A 32-bit seed from integers (numpy's SeedSequence)."""
    return int(np.random.SeedSequence(list(words)).generate_state(1)[0])


class ResumableLoader:
    """Iterator of collated batch dicts (``images``, ``polys``, ``tags``,
    ``valid``, the EAST keys with ``want_east``, and ``fns``) with an
    exact resume position; with a ``group``, of this rank's rows of each
    global batch. ``stop()`` ends its worker threads."""

    def __init__(self, cfg: DataConfig, want_east: bool = False,
                 seed: int = 0, num_epochs: Optional[int] = None,
                 group=None):
        self.cfg = cfg
        # the rows of a global batch this rank prepares (all without a
        # group); refuses a batch that the ranks do not divide
        self.rows = (group.rows(cfg.batch_size) if group is not None
                     else slice(0, cfg.batch_size))
        self.want_east = want_east
        self.seed = int(seed)
        self.num_epochs = num_epochs
        self.files = icdar.get_images(cfg.training_data_path)
        if not self.files:
            raise FileNotFoundError(cfg.training_data_path)
        self.batcher = Batcher(cfg, want_east)
        self.position = 0  # the next batch's index
        self._pool = ThreadPoolExecutor(max(1, cfg.num_workers))
        self._orders: Dict[int, np.ndarray] = {}

    def _order(self, epoch: int) -> np.ndarray:
        if epoch not in self._orders:
            if len(self._orders) > 2:
                self._orders.pop(min(self._orders))
            rs = np.random.RandomState(_seed(self.seed, epoch))
            self._orders[epoch] = rs.permutation(len(self.files))
        return self._orders[epoch]

    def _sample(self, g: int) -> icdar.Sample:
        n = len(self.files)
        epoch, i = divmod(g, n)
        record = int(self._order(epoch)[i])
        fn = self.files[record]
        rs = np.random.RandomState(_seed(self.seed, epoch, record))
        s = icdar.prepare_sample(fn, self.cfg, rs, want_east=self.want_east)
        if s is None:
            size, k = self.cfg.input_size, self.cfg.max_polys
            s = icdar.Sample(
                image=np.zeros((size, size, 3), np.uint8),
                polys=np.zeros((k, 4, 2), np.float32),
                tags=np.zeros((k,), bool), valid=np.zeros((k,), bool),
                shrunk=np.zeros((k, 4, 2), np.float32),
                rects=np.zeros((k, 4, 2), np.float32),
                angles=np.zeros((k,), np.float32), fn=fn)
        return s

    def __len__(self) -> int:
        """Global batches in the stream (``num_epochs`` set), else
        raises."""
        if self.num_epochs is None:
            raise TypeError("an endless loader has no length")
        return self.num_epochs * len(self.files) // self.cfg.batch_size

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        if self.num_epochs is not None and self.position >= len(self):
            raise StopIteration
        start = self.position * self.cfg.batch_size
        samples = list(self._pool.map(self._sample, range(
            start + self.rows.start, start + self.rows.stop)))
        self.position += 1
        return self.batcher.collate(samples)

    def state_at(self, position: int) -> bytes:
        return json.dumps({"position": int(position), "seed": self.seed,
                           "files": len(self.files),
                           "batch_size": self.cfg.batch_size}).encode()

    def get_state(self) -> bytes:
        return self.state_at(self.position)

    def set_state(self, state: bytes) -> None:
        """Move to a saved position; raises where the state was saved for
        another seed, file count or batch size."""
        st = json.loads(state.decode())
        want = {"seed": self.seed, "files": len(self.files),
                "batch_size": self.cfg.batch_size}
        got = {k: st.get(k) for k in want}
        if got != want:
            raise ValueError(f"loader state for {got}, this loader is {want}")
        self.position = int(st["position"])

    def stop(self):
        self._pool.shutdown(wait=True, cancel_futures=True)
