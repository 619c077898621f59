"""Batching and prefetch: host samples to batches on the device.

Port of ``tensorflow_ocr_tpu/data/pipeline.py``:

- :class:`Batcher` :24, :func:`sample_generator` :46 and
  :func:`batch_generator` :70, the same stream of batches as JAX's for
  the same seed;
- :class:`PrefetchLoader` :82: worker threads, bounded queues,
  ``stop()``. Given a ``source`` (``data/resumable.py``
  ``ResumableLoader``) it prefetches that source's batches in order and
  keeps its resumable position;
- :class:`DevicePrefetcher` :148: copies batches ``depth`` ahead into
  pinned host memory and on to the card on a side stream
  (``non_blocking``), and records an event that the consumer's stream
  waits on; in place of ``device_put`` on a mesh. On the CPU it hands the
  batches over as tensors. With a data-parallel group it copies this
  rank's rows: it cuts a global batch, and passes a per-rank reader's
  batch as it is;
- :func:`get_batch` :194.

A resumable loader's position (``get_state``/``set_state``) is the next
batch the *consumer* takes, whatever the prefetchers hold: each layer
counts what it delivered. Threads start at the first ``next``, so a
``set_state`` before it (``train/trainer.py`` ``restore_data_iter``)
moves the source before anything is read.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from tensorflow_ocr_tpu_torch.config import DataConfig
from tensorflow_ocr_tpu_torch.data import icdar

_POLL_S = 0.2  # how often a blocked thread looks at its stop flag


class Batcher:
    """Collates Samples into dense arrays (one host->device copy each)."""

    def __init__(self, cfg: DataConfig, want_east: bool = False):
        self.cfg = cfg
        self.want_east = want_east

    def collate(self, samples: List[icdar.Sample]) -> Dict[str, np.ndarray]:
        out = {
            "images": np.stack([s.image for s in samples]),
            "polys": np.stack([s.polys for s in samples]),
            "tags": np.stack([s.tags for s in samples]),
            "valid": np.stack([s.valid for s in samples]),
            "fns": [s.fn for s in samples],
        }
        if self.want_east:
            out["shrunk"] = np.stack([s.shrunk for s in samples])
            out["rects"] = np.stack([s.rects for s in samples])
            out["angles"] = np.stack([s.angles for s in samples])
        return out


def sample_generator(cfg: DataConfig, want_east: bool = False,
                     seed: int = 0, loop: bool = True
                     ) -> Iterator[icdar.Sample]:
    """Shuffled sample stream: each pass a permutation of the files from
    one ``RandomState(seed)`` that also draws the augmentation; a sample
    that fails or comes back None is skipped."""
    image_list = icdar.get_images(cfg.training_data_path)
    if not image_list:
        raise FileNotFoundError(
            f"no training images in {cfg.training_data_path}")
    rng = np.random.RandomState(seed)
    while True:
        idx = rng.permutation(len(image_list))
        for i in idx:
            try:
                s = icdar.prepare_sample(image_list[i], cfg, rng,
                                         want_east=want_east)
            except Exception:  # skip and continue (icdar.py:646-649)
                continue
            if s is not None:
                yield s
        if not loop:
            return


def batch_generator(cfg: DataConfig, want_east: bool = False,
                    seed: int = 0, loop: bool = True):
    gen = sample_generator(cfg, want_east, seed, loop)
    batcher = Batcher(cfg, want_east)
    buf: List[icdar.Sample] = []
    for s in gen:
        buf.append(s)
        if len(buf) == cfg.batch_size:
            yield batcher.collate(buf)
            buf = []


def _put(q: "queue.Queue", item, stop: threading.Event) -> bool:
    """Put into a bounded queue unless ``stop`` is set first."""
    while not stop.is_set():
        try:
            q.put(item, timeout=_POLL_S)
            return True
        except queue.Full:
            continue
    return False


class _Resumable:
    """Position bookkeeping of a layer over a resumable source: the
    position is the source's at the first read plus the batches this
    layer delivered."""

    _source = None
    _base = 0
    _delivered = 0
    _started = False

    @property
    def resumable(self) -> bool:
        return hasattr(self._source, "state_at")

    @property
    def position(self) -> int:
        if not self._started:
            return self._source.position
        return self._base + self._delivered

    def state_at(self, position: int) -> bytes:
        return self._source.state_at(position)

    def get_state(self) -> Optional[bytes]:
        """The position's bytes, None where the source is not resumable
        (a checkpoint then stores no data position)."""
        return self.state_at(self.position) if self.resumable else None

    def set_state(self, state: bytes) -> None:
        if not self.resumable:
            raise TypeError("this loader's source keeps no position")
        if self._started:
            raise RuntimeError("set_state after the first batch was read")
        self._source.set_state(state)


class PrefetchLoader(_Resumable):
    """Thread-pool prefetcher with a bounded queue. Without ``source``:
    ``num_workers`` threads each run an independently seeded sample stream
    (seed + w) and a collator thread assembles batches (JAX's loader).
    With ``source`` (an iterator of batches): one thread reads it ahead,
    in order, and the loader is resumable where the source is. Threads
    start at the first ``next``; ``stop()`` ends them."""

    def __init__(self, cfg: DataConfig, want_east: bool = False,
                 seed: int = 0, source=None):
        self.cfg = cfg
        self.want_east = want_east
        self.seed = seed
        self._source = source
        self._sample_q: "queue.Queue" = queue.Queue(
            maxsize=cfg.max_queue_size * max(cfg.batch_size, 1))
        self._batch_q: "queue.Queue" = queue.Queue(
            maxsize=cfg.max_queue_size)
        self._stop = threading.Event()
        self._done = threading.Event()  # the source is exhausted
        self._threads: List[threading.Thread] = []
        self._error: Optional[BaseException] = None

    def _start(self):
        self._started = True
        if self._source is not None:
            if self.resumable:
                self._base = self._source.position
            targets = [self._reader]
        else:
            targets = [lambda w=w: self._worker(self.seed + w)
                       for w in range(max(1, self.cfg.num_workers))]
            targets.append(self._collator)
        for target in targets:
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)

    def _reader(self):
        try:
            for batch in self._source:
                if not _put(self._batch_q, batch, self._stop):
                    return
        except BaseException as e:  # re-raised by __next__
            self._error = e
        finally:
            self._done.set()

    def _worker(self, seed: int):
        try:
            for s in sample_generator(self.cfg, self.want_east, seed):
                if not _put(self._sample_q, s, self._stop):
                    return
        except BaseException as e:
            self._error = e
            self._stop.set()

    def _collator(self):
        batcher = Batcher(self.cfg, self.want_east)
        buf: List[icdar.Sample] = []
        while not self._stop.is_set():
            try:
                buf.append(self._sample_q.get(timeout=_POLL_S))
            except queue.Empty:
                continue
            if len(buf) == self.cfg.batch_size:
                if not _put(self._batch_q, batcher.collate(buf), self._stop):
                    return
                buf = []

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        if not self._started:
            self._start()
        while True:
            if self._error is not None:
                raise RuntimeError("the data loader failed") from self._error
            if (self._stop.is_set() or self._done.is_set()) \
                    and self._batch_q.empty():
                raise StopIteration
            try:
                batch = self._batch_q.get(timeout=_POLL_S)
            except queue.Empty:
                continue
            self._delivered += 1
            return batch

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5.0)
        if hasattr(self._source, "stop"):
            self._source.stop()


class DevicePrefetcher(_Resumable):
    """Batches of ``loader`` on ``device``, ``depth`` ahead of the
    consumer. On the card a thread copies each array into pinned host
    memory and on to the card on a side stream (``non_blocking``), and
    records an event; ``next`` makes the current stream wait on it (and
    marks the tensors used there), so the copy overlaps the step before.
    On the CPU the arrays become tensors. File names stay on the host
    (``fns``). Resumable where ``loader`` is. With a data-parallel
    ``group`` (``parallel/mesh.py``) of several ranks, a batch of the
    loader's ``cfg.batch_size`` rows (the global batch) is cut to this
    rank's rows before the copy, a batch of ``batch_size / world`` rows
    (a per-rank reader's, ``data/resumable.py`` given the group) is
    copied as it is, and any other size raises (``rank_rows``): no batch
    is cut twice."""

    def __init__(self, loader, device="cuda", want_east: bool = False,
                 depth: int = 2, group=None):
        self._source = loader
        self.group = group if group is not None and group.world > 1 else None
        self.batch_size = (loader.cfg.batch_size if self.group is not None
                           else None)
        self.device = torch.device(device)
        self.want_east = want_east
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._stream = None

    def _upload(self, batch):
        if self.group is not None:
            from tensorflow_ocr_tpu_torch.parallel.mesh import rank_rows

            batch = rank_rows(self.group, batch, self.batch_size)
        if self.device.type != "cuda":
            return {k: (torch.as_tensor(v) if k != "fns" else v)
                    for k, v in batch.items()}, None
        out = {}
        with torch.cuda.stream(self._stream):
            for k, v in batch.items():
                if k == "fns":
                    out[k] = v
                    continue
                t = torch.as_tensor(v)
                if t.device.type == "cpu":
                    t = t.pin_memory()
                out[k] = t.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def _run(self):
        try:
            for batch in self._source:
                if not _put(self._q, self._upload(batch), self._stop):
                    return
        except BaseException as e:  # re-raised by __next__
            self._error = e
        finally:
            _put(self._q, None, self._stop)

    def __iter__(self):
        return self

    def __next__(self):
        if not self._started:
            self._started = True
            if self.resumable:
                self._base = self._source.position
            if self.device.type == "cuda":
                self._stream = torch.cuda.Stream(self.device)
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()
        item = self._q.get()
        if item is None:
            if self._error is not None:
                raise RuntimeError("the data loader failed") from self._error
            raise StopIteration
        batch, event = item
        if event is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(event)
            for k, v in batch.items():
                if torch.is_tensor(v):
                    v.record_stream(cur)
        self._delivered += 1
        return batch

    def stop(self):
        self._stop.set()
        if hasattr(self._source, "stop"):
            self._source.stop()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        if self._thread is not None:
            self._thread.join(timeout=5.0)


def get_batch(num_workers: int, cfg: Optional[DataConfig] = None,
              input_size: int = 512, batch_size: int = 14,
              want_east: bool = False, **_ignored):
    """The reference's entry (datasets/icdar.py:652-668 signature)."""
    cfg = cfg or DataConfig()
    cfg.num_workers = num_workers
    cfg.input_size = input_size
    cfg.batch_size = batch_size
    return PrefetchLoader(cfg, want_east=want_east)
