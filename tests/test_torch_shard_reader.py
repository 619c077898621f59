"""Per-rank shard reading: ``data/resumable.py`` ``ResumableLoader`` given
a data-parallel group, and ``data/pipeline.py`` ``DevicePrefetcher``'s
rows.

Single process, on the CPU: each rank is a ``DataGroup(rank, world,
cpu)`` with no process group (the loader reads only ``rank`` and
``world``). 8 synthetic v2 scenes at 96x128, input 64, the host's crop
and rotation on, a global batch of 12 (an epoch of 8 files ends inside
batch 0 and batch 2 starts the third epoch). For world 2 and 4 and each
rank:

- every batch's arrays and file names equal the rank's rows of a world-1
  loader's batch (``DataGroup.rows``), over the epoch boundaries;
- ``len`` is the global count (``num_epochs`` x files // B) on every
  rank, and the iterator stops there; a B that the ranks do not divide is
  refused, naming both numbers;
- ``prepare_sample`` runs B/n times a batch (a counter patched in);
- ``get_state`` is the same bytes on every rank and a world-1 loader's at
  the same position, and a fresh rank given world-1's (rank 0's) state
  replays the rest of its rows;
- ``DevicePrefetcher`` on the CPU with the group passes a B/n-row batch
  as it is, still cuts a B-row one (B its loader's ``cfg.batch_size``),
  and raises on any other size; through ``PrefetchLoader(source=...)``
  it keeps the source's position.
"""

import threading

import numpy as np
import pytest
import torch

from tensorflow_ocr_tpu_torch.config import Config
from tensorflow_ocr_tpu_torch.data import icdar
from tensorflow_ocr_tpu_torch.data.pipeline import (DevicePrefetcher,
                                                    PrefetchLoader)
from tensorflow_ocr_tpu_torch.data.resumable import ResumableLoader
from tensorflow_ocr_tpu_torch.parallel.mesh import DataGroup

torch.set_num_threads(1)
B, BATCHES = 12, 3
RANKS = [(w, r) for w in (2, 4) for r in range(w)]
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("shard")
    icdar.make_synthetic_dataset(str(d), 8, (96, 128), seed=5, hard="v2")
    return str(d)


def _cfg(path, batch_size=B):
    cfg = Config()
    d = cfg.data
    d.training_data_path, d.input_size, d.batch_size = path, 64, batch_size
    d.max_polys, d.num_workers, d.max_queue_size = 8, 2, 2
    d.use_crop = d.use_rotate = True
    d.min_text_size = 2
    return cfg.data


_WHOLE = {}


def whole_batches(dataset):
    """A world-1 loader's first BATCHES batches and its state after each
    (computed once)."""
    if dataset not in _WHOLE:
        it = ResumableLoader(_cfg(dataset), seed=4)
        out = []
        for _ in range(BATCHES):
            out.append(next(it))
        states = [it.state_at(p) for p in range(BATCHES + 1)]
        it.stop()
        _WHOLE[dataset] = (out, states)
    return _WHOLE[dataset]


def same_rows(got, whole, rows):
    assert got["fns"] == list(whole["fns"])[rows]
    assert set(got) == set(whole)
    for k in set(whole) - {"fns"}:
        assert np.array_equal(got[k], np.asarray(whole[k])[rows]), k


@pytest.mark.parametrize("world,rank", RANKS)
def test_rank_rows_equal_world_one(dataset, world, rank):
    group = DataGroup(rank, world, CPU)
    want, _ = whole_batches(dataset)
    it = ResumableLoader(_cfg(dataset), seed=4, group=group)
    rows = group.rows(B)
    for p in range(BATCHES):
        got = next(it)
        assert len(got["images"]) == B // world
        same_rows(got, want[p], rows)
    it.stop()


@pytest.mark.parametrize("world,rank", RANKS)
def test_length_is_global_and_odd_batches_are_refused(dataset, world, rank):
    group = DataGroup(rank, world, CPU)
    it = ResumableLoader(_cfg(dataset), seed=4, num_epochs=3, group=group)
    assert len(it) == 3 * 8 // B == 2
    assert len(list(it)) == 2  # the partial third global batch dropped
    it.stop()
    odd = 3 * world + 1
    with pytest.raises(ValueError) as e:
        ResumableLoader(_cfg(dataset, odd), group=group)
    assert str(odd) in str(e.value) and str(world) in str(e.value)


@pytest.mark.parametrize("world,rank", RANKS)
def test_prepare_sample_runs_for_the_rank_rows_only(dataset, world, rank,
                                                    monkeypatch):
    calls, lock = [], threading.Lock()
    prepare = icdar.prepare_sample

    def counted(*a, **k):
        with lock:
            calls.append(a[0])
        return prepare(*a, **k)

    monkeypatch.setattr(icdar, "prepare_sample", counted)
    group = DataGroup(rank, world, CPU)
    it = ResumableLoader(_cfg(dataset), seed=4, group=group)
    for p in range(2):
        before = len(calls)
        batch = next(it)
        assert len(calls) - before == B // world, p
        assert sorted(calls[before:]) == sorted(batch["fns"])
    it.stop()
    whole = ResumableLoader(_cfg(dataset), seed=4)
    before = len(calls)
    next(whole)
    assert len(calls) - before == B
    whole.stop()


@pytest.mark.parametrize("world,rank", RANKS)
def test_state_is_global_and_resumes_every_rank(dataset, world, rank):
    want, states = whole_batches(dataset)
    loaders = [ResumableLoader(_cfg(dataset), seed=4,
                               group=DataGroup(r, world, CPU))
               for r in range(world)]
    assert all(it.get_state() == states[0] for it in loaders)
    for it in loaders:
        next(it)
    # the same bytes on every rank, a world-1 loader's, naming no rank
    assert all(it.get_state() == states[1] for it in loaders)
    assert b"rank" not in states[1]
    for it in loaders:
        it.stop()
    group = DataGroup(rank, world, CPU)
    fresh = ResumableLoader(_cfg(dataset), seed=4, group=group)
    fresh.set_state(states[1])  # rank 0's checkpoint
    for p in range(1, BATCHES):
        same_rows(next(fresh), want[p], group.rows(B))
    assert fresh.get_state() == states[BATCHES]
    with pytest.raises(ValueError):
        ResumableLoader(_cfg(dataset), seed=5, group=group).set_state(
            states[1])
    fresh.stop()


class _Batches:
    """Given batches, with the loader config the prefetcher reads B
    from."""

    def __init__(self, cfg, batches):
        self.cfg, self.batches = cfg, batches

    def __iter__(self):
        return iter(self.batches)


@pytest.mark.parametrize("world,rank", RANKS)
def test_device_prefetcher_cuts_a_batch_once(dataset, world, rank):
    group = DataGroup(rank, world, CPU)
    want, states = whole_batches(dataset)
    rows = group.rows(B)
    local = {k: (np.asarray(v)[rows] if k != "fns" else list(v)[rows])
             for k, v in want[1].items()}
    odd = {k: v[:B // world + 1] for k, v in want[2].items()}
    chain = DevicePrefetcher(_Batches(_cfg(dataset), [want[0], local, odd]),
                             "cpu", group=group)
    cut = next(chain)
    same_rows({k: (v.numpy() if torch.is_tensor(v) else v)
               for k, v in cut.items()}, want[0], rows)
    passed = next(chain)
    assert passed["fns"] == local["fns"]
    for k in set(local) - {"fns"}:
        assert torch.equal(passed[k], torch.as_tensor(local[k])), k
    with pytest.raises(RuntimeError) as e:
        next(chain)
    assert isinstance(e.value.__cause__, ValueError)
    assert f"{B // world + 1} rows" in str(e.value.__cause__)
    chain.stop()

    # the host chain: the global size from the loader's config, the
    # per-rank reader's batches copied as they are, its position kept
    cfg = _cfg(dataset)
    chain = DevicePrefetcher(
        PrefetchLoader(cfg, source=ResumableLoader(cfg, seed=4,
                                                   group=group)),
        "cpu", group=group)
    assert chain.batch_size == B
    for p in range(2):
        got = next(chain)
        same_rows({k: (v.numpy() if torch.is_tensor(v) else v)
                   for k, v in got.items()}, want[p], rows)
    assert chain.get_state() == states[2]
    chain.stop()
