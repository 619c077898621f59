"""The batching and prefetch layers against the JAX package's.

``tensorflow_ocr_tpu_torch/data/pipeline.py`` on the CPU:

- ``batch_generator`` gives JAX's batches for the same seed and files
  (the same files in the same order, the same polygons within 1e-4,
  tags and valid exactly; images within the codec's resize tolerance,
  1 level on at most 1% of the values), with and without augmentation;
- ``PrefetchLoader`` delivers full batches from its worker threads and
  ``stop()`` ends them; over a resumable source it delivers the source's
  batches in order and keeps its position;
- ``DevicePrefetcher`` on the CPU hands tensors over (file names stay
  on the host), and the position it reports is the consumer's, however
  far ahead it read;
- ``get_batch`` is the reference's entry.
"""

import time

import numpy as np
import pytest
import torch

from tensorflow_ocr_tpu.config import DataConfig as JData
from tensorflow_ocr_tpu.data import pipeline as JP
from tensorflow_ocr_tpu_torch.config import DataConfig
from tensorflow_ocr_tpu_torch.data import icdar as T
from tensorflow_ocr_tpu_torch.data import pipeline as P
from tensorflow_ocr_tpu_torch.data.resumable import ResumableLoader

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipe")
    T.make_synthetic_dataset(str(d), 5, (160, 200), seed=3, hard="v2")
    return str(d)


def _configs(path, **flags):
    j, t = JData(), DataConfig()
    for c in (j, t):
        c.training_data_path = path
        c.input_size, c.batch_size, c.max_polys = 64, 2, 8
        c.num_workers, c.max_queue_size = 2, 2
        for k, v in flags.items():
            setattr(c, k, v)
    return j, t


@pytest.mark.parametrize("flags", [{}, dict(use_crop=True, use_rotate=True,
                                            use_random_scale=True)])
@pytest.mark.parametrize("want_east", [False, True])
def test_batch_generator_matches_jax(dataset, flags, want_east):
    jcfg, tcfg = _configs(dataset, **flags)
    jgen = JP.batch_generator(jcfg, want_east, seed=4)
    tgen = P.batch_generator(tcfg, want_east, seed=4)
    for _ in range(4):
        j, t = next(jgen), next(tgen)
        assert set(j) == set(t) and t["fns"] == j["fns"]
        d = np.abs(t["images"].astype(int) - j["images"])
        assert d.max() <= 2 and (d > 0).mean() <= 0.01
        for k in set(t) - {"images", "fns"}:
            if t[k].dtype == bool:
                assert np.array_equal(t[k], j[k]), k
            else:
                np.testing.assert_allclose(t[k], j[k], rtol=0, atol=1e-4)


def test_prefetch_loader_delivers_and_stops(dataset):
    _, cfg = _configs(dataset)
    loader = P.PrefetchLoader(cfg, seed=1)
    assert loader.get_state() is None  # its own streams keep no position
    for _ in range(3):
        b = next(loader)
        assert b["images"].shape == (2, 64, 64, 3) and len(b["fns"]) == 2
    loader.stop()
    for t in loader._threads:
        assert not t.is_alive()
    with pytest.raises(StopIteration):
        while True:
            next(loader)


def test_prefetchers_keep_the_consumer_s_position(dataset):
    _, cfg = _configs(dataset)
    src = ResumableLoader(cfg, seed=2)
    chain = P.DevicePrefetcher(P.PrefetchLoader(cfg, source=src), "cpu",
                               depth=2)
    ref = ResumableLoader(cfg, seed=2)
    try:
        for i in range(3):
            b, want = next(chain), next(ref)
            assert isinstance(b["images"], torch.Tensor)
            assert b["images"].dtype == torch.uint8 and b["fns"] == \
                want["fns"]
            assert np.array_equal(b["images"].numpy(), want["images"])
            assert chain.position == i + 1
        deadline = time.monotonic() + 10.0  # the reader thread reads ahead
        while src.position <= chain.position and time.monotonic() < deadline:
            time.sleep(0.01)
        assert src.position > chain.position
        assert chain.get_state() == ref.get_state()
        with pytest.raises(RuntimeError, match="after the first"):
            chain.set_state(ref.get_state())
    finally:
        chain.stop()
        ref.stop()


def test_device_prefetcher_ends_with_its_source(dataset):
    _, cfg = _configs(dataset)
    batches = [{"images": np.zeros((2, 4, 4, 3), np.uint8), "fns": ["a"]}] * 3
    chain = P.DevicePrefetcher(iter(batches), "cpu")
    got = list(chain)
    assert len(got) == 3 and got[0]["fns"] == ["a"]
    assert chain.get_state() is None


def test_get_batch_is_the_reference_entry(dataset):
    _, cfg = _configs(dataset)
    loader = P.get_batch(1, cfg, input_size=64, batch_size=2)
    try:
        assert next(loader)["images"].shape == (2, 64, 64, 3)
    finally:
        loader.stop()
