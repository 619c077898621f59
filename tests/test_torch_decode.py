"""Port parity: PixelLink decode (adjacency, components, boxes, overflow).

Seeded numpy maps go through the JAX decode (``connected_components``,
its plain XLA reference of the Pallas CC kernel) one image at a time and
through the PyTorch port batched. Labels and adjacency must be bit-exact;
component sizes and validity exact; box corners within 1e-3 at label-map
resolution. One exception, stated in :func:`assert_same_boxes`: where two
angles of the sweep give the same minimum area in exact arithmetic, the
last bit of the projections picks the angle (XLA fuses them into FMAs
and its cos/sin differ from torch's by an ulp), so there the two
rectangles must have the same area within 1e-3 instead.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_ocr_tpu.ops import decode as JD
from tensorflow_ocr_tpu_torch.ops import decode as TD
from tensorflow_ocr_tpu_torch.ops import kernels as TK

torch.set_num_threads(1)
BOX_ATOL = 1e-3


def _area(box):
    return (np.linalg.norm(box[1] - box[0])
            * np.linalg.norm(box[3] - box[0]))


def assert_same_boxes(got, want, atol=BOX_ATOL):
    """(K, 4, 2) boxes: corners within ``atol``, or, at an angle tie, both
    minimal rectangles of the same area within ``atol``."""
    assert got.shape == want.shape
    for g, w in zip(got, want):
        if not np.allclose(g, w, rtol=0, atol=atol):
            assert abs(_area(g) - _area(w)) <= atol, (g, w)


def _jax_labels(mask, links, thresh):
    """Per-image JAX labels, stacked: (B, h, w) int32."""
    out = []
    for m, l in zip(mask, links):
        edges = JD.link_adjacency(jnp.asarray(m), jnp.asarray(l), thresh)
        out.append(np.asarray(JD.connected_components(edges, jnp.asarray(m))))
    return np.stack(out)


def _port_labels(mask, links, thresh):
    m = torch.from_numpy(mask)
    edges = TD.link_adjacency(m, torch.from_numpy(links), thresh)
    return TK.connected_components_reference(edges, m).numpy()


def _random_maps(seed, b=3, h=24, w=32, density=0.55):
    rng = np.random.RandomState(seed)
    mask = rng.rand(b, h, w) > density
    links = rng.rand(b, h, w, 8).astype(np.float32)
    return mask, links


def _two_blobs():
    mask = np.zeros((1, 16, 24), bool)
    mask[0, 2:6, 2:10] = True
    mask[0, 10:14, 12:20] = True
    return mask, np.ones((1, 16, 24, 8), np.float32)


def _link_cut():
    """Touching blobs kept apart by links cut across column 7/8."""
    mask = np.zeros((1, 8, 16), bool)
    mask[0, 2:6, 2:14] = True
    links = np.ones((1, 8, 16, 8), np.float32)
    links[0, :, 7, 3:6] = 0.0   # right, right_down, right_up from col 7
    links[0, :, 8, 0:3] = 0.0   # left, left_down, left_up from col 8
    return mask, links


def test_link_adjacency_exact():
    mask, links = _random_maps(0)
    got = TD.link_adjacency(torch.from_numpy(mask), torch.from_numpy(links),
                            0.6).numpy()
    for i in range(len(mask)):
        want = np.asarray(JD.link_adjacency(jnp.asarray(mask[i]),
                                            jnp.asarray(links[i]), 0.6))
        np.testing.assert_array_equal(got[i], want)


@pytest.mark.parametrize("case", [
    "random_sparse", "random_dense", "two_blobs", "link_cut",
    "all_background", "all_foreground"])
def test_connected_components_reference_bit_exact(case):
    if case == "random_sparse":
        mask, links = _random_maps(1, density=0.55)
    elif case == "random_dense":
        mask, links = _random_maps(2, density=0.2)
    elif case == "two_blobs":
        mask, links = _two_blobs()
    elif case == "link_cut":
        mask, links = _link_cut()
    elif case == "all_background":
        mask = np.zeros((2, 12, 20), bool)
        links = np.ones((2, 12, 20, 8), np.float32)
    else:
        mask = np.ones((2, 12, 20), bool)
        links = np.ones((2, 12, 20, 8), np.float32)
    got = _port_labels(mask, links, 0.6)
    want = _jax_labels(mask, links, 0.6)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if case in ("two_blobs", "link_cut"):
        assert len(np.unique(got[mask])) == 2


def test_connected_components_dispatch_by_device():
    mask, links = _random_maps(3, b=2)
    m = torch.from_numpy(mask)
    edges = TD.link_adjacency(m, torch.from_numpy(links), 0.6)
    before = TK.connected_components.launches
    np.testing.assert_array_equal(TK.connected_components(edges, m).numpy(),
                                  TK.connected_components_reference(edges, m))
    # the plain version on the CPU is no kernel launch
    assert TK.connected_components.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        TK.connected_components(edges.to("meta"), m.to("meta"))


def test_extract_components_matches_jax():
    mask, links = _random_maps(4, b=2, h=24, w=32, density=0.35)
    labels = _port_labels(mask, links, 0.5)
    boxes, sizes, valid = (t.numpy() for t in TD.extract_components(
        torch.from_numpy(labels), max_components=16, min_size=3))
    assert boxes.shape == (2, 16, 4, 2)
    assert valid.any()
    for i in range(len(labels)):
        jb, js, jv = map(np.asarray, JD.extract_components(
            jnp.asarray(labels[i]), max_components=16, min_size=3))
        np.testing.assert_array_equal(sizes[i], js)
        np.testing.assert_array_equal(valid[i], jv)
        assert_same_boxes(boxes[i][jv], jb[jv])


def test_overflow_budget_matches_jax_and_full_budget_heals():
    """tests/test_decode.py:218-288 pattern: a dense map overflows a small
    foreground budget; the full-budget re-run is exact and clean."""
    mask = np.ones((1, 16, 16), bool)
    mask[0, :, 7] = False
    mask[0, 12:, :] = False
    mask[0, 14:, 12:] = True
    links = np.ones((1, 16, 16, 8), np.float32)
    labels = _port_labels(mask, links, 0.5)
    lab = torch.from_numpy(labels)

    boxes, sizes, valid = (t.numpy() for t in TD.extract_components(
        lab, max_components=8, min_size=1, max_pixels=32))
    jb, js, jv = map(np.asarray, JD.extract_components(
        jnp.asarray(labels[0]), max_components=8, min_size=1, max_pixels=32))
    np.testing.assert_array_equal(sizes[0], js)
    np.testing.assert_array_equal(valid[0], jv)
    assert np.all(np.isfinite(boxes))
    assert not valid.any()
    assert TD.overflow_retry_needed(sizes, valid, min_size=1)

    boxes, sizes, valid = (t.numpy() for t in TD.extract_components(
        lab, max_components=8, min_size=1, max_pixels=1 << 30))
    jb, js, jv = map(np.asarray, JD.extract_components(
        jnp.asarray(labels[0]), max_components=8, min_size=1,
        max_pixels=256))
    np.testing.assert_array_equal(valid[0], jv)
    assert valid.sum() >= 2
    assert not TD.overflow_retry_needed(sizes, valid, min_size=1)
    assert_same_boxes(boxes[0][jv], jb[jv])

    # a min_size rejection alone is no overflow
    ps = torch.zeros((1, 16, 16))
    ps[0, 2, 2] = 1.0
    _, sizes, valid = TD.pixellink_decode(ps, torch.ones((1, 16, 16, 8)),
                                          0.5, 0.5, min_size=10)
    assert not valid.any()
    assert not TD.overflow_retry_needed(sizes, valid, min_size=10)


def test_pixellink_decode_matches_jax():
    rng = np.random.RandomState(5)
    b, h, w = 2, 32, 48
    ps = ((rng.rand(b, h, w) < 0.4) * rng.rand(b, h, w)).astype(np.float32)
    ls = rng.rand(b, h, w, 8).astype(np.float32)
    boxes, sizes, valid = (t.numpy() for t in TD.pixellink_decode(
        torch.from_numpy(ps), torch.from_numpy(ls), 0.3, 0.4, min_size=4,
        max_components=32))
    assert valid.any()
    for i in range(b):
        jb, js, jv = map(np.asarray, JD.pixellink_decode(
            jnp.asarray(ps[i]), jnp.asarray(ls[i]), 0.3, 0.4, min_size=4,
            max_components=32, use_pallas=False))
        np.testing.assert_array_equal(sizes[i], js)
        np.testing.assert_array_equal(valid[i], jv)
        assert_same_boxes(boxes[i][jv], jb[jv])
