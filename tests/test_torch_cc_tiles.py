"""The connected-components kernel (csrc/cc.cu, block-based union-find)
emulated on the CPU and held label for label against the plain version
(ops/kernels.py ``connected_components_reference``, uncapped) and JAX's
``connected_components`` (ops/decode.py:103) where that converges within
its cap.

The emulation walks the kernel's three launches: local (each T x T tile
of each image, the ragged right and bottom tiles included, joins each
linked pair whose both ends lie in the tile, taken once from its later
pixel: row runs under their first pixel, then the runs above by union,
the larger root under the smaller, skipping a pair of runs that an
earlier direction of the pixel or the previous pixel of its run already
links; it writes each mask pixel's local root as its global index,
background h*w), border (each tile's
pixels with backward neighbours in other tiles, its top row and its left
and right columns, union those pairs: across a side, and at a corner into
the diagonal neighbour tile; a pair whose predecessor along the side is
linked the same way, with both ends already in its trees, is skipped)
and flatten (each mask pixel to its root). Labels start as a garbage
value, a stand-in for torch.empty.

Planted faults, each of which must be caught: the border pass dropping
the diagonal links into a corner's diagonal tile, the tiles laid over the
batch as one tall map with each tile taken to lie in one image (the rows
of a tile past its first image's bottom are skipped), and the ragged right
and bottom tiles skipped.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_ocr_tpu.ops import decode as JD
from tensorflow_ocr_tpu_torch.ops import decode as TD
from tensorflow_ocr_tpu_torch.ops import kernels as TK
from tensorflow_ocr_tpu_torch.ops.labels import LINK_OFFSETS

torch.set_num_threads(1)
GARBAGE = -7
FAULTS = ("corner_diagonals", "span_images", "ragged")


# a pixel's backward neighbours (before it in row-major order): (dx, dy),
# its link channel to the neighbour and the neighbour's channel back
BACK = ((-1, 0, 0, 3), (-1, -1, 2, 4), (0, -1, 6, 7), (1, -1, 5, 1))


def emulate_cc(edges, mask, tile, fault=None):
    """cc_local, cc_border and cc_flatten on the CPU: (B, h, w, 8) bool
    edges and (B, h, w) bool mask -> (B, h, w) int32 labels. A pair of
    pixels counts where either end's bit links it, and is taken once, by
    its later pixel; the border pass skips a pair whose predecessor along
    the tile's side is linked the same way with both ends in its trees."""
    for dx, dy, c, rc in BACK:  # the channels there and back
        assert LINK_OFFSETS[c] == (dx, dy) and LINK_OFFSETS[rc] == (-dx, -dy)
    b, h, w = mask.shape
    n = h * w
    e = edges.numpy().reshape(b, n, 8)
    m = mask.numpy().reshape(b, n)
    labels = np.full((b, n), GARBAGE, np.int64)

    def unite(par, a, c, find):
        while True:
            a, c = find(a), find(c)
            if a == c:
                return
            a, c = min(a, c), max(a, c)
            old = par[c]
            par[c] = min(old, a)  # atomicMin
            if old == c:
                return
            c = old

    def pair(img, x, y, d):
        """The pixel index of (x, y)'s backward neighbour d where it is in
        the image, on the mask and linked by either bit, else None."""
        dx, dy, c, rc = BACK[d]
        nx, ny = x + dx, y + dy
        if not (0 <= nx < w and ny >= 0):
            return None
        p, q = y * w + x, ny * w + nx
        ok = m[img, p] and m[img, q] and (e[img, p, c] or e[img, q, rc])
        return q if ok else None

    # local: the tiles of each image (fault span_images: of the tall map)
    tiles_h = -(-h // tile) if fault != "ragged" else h // tile
    tiles_w = -(-w // tile) if fault != "ragged" else w // tile
    if fault == "span_images":
        tiles = [(yt // h, yt % h, tx * tile)
                 for yt in range(0, b * h, tile) for tx in range(tiles_w)]
    else:
        tiles = [(img, ty * tile, tx * tile) for img in range(b)
                 for ty in range(tiles_h) for tx in range(tiles_w)]
    for img, y0, x0 in tiles:
        pix = [(y, x) for y in range(y0, min(y0 + tile, h))
               for x in range(x0, min(x0 + tile, w))]
        local = {y * w + x: (y - y0) * tile + x - x0 for y, x in pix}
        par = {local[y * w + x]: local[y * w + x] for y, x in pix
               if m[img, y * w + x]}

        def lfind(v):
            while par[v] != v:
                v = par[v]
            return v

        def in_tile(x, y, d):
            """pair() where the neighbour lies in the tile, else None."""
            q = pair(img, x, y, d)
            return q if q is not None and q in local else None

        # row runs: a run's first pixel (no link to its left neighbour) is
        # the parent of each pixel of the run
        run = {}
        for y, x in pix:
            if m[img, y * w + x]:
                left = in_tile(x, y, 0)
                run[y * w + x] = run[left] if left is not None else y * w + x
                par[local[y * w + x]] = local[run[y * w + x]]
        # the runs above, unless an earlier direction of the pixel or the
        # previous pixel of its run links the same two runs
        for y, x in pix:
            if not m[img, y * w + x] or y == y0:
                continue
            left = in_tile(x, y, 0) is not None
            for d in (1, 2, 3):
                q = in_tile(x, y, d)
                if q is None:
                    continue
                earlier = [in_tile(x, y, d2) for d2 in range(1, d)]
                if left:
                    earlier += [in_tile(x - 1, y, d2) for d2 in (1, 2, 3)]
                if any(q2 is not None and run[q2] == run[q] for q2 in earlier):
                    continue
                unite(par, local[run[y * w + x]], local[run[q]], lfind)
        for y, x in pix:
            r = lfind(local[y * w + x]) if m[img, y * w + x] else None
            labels[img, y * w + x] = (n if r is None else
                                      (y0 + r // tile) * w + x0 + r % tile)

    # border: the pixels with backward neighbours in other tiles
    for img in range(b):
        par = labels[img]

        def gfind(v):
            while 0 <= v < n and par[v] != v:  # a fault's garbage stops it
                v = par[v]
            return v

        for ty in range(tiles_h):
            for tx in range(tiles_w):
                y0, x0 = ty * tile, tx * tile
                th, tw = min(tile, h - y0), min(tile, w - x0)
                # (pixel, predecessor step): the top row, then the left
                # and the right column below it
                cand = ([(x0 + lx, y0, -1, 0) for lx in range(tw)]
                        + [(x0, y0 + ly, 0, -1) for ly in range(1, th)]
                        + [(x0 + tw - 1, y0 + ly, 0, -1)
                           for ly in range(1, th) if tw > 1])
                for x, y, px, py in cand:
                    if not m[img, y * w + x]:
                        continue
                    for d in range(4):
                        q = pair(img, x, y, d)
                        if q is None:
                            continue
                        qx, qy = q % w, q // w
                        if qx // tile == tx and qy // tile == ty:
                            continue  # the local pass's
                        if qx // tile != tx and qy // tile != ty \
                                and fault == "corner_diagonals":
                            continue
                        ax, ay = x + px, y + py
                        if ax >= x0 and ay >= 0:
                            q2 = pair(img, ax, ay, d)
                            if q2 is not None \
                                    and par[ay * w + ax] == par[y * w + x] \
                                    and par[q2] == par[q]:
                                continue
                        unite(par, y * w + x, q, gfind)
        # flatten
        for i in range(n):
            if m[img, i] and par[i] != GARBAGE:
                par[i] = gfind(par[i])
    return torch.from_numpy(labels.reshape(b, h, w).astype(np.int32))


def maps(mask, links=None, thresh=0.5):
    """(edges, mask) torch tensors from a numpy mask (B, h, w) and link
    scores (all on by default)."""
    m = torch.from_numpy(mask)
    lk = torch.ones(m.shape + (8,)) if links is None else torch.from_numpy(
        links)
    return TD.link_adjacency(m, lk, thresh), m


def blobs(seed, shape):
    """Text-like maps: horizontal bars and noise pixels, links mostly on."""
    rng = np.random.RandomState(seed)
    b, h, w = shape
    mask = np.zeros(shape, bool)
    for i in range(b):
        for _ in range(rng.randint(4, 12)):
            y, x = rng.randint(0, h - 2), rng.randint(0, w - 4)
            mask[i, y:y + rng.randint(1, 6), x:x + rng.randint(3, 30)] = True
    mask |= rng.rand(*shape) < 0.05
    links = rng.rand(*shape, 8).astype(np.float32)
    return mask, links


def serpentine_cols(h, w):
    """Every other column full, joined at alternate ends: one component
    whose path crosses every tile border of a row of tiles many times."""
    mask = np.zeros((1, h, w), bool)
    mask[0, :, 0::2] = True
    for x in range(1, w, 2):
        mask[0, h - 1 if (x // 2) % 2 == 0 else 0, x] = True
    return mask


def diagonal_chains(h, w):
    """An X: a down-right chain from (0, 0) and an up-right chain from the
    bottom-left, linked only diagonally (bar where they cross), through
    the tiles' corners."""
    mask = np.zeros((1, h, w), bool)
    k = np.arange(min(h, w))
    mask[0, k, k] = True
    mask[0, h - 1 - k, k] = True
    return mask


def case(name):
    if name == "blobs":
        return maps(*blobs(0, (2, 48, 80)), 0.15)
    if name == "ragged_blobs":
        return maps(*blobs(1, (3, 40, 72)), 0.15)
    if name == "serpentine":
        return maps(serpentine_cols(40, 72))
    if name == "diagonal_corners":
        return maps(diagonal_chains(48, 48))
    if name == "full":
        return maps(np.ones((2, 40, 72), bool))
    if name == "empty":
        return maps(np.zeros((2, 40, 72), bool))
    raise KeyError(name)


CASES = ("blobs", "ragged_blobs", "serpentine", "diagonal_corners", "full",
         "empty")


def uncapped(edges, mask):
    return TK.connected_components_reference(edges, mask, max_iters=1 << 20)


@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("name", CASES)
def test_cc_emulation_equals_the_uncapped_plain_version(name, tile):
    edges, mask = case(name)
    got = emulate_cc(edges, mask, tile)
    assert bool((got != GARBAGE).all())
    assert torch.equal(got, uncapped(edges, mask))


@pytest.mark.parametrize("name", ("blobs", "ragged_blobs", "full", "empty",
                                  "diagonal_corners"))
def test_cc_emulation_matches_jax_where_it_converges(name):
    """JAX's connected_components (its h + w round cap; one image at a
    time, as tests/test_torch_decode.py runs it) on maps that converge
    within the cap."""
    edges, mask = case(name)
    got = emulate_cc(edges, mask, 16)
    for i in range(mask.shape[0]):
        want = np.asarray(JD.connected_components(
            jnp.asarray(edges[i].numpy()), jnp.asarray(mask[i].numpy())))
        np.testing.assert_array_equal(got[i].numpy(), want)


@pytest.mark.parametrize("fault,name", [
    ("corner_diagonals", "diagonal_corners"),
    ("span_images", "ragged_blobs"),
    ("span_images", "full"),
    ("ragged", "ragged_blobs"),
    ("ragged", "serpentine"),
])
def test_cc_emulation_catches_planted_faults(fault, name):
    """At 16 x 16 tiles: the diagonal chains cross tiles only at corners;
    h = 40 and w = 72 leave ragged tiles of 8 rows and columns, which a
    tall map's tiles straddle from one image into the next."""
    edges, mask = case(name)
    assert not torch.equal(emulate_cc(edges, mask, 16, fault),
                           uncapped(edges, mask))


def test_the_cases_cross_tile_borders():
    """The serpentine's one component and the X of diagonal chains span
    many 16 x 16 tiles; the ragged maps are no multiple of the tile."""
    for name, parts in (("serpentine", 1), ("diagonal_corners", 1)):
        edges, mask = case(name)
        labels = uncapped(edges, mask)[mask]
        assert len(torch.unique(labels)) == parts
        ys, xs = torch.nonzero(mask[0], as_tuple=True)
        assert len(set(zip((ys // 16).tolist(), (xs // 16).tolist()))) >= 5
    _, mask = case("ragged_blobs")
    assert mask.shape[1] % 16 and mask.shape[2] % 16
