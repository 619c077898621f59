"""The round cap of the plain connected components, pinned against JAX.

``connected_components_reference(edges, mask, max_iters=k)`` stops after
k rounds of pointer jumping and a min-label sweep, as JAX's
``connected_components(..., max_iters=k)`` (ops/decode.py:101-161) does,
and returns a long component in pieces where k rounds do not suffice.
On a serpentine (every other row full, joined at alternate ends: one
component along a path of 200 pixels) both must give the same labels,
label for label, after each cap, the default h + w cap included. The
JAX side runs one image at a time as tests/test_torch_decode.py does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_ocr_tpu.ops import decode as JD
from tensorflow_ocr_tpu_torch.ops import decode as TD
from tensorflow_ocr_tpu_torch.ops import kernels as TK

torch.set_num_threads(1)
H, W = 16, 24


def serpentine(h, w):
    mask = np.zeros((h, w), bool)
    mask[0::2, :] = True
    for y in range(1, h, 2):
        mask[y, w - 1 if (y // 2) % 2 == 0 else 0] = True
    return mask, np.ones((h, w, 8), np.float32)


@pytest.mark.parametrize("max_iters", [1, 2, 3, 5, 8, 24, None])
def test_round_cap_matches_jax_label_for_label(max_iters):
    mask, links = serpentine(H, W)
    edges = JD.link_adjacency(jnp.asarray(mask), jnp.asarray(links), 0.5)
    want = np.asarray(JD.connected_components(edges, jnp.asarray(mask),
                                              max_iters=max_iters))
    m = torch.from_numpy(mask)[None]
    tedges = TD.link_adjacency(m, torch.from_numpy(links)[None], 0.5)
    got = TK.connected_components_reference(tedges, m, max_iters=max_iters)
    np.testing.assert_array_equal(got[0].numpy(), want)
    # the serpentine needs 25 rounds: fewer leave it in pieces, the
    # default cap (h + w = 40) joins it
    pieces = len(np.unique(want[mask]))
    assert (pieces > 1) == (max_iters is not None and max_iters < 25)
