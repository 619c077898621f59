"""Port parity: the OHEM PixelLink loss and its gradient.

Seeded numpy logits and labels go through ``ops/losses.py`` of both
packages. Cases: random logits; a zero-logit plateau, where every
negative score ties at 0.5 and the selection must keep the ties as
JAX's value bisection keeps them (``torch.topk`` would cut them); an
image with no positive pixel (nothing selected there, unless
``bg_neg_budget``); the bfloat16 compute dtype.
Tolerances: float32 rtol = 1e-5 for the loss and its aux scalars, 1e-4
(of the largest value) for the logit gradients; bfloat16 compute 1e-2
relative (CE terms in bfloat16, softmax rounded once in torch and per
operation in JAX); the selected-negative masks are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_ocr_tpu.ops import losses as JLoss
from tensorflow_ocr_tpu_torch.ops import losses as TLoss

torch.set_num_threads(1)


def case(rng, kind, b=3, h=6, w=7):
    labels = (rng.rand(b, h, w, 1) < 0.25).astype(np.float32)
    links = (rng.rand(b, h, w, 8) < 0.5).astype(np.float32)
    mask = (rng.rand(b, h, w, 1) > 0.1).astype(np.float32)
    pl = rng.randn(b, h, w, 2).astype(np.float32) * 2
    ll = rng.randn(b, h, w, 16).astype(np.float32) * 2
    if kind == "plateau":
        pl[:] = 0.0
    if kind in ("no_positives", "bg_budget"):
        labels[1] = 0.0
    return labels, pl, links, ll, mask


KW = {"random": {}, "plateau": {}, "no_positives": {},
      "bg_budget": {"bg_neg_budget": 5}, "no_mask": {"mask": None}}


@pytest.mark.parametrize("kind", sorted(KW))
def test_ohem_loss_matches_jax(kind):
    rng = np.random.RandomState(len(kind))
    labels, pl, links, ll, mask = case(rng, kind)
    kw = dict(KW[kind])
    if kw.pop("mask", 0) is None:
        mask = None
    jfn = lambda p, l: JLoss.ohem_pixel_link_loss(  # noqa: E731
        jnp.asarray(labels), p, jnp.asarray(links), l,
        None if mask is None else jnp.asarray(mask), **kw)
    (jtotal, jaux), (jgp, jgl) = jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True)(jnp.asarray(pl), jnp.asarray(ll))

    tpl = torch.from_numpy(pl).requires_grad_()
    tll = torch.from_numpy(ll).requires_grad_()
    total, aux = TLoss.ohem_pixel_link_loss(
        torch.from_numpy(labels), tpl, torch.from_numpy(links), tll,
        None if mask is None else torch.from_numpy(mask), **kw)
    np.testing.assert_allclose(float(total.detach()), float(jtotal),
                               rtol=1e-5)
    assert sorted(aux) == sorted(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(aux[k].detach()), float(jaux[k]),
                                   rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    total.backward()
    for g, jg in ((tpl.grad, jgp), (tll.grad, jgl)):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-4,
                                   atol=1e-4 * np.abs(jg).max())


def test_ohnm_selection_keeps_ties_like_jax():
    """On a plateau every negative ties at the threshold: all are
    selected (JAX's rule), where a top-k of 3*n_pos would cut them."""
    rng = np.random.RandomState(7)
    n = 40
    pos = np.zeros((2, n), bool)
    pos[0, :3] = True
    neg = ~pos & (rng.rand(2, n) > 0.2)
    scores = np.full((2, n), 0.5, np.float32)
    scores[0, 30:] = 0.25  # ten strictly harder negatives on image 0
    got = TLoss.ohnm_mask(torch.from_numpy(scores), torch.from_numpy(pos),
                          torch.from_numpy(neg), 3).numpy()
    for i in range(2):
        want = np.asarray(JLoss.ohnm_mask(jnp.asarray(scores[i]),
                                          jnp.asarray(pos[i]),
                                          jnp.asarray(neg[i]), 3))
        np.testing.assert_array_equal(got[i], want)
    assert got[0].sum() > 9  # the 9 hardest plus the tied ones
    assert got[1].sum() == 0  # no positives: nothing selected


def test_ohem_loss_bfloat16_compute_matches_jax():
    rng = np.random.RandomState(11)
    labels, pl, links, ll, mask = case(rng, "random")
    jtotal, jaux = JLoss.ohem_pixel_link_loss(
        *map(jnp.asarray, (labels, pl, links, ll, mask)),
        compute_dtype="bfloat16")
    total, aux = TLoss.ohem_pixel_link_loss(
        *map(torch.from_numpy, (labels, pl, links, ll, mask)),
        compute_dtype="bfloat16")
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-2)
    np.testing.assert_allclose(float(aux["n_pos"]), float(jaux["n_pos"]))


def test_unported_losses_name_the_roadmap():
    TLoss.check_loss_ported("ohem")
    for name in ("dice", "focal", "positive", "east"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TLoss.check_loss_ported(name)
    with pytest.raises(ValueError, match="unknown loss"):
        TLoss.check_loss_ported("nope")
