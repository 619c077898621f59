"""Port parity: the losses beside OHEM, value and gradient.

Seeded numpy maps go through each loss of ``ops/losses.py`` of both
packages: ``dice_loss``, ``dice_pixel_link_loss``,
``positive_pixel_link_loss``, ``focal_loss``, ``focal_loss_binary``,
``east_quad_loss`` and ``east_loss``. The gradient is taken with respect
to every prediction input (``jax.value_and_grad`` on the JAX side,
autograd on the port's). Cases: random maps, and all-negative labels
(the ``_safe_div`` branch of the normalisers, and ``max(n_pos, 1)`` of
the focal losses). Tolerances: float32, rtol 1e-5 on the value and the
aux scalars, 1e-4 on the gradients (relative, and of their largest
value).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_ocr_tpu.ops import losses as JLoss
from tensorflow_ocr_tpu_torch.ops import losses as TLoss

torch.set_num_threads(1)
B, H, W = 2, 6, 7


def maps(rng, kind):
    """Labels, mask and predictions of every loss, as float32 numpy."""
    pos = rng.rand(B, H, W, 1) < 0.3
    if kind == "negative":
        pos[:] = False
    geo_gt = np.concatenate([rng.uniform(1, 40, (B, H, W, 4)),
                             rng.uniform(-0.7, 0.7, (B, H, W, 1))], -1)
    geo_p = np.concatenate([rng.uniform(1, 40, (B, H, W, 4)),
                            rng.uniform(-0.7, 0.7, (B, H, W, 1))], -1)
    quad_gt = np.concatenate([rng.randn(B, H, W, 8) * 20,
                              rng.uniform(0.5, 30, (B, H, W, 1))], -1)
    f = np.float32
    return {
        "score": pos.astype(f),
        "mask": (rng.rand(B, H, W, 1) > 0.15).astype(f),
        "link": ((rng.rand(B, H, W, 8) < 0.5) & pos).astype(f),
        "probs": rng.uniform(0.01, 0.99, (B, H, W, 1)).astype(f),
        "link_probs": rng.uniform(0.01, 0.99, (B, H, W, 8)).astype(f),
        "pixel_logits": (rng.randn(B, H, W, 2) * 2).astype(f),
        "link_logits": (rng.randn(B, H, W, 16) * 2).astype(f),
        "geo_gt": geo_gt.astype(f), "geo_p": geo_p.astype(f),
        "quad_gt": quad_gt.astype(f),
        "quad_p": (rng.randn(B, H, W, 8) * 20).astype(f),
    }


# name: (fixed inputs, differentiated inputs, keyword arguments); each
# loss is called as loss(*fixed_and_diff_in_order, **kw)
LOSSES = {
    "dice_loss": (("score", "probs", "mask"), ("probs",), {}),
    "dice_pixel_link_loss": (("score", "probs", "link", "link_probs",
                              "mask"), ("probs", "link_probs"), {}),
    "positive_pixel_link_loss": (("score", "pixel_logits", "link",
                                  "link_logits"),
                                 ("pixel_logits", "link_logits"),
                                 {"pixel_loss_weight": 2.0}),
    "focal_loss": (("score", "pixel_logits", "mask"), ("pixel_logits",),
                   {"alpha": 0.25, "gamma": 2.0}),
    "focal_loss_binary": (("score", "probs", "mask"), ("probs",),
                          {"alpha": 0.3, "gamma": 2.0}),
    "east_quad_loss": (("score", "probs", "quad_gt", "quad_p", "mask"),
                       ("probs", "quad_p"), {}),
    "east_loss": (("score", "probs", "geo_gt", "geo_p", "mask"),
                  ("probs", "geo_p"), {"angle_weight": 10.0}),
}


def split(out):
    """(value, aux) of a loss that returns a tuple, else (value, {})."""
    return out if isinstance(out, tuple) else (out, {})


@pytest.mark.parametrize("kind", ["random", "negative"])
@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_and_gradient_match_jax(name, kind):
    args, diff, kw = LOSSES[name]
    m = maps(np.random.RandomState(len(name) + len(kind)), kind)

    def jfn(*d):
        vals = dict(zip(diff, d))
        return split(getattr(JLoss, name)(
            *[vals.get(a, jnp.asarray(m[a])) for a in args], **kw))

    (jval, jaux), jgrads = jax.value_and_grad(
        jfn, argnums=tuple(range(len(diff))), has_aux=True)(
        *[jnp.asarray(m[a]) for a in diff])

    tdiff = {a: torch.from_numpy(m[a]).requires_grad_() for a in diff}
    val, aux = split(getattr(TLoss, name)(
        *[tdiff.get(a, torch.from_numpy(m[a])) for a in args], **kw))
    tgrads = torch.autograd.grad(val, [tdiff[a] for a in diff])

    assert np.isfinite(float(val.detach()))
    np.testing.assert_allclose(float(val), float(jval), rtol=1e-5)
    assert set(aux) == set(jaux)
    for key in aux:
        np.testing.assert_allclose(float(aux[key]), float(jaux[key]),
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    for a, g, jg in zip(diff, tgrads, jgrads):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-4,
                                   atol=1e-4 * np.abs(jg).max() + 1e-12,
                                   err_msg=a)


def test_all_negative_maps_take_the_safe_branches():
    """No positive pixel: the geometry and positive-pixel terms divide by
    zero weight and are 0, and the focal losses divide by max(n_pos, 1)."""
    m = {k: torch.from_numpy(v)
         for k, v in maps(np.random.RandomState(3), "negative").items()}
    _, aux = TLoss.east_loss(m["score"], m["probs"], m["geo_gt"], m["geo_p"],
                             m["mask"])
    assert float(aux["geo_loss"]) == 0.0
    _, aux = TLoss.east_quad_loss(m["score"], m["probs"], m["quad_gt"],
                                  m["quad_p"], m["mask"])
    assert float(aux["geo_loss"]) == 0.0
    _, aux = TLoss.positive_pixel_link_loss(m["score"], m["pixel_logits"],
                                            m["link"], m["link_logits"])
    assert float(aux["pixel_loss"]) == 0.0 and float(aux["link_loss"]) == 0.0
    fl = TLoss.focal_loss_binary(m["score"], m["probs"], m["mask"])
    p = m["probs"].clamp(1e-7, 1 - 1e-7)
    want = (-(0.75) * p ** 2 * torch.log(1 - p) * (m["mask"] > 0)).sum()
    torch.testing.assert_close(fl, want, rtol=1e-5, atol=0)
