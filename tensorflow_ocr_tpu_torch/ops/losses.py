"""The losses of the train step.

Port of ``tensorflow_ocr_tpu/ops/losses.py``:

- :func:`ohem_pixel_link_loss` (:137-216): softmax CE in closed form,
  Online Hard Negative Mining with the k-th smallest negative score found
  by a 32-step value bisection (not ``torch.topk``: every negative tied
  at the threshold is selected, as JAX selects it), and the pixel and
  8-direction link terms with their aux scalars. ``compute_dtype`` runs
  the CE terms and selection weights in bfloat16 with float32 reductions;
  :func:`effective_loss_compute_dtype` (:45-60) resolves the config's
  value with the ``OCR_LOSS_BF16`` environment variable, once, where the
  train step's loss is made (``train/trainer.py`` ``make_loss_fn``);
- :func:`dice_loss` (:64), :func:`dice_pixel_link_loss` (:219) and
  :func:`positive_pixel_link_loss` (:236) of the VGG reference;
- :func:`focal_loss` (:269) over 2-class logits and
  :func:`focal_loss_binary` (:289) over sigmoid scores;
- :func:`east_loss` (:333, RBOX: dice score, IoU and angle terms) and
  :func:`east_quad_loss` (:303, QUAD: dice score and a smoothed L1 of the
  corner offsets).

Every one is capturable in a CUDA graph: no host sync and no
data-dependent shape; the divisions by data-dependent counts stay tensor
ops (``_safe_div``, ``clamp``).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch

EPS = 1e-5


def _argument_dtype(compute_dtype) -> str:
    """"bfloat16" where ``compute_dtype`` names bfloat16 (``"bfloat16"`` or
    ``torch.bfloat16``), else "float32" (``None`` and every other dtype);
    TypeError on a name that is no dtype, as ``jnp.dtype`` raises."""
    if compute_dtype is None:
        return "float32"
    named = compute_dtype
    if isinstance(compute_dtype, str):
        named = getattr(torch, compute_dtype, None)
    if not isinstance(named, torch.dtype):
        raise TypeError(f"not a dtype: {compute_dtype!r}")
    return "bfloat16" if named == torch.bfloat16 else "float32"


def effective_loss_compute_dtype(compute_dtype=None, loss_name: str = "ohem"
                                 ) -> str:
    """The CE-term dtype the OHEM loss computes in, "bfloat16" or
    "float32" (losses.py:45-60): float32 for every loss but ``"ohem"``;
    with ``OCR_LOSS_BF16`` set, bfloat16 for "1", "true" or "on" and
    float32 for any other value; unset, what ``compute_dtype`` names
    (:func:`_argument_dtype`).

    ``make_loss_fn`` calls it once and hands the result to
    :func:`ohem_pixel_link_loss`, which reads no environment: the eager
    and the captured steps of one loss function compute in one dtype, as
    JAX's jitted step keeps the dtype it was traced with."""
    if loss_name != "ohem":
        return "float32"
    env = os.environ.get("OCR_LOSS_BF16")
    if env is not None:
        return "bfloat16" if env in ("1", "true", "on") else "float32"
    return _argument_dtype(compute_dtype)


def _safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num / den, and 0 where den <= 0 (losses.py:40-42)."""
    return torch.where(den > 0, num / torch.clamp(den, min=1e-12),
                       torch.zeros_like(num))


def dice_loss(y_true: torch.Tensor, y_pred: torch.Tensor,
              training_mask: torch.Tensor) -> torch.Tensor:
    """1 - 2 sum(t p m) / (sum(t m) + sum(p m) + eps), over the whole
    batch (losses.py:64-70)."""
    inter = (y_true * y_pred * training_mask).sum()
    union = ((y_true * training_mask).sum() + (y_pred * training_mask).sum()
             + EPS)
    return 1.0 - 2.0 * inter / union


def softmax_ce_with_logits(logits: torch.Tensor, labels: torch.Tensor
                           ) -> torch.Tensor:
    """CE over a 2-class last axis: logsumexp minus the picked logit."""
    l0, l1 = logits[..., 0], logits[..., 1]
    m = torch.maximum(l0, l1)
    lse = m + torch.log(torch.exp(l0 - m) + torch.exp(l1 - m))
    return lse - torch.where(labels == 1, l1, l0)


def _kth_smallest_threshold(scores: torch.Tensor, mask: torch.Tensor,
                            k: torch.Tensor, iters: int = 32
                            ) -> torch.Tensor:
    """Per row of (B, N) scores: the bisection bound ``hi`` that keeps the
    k-th smallest masked score in (lo, hi] after ``iters`` halvings
    (losses.py:88-107), float32."""
    big = torch.full((), 3.4e38, dtype=torch.float32, device=scores.device)
    s = scores.float()
    lo = torch.where(mask, s, big).amin(1)
    hi = torch.where(mask, s, -big).amax(1)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        cnt = ((s <= mid[:, None]) & mask).sum(1, dtype=torch.int32)
        ge = cnt >= k
        lo, hi = torch.where(ge, lo, mid), torch.where(ge, mid, hi)
    return hi


def ohnm_mask(neg_scores: torch.Tensor, pos_mask: torch.Tensor,
              neg_mask: torch.Tensor, max_neg_pos_ratio: int = 3,
              bg_neg_budget: int = 0) -> torch.Tensor:
    """(B, N) float32 mask of the selected hard negatives
    (losses.py:110-134): per image, the n_neg negatives of smallest
    negative-class probability, ties at the threshold included, with
    n_neg = min(ratio * n_pos, available), or ``bg_neg_budget`` on an
    image without positives (0 selects none, the reference's rule)."""
    n_pos = pos_mask.sum(1, dtype=torch.int32)
    n_avail = neg_mask.sum(1, dtype=torch.int32)
    want = torch.where(n_pos > 0, n_pos * max_neg_pos_ratio,
                       torch.full_like(n_pos, bg_neg_budget))
    n_neg = torch.minimum(want, n_avail)
    kth = _kth_smallest_threshold(neg_scores, neg_mask, n_neg)
    selected = (neg_mask & (neg_scores.float() <= kth[:, None])
                & (n_neg > 0)[:, None])
    return selected.float()


def ohem_pixel_link_loss(pixel_labels: torch.Tensor,
                         pixel_logits: torch.Tensor,
                         link_labels: torch.Tensor,
                         link_logits: torch.Tensor,
                         training_mask: Optional[torch.Tensor] = None,
                         max_neg_pos_ratio: int = 3,
                         pixel_loss_weight: float = 2.0,
                         apply_training_mask: bool = True,
                         bg_neg_budget: int = 0,
                         compute_dtype=None
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """OHEM pixel + link loss (losses.py:137-216). Returns (total, aux).

    pixel_labels (B,h,w[,1]); pixel_logits (B,h,w,2); link_labels
    (B,h,w,8); link_logits (B,h,w,16) in (direction, class) pairs;
    training_mask (B,h,w[,1]). aux: pixel_loss, link_loss, n_pos and
    link_loss/dir0..7.

    The CE terms and the selection weights compute in bfloat16 where
    ``compute_dtype`` names it, else in float32 (the default); the OHNM
    bisection and every final reduction in float32. The caller resolves
    ``OCR_LOSS_BF16`` (:func:`effective_loss_compute_dtype`, which JAX
    calls here at :158).
    """
    cdt = getattr(torch, _argument_dtype(compute_dtype))
    b = pixel_logits.shape[0]
    labels = pixel_labels.reshape(b, -1).to(torch.int32)
    logits = pixel_logits.reshape(b, -1, 2).to(cdt)
    if training_mask is None or not apply_training_mask:
        valid = torch.ones_like(labels, dtype=torch.bool)
    else:
        valid = training_mask.reshape(b, -1) > 0

    neg_scores = torch.softmax(logits, -1)[..., 0]
    pos_mask = (labels == 1) & valid
    neg_mask = (labels == 0) & valid
    selected = ohnm_mask(neg_scores, pos_mask, neg_mask, max_neg_pos_ratio,
                         bg_neg_budget)
    w_pixel = pos_mask.to(cdt) + selected.to(cdt)                 # (B, N)

    n_pos = pos_mask.float().sum()
    has_pos = pos_mask.float().sum(1) > 0
    n_bg = torch.where(has_pos[:, None], torch.zeros_like(selected),
                       selected).sum()
    ce = softmax_ce_with_logits(logits, labels)
    pixel_loss = _safe_div((ce * w_pixel).float().sum(), n_pos + n_bg)

    link_lbl = link_labels.reshape(b, -1, 8).to(torch.int32)
    link_lgt = link_logits.reshape(b, -1, 8, 2).to(cdt)
    link_ce = softmax_ce_with_logits(link_lgt, link_lbl)          # (B,N,8)
    wp = w_pixel[..., None]
    w_pos = (link_lbl == 1).to(cdt) * wp
    w_neg = (link_lbl == 0).to(cdt) * wp
    link_pos = _safe_div((link_ce * w_pos).float().sum((0, 1)),
                         w_pos.float().sum((0, 1)))
    link_neg = _safe_div((link_ce * w_neg).float().sum((0, 1)),
                         w_neg.float().sum((0, 1)))
    per_dir = link_pos + link_neg                                 # (8,)
    link_loss = per_dir.sum()
    total = link_loss + pixel_loss_weight * pixel_loss
    aux = {"pixel_loss": pixel_loss, "link_loss": link_loss, "n_pos": n_pos}
    for d in range(8):
        aux[f"link_loss/dir{d}"] = per_dir[d]
    return total, aux


def dice_pixel_link_loss(pixel_labels: torch.Tensor,
                         pixel_probs: torch.Tensor,
                         link_labels: torch.Tensor,
                         link_probs: torch.Tensor,
                         training_mask: torch.Tensor
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Dice on the score, twice, plus one dice per link direction
    (losses.py:219-233). pixel_* (B,h,w,1) probabilities; link_* (B,h,w,8);
    training_mask (B,h,w,1). Returns (total, aux)."""
    cls = dice_loss(pixel_labels, pixel_probs, training_mask) * 2.0
    link = torch.stack([
        dice_loss(link_labels[..., i:i + 1], link_probs[..., i:i + 1],
                  training_mask) for i in range(8)]).sum()
    return link + cls, {"pixel_loss": cls, "link_loss": link}


def positive_pixel_link_loss(pixel_labels: torch.Tensor,
                             pixel_logits: torch.Tensor,
                             link_labels: torch.Tensor,
                             link_logits: torch.Tensor,
                             pixel_loss_weight: float = 2.0
                             ) -> Tuple[torch.Tensor,
                                        Dict[str, torch.Tensor]]:
    """Pixel CE on the positives only, and per-direction link CE on the
    positive and negative links, both weighted by the pixel positives
    (losses.py:236-266). Returns (total, aux)."""
    labels = pixel_labels.reshape(-1).to(torch.int32)
    w_pixel = (labels == 1).float()
    ce = softmax_ce_with_logits(pixel_logits.reshape(-1, 2), labels)
    pixel_loss = _safe_div((ce * w_pixel).sum(), w_pixel.sum())

    link_lbl = link_labels.reshape(-1, 8).to(torch.int32)
    link_ce = softmax_ce_with_logits(link_logits.reshape(-1, 8, 2),
                                     link_lbl)
    wp = w_pixel[:, None]
    w_pos = (link_lbl == 1).float() * wp
    w_neg = (link_lbl == 0).float() * wp
    link_loss = (_safe_div((link_ce * w_pos).sum(0), w_pos.sum(0))
                 + _safe_div((link_ce * w_neg).sum(0), w_neg.sum(0))).sum()
    return pixel_loss * pixel_loss_weight + link_loss, {
        "pixel_loss": pixel_loss, "link_loss": link_loss}


def focal_loss(labels: torch.Tensor, logits: torch.Tensor,
               training_mask: Optional[torch.Tensor] = None,
               alpha: float = 0.25, gamma: float = 2.0) -> torch.Tensor:
    """Focal loss over 2-class pixel logits, normalised by the positive
    count (at least 1) (losses.py:269-286). labels (B,h,w,1); logits
    (B,h,w,2)."""
    lbl = labels.reshape(labels.shape[0], -1).to(torch.int32)
    logpt = -softmax_ce_with_logits(logits.reshape(logits.shape[0], -1, 2),
                                    lbl)
    pt = torch.exp(logpt)
    at = torch.where(lbl == 1, alpha, 1.0 - alpha)
    fl = -at * (1.0 - pt) ** gamma * logpt
    if training_mask is not None:
        fl = fl * (training_mask.reshape(training_mask.shape[0], -1) > 0)
    n_pos = torch.clamp((lbl == 1).float().sum(), min=1.0)
    return fl.sum() / n_pos


def focal_loss_binary(labels: torch.Tensor, probs: torch.Tensor,
                      training_mask: Optional[torch.Tensor] = None,
                      alpha: float = 0.25, gamma: float = 2.0
                      ) -> torch.Tensor:
    """Binary focal loss on sigmoid probabilities, p clipped to
    [1e-7, 1 - 1e-7] (losses.py:289-300). labels, probs (B,h,w,1)."""
    p = torch.clamp(probs, 1e-7, 1.0 - 1e-7)
    pos = labels == 1
    pt = torch.where(pos, p, 1.0 - p)
    at = torch.where(pos, alpha, 1.0 - alpha)
    fl = -at * (1.0 - pt) ** gamma * torch.log(pt)
    if training_mask is not None:
        fl = fl * (training_mask > 0)
    n_pos = torch.clamp(pos.float().sum(), min=1.0)
    return fl.sum() / n_pos


def east_quad_loss(y_true_cls: torch.Tensor, y_pred_cls: torch.Tensor,
                   y_true_geo: torch.Tensor, y_pred_geo: torch.Tensor,
                   training_mask: torch.Tensor, cls_weight: float = 1.0
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """EAST QUAD: dice on the score plus the smoothed L1 of the 8 corner
    offsets over 8 N_Q (the short edge, at least 1), averaged over the
    positive pixels (losses.py:303-330). y_true_geo (B,h,w,9): offsets and
    N_Q; y_pred_geo (B,h,w,8). Returns (total, aux)."""
    cls_loss = dice_loss(y_true_cls, y_pred_cls, training_mask) * cls_weight
    nq = torch.clamp(y_true_geo[..., 8:9], min=1.0)
    ad = ((y_pred_geo - y_true_geo[..., :8]) / (8.0 * nq)).abs()
    smooth = torch.where(ad < 1.0, 0.5 * ad * ad, ad - 0.5)
    w = y_true_cls * training_mask
    geo_loss = _safe_div((smooth.sum(-1, keepdim=True) * w).sum(), w.sum())
    return geo_loss + cls_loss, {"cls_loss": cls_loss, "geo_loss": geo_loss}


def east_loss(y_true_cls: torch.Tensor, y_pred_cls: torch.Tensor,
              y_true_geo: torch.Tensor, y_pred_geo: torch.Tensor,
              training_mask: torch.Tensor, angle_weight: float = 20.0,
              cls_weight: float = 1.0
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """EAST RBOX: dice on the score, -log IoU of the edge distances
    (top, right, bottom, left) and angle_weight (1 - cos) of the angle,
    averaged over the positive pixels (losses.py:333-367). geo (B,h,w,5).
    Returns (total, aux)."""
    cls_loss = dice_loss(y_true_cls, y_pred_cls, training_mask) * cls_weight
    d1_gt, d2_gt, d3_gt, d4_gt, theta_gt = torch.split(y_true_geo, 1, -1)
    d1_p, d2_p, d3_p, d4_p, theta_p = torch.split(y_pred_geo, 1, -1)
    area_gt = (d1_gt + d3_gt) * (d2_gt + d4_gt)
    area_p = (d1_p + d3_p) * (d2_p + d4_p)
    w_union = torch.minimum(d2_gt, d2_p) + torch.minimum(d4_gt, d4_p)
    h_union = torch.minimum(d1_gt, d1_p) + torch.minimum(d3_gt, d3_p)
    area_intersect = w_union * h_union
    area_union = area_gt + area_p - area_intersect
    aabb = -torch.log((area_intersect + 1.0) / (area_union + 1.0))
    theta = 1.0 - torch.cos(theta_p - theta_gt)
    geo = aabb + angle_weight * theta
    w = y_true_cls * training_mask
    geo_loss = _safe_div((geo * w).sum(), w.sum())
    return geo_loss + cls_loss, {"cls_loss": cls_loss, "geo_loss": geo_loss}
