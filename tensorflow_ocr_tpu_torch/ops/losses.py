"""The OHEM PixelLink loss of the train step.

Port of ``tensorflow_ocr_tpu/ops/losses.py:40-216``: softmax CE in closed
form, Online Hard Negative Mining with the k-th smallest negative score
found by a 32-step value bisection (not ``torch.topk``: every negative
tied at the threshold is selected, as JAX selects it), and the pixel and
8-direction link terms with their aux scalars. ``compute_dtype`` runs the
CE terms and selection weights in bfloat16 with float32 reductions.

The other losses of the JAX package (dice, positive, focal, EAST) are not
ported: :func:`check_loss_ported` raises for them.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

NOT_PORTED = ("dice", "positive", "focal", "east")


def _safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num / den, and 0 where den <= 0 (losses.py:40-42)."""
    return torch.where(den > 0, num / torch.clamp(den, min=1e-12),
                       torch.zeros_like(num))


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
                         compute_dtype: str = "float32"
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """OHEM pixel + link loss (losses.py:137-216). Returns (total, aux).

    pixel_labels (B,h,w[,1]); pixel_logits (B,h,w,2); link_labels
    (B,h,w,8); link_logits (B,h,w,16) in (direction, class) pairs;
    training_mask (B,h,w[,1]). aux: pixel_loss, link_loss, n_pos and
    link_loss/dir0..7.
    """
    cdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[
        compute_dtype]
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


def check_loss_ported(name: str) -> None:
    """Raise for a loss of the JAX package that the port lacks."""
    if name == "ohem":
        return
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"loss {name!r} is not ported yet (ROADMAP.md Queue 1: losses)")
    raise ValueError(f"unknown loss {name!r}")
