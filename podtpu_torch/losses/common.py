"""Shared loss math (``podtpu/losses/common.py``): masked sums, BCE on
logits, NaN-safe masked CIoU."""

from __future__ import annotations

import torch

from podtpu_torch.ops.boxes import bbox_iou, tie_abs, tie_max0


def smooth_bce(eps: float) -> tuple[float, float]:
    """Label-smoothing (positive, negative) targets."""
    return 1.0 - 0.5 * eps, 0.5 * eps


def bce_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy on raw logits, in the stable form.
    ``max`` and ``abs`` take ``jnp.maximum``'s and ``jnp.abs``'s
    subgradients at 0 (half to each side; +1), as ``podtpu``'s do."""
    return (tie_max0(logits) - logits * targets
            + torch.log1p(torch.exp(-tie_abs(logits))))


def masked_sum(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """sum(x * mask) with mask broadcast over trailing dims of x."""
    mask = mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim()))
    return (x * mask).sum()


def masked_ciou_loss(pbox: torch.Tensor, tbox: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """sum over masked positions of (1 - CIoU(pbox, tbox)).

    Boxes are [..., 4] cxcywh; mask is [...]. Unmasked positions become a
    unit box *before* the CIoU, so that the 0/0 terms (atan of 0-width
    targets) reach neither the value nor the gradient (the double-where
    trick)."""
    m = mask.bool()[..., None]
    # made on the device: a tensor from a host list would be a copy per call
    dummy = torch.full((4,), 0.5, dtype=pbox.dtype, device=pbox.device)
    dummy[2:] = 1.0
    pbox_safe = torch.where(m, pbox, dummy)
    tbox_safe = torch.where(m, tbox, dummy)
    ciou = bbox_iou(pbox_safe, tbox_safe, CIoU=True)[..., 0]
    return torch.where(mask.bool(), 1.0 - ciou, 0.0).sum()
