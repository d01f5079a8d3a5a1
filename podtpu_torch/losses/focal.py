"""Focal loss (``podtpu/losses/focal.py``): alpha/gamma focal BCE on
probabilities, in the stable logits form, with a sum, mean or no
reduction."""

from __future__ import annotations

import torch

from podtpu_torch.losses.common import bce_logits


def focal_loss(logits: torch.Tensor, targets: torch.Tensor,
               alpha: float = 0.25, gamma: float = 2.0,
               reduction: str = "sum") -> torch.Tensor:
    p = torch.sigmoid(logits)
    ce = bce_logits(logits, targets)
    p_t = p * targets + (1.0 - p) * (1.0 - targets)
    alpha_t = alpha * targets + (1.0 - alpha) * (1.0 - targets)
    loss = alpha_t * (1.0 - p_t) ** gamma * ce
    if reduction == "sum":
        return loss.sum()
    if reduction == "mean":
        return loss.mean()
    return loss
