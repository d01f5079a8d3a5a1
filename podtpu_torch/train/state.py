"""Train state (``podtpu/train/state.py``): the model (its parameters and
BN statistics), the optimizer with its momentum, the schedule and the count
of updates done."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from podtpu_torch.export.weights import load_flat_weights, load_npz_weights
from podtpu_torch.models.factory import build_model
from podtpu_torch.train.optim import (
    build_optimizer,
    clip_by_global_norm_,
    clip_grad_norm,
)
from podtpu_torch.train.schedule import Schedule, build_schedule


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Schedule
    step: int = 0
    clip_norm: float | None = None  # optimizer_options.clip_grad_norm

    def apply_gradients(self):
        """One optimizer update from the parameters' ``.grad``, at the
        schedule's lr for this update (``schedule(step)``); with
        ``clip_norm`` set, the raw gradients are first clipped by their
        global norm (every parameter's, BN's included, before the coupled
        weight decay), as ``podtpu``'s chain puts the clip first."""
        if self.clip_norm:
            grads = [p.grad for group in self.optimizer.param_groups
                     for p in group["params"] if p.grad is not None]
            clip_by_global_norm_(grads, self.clip_norm)
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1


def create_train_state(cfg: dict, device: str | torch.device | None = None,
                       weights: dict[str, np.ndarray] | None = None
                       ) -> TrainState:
    """Build the model named in ``cfg`` in train mode on ``device`` (cuda by
    default) with its optimizer. ``weights``: ``podtpu``'s flat weights
    (``export/weights.py``) to start from instead of PyTorch's init. Then
    cfg ``backbone_pretrained`` (a ``podtpu`` ``.npz``, or '' for none) is
    loaded over them partially: the keys it has, the rest kept."""
    if cfg.get("ema"):
        raise NotImplementedError("ema is not ported yet (ROADMAP.md queue "
                                  "1, train-step options)")
    model = build_model(cfg, device, train=True)
    if weights is not None:
        load_flat_weights(model, weights)
    pretrained = cfg.get("backbone_pretrained")
    if pretrained:
        load_npz_weights(model, pretrained, allow_partial=True)
    return TrainState(model, build_optimizer(cfg, model), build_schedule(cfg),
                      clip_norm=clip_grad_norm(cfg))


def param_count(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
