"""Train state (``podtpu/train/state.py``): the model (its parameters and
BN statistics), the optimizer with its momentum, the schedule, the counts
of train steps and of optimizer updates, the state of ``podtpu``'s optax
wrappers (``accum_steps``, ``skip_nonfinite``) and the EMA shadow."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from podtpu_torch.export.weights import load_flat_weights, load_npz_weights
from podtpu_torch.models.factory import build_model
from podtpu_torch.models.layers import ConvBnAct, HeadConv
from podtpu_torch.parallel.mesh import (
    apply_fsdp,
    broadcast_module,
    local_tensors,
)
from podtpu_torch.train.optim import (
    accum_steps,
    build_optimizer,
    clip_by_global_norm_,
    clip_grad_norm,
    skip_nonfinite,
)
from podtpu_torch.train.schedule import Schedule, build_schedule


def ema_options(cfg: dict) -> dict | None:
    """cfg ``ema`` -> ``{decay, tau, eval}`` (None = off). ``ema: true``
    takes YOLOv5 ModelEMA's defaults (decay 0.9999 ramped in as
    ``decay * (1 - exp(-updates / 2000))``); a number is the decay; a
    mapping overrides ``decay`` / ``tau`` / ``eval``. ``eval`` (default
    on): validation and ``best`` use the shadow."""
    e = cfg.get("ema")
    if not e:
        return None
    if isinstance(e, (int, float)) and not isinstance(e, bool):
        e = {"decay": float(e)}
    e = dict(e) if isinstance(e, dict) else {}
    return {
        "decay": float(e.get("decay", 0.9999)),
        "tau": float(e.get("tau", 2000.0)),
        "eval": bool(e.get("eval", True)),
    }


def shadow_of(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """A float32 copy of every floating entry of ``model``'s state_dict:
    the parameters and the BN running statistics."""
    return {k: v.detach().float().clone()
            for k, v in model.state_dict().items() if v.is_floating_point()}


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Schedule
    step: int = 0  # train steps done, rejected ones included (flax's step)
    clip_norm: float | None = None  # optimizer_options.clip_grad_norm
    accum: int = 1  # optimizer_options.accum_steps
    skip: int = 0  # optimizer_options.skip_nonfinite
    # optimizer updates applied: the schedule's count (optax's ``count``)
    count: int = 0
    mini_step: int = 0  # micro-steps accumulated towards the next update
    acc: list | None = None  # their running mean gradient
    notfinite_count: int = 0  # consecutive non-finite steps
    total_notfinite: int = 0
    ema: dict | None = None  # the shadow: state_dict key -> float32
    ema_opts: dict | None = None

    def params(self) -> list[torch.nn.Parameter]:
        """The model's parameters in the optimizer's group order."""
        flat = getattr(self.optimizer, "flat", None)
        if flat is not None:
            return flat.params
        return [p for group in self.optimizer.param_groups
                for p in group["params"]]

    def apply_gradients(self, finite: bool = True) -> bool:
        """One train step's update from the parameters' ``.grad``: the
        step count advances; returns whether the optimizer updated.

        As ``podtpu``'s optax chain, outermost first: with ``skip`` set a
        step whose gradients were not ``finite`` is dropped (nothing but
        the counts changes) until more than ``skip`` come in a row;
        ``accum`` > 1 keeps the running mean ``acc + (g - acc) / (n + 1)``
        and updates on every ``accum``-th accepted step; the update clips
        the mean by its global norm (``clip_norm``), sets the schedule's
        lr for update number ``count`` and steps the optimizer."""
        self.step += 1
        if self.skip:
            self.notfinite_count = 0 if finite else self.notfinite_count + 1
            self.total_notfinite += not finite
            if self.notfinite_count and self.notfinite_count <= self.skip:
                return False
        params = self.params()
        if self.accum > 1:
            grads = [p.grad for p in params]
            if self.mini_step == 0:
                self.acc = grads
            else:
                # on the local shards under FSDP (the same tensors else)
                acc = local_tensors(self.acc)
                diff = torch._foreach_sub(local_tensors(grads), acc)
                # a 0-dim divisor, made on the device: true division on
                # the card as on the CPU, and no host copy
                torch._foreach_div_(diff, torch.full(
                    (), float(self.mini_step + 1), device=acc[0].device))
                torch._foreach_add_(acc, diff)
            self.mini_step += 1
            if self.mini_step < self.accum:
                return False
            for p, a in zip(params, self.acc):
                p.grad = a
            self.mini_step, self.acc = 0, None
        if self.clip_norm:
            clip_by_global_norm_([p.grad for p in params], self.clip_norm)
        flat = getattr(self.optimizer, "flat", None)
        if flat is not None:
            flat.gather_grads()
        lr = self.schedule(self.count)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.count += 1
        return True

    def init_ema(self):
        """(Re)seed the EMA shadow from the model's current weights."""
        self.ema = shadow_of(self.model)

    @torch.no_grad()
    def update_ema(self):
        """Blend the shadow towards the model after step ``step``:
        ``e * d + p * (1 - d)`` with ``d = decay * (1 - exp(-(step // k) /
        tau))`` in float32, ``k`` = ``accum``; under accumulation only on
        the steps ``step % k == 0`` (``podtpu``'s train step)."""
        if self.ema is None:
            return
        k = self.accum
        if k > 1 and self.step % k:
            return
        f = np.float32
        n = f(self.step // k)
        d = f(self.ema_opts["decay"]) * (
            f(1.0) - np.exp(-n / f(self.ema_opts["tau"])))
        state = self.model.state_dict()
        keys = list(self.ema)
        # under FSDP the shadow of a parameter is sharded as it is: the
        # blend runs on the local shards
        shadow = local_tensors([self.ema[k] for k in keys])
        torch._foreach_mul_(shadow, float(d))
        torch._foreach_add_(shadow, local_tensors(
            [state[k].float() for k in keys]), alpha=float(f(1.0) - d))


def total_notfinite(state: TrainState) -> int | None:
    """The running count of non-finite steps, or None when the
    ``optimizer_options.skip_nonfinite`` guard is off."""
    return state.total_notfinite if state.skip else None


def create_train_state(cfg: dict, device: str | torch.device | None = None,
                       weights: dict[str, np.ndarray] | None = None,
                       fsdp_mesh=None) -> TrainState:
    """Build the model named in ``cfg`` in train mode on ``device`` (cuda by
    default) with its optimizer. ``weights``: ``podtpu``'s flat weights
    (``export/weights.py``) to start from instead of PyTorch's init. Then
    cfg ``backbone_pretrained`` (a ``podtpu`` ``.npz``, or '' for none) is
    loaded over them partially: the keys it has, the rest kept. With cfg
    ``ema`` the shadow starts from the weights after both loads.

    Under a process group every rank then takes rank 0's weights (as DDP
    does), and with ``fsdp_mesh`` the whole model is sharded over it
    (``parallel/mesh.py::apply_fsdp``) before the optimizer and the shadow
    are made from the shards."""
    model = build_model(cfg, device, train=True)
    if weights is not None:
        load_flat_weights(model, weights)
    pretrained = cfg.get("backbone_pretrained")
    if pretrained:
        load_npz_weights(model, pretrained, allow_partial=True)
    broadcast_module(model)
    if fsdp_mesh is not None:
        # each block (conv + BN + activation, the heads' 1x1 convs) is one
        # FSDP unit
        apply_fsdp(model, fsdp_mesh, (ConvBnAct, HeadConv))
    state = TrainState(model, build_optimizer(cfg, model),
                       build_schedule(cfg), clip_norm=clip_grad_norm(cfg),
                       accum=accum_steps(cfg), skip=skip_nonfinite(cfg),
                       ema_opts=ema_options(cfg))
    if state.ema_opts is not None:
        state.init_ema()
    return state


def param_count(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
