"""Learning-rate schedules, ``step -> lr`` (``podtpu/train/schedule.py``).

* ``yolo_lr`` — darknet burn-in ``lr * (step / burn_in)^4``, then decays at
  ``steps`` by cumulative ``scales``;
* ``multi_step`` — torch MultiStepLR;
* ``cosine_annealing_warm_restarts`` — torch CosineAnnealingWarmRestarts;
* ``cosine_annealing_warm_up_restarts`` — linear warm-up to ``eta_max``,
  cosine back to the base, cycle length x ``T_mult``, amplitude x ``gamma``;
* ``cosine_decay_schedule`` — optax's, ``lr * 0.5 * (1 + cos(pi * t / T))``
  held at 0 past T (backbone pretraining, ``cli/pretrain_darknet.py``).

The step is the count of optimizer updates done before the one the lr is
for (optax's ``count``): update k uses ``schedule(k)``, so ``yolo_lr``'s
first update has lr 0. Values are float32, as ``podtpu`` computes them.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np

Schedule = Callable[[int], float]
_F = np.float32


def yolo_lr(base_lr: float, burn_in: int, steps: Sequence[int],
            scales: Sequence[float]) -> Schedule:
    def schedule(step: int) -> float:
        s = _F(step)
        if s < _F(burn_in):
            r = s / _F(burn_in)
            r2 = r * r
            return float(_F(base_lr) * (r2 * r2))
        factor = _F(1.0)
        for at, scale in zip(steps, scales):
            if s >= _F(at):
                factor = factor * _F(scale)
        return float(_F(base_lr) * factor)

    return schedule


def multi_step(base_lr: float, milestones: Sequence[int],
               gamma: float = 0.1) -> Schedule:
    def schedule(step: int) -> float:
        n = sum(step >= m for m in milestones)
        return float(_F(base_lr * gamma ** n))

    return schedule


def cosine_annealing_warm_restarts(base_lr: float, T_0: int, T_mult: int = 1,
                                   eta_min: float = 0.0) -> Schedule:
    def schedule(step: int) -> float:
        if T_mult == 1:
            t_cur, t_i = step % T_0, T_0
        else:
            n = math.floor(math.log(step / T_0 * (T_mult - 1) + 1.0)
                           / math.log(T_mult))
            t_cur = step - T_0 * (T_mult ** n - 1.0) / (T_mult - 1)
            t_i = T_0 * T_mult ** n
        return float(_F(eta_min + (base_lr - eta_min)
                        * (1 + math.cos(math.pi * t_cur / t_i)) / 2))

    return schedule


def cosine_annealing_warm_up_restarts(
    base_lr: float, T_0: int, T_mult: int = 1, eta_max: float = 0.1,
    T_up: int = 0, gamma: float = 1.0, max_cycles: int = 40,
) -> Schedule:
    """Each new cycle has length ``(T_i - T_up) * T_mult + T_up``; past
    ``max_cycles`` cycles the last one repeats no more (it clamps)."""
    lengths, t_i = [], float(T_0)
    for _ in range(max_cycles):
        lengths.append(t_i)
        t_i = (t_i - T_up) * T_mult + T_up
    starts = [0.0]
    for ln in lengths[:-1]:
        starts.append(starts[-1] + ln)

    def schedule(step: int) -> float:
        cycle = min(max(sum(step >= s for s in starts) - 1, 0),
                    max_cycles - 1)
        t_cur, t_i = step - starts[cycle], lengths[cycle]
        eta = eta_max * gamma ** cycle
        if t_cur < T_up:
            return float(_F((eta - base_lr) * t_cur / max(T_up, 1) + base_lr))
        return float(_F(base_lr + (eta - base_lr) * (
            1 + math.cos(math.pi * (t_cur - T_up) / (t_i - T_up))) / 2))

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Schedule:
    """``optax.cosine_decay_schedule`` (exponent 1): ``init_value *
    ((1 - alpha) * 0.5 * (1 + cos(pi * min(t, T) / T)) + alpha)``, in
    float32 as optax computes it; the cosine of the float32 angle is
    rounded once from float64 (XLA's float32 cosine differs from it by one
    ulp on a few angles in a thousand)."""
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule needs positive "
                         f"decay_steps, got {decay_steps}")

    def schedule(step: int) -> float:
        count = _F(min(float(step), float(decay_steps)))
        cos = _F(math.cos(float(_F(np.pi) * count / _F(decay_steps))))
        decayed = _F(1.0 - alpha) * (_F(0.5) * (_F(1.0) + cos)) + _F(alpha)
        return float(_F(init_value) * decayed)

    return schedule


def constant(base_lr: float) -> Schedule:
    return lambda step: float(_F(base_lr))


def build_schedule(cfg: dict) -> Schedule:
    """Config -> schedule."""
    base_lr = float(cfg["optimizer_options"]["lr"])
    name = cfg.get("scheduler")
    opts = cfg.get("scheduler_options", {}) or {}
    if name is None:
        return constant(base_lr)
    if name == "yolo_lr":
        return yolo_lr(base_lr, opts["burn_in"], opts["steps"], opts["scales"])
    if name == "multi_step":
        return multi_step(base_lr, opts["milestones"], opts.get("gamma", 0.1))
    if name == "cosine_annealing_warm_restarts":
        return cosine_annealing_warm_restarts(
            base_lr, opts["T_0"], opts.get("T_mult", 1),
            opts.get("eta_min", 0.0))
    if name == "cosine_annealing_warm_up_restarts":
        return cosine_annealing_warm_up_restarts(
            base_lr, opts["T_0"], opts.get("T_mult", 1),
            opts.get("eta_max", 0.1), opts.get("T_up", 0),
            opts.get("gamma", 1.0), opts.get("max_cycles", 40))
    raise ValueError(f"unknown scheduler '{name}'")
