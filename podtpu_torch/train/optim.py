"""SGD with the reference's parameter-group decay policy
(``podtpu/train/optim.py``).

* ``kernels`` (the v3 and v4-tiny recipes): coupled weight decay on conv
  and linear weights only (``podtpu``'s ``kernel`` leaves); BN weights and
  biases get none;
* ``all`` (v1/v2): one group, decay on every parameter.

``optimizer_options.decay_policy`` picks; by default the model family
decides. ``torch.optim.SGD`` (coupled decay added to the gradient before
momentum, ``nesterov``) is the update ``podtpu``'s optax chain applies
(``tests/test_optim_parity.py``). The learning rate is set per update from
the schedule by :class:`podtpu_torch.train.state.TrainState`, which also
clips the raw gradients by their global norm first where
``optimizer_options.clip_grad_norm`` is set (:func:`clip_by_global_norm_`,
``optax.clip_by_global_norm`` at the head of ``podtpu``'s chain).
"""

from __future__ import annotations

import torch
from torch import nn

# optimizer_options that podtpu reads and the port does not apply yet
_UNPORTED_OPTIONS = ("flat", "accum_steps", "skip_nonfinite")


def decay_policy(cfg: dict) -> str:
    """``kernels`` or ``all``: explicit ``optimizer_options.decay_policy``
    wins, else the model family's reference detector decides."""
    policy = dict(cfg.get("optimizer_options", {})).get("decay_policy")
    if policy is None:
        policy = "all" if cfg.get("model") in ("yolov1", "yolov2") else "kernels"
    if policy not in ("kernels", "all"):
        raise ValueError(f"unknown decay_policy '{policy}' "
                         "(expected kernels | all)")
    return policy


def clip_grad_norm(cfg: dict) -> float | None:
    """``optimizer_options.clip_grad_norm`` (None or 0: no clipping)."""
    value = dict(cfg.get("optimizer_options", {})).get("clip_grad_norm")
    return float(value) if value else None


@torch.no_grad()
def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float
                         ) -> torch.Tensor:
    """Clip ``grads`` in place as ``optax.clip_by_global_norm`` does:
    ``g`` where the global norm is below ``max_norm``, else
    ``(g / norm) * max_norm``, chosen on the device (no host sync).
    Returns the global norm before the clip.

    Not ``torch.nn.utils.clip_grad_norm_``: it scales by
    ``max / (norm + 1e-6)`` whether or not the norm is over, a different
    update."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    under = norm < max_norm
    # below the limit g / 1 * 1 leaves each gradient bit for bit
    torch._foreach_div_(grads, torch.where(under, 1.0, norm))
    torch._foreach_mul_(grads, torch.where(under, 1.0, max_norm))
    return norm


def _is_kernel(module: nn.Module, name: str) -> bool:
    return name == "weight" and isinstance(module, (nn.Conv2d, nn.Linear))


def build_optimizer(cfg: dict, model: nn.Module) -> torch.optim.Optimizer:
    """Config -> ``torch.optim.SGD`` over ``model``'s parameters."""
    opts = dict(cfg.get("optimizer_options", {}))
    name = cfg.get("optimizer", "sgd")
    if name != "sgd":
        raise NotImplementedError(f"optimizer '{name}' is not ported yet "
                                  "(ROADMAP.md queue 1, train-step options)")
    unported = [k for k in _UNPORTED_OPTIONS
                if opts.get(k) and not (k == "accum_steps" and opts[k] == 1)]
    if unported:
        raise NotImplementedError(f"optimizer_options {unported} are not "
                                  "ported yet (ROADMAP.md queue 1, "
                                  "train-step options)")
    wd = float(opts.get("weight_decay", 0.0))
    momentum = float(opts.get("momentum", 0.0))
    nesterov = bool(opts.get("nesterov", False)) and momentum > 0.0
    if decay_policy(cfg) == "all":
        groups = [{"params": list(model.parameters()), "weight_decay": wd}]
    else:
        decayed, exempt = [], []
        for module in model.modules():
            for pname, p in module.named_parameters(recurse=False):
                (decayed if _is_kernel(module, pname) else exempt).append(p)
        groups = [{"params": decayed, "weight_decay": wd},
                  {"params": exempt, "weight_decay": 0.0}]
    # lr is set before every update (TrainState.apply_gradients)
    return torch.optim.SGD(groups, lr=float(opts["lr"]), momentum=momentum,
                           nesterov=nesterov)
