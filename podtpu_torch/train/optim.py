"""Optimizers with the reference's parameter-group decay policy
(``podtpu/train/optim.py``).

* ``kernels`` (the v3 and v4-tiny recipes): weight decay on conv and linear
  weights only (``podtpu``'s ``kernel`` leaves); BN weights and biases get
  none;
* ``all`` (v1/v2): one group, decay on every parameter.

``optimizer_options.decay_policy`` picks; by default the model family
decides. ``optimizer``: ``sgd`` (``torch.optim.SGD``: coupled decay added
to the gradient before momentum, ``nesterov``), ``adam`` and ``radam``
(coupled decay, as ``podtpu`` chains ``add_decayed_weights`` before
them) and ``adamw`` (decoupled ``lr * wd * p`` under the same mask), the
updates ``podtpu``'s optax chains apply. ``optimizer_options.flat``
(SGD only, as in ``podtpu``) runs the update over one contiguous buffer
of parameters and one of gradients (:class:`FlatParams`).

The learning rate is set per update from the schedule by
:class:`podtpu_torch.train.state.TrainState`, which also applies the
wrappers of ``podtpu``'s chain: ``clip_grad_norm`` first
(:func:`clip_by_global_norm_`), ``accum_steps`` (``optax.MultiSteps``)
and ``skip_nonfinite`` (``optax.apply_if_finite``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from podtpu_torch.parallel.mesh import is_dtensor, local_tensors

OPTIMIZERS = ("sgd", "adam", "radam", "adamw")


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


def accum_steps(cfg: dict) -> int:
    """``optimizer_options.accum_steps`` (1 = no accumulation)."""
    return int(dict(cfg.get("optimizer_options", {})).get("accum_steps", 1)
               or 1)


def skip_nonfinite(cfg: dict) -> int:
    """``optimizer_options.skip_nonfinite``: how many consecutive
    non-finite updates are dropped (0 = no guard)."""
    return int(dict(cfg.get("optimizer_options", {}))
               .get("skip_nonfinite", 0) or 0)


@torch.no_grad()
def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float
                         ) -> torch.Tensor:
    """Clip ``grads`` in place as ``optax.clip_by_global_norm`` does:
    ``g`` where the global norm is below ``max_norm``, else
    ``(g / norm) * max_norm``, chosen on the device (no host sync).
    Returns the global norm before the clip.

    Not ``torch.nn.utils.clip_grad_norm_``: it scales by
    ``max / (norm + 1e-6)`` whether or not the norm is over, a different
    update.

    Under FSDP the gradients are DTensor shards: the squares of the
    shards' norms are summed over the ranks (the global norm to float32
    rounding), and each rank scales its shards."""
    sharded = any(is_dtensor(g) for g in grads)
    grads = local_tensors(grads)
    norms = torch.stack(torch._foreach_norm(grads))
    if sharded:
        sq = norms.square().sum()
        dist.all_reduce(sq)
        norm = sq.sqrt()
    else:
        norm = torch.linalg.vector_norm(norms)
    under = norm < max_norm
    # below the limit g / 1 * 1 leaves each gradient bit for bit
    torch._foreach_div_(grads, torch.where(under, 1.0, norm))
    torch._foreach_mul_(grads, torch.where(under, 1.0, max_norm))
    return norm


@torch.no_grad()
def all_finite(tensors: list[torch.Tensor]) -> torch.Tensor:
    """0-dim bool on the tensors' device: no NaN or inf in any of them
    (their max-abs norms, which cannot overflow)."""
    norms = torch._foreach_norm(tensors, float("inf"))
    return torch.isfinite(torch.stack(norms)).all()


def _is_kernel(module: nn.Module, name: str) -> bool:
    return name == "weight" and isinstance(module, (nn.Conv2d, nn.Linear))


def param_groups(cfg: dict, model: nn.Module) -> list[list[nn.Parameter]]:
    """The parameters by decay: ``[decayed, exempt]`` under ``kernels``,
    ``[all]`` under ``all``."""
    if decay_policy(cfg) == "all":
        return [list(model.parameters())]
    decayed, exempt = [], []
    for module in model.modules():
        for pname, p in module.named_parameters(recurse=False):
            (decayed if _is_kernel(module, pname) else exempt).append(p)
    return [decayed, exempt]


class FlatParams:
    """``optimizer_options.flat``: the parameters as views into one
    contiguous float32 buffer, group after group, and their gradients
    gathered into a second one before each update, so the optimizer steps
    one tensor a decay group. Every element goes through the same
    elementwise operations as on the per-tensor path, so the numbers are
    the same bit for bit."""

    def __init__(self, groups: list[list[nn.Parameter]]):
        params = [p for g in groups for p in g]
        n = sum(p.numel() for p in params)
        device = params[0].device
        self.param = torch.empty(n, dtype=torch.float32, device=device)
        self.grad = torch.zeros(n, dtype=torch.float32, device=device)
        self.params = params
        self.groups = []  # each decay group's slice of both buffers
        off = 0
        with torch.no_grad():
            for g in groups:
                start = off
                for p in g:
                    view = self.param[off:off + p.numel()]
                    view.copy_(p.detach().reshape(-1))
                    p.data = view.view_as(p)
                    off += p.numel()
                flat = self.param[start:off]
                flat.grad = self.grad[start:off]
                self.groups.append(flat)

    @torch.no_grad()
    def gather_grads(self):
        """Every parameter's ``.grad`` into the flat gradient buffer."""
        torch.cat([p.grad.reshape(-1) for p in self.params], out=self.grad)


def build_optimizer(cfg: dict, model: nn.Module) -> torch.optim.Optimizer:
    """Config -> the optimizer over ``model``'s parameters; its ``flat``
    attribute is the :class:`FlatParams` it steps under ``flat``, else
    None. Raises ``ValueError`` for an optimizer ``podtpu`` does not
    know."""
    opts = dict(cfg.get("optimizer_options", {}))
    name = cfg.get("optimizer", "sgd")
    if name not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer '{name}'")
    wd = float(opts.get("weight_decay", 0.0))
    lr = float(opts["lr"])  # set again before every update (TrainState)
    groups = param_groups(cfg, model)
    flat = None
    if name == "sgd" and bool(opts.get("flat", False)):
        if any(is_dtensor(p) for g in groups for p in g):
            raise ValueError("optimizer_options.flat views every parameter "
                             "in one buffer; FSDP shards them: use one or "
                             "the other")
        flat = FlatParams(groups)
        groups = [[t] for t in flat.groups]
    decays = [wd, 0.0][:len(groups)]
    pgroups = [{"params": g, "weight_decay": d}
               for g, d in zip(groups, decays)]
    if name == "sgd":
        momentum = float(opts.get("momentum", 0.0))
        nesterov = bool(opts.get("nesterov", False)) and momentum > 0.0
        opt = torch.optim.SGD(pgroups, lr=lr, momentum=momentum,
                              nesterov=nesterov)
    else:
        cls = {"adam": torch.optim.Adam, "radam": torch.optim.RAdam,
               "adamw": torch.optim.AdamW}[name]
        opt = cls(pgroups, lr=lr)
    opt.flat = flat
    return opt
