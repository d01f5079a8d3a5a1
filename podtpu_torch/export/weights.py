"""Carry ``podtpu`` weights into the port, and back.

``podtpu/export/weights.py`` writes a flat ``.npz``: keys
``params::<module path>::<leaf>`` and ``batch_stats::<module path>::<leaf>``
(for example ``params::backbone::stage0::conv0::conv::kernel``). The port's
modules keep ``podtpu``'s module names, so a state_dict key maps onto a
flat key by its module path and its leaf:

==================================  ======================================
port (``state_dict``)               ``podtpu`` (flat ``.npz``)
==================================  ======================================
``<path>.conv.weight`` (OIHW)       ``params::<path>::conv::kernel`` (HWIO)
``<path>.bn.weight``                ``params::<path>::bn::scale``
``<path>.bn.bias``                  ``params::<path>::bn::bias``
``<path>.bn.running_mean``          ``batch_stats::<path>::bn::mean``
``<path>.bn.running_var``           ``batch_stats::<path>::bn::var``
``<path>.fc.weight`` [out, in]      ``params::<path>::fc::kernel`` [in, out]
``<path>.fc.bias``                  ``params::<path>::fc::bias``
``<conv>.weight`` (OIHW)            ``params::<conv>::kernel`` (HWIO)
``<conv>.bias``                     ``params::<conv>::bias``
==================================  ======================================

(``<path>.`` is empty for a module at the top, as YOLOv1's ``fc``.) The
table's rows match by name first; the last two match by module type: a
bare ``nn.Conv2d`` at ``<conv>`` (RetinaNet's FPN and subnet convs, a flax
``nn.Conv`` with a bias outside a ``ConvBnAct``), so they need the model's
conv paths (:func:`conv_paths`).

Any key the mapping does not cover raises. So does any key missing on
either side, unless ``allow_partial=True`` (cfg ``backbone_pretrained``,
``podtpu``'s ``load_npz_weights(allow_partial=True)``): then the model's
keys the file lacks keep their values, the file's keys with no place in the
model are ignored, and one line says how many were loaded. A shape mismatch
always raises.
"""

from __future__ import annotations

import numpy as np
import torch

from podtpu_torch.parallel.mesh import full_tree, gather_model, load_full_state

SEP = "::"

# port leaf -> (collection, podtpu leaf)
_LEAVES = {
    "conv.weight": ("params", "conv::kernel"),
    "bn.weight": ("params", "bn::scale"),
    "bn.bias": ("params", "bn::bias"),
    "bn.running_mean": ("batch_stats", "bn::mean"),
    "bn.running_var": ("batch_stats", "bn::var"),
    "fc.weight": ("params", "fc::kernel"),
    "fc.bias": ("params", "fc::bias"),
}


# the table's leaves stored in another layout by podtpu
_LAYOUTS = {"conv.weight": "conv", "fc.weight": "fc"}
# bare conv leaf -> podtpu leaf
_CONV_LEAVES = {"weight": "kernel", "bias": "bias"}


def conv_paths(model: torch.nn.Module) -> frozenset[str]:
    """The module paths of ``model``'s ``nn.Conv2d`` layers."""
    return frozenset(path for path, m in model.named_modules()
                     if isinstance(m, torch.nn.Conv2d))


def _leaf(name: str, convs: frozenset[str]) -> tuple[str, str | None]:
    """state_dict key -> (``podtpu`` flat key, its layout: ``conv`` for
    OIHW <-> HWIO, ``fc`` for a transposed matrix, or None)."""
    for leaf, (collection, jax_leaf) in _LEAVES.items():
        if name == leaf or name.endswith("." + leaf):
            path = name[:-len(leaf)].rstrip(".")
            parts = [collection, path.replace(".", SEP), jax_leaf]
            return SEP.join(p for p in parts if p), _LAYOUTS.get(leaf)
    path, _, leaf = name.rpartition(".")
    if path in convs and leaf in _CONV_LEAVES:
        key = SEP.join(["params", path.replace(".", SEP), _CONV_LEAVES[leaf]])
        return key, "conv" if leaf == "weight" else None
    raise KeyError(f"no podtpu counterpart for state_dict key '{name}'")


def flat_key(name: str, convs: frozenset[str] = frozenset()) -> str:
    """state_dict key -> ``podtpu`` flat key; ``convs``: the model's
    :func:`conv_paths`, for the keys of a bare conv."""
    return _leaf(name, convs)[0]


def _to_torch(layout: str | None, arr: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr, dtype=np.float32))  # a writable copy
    if layout == "conv":
        t = t.permute(3, 2, 0, 1)  # HWIO -> OIHW
    elif layout == "fc":
        t = t.t()  # [in, out] -> [out, in]
    return t.contiguous()


def _to_numpy(layout: str | None, t: torch.Tensor) -> np.ndarray:
    t = t.detach().float().cpu()
    if layout == "conv":
        t = t.permute(2, 3, 1, 0)  # OIHW -> HWIO
    elif layout == "fc":
        t = t.t()  # [out, in] -> [in, out]
    # a copy: a float32 CPU tensor's numpy() shares its memory, which the
    # next optimizer step or BN update would rewrite
    return np.array(t.numpy(), order="C", copy=True)


def state_dict_from_flat(model: torch.nn.Module,
                         flat: dict[str, np.ndarray],
                         allow_partial: bool = False
                         ) -> dict[str, torch.Tensor]:
    """``podtpu`` flat weights -> a state_dict for ``model``: complete, or
    with ``allow_partial`` the keys ``flat`` has."""
    own, convs = model.state_dict(), conv_paths(model)
    out, used, missing = {}, set(), []
    for name, ref in own.items():
        key, layout = _leaf(name, convs)
        if key not in flat:
            missing.append(key)
            continue
        t = _to_torch(layout, flat[key])
        if t.shape != ref.shape:
            raise ValueError(f"shape mismatch for {key}: podtpu "
                             f"{tuple(np.shape(flat[key]))} -> "
                             f"{tuple(t.shape)} vs port {tuple(ref.shape)}")
        out[name] = t
        used.add(key)
    if allow_partial:
        return out
    if missing:
        raise KeyError(f"{len(missing)} weight(s) missing, e.g. {missing[:3]}")
    extra = sorted(set(flat) - used)
    if extra:
        raise KeyError(f"{len(extra)} weight(s) with no place in the model, "
                       f"e.g. {extra[:3]}")
    return out


def flat_from_tensors(state_dict: dict[str, torch.Tensor],
                      convs: frozenset[str] = frozenset()
                      ) -> dict[str, np.ndarray]:
    """A port ``state_dict`` in ``podtpu``'s flat ``.npz`` layout;
    ``convs``: the model's :func:`conv_paths`, for the keys of a bare
    conv."""
    out = {}
    for name, t in state_dict.items():
        key, layout = _leaf(name, convs)
        out[key] = _to_numpy(layout, t)
    return out


def flat_from_state_dict(model: torch.nn.Module) -> dict[str, np.ndarray]:
    """The model's weights in ``podtpu``'s flat ``.npz`` layout (of a
    model sharded by FSDP or split by the tensor layout, gathered whole:
    every rank calls it)."""
    sd = full_tree(model.state_dict())
    for k in sorted(getattr(model, "tp_keys", ())):
        sd[k] = gather_model(sd[k])
    return flat_from_tensors(sd, conv_paths(model))


def load_flat_weights(model: torch.nn.Module, flat: dict[str, np.ndarray],
                      allow_partial: bool = False, source: str = "weights"
                      ) -> torch.nn.Module:
    """``flat`` into ``model``; with ``allow_partial`` the keys it has,
    printing ``podtpu``'s "partial load" line when some are missing."""
    sd = state_dict_from_flat(model, flat, allow_partial)
    # whole tensors, into a model sharded by FSDP or not
    load_full_state(model, sd, strict=not allow_partial)
    n_total = len(model.state_dict())
    if allow_partial and len(sd) < n_total:
        print(f"partial load: {len(sd)}/{n_total} leaves loaded from "
              f"{source}, {n_total - len(sd)} kept at init")
    return model


def load_npz_weights(target, path: str, allow_partial: bool = False):
    """Load a ``podtpu`` ``save_npz_weights`` file into ``target``: a
    model, or a train state, whose EMA shadow (where it has one) is then
    reseeded from the loaded weights. Returns ``target``."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    load_flat_weights(getattr(target, "model", target), flat, allow_partial,
                      source=path)
    if getattr(target, "ema", None) is not None:
        target.init_ema()
    return target
