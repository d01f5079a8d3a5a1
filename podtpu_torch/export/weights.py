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
==================================  ======================================

(``<path>.`` is empty for a module at the top, as YOLOv1's ``fc``.)

Any key the mapping does not cover, and any key missing on either side,
raises.
"""

from __future__ import annotations

import numpy as np
import torch

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


def flat_key(name: str) -> str:
    """state_dict key -> ``podtpu`` flat key."""
    for leaf, (collection, jax_leaf) in _LEAVES.items():
        if name == leaf or name.endswith("." + leaf):
            path = name[:-len(leaf)].rstrip(".")
            parts = [collection, path.replace(".", SEP), jax_leaf]
            return SEP.join(p for p in parts if p)
    raise KeyError(f"no podtpu counterpart for state_dict key '{name}'")


def _to_torch(name: str, arr: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr, dtype=np.float32))  # a writable copy
    if name.endswith("conv.weight"):
        t = t.permute(3, 2, 0, 1)  # HWIO -> OIHW
    elif name.endswith("fc.weight"):
        t = t.t()  # [in, out] -> [out, in]
    return t.contiguous()


def _to_numpy(name: str, t: torch.Tensor) -> np.ndarray:
    t = t.detach().float().cpu()
    if name.endswith("conv.weight"):
        t = t.permute(2, 3, 1, 0)  # OIHW -> HWIO
    elif name.endswith("fc.weight"):
        t = t.t()  # [out, in] -> [in, out]
    # a copy: a float32 CPU tensor's numpy() shares its memory, which the
    # next optimizer step or BN update would rewrite
    return np.array(t.numpy(), order="C", copy=True)


def state_dict_from_flat(model: torch.nn.Module,
                         flat: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """``podtpu`` flat weights -> a complete state_dict for ``model``."""
    own = model.state_dict()
    out, used, missing = {}, set(), []
    for name, ref in own.items():
        key = flat_key(name)
        if key not in flat:
            missing.append(key)
            continue
        t = _to_torch(name, flat[key])
        if t.shape != ref.shape:
            raise ValueError(f"shape mismatch for {key}: podtpu "
                             f"{tuple(np.shape(flat[key]))} -> "
                             f"{tuple(t.shape)} vs port {tuple(ref.shape)}")
        out[name] = t
        used.add(key)
    if missing:
        raise KeyError(f"{len(missing)} weight(s) missing, e.g. {missing[:3]}")
    extra = sorted(set(flat) - used)
    if extra:
        raise KeyError(f"{len(extra)} weight(s) with no place in the model, "
                       f"e.g. {extra[:3]}")
    return out


def flat_from_state_dict(model: torch.nn.Module) -> dict[str, np.ndarray]:
    """The model's weights in ``podtpu``'s flat ``.npz`` layout."""
    return {flat_key(name): _to_numpy(name, t)
            for name, t in model.state_dict().items()}


def load_flat_weights(model: torch.nn.Module,
                      flat: dict[str, np.ndarray]) -> torch.nn.Module:
    model.load_state_dict(state_dict_from_flat(model, flat), strict=True)
    return model


def load_npz_weights(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """Load a ``podtpu`` ``save_npz_weights`` file into ``model``."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    return load_flat_weights(model, flat)
