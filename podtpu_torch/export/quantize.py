"""Post-training int8 quantization for serving (``podtpu/export/quantize.py``).

Static symmetric PTQ, as ``podtpu`` does it:

* **weights**: per output channel, ``w_scale[o] = absmax(kernel[o]) / 127``
  and ``w_int8 = clip(round(kernel / w_scale), -127, 127)``;
* **activations**: per tensor, from the abs-max each ``ConvBnAct``'s input
  reaches over calibration batches run through the float model in eval
  mode (``podtpu`` sows it into ``quant_stats`` and max-merges);
* the int32 accumulator dequantizes by ``x_scale * w_scale`` straight into
  the float32 BN affine, so BN and the activation stay full precision;
* prediction heads (``HeadConv``) stay float.

The quant state is keyed by ``podtpu``'s slash-joined module paths
(``backbone/stage0/conv0``), which ``skip(path)`` sees. A block holds it
as buffers (``ConvBnAct.set_quant``) only while it is installed:
:func:`apply_quant` for an export, :func:`quant_scope` for the span of an
eval call (``train/steps.py::make_eval_step(extra_variables=...)``).

    stats = calibrate(model, batches)
    quant = build_quant_variables(model, stats)        # {"quant": {...}}
    with quant_scope(model, quant["quant"]): ...
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, Iterable

import numpy as np
import torch

from podtpu_torch.models.layers import ConvBnAct


def _blocks(model: torch.nn.Module):
    """(slash-joined path, block) of each ``ConvBnAct``."""
    for name, m in model.named_modules():
        if isinstance(m, ConvBnAct):
            yield name.replace(".", "/"), m


@torch.no_grad()
def calibrate(model: torch.nn.Module, batches: Iterable) -> dict:
    """Run calibration batches (NHWC float images in [0, 1], the serving
    input) through the model in eval mode; returns ``{"quant_stats":
    {path: float32 abs-max of the block's input}}``, max-merged over the
    batches on the host. The model's train/eval mode is left as it was."""
    seen: dict[str, torch.Tensor] = {}
    hooks = []
    for path, block in _blocks(model):
        def record(_, args, path=path):
            a = args[0].detach().abs().amax().float()
            seen[path] = torch.maximum(seen[path], a) if path in seen else a
        hooks.append(block.register_forward_pre_hook(record))
    dev = next(model.parameters()).device
    was_training = model.training
    merged = None
    try:
        model.eval()
        for x in batches:
            seen.clear()
            model(torch.as_tensor(np.asarray(x)).to(dev))
            stats = {p: np.float32(t.cpu()) for p, t in seen.items()}
            merged = stats if merged is None else {
                p: np.maximum(merged[p], v) for p, v in stats.items()}
    finally:
        for h in hooks:
            h.remove()
        model.train(was_training)
    if merged is None:
        raise ValueError("calibrate() needs at least one batch")
    return {"quant_stats": merged}


def build_quant_variables(model: torch.nn.Module, stats: dict,
                          skip: Callable[[str], bool] | None = None) -> dict:
    """``{"quant": {path: {"w_int8", "w_scale", "x_scale"}}}`` (CPU
    tensors; ``w_int8`` OIHW) for every ``ConvBnAct`` with calibration
    data that ``skip(path)`` does not exclude (e.g. to keep the stem
    float). The arithmetic is ``podtpu``'s numpy, so the int8 kernel and
    both scales are its bits."""
    qstats = stats["quant_stats"]
    quant = {}
    for path, block in _blocks(model):
        if path not in qstats or (skip and skip(path)):
            continue
        kernel = block.conv.weight.detach().float().cpu().numpy()  # OIHW
        w_absmax = np.max(np.abs(kernel), axis=(1, 2, 3))
        w_scale = np.where(w_absmax > 0, w_absmax / 127.0, 1.0).astype(
            np.float32)
        w_int8 = np.clip(np.round(kernel / w_scale[:, None, None, None]),
                         -127, 127).astype(np.int8)
        x_absmax = float(np.asarray(qstats[path]))
        x_scale = np.float32(x_absmax / 127.0 if x_absmax > 0 else 1.0)
        quant[path] = {"w_int8": torch.from_numpy(w_int8),
                       "w_scale": torch.from_numpy(w_scale),
                       "x_scale": torch.tensor(x_scale)}
    if not quant:
        raise ValueError("no quantizable ConvBnAct blocks found")
    return {"quant": quant}


def apply_quant(model: torch.nn.Module, quant: dict) -> torch.nn.Module:
    """Install ``quant`` (the inner dict of :func:`build_quant_variables`)
    into the model's blocks; every path must name a block."""
    blocks = dict(_blocks(model))
    missing = sorted(set(quant) - set(blocks))
    if missing:
        raise KeyError(f"quant state for blocks the model lacks: "
                       f"{missing[:3]}")
    for path, q in quant.items():
        blocks[path].set_quant(q["w_int8"], q["w_scale"], q["x_scale"])
    return model


def clear_quant(model: torch.nn.Module) -> torch.nn.Module:
    for _, block in _blocks(model):
        block.clear_quant()
    return model


@contextmanager
def quant_scope(model: torch.nn.Module, quant: dict | None):
    """``quant`` installed for the span of the block, then removed (None:
    nothing happens)."""
    if not quant:
        yield model
        return
    apply_quant(model, quant)
    try:
        yield model
    finally:
        clear_quant(model)


def quantize_for_serving(model: torch.nn.Module, batches,
                         skip: Callable[[str], bool] | None = None) -> dict:
    """One-call PTQ: calibrate, build, install into ``model``; returns the
    ``{"quant": ...}`` variables."""
    qvars = build_quant_variables(model, calibrate(model, batches), skip)
    apply_quant(model, qvars["quant"])
    return qvars
