"""NPU-toolchain conditioning of exported programs (``podtpu/export/npu.py``;
the reference's onnx2novaonnx_converter.py role).

* :func:`validate_for_npu` — the artifact's ATen operator set against a
  whitelist of what a conv-centric NPU compiler ingests; operators off
  the list raise :class:`NPUValidationError`. The whitelist mirrors
  ``podtpu``'s ``DEFAULT_NPU_WHITELIST`` op for op (each StableHLO op
  beside the ATen operators that lower to it): the sort, top-k, gather
  and loop machinery of the NMS tail, and the port's suppression
  operator, are not on it, so a serving graph fails and a forward graph
  passes, as in ``podtpu``.
* :func:`annotate_for_npu` — the graph's convolution, dense and pool
  nodes in order, each with a ``layer_idx`` and a sanitized name; a pool
  carries ``pool_at_pad`` when it pads.
* :func:`fold_batchnorm` — BN folded into the preceding conv kernels of a
  ``state_dict`` with ``podtpu``'s formula; eval outputs are unchanged.
"""

from __future__ import annotations

import json
import re
from typing import Iterable

import numpy as np

# podtpu's StableHLO whitelist, each op with the ATen operators (by
# schema name, overload dropped) that compute it
_WHITELIST_BY_HLO = {
    "stablehlo.add": ("aten.add",),
    "stablehlo.subtract": ("aten.sub", "aten.rsub"),
    "stablehlo.multiply": ("aten.mul",),
    "stablehlo.divide": ("aten.div",),
    # relu is maximum(x, 0)
    "stablehlo.maximum": ("aten.maximum", "aten.relu", "aten.clamp_min"),
    "stablehlo.minimum": ("aten.minimum", "aten.clamp_max"),
    "stablehlo.convolution": ("aten.conv2d", "aten.convolution",
                              "aten._convolution"),
    # the int8 route's product on the card is a dot_general too
    "stablehlo.dot_general": ("aten.linear", "aten.mm", "aten.addmm",
                              "aten.matmul", "aten.bmm", "aten._int_mm"),
    "stablehlo.reduce_window": ("aten.max_pool2d",
                                "aten.max_pool2d_with_indices",
                                "aten.avg_pool2d"),
    "stablehlo.reduce": ("aten.sum", "aten.mean", "aten.amax", "aten.amin"),
    "stablehlo.reshape": ("aten.view", "aten.reshape", "aten._unsafe_view",
                          "aten.flatten", "aten.unsqueeze", "aten.squeeze"),
    "stablehlo.transpose": ("aten.permute", "aten.transpose", "aten.t"),
    "stablehlo.concatenate": ("aten.cat",),
    "stablehlo.slice": ("aten.slice", "aten.narrow"),
    "stablehlo.pad": ("aten.pad", "aten.constant_pad_nd"),
    # podtpu's nearest 2x upsample is a broadcast and a reshape
    "stablehlo.broadcast_in_dim": ("aten.expand", "aten.broadcast_to",
                                   "aten.upsample_nearest2d"),
    "stablehlo.constant": ("aten.scalar_tensor", "aten.full",
                           "aten.zeros", "aten.ones", "aten.lift_fresh_copy"),
    "stablehlo.convert": ("aten.to", "aten._to_copy", "aten.type_as",
                          "aten.clone", "aten.contiguous", "aten.alias",
                          "aten.detach", "aten._assert_tensor_metadata"),
    "stablehlo.return": ("python.getitem",),
    "stablehlo.rsqrt": ("aten.rsqrt",),
    "stablehlo.sqrt": ("aten.sqrt",),
    "stablehlo.exponential": ("aten.exp",),
    "stablehlo.logistic": ("aten.sigmoid",),
    "stablehlo.tanh": ("aten.tanh",),
    "stablehlo.abs": ("aten.abs",),
    "stablehlo.negate": ("aten.neg",),
    "stablehlo.clamp": ("aten.clamp", "aten.hardtanh"),
    "stablehlo.floor": ("aten.floor",),
    # leaky relu is a compare, a multiply and a select
    "stablehlo.select": ("aten.where", "aten.leaky_relu"),
    "stablehlo.compare": ("aten.eq", "aten.ne", "aten.gt", "aten.ge",
                          "aten.lt", "aten.le"),
    # int8 PTQ artifacts: quantize / dequantize
    "stablehlo.round_nearest_even": ("aten.round",),
}

DEFAULT_NPU_WHITELIST = frozenset(
    op for ops in _WHITELIST_BY_HLO.values() for op in ops)


class NPUValidationError(Exception):
    """Raised when an artifact uses operators outside the NPU whitelist."""

    def __init__(self, unsupported: dict):
        self.unsupported = unsupported
        ops = ", ".join(f"{k} x{v}" for k, v in sorted(unsupported.items()))
        super().__init__(f"unsupported ops for NPU target: {ops}")


def _program(artifact):
    """A path (loaded) or an ``ExportedProgram`` as it is."""
    if isinstance(artifact, str):
        from podtpu_torch.export.program import load_program

        return load_program(artifact)
    return artifact


def validate_for_npu(artifact, whitelist: Iterable[str] | None = None,
                     strict: bool = True) -> dict:
    """Check an artifact's (a ``.pt2`` path or an ``ExportedProgram``)
    operators against the whitelist. Returns ``{"ok", "unsupported":
    {op: count}, "ops": {op: count}}``; with ``strict`` raises
    :class:`NPUValidationError` when unsupported operators appear."""
    from podtpu_torch.export.program import inspect_program

    wl = (frozenset(whitelist) if whitelist is not None
          else DEFAULT_NPU_WHITELIST)
    ops = inspect_program(_program(artifact))["ops"]
    unsupported = {op: n for op, n in ops.items() if op not in wl}
    if unsupported and strict:
        raise NPUValidationError(unsupported)
    return {"ok": not unsupported, "unsupported": unsupported, "ops": ops}


def _sanitize(name: str) -> str:
    """A toolchain-safe identifier (the converter's name pass)."""
    name = re.sub(r"[^0-9a-zA-Z_]", "_", name)
    return re.sub(r"_+", "_", name).strip("_").lower() or "op"


_TAGGED_OPS = {
    "aten.conv2d": "conv", "aten.convolution": "conv",
    "aten._convolution": "conv",
    "aten.linear": "dense", "aten.mm": "dense", "aten.addmm": "dense",
    "aten._int_mm": "dense",
    "aten.max_pool2d": "pool", "aten.max_pool2d_with_indices": "pool",
    "aten.avg_pool2d": "pool",
}


def annotate_for_npu(artifact, out_json: str | None = None) -> dict:
    """Per-layer annotation map: the convolution, dense and pool nodes in
    graph order with ``layer_idx``, the operator, a sanitized name and,
    for a pool, ``pool_at_pad`` (its padding argument is non-zero)."""
    from podtpu_torch.export.program import op_name

    ep = _program(artifact)
    layers = []
    for node in ep.graph.nodes:
        if node.op != "call_function":
            continue
        op = op_name(node.target)
        kind = _TAGGED_OPS.get(op)
        if kind is None:
            continue
        idx = len(layers)
        entry = {"layer_idx": idx, "op": op, "name": _sanitize(f"{kind}_{idx}")}
        if kind == "pool":
            pad = node.args[3] if len(node.args) > 3 else node.kwargs.get(
                "padding", 0)
            pad = pad if isinstance(pad, (list, tuple)) else [pad]
            entry["pool_at_pad"] = any(int(p) != 0 for p in pad)
        layers.append(entry)
    result = {"artifact": artifact if isinstance(artifact, str) else None,
              "num_layers": len(layers), "layers": layers}
    if out_json:
        with open(out_json, "w") as f:
            json.dump(result, f, indent=2)
    return result


def fold_batchnorm(state_dict: dict, eps: float = 1e-5) -> dict:
    """Fold BN into the preceding conv kernel of every ``ConvBnAct`` of a
    ``state_dict`` (``<p>.conv.weight`` beside ``<p>.bn.*``); returns a
    new one whose eval outputs are unchanged. With ``g/b`` the BN affine
    and ``m/v`` the running statistics:

        kernel' = kernel * g/sqrt(v+eps) * sqrt(1+eps)
        bias'   = b - m * g/sqrt(v+eps),  weight' = 1, mean' = 0, var' = 1

    so the identity-statistics BN computes ``conv'(x) * rsqrt(1+eps) +
    bias'``, the original ``(conv(x)-m) * g/sqrt(v+eps) + b`` (the
    ``sqrt(1+eps)`` cancels the identity BN's ``rsqrt(1+eps)``). The
    arithmetic is ``podtpu``'s numpy, in the same precisions."""
    import torch

    out = dict(state_dict)
    for key in state_dict:
        if not key.endswith(".conv.weight"):
            continue
        p = key[:-len("conv.weight")]
        names = [p + n for n in ("bn.weight", "bn.bias", "bn.running_mean",
                                 "bn.running_var")]
        if not all(n in state_dict for n in names):
            continue
        g, b, m, v = (state_dict[n].detach().cpu().numpy() for n in names)
        kernel = state_dict[key].detach().cpu().numpy()
        inv = g / np.sqrt(v + eps)
        factor = inv * np.sqrt(1.0 + eps)
        folded = (kernel * factor[:, None, None, None]).astype(kernel.dtype)
        dev = state_dict[key].device
        out[key] = torch.from_numpy(folded).to(dev)
        out[names[0]] = torch.from_numpy(np.ones_like(g)).to(dev)
        out[names[1]] = torch.from_numpy((b - m * inv).astype(b.dtype)).to(
            dev)
        out[names[2]] = torch.from_numpy(np.zeros_like(m)).to(dev)
        out[names[3]] = torch.from_numpy(np.ones_like(v)).to(dev)
    return out
