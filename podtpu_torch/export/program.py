"""Model export through ``torch.export``: the deploy path (the counterpart
of ``podtpu/export/stablehlo.py``, which exports StableHLO through
``jax.export``).

An artifact is one file, a ``torch.export`` program saved with
``torch.export.save`` (``.pt2``): the graph of ATen operators with the
weights frozen in, runnable without the model's Python code.
:func:`inspect_exported` lists its operators, the role ``podtpu``'s op
histogram plays for a downstream toolchain (``export/npu.py``).

* ``--batch dyn`` (an input shape whose batch entry is ``None`` or a
  string) exports the leading dimension as a ``torch.export.Dim``: one
  artifact serves any batch.
* The serving artifact (:func:`export_serving`) holds the forward, the
  decoder and the padded NMS, traced from ``make_serving_graph``; its
  suppression is the registered operator
  ``torch.ops.podtpu_torch.greedy_suppress`` (``ops/kernels/nms_kernel.py``),
  one node of the graph, which runs the CUDA kernels on the card (and
  counts their launches) and the plain version on the CPU.
  :func:`load_exported` imports that module before it loads a file.
* An artifact runs on the device it was exported on: the graph's
  constants (anchor grids, class offsets) live there. Its metadata
  (``podtpu_torch.json`` in the file: the kind, the device, the batch)
  says which.
* A quantized model (``export/quantize.py``) exports its int8 blocks as
  they run: ``_int_mm`` on the card, the float64 plain version on the
  CPU.
"""

from __future__ import annotations

import collections
import json

import torch
from torch import nn

META = "podtpu_torch.json"
# a symbolic batch is traced from this many rows (a batch of 1 would let
# the tracer specialise on it)
_DYN_EXAMPLE = 2


class _Program(nn.Module):
    """What ``torch.export`` traces: ``fn(x)``, with ``model``'s weights
    registered so that they become the program's state."""

    def __init__(self, model: nn.Module, fn):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


def _is_dynamic(input_shape) -> bool:
    return input_shape[0] is None or isinstance(input_shape[0], str)


def _example(model: nn.Module, input_shape, dtype):
    dev = next(model.parameters()).device
    dyn = _is_dynamic(input_shape)
    shape = ((_DYN_EXAMPLE if dyn else int(input_shape[0])),) + tuple(
        int(d) for d in input_shape[1:])
    x = torch.zeros(shape, dtype=dtype, device=dev)
    dims = ({0: torch.export.Dim("batch", min=1)},) if dyn else None
    return x, dims


def _export(model: nn.Module, fn, input_shape, dtype, kind: str):
    was_training = model.training
    model.eval()
    x, dims = _example(model, input_shape, dtype)
    try:
        with torch.no_grad():
            ep = torch.export.export(_Program(model, fn), (x,),
                                     dynamic_shapes=dims)
    finally:
        model.train(was_training)
    meta = {"kind": kind, "device": str(x.device),
            "batch": None if dims else int(x.shape[0]),
            "input_shape": [None if dims else int(x.shape[0])]
            + list(x.shape[1:]), "dtype": str(dtype).replace("torch.", "")}
    return ep, meta


def export_forward(model: nn.Module, input_shape, dtype=torch.float32):
    """``torch.export`` of ``model(x)`` in eval mode, weights frozen in:
    ``(ExportedProgram, metadata)``. ``input_shape`` is the NHWC input;
    a batch entry of ``None`` exports a symbolic batch."""
    return _export(model, model, input_shape, dtype, "forward")


def _save(ep, meta: dict, path: str) -> str:
    torch.export.save(ep, path, extra_files={META: json.dumps(meta)})
    return path


def export_program(model: nn.Module, input_shape, path: str,
                   dtype=torch.float32) -> str:
    """The forward artifact (``podtpu``'s ``export_stablehlo``)."""
    return _save(*export_forward(model, input_shape, dtype), path)


def export_serving(model: nn.Module, cfg: dict, input_shape, path: str,
                   dtype=torch.float32) -> str:
    """The full deployment unit: forward + decode + padded NMS, from an
    image batch to ``(dets [B, max_det, 6], valid [B, max_det])``. cfg
    ``nms_options`` and ``tta`` bake into the artifact."""
    from podtpu_torch.train.steps import make_serving_graph

    graph = make_serving_graph(cfg, model)
    return _save(*_export(model, graph, input_shape, dtype, "serving"),
                 path)


def read_meta(path: str) -> dict:
    """The artifact's metadata (``{}`` for a file without it)."""
    import zipfile

    with zipfile.ZipFile(path) as z:
        for name in z.namelist():
            if name.endswith("/extra/" + META) or name == META:
                return json.loads(z.read(name))
    return {}


def load_program(path: str):
    """The ``ExportedProgram`` of an artifact, after the operators it may
    hold are registered."""
    import podtpu_torch.ops.kernels.nms_kernel  # noqa: F401  (the operator)

    return torch.export.load(path)


def load_exported(path: str):
    """Load an artifact; returns a callable that runs it without autograd
    (``inference_mode``) on the device it was exported on."""
    module = load_program(path).module()

    @torch.inference_mode()
    def run(x):
        return module(x)

    return run


def op_name(target) -> str:
    """``aten.conv2d``, ``podtpu_torch.greedy_suppress``, ... (the
    overload dropped); a Python callable by its own name."""
    schema = getattr(target, "_schema", None)
    if schema is not None:
        return schema.name.replace("::", ".")
    return "python." + getattr(target, "__name__", str(target))


def _spec(val) -> str:
    if isinstance(val, torch.Tensor):
        dims = ",".join(str(d) for d in val.shape)
        return f"{str(val.dtype).replace('torch.', '')}[{dims}]"
    return type(val).__name__


def inspect_program(ep) -> dict:
    """Op histogram of the graph's ``call_function`` targets, and the user
    inputs' and outputs' dtype and shape (a symbolic batch as ``s0``)."""
    ops = collections.Counter(op_name(n.target) for n in ep.graph.nodes
                              if n.op == "call_function")
    sig = ep.graph_signature
    nodes = {n.name: n for n in ep.graph.nodes}
    ins = [_spec(nodes[name].meta.get("val")) for name in sig.user_inputs]
    out_node = next(n for n in ep.graph.nodes if n.op == "output")
    outs = [_spec(a.meta.get("val")) for a in out_node.args[0]
            if hasattr(a, "meta")][:len(sig.user_outputs)]
    return {"in_specs": ins, "out_specs": outs,
            "ops": dict(sorted(ops.items(), key=lambda kv: -kv[1]))}


def inspect_exported(path: str) -> dict:
    """:func:`inspect_program` of the file, with its metadata."""
    info = inspect_program(load_program(path))
    info.update(read_meta(path))
    return info
