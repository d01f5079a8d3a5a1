"""TFLite export written by hand, and a reader that runs the file with
torch (the counterpart of ``podtpu/export/tflite.py``).

``podtpu`` converts its model through jax2tf and TensorFlow's converter.
Neither is on the card's machine, so the port writes the ``.tflite``
flatbuffer itself: :func:`export_tflite` traces the model with
``torch.export`` (``export/program.py``), lowers the ATen graph to TFLite
builtin operators (``export/tflite_lower.py``) and lays the file out with
``export/flatbuf.py`` by the schema constants of
``export/tflite_schema.py``. The file is float32 with a static batch, the
forward or the whole serving unit (``with_postprocess``): input ``image``
``[B, H, W, 3]`` float32, outputs ``dets`` ``[B, max_det, 6]`` float32
then ``valid`` ``[B, max_det]`` bool, as ``podtpu``'s artifact.

There is no TFLite interpreter on the card's machine either:
:func:`load_tflite` parses the file and runs its operators in order with
torch on a device (the card by default), the constants uploaded once. Its
``NON_MAX_SUPPRESSION_V5`` runs through ``greedy_suppress``: the CUDA
kernels of ``csrc/nms_suppress.cu`` on the card (one launch for the
batch's consecutive suppressions), the plain version on the CPU.

Where the file and the port's in-process serving differ:

* TFLite's interpreter computes an IoU as ``inter / union``; the port adds
  1e-6 to the union and suppresses at ``iou > thr``. The file asks
  ``iou >= t`` with ``t`` the float32 after ``thr`` (so ``>`` and ``>=``
  agree), and so a pair decides differently only where the 1e-6 moves the
  IoU across the threshold (two identical boxes of area 1e-6: IoU 1 there,
  0.5 in the port). The interpreter sorts each box's corners; the port
  does not (the decoders never make x2 < x1). Boxes of no area bypass the
  op (``export/tflite_lower.py``). The reader runs the port's
  ``greedy_suppress``, and so gives the port's answer on the same boxes.
* A bf16 config exports the float32 graph of its weights (``podtpu``'s
  converter refuses bf16: "failed to legalize operation 'tfl.pad'").
* Reading ``podtpu``'s own files (``WHILE``, ``GATHER_ND`` over a loop
  state) is not ported (ROADMAP.md item 10d).

A quantized file (``quantize="dynamic"`` or ``"int8"``,
``export/tflite_quant.py``) holds int8 tensors with their scales and zero
points; the reader runs its int8 and hybrid operators with TFLite's
integer arithmetic (``export/tflite_int8.py``: the int8 products through
``torch._int_mm`` on the card), and gives the interpreter's int8 codes.
"""

from __future__ import annotations

import collections
import copy
import json

import numpy as np
import torch
import torch.nn.functional as F

from podtpu_torch.export import flatbuf
from podtpu_torch.export import tflite_schema as S
from podtpu_torch.export.tflite_int8 import (
    HYBRID_KERNELS,
    INT8_KERNELS,
    conv_pads,
    same_pads,
)
from podtpu_torch.export.tflite_quant import MOVERS

META = "podtpu_torch"


def export_tflite(model: torch.nn.Module, cfg: dict | None, input_shape,
                  path: str, with_postprocess: bool = False,
                  quantize: str | None = None, rep_batches=None) -> str:
    """Write ``model`` (eval mode, weights frozen in) as a ``.tflite``
    file: the forward, or with ``with_postprocess`` the serving unit of
    ``cfg`` (forward + decode + NMS). ``input_shape`` is the NHWC input
    with a static batch.

    ``quantize``: ``None`` = float32; ``"dynamic"`` = int8 filters, float
    compute; ``"int8"`` = full-integer post-training quantization with
    float fallback, calibrated on ``rep_batches`` (float32 arrays of
    ``input_shape``, run through the float file by the reader on the
    model's device). ``export/tflite_quant.py`` says what each holds."""
    lowered = lower_model(model, cfg, input_shape, with_postprocess)
    return write_tflite(lowered, path, quantize, rep_batches,
                        next(model.parameters()).device)


def lower_model(model: torch.nn.Module, cfg: dict | None, input_shape,
                with_postprocess: bool = False):
    """The float32 TFLite subgraph of ``model`` (one ``torch.export``) and
    its metadata, for :func:`write_tflite` (which may write several files
    of it)."""
    from podtpu_torch.export.program import _export
    from podtpu_torch.export.tflite_lower import lower_program

    if input_shape[0] is None or isinstance(input_shape[0], str):
        raise ValueError("a TFLite artifact takes a static batch "
                         "(podtpu refuses --batch dyn for TFLite too)")
    if with_postprocess:
        from podtpu_torch.train.steps import make_serving_graph

        fn, kind = make_serving_graph(cfg, model), "serving"
    else:
        fn, kind = model, "forward"
    ep, meta = _export(model, fn, input_shape, torch.float32, kind)
    family = (cfg or {}).get("model", type(model).__name__)
    meta.update(dtype="float32", family=family)
    meta.pop("device", None)
    return lower_program(ep, family), meta


def write_tflite(lowered, path: str, quantize: str | None = None,
                 rep_batches=None, device="cuda") -> str:
    """Write the ``(subgraph, meta)`` of :func:`lower_model` as a float32,
    ``"dynamic"`` or ``"int8"`` file (:func:`export_tflite`); an int8 file
    is calibrated by the reader on ``device``. ``lowered`` is left as it
    was."""
    from podtpu_torch.export import tflite_quant

    if quantize not in (None,) + tflite_quant.MODES:
        raise ValueError(f"unknown quantize mode {quantize!r} (expected "
                         "dynamic | int8)")
    if quantize == "int8" and rep_batches is None:
        raise ValueError("int8 quantization needs rep_batches for "
                         "calibration")
    b, meta = copy.deepcopy(lowered)
    if quantize == "dynamic":
        tflite_quant.dynamic_range(b)
    elif quantize == "int8":
        tflite_quant.full_integer(b, tflite_quant.calibrate(
            b, rep_batches, device))
    kind = meta["kind"]
    names = ["dets", "valid"] if kind == "serving" else [
        f"head{i}" for i in range(len(b.outputs))]
    for t, name in zip(b.outputs, names):
        b.tensors[t][3] = name
    meta.update(outputs=names, quantize=quantize)
    data = b.serialize(f"podtpu_torch {kind} ({meta['family']})",
                       {META: json.dumps(meta).encode()})
    with open(path, "wb") as f:
        f.write(data)
    return path


# ---- the file ---------------------------------------------------------------

class TFLiteFile:
    """A parsed ``.tflite`` file: ``tensors`` ``(name, shape, type,
    data)`` (data a numpy view of the constant's buffer, or None),
    ``quant`` the affine parameters of the quantized ones,
    ``ops`` ``(name, inputs, outputs, options)``, the subgraph's
    ``inputs`` and ``outputs`` and the ``meta`` the port wrote."""

    def __init__(self, buf):
        m = flatbuf.root(buf, S.IDENTIFIER)
        self.version = m.scalar(S.MODEL["version"], "uint32")
        codes = []
        for oc in m.tables(S.MODEL["operator_codes"]):
            code = max(oc.scalar(S.OPERATOR_CODE["builtin_code"], "int32"),
                       oc.scalar(S.OPERATOR_CODE["deprecated_builtin_code"],
                                 "int8"))
            if oc.has(S.OPERATOR_CODE["custom_code"]):
                raise NotImplementedError(
                    f"custom operator {oc.string(S.OPERATOR_CODE['custom_code'])!r}")
            codes.append(code)
        buffers = [b.vector(S.BUFFER["data"], np.uint8)
                   for b in m.tables(S.MODEL["buffers"])]
        subgraphs = m.tables(S.MODEL["subgraphs"])
        if len(subgraphs) != 1:
            raise NotImplementedError(
                f"{len(subgraphs)} subgraphs: control flow (WHILE) is not "
                "read here (podtpu's own artifacts: ROADMAP.md item 10d)")
        sg = subgraphs[0]
        self.tensors = []
        self.quant = {}  # tensor -> (scale [n], zero_point [n], axis)
        for t in sg.tables(S.SUBGRAPH["tensors"]):
            shape = t.vector(S.TENSOR["shape"], np.int32)
            shape = tuple(int(d) for d in shape) if shape is not None else ()
            ttype = S.TENSOR_TYPE_NAME.get(t.scalar(S.TENSOR["type"], "int8"))
            if ttype is None:
                raise NotImplementedError(
                    f"tensor type {t.scalar(S.TENSOR['type'], 'int8')}")
            buf = buffers[t.scalar(S.TENSOR["buffer"], "uint32")]
            data = None
            if buf is not None and buf.size:
                data = buf.view(S.NUMPY[ttype]).reshape(shape)
            q = t.table(S.TENSOR["quantization"])
            scale = None if q is None else q.vector(
                S.QUANTIZATION["scale"], np.float32)
            if scale is not None and scale.size:
                self.quant[len(self.tensors)] = (
                    scale, q.vector(S.QUANTIZATION["zero_point"], np.int64),
                    q.scalar(S.QUANTIZATION["quantized_dimension"], "int32"))
            self.tensors.append((t.string(S.TENSOR["name"]), shape, ttype,
                                 data))
        self.ops = []
        for op in sg.tables(S.SUBGRAPH["operators"]):
            code = codes[op.scalar(S.OPERATOR["opcode_index"], "uint32")]
            name = S.BUILTIN_NAME.get(code)
            if name is None:
                raise NotImplementedError(
                    f"TFLite builtin operator {code} is not read here "
                    "(podtpu_torch/export/tflite_schema.py)")
            self.ops.append((name, [int(i) for i in op.vector(
                S.OPERATOR["inputs"], np.int32)], [int(i) for i in op.vector(
                    S.OPERATOR["outputs"], np.int32)], _options(name, op)))
        self.inputs = [int(i) for i in sg.vector(S.SUBGRAPH["inputs"],
                                                 np.int32)]
        self.outputs = [int(i) for i in sg.vector(S.SUBGRAPH["outputs"],
                                                  np.int32)]
        self.meta = {}
        for md in m.tables(S.MODEL["metadata"]):
            if md.string(S.METADATA["name"]) == META:
                self.meta = json.loads(bytes(buffers[md.scalar(
                    S.METADATA["buffer"], "uint32")]))

    def spec(self, t: int) -> str:
        _, shape, ttype, _ = self.tensors[t]
        return f"{S.NUMPY[ttype]}[{','.join(str(d) for d in shape)}]"


def _options(name: str, op) -> dict:
    table = S.OP_OPTIONS.get(name)
    if table is None:
        return {}
    union, spec = S.OPTIONS[table]
    opts = op.table(S.OPERATOR["builtin_options"])
    got = op.scalar(S.OPERATOR["builtin_options_type"], "uint8")
    if opts is not None and got != union:
        raise ValueError(f"{name} carries options {got}, expected {union}")
    return {k: (opts.scalar(slot, kind, default) if opts is not None
                else default) for k, (slot, kind, default) in spec.items()}


def read_tflite(path: str) -> TFLiteFile:
    with open(path, "rb") as f:
        return TFLiteFile(f.read())


def _quant_info(q) -> dict:
    scale, zp, dim = q
    if scale.size == 1:
        return {"scale": float(scale[0]), "zero_point": int(zp[0])}
    return {"channels": int(scale.size), "axis": int(dim),
            "scale_min": float(scale.min()), "scale_max": float(scale.max())}


def inspect_tflite(path: str) -> dict:
    """Op histogram, input and output specs, each tensor's type and
    quantization, and the metadata of a ``.tflite`` file
    (``export/program.py::inspect_program`` for ``.pt2``)."""
    f = read_tflite(path)
    ops = collections.Counter(op[0] for op in f.ops)
    info = {"in_specs": [f.spec(t) for t in f.inputs],
            "out_specs": [f.spec(t) for t in f.outputs],
            "out_names": [f.tensors[t][0] for t in f.outputs],
            "ops": dict(sorted(ops.items(), key=lambda kv: -kv[1])),
            "tensor_types": dict(collections.Counter(
                t[2] for t in f.tensors)),
            "tensors": [{"name": name, "type": ttype, "shape": list(shape),
                         **({"quantization": _quant_info(f.quant[i])}
                            if i in f.quant else {})}
                        for i, (name, shape, ttype, _) in
                        enumerate(f.tensors)],
            "version": f.version}
    info.update(f.meta)
    return info


# ---- the reader -------------------------------------------------------------

_DTYPE = {"FLOAT32": torch.float32, "INT32": torch.int32, "BOOL": torch.bool,
          "INT8": torch.int8}


def _activation(code: int):
    if code == 0:
        return None
    if code == 1:
        return torch.relu
    if code == 3:
        return lambda x: x.clamp(0.0, 6.0)
    raise NotImplementedError(f"fused activation {code}")


class _Plan:
    """What each operator needs at run time, read once when its kernel is
    built: a constant parameter on the host (:meth:`value`: a shape, an
    axis) or on the device in the layout the kernel wants (:meth:`upload`:
    a filter). Every constant operand not uploaded here is uploaded as it
    is and handed over with the computed tensors
    (:attr:`TFLiteProgram._fill`)."""

    def __init__(self, f: TFLiteFile, device: torch.device):
        self.f, self.device = f, device
        self.uploaded: set = set()

    def is_const(self, t: int) -> bool:
        return t >= 0 and self.f.tensors[t][3] is not None

    def value(self, t: int) -> np.ndarray:
        data = self.f.tensors[t][3]
        if data is None:
            raise ValueError(f"tensor {t} ({self.f.tensors[t][0]}) must be "
                             "a constant here")
        return np.asarray(data)

    def upload(self, t: int, transform=None) -> torch.Tensor:
        """Constant ``t`` on the device, after ``transform`` on the host."""
        x = torch.from_numpy(np.array(self.value(t)))
        if transform is not None:
            x = transform(x)
        self.uploaded.add(t)
        return x.to(self.device)

    def shape(self, t: int):
        return self.f.tensors[t][1]


KERNELS: dict = {}


def _kernel(*names):
    def register(fn):
        for n in names:
            KERNELS[n] = fn
        return fn
    return register


def _fused(o):
    act = _activation(o.get("fused_activation_function", 0))
    return act if act is not None else (lambda x: x)


_BIN = {"ADD": torch.add, "SUB": torch.sub, "MUL": torch.mul,
        "DIV": torch.div, "MAXIMUM": torch.maximum, "MINIMUM": torch.minimum,
        "GREATER": torch.gt, "LESS": torch.lt, "EQUAL": torch.eq,
        "LOGICAL_AND": torch.logical_and, "LOGICAL_OR": torch.logical_or}


@_kernel(*_BIN)
def _k_binary(p, name, ins, outs, o):
    fn, act = _BIN[name], _fused(o)
    (a, b), (out,) = ins, outs

    def run(v):
        v[out] = act(fn(v[a], v[b]))
    return run


_UN = {"RELU": torch.relu, "LOGISTIC": torch.sigmoid, "TANH": torch.tanh,
       "EXP": torch.exp, "LOG": torch.log, "ABS": torch.abs,
       "LOGICAL_NOT": torch.logical_not}


@_kernel(*_UN)
def _k_unary(p, name, ins, outs, o):
    fn = _UN[name]
    (a,), (out,) = ins[:1], outs

    def run(v):
        v[out] = fn(v[a])
    return run


@_kernel("LEAKY_RELU")
def _k_leaky(p, name, ins, outs, o):
    alpha = float(o["alpha"])
    (a,), (out,) = ins[:1], outs

    def run(v):
        v[out] = F.leaky_relu(v[a], alpha)
    return run


@_kernel("CAST")
def _k_cast(p, name, ins, outs, o):
    dtype = _DTYPE[p.f.tensors[outs[0]][2]]
    a, out = ins[0], outs[0]

    def run(v):
        v[out] = v[a].to(dtype)
    return run


@_kernel("CONV_2D")
def _k_conv(p, name, ins, outs, o):
    x_t, out = ins[0], outs[0]
    w = p.upload(ins[1], lambda w: w.permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last))
    bias = p.upload(ins[2]) if len(ins) > 2 and ins[2] >= 0 else None
    _, h, wd, _ = p.shape(x_t)
    kh, kw = w.shape[2:]
    sh, sw = o["stride_h"], o["stride_w"]
    dh, dw = o["dilation_h_factor"], o["dilation_w_factor"]
    top, bottom, left, right = conv_pads(o, h, wd, kh, kw)
    act = _fused(o)
    if top == bottom and left == right:
        def run(v):
            y = F.conv2d(v[x_t].permute(0, 3, 1, 2), w, bias, (sh, sw),
                         (top, left), (dh, dw))
            v[out] = act(y).permute(0, 2, 3, 1)
    else:
        def run(v):
            x = F.pad(v[x_t].permute(0, 3, 1, 2), (left, right, top, bottom))
            y = F.conv2d(x, w, bias, (sh, sw), 0, (dh, dw))
            v[out] = act(y).permute(0, 2, 3, 1)
    return run


@_kernel("MAX_POOL_2D")
def _k_max_pool(p, name, ins, outs, o):
    x_t, out = ins[0], outs[0]
    _, h, w, _ = p.shape(x_t)
    kh, kw = o["filter_height"], o["filter_width"]
    sh, sw = o["stride_h"], o["stride_w"]
    if o["padding"] == S.PADDING["SAME"]:
        top, bottom = same_pads(h, kh, sh, 1)
        left, right = same_pads(w, kw, sw, 1)
    else:
        top = bottom = left = right = 0
    act = _fused(o)
    dtype = _DTYPE[p.f.tensors[out][2]]

    def run(v):
        # int8 codes pool as float32 (exact), which torch pools on both
        # devices
        x = v[x_t].permute(0, 3, 1, 2).float()
        if top or bottom or left or right:
            x = F.pad(x, (left, right, top, bottom), value=-float("inf"))
        v[out] = act(F.max_pool2d(x, (kh, kw), (sh, sw))).permute(
            0, 2, 3, 1).to(dtype)
    return run


@_kernel("RESIZE_NEAREST_NEIGHBOR")
def _k_resize(p, name, ins, outs, o):
    if o["align_corners"] or o["half_pixel_centers"]:
        raise NotImplementedError("RESIZE_NEAREST_NEIGHBOR with "
                                  "align_corners or half_pixel_centers")
    size = tuple(int(s) for s in p.value(ins[1]))
    x_t, out = ins[0], outs[0]
    dtype = _DTYPE[p.f.tensors[out][2]]

    def run(v):
        x = v[x_t].permute(0, 3, 1, 2).float()
        v[out] = F.interpolate(x, size=size, mode="nearest").permute(
            0, 2, 3, 1).to(dtype)
    return run


@_kernel("CONCATENATION")
def _k_concat(p, name, ins, outs, o):
    axis, act, out = o["axis"], _fused(o), outs[0]

    def run(v):
        v[out] = act(torch.cat([v[t] for t in ins], axis))
    return run


@_kernel("RESHAPE")
def _k_reshape(p, name, ins, outs, o):
    shape, a, out = p.shape(outs[0]), ins[0], outs[0]

    def run(v):
        v[out] = v[a].reshape(shape)
    return run


@_kernel("TRANSPOSE")
def _k_transpose(p, name, ins, outs, o):
    perm, a, out = [int(i) for i in p.value(ins[1])], ins[0], outs[0]

    def run(v):
        v[out] = v[a].permute(perm)
    return run


@_kernel("STRIDED_SLICE")
def _k_strided_slice(p, name, ins, outs, o):
    if o["ellipsis_mask"] or o["new_axis_mask"] or o["offset"]:
        raise NotImplementedError("STRIDED_SLICE with ellipsis, new-axis or "
                                  "offset masks")
    begin, end, strides = (p.value(t) for t in ins[1:4])
    index = []
    for i, (bg, en, st) in enumerate(zip(begin, end, strides)):
        bg = None if o["begin_mask"] >> i & 1 else int(bg)
        en = None if o["end_mask"] >> i & 1 else int(en)
        if o["shrink_axis_mask"] >> i & 1:
            index.append(bg)
        else:
            if st <= 0:
                raise NotImplementedError("STRIDED_SLICE with stride <= 0")
            index.append(slice(bg, en, int(st)))
    index = tuple(index)
    a, out = ins[0], outs[0]

    def run(v):
        v[out] = v[a][index]
    return run


@_kernel("PACK")
def _k_pack(p, name, ins, outs, o):
    axis, out = o["axis"], outs[0]

    def run(v):
        v[out] = torch.stack([v[t] for t in ins], axis)
    return run


@_kernel("UNPACK")
def _k_unpack(p, name, ins, outs, o):
    axis, a = o["axis"], ins[0]

    def run(v):
        for t, x in zip(outs, torch.unbind(v[a], axis)):
            v[t] = x
    return run


@_kernel("ARG_MAX")
def _k_argmax(p, name, ins, outs, o):
    axis = int(p.value(ins[1]).reshape(-1)[0])
    dtype = _DTYPE[p.f.tensors[outs[0]][2]]
    a, out = ins[0], outs[0]

    def run(v):
        v[out] = torch.argmax(v[a], axis).to(dtype)
    return run


@_kernel("REDUCE_MAX", "REDUCE_ANY")
def _k_reduce(p, name, ins, outs, o):
    axes = tuple(int(d) for d in p.value(ins[1]).reshape(-1))
    keep, a, out = bool(o["keep_dims"]), ins[0], outs[0]
    if name == "REDUCE_ANY":
        def run(v):
            v[out] = torch.amax(v[a].to(torch.uint8), axes, keep).bool()
    else:
        def run(v):
            v[out] = torch.amax(v[a], axes, keep)
    return run


@_kernel("SELECT_V2")
def _k_select(p, name, ins, outs, o):
    (c, a, b), out = ins, outs[0]

    def run(v):
        v[out] = torch.where(v[c], v[a], v[b])
    return run


@_kernel("TOPK_V2")
def _k_topk(p, name, ins, outs, o):
    k = int(p.value(ins[1]).reshape(()))
    a, (vals, idx) = ins[0], outs

    def run(v):
        # a stable descending sort: ties keep the lower index, as TFLite
        s, i = torch.sort(v[a], dim=-1, descending=True, stable=True)
        v[vals], v[idx] = s[..., :k], i[..., :k].int()
    return run


@_kernel("GATHER_ND")
def _k_gather_nd(p, name, ins, outs, o):
    (x, i), out = ins, outs[0]

    def run(v):
        v[out] = v[x][tuple(v[i].long().unbind(-1))]
    return run


@_kernel("PAD", "PADV2")
def _k_pad(p, name, ins, outs, o):
    pads = p.value(ins[1]).reshape(-1, 2)
    flat = []
    for before, after in pads[::-1]:
        flat += [int(before), int(after)]
    if len(ins) > 2:
        value = p.value(ins[2]).reshape(()).item()
    elif p.f.tensors[outs[0]][2] == "INT8":
        value = int(p.f.quant[outs[0]][1][0])  # int8 pads with its zp
    else:
        value = 0.0
    a, out = ins[0], outs[0]

    def run(v):
        v[out] = F.pad(v[a], flat, value=value)
    return run


@_kernel("BROADCAST_TO")
def _k_broadcast(p, name, ins, outs, o):
    shape, a, out = p.shape(outs[0]), ins[0], outs[0]

    def run(v):
        v[out] = v[a].expand(shape)
    return run


@_kernel("FULLY_CONNECTED")
def _k_fc(p, name, ins, outs, o):
    if o["weights_format"]:
        raise NotImplementedError("shuffled FULLY_CONNECTED weights")
    w = p.upload(ins[1])
    bias = p.upload(ins[2]) if len(ins) > 2 and ins[2] >= 0 else None
    shape, a, out, act = p.shape(outs[0]), ins[0], outs[0], _fused(o)

    def run(v):
        x = v[a].reshape(-1, w.shape[1])
        v[out] = act(F.linear(x, w, bias)).reshape(shape)
    return run


def _nms_group(p, group):
    """``NON_MAX_SUPPRESSION_V5`` of consecutive, independent operators
    with the same constants, as one batched ``greedy_suppress``: the
    candidates sorted by score (stable), suppressed at ``iou > thr`` with
    ``thr`` the float32 before the file's threshold (the port's ``>``;
    TFLite's ``>=``), the survivors' indices, scores and count."""
    from podtpu_torch.ops.kernels.nms_kernel import greedy_suppress

    ins0 = group[0][1]
    m = int(p.value(ins0[2]).reshape(()))
    iou = np.float32(p.value(ins0[3]).reshape(()))
    score_thr = float(p.value(ins0[4]).reshape(()))
    if float(p.value(ins0[5]).reshape(())) != 0.0:
        raise NotImplementedError("soft NMS (soft_nms_sigma > 0)")
    thr = float(np.nextafter(iou, np.float32(-np.inf)))
    boxes_t = [ins[0] for _, ins, _ in group]
    scores_t = [ins[1] for _, ins, _ in group]
    outs = [o for _, _, o in group]

    def run(v):
        boxes = torch.stack([v[t] for t in boxes_t]).float()
        scores = torch.stack([v[t] for t in scores_t]).float()
        n, k = scores.shape
        s, order = torch.sort(scores, dim=1, descending=True, stable=True)
        b = boxes.gather(1, order[..., None].expand(-1, -1, 4))
        keep = greedy_suppress(b.contiguous(), s > score_thr, thr)
        rank = torch.cumsum(keep, 1) - 1
        slot = torch.where(keep & (rank < m), rank, m)
        sel = torch.zeros((n, m + 1), dtype=torch.int32, device=s.device)
        sel.scatter_(1, slot, order.int())
        sc = torch.zeros((n, m + 1), dtype=s.dtype, device=s.device)
        sc.scatter_(1, slot, s)
        count = keep.sum(1).clamp(max=m).int()
        for i, (t_sel, t_sc, t_n) in enumerate(outs):
            v[t_sel], v[t_sc], v[t_n] = sel[i, :m], sc[i, :m], count[i]
    return run


def _kernel_for(f: TFLiteFile, name: str, ins):
    """The kernel of an operator on its input types: TFLite's integer
    arithmetic (``export/tflite_int8.py``) where the first input is int8,
    its hybrid kernels where a float input meets an int8 filter, else the
    float one, which the operators that only move bytes (reshape, slice,
    pad, pool: ``tflite_quant.MOVERS``) also run on int8 codes."""
    types = [f.tensors[t][2] for t in ins if t >= 0]
    if name in ("QUANTIZE", "DEQUANTIZE"):
        return INT8_KERNELS[name]
    if name in HYBRID_KERNELS and types[:2] == ["FLOAT32", "INT8"]:
        return HYBRID_KERNELS[name]
    if name in INT8_KERNELS and types[0] == "INT8":
        return INT8_KERNELS[name]
    if "INT8" in types and name not in MOVERS:  # their kernels move bytes
        return None
    return KERNELS.get(name)


def _nms_key(p, ins) -> tuple:
    return (p.shape(ins[0]),) + tuple(
        p.value(t).tobytes() for t in ins[2:6])


class TFLiteProgram:
    """A ``.tflite`` file run with torch on ``device``: call it with the
    input tensor(s); returns the outputs (a tuple when there are more
    than one)."""

    def __init__(self, f: TFLiteFile, device):
        self.file, self.device = f, torch.device(device)
        self.meta = f.meta
        self.in_specs = [f.spec(t) for t in f.inputs]
        self.out_specs = [f.spec(t) for t in f.outputs]
        self.out_names = [f.tensors[t][0] for t in f.outputs]
        self.batch = f.tensors[f.inputs[0]][1][0] if f.inputs else None
        plan = _Plan(f, self.device)
        self._steps, self._made = [], []  # the kernels, what each makes
        reads = []  # the tensors each step reads
        made = set(f.inputs)
        ops = f.ops
        i = 0
        while i < len(ops):
            name, ins, outs, o = ops[i]
            if name == "NON_MAX_SUPPRESSION_V5":
                group, key, group_outs = [], _nms_key(plan, ins), set()
                while (i < len(ops) and ops[i][0] == name
                       and _nms_key(plan, ops[i][1]) == key
                       and not set(ops[i][1]) & group_outs):
                    group.append(ops[i][:3])
                    group_outs.update(ops[i][2])
                    i += 1
                self._steps.append(_nms_group(plan, group))
                self._made.append(sorted(group_outs))
                reads.append({t for g in group for t in g[1]})
                made.update(group_outs)
                continue
            kernel = _kernel_for(f, name, ins)
            if kernel is None:
                raise NotImplementedError(
                    f"TFLite operator {name} on "
                    f"{[f.tensors[t][2] for t in ins if t >= 0]} is not run "
                    "here (podtpu_torch/export/tflite.py)")
            self._steps.append(kernel(plan, name, ins, outs, o))
            self._made.append(outs)
            reads.append(set(ins))
            made.update(outs)
            i += 1
        # each computed tensor is dropped after the last step that reads it
        last = {t: j for j, r in enumerate(reads) for t in r
                if t in made and t not in f.outputs}
        self._free = [[] for _ in self._steps]
        for t, j in last.items():
            self._free[j].append(t)
        self._n = len(f.tensors)
        operands = {t for op in ops for t in op[1] if plan.is_const(t)}
        self._fill = [(t, plan.upload(t)) for t in sorted(
            operands - plan.uploaded)]
        missing = [f.tensors[t][0] for t in f.outputs
                   if t not in made and f.tensors[t][3] is None]
        if missing:
            raise ValueError(f"outputs {missing} are computed by no operator")

    def __call__(self, *xs):
        return self.run(xs)

    @torch.inference_mode()
    def run(self, xs, observe=None):
        """The outputs for inputs ``xs``; ``observe(t, value)`` sees each
        input and each computed tensor ``t`` as it is made (the int8
        export's calibration)."""
        f = self.file
        if len(xs) != len(f.inputs):
            raise ValueError(f"{len(f.inputs)} inputs expected, got {len(xs)}")
        v: list = [None] * self._n
        for t, c in self._fill:
            v[t] = c
        for t, x in zip(f.inputs, xs):
            want = f.tensors[t][1]
            x = torch.as_tensor(x)
            if tuple(x.shape) != want:
                raise ValueError(f"input {f.tensors[t][0]} must be {want}, "
                                 f"got {tuple(x.shape)}")
            v[t] = x.to(self.device, _DTYPE[f.tensors[t][2]])
            if observe is not None:
                observe(t, v[t])
        for step, made, free in zip(self._steps, self._made, self._free):
            step(v)
            if observe is not None:
                for t in made:
                    observe(t, v[t])
            for t in free:
                v[t] = None
        outs = tuple(v[t] for t in f.outputs)
        return outs[0] if len(outs) == 1 else outs


def load_tflite(path: str, device="cuda") -> TFLiteProgram:
    """The port's counterpart of ``podtpu``'s ``load_interpreter`` /
    ``run_tflite``: the file parsed, its constants uploaded to ``device``
    once, and a callable that runs its operators there with torch (the
    suppression through ``greedy_suppress``). Runs under
    ``torch.inference_mode``."""
    return TFLiteProgram(read_tflite(path), device)
