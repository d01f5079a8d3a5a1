"""TF SavedModel export written by hand, and a reader that runs it with
torch (the counterpart of ``podtpu/export/tflite.py::export_savedmodel``).

``podtpu`` writes its SavedModel through jax2tf and TensorFlow. Neither is
on the card's machine, so the port writes the protobuf itself:
:func:`export_savedmodel` traces the model with ``torch.export``, lowers
it with the TFLite path's ATen walk (``export/tflite_lower.py``,
``fmt="SavedModel"``) and turns that into a frozen ``GraphDef`` of TF raw
operators (``export/savedmodel_lower.py``), written by
``export/protobuf.py``. The directory holds ``saved_model.pb``: one
``MetaGraphDef`` tagged ``serve`` with a ``serving_default`` signature of
the names, shapes and dtypes of ``podtpu``'s: input ``image`` float32
``[B, H, W, 3]`` (a static batch), outputs ``output_0`` ... the NHWC heads
in ``podtpu``'s order, or for the serving unit (``with_postprocess``)
``output_0`` dets ``[B, max_det, 6]`` float32 and ``output_1`` valid
``[B, max_det]`` bool. There are no variables: every weight is a ``Const``
node. The port's metadata is ``assets.extra/podtpu_torch.json`` (the
folder a SavedModel keeps for files TensorFlow does not load).
``tf.saved_model.load(path).signatures["serving_default"]`` runs it.

There is no TensorFlow runtime on the card's machine either:
:func:`load_savedmodel` parses the file, orders its nodes and runs each
operator with torch on a device (the card by default), through the TFLite
reader's kernels (``export/tflite.py::TFLiteProgram``: each TF operator is
read as its TFLite counterpart; a ``Conv2D``'s ``BiasAdd`` joins it). The
batch's ``NonMaxSuppressionV5`` nodes run as one ``greedy_suppress``: one
launch of the CUDA kernels of ``csrc/nms_suppress.cu`` for a CUDA input,
the plain version for a CPU one.

Where the file and the port's in-process serving differ:

* TF's ``NonMaxSuppressionV5`` computes an IoU as ``inter / union`` and
  suppresses at ``iou > t``; the port adds 1e-6 to the union. A pair
  decides differently only where that 1e-6 moves the IoU across the
  threshold. The reader runs the port's ``greedy_suppress``.
* A bf16 config exports the float32 graph of its weights (``podtpu``'s
  ``XlaCallModule`` computes that config in bf16).
* ``podtpu``'s own SavedModel (a ``StatefulPartitionedCall`` over one
  ``XlaCallModule`` of serialized StableHLO) is refused by the reader
  (ROADMAP.md queue 1, item 10d).
"""

from __future__ import annotations

import collections
import json
import os

import numpy as np
import torch

from podtpu_torch.export import savedmodel_schema as S
from podtpu_torch.export.protobuf import Fields, Message
from podtpu_torch.export.savedmodel_lower import (
    IR_TYPE,
    SIMPLE,
    graph_def,
    ir_type,
)
from podtpu_torch.export.tflite import TFLiteProgram, lower_model
from podtpu_torch.export.tflite_int8 import same_pads
from podtpu_torch.export.tflite_schema import NUMPY as IR_NUMPY
from podtpu_torch.export.tflite_schema import PADDING

META = "assets.extra/podtpu_torch.json"
PB = "saved_model.pb"
# TensorFlow functions: how podtpu's SavedModel holds its StableHLO
FUNCTION_OPS = {"XlaCallModule", "StatefulPartitionedCall",
                "PartitionedCall"}
UNPORTED_10D = (
    "a SavedModel of TensorFlow functions ({ops}) is not read here: "
    "podtpu's own export is one XlaCallModule of serialized StableHLO, "
    "which needs a StableHLO interpreter (ROADMAP.md queue 1, item 10d); "
    "export the model with podtpu_torch.export.savedmodel.export_savedmodel")


def export_savedmodel(model: torch.nn.Module, cfg: dict | None, input_shape,
                      path: str, with_postprocess: bool = False) -> str:
    """Write ``model`` (eval mode, weights frozen in) as a SavedModel
    directory ``path``: the forward, or with ``with_postprocess`` the
    serving unit of ``cfg`` (forward + decode + NMS). ``input_shape`` is
    the NHWC input with a static batch."""
    return write_savedmodel(lower_model(model, cfg, input_shape,
                                        with_postprocess, "SavedModel"), path)


def write_savedmodel(lowered, path: str) -> str:
    """Write the ``(subgraph, meta)`` of ``export/tflite.py::lower_model(
    ..., fmt="SavedModel")`` as a SavedModel directory ``path``."""
    b, meta = lowered
    gd, inputs, outputs, ops = graph_def(b)
    sig = Message()
    for key, info in inputs.items():
        sig.entry(S.SIGNATURE_DEF["inputs"], key, info)
    for key, info in outputs.items():
        sig.entry(S.SIGNATURE_DEF["outputs"], key, info)
    sig.bytes(S.SIGNATURE_DEF["method_name"], S.PREDICT_METHOD)
    mg = (Message()
          .message(S.META_GRAPH_DEF["meta_info_def"], Message().bytes(
              S.META_INFO_DEF["tags"], S.TAG_SERVE))
          .message(S.META_GRAPH_DEF["graph_def"], gd)
          .entry(S.META_GRAPH_DEF["signature_def"], S.SIGNATURE_KEY, sig))
    sm = (Message()
          .varint(S.SAVED_MODEL["saved_model_schema_version"],
                  S.SCHEMA_VERSION)
          .message(S.SAVED_MODEL["meta_graphs"], mg))
    if sm.size > S.MAX_MESSAGE_BYTES:
        raise ValueError(f"the SavedModel is {sm.size} bytes, over "
                         "protobuf's 2 GiB limit")
    os.makedirs(os.path.join(path, os.path.dirname(META)), exist_ok=True)
    with open(os.path.join(path, PB), "wb") as f:
        sm.write_to(f)
    meta = dict(meta, format="savedmodel", outputs=list(outputs),
                graph_ops=ops)
    with open(os.path.join(path, META), "w") as f:
        json.dump(meta, f)
    return path


# ---- the file ---------------------------------------------------------------

def _pb_path(path: str) -> str:
    return os.path.join(path, PB) if os.path.isdir(path) else path


def _shape(m: Fields | None) -> tuple:
    if m is None:
        return ()
    return tuple(d.int(S.DIM["size"]) for d in m.messages(
        S.TENSOR_SHAPE["dim"]))


def _dtype(code: int) -> str:
    name = S.DATA_TYPE_NAME.get(code)
    if name not in IR_TYPE:
        raise NotImplementedError(f"TF data type {code} is not read here "
                                  "(float32, int32 and bool are)")
    return IR_TYPE[name]


def _tensor_value(t: Fields) -> np.ndarray:
    """A ``TensorProto``'s array: a view of its ``tensor_content`` (how
    the port writes every constant)."""
    ttype = _dtype(t.int(S.TENSOR["dtype"]))
    shape = _shape(t.message(S.TENSOR["tensor_shape"]))
    if not t.has(S.TENSOR["tensor_content"]):
        raise NotImplementedError("a constant without tensor_content (the "
                                  "reader takes the SavedModels "
                                  "podtpu_torch writes)")
    return np.frombuffer(t.bytes(S.TENSOR["tensor_content"]), np.dtype(
        IR_NUMPY[ttype]).newbyteorder("<")).reshape(shape)


class _Node:
    __slots__ = ("name", "op", "inputs", "attr")

    def __init__(self, m: Fields):
        self.name = m.str(S.NODE_DEF["name"])
        self.op = m.str(S.NODE_DEF["op"])
        self.inputs = m.strs(S.NODE_DEF["input"])
        self.attr = m.map(S.NODE_DEF["attr"])

    def i(self, key: str, default: int = 0) -> int:
        a = self.attr.get(key)
        return default if a is None else a.int(S.ATTR_VALUE["i"])

    def ints(self, key: str) -> list[int]:
        a = self.attr.get(key)
        lst = None if a is None else a.message(S.ATTR_VALUE["list"])
        return [] if lst is None else lst.ints(S.LIST_VALUE["i"])

    def b(self, key: str, default: bool = False) -> bool:
        a = self.attr.get(key)
        return default if a is None else a.bool(S.ATTR_VALUE["b"])

    def f(self, key: str) -> float:
        return self.attr[key].float(S.ATTR_VALUE["f"])

    def s(self, key: str, default: str = "") -> str:
        a = self.attr.get(key)
        return default if a is None else a.str(S.ATTR_VALUE["s"])

    def type(self, key: str) -> str:
        return _dtype(self.attr[key].int(S.ATTR_VALUE["type"]))

    def shapes(self) -> list[tuple]:
        a = self.attr.get("_output_shapes")
        lst = None if a is None else a.message(S.ATTR_VALUE["list"])
        if lst is None:
            raise ValueError(
                f"node {self.name} ({self.op}) carries no _output_shapes: "
                "the reader takes the SavedModels podtpu_torch writes")
        return [_shape(s) for s in lst.messages(S.LIST_VALUE["shape"])]


def _out_types(n: _Node) -> list[str]:
    """The types of a node's outputs, read off its attributes."""
    if n.op in ("Placeholder", "Const"):
        return [n.type("dtype")]
    if n.op in ("Greater", "Less", "Equal", "LogicalAnd", "LogicalOr",
                "LogicalNot", "Any"):
        return ["BOOL"]
    if n.op == "Cast":
        return [n.type("DstT")]
    if n.op == "ArgMax":
        return [n.type("output_type")]
    if n.op == "GatherNd":
        return [n.type("Tparams")]
    if n.op == "TopKV2":
        return [n.type("T"), "INT32"]
    if n.op == "NonMaxSuppressionV5":
        return ["INT32", "FLOAT32", "INT32"]
    if n.op == "Unpack":
        return [n.type("T")] * n.i("num")
    return [n.type("T")]


def _order(nodes: list[_Node]) -> list[_Node]:
    """The nodes in an order where each comes after what it reads."""
    by_name = {n.name: n for n in nodes}
    done, out = set(), []
    for root in nodes:
        stack = [(root, False)]
        while stack:
            n, expanded = stack.pop()
            if n.name in done:
                continue
            if expanded:
                done.add(n.name)
                out.append(n)
                continue
            stack.append((n, True))
            for i in n.inputs:
                src = by_name.get(i.lstrip("^").split(":")[0])
                if src is None:
                    raise ValueError(f"node {n.name} reads {i}, which no "
                                     "node makes")
                if src.name not in done:
                    stack.append((src, False))
    return out


_REVERSE = {tf_op: name for name, (tf_op, _) in SIMPLE.items()}
_REVERSE.update({"Max": "REDUCE_MAX", "Any": "REDUCE_ANY",
                 "ArgMax": "ARG_MAX", "Cast": "CAST", "Pack": "PACK",
                 "Unpack": "UNPACK", "TopKV2": "TOPK_V2",
                 "GatherNd": "GATHER_ND", "LeakyRelu": "LEAKY_RELU",
                 "ResizeNearestNeighbor": "RESIZE_NEAREST_NEIGHBOR",
                 "StridedSlice": "STRIDED_SLICE"})


class SavedModelFile:
    """A parsed SavedModel, as the TFLite reader's file: ``tensors``
    ``(name, shape, type, data)`` (one a node's output), ``ops`` ``(name,
    inputs, outputs, options)`` in TFLite's operator names, the
    signature's ``inputs`` and ``outputs`` in order, and the ``meta`` the
    port wrote. ``graph_ops`` is the histogram of the file's TF
    operators, ``signature`` its ``serving_default``."""

    def __init__(self, buf, meta: dict | None = None):
        sm = Fields(buf)
        graphs = sm.messages(S.SAVED_MODEL["meta_graphs"])
        mg = next((g for g in graphs if S.TAG_SERVE in g.message(
            S.META_GRAPH_DEF["meta_info_def"]).strs(S.META_INFO_DEF["tags"])),
            None) if graphs else None
        if mg is None:
            raise ValueError("no MetaGraphDef tagged 'serve'")
        gd = mg.message(S.META_GRAPH_DEF["graph_def"])
        nodes = [_Node(m) for m in gd.messages(S.GRAPH_DEF["node"])]
        self.graph_ops = dict(collections.Counter(n.op for n in nodes))
        lib = gd.message(S.GRAPH_DEF["library"])
        if lib is not None:
            for fn in lib.messages(S.FUNCTION_DEF_LIBRARY["function"]):
                for m in fn.messages(S.FUNCTION_DEF["node_def"]):
                    op = m.str(S.NODE_DEF["op"])
                    self.graph_ops[op] = self.graph_ops.get(op, 0) + 1
        funcs = sorted(FUNCTION_OPS & set(self.graph_ops))
        if funcs:
            raise NotImplementedError(UNPORTED_10D.format(ops=", ".join(
                funcs)))
        sigs = mg.map(S.META_GRAPH_DEF["signature_def"])
        if S.SIGNATURE_KEY not in sigs:
            raise ValueError(f"no {S.SIGNATURE_KEY!r} signature")
        sig = sigs[S.SIGNATURE_KEY]
        self.signature = {
            side: {k: {"name": v.str(S.TENSOR_INFO["name"]),
                       "dtype": _dtype(v.int(S.TENSOR_INFO["dtype"])),
                       "shape": list(_shape(v.message(
                           S.TENSOR_INFO["tensor_shape"])))}
                   for k, v in sig.map(S.SIGNATURE_DEF[side]).items()}
            for side in ("inputs", "outputs")}
        self.meta = meta or {}
        self.tensors: list = []
        self.ops: list = []
        self._index: dict[str, int] = {}
        self._read(_order(nodes))
        self.inputs = [self._tensor(v["name"]) for v in
                       self.signature["inputs"].values()]
        keys = sorted(self.signature["outputs"], key=_output_rank)
        self.outputs = [self._tensor(self.signature["outputs"][k]["name"])
                        for k in keys]
        for t, key in zip(self.outputs, keys):
            _, shape, ttype, data = self.tensors[t]
            self.tensors[t] = (key, shape, ttype, data)

    def _tensor(self, name: str) -> int:
        name = name if ":" in name else name + ":0"
        if name not in self._index:
            raise ValueError(f"tensor {name} is made by no node")
        return self._index[name]

    def _new(self, name, shape, ttype, data=None) -> int:
        self.tensors.append((name, tuple(shape), ttype, data))
        self._index[name] = len(self.tensors) - 1
        return len(self.tensors) - 1

    def _const(self, data: np.ndarray) -> int:
        return self._new(f"const{len(self.tensors)}:0", data.shape,
                         ir_type(data), data)

    def value(self, name: str) -> np.ndarray:
        data = self.tensors[self._tensor(name)][3]
        if data is None:
            raise ValueError(f"{name} must be a constant here")
        return data

    def _read(self, nodes: list[_Node]):
        users = collections.Counter(i.split(":")[0] for n in nodes
                                    for i in n.inputs)
        for n in nodes:
            ins = [i for i in n.inputs if not i.startswith("^")]
            if n.op == "Identity":
                self._index[n.name + ":0"] = self._tensor(ins[0])
                continue
            if n.op == "Const":
                t = n.attr["value"].message(S.ATTR_VALUE["tensor"])
                data = _tensor_value(t)
                self._new(n.name + ":0", data.shape, _out_types(n)[0], data)
                continue
            types = _out_types(n)
            shapes = n.shapes()
            outs = [self._new(f"{n.name}:{i}", s, tt)
                    for i, (s, tt) in enumerate(zip(shapes, types))]
            if n.op == "Placeholder":
                continue
            if n.op == "BiasAdd" and self._join_bias(n, ins, outs, users):
                continue
            name, args, opts = self._translate(n, ins)
            self.ops.append((name, args, outs, opts))

    def _join_bias(self, n, ins, outs, users) -> bool:
        """A ``BiasAdd`` of a constant on the only reader of a
        ``CONV_2D`` or ``FULLY_CONNECTED`` output becomes that operator's
        bias."""
        src = self._tensor(ins[0])
        last = self.ops[-1] if self.ops else None
        bias = self.tensors[self._tensor(ins[1])][3]
        if (last is None or last[0] not in ("CONV_2D", "FULLY_CONNECTED")
                or last[2] != [src] or last[1][2] != -1 or bias is None
                or users[ins[0].split(":")[0]] != 1):
            return False
        last[1][2] = self._tensor(ins[1])
        self._index[n.name + ":0"] = src
        self.tensors.pop(outs[0])
        return True

    def _explicit(self, x: int, p: list[int], k, s, d):
        """A ``Conv2D``'s explicit pads as the TFLite file has them:
        ``SAME`` where they are its pads, else a ``PAD`` before a
        ``VALID`` convolution (``export/tflite_lower.py``), so that the
        two readers run one model alike. Returns the input and padding."""
        _, h, w, c = self.tensors[x][1]
        pads = tuple(p[2:6])
        if pads == same_pads(h, k[0], s[1], d[1]) + same_pads(
                w, k[1], s[2], d[2]):
            return x, "SAME"
        if not any(pads):
            return x, "VALID"
        shape = (self.tensors[x][1][0], h + pads[0] + pads[1],
                 w + pads[2] + pads[3], c)
        out = self._new(f"pad{len(self.tensors)}:0", shape,
                        self.tensors[x][2])
        self.ops.append(("PAD", [x, self._const(np.array(
            [[0, 0], pads[:2], pads[2:], [0, 0]], np.int32))], [out], {}))
        return out, "VALID"

    def _translate(self, n: _Node, ins: list[str]):
        """The TFLite operator, inputs and options of TF node ``n``."""
        op = n.op
        args = [self._tensor(i) for i in ins]
        if op == "Conv2D":
            if n.s("data_format", "NHWC") != "NHWC":
                raise NotImplementedError("a Conv2D other than NHWC")
            hwio = self.value(ins[1])
            filt = self._const(hwio.transpose(3, 0, 1, 2))
            s, d = n.ints("strides"), n.ints("dilations") or [1, 1, 1, 1]
            padding = n.s("padding")
            x = args[0]
            if padding == "EXPLICIT":
                x, padding = self._explicit(x, n.ints("explicit_paddings"),
                                            hwio.shape[:2], s, d)
            return "CONV_2D", [x, filt, -1], {
                "stride_h": s[1], "stride_w": s[2], "dilation_h_factor": d[1],
                "dilation_w_factor": d[2], "fused_activation_function": 0,
                "padding": PADDING[padding]}
        if op == "MatMul":
            if n.b("transpose_a"):
                raise NotImplementedError("a MatMul with transpose_a")
            w = self.value(ins[1])
            w = self._const(w if n.b("transpose_b") else w.T)
            return "FULLY_CONNECTED", [args[0], w, -1], {
                "fused_activation_function": 0, "weights_format": 0,
                "keep_num_dims": False}
        if op == "BiasAdd":
            return "ADD", args, {}
        if op == "MaxPool":
            k, s = n.ints("ksize"), n.ints("strides")
            if n.s("data_format", "NHWC") != "NHWC" or n.s("padding") not in (
                    "SAME", "VALID"):
                raise NotImplementedError("a MaxPool other than NHWC, "
                                          "SAME or VALID")
            return "MAX_POOL_2D", args, {
                "filter_height": k[1], "filter_width": k[2],
                "stride_h": s[1], "stride_w": s[2],
                "padding": PADDING[n.s("padding")],
                "fused_activation_function": 0}
        if op == "ConcatV2":
            rank = len(self.tensors[args[0]][1])
            axis = int(self.value(ins[-1]).reshape(()))
            return "CONCATENATION", args[:-1], {
                "axis": axis + rank if axis < 0 else axis,
                "fused_activation_function": 0}
        if op == "NonMaxSuppressionV5":
            if not n.b("pad_to_max_output_size"):
                raise NotImplementedError("NonMaxSuppressionV5 without "
                                          "pad_to_max_output_size")
            return "NON_MAX_SUPPRESSION_V5", args, {"strict": True}
        name = _REVERSE.get(op)
        if name is None:
            raise NotImplementedError(
                f"TF operator {op} (node {n.name}) is not read here "
                "(podtpu_torch/export/savedmodel.py)")
        opts = {}
        if name == "LEAKY_RELU":
            opts = {"alpha": n.f("alpha")}
        elif name == "RESIZE_NEAREST_NEIGHBOR":
            opts = {"align_corners": n.b("align_corners"),
                    "half_pixel_centers": n.b("half_pixel_centers")}
        elif name == "STRIDED_SLICE":
            opts = {k: n.i(k) for k in ("begin_mask", "end_mask",
                                        "ellipsis_mask", "new_axis_mask",
                                        "shrink_axis_mask")}
            opts["offset"] = False
        elif name in ("PACK", "UNPACK"):
            opts = {"axis": n.i("axis"), "num": n.i("num"),
                    "values_count": len(args)}
        elif name in ("REDUCE_MAX", "REDUCE_ANY"):
            opts = {"keep_dims": n.b("keep_dims")}
        elif name == "TOPK_V2" and not n.b("sorted", True):
            raise NotImplementedError("TopKV2 with sorted=False")
        return name, args, opts

    def spec(self, t: int) -> str:
        _, shape, ttype, _ = self.tensors[t]
        return f"{IR_NUMPY[ttype]}[{','.join(str(d) for d in shape)}]"


def _output_rank(key: str):
    head, _, tail = key.rpartition("_")
    return (head, int(tail)) if tail.isdigit() else (key, -1)


def read_savedmodel(path: str) -> SavedModelFile:
    """Parse the SavedModel at ``path`` (its directory, or its
    ``saved_model.pb``)."""
    with open(_pb_path(path), "rb") as f:
        buf = f.read()
    root = path if os.path.isdir(path) else os.path.dirname(path)
    meta = None
    if os.path.exists(os.path.join(root, META)):
        with open(os.path.join(root, META)) as f:
            meta = json.load(f)
    return SavedModelFile(buf, meta)


def inspect_savedmodel(path: str) -> dict:
    """The TF operators, the ``serving_default`` signature, the file's MB
    and the port's metadata of a SavedModel
    (``export/tflite.py::inspect_tflite`` for ``.tflite``)."""
    f = read_savedmodel(path)
    info = {"ops": dict(sorted(f.graph_ops.items(), key=lambda kv: -kv[1])),
            "signature": f.signature,
            "in_specs": [f.spec(t) for t in f.inputs],
            "out_specs": [f.spec(t) for t in f.outputs],
            "out_names": [f.tensors[t][0] for t in f.outputs],
            "MB": os.path.getsize(_pb_path(path)) / 2**20}
    info.update(f.meta)
    return info


def load_savedmodel(path: str, device="cuda") -> TFLiteProgram:
    """The port's reader of a SavedModel it wrote: the file parsed, its
    constants uploaded to ``device`` once, and a callable that runs its
    operators there with torch (the suppression through
    ``greedy_suppress``, one launch a call); returns the outputs in the
    signature's order. Runs under ``torch.inference_mode``. Refuses
    ``podtpu``'s own SavedModel (item 10d)."""
    return TFLiteProgram(read_savedmodel(path), device)
