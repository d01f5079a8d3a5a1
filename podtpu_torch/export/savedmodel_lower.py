"""Lower a ``torch.export`` program to a TF ``GraphDef`` of raw operators.

The ATen walk is ``export/tflite_lower.py``'s, run with
``fmt="SavedModel"``: constant evaluation, the ``nhwc`` layout tags, BN
folded into the filters (``fold_affine``), ``sort`` + slice as a top-k,
one suppression an image. :func:`graph_def` turns the subgraph it gives,
operator by operator, into ``NodeDef`` messages (``export/protobuf.py``,
field numbers from ``export/savedmodel_schema.py``), its weights frozen
as ``Const`` nodes:

* **NHWC and HWIO.** TF's CPU ``Conv2D`` takes no NCHW: activations stay
  NHWC as in the TFLite subgraph, and each OHWI filter is written HWIO.
* **Convolutions** are ``Conv2D`` with ``EXPLICIT`` padding (torch's
  symmetric pads, a ``PAD`` before the convolution merged in) and a
  ``BiasAdd`` of the folded bias.
* **Every floating tensor is float32** (the TFLite subgraph's rule: TF's
  CPU kernels lack bfloat16 for several of these operators).
* **Suppression** is one ``NonMaxSuppressionV5`` an image with
  ``pad_to_max_output_size``, at the port's threshold (TF suppresses at
  ``iou > t``, as the port).
* Every node carries ``_output_shapes``, the static shape of each output
  (attributes starting with ``_`` are TF's own annotations, which its
  loader keeps and its kernels ignore); the port's reader reads them.

The model's outputs are ``Identity`` nodes ``output_0`` ... in order.
"""

from __future__ import annotations

import numpy as np

from podtpu_torch.export import savedmodel_schema as S
from podtpu_torch.export.protobuf import Message
from podtpu_torch.export.tflite_int8 import same_pads

DTYPE = {"FLOAT32": "DT_FLOAT", "INT32": "DT_INT32", "BOOL": "DT_BOOL"}
IR_TYPE = {v: k for k, v in DTYPE.items()}


def ir_type(arr: np.ndarray) -> str:
    """The subgraph's type name of a constant array."""
    return {np.float32: "FLOAT32", np.int32: "INT32",
            np.bool_: "BOOL"}[arr.dtype.type]

# the subgraph's operators that are one TF operator of the same inputs,
# with attribute T the type of input ``T`` (None: no T)
SIMPLE = {"ADD": ("AddV2", 0), "SUB": ("Sub", 0), "MUL": ("Mul", 0),
          "DIV": ("RealDiv", 0), "MAXIMUM": ("Maximum", 0),
          "MINIMUM": ("Minimum", 0), "GREATER": ("Greater", 0),
          "LESS": ("Less", 0), "EQUAL": ("Equal", 0),
          "LOGICAL_AND": ("LogicalAnd", None),
          "LOGICAL_OR": ("LogicalOr", None),
          "LOGICAL_NOT": ("LogicalNot", None), "RELU": ("Relu", 0),
          "LOGISTIC": ("Sigmoid", 0), "TANH": ("Tanh", 0),
          "EXP": ("Exp", 0), "LOG": ("Log", 0), "ABS": ("Abs", 0),
          "SELECT_V2": ("SelectV2", 1), "RESHAPE": ("Reshape", 0),
          "TRANSPOSE": ("Transpose", 0), "BROADCAST_TO": ("BroadcastTo", 0),
          "PAD": ("Pad", 0), "PADV2": ("PadV2", 0)}


# ---- messages ---------------------------------------------------------------

def shape_proto(shape) -> Message:
    m = Message()
    for d in shape:
        m.message(S.TENSOR_SHAPE["dim"], Message().varint(S.DIM["size"], d))
    return m


def tensor_proto(arr: np.ndarray) -> Message:
    """A ``TensorProto`` holding ``arr`` as ``tensor_content`` (its buffer
    taken as it is)."""
    return (Message()
            .varint(S.TENSOR["dtype"], S.DATA_TYPE[DTYPE[ir_type(arr)]])
            .message(S.TENSOR["tensor_shape"], shape_proto(arr.shape))
            .bytes(S.TENSOR["tensor_content"],
                   np.ascontiguousarray(arr, arr.dtype.newbyteorder("<"))))


def a_type(ttype: str) -> Message:
    return Message().varint(S.ATTR_VALUE["type"],
                            S.DATA_TYPE[DTYPE[ttype]])


def a_int(i: int) -> Message:
    return Message().varint(S.ATTR_VALUE["i"], i)


def a_ints(values) -> Message:
    return Message().message(S.ATTR_VALUE["list"], Message().packed(
        S.LIST_VALUE["i"], values))


def a_float(f: float) -> Message:
    return Message().float(S.ATTR_VALUE["f"], f)


def a_bool(b: bool) -> Message:
    return Message().bool(S.ATTR_VALUE["b"], b)


def a_str(s: str) -> Message:
    return Message().bytes(S.ATTR_VALUE["s"], s)


def a_shapes(shapes) -> Message:
    lst = Message()
    for shape in shapes:
        lst.message(S.LIST_VALUE["shape"], shape_proto(shape))
    return Message().message(S.ATTR_VALUE["list"], lst)


def tensor_info(name: str, ttype: str, shape) -> Message:
    return (Message().bytes(S.TENSOR_INFO["name"], name)
            .varint(S.TENSOR_INFO["dtype"], S.DATA_TYPE[DTYPE[ttype]])
            .message(S.TENSOR_INFO["tensor_shape"], shape_proto(shape)))


# ---- the graph --------------------------------------------------------------

class _Graph:
    """The ``NodeDef`` messages of one subgraph, as they are made."""

    def __init__(self, b):
        self.b = b
        self.nodes: list[Message] = []
        self.ops: dict[str, int] = {}
        self.names: dict[int, str] = {}  # subgraph tensor -> TF tensor name

    def node(self, op: str, inputs, attrs: dict, shapes,
             name: str | None = None) -> str:
        """Append node ``op``; ``shapes`` are its outputs' static shapes.
        Returns its name."""
        if name is None:
            name = f"{op}_{len(self.nodes)}"
        m = Message().bytes(S.NODE_DEF["name"], name).bytes(
            S.NODE_DEF["op"], op)
        for i in inputs:
            m.bytes(S.NODE_DEF["input"], i)
        for key, value in dict(attrs, _output_shapes=a_shapes(shapes)).items():
            m.entry(S.NODE_DEF["attr"], key, value)
        self.nodes.append(m)
        self.ops[op] = self.ops.get(op, 0) + 1
        return name

    def const(self, arr: np.ndarray) -> str:
        """A ``Const`` node of ``arr``."""
        arr = np.asarray(arr)
        return self.node("Const", [], {
            "dtype": a_type(ir_type(arr)), "value": Message().message(
                S.ATTR_VALUE["tensor"], tensor_proto(arr))}, [arr.shape])

    def tensor(self, t: int) -> str:
        """The TF name of subgraph tensor ``t`` (a constant's node made at
        its first use)."""
        if t not in self.names:
            value = self.b.value(t)
            if value is None:
                raise ValueError(f"tensor {t} ({self.b.tensors[t][3]}) is "
                                 "read before it is made")
            self.names[t] = self.const(value)
        return self.names[t]

    def shape(self, t: int):
        return self.b.tensors[t][0]

    def ttype(self, t: int) -> str:
        return self.b.tensors[t][1]


def _users(b) -> dict[int, int]:
    n: dict[int, int] = {}
    for _, ins, _, _ in b.ops:
        for t in ins:
            n[t] = n.get(t, 0) + 1
    for t in b.outputs:
        n[t] = n.get(t, 0) + 1
    return n


def _no_activation(name, o):
    if o.get("fused_activation_function", 0):
        raise NotImplementedError(f"{name} with a fused activation")


def graph_def(b) -> tuple[Message, dict, dict, dict]:
    """The ``GraphDef`` of the float32 subgraph ``b`` (the one
    ``lower_program(ep, family, "SavedModel")`` gives), its inputs
    ``{name: TensorInfo}`` and outputs ``{"output_i": TensorInfo}`` for
    the signature, and a histogram of its operators. An operator of the
    subgraph with no TF counterpart here raises ``NotImplementedError``
    naming it."""
    g = _Graph(b)
    users = _users(b)
    producer = {t: op for op in b.ops for t in op[2]}
    inputs = {}
    for t in b.inputs:
        shape, ttype, _, name = b.tensors[t]
        g.names[t] = g.node("Placeholder", [], {
            "dtype": a_type(ttype), "shape": Message().message(
                S.ATTR_VALUE["shape"], shape_proto(shape))}, [shape],
            name=name)
        inputs[name] = tensor_info(f"{name}:0", ttype, shape)
    merged = set()  # PAD operators folded into the convolution after them
    for op in b.ops:
        name, ins, outs, o = op
        if name == "PAD" and users.get(outs[0]) == 1:
            nxt = [c for c in b.ops if outs[0] in c[1]]
            p = b.value(ins[1])
            if nxt[0][0] == "CONV_2D" and nxt[0][1][0] == outs[0] and \
                    p is not None and not p[[0, 3]].any():
                merged.add(id(op))
                continue
        _emit(g, name, ins, outs, o, producer, merged)
    outputs = {}
    for i, t in enumerate(b.outputs):
        key = f"output_{i}"
        g.node("Identity", [g.tensor(t)], {"T": a_type(g.ttype(t))},
               [g.shape(t)], name=key)
        outputs[key] = tensor_info(f"{key}:0", g.ttype(t), g.shape(t))
    gd = Message()
    for m in g.nodes:
        gd.message(S.GRAPH_DEF["node"], m)
    gd.message(S.GRAPH_DEF["versions"], Message()
               .varint(S.VERSION_DEF["producer"], S.GRAPH_DEF_VERSION)
               .varint(S.VERSION_DEF["min_consumer"],
                       S.GRAPH_DEF_MIN_CONSUMER))
    return gd, inputs, outputs, dict(g.ops)


def _emit(g: _Graph, name, ins, outs, o, producer, merged):
    b = g.b
    shapes = [g.shape(t) for t in outs]
    T = {"T": a_type(g.ttype(ins[0]))} if ins else {}
    if name in SIMPLE:
        tf_op, src = SIMPLE[name]
        _no_activation(name, o)
        attrs = {} if src is None else {"T": a_type(g.ttype(ins[src]))}
        if name in ("RESHAPE", "TRANSPOSE", "BROADCAST_TO", "PAD", "PADV2"):
            idx = {"RESHAPE": "Tshape", "TRANSPOSE": "Tperm",
                   "BROADCAST_TO": "Tidx"}.get(name, "Tpaddings")
            attrs[idx] = a_type("INT32")
        g.names[outs[0]] = g.node(tf_op, [g.tensor(t) for t in ins], attrs,
                                  shapes)
    elif name == "CONV_2D":
        _conv(g, ins, outs, o, producer, merged)
    elif name == "FULLY_CONNECTED":
        _no_activation(name, o)
        x, w = ins[0], b.value(ins[1])
        out_shape = g.shape(outs[0])
        src = g.tensor(x)
        if len(g.shape(x)) != 2:
            rows = int(np.prod(g.shape(x))) // w.shape[1]
            src = g.node("Reshape", [src, g.const(np.array(
                [rows, w.shape[1]], np.int32))], dict(T, Tshape=a_type(
                    "INT32")), [(rows, w.shape[1])])
        rows = int(np.prod(out_shape)) // w.shape[0]
        y = g.node("MatMul", [src, g.tensor(ins[1])], dict(
            T, transpose_a=a_bool(False), transpose_b=a_bool(True)),
            [(rows, w.shape[0])])
        if len(ins) > 2 and ins[2] >= 0:
            y = g.node("BiasAdd", [y, g.tensor(ins[2])], T,
                       [(rows, w.shape[0])])
        if tuple(out_shape) != (rows, w.shape[0]):
            y = g.node("Reshape", [y, g.const(np.array(out_shape, np.int32))],
                       dict(T, Tshape=a_type("INT32")), [out_shape])
        g.names[outs[0]] = y
    elif name == "LEAKY_RELU":
        g.names[outs[0]] = g.node("LeakyRelu", [g.tensor(ins[0])], dict(
            T, alpha=a_float(o["alpha"])), shapes)
    elif name == "CAST":
        g.names[outs[0]] = g.node("Cast", [g.tensor(ins[0])], {
            "SrcT": a_type(g.ttype(ins[0])), "DstT": a_type(g.ttype(outs[0])),
            "Truncate": a_bool(False)}, shapes)
    elif name == "MAX_POOL_2D":
        _no_activation(name, o)
        g.names[outs[0]] = g.node("MaxPool", [g.tensor(ins[0])], dict(
            T, ksize=a_ints([1, o["filter_height"], o["filter_width"], 1]),
            strides=a_ints([1, o["stride_h"], o["stride_w"], 1]),
            padding=a_str("SAME" if o["padding"] == 0 else "VALID"),
            data_format=a_str("NHWC")), shapes)
    elif name == "RESIZE_NEAREST_NEIGHBOR":
        g.names[outs[0]] = g.node("ResizeNearestNeighbor", [
            g.tensor(t) for t in ins], dict(
                T, align_corners=a_bool(o["align_corners"]),
                half_pixel_centers=a_bool(o["half_pixel_centers"])), shapes)
    elif name == "CONCATENATION":
        _no_activation(name, o)
        if len(ins) == 1:
            g.names[outs[0]] = g.node("Identity", [g.tensor(ins[0])], T,
                                      shapes)
            return
        g.names[outs[0]] = g.node("ConcatV2", [g.tensor(t) for t in ins] + [
            g.const(np.int32(o["axis"]))], dict(
                T, N=a_int(len(ins)), Tidx=a_type("INT32")), shapes)
    elif name == "STRIDED_SLICE":
        if o.get("offset"):
            raise NotImplementedError("STRIDED_SLICE with offset")
        g.names[outs[0]] = g.node("StridedSlice", [g.tensor(t) for t in ins],
                                  dict(T, Index=a_type("INT32"), **{
                                      k: a_int(o[k]) for k in (
                                          "begin_mask", "end_mask",
                                          "ellipsis_mask", "new_axis_mask",
                                          "shrink_axis_mask")}), shapes)
    elif name == "PACK":
        g.names[outs[0]] = g.node("Pack", [g.tensor(t) for t in ins], dict(
            T, N=a_int(len(ins)), axis=a_int(o["axis"])), shapes)
    elif name == "UNPACK":
        node = g.node("Unpack", [g.tensor(ins[0])], dict(
            T, num=a_int(o["num"]), axis=a_int(o["axis"])), shapes)
        for i, t in enumerate(outs):
            g.names[t] = f"{node}:{i}"
    elif name == "ARG_MAX":
        # TF's dimension is a scalar, TFLite's a [1] vector
        axis = g.const(np.int32(b.value(ins[1]).reshape(-1)[0]))
        g.names[outs[0]] = g.node("ArgMax", [g.tensor(ins[0]), axis], dict(
            T, Tidx=a_type("INT32"), output_type=a_type(g.ttype(outs[0]))),
            shapes)
    elif name in ("REDUCE_MAX", "REDUCE_ANY"):
        attrs = {"Tidx": a_type("INT32"), "keep_dims": a_bool(o["keep_dims"])}
        if name == "REDUCE_MAX":
            attrs.update(T)
        g.names[outs[0]] = g.node("Max" if name == "REDUCE_MAX" else "Any",
                                  [g.tensor(t) for t in ins], attrs, shapes)
    elif name == "TOPK_V2":
        node = g.node("TopKV2", [g.tensor(t) for t in ins], dict(
            T, sorted=a_bool(True)), shapes)
        g.names[outs[0]], g.names[outs[1]] = f"{node}:0", f"{node}:1"
    elif name == "GATHER_ND":
        g.names[outs[0]] = g.node("GatherNd", [g.tensor(t) for t in ins], {
            "Tparams": a_type(g.ttype(ins[0])),
            "Tindices": a_type(g.ttype(ins[1]))}, shapes)
    elif name == "NON_MAX_SUPPRESSION_V5":
        node = g.node("NonMaxSuppressionV5", [g.tensor(t) for t in ins], {
            "T": a_type("FLOAT32"), "pad_to_max_output_size": a_bool(True)},
            shapes)
        for i, t in enumerate(outs):
            g.names[t] = f"{node}:{i}"
    else:
        raise NotImplementedError(
            f"the subgraph's operator {name} has no TF counterpart "
            "(podtpu_torch/export/savedmodel_lower.py)")


def _conv(g: _Graph, ins, outs, o, producer, merged):
    """``Conv2D`` (``EXPLICIT`` pads: the ``SAME`` ones computed, a merged
    ``PAD``'s added) and a ``BiasAdd``."""
    _no_activation("CONV_2D", o)
    b = g.b
    x = ins[0]
    w = b.value(ins[1])  # OHWI
    if w is None:
        raise NotImplementedError("CONV_2D with a computed filter")
    _, h, wd, _ = g.shape(x)
    _, kh, kw, _ = w.shape
    sh, sw = o["stride_h"], o["stride_w"]
    dh, dw = o["dilation_h_factor"], o["dilation_w_factor"]
    pads = [0, 0, 0, 0]
    if o["padding"] == 0:  # SAME
        pads = list(same_pads(h, kh, sh, dh) + same_pads(wd, kw, sw, dw))
    pad = producer.get(x)
    if pad is not None and id(pad) in merged:
        p = b.value(pad[1][1])
        pads = [pads[0] + int(p[1, 0]), pads[1] + int(p[1, 1]),
                pads[2] + int(p[2, 0]), pads[3] + int(p[2, 1])]
        x = pad[1][0]
    hwio = np.ascontiguousarray(w.transpose(1, 2, 3, 0))
    attrs = {"T": a_type("FLOAT32"), "strides": a_ints([1, sh, sw, 1]),
             "dilations": a_ints([1, dh, dw, 1]),
             "data_format": a_str("NHWC")}
    if any(pads):
        attrs["padding"] = a_str("EXPLICIT")
        attrs["explicit_paddings"] = a_ints([0, 0] + pads + [0, 0])
    else:
        attrs["padding"] = a_str("VALID")
    shape = g.shape(outs[0])
    y = g.node("Conv2D", [g.tensor(x), g.const(hwio)], attrs, [shape])
    if len(ins) > 2 and ins[2] >= 0:
        y = g.node("BiasAdd", [y, g.tensor(ins[2])], {
            "T": a_type("FLOAT32"), "data_format": a_str("NHWC")}, [shape])
    g.names[outs[0]] = y
