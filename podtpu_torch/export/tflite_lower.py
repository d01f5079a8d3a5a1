"""Lower a ``torch.export`` program to a TFLite subgraph.

The program is the ATen graph of ``export/program.py::export_forward`` or
``export_serving`` with the weights frozen in. :func:`lower_program` walks
its nodes in order and gives each one of three things: a constant (a node
whose inputs are all constants is evaluated with torch here, on the host:
the anchor grids, the ``rsqrt(var + eps) * gamma`` of BN, every dtype cast
of a weight), a :class:`Dyn` (a TFLite tensor), or a tuple of them. An
ATen target outside :data:`HANDLERS` raises ``NotImplementedError`` naming
it and the model family.

* **float32.** TFLite has no bfloat16 kernels: every floating tensor of
  the file is float32, and a cast of a weight to bfloat16 or float16 is
  folded as a cast to float32, so a bf16 config exports the float32
  graph of its weights. Integer tensors are int32, masks bool.
* **Layout.** The models take NHWC and permute to NCHW at once; TFLite's
  convolutions want NHWC activations and OHWI filters. A 4-D tensor may
  carry the tag ``nhwc``: its logical shape is torch's NCHW, its TFLite
  tensor holds it NHWC. The model's first ``permute(0, 3, 1, 2)`` only
  sets the tag, the heads' ``permute(0, 2, 3, 1)`` only clears it;
  elementwise ops take per-channel constants permuted to match; any other
  ``reshape``, ``permute``, ``select`` or ``stack`` of a tagged tensor
  first gets an explicit ``TRANSPOSE`` back to NCHW order.
* **Convolutions.** torch pads symmetrically; TFLite's ``SAME`` puts the
  odd pixel after. A stride-1 convolution with ``2p = d (k - 1)`` is
  ``SAME``; any other padded one gets a ``PAD`` and runs ``VALID``.
  :func:`fold_affine` then folds a per-channel ``MUL`` / ``ADD`` that
  follows a convolution (the BN epilogue of every ``ConvBnAct``) into its
  filter and bias.
* **mish** has no builtin: ``x * tanh(log(1 + exp(x)))``. For large x,
  ``exp`` overflows to inf and ``tanh(inf) = 1`` gives ``x``, which is
  right; for x below about -88, ``exp`` gives 0 and the result 0, where
  mish is below 1e-36 in magnitude.
* **Selection.** ``sort(stable, descending)`` whose outputs are only
  sliced to ``[..., :k]`` becomes ``TOPK_V2`` with that k (with the whole
  length otherwise): ties keep the lower index, as the port's ``_top``.
* **Suppression.** The ``podtpu_torch.greedy_suppress`` node becomes one
  ``NON_MAX_SUPPRESSION_V5`` an image, unrolled over the static batch:
  scores ``where(valid, K - index, -1)`` (so the op's score order is the
  index order and its ``score_threshold`` of 0 drops exactly the invalid
  candidates), ``max_output_size`` K, ``soft_nms_sigma`` 0. TFLite
  suppresses at ``iou >= t`` and the port at ``iou > thr``: ``t`` is the
  float32 after ``thr``. The selected indices become the keep mask
  ``[B, K]`` (``EQUAL`` against a range, masked by the count,
  ``REDUCE_ANY``). Boxes of no area bypass the op (TFLite selects such a
  box twice; the port keeps it and it suppresses nothing). What still
  differs from the port is written down in ``export/tflite.py``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.fx.node import map_aggregate

from podtpu_torch.export import flatbuf
from podtpu_torch.export import tflite_schema as S
from podtpu_torch.export.program import op_name

_FLOATS = (torch.float16, torch.bfloat16, torch.float32, torch.float64)
_INTS = (torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8)
NP_TYPE = {"FLOAT32": np.float32, "INT32": np.int32, "BOOL": np.bool_,
           "INT8": np.int8}

# a logical NCHW axis -> its place in the NHWC tensor
_PHYS_AXIS = (0, 3, 1, 2)


def tf_type(dtype: torch.dtype) -> str:
    """The TensorType a torch dtype is written as."""
    if dtype in _FLOATS:
        return "FLOAT32"
    if dtype in _INTS:
        return "INT32"
    if dtype == torch.bool:
        return "BOOL"
    raise NotImplementedError(f"no TFLite tensor type for {dtype}")


def _np_const(value, ttype: str | None = None) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        if ttype is None:
            ttype = tf_type(value.dtype)
        value = value.detach().cpu()
        if value.dtype in _FLOATS:
            value = value.float()
        value = value.numpy()
    arr = np.asarray(value)
    if ttype is None:
        ttype = ("BOOL" if arr.dtype == np.bool_ else "INT32"
                 if np.issubdtype(arr.dtype, np.integer) else "FLOAT32")
    return np.array(arr, dtype=NP_TYPE[ttype], order="C")


class Builder:
    """One TFLite subgraph and its buffers, as it is lowered: tensors
    ``[shape, type, buffer, name]`` (buffer 0 is the empty sentinel),
    operators ``[name, inputs, outputs, options]``. An int8 or int32
    tensor of a quantized file has its affine parameters in :attr:`quant`
    (``(scale float32 [n], zero_point int64 [n], quantized_dimension)``,
    n = 1 per tensor or the channel count), and an operator that runs on
    such tensors its version in :attr:`versions` (the file's version of an
    operator code is the largest one asked)."""

    def __init__(self):
        self.tensors: list[list] = []
        self.buffers: list[np.ndarray | None] = [None]
        self.ops: list[list] = []
        self.inputs: list[int] = []
        self.outputs: list[int] = []
        self.quant: dict[int, tuple] = {}
        self.versions: dict[str, int] = {}
        self._small: dict = {}

    def tensor(self, shape, ttype: str, name: str | None = None,
               buffer: int = 0, quant: tuple | None = None) -> int:
        self.tensors.append([tuple(int(d) for d in shape), ttype, buffer,
                             name or f"t{len(self.tensors)}"])
        if quant is not None:
            self.quant[len(self.tensors) - 1] = quant
        return len(self.tensors) - 1

    def const(self, value, ttype: str | None = None,
              name: str | None = None, quant: tuple | None = None) -> int:
        """A constant tensor; small ones are shared by value."""
        arr = _np_const(value, ttype)
        ttype = {np.float32: "FLOAT32", np.int32: "INT32",
                 np.bool_: "BOOL", np.int8: "INT8"}[arr.dtype.type]
        key = None
        if arr.size <= 64:
            key = (ttype, arr.shape, arr.tobytes(), None if quant is None
                   else tuple(np.asarray(q).tobytes() for q in quant))
            if key in self._small:
                return self._small[key]
        self.buffers.append(arr)
        t = self.tensor(arr.shape, ttype, name or f"const{len(self.buffers)}",
                        len(self.buffers) - 1, quant)
        if key is not None:
            self._small[key] = t
        return t

    def value(self, t: int) -> np.ndarray | None:
        """The constant data of tensor ``t`` (None for a computed one)."""
        shape, _, buf, _ = self.tensors[t]
        return None if buf == 0 else self.buffers[buf].reshape(shape)

    def op(self, name: str, inputs, outs, **options) -> list[int]:
        """Append operator ``name``; ``outs`` are ``(shape, type)`` of its
        outputs. Returns the output tensors."""
        idx = [self.tensor(s, t) for s, t in outs]
        self.ops.append([name, [int(i) for i in inputs], idx, options])
        return idx

    # -- passes -----------------------------------------------------------

    def _users(self) -> dict[int, list[int]]:
        users: dict[int, list[int]] = {}
        for i, (_, ins, _, _) in enumerate(self.ops):
            for t in ins:
                users.setdefault(t, []).append(i)
        return users

    def prune(self):
        """Drop operators no output depends on, then every tensor and
        buffer nothing refers to."""
        live = set(self.outputs)
        keep = []
        for op in reversed(self.ops):
            if any(t in live for t in op[2]):
                keep.append(op)
                live.update(op[1])
        self.ops = keep[::-1]
        used = sorted(set(self.inputs) | set(self.outputs) | {
            t for op in self.ops for t in op[1] + op[2] if t >= 0})
        remap = {t: i for i, t in enumerate(used)}
        bufs = [None]
        tensors = []
        for t in used:
            shape, ttype, buf, name = self.tensors[t]
            if buf:
                bufs.append(self.buffers[buf])
                buf = len(bufs) - 1
            tensors.append([shape, ttype, buf, name])
        self.tensors, self.buffers = tensors, bufs
        self.quant = {remap[t]: q for t, q in self.quant.items()
                      if t in remap}
        self._small = {}
        for op in self.ops:
            op[1] = [remap[t] if t >= 0 else t for t in op[1]]
            op[2] = [remap[t] for t in op[2]]
        self.inputs = [remap[t] for t in self.inputs]
        self.outputs = [remap[t] for t in self.outputs]

    def serialize(self, description: str = "",
                  metadata: dict[str, bytes] | None = None) -> bytearray:
        """The ``.tflite`` flatbuffer of this subgraph."""
        F = flatbuf
        names = sorted({op[0] for op in self.ops}, key=S.BUILTIN.get)
        code_index = {n: i for i, n in enumerate(names)}
        codes = [F.Table({
            S.OPERATOR_CODE["deprecated_builtin_code"]: F.Scalar(
                "int8", min(S.BUILTIN[n], S.PLACEHOLDER_FOR_GREATER_OP_CODES)),
            S.OPERATOR_CODE["version"]: F.Scalar("int32", max(
                S.OP_VERSION.get(n, 1), self.versions.get(n, 1))),
            S.OPERATOR_CODE["builtin_code"]: F.Scalar("int32", S.BUILTIN[n]),
        }) for n in names]
        tensors = [F.Table({
            S.TENSOR["shape"]: F.Vector(list(shape), np.int32),
            S.TENSOR["type"]: F.Scalar("int8", S.TENSOR_TYPE[ttype]),
            S.TENSOR["buffer"]: F.Scalar("uint32", buf),
            S.TENSOR["name"]: F.String(name),
            S.TENSOR["quantization"]: self._quantization(t),
            S.TENSOR["has_rank"]: F.Scalar("bool", True),
        }) for t, (shape, ttype, buf, name) in enumerate(self.tensors)]
        ops = []
        for name, ins, outs, options in self.ops:
            fields = {
                S.OPERATOR["opcode_index"]: F.Scalar("uint32",
                                                     code_index[name]),
                S.OPERATOR["inputs"]: F.Vector(ins, np.int32),
                S.OPERATOR["outputs"]: F.Vector(outs, np.int32),
            }
            table = S.OP_OPTIONS[name]
            if table is not None:
                union, spec = S.OPTIONS[table]
                fields[S.OPERATOR["builtin_options_type"]] = F.Scalar(
                    "uint8", union)
                fields[S.OPERATOR["builtin_options"]] = F.Table({
                    spec[k][0]: F.Scalar(spec[k][1], v)
                    for k, v in options.items()})
            elif options:
                raise ValueError(f"{name} takes no options, got {options}")
            ops.append(F.Table(fields))
        subgraph = F.Table({
            S.SUBGRAPH["tensors"]: tensors,
            S.SUBGRAPH["inputs"]: F.Vector(self.inputs, np.int32),
            S.SUBGRAPH["outputs"]: F.Vector(self.outputs, np.int32),
            S.SUBGRAPH["operators"]: ops,
            S.SUBGRAPH["name"]: F.String("main"),
        })
        buffers = [F.Table({})] + [
            F.Table({S.BUFFER["data"]: F.Vector(
                arr.reshape(-1).view(np.uint8), align=16)})
            for arr in self.buffers[1:]]
        meta = []
        for key, data in (metadata or {}).items():
            buffers.append(F.Table({S.BUFFER["data"]: F.Vector(
                np.frombuffer(data, np.uint8))}))
            meta.append(F.Table({
                S.METADATA["name"]: F.String(key),
                S.METADATA["buffer"]: F.Scalar("uint32", len(buffers) - 1)}))
        model = F.Table({
            S.MODEL["version"]: F.Scalar("uint32", S.VERSION),
            S.MODEL["operator_codes"]: codes,
            S.MODEL["subgraphs"]: [subgraph],
            S.MODEL["description"]: F.String(description),
            S.MODEL["buffers"]: buffers,
            S.MODEL["metadata"]: meta or None,
        })
        return F.serialize(model, S.IDENTIFIER)

    def _quantization(self, t: int):
        if t not in self.quant:
            return None
        scale, zero_point, dim = self.quant[t]
        Q = S.QUANTIZATION
        return flatbuf.Table({
            Q["scale"]: flatbuf.Vector(scale, np.float32),
            Q["zero_point"]: flatbuf.Vector(zero_point, np.int64),
            Q["quantized_dimension"]: flatbuf.Scalar("int32", dim)})


def _channel_vector(arr: np.ndarray | None, c: int) -> np.ndarray | None:
    """``arr`` as a [c] per-last-axis vector, if it is one (a scalar or
    a shape of ones ending in 1 or c), else None."""
    if arr is None or arr.dtype != np.float32:
        return None
    if arr.size == 1:
        return np.full(c, arr.reshape(()), np.float32)
    if arr.shape[-1] == c and arr.size == c:
        return arr.reshape(c)
    return None


def fold_affine(b: Builder) -> int:
    """Fold a constant per-output-channel ``MUL`` and then ``ADD`` that
    follow a ``CONV_2D`` (each the only user of what it reads) into the
    convolution's filter and bias. Returns the operators removed."""
    removed = 0
    while True:
        users = b._users()
        outputs = set(b.outputs)
        dead = set()
        for i, op in enumerate(b.ops):
            if op[0] != "CONV_2D" or i in dead:
                continue
            c = b.tensors[op[1][1]][0][0]
            w = b.value(op[1][1])
            bias = b.value(op[1][2]) if len(op[1]) > 2 and op[1][2] >= 0 \
                else np.zeros(c, np.float32)
            if w is None or bias is None:
                continue
            out = op[2][0]
            scale = np.ones(c, np.float32)
            shift = np.zeros(c, np.float32)
            chain = []
            for kind in ("MUL", "ADD"):
                if out in outputs or len(users.get(out, ())) != 1:
                    break
                j = users[out][0]
                nxt = b.ops[j]
                if nxt[0] != kind or nxt[3].get("fused_activation_function"):
                    break
                other = [t for t in nxt[1] if t != out]
                if len(other) != 1:
                    break
                vec = _channel_vector(b.value(other[0]), c)
                if vec is None or b.tensors[nxt[2][0]][0] != \
                        b.tensors[out][0]:
                    break
                if kind == "MUL":
                    scale = vec
                else:
                    shift = vec
                chain.append(j)
                out = nxt[2][0]
            if not chain:
                continue
            new_w = (w * scale[:, None, None, None]).astype(np.float32)
            new_b = (bias * scale + shift).astype(np.float32)
            op[1] = [op[1][0], b.const(new_w), b.const(new_b)]
            op[2] = [out]
            dead.update(chain)
            removed += len(chain)
        if not dead:
            return removed
        b.ops = [op for j, op in enumerate(b.ops) if j not in dead]


class Dyn:
    """A computed TFLite tensor: its index, logical (torch) shape, type,
    and whether it is stored NHWC (a logical NCHW tensor)."""

    __slots__ = ("t", "shape", "ttype", "nhwc")

    def __init__(self, t: int, shape, ttype: str, nhwc: bool = False):
        self.t, self.shape, self.ttype = t, tuple(shape), ttype
        self.nhwc = nhwc and len(self.shape) == 4

    def __repr__(self):
        return (f"Dyn(t{self.t}, {self.shape}, {self.ttype}"
                f"{', nhwc' if self.nhwc else ''})")


def _phys(shape, nhwc: bool):
    return (shape[0], shape[2], shape[3], shape[1]) if nhwc else tuple(shape)


def _is_dyn(tree) -> bool:
    found = []
    map_aggregate(tree, lambda a: found.append(a) if isinstance(a, Dyn)
                  else None)
    return bool(found)


def _pair(v, n=2):
    if isinstance(v, int):
        return (v,) * n
    v = tuple(int(x) for x in v)
    return v * n if len(v) == 1 else v


def _norm_dim(d: int, rank: int) -> int:
    return d + rank if d < 0 else d


# targets that compute nothing (shape asserts)
_SKIP = {"aten._assert_tensor_metadata", "aten._assert_scalar",
         "aten._assert_async", "aten.sym_constrain_range_for_size",
         "aten.sym_constrain_range"}
# targets that pass their first argument through
_IDENTITY = {"aten.alias", "aten.detach", "aten.detach_", "aten.clone",
             "aten.contiguous", "aten.lift_fresh_copy", "aten.dropout"}
_CASTS = {"aten.to", "aten._to_copy"}


class _Lowerer:
    def __init__(self, ep, family: str):
        self.b = Builder()
        self.family = family
        self.env: dict = {}
        self._cache: dict = {}
        self.ep = ep

    def fail(self, what: str):
        raise NotImplementedError(
            f"{self.family}: {what} has no TFLite lowering "
            "(podtpu_torch/export/tflite_lower.py)")

    # -- values ------------------------------------------------------------

    def meta(self, node):
        val = node.meta["val"]
        shape = []
        for d in val.shape:
            if not isinstance(d, int):
                try:
                    d = int(d)
                except TypeError:
                    raise ValueError("TFLite export takes a static batch "
                                     f"(symbolic dimension {d})") from None
            shape.append(d)
        return tuple(shape), tf_type(val.dtype)

    def emit(self, name, inputs, shape, ttype, nhwc=False, **options) -> Dyn:
        t = self.b.op(name, inputs, [(_phys(shape, nhwc), ttype)],
                      **options)[0]
        return Dyn(t, shape, ttype, nhwc)

    def const(self, value, ttype=None, nhwc=False) -> int:
        """A constant operand; ``nhwc`` permutes one that broadcasts
        against a logical NCHW tensor into the NHWC order."""
        if nhwc:
            arr = torch.as_tensor(_np_const(value, ttype))
            if arr.dim() > 0:
                arr = arr.reshape((1,) * (4 - arr.dim()) + tuple(arr.shape))
                arr = arr.permute(0, 2, 3, 1).contiguous()
            value = arr
        return self.b.const(value, ttype)

    def logical(self, v) -> int:
        """Tensor index of ``v`` in its logical (torch) layout."""
        if not isinstance(v, Dyn):
            return self.const(v)
        if not v.nhwc:
            return v.t
        key = ("nchw", v.t)
        if key not in self._cache:
            self._cache[key] = self.emit(
                "TRANSPOSE", [v.t, self.const(np.array(
                    [0, 3, 1, 2], np.int32))], v.shape, v.ttype).t
        return self._cache[key]

    def to_nhwc(self, v: Dyn) -> Dyn:
        if v.nhwc:
            return v
        if len(v.shape) != 4:
            raise ValueError(f"{v} is not 4-D")
        key = ("nhwc", v.t)
        if key not in self._cache:
            self._cache[key] = self.emit(
                "TRANSPOSE", [v.t, self.const(np.array(
                    [0, 2, 3, 1], np.int32))], v.shape, v.ttype, nhwc=True)
        return self._cache[key]

    def plain(self, v: Dyn) -> Dyn:
        """``v`` untagged (NCHW as torch holds it)."""
        return v if not v.nhwc else Dyn(self.logical(v), v.shape, v.ttype)

    def cast(self, v: Dyn, ttype: str) -> Dyn:
        if v.ttype == ttype:
            return v
        key = ("cast", v.t, ttype)
        if key not in self._cache:
            self._cache[key] = self.emit(
                "CAST", [v.t], v.shape, ttype, v.nhwc,
                in_data_type=S.TENSOR_TYPE[v.ttype],
                out_data_type=S.TENSOR_TYPE[ttype])
        return self._cache[key]

    # -- the walk ----------------------------------------------------------

    def run(self):
        from torch.export.graph_signature import InputKind

        ep, gm = self.ep, self.ep.graph_module
        kinds = {}
        for spec in ep.graph_signature.input_specs:
            kinds[spec.arg.name] = spec
        names = []
        for node in gm.graph.nodes:
            if node.op == "placeholder":
                spec = kinds[node.name]
                if spec.kind == InputKind.USER_INPUT:
                    shape, ttype = self.meta(node)
                    name = "image" if not names else node.name
                    names.append(name)
                    t = self.b.tensor(shape, ttype, name)
                    self.b.inputs.append(t)
                    self.env[node] = Dyn(t, shape, ttype)
                else:
                    value = ep.state_dict.get(spec.target)
                    if value is None:
                        value = ep.constants[spec.target]
                    if isinstance(value, torch.Tensor):
                        value = value.detach().cpu()
                    self.env[node] = value
            elif node.op == "get_attr":
                self.env[node] = getattr(gm, node.target)
            elif node.op == "call_function":
                self.env[node] = self.call(node)
            elif node.op == "output":
                outs = node.args[0]
                for v in outs:
                    v = self.env[v]
                    if not isinstance(v, Dyn):
                        raise NotImplementedError(
                            f"{self.family}: a constant program output")
                    self.b.outputs.append(self.logical(v))
        return self.b

    def call(self, node):
        name = op_name(node.target)
        if name in _SKIP:
            return None
        args = map_aggregate(node.args, lambda a: self.env[a]
                             if isinstance(a, torch.fx.Node) else a)
        kwargs = map_aggregate(node.kwargs, lambda a: self.env[a]
                               if isinstance(a, torch.fx.Node) else a)
        if name == "python.getitem":
            return args[0][args[1]]
        if not _is_dyn((args, kwargs)):
            return self.fold(node, name, args, kwargs)
        if name in _IDENTITY:
            return args[0]
        handler = HANDLERS.get(name)
        if handler is None:
            self.fail(f"ATen target {name}")
        return handler(self, node, *args, **kwargs)

    def fold(self, node, name, args, kwargs):
        """Evaluate a node of constants here, on the host; a cast to a
        floating type is a cast to float32 (the file's only float)."""
        if name in _CASTS:
            dtype = kwargs.get("dtype", args[1] if len(args) > 1 and
                               isinstance(args[1], torch.dtype) else None)
            if dtype in _FLOATS:
                x = args[0]
                return x.float() if isinstance(x, torch.Tensor) and \
                    x.is_floating_point() else x.to(torch.float32)
        kwargs = dict(kwargs)
        if "device" in kwargs:
            kwargs["device"] = torch.device("cpu")
        out = node.target(*args, **kwargs)
        return map_aggregate(out, lambda a: a.detach().cpu()
                             if isinstance(a, torch.Tensor) else a)


# ---- handlers ---------------------------------------------------------------

HANDLERS: dict = {}


def _handles(*names):
    def register(fn):
        for n in names:
            HANDLERS[n] = fn
        return fn
    return register


def _elementwise(lw: _Lowerer, node, name: str, operands, comp=None,
                 **options) -> Dyn:
    """An elementwise TFLite op over ``operands`` (Dyn or constants),
    computed in ``comp`` (default: the output's type); NHWC when the
    output is 4-D and a 4-D operand is."""
    shape, out_tt = lw.meta(node)
    comp = comp or out_tt
    dyns = [o for o in operands if isinstance(o, Dyn)]
    nhwc = (len(shape) == 4 and any(d.nhwc for d in dyns)
            and all(len(d.shape) == 4 for d in dyns))
    ins = []
    for o in operands:
        if isinstance(o, Dyn):
            o = lw.cast(o, comp) if comp else o
            ins.append(lw.to_nhwc(o).t if nhwc else lw.logical(o))
        else:
            ins.append(lw.const(o, comp, nhwc=nhwc))
    return lw.emit(name, ins, shape, out_tt, nhwc, **options)


def _common_type(operands) -> str:
    types = set()
    for o in operands:
        if isinstance(o, Dyn):
            types.add(o.ttype)
        elif isinstance(o, bool):
            types.add("BOOL")
        elif isinstance(o, int):
            types.add("INT32")
        elif isinstance(o, float):
            types.add("FLOAT32")
        elif isinstance(o, torch.Tensor):
            types.add(tf_type(o.dtype))
    for t in ("FLOAT32", "INT32", "BOOL"):
        if t in types:
            return t
    return "FLOAT32"


_BINARY = {"aten.add": "ADD", "aten.sub": "SUB", "aten.mul": "MUL",
           "aten.div": "DIV"}
_UNARY = {"aten.relu": "RELU", "aten.sigmoid": "LOGISTIC",
          "aten.exp": "EXP", "aten.abs": "ABS"}


def _binary(lw, node, a, b, alpha=1, rounding_mode=None):
    name = op_name(node.target)
    if alpha != 1 or rounding_mode is not None:
        lw.fail(f"{name} with alpha or rounding_mode")
    return _elementwise(lw, node, _BINARY[name], [a, b])


for _n in _BINARY:
    HANDLERS[_n] = _binary


@_handles("aten.gt")
def _greater(lw, node, a, b):
    return _elementwise(lw, node, "GREATER", [a, b],
                        comp=_common_type([a, b]))


def _unary(lw, node, x):
    shape, ttype = lw.meta(node)
    x = lw.cast(x, ttype)
    return lw.emit(_UNARY[op_name(node.target)], [x.t], shape, ttype,
                   x.nhwc)


for _n in _UNARY:
    HANDLERS[_n] = _unary
    HANDLERS[_n + "_"] = _unary


@_handles("aten.leaky_relu", "aten.leaky_relu_")
def _leaky_relu(lw, node, x, negative_slope=0.01):
    shape, ttype = lw.meta(node)
    return lw.emit("LEAKY_RELU", [x.t], shape, ttype, x.nhwc,
                   alpha=float(negative_slope))


@_handles("aten.mish", "aten.mish_")
def _mish(lw, node, x):
    # x * tanh(log(1 + exp(x))): see the module docstring for large |x|
    shape, ttype = lw.meta(node)
    e = lw.emit("EXP", [x.t], shape, ttype, x.nhwc)
    p = lw.emit("ADD", [e.t, lw.const(np.float32(1.0))], shape, ttype,
                x.nhwc)
    sp = lw.emit("LOG", [p.t], shape, ttype, x.nhwc)
    th = lw.emit("TANH", [sp.t], shape, ttype, x.nhwc)
    return lw.emit("MUL", [x.t, th.t], shape, ttype, x.nhwc)


@_handles("aten.clamp", "aten.clamp_min")
def _clamp(lw, node, x, lo=None, hi=None):
    out = x
    if lo is not None:
        out = _elementwise(lw, node, "MAXIMUM", [out, lo])
    if hi is not None:
        out = _elementwise(lw, node, "MINIMUM", [out, hi])
    return out


@_handles("aten.where")
def _where(lw, node, cond, a, b):
    shape, ttype = lw.meta(node)
    dyns = [o for o in (cond, a, b) if isinstance(o, Dyn)]
    nhwc = (len(shape) == 4 and any(d.nhwc for d in dyns)
            and all(len(d.shape) == 4 for d in dyns))
    ins = []
    for o, tt in ((cond, "BOOL"), (a, ttype), (b, ttype)):
        if isinstance(o, Dyn):
            o = lw.cast(o, tt)
            ins.append(lw.to_nhwc(o).t if nhwc else lw.logical(o))
        else:
            ins.append(lw.const(o, tt, nhwc=nhwc))
    return lw.emit("SELECT_V2", ins, shape, ttype, nhwc)


def _cast_handler(lw, node, x, *args, **kwargs):
    _, ttype = lw.meta(node)
    return lw.cast(x, ttype)


for _n in _CASTS:
    HANDLERS[_n] = _cast_handler


@_handles("aten.conv2d")
def _conv(lw, node, x, w, bias=None, stride=1, padding=0, dilation=1,
          groups=1):
    if isinstance(w, Dyn) or isinstance(bias, Dyn):
        lw.fail("a convolution with computed weights")
    o, i, kh, kw = w.shape
    if groups != 1:
        lw.fail(f"a grouped convolution (groups={groups})")
    shape, ttype = lw.meta(node)
    x = lw.to_nhwc(lw.cast(x, "FLOAT32"))
    sh, sw = _pair(stride)
    dh, dw = _pair(dilation)
    if isinstance(padding, str):
        if padding == "valid":
            padding = 0
        else:
            padding = (dh * (kh - 1) // 2, dw * (kw - 1) // 2)
    ph, pw = _pair(padding)
    mode = "VALID"
    if (ph, pw) != (0, 0):
        if (sh, sw) == (1, 1) and 2 * ph == dh * (kh - 1) \
                and 2 * pw == dw * (kw - 1):
            mode = "SAME"
        else:
            n, c, h, wd = x.shape
            x = lw.emit("PAD", [x.t, lw.const(np.array(
                [[0, 0], [ph, ph], [pw, pw], [0, 0]], np.int32))],
                (n, c, h + 2 * ph, wd + 2 * pw), x.ttype, nhwc=True)
    filt = lw.const(w.permute(0, 2, 3, 1).contiguous(), "FLOAT32")
    b = lw.const(bias if bias is not None else torch.zeros(o), "FLOAT32")
    return lw.emit("CONV_2D", [x.t, filt, b], shape, ttype, nhwc=True,
                   padding=S.PADDING[mode], stride_w=sw, stride_h=sh,
                   fused_activation_function=S.ACTIVATION_NONE,
                   dilation_w_factor=dw, dilation_h_factor=dh)


@_handles("aten.max_pool2d")
def _max_pool(lw, node, x, kernel, stride=(), padding=0, dilation=1,
              ceil_mode=False):
    shape, ttype = lw.meta(node)
    kh, kw = _pair(kernel)
    sh, sw = _pair(stride) if stride else (kh, kw)
    ph, pw = _pair(padding)
    if _pair(dilation) != (1, 1):
        lw.fail("a dilated max pool")
    x = lw.to_nhwc(x)
    n, c, h, w = x.shape
    valid_out = ((h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1)
    if ceil_mode and tuple(shape[2:]) != valid_out:
        lw.fail("a ceil_mode max pool")
    mode = "VALID"
    if (ph, pw) != (0, 0):
        if (sh, sw) == (1, 1) and 2 * ph == kh - 1 and 2 * pw == kw - 1:
            mode = "SAME"  # TFLite's SAME pool skips the padding
        else:
            x = lw.emit("PADV2", [x.t, lw.const(np.array(
                [[0, 0], [ph, ph], [pw, pw], [0, 0]], np.int32)),
                lw.const(np.float32(-np.inf))],
                (n, c, h + 2 * ph, w + 2 * pw), x.ttype, nhwc=True)
    return lw.emit("MAX_POOL_2D", [x.t], shape, ttype, nhwc=True,
                   padding=S.PADDING[mode], stride_w=sw, stride_h=sh,
                   filter_width=kw, filter_height=kh,
                   fused_activation_function=S.ACTIVATION_NONE)


@_handles("aten.upsample_nearest2d")
def _upsample(lw, node, x, *args, **kwargs):
    shape, ttype = lw.meta(node)
    x = lw.to_nhwc(x)
    return lw.emit("RESIZE_NEAREST_NEIGHBOR", [x.t, lw.const(np.array(
        shape[2:], np.int32))], shape, ttype, nhwc=True,
        align_corners=False, half_pixel_centers=False)


@_handles("aten.cat")
def _cat(lw, node, tensors, dim=0):
    shape, ttype = lw.meta(node)
    dim = _norm_dim(dim, len(shape))
    tensors = [t for t in tensors if not (isinstance(t, torch.Tensor)
                                          and t.numel() == 0)]
    dyns = [t for t in tensors if isinstance(t, Dyn)]
    nhwc = len(shape) == 4 and any(d.nhwc for d in dyns)
    ins = []
    for t in tensors:
        if isinstance(t, Dyn):
            t = lw.cast(t, ttype)
            ins.append(lw.to_nhwc(t).t if nhwc else lw.logical(t))
        else:
            ins.append(lw.const(t, ttype, nhwc=nhwc))
    axis = _PHYS_AXIS[dim] if nhwc else dim
    return lw.emit("CONCATENATION", ins, shape, ttype, nhwc, axis=axis,
                   fused_activation_function=S.ACTIVATION_NONE)


@_handles("aten.permute")
def _permute(lw, node, x, dims):
    shape, ttype = lw.meta(node)
    dims = tuple(_norm_dim(d, len(x.shape)) for d in dims)
    if x.nhwc:
        if dims == (0, 2, 3, 1):  # the stored NHWC tensor is the result
            return Dyn(x.t, shape, ttype)
        perm = [_PHYS_AXIS[d] for d in dims]
    elif len(dims) == 4 and dims == (0, 3, 1, 2):
        return Dyn(x.t, shape, ttype, nhwc=True)
    else:
        perm = list(dims)
    if perm == sorted(perm):
        return Dyn(x.t, shape, ttype)
    return lw.emit("TRANSPOSE", [x.t, lw.const(np.array(perm, np.int32))],
                   shape, ttype)


def _reshape_to(lw, x: Dyn, shape, ttype) -> Dyn:
    if tuple(shape) == x.shape and not x.nhwc:
        return x
    return lw.emit("RESHAPE", [lw.logical(x), lw.const(np.array(
        shape, np.int32))], shape, ttype)


@_handles("aten.view", "aten.reshape", "aten._unsafe_view", "aten.flatten",
          "aten.unsqueeze", "aten.squeeze")
def _reshape(lw, node, x, *args, **kwargs):
    shape, ttype = lw.meta(node)
    return _reshape_to(lw, x, shape, ttype)


@_handles("aten.expand")
def _expand(lw, node, x, *args, **kwargs):
    shape, ttype = lw.meta(node)
    if tuple(shape) == x.shape:
        return x
    return lw.emit("BROADCAST_TO", [lw.logical(x), lw.const(np.array(
        shape, np.int32))], shape, ttype)


def _strided_slice(lw, x: Dyn, begin, end, strides, shape, ttype,
                   shrink=0, nhwc=False):
    src = x.t if nhwc else lw.logical(x)
    return lw.emit("STRIDED_SLICE", [src, lw.const(np.array(begin, np.int32)),
                                     lw.const(np.array(end, np.int32)),
                                     lw.const(np.array(strides, np.int32))],
                   shape, ttype, nhwc, begin_mask=0, end_mask=0,
                   ellipsis_mask=0, new_axis_mask=0, shrink_axis_mask=shrink,
                   offset=False)


@_handles("aten.slice")
def _slice(lw, node, x, dim=0, start=None, end=None, step=1):
    shape, ttype = lw.meta(node)
    rank = len(x.shape)
    dim = _norm_dim(dim, rank)
    n = x.shape[dim]
    start = 0 if start is None else start
    end = n if end is None else end
    start = max(0, min(n, start + n if start < 0 else start))
    end = max(start, min(n, end + n if end < 0 else end))
    if (start, end, step) == (0, n, 1):
        return x
    nhwc = x.nhwc
    axis = _PHYS_AXIS[dim] if nhwc else dim
    pshape = _phys(x.shape, nhwc)
    begin = [0] * rank
    stop = list(pshape)
    strides = [1] * rank
    begin[axis], stop[axis], strides[axis] = start, end, step
    return _strided_slice(lw, x, begin, stop, strides, shape, ttype,
                          nhwc=nhwc)


@_handles("aten.select")
def _select(lw, node, x, dim, index):
    shape, ttype = lw.meta(node)
    rank = len(x.shape)
    dim = _norm_dim(dim, rank)
    index = index + x.shape[dim] if index < 0 else index
    begin = [0] * rank
    end = list(x.shape)
    begin[dim], end[dim] = index, index + 1
    return _strided_slice(lw, x, begin, end, [1] * rank, shape, ttype,
                          shrink=1 << dim)


@_handles("aten.unbind")
def _unbind(lw, node, x, dim=0):
    rank = len(x.shape)
    dim = _norm_dim(dim, rank)
    n = x.shape[dim]
    shape = x.shape[:dim] + x.shape[dim + 1:]
    outs = lw.b.op("UNPACK", [lw.logical(x)], [(shape, x.ttype)] * n,
                   num=n, axis=dim)
    return [Dyn(t, shape, x.ttype) for t in outs]


def _concat(lw, parts: list, axis: int, shape, ttype) -> Dyn:
    return lw.emit("CONCATENATION", [p.t for p in parts], shape, ttype,
                   axis=axis, fused_activation_function=S.ACTIVATION_NONE)


@_handles("aten.stack")
def _stack(lw, node, tensors, dim=0):
    shape, ttype = lw.meta(node)
    dim = _norm_dim(dim, len(shape))
    if ttype == "BOOL":  # TFLite's PACK takes no bool: reshape and concat
        one = shape[:dim] + (1,) + shape[dim + 1:]
        parts = [_reshape_to(lw, t if isinstance(t, Dyn) else Dyn(
            lw.const(t, ttype), tuple(t.shape), ttype), one, ttype)
            for t in tensors]
        return _concat(lw, parts, dim, shape, ttype)
    ins = [lw.logical(lw.cast(t, ttype)) if isinstance(t, Dyn)
           else lw.const(t, ttype) for t in tensors]
    return lw.emit("PACK", ins, shape, ttype, values_count=len(ins),
                   axis=dim)


@_handles("aten.argmax")
def _argmax(lw, node, x, dim=None, keepdim=False):
    shape, _ = lw.meta(node)
    if dim is None:
        lw.fail("aten.argmax over all axes")
    dim = _norm_dim(dim, len(x.shape))
    red = x.shape[:dim] + x.shape[dim + 1:]
    out = lw.emit("ARG_MAX", [lw.logical(x), lw.const(np.array(
        [dim], np.int32))], red, "INT32",
        output_type=S.TENSOR_TYPE["INT32"])
    return _reshape_to(lw, out, shape, "INT32") if keepdim else out


@_handles("aten.amax")
def _amax(lw, node, x, dim=(), keepdim=False):
    shape, ttype = lw.meta(node)
    rank = len(x.shape)
    dims = [_norm_dim(d, rank) for d in (dim or range(rank))]
    nhwc = x.nhwc and keepdim
    axes = [_PHYS_AXIS[d] for d in dims] if nhwc else dims
    return lw.emit("REDUCE_MAX", [x.t if nhwc else lw.logical(x), lw.const(
        np.array(axes, np.int32))], shape, ttype, nhwc,
        keep_dims=bool(keepdim))


@_handles("aten.linear")
def _linear(lw, node, x, w, bias=None):
    shape, ttype = lw.meta(node)
    if isinstance(w, Dyn) or isinstance(bias, Dyn):
        lw.fail("aten.linear with computed weights")
    b = lw.const(bias if bias is not None else torch.zeros(w.shape[0]),
                 "FLOAT32")
    return lw.emit("FULLY_CONNECTED", [lw.logical(x), lw.const(w, "FLOAT32"),
                                       b], shape, ttype,
                   fused_activation_function=S.ACTIVATION_NONE,
                   weights_format=0, keep_num_dims=len(shape) > 2)


@_handles("aten.pad", "aten.constant_pad_nd")
def _pad(lw, node, x, pad, mode="constant", value=None):
    shape, ttype = lw.meta(node)
    if mode != "constant":
        lw.fail(f"aten.pad mode {mode!r}")
    rank = len(x.shape)
    pads = [[0, 0] for _ in range(rank)]
    for i in range(len(pad) // 2):
        pads[rank - 1 - i] = [pad[2 * i], pad[2 * i + 1]]
    if min(min(p) for p in pads) < 0:
        lw.fail("a negative aten.pad")
    nhwc = x.nhwc
    if nhwc:
        pads = [pads[d] for d in (0, 2, 3, 1)]
    ins = [x.t if nhwc else lw.logical(x),
           lw.const(np.array(pads, np.int32))]
    if value:
        ins.append(lw.const(np.asarray(value), x.ttype))
    return lw.emit("PADV2" if value else "PAD", ins, shape, ttype, nhwc)


@_handles("aten.gather")
def _gather(lw, node, x, dim, index, sparse_grad=False):
    """``torch.gather`` as ``GATHER_ND``: the index grid of every other
    axis is a constant."""
    shape, ttype = lw.meta(node)
    rank = len(shape)
    dim = _norm_dim(dim, rank)
    coords = []
    for a in range(rank):
        if a == dim:
            coords.append(lw.logical(lw.cast(index, "INT32"))
                          if isinstance(index, Dyn)
                          else lw.const(index, "INT32"))
        else:
            grid = np.broadcast_to(np.arange(shape[a], dtype=np.int32).reshape(
                [-1 if i == a else 1 for i in range(rank)]), shape)
            coords.append(lw.const(np.ascontiguousarray(grid)))
    idx = lw.emit("PACK", coords, shape + (rank,), "INT32",
                  values_count=rank, axis=rank)
    return lw.emit("GATHER_ND", [lw.logical(x), idx.t], shape, ttype)


def _slice_users(node):
    """The ``slice`` nodes ``node``'s value reaches through aliases, or
    None if anything else reads it."""
    out = []
    for u in node.users:
        name = op_name(u.target)
        if name in ("aten.alias", "aten.detach"):
            more = _slice_users(u)
            if more is None:
                return None
            out += more
        elif name == "aten.slice":
            out.append(u)
        else:
            return None
    return out


def _topk(lw, x: Dyn, k: int):
    shape = x.shape[:-1] + (k,)
    vals, idx = lw.b.op("TOPK_V2", [lw.logical(x), lw.const(np.int32(k))],
                        [(shape, x.ttype), (shape, "INT32")])
    return [Dyn(vals, shape, x.ttype), Dyn(idx, shape, "INT32")]


@_handles("aten.sort")
def _sort(lw, node, x, *args, **kwargs):
    """A descending ``sort`` along the last axis as ``TOPK_V2``: with the
    k its users slice to when every user is a ``[..., :k]`` slice, else
    the whole length (TFLite's ties keep the lower index, as a stable
    sort)."""
    names = ("stable", "dim", "descending") if "stable" in str(
        node.target) else ("dim", "descending", "stable")
    opts = dict(zip(names, args))
    opts.update(kwargs)
    dim = _norm_dim(opts.get("dim", -1), len(x.shape))
    if dim != len(x.shape) - 1 or not opts.get("descending", False):
        lw.fail("aten.sort other than descending along the last axis")
    n = x.shape[-1]
    k = n
    slices = []
    for g in node.users:
        if op_name(g.target) != "python.getitem":
            slices = None
            break
        more = _slice_users(g)
        if more is None:
            slices = None
            break
        slices += more
    if slices:
        ends = set()
        for s in slices:
            sd = _norm_dim(s.args[1] if len(s.args) > 1 else 0,
                           len(x.shape))
            start = s.args[2] if len(s.args) > 2 else 0
            end = s.args[3] if len(s.args) > 3 else n
            step = s.args[4] if len(s.args) > 4 else 1
            if sd != dim or start not in (0, None) or step != 1:
                ends = None
                break
            ends.add(min(n, end if end is not None else n))
        if ends and len(ends) == 1:
            k = ends.pop()
    return _topk(lw, x, k)


@_handles("podtpu_torch.greedy_suppress")
def _greedy_suppress(lw, node, boxes, valid, iou_threshold):
    """One ``NON_MAX_SUPPRESSION_V5`` an image (the module docstring).

    TFLite 2.21's op selects a box of no area twice (its index also fills
    the next slot, and the count includes it), losing the next survivor;
    the port's IoU of such a box with any other is 0, so it is always
    kept and suppresses nothing. Boxes of no area (``(x2 - x1) (y2 - y1)
    <= 0`` in float32) therefore stay out of the op and join the keep
    mask after it. A threshold of 1 or more suppresses nothing in the port
    (its IoU is never above 1): the mask is then ``valid``."""
    shape, _ = lw.meta(node)
    b, k = shape
    valid = valid if isinstance(valid, Dyn) else Dyn(
        lw.const(valid, "BOOL"), (b, k), "BOOL")
    valid = lw.plain(valid)
    if np.float32(iou_threshold) >= 1.0:
        return valid
    boxes = Dyn(lw.logical(lw.cast(boxes, "FLOAT32")), (b, k, 4), "FLOAT32")
    lo = _strided_slice(lw, boxes, [0, 0, 0], [b, k, 2], [1, 1, 1],
                        (b, k, 2), "FLOAT32")
    hi = _strided_slice(lw, boxes, [0, 0, 2], [b, k, 4], [1, 1, 1],
                        (b, k, 2), "FLOAT32")
    wh = lw.emit("SUB", [hi.t, lo.t], (b, k, 2), "FLOAT32")
    w = _strided_slice(lw, wh, [0, 0, 0], [b, k, 1], [1, 1, 1], (b, k),
                       "FLOAT32", shrink=4)
    h = _strided_slice(lw, wh, [0, 0, 1], [b, k, 2], [1, 1, 1], (b, k),
                       "FLOAT32", shrink=4)
    area = lw.emit("MUL", [w.t, h.t], (b, k), "FLOAT32")
    some = lw.emit("GREATER", [area.t, lw.const(np.float32(0.0))], (b, k),
                   "BOOL")
    none = lw.emit("LOGICAL_NOT", [some.t], (b, k), "BOOL")
    cand = lw.emit("LOGICAL_AND", [valid.t, some.t], (b, k), "BOOL")
    flat = lw.emit("LOGICAL_AND", [valid.t, none.t], (b, k), "BOOL")
    thr = np.nextafter(np.float32(iou_threshold), np.float32(np.inf))
    ranks = lw.const(np.arange(k, 0, -1, dtype=np.float32))
    row = lw.const(np.arange(k, dtype=np.int32).reshape(1, k))
    col = lw.const(np.arange(k, dtype=np.int32).reshape(k, 1))
    per_image = []
    for i in range(b):
        box_i = _strided_slice(lw, boxes, [i, 0, 0], [i + 1, k, 4],
                               [1, 1, 1], (k, 4), "FLOAT32", shrink=1)
        val_i = _strided_slice(lw, cand, [i, 0], [i + 1, k], [1, 1], (k,),
                               "BOOL", shrink=1)
        score = lw.emit("SELECT_V2", [val_i.t, ranks, lw.const(
            np.float32(-1.0))], (k,), "FLOAT32")
        per_image.append((box_i, score))
    # the B suppressions one after another: a reader may batch them
    selected = []
    for box_i, score in per_image:
        sel, _, count = lw.b.op(
            "NON_MAX_SUPPRESSION_V5",
            [box_i.t, score.t, lw.const(np.int32(k)), lw.const(thr),
             lw.const(np.float32(0.0)), lw.const(np.float32(0.0))],
            [((k,), "INT32"), ((k,), "FLOAT32"), ((), "INT32")])
        selected.append((sel, count))
    masks = []
    for sel, count in selected:
        sel_col = lw.emit("RESHAPE", [sel, lw.const(np.array(
            [k, 1], np.int32))], (k, 1), "INT32")
        hit = lw.emit("EQUAL", [sel_col.t, row], (k, k), "BOOL")
        live = lw.emit("LESS", [col, count], (k, 1), "BOOL")
        both = lw.emit("LOGICAL_AND", [hit.t, live.t], (k, k), "BOOL")
        masks.append(lw.emit("REDUCE_ANY", [both.t, lw.const(np.array(
            [0], np.int32))], (1, k), "BOOL", keep_dims=True))
    keep = masks[0] if b == 1 else _concat(lw, masks, 0, (b, k), "BOOL")
    return lw.emit("LOGICAL_OR", [keep.t, flat.t], (b, k), "BOOL")


def lower_program(ep, family: str = "model") -> Builder:
    """The TFLite subgraph of ``torch.export`` program ``ep``: its user
    inputs are the subgraph's inputs (the first named ``image``), its
    outputs the subgraph's outputs, in order; each convolution's
    per-channel affine epilogue folded into it (:func:`fold_affine`)."""
    b = _Lowerer(ep, family).run()
    fold_affine(b)
    b.prune()
    return b
