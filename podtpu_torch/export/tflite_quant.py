"""Quantized TFLite files: a pass over the lowered float32 subgraph
(``export/tflite_lower.py::lower_program``), so the model is traced once a
file (``podtpu``'s ``export_tflite(..., quantize=...)`` asks TensorFlow's
converter for the same two kinds).

* **dynamic** (dynamic range: int8 weights, float compute). The filter of
  each ``CONV_2D`` and ``FULLY_CONNECTED`` with at least
  :data:`MIN_ELEMENTS` elements becomes int8, symmetric per output channel
  (``quantized_dimension`` 0, [-127, 127], scale = absmax / 127); smaller
  filters, activations and biases stay float32. That is the converter's
  rule: in its files a 3x3x3x32 stem (864 elements) and a 1x1 32->31
  filter (992) stay float, a 1x1 32->32 (1,024) is int8. A
  ``FULLY_CONNECTED`` quantizes its input asymmetrically
  (``asymmetric_quantize_inputs``), as the converter writes it.
* **int8** (full-integer post-training quantization with float fallback):

  1. *Calibration.* The float file runs through the port's reader over the
     representative batches, and every float32 tensor it makes records its
     min and max (:func:`calibrate`).
  2. *Activations* are int8, asymmetric per tensor over [-128, 127]: the
     range widened to hold 0 and the zero point nudged to an integer, so
     0.0 is exact (:func:`affine_params`, TFLite's quantizer's rule).
  3. *Filters* are int8, symmetric per output channel; *biases* int32 at
     scale ``s_in * s_w[c]``, zero point 0.
  4. The operators that run on int8: ``CONV_2D`` and ``FULLY_CONNECTED``
     (always: a float input is quantized first; a ``RELU`` that is their
     or an ``ADD``'s only reader is fused into them), ``LEAKY_RELU`` and
     ``ADD`` (where their inputs are int8 already), and the operators of
     :data:`MOVERS` (likewise).
  5. The movers share one scale and zero point between their inputs and
     their output (TFLite's int8 pool and concatenation require it), so
     they only move bytes: a group of tensors tied by them takes the union
     of its members' ranges (a mover's output adds nothing to it: a
     ``PADV2`` of -inf clamps to -128, which a max pool then ignores).
     ``PAD`` pads with the zero point.
  6. Every other operator (Mish's ``EXP``, ``LOG``, ``TANH`` and ``MUL``,
     the decode, ``TOPK_V2``, ``NON_MAX_SUPPRESSION_V5``) runs in float32,
     after a ``DEQUANTIZE`` of what it reads that is int8.
  7. The input ``image`` stays float32, with a ``QUANTIZE`` first; an int8
     output is ``DEQUANTIZE``d, so the outputs keep the float file's
     names, types and order.

Operator versions are those TensorFlow 2.21's converter writes for the
same operators (``tflite_schema.INT8_OP_VERSION`` and
``HYBRID_OP_VERSION``).
"""

from __future__ import annotations

import numpy as np
import torch

from podtpu_torch.export import tflite_schema as S
from podtpu_torch.export.tflite_int8 import (
    QMAX,
    QMIN,
    nudged_scale_and_zero_point,
)
from podtpu_torch.export.tflite_int8 import np_round_half_away as _round
from podtpu_torch.export.tflite_lower import Builder

MIN_ELEMENTS = 1024
MODES = ("dynamic", "int8")

# int8 whenever their input can be: their float inputs are quantized
COMPUTE = {"CONV_2D", "FULLY_CONNECTED"}
# int8 where every input they read is int8 already
ELEMENTWISE = {"LEAKY_RELU", "ADD"}
MOVERS = {"MAX_POOL_2D", "CONCATENATION", "RESIZE_NEAREST_NEIGHBOR", "PAD",
          "PADV2", "RESHAPE", "STRIDED_SLICE"}
_FUSE_RELU = {"CONV_2D", "FULLY_CONNECTED", "ADD"}


def symmetric_per_channel(w: np.ndarray, qmax: int = 127):
    """``w`` [O, ...] float32 -> (int8 codes, scale float32 [O]), the
    scale of a channel its absmax / 127 (1 for a channel of zeros)."""
    o = w.shape[0]
    absmax = np.abs(w.reshape(o, -1)).max(1).astype(np.float64)
    scale = np.where(absmax > 0, absmax / qmax, 1.0).astype(np.float32)
    q = _round(w.astype(np.float64) / scale.reshape(
        (o,) + (1,) * (w.ndim - 1)).astype(np.float64))
    return np.clip(q, -qmax, qmax).astype(np.int8), scale


def affine_params(lo: float, hi: float) -> tuple[np.float32, int]:
    """(scale, zero point) of the int8 range of [lo, hi], widened to hold
    0, with the zero point nudged to an integer (TFLite's
    ``GetNudgedScaleAndZeroPoint``)."""
    lo, hi = min(float(lo), 0.0), max(float(hi), 0.0)
    if not (np.isfinite(lo) and np.isfinite(hi)):
        raise ValueError(f"calibration range [{lo}, {hi}] is not finite")
    scale, zp = nudged_scale_and_zero_point(
        torch.tensor(lo, dtype=torch.float64),
        torch.tensor(hi, dtype=torch.float64))
    return np.float32(scale.item()), int(zp)


def _per_tensor(scale, zp) -> tuple:
    return (np.array([scale], np.float32), np.array([zp], np.int64), 0)


def _per_channel(scale: np.ndarray) -> tuple:
    return (scale.astype(np.float32), np.zeros(scale.size, np.int64), 0)


def _bump(b: Builder, name: str, table: dict):
    b.versions[name] = max(b.versions.get(name, 1), table.get(name, 1))


# ---- dynamic range ----------------------------------------------------------

def dynamic_range(b: Builder) -> Builder:
    """Int8 filters for ``CONV_2D`` / ``FULLY_CONNECTED`` of at least
    :data:`MIN_ELEMENTS` elements, in place."""
    for name, ins, _, options in b.ops:
        if name not in COMPUTE:
            continue
        w = b.value(ins[1])
        if w is None or w.size < MIN_ELEMENTS:
            continue
        q, scale = symmetric_per_channel(w)
        ins[1] = b.const(q, "INT8", quant=_per_channel(scale))
        _bump(b, name, S.HYBRID_OP_VERSION)
        if name == "FULLY_CONNECTED":
            options["asymmetric_quantize_inputs"] = True
    b.prune()
    return b


# ---- full integer -----------------------------------------------------------

def calibrate(b: Builder, batches, device) -> dict:
    """Run the float subgraph ``b`` through the port's reader on
    ``device`` over ``batches`` (each the input's static shape, or a tuple
    of one array an input): ``{tensor: (min, max)}`` of every float32
    tensor it makes or takes."""
    from podtpu_torch.export.tflite import TFLiteFile, TFLiteProgram

    prog = TFLiteProgram(TFLiteFile(bytes(b.serialize())), device)
    want = [b.tensors[t][0] for t in b.inputs]
    stats: dict = {}

    def observe(t, x):
        if x.dtype != torch.float32:
            return
        mm = torch.stack([x.amin(), x.amax()])
        old = stats.get(t)
        stats[t] = mm if old is None else torch.stack(
            [torch.minimum(old[0], mm[0]), torch.maximum(old[1], mm[1])])

    n = 0
    for batch in batches:
        xs = [torch.as_tensor(np.asarray(x, np.float32)) for x in (
            batch if isinstance(batch, (tuple, list)) else [batch])]
        got = [tuple(x.shape) for x in xs]
        if got != want:
            raise ValueError(f"a calibration batch must have the export's "
                             f"input shape {want}, got {got}")
        prog.run(xs, observe)
        n += 1
    if not n:
        raise ValueError("int8 quantization needs at least one "
                         "representative batch")
    return {t: tuple(float(v) for v in mm.cpu()) for t, mm in stats.items()}


def _fuse_relu(b: Builder):
    """Fold a ``RELU`` into the ``CONV_2D``, ``FULLY_CONNECTED`` or ``ADD``
    whose output only it reads (the RELU's output tensor, and so its
    calibrated range, becomes the operator's)."""
    users = b._users()
    outputs = set(b.outputs)
    dead = set()
    for op in b.ops:
        if op[0] not in _FUSE_RELU or op[3].get(
                "fused_activation_function", 0) != 0:
            continue
        out = op[2][0]
        if out in outputs or len(users.get(out, ())) != 1:
            continue
        j = users[out][0]
        if b.ops[j][0] != "RELU":
            continue
        op[3]["fused_activation_function"] = 1
        op[2] = [b.ops[j][2][0]]
        dead.add(j)
    b.ops = [op for j, op in enumerate(b.ops) if j not in dead]


class _Groups:
    """Union-find over tensors that share one scale and zero point."""

    def __init__(self):
        self.parent: dict = {}

    def find(self, t):
        self.parent.setdefault(t, t)
        while self.parent[t] != t:
            self.parent[t] = self.parent[self.parent[t]]
            t = self.parent[t]
        return t

    def union(self, a, c):
        self.parent[self.find(a)] = self.find(c)


def _plan(b: Builder) -> list[bool]:
    """Which operators run on int8 (the module docstring, 4.)."""
    def computed(t):
        return t >= 0 and b.value(t) is None

    int8 = set(t for t in b.inputs if b.tensors[t][1] == "FLOAT32")
    plan = []
    for name, ins, outs, _ in b.ops:
        dyn = [t for t in ins if computed(t)]
        floats = all(b.tensors[t][1] == "FLOAT32" for t in dyn + outs)
        if name in COMPUTE:
            ok = floats and len(dyn) == 1 and dyn[0] == ins[0]
        elif name in ELEMENTWISE or name in MOVERS:
            ok = floats and bool(dyn) and all(t in int8 for t in dyn)
            if name in ("ADD", "CONCATENATION"):
                ok = ok and len(dyn) == len(ins)
            else:
                ok = ok and dyn == [ins[0]]
        else:
            ok = False
        plan.append(ok)
        if ok:
            int8.update(outs)
    return plan


def full_integer(b: Builder, ranges: dict) -> Builder:
    """The int8 file of float subgraph ``b`` with calibrated ``ranges``
    (:func:`calibrate`), in place."""
    _fuse_relu(b)
    plan = _plan(b)
    groups = _Groups()
    mover_outs = set()
    for run_int8, (name, ins, outs, _) in zip(plan, b.ops):
        if run_int8 and name in MOVERS:
            for t in (ins if name == "CONCATENATION" else ins[:1]):
                groups.union(t, outs[0])
            mover_outs.add(outs[0])
    span: dict = {}
    for t, (lo, hi) in ranges.items():
        if t in mover_outs:
            continue
        g = groups.find(t)
        old = span.get(g, (lo, hi))
        span[g] = (min(old[0], lo), max(old[1], hi))

    def params(t):
        g = groups.find(t)
        if g not in span:
            raise ValueError(f"tensor {t} ({b.tensors[t][3]}) has no "
                             "calibrated range")
        return affine_params(*span[g])

    ops, as_q, as_f, retyped = [], {}, {}, set()

    def int8_of(t):
        if t in retyped:
            return t
        if t not in as_q:
            shape, _, _, name = b.tensors[t]
            as_q[t] = b.tensor(shape, "INT8", f"{name}_int8",
                               quant=_per_tensor(*params(t)))
            ops.append(["QUANTIZE", [t], [as_q[t]], {}])
            _bump(b, "QUANTIZE", S.INT8_OP_VERSION)
        return as_q[t]

    def float_of(t):
        if t < 0 or t not in retyped:
            return t
        if t not in as_f:
            shape, _, _, name = b.tensors[t]
            as_f[t] = b.tensor(shape, "FLOAT32", f"{name}_float")
            ops.append(["DEQUANTIZE", [t], [as_f[t]], {}])
            _bump(b, "DEQUANTIZE", S.INT8_OP_VERSION)
        return as_f[t]

    for run_int8, (name, ins, outs, options) in zip(plan, b.ops):
        if not run_int8:
            ops.append([name, [float_of(t) for t in ins], outs, options])
            continue
        new_ins = [int8_of(t) if t >= 0 and b.value(t) is None else t
                   for t in ins]
        if name in COMPUTE:
            s_in = params(ins[0])[0]
            q, s_w = symmetric_per_channel(b.value(ins[1]))
            new_ins[1] = b.const(q, "INT8", quant=_per_channel(s_w))
            if len(ins) > 2 and ins[2] >= 0:
                s_b = (np.float64(s_in) * s_w.astype(np.float64)).astype(
                    np.float32)
                qb = _round(b.value(ins[2]).astype(np.float64) / s_b)
                new_ins[2] = b.const(np.clip(qb, -2**31, 2**31 - 1).astype(
                    np.int32), "INT32", quant=_per_channel(s_b))
        elif name == "PADV2":
            s, zp = params(outs[0])
            v = np.float64(b.value(ins[2]).reshape(()))
            qv = np.clip(_round(np.float64(v / s)) + zp, QMIN, QMAX) \
                if np.isfinite(v) else (QMIN if v < 0 else QMAX)
            new_ins[2] = b.const(np.int8(qv), "INT8",
                                 quant=_per_tensor(s, zp))
        for t in outs:
            b.tensors[t][1] = "INT8"
            b.quant[t] = _per_tensor(*params(t))
            retyped.add(t)
        _bump(b, name, S.INT8_OP_VERSION)
        ops.append([name, new_ins, outs, options])
    b.outputs = [float_of(t) for t in b.outputs]
    b.ops = ops
    b.prune()
    return b
