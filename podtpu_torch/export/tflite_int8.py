"""TFLite's integer arithmetic, for the port's reader (``export/tflite.py``).

A quantized ``.tflite`` (``export/tflite_quant.py``) holds int8 tensors
with affine parameters, ``real = scale * (q - zero_point)``. The kernels
here run its operators the way TFLite's reference kernels do, so that the
reader gives the interpreter's int8 codes bit for bit:

* ``QUANTIZE`` rounds ``x / scale`` (float32) half away from zero
  (``TfLiteRound``; ``torch.round`` takes ties to even), adds the zero
  point and clamps to [-128, 127]; ``DEQUANTIZE`` is ``scale * (q - zp)``.
  On the card a tensor divided by a host scalar is multiplied by its
  reciprocal, so the scale is a 0-dim tensor on the device.
* A real multiplier ``m`` is a Q31 integer and a shift
  (:func:`quantize_multiplier`, TFLite's ``QuantizeMultiplier``), applied
  as the rounding doubling high multiply and the rounding right shift
  (:func:`multiply_by_quantized_multiplier`), in int64 tensors that hold
  TFLite's int32 values.
* Int8 ``CONV_2D`` / ``FULLY_CONNECTED``: TFLite sums ``w * (x - zp_in)``
  over the taps inside the image. The reader pads with ``zp_in``
  (``ops/int8_conv.py::int8_im2col_nhwc``), takes one int8 product
  (``int8_matmul``: ``torch._int_mm`` on the card) and subtracts
  ``zp_in * sum(w)`` a channel, so a padded tap adds nothing; then the
  bias, the per-channel requantization by ``s_in * s_w[c] / s_out`` (in
  double), the output zero point and the fused activation's clamp. The
  interpreter's ``FULLY_CONNECTED`` rounds the requantization once
  (:func:`multiply_by_quantized_multiplier_single`), its ``CONV_2D``
  twice, as the reader does.
* ``LEAKY_RELU`` takes one multiplier for x >= zp and one for the alpha
  side; ``ADD`` shifts both inputs left by 20 bits, scales each by its
  multiplier, adds, and scales by the output's.
* Hybrid ``CONV_2D`` / ``FULLY_CONNECTED`` (a float input, an int8 filter:
  the dynamic range files) quantize each image (``CONV_2D``) or each row
  (``FULLY_CONNECTED``) of the input asymmetrically with its own scale and
  zero point (``AsymmetricQuantizeFloats``, as the interpreter's vector
  loop rounds: :func:`asymmetric_quantize`), take the integer product and
  rescale it in float32 by the input's scale and the filter's channel
  scale, plus the float bias.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from podtpu_torch.ops.int8_conv import int8_im2col_nhwc, int8_matmul

QMIN, QMAX = -128, 127


def same_pads(size: int, k: int, stride: int, dilation: int):
    """TFLite's SAME padding of one axis: (before, after)."""
    eff = (k - 1) * dilation + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + eff - size, 0)
    return total // 2, total - total // 2


def conv_pads(o: dict, h: int, w: int, kh: int, kw: int):
    """(top, bottom, left, right) of a ``CONV_2D``'s options."""
    if o["padding"] != 0:  # VALID
        return 0, 0, 0, 0
    return same_pads(h, kh, o["stride_h"], o["dilation_h_factor"]) + \
        same_pads(w, kw, o["stride_w"], o["dilation_w_factor"])


# ---- the arithmetic ---------------------------------------------------------

def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """``std::round`` of a float tensor: ties away from zero."""
    t = torch.trunc(x)
    return torch.where((x - t).abs() == 0.5, t + torch.sign(x),
                       torch.round(x))


def np_round_half_away(x):
    """``std::round`` of float64 numbers (numpy)."""
    return np.sign(x) * np.floor(np.abs(x) + 0.5)


def nudged_scale_and_zero_point(rmin: torch.Tensor, rmax: torch.Tensor):
    """TFLite's int8 range of [rmin, rmax] (float64 tensors, each range
    already holding 0): ``(rmax - rmin) / 255`` and the zero point from
    the end whose error is smaller, rounded and clamped; scale 1 and zero
    point 0 where rmin == rmax. Its quantizer's rule for a calibrated
    range and its hybrid kernels' for each input row."""
    flat = rmin == rmax
    scale = torch.where(flat, 1.0, (rmax - rmin) / (QMAX - QMIN))
    from_min = QMIN - rmin / scale
    from_max = QMAX - rmax / scale
    err_min = abs(QMIN) + (rmin / scale).abs()
    err_max = abs(QMAX) + (rmax / scale).abs()
    zpd = torch.where(err_min < err_max, from_min, from_max)
    zp = round_half_away(zpd).clamp(QMIN, QMAX).long()
    return scale, torch.where(flat, 0, zp)


def quantize_multiplier(m: float) -> tuple[int, int]:
    """TFLite's ``QuantizeMultiplier``: ``m = q * 2^shift`` with q a Q31
    integer in [2^30, 2^31)."""
    if m == 0.0:
        return 0, 0
    q, shift = math.frexp(m)
    q_fixed = int(np_round_half_away(q * (1 << 31)))
    if q_fixed == 1 << 31:
        q_fixed //= 2
        shift += 1
    if shift < -31:
        return 0, 0
    return q_fixed, shift


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    return ((x + 2**31) & (2**32 - 1)) - 2**31


def multiply_by_quantized_multiplier(x: torch.Tensor, mult, shift
                                     ) -> torch.Tensor:
    """TFLite's ``MultiplyByQuantizedMultiplier`` on int64 tensors holding
    int32 values; ``mult`` and ``shift`` ints or int64 tensors that
    broadcast against ``x`` (one a channel)."""
    mult = torch.as_tensor(mult, dtype=torch.int64, device=x.device)
    shift = torch.as_tensor(shift, dtype=torch.int64, device=x.device)
    left = shift.clamp(min=0)
    right = (-shift).clamp(min=0)
    x = _wrap32(torch.bitwise_left_shift(x, left))
    # SaturatingRoundingDoublingHighMul: (x m + nudge) / 2^31, truncated
    ab = x * mult
    nudge = torch.where(ab >= 0, 1 << 30, 1 - (1 << 30))
    high = torch.div(ab + nudge, 1 << 31, rounding_mode="trunc")
    high = torch.where((x == mult) & (x == -2**31), 2**31 - 1, high)
    # RoundingDivideByPOT(high, right)
    mask = torch.bitwise_left_shift(torch.ones_like(right), right) - 1
    remainder = high & mask
    threshold = (mask >> 1) + (high < 0).long()
    return (high >> right) + (remainder > threshold).long()


def multiply_by_quantized_multiplier_single(x: torch.Tensor, mult, shift
                                            ) -> torch.Tensor:
    """The single-rounding form the interpreter's int8 ``FULLY_CONNECTED``
    takes (its product goes through ruy): ``(x m + 2^(s - 1)) >> s`` with
    ``s = 31 - shift``, on int64 tensors."""
    mult = torch.as_tensor(mult, dtype=torch.int64, device=x.device)
    total = 31 - torch.as_tensor(shift, dtype=torch.int64, device=x.device)
    nudge = torch.bitwise_left_shift(torch.ones_like(total), total - 1)
    return (x * mult + nudge) >> total


def activation_range(code: int, scale: float, zp: int) -> tuple[int, int]:
    """``CalculateActivationRangeQuantized`` of a fused activation."""
    def q(f):
        return zp + int(np_round_half_away(np.float32(f)
                                           / np.float32(scale)))
    if code == 0:
        return QMIN, QMAX
    if code == 1:  # RELU
        return max(QMIN, q(0.0)), QMAX
    if code == 3:  # RELU6
        return max(QMIN, q(0.0)), min(QMAX, q(6.0))
    raise NotImplementedError(f"fused activation {code} on int8")


def per_channel_multipliers(s_in: float, s_w: np.ndarray, s_out: float,
                            n: int, device) -> tuple[torch.Tensor, ...]:
    """Each channel's ``(double)s_in * s_w[c] / s_out`` as (multiplier,
    shift) int64 tensors [n]; a per-tensor ``s_w`` serves every channel."""
    s_w = np.broadcast_to(np.asarray(s_w, np.float32).reshape(-1), (n,))
    pairs = [quantize_multiplier(float(s_in) * float(s) / float(s_out))
             for s in s_w]
    mult, shift = zip(*pairs)
    return (torch.tensor(mult, dtype=torch.int64, device=device),
            torch.tensor(shift, dtype=torch.int64, device=device))


def asymmetric_quantize(x: torch.Tensor):
    """TFLite's ``AsymmetricQuantizeFloats`` of each row of ``x`` [N, D]
    float32: (int8 [N, D], scale float32 [N], zero point int64 [N])."""
    rmin = x.amin(1).clamp(max=0.0).double()
    rmax = x.amax(1).clamp(min=0.0).double()
    flat = rmin == rmax
    scale, zp = nudged_scale_and_zero_point(rmin, rmax)
    sf = scale.float()
    y = x * (1.0 / sf)[:, None]
    # the interpreter's vector loop (NEON, through SSE on x86) rounds
    # trunc(y +- 0.5) in float32; the tail past the last multiple of 8
    # rounds half away from zero; the zero point is added after rounding
    r = torch.trunc(y + torch.where(y < 0, -0.5, 0.5))
    tail = x.shape[1] // 8 * 8
    r[:, tail:] = round_half_away(y[:, tail:])
    q = (r + zp[:, None]).clamp(QMIN, QMAX)
    q = torch.where(flat[:, None], 0.0, q)
    return q.to(torch.int8), sf, zp


# ---- the kernels ------------------------------------------------------------

def _qparam(p, t: int) -> tuple[float, int]:
    """The per-tensor (scale, zero point) of tensor ``t``."""
    q = p.f.quant.get(t)
    if q is None or len(q[0]) != 1:
        raise ValueError(f"tensor {t} ({p.f.tensors[t][0]}) needs one scale "
                         "and zero point")
    return float(q[0][0]), int(q[1][0])


def _scalar(value, device, dtype=torch.float32) -> torch.Tensor:
    return torch.tensor(value, dtype=dtype, device=device)


def k_quantize(p, name, ins, outs, o):
    if p.f.tensors[ins[0]][2] != "FLOAT32":
        raise NotImplementedError("QUANTIZE of an integer tensor "
                                  "(requantization)")
    s, zp = _qparam(p, outs[0])
    scale = _scalar(np.float32(s), p.device)
    (a,), (out,) = ins, outs

    def run(v):
        q = round_half_away(v[a] / scale) + zp
        v[out] = q.clamp(QMIN, QMAX).to(torch.int8)
    return run


def k_dequantize(p, name, ins, outs, o):
    s, zp = _qparam(p, ins[0])
    scale = _scalar(np.float32(s), p.device)
    (a,), (out,) = ins, outs

    def run(v):
        v[out] = (v[a].float() - zp) * scale
    return run


def _filter(p, t: int):
    """An int8 filter ``[O, ...]`` as ``[O, K]`` on the device, its
    per-channel sums (int64 [O]) and scales."""
    w = p.value(t)
    if w.dtype != np.int8:
        raise ValueError(f"filter {p.f.tensors[t][0]} is {w.dtype}, not int8")
    scale, zp, dim = p.f.quant[t]
    if dim != 0 or np.any(zp != 0):
        raise NotImplementedError("an int8 filter quantized along another "
                                  "axis than 0 or with a zero point")
    o = w.shape[0]
    wm = p.upload(t, lambda x: x.reshape(o, -1).contiguous())
    wsum = torch.from_numpy(w.reshape(o, -1).astype(np.int64).sum(1)).to(
        p.device)
    return wm, wsum, scale


def _requantize(p, x_t: int, w_scale, out: int, act: int, n: int,
                multiply=multiply_by_quantized_multiplier):
    """A function of ``acc`` int64 [..., n] (bias added) -> int8: the
    per-channel multiplier, the output zero point, the activation's
    clamp."""
    s_in, _ = _qparam(p, x_t)
    s_out, zp_out = _qparam(p, out)
    mult, shift = per_channel_multipliers(s_in, w_scale, s_out, n, p.device)
    lo, hi = activation_range(act, s_out, zp_out)

    def run(acc):
        y = multiply(acc, mult, shift) + zp_out
        return y.clamp(lo, hi).to(torch.int8)
    return run


def _int_bias(p, ins, n: int):
    if len(ins) > 2 and ins[2] >= 0:
        return p.upload(ins[2], lambda b: b.long())
    return torch.zeros(n, dtype=torch.int64, device=p.device)


def _float_bias(p, ins, n: int):
    if len(ins) > 2 and ins[2] >= 0:
        return p.upload(ins[2])
    return torch.zeros(n, dtype=torch.float32, device=p.device)


def _conv_geometry(p, ins, o):
    _, h, w, _ = p.shape(ins[0])
    _, kh, kw, _ = p.shape(ins[1])
    return (kh, kw, (o["stride_h"], o["stride_w"]),
            (o["dilation_h_factor"], o["dilation_w_factor"]),
            conv_pads(o, h, w, kh, kw))


def k_conv_int8(p, name, ins, outs, o):
    x_t, out = ins[0], outs[0]
    wm, wsum, w_scale = _filter(p, ins[1])
    n = wm.shape[0]
    zp_in = _qparam(p, x_t)[1]
    bias = _int_bias(p, ins, n) - zp_in * wsum
    kh, kw, stride, dil, pads = _conv_geometry(p, ins, o)
    requant = _requantize(p, x_t, w_scale, out, o[
        "fused_activation_function"], n)

    def run(v):
        x = v[x_t]
        cols, ho, wo = int8_im2col_nhwc(x, kh, kw, stride, dil, pads, zp_in)
        acc = int8_matmul(cols, wm).long() + bias
        v[out] = requant(acc).reshape(x.shape[0], ho, wo, n)
    return run


def k_fc_int8(p, name, ins, outs, o):
    if o["weights_format"]:
        raise NotImplementedError("shuffled FULLY_CONNECTED weights")
    x_t, out = ins[0], outs[0]
    wm, wsum, w_scale = _filter(p, ins[1])
    n = wm.shape[0]
    bias = _int_bias(p, ins, n) - _qparam(p, x_t)[1] * wsum
    requant = _requantize(p, x_t, w_scale, out, o[
        "fused_activation_function"], n,
        multiply_by_quantized_multiplier_single)
    shape = p.shape(out)

    def run(v):
        x = v[x_t].reshape(-1, wm.shape[1])
        v[out] = requant(int8_matmul(x, wm).long() + bias).reshape(shape)
    return run


def _float_act(code: int):
    if code == 0:
        return lambda x: x
    if code == 1:
        return torch.relu
    if code == 3:
        return lambda x: x.clamp(0.0, 6.0)
    raise NotImplementedError(f"fused activation {code}")


def k_conv_hybrid(p, name, ins, outs, o):
    """The reference kernel's ``HybridConvPerChannel``: each image
    quantized on its own; ``float(acc) * s_w[c] * s_x[b] + bias[c]``."""
    x_t, out = ins[0], outs[0]
    wm, wsum, w_scale = _filter(p, ins[1])
    n = wm.shape[0]
    s_w = torch.from_numpy(np.broadcast_to(w_scale, (n,)).astype(
        np.float32)).to(p.device)
    bias = _float_bias(p, ins, n)
    kh, kw, stride, dil, pads = _conv_geometry(p, ins, o)
    act = _float_act(o["fused_activation_function"])

    def run(v):
        x = v[x_t]
        b = x.shape[0]
        xq, sf, zp = asymmetric_quantize(x.reshape(b, -1))
        cols, ho, wo = int8_im2col_nhwc(xq.reshape(x.shape), kh, kw, stride,
                                        dil, pads, zp)
        acc = int8_matmul(cols, wm).long().reshape(b, ho * wo, n)
        acc = acc - zp[:, None, None] * wsum
        y = acc.float() * s_w * sf[:, None, None] + bias
        v[out] = act(y).reshape(b, ho, wo, n)
    return run


def k_fc_hybrid(p, name, ins, outs, o):
    """The hybrid ``FULLY_CONNECTED`` with asymmetric inputs: each row
    quantized on its own; ``bias[c] + float(acc) * (s_x[r] * s_w[c])``."""
    if o["weights_format"]:
        raise NotImplementedError("shuffled FULLY_CONNECTED weights")
    if not o["asymmetric_quantize_inputs"]:
        raise NotImplementedError("a hybrid FULLY_CONNECTED with symmetric "
                                  "input quantization")
    x_t, out = ins[0], outs[0]
    wm, wsum, w_scale = _filter(p, ins[1])
    n = wm.shape[0]
    s_w = torch.from_numpy(np.broadcast_to(w_scale, (n,)).astype(
        np.float32)).to(p.device)
    bias = _float_bias(p, ins, n)
    act = _float_act(o["fused_activation_function"])
    shape = p.shape(out)

    def run(v):
        xq, sf, zp = asymmetric_quantize(v[x_t].reshape(-1, wm.shape[1]))
        acc = int8_matmul(xq, wm).long() - zp[:, None] * wsum
        y = bias + acc.float() * (sf[:, None] * s_w)
        v[out] = act(y).reshape(shape)
    return run


def k_leaky_int8(p, name, ins, outs, o):
    """``QuantizeLeakyRelu``: the identity multiplier ``s_in / s_out`` and
    the alpha one ``s_in * alpha / s_out``, each computed in float32 as
    TFLite's kernel does."""
    (a,), (out,) = ins[:1], outs
    s_in, zp_in = _qparam(p, a)
    s_out, zp_out = _qparam(p, out)
    f32 = np.float32
    alpha_m = quantize_multiplier(float(f32(f32(s_in) * f32(o["alpha"]))
                                        / f32(s_out)))
    ident_m = quantize_multiplier(float(f32(s_in) / f32(s_out)))

    def run(v):
        x = v[a].long() - zp_in
        y = torch.where(x >= 0,
                        multiply_by_quantized_multiplier(x, *ident_m),
                        multiply_by_quantized_multiplier(x, *alpha_m))
        v[out] = (y + zp_out).clamp(QMIN, QMAX).to(torch.int8)
    return run


def k_add_int8(p, name, ins, outs, o):
    """TFLite's int8 ``ADD``: both inputs shifted left by 20 bits and
    scaled by ``s_i / (2 max(s_1, s_2))``, summed, and scaled by
    ``2 max(s_1, s_2) / (2^20 s_out)``."""
    (a, b), (out,) = ins, outs
    (s1, z1), (s2, z2) = _qparam(p, a), _qparam(p, b)
    s_out, zp_out = _qparam(p, out)
    f32 = np.float32
    twice_max = float(2 * max(f32(s1), f32(s2)))
    m1 = quantize_multiplier(float(f32(s1)) / twice_max)
    m2 = quantize_multiplier(float(f32(s2)) / twice_max)
    mo = quantize_multiplier(twice_max / float(f32(1 << 20) * f32(s_out)))
    lo, hi = activation_range(o.get("fused_activation_function", 0), s_out,
                              zp_out)

    def run(v):
        x1 = multiply_by_quantized_multiplier((v[a].long() - z1) << 20, *m1)
        x2 = multiply_by_quantized_multiplier((v[b].long() - z2) << 20, *m2)
        y = multiply_by_quantized_multiplier(x1 + x2, *mo) + zp_out
        v[out] = y.clamp(lo, hi).to(torch.int8)
    return run


# kernels of an operator whose first input is int8 (or, for QUANTIZE,
# whose output is)
INT8_KERNELS = {"QUANTIZE": k_quantize, "DEQUANTIZE": k_dequantize,
                "CONV_2D": k_conv_int8, "FULLY_CONNECTED": k_fc_int8,
                "LEAKY_RELU": k_leaky_int8, "ADD": k_add_int8}
# kernels of an operator with a float input and an int8 filter
HYBRID_KERNELS = {"CONV_2D": k_conv_hybrid, "FULLY_CONNECTED": k_fc_hybrid}
