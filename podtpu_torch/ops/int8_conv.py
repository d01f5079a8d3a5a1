"""The int8 x int8 -> int32 convolution of a quantized ``ConvBnAct``
(``podtpu``'s ``conv_general_dilated(..., preferred_element_type=int32)``,
which XLA lowers outside any Pallas kernel).

* On a CUDA tensor: an int8 im2col (``k * k`` strided slices of the padded
  NHWC input, joined on the channel axis in (row, column, channel) order)
  and one ``torch._int_mm`` product with the OIHW kernel laid out the same
  way. ``_int_mm`` takes ``m > 16`` rows and a depth and a width that are
  multiples of 8, so the rows, the depth (the stem's 27) and the width (a
  class count such as 20) are padded with zeros, which add nothing to the
  sums. The accumulation is integer: exact, where a float32 convolution
  of the same integers is exact only while every partial sum stays below
  2^24 (a 3x3 conv over 1,024 channels reaches 1.5e8).
* On a CPU tensor: the plain version, a float64 convolution of the
  integer-valued tensors cast to int32. Every partial sum is an integer
  below 2^53, so it is exact too, and the two agree bit for bit.

There is no float fallback: a CUDA tensor goes to ``_int_mm`` or the call
raises.

The quantized TFLite reader (``export/tflite_int8.py``) takes the same
route: :func:`int8_im2col_nhwc` pads with a value of its caller's (the
input's zero point, whose taps then add nothing once the zero point's
term is taken off; 0 here) and :func:`int8_matmul` is the product,
``_int_mm`` on the card and the float64 one on the CPU.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# torch._int_mm's shape rules on CUDA
_MIN_ROWS = 17
_ALIGN = 8


def _round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def int8_conv2d_reference(x: torch.Tensor, w: torch.Tensor, stride: int,
                          padding: int) -> torch.Tensor:
    """x int8 NCHW, w int8 OIHW -> int32 NCHW, through a float64 conv."""
    acc = F.conv2d(x.to(torch.float64), w.to(torch.float64), stride=stride,
                   padding=padding)
    return acc.to(torch.int32)


def int8_im2col_nhwc(x: torch.Tensor, kh: int, kw: int, stride, dilation,
                     pads, pad_value) -> tuple[torch.Tensor, int, int]:
    """x int8 NHWC -> ([B * Ho * Wo, kh * kw * C] int8 in (row, column,
    channel) order, Ho, Wo). ``pads`` is (top, bottom, left, right);
    ``pad_value`` an int or a [B] tensor (one value an image)."""
    b, h, w, c = x.shape
    (sh, sw), (dh, dw) = stride, dilation
    top, bottom, left, right = pads
    if top or bottom or left or right:
        fill = torch.as_tensor(pad_value, dtype=x.dtype, device=x.device)
        xp = fill.reshape(-1, 1, 1, 1).expand(
            b, h + top + bottom, w + left + right, c).clone()
        xp[:, top:top + h, left:left + w] = x
        x = xp
    hp, wp = x.shape[1:3]
    ho = (hp - dh * (kh - 1) - 1) // sh + 1
    wo = (wp - dw * (kw - 1) - 1) // sw + 1
    if kh == kw == sh == sw == 1:
        cols = x
    else:
        cols = torch.cat([
            x[:, di * dh:di * dh + sh * (ho - 1) + 1:sh,
              dj * dw:dj * dw + sw * (wo - 1) + 1:sw, :]
            for di in range(kh) for dj in range(kw)], dim=-1)
    return cols.reshape(b * ho * wo, kh * kw * c), ho, wo


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a int8 [M, K] x b int8 [N, K] -> a b^T int32 [M, N]: one
    ``torch._int_mm`` on a CUDA tensor (the rows, the depth and the width
    padded with zeros to its shape rules), a float64 product on a CPU
    tensor (exact: every partial sum is an integer below 2^53)."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int8_matmul takes int8 tensors, got {a.dtype} "
                        f"and {b.dtype}")
    if a.device.type == "cpu":
        return (a.double() @ b.double().t()).to(torch.int32)
    if a.device.type != "cuda":
        raise ValueError(f"int8_matmul takes CPU or CUDA tensors, got "
                         f"{a.device}")
    (m, depth), n = a.shape, b.shape[0]
    mp, dp, np_ = max(m, _MIN_ROWS), _round_up(depth, _ALIGN), \
        _round_up(n, _ALIGN)
    if (mp, dp) != (m, depth):
        a = F.pad(a, (0, dp - depth, 0, mp - m))
    if (np_, dp) != (n, depth):
        b = F.pad(b, (0, dp - depth, 0, np_ - n))
    return torch._int_mm(a.contiguous(), b.contiguous().t())[:m, :n]


def int8_conv2d_cuda(x: torch.Tensor, w: torch.Tensor, stride: int,
                     padding: int) -> torch.Tensor:
    """The im2col + ``torch._int_mm`` route; int32 NCHW (channels_last
    strides)."""
    if x.device.type != "cuda":
        raise ValueError(f"int8_conv2d_cuda takes CUDA tensors, got "
                         f"{x.device}")
    o, _, k, _ = w.shape
    b = x.shape[0]
    cols, ho, wo = int8_im2col_nhwc(x.permute(0, 2, 3, 1), k, k,
                                    (stride, stride), (1, 1),
                                    (padding,) * 4, 0)
    acc = int8_matmul(cols, w.permute(0, 2, 3, 1).reshape(o, cols.shape[1]))
    return acc.reshape(b, ho, wo, o).permute(0, 3, 1, 2)


def int8_conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                padding: int = 0) -> torch.Tensor:
    """int8 x int8 -> int32 convolution. x: int8 NCHW; w: int8 OIHW,
    square. A CUDA tensor takes :func:`int8_conv2d_cuda`, a CPU tensor
    :func:`int8_conv2d_reference`."""
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"int8_conv2d takes int8 tensors, got {x.dtype} "
                        f"and {w.dtype}")
    if x.device.type == "cpu":
        return int8_conv2d_reference(x, w, stride, padding)
    return int8_conv2d_cuda(x, w, stride, padding)
