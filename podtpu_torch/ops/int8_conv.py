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


def int8_im2col(x: torch.Tensor, k: int, stride: int, padding: int
                ) -> tuple[torch.Tensor, int, int]:
    """x int8 NCHW -> ([B * Ho * Wo, k * k * C] int8 in (row, column,
    channel) order, Ho, Wo)."""
    b, c, h, w = x.shape
    xh = x.permute(0, 2, 3, 1)
    if padding:
        xh = F.pad(xh, (0, 0, padding, padding, padding, padding))
    ho = (h + 2 * padding - k) // stride + 1
    wo = (w + 2 * padding - k) // stride + 1
    if k == 1 and stride == 1:
        cols = xh
    else:
        cols = torch.cat([
            xh[:, di:di + stride * (ho - 1) + 1:stride,
               dj:dj + stride * (wo - 1) + 1:stride, :]
            for di in range(k) for dj in range(k)], dim=-1)
    return cols.reshape(b * ho * wo, k * k * c), ho, wo


def int8_conv2d_cuda(x: torch.Tensor, w: torch.Tensor, stride: int,
                     padding: int) -> torch.Tensor:
    """The im2col + ``torch._int_mm`` route; int32 NCHW (channels_last
    strides)."""
    if x.device.type != "cuda":
        raise ValueError(f"int8_conv2d_cuda takes CUDA tensors, got "
                         f"{x.device}")
    o, _, k, _ = w.shape
    b = x.shape[0]
    cols, ho, wo = int8_im2col(x, k, stride, padding)
    m, depth = cols.shape
    mp, dp, op = max(m, _MIN_ROWS), _round_up(depth, _ALIGN), \
        _round_up(o, _ALIGN)
    if (mp, dp) != (m, depth):
        cols = F.pad(cols, (0, dp - depth, 0, mp - m))
    wm = w.permute(0, 2, 3, 1).reshape(o, depth)
    if (op, dp) != (o, depth):
        wm = F.pad(wm, (0, dp - depth, 0, op - o))
    acc = torch._int_mm(cols.contiguous(), wm.contiguous().t())
    acc = acc[:m, :o].reshape(b, ho, wo, o)
    return acc.permute(0, 3, 1, 2)


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
