"""Core conv building blocks, eval-mode forward (``podtpu/models/layers.py``).

Tensors are NCHW inside the model (the input is an NHWC batch permuted to
NCHW, which is a ``channels_last`` view, so cuDNN keeps that layout). As in
``podtpu``:

* convolutions are bias-free with symmetric ``(k-1)//2`` padding;
* parameters and BN statistics are float32; the convolution and the BN
  multiply-add run in the compute dtype (bf16 for the flagship config);
* the BN epilogue is one compute-dtype multiply-add whose ``mul``/``add``
  are folded in float32 from the running statistics.

Train-mode BatchNorm (batch statistics, running-stat update) belongs to the
training slice and is not here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class BatchNormMixed(nn.Module):
    """Eval-mode BatchNorm with float32 statistics, compute-dtype apply.

    ``weight``/``bias``/``running_mean``/``running_var`` carry ``podtpu``'s
    ``bn/scale``, ``bn/bias``, ``batch_stats/mean`` and ``batch_stats/var``.
    """

    def __init__(self, features: int, dtype: torch.dtype = torch.float32,
                 eps: float = 1e-5):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        # y = (x - mean) * inv + bias, folded into one multiply-add
        mul = inv.to(self.dtype)[:, None, None]
        add = (self.bias - self.running_mean * inv).to(self.dtype)[:, None, None]
        return x.to(self.dtype) * mul + add


class ConvBnAct(nn.Module):
    """Conv2d(stride 1, pad=(k-1)//2, bias=False) + BatchNorm + ReLU."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(in_ch, features, kernel_size,
                              padding=(kernel_size - 1) // 2, bias=False)
        self.bn = BatchNormMixed(features, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.conv2d(x.to(self.dtype), self.conv.weight.to(self.dtype),
                     padding=self.conv.padding)
        return torch.relu(self.bn(x))


class HeadConv(nn.Module):
    """The raw 1x1 prediction conv (bias-free); output is float32."""

    def __init__(self, in_ch: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(in_ch, features, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x.to(self.dtype),
                        self.conv.weight.to(self.dtype)).float()


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 VALID max pool (floor division), NCHW."""
    return F.max_pool2d(x, kernel_size=2, stride=2)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """2x nearest-neighbour upsample, NCHW."""
    return F.interpolate(x, scale_factor=2, mode="nearest")
