"""Core conv building blocks (``podtpu/models/layers.py``).

Tensors are NCHW inside the model (the input is an NHWC batch permuted to
NCHW, which is a ``channels_last`` view, so cuDNN keeps that layout). As in
``podtpu``:

* convolutions are bias-free with symmetric ``(k-1)//2`` padding;
* parameters and BN statistics are float32; the convolution and the BN
  multiply-add run in the compute dtype (bf16 for the flagship config);
* the BN epilogue is one compute-dtype multiply-add whose ``mul``/``add``
  are folded in float32 from the statistics: the running ones in eval
  mode, the batch's in train mode (``module.train()``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class BatchNormMixed(nn.Module):
    """BatchNorm with float32 statistics, compute-dtype apply.

    ``weight``/``bias``/``running_mean``/``running_var`` carry ``podtpu``'s
    ``bn/scale``, ``bn/bias``, ``batch_stats/mean`` and ``batch_stats/var``.

    In train mode the statistics are the batch's, taken in float32 from the
    compute-dtype input: ``mean`` and ``var = max(0, E[x^2] - mean^2)``,
    differentiated through as flax does; the running statistics then move
    with decay ``momentum`` and the unbiased (Bessel) variance, as torch
    and ``podtpu`` update them. ``F.batch_norm`` is not used: it rounds
    at other places.
    """

    momentum = 0.9  # running-stat decay (torch's momentum 0.1)

    def __init__(self, features: int, dtype: torch.dtype = torch.float32,
                 eps: float = 1e-5):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    @torch.no_grad()
    def update_running_stats(self, mean: torch.Tensor, var: torch.Tensor,
                             n: int):
        """Fold one batch's statistics (over ``n`` values per channel) into
        the running ones."""
        bessel = n / max(n - 1, 1)
        m = self.momentum
        self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
        self.running_var.copy_(m * self.running_var
                               + (1.0 - m) * bessel * var)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            x32 = x.float()
            mean = x32.mean(dim=(0, 2, 3))
            var = ((x32 * x32).mean(dim=(0, 2, 3)) - mean * mean
                   ).clamp_min(0.0)
            self.update_running_stats(mean, var, x.numel() // x.shape[1])
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        # y = (x - mean) * inv + bias, folded into one multiply-add
        mul = inv.to(self.dtype)[:, None, None]
        add = (self.bias - mean * inv).to(self.dtype)[:, None, None]
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
