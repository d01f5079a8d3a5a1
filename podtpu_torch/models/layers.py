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
        # fn(mean, unbiased var) taking a train-mode batch's statistics in
        # place of the running update (``train/steps.py::make_stats_step``)
        self.stats_sink = None

    @torch.no_grad()
    def update_running_stats(self, mean: torch.Tensor, var: torch.Tensor,
                             n: int):
        """Fold one batch's statistics (over ``n`` values per channel) into
        the running ones, or hand them to ``stats_sink`` when one is set
        (the buffers are then left alone)."""
        bessel = n / max(n - 1, 1)
        if self.stats_sink is not None:
            self.stats_sink(mean, bessel * var)
            return
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
    """Conv2d(pad=(k-1)//2 on both sides, bias=False) + BatchNorm + ReLU.

    ``podtpu`` pads symmetrically, so a stride-2 conv is torch's
    ``padding=p, stride=2`` and not a ``'same'`` one."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 3,
                 dtype: torch.dtype = torch.float32, strides: int = 1):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(in_ch, features, kernel_size, stride=strides,
                              padding=(kernel_size - 1) // 2, bias=False)
        self.bn = BatchNormMixed(features, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.conv2d(x.to(self.dtype), self.conv.weight.to(self.dtype),
                     stride=self.conv.stride, padding=self.conv.padding)
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


def passthrough_reorg(x: torch.Tensor) -> torch.Tensor:
    """YOLOv2's raw ``.view(b, 4c, h/2, w/2)`` passthrough (NCHW in and out).

    Not a space-to-depth: the reference reinterprets the contiguous NCHW
    buffer. The port's activations are NCHW tensors with channels_last
    strides, on which ``.view`` raises or reads another order, so this
    reshapes the logical NCHW shape (a copy, which is the semantics) and
    returns it with channels_last strides again for the next conv."""
    b, c, h, w = x.shape
    x = x.reshape(b, c * 4, h // 2, w // 2)
    return x.contiguous(memory_format=torch.channels_last)


class SeededDropout(nn.Module):
    """Inverted dropout (flax ``nn.Dropout``: kept values scaled by
    ``1 / (1 - rate)``) active in train mode only, its mask drawn from a
    ``torch.Generator`` of its own on the input's device.

    :meth:`reseed` seeds it; the train step calls it with the config's seed
    and the step number, as ``podtpu`` folds the step into its dropout key,
    so a resumed run draws the masks it would have drawn. Rate 0 returns
    the input, as flax does."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.seed = 0
        self._gens: dict = {}  # device -> torch.Generator

    def reseed(self, seed: int):
        self.seed = int(seed)
        for g in self._gens.values():
            g.manual_seed(self.seed)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        gen = self._gens.get(x.device)
        if gen is None:
            gen = self._gens[x.device] = torch.Generator(device=x.device)
            gen.manual_seed(self.seed)
        keep = torch.empty(x.shape, device=x.device).bernoulli_(
            1.0 - self.rate, generator=gen).bool()
        return torch.where(keep, x / (1.0 - self.rate), 0.0)
