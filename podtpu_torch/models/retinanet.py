"""RetinaNet detector (``podtpu/models/retinanet.py``).

ResNet-50 C3/C4/C5 -> FPN P3..P7 (256 channels) -> shared 4-conv class and
box subnets. The FPN and subnet convs are bare biased convs
(:class:`BiasedConv`, a flax ``nn.Conv``), compute dtype in, float32
parameters. The heads are raw logits; the class subnet's last conv bias
starts at -log((1 - pi) / pi), pi = 0.01 (the focal-loss prior), so that
training from scratch is not swamped by easy negatives.

Takes an NHWC float batch and returns a list of five ``(cls [B, 9*C, H, W],
box [B, 9*4, H, W])`` levels, NCHW float32 (``ops/retina.py`` flattens
them anchor by anchor).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from podtpu_torch.models.layers import add_maps, upsample_nearest_2x
from podtpu_torch.models.resnet import resnet50
from podtpu_torch.ops.retina import STRIDES
from podtpu_torch.parallel import layouts

PRIOR_PI = 0.01
ANCHORS_PER_CELL = 9


class BiasedConv(nn.Conv2d):
    """A biased kxk conv with symmetric (k-1)//2 padding run in the compute
    dtype (input, weight and bias cast to it), as flax's
    ``nn.Conv(dtype=..., param_dtype=float32)``. Under the layouts a row
    block takes its window's halo, and a split conv (``tp``) computes its
    output-channel slice with that slice of the whole ``bias``, gathered
    whole over ``model``."""

    tp = None

    def __init__(self, in_ch: int, features: int, kernel_size: int = 3,
                 strides: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__(in_ch, features, kernel_size, stride=strides,
                         padding=(kernel_size - 1) // 2)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = self.bias
        if self.tp is not None:
            x = layouts.enter_model(x)
            bias = bias[layouts.channel_slice(self.tp, bias.shape[0])]
        y = layouts.conv2d(x.to(self.dtype), self.weight.to(self.dtype),
                           bias.to(self.dtype), self.stride, self.padding)
        return y if self.tp is None else layouts.gather_channels(y)


class _Subnet(nn.Module):
    """Four 3x3 256-channel conv + ReLU, then the 3x3 ``pred`` conv; the
    output is float32."""

    def __init__(self, out_channels: int, bias_init_value: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        for i in range(4):
            self.add_module(f"conv{i}", BiasedConv(256, 256, 3, dtype=dtype))
        self.pred = BiasedConv(256, out_channels, 3, dtype=dtype)
        with torch.no_grad():
            self.pred.bias.fill_(bias_init_value)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(4):
            x = torch.relu(getattr(self, f"conv{i}")(x))
        return layouts.whole_rows(self.pred(x).float())


class RetinaNet(nn.Module):
    def __init__(self, num_classes: int, in_channels: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.backbone = resnet50(in_channels, dtype)
        # FPN laterals on C3..C5, smoothing of P3..P5, P6 from C5, P7 from P6
        for level, ch in ((3, 512), (4, 1024), (5, 2048)):
            self.add_module(f"lateral{level}",
                            BiasedConv(ch, 256, 1, dtype=dtype))
            self.add_module(f"smooth{level}",
                            BiasedConv(256, 256, 3, dtype=dtype))
        self.p6 = BiasedConv(2048, 256, 3, strides=2, dtype=dtype)
        self.p7 = BiasedConv(256, 256, 3, strides=2, dtype=dtype)
        self.cls_subnet = _Subnet(
            ANCHORS_PER_CELL * num_classes,
            bias_init_value=-math.log((1.0 - PRIOR_PI) / PRIOR_PI),
            dtype=dtype)
        self.box_subnet = _Subnet(ANCHORS_PER_CELL * 4, dtype=dtype)

    def forward(self, x: torch.Tensor):
        # NHWC -> NCHW view with channels_last strides
        c3, c4, c5 = self.backbone(x.permute(0, 3, 1, 2))
        # the top-down path adds the pre-smoothing P5 and P4
        p5 = self.lateral5(c5)
        p4 = add_maps(self.lateral4(c4), upsample_nearest_2x(p5))
        p3 = add_maps(self.lateral3(c3), upsample_nearest_2x(p4))
        p3, p4, p5 = self.smooth3(p3), self.smooth4(p4), self.smooth5(p5)
        p6 = self.p6(c5)
        p7 = self.p7(torch.relu(p6))
        return [(self.cls_subnet(p), self.box_subnet(p))
                for p in (p3, p4, p5, p6, p7)]


def retinanet_strides() -> Sequence[int]:
    """The strides of P3..P7, the levels the heads come in."""
    return STRIDES
