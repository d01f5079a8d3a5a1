"""ResNet backbone for RetinaNet (``podtpu/models/resnet.py``).

Standard bottleneck ResNet-50 with feature taps at C3/C4/C5 (strides
8/16/32): a 7x7 stride-2 ``ConvBnAct`` stem, a 3x3 stride-2 max pool, then
four stages of ``Bottleneck`` blocks. Compute-dtype convs with float32 BN,
as the Darknet backbone. Submodules carry ``podtpu``'s scope names
(``stem``, ``stage{n}_block{k}.{conv1,conv2,conv3,downsample}``), so its
flat weights map by path.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from podtpu_torch.models.layers import ConvBnAct, add_maps
from podtpu_torch.parallel import layouts

WIDTHS = (64, 128, 256, 512)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (strided) -> 1x1 to 4x the width, plus the residual: a
    1x1 ``downsample`` where the width or the stride changes. Ends in
    ``relu(y + residual)`` in the compute dtype."""

    def __init__(self, in_ch: int, features: int, strides: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = ConvBnAct(in_ch, features, 1, dtype=dtype)
        self.conv2 = ConvBnAct(features, features, 3, strides=strides,
                               dtype=dtype)
        self.conv3 = ConvBnAct(features, features * 4, 1, act=None,
                               dtype=dtype)
        self.downsample = None
        if in_ch != features * 4 or strides != 1:
            self.downsample = ConvBnAct(in_ch, features * 4, 1,
                                        strides=strides, act=None,
                                        dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv3(self.conv2(self.conv1(x)))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(add_maps(y, residual)).to(self.dtype)


class ResNet(nn.Module):
    """NCHW in, the feature maps of the stages in ``out_indices`` out
    (2, 3, 4 = C3, C4, C5)."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 in_channels: int = 3, dtype: torch.dtype = torch.float32,
                 out_indices: Sequence[int] = (2, 3, 4)):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.out_indices = tuple(out_indices)
        self.stem = ConvBnAct(in_channels, 64, 7, strides=2, dtype=dtype)
        in_ch = 64
        for stage, (n_blocks, width) in enumerate(zip(self.stage_sizes,
                                                      WIDTHS)):
            for block in range(n_blocks):
                strides = 2 if (block == 0 and stage > 0) else 1
                self.add_module(f"stage{stage + 1}_block{block}",
                                Bottleneck(in_ch, width, strides, dtype))
                in_ch = width * 4

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        # pad 1 with -inf, as flax's max_pool pads
        x = layouts.max_pool2d(self.stem(x), 3, 2, 1)
        feats = []
        for stage, n_blocks in enumerate(self.stage_sizes):
            for block in range(n_blocks):
                x = getattr(self, f"stage{stage + 1}_block{block}")(x)
            if stage + 1 in self.out_indices:
                feats.append(x)
        return feats


def resnet50(in_channels: int = 3, dtype: torch.dtype = torch.float32,
             out_indices: Sequence[int] = (2, 3, 4)) -> ResNet:
    return ResNet((3, 4, 6, 3), in_channels=in_channels, dtype=dtype,
                  out_indices=out_indices)
