"""YOLOv4-tiny detector (``podtpu/models/yolov4_tiny.py``).

CSP-tiny backbone (stride-2 stem, stride-2 layer1, three ``V4TinyBlock``
stages with concat skips and 2x2 pools, layer4), a two-route FPN and three
heads. Takes an NHWC float batch and returns (p3, p4, p5) NHWC float32 raw
logits at strides 8/16/32, decoded as YOLOv3's.

The stem is the plain symmetric-pad stride-2 conv: ``podtpu``'s
``PODTPU_STEM=s2d`` is an exact reparameterisation of the same conv for the
TPU's lane layout, and the port does not read it.
"""

from __future__ import annotations

import torch
from torch import nn

from podtpu_torch.models.layers import (
    ConvBnAct,
    HeadConv,
    V4TinyBlock,
    cat_channels,
    max_pool_2x2,
    upsample_nearest_2x,
)


class YoloV4Tiny(nn.Module):
    def __init__(self, num_classes: int, num_anchors: int = 9,
                 in_channels: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        if num_anchors != 9:
            raise ValueError(f"YOLOv4-tiny takes 9 anchors (3 per scale), "
                             f"got {num_anchors}")
        out_ch = num_anchors // 3 * (num_classes + 5)
        dt = dict(dtype=dtype)
        self.stem = ConvBnAct(in_channels, 32, 3, strides=2, **dt)
        self.layer1_0 = ConvBnAct(32, 64, 3, strides=2, **dt)
        self.layer1_1 = ConvBnAct(64, 64, 3, **dt)
        self.tiny_block1 = V4TinyBlock(64, 32, **dt)
        self.layer2 = ConvBnAct(128, 128, 3, **dt)
        self.tiny_block2 = V4TinyBlock(128, 64, **dt)
        self.layer3 = ConvBnAct(256, 256, 3, **dt)
        self.tiny_block3 = V4TinyBlock(256, 128, **dt)
        self.layer4_0 = ConvBnAct(512, 512, 3, **dt)
        self.layer4_1 = ConvBnAct(512, 256, 1, **dt)
        self.p5_expand = ConvBnAct(256, 512, 3, **dt)
        self.p5_pred = HeadConv(512, out_ch, **dt)
        self.b5_route = ConvBnAct(256, 128, 1, **dt)
        self.b4_conv = ConvBnAct(128 + 256, 256, 3, **dt)
        self.p4_pred = HeadConv(256, out_ch, **dt)
        self.b4_route = ConvBnAct(256, 64, 1, **dt)
        self.p3_expand = ConvBnAct(64 + 128, 128, 3, **dt)
        self.p3_pred = HeadConv(128, out_ch, **dt)

    def forward(self, x: torch.Tensor):
        # NHWC -> NCHW view with channels_last strides
        x = self.stem(x.permute(0, 3, 1, 2))
        y = self.layer1_1(self.layer1_0(x))
        x = cat_channels([y, self.tiny_block1(y)])

        y = self.layer2(max_pool_2x2(x))
        b3 = self.tiny_block2(y)
        x = cat_channels([y, b3])

        y = self.layer3(max_pool_2x2(x))
        b4 = self.tiny_block3(y)
        x = cat_channels([y, b4])

        b5 = self.layer4_1(self.layer4_0(max_pool_2x2(x)))

        p5 = self.p5_pred(self.p5_expand(b5))
        b5_route = upsample_nearest_2x(self.b5_route(b5))
        b4 = self.b4_conv(cat_channels([b5_route, b4]))
        p4 = self.p4_pred(b4)
        b4_route = upsample_nearest_2x(self.b4_route(b4))
        p3 = self.p3_pred(self.p3_expand(cat_channels([b4_route, b3])))

        return tuple(p.permute(0, 2, 3, 1).contiguous() for p in (p3, p4, p5))
