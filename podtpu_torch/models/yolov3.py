"""YOLOv3 detector (``podtpu/models/yolov3.py``).

Darknet-19 taps c3/c4/c5; top-down FPN with conv-route + 2x nearest
upsample; three heads each predicting 3*(5+C) channels. Takes an NHWC
float batch and returns (p3, p4, p5) NHWC float32 raw logits at strides
8/16/32, as ``podtpu`` does. ``remat``: cfg ``remat_backbone``, the
backbone's stages recomputed in the backward (``models/darknet.py``).
"""

from __future__ import annotations

import torch
from torch import nn

from podtpu_torch.models.darknet import Darknet19
from podtpu_torch.models.layers import ConvBnAct, HeadConv, upsample_nearest_2x


class _ConvTriple(nn.Module):
    """1x1 -> 3x3 -> 1x1 squeeze/expand trio."""

    def __init__(self, in_ch: int, mid: int, dtype: torch.dtype):
        super().__init__()
        self.c0 = ConvBnAct(in_ch, mid, 1, dtype=dtype)
        self.c1 = ConvBnAct(mid, mid * 2, 3, dtype=dtype)
        self.c2 = ConvBnAct(mid * 2, mid, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c2(self.c1(self.c0(x)))


class _Head(nn.Module):
    """3x3 expand + 1x1 raw prediction conv."""

    def __init__(self, in_ch: int, mid: int, out: int, dtype: torch.dtype):
        super().__init__()
        self.expand = ConvBnAct(in_ch, mid, 3, dtype=dtype)
        self.pred = HeadConv(mid, out, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pred(self.expand(x))


class YoloV3(nn.Module):
    def __init__(self, num_classes: int, num_anchors: int = 9,
                 in_channels: int = 3, dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        if num_anchors != 9:
            raise ValueError(f"YOLOv3 takes 9 anchors (3 per scale), "
                             f"got {num_anchors}")
        out_ch = num_anchors // 3 * (num_classes + 5)
        self.backbone = Darknet19(out_indices=(3, 4, 5),
                                  in_channels=in_channels, dtype=dtype,
                                  remat=remat)
        self.c5_conv = _ConvTriple(1024, 512, dtype)
        self.p5_head = _Head(512, 1024, out_ch, dtype)
        self.c5_route = ConvBnAct(512, 256, 3, dtype=dtype)
        self.c4_conv = _ConvTriple(256 + 512, 256, dtype)
        self.p4_head = _Head(256, 512, out_ch, dtype)
        self.c4_route = ConvBnAct(256, 128, 3, dtype=dtype)
        self.c3_conv = _ConvTriple(128 + 256, 128, dtype)
        self.p3_head = _Head(128, 256, out_ch, dtype)

    def forward(self, x: torch.Tensor):
        # NHWC -> NCHW view with channels_last strides
        x = x.permute(0, 3, 1, 2)
        c3, c4, c5 = self.backbone(x)

        c5 = self.c5_conv(c5)
        p5 = self.p5_head(c5)

        c5_route = upsample_nearest_2x(self.c5_route(c5))
        c4 = self.c4_conv(torch.cat([c5_route, c4], dim=1))
        p4 = self.p4_head(c4)

        c4_route = upsample_nearest_2x(self.c4_route(c4))
        c3 = self.c3_conv(torch.cat([c4_route, c3], dim=1))
        p3 = self.p3_head(c3)

        return tuple(p.permute(0, 2, 3, 1).contiguous() for p in (p3, p4, p5))
