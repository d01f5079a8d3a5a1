"""YOLOv2 detector (``podtpu/models/yolov2.py``).

Darknet-19 taps layer4 (512 ch, /16) and layer5 (1024 ch, /32). The
passthrough branch is a 1x1 conv to 64 ch and the reference's raw ``.view``
reorg to /32 (:func:`~podtpu_torch.models.layers.passthrough_reorg`),
concatenated before the two 3x3 convs to 1024 ch of the deep branch, then a
3x3 conv to 1024 ch and the 1x1 prediction conv. Takes an NHWC float batch
and returns one NHWC float32 tensor [B, H/32, W/32, A*(5+C)] of raw logits,
as ``podtpu`` does.
"""

from __future__ import annotations

import torch
from torch import nn

from podtpu_torch.models.darknet import Darknet19
from podtpu_torch.models.layers import (
    ConvBnAct,
    HeadConv,
    cat_channels,
    passthrough_reorg,
)


class YoloV2(nn.Module):
    def __init__(self, num_classes: int, num_anchors: int = 5,
                 in_channels: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.backbone = Darknet19(out_indices=(4, 5), in_channels=in_channels,
                                  dtype=dtype)
        self.b4_layer = ConvBnAct(512, 64, 1, dtype=dtype)
        self.b5_layer0 = ConvBnAct(1024, 1024, 3, dtype=dtype)
        self.b5_layer1 = ConvBnAct(1024, 1024, 3, dtype=dtype)
        self.head_conv = ConvBnAct(256 + 1024, 1024, 3, dtype=dtype)
        self.head = HeadConv(1024, num_anchors * (num_classes + 5),
                             dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # NHWC -> NCHW view with channels_last strides
        b4, b5 = self.backbone(x.permute(0, 3, 1, 2))
        b4 = passthrough_reorg(self.b4_layer(b4))
        b5 = self.b5_layer1(self.b5_layer0(b5))
        x = self.head_conv(cat_channels([b4, b5]))  # 256 + 1024 ch
        return self.head(x).permute(0, 2, 3, 1).contiguous()
