"""YOLOv4 (full) detector (``podtpu/models/yolov4.py``): CSPDarknet53 +
SPP + PANet.

* CSPDarknet53: stem conv(32, 3) and five CSP stages with block counts
  [1, 2, 8, 8, 4], Mish throughout; stage1 keeps full width in its split.
* SPP: 5/9/13 stride-1 max pools concatenated with the identity, between
  two 1x1/3x3/1x1 trios on c5 (LeakyReLU(0.1) from here on).
* PANet: a top-down path (1x1 route, 2x nearest upsample, 5-conv blocks)
  then a bottom-up one (stride-2 3x3 downsample, 5-conv blocks).
* Heads: 3x3 expand and the bias-free 1x1 prediction conv.

Takes an NHWC float batch and returns (p3, p4, p5) NHWC float32 raw logits
at strides 8/16/32, the contract of YOLOv3 and YOLOv4-tiny (loss
``yolov3_loss_v2``, decoder ``decode_yolov3``). Submodules carry
``podtpu``'s scope names, so its flat weights map by path.
"""

from __future__ import annotations

import torch
from torch import nn

from podtpu_torch.models.layers import (
    ConvBnAct,
    HeadConv,
    SeededDropout,
    cat_channels,
    leaky01,
    mish,
    upsample_nearest_2x,
)
from podtpu_torch.parallel import layouts


def _maxpool_same(x: torch.Tensor, k: int) -> torch.Tensor:
    """Stride-1 kxk max pool with symmetric padding k//2 (SPP's pools).
    torch pads a max pool with -inf, as flax does, so the output keeps the
    input's size however small the map."""
    return layouts.max_pool2d(x, k, 1, k // 2)


class _CSPRes(nn.Module):
    """Residual unit inside a CSP stage: 1x1 squeeze -> 3x3 -> add."""

    def __init__(self, in_ch: int, mid: int, dtype: torch.dtype):
        super().__init__()
        self.c0 = ConvBnAct(in_ch, mid, 1, act=mish, dtype=dtype)
        self.c1 = ConvBnAct(mid, in_ch, 3, act=mish, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.c1(self.c0(x))


class _CSPStage(nn.Module):
    """One CSPDarknet53 stage: stride-2 downsample, split, residual chain,
    transition, cross-stage concat [transition, route], merge."""

    def __init__(self, in_ch: int, features: int, blocks: int,
                 first: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = features if first else features // 2
        kw = dict(act=mish, dtype=dtype)
        self.blocks = blocks
        self.down = ConvBnAct(in_ch, features, 3, strides=2, **kw)
        self.split_route = ConvBnAct(features, hidden, 1, **kw)
        self.split_main = ConvBnAct(features, hidden, 1, **kw)
        for i in range(blocks):
            self.add_module(f"res{i}", _CSPRes(hidden, features // 2, dtype))
        self.transition = ConvBnAct(hidden, hidden, 1, **kw)
        self.merge = ConvBnAct(2 * hidden, features, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.down(x)
        route = self.split_route(x)
        x = self.split_main(x)
        for i in range(self.blocks):
            x = getattr(self, f"res{i}")(x)
        x = self.transition(x)
        return self.merge(cat_channels([x, route]))


class CSPDarknet53(nn.Module):
    """CSPDarknet53 feature extractor (NCHW); returns (c3, c4, c5) at
    /8, /16, /32."""

    def __init__(self, in_channels: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stem = ConvBnAct(in_channels, 32, 3, act=mish, dtype=dtype)
        self.stage1 = _CSPStage(32, 64, 1, first=True, dtype=dtype)
        self.stage2 = _CSPStage(64, 128, 2, dtype=dtype)
        self.stage3 = _CSPStage(128, 256, 8, dtype=dtype)
        self.stage4 = _CSPStage(256, 512, 8, dtype=dtype)
        self.stage5 = _CSPStage(512, 1024, 4, dtype=dtype)

    def forward(self, x: torch.Tensor):
        x = self.stage2(self.stage1(self.stem(x)))
        c3 = self.stage3(x)
        c4 = self.stage4(c3)
        return c3, c4, self.stage5(c4)



class CSPDarknet53Classifier(nn.Module):
    """Classification variant for backbone pretraining: ``CSPDarknet53``'s
    c5, dropout 0.5 (train mode), ``classifier`` = ConvBnAct(num_classes,
    1) with its ReLU, then the float32 mean over the map; NHWC in, float32
    logits [B, num_classes] out. Shares the ``backbone`` scope with
    ``YoloV4``, so its weights load through cfg ``backbone_pretrained``.
    Its stem is a Mish ``ConvBnAct``: it never reaches the fused stem."""

    def __init__(self, num_classes: int = 1000, in_channels: int = 3,
                 dtype: torch.dtype = torch.float32, qat: bool = False,
                 dropout_rate: float = 0.5):
        super().__init__()
        self.backbone = CSPDarknet53(in_channels=in_channels, dtype=dtype)
        for m in self.backbone.modules():
            if isinstance(m, ConvBnAct):
                m.qat = qat
        self.dropout = SeededDropout(dropout_rate)
        self.classifier = ConvBnAct(1024, num_classes, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c5 = self.backbone(x.permute(0, 3, 1, 2))[2]
        x = self.classifier(self.dropout(c5))
        return x.float().mean(dim=(2, 3))

class _ConvTrioLeaky(nn.Module):
    """1x1 squeeze -> 3x3 expand -> 1x1 squeeze (leaky), SPP's sandwich."""

    def __init__(self, in_ch: int, mid: int, dtype: torch.dtype):
        super().__init__()
        self.c0 = ConvBnAct(in_ch, mid, 1, act=leaky01, dtype=dtype)
        self.c1 = ConvBnAct(mid, mid * 2, 3, act=leaky01, dtype=dtype)
        self.c2 = ConvBnAct(mid * 2, mid, 1, act=leaky01, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c2(self.c1(self.c0(x)))


class _FiveConv(nn.Module):
    """PANet 5-conv block: 1x1 C, 3x3 2C, 1x1 C, 3x3 2C, 1x1 C (leaky)."""

    def __init__(self, in_ch: int, mid: int, dtype: torch.dtype):
        super().__init__()
        for i, (ch, k) in enumerate([(mid, 1), (mid * 2, 3), (mid, 1),
                                     (mid * 2, 3), (mid, 1)]):
            self.add_module(f"c{i}", ConvBnAct(in_ch, ch, k, act=leaky01,
                                               dtype=dtype))
            in_ch = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(5):
            x = getattr(self, f"c{i}")(x)
        return x


class YoloV4(nn.Module):
    def __init__(self, num_classes: int, num_anchors: int = 9,
                 in_channels: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        if num_anchors != 9:
            raise ValueError(f"YOLOv4 takes 9 anchors (3 per scale), "
                             f"got {num_anchors}")
        out_ch = num_anchors // 3 * (num_classes + 5)
        kw = dict(act=leaky01, dtype=dtype)
        self.backbone = CSPDarknet53(in_channels, dtype=dtype)
        self.spp_pre = _ConvTrioLeaky(1024, 512, dtype)
        self.spp_post = _ConvTrioLeaky(2048, 512, dtype)
        self.td_route5 = ConvBnAct(512, 256, 1, **kw)
        self.td_lateral4 = ConvBnAct(512, 256, 1, **kw)
        self.td_block4 = _FiveConv(512, 256, dtype)
        self.td_route4 = ConvBnAct(256, 128, 1, **kw)
        self.td_lateral3 = ConvBnAct(256, 128, 1, **kw)
        self.td_block3 = _FiveConv(256, 128, dtype)
        self.p3_expand = ConvBnAct(128, 256, 3, **kw)
        self.p3_pred = HeadConv(256, out_ch, dtype=dtype)
        self.bu_down3 = ConvBnAct(128, 256, 3, strides=2, **kw)
        self.bu_block4 = _FiveConv(512, 256, dtype)
        self.p4_expand = ConvBnAct(256, 512, 3, **kw)
        self.p4_pred = HeadConv(512, out_ch, dtype=dtype)
        self.bu_down4 = ConvBnAct(256, 512, 3, strides=2, **kw)
        self.bu_block5 = _FiveConv(1024, 512, dtype)
        self.p5_expand = ConvBnAct(512, 1024, 3, **kw)
        self.p5_pred = HeadConv(1024, out_ch, dtype=dtype)

    def forward(self, x: torch.Tensor):
        # NHWC -> NCHW view with channels_last strides
        c3, c4, c5 = self.backbone(x.permute(0, 3, 1, 2))

        # SPP sandwich on c5: trio -> pools 13/9/5 and the identity -> trio
        x5 = self.spp_pre(c5)
        x5 = cat_channels([_maxpool_same(x5, 13), _maxpool_same(x5, 9),
                        _maxpool_same(x5, 5), x5])
        n5 = self.spp_post(x5)

        # top-down
        r5 = upsample_nearest_2x(self.td_route5(n5))
        n4 = self.td_block4(cat_channels([self.td_lateral4(c4), r5]))
        r4 = upsample_nearest_2x(self.td_route4(n4))
        n3 = self.td_block3(cat_channels([self.td_lateral3(c3), r4]))

        # bottom-up and the heads
        p3 = self.p3_pred(self.p3_expand(n3))
        m4 = self.bu_block4(cat_channels([self.bu_down3(n3), n4]))
        p4 = self.p4_pred(self.p4_expand(m4))
        m5 = self.bu_block5(cat_channels([self.bu_down4(m4), n5]))
        p5 = self.p5_pred(self.p5_expand(m5))

        return tuple(p.permute(0, 2, 3, 1).contiguous() for p in (p3, p4, p5))
