"""Darknet-19 backbone (``podtpu/models/darknet.py``).

Six stages (stem + layer1..5) built from ``(out_ch, k)`` / ``"M"`` config
lists; ``Darknet19`` returns the features at ``out_indices``. In train mode
stage0 and layer1's leading pool run as the fused stem
(``models/stem.py``) when :func:`stem_fusable` holds.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from podtpu_torch.models.layers import ConvBnAct, max_pool_2x2
from podtpu_torch.models.stem import fused_stem_pool, stem_fusable

# (out_channels, kernel) conv entries; "M" = 2x2/2 max pool.
STAGE_CFGS = (
    ((32, 3),),                                                     # stem
    ("M", (64, 3)),                                                 # layer1
    ("M", (128, 3), (64, 1), (128, 3)),                             # layer2
    ("M", (256, 3), (128, 1), (256, 3)),                            # layer3
    ("M", (512, 3), (256, 1), (512, 3), (256, 1), (512, 3)),        # layer4
    ("M", (1024, 3), (512, 1), (1024, 3), (512, 1), (1024, 3)),     # layer5
)

STAGE_CHANNELS = (32, 64, 128, 256, 512, 1024)


class _Stage(nn.Module):
    def __init__(self, cfg: tuple, in_ch: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        conv_idx = 0
        for entry in cfg:
            if entry == "M":
                continue
            out_ch, k = entry
            self.add_module(f"conv{conv_idx}",
                            ConvBnAct(in_ch, out_ch, k, dtype=dtype))
            in_ch = out_ch
            conv_idx += 1

    def forward(self, x: torch.Tensor, skip_pool: bool = False
                ) -> torch.Tensor:
        """``skip_pool``: the leading pool already ran (fused stem)."""
        conv_idx = 0
        for entry in self.cfg[1:] if skip_pool else self.cfg:
            if entry == "M":
                x = max_pool_2x2(x)
            else:
                x = getattr(self, f"conv{conv_idx}")(x)
                conv_idx += 1
        return x


class Darknet19(nn.Module):
    """Feature extractor (NCHW); returns the stage outputs at ``out_indices``."""

    def __init__(self, out_indices: Sequence[int] = (5,), in_channels: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.out_indices = tuple(out_indices)
        in_ch = in_channels
        for i, cfg in enumerate(STAGE_CFGS):
            self.add_module(f"stage{i}", _Stage(cfg, in_ch, dtype=dtype))
            in_ch = STAGE_CHANNELS[i]

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        fuse = stem_fusable(x, self.training, self.out_indices)
        if fuse:
            x = fused_stem_pool(self.stage0.conv0, x)
        feats = []
        for i in range(1 if fuse else 0, len(STAGE_CFGS)):
            x = getattr(self, f"stage{i}")(x, skip_pool=fuse and i == 1)
            if i in self.out_indices:
                feats.append(x)
        return feats
