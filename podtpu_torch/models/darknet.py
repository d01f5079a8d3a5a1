"""Darknet-19 backbone (``podtpu/models/darknet.py``).

Six stages (stem + layer1..5) built from ``(out_ch, k)`` / ``"M"`` config
lists; ``Darknet19`` returns the features at ``out_indices``, and
``Darknet19Classifier`` adds the dropout -> conv1x1 -> global-mean head of
backbone pretraining (``cli/pretrain_darknet.py``). In train mode
stage0 and layer1's leading pool run as the fused stem
(``models/stem.py``) when :func:`stem_fusable` holds and the stem block is
not under QAT (the fused op has no fake-quant).

``remat`` (cfg ``remat_backbone``, YOLOv3 only as in ``podtpu``): each
stage's forward is recomputed in the backward in place of keeping its
activations (``torch.utils.checkpoint``); the recompute leaves the BN
running statistics alone (``layers.recompute_context``), so they move
once a step. The fused stem stays outside the recomputed stages.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from podtpu_torch.models.layers import (
    ConvBnAct,
    SeededDropout,
    max_pool_2x2,
    recompute_context,
)
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
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.out_indices = tuple(out_indices)
        self.remat = remat
        in_ch = in_channels
        for i, cfg in enumerate(STAGE_CFGS):
            self.add_module(f"stage{i}", _Stage(cfg, in_ch, dtype=dtype))
            in_ch = STAGE_CHANNELS[i]

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        stem = self.stage0.conv0
        fuse = (stem_fusable(x, self.training, self.out_indices)
                and not stem.qat and not stem.quantized)
        if fuse:
            x = fused_stem_pool(self.stage0.conv0, x)
        remat = self.remat and self.training and torch.is_grad_enabled()
        feats = []
        for i in range(1 if fuse else 0, len(STAGE_CFGS)):
            stage, skip = getattr(self, f"stage{i}"), fuse and i == 1
            if remat:
                x = checkpoint(stage, x, skip, use_reentrant=False,
                               preserve_rng_state=False,
                               context_fn=_recompute_contexts)
            else:
                x = stage(x, skip_pool=skip)
            if i in self.out_indices:
                feats.append(x)
        return feats


def _recompute_contexts():
    """``checkpoint``'s (forward, recompute) contexts."""
    return nullcontext(), recompute_context()


class Darknet19Classifier(nn.Module):
    """Classification variant for backbone pretraining: ``Darknet19``'s c5,
    dropout 0.5 (train mode), ``classifier`` = ConvBnAct(num_classes, 1)
    with its ReLU, then the float32 mean over the map. Takes an NHWC batch
    and returns float32 logits [B, num_classes].

    The ``backbone`` scope is the detectors' own, so the weights it saves
    load into any Darknet-19 detector through cfg ``backbone_pretrained``.
    With ``qat`` the backbone's blocks fake-quantize in train mode (the
    fused stem is then off) and the classifier does not, as in
    ``podtpu``."""

    def __init__(self, num_classes: int = 1000, in_channels: int = 3,
                 dtype: torch.dtype = torch.float32, qat: bool = False,
                 dropout_rate: float = 0.5):
        super().__init__()
        self.backbone = Darknet19(out_indices=(5,), in_channels=in_channels,
                                  dtype=dtype)
        for m in self.backbone.modules():
            if isinstance(m, ConvBnAct):
                m.qat = qat
        self.dropout = SeededDropout(dropout_rate)
        self.classifier = ConvBnAct(STAGE_CHANNELS[-1], num_classes, 1,
                                    dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # NHWC -> NCHW view with channels_last strides
        x = self.backbone(x.permute(0, 3, 1, 2))[0]
        x = self.classifier(self.dropout(x))
        return x.float().mean(dim=(2, 3))
