"""YOLOv1 detector (``podtpu/models/yolov1.py``).

Darknet-19's last stage (1024 ch, /32: 14x14 at 448 px), five conv-BN-ReLU
layers (``head1`` of stride 2: 7x7), a flatten, dropout 0.5 in train mode,
and a linear layer to ``7*7*(C + 5*B)`` raw float32 logits.

``podtpu`` flattens an NHWC map, so the port permutes its NCHW activation
to (h, w, c) order before the flatten, and ``podtpu``'s Dense kernel
[in, out] is ``fc.weight`` transposed. The linear layer runs in the compute
dtype on float32 parameters, as ``nn.Dense(dtype=bf16, param_dtype=f32)``.
"""

from __future__ import annotations

import torch
from torch import nn

from podtpu_torch.models.darknet import Darknet19
from podtpu_torch.models.layers import ConvBnAct, SeededDropout
from podtpu_torch.parallel import layouts


def _head_hw(size: int) -> int:
    """The side of the map ``fc`` flattens: five 2x2/2 pools (floor), then
    head1's 3x3/2 conv with padding 1."""
    for _ in range(5):
        size //= 2
    return (size - 1) // 2 + 1


class YoloV1(nn.Module):
    def __init__(self, num_classes: int, num_boxes: int = 2,
                 input_size: int = 448, in_channels: int = 3,
                 dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.5):
        super().__init__()
        self.dtype = dtype
        self.backbone = Darknet19(out_indices=(5,), in_channels=in_channels,
                                  dtype=dtype)
        self.head0 = ConvBnAct(1024, 1024, 3, dtype=dtype)
        self.head1 = ConvBnAct(1024, 1024, 3, dtype=dtype, strides=2)
        self.head2 = ConvBnAct(1024, 1024, 3, dtype=dtype)
        self.head3 = ConvBnAct(1024, 1024, 3, dtype=dtype)
        self.head4 = ConvBnAct(1024, 256, 3, dtype=dtype)
        # podtpu's Dropout rate: 0 switches it off in train mode too (the
        # parity tests compare train-mode steps that way)
        self.dropout = SeededDropout(dropout_rate)
        self.fc = nn.Linear(256 * _head_hw(input_size) ** 2,
                            7 * 7 * (num_classes + 5 * num_boxes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # NHWC -> NCHW view with channels_last strides
        x = self.backbone(x.permute(0, 3, 1, 2))[0]
        for i in range(5):
            x = getattr(self, f"head{i}")(x)
        # (h, w, c) order, of whole rows
        x = layouts.whole_rows(x)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = self.dropout(x)
        return layouts.linear(self.fc, x, self.dtype).float()
