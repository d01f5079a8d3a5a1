"""Box geometry primitives (``podtpu/ops/boxes.py``), on tensors.

Same formulas and the same ``_EPS`` placement as ``podtpu``, so IoUs match
it bit for bit where both frameworks round each operation once.
"""

from __future__ import annotations

import torch

_EPS = 1e-6

# exp() of unbounded wh logits overflows once training diverges; +-15 is far
# outside the trained regime (|wh logit| < ~3) and keeps boxes finite.
WH_CLAMP = 15.0


def cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 4] center-format boxes -> corner format."""
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack(
        [cx - w / 2.0, cy - h / 2.0, cx + w / 2.0, cy + h / 2.0], dim=-1)


def box_area(boxes_xyxy: torch.Tensor) -> torch.Tensor:
    return (boxes_xyxy[..., 2] - boxes_xyxy[..., 0]) * (
        boxes_xyxy[..., 3] - boxes_xyxy[..., 1])


def pairwise_iou(boxes1_xyxy: torch.Tensor,
                 boxes2_xyxy: torch.Tensor) -> torch.Tensor:
    """All-pairs IoU: [..., N, 4] x [..., M, 4] -> [..., N, M] (corner format)."""
    b1 = boxes1_xyxy[..., :, None, :]
    b2 = boxes2_xyxy[..., None, :, :]
    inter_w = (torch.minimum(b1[..., 2], b2[..., 2])
               - torch.maximum(b1[..., 0], b2[..., 0])).clamp_min(0.0)
    inter_h = (torch.minimum(b1[..., 3], b2[..., 3])
               - torch.maximum(b1[..., 1], b2[..., 1])).clamp_min(0.0)
    inter = inter_w * inter_h
    area1 = box_area(boxes1_xyxy)[..., :, None]
    area2 = box_area(boxes2_xyxy)[..., None, :]
    return inter / (area1 + area2 - inter + _EPS)
