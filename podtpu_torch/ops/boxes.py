"""Box geometry primitives (``podtpu/ops/boxes.py``), on tensors.

Same formulas and the same ``_EPS`` placement as ``podtpu``, so IoUs match
it bit for bit where both frameworks round each operation once.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-6

# exp() of unbounded wh logits overflows once training diverges; +-15 is far
# outside the trained regime (|wh logit| < ~3) and keeps boxes finite.
WH_CLAMP = 15.0


# JAX's subgradients at a tie, which torch's clamp and abs do not take:
# jnp.maximum / jnp.clip give each side half the gradient where the two are
# equal (torch.maximum does too; clamp passes it whole), and jnp.abs has
# derivative 1 at 0 (torch's abs has 0).
def tie_max0(x: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum(x, 0)``, its gradient halved at 0."""
    return torch.maximum(x, x.new_zeros(()))


def tie_clamp(x: torch.Tensor, bound: float) -> torch.Tensor:
    """``jnp.clip(x, -bound, bound)``, its gradient halved at the bounds."""
    return torch.minimum(torch.maximum(x, x.new_full((), -bound)),
                         x.new_full((), bound))


def tie_abs(x: torch.Tensor) -> torch.Tensor:
    """``jnp.abs(x)``, with derivative 1 at 0."""
    return torch.where(x >= 0, x, -x)


def cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 4] center-format boxes -> corner format."""
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack(
        [cx - w / 2.0, cy - h / 2.0, cx + w / 2.0, cy + h / 2.0], dim=-1)


def xyxy_to_cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 4] corner-format boxes -> center format."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([(x1 + x2) / 2.0, (y1 + y2) / 2.0, x2 - x1, y2 - y1],
                       dim=-1)


def xywhn_to_xyxy(boxes: torch.Tensor, w: float, h: float, padw: float = 0.0,
                  padh: float = 0.0) -> torch.Tensor:
    """Normalized cxcywh -> pixel xyxy, shifted by the letterbox padding
    (utils/general.py:560-568 semantics)."""
    cx, cy, bw, bh = boxes.unbind(-1)
    return torch.stack([w * (cx - bw / 2.0) + padw,
                        h * (cy - bh / 2.0) + padh,
                        w * (cx + bw / 2.0) + padw,
                        h * (cy + bh / 2.0) + padh], dim=-1)


def xyxy_to_xywhn(boxes: torch.Tensor, w: float, h: float, clip: bool = False,
                  eps: float = 0.0) -> torch.Tensor:
    """Pixel xyxy -> normalized cxcywh (utils/general.py:571-581 semantics);
    ``clip`` first clamps the corners into ``[0, w - eps] x [0, h - eps]``."""
    if clip:
        hi = boxes.new_tensor([w - eps, h - eps, w - eps, h - eps])
        boxes = torch.minimum(torch.maximum(boxes, boxes.new_zeros(())), hi)
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([(x1 + x2) / 2.0 / w, (y1 + y2) / 2.0 / h,
                        (x2 - x1) / w, (y2 - y1) / h], dim=-1)


def box_area(boxes_xyxy: torch.Tensor) -> torch.Tensor:
    return (boxes_xyxy[..., 2] - boxes_xyxy[..., 0]) * (
        boxes_xyxy[..., 3] - boxes_xyxy[..., 1])


def pairwise_iou(boxes1_xyxy: torch.Tensor,
                 boxes2_xyxy: torch.Tensor) -> torch.Tensor:
    """All-pairs IoU: [..., N, 4] x [..., M, 4] -> [..., N, M] (corner format)."""
    b1 = boxes1_xyxy[..., :, None, :]
    b2 = boxes2_xyxy[..., None, :, :]
    inter_w = tie_max0(torch.minimum(b1[..., 2], b2[..., 2])
                       - torch.maximum(b1[..., 0], b2[..., 0]))
    inter_h = tie_max0(torch.minimum(b1[..., 3], b2[..., 3])
                       - torch.maximum(b1[..., 1], b2[..., 1]))
    inter = inter_w * inter_h
    area1 = box_area(boxes1_xyxy)[..., :, None]
    area2 = box_area(boxes2_xyxy)[..., None, :]
    return inter / (area1 + area2 - inter + _EPS)


def bbox_iou(boxes1: torch.Tensor, boxes2: torch.Tensor, GIoU: bool = False,
             DIoU: bool = False, CIoU: bool = False) -> torch.Tensor:
    """Broadcasting elementwise IoU / GIoU / DIoU / CIoU on [..., 4] cxcywh
    boxes; returns [..., 1]. In CIoU the aspect weight ``alpha`` takes no
    gradient."""
    boxes1, boxes2 = cxcywh_to_xyxy(boxes1), cxcywh_to_xyxy(boxes2)
    b1x1, b1y1, b1x2, b1y2 = boxes1.split(1, dim=-1)
    b2x1, b2y1, b2x2, b2y2 = boxes2.split(1, dim=-1)

    inter_w = tie_max0(torch.minimum(b1x2, b2x2) - torch.maximum(b1x1, b2x1))
    inter_h = tie_max0(torch.minimum(b1y2, b2y2) - torch.maximum(b1y1, b2y1))
    inter = inter_w * inter_h
    area1 = tie_abs((b1x2 - b1x1) * (b1y2 - b1y1))
    area2 = tie_abs((b2x2 - b2x1) * (b2y2 - b2y1))
    union = area1 + area2 - inter + _EPS
    iou = inter / union
    if not (GIoU or DIoU or CIoU):
        return iou

    cw = torch.maximum(b1x2, b2x2) - torch.minimum(b1x1, b2x1)
    ch = torch.maximum(b1y2, b2y2) - torch.minimum(b1y1, b2y1)
    if CIoU or DIoU:
        c2 = cw ** 2 + ch ** 2 + _EPS
        rho2 = ((b2x1 + b2x2 - b1x1 - b1x2) ** 2
                + (b2y1 + b2y2 - b1y1 - b1y2) ** 2) / 4.0
        if DIoU:
            return iou - rho2 / c2
        v = (4.0 / math.pi ** 2) * (
            torch.atan((b2x2 - b2x1) / (b2y2 - b2y1))
            - torch.atan((b1x2 - b1x1) / (b1y2 - b1y1))) ** 2
        alpha = (v / (v - iou + (1.0 + _EPS))).detach()
        return iou - (rho2 / c2 + v * alpha)
    c_area = cw * ch + _EPS
    return iou - (c_area - union) / c_area


def wh_iou(wh1: torch.Tensor, wh2: torch.Tensor) -> torch.Tensor:
    """IoU of width/height-only boxes anchored at the origin:
    [N, 2] x [M, 2] -> [N, M]."""
    inter = (torch.minimum(wh1[:, None, 0], wh2[None, :, 0])
             * torch.minimum(wh1[:, None, 1], wh2[None, :, 1]))
    union = (wh1[:, None, 0] * wh1[:, None, 1]
             + wh2[None, :, 0] * wh2[None, :, 1] - inter + _EPS)
    return inter / union
