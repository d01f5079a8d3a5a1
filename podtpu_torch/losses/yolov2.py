"""YOLOv2 losses (``podtpu/losses/yolov2.py``): the active
``yolov2_loss_v2`` (CIoU box x0.5, MSE objectness x5, MSE no-object x1,
BCE class x1, summed and divided by the batch) and the original
per-coordinate MSE ``yolov2_loss``, which ``build_loss`` does not wire.

Targets are ``encode_anchor_targets`` on the 13x13 grid with the config's
``scaled_anchors`` (grid units) and unsmoothed class bits that accumulate
on same-slot collisions (``cls_accumulate``), as the reference writes them.

Inputs: the NHWC raw logits [B, H, W, A*(5+C)] and padded annotations
[B, T, 5].
"""

from __future__ import annotations

import torch

from podtpu_torch.losses.common import bce_logits, masked_ciou_loss, masked_sum
from podtpu_torch.ops.assign import encode_anchor_targets
from podtpu_torch.ops.boxes import WH_CLAMP, tie_clamp


def _split_pred(pred: torch.Tensor, num_anchors: int, num_classes: int):
    b, h, w, _ = pred.shape
    p = pred.float().reshape(b, h, w, num_anchors, 5 + num_classes)
    return p[..., 0:2], p[..., 2:4], p[..., 4], p[..., 5:]


def yolov2_loss_v2(pred: torch.Tensor, target: torch.Tensor,
                   num_classes: int, scaled_anchors,
                   ignore_threshold: float = 0.5, lambda_obj: float = 5.0,
                   lambda_noobj: float = 1.0, lambda_coord: float = 0.5,
                   lambda_class: float = 1.0) -> torch.Tensor:
    """Scalar loss; ``scaled_anchors`` [A, 2] (a tensor on the target's
    device avoids a host copy per call)."""
    anchors = torch.as_tensor(scaled_anchors, dtype=torch.float32,
                              device=target.device)
    num_anchors = anchors.shape[0]
    b, h, w, _ = pred.shape
    xy, wh, conf, cls = _split_pred(pred, num_anchors, num_classes)
    t = encode_anchor_targets(target, num_classes, anchors, w, h,
                              ignore_threshold, cls_accumulate=True)

    pbox = torch.cat([torch.sigmoid(xy),
                      torch.exp(tie_clamp(wh, WH_CLAMP))], dim=-1)
    box_loss = lambda_coord * masked_ciou_loss(pbox, t.tbox, t.mask)
    pconf = torch.sigmoid(conf)
    object_loss = lambda_obj * ((pconf * t.mask - t.tconf) ** 2).sum()
    no_object_loss = lambda_noobj * ((pconf * t.noobj_mask) ** 2).sum()
    class_loss = lambda_class * masked_sum(bce_logits(cls, t.tcls), t.mask)
    return (box_loss + object_loss + no_object_loss + class_loss) / b


def yolov2_loss(pred: torch.Tensor, target: torch.Tensor, num_classes: int,
                scaled_anchors, ignore_threshold: float = 0.5,
                lambda_obj: float = 5.0, lambda_noobj: float = 1.0,
                lambda_coord: float = 1.0, lambda_class: float = 1.0
                ) -> torch.Tensor:
    """The original per-coordinate MSE variant: MSE on sigmoid(xy) and
    exp(wh) against the raw targets in place of the CIoU term."""
    anchors = torch.as_tensor(scaled_anchors, dtype=torch.float32,
                              device=target.device)
    num_anchors = anchors.shape[0]
    b, h, w, _ = pred.shape
    xy, wh, conf, cls = _split_pred(pred, num_anchors, num_classes)
    t = encode_anchor_targets(target, num_classes, anchors, w, h,
                              ignore_threshold, cls_accumulate=True)
    pxy = torch.sigmoid(xy)
    pwh = torch.exp(tie_clamp(wh, WH_CLAMP))
    box_loss = lambda_coord * (
        ((pxy[..., 0] * t.mask - t.tbox[..., 0]) ** 2).sum()
        + ((pxy[..., 1] * t.mask - t.tbox[..., 1]) ** 2).sum()
        + ((pwh[..., 0] * t.mask - t.tbox[..., 2]) ** 2).sum()
        + ((pwh[..., 1] * t.mask - t.tbox[..., 3]) ** 2).sum())
    pconf = torch.sigmoid(conf)
    object_loss = lambda_obj * ((pconf * t.mask - t.tconf) ** 2).sum()
    no_object_loss = lambda_noobj * ((pconf * t.noobj_mask) ** 2).sum()
    class_loss = lambda_class * masked_sum(bce_logits(cls, t.tcls), t.mask)
    return (box_loss + object_loss + no_object_loss + class_loss) / b
