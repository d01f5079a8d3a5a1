"""The YOLOv1 loss (``podtpu/losses/yolov1.py::yolov1_loss``).

The whole [B, 7, 7, 5*NB+C] prediction is sigmoided. Per cell, the predicted
box of the best IoU against the cell's (single) GT box is responsible (the
first on a tie). Sum-reduced MSE coordinate term x5, objectness MSE toward
the responsible box's IoU, no-object MSE x0.5, BCE class on occupied
cells, divided by the batch.

The objectness target is that IoU with its gradient: ``podtpu`` stops
none, so neither does the port. The reference's quirk stays: the IoU mixes
scales (xy are cell offsets in [0, 1), wh are normalized to the image).
"""

from __future__ import annotations

import torch

from podtpu_torch.losses.common import bce_logits, masked_sum
from podtpu_torch.ops.assign import encode_yolov1_targets
from podtpu_torch.ops.boxes import bbox_iou


def yolov1_loss(pred: torch.Tensor, target: torch.Tensor, num_classes: int,
                num_boxes: int, grid_size: int = 7, lambda_obj: float = 1.0,
                lambda_noobj: float = 0.5, lambda_coord: float = 5.0,
                lambda_class: float = 1.0) -> torch.Tensor:
    s = grid_size
    b = pred.shape[0]
    logits = pred.float().reshape(b, s, s, num_boxes * 5 + num_classes)
    y_pred = torch.sigmoid(logits)

    t = encode_yolov1_targets(target, num_classes, s)

    # [B, S, S, NB, 5]: (conf, x, y, w, h) per predicted box
    pboxes = y_pred[..., num_classes:].reshape(b, s, s, num_boxes, 5)
    ious = bbox_iou(t.tbox[..., None, :], pboxes[..., 1:5])[..., 0]
    best = torch.argmax(ious, dim=-1)                     # [B, S, S]
    onehot = (best[..., None] == torch.arange(num_boxes, device=pred.device)
              ).float()

    pbox = (onehot[..., None] * pboxes[..., 1:5]).sum(dim=-2)  # [B, S, S, 4]
    pconf = (onehot * pboxes[..., 0]).sum(dim=-1)              # [B, S, S]
    piou = (onehot * ious).sum(dim=-1)                         # [B, S, S]

    mask = t.mask
    noobj = 1.0 - mask
    box_loss = lambda_coord * ((pbox * mask[..., None] - t.tbox) ** 2).sum()
    object_loss = lambda_obj * ((pconf * mask - piou) ** 2).sum()
    no_object_loss = lambda_noobj * ((pconf * noobj) ** 2).sum()
    class_loss = lambda_class * masked_sum(
        bce_logits(logits[..., :num_classes], t.tcls), mask)
    return (box_loss + object_loss + no_object_loss + class_loss) / b
