"""The active YOLOv3 loss (``podtpu/losses/yolov3.py::yolov3_loss_v2``):
CIoU box x10, MSE objectness x5, MSE no-object x1, BCE class x1 with label
smoothing ``smooth_bce(0.01)``, summed over the three layers and divided by
the batch.

A GT is assigned to a layer only when its globally-best anchor (argmax of
wh-IoU over all 9 anchors in input pixels) falls in that layer's triplet;
the per-layer ignore mask uses the triplet's local IoUs.

Inputs: the NHWC raw logits [p3, p4, p5] and padded annotations [B, T, 5].
"""

from __future__ import annotations

import torch

from podtpu_torch.losses.common import (
    bce_logits,
    masked_ciou_loss,
    masked_sum,
    smooth_bce,
)
from podtpu_torch.ops.assign import encode_anchor_targets
from podtpu_torch.ops.boxes import WH_CLAMP

# the recipe's term weights, ignore threshold and label smoothing
LAMBDA_COORD, LAMBDA_OBJ, LAMBDA_NOOBJ, LAMBDA_CLASS = 10.0, 5.0, 1.0, 1.0
IGNORE_THRESHOLD = 0.5
LABEL_SMOOTHING = 0.01


def _layer_targets(target, num_classes, anchors: torch.Tensor, input_size,
                   layer_idx, layer_w, layer_h, cls_pos, cls_neg):
    """anchors: all 9, [9, 2] float32 in input pixels, on target's device."""
    lo, hi = 3 * layer_idx, 3 * layer_idx + 3
    a = anchors[lo:hi]
    scaled = torch.stack([a[:, 0] * (layer_w / input_size),
                          a[:, 1] * (layer_h / input_size)], dim=-1)
    return encode_anchor_targets(
        target, num_classes, scaled, layer_w, layer_h, IGNORE_THRESHOLD,
        match_anchors=anchors, layer_anchor_slice=(lo, hi),
        match_scale=(float(input_size), float(input_size)),
        cls_pos=cls_pos, cls_neg=cls_neg)


def _split(pred: torch.Tensor, num_classes: int):
    b, h, w, _ = pred.shape
    p = pred.float().reshape(b, h, w, 3, 5 + num_classes)
    return p[..., 0:2], p[..., 2:4], p[..., 4], p[..., 5:]


def yolov3_loss_v2(preds, target: torch.Tensor, num_classes: int, anchors,
                   input_size: int) -> torch.Tensor:
    """Scalar loss; ``anchors`` [9, 2] (a tensor on the target's device
    avoids a host copy per call)."""
    anchors = torch.as_tensor(anchors, dtype=torch.float32,
                              device=target.device)
    cls_pos, cls_neg = smooth_bce(LABEL_SMOOTHING)
    b = preds[0].shape[0]
    loss = 0.0
    for layer_idx, pred in enumerate(preds):
        h, w = pred.shape[1], pred.shape[2]
        xy, wh, conf, cls = _split(pred, num_classes)
        t = _layer_targets(target, num_classes, anchors, input_size,
                           layer_idx, w, h, cls_pos, cls_neg)
        pbox = torch.cat([torch.sigmoid(xy),
                          torch.exp(wh.clamp(-WH_CLAMP, WH_CLAMP))], dim=-1)
        box_loss = LAMBDA_COORD * masked_ciou_loss(pbox, t.tbox, t.mask)
        pconf = torch.sigmoid(conf)
        object_loss = LAMBDA_OBJ * ((pconf * t.mask - t.tconf) ** 2).sum()
        no_object_loss = LAMBDA_NOOBJ * ((pconf * t.noobj_mask) ** 2).sum()
        class_loss = LAMBDA_CLASS * masked_sum(bce_logits(cls, t.tcls), t.mask)
        loss = loss + box_loss + object_loss + no_object_loss + class_loss
    return loss / b
