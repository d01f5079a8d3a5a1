"""Losses (``podtpu/losses``): the active loss of each family, which
``build_loss`` wires, and the reference's inactive variants
(``yolov2_loss``, ``yolov3_loss``, ``yolov3_loss_v3``), exported as
``podtpu`` exports them."""

from __future__ import annotations

from typing import Callable

import torch

from podtpu_torch.losses.focal import focal_loss  # noqa: F401
from podtpu_torch.losses.yolov1 import yolov1_loss
from podtpu_torch.losses.yolov2 import yolov2_loss, yolov2_loss_v2  # noqa: F401
from podtpu_torch.losses.yolov3 import (  # noqa: F401
    yolov3_loss,
    yolov3_loss_v2,
    yolov3_loss_v3,
)


def build_loss(cfg: dict) -> Callable:
    """Config -> ``loss(preds, annots) -> scalar``, as ``podtpu`` wires it:
    ``yolov1_loss`` for yolov1, ``yolov2_loss_v2`` for yolov2,
    ``yolov3_loss_v2`` for yolov3, yolov4-tiny and yolov4, and
    ``retinanet_loss`` (focal + smooth-L1, anchors cached per device) for
    retinanet."""
    name = cfg["model"]
    num_classes = cfg["num_classes"]
    if name == "retinanet":
        # imported here, as podtpu does: ops/retina.py imports losses
        from podtpu_torch.ops.retina import retinanet_loss

        input_size = cfg["input_size"]
        return lambda preds, annots: retinanet_loss(preds, annots,
                                                    num_classes, input_size)
    if name == "yolov1":
        num_boxes = cfg["num_boxes"]
        return lambda preds, annots: yolov1_loss(preds, annots, num_classes,
                                                 num_boxes)
    if name == "yolov2":
        anchors = cfg["scaled_anchors"]

        def family_loss(preds, annots, anchors_t):
            return yolov2_loss_v2(preds, annots, num_classes, anchors_t)
    elif name in ("yolov3", "yolov4-tiny", "yolov4"):
        anchors, input_size = cfg["anchors"], cfg["input_size"]

        def family_loss(preds, annots, anchors_t):
            return yolov3_loss_v2(preds, annots, num_classes, anchors_t,
                                  input_size)
    else:
        raise ValueError(f"unknown model '{name}'")
    on_device: dict = {}  # device -> the anchors as a float32 tensor there

    def loss(preds, annots: torch.Tensor) -> torch.Tensor:
        dev = annots.device
        if dev not in on_device:
            on_device[dev] = torch.tensor(anchors, dtype=torch.float32,
                                          device=dev)
        return family_loss(preds, annots, on_device[dev])

    return loss
