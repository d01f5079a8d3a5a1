"""Losses (``podtpu/losses``): the active loss of each ported family."""

from __future__ import annotations

from typing import Callable

import torch

from podtpu_torch.losses.yolov1 import yolov1_loss
from podtpu_torch.losses.yolov2 import yolov2_loss_v2
from podtpu_torch.losses.yolov3 import yolov3_loss_v2

# families of podtpu's build_loss that the port does not build yet
_LATER = ("retinanet",)


def build_loss(cfg: dict) -> Callable:
    """Config -> ``loss(preds, annots) -> scalar``, as ``podtpu`` wires it:
    ``yolov1_loss`` for yolov1, ``yolov2_loss_v2`` for yolov2 and
    ``yolov3_loss_v2`` for yolov3, yolov4-tiny and yolov4."""
    name = cfg["model"]
    if name in _LATER:
        raise NotImplementedError(f"the '{name}' loss is not ported yet "
                                  "(ROADMAP.md queue 1, other families)")
    num_classes = cfg["num_classes"]
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
