"""Losses (``podtpu/losses``); the port has the YOLOv3 family's active one."""

from __future__ import annotations

from typing import Callable

import torch

from podtpu_torch.losses.yolov3 import yolov3_loss_v2

# families of podtpu's build_loss that the port does not build yet
_LATER = ("yolov1", "yolov2", "yolov4", "yolov4-tiny", "retinanet")


def build_loss(cfg: dict) -> Callable:
    """Config -> ``loss(preds, annots) -> scalar``: ``yolov3_loss_v2`` for
    yolov3, as ``podtpu`` wires it."""
    name = cfg["model"]
    if name in _LATER:
        raise NotImplementedError(f"the '{name}' loss is not ported yet "
                                  "(ROADMAP.md queue 1, other families)")
    if name != "yolov3":
        raise ValueError(f"unknown model '{name}'")
    num_classes, input_size = cfg["num_classes"], cfg["input_size"]
    anchors = cfg["anchors"]
    on_device: dict = {}  # device -> the anchors as a float32 tensor there

    def loss(preds, annots: torch.Tensor) -> torch.Tensor:
        dev = annots.device
        if dev not in on_device:
            on_device[dev] = torch.tensor(anchors, dtype=torch.float32,
                                          device=dev)
        return yolov3_loss_v2(preds, annots, num_classes, on_device[dev],
                              input_size)

    return loss
