"""Model factory: config dict -> ``nn.Module`` on a device."""

from __future__ import annotations

import torch

from podtpu_torch import resolve_device
from podtpu_torch.models.layers import ConvBnAct
from podtpu_torch.models.retinanet import RetinaNet
from podtpu_torch.models.yolov1 import YoloV1
from podtpu_torch.models.yolov2 import YoloV2
from podtpu_torch.models.yolov3 import YoloV3
from podtpu_torch.models.yolov4 import YoloV4
from podtpu_torch.models.yolov4_tiny import YoloV4Tiny

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
}


def compute_dtype(cfg: dict) -> torch.dtype:
    return _DTYPES[cfg.get("compute_dtype", "float32")]


def build_model(cfg: dict, device: str | torch.device | None = None,
                train: bool = False):
    """Instantiate the detector named by ``cfg['model']``, in eval mode
    unless ``train``.

    Weights are PyTorch's default init (RetinaNet's class prior bias
    aside); load trained ones with
    :func:`podtpu_torch.export.weights.load_npz_weights`.

    ``qat: true`` turns on every ``ConvBnAct``'s fake-quantized train-mode
    forward (``podtpu`` threads the flag into each family's blocks: all of
    them, the fused stem then off); ``remat_backbone: true`` recomputes
    YOLOv3's backbone stages in the backward (YOLOv3 only, as in
    ``podtpu``).
    """
    name = cfg["model"]
    kw = dict(num_classes=cfg["num_classes"],
              in_channels=cfg.get("in_channels", 3), dtype=compute_dtype(cfg))
    if name == "yolov1":
        model = YoloV1(num_boxes=cfg["num_boxes"],
                       input_size=cfg["input_size"], **kw)
    elif name == "yolov2":
        model = YoloV2(num_anchors=len(cfg["scaled_anchors"]), **kw)
    elif name == "yolov3":
        model = YoloV3(num_anchors=len(cfg["anchors"]),
                       remat=bool(cfg.get("remat_backbone", False)), **kw)
    elif name == "yolov4-tiny":
        model = YoloV4Tiny(num_anchors=len(cfg["anchors"]), **kw)
    elif name == "yolov4":
        model = YoloV4(num_anchors=len(cfg["anchors"]), **kw)
    elif name == "retinanet":
        model = RetinaNet(**kw)
    else:
        raise ValueError(f"unknown model '{name}'")
    if cfg.get("qat"):
        for m in model.modules():
            if isinstance(m, ConvBnAct):
                m.qat = True
    return model.to(resolve_device(device)).train(train)
