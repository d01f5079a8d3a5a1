#!/usr/bin/env python3
"""Forward FLOPs an image and parameters of the port's detectors, counted
from the layer shapes (``torch.utils.flop_counter`` on a ``meta``-device
forward at batch 1, so nothing is computed or allocated).

    python3 tools/model_flops.py [configs/yolov3_voc.yaml ...]

Without arguments: the six configs the port builds at full size.
"""

from __future__ import annotations

import os
import sys

import torch
from torch.utils.flop_counter import FlopCounterMode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from podtpu_torch.config import get_configs  # noqa: E402
from podtpu_torch.models.factory import build_model  # noqa: E402

DEFAULT = [os.path.join(REPO, "configs", f"{m}_voc.yaml")
           for m in ("yolov3", "yolov2", "yolov1", "yolov4-tiny", "yolov4",
                     "retinanet")]


def forward_flops(cfg: dict) -> tuple[int, int]:
    """(forward FLOPs of one image, parameters) of ``cfg``'s model."""
    model = build_model(cfg, "meta")
    size = cfg["input_size"]
    x = torch.zeros(1, size, size, cfg.get("in_channels", 3), device="meta")
    with FlopCounterMode(display=False) as counter:
        model(x)
    return counter.get_total_flops(), sum(p.numel()
                                          for p in model.parameters())


def main(argv=None) -> None:
    paths = (argv if argv is not None else sys.argv[1:]) or DEFAULT
    base = None
    for path in paths:
        flops, params = forward_flops(get_configs(path, validate=False))
        base = base or flops
        print(f"{os.path.basename(path)}: {flops / 1e9:.2f} GFLOP an image "
              f"forward ({flops / base:.3f}x the first), "
              f"{params / 1e6:.1f} M parameters")


if __name__ == "__main__":
    main()
