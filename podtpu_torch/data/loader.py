"""Batch assembly (the port's copy of ``pad_annotations`` from
``podtpu/data/loader.py``)."""

from __future__ import annotations

import numpy as np


def pad_annotations(boxes_list, max_annots: int) -> np.ndarray:
    """[B, max_annots, 5] with -1 padding; overflow annotations drop."""
    b = len(boxes_list)
    out = np.full((b, max_annots, 5), -1.0, np.float32)
    for i, boxes in enumerate(boxes_list):
        n = min(len(boxes), max_annots)
        if n:
            out[i, :n] = boxes[:n]
    return out
