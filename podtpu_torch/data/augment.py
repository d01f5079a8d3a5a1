"""The serving path's image preprocessing (the port's copy of ``letterbox``
from ``podtpu/data/augment.py``). ``cv2`` is imported only when an image
has to be resized or padded."""

from __future__ import annotations

import numpy as np

GRAY = 114


def letterbox(im: np.ndarray, new_size: int, scaleup: bool = True):
    """Pad-to-square with gray borders; returns (img, ratio, (dw, dh))."""
    import cv2

    h, w = im.shape[:2]
    r = min(new_size / h, new_size / w)
    if not scaleup:
        r = min(r, 1.0)
    new_w, new_h = int(round(w * r)), int(round(h * r))
    dw = (new_size - new_w) / 2
    dh = (new_size - new_h) / 2
    if (w, h) != (new_w, new_h):
        im = cv2.resize(im, (new_w, new_h), interpolation=cv2.INTER_LINEAR)
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    im = cv2.copyMakeBorder(
        im, top, bottom, left, right, cv2.BORDER_CONSTANT,
        value=(GRAY, GRAY, GRAY),
    )
    return im, (r, r), (dw, dh)
