"""Detection visualization (the port's copy of ``podtpu/utils/viz.py``;
utils/yolo_utils.py:577-709 analog).

Draws [cx, cy, w, h, conf, cls] rows on a BGR image with class names from a
``.names`` file; also a unicode-capable PIL variant for non-ASCII label sets
(the reference's LPR path uses a Korean font: yolo_utils.py:617-653).
"""

from __future__ import annotations

import cv2
import numpy as np


def load_names(names_path: str) -> list[str]:
    with open(names_path, "r") as f:
        return [line.strip() for line in f.readlines() if line.strip()]


def draw_boxes(img: np.ndarray, boxes, class_names, color=(0, 255, 0),
               thickness: int = 1) -> np.ndarray:
    """boxes: iterable of [cx, cy, w, h, conf, cls] in pixel scale."""
    for box in boxes:
        cx, cy, w, h, conf, cls = [float(v) for v in box[:6]]
        x1, y1 = int(cx - w / 2), int(cy - h / 2)
        x2, y2 = int(cx + w / 2), int(cy + h / 2)
        name = class_names[int(cls)] if int(cls) < len(class_names) else str(int(cls))
        img = cv2.rectangle(img, (x1, y1), (x2, y2), color=color,
                            thickness=thickness)
        img = cv2.putText(
            img, f"{name}, {conf:.2f}", (x1, y1 + 20),
            fontFace=cv2.FONT_HERSHEY_PLAIN, fontScale=1, color=color,
        )
    return img


def draw_boxes_unicode(img: np.ndarray, boxes, class_names,
                       color=(0, 255, 0), font_path: str | None = None,
                       font_size: int = 20) -> np.ndarray:
    """PIL-based variant that renders non-ASCII class names."""
    from PIL import Image, ImageDraw, ImageFont

    try:
        font = (ImageFont.truetype(font_path, font_size)
                if font_path else ImageFont.load_default())
    except OSError:
        font = ImageFont.load_default()
    pil = Image.fromarray(img)
    draw = ImageDraw.Draw(pil)
    for box in boxes:
        cx, cy, w, h, _, cls = [float(v) for v in box[:6]]
        x1, y1 = int(cx - w / 2), int(cy - h / 2)
        x2, y2 = int(cx + w / 2), int(cy + h / 2)
        name = class_names[int(cls)] if int(cls) < len(class_names) else str(int(cls))
        draw.rectangle((x1, y1, x2, y2), outline=color, width=1)
        draw.text((x1, y1), name, font=font, fill=color)
    return np.array(pil)


def annots_to_boxes(annots: np.ndarray, input_size: int) -> np.ndarray:
    """Padded [T, 5] normalized annotations -> [n, 6] pixel GT rows."""
    annots = np.asarray(annots)
    keep = annots.sum(axis=-1) > 0
    rows = annots[keep]
    out = np.zeros((len(rows), 6), np.float32)
    out[:, :4] = rows[:, :4] * input_size
    out[:, 4] = 1.0
    out[:, 5] = rows[:, 4]
    return out
