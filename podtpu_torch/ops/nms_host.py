"""Host-side (numpy) NMS variants (``podtpu/ops/nms_host.py``, copied) —
the reference's dormant surface.

The active on-device path is :mod:`podtpu_torch.ops.nms` (`nms_v3`/
`batched_nms` semantics). The reference also ships two dormant variants plus the
Ultralytics `non_max_suppression` with multi-label/merge options; these are
their numpy equivalents, kept host-side because they are offline/debug tools,
not step-path code:

* :func:`nms_v1` — greedy highest-confidence-first, class-aware, plain IoU
  (utils/yolo_utils.py:182-224 semantics);
* :func:`nms_v2` — per-class Malisiewicz-style suppression whose overlap
  metric is intersection / other-box-area, NOT IoU
  (utils/yolo_utils.py:227-318 semantics — a deliberate quirk);
* :func:`non_max_suppression` — Ultralytics-style on raw [N, 5+C] rows with
  ``multi_label`` (every class above threshold becomes a candidate) and
  ``merge`` (weighted box merging) options (utils/general.py:640-731 role).

All take/return numpy arrays; boxes are ``[cx, cy, w, h, conf, cls]`` rows
like the decoders emit.
"""

from __future__ import annotations

import numpy as np


def _xyxy(b: np.ndarray) -> np.ndarray:
    out = np.empty_like(b[..., :4])
    out[..., 0] = b[..., 0] - b[..., 2] / 2
    out[..., 1] = b[..., 1] - b[..., 3] / 2
    out[..., 2] = b[..., 0] + b[..., 2] / 2
    out[..., 3] = b[..., 1] + b[..., 3] / 2
    return out


def _iou_one_many(box: np.ndarray, others: np.ndarray) -> np.ndarray:
    xy1 = np.maximum(box[:2], others[:, :2])
    xy2 = np.minimum(box[2:4], others[:, 2:4])
    inter = np.clip(xy2 - xy1, 0, None).prod(axis=1)
    a1 = np.clip(box[2:4] - box[:2], 0, None).prod()
    a2 = np.clip(others[:, 2:4] - others[:, :2], 0, None).prod(axis=1)
    return inter / (a1 + a2 - inter + 1e-16)


def nms_v1(boxes: np.ndarray, conf_threshold: float = 0.25,
           iou_threshold: float = 0.45) -> np.ndarray:
    """Greedy confidence-ordered class-aware NMS (IoU metric)."""
    boxes = np.asarray(boxes, np.float32)
    boxes = boxes[boxes[:, 4] > conf_threshold]
    boxes = boxes[np.argsort(-boxes[:, 4])]
    kept = []
    while len(boxes):
        chosen = boxes[0]
        kept.append(chosen)
        rest = boxes[1:]
        if not len(rest):
            break
        same_cls = rest[:, 5] == chosen[5]
        iou = _iou_one_many(_xyxy(chosen[None])[0], _xyxy(rest))
        boxes = rest[~same_cls | (iou < iou_threshold)]
    return (np.stack(kept) if kept else np.zeros((0, 6), np.float32))


def nms_v2(boxes: np.ndarray, conf_threshold: float = 0.25,
           iou_threshold: float = 0.45) -> np.ndarray:
    """Per-class suppression with overlap = intersection / other-area."""
    boxes = np.asarray(boxes, np.float32)
    boxes = boxes[boxes[:, 4] > conf_threshold]
    if not len(boxes):
        return np.zeros((0, 6), np.float32)
    out = []
    for cls in np.unique(boxes[:, 5]):
        tb = boxes[boxes[:, 5] == cls]
        xy = _xyxy(tb)
        area = (xy[:, 2] - xy[:, 0]) * (xy[:, 3] - xy[:, 1])
        idxs = np.argsort(tb[:, 4])
        pick = []
        while len(idxs):
            i = idxs[-1]
            pick.append(i)
            rest = idxs[:-1]
            xx1 = np.maximum(xy[i, 0], xy[rest, 0])
            yy1 = np.maximum(xy[i, 1], xy[rest, 1])
            xx2 = np.minimum(xy[i, 2], xy[rest, 2])
            yy2 = np.minimum(xy[i, 3], xy[rest, 3])
            inter = np.maximum(0, xx2 - xx1) * np.maximum(0, yy2 - yy1)
            overlap = inter / area[rest]
            idxs = rest[overlap <= iou_threshold]
        out.append(tb[pick])
    return np.concatenate(out, axis=0)


def non_max_suppression(prediction: np.ndarray, conf_thres: float = 0.25,
                        iou_thres: float = 0.45, multi_label: bool = False,
                        merge: bool = False,
                        max_det: int = 300) -> np.ndarray:
    """Ultralytics-style NMS on one image's raw rows.

    prediction: [N, 5+C] rows ``[cx, cy, w, h, obj, cls0..clsC-1]``.
    Returns [M, 6] ``[x1, y1, x2, y2, conf, cls]`` (note: xyxy output, the
    Ultralytics convention).
    """
    pred = np.asarray(prediction, np.float32)
    pred = pred[pred[:, 4] > conf_thres]
    if not len(pred):
        return np.zeros((0, 6), np.float32)
    cls_conf = pred[:, 5:] * pred[:, 4:5]  # obj * cls
    xyxy = _xyxy(pred)
    if multi_label:
        i, j = np.nonzero(cls_conf > conf_thres)
        if not len(i):
            return np.zeros((0, 6), np.float32)
        rows = np.concatenate(
            [xyxy[i], cls_conf[i, j, None], j[:, None].astype(np.float32)],
            axis=1)
    else:
        j = cls_conf.argmax(axis=1)
        conf = cls_conf[np.arange(len(pred)), j]
        rows = np.concatenate(
            [xyxy, conf[:, None], j[:, None].astype(np.float32)], axis=1)
        rows = rows[conf > conf_thres]
    if not len(rows):
        return np.zeros((0, 6), np.float32)

    # class-offset batched NMS, score-descending greedy (IoU metric).
    # Stride from max |coord| like the device path: a plain max would let
    # boxes with negative coordinates (edge detections) bleed into the
    # neighboring class's offset region.
    order = np.argsort(-rows[:, 4])
    rows = rows[order]
    span = np.abs(rows[:, :4]).max() * 2.0 + 1.0
    off = rows[:, :4] + rows[:, 5:6] * span
    keep = np.ones(len(rows), bool)
    for i in range(len(rows)):
        if not keep[i]:
            continue
        rest = np.arange(i + 1, len(rows))
        rest = rest[keep[rest]]
        if not len(rest):
            break
        iou = _iou_one_many(off[i], off[rest])
        keep[rest[iou > iou_thres]] = False
    kept = np.where(keep)[0][:max_det]
    if merge and 1 < len(rows):
        # the reference's merge-NMS matrix math (general.py:714-721):
        # survivors become the score-weighted mean of EVERY candidate
        # overlapping them above the threshold, and survivors without a
        # second contributor are dropped (``redundant``) — identical to
        # the device path (podtpu_torch/ops/nms.py::_merge_kept)
        iou_m = np.stack([_iou_one_many(off[i], off) for i in kept])
        contrib = iou_m > iou_thres
        w = contrib * rows[None, :, 4]
        rows[kept, :4] = (w @ rows[:, :4]) / np.maximum(
            w.sum(1, keepdims=True), 1e-12)
        kept = kept[contrib.sum(1) > 1]
    return rows[kept]
