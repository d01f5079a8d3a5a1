"""VOC-style mAP@.5 (host-side numpy): the port's copy of
``podtpu/metrics/map.py``, fed from the eval step's outputs after ``.cpu()``.
The greedy matcher is the C++ one (``podtpu_torch/native``), which raises
if it cannot be built; the numpy matcher stays as its plain version.

Semantics match the reference's ``mean_average_precision``
(utils/yolo_utils.py:351-456) exactly — this is the number its README parity
tables report:

* detections are pre-filtered by the config ``conf_threshold`` (0.25) before
  NMS — already done on device;
* per class: sort detections by confidence, greedily match each to the
  best-IoU ground truth of the same image; IoU > 0.5 on an unmatched GT is a
  TP (one detection per GT), everything else an FP;
* AP = sum of (delta recall x interpolated precision) at recall change
  points, with the precision envelope (monotone non-increasing from the
  right) and a (1, 0) anchor point prepended;
* classes with zero GT contribute AP = 0 to the mean (reference quirk,
  yolo_utils.py:378-381).

The matching is inherently dynamic-size/sequential, so it stays off the step
path, vectorized where possible: IoUs are computed as numpy matrices per
(class, image) group instead of a per-detection Python loop over GTs.

Rows are ``[img_idx, cx, cy, w, h, conf, cls]`` (center-format pixel boxes),
the same accumulation format as the reference (yolov3_utils.py:93-146).
"""

from __future__ import annotations

import numpy as np


def _iou_center(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of [N,4] x [M,4] center-format boxes -> [N,M]."""
    ax1, ay1 = a[:, 0] - a[:, 2] / 2, a[:, 1] - a[:, 3] / 2
    ax2, ay2 = a[:, 0] + a[:, 2] / 2, a[:, 1] + a[:, 3] / 2
    bx1, by1 = b[:, 0] - b[:, 2] / 2, b[:, 1] - b[:, 3] / 2
    bx2, by2 = b[:, 0] + b[:, 2] / 2, b[:, 1] + b[:, 3] / 2
    iw = np.clip(
        np.minimum(ax2[:, None], bx2[None]) - np.maximum(ax1[:, None], bx1[None]),
        0, None,
    )
    ih = np.clip(
        np.minimum(ay2[:, None], by2[None]) - np.maximum(ay1[:, None], by1[None]),
        0, None,
    )
    inter = iw * ih
    area_a = np.abs((ax2 - ax1) * (ay2 - ay1))[:, None]
    area_b = np.abs((bx2 - bx1) * (by2 - by1))[None]
    return inter / (area_a + area_b - inter + 1e-6)


def _class_tp_fp(dets: np.ndarray, gts: np.ndarray, iou_threshold: float):
    """Greedy per-class matching. dets/gts are [N,7] rows of one class.

    Returns (tp, fp) arrays aligned with confidence-sorted detections, from
    the C++ matcher (``podtpu_torch/native/map_matcher.cpp``)."""
    from podtpu_torch.native import native_class_tp_fp

    order = np.argsort(-dets[:, 5], kind="stable")
    return native_class_tp_fp(dets[order], gts, iou_threshold)


def _class_tp_fp_numpy(dets: np.ndarray, gts: np.ndarray,
                       iou_threshold: float):
    """The plain version of :func:`_class_tp_fp` (same rows, same result)."""
    order = np.argsort(-dets[:, 5], kind="stable")
    dets = dets[order]
    n = len(dets)
    tp = np.zeros(n, np.float32)
    fp = np.zeros(n, np.float32)

    # Pre-group GTs by image and precompute det->gt IoUs per image.
    gt_by_img: dict[int, np.ndarray] = {}
    gt_used: dict[int, np.ndarray] = {}
    for img in np.unique(gts[:, 0]).astype(int):
        rows = gts[gts[:, 0] == img]
        gt_by_img[img] = rows
        gt_used[img] = np.zeros(len(rows), bool)

    for i, det in enumerate(dets):
        img = int(det[0])
        rows = gt_by_img.get(img)
        if rows is None or len(rows) == 0:
            fp[i] = 1.0
            continue
        ious = _iou_center(det[None, 1:5], rows[:, 1:5])[0]
        best = int(np.argmax(ious))
        # Strict > like the reference (best_iou starts at 0; ties keep the
        # first argmax) — yolo_utils.py:410-419.
        if ious[best] > iou_threshold:
            if not gt_used[img][best]:
                tp[i] = 1.0
                gt_used[img][best] = True
            else:
                fp[i] = 1.0
        else:
            fp[i] = 1.0
    return tp, fp


def _ap_from_tp_fp(tp: np.ndarray, fp: np.ndarray, total_gt: int) -> float:
    """Precision-envelope AP at recall change points (yolo_utils.py:432-454)."""
    eps = 1e-6
    tp_cum = np.cumsum(tp)
    fp_cum = np.cumsum(fp)
    recalls = np.concatenate([[0.0], tp_cum / (total_gt + eps)])
    precisions = np.concatenate([[1.0], tp_cum / (tp_cum + fp_cum + eps)])
    # envelope: monotone non-increasing from the right
    precisions = np.maximum.accumulate(precisions[::-1])[::-1]
    changed = np.where(recalls[1:] != recalls[:-1])[0] + 1
    return float(np.sum((recalls[changed] - recalls[changed - 1])
                        * precisions[changed]))


def mean_average_precision(
    true_boxes: np.ndarray,
    pred_boxes: np.ndarray,
    num_classes: int,
    iou_threshold: float = 0.5,
) -> float:
    """mAP@iou over [N,7] rows ``[img_idx, cx, cy, w, h, conf, cls]``."""
    true_boxes = np.asarray(true_boxes, np.float32).reshape(-1, 7)
    pred_boxes = np.asarray(pred_boxes, np.float32).reshape(-1, 7)
    aps = []
    for c in range(num_classes):
        gts = true_boxes[true_boxes[:, 6] == c]
        if len(gts) == 0:
            aps.append(0.0)
            continue
        dets = pred_boxes[pred_boxes[:, 6] == c]
        if len(dets) == 0:
            aps.append(0.0)
            continue
        tp, fp = _class_tp_fp(dets, gts, iou_threshold)
        aps.append(_ap_from_tp_fp(tp, fp, len(gts)))
    return float(np.mean(aps)) if aps else 0.0


def metrics_per_class(
    true_boxes: np.ndarray,
    pred_boxes: np.ndarray,
    num_classes: int,
    iou_threshold: float = 0.5,
) -> np.ndarray:
    """[num_classes, 4] rows of [AP, TP, FP, FN] (yolo_utils.py:458-574)."""
    true_boxes = np.asarray(true_boxes, np.float32).reshape(-1, 7)
    pred_boxes = np.asarray(pred_boxes, np.float32).reshape(-1, 7)
    out = np.zeros((num_classes, 4), np.float32)
    for c in range(num_classes):
        gts = true_boxes[true_boxes[:, 6] == c]
        if len(gts) == 0:
            continue
        dets = pred_boxes[pred_boxes[:, 6] == c]
        if len(dets) == 0:
            out[c] = [0.0, 0.0, 0.0, len(gts)]
            continue
        tp, fp = _class_tp_fp(dets, gts, iou_threshold)
        out[c] = [
            _ap_from_tp_fp(tp, fp, len(gts)),
            tp.sum(),
            fp.sum(),
            len(gts) - tp.sum(),
        ]
    return out


class MeanAveragePrecision:
    """Stateful accumulator fed from the device eval step.

    ``update_state`` takes the *already decoded + NMS'd* padded detections
    (the eval step's output) plus the raw padded annotations, converts both
    to host rows, and assigns global image indices — the functional analog of
    the reference's per-version metric classes (yolov3_utils.py:93-149).
    """

    def __init__(self, num_classes: int, input_size: int,
                 iou_threshold: float = 0.5):
        self.num_classes = num_classes
        self.input_size = input_size
        self.iou_threshold = iou_threshold
        self.reset_states()

    def reset_states(self):
        self._true: list[np.ndarray] = []
        self._pred: list[np.ndarray] = []
        self.img_idx = 0

    def update_state(self, annots, detections, valid):
        """annots: [B, T, 5] normalized; detections: [B, M, 6]; valid: [B, M]."""
        annots = np.asarray(annots)
        detections = np.asarray(detections)
        valid = np.asarray(valid)
        for b in range(annots.shape[0]):
            rows = annots[b]
            keep = rows.sum(axis=1) > 0
            gt = rows[keep]
            if len(gt):
                true = np.empty((len(gt), 7), np.float32)
                true[:, 0] = self.img_idx
                true[:, 1:5] = gt[:, :4] * self.input_size
                true[:, 5] = 1.0
                true[:, 6] = gt[:, 4]
                self._true.append(true)
            det = detections[b][valid[b]]
            if len(det):
                pred = np.empty((len(det), 7), np.float32)
                pred[:, 0] = self.img_idx
                pred[:, 1:7] = det
                self._pred.append(pred)
            self.img_idx += 1

    def result(self) -> float:
        true = np.concatenate(self._true) if self._true else np.zeros((0, 7))
        pred = np.concatenate(self._pred) if self._pred else np.zeros((0, 7))
        return mean_average_precision(
            true, pred, self.num_classes, self.iou_threshold
        )

    def result_per_class(self) -> np.ndarray:
        true = np.concatenate(self._true) if self._true else np.zeros((0, 7))
        pred = np.concatenate(self._pred) if self._pred else np.zeros((0, 7))
        return metrics_per_class(
            true, pred, self.num_classes, self.iou_threshold
        )
