"""COCO-style AP evaluation (numpy, no pycocotools dependency): the port's
copy of ``podtpu/metrics/coco.py``.

The reference cross-validates its checkpoints with pycocotools COCOeval
(yolo2coco_pred_file_yolov3.py:105-121). That package isn't always available,
so this is a self-contained evaluator with the COCO conventions:

* AP averaged over IoU thresholds 0.50:0.05:0.95 (and AP50/AP75 reported);
* 101-point interpolated precision (recall grid 0:0.01:1);
* per-class AP averaged over classes present in the ground truth;
* greedy matching in descending confidence, each GT matched at most once,
  detections allowed to match the best *unmatched* GT above the threshold
  (COCO's matcher, which differs from the VOC-style matcher in
  podtpu_torch/metrics/map.py: there a detection whose best-IoU GT is taken counts
  as FP even if another GT would match).

Rows are the framework's standard ``[img_idx, cx, cy, w, h, conf, cls]``.
"""

from __future__ import annotations

import numpy as np

IOU_THRESHOLDS = np.arange(0.5, 1.0, 0.05)
RECALL_GRID = np.linspace(0.0, 1.0, 101)


def _iou_matrix(dets: np.ndarray, gts: np.ndarray) -> np.ndarray:
    ax1 = dets[:, None, 1] - dets[:, None, 3] / 2
    ay1 = dets[:, None, 2] - dets[:, None, 4] / 2
    ax2 = dets[:, None, 1] + dets[:, None, 3] / 2
    ay2 = dets[:, None, 2] + dets[:, None, 4] / 2
    bx1 = gts[None, :, 1] - gts[None, :, 3] / 2
    by1 = gts[None, :, 2] - gts[None, :, 4] / 2
    bx2 = gts[None, :, 1] + gts[None, :, 3] / 2
    by2 = gts[None, :, 2] + gts[None, :, 4] / 2
    iw = np.clip(np.minimum(ax2, bx2) - np.maximum(ax1, bx1), 0, None)
    ih = np.clip(np.minimum(ay2, by2) - np.maximum(ay1, by1), 0, None)
    inter = iw * ih
    union = ((ax2 - ax1) * (ay2 - ay1) + (bx2 - bx1) * (by2 - by1)
             - inter + 1e-9)
    return inter / union


def _match_class(dets: np.ndarray, gts: np.ndarray,
                 iou_thresholds: np.ndarray) -> np.ndarray:
    """TP flags [T, N] for confidence-sorted dets of one class (COCO
    matcher). Per-image IoU matrices are computed once and reused across
    all T thresholds (pycocotools' structure — IoU is threshold-free, only
    the greedy taken/tp pass depends on the threshold)."""
    iou_thresholds = np.atleast_1d(iou_thresholds)
    tp = np.zeros((len(iou_thresholds), len(dets)), bool)
    for img in np.unique(dets[:, 0]):
        d_idx = np.where(dets[:, 0] == img)[0]
        g_rows = gts[gts[:, 0] == img]
        if not len(g_rows):
            continue
        iou = _iou_matrix(dets[d_idx], g_rows)
        for t, thr in enumerate(iou_thresholds):
            taken = np.zeros(len(g_rows), bool)
            for row, d in enumerate(d_idx):
                cand = np.where(~taken & (iou[row] >= thr))[0]
                if len(cand):
                    best = cand[np.argmax(iou[row][cand])]
                    taken[best] = True
                    tp[t, d] = True
    return tp


def sample_ap_101(precision: np.ndarray, recall: np.ndarray) -> float:
    """101-point interpolated AP: precision envelope sampled on the COCO
    recall grid. ``recall`` must be non-decreasing (cumulative TP order)."""
    env = np.maximum.accumulate(precision[::-1])[::-1]
    idx = np.searchsorted(recall, RECALL_GRID, side="left")
    p = np.where(idx < len(env), env[np.minimum(idx, len(env) - 1)], 0.0)
    return float(p.mean())


def _ap_101(tp: np.ndarray, conf: np.ndarray, n_gt: int) -> float:
    order = np.argsort(-conf, kind="stable")
    tp = tp[order]
    tp_cum = np.cumsum(tp)
    fp_cum = np.cumsum(~tp)
    recall = tp_cum / max(n_gt, 1)
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)
    return sample_ap_101(precision, recall)


def coco_eval(true_boxes: np.ndarray, pred_boxes: np.ndarray,
              num_classes: int) -> dict:
    """Returns {'AP': mAP@[.5:.95], 'AP50': ..., 'AP75': ..., 'per_class': [C]}."""
    true_boxes = np.asarray(true_boxes, np.float32).reshape(-1, 7)
    pred_boxes = np.asarray(pred_boxes, np.float32).reshape(-1, 7)

    per_class = np.full((num_classes, len(IOU_THRESHOLDS)), np.nan)
    for c in range(num_classes):
        gts = true_boxes[true_boxes[:, 6] == c]
        if not len(gts):
            continue
        dets = pred_boxes[pred_boxes[:, 6] == c]
        if not len(dets):
            per_class[c] = 0.0
            continue
        dets = dets[np.argsort(-dets[:, 5], kind="stable")]
        tp_all = _match_class(dets, gts, IOU_THRESHOLDS)
        for t in range(len(IOU_THRESHOLDS)):
            per_class[c, t] = _ap_101(tp_all[t], dets[:, 5], len(gts))

    present = ~np.isnan(per_class[:, 0])
    if not present.any():
        return {"AP": 0.0, "AP50": 0.0, "AP75": 0.0,
                "per_class": np.zeros(num_classes)}
    ap_matrix = per_class[present]
    # present rows are fully populated -> plain mean (nanmean over absent
    # all-NaN rows would spam "Mean of empty slice" warnings)
    per_class_mean = np.zeros(num_classes)
    per_class_mean[present] = ap_matrix.mean(axis=1)
    return {
        "AP": float(ap_matrix.mean()),
        "AP50": float(ap_matrix[:, 0].mean()),
        "AP75": float(ap_matrix[:, 5].mean()),
        "per_class": per_class_mean,
    }
