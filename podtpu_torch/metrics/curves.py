"""Per-class PR/F1 curves + confusion matrix (utils/metrics.py:21-185 role):
the port's copy of ``podtpu/metrics/curves.py``, matching with the C++
matcher of ``metrics/map.py`` (which raises where ``podtpu``'s falls back).

The reference carries Ultralytics' dormant metric utilities (ap_per_class
with 101-point COCO interpolation, ConfusionMatrix, curve plotting). These
are the active equivalents: pure numpy, returning curve arrays the caller
can log or plot; matplotlib is optional.
"""

from __future__ import annotations

import numpy as np

from podtpu_torch.metrics.coco import _iou_matrix, sample_ap_101


def ap_per_class(true_boxes: np.ndarray, pred_boxes: np.ndarray,
                 num_classes: int, iou_threshold: float = 0.5,
                 eps: float = 1e-16) -> dict:
    """Precision/recall/F1/AP per class at one IoU threshold.

    Rows: [img_idx, cx, cy, w, h, conf, cls]. Returns dict with 'precision',
    'recall', 'f1', 'ap' ([C] arrays at max-F1 confidence / AP), plus
    'curves': per-class (conf-sorted recall, precision) arrays.
    """
    from podtpu_torch.metrics.map import _class_tp_fp

    precision = np.zeros(num_classes)
    recall = np.zeros(num_classes)
    f1 = np.zeros(num_classes)
    ap = np.zeros(num_classes)
    curves = {}
    for c in range(num_classes):
        gts = true_boxes[true_boxes[:, 6] == c]
        dets = pred_boxes[pred_boxes[:, 6] == c]
        if not len(gts) or not len(dets):
            continue
        order = np.argsort(-dets[:, 5], kind="stable")
        dets_sorted = dets[order]
        tp, fp = _class_tp_fp(dets, gts, iou_threshold)
        tp_cum, fp_cum = np.cumsum(tp), np.cumsum(fp)
        r = tp_cum / (len(gts) + eps)
        p = tp_cum / np.maximum(tp_cum + fp_cum, eps)
        f = 2 * p * r / np.maximum(p + r, eps)
        best = int(np.argmax(f))
        precision[c], recall[c], f1[c] = p[best], r[best], f[best]
        ap[c] = sample_ap_101(p, r)  # 101-point interpolated AP
        curves[c] = (r, p, dets_sorted[:, 5])
    return {"precision": precision, "recall": recall, "f1": f1, "ap": ap,
            "curves": curves}


class ConfusionMatrix:
    """[C+1, C+1] detection confusion matrix (last row/col = background)."""

    def __init__(self, num_classes: int, conf_threshold: float = 0.25,
                 iou_threshold: float = 0.45):
        self.num_classes = num_classes
        self.conf_threshold = conf_threshold
        self.iou_threshold = iou_threshold
        self.matrix = np.zeros((num_classes + 1, num_classes + 1), np.int64)

    def update(self, dets: np.ndarray, gts: np.ndarray):
        """dets/gts: [N, 7] rows of ONE image (img_idx ignored)."""
        dets = dets[dets[:, 5] > self.conf_threshold]
        matched_gt = np.zeros(len(gts), bool)
        matched_det = np.zeros(len(dets), bool)
        if len(dets) and len(gts):
            iou = _iou_matrix(dets, gts)
            for d in np.argsort(-dets[:, 5], kind="stable"):
                cand = np.where(~matched_gt & (iou[d] >= self.iou_threshold))[0]
                if len(cand):
                    g = cand[np.argmax(iou[d][cand])]
                    matched_gt[g] = True
                    matched_det[d] = True
                    self.matrix[int(dets[d, 6]), int(gts[g, 6])] += 1
        for d in np.where(~matched_det)[0] if len(dets) else []:
            self.matrix[int(dets[d, 6]), self.num_classes] += 1  # FP vs bg
        for g in np.where(~matched_gt)[0] if len(gts) else []:
            self.matrix[self.num_classes, int(gts[g, 6])] += 1  # FN (missed)

    def normalized(self) -> np.ndarray:
        col = self.matrix.sum(axis=0, keepdims=True)
        return self.matrix / np.maximum(col, 1)
