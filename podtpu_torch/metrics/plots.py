"""PR/F1 curve and confusion-matrix plotting (utils/metrics.py:292-331 role):
the port's copy of ``podtpu/metrics/plots.py``.

The reference carries dormant Ultralytics plotting; these are the active
equivalents over the port's metric outputs. matplotlib is imported lazily and
everything is headless (Agg).
"""

from __future__ import annotations

import os

import numpy as np


def plot_pr_curves(curves: dict, class_names, out_path: str) -> str:
    """curves: {class_id: (recall, precision, conf)} from ap_per_class."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 6))
    for cid, (r, p, _) in sorted(curves.items()):
        name = class_names[cid] if cid < len(class_names) else str(cid)
        ax.plot(r, p, linewidth=1.5, label=name)
    ax.set_xlabel("Recall")
    ax.set_ylabel("Precision")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1.05)
    ax.set_title("Precision-Recall")
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_confusion_matrix(matrix: np.ndarray, class_names, out_path: str
                          ) -> str:
    """[C+1, C+1] counts (last row/col background), column-normalized plot."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    names = list(class_names) + ["background"]
    norm = matrix / np.maximum(matrix.sum(axis=0, keepdims=True), 1)
    fig, ax = plt.subplots(figsize=(7, 6))
    im = ax.imshow(norm, cmap="Blues", vmin=0, vmax=1)
    ax.set_xticks(range(len(names)))
    ax.set_yticks(range(len(names)))
    ax.set_xticklabels(names, rotation=90, fontsize=7)
    ax.set_yticklabels(names, fontsize=7)
    ax.set_xlabel("True")
    ax.set_ylabel("Predicted")
    for i in range(len(names)):
        for j in range(len(names)):
            if matrix[i, j]:
                ax.text(j, i, int(matrix[i, j]), ha="center", va="center",
                        fontsize=6)
    fig.colorbar(im, ax=ax, fraction=0.046)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def build_confusion_matrix(true: np.ndarray, pred: np.ndarray,
                           num_classes: int, conf_threshold: float = 0.25):
    """Accumulate a ConfusionMatrix over per-image row groups. Iterates the
    union of image ids: a GT-less image with detections still contributes
    its FP-vs-background column."""
    from podtpu_torch.metrics.curves import ConfusionMatrix

    cm = ConfusionMatrix(num_classes, conf_threshold)
    img_ids = np.unique(np.concatenate([true[:, 0], pred[:, 0]]))
    for img in img_ids:
        cm.update(pred[pred[:, 0] == img], true[true[:, 0] == img])
    return cm


def write_eval_report(metric, class_names, out_dir: str,
                      conf_threshold: float = 0.25) -> dict:
    """Per-class AP/TP/FP/FN table + PR curves + confusion matrix from a
    consumed MeanAveragePrecision accumulator. Returns summary paths."""
    from podtpu_torch.metrics.curves import ap_per_class

    os.makedirs(out_dir, exist_ok=True)
    true = (np.concatenate(metric._true) if metric._true
            else np.zeros((0, 7), np.float32))
    pred = (np.concatenate(metric._pred) if metric._pred
            else np.zeros((0, 7), np.float32))

    per_class = metric.result_per_class()
    table_path = os.path.join(out_dir, "per_class.txt")
    with open(table_path, "w") as f:
        f.write(f"{'class':<20}{'AP':>8}{'TP':>8}{'FP':>8}{'FN':>8}\n")
        for c, (ap, tp, fp, fn) in enumerate(per_class):
            name = class_names[c] if c < len(class_names) else str(c)
            f.write(f"{name:<20}{ap:>8.4f}{tp:>8.0f}{fp:>8.0f}{fn:>8.0f}\n")
        f.write(f"{'mAP':<20}{per_class[:, 0].mean():>8.4f}\n")

    out = {"table": table_path}
    curves = ap_per_class(true, pred, metric.num_classes,
                          iou_threshold=metric.iou_threshold)["curves"]
    if curves:
        out["pr_curves"] = plot_pr_curves(
            curves, class_names, os.path.join(out_dir, "pr_curves.png")
        )
    cm = build_confusion_matrix(true, pred, metric.num_classes,
                                conf_threshold)
    out["confusion_matrix"] = plot_confusion_matrix(
        cm.matrix, class_names, os.path.join(out_dir, "confusion_matrix.png")
    )
    return out
