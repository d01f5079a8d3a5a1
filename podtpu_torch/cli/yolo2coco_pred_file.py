"""COCO-json predictions for the images of a COCO annotation file, then
COCO-style scoring (the port's ``yolo2coco_pred_file.py``;
yolo2coco_pred_file_yolov3.py:19-121 analog).

Each image is resized to the model's square input without a letterbox, as
the reference does on this path, so predictions map back to the image's
original (width, height) by a plain scale. Scoring uses pycocotools'
COCOeval when it is installed, else the built-in evaluator
(``metrics/coco.py``).

    python -m podtpu_torch.cli.yolo2coco_pred_file --cfg ... --ckpt ... \\
        --json annotations.json --out results.json [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import cv2
import numpy as np

from podtpu_torch.cli import Detector, add_common_args
from podtpu_torch.config import get_configs


def coco_record(image_id, det, sx: float, sy: float) -> dict:
    """One COCO-format prediction record: ``image_id``, 1-based
    ``category_id``, ``bbox`` [x, y, w, h] in original pixels, ``score``."""
    cx, cy, w, h, conf, cls = det
    return {
        "image_id": image_id,
        "category_id": int(cls) + 1,  # COCO categories are 1-based
        "bbox": [
            round(float((cx - w / 2) * sx), 2),
            round(float((cy - h / 2) * sy), 2),
            round(float(w * sx), 2),
            round(float(h * sy), 2),
        ],
        "score": round(float(conf), 5),
    }


def _score(coco: dict, ann_json: str, out_json: str, results: list,
           num_classes: int) -> dict:
    """{"AP", "AP50", "AP75", "evaluator"}: pycocotools' COCOeval when it
    is installed, else ``metrics/coco.py::coco_eval``."""
    try:
        from pycocotools.coco import COCO
        from pycocotools.cocoeval import COCOeval
    except ImportError:
        from podtpu_torch.metrics.coco import coco_eval

        img_index = {info["id"]: i for i, info in enumerate(coco["images"])}
        true_rows, pred_rows = [], []
        for ann in coco.get("annotations", []):
            x, y, w, h = ann["bbox"]
            true_rows.append([
                img_index[ann["image_id"]], x + w / 2, y + h / 2, w, h,
                1.0, ann["category_id"] - 1,
            ])
        for det in results:
            x, y, w, h = det["bbox"]
            pred_rows.append([
                img_index[det["image_id"]], x + w / 2, y + h / 2, w, h,
                det["score"], det["category_id"] - 1,
            ])
        r = coco_eval(np.asarray(true_rows, np.float32),
                      np.asarray(pred_rows, np.float32), num_classes)
        print("pycocotools not installed; built-in COCO-style eval:")
        print(f"  AP@[.5:.95] = {r['AP']:.4f}  AP50 = {r['AP50']:.4f}  "
              f"AP75 = {r['AP75']:.4f}")
        return {"AP": r["AP"], "AP50": r["AP50"], "AP75": r["AP75"],
                "evaluator": "builtin"}
    gt = COCO(ann_json)
    dt = gt.loadRes(out_json)
    ev = COCOeval(gt, dt, "bbox")
    ev.evaluate()
    ev.accumulate()
    ev.summarize()
    return {"AP": float(ev.stats[0]), "AP50": float(ev.stats[1]),
            "AP75": float(ev.stats[2]), "evaluator": "pycocotools"}


def run(cfg: dict, ckpt: str | None, ann_json: str, out_json: str,
        device=None, artifact: str | None = None) -> dict:
    """Writes ``out_json`` and returns the scores (``_score``) with the
    number of detections written."""
    with open(ann_json, "r") as f:
        coco = json.load(f)
    images = coco["images"]
    img_dir = os.path.dirname(ann_json)
    detect = Detector(cfg, ckpt, artifact, device)
    size = cfg["input_size"]

    results = []
    for info in images:
        path = os.path.join(img_dir, info["file_name"])
        img = cv2.imread(path)
        if img is None:
            raise FileNotFoundError(path)
        h0, w0 = img.shape[:2]
        inp = cv2.resize(img, (size, size), interpolation=cv2.INTER_LINEAR)
        inp = cv2.cvtColor(inp, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0
        dets = detect(inp[None])
        sx, sy = w0 / size, h0 / size
        for det in dets:
            results.append(coco_record(info["id"], det, sx, sy))

    with open(out_json, "w") as f:
        json.dump(results, f)
    print(f"wrote {len(results)} detections to {out_json}")
    scores = _score(coco, ann_json, out_json, results, cfg["num_classes"])
    return dict(scores, n_detections=len(results))


def main(argv=None):
    ap = argparse.ArgumentParser()
    add_common_args(ap, "emit COCO results from an exported serving artifact")
    ap.add_argument("--json", required=True, type=str,
                    help="COCO annotation json")
    ap.add_argument("--out", type=str, default="results.json")
    args = ap.parse_args(argv)
    return run(get_configs(args.cfg), args.ckpt, args.json, args.out,
               device=args.device, artifact=args.artifact)


if __name__ == "__main__":
    main()
