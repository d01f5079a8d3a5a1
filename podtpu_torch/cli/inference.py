"""Batch-1 inference over the validation list with per-image latency (the
port's ``inference.py``; inference_yolov3.py:19-97 analog). Headless by
default: tagged GT(red)/pred(green) images go to ``--out``; ``--show``
opens cv2 windows.

    python -m podtpu_torch.cli.inference --cfg configs/yolov3_voc.yaml \\
        --ckpt ... --out /tmp/vis [--limit N] [--device cpu]
    python -m podtpu_torch.cli.inference --cfg ... --artifact model.pt2

The printed latency is what a caller waits for: from the image on the
host to its detections on the host (the eval step or the artifact, then
``.cpu()``, inside a device-synchronised
:class:`~podtpu_torch.utils.profiling.Profile`). An artifact exported at
batch B runs B tiled copies: its time is labelled as the batch's.
"""

from __future__ import annotations

import argparse
import os

import cv2
import numpy as np

from podtpu_torch.cli import Detector, add_common_args, class_names
from podtpu_torch.config import get_configs
from podtpu_torch.data.dataset import build_datasets
from podtpu_torch.data.loader import Loader
from podtpu_torch.utils.profiling import Profile
from podtpu_torch.utils.viz import annots_to_boxes, draw_boxes


def inference(cfg: dict, ckpt: str | None, out_dir: str | None,
              show: bool = False, limit: int | None = None,
              device=None, artifact: str | None = None) -> list[float]:
    """Runs the first ``limit`` val images (all by default) one at a time;
    returns each image's latency in ms."""
    _, val_ds = build_datasets(cfg)
    loader = Loader(val_ds, batch_size=1, shuffle=False,
                    max_annots=cfg["max_annots"], workers=1)
    detect = Detector(cfg, ckpt, artifact, device)
    unit = (f"ms/batch-{detect.batch}" if artifact and detect.batch
            and detect.batch > 1 else "ms")
    names = class_names(cfg)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)

    size = cfg["input_size"]
    latencies = []
    for idx, batch in enumerate(loader):
        if limit is not None and idx >= limit:
            break
        with Profile(device=detect.device) as p:
            dets = detect(batch["img"])
        latencies.append(p.dt * 1000)
        print(f"[{idx}] inference: {latencies[-1]:.2f} {unit}, "
              f"{len(dets)} boxes")

        raw = batch["img"][0]
        img = (raw if raw.dtype == np.uint8 else
               (raw * 255).astype(np.uint8))
        img = cv2.cvtColor(img, cv2.COLOR_RGB2BGR)
        img = draw_boxes(img, annots_to_boxes(batch["annot"][0], size),
                         names, color=(0, 0, 255))
        img = draw_boxes(img, dets, names, color=(0, 255, 0))
        if out_dir:
            cv2.imwrite(os.path.join(out_dir, f"{idx:05d}.jpg"), img)
        if show:
            cv2.imshow("inference", img)
            key = cv2.waitKey(0)
            if key == 27:  # ESC
                break
            if key == ord("c") and out_dir:
                cv2.imwrite(os.path.join(out_dir, f"capture_{idx:05d}.jpg"),
                            img)
    if show:
        cv2.destroyAllWindows()
    return latencies


def main(argv=None):
    ap = argparse.ArgumentParser()
    add_common_args(ap, "run an exported serving artifact")
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--show", action="store_true")
    ap.add_argument("--limit", type=int, default=None)
    args = ap.parse_args(argv)
    return inference(get_configs(args.cfg), args.ckpt, args.out, args.show,
                     args.limit, device=args.device, artifact=args.artifact)


if __name__ == "__main__":
    main()
