"""Write Cartucho/mAP-format prediction files, one txt per val image:
``class_name conf xmin ymin xmax ymax`` (the port's ``make_pred_file.py``;
make_pred_file_yolov3.py:15-97 analog) — the reference's
external-calculator cross-validation path.

    python -m podtpu_torch.cli.make_pred_file --cfg ... --ckpt ... \\
        --out mAP/input/detection-results [--device cpu]
    python -m podtpu_torch.cli.make_pred_file --cfg ... --artifact model.pt2 \\
        --out mAP/input/detection-results
"""

from __future__ import annotations

import argparse
import os

from podtpu_torch.cli import Detector, add_common_args, class_names
from podtpu_torch.config import get_configs
from podtpu_torch.data.dataset import build_datasets
from podtpu_torch.data.loader import Loader


def make_pred_files(cfg: dict, ckpt: str | None, out_dir: str, device=None,
                    artifact: str | None = None):
    _, val_ds = build_datasets(cfg)
    loader = Loader(val_ds, batch_size=1, shuffle=False,
                    max_annots=cfg["max_annots"], workers=1)
    detect = Detector(cfg, ckpt, artifact, device)
    names = class_names(cfg)
    os.makedirs(out_dir, exist_ok=True)

    for idx, batch in enumerate(loader):
        dets = detect(batch["img"])
        img_path = val_ds.imgs[idx]
        stem = os.path.splitext(os.path.basename(img_path))[0]
        lines = []
        for cx, cy, w, h, conf, cls in dets:
            x1, y1, x2, y2 = cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2
            lines.append(f"{names[int(cls)]} {conf:.6f} "
                         f"{x1:.2f} {y1:.2f} {x2:.2f} {y2:.2f}")
        with open(os.path.join(out_dir, stem + ".txt"), "w") as f:
            f.write("\n".join(lines) + ("\n" if lines else ""))
    print(f"wrote predictions for {len(val_ds)} images to {out_dir}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    add_common_args(ap, "emit predictions from an exported serving artifact")
    ap.add_argument("--out", type=str, required=True)
    args = ap.parse_args(argv)
    make_pred_files(get_configs(args.cfg), args.ckpt, args.out,
                    device=args.device, artifact=args.artifact)


if __name__ == "__main__":
    main()
