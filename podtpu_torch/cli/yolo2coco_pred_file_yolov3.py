"""Per-version wrapper of ``podtpu_torch.cli.yolo2coco_pred_file``, as the root
``yolo2coco_pred_file_yolov3.py`` is of its script: ``--cfg`` defaults to
``configs/yolov3_voc.yaml``; runs on ``cuda`` unless ``--device`` says
otherwise."""
import argparse

from podtpu_torch.cli.yolo2coco_pred_file import run
from podtpu_torch.config import get_configs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cfg", type=str, default="configs/yolov3_voc.yaml")
    ap.add_argument("--ckpt", type=str, default=None)
    ap.add_argument("--json", type=str, required=True)
    ap.add_argument("--out", type=str, default="results.json")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (cpu for local runs)")
    args = ap.parse_args(argv)
    return run(get_configs(args.cfg), args.ckpt, args.json, args.out,
               device=args.device)


if __name__ == "__main__":
    main()
