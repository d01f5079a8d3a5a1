"""Per-version wrapper of ``podtpu_torch.train.run``, as the root
``train_yolov4-tiny.py`` is of its script: ``--cfg`` defaults to
``configs/yolov4-tiny_voc.yaml``; runs on ``cuda`` unless ``--device`` says
otherwise. The module name takes ``_`` for the script's ``-``, which
``python -m`` cannot import:

    python -m podtpu_torch.cli.train_yolov4_tiny --cfg configs/yolov4-tiny_voc.yaml
"""
import argparse

from podtpu_torch.config import get_configs
from podtpu_torch.train.run import train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cfg", type=str, default="configs/yolov4-tiny_voc.yaml")
    ap.add_argument("--resume", type=str, default=None)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (cpu for local runs)")
    args = ap.parse_args(argv)
    return train(get_configs(args.cfg), resume=args.resume, epochs=args.epochs,
                 device=args.device)


if __name__ == "__main__":
    main()
