"""Per-version wrapper of ``podtpu_torch.cli.test``, as the root
``test_yolov1.py`` is of its script: ``--cfg`` defaults to
``configs/yolov1_voc.yaml``; runs on ``cuda`` unless ``--device`` says
otherwise."""
import argparse

from podtpu_torch.cli.test import evaluate
from podtpu_torch.config import get_configs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cfg", type=str, default="configs/yolov1_voc.yaml")
    ap.add_argument("--ckpt", type=str, default=None)
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (cpu for local runs)")
    args = ap.parse_args(argv)
    return evaluate(get_configs(args.cfg), args.ckpt, device=args.device)


if __name__ == "__main__":
    main()
