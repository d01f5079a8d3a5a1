"""Per-version wrapper of ``podtpu_torch.cli.inference``, as the root
``inference_yolov4-tiny.py`` is of its script: ``--cfg`` defaults to
``configs/yolov4-tiny_voc.yaml``; runs on ``cuda`` unless ``--device`` says
otherwise. The module name takes ``_`` for the script's ``-``, which
``python -m`` cannot import."""
import argparse

from podtpu_torch.cli.inference import inference
from podtpu_torch.config import get_configs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cfg", type=str, default="configs/yolov4-tiny_voc.yaml")
    ap.add_argument("--ckpt", type=str, default=None)
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--show", action="store_true")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (cpu for local runs)")
    args = ap.parse_args(argv)
    return inference(get_configs(args.cfg), args.ckpt, args.out, args.show,
                     args.limit, device=args.device)


if __name__ == "__main__":
    main()
