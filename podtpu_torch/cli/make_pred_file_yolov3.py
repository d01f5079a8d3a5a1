"""Per-version wrapper of ``podtpu_torch.cli.make_pred_file``, as the root
``make_pred_file_yolov3.py`` is of its script: ``--cfg`` defaults to
``configs/yolov3_voc.yaml``; runs on ``cuda`` unless ``--device`` says
otherwise."""
import argparse

from podtpu_torch.cli.make_pred_file import make_pred_files
from podtpu_torch.config import get_configs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cfg", type=str, default="configs/yolov3_voc.yaml")
    ap.add_argument("--ckpt", type=str, default=None)
    ap.add_argument("--out", type=str, required=True)
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (cpu for local runs)")
    args = ap.parse_args(argv)
    return make_pred_files(get_configs(args.cfg), args.ckpt, args.out,
                           device=args.device)


if __name__ == "__main__":
    main()
