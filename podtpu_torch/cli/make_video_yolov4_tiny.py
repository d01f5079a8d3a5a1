"""Per-version wrapper of ``podtpu_torch.cli.make_video``, as the root
``make_video_yolov4-tiny.py`` is of its script: ``--cfg`` defaults to
``configs/yolov4-tiny_voc.yaml``; runs on ``cuda`` unless ``--device`` says
otherwise (``--device`` in place of the script's ``--platform``). The
module name takes ``_`` for the script's ``-``, which ``python -m`` cannot
import."""
import argparse

from podtpu_torch.cli.make_video import run
from podtpu_torch.config import get_configs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cfg", type=str, default="configs/yolov4-tiny_voc.yaml")
    ap.add_argument("--ckpt", type=str, default=None)
    ap.add_argument("--input", type=str, required=True)
    ap.add_argument("--output", type=str, required=True)
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (cpu for local runs)")
    args = ap.parse_args(argv)
    return run(get_configs(args.cfg), args.ckpt, args.input, args.output,
               device=args.device)


if __name__ == "__main__":
    main()
