"""Per-version wrapper of ``podtpu_torch.train.run``, as the root
``train_yolov4-tiny.py`` is of its script: ``--cfg`` defaults to
``configs/yolov4-tiny_voc.yaml``; runs on ``cuda`` unless ``--device`` says
otherwise. The module name takes ``_`` for the script's ``-``, which
``python -m`` cannot import:

    python -m podtpu_torch.cli.train_yolov4_tiny --cfg configs/yolov4-tiny_voc.yaml
"""
import argparse

from podtpu_torch.config import get_configs
from podtpu_torch.train.run import add_args, distributed, train


def main(argv=None):
    ap = argparse.ArgumentParser()
    add_args(ap, cfg="configs/yolov4-tiny_voc.yaml", device="cuda")
    args = ap.parse_args(argv)
    with distributed(args) as device:
        return train(get_configs(args.cfg), resume=args.resume,
                     epochs=args.epochs, device=device)


if __name__ == "__main__":
    main()
