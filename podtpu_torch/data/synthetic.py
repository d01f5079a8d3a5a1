"""Synthetic dataset generators (the port's copies of ``generate`` and
``generate_classification`` from ``podtpu/data/synthetic.py``; the same
seed writes the same files).

No VOC is needed: tests, the CPU smoke training run and ``chip_smoke.py``
use a generated dataset in the exact on-disk format the framework (and the
reference) consume: JPEG images + sibling YOLO-txt labels + list files + a
``.names`` file.

The task is learnable: each image is a noisy background with 1..max_objects
axis-aligned shapes; class = shape color index.

CLI: ``python -m podtpu_torch.data.synthetic --out DIR [--n 200] [--size 416]``.
"""

from __future__ import annotations

import argparse
import os

import cv2
import numpy as np

PALETTE = [
    (220, 40, 40), (40, 200, 60), (50, 80, 230), (230, 220, 50),
    (200, 60, 200), (60, 220, 220), (240, 140, 40), (140, 70, 20),
    (90, 90, 90), (250, 250, 250), (120, 40, 160), (40, 120, 160),
    (160, 120, 40), (20, 60, 120), (120, 20, 60), (60, 120, 20),
    (200, 160, 120), (120, 200, 160), (160, 120, 200), (30, 30, 200),
]


def generate(
    out_dir: str,
    n_train: int = 200,
    n_val: int = 50,
    size: int = 256,
    num_classes: int = 4,
    max_objects: int = 4,
    seed: int = 0,
) -> dict:
    """Write the dataset; returns the config-style paths dict."""
    num_classes = min(num_classes, len(PALETTE))
    os.makedirs(out_dir, exist_ok=True)
    img_dir = os.path.join(out_dir, "images")
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.default_rng(seed)

    def make_split(name: str, count: int) -> str:
        paths = []
        for i in range(count):
            img = rng.integers(90, 150, (size, size, 3)).astype(np.uint8)
            img = cv2.GaussianBlur(img, (5, 5), 0)
            rows = []
            for _ in range(int(rng.integers(1, max_objects + 1))):
                cls = int(rng.integers(0, num_classes))
                w = int(rng.integers(size // 8, size // 3))
                h = int(rng.integers(size // 8, size // 3))
                x1 = int(rng.integers(0, size - w))
                y1 = int(rng.integers(0, size - h))
                color = PALETTE[cls]
                cv2.rectangle(img, (x1, y1), (x1 + w, y1 + h), color, -1)
                rows.append(
                    f"{cls} {(x1 + w / 2) / size:.6f} {(y1 + h / 2) / size:.6f} "
                    f"{w / size:.6f} {h / size:.6f}"
                )
            path = os.path.join(img_dir, f"{name}_{i:05d}.jpg")
            cv2.imwrite(path, img)
            with open(path[:-4] + ".txt", "w") as f:
                f.write("\n".join(rows) + "\n")
            paths.append(path)
        list_path = os.path.join(out_dir, f"{name}.txt")
        with open(list_path, "w") as f:
            f.write("\n".join(paths) + "\n")
        return list_path

    train_list = make_split("train", n_train)
    val_list = make_split("val", n_val)
    names_path = os.path.join(out_dir, "synth.names")
    with open(names_path, "w") as f:
        f.write("\n".join(f"class{i}" for i in range(num_classes)) + "\n")
    return {
        "train_list": train_list,
        "val_list": val_list,
        "names": names_path,
        "num_classes": num_classes,
    }


def generate_classification(
    out_dir: str,
    n_per_class: int = 200,
    size: int = 64,
    num_classes: int = 20,
    seed: int = 0,
) -> list[str]:
    """Write a tiny-imagenet-style imagefolder classification set for
    ``cli/pretrain_darknet.py``: per-class subdirectories
    (``classNN``) of JPEGs, each one dominant rectangle of
    ``PALETTE[cls]`` on the detection set's noisy background, so the
    pretrained backbone's colour and edge features carry over to the
    detection fine-tune. Returns the class directory names."""
    num_classes = min(num_classes, len(PALETTE))
    rng = np.random.default_rng(seed)
    classes = []
    for cls in range(num_classes):
        cdir = os.path.join(out_dir, f"class{cls:02d}")
        os.makedirs(cdir, exist_ok=True)
        classes.append(f"class{cls:02d}")
        for i in range(n_per_class):
            img = rng.integers(90, 150, (size, size, 3)).astype(np.uint8)
            img = cv2.GaussianBlur(img, (5, 5), 0)
            w = int(rng.integers(size // 6, size // 2))
            h = int(rng.integers(size // 6, size // 2))
            x1 = int(rng.integers(0, size - w))
            y1 = int(rng.integers(0, size - h))
            cv2.rectangle(img, (x1, y1), (x1 + w, y1 + h), PALETTE[cls], -1)
            cv2.imwrite(os.path.join(cdir, f"{i:05d}.jpg"), img)
    return classes


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--n", type=int, default=200)
    ap.add_argument("--n-val", type=int, default=50)
    ap.add_argument("--size", type=int, default=416)
    ap.add_argument("--classes", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    info = generate(args.out, args.n, args.n_val, args.size, args.classes,
                    seed=args.seed)
    print(info)


if __name__ == "__main__":
    main()
