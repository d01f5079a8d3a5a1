#!/usr/bin/env python3
"""Where the port's host data pipeline spends its time.

    python3 tools/loader_probe.py [--workers 1 2 4 8] [--n 128] [--size 480]

Writes ``podtpu_torch.data.synthetic``'s set (as ``chip_smoke.py``'s phase
``fit`` does: ``--n`` train images at ``--size`` px, 20 classes, up to 8
objects) into a temporary directory, builds the train dataset of
``configs/yolov3_voc.yaml`` (letterbox pipeline, augmented, uint8) and
prints one JSON line with:

* ``per_sample_ms``: one thread, every sample once, the time in each
  function of ``podtpu_torch.data.augment`` that ``get`` calls (timed by
  wrapping them) and the rest of ``get`` (labels, box math, the BGR->RGB
  conversion, the flip);
* ``loader_img_per_s``: ``Loader`` alone (no consumer work), one epoch
  after a warm-up epoch, for each thread count of ``--workers``, for 8
  threads with cv2's own thread pool cut to one thread
  (``cv2.setNumThreads(1)`` in this tool only; the port leaves cv2 as it
  is), and for 8 processes (``worker_mode="process"``, whose pool is
  spawned anew each epoch);
* the host's CPU count and cv2's thread count.

Host work only: it needs no card, and on a machine with one it reads the
CPUs the card's loader shares.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def per_sample_ms(ds) -> dict:
    """ms a sample in each augment function ``ds.get`` calls, one thread."""
    from podtpu_torch.data import augment

    spent: dict[str, float] = {}
    saved = {}
    for name in ("load_resized", "letterbox", "random_affine", "pixel_ops",
                 "augment_hsv", "mosaic4", "copy_paste"):
        fn = saved[name] = getattr(augment, name)

        def timed(*a, _fn=fn, _name=name, **k):
            t0 = time.perf_counter()
            out = _fn(*a, **k)
            spent[_name] = spent.get(_name, 0.0) + time.perf_counter() - t0
            return out

        setattr(augment, name, timed)
    try:
        t0 = time.perf_counter()
        for i in range(len(ds)):
            ds.get(i, 1000 + i)
        total = time.perf_counter() - t0
    finally:
        for name, fn in saved.items():
            setattr(augment, name, fn)
    n = len(ds)
    out = {k: v * 1e3 / n for k, v in spent.items()}
    out["rest_of_get"] = (total - sum(spent.values())) * 1e3 / n
    out["total"] = total * 1e3 / n
    return out


def loader_img_per_s(ds, cfg, workers: int, mode: str) -> float:
    from podtpu_torch.data.loader import Loader

    loader = Loader(ds, batch_size=cfg["batch_size"], shuffle=True,
                    max_annots=cfg["max_annots"], workers=workers,
                    seed=0, worker_mode=mode)
    sum(b["n_valid"] for b in loader)  # warm-up epoch (and pool start)
    loader.set_epoch(1)
    t0 = time.perf_counter()
    n = sum(b["n_valid"] for b in loader)
    return n / (time.perf_counter() - t0)


def main() -> int:
    import cv2

    from podtpu_torch.config import get_configs
    from podtpu_torch.data.dataset import build_datasets
    from podtpu_torch.data.synthetic import generate

    ap = argparse.ArgumentParser()
    ap.add_argument("--workers", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--size", type=int, default=480)
    args = ap.parse_args()

    tmp = tempfile.mkdtemp(prefix="podtpu_loader_")
    try:
        info = generate(os.path.join(tmp, "data"), n_train=args.n, n_val=0,
                        size=args.size, num_classes=20, max_objects=8, seed=0)
        cfg = get_configs(os.path.join(REPO, "configs", "yolov3_voc.yaml"))
        cfg.update(train_list=info["train_list"], val_list=info["val_list"])
        ds, _ = build_datasets(cfg)
        result = {
            "cpu_count": os.cpu_count(),
            "cv2_threads": cv2.getNumThreads(),
            "n": args.n, "size": args.size,
            "input_size": cfg["input_size"], "batch": cfg["batch_size"],
            "per_sample_ms": per_sample_ms(ds),
            "loader_img_per_s": {
                f"thread_{w}": loader_img_per_s(ds, cfg, w, "thread")
                for w in args.workers},
        }
        rates = result["loader_img_per_s"]
        threads = cv2.getNumThreads()
        cv2.setNumThreads(1)
        try:
            rates["thread_8_cv2_one_thread"] = loader_img_per_s(
                ds, cfg, 8, "thread")
            result["per_sample_ms_cv2_one_thread"] = per_sample_ms(ds)
        finally:
            cv2.setNumThreads(threads)
        rates["process_8"] = loader_img_per_s(ds, cfg, 8, "process")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
