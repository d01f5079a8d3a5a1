"""Benchmark an exported artifact (the port's ``exported_inference.py``;
onnx_inference.py:23-51 analog): load a ``.pt2`` program, a ``.tflite``
file or a SavedModel, run it on a seeded uniform input of its own shape,
print the average latency and FPS.

    python -m podtpu_torch.cli.exported_inference --model model.pt2 \\
        [--iters 50]
    python -m podtpu_torch.cli.exported_inference --model model.tflite \\
        [--device cpu]
    python -m podtpu_torch.cli.exported_inference --model x.savedmodel \\
        [--device cpu]

A ``.pt2`` runs on the device it was exported on; a ``.tflite`` or a
SavedModel runs through the port's reader (``export/tflite.py::
load_tflite``, ``export/savedmodel.py::load_savedmodel``) on ``--device``
(default cuda). On the card each call is timed with CUDA events after
warm-up; on the CPU by the host clock. A symbolic-batch artifact
(``--batch dyn``) is timed at batch 1.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def bench(path: str, iters: int = 50, warmup: int = 3,
          device=None) -> dict:
    """``{"ms", "fps", "batch", "device"}`` of the artifact at ``path``;
    ``device`` is where a ``.tflite`` or a SavedModel runs (default
    cuda)."""
    from podtpu_torch.export.program import load_exported, read_meta
    from podtpu_torch.export.runner import is_savedmodel, load_reader

    if path.endswith(".tflite") or is_savedmodel(path):
        run = load_reader(path, device or "cuda")
        meta = dict(run.meta, device=str(run.device))
    else:
        meta = read_meta(path)
        run = load_exported(path)
    shape = [d if d is not None else 1 for d in meta["input_shape"]]
    dev = torch.device(meta["device"])
    print(f"input: {meta['dtype']}{meta['input_shape']} on {dev}")
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, shape).astype(meta["dtype"])).to(dev)
    for _ in range(warmup):
        run(x)
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            run(x)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / iters
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            run(x)
        ms = 1000 * (time.perf_counter() - t0) / iters
    fps = 1000 * shape[0] / ms
    print(f"avg latency: {ms:.2f} ms  |  {fps:.1f} FPS")
    return {"ms": ms, "fps": fps, "batch": shape[0], "device": str(dev)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", required=True, type=str)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--device", type=str, default=None,
                    help="where a .tflite or a SavedModel runs (default "
                         "cuda; cpu for local runs); a .pt2 runs where it "
                         "was exported")
    args = ap.parse_args(argv)
    return bench(args.model, args.iters, device=args.device)


if __name__ == "__main__":
    main()
