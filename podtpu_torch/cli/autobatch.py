"""Auto-batch sizing on the card (``podtpu``'s ``tools/autobatch.py``).

``podtpu`` plans the train step's memory ahead of time: XLA compiles the
step at each candidate batch and reports its buffers before anything runs.
PyTorch has no such plan, so this tool measures instead: it runs the REAL
train step (the config's remat policy, device augmentation, EMA and batch
leaves: uint8 or float images, ``device_geom``'s ``geom`` rows) at each
candidate batch on the card, and reads the caching allocator's peak. It
recommends the largest batch whose peak fits a share of the card's memory,
by ``podtpu``'s rule.

    python -m podtpu_torch.cli.autobatch --cfg configs/yolov3_voc.yaml
    python -m podtpu_torch.cli.autobatch --cfg ... --batches 32,64,128 \
        --frac 0.92 --mem-gb 80

The CPU has no peak-memory reading: :func:`measure_memory` raises there
(a deviation from ``podtpu``, whose plan needs no device). One process,
one card: the batch is the per-card batch, as ``podtpu``'s per-chip one.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from podtpu_torch import resolve_device


def synthetic_batch(cfg: dict, batch_size: int, device: torch.device,
                    seed: int = 0) -> dict:
    """A train batch shaped as the loader makes it for ``cfg``: uint8 (cfg
    ``uint8_batches``, the default) or float images, ``max_annots`` padded
    boxes, and with ``device_geom`` identity ``geom`` rows."""
    from podtpu_torch.data.loader import pad_annotations

    r = np.random.default_rng(seed)
    size = int(cfg["input_size"])
    shape = (batch_size, size, size, int(cfg.get("in_channels", 3)))
    img = r.integers(0, 256, shape, dtype=np.uint8)
    if not bool(cfg.get("uint8_batches", True)):
        img = img.astype(np.float32) / 255.0
    boxes = [np.asarray([[*r.uniform(0.2, 0.8, 2), *r.uniform(0.05, 0.5, 2),
                          r.integers(0, cfg["num_classes"])]
                         for _ in range(4)], np.float32)
             for _ in range(batch_size)]
    out = {"img": img,
           "annot": pad_annotations(boxes, int(cfg.get("max_annots", 64)))}
    if bool(cfg.get("device_geom", False)):
        out["geom"] = np.tile(np.asarray([1.0, 1.0, 0.0, 0.0], np.float32),
                              (batch_size, 1))
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def measure_memory(cfg: dict, batch_size: int,
                   device: str | torch.device | None = None) -> dict:
    """Run the train step at ``batch_size`` on the card and return its
    bytes: ``state`` (allocated after the train state is made), ``peak``
    (the allocator's peak over one step after a warm-up step, with the
    peak statistics reset between them) and ``reserved`` (the caching
    allocator's peak reservation over that step).

    Raises on the CPU, which has no peak-memory reading."""
    from podtpu_torch.train.state import create_train_state
    from podtpu_torch.train.steps import make_train_step

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("measure_memory reads the CUDA allocator's peak; "
                         f"the {dev.type} has no such reading")
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    with torch.random.fork_rng(devices=[dev]):
        torch.manual_seed(int(cfg.get("seed", 0)))
        state = create_train_state(cfg, dev)
    step = make_train_step(cfg)
    state_bytes = torch.cuda.memory_allocated(dev) - base
    try:
        batch = synthetic_batch(cfg, batch_size, dev)
        state, _ = step(state, batch)  # warm-up: kernels built, momentum made
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        state, _ = step(state, batch)
        torch.cuda.synchronize(dev)
        row = {"batch": int(batch_size), "state": int(state_bytes),
               "peak": int(torch.cuda.max_memory_allocated(dev) - base),
               "reserved": int(torch.cuda.max_memory_reserved(dev))}
    finally:
        del state, step
        torch.cuda.empty_cache()
    return row


def device_memory_bytes(default_gb: float | None = None,
                        device: str | torch.device | None = None
                        ) -> int | None:
    """The card's memory (``total_memory``), or ``default_gb`` GiB when
    given (``--mem-gb``)."""
    if default_gb:
        return int(default_gb * (1 << 30))
    dev = resolve_device(device)
    if dev.type != "cuda":
        return None
    return int(torch.cuda.get_device_properties(dev).total_memory)


def recommend(rows: list[dict], limit_bytes: int, frac: float = 0.9
              ) -> int | None:
    """Largest analyzed batch whose planned peak fits ``frac * limit``."""
    fitting = [r["batch"] for r in rows if r["peak"] <= frac * limit_bytes]
    return max(fitting) if fitting else None


def _fmt(n: int) -> str:
    return f"{n / (1 << 30):7.2f}"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cfg", required=True, type=str)
    ap.add_argument("--batches", type=str, default="32,64,128,192,256",
                    help="comma-separated candidate batch sizes")
    ap.add_argument("--frac", type=float, default=0.9,
                    help="usable fraction of the card's memory (headroom for "
                         "the allocator's fragmentation and other processes)")
    ap.add_argument("--mem-gb", type=float, default=None,
                    help="the card's memory (GiB); default: its total_memory")
    ap.add_argument("--device", default=None,
                    help="cuda (the default); the CPU has no peak reading")
    args = ap.parse_args(argv)

    from podtpu_torch.config import get_configs

    cfg = get_configs(args.cfg)
    dev = resolve_device(args.device)
    limit = device_memory_bytes(args.mem_gb, dev)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {name}  capacity {limit / (1 << 30):.1f} GiB  usable "
          f"{args.frac:.0%}" if limit else f"device: {name}")
    print(f"{'batch':>6} {'state GiB':>9} {'peak GiB':>8}  fits")
    rows = []
    for b in (int(x) for x in args.batches.split(",") if x.strip()):
        try:
            row = measure_memory(cfg, b, dev)
        except torch.cuda.OutOfMemoryError:
            print(f"{b:>6} out of memory")
            break  # larger candidates only get worse
        rows.append(row)
        fits = "yes" if row["peak"] <= args.frac * limit else "NO"
        print(f"{b:>6} {_fmt(row['state'])}  {_fmt(row['peak'])}  {fits}")
        if row["peak"] > limit:
            break
    best = recommend(rows, limit, args.frac)
    if best is None:
        print("no measured batch fits: try smaller candidates, remat_policy, "
              "fsdp, or a smaller input_size")
    else:
        print(f"recommended per-card batch: {best}")
    return rows, best


if __name__ == "__main__":
    main()
