"""Structured-pruning latency experiment (the port's ``pruning_test.py``;
the reference's pruning_test.py:34-60).

Zeroes the lowest-L2 fraction of output channels in every conv kernel of
Darknet-19 (the effect of torch's ``ln_structured(amount=0.5, n=2,
dim=0)``) and A/B-times the eval forward. The convolutions stay dense, so
no speed-up is expected without a slimming pass; the sparsified weights
are what such a pass would take.

    python -m podtpu_torch.cli.pruning_test [--amount 0.5] [--iters 20] \\
        [--size 416] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from podtpu_torch import resolve_device
from podtpu_torch.models.darknet import Darknet19


def prune_channels(state_dict: dict, amount: float) -> dict:
    """Zero the ``amount`` fraction of output channels with the smallest
    L2 norm in every conv kernel (OIHW: the norm over I, H, W of each O);
    other tensors are kept."""
    out = {}
    for name, t in state_dict.items():
        if name.endswith("weight") and t.dim() == 4:
            norms = torch.sqrt((t.float() ** 2).sum(dim=(1, 2, 3)))
            k = int(t.shape[0] * amount)
            if k:
                threshold = torch.sort(norms).values[k - 1]
                t = t * (norms > threshold).to(t.dtype)[:, None, None, None]
        out[name] = t
    return out


def time_forward(model: torch.nn.Module, x: torch.Tensor, iters: int
                 ) -> float:
    """Seconds per eval forward of ``x`` (NCHW): CUDA events on the card,
    the host clock on the CPU, after one warm-up call."""
    with torch.inference_mode():
        model(x)
        if x.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                model(x)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1000.0 / iters
        t0 = time.perf_counter()
        for _ in range(iters):
            model(x)
        return (time.perf_counter() - t0) / iters


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--amount", type=float, default=0.5)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--size", type=int, default=416)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default cuda; cpu for local runs)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    torch.manual_seed(0)
    model = Darknet19(out_indices=(5,)).to(dev).eval()
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (1, args.size, args.size, 3)).astype(np.float32)).to(dev)
    x = x.permute(0, 3, 1, 2)  # NHWC batch as an NCHW view
    dense = {k: v.clone() for k, v in model.state_dict().items()}
    t_dense = time_forward(model, x, args.iters)
    pruned = prune_channels(dense, args.amount)
    model.load_state_dict(pruned)
    # the share of zeros averaged over the parameters (podtpu's params
    # tree: kernels and the BN affine, not the running statistics)
    params = [v for k, v in pruned.items() if "running_" not in k]
    zero_frac = float(np.mean([(w == 0).float().mean().item()
                               for w in params]))
    t_pruned = time_forward(model, x, args.iters)
    print(f"dense:  {1000 * t_dense:.2f} ms/img")
    print(f"pruned: {1000 * t_pruned:.2f} ms/img "
          f"(~{100 * zero_frac:.0f}% zeros; dense compute — no speedup "
          "expected without a slimming pass)")
    return {"dense_ms": 1000 * t_dense, "pruned_ms": 1000 * t_pruned,
            "zero_frac": zero_frac, "state_dict": pruned}


if __name__ == "__main__":
    main()
