"""podtpu_torch — the PyTorch / CUDA port of ``podtpu`` for NVIDIA Hopper.

Module paths and names follow ``podtpu`` so each piece has an obvious
counterpart there (``podtpu_torch/ops/nms.py`` <-> ``podtpu/ops/nms.py``).
Plain tensor code is PyTorch; each Pallas kernel of ``podtpu`` becomes a
hand-written CUDA kernel under ``csrc/`` with its plain PyTorch version
beside the wrapper (``ops/kernels/``).

The port imports nothing of ``podtpu`` or JAX: what it needs from
``podtpu``'s host code it keeps as its own copy.

Entry points run on ``cuda`` unless the caller asks for the CPU
(``device="cpu"``); without a card they raise instead of falling back.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``. Raises when CUDA is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "podtpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return dev
