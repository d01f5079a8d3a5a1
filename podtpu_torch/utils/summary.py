"""torchinfo-style parameter summary (the port's ``podtpu/utils/summary.py``;
the reference prints one per train script, e.g. train_yolov3.py:43)."""

from __future__ import annotations

from torch import nn


def summarize(model: nn.Module, batch_stats: bool = True) -> str:
    """Tabulate parameters by top-level module with totals; with
    ``batch_stats`` also the count of the buffers (the BN running
    statistics), as ``podtpu`` counts its ``batch_stats``."""
    rows: dict[str, int] = {}
    total = 0
    for name, p in model.named_parameters():
        top = name.split(".", 1)[0] if name else "<root>"
        rows[top] = rows.get(top, 0) + p.numel()
        total += p.numel()
    lines = ["=" * 52, f"{'Module':<36}{'Params':>16}", "-" * 52]
    for name, count in sorted(rows.items()):
        lines.append(f"{name:<36}{count:>16,}")
    lines.append("-" * 52)
    lines.append(f"{'Total trainable params':<36}{total:>16,}")
    if batch_stats:
        bn = sum(b.numel() for b in model.buffers())
        lines.append(f"{'BatchNorm running stats':<36}{bn:>16,}")
    lines.append("=" * 52)
    return "\n".join(lines)
