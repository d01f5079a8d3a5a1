"""Rank-aware logging (the port's copy of ``podtpu/utils/log.py``;
utils/general.py:46-53 role).

On multi-process runs only rank 0 emits INFO-level logs; other ranks log
warnings and errors. ``colorstr`` gives the reference's ANSI highlighting
(general.py:472-494 role) for terminals that support it.
"""

from __future__ import annotations

import logging
import sys

_ANSI = {
    "black": "\033[30m", "red": "\033[31m", "green": "\033[32m",
    "yellow": "\033[33m", "blue": "\033[34m", "magenta": "\033[35m",
    "cyan": "\033[36m", "white": "\033[37m", "bold": "\033[1m",
    "end": "\033[0m",
}


def colorstr(*args) -> str:
    """colorstr('blue', 'bold', 'text') -> ANSI-wrapped text."""
    *styles, text = args if len(args) > 1 else ("blue", "bold", args[0])
    return "".join(_ANSI.get(s, "") for s in styles) + str(text) + _ANSI["end"]


def _rank() -> int:
    """This process's rank: ``torch.distributed``'s once a process group
    is initialised, else the ``RANK`` environment variable (what
    ``torchrun`` sets before any group exists), else 0."""
    import os

    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", 0))


class _RankFilter(logging.Filter):
    """Only rank 0 emits sub-WARNING records (DistributedSampler-era
    rank-aware logging, general.py:46-53 role)."""

    def filter(self, record: logging.LogRecord) -> bool:
        return record.levelno >= logging.WARNING or _rank() == 0


def get_logger(name: str = "podtpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter("%(message)s"))
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    logger.addFilter(_RankFilter())
    logger.propagate = False
    return logger


LOGGER = get_logger()
