"""Tracing / profiling / determinism utilities (the port of
``podtpu/utils/profiling.py``).

The reference's observability is ad-hoc (``Profile``/``Timeout`` context
managers, per-image wall-clock prints — utils/general.py:56-96,
inference_yolov3.py:67-71). The port's equivalents:

* :class:`Profile` — wall-clock context/decorator that synchronizes the
  CUDA device on exit, so it times the work queued inside it, not its
  launch;
* :func:`trace` — a ``torch.profiler`` context writing a TensorBoard trace
  (``*.pt.trace.json``) into a directory;
* :class:`StepTimer` — rolling per-step timing -> images/sec;
* :func:`init_seeds` — one-call determinism (python/numpy seeds, which
  drive the data pipeline, and a seeded ``torch.Generator``).
"""

from __future__ import annotations

import contextlib
import random
import time

import numpy as np
import torch


def _synchronize(device) -> None:
    """Wait for ``device``'s queued work; a CPU device has none. ``None``
    is the current CUDA device, once CUDA has been initialised."""
    dev = None if device is None else torch.device(device)
    if dev is not None and dev.type != "cuda":
        return
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize(dev)


class Profile(contextlib.ContextDecorator):
    """with Profile('fwd') as p: ...  ->  p.dt seconds (device-synced).

    ``device``: the device whose work is timed (``None``: the current CUDA
    device, if any)."""

    def __init__(self, name: str = "", sync: bool = True, device=None):
        self.name = name
        self.sync = sync
        self.device = device
        self.dt = 0.0

    def __enter__(self):
        if self.sync:  # work queued before the region is not its own
            _synchronize(self.device)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.sync:
            _synchronize(self.device)
        self.dt = time.perf_counter() - self.start
        if self.name:
            print(f"{self.name}: {1000 * self.dt:.2f} ms")
        return False


class Timeout(contextlib.ContextDecorator):
    """SIGALRM-based timeout context (general.py:65-82 role): raises or
    suppresses ``TimeoutError`` after ``seconds``. Unix main-thread only."""

    def __init__(self, seconds: float, suppress: bool = False,
                 msg: str = "timed out"):
        self.seconds = seconds
        self.suppress = suppress
        self.msg = msg

    def _handler(self, signum, frame):
        raise TimeoutError(self.msg)

    def __enter__(self):
        import signal

        self._old = signal.signal(signal.SIGALRM, self._handler)
        signal.setitimer(signal.ITIMER_REAL, self.seconds)
        return self

    def __exit__(self, exc_type, exc, tb):
        import signal

        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, self._old)
        return self.suppress and exc_type is TimeoutError


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` trace of the CPU and, when there is one, the CUDA
    device; written into ``logdir`` on exit for TensorBoard's profile
    plugin. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


class StepTimer:
    """Rolling window of step durations -> steps/sec and images/sec."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times: list[float] = []
        self._last: float | None = None

    def tick(self) -> float | None:
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self._times.append(dt)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now
        return dt

    def steps_per_sec(self) -> float:
        if not self._times:
            return 0.0
        return len(self._times) / sum(self._times)

    def images_per_sec(self, batch_size: int) -> float:
        return self.steps_per_sec() * batch_size


def init_seeds(seed: int = 0) -> torch.Generator:
    """Seed python + numpy global RNGs; return a ``torch.Generator`` seeded
    with ``seed``."""
    random.seed(seed)
    np.random.seed(seed)
    return torch.Generator().manual_seed(seed)
