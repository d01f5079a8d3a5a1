"""Build the native host matcher (``native/map_matcher.cpp``) with ``g++``
and load it with ctypes.

The library is ``podtpu_torch/_build/map_matcher-<digest>.so``, keyed on the
content of the source and the flags (as ``ops/kernels/build.py`` keys the
CUDA libraries), so an edited source is rebuilt and an unchanged one is not.
It builds at first use. A failed build or load raises with the compiler's
output: there is no numpy fallback (``metrics/map.py`` keeps the numpy
matcher only as the plain version the tests hold the native one against).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "map_matcher.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None


def _target() -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"map_matcher-{h.hexdigest()[:16]}.so")


def _build(out: str):
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, _SRC, "-o", tmp],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as exc:
        raise RuntimeError(f"podtpu_torch.native: g++ could not build "
                           f"{_SRC}: {exc}") from exc
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(f"podtpu_torch.native: g++ failed on {_SRC} "
                           f"(exit {proc.returncode}):\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)


def get_lib() -> ctypes.CDLL:
    """The loaded matcher library, built first if needed."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            out = _target()
            if not os.path.exists(out):
                _build(out)
            lib = ctypes.CDLL(out)
            lib.class_tp_fp.restype = ctypes.c_int
            lib.class_tp_fp.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.c_float,
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ]
            _LIB = lib
    return _LIB


def native_class_tp_fp(dets: np.ndarray, gts: np.ndarray,
                       iou_threshold: float):
    """Greedy TP/FP matching (dets pre-sorted by -conf); returns (tp, fp)."""
    lib = get_lib()
    dets = np.ascontiguousarray(dets, np.float32)
    gts = np.ascontiguousarray(gts, np.float32)
    n, m = len(dets), len(gts)
    tp = np.zeros(n, np.float32)
    fp = np.zeros(n, np.float32)
    fptr = ctypes.POINTER(ctypes.c_float)
    rc = lib.class_tp_fp(
        dets.ctypes.data_as(fptr), n,
        gts.ctypes.data_as(fptr), m,
        ctypes.c_float(iou_threshold),
        tp.ctypes.data_as(fptr), fp.ctypes.data_as(fptr),
    )
    if rc != 0:
        raise RuntimeError(f"podtpu_torch.native: class_tp_fp returned {rc}")
    return tp, fp
