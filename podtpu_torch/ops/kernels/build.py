"""Build the CUDA sources under ``podtpu_torch/csrc`` with ``nvcc`` and load
them with ctypes.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, ``podtpu_torch/_build/<name>-<digest>.so``, keyed on the content
of the sources and the flags, so an edited kernel is rebuilt and an
unchanged one is not. Libraries build at first use (or all at once, one
``nvcc`` per source in parallel, with :func:`build_all`). A failed build
raises with the compiler's output: there is no fallback.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

# --fmad=false and no fast math: the kernels must round like the plain
# PyTorch versions they are held against (see csrc/nms_suppress.cu).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from source")


def sources() -> list[str]:
    """Kernel names: one per ``csrc/*.cu``."""
    return sorted(os.path.splitext(os.path.basename(p))[0]
                  for p in glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _target(name: str) -> tuple[str, str]:
    src = os.path.join(CSRC_DIR, name + ".cu")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src] + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    return src, os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def _start(name: str):
    """Start ``nvcc`` for ``name`` unless its library is built; returns
    (popen or None, tmp, out)."""
    src, out = _target(name)
    if os.path.exists(out):
        return None, None, out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc, tmp: str, out: str, timeout: float = 600.0):
    if proc is None:
        return
    try:
        log, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise RuntimeError(f"nvcc timed out after {timeout:.0f}s on {name}.cu")
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {name}.cu (exit "
                           f"{proc.returncode}):\n{log}")
    with open(out + ".log", "w") as f:
        f.write(log)
    os.replace(tmp, out)


def build_all() -> dict[str, str]:
    """Build every ``csrc/*.cu`` that is not built yet, one ``nvcc`` each,
    all started together. Returns {name: library path}."""
    with _LOCK:
        started = {name: _start(name) for name in sources()}
        try:
            for name, job in started.items():
                _finish(name, *job)
        finally:
            for proc, _, _ in started.values():
                if proc is not None and proc.poll() is None:
                    proc.kill()
                    proc.wait()
    return {name: job[2] for name, job in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            job = _start(name)
            _finish(name, *job)
            lib = _LIBS[name] = ctypes.CDLL(job[2])
    return lib


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) of the build of ``csrc/<name>.cu``, if it was built here."""
    path = _target(name)[1] + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()
