"""What the tests of the stem's mocked build share
(``tests/test_torch_stem_mock*.py``): the g++ build against
``tools/cuda_mock``, the entry points' calls, the operands, and the checks
of the forward and backward kernels against their plain versions, which
those files run at the shapes and dtypes each holds."""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from podtpu_torch.ops.kernels import stem_kernel as sk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "podtpu_torch", "csrc", "stem_fused.cu")
MOCK = os.path.join(ROOT, "tools", "cuda_mock")
ROWS = 16        # rows of the partial-sum buffer: more than the mock's grid
# one tile per image; ragged 3 x 3 tiles; 448 px wide (YOLOv1): 14 column
# tiles of 16 pooled columns
SHAPES = [(2, 16, 24), (3, 40, 70), (1, 16, 448)]
# sums then dW of the two backward kernels on _saved_case(), from the mocked
# kernels as they stood before the conv core became functions of its own
SAVED_BWD = os.path.join(ROOT, "tests", "test_torch_stem_mock_bwd.npy")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels against the CUDA mock")
    out = str(tmp_path_factory.mktemp("cuda_mock") / "stem_fused_mock.so")
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-pthread",
                    "-shared", "-fPIC", "-x", "c++", "-I", MOCK, "-o", out,
                    SOURCE], check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(out)


def _fn(lib, name):
    fn = getattr(lib, f"podtpu_stem_{name}")
    fn.restype = ctypes.c_int
    fn.argtypes = sk._ARGTYPES[name]
    return fn


def _call(lib, name, *args):
    assert _fn(lib, name)(*args) == 0


def _operands(shape, dtype, seed=5):
    b, h, w = shape
    r = np.random.default_rng(seed)
    as_t = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    x = as_t(r.random((b, h, w, 3))).to(dtype)
    wt = as_t(r.normal(0.0, np.sqrt(2.0 / 27), (3, 3, 3, 32)))
    scale, bias = as_t(r.uniform(0.5, 1.5, 32)), as_t(r.normal(0, 0.1, 32))
    g = as_t(r.normal(0, 1, (b, h // 2, w // 2, 32))).to(dtype)
    n = b * h * w
    s = sk.stem_stats_reference(x, wt)
    mean = s[0] / n
    var = (s[1] / n - mean * mean).clamp_min(0.0)
    rinv = torch.rsqrt(var + 1e-5)
    inv = rinv * scale
    mul, add = inv.to(dtype).float(), (bias - mean * inv).to(dtype).float()
    u = sk.stem_bwd_sums_reference(x, wt, mul, add, mean, rinv, g)
    return x, wt, g, (mul, add, mean, rinv, inv, u[0] / n, u[1] / n), s, u


def _bwd(lib, name, x, wt, vecs, g, cols, halo=0):
    b, h, w, _ = x.shape
    h -= 2 * halo
    partials = torch.empty((ROWS, cols))
    out = torch.empty((cols,))
    wk, vec = sk._wk(wt, x.dtype), sk._vec7(*vecs)
    _call(lib, name, x.data_ptr(), wk.data_ptr(), vec.data_ptr(),
          g.data_ptr(), partials.data_ptr(), ROWS, out.data_ptr(), b, h, w,
          int(x.dtype == torch.bfloat16), halo, None)
    return out


def _stats(lib, x, wt, halo=0):
    b, h, w, _ = x.shape
    h -= 2 * halo
    partials, out = torch.empty((ROWS, 64)), torch.empty((64,))
    wk = sk._wk(wt, x.dtype)
    _call(lib, "stats", x.data_ptr(), wk.data_ptr(), partials.data_ptr(), ROWS,
          out.data_ptr(), b, h, w, int(x.dtype == torch.bfloat16), halo, None)
    return out.view(2, 32)


def _emit(lib, x, wt, mul, add, out=None, halo=0):
    b, h, w, _ = x.shape
    h -= 2 * halo
    if out is None:
        out = torch.empty((b, h // 2, w // 2, 32), dtype=x.dtype)
    wk, vec = sk._wk(wt, x.dtype), torch.stack([mul, add]).contiguous()
    _call(lib, "emit", x.data_ptr(), wk.data_ptr(), vec.data_ptr(),
          out.data_ptr(), b, h, w, int(x.dtype == torch.bfloat16), halo, None)
    return out


def _rel(a, b):
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


def _cos(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


DTYPES = [torch.float32,   # dtype0: the f32-pipe kernels
          torch.bfloat16]  # dtype1: the tensor-core kernels


def cases(*ids):
    """``(shape, dtype)`` parameters by their ids ``shape{i}-dtype{j}``:
    the ids the cases had when one file held them all."""
    out = []
    for case in ids:
        i, j = (int(p[-1]) for p in case.split("-"))
        out.append(pytest.param(SHAPES[i], DTYPES[j], id=case))
    return out


def check_forward(lib, dtype, shape):
    """stats within 1e-5 (float32) or 1e-3 (bf16) of its max; the pooled
    output within 1e-5, or in bf16 equal on all but 1% of the elements and
    within 2^-7 of its max (the CPU conv sums in another order)."""
    x, wt, g, vecs, s_r, _ = _operands(shape, dtype)
    assert _rel(_stats(lib, x, wt), s_r) <= (1e-5 if dtype == torch.float32
                                             else 1e-3)
    pooled = _emit(lib, x, wt, *vecs[:2])
    want = sk.stem_emit_reference(x, wt, *vecs[:2])
    diff = (pooled.float() - want.float()).abs()
    if dtype == torch.float32:
        assert float(diff.max()) <= 1e-5
    else:
        assert float((diff > 0).float().mean()) <= 0.01
        assert float(diff.max()) <= 2.0 ** -7 * float(want.float().abs().max())


def check_backward(lib, dtype, shape):
    """sums and dW within 1e-4 of their max in float32; in bf16 within the
    card checks' limits (cosine >= 0.995, 2e-3 of the max). The mock gives
    the grid 2 blocks, so at 27 tiles each block walks 13 or 14 of them
    through both load stages."""
    x, wt, g, vecs, _, u_r = _operands(shape, dtype)
    d_r = sk.stem_bwd_dw_reference(x, wt, *vecs, g)
    u = _bwd(lib, "bwd_sums", x, wt, vecs, g, 64).view(2, 32)
    d = _bwd(lib, "bwd_dw", x, wt, vecs, g, 864).view(3, 3, 3, 32)
    for got, want in ((u, u_r), (d, d_r)):
        if dtype == torch.float32:
            assert _rel(got, want) <= 1e-4
        else:
            assert _rel(got, want) <= 2e-3
            assert _cos(got, want) >= 0.995
    # no atomics, fixed orders: a second launch gives the same bits
    assert torch.equal(d, _bwd(lib, "bwd_dw", x, wt, vecs, g,
                               864).view(3, 3, 3, 32))
