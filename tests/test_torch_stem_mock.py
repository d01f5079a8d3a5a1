"""The stem's CUDA source, compiled by g++ as host C++ against the mock of
the CUDA runtime in ``tools/cuda_mock`` and run on CPU threads, against the
kernels' plain PyTorch versions.

The mock runs one thread per CUDA thread with real barriers and emulates
``cp.async``, ``ldmatrix``, ``mma.sync`` and the shuffle by their documented
lane layouts, so this holds the kernels' indexing, tiling, staging, fragment
handling and reductions; it says nothing of what nvcc accepts or how fast
the card runs them (``tests/test_torch_cuda.py`` and ``chip_smoke.py`` do).
In bf16 all four kernels run one conv core (``conv_unit``), so here too the
forward and the backward must agree exactly on every pool window.
Without g++ the tests skip.
"""

import ctypes

import numpy as np
import pytest
import torch

from podtpu_torch.ops.kernels import stem_kernel as sk
from tests.stem_mock_common import (  # noqa: F401 (lib is a fixture)
    ROWS,
    SAVED_BWD,
    _bwd,
    _emit,
    _fn,
    _operands,
    _rel,
    _stats,
    cases,
    check_backward,
    check_forward,
    lib,
)

# the float32 cases and the first shape's bf16 ones. The bf16 ones at the
# other two shapes, the same bits twice, every pool window and the halo
# take minutes on the mock's threads beside the other mocked files, and
# run in files of their own: tests/test_torch_stem_mock_{bf16,bwd_bf16,
# windows,halo}.py
FWD = cases("shape0-dtype0", "shape0-dtype1", "shape1-dtype0", "shape2-dtype0")
BWD = cases("shape0-dtype0", "shape0-dtype1", "shape1-dtype0", "shape2-dtype0")


@pytest.mark.parametrize("shape,dtype", FWD)
def test_mocked_forward_kernels_match_plain_versions(lib, dtype, shape):
    """:func:`tests.stem_mock_common.check_forward`."""
    check_forward(lib, dtype, shape)


@pytest.mark.parametrize("shape,dtype", BWD)
def test_mocked_backward_kernels_match_plain_versions(lib, dtype, shape):
    """:func:`tests.stem_mock_common.check_backward`."""
    check_backward(lib, dtype, shape)


def test_mocked_tensor_core_backward_zeroes_outside_pixels(lib):
    """Ragged tiles: pooled pixels outside the image give no d_pre. With
    c0 far from 0 a leak of outside pixels into dW would be large."""
    x, wt, g, vecs, _, _ = _operands((1, 12, 20), torch.bfloat16)
    vecs = vecs[:5] + (torch.full((32,), 3.0), vecs[6])
    d_r = sk.stem_bwd_dw_reference(x, wt, *vecs, g)
    d = _bwd(lib, "bwd_dw", x, wt, vecs, g, 864).view(3, 3, 3, 32)
    assert _rel(d, d_r) <= 2e-3


def test_mocked_backward_rejects_misaligned_and_odd_shapes(lib):
    x, wt, g, vecs, _, _ = _operands((1, 16, 16), torch.bfloat16)
    fn = lib.podtpu_stem_bwd_sums
    fn.restype, fn.argtypes = ctypes.c_int, sk._ARGTYPES["bwd_sums"]
    partials, out = torch.empty((ROWS, 64)), torch.empty((64,))
    wk, vec = sk._wk(wt, x.dtype), sk._vec7(*vecs)
    args = [x.data_ptr(), wk.data_ptr(), vec.data_ptr(), g.data_ptr(),
            partials.data_ptr(), ROWS, out.data_ptr(), 1, 16, 16, 1, 0, None]
    assert fn(*args) == 0
    assert fn(*(args[:8] + [15] + args[9:])) != 0            # odd H
    assert fn(*([args[0] + 2] + args[1:])) != 0              # x off by 2 bytes


# ---- the forward on the backward's conv core (bf16) ------------------------

def test_mocked_stats_masks_the_conv_beyond_the_border(lib):
    """Ragged tiles: a unit computes its 16 conv pixels whether they lie in
    the image or not, and the conv one pixel beyond the border sees the
    image through its halo. With pixel values near 100 that conv is large:
    let into the sums it would move them by several percent."""
    x, wt, _, _, _, _ = _operands((1, 12, 20), torch.bfloat16)
    x = (x.float() * 50.0 + 50.0).to(torch.bfloat16)
    assert _rel(_stats(lib, x, wt), sk.stem_stats_reference(x, wt)) <= 1e-3


def test_mocked_emit_stores_nothing_outside_the_output(lib):
    """Ragged tiles: pooled pixels outside [B, H/2, W/2, 32] are computed
    but not stored. A guard band of 4 KB on either side of the output keeps
    its fill, and every element inside is written."""
    x, wt, _, vecs, _, _ = _operands((3, 40, 70), torch.bfloat16)
    n, guard = 3 * 20 * 35 * 32, 2048
    buf = torch.full((n + 2 * guard,), -77.0, dtype=torch.bfloat16)
    out = buf[guard:guard + n].view(3, 20, 35, 32)
    assert out.data_ptr() % 16 == 0
    _emit(lib, x, wt, *vecs[:2], out=out)
    assert bool((buf[:guard] == -77.0).all())
    assert bool((buf[guard + n:] == -77.0).all())
    assert bool((out >= 0).all())
    assert torch.equal(out, _emit(lib, x, wt, *vecs[:2]))


def test_mocked_forward_rejects_misaligned_and_odd_shapes(lib):
    x, wt, _, vecs, _, _ = _operands((1, 16, 16), torch.bfloat16)
    wk, vec = sk._wk(wt, x.dtype), torch.stack(vecs[:2]).contiguous()
    partials, sums = torch.empty((ROWS, 64)), torch.empty((64,))
    pooled = torch.empty((1, 8, 8, 32 + 1), dtype=x.dtype).flatten()
    stats, emit = _fn(lib, "stats"), _fn(lib, "emit")
    s_args = [x.data_ptr(), wk.data_ptr(), partials.data_ptr(), ROWS,
              sums.data_ptr(), 1, 16, 16, 1, 0, None]
    e_args = [x.data_ptr(), wk.data_ptr(), vec.data_ptr(), pooled.data_ptr(),
              1, 16, 16, 1, 0, None]
    assert stats(*s_args) == 0 and emit(*e_args) == 0
    assert stats(*(s_args[:7] + [15] + s_args[8:])) != 0     # odd W
    assert emit(*(e_args[:5] + [15] + e_args[6:])) != 0      # odd H
    assert stats(*([s_args[0] + 2] + s_args[1:])) != 0       # x off by 2 bytes
    assert emit(*([e_args[0] + 2] + e_args[1:])) != 0
    assert emit(*(e_args[:3] + [e_args[3] + 2] + e_args[4:])) != 0  # out off
    # float32 has no 16-byte pieces of x: only the shape is checked there
    xf = torch.zeros(x.numel() + 1)[1:].copy_(x.flatten())
    assert xf.data_ptr() % 16 == 4
    assert stats(*([xf.data_ptr()] + s_args[1:8] + [0, 0, None])) == 0


def _saved_case():
    """One seeded bf16 case at (3, 40, 70), ragged tiles, with every vector
    drawn by numpy, so that nothing but the kernels' own arithmetic decides
    the bits of the result."""
    b, h, w = 3, 40, 70
    r = np.random.default_rng(11)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    x = f32(r.random((b, h, w, 3))).to(torch.bfloat16)
    wt = f32(r.normal(0.0, np.sqrt(2.0 / 27), (3, 3, 3, 32)))
    g = f32(r.normal(0, 1, (b, h // 2, w // 2, 32))).to(torch.bfloat16)
    mean, rinv = f32(r.normal(0, 0.3, 32)), f32(r.uniform(0.8, 1.5, 32))
    inv = rinv * f32(r.uniform(0.5, 1.5, 32))
    mul = inv.to(torch.bfloat16).float()
    add = (f32(r.normal(0, 0.1, 32)) - mean * inv).to(torch.bfloat16).float()
    c0, c1 = f32(r.normal(0, 0.01, 32)), f32(r.normal(0, 0.01, 32))
    return x, wt, g, (mul, add, mean, rinv, inv, c0, c1)


def test_mocked_backward_equals_saved_outputs(lib):
    """bwd_sums and bwd_dw give, bit for bit, what they gave before their
    conv core (weight fragments, ldmatrix addressing, product 1, rounding,
    affine, input loads, staging) was lifted into the functions that stats
    and emit now share. The mock's arithmetic is exact IEEE, so the saved
    bits do not depend on the machine."""
    x, wt, g, vecs = _saved_case()
    got = torch.cat([_bwd(lib, "bwd_sums", x, wt, vecs, g, 64),
                     _bwd(lib, "bwd_dw", x, wt, vecs, g, 864)]).numpy()
    want = np.load(SAVED_BWD)
    assert got.shape == want.shape == (928,)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
