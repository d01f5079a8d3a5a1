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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_mocked_forward_kernels_match_plain_versions(lib, dtype, shape):
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


@pytest.mark.parametrize("dtype", [
    torch.float32,            # the f32-pipe kernels
    torch.bfloat16,           # the tensor-core kernels
])
@pytest.mark.parametrize("shape", SHAPES)
def test_mocked_backward_kernels_match_plain_versions(lib, dtype, shape):
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


def test_mocked_forward_kernels_give_the_same_bits_twice(lib):
    """No atomics and fixed orders in stats; emit stores each element once."""
    x, wt, _, vecs, _, _ = _operands((3, 40, 70), torch.bfloat16)
    assert torch.equal(_stats(lib, x, wt), _stats(lib, x, wt))
    assert torch.equal(_emit(lib, x, wt, *vecs[:2]),
                       _emit(lib, x, wt, *vecs[:2]))


@pytest.mark.parametrize("shape", SHAPES)
def test_mocked_forward_and_backward_agree_on_every_window(lib, shape):
    """With a cotangent of ones bwd_sums' first row counts the pool windows
    of a channel whose max is positive (small integers, exact in float32).
    They are the windows emit wrote as positive, in all 32 channels: both
    kernels make pre and y by one instruction sequence."""
    x, wt, g, vecs, _, _ = _operands(shape, torch.bfloat16)
    pooled = _emit(lib, x, wt, *vecs[:2])
    positive = _bwd(lib, "bwd_sums", x, wt, vecs, torch.ones_like(g),
                    64).view(2, 32)[0]
    emitted = (pooled > 0).sum(dim=(0, 1, 2)).float()
    assert 0 < float(emitted.min())
    assert float(emitted.max()) < pooled[..., 0].numel()
    assert torch.equal(positive, emitted)


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


# ---- a block of rows with its halo (the spatial layout) ---------------------

def _blocks(x, n, zero_halo=False):
    """The n row blocks of NHWC x, each with one row of its neighbours
    above and below (zeros at the image's edge, or everywhere with
    ``zero_halo``): the kernels' ``halo`` input."""
    xp = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 1, 1)).to(x.dtype)
    k = x.shape[1] // n
    out = []
    for i in range(n):
        blk = xp[:, i * k:(i + 1) * k + 2].clone()
        if zero_halo:
            blk[:, 0].zero_()
            blk[:, -1].zero_()
        out.append(blk.contiguous())
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mocked_kernels_with_a_halo_match_the_whole_image(lib, dtype):
    """Two row blocks of a (2, 32, 40) image (ragged column tiles), each
    with its halo: the four kernels on each block against their plain
    twins on it (as the forward and backward tests hold them), the pooled
    blocks bit for bit the whole image's pooled rows, and the blocks'
    sums and dW, added, the whole image's (1e-5 of the max in float32,
    1e-3 in bf16). A halo of zeros in place of the neighbour's rows
    changes the pooled rows at the block edge."""
    x, wt, g, vecs, s_r, u_r = _operands((2, 32, 40), dtype)
    blocks = _blocks(x, 2)
    gs = g.chunk(2, dim=1)
    tol = 1e-5 if dtype == torch.float32 else 1e-3
    stats = [_stats(lib, b, wt, halo=1) for b in blocks]
    pooled = [_emit(lib, b, wt, *vecs[:2], halo=1) for b in blocks]
    sums = [_bwd(lib, "bwd_sums", b, wt, vecs, gi.contiguous(), 64, halo=1)
            for b, gi in zip(blocks, gs)]
    dws = [_bwd(lib, "bwd_dw", b, wt, vecs, gi.contiguous(), 864, halo=1)
           for b, gi in zip(blocks, gs)]
    for b, gi, s, u, d in zip(blocks, gs, stats, sums, dws):
        gi = gi.contiguous()
        assert _rel(s, sk.stem_stats_reference(b, wt, halo=True)) <= tol
        assert _rel(u.view(2, 32), sk.stem_bwd_sums_reference(
            b, wt, *vecs[:4], gi, halo=True)) <= 2e-3
        assert _rel(d.view(3, 3, 3, 32), sk.stem_bwd_dw_reference(
            b, wt, *vecs, gi, halo=True)) <= 2e-3
    whole = _emit(lib, x, wt, *vecs[:2])
    assert torch.equal(torch.cat(pooled, dim=1), whole)
    assert _rel(stats[0] + stats[1], _stats(lib, x, wt)) <= tol
    assert _rel((sums[0] + sums[1]).view(2, 32), u_r) <= 2e-3
    assert _rel(dws[0] + dws[1], _bwd(lib, "bwd_dw", x, wt, vecs, g, 864)
                ) <= tol * 10
    zeroed = [_emit(lib, b, wt, *vecs[:2], halo=1)
              for b in _blocks(x, 2, zero_halo=True)]
    assert not torch.equal(torch.cat(zeroed, dim=1), whole)
