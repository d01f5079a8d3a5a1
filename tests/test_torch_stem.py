"""The port's fused stem against podtpu's (CPU).

``podtpu``'s ``make_fused_stem`` runs its Pallas kernels in interpret mode
(tests/conftest.py); ``stem_pool_reference`` is its plain XLA oracle. The
port's side is ``stem_pool_reference_torch`` (the CPU path of the model)
and ``StemPoolFunction`` (the card's custom backward, run here through the
kernels' plain versions). Inputs are numpy-seeded, at B, H, W = 2, 16, 24.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from podtpu.models.stem import stem_fusable as podtpu_stem_fusable
from podtpu.ops.pallas.stem_fused import make_fused_stem, stem_pool_reference
from podtpu_torch.models.darknet import Darknet19
from podtpu_torch.models.stem import stem_fusable
from podtpu_torch.ops.kernels import stem_kernel
from podtpu_torch.ops.kernels.stem_kernel import (
    StemPoolFunction,
    stem_fused,
    stem_pool_reference_torch,
)

B, H, W, CI, CO = 2, 16, 24, 3, 32
EPS = 1e-5
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed=0):
    r = np.random.default_rng(seed)
    x = r.normal(size=(B, H, W, CI)).astype(np.float32)
    w = (r.normal(size=(3, 3, CI, CO)) * 0.2).astype(np.float32)
    scale = r.uniform(0.5, 1.5, CO).astype(np.float32)
    bias = (r.normal(size=CO) * 0.1).astype(np.float32)
    return x, w, scale, bias


def _cotangent():
    shape = (B, H // 2, W // 2, CO)
    return np.sin(np.arange(np.prod(shape)).reshape(shape) * 0.1
                  ).astype(np.float32)


def _torch_grads(fn, x, w, scale, bias, dtype):
    """(pooled, mean, var, dw, dscale, dbias) of sum(pooled * cotangent)."""
    tw, ts, tb = (torch.tensor(a, requires_grad=True) for a in (w, scale, bias))
    pooled, mean, var = fn(torch.from_numpy(x).to(dtype), tw, ts, tb)
    (pooled.float() * torch.from_numpy(_cotangent())).sum().backward()
    return [t.detach().float().numpy() for t in
            (pooled, mean, var, tw.grad, ts.grad, tb.grad)]


def _jax_grads(fn, x, w, scale, bias):
    t = jnp.asarray(_cotangent())

    def loss(w_, s_, b_):
        return jnp.sum(fn(jnp.asarray(x), w_, s_, b_)[0].astype(jnp.float32) * t)

    out = fn(jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
             jnp.asarray(bias))
    grads = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(w), jnp.asarray(scale), jnp.asarray(bias))
    return [np.asarray(a, np.float32) for a in (*out, *grads)]


def _plain(dtype):
    return lambda x, w, s, b: stem_pool_reference_torch(x, w, s, b, EPS, dtype)


def _function(x, w, s, b):
    return StemPoolFunction.apply(x, w, s, b, EPS)


def _cosine(a, b):
    a, b = a.ravel(), b.ravel()
    return a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-9)


@pytest.mark.parametrize("cdtype", ["float32", "bfloat16"])
def test_plain_forward_matches_podtpu(cdtype):
    x, w, scale, bias = _inputs()
    dt = TORCH_DTYPE[cdtype]
    got = [t.float().numpy() for t in stem_pool_reference_torch(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(scale),
        torch.from_numpy(bias), EPS, dt)]
    fused = make_fused_stem(H, W, CI, CO, cdtype, EPS)
    for want in (stem_pool_reference(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(scale), jnp.asarray(bias), EPS,
                                     jnp.dtype(cdtype)),
                 fused(jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
                       jnp.asarray(bias))):
        wp, wm, wv = (np.asarray(a, np.float32) for a in want)
        # mean and var: float32 sums in another order (podtpu's own test
        # holds the fused op to the oracle at 1e-5); in bf16 also the few
        # conv outputs that round to the neighbouring bf16 value (below)
        stat_tol = 1e-5 if cdtype == "float32" else 1e-4
        np.testing.assert_allclose(got[1], wm, atol=stat_tol)
        np.testing.assert_allclose(got[2], wv, atol=stat_tol)
        if cdtype == "float32":
            np.testing.assert_allclose(got[0], wp, atol=1e-5)
        else:
            # the CPU convs accumulate in float32 in another order: a
            # pre-activation lands on the other side of a bf16 rounding
            # boundary now and then, one bf16 ulp (2^-8 relative) of
            # |pre * mul|, which stays below 2^-7 of the output's max
            diff = np.abs(got[0] - wp)
            assert (diff > 0).mean() <= 0.01
            assert diff.max() <= 2.0 ** -7 * np.abs(wp).max()


@pytest.mark.parametrize("impl", ["plain", "function"])
def test_f32_gradients_match_podtpu(impl):
    """float32: the port's forward and (w, scale, bias) gradients against
    podtpu's custom VJP (Pallas, interpret mode) and the XLA autodiff of
    its oracle, to float32 summation order (rtol 1e-4, as podtpu's own
    test holds its VJP)."""
    x, w, scale, bias = _inputs()
    fn = _plain(torch.float32) if impl == "plain" else _function
    got = _torch_grads(fn, x, w, scale, bias, torch.float32)
    fused = make_fused_stem(H, W, CI, CO, "float32", EPS)
    ref = lambda x_, w_, s_, b_: stem_pool_reference(  # noqa: E731
        x_, w_, s_, b_, EPS, jnp.float32)
    for jfn in (fused, ref):
        want = _jax_grads(jfn, x, w, scale, bias)
        for g, wnt in zip(got, want):
            np.testing.assert_allclose(g, wnt, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("impl", ["plain", "function"])
def test_bf16_gradient_direction(impl):
    """bf16: pool-window ties and the rounding of intermediate gradients
    differ between implementations, so the gradients are held by direction
    (cosine >= 0.995), as podtpu's test holds its own."""
    x, w, scale, bias = _inputs()
    fn = _plain(torch.bfloat16) if impl == "plain" else _function
    got = _torch_grads(fn, x, w, scale, bias, torch.bfloat16)
    want = _jax_grads(make_fused_stem(H, W, CI, CO, "bfloat16", EPS),
                      x, w, scale, bias)
    for g, wnt in zip(got[3:], want[3:]):
        assert _cosine(g, wnt) >= 0.995


def test_function_gives_no_input_gradient():
    x, w, scale, bias = _inputs()
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.tensor(w, requires_grad=True)
    pooled, mean, var = StemPoolFunction.apply(
        tx, tw, torch.from_numpy(scale), torch.from_numpy(bias), EPS)
    assert not mean.requires_grad and not var.requires_grad
    pooled.sum().backward()
    assert tx.grad is None
    assert tw.grad is not None and torch.isfinite(tw.grad).all()


def test_cpu_entry_point_is_the_plain_version(monkeypatch):
    """On a CPU tensor ``stem_fused`` runs the plain version and launches
    nothing."""
    x, w, scale, bias = _inputs()
    monkeypatch.setattr(stem_kernel, "_kernel", lambda name: pytest.fail(
        f"kernel {name} loaded for a CPU tensor"))
    before = dict(stem_fused.launches)
    got = stem_fused(torch.from_numpy(x), torch.from_numpy(w),
                     torch.from_numpy(scale), torch.from_numpy(bias), EPS,
                     torch.float32)
    want = stem_pool_reference_torch(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(scale),
        torch.from_numpy(bias), EPS, torch.float32)
    for g, wn in zip(got, want):
        assert torch.equal(g, wn)
    assert stem_fused.launches == before


def test_cuda_path_rejects_cpu_tensors():
    x, w, _, _ = _inputs()
    with pytest.raises(ValueError, match="CUDA tensors"):
        stem_kernel._check_cuda("stem_stats", torch.from_numpy(x),
                                torch.from_numpy(w))


@pytest.mark.parametrize("bad,err", [
    (dict(x=(2, 16, 24, 4)), ValueError),
    (dict(x=(2, 15, 24, 3)), ValueError),
    (dict(w=(3, 3, 3, 16)), ValueError),
    (dict(dtype=torch.float16), TypeError),
])
def test_kernel_wrappers_reject_bad_inputs(bad, err):
    x = torch.zeros(bad.get("x", (2, 16, 24, 3)),
                    dtype=bad.get("dtype", torch.float32))
    w = torch.zeros(bad.get("w", (3, 3, 3, 32)))
    with pytest.raises(err):
        stem_kernel.stem_stats(x, w)


@pytest.mark.parametrize("shape,training,out_indices", [
    ((2, 32, 32, 3), True, (5,)),
    ((2, 32, 32, 3), False, (5,)),       # eval mode never fuses
    ((2, 32, 32, 3), True, (0, 5)),      # a consumer of the pre-pool map
    ((2, 30, 32, 3), True, (5,)),        # H not a multiple of 8
    ((2, 32, 30, 3), True, (5,)),
    ((2, 32, 31, 3), True, (5,)),        # W odd
    ((2, 32, 32, 4), True, (5,)),        # not 3 input channels
    ((32, 32, 3), True, (5,)),           # not 4-D
])
def test_stem_fusable_matches_podtpu(monkeypatch, shape, training,
                                     out_indices):
    monkeypatch.setenv("PODTPU_STEM", "fused")
    want = podtpu_stem_fusable(jnp.zeros(shape), training, out_indices)
    nchw = torch.zeros(shape).movedim(-1, -3) if len(shape) == 4 \
        else torch.zeros(shape)
    assert stem_fusable(nchw, training, out_indices) == want


def _darknet_pair(seed=1):
    torch.manual_seed(seed)
    fused = Darknet19(out_indices=(1,), dtype=torch.float32)
    stock = Darknet19(out_indices=(0, 1), dtype=torch.float32)
    stock.load_state_dict(fused.state_dict())
    x = torch.from_numpy(np.random.default_rng(seed).uniform(
        0, 1, (2, 32, 32, 3)).astype(np.float32)).permute(0, 3, 1, 2)
    return fused, stock, x


def test_darknet_fused_branch_equals_stock_path_and_keeps_keys():
    """Train mode: the fused branch (out_indices (1,)) and the stock path
    (out_indices (0, 1) keeps stage0 unfused) give the same stage1 output,
    the same running statistics and the same state_dict keys."""
    fused, stock, x = _darknet_pair()
    assert list(fused.state_dict()) == list(stock.state_dict())
    assert stem_fusable(x, True, fused.out_indices)
    assert not stem_fusable(x, True, stock.out_indices)
    y_fused = fused.train()(x)[0]
    y_stock = stock.train()(x)[1]
    torch.testing.assert_close(y_fused, y_stock, rtol=0, atol=0)
    for k, v in fused.state_dict().items():
        torch.testing.assert_close(v, stock.state_dict()[k], rtol=0, atol=0,
                                   msg=k)
    moved = fused.stage0.conv0.bn.running_mean
    assert not torch.equal(moved, torch.zeros_like(moved))


def test_eval_mode_never_reaches_the_stem_op(monkeypatch):
    fused, _, x = _darknet_pair()
    import podtpu_torch.models.stem as stem_mod

    calls = []
    monkeypatch.setattr(stem_mod, "stem_fused",
                        lambda *a: calls.append(1) or stem_fused(*a))
    with torch.no_grad():
        fused.eval()(x)
    assert calls == []
    fused.train()(x)
    assert calls == [1]


# ---- the backward as the tensor-core kernels compute it -------------------

def _bwd_operands(shape, dtype, seed=3):
    """numpy-seeded operands of the two backward passes at (B, H, W): images
    in [0, 1), He-normal weights, the BN vectors from the plain statistics
    and a normal pooled cotangent."""
    b, h, w = shape
    r = np.random.default_rng(seed)
    as_t = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    x = as_t(r.random((b, h, w, CI))).to(dtype)
    wt = as_t(r.normal(0.0, np.sqrt(2.0 / 27), (3, 3, CI, CO)))
    scale, bias = as_t(r.uniform(0.5, 1.5, CO)), as_t(r.normal(0, 0.1, CO))
    g = as_t(r.normal(0, 1, (b, h // 2, w // 2, CO))).to(dtype)
    n = b * h * w
    s = stem_kernel.stem_stats_reference(x, wt)
    mean = s[0] / n
    var = (s[1] / n - mean * mean).clamp_min(0.0)
    rinv = torch.rsqrt(var + EPS)
    inv = rinv * scale
    mul, add = inv.to(dtype).float(), (bias - mean * inv).to(dtype).float()
    return x, wt, g, n, (mul, add, mean, rinv), inv


def _rel(a, b):
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


@pytest.mark.parametrize("cdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 16, 16), (2, 24, 40), (3, 40, 70)])
def test_im2col_backward_equals_plain_versions(cdtype, shape):
    """The two backward passes as matrix products over an im2col matrix
    (32 tap columns, 5 of them zero), the arithmetic of the tensor-core
    kernels, against the plain versions (F.conv2d, conv2d_weight): float32
    within 1e-5 of the result's max (another summation order); bf16 within
    the card checks' limits, cosine >= 0.995 and 2e-3 of the max (a
    pre-activation may round to the neighbouring bf16 value)."""
    dt = TORCH_DTYPE[cdtype]
    x, wt, g, n, vecs, inv = _bwd_operands(shape, dt)
    u_r = stem_kernel.stem_bwd_sums_reference(x, wt, *vecs, g)
    u_i = stem_kernel.stem_bwd_sums_im2col(x, wt, *vecs, g)
    c0, c1 = u_r[0] / n, u_r[1] / n
    d_r = stem_kernel.stem_bwd_dw_reference(x, wt, *vecs, inv, c0, c1, g)
    d_i = stem_kernel.stem_bwd_dw_im2col(x, wt, *vecs, inv, c0, c1, g)
    assert d_i.shape == (3, 3, CI, CO) and u_i.shape == (2, CO)
    for got, want in ((u_i, u_r), (d_i, d_r)):
        if cdtype == "float32":
            assert _rel(got, want) <= 1e-5
        else:
            assert _rel(got, want) <= 2e-3
            assert _cosine(got.numpy(), want.numpy()) >= 0.995


def test_im2col_matrix_layout():
    """Row (b, y, x) of the im2col matrix holds the zero-padded 3x3 patch
    in (ky, kx, ci) order, then 5 zeros."""
    x = torch.arange(2 * 4 * 6 * CI, dtype=torch.float32).reshape(2, 4, 6, CI)
    col = stem_kernel._im2col(x)
    assert col.shape == (2 * 4 * 6, 32)
    assert torch.equal(col[:, 27:], torch.zeros(48, 5))
    row = col[(1 * 4 + 2) * 6 + 0]          # image 1, y = 2, x = 0
    assert torch.equal(row[0:3], torch.zeros(3))           # (ky 0, kx 0): pad
    assert torch.equal(row[3:6], x[1, 1, 0])               # (ky 0, kx 1)
    assert torch.equal(row[12:15], x[1, 2, 0])             # the centre tap
    assert torch.equal(row[24:27], x[1, 3, 1])             # (ky 2, kx 2)


class _Im2colStem(torch.autograd.Function):
    """The whole op with the backward built from the im2col passes, as
    ``StemPoolFunction`` builds it from the kernels."""

    @staticmethod
    def forward(ctx, x, w, scale, bias):
        pooled, mean, var = stem_pool_reference_torch(x, w, scale, bias, EPS,
                                                      x.dtype)
        inv = torch.rsqrt(var + EPS) * scale
        ctx.save_for_backward(x, w, inv, bias, mean, var)
        ctx.mark_non_differentiable(mean, var)
        return pooled.detach(), mean.detach(), var.detach()

    @staticmethod
    def backward(ctx, gp, _gm, _gv):
        x, w, inv, bias, mean, var = ctx.saved_tensors
        n = x.shape[0] * x.shape[1] * x.shape[2]
        mul = inv.to(x.dtype).float()
        add = (bias - mean * inv).to(x.dtype).float()
        rinv = torch.rsqrt(var + EPS)
        g = gp.to(x.dtype).contiguous()
        sums = stem_kernel.stem_bwd_sums_im2col(x, w, mul, add, mean, rinv, g)
        dw = stem_kernel.stem_bwd_dw_im2col(x, w, mul, add, mean, rinv, inv,
                                            sums[0] / n, sums[1] / n, g)
        return None, dw, sums[1], sums[0]


def test_im2col_f32_gradients_match_podtpu():
    """float32: the op's gradients from the im2col passes against podtpu's
    custom VJP (Pallas, interpret mode), at the tolerance of
    ``test_f32_gradients_match_podtpu``."""
    x, w, scale, bias = _inputs()
    got = _torch_grads(_Im2colStem.apply, x, w, scale, bias, torch.float32)
    want = _jax_grads(make_fused_stem(H, W, CI, CO, "float32", EPS),
                      x, w, scale, bias)
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g, wnt, rtol=1e-4, atol=1e-4)


def test_im2col_bf16_gradient_direction():
    """bf16: the same by direction (cosine >= 0.995), as
    ``test_bf16_gradient_direction`` holds the plain version."""
    x, w, scale, bias = _inputs()
    got = _torch_grads(_Im2colStem.apply, x, w, scale, bias, torch.bfloat16)
    want = _jax_grads(make_fused_stem(H, W, CI, CO, "bfloat16", EPS),
                      x, w, scale, bias)
    for g, wnt in zip(got[3:], want[3:]):
        assert _cosine(g, wnt) >= 0.995


# ---- the forward as the tensor-core kernels compute it --------------------

@pytest.mark.parametrize("cdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 16, 16), (2, 24, 40), (3, 40, 70)])
def test_im2col_forward_equals_plain_versions(cdtype, shape):
    """stats and emit with the conv as one float32 product over the im2col
    matrix, rounded once (the arithmetic of the tensor-core kernels),
    against the plain versions (F.conv2d): float32 within 1e-5 of the
    result's max (another summation order); bf16 stats within 1e-3 and the
    pooled output at the card check's limits, differing on at most 1e-3 of
    the elements by at most 2^-7 of the max (a pre-activation may round to
    the neighbouring bf16 value)."""
    dt = TORCH_DTYPE[cdtype]
    x, wt, _, _, (mul, add, _, _), _ = _bwd_operands(shape, dt)
    s_r = stem_kernel.stem_stats_reference(x, wt)
    s_i = stem_kernel.stem_stats_im2col(x, wt)
    p_r = stem_kernel.stem_emit_reference(x, wt, mul, add)
    p_i = stem_kernel.stem_emit_im2col(x, wt, mul, add)
    assert s_i.shape == (2, CO) and s_i.dtype == torch.float32
    assert p_i.shape == p_r.shape and p_i.dtype == dt
    diff = (p_i.float() - p_r.float()).abs()
    if cdtype == "float32":
        assert _rel(s_i, s_r) <= 1e-5
        assert float(diff.max()) <= 1e-5 * max(1.0, float(p_r.abs().max()))
    else:
        assert _rel(s_i, s_r) <= 1e-3
        assert float((diff > 0).float().mean()) <= 1e-3
        assert float(diff.max()) <= 2.0 ** -7 * float(p_r.float().abs().max())


def _im2col_forward(x, w, scale, bias, dtype):
    """The whole op's forward built from the im2col passes, as
    ``StemPoolFunction.forward`` builds it from the kernels."""
    x = x.to(dtype)
    n = x.shape[0] * x.shape[1] * x.shape[2]
    s = stem_kernel.stem_stats_im2col(x, w)
    mean = s[0] / n
    var = (s[1] / n - mean * mean).clamp_min(0.0)
    inv = torch.rsqrt(var + EPS) * scale
    mul = inv.to(dtype).float()
    add = (bias - mean * inv).to(dtype).float()
    return stem_kernel.stem_emit_im2col(x, w, mul, add), mean, var


@pytest.mark.parametrize("cdtype", ["float32", "bfloat16"])
def test_im2col_forward_matches_podtpu(cdtype):
    """The forward from the im2col passes against podtpu's fused stem
    (Pallas, interpret mode), at the tolerances of
    ``test_plain_forward_matches_podtpu``."""
    x, w, scale, bias = _inputs()
    got = [t.float().numpy() for t in _im2col_forward(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(scale),
        torch.from_numpy(bias), TORCH_DTYPE[cdtype])]
    fused = make_fused_stem(H, W, CI, CO, cdtype, EPS)
    wp, wm, wv = (np.asarray(a, np.float32) for a in fused(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale), jnp.asarray(bias)))
    stat_tol = 1e-5 if cdtype == "float32" else 1e-4
    np.testing.assert_allclose(got[1], wm, atol=stat_tol)
    np.testing.assert_allclose(got[2], wv, atol=stat_tol)
    if cdtype == "float32":
        np.testing.assert_allclose(got[0], wp, atol=1e-5)
    else:
        diff = np.abs(got[0] - wp)
        assert (diff > 0).mean() <= 0.01
        assert diff.max() <= 2.0 ** -7 * np.abs(wp).max()
