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
