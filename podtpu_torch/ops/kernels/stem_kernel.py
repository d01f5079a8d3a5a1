"""Fused Darknet stem: the CUDA kernels' wrappers and their plain versions.

conv3x3 (3 -> 32, stride 1, pad 1) + train-mode BatchNorm + ReLU + 2x2/2
max pool, with a hand-written backward. Replaces the Pallas TPU kernels of
``podtpu/ops/pallas/stem_fused.py`` (``make_fused_stem``). The kernels are
``csrc/stem_fused.cu``; its source says what bounds them and how the design
answers that.

Layouts are ``podtpu``'s: x is NHWC ``[B, H, W, 3]`` in the compute dtype
(bf16 or float32, the dtype of x), w is HWIO ``[3, 3, 3, 32]`` float32,
pooled and its cotangent are NHWC ``[B, H/2, W/2, 32]``.

With ``halo=True`` (a block of the image's rows under the spatial layout,
``parallel/layouts.py``) x is ``[B, H + 2, W, 3]``: one row of the block
above on top and one of the block below at the bottom, zeros where the
block is at the image's edge. Every pass then computes the conv for the
H interior rows only, reading its top and bottom taps from those rows in
place of the zero padding; the pooled output and its cotangent are
``[B, H/2, W/2, 32]`` as before, and dW sums over the interior rows.

* :func:`stem_fused` — the entry point of the train step. A CUDA tensor goes
  to :class:`StemPoolFunction` (two kernels forward, two backward); a CPU
  tensor goes to :func:`stem_pool_reference_torch`. Its launches are counted
  per kernel in ``stem_fused.launches``.
* :func:`stem_stats`, :func:`stem_emit`, :func:`stem_bwd_sums`,
  :func:`stem_bwd_dw` — one wrapper per kernel: a CUDA tensor launches the
  kernel (or the call raises), a CPU tensor runs its plain version
  (``*_reference``).
  In bf16 all four launch the tensor-core kernels, which share one conv
  core, so the backward recomputes the forward's pre-activations bit for
  bit; in float32 the kernels that run the conv on the float32 pipes.
* :func:`stem_stats_im2col`, :func:`stem_emit_im2col`,
  :func:`stem_bwd_sums_im2col`, :func:`stem_bwd_dw_im2col` — the four
  passes written as the tensor-core kernels compute them (an im2col matrix
  with zero-padded tap columns, one float32 product rounded once; dW as a
  second product); the tests hold them against the plain versions.
* :func:`stem_pool_reference_torch` — the plain PyTorch version of the
  whole op (compute-dtype conv, float32 batch statistics, folded affine,
  ReLU, ``max_pool2d``; autograd's backward). It mirrors ``podtpu``'s
  ``stem_pool_reference`` except that the variance is clamped at 0, as
  ``BatchNormMixed`` clamps it (the Pallas forward does not clamp; the two
  agree whenever the variance is positive). The CPU path and the tests use
  it, and the card's path never does.
"""

from __future__ import annotations

import ctypes

import torch
import torch.distributed as dist
import torch.nn.functional as F

from podtpu_torch.parallel.mesh import stat_group

CI, CO = 3, 32
# rows of the kernels' partial-sum scratch: an upper bound on their grid
# (one wave of resident blocks)
MAX_BLOCKS = 2048
_DTYPES = (torch.float32, torch.bfloat16)

_FNS: dict = {}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "stats": [_P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P],
    "emit": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "bwd_sums": [_P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P],
    "bwd_dw": [_P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P],
}


def _kernel(name: str):
    fn = _FNS.get(name)
    if fn is None:
        from podtpu_torch.ops.kernels.build import load

        fn = getattr(load("stem_fused"), f"podtpu_stem_{name}")
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[name]
        _FNS[name] = fn
    return fn


# ---- checks ---------------------------------------------------------------

def _check_x(x: torch.Tensor, halo: bool = False):
    if x.dim() != 4 or x.shape[-1] != CI:
        raise ValueError(f"x must be NHWC [B, H, W, {CI}], got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    h = x.shape[1] - 2 * int(halo)
    if h <= 0 or h % 2 or x.shape[2] % 2:
        raise ValueError(f"H and W must be even, got {(h, x.shape[2])}"
                         + (" inside the halo" if halo else ""))


def _check_w(w: torch.Tensor):
    if tuple(w.shape) != (3, 3, CI, CO):
        raise ValueError(f"w must be HWIO [3, 3, {CI}, {CO}], got "
                         f"{tuple(w.shape)}")


def _check_vec(**vecs):
    for name, v in vecs.items():
        if tuple(v.shape) != (CO,) or v.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 [{CO}], got "
                             f"{v.dtype} {tuple(v.shape)}")


def _check_g(g: torch.Tensor, x: torch.Tensor, halo: bool = False):
    b, h, w, _ = x.shape
    h -= 2 * int(halo)
    if tuple(g.shape) != (b, h // 2, w // 2, CO) or g.dtype != x.dtype:
        raise ValueError(f"g must be {x.dtype} [{b}, {h // 2}, {w // 2}, {CO}]"
                         f", got {g.dtype} {tuple(g.shape)}")


def _check_cuda(name: str, *tensors: torch.Tensor):
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors, got {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


# ---- plain versions -------------------------------------------------------

def _pad(halo: bool):
    """The conv's (rows, columns) of zero padding: none on the rows of a
    block that brings its halo."""
    return (0, 1) if halo else 1


def _conv(x: torch.Tensor, w: torch.Tensor, halo: bool = False
          ) -> torch.Tensor:
    """The compute-dtype conv: NHWC x, HWIO w -> NCHW (channels_last) pre
    (of the interior rows with ``halo``)."""
    return F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1),
                    padding=_pad(halo))


def _affine(pre, mul, add):
    """y = pre * mul + add, each operation rounded to the compute dtype."""
    t = pre.dtype
    return pre * mul.to(t)[:, None, None] + add.to(t)[:, None, None]


def _routed(y: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """float32 dL/dy [B, C, H, W]: the NHWC pooled cotangent g goes to the
    first window position, (0,0),(0,1),(1,0),(1,1), holding the max of
    relu(y), where y > 0."""
    b, c, h, w = y.shape
    y6 = y.float().reshape(b, c, h // 2, 2, w // 2, 2)
    z6 = y6.clamp_min(0.0)
    m = z6.amax(dim=(3, 5))
    g4 = g.float().permute(0, 3, 1, 2)
    d6 = torch.zeros_like(y6)
    taken = torch.zeros_like(m, dtype=torch.bool)
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        hit = (z6[:, :, :, dy, :, dx] == m) & ~taken
        d6[:, :, :, dy, :, dx] = torch.where(hit & (y6[:, :, :, dy, :, dx] > 0),
                                             g4, 0.0)
        taken |= hit
    return d6.reshape(b, c, h, w)


def _xhat(pre, mean, rinv):
    return (pre.float() - mean[:, None, None]) * rinv[:, None, None]


def stem_stats_reference(x: torch.Tensor, w: torch.Tensor,
                         halo: bool = False) -> torch.Tensor:
    """[2, 32] float32: (sum pre, sum pre^2) per channel."""
    p = _conv(x, w, halo).float()
    return torch.stack([p.sum(dim=(0, 2, 3)), (p * p).sum(dim=(0, 2, 3))])


def stem_emit_reference(x, w, mul, add, halo: bool = False) -> torch.Tensor:
    """NHWC pooled ``maxpool(relu(pre * mul + add))`` in the compute dtype."""
    z = torch.relu(_affine(_conv(x, w, halo), mul, add))
    return F.max_pool2d(z, 2, 2).permute(0, 2, 3, 1)


def stem_bwd_sums_reference(x, w, mul, add, mean, rinv, g,
                            halo: bool = False) -> torch.Tensor:
    """[2, 32] float32: (sum d, sum d * xhat) per channel."""
    pre = _conv(x, w, halo)
    d = _routed(_affine(pre, mul, add), g)
    return torch.stack([d.sum(dim=(0, 2, 3)),
                        (d * _xhat(pre, mean, rinv)).sum(dim=(0, 2, 3))])


def stem_bwd_dw_reference(x, w, mul, add, mean, rinv, inv, c0, c1, g,
                          halo: bool = False) -> torch.Tensor:
    """HWIO [3, 3, 3, 32] float32: sum over pixels of x-patch (x) d_pre,
    d_pre = inv * (d - c0 - xhat * c1) rounded to the compute dtype."""
    pre = _conv(x, w, halo)
    d = _routed(_affine(pre, mul, add), g)
    v = lambda t: t[:, None, None]  # noqa: E731
    dpre = (v(inv) * (d - v(c0) - _xhat(pre, mean, rinv) * v(c1))).to(x.dtype)
    dw = torch.nn.grad.conv2d_weight(x.permute(0, 3, 1, 2).float(),
                                     (CO, CI, 3, 3), dpre.float(),
                                     padding=_pad(halo))
    return dw.permute(2, 3, 1, 0).contiguous()


def _im2col(x: torch.Tensor, halo: bool = False) -> torch.Tensor:
    """[B * H * W, 32]: the 3x3 patch of every (interior) pixel with zero
    padding, taps in (ky, kx, ci) order, and 5 zero columns after the 27
    taps."""
    b, h, w, _ = x.shape
    h -= 2 * int(halo)
    xp = F.pad(x, (0, 0, 1, 1, 0 if halo else 1, 0 if halo else 1))
    cols = [xp[:, ky:ky + h, kx:kx + w, :] for ky in range(3)
            for kx in range(3)]
    cols.append(x.new_zeros((b, h, w, 32 - 9 * CI)))
    return torch.cat(cols, dim=-1).reshape(b * h * w, 32)


def _im2col_pre(x, w, halo: bool = False):
    """(im2col, pre NCHW): the conv as one float32 product of the im2col
    matrix with the [32, 32] weights (5 zero rows), rounded once."""
    b, h, wd, _ = x.shape
    h -= 2 * int(halo)
    col = _im2col(x, halo)
    w32 = torch.cat([w.to(x.dtype).reshape(9 * CI, CO),
                     w.new_zeros((32 - 9 * CI, CO), dtype=x.dtype)])
    pre = (col.float() @ w32.float()).to(x.dtype)
    return col, pre.reshape(b, h, wd, CO).permute(0, 3, 1, 2)


def stem_stats_im2col(x: torch.Tensor, w: torch.Tensor,
                      halo: bool = False) -> torch.Tensor:
    """:func:`stem_stats_reference` with the conv as an im2col product."""
    p = _im2col_pre(x, w, halo)[1].float()
    return torch.stack([p.sum(dim=(0, 2, 3)), (p * p).sum(dim=(0, 2, 3))])


def stem_emit_im2col(x, w, mul, add, halo: bool = False) -> torch.Tensor:
    """:func:`stem_emit_reference` with the conv as an im2col product."""
    z = torch.relu(_affine(_im2col_pre(x, w, halo)[1], mul, add))
    return F.max_pool2d(z, 2, 2).permute(0, 2, 3, 1)


def stem_bwd_sums_im2col(x, w, mul, add, mean, rinv, g,
                         halo: bool = False) -> torch.Tensor:
    """:func:`stem_bwd_sums_reference` with the conv as an im2col product."""
    _, pre = _im2col_pre(x, w, halo)
    d = _routed(_affine(pre, mul, add), g)
    return torch.stack([d.sum(dim=(0, 2, 3)),
                        (d * _xhat(pre, mean, rinv)).sum(dim=(0, 2, 3))])


def stem_bwd_dw_im2col(x, w, mul, add, mean, rinv, inv, c0, c1, g,
                       halo: bool = False) -> torch.Tensor:
    """:func:`stem_bwd_dw_reference` as two products: the conv, and
    dW = im2col^T @ d_pre in float32 with the zero tap columns dropped."""
    col, pre = _im2col_pre(x, w, halo)
    d = _routed(_affine(pre, mul, add), g)
    v = lambda t: t[:, None, None]  # noqa: E731
    dpre = (v(inv) * (d - v(c0) - _xhat(pre, mean, rinv) * v(c1))).to(x.dtype)
    dw = col.float().T @ dpre.permute(0, 2, 3, 1).reshape(-1, CO).float()
    return dw[:9 * CI].reshape(3, 3, CI, CO).contiguous()


def stem_pool_reference_torch(x, w, scale, bias, eps: float,
                              dtype: torch.dtype, halo: bool = False):
    """Plain ConvBnAct(32, 3) + max_pool_2x2 in train mode.

    x NHWC (any float dtype), w HWIO float32 -> (pooled NHWC in ``dtype``,
    batch mean, batch variance), of the interior rows with ``halo`` (the
    statistics then this block's alone). Differentiable by autograd."""
    pre = _conv(x.to(dtype), w, halo)
    p32 = pre.float()
    mean = p32.mean(dim=(0, 2, 3))
    var = ((p32 * p32).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
    inv = torch.rsqrt(var + eps) * scale
    z = torch.relu(_affine(pre, inv, bias - mean * inv))
    return F.max_pool2d(z, 2, 2).permute(0, 2, 3, 1), mean, var


# ---- kernel launches ------------------------------------------------------

def _wk(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The kernels' weight operand: compute-dtype values as float32 [27, 32]."""
    return w.detach().to(dtype).float().contiguous()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"stem_fused {name} launch failed: cudaError {err}")


def _check_aligned(name: str, *tensors: torch.Tensor):
    """The kernels move x, g and the pooled output in 16-byte pieces."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"stem_fused {name}: x, g and the pooled output "
                         f"must be 16-byte aligned")


def _launch_stats(x, w, halo: bool) -> torch.Tensor:
    b, h, wd, _ = x.shape
    h -= 2 * int(halo)
    _check_aligned("stats", x)
    partials = torch.empty((MAX_BLOCKS, 2 * CO), dtype=torch.float32,
                           device=x.device)
    out = torch.empty((2, CO), dtype=torch.float32, device=x.device)
    wk = _wk(w, x.dtype)
    with torch.cuda.device(x.device):
        err = _kernel("stats")(x.data_ptr(), wk.data_ptr(),
                               partials.data_ptr(), MAX_BLOCKS, out.data_ptr(),
                               b, h, wd, int(x.dtype == torch.bfloat16),
                               int(halo), _stream(x))
    _raise_on(err, "stats")
    stem_fused.launches["stats"] += 1
    return out


def _launch_emit(x, w, mul, add, halo: bool) -> torch.Tensor:
    b, h, wd, _ = x.shape
    h -= 2 * int(halo)
    out = torch.empty((b, h // 2, wd // 2, CO), dtype=x.dtype, device=x.device)
    _check_aligned("emit", x, out)
    wk = _wk(w, x.dtype)
    vec = torch.stack([mul, add]).contiguous()
    with torch.cuda.device(x.device):
        err = _kernel("emit")(x.data_ptr(), wk.data_ptr(), vec.data_ptr(),
                              out.data_ptr(), b, h, wd,
                              int(x.dtype == torch.bfloat16), int(halo),
                              _stream(x))
    _raise_on(err, "emit")
    stem_fused.launches["emit"] += 1
    return out


def _launch_bwd(name, x, w, vec, g, cols, halo: bool) -> torch.Tensor:
    b, h, wd, _ = x.shape
    h -= 2 * int(halo)
    _check_aligned(name, x, g)
    partials = torch.empty((MAX_BLOCKS, cols), dtype=torch.float32,
                           device=x.device)
    out = torch.empty((cols,), dtype=torch.float32, device=x.device)
    wk = _wk(w, x.dtype)
    with torch.cuda.device(x.device):
        err = _kernel(name)(x.data_ptr(), wk.data_ptr(), vec.data_ptr(),
                            g.data_ptr(), partials.data_ptr(), MAX_BLOCKS,
                            out.data_ptr(), b, h, wd,
                            int(x.dtype == torch.bfloat16), int(halo),
                            _stream(x))
    _raise_on(err, name)
    stem_fused.launches[name] += 1
    return out


def _vec7(mul, add, mean, rinv, inv=None, c0=None, c1=None):
    """The kernels' [7, 32] vector operand (rows mul, add, mean, rinv, inv,
    c0, c1; zeros where a kernel reads none)."""
    zero = torch.zeros_like(mean)
    return torch.stack([mul, add, mean, rinv,
                        zero if inv is None else inv,
                        zero if c0 is None else c0,
                        zero if c1 is None else c1]).contiguous()


# ---- the four kernel wrappers ---------------------------------------------

def stem_stats(x: torch.Tensor, w: torch.Tensor,
               halo: bool = False) -> torch.Tensor:
    """(sum pre, sum pre^2) per channel, [2, 32] float32."""
    _check_x(x, halo)
    _check_w(w)
    if x.device.type == "cpu":
        return stem_stats_reference(x, w, halo)
    _check_cuda("stem_stats", x, w)
    return _launch_stats(x, w, halo)


def stem_emit(x, w, mul, add, halo: bool = False) -> torch.Tensor:
    """NHWC pooled output in x's dtype; mul, add float32 [32] holding
    compute-dtype values."""
    _check_x(x, halo)
    _check_w(w)
    _check_vec(mul=mul, add=add)
    if x.device.type == "cpu":
        return stem_emit_reference(x, w, mul, add, halo)
    _check_cuda("stem_emit", x, w, mul, add)
    return _launch_emit(x, w, mul, add, halo)


def stem_bwd_sums(x, w, mul, add, mean, rinv, g, halo: bool = False
                  ) -> torch.Tensor:
    """(sum d, sum d * xhat) per channel, [2, 32] float32."""
    _check_x(x, halo)
    _check_w(w)
    _check_vec(mul=mul, add=add, mean=mean, rinv=rinv)
    _check_g(g, x, halo)
    if x.device.type == "cpu":
        return stem_bwd_sums_reference(x, w, mul, add, mean, rinv, g, halo)
    _check_cuda("stem_bwd_sums", x, w, mul, add, mean, rinv, g)
    vec = _vec7(mul, add, mean, rinv)
    return _launch_bwd("bwd_sums", x, w, vec, g, 2 * CO, halo).view(2, CO)


def stem_bwd_dw(x, w, mul, add, mean, rinv, inv, c0, c1, g,
                halo: bool = False) -> torch.Tensor:
    """dW, HWIO [3, 3, 3, 32] float32 (over the interior rows with
    ``halo``)."""
    _check_x(x, halo)
    _check_w(w)
    _check_vec(mul=mul, add=add, mean=mean, rinv=rinv, inv=inv, c0=c0, c1=c1)
    _check_g(g, x, halo)
    if x.device.type == "cpu":
        return stem_bwd_dw_reference(x, w, mul, add, mean, rinv, inv, c0, c1,
                                     g, halo)
    _check_cuda("stem_bwd_dw", x, w, mul, add, mean, rinv, inv, c0, c1, g)
    vec = _vec7(mul, add, mean, rinv, inv, c0, c1)
    return _launch_bwd("bwd_dw", x, w, vec, g, 9 * CI * CO,
                       halo).view(3, 3, CI, CO)


# ---- the op ---------------------------------------------------------------

class StemPoolFunction(torch.autograd.Function):
    """(x, w, scale, bias) -> (pooled, mean, var) through the four wrappers.

    Forward: stats, then emit with ``mul = rsqrt(var + eps) * scale`` and
    ``add = bias - mean * mul`` rounded to the compute dtype. Backward:
    sums give ``dbias = sum d`` and ``dscale = sum d * xhat``; dW from
    ``d_pre = inv * (d - sum d / n - xhat * sum(d * xhat) / n)``. x gets no
    gradient (the stem is the first layer), and mean and var are outputs
    for the running statistics only.

    Under data parallelism and the spatial layout (``parallel/mesh.py``)
    the stats kernel's sums are all-reduced over ``data x space``
    (``stat_group``) before ``mean`` / ``var``, with ``n`` the global count
    of pixels, and a copy of the backward sums before ``c0`` / ``c1``. The
    gradients returned are this rank's shares: with ``halo`` (a block of
    rows with its neighbours' edge rows) dW, dscale and dbias sum over
    the block's interior rows, and the train step's average over ``data x
    space`` adds the space ranks' shares up."""

    @staticmethod
    def forward(ctx, x, w, scale, bias, eps, halo=False):
        b, h, wd, _ = x.shape
        group, ranks = stat_group()
        n = b * (h - 2 * int(halo)) * wd * ranks
        s = stem_stats(x, w, halo)
        if ranks > 1:
            # the global batch's sums (every rank's pixels, equal blocks)
            dist.all_reduce(s, group=group)
        mean = s[0] / n
        var = (s[1] / n - mean * mean).clamp_min(0.0)
        inv = torch.rsqrt(var + eps) * scale
        mul = inv.to(x.dtype).float()
        add = (bias - mean * inv).to(x.dtype).float()
        pooled = stem_emit(x, w, mul, add, halo)
        ctx.mark_non_differentiable(mean, var)
        ctx.save_for_backward(x, w, mul, add, mean, var, inv)
        ctx.eps, ctx.n, ctx.halo, ctx.group = eps, n, halo, group
        return pooled, mean, var

    @staticmethod
    def backward(ctx, gp, _gmean, _gvar):
        x, w, mul, add, mean, var, inv = ctx.saved_tensors
        g = gp.to(x.dtype).contiguous()
        rinv = torch.rsqrt(var + ctx.eps)
        sums = stem_bwd_sums(x, w, mul, add, mean, rinv, g, ctx.halo)
        # this rank's sums are its share of dbias and dscale (the gradient
        # reduction adds the shares); d_pre takes the global sums
        dbias, dscale = sums[0], sums[1]
        total = sums
        if stat_group()[1] > 1:
            total = sums.clone()
            dist.all_reduce(total, group=ctx.group)
        dw = stem_bwd_dw(x, w, mul, add, mean, rinv, inv, total[0] / ctx.n,
                         total[1] / ctx.n, g, ctx.halo)
        return None, dw, dscale, dbias, None, None


def stem_fused(x, w, scale, bias, eps: float, dtype: torch.dtype,
               halo: bool = False):
    """conv3x3 + train-mode BN + ReLU + 2x2 max pool.

    x NHWC ``[B, H, W, 3]`` (cast to ``dtype``; ``[B, H + 2, W, 3]`` with
    ``halo``), w HWIO float32, scale and bias float32 [32] -> (pooled NHWC
    ``[B, H/2, W/2, 32]`` in ``dtype``, batch mean, batch variance). CUDA:
    the kernels; CPU: the plain version of the whole op, or under a group
    of statistics (data parallelism, the spatial layout) the plain
    versions of the four passes through :class:`StemPoolFunction`, with
    its all-reduces.
    """
    if x.device.type == "cpu" and stat_group()[1] == 1:
        return stem_pool_reference_torch(x, w, scale, bias, eps, dtype, halo)
    return StemPoolFunction.apply(x.to(dtype), w.contiguous(), scale, bias,
                                  eps, halo)


stem_fused.launches = {"stats": 0, "emit": 0, "bwd_sums": 0, "bwd_dw": 0}
