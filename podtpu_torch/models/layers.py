"""Core conv building blocks (``podtpu/models/layers.py``).

Tensors are NCHW inside the model (the input is an NHWC batch permuted to
NCHW, which is a ``channels_last`` view, so cuDNN keeps that layout). As in
``podtpu``:

* convolutions are bias-free with symmetric ``(k-1)//2`` padding;
* parameters and BN statistics are float32; the convolution and the BN
  multiply-add run in the compute dtype (bf16 for the flagship config);
* the BN epilogue is one compute-dtype multiply-add whose ``mul``/``add``
  are folded in float32 from the statistics: the running ones in eval
  mode, the batch's in train mode (``module.train()``).

Two train-step options live here. QAT (cfg ``qat``, ``ConvBnAct.qat``):
the train-mode forward fake-quantizes each block's input and kernel
(:func:`fake_quant`). Rematerialization (cfg ``remat_policy``, the
:func:`remat_scope` of the train step): the backward recomputes a block's
BN-apply and activation from its saved conv output and [C] statistics in
place of keeping them; a recompute never moves the running statistics
(:func:`recompute_context`, for ``remat_backbone``'s recomputed stages).
"""

from __future__ import annotations

import threading
import weakref
from contextlib import contextmanager
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

import torch.distributed as dist

from podtpu_torch.ops import int8_conv
from podtpu_torch.parallel import layouts
from podtpu_torch.parallel.mesh import all_reduce_sum, global_rows, stat_group

REMAT_POLICIES = ("conv_out", "no_post_act")

# per thread: the remat registry of the forward in progress, and whether a
# checkpointed stage is being recomputed
_local = threading.local()


def _key(t: torch.Tensor) -> tuple:
    return (t.untyped_storage().data_ptr(), t.storage_offset(),
            tuple(t.shape), tuple(t.stride()), t.dtype)


class _Recipe:
    """How the backward recomputes a tensor the forward did not keep; the
    value is made once and shared by every node that saved it."""

    def __init__(self, fn):
        self.fn, self.value = fn, None

    def __call__(self) -> torch.Tensor:
        if self.value is None:
            with torch.no_grad():
                self.value = self.fn()
        return self.value


class _Registry:
    """Tensors of one forward that the backward recomputes: key -> (a weak
    reference to the tensor, its recipe)."""

    def __init__(self, policy: str):
        self.policy = policy
        self.entries: dict = {}
        self.affine = None  # the last BN's replay of its output
        # while a block's activation runs: (the key of its input, the
        # recipe of its output), for the output it saves as it makes it
        self.pending = None

    def add(self, t: torch.Tensor, fn):
        recipe = fn if isinstance(fn, _Recipe) else _Recipe(fn)
        self.entries[_key(t)] = (weakref.ref(t), recipe)

    def pack(self, t: torch.Tensor):
        key = _key(t)
        hit = self.entries.get(key)
        # a dead reference: the storage may since hold another tensor
        if hit is not None and hit[0]() is not None:
            return hit[1]
        if self.pending is not None and key != self.pending[0]:
            return self.pending[1]
        return t


def _unpack(saved):
    return saved() if isinstance(saved, _Recipe) else saved


@contextmanager
def remat_scope(policy: str | None):
    """Within it, train-mode ``ConvBnAct`` forwards keep for the backward
    only what ``policy`` saves (``podtpu``'s ``remat_policy``):

    * ``conv_out``: the conv output and the [C] batch statistics; the
      float32 copy the statistics are taken from, the BN output and the
      activation are recomputed from them;
    * ``no_post_act``: everything but the activation's output (the
      block's output), which is recomputed.

    The forward runs once, so the running statistics move once; the
    recompute repeats the same operations and gives the same bits.
    ``None`` saves everything (stock autograd)."""
    if policy is None:
        yield
        return
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy '{policy}' "
                         "(expected conv_out | no_post_act)")
    registry = _Registry(policy)
    prev = getattr(_local, "remat", None)
    _local.remat = registry
    try:
        with torch.autograd.graph.saved_tensors_hooks(registry.pack,
                                                      _unpack):
            yield
    finally:
        _local.remat = prev
        # every saved tensor keeps the hooks, and so the registry, until
        # its node runs: drop the registry's own references, so that a
        # recomputed tensor lives only until the nodes that read it ran
        registry.entries.clear()
        registry.affine = registry.pending = None


@contextmanager
def recompute_context():
    """The context of a checkpointed stage's recompute: BN layers use the
    batch statistics as before and leave the running ones alone."""
    prev = getattr(_local, "recomputing", False)
    _local.recomputing = True
    try:
        yield
    finally:
        _local.recomputing = prev


def fake_quant(x: torch.Tensor, dims: tuple[int, ...] | None = None,
               group=None) -> torch.Tensor:
    """Symmetric int8 fake quantization with a straight-through estimator
    (``podtpu``'s ``_fake_quant``): the scale is the abs-max over the whole
    tensor (``dims=None``, activations; over ``group``'s ranks too, which
    hold its other rows under the spatial layout) or over ``dims`` (per
    output channel of an OIHW kernel: ``(1, 2, 3)``) / 127, detached; the
    math runs in float32 and returns ``x + detach(q(x) - x)`` in x's
    dtype."""
    x32 = x.float()
    a = x32.abs()
    absmax = a.amax() if dims is None else a.amax(dim=dims, keepdim=True)
    if group is not None:
        absmax = absmax.detach().clone()
        dist.all_reduce(absmax, op=dist.ReduceOp.MAX, group=group)
    # a 0-dim divisor: true division on the card as on the CPU
    scale = (torch.where(absmax > 0, absmax, 1.0)
             / absmax.new_full((), 127.0)).detach()
    q = torch.clamp(torch.round(x32 / scale), -127, 127) * scale
    return (x32 + (q - x32).detach()).to(x.dtype)


class BatchNormMixed(nn.Module):
    """BatchNorm with float32 statistics, compute-dtype apply.

    ``weight``/``bias``/``running_mean``/``running_var`` carry ``podtpu``'s
    ``bn/scale``, ``bn/bias``, ``batch_stats/mean`` and ``batch_stats/var``.

    In train mode the statistics are the batch's, taken in float32 from the
    compute-dtype input: ``mean`` and ``var = max(0, E[x^2] - mean^2)``,
    differentiated through as flax does; the running statistics then move
    with decay ``momentum`` and the unbiased (Bessel) variance, as torch
    and ``podtpu`` update them. ``F.batch_norm`` is not used: it rounds
    at other places. Under data parallelism (more than one rank) the
    statistics are the global batch's, as under ``podtpu``'s mesh: the
    per-channel sums are all-reduced over ``data x space``
    (``parallel/mesh.py::stat_group``), and the running update takes the
    global count for Bessel's correction (each value counted once: a
    whole map under the spatial layout is in every space peer's sums, and
    its mean and variance are the same as counted once).

    Under the tensor layout (``tp = (M, m)``, set with its block's) the
    input holds channel slice ``m`` of ``M``: the statistics are the
    slice's, the affine takes that slice of the whole ``weight`` / ``bias``
    and of the running statistics, and the running update takes the
    statistics of every slice (gathered over ``model``), so the buffers
    stay whole on every rank.
    """

    tp = None

    momentum = 0.9  # running-stat decay (torch's momentum 0.1)

    def __init__(self, features: int, dtype: torch.dtype = torch.float32,
                 eps: float = 1e-5):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        # fn(mean, unbiased var) taking a train-mode batch's statistics in
        # place of the running update (``train/steps.py::make_stats_step``)
        self.stats_sink = None

    @torch.no_grad()
    def update_running_stats(self, mean: torch.Tensor, var: torch.Tensor,
                             n: int):
        """Fold one batch's statistics (over ``n`` values per channel) into
        the running ones, or hand them to ``stats_sink`` when one is set
        (the buffers are then left alone)."""
        if getattr(_local, "recomputing", False):
            return
        if self.tp is not None:
            mean, var = (layouts.gather_vector(t) for t in (mean, var))
        bessel = n / max(n - 1, 1)
        if self.stats_sink is not None:
            self.stats_sink(mean, bessel * var)
            return
        m = self.momentum
        self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
        self.running_var.copy_(m * self.running_var
                               + (1.0 - m) * bessel * var)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        remat = getattr(_local, "remat", None) if self.training else None
        if self.training:
            x32 = x.float()
            if remat is not None and remat.policy == "conv_out" \
                    and x32 is not x:
                remat.add(x32, x.float)
            n = x.numel() // x.shape[1]
            group, ranks = stat_group()
            if ranks > 1:
                # the global batch's statistics: sum x and sum x^2 over
                # every rank's rows (equal local batches), differentiated
                # through the all-reduce
                c = x.shape[1]
                s = all_reduce_sum(torch.cat([x32.sum(dim=(0, 2, 3)),
                                              (x32 * x32).sum(dim=(0, 2, 3))]),
                                   group)
                n *= ranks
                mean = s[:c] / n
                var = (s[c:] / n - mean * mean).clamp_min(0.0)
            else:
                mean = x32.mean(dim=(0, 2, 3))
                var = ((x32 * x32).mean(dim=(0, 2, 3)) - mean * mean
                       ).clamp_min(0.0)
            # Bessel's count: a whole map under the spatial layout came in
            # once from each space peer
            self.update_running_stats(mean, var, n // layouts.copies(x))
        else:
            mean, var = self.running_mean, self.running_var
        weight, bias = self.weight, self.bias
        if self.tp is not None:
            sl = layouts.channel_slice(self.tp, weight.shape[0])
            weight, bias = weight[sl], bias[sl]
            if not self.training:
                mean, var = mean[sl], var[sl]
        inv = torch.rsqrt(var + self.eps) * weight
        # y = (x - mean) * inv + bias, folded into one multiply-add
        mul = inv.to(self.dtype)[:, None, None]
        add = (bias - mean * inv).to(self.dtype)[:, None, None]
        z = x.to(self.dtype) * mul + add
        if remat is not None:
            # what the enclosing block's recipes replay: c * mul + add
            c, m, a = x, mul.detach(), add.detach()
            remat.affine = lambda: c.to(self.dtype) * m + a
            if remat.policy == "conv_out":
                remat.add(z, remat.affine)
        return z


class ConvBnAct(nn.Module):
    """Conv2d(pad=(k-1)//2 on both sides, bias=False) + BatchNorm + ``act``
    (ReLU by default; ``None`` is linear).

    ``podtpu`` pads symmetrically, so a stride-2 conv is torch's
    ``padding=p, stride=2`` and not a ``'same'`` one. As in ``podtpu``, the
    activation takes the BN output in the compute dtype and its result is
    cast to it.

    ``qat`` (cfg ``qat``, set by the factory): the train-mode forward
    fake-quantizes the input per tensor and the kernel per output channel
    (:func:`fake_quant`) before the conv; eval mode is untouched.

    The layouts (``parallel/layouts.py``): a row block takes its window's
    halo from its space peers; under the tensor layout (``tp = (M, m)``)
    the block holds its output-channel slice of the kernel, computes that
    slice from the whole input and returns the whole output, gathered over
    ``model``.

    Serving-time int8 (``export/quantize.py``): a block given quant state
    (:meth:`set_quant`: ``w_int8`` OIHW int8, ``w_scale`` [O] and
    ``x_scale`` [] float32, registered as buffers only then, so a float
    model's ``state_dict`` is unchanged) quantizes its input,
    ``clip(round(x / x_scale), -127, 127)`` (half to even), convolves int8
    x int8 into int32 (``ops/int8_conv.py``), and dequantizes by
    ``x_scale * w_scale`` into the compute dtype before the BN and the
    activation."""

    QUANT_BUFFERS = ("w_int8", "w_scale", "x_scale")
    tp = None

    def __init__(self, in_ch: int, features: int, kernel_size: int = 3,
                 dtype: torch.dtype = torch.float32, strides: int = 1,
                 act: Callable | None = torch.relu):
        super().__init__()
        self.dtype = dtype
        self.act = act
        self.qat = False
        self.conv = nn.Conv2d(in_ch, features, kernel_size, stride=strides,
                              padding=(kernel_size - 1) // 2, bias=False)
        self.bn = BatchNormMixed(features, dtype=dtype)

    @property
    def quantized(self) -> bool:
        return "w_int8" in self._buffers

    def set_quant(self, w_int8: torch.Tensor, w_scale: torch.Tensor,
                  x_scale: torch.Tensor):
        """Install the int8 serving state on the block's device."""
        dev = self.conv.weight.device
        if tuple(w_int8.shape) != tuple(self.conv.weight.shape):
            raise ValueError(f"w_int8 {tuple(w_int8.shape)} does not fit "
                             f"the kernel {tuple(self.conv.weight.shape)}")
        self.register_buffer("w_int8", w_int8.to(dev, torch.int8))
        self.register_buffer("w_scale", w_scale.to(dev, torch.float32))
        self.register_buffer("x_scale", x_scale.to(dev, torch.float32))

    def clear_quant(self):
        for name in self.QUANT_BUFFERS:
            self._buffers.pop(name, None)

    def quantize_input(self, x: torch.Tensor) -> torch.Tensor:
        """``clip(round(x / x_scale), -127, 127)`` as int8 (the division by
        the 0-dim ``x_scale`` is a true division on the card too)."""
        return torch.clamp(torch.round(x.float() / self.x_scale), -127,
                           127).to(torch.int8)

    def _int8_conv(self, x: torch.Tensor) -> torch.Tensor:
        acc = int8_conv.int8_conv2d(self.quantize_input(x), self.w_int8,
                                    self.conv.stride[0],
                                    self.conv.padding[0])
        scale = (self.x_scale * self.w_scale)[:, None, None]
        return (acc.float() * scale).to(self.dtype)

    def _post(self, z: torch.Tensor) -> torch.Tensor:
        if self.act is not None:
            z = self.act(z)
        return z.to(self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            x = layouts.enter_model(x)
        if self.quantized:
            x = self._int8_conv(x)
        else:
            w = self.conv.weight
            if self.qat and self.training:
                x = fake_quant(x, group=layouts.quant_group(x))
                w = fake_quant(w, dims=(1, 2, 3))
            x = layouts.conv2d(x.to(self.dtype), w.to(self.dtype),
                               stride=self.conv.stride,
                               padding=self.conv.padding)
        y = self._bn_act(x)
        return y if self.tp is None else layouts.gather_channels(y)

    def _bn_act(self, x: torch.Tensor) -> torch.Tensor:
        z = self.bn(x)
        remat = getattr(_local, "remat", None) if self.training else None
        if remat is None:
            return self._post(z)
        # the activation saves its output (ReLU) as it makes it, before
        # the output can be registered: the registry knows it as pending
        affine = remat.affine
        recipe = _Recipe(lambda: self._post(affine()))
        remat.pending = (_key(z), recipe)
        try:
            y = self._post(z)
        finally:
            remat.pending = None
        remat.add(y, recipe)
        return y


def mish(x: torch.Tensor) -> torch.Tensor:
    """x * tanh(softplus(x)), CSPDarknet53's activation (``jax.nn.mish``)."""
    return F.mish(x)


def leaky01(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU(0.1), yolov4.cfg's neck and head activation."""
    return F.leaky_relu(x, negative_slope=0.1)


class V4TinyBlock(nn.Module):
    """CSP-tiny partial block: 3x3 -> 3x3 -> concat [second, first] ->
    1x1 to twice the width."""

    def __init__(self, in_ch: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = ConvBnAct(in_ch, features, 3, dtype=dtype)
        self.conv2 = ConvBnAct(features, features, 3, dtype=dtype)
        self.conv3 = ConvBnAct(2 * features, 2 * features, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(x)
        return self.conv3(cat_channels([self.conv2(y), y]))


class HeadConv(nn.Module):
    """The raw 1x1 prediction conv (bias-free); output is float32, whole
    (its rows gathered under the spatial layout, its channels under the
    tensor layout)."""

    tp = None

    def __init__(self, in_ch: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(in_ch, features, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            x = layouts.enter_model(x)
        y = F.conv2d(x.to(self.dtype), self.conv.weight.to(self.dtype)).float()
        if self.tp is not None:
            y = layouts.gather_channels(y)
        return layouts.whole_rows(y)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 VALID max pool (floor division), NCHW."""
    return layouts.max_pool2d(x, 2, 2)


def cat_channels(ts) -> torch.Tensor:
    """``torch.cat(ts, dim=1)``; under the spatial layout a row block meets
    a whole map gathered whole."""
    return torch.cat(layouts.match_rows(*ts), dim=1)


def add_maps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a + b`` of two maps, in one row layout (as :func:`cat_channels`)."""
    a, b = layouts.match_rows(a, b)
    return a + b


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """2x nearest-neighbour upsample, NCHW."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def passthrough_reorg(x: torch.Tensor) -> torch.Tensor:
    """YOLOv2's raw ``.view(b, 4c, h/2, w/2)`` passthrough (NCHW in and out).

    Not a space-to-depth: the reference reinterprets the contiguous NCHW
    buffer. The port's activations are NCHW tensors with channels_last
    strides, on which ``.view`` raises or reads another order, so this
    reshapes the logical NCHW shape (a copy, which is the semantics) and
    returns it with channels_last strides again for the next conv. It
    mixes rows and channels, so it takes whole rows."""
    x = layouts.whole_rows(x)
    b, c, h, w = x.shape
    x = x.reshape(b, c * 4, h // 2, w // 2)
    return x.contiguous(memory_format=torch.channels_last)


class SeededDropout(nn.Module):
    """Inverted dropout (flax ``nn.Dropout``: kept values scaled by
    ``1 / (1 - rate)``) active in train mode only, its mask drawn from a
    ``torch.Generator`` of its own on the input's device.

    :meth:`reseed` seeds it; the train step calls it with the config's seed
    and the step number, as ``podtpu`` folds the step into its dropout key,
    so a resumed run draws the masks it would have drawn. Rate 0 returns
    the input, as flax does."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.seed = 0
        self._gens: dict = {}  # device -> torch.Generator

    def reseed(self, seed: int):
        self.seed = int(seed)
        for g in self._gens.values():
            g.manual_seed(self.seed)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        gen = self._gens.get(x.device)
        if gen is None:
            gen = self._gens[x.device] = torch.Generator(device=x.device)
            gen.manual_seed(self.seed)
        # under data parallelism the global batch's mask, of which this
        # rank keeps its rows: the masks of a one-process run
        b, rows = global_rows(x.shape[0])
        keep = torch.empty((b,) + tuple(x.shape[1:]),
                           device=x.device).bernoulli_(
            1.0 - self.rate, generator=gen).bool()
        if rows is not None:
            keep = keep[rows]
        return torch.where(keep, x / (1.0 - self.rate), 0.0)
