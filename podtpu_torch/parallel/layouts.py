"""The tensor-parallel and spatial layouts (``podtpu``'s ``make_mesh(spatial=,
tensor=)`` and ``state_shardings(tensor=True)``), as explicit collectives.

GSPMD partitions ``podtpu``'s program from the shardings alone. The port
says where each collective goes, on the mesh of ``parallel/mesh.py``:

Tensor layout (cfg ``parallel_options.tensor``, the ``model`` axis).
  :func:`model_split` is ``podtpu``'s ``_leaf_spec`` rule: a kernel of rank
  >= 2 with at least ``2**14`` elements and ``out_channels % tensor == 0``
  is split on its output channels; BN vectors, biases, small kernels (the
  stem's 864) and heads with odd channels (``3 * (5 + C)``) stay whole.
  :func:`apply_tensor_layout` keeps each rank's block of a split kernel as
  a plain parameter (its momentum follows it) and marks the module
  (``tp = (M, m)``). Activations between blocks are whole on every model
  rank: a split conv enters through :func:`enter_model` (identity forward,
  all-reduce of the cotangent over ``model`` backward, since each rank's
  cotangent holds its slice's share), computes its channel slice from the
  whole input channels, runs BatchNorm on the slice with that slice of
  the whole ``weight`` / ``bias`` (statistics over ``data x space``), and
  leaves through :func:`gather_channels`, which every consumer then reads
  whole: the next conv, the heads, every channel concat and YOLOv2's
  reorg. The gather's backward takes this rank's slice of the cotangent
  (a reduce-scatter in GSPMD's terms, whose sum the consumer's
  :func:`enter_model` already made: every consumer of a whole activation
  gives each rank its whole cotangent). The whole leaves a slice uses get
  their gradients summed over ``model``, the leaves every model rank uses
  whole averaged over it, so the replicas cannot drift apart by the
  card's rounding (:func:`model_axis_params`); everything then averages
  over ``data x space``.

Spatial layout (cfg ``parallel_options.spatial``, the ``space`` axis).
  Each space rank holds a block of every image's rows (:func:`space_rows`
  takes it after the device augmentation). A NCHW activation is row-sharded
  while its local height times ``S`` is its width (the images are square),
  and whole when its height is its width. Windows that reach across a block
  edge take their rows from the neighbour through :func:`halo` (zeros, or
  -inf for a max pool, at the image's outer edges, as the padding); its
  backward adds the halo's cotangent back into the sender's rows. Where a
  block no longer splits evenly (a stride-2 window over an odd block, a
  halo deeper than the block; YOLOv3-416's stride-32 grid of 13 rows,
  YOLOv1's ``fc``, YOLOv2's reorg) the activation is gathered whole over
  ``space`` (:func:`whole_rows`) and the rest of the network runs whole on
  every space rank; GSPMD pads the uneven block there instead, with the
  same math. The heads are gathered whole before the loss and the decode,
  so space peers compute the same loss; a row gather's backward sums its
  cotangent over the space peers, which makes every gradient ``S`` times
  the data rank's, and the average over ``data x space`` is the data
  average. BatchNorm reduces over ``data x space`` with ``n`` counting
  every row of the global batch.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from podtpu_torch.parallel import mesh

MIN_SHARD_ELEMS = 2 ** 14  # podtpu's state_shardings(min_shard_elems)

# the spatial layout of the forward (and backward) in progress
_local = threading.local()


# ---- the leaf rule and the parameters ---------------------------------------

def model_split(shape, n_model: int,
                min_elems: int = MIN_SHARD_ELEMS) -> bool:
    """``podtpu``'s ``_leaf_spec`` tensor rule on a torch leaf (output
    channels first: OIHW kernels, ``[out, in]`` linears): split on dim 0
    over ``model``."""
    shape = tuple(shape)
    n = 1
    for d in shape:
        n *= d
    return (n_model > 1 and len(shape) >= 2 and n >= min_elems
            and shape[0] % n_model == 0)


def _split_modules(model: nn.Module):
    """(name, module, its kernel's parameter name) of every module that
    holds a kernel: the blocks' convs, the heads, biased and bare convs
    and linears."""
    from podtpu_torch.models.layers import ConvBnAct, HeadConv

    for name, mod in model.named_modules():
        if isinstance(mod, (ConvBnAct, HeadConv)):
            yield name, mod, "conv.weight"
        elif isinstance(mod, (nn.Conv2d, nn.Linear)):
            parent = name.rsplit(".", 1)[0] if "." in name else ""
            owner = model.get_submodule(parent) if parent else model
            if not isinstance(owner, (ConvBnAct, HeadConv)):
                yield name, mod, "weight"


@torch.no_grad()
def apply_tensor_layout(model: nn.Module, n_model: int, index: int):
    """Keep this model rank's block (``index`` of ``n_model``) of every
    split kernel, and of a split conv's or linear's ``bias`` nothing: it
    stays whole (a slice of it is used). Marks each split module
    ``tp = (n_model, index)`` and its BatchNorm alike, and the model's
    ``tp_keys``. Build the optimizer (and FSDP) after this."""
    keys = []
    for name, mod, wname in _split_modules(model):
        holder = mod.conv if wname == "conv.weight" else mod
        w = holder.weight
        if not model_split(w.shape, n_model):
            continue
        k = w.shape[0] // n_model
        holder.weight = nn.Parameter(w.narrow(0, index * k, k).clone())
        mod.tp = (n_model, index)
        if hasattr(mod, "bn"):
            mod.bn.tp = (n_model, index)
        keys.append(f"{name}.{wname}" if name else wname)
    model.tp_keys = frozenset(keys)


def model_axis_params(model: nn.Module) -> tuple[list, list]:
    """(summed, whole): the whole leaves a channel slice uses (the
    BatchNorm ``weight`` and ``bias`` of split blocks, the ``bias`` of
    split biased convs and linears), whose gradients are summed over
    ``model``, and every other leaf but the split kernels, whose gradients
    are averaged over it (``parallel/mesh.py::sum_over_model``). Empty
    without the tensor layout."""
    if not getattr(model, "tp_keys", None):
        return [], []
    summed, split = [], []
    for mod in model.modules():
        if getattr(mod, "tp", None) is None:
            continue
        split.append(mod.conv.weight if hasattr(mod, "conv") else mod.weight)
        if hasattr(mod, "bn"):
            summed += [mod.bn.weight, mod.bn.bias]
        elif getattr(mod, "bias", None) is not None:
            summed.append(mod.bias)
    skip = {id(p) for p in summed + split}
    return summed, [p for p in model.parameters() if id(p) not in skip]


def channel_slice(tp, c: int) -> slice:
    """The channels of ``c`` that a ``tp = (M, m)`` module computes."""
    n, i = tp
    return slice(i * c // n, (i + 1) * c // n)


# ---- collectives as autograd ops --------------------------------------------

def _gather_dim(t: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    moved = t.movedim(dim, 0).contiguous()
    out = moved.new_empty((n * moved.shape[0],) + tuple(moved.shape[1:]))
    dist.all_gather_into_tensor(out, moved, group=group)
    out = out.movedim(0, dim)
    if out.dim() == 4:
        out = out.contiguous(memory_format=torch.channels_last)
    return out


class _GatherDim(torch.autograd.Function):
    """Blocks of ``dim`` from every rank of ``group``, whole. Backward:
    this rank's block of the cotangent, summed over the group first when
    ``reduce`` (the row gather: space peers each hold the whole
    cotangent of their copy)."""

    @staticmethod
    def forward(ctx, t, dim, group, n, index, reduce):
        ctx.dim, ctx.group, ctx.index, ctx.reduce = dim, group, index, reduce
        ctx.k = t.shape[dim]
        return _gather_dim(t, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce:
            g = g.contiguous()
            dist.all_reduce(g, group=ctx.group)
        out = g.narrow(ctx.dim, ctx.index * ctx.k, ctx.k)
        if out.dim() == 4:
            out = out.contiguous(memory_format=torch.channels_last)
        else:
            out = out.contiguous()
        return out, None, None, None, None, None


class _EnterModel(torch.autograd.Function):
    """Identity forward; the cotangent summed over ``model`` backward."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=mesh.model_group())
        return g


class _Halo(torch.autograd.Function):
    """A row-sharded NCHW block with ``above`` rows of the block before it
    and ``below`` rows of the block after it, ``fill`` beyond the image.
    Backward: the halo rows' cotangent is added into the rows they came
    from."""

    @staticmethod
    def forward(ctx, x, above, below, fill):
        group, (_, n_space, _) = mesh.space_group(), mesh.axis_sizes()
        s = mesh.coords()[1]
        h = x.shape[2]
        ctx.above, ctx.below, ctx.h = above, below, h
        ctx.s, ctx.n = s, n_space
        # what the neighbours need: my first `below` rows (for the block
        # before) and my last `above` rows (for the block after)
        send = torch.cat([x.narrow(2, 0, below),
                          x.narrow(2, h - above, above)], dim=2)
        got = _gather_dim(send, 2, group, n_space)
        width = above + below
        parts = []
        if above:
            parts.append(got.narrow(2, (s - 1) * width + below, above)
                         if s > 0 else
                         torch.full_like(x.narrow(2, 0, above), fill))
        parts.append(x)
        if below:
            parts.append(got.narrow(2, (s + 1) * width, below)
                         if s + 1 < n_space else
                         torch.full_like(x.narrow(2, 0, below), fill))
        return torch.cat(parts, dim=2)

    @staticmethod
    def backward(ctx, g):
        a, b, h, s, n = ctx.above, ctx.below, ctx.h, ctx.s, ctx.n
        top, bot = g.narrow(2, 0, a), g.narrow(2, a + h, b)
        got = _gather_dim(torch.cat([top, bot], dim=2), 2, mesh.space_group(),
                          n)
        gx = g.narrow(2, a, h).clone()
        width = a + b
        if a and s + 1 < n:  # the block after took my last rows as its top
            gx.narrow(2, h - a, a).add_(got.narrow(2, (s + 1) * width, a))
        if b and s > 0:  # the block before took my first rows as its bottom
            gx.narrow(2, 0, b).add_(got.narrow(2, (s - 1) * width + a, b))
        return gx, None, None, None


def enter_model(x: torch.Tensor) -> torch.Tensor:
    return _EnterModel.apply(x)


def gather_channels(y: torch.Tensor) -> torch.Tensor:
    """The model ranks' channel slices of ``y`` (dim 1), whole."""
    _, _, n = mesh.axis_sizes()
    return _GatherDim.apply(y, 1, mesh.model_group(), n, mesh.coords()[2],
                            False)


@torch.no_grad()
def gather_vector(v: torch.Tensor) -> torch.Tensor:
    """The model ranks' slices of a per-channel vector, whole (no
    gradient: the running statistics' update)."""
    return _gather_dim(v, 0, mesh.model_group(), mesh.tensor_size())


# ---- the spatial layout -----------------------------------------------------

@contextmanager
def layout_scope(model: nn.Module):
    """Within it, the spatial layout of ``model`` (its ``layout``, set by
    ``train/state.py::create_train_state``) is active: the layout-aware
    ops below shard rows. A model without one (a whole replica) runs as
    in one process. The train step keeps it open over the backward too,
    where checkpointed stages are recomputed."""
    spatial = (getattr(model, "layout", None) or {}).get("spatial", 1)
    prev = getattr(_local, "space", 1)
    _local.space = spatial
    try:
        yield
    finally:
        _local.space = prev


def _space() -> int:
    return getattr(_local, "space", 1)


def row_sharded(x: torch.Tensor) -> bool:
    """Whether NCHW ``x`` holds a block of its rows (under an active
    spatial layout)."""
    n = _space()
    if n == 1 or x.dim() != 4:
        return False
    h, w = x.shape[2], x.shape[3]
    if h == w:
        return False
    if h * n != w:
        raise ValueError(f"a [{h} x {w}] map is neither whole nor one of "
                         f"{n} row blocks of a square map")
    return True


def space_rows(img: torch.Tensor, model: nn.Module) -> torch.Tensor:
    """This space rank's block of an NHWC image batch's rows when
    ``model`` has the spatial layout, else ``img``."""
    n = (getattr(model, "layout", None) or {}).get("spatial", 1)
    if n == 1:
        return img
    h = img.shape[1]
    if h % n:
        raise ValueError(f"{h} image rows do not split over {n} space ranks")
    k = h // n
    return img.narrow(1, mesh.coords()[1] * k, k)


def copies(x: torch.Tensor) -> int:
    """How many space peers hold the same values of NCHW ``x``: ``S`` for
    a whole map under the spatial layout, else 1 (what a count over the
    ``data x space`` group divides by to count each value once)."""
    n = _space()
    return n if n > 1 and not row_sharded(x) else 1


def whole_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` with every row (gathered over ``space`` when it holds a
    block of them)."""
    if not row_sharded(x):
        return x
    return _GatherDim.apply(x, 2, mesh.space_group(), mesh.spatial_size(),
                            mesh.coords()[1], True)


def match_rows(*ts: torch.Tensor) -> list[torch.Tensor]:
    """The tensors in one layout: all gathered whole when any is whole."""
    if _space() == 1 or all(row_sharded(t) for t in ts):
        return list(ts)
    return [whole_rows(t) for t in ts]


def halo(x: torch.Tensor, above: int, below: int,
         fill: float = 0.0) -> torch.Tensor:
    return _Halo.apply(x, above, below, fill)


def _rows_for(x: torch.Tensor, k: int, stride: int, pad: int, fill: float):
    """(a row-sharded ``x`` ready for a k-row window of ``stride`` with
    ``pad`` rows of padding, the row padding left for the op): the block
    with its halo, or the whole rows where the block does not split."""
    above, below = pad, max(k - pad - stride, 0)
    h = x.shape[2]
    if h % stride or max(above, below) > h:
        return whole_rows(x), pad
    if above or below:
        x = halo(x, above, below, fill)
    return x, 0


def _square(v) -> int:
    return v[0] if isinstance(v, (tuple, list)) else int(v)


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
           stride=1, padding=0) -> torch.Tensor:
    """``F.conv2d`` with square ``stride`` and ``padding``; a row-sharded
    ``x`` takes its window's halo (zeros beyond the image)."""
    if not row_sharded(x):
        return F.conv2d(x, w, b, stride=stride, padding=padding)
    stride, padding = _square(stride), _square(padding)
    xs, ph = _rows_for(x, w.shape[2], stride, padding, 0.0)
    return F.conv2d(xs, w, b, stride=stride, padding=(ph, padding))


def max_pool2d(x: torch.Tensor, k: int, stride: int,
               padding: int = 0) -> torch.Tensor:
    """``F.max_pool2d`` (-inf padding); a row-sharded ``x`` takes its
    window's halo, -inf beyond the image."""
    if not row_sharded(x):
        return F.max_pool2d(x, k, stride=stride, padding=padding)
    xs, ph = _rows_for(x, k, stride, padding, float("-inf"))
    return F.max_pool2d(xs, k, stride=stride, padding=(ph, padding))


def linear(fc: nn.Linear, x: torch.Tensor, dtype: torch.dtype
           ) -> torch.Tensor:
    """``x @ W^T + b`` in ``dtype`` (YOLOv1's ``fc``, whose bias ``podtpu``
    adds after the product); a split linear (``tp``) computes its slice of
    the output features with that slice of the whole bias, gathered whole
    over ``model``."""
    bias = fc.bias
    tp = getattr(fc, "tp", None)
    if tp is not None:
        x = enter_model(x)
        bias = bias[channel_slice(tp, bias.shape[0])]
    y = F.linear(x, fc.weight.to(dtype)) + bias.to(dtype)
    return y if tp is None else gather_channels(y)


def quant_group(x: torch.Tensor):
    """The group a per-tensor abs-max of ``x`` is taken over (QAT's
    activation scale): ``space`` for a row block, else none."""
    return mesh.space_group() if row_sharded(x) else None
