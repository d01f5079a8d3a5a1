"""Data, spatial and tensor parallelism over processes
(``podtpu/parallel/mesh.py``).

``podtpu`` runs one program on a mesh of chips ``(data[, space][, model])``:
the batch is sharded on ``data``, image height on ``space`` and conv
output channels on ``model``, and GSPMD inserts the collectives. The port
runs one process a card (or, over ``gloo``, several processes sharing
one) on the same mesh, :func:`make_mesh`, whose rank ``r`` sits at
``(d, s, m)`` with ``r = (d * S + s) * M + m``, and says where each
collective goes (``parallel/layouts.py`` holds the layouts' ops):

* :func:`init_distributed` joins the job ``torchrun`` started (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``): ``nccl`` when every rank has a card of
  its own, ``gloo`` only when the caller asks for it (ranks sharing a card,
  CPU runs). Nothing falls back: a failed rendezvous or collective raises.
* :func:`world` / :func:`rank`: the ``data`` axis (every rank without a
  mesh of more axes). The loaders, the global batch's rows
  (:func:`global_rows`), the augmentation and dropout draws and the
  counts follow it; ``space`` and ``model`` peers load the same rows.
* BatchNorm statistics, the fused stem's sums and the gradient average go
  over ``data x space`` (:func:`stat_group`): space peers hold other rows
  of the same images. A whole (gathered) activation is held by every
  space peer, so its sums come in ``S`` times with ``n`` counted ``S``
  times: the same statistics.
* ``model`` (:func:`model_group`): the channel gathers of the tensor
  layout, the all-reduce of a split conv's input cotangent, the sum of
  the gradients of the whole leaves a channel slice uses (BN's ``weight``
  / ``bias``, a biased conv's ``bias``) and the average of those of the
  leaves every model rank uses whole (:func:`sum_over_model`).
* ``space`` (:func:`space_group`): the halo exchanges and row gathers of
  the spatial layout.
* :func:`apply_fsdp`: FSDP2 ``fully_shard`` over ``data x space``
  (:func:`fsdp_mesh`; ZeRO-3: parameters, gradients and momentum sharded
  at rest; the math is DP's). Under the tensor layout each rank's leaves
  are plain tensors holding its channel slice, which FSDP2 shards again
  on their dim 0 (``podtpu``'s rule puts ``data`` on another dim of the
  leaf; the math is the same).
* Host-side agreement (run directory, stop flags, the mAP's rows, the
  val loss) goes through :func:`host_group`, a ``gloo`` group, so it never
  waits on the card.
"""

from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist

DATA_AXIS = "data"
SPACE_AXIS = "space"
MODEL_AXIS = "model"

# the job this process joined: backend, device, and the host-side group
_job: dict = {}
# the mesh of :func:`make_mesh`: sizes (D, S, M), this rank's coordinates
# (d, s, m), the DeviceMesh and the groups of each collective
_mesh: dict = {}


def is_distributed() -> bool:
    """A process group is initialised."""
    return dist.is_available() and dist.is_initialized()


def _ranks() -> int:
    return dist.get_world_size() if is_distributed() else 1


def axis_sizes() -> tuple[int, int, int]:
    """(data, space, model) ranks: every rank on ``data`` without a mesh."""
    return _mesh.get("shape", (_ranks(), 1, 1))


def coords() -> tuple[int, int, int]:
    """This rank's (data, space, model) coordinates."""
    if "coord" in _mesh:
        return _mesh["coord"]
    return (dist.get_rank() if is_distributed() else 0), 0, 0


def world() -> int:
    """Ranks on the data axis (1 without a group)."""
    return axis_sizes()[0]


def rank() -> int:
    """This rank's coordinate on the data axis."""
    return coords()[0]


def spatial_size() -> int:
    return axis_sizes()[1]


def tensor_size() -> int:
    return axis_sizes()[2]


def stat_group():
    """(group, ranks) of the BatchNorm statistics and the gradient average:
    ``data x space`` (the default group when that is every rank)."""
    d, s, m = axis_sizes()
    return (_mesh["groups"]["stat"] if m > 1 else None), d * s


def space_group():
    return _mesh["groups"][SPACE_AXIS]


def model_group():
    return _mesh["groups"][MODEL_AXIS]


def data_group():
    """The data axis' group (the default group without a mesh)."""
    return _mesh["groups"][DATA_AXIS] if "groups" in _mesh else None


def init_distributed(backend: str | None = None, timeout_s: float = 600.0,
                     device: str | None = None,
                     init_method: str | None = None) -> torch.device:
    """Join the job ``torchrun`` describes in the environment and return
    this rank's device: ``cuda:LOCAL_RANK``, or the CPU when ``device`` is
    ``"cpu"`` (which needs ``backend="gloo"``).

    ``backend=None`` picks ``nccl`` and raises when the ranks of a host
    outnumber its cards; ``"gloo"`` must be asked for, and then ranks may
    share a card (``cuda:LOCAL_RANK % cards``). A rank that finds no card
    raises unless the CPU was asked for. ``init_method`` (say
    ``file:///path``) is where the ranks meet; by default torchrun's
    store (``MASTER_ADDR`` / ``MASTER_PORT``)."""
    if is_distributed():
        raise RuntimeError("a process group is already initialised")
    keys = ("RANK", "WORLD_SIZE", "LOCAL_RANK")
    if init_method is None:
        keys += ("MASTER_ADDR", "MASTER_PORT")
    for key in keys:
        if key not in os.environ:
            raise RuntimeError(f"--distributed needs torchrun's environment "
                               f"({key} is not set): launch with python -m "
                               "torch.distributed.run --nproc_per_node N")
    local = int(os.environ["LOCAL_RANK"])
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE",
                                     os.environ["WORLD_SIZE"]))
    if backend not in (None, "nccl", "gloo"):
        raise ValueError(f"backend must be nccl or gloo, not {backend!r}")
    if device == "cpu":
        if backend != "gloo":
            raise ValueError("a CPU run needs backend='gloo'")
        dev = torch.device("cpu")
    else:
        if device not in (None, "cuda"):
            raise ValueError(f"device must be cuda or cpu, not {device!r}")
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for this rank; pass "
                               "device='cpu' (with backend='gloo') to run on "
                               "the CPU")
        cards = torch.cuda.device_count()
        backend = backend or "nccl"
        if backend == "nccl" and local_world > cards:
            raise RuntimeError(
                f"{local_world} ranks on a host with {cards} card(s): nccl "
                "takes one card a rank; pass backend='gloo' to share cards")
        dev = torch.device("cuda", local % cards)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]),
                            timeout=timedelta(seconds=timeout_s))
    _joined(backend, dev)
    return dev


def _joined(backend: str, dev: torch.device):
    """Record the job (for a group initialised by the caller, as the tests
    and ``dryrun`` do over a file store)."""
    _job.clear()
    _job.update(backend=backend, device=dev,
                host=None if backend == "gloo" else dist.new_group(
                    backend="gloo"))


def join(backend: str, dev: torch.device, rank_: int, world_: int,
         init_method: str, timeout_s: float = 60.0) -> torch.device:
    """Initialise a group without torchrun's environment (a file store:
    ``file:///path``): what a launcher that spawns its own ranks calls."""
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank_,
                            world_size=world_,
                            timeout=timedelta(seconds=timeout_s))
    _joined(backend, dev)
    return dev


def shutdown():
    """Leave the job (every rank calls it)."""
    if is_distributed():
        dist.destroy_process_group()
    _job.clear()
    _mesh.clear()


def host_group():
    """The group for host-side objects: ``gloo`` over the CPU."""
    if not is_distributed():
        return None
    return _job.get("host")


def make_mesh(device_type: str | None = None, spatial: int = 1,
              tensor: int = 1):
    """The ``DeviceMesh`` ``(data[, space][, model])`` over every rank, axes
    of size 1 left out (``podtpu``'s ``make_mesh``): ``spatial`` ranks
    share each image's height, ``tensor`` ranks each layer's channels, and
    the rest is the data axis. Every rank calls it (it makes the groups);
    it becomes the process's mesh, which :func:`world`, :func:`rank` and
    the layouts read, until the next call or :func:`shutdown`."""
    from torch.distributed.device_mesh import init_device_mesh

    if device_type is None:
        device_type = _job.get("device", torch.device("cpu")).type
    spatial, tensor = max(int(spatial), 1), max(int(tensor), 1)
    n = _ranks()
    if n % (spatial * tensor):
        raise ValueError(f"parallel_options spatial={spatial} x "
                         f"tensor={tensor} does not divide {n} devices")
    d = n // (spatial * tensor)
    shape, names = [d], [DATA_AXIS]
    for size, name in ((spatial, SPACE_AXIS), (tensor, MODEL_AXIS)):
        if size > 1:
            shape.append(size)
            names.append(name)
    mesh = init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))
    r = dist.get_rank()
    coord = (r // (spatial * tensor), r // tensor % spatial, r % tensor)
    groups = {name: mesh.get_group(name) for name in names}
    if spatial == 1:
        groups["stat"] = groups[DATA_AXIS]
    elif d == 1:
        groups["stat"] = groups[SPACE_AXIS]
    else:
        # data x space: one group for each model coordinate, made by every
        # rank in the same order
        for m in range(tensor):
            g = dist.new_group([(i * spatial + j) * tensor + m
                                for i in range(d) for j in range(spatial)])
            if m == coord[2]:
                groups["stat"] = g
    _mesh.clear()
    _mesh.update(shape=(d, spatial, tensor), coord=coord, mesh=mesh,
                 groups=groups, device_type=device_type)
    return mesh


def fsdp_mesh(mesh=None):
    """The mesh FSDP shards over: ``data x space`` of ``mesh`` (the
    process's mesh by default); the mesh itself when it is one data
    axis."""
    from torch.distributed.device_mesh import DeviceMesh

    mesh = _mesh["mesh"] if mesh is None else mesh
    if mesh.mesh_dim_names == (DATA_AXIS,):
        return mesh
    if spatial_size() == 1:
        return mesh[DATA_AXIS]
    return DeviceMesh.from_group(_mesh["groups"]["stat"], mesh.device_type)


def parallel_options(cfg: dict) -> dict:
    """cfg ``parallel_options`` -> ``{"fsdp": bool, "spatial": int,
    "tensor": int}`` (no key is ignored: ``config.py`` refuses others)."""
    popts = cfg.get("parallel_options") or {}
    out = {"fsdp": bool(popts.get("fsdp", False))}
    for key in ("spatial", "tensor"):
        out[key] = int(popts.get(key, 1) or 1)
        if out[key] < 1:
            raise ValueError(f"parallel_options.{key} must be >= 1, got "
                             f"{out[key]}")
    return out


def setup_layout(cfg: dict, device_type: str | None = None):
    """The mesh cfg ``parallel_options`` asks for (under a process group;
    nothing without one, where every layout is the one-process step). Kept
    when the process's mesh already has that shape."""
    if not is_distributed():
        return None
    p = parallel_options(cfg)
    want = (_ranks() // (p["spatial"] * p["tensor"]), p["spatial"],
            p["tensor"])
    if _mesh.get("shape") == want and (
            device_type is None or _mesh["device_type"] == device_type):
        return _mesh["mesh"]
    return make_mesh(device_type, p["spatial"], p["tensor"])


# ---- the batch ------------------------------------------------------------

def _rows(n: int) -> slice:
    w, r = world(), rank()
    if n % w:
        raise ValueError(f"a global batch of {n} does not split over {w} "
                         "ranks")
    return slice(r * n // w, (r + 1) * n // w)


def shard_batch(batch: dict) -> dict:
    """This rank's rows of a global host batch ``{key: [B, ...]}``: block
    ``rank`` of ``world`` equal blocks on the data axis, as ``podtpu``
    assembles a global array from each host's rows; space and model peers
    take the same rows. Under the spatial layout the images stay whole
    here: the train, eval and stats steps take this rank's block of their
    height (``parallel/layouts.py::space_rows``) after the device
    augmentation, whose warp moves pixels between blocks."""
    return {k: v[_rows(v.shape[0])] for k, v in batch.items()}


def shard_stacked_batch(batch: dict) -> dict:
    """:func:`shard_batch` of a ``[K, B, ...]`` group (cfg
    ``steps_per_dispatch``)."""
    return {k: v[:, _rows(v.shape[1])] for k, v in batch.items()}


def global_rows(local: int) -> tuple[int, slice | None]:
    """(the global batch, this rank's rows in it) for a local batch of
    ``local`` rows; the rows are None on one rank."""
    w = world()
    if w == 1:
        return local, None
    return local * w, slice(rank() * local, (rank() + 1) * local)


# ---- collectives ----------------------------------------------------------

class _AllReduceSum(torch.autograd.Function):
    """The sum over a group's ranks; its backward sums the cotangents,
    which is the gradient of the sum of the ranks' losses."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = g.contiguous().clone()
        dist.all_reduce(out, group=ctx.group)
        return out, None


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The differentiable sum over ``group`` (every rank by default): what
    the BatchNorm statistics take."""
    return _AllReduceSum.apply(t, group)


def gradients_of(params) -> list[torch.Tensor]:
    return [p.grad for p in params if p.grad is not None]


def _coalesced_all_reduce(grads, group, divisor: int | None = None):
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    flat = _flatten_dense_tensors(grads)
    dist.all_reduce(flat, group=group)
    if divisor is not None:
        # a 0-dim divisor: true division on the card as on the CPU
        flat.div_(torch.full((), float(divisor), device=flat.device))
    for g, r in zip(grads, _unflatten_dense_tensors(flat, grads)):
        g.copy_(r)


@torch.no_grad()
def sum_over_model(summed, whole=()):
    """The model axis' part of the gradient reduction
    (``parallel/layouts.py::model_axis_params``): the gradients of the
    whole leaves each ``model`` rank uses a channel slice of (``summed``:
    each rank's holds its slice's share) are summed over ``model``, and
    those of the whole leaves every model rank uses whole (``whole``: the
    same gradient on each, up to the card's rounding) averaged, so that
    the replicas never drift apart. On FSDP's shards too (every model
    rank shards a leaf alike)."""
    if tensor_size() == 1:
        return
    for params, divisor in ((summed, None), (whole, tensor_size())):
        grads = [local(g) for g in gradients_of(params)]
        if grads:
            _coalesced_all_reduce(grads, model_group(), divisor)


@torch.no_grad()
def average_gradients(params, model_summed=(), model_whole=()):
    """Average the gradients of plain (not FSDP-sharded) parameters over
    ``data x space`` in one coalesced all-reduce (FSDP reduces its own
    over that mesh), after :func:`sum_over_model` of ``model_summed`` and
    ``model_whole``.

    Space peers compute the same loss: a layer on a whole activation gives
    each the whole gradient, and a row gather's backward sums its
    cotangent over the space peers, so every gradient is ``S`` times the
    data rank's, and the average over ``data x space`` is the data
    average."""
    if not is_distributed():
        return
    sum_over_model(model_summed, model_whole)
    grads = [g for g in gradients_of(params) if not is_dtensor(g)]
    if not grads:
        return
    group, n = stat_group()
    _coalesced_all_reduce(grads, group, n)


def agree_all(flags: torch.Tensor) -> torch.Tensor:
    """Per element, whether the flag holds on every rank (a min over the
    group on the flags' device)."""
    if not is_distributed():
        return flags
    out = flags.to(torch.int32)
    dist.all_reduce(out, op=dist.ReduceOp.MIN)
    return out.bool()


def any_rank(flag: bool) -> bool:
    """Whether ``flag`` holds on some rank (host side)."""
    if not is_distributed():
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=host_group())
    return bool(t.item())


def mean_over_ranks(value: float) -> float:
    """The mean of a host float over the ranks, the same on every rank
    (space and model peers hold equal values: the data ranks' mean)."""
    if not is_distributed():
        return float(value)
    t = torch.tensor([float(value)], dtype=torch.float64)
    dist.all_reduce(t, group=host_group())
    return float(t.item() / _ranks())


def gather_rows(rows):
    """Every data rank's ``rows`` (host objects), in data order: what
    ``Trainer.validate`` scores the global mAP over (space and model peers
    hold the same rows: the first of each is kept)."""
    if not is_distributed():
        return [rows]
    out = [None] * _ranks()
    dist.all_gather_object(out, rows, group=host_group())
    _, s, m = axis_sizes()
    return out[::s * m]


def broadcast_object(obj):
    """Rank 0's ``obj`` on every rank."""
    if not is_distributed():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=host_group())
    return box[0]


def barrier():
    if is_distributed():
        dist.barrier(group=host_group())


@torch.no_grad()
def broadcast_module(module: torch.nn.Module):
    """Rank 0's parameters and buffers into every rank's module (as DDP
    does at its construction)."""
    if not is_distributed():
        return
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=0)


# ---- FSDP -----------------------------------------------------------------

def is_dtensor(t) -> bool:
    if not dist.is_available():
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (its storage), or ``t`` itself."""
    return t.to_local() if is_dtensor(t) else t


def local_tensors(ts) -> list[torch.Tensor]:
    return [local(t) for t in ts]


def _fsdp_units(model: torch.nn.Module, blocks: tuple[type, ...],
                min_shard_elems: int):
    """The modules that become FSDP units of their own: each block the
    model calls (an instance of ``blocks``, and bare convs and linears
    called directly) with a parameter of at least ``min_shard_elems``
    elements (``podtpu``'s FSDP threshold). Everything else is in the
    root's unit."""
    from torch import nn

    inner = set()
    for m in model.modules():
        if isinstance(m, blocks):
            inner.update(id(c) for c in m.children())
    units = []
    for m in model.modules():
        called = isinstance(m, blocks) or (
            isinstance(m, (nn.Conv2d, nn.Linear)) and id(m) not in inner)
        if called and any(p.numel() >= min_shard_elems
                          for p in m.parameters()):
            units.append(m)
    return units


def apply_fsdp(model: torch.nn.Module, mesh, blocks: tuple[type, ...],
               min_shard_elems: int = 2 ** 14):
    """Shard ``model`` ZeRO-3 over ``mesh``'s ranks with FSDP2
    (``podtpu``'s ``state_shardings(fsdp=True)``): each large block (the
    model's own block types, ``blocks``, whose children run together, and
    every other conv or linear) is a unit, all-gathered before its forward
    and again for its backward, its gradients reduce-scattered (averaged);
    the root's unit holds the rest. FSDP2 shards every parameter it
    manages on dim 0, so the small leaves that ``podtpu`` replicates are
    sharded too; buffers (the BN running statistics) stay whole on every
    rank. Build the optimizer after this."""
    from torch.distributed.fsdp import fully_shard

    for m in _fsdp_units(model, tuple(blocks), min_shard_elems):
        fully_shard(m, mesh=mesh)
    fully_shard(model, mesh=mesh)


def sharded_leaves(model: torch.nn.Module) -> int:
    """Parameters whose local shard is smaller than the whole."""
    return sum(1 for p in model.parameters()
               if is_dtensor(p) and tuple(p.to_local().shape) != tuple(p.shape))


@torch.no_grad()
def whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor of one mesh axis (FSDP's ``Shard(0)``, or replicated)
    gathered whole with one ``all_gather_into_tensor`` of the shards padded
    to equal rows (DTensor's own ``full_tensor`` goes through functional
    collectives, which crash under gloo with CUDA tensors in torch 2.11);
    a plain tensor as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard

    (place,) = t.placements
    loc = t.to_local()
    if isinstance(place, Replicate):
        return loc
    if not (isinstance(place, Shard) and place.dim == 0):
        raise NotImplementedError(f"gathering a {place} DTensor")
    group = t.device_mesh.get_group()
    n, ranks = t.shape[0], dist.get_world_size(group)
    rows = -(-n // ranks)  # torch.chunk's: rank r holds rows r*rows...
    pad = loc.new_zeros((rows,) + tuple(t.shape[1:]))
    pad[:loc.shape[0]] = loc
    out = loc.new_empty((rows * ranks,) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(out, pad, group=group)
    return out[:n]


def full_tree(tree):
    """``tree`` with every DTensor leaf gathered whole (a collective: every
    rank calls it, in the same order)."""
    from torch.utils._pytree import tree_map

    return tree_map(whole, tree)


def model_chunk(full: torch.Tensor, ref) -> torch.Tensor:
    """This model rank's block of dim 0 of ``full`` where ``ref`` (a leaf
    of the tensor layout) holds one of ``tensor`` equal blocks, else
    ``full`` itself."""
    m = tensor_size()
    shape = tuple(ref.shape)
    if (m == 1 or not full.dim() or tuple(full.shape) == shape
            or tuple(full.shape) != (shape[0] * m,) + shape[1:]):
        return full
    k = shape[0]
    return full.narrow(0, coords()[2] * k, k).clone()


@torch.no_grad()
def gather_model(t: torch.Tensor) -> torch.Tensor:
    """The model ranks' blocks of a tensor-layout leaf, whole: their
    dim-0 blocks in model order (a collective over the model axis)."""
    t = t.contiguous()
    out = t.new_empty((tensor_size() * t.shape[0],) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(out, t, group=model_group())
    return out


def shard_like(full: torch.Tensor, ref) -> torch.Tensor:
    """``full`` laid out as ``ref``: its model block under the tensor
    layout (:func:`model_chunk`), then sliced to this rank's shard when
    ``ref`` is a DTensor (every rank holds the same ``full``: no
    communication), else ``full`` itself."""
    full = model_chunk(full, ref)
    if not is_dtensor(ref):
        return full
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(full.to(ref.device, ref.dtype), ref.device_mesh,
                             ref.placements, src_data_rank=None)


def load_full_state(module: torch.nn.Module, state_dict: dict,
                    strict: bool = True):
    """``module.load_state_dict`` of whole tensors, whether or not the
    module is sharded (the weight carrier and the checkpoints)."""
    own = module.state_dict()
    sd = {k: shard_like(v, own[k]) if k in own else v
          for k, v in state_dict.items()}
    return module.load_state_dict(sd, strict=strict)
