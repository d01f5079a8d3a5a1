"""Train a detector from a YAML config (the port's ``train.py``).

    python -m podtpu_torch.train.run --cfg configs/yolov3_voc.yaml \\
        [--resume CKPT] [--epochs N] [--device cpu]

Host data (``build_datasets`` -> ``Loader``) feeds ``Trainer.fit``, which
validates every ``check_val_every_n_epoch`` epochs and keeps ``best`` on
the lowest ``val_loss``. Runs on ``cuda`` unless ``--device`` says
otherwise.

Several processes (data parallelism; the spatial and tensor layouts and
FSDP with cfg ``parallel_options.spatial`` / ``.tensor`` / ``.fsdp``), one
a card:

    python -m torch.distributed.run --nproc_per_node N \\
        -m podtpu_torch.train.run --cfg ... --distributed

``--backend gloo`` for ranks sharing a card or on the CPU (``--device
cpu``); ``--init-method file:///path`` makes the group meet through a
file in place of torchrun's store. Each data rank's loaders read its shard
of the data (``host_id`` = its data coordinate, ``host_count`` = the data
ranks) at ``batch_size // data ranks`` rows a batch, as ``train.py`` gives
each host its share; space and model peers read the same rows.
"""

from __future__ import annotations

import argparse
from contextlib import contextmanager

from podtpu_torch.config import get_configs
from podtpu_torch.data.dataset import build_datasets
from podtpu_torch.data.loader import Loader
from podtpu_torch.parallel.mesh import (
    init_distributed,
    rank,
    setup_layout,
    shutdown,
    world,
)
from podtpu_torch.train.trainer import Trainer
from podtpu_torch.utils.summary import summarize


def make_loaders(cfg: dict, host_id: int | None = None,
                 host_count: int | None = None) -> tuple[Loader, Loader]:
    """(train_loader, val_loader) over ``build_datasets(cfg)``: this rank's
    shard of each (by default its coordinate on the data axis and the data
    ranks, ``parallel/mesh.py``), at ``batch_size // host_count`` rows a
    batch. A ``batch_size`` that does not split over the data ranks raises:
    torchrun fixes the rank count, where ``podtpu``'s ``_pick_mesh`` can
    leave devices out."""
    host_id = rank() if host_id is None else host_id
    host_count = world() if host_count is None else host_count
    if cfg["batch_size"] % host_count:
        raise ValueError(f"batch_size {cfg['batch_size']} does not split "
                         f"over {host_count} ranks")
    batch = cfg["batch_size"] // host_count
    train_ds, val_ds = build_datasets(cfg)
    train_loader = Loader(
        train_ds,
        batch_size=batch,
        shuffle=True,
        max_annots=cfg["max_annots"],
        workers=cfg["workers"],
        seed=cfg.get("seed", 0),
        host_id=host_id,
        host_count=host_count,
        worker_mode=cfg.get("worker_mode", "thread"),
    )
    val_loader = Loader(
        val_ds,
        batch_size=batch,
        shuffle=False,
        max_annots=cfg["max_annots"],
        workers=cfg["workers"],
        host_id=host_id,
        host_count=host_count,
    )
    return train_loader, val_loader


def train(cfg: dict, resume: str | None = None, epochs: int | None = None,
          device=None) -> Trainer:
    # the mesh of cfg parallel_options first: the loaders follow its data
    # axis
    setup_layout(cfg)
    train_loader, val_loader = make_loaders(cfg)
    log = print if rank() == 0 else (lambda _msg: None)
    trainer = Trainer(cfg, device=device, log=log)
    start_epoch = 0
    if resume:
        trainer.state = trainer.ckpt.restore(resume, trainer.state)
        # epoch-granular resume: a mid-epoch (preemption) checkpoint replays
        # its epoch from the start; set_epoch(epoch) keeps the data draws
        # per-epoch deterministic
        start_epoch = trainer.state.step // max(len(train_loader), 1)
        log(f"resumed from {resume} at step {trainer.state.step} "
            f"(epoch {start_epoch})")
    log(summarize(trainer.state.model))
    trainer.fit(train_loader, val_loader, epochs=epochs,
                start_epoch=start_epoch)
    if world() > 1:
        print(f"rank {rank()} of {world()}: fit ended at step "
              f"{trainer.state.step}", flush=True)
    return trainer


def add_args(ap: argparse.ArgumentParser, cfg: str | None = None,
             device: str | None = None):
    """The training CLI's arguments (``--cfg`` required unless given a
    default)."""
    ap.add_argument("--cfg", required=cfg is None, type=str, default=cfg,
                    help="experiment yaml")
    ap.add_argument("--resume", type=str, default=None, help="checkpoint dir")
    ap.add_argument("--epochs", type=int, default=None,
                    help="override cfg epochs")
    ap.add_argument("--device", type=str, default=device,
                    help="torch device (default cuda; cpu for local runs)")
    ap.add_argument("--distributed", action="store_true",
                    help="one rank of a torchrun job: data parallelism (the "
                         "layouts and FSDP of cfg parallel_options)")
    ap.add_argument("--backend", type=str, default=None,
                    choices=("nccl", "gloo"),
                    help="with --distributed: nccl (one card a rank, the "
                         "default) or gloo (ranks sharing a card, the CPU)")
    ap.add_argument("--init-method", type=str, default=None,
                    help="with --distributed: where the group meets, e.g. "
                         "file:///tmp/store (default: torchrun's store)")


@contextmanager
def distributed(args):
    """The device to train on, as ``args`` (from :func:`add_args`) say:
    with ``--distributed`` this rank's, inside the job it joins (left on
    exit); else ``--device``."""
    if not args.distributed:
        if args.backend or args.init_method:
            raise ValueError("--backend and --init-method go with "
                             "--distributed")
        yield args.device
        return
    dev = init_distributed(args.backend, device=args.device,
                           init_method=args.init_method)
    try:
        yield dev
    finally:
        shutdown()


def main(argv=None) -> Trainer:
    ap = argparse.ArgumentParser()
    add_args(ap)
    args = ap.parse_args(argv)
    with distributed(args) as device:
        return train(get_configs(args.cfg), resume=args.resume,
                     epochs=args.epochs, device=device)


if __name__ == "__main__":
    main()
