"""Train a detector from a YAML config (the port's ``train.py``).

    python -m podtpu_torch.train.run --cfg configs/yolov3_voc.yaml \\
        [--resume CKPT] [--epochs N] [--device cpu]

Host data (``build_datasets`` -> ``Loader``) feeds ``Trainer.fit``, which
validates every ``check_val_every_n_epoch`` epochs and keeps ``best`` on
the lowest ``val_loss``. Runs on ``cuda`` unless ``--device`` says
otherwise. One process: the loader is not sharded across hosts.
"""

from __future__ import annotations

import argparse

from podtpu_torch.config import get_configs
from podtpu_torch.data.dataset import build_datasets
from podtpu_torch.data.loader import Loader
from podtpu_torch.train.trainer import Trainer
from podtpu_torch.utils.summary import summarize


def make_loaders(cfg: dict) -> tuple[Loader, Loader]:
    """(train_loader, val_loader) over ``build_datasets(cfg)``."""
    train_ds, val_ds = build_datasets(cfg)
    train_loader = Loader(
        train_ds,
        batch_size=cfg["batch_size"],
        shuffle=True,
        max_annots=cfg["max_annots"],
        workers=cfg["workers"],
        seed=cfg.get("seed", 0),
        worker_mode=cfg.get("worker_mode", "thread"),
    )
    val_loader = Loader(
        val_ds,
        batch_size=cfg["batch_size"],
        shuffle=False,
        max_annots=cfg["max_annots"],
        workers=cfg["workers"],
    )
    return train_loader, val_loader


def train(cfg: dict, resume: str | None = None, epochs: int | None = None,
          device=None) -> Trainer:
    train_loader, val_loader = make_loaders(cfg)
    trainer = Trainer(cfg, device=device)
    start_epoch = 0
    if resume:
        trainer.state = trainer.ckpt.restore(resume, trainer.state)
        # epoch-granular resume: a mid-epoch (preemption) checkpoint replays
        # its epoch from the start; set_epoch(epoch) keeps the data draws
        # per-epoch deterministic
        start_epoch = trainer.state.step // max(len(train_loader), 1)
        print(f"resumed from {resume} at step {trainer.state.step} "
              f"(epoch {start_epoch})")
    print(summarize(trainer.state.model))
    trainer.fit(train_loader, val_loader, epochs=epochs,
                start_epoch=start_epoch)
    return trainer


def main(argv=None) -> Trainer:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cfg", required=True, type=str, help="experiment yaml")
    ap.add_argument("--resume", type=str, default=None, help="checkpoint dir")
    ap.add_argument("--epochs", type=int, default=None,
                    help="override cfg epochs")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default cuda; cpu for local runs)")
    args = ap.parse_args(argv)
    return train(get_configs(args.cfg), resume=args.resume,
                 epochs=args.epochs, device=args.device)


if __name__ == "__main__":
    main()
