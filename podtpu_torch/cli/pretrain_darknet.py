"""Pretrain Darknet-19 (or CSPDarknet53) as a classifier (the port's
``pretrain_darknet.py``; the reference's tiny-imagenet backbone
pretraining, models/backbone/darknet.py:96-150).

Dataset: a directory of per-class subdirectories of images (imagefolder
layout; ``podtpu_torch.data.synthetic.generate_classification`` writes
one). The weights ``.npz`` it writes, in ``podtpu``'s flat layout, plugs
into any detector config through ``backbone_pretrained: path.npz``: the
classifier and the detectors share the ``backbone`` scope, so the partial
load maps one to one.

    python -m podtpu_torch.cli.pretrain_darknet --data DIR/train \\
        --epochs 10 --out darknet19_pretrained.npz [--device cpu]

``--model cspdarknet53`` pretrains the full-YOLOv4 backbone the same way.
The recipe is ``podtpu``'s: a cosine decay of ``--lr`` over every step
(``optax.cosine_decay_schedule``, alpha 0), nesterov SGD with momentum
0.9 and no weight decay, the mean softmax cross-entropy, bf16 compute.
On the card the Darknet-19 step runs the fused stem's four kernels.
"""

from __future__ import annotations

import argparse
import os
import time
from concurrent.futures import ThreadPoolExecutor

import cv2
import numpy as np
import torch

from podtpu_torch import resolve_device
from podtpu_torch.models.layers import SeededDropout
from podtpu_torch.train.schedule import cosine_decay_schedule

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class ImageFolderDataset:
    def __init__(self, root: str, size: int):
        self.size = size
        self.classes = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d))
        )
        self.samples: list[tuple[str, int]] = []
        for idx, cls in enumerate(self.classes):
            cdir = os.path.join(root, cls)
            for name in sorted(os.listdir(cdir)):
                if name.lower().endswith((".jpg", ".jpeg", ".png", ".bmp")):
                    self.samples.append((os.path.join(cdir, name), idx))

    def __len__(self):
        return len(self.samples)

    def get(self, index: int, seed: int, augment: bool = True):
        """(float32 HWC RGB image in [0, 1], label); flipped left-right
        with probability 0.5 under ``augment``, drawn from ``seed``."""
        rng = np.random.default_rng(seed)
        path, label = self.samples[index]
        img = cv2.imread(path)
        if img is None:
            raise FileNotFoundError(path)
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        img = cv2.resize(img, (self.size, self.size))
        if augment and rng.random() < 0.5:
            img = np.ascontiguousarray(img[:, ::-1])
        return img.astype(np.float32) / 255.0, label


def build_classifier(name: str, num_classes: int, dtype: torch.dtype,
                     device) -> torch.nn.Module:
    """``darknet19`` or ``cspdarknet53``, in train mode on ``device``."""
    if name == "cspdarknet53":
        from podtpu_torch.models.yolov4 import CSPDarknet53Classifier as cls
    elif name == "darknet19":
        from podtpu_torch.models.darknet import Darknet19Classifier as cls
    else:
        raise ValueError(f"unknown classifier '{name}'")
    return cls(num_classes=num_classes, dtype=dtype).to(device).train()


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                          ) -> torch.Tensor:
    """Per-example cross-entropy on integer labels, as
    ``optax.softmax_cross_entropy_with_integer_labels``: the shifted
    log-normaliser minus the label's shifted logit."""
    logits = logits - logits.detach().amax(dim=-1, keepdim=True)
    label_logits = torch.gather(logits, -1, labels[:, None])[:, 0]
    return torch.log(torch.exp(logits).sum(-1)) - label_logits


def make_optimizer(model: torch.nn.Module, lr: float
                   ) -> torch.optim.Optimizer:
    """Nesterov SGD, momentum 0.9, no weight decay (``optax.sgd``)."""
    return torch.optim.SGD(model.parameters(), lr=lr, momentum=0.9,
                           nesterov=True)


def make_pretrain_step(model: torch.nn.Module,
                       optimizer: torch.optim.Optimizer, schedule,
                       seed: int = 0):
    """``(imgs NHWC float32, labels int64, step) -> (loss, accuracy)``, on
    the model's device: the train-mode forward (dropout reseeded from
    (seed, step)), the mean cross-entropy, the backward and the update at
    ``schedule(step)``. The results stay on the device."""

    def step(imgs: torch.Tensor, labels: torch.Tensor, index: int):
        model.train()
        for m in model.modules():
            if isinstance(m, SeededDropout):
                m.reseed((seed << 32) + index)
        for group in optimizer.param_groups:
            group["lr"] = schedule(index)
        logits = model(imgs)
        loss = softmax_cross_entropy(logits, labels).mean()
        acc = (logits.argmax(-1) == labels).float().mean()
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach(), acc.detach()

    return step


def evaluate(model: torch.nn.Module, ds: ImageFolderDataset, batch: int,
             device) -> float:
    """Top-1 over ``ds`` in full batches of ``min(batch, len(ds))``; the
    ragged tail is dropped, as ``podtpu`` drops it."""
    vb = min(batch, len(ds))
    correct = total = 0
    model.eval()
    with torch.inference_mode():
        for b in range(len(ds) // vb):
            samples = [ds.get(i, seed=0, augment=False)
                       for i in range(b * vb, (b + 1) * vb)]
            imgs = torch.from_numpy(np.stack([s[0] for s in samples]))
            labels = torch.tensor([s[1] for s in samples], device=device)
            logits = model(imgs.to(device))
            correct += int((logits.argmax(-1) == labels).sum())
            total += vb
    model.train()
    return correct / max(1, total)


def save_weights(model: torch.nn.Module, path: str) -> str:
    """The model's weights as ``podtpu``'s flat ``.npz`` (``params::`` and
    ``batch_stats::`` keys)."""
    from podtpu_torch.export.weights import flat_from_state_dict

    np.savez(path, **flat_from_state_dict(model))
    return path


def pretrain(data: str, size: int = 224, batch: int = 128, epochs: int = 10,
             lr: float = 0.1, out: str = "darknet19_pretrained.npz",
             model_name: str = "darknet19", val_data: str | None = None,
             device=None, dtype: str = "bfloat16", log=print) -> dict:
    """Runs the recipe and writes ``out``; returns ``{"out", "epochs":
    [{"loss", "acc", "seconds", "steps", "val_top1"?}]}``. ``dtype`` is
    the compute dtype (``podtpu``'s script fixes bf16)."""
    dev = resolve_device(device)
    ds = ImageFolderDataset(data, size)
    num_classes = len(ds.classes)
    log(f"{len(ds)} images / {num_classes} classes")
    val_ds = ImageFolderDataset(val_data, size) if val_data else None
    if val_ds is not None and val_ds.classes != ds.classes:
        raise ValueError("train/val class sets differ")

    torch.manual_seed(0)
    model = build_classifier(model_name, num_classes, DTYPES[dtype], dev)
    steps_per_epoch = len(ds) // batch
    schedule = cosine_decay_schedule(lr, epochs * max(1, steps_per_epoch))
    optimizer = make_optimizer(model, lr)
    step = make_pretrain_step(model, optimizer, schedule)

    order_rng = np.random.default_rng(0)
    history = []
    with ThreadPoolExecutor(max_workers=8) as pool:
        for epoch in range(epochs):
            order = order_rng.permutation(len(ds))
            t0 = time.time()
            losses, accs = [], []
            for b in range(steps_per_epoch):
                idx = order[b * batch:(b + 1) * batch]
                samples = list(pool.map(
                    lambda i: ds.get(int(i), int(i) + epoch * 1_000_003),
                    idx))
                imgs = torch.from_numpy(np.stack([s[0] for s in samples]))
                labels = torch.tensor([s[1] for s in samples])
                loss, acc = step(imgs.to(dev, non_blocking=True),
                                 labels.to(dev, non_blocking=True),
                                 epoch * steps_per_epoch + b)
                losses.append(loss)
                accs.append(acc)
            row = {"loss": float(torch.stack(losses).mean()) if losses
                   else float("nan"),
                   "acc": float(torch.stack(accs).mean()) if accs
                   else float("nan"),
                   "steps": len(losses)}
            val_msg = ""
            if val_ds is not None:
                row["val_top1"] = evaluate(model, val_ds, batch, dev)
                val_msg = f" val_top1={row['val_top1']:.4f}"
            row["seconds"] = time.time() - t0
            history.append(row)
            log(f"epoch {epoch}: loss={row['loss']:.4f} "
                f"acc={row['acc']:.4f}{val_msg} ({row['seconds']:.1f}s)")
    save_weights(model, out)
    log(f"wrote {out}")
    return {"out": out, "epochs": history}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", required=True, type=str)
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--out", type=str, default="darknet19_pretrained.npz")
    ap.add_argument("--model", type=str, default="darknet19",
                    choices=["darknet19", "cspdarknet53"])
    ap.add_argument("--val-data", type=str, default=None,
                    help="imagefolder val split; top-1 evaluated per epoch")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default cuda; cpu for local runs)")
    args = ap.parse_args(argv)
    return pretrain(args.data, args.size, args.batch, args.epochs, args.lr,
                    args.out, args.model, args.val_data, device=args.device)


if __name__ == "__main__":
    main()
