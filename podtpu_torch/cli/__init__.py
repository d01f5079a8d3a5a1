"""The port's command-line tools, one module per root script of ``podtpu``
under the same name (``test.py`` -> ``python -m podtpu_torch.cli.test``).

Each runs on ``cuda`` unless ``--device`` says otherwise (``--device cpu``
in place of ``podtpu``'s ``--platform cpu``). ``--artifact`` runs an
exported serving artifact (``export_model --with-postprocess``, a
``.pt2`` program) in place of a checkpoint, on the device it was
exported on (``export/runner.py``).
"""

from __future__ import annotations

import os

import numpy as np


def class_names(cfg: dict) -> list[str]:
    """cfg ``names`` when the file exists, else the class indices."""
    from podtpu_torch.utils.viz import load_names

    if cfg.get("names") and os.path.exists(cfg["names"]):
        return load_names(cfg["names"])
    return [str(i) for i in range(cfg["num_classes"])]


def eval_trainer(cfg: dict, ckpt: str | None, device=None,
                 use_ema: bool | None = None):
    """An eval-only ``Trainer`` on ``device`` holding ``ckpt``'s weights
    (the model's own initialisation without one): the EMA shadow or the
    raw weights as ``restore_eval_weights`` picks them."""
    from podtpu_torch.train.trainer import Trainer, restore_eval_weights

    trainer = Trainer(cfg, eval_only=True, device=device)
    if ckpt:
        trainer.state = restore_eval_weights(ckpt, trainer.state, cfg,
                                             use_ema=use_ema)
    return trainer


class Detector:
    """What the per-image CLIs run on one image: a checkpoint's eval step
    on ``device``, or an exported serving artifact (``--artifact``; a
    fixed-batch artifact gets the image tiled up to its batch, as
    ``podtpu``'s scripts do)."""

    def __init__(self, cfg: dict, ckpt: str | None, artifact: str | None,
                 device=None):
        self.pad_annot = -np.ones((1, cfg["max_annots"], 5), np.float32)
        self.trainer, self.batch = None, None
        if artifact:
            if ckpt:
                raise SystemExit("--artifact runs the exported graph as-is; "
                                 "--ckpt applies to a checkpoint")
            from podtpu_torch.export.runner import (
                artifact_device,
                artifact_runner,
            )

            try:
                self.run_artifact, self.batch = artifact_runner(artifact,
                                                                device)
            except ValueError as e:
                raise SystemExit(str(e))
            self.device = artifact_device(artifact, device)
        else:
            self.trainer = eval_trainer(cfg, ckpt, device)
            self.device = self.trainer.device

    def __call__(self, img: np.ndarray) -> np.ndarray:
        """img [1, H, W, 3] (uint8, or float in [0, 1]) -> the valid
        detections [n, 6] (cx, cy, w, h, conf, class), score-sorted."""
        if self.trainer is None:
            from podtpu_torch.export.runner import prepare_input

            x = prepare_input(img)
            if self.batch and self.batch > 1:
                x = np.tile(x, (self.batch, 1, 1, 1))
            dets, valid = self.run_artifact(x)
            return dets[0][valid[0]]
        from podtpu_torch.train.trainer import put_batch

        batch = put_batch({"img": img, "annot": self.pad_annot},
                          self.device)
        _, dets, valid = self.trainer.eval_step(self.trainer.state, batch)
        return dets[0].cpu().numpy()[valid[0].cpu().numpy()]


def add_common_args(ap, artifact_help: str):
    """``--cfg``, ``--ckpt``, ``--artifact`` and ``--device``."""
    ap.add_argument("--cfg", required=True, type=str)
    ap.add_argument("--ckpt", type=str, default=None)
    ap.add_argument("--artifact", type=str, default=None,
                    help=artifact_help + " (a .pt2, .tflite or "
                    ".savedmodel from export_model --with-postprocess) "
                    "instead of a checkpoint")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default cuda; cpu for local runs); "
                    "where a .tflite or .savedmodel artifact runs")
