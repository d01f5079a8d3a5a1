"""The port's command-line tools, one module per root script of ``podtpu``
under the same name (``test.py`` -> ``python -m podtpu_torch.cli.test``).

Each runs on ``cuda`` unless ``--device`` says otherwise (``--device cpu``
in place of ``podtpu``'s ``--platform cpu``). Exported serving artifacts
(``--artifact``) and int8 evaluation (``--quantize``) are not ported:
asking for them raises, naming the ``ROADMAP.md`` item that ports them.
"""

from __future__ import annotations

import os

ARTIFACT_UNPORTED = ("exported serving artifacts (--artifact) are not "
                     "ported yet (ROADMAP.md queue 1, item 10: export)")


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


def add_common_args(ap, artifact_help: str):
    """``--cfg``, ``--ckpt``, ``--artifact`` and ``--device``."""
    ap.add_argument("--cfg", required=True, type=str)
    ap.add_argument("--ckpt", type=str, default=None)
    ap.add_argument("--artifact", type=str, default=None,
                    help=artifact_help + " (not ported yet: raises)")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default cuda; cpu for local runs)")
