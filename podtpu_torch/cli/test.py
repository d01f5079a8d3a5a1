"""Evaluate a checkpoint: val_loss + val_mAP (the port's ``test.py``; the
reference's ``test_yolov*.py`` Trainer.validate flow, test_yolov3.py:16-53).

    python -m podtpu_torch.cli.test --cfg configs/yolov3_voc.yaml \\
        --ckpt saved/.../checkpoints/best [--report DIR] [--device cpu]
"""

from __future__ import annotations

import argparse

from podtpu_torch.cli import (
    ARTIFACT_UNPORTED,
    add_common_args,
    class_names,
    eval_trainer,
)
from podtpu_torch.config import get_configs
from podtpu_torch.data.dataset import build_datasets
from podtpu_torch.data.loader import Loader


def evaluate(cfg: dict, ckpt: str | None, report_dir: str | None = None,
             device=None, quantize: str | None = None,
             use_ema: bool | None = None) -> dict:
    """``{"val_loss", "val_mAP"}`` of ``ckpt`` over cfg ``val_list`` at
    cfg ``batch_size``; ``report_dir``: also the per-class table, PR curves
    and confusion matrix (``metrics/plots.py::write_eval_report``).
    ``use_ema``: the checkpoint's EMA shadow (True), its raw weights
    (False), or None: the shadow where cfg ``ema.eval`` chose ``best`` on
    it (``train/trainer.py::restore_eval_weights``)."""
    if quantize:
        raise NotImplementedError("--quantize (int8 PTQ eval) is not ported "
                                  "yet (ROADMAP.md queue 1, item 10: export)")
    _, val_ds = build_datasets(cfg)
    val_loader = Loader(
        val_ds,
        batch_size=cfg["batch_size"],
        shuffle=False,
        max_annots=cfg["max_annots"],
        workers=cfg["workers"],
    )
    trainer = eval_trainer(cfg, ckpt, device, use_ema=use_ema)
    result = trainer.validate(val_loader)
    print(f"val_loss: {result['val_loss']:.5f}")
    print(f"val_mAP: {result['val_mAP']:.5f}")
    if report_dir:
        from podtpu_torch.metrics.plots import write_eval_report

        paths = write_eval_report(trainer.map_metric, class_names(cfg),
                                  report_dir, cfg.get("conf_threshold", 0.25))
        print(f"report: {paths}")
        with open(paths["table"]) as f:
            print(f.read())
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    add_common_args(ap, "score an exported serving artifact")
    ap.add_argument("--report", type=str, default=None,
                    help="write per-class AP table + PR curves + confusion "
                         "matrix to this directory")
    ap.add_argument("--quantize", type=str, default=None, choices=["int8"],
                    help="evaluate the int8-PTQ model (not ported yet: "
                         "raises)")
    ap.add_argument("--use-ema", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="evaluate the checkpoint's EMA shadow weights "
                         "(default: auto — EMA when the config's ema.eval "
                         "is on, matching how `best` was selected)")
    args = ap.parse_args(argv)
    if args.artifact:
        raise NotImplementedError(ARTIFACT_UNPORTED)
    return evaluate(get_configs(args.cfg), args.ckpt, args.report,
                    device=args.device, quantize=args.quantize,
                    use_ema=args.use_ema)


if __name__ == "__main__":
    main()
