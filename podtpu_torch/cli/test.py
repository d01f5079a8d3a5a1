"""Evaluate a checkpoint: val_loss + val_mAP (the port's ``test.py``; the
reference's ``test_yolov*.py`` Trainer.validate flow, test_yolov3.py:16-53).

    python -m podtpu_torch.cli.test --cfg configs/yolov3_voc.yaml \\
        --ckpt saved/.../checkpoints/best [--report DIR] [--device cpu] \\
        [--quantize int8 --calib-batches 4]
    python -m podtpu_torch.cli.test --cfg ... --artifact model.pt2
    python -m podtpu_torch.cli.test --cfg ... --artifact model.tflite \\
        [--device cpu]
    python -m podtpu_torch.cli.test --cfg ... --artifact model.savedmodel \\
        [--device cpu]

``--quantize int8`` scores the int8-PTQ model: activation scales
calibrated on the first ``--calib-batches`` val batches
(``export/quantize.py``), the eval step with the quant state installed.
``--artifact`` scores an exported serving artifact: the val mAP of the
deployed graph, through the same host mAP as ``validate``; a ``.tflite``
or a SavedModel runs through the port's reader on ``--device`` (default
cuda).
"""

from __future__ import annotations

import argparse

import numpy as np

from podtpu_torch.cli import add_common_args, class_names, eval_trainer
from podtpu_torch.config import get_configs
from podtpu_torch.data.dataset import build_datasets
from podtpu_torch.data.loader import Loader


def evaluate(cfg: dict, ckpt: str | None, report_dir: str | None = None,
             device=None, quantize: str | None = None,
             use_ema: bool | None = None, calib_batches: int = 4) -> dict:
    """``{"val_loss", "val_mAP"}`` of ``ckpt`` over cfg ``val_list`` at
    cfg ``batch_size``; ``report_dir``: also the per-class table, PR curves
    and confusion matrix (``metrics/plots.py::write_eval_report``).
    ``use_ema``: the checkpoint's EMA shadow (True), its raw weights
    (False), or None: the shadow where cfg ``ema.eval`` chose ``best`` on
    it (``train/trainer.py::restore_eval_weights``)."""
    _, val_ds = build_datasets(cfg)
    val_loader = Loader(
        val_ds,
        batch_size=cfg["batch_size"],
        shuffle=False,
        max_annots=cfg["max_annots"],
        workers=cfg["workers"],
    )
    trainer = eval_trainer(cfg, ckpt, device, use_ema=use_ema)
    if quantize == "int8":
        from podtpu_torch.export.quantize import (
            build_quant_variables,
            calibrate,
        )
        from podtpu_torch.train.steps import make_eval_step

        calib = []
        for batch in val_loader:
            x = np.asarray(batch["img"])
            calib.append(x.astype(np.float32) / 255.0
                         if x.dtype == np.uint8 else x)
            if len(calib) >= calib_batches:
                break
        model = trainer.state.model
        qvars = build_quant_variables(model, calibrate(model, calib))
        trainer.eval_step = make_eval_step(cfg, extra_variables=qvars)
        print(f"int8 PTQ eval (calibrated on {len(calib)} val batches)")
    elif quantize:
        raise ValueError(f"unknown quantization '{quantize}' (int8)")
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


def evaluate_artifact(cfg: dict, artifact: str,
                      report_dir: str | None = None, device=None) -> dict:
    """Score an exported serving artifact over cfg ``val_list``: its
    detections through the host mAP ``validate`` uses, so the number
    matches ``--ckpt`` on the same weights. A fixed-batch artifact runs
    at its batch, a symbolic one at cfg ``batch_size``; ``device`` is
    where a ``.tflite`` or a SavedModel runs."""
    from podtpu_torch.export.runner import artifact_runner, prepare_input
    from podtpu_torch.metrics.map import MeanAveragePrecision

    try:
        run, batch = artifact_runner(artifact, device)
    except ValueError as e:
        raise SystemExit(str(e))
    if batch is None:
        batch = cfg["batch_size"]
    _, val_ds = build_datasets(cfg)
    val_loader = Loader(val_ds, batch_size=batch, shuffle=False,
                        max_annots=cfg["max_annots"], workers=cfg["workers"])
    metric = MeanAveragePrecision(cfg["num_classes"], cfg["input_size"])
    for b in val_loader:
        n_valid = b.pop("n_valid", b["img"].shape[0])
        dets, valid = run(prepare_input(b["img"]))
        metric.update_state(b["annot"][:n_valid], dets[:n_valid],
                            valid[:n_valid])
    val_map = metric.result()
    print(f"artifact val_mAP: {val_map:.5f}  ({artifact}, batch {batch})")
    if report_dir:
        from podtpu_torch.metrics.plots import write_eval_report

        paths = write_eval_report(metric, class_names(cfg), report_dir,
                                  cfg.get("conf_threshold", 0.25))
        print(f"report: {paths}")
    return {"val_mAP": val_map}


def main(argv=None):
    ap = argparse.ArgumentParser()
    add_common_args(ap, "score an exported serving artifact")
    ap.add_argument("--report", type=str, default=None,
                    help="write per-class AP table + PR curves + confusion "
                         "matrix to this directory")
    ap.add_argument("--quantize", type=str, default=None, choices=["int8"],
                    help="evaluate the int8-PTQ model (accuracy-delta check "
                         "for the quantized serving artifact)")
    ap.add_argument("--calib-batches", type=int, default=4)
    ap.add_argument("--use-ema", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="evaluate the checkpoint's EMA shadow weights "
                         "(default: auto — EMA when the config's ema.eval "
                         "is on, matching how `best` was selected)")
    args = ap.parse_args(argv)
    if args.artifact and (args.ckpt or args.quantize):
        ap.error("--artifact evaluates the exported graph as-is; "
                 "--ckpt/--quantize apply to checkpoint evaluation")
    if args.artifact:
        return evaluate_artifact(get_configs(args.cfg), args.artifact,
                                 args.report, device=args.device)
    return evaluate(get_configs(args.cfg), args.ckpt, args.report,
                    device=args.device, quantize=args.quantize,
                    use_ema=args.use_ema, calib_batches=args.calib_batches)


if __name__ == "__main__":
    main()
