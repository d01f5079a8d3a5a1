"""Export a model to a ``torch.export`` artifact, a TFLite file or a TF
SavedModel (the port's ``export_model.py``; torch2onnx.py analog).

    python -m podtpu_torch.cli.export_model --cfg configs/yolov3_voc.yaml \\
        [--ckpt ...] --out model.pt2 [--inspect] [--device cpu]
    python -m podtpu_torch.cli.export_model --cfg ... --format tflite \\
        --with-postprocess --out model.tflite [--fold-bn] [--device cpu] \\
        [--quantize dynamic|int8 [--calib-batches N]]
    python -m podtpu_torch.cli.export_model --cfg ... --format savedmodel \\
        --with-postprocess --out model.savedmodel [--device cpu]

Options beyond the forward graph:
  --with-postprocess   the full serving unit, forward + decode + NMS (the
                       suppression kernel stays one operator of the graph)
  --fold-bn            fold BN statistics into the conv kernels first
  --validate-npu       check the artifact's operators against the NPU
                       whitelist and fail on any other
  --annotate out.json  write the sanitized per-layer annotation map
  --quantize int8      static PTQ calibrated on val batches
                       (--calib-batches): int8 convs in a .pt2; with
                       --format tflite a full-integer int8 file (the model
                       stays float and the file is calibrated)
  --quantize dynamic   TFLite's dynamic range (int8 filters, float
                       compute); --format tflite only
  --batch N|dyn        the batch; ``dyn`` exports a symbolic one (pt2 only)
  --format             pt2 (``torch.export``), tflite (a flatbuffer
                       written by ``export/tflite.py``) or savedmodel (a
                       directory of ``saved_model.pb`` written by
                       ``export/savedmodel.py``, float32)

A ``.pt2`` runs on the device it was exported on (``--device``, default
cuda); a ``.tflite`` or a SavedModel is device-free, and the port's
readers run it where their caller says (an int8 file is calibrated by the
reader on ``--device``). ``--format tflite`` and ``savedmodel`` refuse
``--batch dyn`` (as ``podtpu``), ``savedmodel`` refuses ``--quantize``
(as ``podtpu``), and ``--quantize`` refuses ``--batch dyn`` for any
format.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from podtpu_torch.config import get_configs


def _calibration_batches(cfg: dict, shape, n: int) -> list[np.ndarray]:
    """Calibration inputs for PTQ: real validation images when the cfg
    has data lists, else seeded uniform noise (with a warning: the scales
    are then crude)."""
    try:
        from podtpu_torch.data.dataset import build_datasets
        from podtpu_torch.data.loader import Loader

        _, val_ds = build_datasets(cfg)
        loader = Loader(val_ds, batch_size=shape[0], shuffle=False,
                        max_annots=cfg.get("max_annots", 64), workers=1)
        out = []
        for batch in loader:
            x = np.asarray(batch["img"])
            if x.dtype == np.uint8:
                x = x.astype(np.float32) / 255.0
            out.append(x)
            if len(out) >= n:
                break
        if out:
            return out
    except Exception as e:  # noqa: BLE001 — fall back to noise
        print(f"calibration loader unavailable ({e}); using uniform noise")
    rng = np.random.default_rng(0)
    return [rng.uniform(0, 1, shape).astype(np.float32) for _ in range(n)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cfg", required=True, type=str)
    ap.add_argument("--ckpt", type=str, default=None)
    ap.add_argument("--use-ema", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="export the checkpoint's EMA shadow weights "
                         "(default: auto, as cli.test picks them)")
    ap.add_argument("--out", type=str, default=None,
                    help="the artifact's path (default model.pt2, "
                         "model.tflite or model.savedmodel by --format)")
    ap.add_argument("--batch", type=str, default="1",
                    help="batch size; 'dyn' exports a symbolic batch "
                         "dimension (one artifact serves any batch)")
    ap.add_argument("--inspect", action="store_true")
    ap.add_argument("--with-postprocess", action="store_true",
                    help="export fwd+decode+NMS serving graph")
    ap.add_argument("--fold-bn", action="store_true",
                    help="fold BN into conv kernels before export")
    ap.add_argument("--validate-npu", action="store_true",
                    help="fail if the artifact uses non-whitelisted ops")
    ap.add_argument("--annotate", type=str, default=None,
                    help="write per-layer annotation map to this json")
    ap.add_argument("--format", type=str, default="pt2",
                    choices=["pt2", "tflite", "savedmodel"])
    ap.add_argument("--quantize", type=str, default=None,
                    choices=["int8", "dynamic"],
                    help="int8: static PTQ (int8 convs in a .pt2, a "
                         "full-integer .tflite); dynamic: TFLite's dynamic "
                         "range (int8 filters, float compute)")
    ap.add_argument("--calib-batches", type=int, default=8,
                    help="calibration batches for --quantize")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device the artifact runs on (default cuda; "
                         "cpu for local runs)")
    args = ap.parse_args(argv)
    if args.out is None:
        args.out = f"model.{args.format}"
    if args.format in ("tflite", "savedmodel"):
        if args.format == "savedmodel" and args.quantize:
            ap.error("--quantize applies to --format tflite/pt2 (a "
                     "SavedModel is float32)")
        if args.batch == "dyn":
            ap.error(f"--batch dyn is not supported for --format "
                     f"{args.format} (it takes a static batch)")
        if args.annotate or args.validate_npu:
            ap.error("--annotate / --validate-npu read a .pt2 artifact")
    if args.quantize == "dynamic" and args.format != "tflite":
        ap.error("--quantize dynamic is tflite-only (--format tflite)")
    if args.batch == "dyn" and args.quantize:
        ap.error("--batch dyn is incompatible with --quantize "
                 "(calibration batches are concrete)")

    from podtpu_torch.cli import eval_trainer
    from podtpu_torch.export.program import (
        export_program,
        export_serving,
        inspect_exported,
    )

    cfg = get_configs(args.cfg)
    model = eval_trainer(cfg, args.ckpt, args.device,
                         use_ema=args.use_ema).state.model.eval()
    if args.fold_bn:
        from podtpu_torch.export.npu import fold_batchnorm

        model.load_state_dict(fold_batchnorm(model.state_dict()))
        print("folded BN stats into conv kernels")
    batch = None if args.batch == "dyn" else int(args.batch)
    shape = (batch, cfg["input_size"], cfg["input_size"],
             cfg.get("in_channels", 3))
    rep = None
    if args.quantize == "int8":
        rep = _calibration_batches(cfg, shape, args.calib_batches)
        print(f"int8 PTQ: calibrated on {len(rep)} batches")
    if args.format == "savedmodel":
        from podtpu_torch.export.savedmodel import (
            export_savedmodel,
            inspect_savedmodel,
        )

        path = export_savedmodel(model, cfg, shape, args.out,
                                 with_postprocess=args.with_postprocess)
        print(f"exported to {path}")
        if args.inspect:
            print(json.dumps(inspect_savedmodel(path), indent=2))
        return path
    if args.format == "tflite":
        from podtpu_torch.export.tflite import export_tflite, inspect_tflite

        # the model stays float: the file is quantized from its float graph
        path = export_tflite(model, cfg, shape, args.out,
                             with_postprocess=args.with_postprocess,
                             quantize=args.quantize, rep_batches=rep)
        print(f"exported to {path}")
        if args.inspect:
            print(json.dumps(inspect_tflite(path), indent=2))
        return path
    if rep is not None:
        from podtpu_torch.export.quantize import quantize_for_serving

        quantize_for_serving(model, rep)
    if args.with_postprocess:
        path = export_serving(model, cfg, shape, args.out)
    else:
        path = export_program(model, shape, args.out)
    print(f"exported to {path}")
    if args.annotate:
        from podtpu_torch.export.npu import annotate_for_npu

        info = annotate_for_npu(path, args.annotate)
        print(f"annotated {info['num_layers']} layers -> {args.annotate}")
    if args.validate_npu:
        from podtpu_torch.export.npu import validate_for_npu

        report = validate_for_npu(path)  # raises on unsupported ops
        print(f"NPU validation ok: {len(report['ops'])} distinct ops, "
              "all whitelisted")
    if args.inspect:
        print(json.dumps(inspect_exported(path), indent=2))
    return path


if __name__ == "__main__":
    main()
