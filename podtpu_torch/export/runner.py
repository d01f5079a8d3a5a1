"""Load-and-run helper for exported serving artifacts
(``podtpu/export/runner.py``).

One place that knows how to run a ``--with-postprocess`` export and hand
back ``(dets [B, M, 6], valid [B, M])`` as numpy arrays: ``cli.test
--artifact`` (the val mAP of the deployed graph), ``cli.inference``,
``cli.make_pred_file``, ``cli.yolo2coco_pred_file`` and
``cli.make_video``. Artifacts are ``torch.export`` programs (``.pt2``,
``export/program.py``), which run on the device they were exported on,
and TFLite files (``.tflite``, ``export/tflite.py``: float32, dynamic
range or int8), which the port's reader runs on the device it is given
(the card by default).

A TF SavedModel is not ported: it is a TensorFlow ``GraphDef`` run by the
TensorFlow runtime, which the port does not import. A ``.savedmodel`` path
raises ``NotImplementedError`` saying so.
"""

from __future__ import annotations

import numpy as np
import torch

TFLITE_UNPORTED = (
    "SavedModel artifacts are not ported: a SavedModel is a TensorFlow "
    "GraphDef run by the TensorFlow runtime, which the port does not import "
    "(ROADMAP.md queue 1, item 10c); export a .tflite (float32, dynamic or "
    "int8) or a torch.export program (.pt2) instead")


def _not_serving(artifact: str, outs) -> ValueError:
    return ValueError(f"{artifact} is not a serving artifact (outputs: "
                      f"{outs}); re-export with --with-postprocess")


def artifact_device(artifact: str, device=None) -> torch.device:
    """Where an artifact runs: a ``.pt2`` on the device it was exported
    on, a ``.tflite`` on ``device`` (default cuda)."""
    if artifact.endswith(".tflite"):
        return torch.device(device or "cuda")
    from podtpu_torch.export.program import read_meta

    return torch.device(read_meta(artifact).get("device", "cpu"))


def artifact_runner(artifact: str, device=None):
    """``(run, batch_size)`` where ``run(x) -> (dets, valid)`` (numpy).

    ``batch_size`` is ``None`` for a symbolic-batch export
    (``export_model --batch dyn``): the artifact then takes any leading
    dimension and the caller picks. Rejects a forward-only export (no
    decode + NMS inside) with a ``ValueError`` telling the user to
    re-export ``--with-postprocess``. ``device`` is where a ``.tflite``
    runs (:func:`artifact_device`)."""
    if artifact.endswith(".savedmodel"):
        raise NotImplementedError(TFLITE_UNPORTED)
    if artifact.endswith(".tflite"):
        return _tflite_runner(artifact, artifact_device(artifact, device))
    from podtpu_torch.export.program import (
        inspect_program,
        load_program,
        read_meta,
    )

    meta = read_meta(artifact)
    ep = load_program(artifact)
    outs = inspect_program(ep)["out_specs"]
    if meta.get("kind", "serving") != "serving" or len(outs) != 2:
        raise _not_serving(artifact, outs)
    module = ep.module()
    dev = torch.device(meta.get("device", "cpu"))

    @torch.inference_mode()
    def run(x):
        dets, valid = module(torch.as_tensor(np.asarray(x)).to(dev))
        return dets.cpu().numpy(), valid.cpu().numpy().astype(bool)

    return run, meta.get("batch")


def _tflite_runner(artifact: str, dev: torch.device):
    from podtpu_torch.export.tflite import load_tflite

    prog = load_tflite(artifact, dev)
    if prog.meta.get("kind", "serving") != "serving" or \
            len(prog.out_specs) != 2:
        raise _not_serving(artifact, prog.out_specs)

    def run(x):
        dets, valid = prog(torch.as_tensor(np.asarray(x)))
        return dets.cpu().numpy(), valid.cpu().numpy().astype(bool)

    return run, prog.batch


def prepare_input(x: np.ndarray) -> np.ndarray:
    """The artifact input contract: float32 in [0, 1] (exports trace a
    float input; loaders may ship uint8 batches)."""
    x = np.asarray(x)
    if x.dtype == np.uint8:
        return x.astype(np.float32) / 255.0
    return x
