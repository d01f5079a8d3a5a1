"""Load-and-run helper for exported serving artifacts
(``podtpu/export/runner.py``).

One place that knows how to run a ``--with-postprocess`` export and hand
back ``(dets [B, M, 6], valid [B, M])`` as numpy arrays: ``cli.test
--artifact`` (the val mAP of the deployed graph), ``cli.inference``,
``cli.make_pred_file``, ``cli.yolo2coco_pred_file`` and
``cli.make_video``. Artifacts are ``torch.export`` programs (``.pt2``,
``export/program.py``) and run on the device they were exported on.

``podtpu``'s other artifact, a TFLite flatbuffer, has no converter here:
the port imports no JAX or TensorFlow, and no package that converts a
torch program to TFLite is installed. A ``.tflite`` path raises
``NotImplementedError`` saying so.
"""

from __future__ import annotations

import numpy as np
import torch

TFLITE_UNPORTED = (
    "TFLite and SavedModel artifacts are not ported: the port has no "
    "TFLite converter (it imports neither JAX's jax2tf nor TensorFlow, and "
    "no torch-to-TFLite converter is installed); export a torch.export "
    "program (.pt2) instead (ROADMAP.md queue 1, item 10)")


def artifact_runner(artifact: str):
    """``(run, batch_size)`` where ``run(x) -> (dets, valid)`` (numpy).

    ``batch_size`` is ``None`` for a symbolic-batch export
    (``export_model --batch dyn``): the artifact then takes any leading
    dimension and the caller picks. Rejects a forward-only export (no
    decode + NMS inside) with a ``ValueError`` telling the user to
    re-export ``--with-postprocess``."""
    if artifact.endswith((".tflite", ".savedmodel")):
        raise NotImplementedError(TFLITE_UNPORTED)
    from podtpu_torch.export.program import (
        inspect_program,
        load_program,
        read_meta,
    )

    meta = read_meta(artifact)
    ep = load_program(artifact)
    outs = inspect_program(ep)["out_specs"]
    if meta.get("kind", "serving") != "serving" or len(outs) != 2:
        raise ValueError(
            f"{artifact} is not a serving artifact (outputs: {outs}); "
            "re-export with --with-postprocess")
    module = ep.module()
    dev = torch.device(meta.get("device", "cpu"))

    @torch.inference_mode()
    def run(x):
        dets, valid = module(torch.as_tensor(np.asarray(x)).to(dev))
        return dets.cpu().numpy(), valid.cpu().numpy().astype(bool)

    return run, meta.get("batch")


def prepare_input(x: np.ndarray) -> np.ndarray:
    """The artifact input contract: float32 in [0, 1] (exports trace a
    float input; loaders may ship uint8 batches)."""
    x = np.asarray(x)
    if x.dtype == np.uint8:
        return x.astype(np.float32) / 255.0
    return x
