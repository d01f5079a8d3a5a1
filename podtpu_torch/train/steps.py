"""Train step and serving graph (``podtpu/train/steps.py``).

* ``make_train_step``: train-mode forward (the fused stem's kernels on the
  card), target encoding and loss, backward and the optimizer update, all
  on the batch's device.
* ``make_serve_fn``: image batch -> detections. The whole postprocess stays
  on the batch's device: decode + padded NMS (whose suppression is the
  CUDA kernel on the card); only the [B, max_det, 6] survivors leave it.

The eval step belongs to the eval slice.
"""

from __future__ import annotations

from typing import Callable

import torch

from podtpu_torch.losses import build_loss
from podtpu_torch.ops.decode import decode_yolov3, layer_anchors
from podtpu_torch.ops.nms import batched_class_aware_nms


def _as_input(img: torch.Tensor) -> torch.Tensor:
    """Accept uint8 batches (the host ships raw bytes; 4x less to copy) or
    pre-normalized floats."""
    if img.dtype == torch.uint8:
        return img.float() / 255.0
    return img


def make_decoder(cfg: dict) -> Callable:
    """Config -> fn(raw head outputs) -> [B, N, 6] candidates."""
    name = cfg["model"]
    if name != "yolov3":
        raise NotImplementedError(f"decoding '{name}' is not ported yet "
                                  "(ROADMAP.md queue 1, other families)")
    num_classes = cfg["num_classes"]
    input_size = cfg["input_size"]
    anchors = cfg["anchors"]
    cache: dict = {}  # (device, layer shapes) -> per-layer grid anchors

    def decode(preds):
        key = (preds[0].device, tuple(tuple(p.shape[1:3]) for p in preds))
        if key not in cache:
            cache[key] = layer_anchors(anchors, key[1], input_size,
                                       device=key[0])
        return decode_yolov3(preds, num_classes, anchors, input_size,
                             anchors_grid=cache[key])

    return decode


def _decoder_and_nms(cfg: dict) -> tuple[Callable, Callable]:
    """The two halves of the deployment postprocess: raw preds -> [B, N, 6]
    candidates, and candidates -> padded NMS survivors."""
    nopts = cfg.get("nms_options") or {}
    unported = [k for k in ("multi_label", "merge", "agnostic", "classes",
                            "backend") if nopts.get(k)]
    if unported:
        raise NotImplementedError(
            f"nms_options {unported} are not ported yet (ROADMAP.md queue 1, "
            "eval slice); the port picks its suppression by device")
    decoder = make_decoder(cfg)
    conf_t = float(cfg.get("conf_threshold", 0.25))
    iou_t = float(cfg.get("nms_iou_threshold", 0.45))
    top_k = int(cfg.get("top_k_candidates", 512))
    max_det = int(cfg.get("max_detections", 100))

    def nms(boxes):
        return batched_class_aware_nms(boxes, conf_t, iou_t, top_k=top_k,
                                       max_detections=max_det)

    return decoder, nms


def make_postprocess(cfg: dict) -> Callable:
    """Config -> fn(raw preds) -> (dets [B, max_det, 6], valid [B, max_det])."""
    decoder, nms = _decoder_and_nms(cfg)

    def postprocess(preds):
        return nms(decoder(preds))

    return postprocess


def make_serve_fn(cfg: dict, apply_fn: Callable) -> Callable:
    """The deployment graph: image batch -> (dets, valid).

    ``apply_fn(x) -> raw preds`` is the frozen-weights forward."""
    if cfg.get("tta"):
        raise NotImplementedError("tta is not ported yet (ROADMAP.md queue "
                                  "1, eval slice)")
    decoder, nms = _decoder_and_nms(cfg)

    @torch.inference_mode()
    def serve(x):
        return nms(decoder(apply_fn(x)))

    return serve


def make_train_step(cfg: dict) -> Callable:
    """``(state, batch) -> (state, {"loss"})`` for a
    :class:`podtpu_torch.train.state.TrainState`, updated in place.

    ``batch``: ``{"img": [B, H, W, 3] uint8 or float, "annot": [B, T, 5]}``
    on the model's device. The BN running statistics move in the forward,
    from the batch statistics of the parameters before the update."""
    unported = [k for k in ("device_augment", "device_geom", "remat_policy",
                            "remat_backbone", "ema") if cfg.get(k)]
    if int(cfg.get("steps_per_dispatch") or 1) > 1:
        unported.append("steps_per_dispatch")
    if unported:
        raise NotImplementedError(f"{unported} not ported yet (ROADMAP.md "
                                  "queue 1, train-step options)")
    loss_fn = build_loss(cfg)

    def train_step(state, batch):
        model = state.model
        model.train()
        preds = model(_as_input(batch["img"]))
        loss = loss_fn(preds, batch["annot"])
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.apply_gradients()
        return state, {"loss": loss.detach()}

    return train_step
