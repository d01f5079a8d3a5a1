"""Train step and serving graph (``podtpu/train/steps.py``).

* ``make_train_step``: train-mode forward (the fused stem's kernels on the
  card), target encoding and loss, backward and the optimizer update, all
  on the batch's device; ``make_multi_train_step``: K of them over a
  stacked group of batches with no host synchronisation between them
  (cfg ``steps_per_dispatch``).
* ``make_serve_fn``: image batch -> detections. The whole postprocess stays
  on the batch's device: decode + padded NMS (whose suppression is the
  CUDA kernel on the card); only the [B, max_det, 6] survivors leave it.
* ``make_eval_step``: eval-mode forward + loss + the serving postprocess;
  the host mAP (``metrics/map.py``) takes the survivors after ``.cpu()``.
* ``make_stats_step``: a train-mode forward without a backward that returns
  the batch's BN statistics (the SWA recalibration pass); on the card the
  fused stem launches its two forward kernels and nothing else.
"""

from __future__ import annotations

from typing import Callable

import torch

from podtpu_torch.losses import build_loss
from podtpu_torch.models.layers import BatchNormMixed, SeededDropout
from podtpu_torch.ops.decode import (
    decode_yolov1,
    decode_yolov2,
    decode_yolov3,
    layer_anchors,
)
from podtpu_torch.ops.nms import batched_class_aware_nms
from podtpu_torch.ops.retina import decode_retinanet


def _as_input(img: torch.Tensor) -> torch.Tensor:
    """Accept uint8 batches (the host ships raw bytes; 4x less to copy) or
    pre-normalized floats."""
    if img.dtype == torch.uint8:
        return img.float() / 255.0
    return img


def make_decoder(cfg: dict) -> Callable:
    """Config -> fn(raw head output(s)) -> [B, N, 6] candidates: one tensor
    for yolov1 and yolov2, the tuple of three heads for yolov3, yolov4-tiny
    and yolov4 (all three through ``decode_yolov3``), the five (cls, box)
    levels for retinanet (its anchors cached per device by
    ``ops/retina.py``)."""
    name = cfg["model"]
    num_classes = cfg["num_classes"]
    input_size = cfg["input_size"]
    if name == "retinanet":
        return lambda preds: decode_retinanet(preds, num_classes, input_size)
    if name == "yolov1":
        num_boxes = cfg["num_boxes"]
        return lambda pred: decode_yolov1(pred, num_classes, num_boxes,
                                          input_size)
    if name == "yolov2":
        scaled = cfg["scaled_anchors"]
        on_device: dict = {}  # device -> the anchors as a tensor there

        def decode_v2(pred):
            if pred.device not in on_device:
                on_device[pred.device] = torch.tensor(
                    scaled, dtype=torch.float32, device=pred.device)
            return decode_yolov2(pred, num_classes, on_device[pred.device],
                                 input_size)

        return decode_v2
    if name not in ("yolov3", "yolov4-tiny", "yolov4"):
        raise ValueError(f"unknown model '{name}'")
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
    if cfg["model"] == "yolov1" and nopts.get("multi_label"):
        raise ValueError("multi_label needs per-box class scores; the "
                         "yolov1 head predicts one class set per cell")
    if cfg["model"] == "retinanet" and nopts.get("multi_label"):
        raise ValueError("multi_label is a YOLO-head option; the "
                         "retinanet decoder is per-anchor single-label")
    unported = [k for k in ("multi_label", "merge", "agnostic", "classes",
                            "backend") if nopts.get(k)]
    if unported:
        raise NotImplementedError(
            f"nms_options {unported} are not ported yet (ROADMAP.md queue 1, "
            "item 4: the rest of NMS); the port picks its suppression by device")
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


def make_serve_fn(cfg: dict, apply_fn: Callable,
                  with_preds: bool = False) -> Callable:
    """The deployment graph: image batch -> (dets, valid).

    ``apply_fn(x) -> raw preds`` is the frozen-weights forward.
    ``with_preds=True`` also returns the raw preds first (the eval step
    computes its loss on them)."""
    if cfg.get("tta"):
        raise NotImplementedError("tta is not ported yet (ROADMAP.md queue "
                                  "1, item 4: the rest of NMS, and TTA)")
    decoder, nms = _decoder_and_nms(cfg)

    @torch.inference_mode()
    def serve(x):
        preds = apply_fn(x)
        dets, valid = nms(decoder(preds))
        if with_preds:
            return preds, dets, valid
        return dets, valid

    return serve


def make_eval_step(cfg: dict, extra_variables: dict | None = None
                   ) -> Callable:
    """``(state, batch) -> (loss, dets [B, max_det, 6], valid [B, max_det])``
    on the batch's device: the model in eval mode (BN running statistics;
    the train-mode fused stem is never reached) under
    ``torch.inference_mode()``, the serving postprocess, and the loss on
    the same raw preds. Detections are input-pixel cxcywh + conf + class,
    score-sorted. The state is left as it was, its train/eval mode
    included."""
    if extra_variables:
        raise NotImplementedError("extra_variables (int8 quantized eval) is "
                                  "not ported yet (ROADMAP.md queue 1, item "
                                  "10: export)")
    loss_fn = build_loss(cfg)
    current: list = [None]  # the model of the call in progress
    serve = make_serve_fn(cfg, lambda x: current[0](x), with_preds=True)

    def eval_step(state, batch):
        model = state.model
        was_training = model.training
        model.eval()
        current[0] = model
        try:
            preds, dets, valid = serve(_as_input(batch["img"]))
            with torch.inference_mode():
                loss = loss_fn(preds, batch["annot"])
        finally:
            current[0] = None
            model.train(was_training)
        return loss, dets, valid

    return eval_step


def make_stats_step(cfg: dict) -> Callable:
    """Forward-only BN-statistics step for SWA recalibration:
    ``(state, batch) -> {state_dict key: tensor}``, each BatchNorm's
    ``running_mean`` / ``running_var`` key mapped to THIS batch's mean and
    unbiased (Bessel) variance, float32 on the model's device.

    The model runs in train mode under ``torch.no_grad()``; each BN layer
    hands its batch statistics to a sink in place of its running update.
    ``podtpu`` recovers the same numbers by inverting the EWMA,
    ``(new - m * old) / (1 - m)``; taking them directly skips that
    tenfold amplification of float32 rounding. The state is left as it
    was: parameters, buffers and each module's train/eval flag."""
    if cfg.get("device_geom"):
        raise NotImplementedError("device_geom is not ported yet (ROADMAP.md "
                                  "queue 1, item 8: device augmentation)")

    def stats_step(state, batch):
        model = state.model
        modes = [(m, m.training) for m in model.modules()]
        raw: dict = {}
        bns = [(name, m) for name, m in model.named_modules()
               if isinstance(m, BatchNormMixed)]

        def sink_for(name):
            def sink(mean, var):
                raw[f"{name}.running_mean"] = mean
                raw[f"{name}.running_var"] = var
            return sink

        try:
            for name, m in bns:
                m.stats_sink = sink_for(name)
            model.train()
            with torch.no_grad():
                model(_as_input(batch["img"]))
        finally:
            for _, m in bns:
                m.stats_sink = None
            for m, training in modes:
                m.training = training
        if len(raw) != 2 * len(bns):
            raise RuntimeError(f"{len(bns) - len(raw) // 2} BatchNorm layers "
                               "gave no batch statistics")
        return raw

    return stats_step


# cfg options of podtpu's train step that the port does not run yet
_UNPORTED_STEP = {
    "device_augment": "item 8: device augmentation",
    "device_geom": "item 8: device augmentation",
    "remat_policy": "item 6: train-step options",
    "remat_backbone": "item 6: train-step options",
    "ema": "item 6: train-step options",
}


def make_train_step(cfg: dict) -> Callable:
    """``(state, batch) -> (state, {"loss"})`` for a
    :class:`podtpu_torch.train.state.TrainState`, updated in place.

    ``batch``: ``{"img": [B, H, W, 3] uint8 or float, "annot": [B, T, 5]}``
    on the model's device. The BN running statistics move in the forward,
    from the batch statistics of the parameters before the update."""
    unported = [k for k in _UNPORTED_STEP if cfg.get(k)]
    if unported:
        raise NotImplementedError(
            f"{unported} not ported yet (ROADMAP.md queue 1, "
            + "; ".join(sorted({_UNPORTED_STEP[k] for k in unported})) + ")")
    loss_fn = build_loss(cfg)
    seed = int(cfg.get("seed", 0))

    def train_step(state, batch):
        model = state.model
        model.train()
        # dropout masks from (seed, step), as podtpu folds the step into
        # its dropout key: a resumed run draws the masks it would have
        for m in model.modules():
            if isinstance(m, SeededDropout):
                m.reseed((seed << 32) + state.step)
        preds = model(_as_input(batch["img"]))
        loss = loss_fn(preds, batch["annot"])
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.apply_gradients()
        return state, {"loss": loss.detach()}

    return train_step


def make_multi_train_step(cfg: dict) -> Callable:
    """K train steps in one call (cfg ``steps_per_dispatch: K``):
    ``(state, batches) -> (state, {"loss": [K]})`` over a ``[K, B, ...]``
    stacked group of batches already on the model's device.

    The semantics are those of K sequential ``train_step`` calls on the
    same batches: each step sets the schedule's lr for its own update and
    advances the step counter, and the BN running statistics move in each
    forward. The losses stay on the device: nothing in the group waits for
    the card, so the host queues all K steps and is free for the next
    group's batches. (``podtpu`` scans the steps in one compiled program;
    here each step's kernels are queued as the single step queues them.)"""
    step = make_train_step(cfg)

    def multi_step(state, batches):
        k = int(next(iter(batches.values())).shape[0])
        losses = []
        for i in range(k):
            state, m = step(state, {name: v[i] for name, v in batches.items()})
            losses.append(m["loss"])
        return state, {"loss": torch.stack(losses)}

    return multi_step
