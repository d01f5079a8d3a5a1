"""Train step and serving graph (``podtpu/train/steps.py``).

* ``make_train_step``: train-mode forward (the fused stem's kernels on the
  card), target encoding and loss, backward and the optimizer update, all
  on the batch's device; ``make_multi_train_step``: K of them over a
  stacked group of batches (cfg ``steps_per_dispatch``). With cfg
  ``device_geom`` / ``device_augment`` the step first warps and jitters
  the batch on its device (``data/device_aug.py``). The step honours
  ``podtpu``'s options: ``remat_policy`` (``models/layers.py``),
  ``optimizer_options.skip_nonfinite`` (the update and the BN statistics
  of a non-finite step dropped), ``accum_steps`` (``train/state.py``) and
  ``ema`` (the shadow blended after each update).
* ``make_serve_fn``: image batch -> detections. The whole postprocess stays
  on the batch's device: decode + padded NMS (whose suppression is the
  CUDA kernel on the card); only the [B, max_det, 6] survivors leave it.
  cfg ``nms_options`` (``multi_label``, ``merge``, ``agnostic``,
  ``classes``, ``backend``) and ``tta`` (flipped and down-scaled forwards,
  their candidates joined before the one NMS) as in ``podtpu``.
* ``make_eval_step``: eval-mode forward + loss + the serving postprocess;
  the host mAP (``metrics/map.py``) takes the survivors after ``.cpu()``.
* ``make_stats_step``: a train-mode forward without a backward that returns
  the batch's BN statistics (the SWA recalibration pass); on the card the
  fused stem launches its two forward kernels and nothing else.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from podtpu_torch.data.device_aug import make_device_augment, separable_affine
from podtpu_torch.losses import build_loss
from podtpu_torch.models.layers import (
    REMAT_POLICIES,
    BatchNormMixed,
    SeededDropout,
    remat_scope,
)
from podtpu_torch.ops.decode import (
    decode_yolov1,
    decode_yolov2,
    decode_yolov3,
    layer_anchors,
)
from podtpu_torch.ops.nms import batched_class_aware_nms
from podtpu_torch.ops.retina import decode_retinanet
from podtpu_torch.parallel.layouts import (
    layout_scope,
    model_axis_params,
    space_rows,
)
from podtpu_torch.parallel.mesh import (
    agree_all,
    average_gradients,
    global_rows,
    gradients_of,
    local_tensors,
)
from podtpu_torch.train.optim import all_finite, skip_nonfinite


def _as_input(img: torch.Tensor) -> torch.Tensor:
    """Accept uint8 batches (the host ships raw bytes; 4x less to copy) or
    pre-normalized floats."""
    if img.dtype == torch.uint8:
        return img.float() / 255.0
    return img


def make_decoder(cfg: dict, multi_label: bool = False) -> Callable:
    """Config -> fn(raw head output(s)) -> [B, N, 6] candidates: one tensor
    for yolov1 and yolov2, the tuple of three heads for yolov3, yolov4-tiny
    and yolov4 (all three through ``decode_yolov3``), the five (cls, box)
    levels for retinanet (its anchors cached per device by
    ``ops/retina.py``). ``multi_label``: one candidate per (anchor, class)
    (the anchor heads only)."""
    name = cfg["model"]
    num_classes = cfg["num_classes"]
    input_size = cfg["input_size"]
    if name == "retinanet":
        if multi_label:
            raise ValueError("multi_label is a YOLO-head option; the "
                             "retinanet decoder is per-anchor single-label")
        return lambda preds: decode_retinanet(preds, num_classes, input_size)
    if name == "yolov1":
        if multi_label:
            raise ValueError("multi_label needs per-box class scores; the "
                             "yolov1 head predicts one class set per cell")
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
                                 input_size, multi_label=multi_label)

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
                             anchors_grid=cache[key], multi_label=multi_label)

    return decode


def _decoder_and_nms(cfg: dict) -> tuple[Callable, Callable]:
    """The two halves of the deployment postprocess: raw preds -> [B, N, 6]
    candidates, and candidates -> padded NMS survivors."""
    nopts = cfg.get("nms_options") or {}
    decoder = make_decoder(cfg, multi_label=bool(nopts.get("multi_label")))
    conf_t = float(cfg.get("conf_threshold", 0.25))
    iou_t = float(cfg.get("nms_iou_threshold", 0.45))
    top_k = int(cfg.get("top_k_candidates", 512))
    max_det = int(cfg.get("max_detections", 100))
    merge = bool(nopts.get("merge"))
    agnostic = bool(nopts.get("agnostic"))
    classes = nopts.get("classes")
    classes = tuple(int(c) for c in classes) if classes else None
    # podtpu's backend names are checked; the boxes' device picks the
    # suppression (the CUDA kernel on the card)
    backend = nopts.get("backend")

    def nms(boxes):
        return batched_class_aware_nms(
            boxes, conf_t, iou_t, top_k=top_k, max_detections=max_det,
            backend=backend, agnostic=agnostic, merge=merge, classes=classes)

    return decoder, nms


def make_postprocess(cfg: dict) -> Callable:
    """Config -> fn(raw preds) -> (dets [B, max_det, 6], valid [B, max_det])."""
    decoder, nms = _decoder_and_nms(cfg)

    def postprocess(preds):
        return nms(decoder(preds))

    return postprocess


def tta_options(cfg: dict) -> dict | None:
    """cfg ``tta`` -> ``{"hflip": bool, "scales": tuple}`` (None = off).
    ``tta: true`` is the flipped forward alone; a mapping sets ``hflip``
    (default on) and ``scales``, each in (0, 1] (1.0 is dropped: it is the
    plain forward)."""
    t = cfg.get("tta")
    if not t:
        return None
    t = dict(t) if isinstance(t, dict) else {}
    scales = tuple(float(s) for s in (t.get("scales") or ())
                   if float(s) != 1.0)
    if any(not 0.0 < s <= 1.0 for s in scales):
        raise ValueError(f"tta.scales must be in (0, 1]: same-canvas "
                         f"downscale branches (got {scales})")
    return {"hflip": bool(t.get("hflip", True)), "scales": scales}


def _scaled_canvas(x: torch.Tensor, hs: int, ws: int) -> torch.Tensor:
    """The NHWC batch resized to (hs, ws) (bilinear, antialiased as
    ``jax.image.resize`` shrinks) in the top-left of a same-size canvas
    filled with 0.447."""
    small = F.interpolate(x.permute(0, 3, 1, 2), size=(hs, ws),
                          mode="bilinear", align_corners=False,
                          antialias=True).permute(0, 2, 3, 1)
    canvas = torch.full_like(x, 0.447)
    canvas[:, :hs, :ws, :] = small
    return canvas


def make_candidates_fn(cfg: dict, apply_fn: Callable,
                       decoder: Callable) -> Callable:
    """``x -> (raw preds, candidates [B, N, 6])``: the plain forward's raw
    preds and the candidates ``decoder`` makes of them, which go into the
    NMS. With cfg ``tta`` the candidates of the flipped forward (cx
    mirrored to W - cx) and of each scale (the batch shrunk into the
    top-left of a gray canvas, each axis rescaled back by its exact
    ratio) join the plain ones."""
    tta = tta_options(cfg)
    size = float(cfg["input_size"])

    def candidates(x):
        preds = apply_fn(x)
        boxes = decoder(preds)
        if tta is None:
            return preds, boxes
        extra = []
        if tta["hflip"]:
            flipped = decoder(apply_fn(torch.flip(x, dims=(2,))))
            flipped[..., 0] = size - flipped[..., 0]
            extra.append(flipped)
        h, w = x.shape[1], x.shape[2]
        for s in tta["scales"]:
            hs, ws = max(1, round(h * s)), max(1, round(w * s))
            cands = decoder(apply_fn(_scaled_canvas(x, hs, ws)))
            sx, sy = w / ws, h / hs
            cands[..., 0] *= sx
            cands[..., 2] *= sx
            cands[..., 1] *= sy
            cands[..., 3] *= sy
            extra.append(cands)
        if extra:
            boxes = torch.cat([boxes] + extra, dim=1)
        return preds, boxes

    return candidates


def make_serving_graph(cfg: dict, apply_fn: Callable,
                       with_preds: bool = False) -> Callable:
    """The deployment graph: image batch -> (dets, valid), with no grad
    mode of its own (what ``export/program.py`` traces; no host read of a
    tensor, so it exports whole).

    ``apply_fn(x) -> raw preds`` is the frozen-weights forward; the
    candidates (with cfg ``tta`` those of every branch,
    :func:`make_candidates_fn`) go through the one NMS.
    ``with_preds=True`` also returns the plain forward's raw preds first
    (the eval step computes its loss on them)."""
    decoder, nms = _decoder_and_nms(cfg)
    candidates = make_candidates_fn(cfg, apply_fn, decoder)

    def serve(x):
        preds, boxes = candidates(x)
        dets, valid = nms(boxes)
        if with_preds:
            return preds, dets, valid
        return dets, valid

    return serve


def make_serve_fn(cfg: dict, apply_fn: Callable,
                  with_preds: bool = False) -> Callable:
    """:func:`make_serving_graph` under ``torch.inference_mode()``: what
    ``Engine`` and the eval step call."""
    return torch.inference_mode()(
        make_serving_graph(cfg, apply_fn, with_preds))


def make_eval_step(cfg: dict, extra_variables: dict | None = None
                   ) -> Callable:
    """``(state, batch) -> (loss, dets [B, max_det, 6], valid [B, max_det])``
    on the batch's device: the model in eval mode (BN running statistics;
    the train-mode fused stem is never reached) under
    ``torch.inference_mode()``, the serving postprocess, and the loss on
    the same raw preds. Detections are input-pixel cxcywh + conf + class,
    score-sorted. The state is left as it was, its train/eval mode
    included.

    ``extra_variables``: ``{"quant": ...}`` from
    ``export/quantize.py::build_quant_variables``; its int8 blocks are
    installed for each call and removed after it (``quant_scope``), as
    ``podtpu`` merges the collection into the apply's variables."""
    from podtpu_torch.export.quantize import quant_scope

    extra = dict(extra_variables or {})
    unknown = sorted(set(extra) - {"quant"})
    if unknown:
        raise ValueError(f"unknown extra variable collections {unknown} "
                         "(expected 'quant')")
    quant = extra.get("quant")
    on_device: dict = {}  # device -> quant's tensors there, copied once
    loss_fn = build_loss(cfg)
    current: list = [None]  # the model of the call in progress
    # under the spatial layout each forward (TTA's too) takes this rank's
    # rows of the whole images
    serve = make_serve_fn(cfg, lambda x: current[0](space_rows(x, current[0])),
                          with_preds=True)

    def eval_step(state, batch):
        model = state.model
        was_training = model.training
        model.eval()
        current[0] = model
        try:
            dev = batch["img"].device
            if quant and dev not in on_device:
                on_device[dev] = {p: {k: v.to(dev) for k, v in q.items()}
                                  for p, q in quant.items()}
            with quant_scope(model, on_device.get(dev)), layout_scope(model):
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
    was: parameters, buffers and each module's train/eval flag.

    With cfg ``device_geom`` the batch is warped first (its ``geom`` rows),
    so the statistics are those of the distribution training sees."""
    device_geom = bool(cfg.get("device_geom", False))

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
                img = _as_input(batch["img"])
                if device_geom:
                    img = separable_affine(img, batch["geom"])
                with layout_scope(model):
                    model(space_rows(img, model))
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


def remat_policy(cfg: dict) -> str | None:
    """cfg ``remat_policy``: ``conv_out``, ``no_post_act`` or None (off);
    see ``models/layers.py::remat_scope``."""
    name = cfg.get("remat_policy") or None
    if name is not None and name not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy '{name}' "
                         "(expected conv_out | no_post_act)")
    return name


def augment_seed(seed: int, step: int) -> int:
    """The seed of step ``step``'s device-augmentation draws: stream 1 of
    (cfg ``seed``, step), as ``podtpu`` draws them from
    ``fold_in(fold_in(rng, step), 1)``."""
    return int(np.random.SeedSequence([seed, step, 1])
               .generate_state(1, np.uint64)[0])


def make_train_step(cfg: dict) -> Callable:
    """``(state, batch) -> (state, {"loss"})`` for a
    :class:`podtpu_torch.train.state.TrainState`, updated in place.

    ``batch``: ``{"img": [B, H, W, 3] uint8 or float, "annot": [B, T, 5]}``
    on the model's device, and with cfg ``device_geom`` ``"geom"`` [B, 4].
    With ``device_geom`` the images are warped first
    (:func:`separable_affine`); with ``device_augment`` they are then
    jittered and flipped with draws from a generator on their device,
    seeded from (cfg ``seed``, step). The BN running statistics move in
    the forward, from the batch statistics of the parameters before the
    update.

    With ``optimizer_options.skip_nonfinite`` the step reads two flags
    from the device, one host synchronisation a step: whether the
    gradients are finite (the optimizer's guard,
    :meth:`TrainState.apply_gradients`) and whether they and the new BN
    statistics are (else the statistics go back to the step's start, as
    ``podtpu`` keeps a NaN out of them).

    Under a process group (``parallel/mesh.py``) ``batch`` holds this
    data rank's rows of the global batch: BatchNorm and the stem take the
    global statistics, the gradients are averaged over ``data x space``
    after the backward (FSDP reduces its own; the whole leaves a channel
    slice uses are first summed over ``model``), the guard's flags are read
    after that and agreed by every rank, and the augmentation and dropout
    draws are the global batch's, of which the rank keeps its rows. Under
    the layouts (``parallel/layouts.py``) the forward and the backward run
    in the model's layout scope, and under the spatial layout the forward
    takes this rank's block of the augmented images' rows."""
    loss_fn = build_loss(cfg)
    policy = remat_policy(cfg)
    guard = skip_nonfinite(cfg) > 0
    seed = int(cfg.get("seed", 0))
    device_aug = make_device_augment(cfg)
    device_geom = bool(cfg.get("device_geom", False))
    gens: dict = {}  # device -> the augmentation's torch.Generator

    def train_step(state, batch):
        model = state.model
        model.train()
        # before the forward: FSDP's root unit keeps its whole parameters
        # registered from its forward to its backward, and their sharded
        # gradients would then be accumulated into
        model.zero_grad(set_to_none=True)
        # dropout masks from (seed, step), as podtpu folds the step into
        # its dropout key: a resumed run draws the masks it would have
        for m in model.modules():
            if isinstance(m, SeededDropout):
                m.reseed((seed << 32) + state.step)
        img, annot = batch["img"], batch["annot"]
        # the ranges name the step's parts in a profiler trace
        # (utils/step_profile.py); outside one they cost a few us
        with record_function("augment"):
            if device_geom:
                img = separable_affine(_as_input(img), batch["geom"])
            if device_aug is not None:
                gen = gens.get(img.device)
                if gen is None:
                    gen = gens[img.device] = torch.Generator(
                        device=img.device)
                gen.manual_seed(augment_seed(seed, state.step))
                img, annot = device_aug(img, annot, gen,
                                        global_rows(img.shape[0]))
        if guard:
            bns = [m for m in model.modules() if isinstance(m, BatchNormMixed)]
            stats = [t for m in bns for t in (m.running_mean, m.running_var)]
            start = [t.clone() for t in stats]
        with layout_scope(model):
            with record_function("forward"), remat_scope(policy):
                preds = model(space_rows(_as_input(img), model))
            with record_function("loss"):
                loss = loss_fn(preds, annot)
            with record_function("backward"):
                loss.backward()
        # under a process group the gradients are averaged over it
        with record_function("gradient_reduction"):
            average_gradients(state.params(), *model_axis_params(model))
        with record_function("optimizer"):
            if guard:
                # read after the reduction, and agreed: every rank takes
                # the same branch (an FSDP rank sees its shards alone)
                grads = local_tensors(gradients_of(state.params()))
                finite, stats_ok = agree_all(torch.stack(
                    [all_finite(grads), all_finite(stats)])).tolist()
                if not (finite and stats_ok):
                    with torch.no_grad():
                        for t, t0 in zip(stats, start):
                            t.copy_(t0)
                state.apply_gradients(finite)
            else:
                state.apply_gradients()
            state.update_ema()
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
    the card (but ``skip_nonfinite``'s flag, once a step), so the host
    queues all K steps and is free for the next group's batches. (``podtpu`` scans the steps in one compiled program;
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
