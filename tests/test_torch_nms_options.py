"""The serving options of the port against podtpu on the CPU: NMS
``agnostic`` / ``classes`` / ``merge`` / ``backend``, multi-label decoding,
the host NMS variants (``ops/nms_host.py``) and test-time augmentation
(``tta``), each from the same numpy-seeded inputs through both packages.

Tolerances: keep masks, class ids and validity exactly; boxes as
``tests/test_nms.py`` holds merge-NMS to its oracle (rtol 1e-4, atol 1e-3)
and podtpu's own output to 1e-5 where only float32 rounding differs;
detections of a whole model as ``tests/test_torch_serve.py`` does.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import podtpu.ops.nms_host as jhost
from podtpu.models.factory import build_model as podtpu_build_model
from podtpu.ops.decode import decode_anchor_head as podtpu_decode_head
from podtpu.ops.decode import decode_yolov2 as podtpu_decode_yolov2
from podtpu.ops.decode import decode_yolov3 as podtpu_decode_yolov3
from podtpu.ops.nms import batched_class_aware_nms as podtpu_nms
from podtpu.ops.nms import nms_padded as podtpu_nms_padded
from podtpu.train.steps import make_postprocess as podtpu_make_postprocess
from podtpu.train.steps import make_serve_fn as podtpu_make_serve_fn
from podtpu.train.steps import tta_options as podtpu_tta_options
from podtpu_torch.export.weights import load_flat_weights
from podtpu_torch.models.factory import build_model
from podtpu_torch.ops import nms_host
from podtpu_torch.ops.boxes import cxcywh_to_xyxy
from podtpu_torch.ops.decode import (
    decode_anchor_head,
    decode_yolov2,
    decode_yolov3,
)
from podtpu_torch.ops.nms import batched_class_aware_nms, nms_padded
from podtpu_torch.train.state import create_train_state
from podtpu_torch.train.steps import (
    _as_input,
    make_decoder,
    make_eval_step,
    make_postprocess,
    make_serve_fn,
    tta_options,
)
from tests.helpers import VOC_ANCHORS, VOC_SCALED_ANCHORS
from tests.test_nms import greedy_oracle
from tests.torch_parity import (
    flax_variables,
    image_batch,
    podtpu_flat_weights,
    yolo_cfg,
)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs six workers on the machine's
    cores, and these small tensors gain little from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _both(boxes: np.ndarray, **kw):
    """The port's and podtpu's (xla backend) NMS of the same [B, N, 6]."""
    got = batched_class_aware_nms(torch.from_numpy(boxes), **kw)
    want = podtpu_nms(jnp.asarray(boxes), backend="xla", **kw)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


def _random_boxes(seed, b=2, n=64, classes=3):
    rng = np.random.default_rng(seed)
    boxes = np.zeros((b, n, 6), np.float32)
    boxes[..., 0:2] = rng.uniform(40, 160, (b, n, 2))
    boxes[..., 2:4] = rng.uniform(20, 80, (b, n, 2))
    boxes[..., 4] = rng.uniform(0, 1, (b, n))
    boxes[..., 5] = rng.integers(0, classes, (b, n))
    return boxes


def test_agnostic_suppresses_across_classes():
    """tests/test_nms.py's case: class-aware keeps both, agnostic the
    stronger; then random boxes against podtpu."""
    boxes = np.zeros((1, 4, 6), np.float32)
    boxes[0, 0] = [50, 50, 40, 40, 0.9, 1]
    boxes[0, 1] = [50, 50, 40, 40, 0.8, 2]
    (out, valid), _ = _both(boxes, top_k=4, max_detections=4)
    assert valid.sum() == 2
    (out, valid), _ = _both(boxes, top_k=4, max_detections=4, agnostic=True)
    kept = out[valid]
    assert len(kept) == 1 and kept[0, 4] == pytest.approx(0.9)
    (out, valid), (jout, jvalid) = _both(_random_boxes(0), top_k=32,
                                         max_detections=16, agnostic=True)
    np.testing.assert_array_equal(valid, jvalid)
    np.testing.assert_allclose(out, jout, rtol=0, atol=1e-5)


def test_classes_filter_keeps_only_listed_ids():
    boxes = np.zeros((1, 4, 6), np.float32)
    boxes[0, 0] = [50, 50, 40, 40, 0.9, 1]
    boxes[0, 1] = [150, 150, 40, 40, 0.8, 2]
    boxes[0, 2] = [250, 250, 40, 40, 0.7, 3]
    (out, valid), _ = _both(boxes, top_k=4, max_detections=4, classes=(2, 3))
    assert sorted(out[valid][:, 5].tolist()) == [2.0, 3.0]
    (out, valid), (jout, jvalid) = _both(_random_boxes(1), top_k=32,
                                         max_detections=16, classes=(0, 2))
    np.testing.assert_array_equal(valid, jvalid)
    np.testing.assert_allclose(out, jout, rtol=0, atol=1e-5)
    assert set(out[valid][:, 5].tolist()) <= {0.0, 2.0}


def _iou_row(box, others):
    xy1 = np.maximum(box[:2], others[:, :2])
    xy2 = np.minimum(box[2:4], others[:, 2:4])
    inter = np.clip(xy2 - xy1, 0, None).prod(axis=1)
    a1 = np.clip(box[2:4] - box[:2], 0, None).prod()
    a2 = np.clip(others[:, 2:4] - others[:, :2], 0, None).prod(axis=1)
    return inter / (a1 + a2 - inter + 1e-9)


def _merge_oracle(boxes, k, max_det, thr=0.45, conf=0.25):
    """tests/test_nms.py's numpy oracle of the padded pipeline with the
    reference's merge math (keep truncated to max_det first)."""
    score = np.where(boxes[:, 4] > conf, boxes[:, 4], -1.0)
    idx = np.argsort(-score, kind="stable")[:k]
    cand = boxes[idx]
    cand_valid = score[idx] > 0
    xyxy = cxcywh_to_xyxy(torch.from_numpy(cand[:, :4])).numpy()
    span = max(np.abs(xyxy).max(), 8192.0) * 2.0 + 1.0
    off = xyxy + cand[:, 5:6] * span
    keep = greedy_oracle(off, cand_valid, thr)
    keep &= np.cumsum(keep) <= max_det
    ious = np.stack([_iou_row(off[i], off) for i in range(k)])
    contrib = (ious > thr) & cand_valid[None, :]
    w = contrib * np.where(cand_valid, cand[:, 4], 0.0)[None, :]
    merged = (w @ xyxy) / np.maximum(w.sum(1, keepdims=True), 1e-12)
    rows = []
    for i in range(k):
        if not keep[i] or contrib[i].sum() <= 1:
            continue
        x1, y1, x2, y2 = merged[i]
        rows.append([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1,
                     cand[i, 4], cand[i, 5]])
    return np.array(sorted(rows, key=lambda r: -r[4]), np.float32)


@pytest.mark.parametrize("max_det,seeds", [(32, (0, 1, 2)), (4, (0, 1))])
def test_merge_matches_oracle_and_podtpu(max_det, seeds):
    """Merge over seeds and max_det: the oracle's rows (rtol 1e-4, atol
    1e-3), and podtpu's on the same batch (valid exactly, boxes 1e-4)."""
    rng_boxes = []
    for seed in seeds:
        rng = np.random.default_rng(seed)
        n, boxes = 64, np.zeros((64, 6), np.float32)
        boxes[:, 0:2] = rng.uniform(40, 160, (n, 2))
        boxes[:, 2:4] = rng.uniform(20, 80, (n, 2))
        boxes[:, 4] = rng.uniform(0, 1, n)
        boxes[:, 5] = rng.integers(0, 3, n)
        rng_boxes.append(boxes)
    batch = np.stack(rng_boxes)
    kw = dict(conf_threshold=0.25, iou_threshold=0.45, top_k=32,
              max_detections=max_det, merge=True)
    (out, valid), (jout, jvalid) = _both(batch, **kw)
    np.testing.assert_array_equal(valid, jvalid)
    np.testing.assert_allclose(out, jout, rtol=1e-4, atol=1e-4)
    for i, boxes in enumerate(rng_boxes):
        got = out[i][valid[i]]
        want = _merge_oracle(boxes, 32, max_det)
        assert len(got) == len(want) > 0
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_merge_single_candidate_unmerged():
    boxes = np.zeros((1, 4, 6), np.float32)
    boxes[0, 0] = [50, 50, 40, 40, 0.9, 1]
    (out, valid), _ = _both(boxes, top_k=4, max_detections=4, merge=True)
    kept = out[valid]
    assert len(kept) == 1
    np.testing.assert_allclose(kept[0, :4], [50, 50, 40, 40], rtol=1e-5)


def test_backend_names_accepted_and_unknown_raises():
    boxes = torch.from_numpy(_random_boxes(2))
    plain = batched_class_aware_nms(boxes, top_k=32)
    for name in ("xla", "xla_early", "pallas", "pallas_interpret"):
        got = batched_class_aware_nms(boxes, top_k=32, backend=name)
        assert all(torch.equal(a, b) for a, b in zip(got, plain))
    with pytest.raises(ValueError, match="unknown NMS backend"):
        batched_class_aware_nms(boxes, backend="cuda")
    with pytest.raises(ValueError, match="unknown NMS backend"):
        make_postprocess(yolo_cfg(nms_options={"backend": "tpu"}))(
            [torch.zeros(1, s, s, 75) for s in (8, 4, 2)])


def test_nms_padded_takes_the_options():
    boxes = _random_boxes(3, b=1)[0]
    kw = dict(top_k=32, max_detections=16, agnostic=True, merge=True,
              classes=(0, 1))
    got = nms_padded(torch.from_numpy(boxes), **kw)
    want = podtpu_nms_padded(jnp.asarray(boxes), backend="xla", **kw)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-4, atol=1e-4)


def test_multilabel_decode_matches_podtpu():
    """One row per (anchor, class) in podtpu's (h, w, a, c) order, for one
    head, YOLOv3's three and YOLOv2's (float32 sigmoid/exp: 1e-5)."""
    rng = np.random.default_rng(4)
    c = 20
    heads = [rng.normal(0, 2, (2, s, s, 3 * (5 + c))).astype(np.float32)
             for s in (8, 4, 2)]
    got = decode_yolov3([torch.from_numpy(h) for h in heads], c,
                        VOC_ANCHORS, 64, multi_label=True)
    want = podtpu_decode_yolov3([jnp.asarray(h) for h in heads], c,
                                VOC_ANCHORS, 64, multi_label=True)
    assert got.shape == want.shape == (2, (64 + 16 + 4) * 3 * c, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    v2 = rng.normal(0, 2, (2, 4, 4, 5 * (5 + c))).astype(np.float32)
    got = decode_yolov2(torch.from_numpy(v2), c,
                        torch.tensor(VOC_SCALED_ANCHORS), 64,
                        multi_label=True)
    want = podtpu_decode_yolov2(jnp.asarray(v2), c, VOC_SCALED_ANCHORS, 64,
                                multi_label=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_multilabel_decode_and_nms():
    """tests/test_nms.py's case: conf = sigmoid(obj) * sigmoid(cls_c), and
    NMS keeps one detection per strong class on the same box."""
    b, c, a = 1, 4, 3
    pred = np.full((b, 2, 2, a * (5 + c)), -12.0, np.float32)
    view = pred.reshape(b, 2, 2, a, 5 + c)
    view[0, 0, 0, 0, :5] = [0.0, 0.0, 0.0, 0.0, 6.0]
    view[0, 0, 0, 0, 5 + 1] = 5.0
    view[0, 0, 0, 0, 5 + 3] = 4.0
    anchors = np.asarray([[1.0, 1.0], [2.0, 2.0], [3.0, 3.0]], np.float32)
    cand = decode_anchor_head(torch.from_numpy(pred), c,
                              torch.from_numpy(anchors), 64,
                              multi_label=True)
    want = podtpu_decode_head(jnp.asarray(pred), c, jnp.asarray(anchors), 64,
                              multi_label=True)
    np.testing.assert_allclose(cand.numpy(), np.asarray(want), rtol=1e-6)
    assert cand.shape == (b, 2 * 2 * a * c, 6)
    obj = 1 / (1 + np.exp(-6.0))
    np.testing.assert_allclose(cand[0, :, 4].max().item(),
                               obj / (1 + np.exp(-5.0)), rtol=1e-5)
    out, valid = batched_class_aware_nms(cand, conf_threshold=0.5, top_k=16,
                                         max_detections=8)
    kept = out[0][valid[0]].numpy()
    assert sorted(kept[:, 5].tolist()) == [1.0, 3.0]
    np.testing.assert_allclose(kept[0, :4], kept[1, :4], rtol=1e-5)


@pytest.mark.parametrize("nopts", [
    {"multi_label": True, "merge": True},
    {"agnostic": True, "classes": [1, 2], "backend": "xla_early"},
], ids=["multi_label+merge", "agnostic+classes"])
def test_postprocess_options_match_podtpu(nopts):
    """cfg ``nms_options`` through make_postprocess (tests/test_nms.py's
    yolov4-tiny config, wider boxes): valid masks exactly, rows to 1e-4."""
    cfg = {"model": "yolov4-tiny", "num_classes": 3, "input_size": 64,
           "anchors": [[4, 5], [6, 8], [10, 9], [12, 16], [18, 14],
                       [20, 24], [32, 28], [40, 44], [56, 52]],
           "conf_threshold": 0.1, "top_k_candidates": 32,
           "max_detections": 8, "nms_options": nopts}
    heads = []
    for s in (8, 4, 2):
        h = np.random.default_rng(0).normal(0, 1, (2, s, s, 3, 8))
        h[..., 2:4] += 2.0  # wide boxes, so that same-class ones overlap
        heads.append(h.reshape(2, s, s, 24).astype(np.float32))
    got = make_postprocess(cfg)([torch.from_numpy(h) for h in heads])
    want = podtpu_make_postprocess(cfg)([jnp.asarray(h) for h in heads])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-4, atol=1e-4)
    assert got[1].numpy().sum() > 0


@pytest.mark.parametrize("model", ["yolov1", "retinanet"])
def test_multilabel_raises_for_single_label_heads(model):
    cfg = {"model": model, "num_classes": 3, "input_size": 64,
           "num_boxes": 2}
    with pytest.raises(ValueError, match="multi_label"):
        make_decoder(cfg, multi_label=True)
    with pytest.raises(ValueError, match="multi_label"):
        make_postprocess(dict(cfg, nms_options={"multi_label": True}))


def _host_rows(seed, n=48, c=4):
    rng = np.random.default_rng(seed)
    rows = np.zeros((n, 6), np.float32)
    rows[:, 0:2] = rng.uniform(30, 120, (n, 2))
    rows[:, 2:4] = rng.uniform(40, 90, (n, 2))
    rows[:, 4] = rng.uniform(0, 1, n)
    rows[:, 5] = rng.integers(0, c, n)
    raw = np.concatenate([rows[:, :5], rng.uniform(0, 1, (n, c))],
                         axis=1).astype(np.float32)
    return rows, raw


@pytest.mark.parametrize("fn", ["nms_v1", "nms_v2"])
def test_host_nms_variants_match_podtpu(fn):
    for seed in (0, 1):
        rows, _ = _host_rows(seed)
        got = getattr(nms_host, fn)(rows, 0.25, 0.45)
        want = getattr(jhost, fn)(rows, 0.25, 0.45)
        np.testing.assert_array_equal(got, want)
        assert 0 < len(got) < len(rows)


@pytest.mark.parametrize("multi_label,merge", [(False, False), (True, False),
                                               (False, True), (True, True)])
def test_host_non_max_suppression_matches_podtpu(multi_label, merge):
    _, raw = _host_rows(2)
    kw = dict(conf_thres=0.25, iou_thres=0.45, multi_label=multi_label,
              merge=merge, max_det=300)
    got = nms_host.non_max_suppression(raw, **kw)
    want = jhost.non_max_suppression(raw, **kw)
    np.testing.assert_array_equal(got, want)
    assert len(got) > 0


def test_tta_options_parsing():
    for cfg in ({}, {"tta": False}, {"tta": True}, {"tta": {"hflip": False}},
                {"tta": {"scales": [1.0, 0.83]}},
                {"tta": {"hflip": False, "scales": []}},
                {"tta": {"scales": [0.83, 0.67]}}):
        assert tta_options(cfg) == podtpu_tta_options(cfg)
    assert tta_options({"tta": {"scales": [1.0, 0.83]}}) == {
        "hflip": True, "scales": (0.83,)}
    for bad in ([1.5], [0.0], [-0.5]):
        with pytest.raises(ValueError, match="scales"):
            tta_options({"tta": {"scales": bad}})


@pytest.fixture(scope="module")
def tta_setup():
    """tests/test_tta.py's model: YOLOv4-tiny at 64 px, 3 classes."""
    cfg = {"model": "yolov4-tiny", "num_classes": 3, "input_size": 64,
           "compute_dtype": "float32",
           "anchors": [[4, 5], [6, 8], [10, 9], [12, 16], [18, 14],
                       [20, 24], [32, 28], [40, 44], [56, 52]],
           "conf_threshold": 0.1, "nms_iou_threshold": 0.45,
           "top_k_candidates": 64, "max_detections": 20}
    flat = podtpu_flat_weights(cfg, seed=1)
    return cfg, flat, image_batch(cfg, batch=2, seed=3)


def _det_rows(dets, valid):
    out = []
    for d, v in zip(np.asarray(dets), np.asarray(valid)):
        d = d[v]
        out.append(d[np.lexsort((d[:, 1], d[:, 0], d[:, 5]))])
    return out


@pytest.mark.parametrize("tta", [True, {"hflip": True, "scales": [0.83, 0.67]},
                                 {"hflip": False, "scales": [0.5]}],
                         ids=["hflip", "hflip+scales", "scale"])
def test_tta_serving_matches_podtpu(tta_setup, tta):
    """TTA serving at 64 px against podtpu's ``make_serve_fn``:
    the resize antialiased as ``jax.image.resize`` shrinks, canvas, mirror
    and per-axis rescale; detections to tests/test_torch_serve.py's
    tolerances (boxes rtol 1e-4 atol 1e-3, scores 1e-5)."""
    cfg, flat, x = tta_setup
    cfg = dict(cfg, tta=tta)
    variables = flax_variables(flat)
    jmodel = podtpu_build_model(cfg)
    want = podtpu_make_serve_fn(
        cfg, lambda v: jmodel.apply(variables, v, train=False))(
            jnp.asarray(x, jnp.float32) / 255.0)
    model = load_flat_weights(build_model(cfg, device="cpu"), flat)
    got = make_serve_fn(cfg, model)(_as_input(torch.from_numpy(x)))
    np.testing.assert_array_equal(got[1].numpy().sum(1),
                                  np.asarray(want[1]).sum(1))
    for g, w in zip(_det_rows(*got), _det_rows(*want)):
        assert len(g) > 0
        np.testing.assert_array_equal(g[:, 5], w[:, 5])
        np.testing.assert_allclose(g[:, :4], w[:, :4], rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(g[:, 4], w[:, 4], atol=1e-5)


def test_tta_scale_branch_is_the_resized_canvas(tta_setup):
    """The scale branch's candidates are those of the forward on the batch
    shrunk (antialiased bilinear) into the top-left of a 0.447 canvas,
    rescaled by the exact per-axis ratio (round(64 * 0.83) = 53)."""
    cfg, flat, x = tta_setup
    model = load_flat_weights(build_model(cfg, device="cpu"), flat)
    xf = _as_input(torch.from_numpy(x))
    decoder = make_decoder(cfg)
    serve = make_serve_fn(dict(cfg, tta={"hflip": False, "scales": [0.83]}),
                          model)
    with torch.inference_mode():
        small = torch.nn.functional.interpolate(
            xf.permute(0, 3, 1, 2), size=(53, 53), mode="bilinear",
            align_corners=False, antialias=True).permute(0, 2, 3, 1)
        canvas = torch.full_like(xf, 0.447)
        canvas[:, :53, :53] = small
        cands = decoder(model(canvas))
        cands[..., [0, 2]] *= 64 / 53
        cands[..., [1, 3]] *= 64 / 53
        joined = torch.cat([decoder(model(xf)), cands], dim=1)
        want = batched_class_aware_nms(
            joined, cfg["conf_threshold"], cfg["nms_iou_threshold"],
            cfg["top_k_candidates"], cfg["max_detections"])
    got = serve(xf)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])


def test_eval_step_loss_unchanged_by_tta(tta_setup):
    """The eval step's loss is the plain forward's; TTA changes only the
    detections."""
    cfg, flat, x = tta_setup
    cfg = dict(cfg, max_annots=8, optimizer="sgd",
               optimizer_options={"lr": 1e-3}, scheduler=None)
    state = create_train_state(cfg, "cpu", weights=flat)
    annot = -np.ones((2, 8, 5), np.float32)
    annot[:, 0] = [0.5, 0.5, 0.4, 0.4, 1]
    batch = {"img": torch.from_numpy(x), "annot": torch.from_numpy(annot)}
    loss_p, dets_p, valid_p = make_eval_step(cfg)(state, batch)
    loss_t, dets_t, valid_t = make_eval_step(
        dict(cfg, tta={"hflip": True, "scales": [0.67]}))(state, batch)
    assert float(loss_p) == float(loss_t)
    assert not (torch.equal(dets_p, dets_t) and torch.equal(valid_p, valid_t))
