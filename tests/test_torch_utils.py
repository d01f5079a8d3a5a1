"""The port's host utilities and metrics against podtpu's (CPU): the
COCO-style evaluator, PR curves, the confusion matrix and the eval report
on the rows of tests/test_coco_metrics.py; drawing, auto-anchors at the
same seed, and the profiling and logging helpers as tests/test_utils.py
holds podtpu's. Every comparison is exact unless a test says otherwise."""

import logging
import os
import random
import time

import cv2
import numpy as np
import pytest
import torch

from podtpu.metrics import MeanAveragePrecision as JMeanAveragePrecision
from podtpu.metrics import coco as jcoco
from podtpu.metrics import curves as jcurves
from podtpu.metrics import plots as jplots
from podtpu.utils import anchors as janchors
from podtpu.utils import log as jlog
from podtpu.utils import viz as jviz
from podtpu_torch.data.synthetic import generate
from podtpu_torch.metrics import MeanAveragePrecision
from podtpu_torch.metrics import coco as tcoco
from podtpu_torch.metrics import curves as tcurves
from podtpu_torch.metrics import plots as tplots
from podtpu_torch.utils import anchors as tanchors
from podtpu_torch.utils import log as tlog
from podtpu_torch.utils import viz as tviz
from podtpu_torch.utils.profiling import (
    Profile,
    StepTimer,
    Timeout,
    init_seeds,
    trace,
)

# ---- metrics: the rows of tests/test_coco_metrics.py ----------------------


def _box(img, cx, cy, w, h, conf, cls):
    return [img, cx, cy, w, h, conf, cls]


def _voc_and_coco_rows():
    """test_voc_and_coco_matchers_agree_at_iou50's jittered detections."""
    rng = np.random.default_rng(3)
    n_img, n_cls = 40, 4
    true_rows, pred_rows = [], []
    for img in range(n_img):
        for _ in range(rng.integers(1, 4)):
            cx, cy = rng.uniform(60, 200, 2)
            w, h = rng.uniform(30, 80, 2)
            c = rng.integers(0, n_cls)
            true_rows.append([img, cx, cy, w, h, 1.0, c])
            if rng.random() < 0.85:
                pred_rows.append([img, cx + rng.normal(0, 3),
                                  cy + rng.normal(0, 3),
                                  w * rng.uniform(0.9, 1.1),
                                  h * rng.uniform(0.9, 1.1),
                                  rng.uniform(0.5, 1.0), c])
        if rng.random() < 0.4:
            pred_rows.append([img, *rng.uniform(40, 220, 2),
                              *rng.uniform(20, 60, 2), rng.uniform(0.1, 0.6),
                              rng.integers(0, n_cls)])
    return (np.asarray(true_rows, np.float32),
            np.asarray(pred_rows, np.float32), n_cls)


def _ap_per_class_rows():
    """test_ap_per_class_outputs' perfect boxes."""
    rng = np.random.default_rng(0)
    true = np.zeros((30, 7), np.float32)
    true[:, 0] = rng.integers(0, 10, 30)
    true[:, 1:5] = rng.uniform(50, 300, (30, 4))
    true[:, 3:5] = rng.uniform(20, 60, (30, 2))
    true[:, 5] = 1
    true[:, 6] = rng.integers(0, 3, 30)
    pred = true.copy()
    pred[:, 5] = rng.uniform(0.5, 1.0, 30)
    return true, pred, 3


_ONE_GT = np.array([_box(0, 50, 50, 20, 20, 1.0, 0)], np.float32)
CASES = {
    "perfect": lambda: (_ONE_GT, np.array(
        [_box(0, 50, 50, 20, 20, 0.9, 0)], np.float32), 1),
    "loose_box": lambda: (_ONE_GT, np.array(
        [_box(0, 54, 50, 20, 20, 0.9, 0)], np.float32), 1),
    "prefers_unmatched_gt": lambda: (
        np.array([_box(0, 50, 50, 20, 20, 1.0, 0),
                  _box(0, 56, 50, 20, 20, 1.0, 0)], np.float32),
        np.array([_box(0, 50, 50, 20, 20, 0.95, 0),
                  _box(0, 51, 50, 20, 20, 0.90, 0)], np.float32), 1),
    "ap_per_class": _ap_per_class_rows,
    "confusion": lambda: (
        np.array([_box(0, 50, 50, 20, 20, 1.0, 0),
                  _box(0, 150, 150, 20, 20, 1.0, 1)], np.float32),
        np.array([_box(0, 50, 50, 20, 20, 0.9, 0),
                  _box(0, 150, 150, 20, 20, 0.9, 0),
                  _box(0, 300, 300, 20, 20, 0.9, 1)], np.float32), 2),
    "voc_and_coco": _voc_and_coco_rows,
    "gtless_image": lambda: (_ONE_GT, np.array(
        [_box(0, 50, 50, 20, 20, 0.9, 0),
         _box(1, 30, 30, 20, 20, 0.9, 1)], np.float32), 2),
    "absent_classes": lambda: (_ONE_GT, np.array(
        [_box(0, 50, 50, 20, 20, 0.9, 0)], np.float32), 5),
}


@pytest.mark.parametrize("case", list(CASES))
def test_coco_eval_matches_podtpu(case):
    true, pred, n = CASES[case]()
    got, want = tcoco.coco_eval(true, pred, n), jcoco.coco_eval(true, pred, n)
    assert set(got) == set(want)
    for k in ("AP", "AP50", "AP75"):
        assert got[k] == want[k], k
    np.testing.assert_array_equal(got["per_class"], want["per_class"])
    assert tcoco.sample_ap_101(np.array([1.0, 0.5]), np.array([0.5, 1.0])) \
        == jcoco.sample_ap_101(np.array([1.0, 0.5]), np.array([0.5, 1.0]))


@pytest.mark.parametrize("case", list(CASES))
def test_ap_per_class_matches_podtpu(case):
    true, pred, n = CASES[case]()
    got = tcurves.ap_per_class(true, pred, n)
    want = jcurves.ap_per_class(true, pred, n)
    for k in ("precision", "recall", "f1", "ap"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert sorted(got["curves"]) == sorted(want["curves"])
    for c, arrays in want["curves"].items():
        for g, w in zip(got["curves"][c], arrays):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", list(CASES))
def test_confusion_matrix_matches_podtpu(case):
    true, pred, n = CASES[case]()
    got = tplots.build_confusion_matrix(true, pred, n)
    want = jplots.build_confusion_matrix(true, pred, n)
    assert isinstance(got, tcurves.ConfusionMatrix)
    np.testing.assert_array_equal(got.matrix, want.matrix)
    np.testing.assert_array_equal(got.normalized(), want.normalized())
    # one image through ConfusionMatrix.update directly
    cms = (tcurves.ConfusionMatrix(n), jcurves.ConfusionMatrix(n))
    for cm in cms:
        cm.update(pred[pred[:, 0] == 0], true[true[:, 0] == 0])
    np.testing.assert_array_equal(cms[0].matrix, cms[1].matrix)


def test_eval_report_matches_podtpu(tmp_path):
    """The same per-class table, and both PNGs written, from accumulators
    fed the same padded batches."""
    rng = np.random.default_rng(5)
    size, n_cls = 100, 3
    metrics = (MeanAveragePrecision(n_cls, size),
               JMeanAveragePrecision(n_cls, size))
    for _ in range(2):
        annots = -np.ones((4, 5, 5), np.float32)
        dets = np.zeros((4, 8, 6), np.float32)
        for b in range(4):
            k = int(rng.integers(1, 5))
            annots[b, :k, :4] = rng.uniform(0.2, 0.6, (k, 4))
            annots[b, :k, 4] = rng.integers(0, n_cls, k)
            for j in range(8):
                dets[b, j, :4] = annots[b, j % k, :4] * size + rng.normal(
                    0, 3, 4)
                dets[b, j, 4] = rng.uniform(0.2, 1.0)
                dets[b, j, 5] = annots[b, j % k, 4]
        valid = rng.random((4, 8)) < 0.6
        for m in metrics:
            m.update_state(annots, dets, valid)
    names = ["cat", "dog", "bird"]
    got = tplots.write_eval_report(metrics[0], names, str(tmp_path / "t"))
    want = jplots.write_eval_report(metrics[1], names, str(tmp_path / "j"))
    assert set(got) == set(want) == {"table", "pr_curves",
                                     "confusion_matrix"}
    with open(got["table"]) as f, open(want["table"]) as g:
        assert f.read() == g.read()
    for key in ("pr_curves", "confusion_matrix"):
        assert os.path.getsize(got[key]) > 1000, key


# ---- viz ------------------------------------------------------------------

BOXES = np.array([[50, 50, 20, 20, 0.9, 0], [20, 70, 30, 16, 0.55, 2],
                  [80, 20, 40, 40, 0.31, 7]], np.float32)


@pytest.mark.parametrize("fn", ["draw_boxes", "draw_boxes_unicode"])
def test_draw_boxes_matches_podtpu(fn):
    img = np.random.default_rng(0).integers(0, 256, (100, 120, 3),
                                            dtype=np.uint8)
    names = ["thing", "other", "third"]  # class 7 has no name: its index
    got = getattr(tviz, fn)(img.copy(), BOXES, names, color=(0, 200, 50))
    want = getattr(jviz, fn)(img.copy(), BOXES, names, color=(0, 200, 50))
    assert got.dtype == np.uint8 and got.shape == img.shape
    assert (got != img).any()
    np.testing.assert_array_equal(got, want)


def test_annots_and_names_match_podtpu(tmp_path):
    annots = -np.ones((6, 5), np.float32)
    annots[0] = [0.5, 0.5, 0.2, 0.2, 1]
    annots[1] = [0.25, 0.75, 0.1, 0.3, 4]
    got = tviz.annots_to_boxes(annots, 416)
    np.testing.assert_array_equal(got, jviz.annots_to_boxes(annots, 416))
    np.testing.assert_allclose(got[0], [208, 208, 83.2, 83.2, 1, 1],
                               rtol=1e-6)
    path = tmp_path / "x.names"
    path.write_text("a\n\nb\n c \n")
    assert tviz.load_names(str(path)) == jviz.load_names(str(path)) == \
        ["a", "b", "c"]


# ---- anchors --------------------------------------------------------------

def _cluster_wh():
    rng = np.random.default_rng(0)
    return np.concatenate([
        rng.normal((20, 20), 2, (200, 2)),
        rng.normal((60, 40), 4, (200, 2)),
        rng.normal((120, 120), 8, (200, 2)),
    ]).clip(2).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_kmeans_and_evolve_match_podtpu(seed):
    wh = _cluster_wh()
    got = tanchors.kmeans_anchors(wh, 3, seed=seed)
    want = janchors.kmeans_anchors(wh, 3, seed=seed)
    np.testing.assert_array_equal(got, want)
    assert tanchors.best_possible_recall(wh, got) > 0.98
    start = got * np.float32(1.3)  # room for the GA to improve
    evolved = tanchors.evolve_anchors(wh, start, generations=60, seed=seed)
    np.testing.assert_array_equal(
        evolved, janchors.evolve_anchors(wh, start, generations=60,
                                         seed=seed))
    assert tanchors.anchor_fitness(wh, evolved) > \
        tanchors.anchor_fitness(wh, start)
    np.testing.assert_array_equal(tanchors.ratio_metric(wh, evolved),
                                  janchors.ratio_metric(wh, evolved))


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    out = tmp_path_factory.mktemp("synth")
    return generate(str(out), n_train=12, n_val=2, size=96, num_classes=20,
                    max_objects=4, seed=2)


@pytest.mark.parametrize("anchors", ["good", "poor"])
def test_check_anchors_matches_podtpu(synth, anchors, capsys):
    """BPR over the labels of a train list; with poor anchors (BPR below
    0.98) k-means + the GA, the same anchors as podtpu's."""
    wh = tanchors.load_label_wh(synth["train_list"], 416)
    np.testing.assert_array_equal(
        wh, janchors.load_label_wh(synth["train_list"], 416))
    assert len(wh) > 12
    if anchors == "good":
        sets = tanchors.kmeans_anchors(wh, 9).tolist()
    else:
        sets = [[4, 4]] * 9
    cfg = {"anchors": sets, "train_list": synth["train_list"],
           "input_size": 416}
    got = tanchors.check_anchors(cfg, generations=40)
    text = capsys.readouterr().out
    want = janchors.check_anchors(cfg, generations=40)
    assert text == capsys.readouterr().out
    np.testing.assert_array_equal(got, want)
    assert ("BPR below threshold" in text) == (anchors == "poor")


def test_anchors_cli_and_empty_list(synth, tmp_path, monkeypatch, capsys):
    import sys

    import yaml

    cfg = {"model": "yolov3", "anchors": [[4, 4]] * 3,
           "train_list": synth["train_list"], "input_size": 416}
    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump(cfg))
    monkeypatch.setattr(sys, "argv", ["anchors", "--cfg", str(path),
                                      "--generations", "5"])
    tanchors.main()
    out = capsys.readouterr().out
    assert "BPR:" in out and "new BPR:" in out and "anchors:" in out
    empty = tmp_path / "empty.txt"
    empty.write_text("")
    with pytest.raises(ValueError, match="no labels"):
        tanchors.check_anchors(dict(cfg, train_list=str(empty)))


# ---- profiling and logging ------------------------------------------------

def test_profile_and_steptimer(capsys):
    with Profile(sync=False) as p:
        time.sleep(0.01)
    assert p.dt >= 0.01
    with Profile("named", device="cpu") as p:  # a CPU device: no sync
        time.sleep(0.005)
    assert p.dt >= 0.005 and "named: " in capsys.readouterr().out

    @Profile()
    def work():
        return torch.ones(64, 64).sum()

    assert float(work()) == 4096.0

    t = StepTimer(window=2)
    assert t.tick() is None and t.steps_per_sec() == 0.0
    for _ in range(3):
        time.sleep(0.005)
        assert t.tick() >= 0.005
    assert len(t._times) == 2
    assert t.steps_per_sec() > 0
    assert t.images_per_sec(4) == pytest.approx(4 * t.steps_per_sec())


def test_init_seeds_matches_podtpu():
    gen = init_seeds(7)
    assert isinstance(gen, torch.Generator) and gen.initial_seed() == 7
    got = (random.random(), np.random.rand())
    from podtpu.utils.profiling import init_seeds as jinit_seeds

    jinit_seeds(7)
    assert got == (random.random(), np.random.rand())
    assert torch.equal(torch.rand(3, generator=init_seeds(7)),
                       torch.rand(3, generator=torch.Generator()
                                  .manual_seed(7)))


def test_timeout_context():
    with Timeout(5.0):
        time.sleep(0.01)
    with pytest.raises(TimeoutError, match="too slow"):
        with Timeout(0.05, msg="too slow"):
            time.sleep(0.5)
    with Timeout(0.05, suppress=True):
        time.sleep(0.5)


def test_trace_writes_a_tensorboard_trace(tmp_path):
    with trace(str(tmp_path)) as prof:
        torch.ones(32, 32).matmul(torch.ones(32, 32))
    assert prof is not None
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")


def test_logger_colorstr_and_rank(monkeypatch, capsys):
    for args in (("hello",), ("red", "bold", "x"), ("green", 3)):
        assert tlog.colorstr(*args) == jlog.colorstr(*args)
    logger = tlog.get_logger("podtpu_torch-test")
    assert tlog.get_logger("podtpu_torch-test") is logger
    assert logger.level == logging.INFO and not logger.propagate
    logger.info("info line")
    assert capsys.readouterr().out == "info line\n"
    assert tlog.LOGGER.name == "podtpu_torch"
    monkeypatch.setenv("RANK", "2")  # not rank 0: warnings only
    assert tlog._rank() == 2
    logger.info("hidden")
    logger.warning("shown")
    assert capsys.readouterr().out == "shown\n"
    monkeypatch.delenv("RANK")
    assert tlog._rank() == 0


def test_drawn_image_roundtrips_through_jpeg(tmp_path):
    """What the inference CLI writes: a BGR uint8 image cv2 reads back."""
    img = tviz.draw_boxes(np.zeros((64, 64, 3), np.uint8), BOXES[:1],
                          ["thing"])
    path = str(tmp_path / "x.jpg")
    assert cv2.imwrite(path, img)
    assert cv2.imread(path).shape == (64, 64, 3)
