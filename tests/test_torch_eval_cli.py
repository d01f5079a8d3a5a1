"""What users do with a checkpoint, the port against podtpu (CPU): the
CLIs (``podtpu_torch.cli``) against podtpu's root scripts loaded by path,
and cfg ``log_images``, on configs/yolov3_voc.yaml's recipe at 64 px in
float32 from the same seeded weights (tests/torch_parity.py).

podtpu's scripts run once, in a module fixture, on the weights the port
reads from its own checkpoint; its train states are built once per
config."""

import importlib.util
import json
import os
import shutil
import sys

import cv2
import numpy as np
import pytest
import torch

from podtpu_torch.cli import inference as cli_inference
from podtpu_torch.cli import make_pred_file as cli_pred
from podtpu_torch.cli import make_video as cli_video
from podtpu_torch.cli import test as cli_test
from podtpu_torch.cli import yolo2coco_pred_file as cli_coco
from podtpu_torch.data.dataset import label_path_for, read_yolo_labels
from podtpu_torch.train.run import make_loaders
from podtpu_torch.train.state import create_train_state
from podtpu_torch.train.trainer import CheckpointIO, Trainer
from tests.torch_parity import (  # noqa: F401  (fixtures)
    cached_podtpu_states,
    flax_variables,
    podtpu_flat_weights,
    recipe_cfg,
    recording_writer,
    synth,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
quiet = lambda *_: None  # noqa: E731


@pytest.fixture(autouse=True)
def drop_checkpoints(tmp_path):
    """A checkpoint of the 64 px model is ~280 MB: each test's files go
    when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _root_script(name: str):
    """podtpu's root ``<name>.py``, loaded by path (``import test`` would
    find the standard library's package)."""
    spec = importlib.util.spec_from_file_location(
        f"podtpu_root_{name}", os.path.join(REPO, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _coco_json(synth, path) -> str:
    """A COCO annotation file over the val images and their YOLO labels,
    beside the images (``file_name`` is relative to the JSON's folder)."""
    with open(synth["val_list"]) as f:
        imgs = [l for l in f.read().splitlines() if l.strip()]
    images, annotations = [], []
    for i, p in enumerate(imgs):
        h, w = cv2.imread(p).shape[:2]
        images.append({"id": i + 1, "file_name": os.path.relpath(
            p, os.path.dirname(path)), "width": w, "height": h})
        for cls, cx, cy, bw, bh in read_yolo_labels(label_path_for(p)):
            annotations.append({
                "id": len(annotations) + 1, "image_id": i + 1,
                "category_id": int(cls) + 1, "iscrowd": 0,
                "area": float(bw * w * bh * h),
                "bbox": [float((cx - bw / 2) * w), float((cy - bh / 2) * h),
                         float(bw * w), float(bh * h)]})
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": c + 1, "name": str(c)}
                                  for c in range(20)]}, f)
    return path


# ---- log_images --------------------------------------------------------

def test_log_images_draws_the_first_val_batch(synth, tmp_path,
                                              recording_writer):
    """cfg ``log_images: N``: N HWC uint8 images of the first val batch,
    with GT and detections drawn, each validation."""
    cfg = recipe_cfg(synth, tmp_path, epochs=1, log_images=3)
    trainer = Trainer(cfg, device="cpu", log=quiet)
    trainer.ckpt.save = lambda *a: None  # ~280 MB each, not looked at
    trainer.fit(*make_loaders(cfg))
    (writer,) = recording_writer
    assert [t for t, _, _, _ in writer.images] == [
        f"val_detections/{i}" for i in range(3)]
    first = next(iter(make_loaders(cfg)[1]))["img"]
    for i, (_, img, step, fmt) in enumerate(writer.images):
        assert step == 2 and fmt == "HWC"
        assert img.dtype == np.uint8 and img.shape == (64, 64, 3)
        assert (img != first[i]).any()  # boxes were drawn


# ---- the CLIs against podtpu's root scripts -------------------------------

@pytest.fixture(scope="module")
def ckpts(synth, tmp_path_factory, cached_podtpu_states):
    """The seeded weights as a port checkpoint (``CheckpointIO``), and a
    restore for podtpu's root scripts that hands them the same weights."""
    root = tmp_path_factory.mktemp("cli")
    cfg = recipe_cfg(synth, root)
    flat = podtpu_flat_weights(cfg, seed=3)
    io = CheckpointIO(str(root / "ckpts"))
    io.save("best", create_train_state(cfg, "cpu", weights=flat))
    variables = flax_variables(flat)

    def restore(ckpt, state, cfg, use_ema=None):
        return state.replace(params=variables["params"],
                             batch_stats=variables["batch_stats"])

    yield cfg, str(root / "ckpts" / "best"), restore, root
    shutil.rmtree(root, ignore_errors=True)


@pytest.fixture(scope="module")
def podtpu_cli(ckpts, synth):
    """podtpu's ``test.py``, ``make_pred_file.py`` and
    ``yolo2coco_pred_file.py`` on the same weights."""
    cfg, _, restore, root = ckpts
    out = {}
    test_py = _root_script("test")
    test_py.restore_eval_weights = restore
    out["evaluate"] = test_py.evaluate(cfg, "podtpu-weights")
    out["evaluate_int8"] = test_py.evaluate(cfg, "podtpu-weights",
                                            quantize="int8", calib_batches=2)
    pred = _root_script("make_pred_file")
    pred.restore_eval_weights = restore
    pred.make_pred_files(cfg, "podtpu-weights", str(root / "j_pred"))
    out["pred_dir"] = str(root / "j_pred")
    coco = _root_script("yolo2coco_pred_file")
    coco.restore_eval_weights = restore
    ann = _coco_json(synth, os.path.join(os.path.dirname(
        synth["val_list"]), "annotations.json"))
    coco.run(cfg, "podtpu-weights", ann, str(root / "j_results.json"))
    with open(root / "j_results.json") as f:
        out["results"] = json.load(f)
    out["ann"] = ann
    return out


def test_evaluate_matches_podtpu(ckpts, podtpu_cli, tmp_path, capsys):
    """``python -m podtpu_torch.cli.test --report`` (its ``main``):
    val_loss 1e-5 relative, val_mAP 1e-6 (test_torch_trainer.py's validate
    tolerances); the same printed format; the report's table and both
    PNGs."""
    cfg, ckpt, _, root = ckpts
    want = podtpu_cli["evaluate"]
    path = tmp_path / "cfg.yaml"
    import yaml

    path.write_text(yaml.safe_dump(cfg))
    got = cli_test.main(["--cfg", str(path), "--ckpt", ckpt, "--device",
                         "cpu", "--report", str(tmp_path / "report")])
    assert got["val_loss"] == pytest.approx(want["val_loss"], rel=1e-5)
    assert got["val_mAP"] == pytest.approx(want["val_mAP"], abs=1e-6)
    out = capsys.readouterr().out
    assert f"val_loss: {got['val_loss']:.5f}\n" in out
    assert f"val_mAP: {got['val_mAP']:.5f}\n" in out
    report = os.listdir(tmp_path / "report")
    assert {"per_class.txt", "confusion_matrix.png"} <= set(report)
    with open(tmp_path / "report" / "per_class.txt") as f:
        table = f.read().splitlines()
    assert table[0].split() == ["class", "AP", "TP", "FP", "FN"]
    assert len(table) == 22 and table[-1].startswith("mAP")


def _numbers_close(got_line, want_line, places):
    """Same class name; each number within one unit of its last printed
    place (the two sides round values ~1e-4 apart)."""
    g, w = got_line.split(), want_line.split()
    assert g[0] == w[0] and len(g) == len(w)
    for a, b, p in zip(g[1:], w[1:], places):
        assert abs(float(a) - float(b)) <= 10.0 ** -p * 1.01, (got_line,
                                                               want_line)


def test_make_pred_files_match_podtpu(ckpts, podtpu_cli, tmp_path):
    cfg, ckpt, _, _ = ckpts
    cli_pred.make_pred_files(cfg, ckpt, str(tmp_path / "pred"),
                             device="cpu")
    names = sorted(os.listdir(podtpu_cli["pred_dir"]))
    assert sorted(os.listdir(tmp_path / "pred")) == names and len(names) == 6
    n_lines = 0
    for name in names:
        with open(tmp_path / "pred" / name) as f, \
                open(os.path.join(podtpu_cli["pred_dir"], name)) as g:
            got, want = f.read().splitlines(), g.read().splitlines()
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _numbers_close(a, b, (6, 2, 2, 2, 2))
        n_lines += len(got)
    assert n_lines > 0


def test_yolo2coco_matches_podtpu(ckpts, podtpu_cli, tmp_path, capsys):
    """The same ``results.json`` records (bbox and score within one unit
    of their rounding); scored by the built-in evaluator here, where
    pycocotools is absent."""
    cfg, ckpt, _, _ = ckpts
    out = str(tmp_path / "results.json")
    scores = cli_coco.run(cfg, ckpt, podtpu_cli["ann"], out, device="cpu")
    with open(out) as f:
        got = json.load(f)
    want = podtpu_cli["results"]
    assert len(got) == len(want) == scores["n_detections"] > 0
    for a, b in zip(got, want):
        assert set(a) == {"image_id", "category_id", "bbox", "score"}
        assert (a["image_id"], a["category_id"]) == (b["image_id"],
                                                      b["category_id"])
        np.testing.assert_allclose(a["bbox"], b["bbox"], atol=0.0101)
        assert abs(a["score"] - b["score"]) <= 1.01e-5
    assert scores["evaluator"] == ("pycocotools" if importlib.util.find_spec(
        "pycocotools") else "builtin")
    for k in ("AP", "AP50", "AP75"):
        assert 0.0 <= scores[k] <= 1.0
    assert scores["AP50"] >= scores["AP75"]
    assert "AP@[.5:.95]" in capsys.readouterr().out


def test_inference_writes_tagged_images(ckpts, tmp_path, capsys):
    cfg, ckpt, _, _ = ckpts
    ms = cli_inference.inference(cfg, ckpt, str(tmp_path / "vis"), limit=3,
                                 device="cpu")
    assert len(ms) == 3 and all(m > 0 for m in ms)
    files = sorted(os.listdir(tmp_path / "vis"))
    assert files == [f"{i:05d}.jpg" for i in range(3)]
    assert cv2.imread(str(tmp_path / "vis" / files[0])).shape == (64, 64, 3)
    lines = [l for l in capsys.readouterr().out.splitlines()
             if " inference: " in l]
    assert len(lines) == 3 and lines[0].startswith("[0] inference: ")


def _video(synth, path, frames: int) -> str:
    with open(synth["val_list"]) as f:
        imgs = [l for l in f.read().splitlines() if l.strip()]
    first = cv2.imread(imgs[0])
    h, w = first.shape[:2]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10,
                             (w, h))
    assert writer.isOpened()
    for i in range(frames):
        writer.write(cv2.resize(cv2.imread(imgs[i % len(imgs)]), (w, h)))
    writer.release()
    return path


def test_make_video_keeps_every_frame(ckpts, synth, tmp_path):
    cfg, ckpt, _, _ = ckpts
    src = _video(synth, str(tmp_path / "in.mp4"), 5)
    out = str(tmp_path / "out.mp4")
    res = cli_video.run(cfg, ckpt, src, out, device="cpu")
    assert res["frames"] == 5 and res["fps"] > 0
    cap = cv2.VideoCapture(out)
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    assert n == 5
    with pytest.raises(FileNotFoundError):
        cli_video.run(cfg, ckpt, str(tmp_path / "missing.mp4"), out,
                      device="cpu")


CLIS = {
    "test": (cli_test, []),
    "inference": (cli_inference, []),
    "make_pred_file": (cli_pred, ["--out", "OUT"]),
    "yolo2coco_pred_file": (cli_coco, ["--json", "ANN"]),
    "make_video": (cli_video, ["--input", "VIDEO", "--output", "OUT"]),
}


def _argv(name, cfg_path, podtpu_cli, video, tmp_path, *extra):
    fill = {"OUT": str(tmp_path / "out.mp4"), "ANN": podtpu_cli["ann"],
            "VIDEO": video}
    return (["--cfg", cfg_path] + [fill.get(a, a) for a in CLIS[name][1]]
            + list(extra))


@pytest.fixture
def cli_env(ckpts, synth, podtpu_cli, tmp_path):
    import yaml

    cfg, ckpt, _, _ = ckpts
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    video = _video(synth, str(tmp_path / "in.mp4"), 2)
    return str(path), ckpt, video


@pytest.fixture(scope="module")
def artifact(ckpts):
    """The checkpoint's serving graph with a symbolic batch, exported on
    the CPU through ``python -m podtpu_torch.cli.export_model``."""
    import yaml

    from podtpu_torch.cli import export_model as cli_export

    cfg, ckpt, _, root = ckpts
    path = root / "export_cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return cli_export.main(["--cfg", str(path), "--ckpt", ckpt,
                            "--with-postprocess", "--batch", "dyn",
                            "--out", str(root / "serve.pt2"),
                            "--device", "cpu"])


def _case(name, extra, check, old_id):
    # the ids of the refusals these cases replaced
    return pytest.param(name, extra, check, id=old_id)


@pytest.mark.parametrize("name,extra,check", [
    _case("test", ["--artifact", "a.savedmodel"], "savedmodel",
          "test-extra0-item 10"),
    _case("test", ["--quantize", "int8", "--ckpt", "CKPT"], "int8",
          "test-extra1-item 10"),
    _case("inference", ["--artifact", "ART"], "runs",
          "inference-extra2-item 10"),
    _case("make_pred_file", ["--artifact", "ART"], "runs",
          "make_pred_file-extra3-item 10"),
    _case("yolo2coco_pred_file", ["--artifact", "ART"], "runs",
          "yolo2coco_pred_file-extra4-item 10"),
    _case("make_video", ["--artifact", "ART"], "runs",
          "make_video-extra5-item 10"),
])
def test_unported_cli_options_raise(cli_env, podtpu_cli, artifact, tmp_path,
                                    capsys, name, extra, check):
    """The options that raised before the export path was ported: a
    ``.savedmodel`` artifact (float32, B=4, written by ``cli.export_model
    --format savedmodel``) scores as podtpu's ``test.py`` on the same
    weights, val_mAP within 1e-6 (as ``--artifact x.pt2``); ``--quantize
    int8`` scores as podtpu's ``test.py --quantize
    int8`` does on the same weights (val_loss 1e-3 relative, measured
    6.1e-4: the two calibrations' scales round apart, and a random-weight
    loss is sensitive to them; val_mAP 1e-3); ``--artifact x.pt2`` runs
    each CLI on the exported graph, with podtpu's detections."""
    cfg_path, ckpt, video = cli_env
    if check == "savedmodel":
        from podtpu_torch.cli import export_model as cli_export

        saved = cli_export.main([
            "--cfg", cfg_path, "--ckpt", ckpt, "--format", "savedmodel",
            "--with-postprocess", "--batch", "4", "--out",
            str(tmp_path / "a.savedmodel"), "--device", "cpu"])
    extra = [{"ART": artifact, "CKPT": ckpt, "a.savedmodel": saved
              if check == "savedmodel" else None}.get(a, a) for a in extra]
    argv = _argv(name, cfg_path, podtpu_cli, video, tmp_path, "--device",
                 "cpu", *extra)
    if check == "savedmodel":
        got = CLIS[name][0].main(argv)
        assert got["val_mAP"] == pytest.approx(
            podtpu_cli["evaluate"]["val_mAP"], abs=1e-6)
        assert "a.savedmodel, batch 4" in capsys.readouterr().out
        return
    if name == "make_pred_file":
        argv[argv.index("--out") + 1] = str(tmp_path / "pred")
    if name == "yolo2coco_pred_file":
        argv += ["--out", str(tmp_path / "results.json")]
    got = CLIS[name][0].main(argv)
    if check == "int8":
        want = podtpu_cli["evaluate_int8"]
        assert "int8 PTQ eval (calibrated on 2 val batches)" in \
            capsys.readouterr().out
        assert got["val_loss"] == pytest.approx(want["val_loss"], rel=1e-3)
        assert got["val_mAP"] == pytest.approx(want["val_mAP"], abs=1e-3)
    elif name == "inference":
        assert len(got) == 6 and all(m > 0 for m in got)
    elif name == "make_pred_file":
        names = sorted(os.listdir(podtpu_cli["pred_dir"]))
        assert sorted(os.listdir(tmp_path / "pred")) == names
        for n in names:
            with open(tmp_path / "pred" / n) as f, \
                    open(os.path.join(podtpu_cli["pred_dir"], n)) as g:
                a, b = f.read().splitlines(), g.read().splitlines()
            assert len(a) == len(b)
            for x, y in zip(a, b):
                _numbers_close(x, y, (6, 2, 2, 2, 2))
    elif name == "yolo2coco_pred_file":
        assert got["n_detections"] == len(podtpu_cli["results"]) > 0
    else:
        assert got["frames"] == 2


def test_test_cli_scores_an_artifact(cli_env, podtpu_cli, artifact, capsys,
                                    monkeypatch):
    """``cli.test --artifact``: the exported graph's val_mAP equals
    ``cli.test --ckpt``'s on the same weights, and podtpu's, within 1e-6
    (tests/test_export.py::test_artifact_eval_matches_trainer_validate);
    each batch both hand the host mAP holds the same annotations and
    detections (a random-weight mAP of 0 alone would not tell)."""
    from podtpu_torch.metrics.map import MeanAveragePrecision

    cfg_path, ckpt, _ = cli_env
    real, fed = MeanAveragePrecision.update_state, []

    def update_state(self, annots, detections, valid):
        fed[-1].append([np.array(a) for a in (annots, detections, valid)])
        return real(self, annots, detections, valid)

    monkeypatch.setattr(MeanAveragePrecision, "update_state", update_state)
    fed.append([])
    got = cli_test.main(["--cfg", cfg_path, "--artifact", artifact])
    fed.append([])
    want = cli_test.main(["--cfg", cfg_path, "--ckpt", ckpt, "--device",
                          "cpu"])
    assert len(fed[0]) == len(fed[1]) > 0
    for (ga, gd, gv), (wa, wd, wv) in zip(*fed):
        np.testing.assert_array_equal(ga, wa)
        np.testing.assert_array_equal(gv, wv)
        np.testing.assert_allclose(gd[gv], wd[wv], rtol=0, atol=1e-4)
    assert sum(int(v.sum()) for _, _, v in fed[0]) > 0
    assert got["val_mAP"] == pytest.approx(want["val_mAP"], abs=1e-6)
    assert got["val_mAP"] == pytest.approx(
        podtpu_cli["evaluate"]["val_mAP"], abs=1e-6)
    assert "artifact val_mAP: " in capsys.readouterr().out
    with pytest.raises(SystemExit):
        cli_test.main(["--cfg", cfg_path, "--artifact", artifact,
                       "--ckpt", ckpt])


@pytest.mark.parametrize("name", list(CLIS))
def test_clis_default_to_cuda(cli_env, podtpu_cli, tmp_path, monkeypatch,
                              name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg_path, ckpt, video = cli_env
    argv = _argv(name, cfg_path, podtpu_cli, video, tmp_path, "--ckpt", ckpt)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CLIS[name][0].main(argv)


@pytest.mark.parametrize("mod", [f"podtpu_torch.cli.{n}" for n in CLIS]
                         + ["podtpu_torch.utils.anchors"])
def test_cli_modules_run_as_scripts(mod, monkeypatch, capsys):
    """``python -m <mod> --help``, run as ``__main__`` in this process."""
    import runpy

    monkeypatch.setattr(sys, "argv", [mod, "--help"])
    monkeypatch.delitem(sys.modules, mod, raising=False)  # run it afresh
    with pytest.raises(SystemExit) as exit_:
        runpy.run_module(mod, run_name="__main__", alter_sys=True)
    assert exit_.value.code == 0
    out = capsys.readouterr().out
    assert "--cfg" in out and ("--device" in out) != mod.endswith("anchors")
