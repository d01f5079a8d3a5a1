"""The port's training run against podtpu's (CPU): the native matcher, mAP,
the eval step, ``Trainer.validate`` and a 2-epoch ``Trainer.fit`` on
``configs/yolov3_voc.yaml``'s recipe at 64 px in float32, from podtpu's
weights carried across through the flat ``.npz`` layout
(tests/torch_parity.py); then the port's checkpoint staging and its
TensorBoard writer. Resume and preemption:
``tests/test_torch_trainer_resume.py``; early stopping, refused options
and the CLI: ``tests/test_torch_trainer_cli.py``.

podtpu's side runs once, in one module fixture (its eval and train steps
are jitted once)."""

import os
import shutil

import numpy as np
import pytest
import torch

from podtpu.data import Loader as JLoader
from podtpu.data import build_datasets as podtpu_build_datasets
from podtpu.metrics import map as jmap
from podtpu.native import native_class_tp_fp as podtpu_native_tp_fp
from podtpu.train.trainer import Trainer as JTrainer
from podtpu_torch.metrics import map as tmap
from podtpu_torch.native import build as native_build
from podtpu_torch.native import native_class_tp_fp
from podtpu_torch.train.run import make_loaders, train
from podtpu_torch.train.steps import make_eval_step
from podtpu_torch.train.trainer import (
    CheckpointIO,
    Trainer,
    put_batch,
)
from tests.torch_parity import flax_variables, podtpu_flat_weights
from tests.trainer_common import (  # noqa: F401 (fixtures)
    _cfg,
    _port_trainer,
    _Scalars,
    drop_checkpoints,
    quiet,
    recording_writer,
    synth,
)


def _rows(rng, n, n_img, n_cls, jitter_from=None):
    rows = np.zeros((n, 7), np.float32)
    if jitter_from is None:
        rows[:, 0] = rng.integers(0, n_img, n)
        rows[:, 1:3] = rng.uniform(0, 400, (n, 2))
        rows[:, 3:5] = rng.uniform(10, 80, (n, 2))
        rows[:, 6] = rng.integers(0, n_cls, n)
    else:
        src = jitter_from[rng.integers(0, len(jitter_from), n)]
        rows[:] = src
        rows[:, 1:5] += rng.normal(0, 6, (n, 4)).astype(np.float32)
        rows[rng.random(n) < 0.2, 6] = rng.integers(0, n_cls)
    rows[:, 5] = rng.uniform(0, 1, n) if jitter_from is not None else 1.0
    return rows


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_matcher_matches_numpy_and_podtpu(seed):
    rng = np.random.default_rng(seed)
    gts = _rows(rng, 120, 20, 1)
    dets = np.concatenate([_rows(rng, 200, 20, 1, jitter_from=gts),
                           _rows(rng, 100, 20, 1)])
    dets[200:, 5] = rng.uniform(0, 1, 100)
    dets = dets[np.argsort(-dets[:, 5], kind="stable")]
    got = native_class_tp_fp(dets, gts, 0.5)
    plain = tmap._class_tp_fp_numpy(dets, gts, 0.5)
    want = podtpu_native_tp_fp(dets, gts, 0.5)
    assert want is not None
    assert got[0].sum() > 10 and got[1].sum() > 10
    for g, p, w in zip(got, plain, want):
        np.testing.assert_array_equal(g, p)
        np.testing.assert_array_equal(g, w)
    # unsorted input through _class_tp_fp: native and plain alike
    shuffled = dets[rng.permutation(len(dets))]
    for g, p in zip(tmap._class_tp_fp(shuffled, gts, 0.5),
                    tmap._class_tp_fp_numpy(shuffled, gts, 0.5)):
        np.testing.assert_array_equal(g, p)


def test_native_build_is_keyed_and_raises_on_failure(tmp_path, monkeypatch):
    path = native_build._target()
    assert os.path.dirname(path).endswith(os.path.join("podtpu_torch",
                                                       "_build"))
    native_build.get_lib()
    assert os.path.exists(path)
    bad = tmp_path / "map_matcher.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_build, "_SRC", str(bad))
    monkeypatch.setattr(native_build, "BUILD_DIR", str(tmp_path / "b"))
    monkeypatch.setattr(native_build, "_LIB", None)
    assert native_build._target() != path  # the digest follows the source
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native_build.get_lib()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_map_matches_podtpu(seed):
    rng = np.random.default_rng(seed)
    true = _rows(rng, 80, 10, 5)
    pred = np.concatenate([_rows(rng, 120, 10, 5, jitter_from=true),
                           _rows(rng, 40, 10, 5)])
    pred[120:, 5] = rng.uniform(0, 1, 40)
    assert tmap.mean_average_precision(true, pred, 6) == \
        jmap.mean_average_precision(true, pred, 6)
    np.testing.assert_array_equal(tmap.metrics_per_class(true, pred, 6),
                                  jmap.metrics_per_class(true, pred, 6))
    # the accumulator, from padded batches as the eval step gives them
    size = 416
    metrics = (tmap.MeanAveragePrecision(5, size),
               jmap.MeanAveragePrecision(5, size))
    for _ in range(3):
        annots = np.full((4, 6, 5), -1.0, np.float32)
        dets = np.zeros((4, 10, 6), np.float32)
        for b in range(4):
            n = int(rng.integers(0, 6))
            annots[b, :n, :4] = rng.uniform(0.1, 0.6, (n, 4))
            annots[b, :n, 4] = rng.integers(0, 5, n)
            for j in range(10):
                src = annots[b, j % max(n, 1), :4] * size if n else \
                    rng.uniform(0, 200, 4)
                dets[b, j, :4] = src + rng.normal(0, 4, 4)
                dets[b, j, 4] = rng.uniform(0.25, 1)
                dets[b, j, 5] = annots[b, j % n, 4] if n else 0
        valid = rng.random((4, 10)) < 0.7
        for m in metrics:
            m.update_state(annots, dets, valid)
    (got, want) = metrics
    assert got.img_idx == want.img_idx == 12
    assert got.result() == want.result() > 0
    np.testing.assert_array_equal(got.result_per_class(),
                                  want.result_per_class())
    got.reset_states()
    assert got.result() == 0.0 and got.img_idx == 0


@pytest.fixture(scope="module")
def podtpu_run(synth, tmp_path_factory):
    """podtpu's eval step on the first val batch, ``validate`` and a
    2-epoch ``fit``, all from the same seeded weights."""
    runs = tmp_path_factory.mktemp("podtpu_runs")
    cfg = _cfg(synth, runs, save_freq=100)
    flat = podtpu_flat_weights(cfg, seed=3)
    trainer = JTrainer(cfg, log=quiet, use_mesh=False)
    trainer._writer = _Scalars()
    variables = flax_variables(flat)
    trainer.state = trainer.state.replace(
        params=variables["params"], batch_stats=variables["batch_stats"])
    train_ds, val_ds = podtpu_build_datasets(cfg)
    train_l = JLoader(train_ds, batch_size=4, shuffle=True, max_annots=8,
                      workers=2, seed=cfg["seed"])
    val_l = JLoader(val_ds, batch_size=4, shuffle=False, max_annots=8,
                    workers=2)
    batch = next(iter(val_l))
    batch.pop("n_valid")
    loss, dets, valid = trainer.eval_step(trainer.state,
                                          trainer._put(batch))
    eval_out = (float(loss), np.asarray(dets), np.asarray(valid))
    val = trainer.validate(val_l)
    history = trainer.fit(train_l, val_l, epochs=2)
    yield cfg, flat, batch, eval_out, val, history
    shutil.rmtree(runs, ignore_errors=True)


def test_eval_step_matches_podtpu(podtpu_run, tmp_path):
    cfg, flat, batch, (j_loss, j_dets, j_valid), _, _ = podtpu_run
    trainer = _port_trainer(dict(cfg, save_dir=str(tmp_path)), flat,
                            eval_only=True)
    state = trainer.state
    step = make_eval_step(cfg)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    loss, dets, valid = step(state, put_batch(batch, trainer.device))
    assert float(loss) == pytest.approx(j_loss, rel=1e-5)
    assert dets.shape == (4, 100, 6) and valid.dtype == torch.bool
    np.testing.assert_array_equal(valid.numpy(), j_valid)
    assert valid.sum() > 0
    v = j_valid
    np.testing.assert_allclose(dets.numpy()[v][:, :4], j_dets[v][:, :4],
                               atol=1e-3)
    np.testing.assert_allclose(dets.numpy()[v][:, 4:], j_dets[v][:, 4:],
                               atol=1e-5)
    # the eval step leaves the state as it was, the train mode included
    assert state.model.training and state.step == 0
    for k, t in state.model.state_dict().items():
        assert torch.equal(t, before[k]), k


def test_validate_matches_podtpu(podtpu_run, tmp_path):
    cfg, flat, _, _, j_val, _ = podtpu_run
    cfg = dict(cfg, save_dir=str(tmp_path))
    trainer = _port_trainer(cfg, flat, eval_only=True)
    _, val_loader = make_loaders(cfg)
    got = trainer.validate(val_loader)
    assert set(got) == {"val_loss", "val_mAP"}
    assert got["val_loss"] == pytest.approx(j_val["val_loss"], rel=1e-5)
    assert got["val_mAP"] == pytest.approx(j_val["val_mAP"], abs=1e-6)
    # 6 images scored once each: the padded final batch is sliced off
    assert trainer.map_metric.img_idx == 6
    assert trainer.ckpt is None and trainer.run_dir is None


def test_fit_two_epochs_matches_podtpu(podtpu_run, tmp_path):
    """With burn-in 1000, the four updates take lr <= 1e-3 * (3/1000)^4, so
    the weights do not move measurably: the rows differ only by the convs'
    float32 summation order, through the batch statistics (train loss) and
    the running statistics they leave behind (val loss). Limits: train and
    val loss 1e-4 relative, val_mAP 1e-6; lr and step exactly."""
    cfg, flat, _, _, _, j_hist = podtpu_run
    cfg = dict(cfg, save_dir=str(tmp_path))
    trainer = _port_trainer(cfg, flat)
    train_loader, val_loader = make_loaders(cfg)
    hist = trainer.fit(train_loader, val_loader, epochs=2)
    assert [r["epoch"] for r in hist] == [r["epoch"] for r in j_hist] == [0, 1]
    for got, want in zip(hist, j_hist):
        assert got["step"] == want["step"]
        assert got["lr"] == want["lr"]
        assert got["train_loss"] == pytest.approx(want["train_loss"],
                                                  rel=1e-4)
        assert got["val_loss"] == pytest.approx(want["val_loss"], rel=1e-4)
        assert got["val_mAP"] == pytest.approx(want["val_mAP"], abs=1e-6)
        assert got["images_per_sec"] > 0
    ckpts = os.listdir(os.path.join(trainer.run_dir, "checkpoints"))
    assert {"last", "best"} <= set(ckpts)


def _touch_ckpt(path):
    os.makedirs(path)
    open(os.path.join(path, "state.pt"), "w").close()


def test_resolve_after_staging_and_old_leftovers(tmp_path):
    d = tmp_path / "ck"
    io = CheckpointIO(str(d))
    last = str(d / "last")
    assert CheckpointIO._resolve(last) == last  # nothing there
    _touch_ckpt(last + ".old")  # a swap died between its two renames
    assert CheckpointIO._resolve(last) == last + ".old"
    _touch_ckpt(last)
    assert CheckpointIO._resolve(last) == last
    _touch_ckpt(last + ".staging")  # a complete staged save is the newest
    assert CheckpointIO._resolve(last) == last + ".staging"
    io._finalize("last")  # the swap: staging becomes last, old goes
    assert sorted(os.listdir(d)) == ["last"]


def test_named_save_swaps_staging_into_place(synth, tmp_path):
    cfg = _cfg(synth, tmp_path)
    trainer = Trainer(cfg, device="cpu", log=quiet)
    d = os.path.join(trainer.run_dir, "checkpoints")
    trainer.ckpt.save("best", trainer.state)
    _touch_ckpt(os.path.join(d, "best.staging"))  # left by a killed save
    trainer.state.step = 7
    trainer.ckpt.save("best", trainer.state)
    assert sorted(os.listdir(d)) == ["best"]
    restored = trainer.ckpt.restore(os.path.join(d, "best"),
                                    Trainer(cfg, device="cpu", log=quiet,
                                            eval_only=True).state)
    assert restored.step == 7


def test_prune_periodic_orders_numerically(tmp_path):
    io = CheckpointIO(str(tmp_path / "ck"))
    d = tmp_path / "ck"
    for name in ("epoch_0001", "epoch_9999", "epoch_10000",
                 "epoch_10000.tmp-123", "last", "best"):
        (d / name).mkdir()
    io.prune_periodic(0)  # keep <= 0: nothing pruned
    assert len(os.listdir(d)) == 6
    io.prune_periodic(1)
    left = set(os.listdir(d))
    assert "epoch_10000" in left  # the numeric newest
    assert "epoch_9999" not in left and "epoch_0001" not in left
    assert {"epoch_10000.tmp-123", "last", "best"} <= left


def test_entry_points_default_to_cuda(synth, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _cfg(synth, tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, log=quiet)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(cfg)


def test_fit_writes_the_scalars(podtpu_run, tmp_path, recording_writer):
    """train_loss, lr, images_per_sec each epoch; val_loss, val_mAP and
    one val_AP/<class> per class (named from cfg ``names``) each
    validation."""
    cfg, flat, _, _, _, _ = podtpu_run
    cfg = dict(cfg, save_dir=str(tmp_path), epochs=1)
    trainer = _port_trainer(cfg, flat)
    trainer.fit(*make_loaders(cfg))
    (writer,) = recording_writer
    tags = [t for t, _, _ in writer.scalars]
    assert tags[:3] == ["train_loss", "lr", "images_per_sec"]
    assert tags[3:5] == ["val_loss", "val_mAP"]
    assert tags[5:] == [f"val_AP/class{i}" for i in range(20)]
    assert {s for _, _, s in writer.scalars} == {2}
    ap = dict((t, v) for t, v, _ in writer.scalars)
    per_class = trainer.map_metric.result_per_class()
    assert [ap[f"val_AP/class{i}"] for i in range(20)] == \
        [float(r[0]) for r in per_class]


def test_writer_without_tensorboard_is_a_no_op(synth, tmp_path, monkeypatch):
    import sys

    monkeypatch.undo()  # the real ``writer`` property
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    trainer = Trainer(_cfg(synth, tmp_path), device="cpu", log=quiet,
                      eval_only=True)
    writer = trainer.writer
    writer.add_scalar("x", 1.0, 0)
    writer.flush()
    assert trainer.writer is writer
