"""The port's training run against podtpu's (CPU): the native matcher, mAP,
the eval step, ``Trainer.validate`` and a 2-epoch ``Trainer.fit`` on
``configs/yolov3_voc.yaml``'s recipe at 64 px in float32, from podtpu's
weights carried across through the flat ``.npz`` layout
(tests/torch_parity.py); then the port's own checkpoint, resume,
preemption and early-stopping behaviour.

podtpu's side runs once, in one module fixture (its eval and train steps
are jitted once)."""

import os
import shutil
import signal
import threading

import numpy as np
import pytest
import torch

from podtpu.data import Loader as JLoader
from podtpu.data import build_datasets as podtpu_build_datasets
from podtpu.metrics import map as jmap
from podtpu.native import native_class_tp_fp as podtpu_native_tp_fp
from podtpu.train.trainer import Trainer as JTrainer
from podtpu_torch.config import get_configs
from podtpu_torch.data.synthetic import generate
from podtpu_torch.export.weights import load_flat_weights
from podtpu_torch.metrics import map as tmap
from podtpu_torch.native import build as native_build
from podtpu_torch.native import native_class_tp_fp
from podtpu_torch.train.run import make_loaders, train
from podtpu_torch.train.steps import make_eval_step
from podtpu_torch.train.trainer import (
    CheckpointIO,
    Trainer,
    put_batch,
    restore_eval_weights,
)
from tests.torch_parity import flax_variables, podtpu_flat_weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
quiet = lambda *_: None  # noqa: E731


class _Scalars:
    """A TensorBoard writer that records ``add_scalar`` calls."""

    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), int(step)))

    def flush(self):
        pass


@pytest.fixture(autouse=True)
def recording_writer(monkeypatch):
    """Each Trainer of this file writes its scalars to a :class:`_Scalars`
    (importing TensorBoard costs seconds); ``test_writer_*`` check the
    real property."""
    writers = []

    def make(trainer):
        if trainer._writer is None:
            trainer._writer = _Scalars()
            writers.append(trainer._writer)
        return trainer._writer

    monkeypatch.setattr(Trainer, "writer", property(make))
    return writers


@pytest.fixture(autouse=True)
def drop_checkpoints(tmp_path):
    """A checkpoint of the 64 px model is ~280 MB: each test's files go
    when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    out = tmp_path_factory.mktemp("synth")
    return generate(str(out), n_train=8, n_val=6, size=80, num_classes=20,
                    max_objects=3, seed=1)


def _cfg(synth, save_dir, **extra):
    """configs/yolov3_voc.yaml's recipe (nesterov SGD, yolo_lr with burn-in
    1000, 20 classes) at 64 px, float32, B=4: 2 train steps an epoch, and
    a ragged second val batch (6 = 4 + 2)."""
    cfg = get_configs(os.path.join(REPO, "configs", "yolov3_voc.yaml"))
    cfg.update(input_size=64, compute_dtype="float32", batch_size=4,
               workers=2, max_annots=8, epochs=2, save_freq=1,
               trainer_options={"check_val_every_n_epoch": 1},
               train_list=synth["train_list"], val_list=synth["val_list"],
               names=synth["names"], save_dir=str(save_dir))
    cfg.update(extra)
    return cfg


def _port_trainer(cfg, flat, **kw):
    trainer = Trainer(cfg, device="cpu", log=quiet, **kw)
    load_flat_weights(trainer.state.model, flat)
    return trainer


# ---- the matcher and mAP --------------------------------------------------

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


# ---- podtpu's run, once ---------------------------------------------------

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


# ---- the port's own checkpoint / resume / preemption behaviour ------------

def _state_tensors(state):
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    for i, (p, st) in enumerate(state.optimizer.state.items()):
        out[f"momentum.{i}"] = st["momentum_buffer"]
    return out


def test_checkpoint_restore_is_bitwise(synth, tmp_path):
    cfg = _cfg(synth, tmp_path, scheduler=None)  # constant lr 1e-3
    trainer = Trainer(cfg, device="cpu", log=quiet)
    train_loader, _ = make_loaders(cfg)
    for batch in train_loader:
        batch.pop("n_valid")
        trainer.state, _ = trainer.train_step(
            trainer.state, put_batch(batch, trainer.device))
    trainer.ckpt.save("last", trainer.state)
    trainer.ckpt.save("epoch_0000", trainer.state)
    saved = _state_tensors(trainer.state)
    assert len([k for k in saved if k.startswith("momentum")]) == len(
        list(trainer.state.model.parameters()))

    fresh = Trainer(cfg, device="cpu", log=quiet, run_dir=str(tmp_path / "r2"))
    assert fresh.state.step == 0
    for name in ("last", "epoch_0000"):
        path = os.path.join(trainer.run_dir, "checkpoints", name)
        state = fresh.ckpt.restore(path, fresh.state)
        assert state.step == trainer.state.step == 2
        got = _state_tensors(state)
        assert set(got) == set(saved)
        dev = next(state.model.parameters()).device
        for k, v in saved.items():
            assert got[k].device == dev, k
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k

    # weights only: parameters and BN statistics, not the optimizer or step
    other = Trainer(cfg, device="cpu", log=quiet, eval_only=True)
    restore_eval_weights(os.path.join(trainer.run_dir, "checkpoints", "last"),
                         other.state, cfg)
    assert other.state.step == 0 and not other.state.optimizer.state
    for k, v in trainer.state.model.state_dict().items():
        assert torch.equal(other.state.model.state_dict()[k], v), k


def test_two_epochs_equal_one_plus_resume_plus_one(synth, tmp_path):
    cfg = _cfg(synth, tmp_path, scheduler=None, save_freq=100)
    straight = train(dict(cfg, epochs=2), device="cpu")
    first = train(dict(cfg, epochs=1), device="cpu")
    last = os.path.join(first.run_dir, "checkpoints", "last")
    resumed = train(dict(cfg, epochs=2), resume=last, device="cpu")
    assert [r["epoch"] for r in resumed.history] == [1]
    for key in ("step", "train_loss", "lr", "val_loss", "val_mAP"):
        assert resumed.history[0][key] == straight.history[1][key], key
    want, got = (_state_tensors(t.state) for t in (straight, resumed))
    for k, v in want.items():
        assert torch.equal(got[k], v), k


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


def test_sigterm_saves_last_and_fit_returns(synth, tmp_path):
    cfg = _cfg(synth, tmp_path, save_freq=100)
    train_loader, val_loader = make_loaders(cfg)
    trainer = Trainer(cfg, device="cpu", log=quiet)
    fired = threading.Event()

    def fire_when_training():
        while trainer.state.step < 1:
            fired.wait(0.05)
        os.kill(os.getpid(), signal.SIGTERM)

    before = signal.getsignal(signal.SIGTERM)
    t = threading.Thread(target=fire_when_training, daemon=True)
    t.start()
    history = trainer.fit(train_loader, val_loader, epochs=1000)
    t.join(5)
    assert len(history) < 1000
    ckpt_dir = os.path.join(trainer.run_dir, "checkpoints")
    fresh = Trainer(cfg, device="cpu", log=quiet, eval_only=True)
    state = CheckpointIO(ckpt_dir).restore(os.path.join(ckpt_dir, "last"),
                                           fresh.state)
    assert state.step == trainer.state.step > 0
    assert signal.getsignal(signal.SIGTERM) == before


def test_second_sigterm_escalates():
    """The real handler in a child process: the first SIGTERM sets the
    flag, the second kills with the default action."""
    import subprocess
    import sys

    child = (
        "import signal, sys, threading, time\n"
        "sys.path.insert(0, %r)\n"
        "from podtpu_torch.train.trainer import make_preempt_handler\n"
        "ev = threading.Event()\n"
        "signal.signal(signal.SIGTERM, make_preempt_handler(ev))\n"
        "print('READY', flush=True)\n"
        "while not ev.is_set():\n"
        "    time.sleep(0.05)\n"
        "print('FLAG', flush=True)\n"
        "time.sleep(60)\n" % REPO)
    p = subprocess.Popen([sys.executable, "-c", child],
                         stdout=subprocess.PIPE, text=True)
    try:
        assert p.stdout.readline().strip() == "READY"
        p.send_signal(signal.SIGTERM)
        assert p.stdout.readline().strip() == "FLAG"
        assert p.poll() is None
        p.send_signal(signal.SIGTERM)
        assert p.wait(timeout=10) == -signal.SIGTERM
    finally:
        if p.poll() is None:
            p.kill()


def test_early_stopping_counts_validation_rounds(synth, tmp_path,
                                                 monkeypatch):
    """Patience 1: the first round that does not lower val_loss stops the
    run; ``best`` is saved on each new low."""
    cfg = _cfg(synth, tmp_path, early_stopping_patience=1, save_freq=100)
    train_loader, val_loader = make_loaders(cfg)
    trainer = Trainer(cfg, device="cpu", log=quiet)
    losses = iter([3.0, 2.0, 2.5, 1.0])
    saved = []
    monkeypatch.setattr(trainer, "validate",
                        lambda _: {"val_loss": next(losses), "val_mAP": 0.0})
    save = trainer.ckpt.save
    monkeypatch.setattr(trainer.ckpt, "save",
                        lambda name, st: (saved.append((name, st.step)),
                                          save(name, st)))
    history = trainer.fit(train_loader, val_loader, epochs=10)
    assert [r["val_loss"] for r in history] == [3.0, 2.0, 2.5]
    assert [s for s in saved if s[0] == "best"] == [("best", 2), ("best", 4)]
    assert [s for s in saved if s[0] == "last"] == [("last", 2), ("last", 4),
                                                    ("last", 6)]


def test_unported_eval_options_raise(synth, tmp_path):
    """``make_eval_step(extra_variables={"quant": ...})`` (the int8 eval of
    ``cli.test --quantize``, no longer refused): the quant state is in
    place for the call only (the state's keys and mode come back), its
    detections are those of the model with the state installed, and they
    differ from the float model's; another collection raises."""
    from podtpu_torch.export import quantize
    from podtpu_torch.train.state import create_train_state
    from podtpu_torch.train.trainer import put_batch

    cfg = _cfg(synth, tmp_path)
    # seeded He-normal weights: torch's default init shrinks the heads to
    # ~0, where int8 and float agree to the bit
    state = create_train_state(cfg, "cpu",
                               weights=podtpu_flat_weights(cfg, seed=2))
    batch = next(iter(make_loaders(cfg)[1]))
    batch.pop("n_valid", None)
    batch = put_batch(batch, torch.device("cpu"))
    qvars = quantize.build_quant_variables(
        state.model, quantize.calibrate(state.model,
                                        [batch["img"].float() / 255.0]))
    keys = set(state.model.state_dict())
    loss, dets, valid = make_eval_step(cfg, extra_variables=qvars)(state,
                                                                   batch)
    assert set(state.model.state_dict()) == keys and state.model.training
    assert torch.isfinite(loss)
    with quantize.quant_scope(state.model, qvars["quant"]):
        want = make_eval_step(cfg)(state, batch)
    assert torch.equal(loss, want[0]) and torch.equal(dets, want[1])
    assert torch.equal(valid, want[2])
    float_loss = make_eval_step(cfg)(state, batch)[0]
    assert not torch.equal(loss, float_loss)
    with pytest.raises(ValueError, match="quant"):
        make_eval_step(cfg, extra_variables={"quant_stats": {}})


def test_entry_points_default_to_cuda(synth, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _cfg(synth, tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, log=quiet)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(cfg)


def test_cli_trains_on_the_cpu(synth, tmp_path, monkeypatch, capsys):
    """``python -m podtpu_torch.train.run --cfg ... --device cpu`` on a
    synthetic set (its ``main``, in this process): one epoch, validated,
    checkpoints written."""
    import sys

    import yaml

    from podtpu_torch.train import run

    cfg = _cfg(synth, tmp_path / "runs", epochs=1)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    monkeypatch.setattr(sys, "argv", ["run", "--cfg", str(path),
                                      "--device", "cpu"])
    run.main()
    out = capsys.readouterr().out
    assert "Total trainable params" in out
    assert "epoch 0:" in out and "val_mAP=" in out
    ckpts = tmp_path / "runs" / "yolov3_voc" / "version_0" / "checkpoints"
    assert {"last", "best", "epoch_0000"} <= set(os.listdir(ckpts))


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
