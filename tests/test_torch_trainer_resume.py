"""The port's own checkpoint, resume and preemption behaviour
(``tests/test_torch_trainer.py`` holds the run against podtpu's): a
checkpoint restored bit for bit, two epochs equal to one plus a resume
plus one, and SIGTERM saving ``last``. Files of their own: each trains
the 64 px model for several steps."""

import os
import signal
import threading

import torch

from podtpu_torch.train.run import make_loaders, train
from podtpu_torch.train.trainer import (
    CheckpointIO,
    Trainer,
    put_batch,
    restore_eval_weights,
)
from tests.trainer_common import (  # noqa: F401 (fixtures)
    REPO,
    _cfg,
    _state_tensors,
    drop_checkpoints,
    quiet,
    recording_writer,
    synth,
)


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
