"""The trainer's tail (CPU): asynchronous checkpoints
(``CheckpointIO(async_save=True)``, cfg ``async_checkpoint``), the partial
weight load of cfg ``backbone_pretrained`` against podtpu's
``load_npz_weights(allow_partial=True)``, and the step profile's
attribution."""

import dataclasses
import os
import re
import signal
import threading
import time

import numpy as np
import pytest
import torch

from podtpu.export.weights import load_npz_weights as podtpu_load_npz
from podtpu.export.weights import save_npz_weights as podtpu_save_npz
from podtpu_torch.config import get_configs
from podtpu_torch.export.weights import flat_from_state_dict, load_npz_weights
from podtpu_torch.models.layers import BatchNormMixed
from podtpu_torch.train.run import make_loaders
from podtpu_torch.train.state import TrainState, create_train_state
from podtpu_torch.train.trainer import CheckpointIO, Trainer
from podtpu_torch.utils.step_profile import profile_steps
from tests.torch_parity import flax_variables, podtpu_flat_weights, yolo_cfg
from tests.torch_parity import synth  # noqa: F401  (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
quiet = lambda *_: None  # noqa: E731


def _tiny_state(seed: int = 0) -> TrainState:
    """A conv + BN model with momentum buffers after one update."""
    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Conv2d(3, 8, 3, bias=False),
                                BatchNormMixed(8)).train()
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    model(torch.randn(2, 3, 6, 6)).square().mean().backward()
    opt.step()
    return TrainState(model, opt, lambda step: 0.1, step=3)


def _snapshot(state):
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            {k: v["momentum_buffer"].clone()
             for k, v in state.optimizer.state_dict()["state"].items()},
            state.step)


def _assert_state(state, snap):
    sd, mom, step = snap
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    for k, v in state.optimizer.state_dict()["state"].items():
        assert torch.equal(v["momentum_buffer"], mom[k]), k
    assert state.step == step


def _gated_torch_save(monkeypatch, pattern):
    """``torch.save`` that holds the files whose path matches ``pattern``
    (a checkpoint's temporary directory already made) until ``gate`` is
    set; ``held`` is set once such a write is waiting. Returns (gate,
    held)."""
    gate, held, save = threading.Event(), threading.Event(), torch.save

    def gated(obj, path, *a, **kw):
        if re.search(pattern, str(path)):
            held.set()
            assert gate.wait(10)
        return save(obj, path, *a, **kw)

    monkeypatch.setattr(torch, "save", gated)
    return gate, held


class _GatedWrite:
    """``CheckpointIO._write`` that holds the writes whose target matches
    ``pattern`` until ``gate`` is set, and records every write's start and
    end."""

    def __init__(self, pattern):
        self.pattern, self.gate, self.log = pattern, threading.Event(), []
        self._write = CheckpointIO._write

    def __call__(self, target, payload):
        name = os.path.basename(target)
        self.log.append(("start", name))
        if re.search(self.pattern, name):
            assert self.gate.wait(10)
        self._write(target, payload)
        self.log.append(("end", name))


# ---- asynchronous checkpoints ----------------------------------------------

def test_async_and_sync_saves_restore_to_equal_states(tmp_path):
    state = _tiny_state()
    snap = _snapshot(state)
    sync = CheckpointIO(str(tmp_path / "sync"))
    io = CheckpointIO(str(tmp_path / "async"), async_save=True)
    for name in ("last", "best", "epoch_0001"):
        sync.save(name, state)
        io.save(name, state)
    # the next update, in place, before the writes land: the saves hold
    # the state as it was when save returned
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
        for buf in state.model.buffers():
            buf.mul_(3.0)
        for s in state.optimizer.state.values():
            s["momentum_buffer"].add_(1.0)
    io.wait()
    assert sorted(os.listdir(tmp_path / "async")) == sorted(
        os.listdir(tmp_path / "sync")) == ["best", "epoch_0001", "last"]
    for name in ("last", "best", "epoch_0001"):
        for root in ("sync", "async"):
            fresh = _tiny_state(seed=1)
            CheckpointIO(str(tmp_path / root)).restore(
                str(tmp_path / root / name), fresh)
            _assert_state(fresh, snap)


def test_second_save_of_a_target_drains_the_first(tmp_path, monkeypatch):
    gated = _GatedWrite(r"^last\.staging")
    monkeypatch.setattr(CheckpointIO, "_write", staticmethod(gated))
    state = _tiny_state()
    io = CheckpointIO(str(tmp_path), async_save=True)
    io.save("last", state)  # returns with its write held
    io.save("best", state)  # another target: overlaps, lands on its own
    deadline = time.time() + 10
    while ("end", "best.staging") not in gated.log and time.time() < deadline:
        time.sleep(0.01)
    assert ("end", "best.staging") in gated.log
    state.step = 4
    again = threading.Thread(target=io.save, args=("last", state))
    again.start()
    again.join(0.3)
    assert again.is_alive()  # waiting for the first write of "last"
    gated.gate.set()
    again.join(10)
    assert not again.is_alive()
    io.wait()
    lasts = [e for e in gated.log if e[1] == "last.staging"]
    assert lasts == [("start", "last.staging"), ("end", "last.staging")] * 2
    fresh = _tiny_state(seed=1)
    io.restore(str(tmp_path / "last"), fresh)
    assert fresh.step == 4
    assert sorted(os.listdir(tmp_path)) == ["best", "last"]


def test_prune_periodic_leaves_a_write_in_flight(tmp_path, monkeypatch):
    gate, held = _gated_torch_save(monkeypatch, r"epoch_0003")
    state = _tiny_state()
    io = CheckpointIO(str(tmp_path), async_save=True)
    for epoch in range(3):
        io.save(f"epoch_{epoch:04d}", state)
    io.wait()
    io.save("epoch_0003", state)
    assert held.wait(10)  # its temporary directory is made, its file held
    io.prune_periodic(2)
    left = sorted(os.listdir(tmp_path))
    # the newest two committed ones stay; the one in flight is not counted
    assert [d for d in left if re.fullmatch(r"epoch_\d+", d)] == [
        "epoch_0001", "epoch_0002"]
    assert any(d.startswith("epoch_0003.tmp-") for d in left)
    gate.set()
    io.wait()
    io.prune_periodic(2)
    assert sorted(os.listdir(tmp_path)) == ["epoch_0002", "epoch_0003"]


def test_saves_of_one_state_share_its_host_copy(tmp_path, monkeypatch):
    gated = _GatedWrite(r"^last\.staging")
    monkeypatch.setattr(CheckpointIO, "_write", staticmethod(gated))
    copies = []
    to_host = CheckpointIO._to_host

    def counted(self, key, payload):
        before = [b.clone() for b in self._host["buffers"]]
        out = to_host(self, key, payload)
        copies.append(any(not torch.equal(a, b) for a, b in
                          zip(before, self._host["buffers"]))
                      or not before)
        return out

    monkeypatch.setattr(CheckpointIO, "_to_host", counted)
    state = _tiny_state()
    snap = _snapshot(state)
    io = CheckpointIO(str(tmp_path), async_save=True)
    io.save("last", state)  # its write held, reading the host copy
    io.save("best", state)  # the same state: shares the copy, no wait
    io.save("epoch_0000", state)
    assert copies == [True, False, False]
    with torch.no_grad():  # the next update, in place
        for p in state.model.parameters():
            p.add_(1.0)
    state.step = 4
    again = threading.Thread(target=io.save, args=("epoch_0001", state))
    again.start()
    again.join(0.3)
    assert again.is_alive()  # a changed state waits for the copy's readers
    gated.gate.set()
    again.join(10)
    assert not again.is_alive() and copies[-1]
    io.wait()
    for name, want in (("last", snap), ("best", snap), ("epoch_0000", snap),
                       ("epoch_0001", _snapshot(state))):
        fresh = _tiny_state(seed=1)
        io.restore(str(tmp_path / name), fresh)
        _assert_state(fresh, want)


def test_a_writer_error_is_raised_at_the_next_wait_and_save(tmp_path,
                                                            monkeypatch):
    def broken(target, payload):
        raise OSError("disk full")

    monkeypatch.setattr(CheckpointIO, "_write", staticmethod(broken))
    state = _tiny_state()
    io = CheckpointIO(str(tmp_path), async_save=True)
    io.save("last", state)  # the error stays in the writer
    with pytest.raises(RuntimeError, match="last.staging") as err:
        io.wait()
    assert isinstance(err.value.__cause__, OSError)
    io.wait()  # raised once
    io.save("epoch_0001", state)
    io._drain("periodic")
    with pytest.raises(RuntimeError, match="epoch_0001"):
        io.save("best", state)


def _v4tiny_cfg(synth, save_dir, **extra):
    cfg = get_configs(os.path.join(REPO, "configs", "yolov4-tiny_voc.yaml"))
    cfg.update(input_size=64, compute_dtype="float32", batch_size=4,
               workers=2, max_annots=8, steps_per_dispatch=1, save_freq=100,
               trainer_options={"check_val_every_n_epoch": 1},
               train_list=synth["train_list"], val_list=synth["val_list"],
               names=synth["names"], save_dir=str(save_dir), **extra)
    return cfg


def test_sigterm_drains_async_writes(synth, tmp_path):  # noqa: F811
    cfg = _v4tiny_cfg(synth, tmp_path, async_checkpoint=True)
    train_loader, val_loader = make_loaders(cfg)
    trainer = Trainer(cfg, device="cpu", log=quiet)
    ckpt_dir = os.path.join(trainer.run_dir, "checkpoints")
    at_log = []

    def log(msg):
        if msg.startswith("SIGTERM"):
            at_log.append((dict(trainer.ckpt._writers),
                           sorted(os.listdir(ckpt_dir))))

    trainer.log = log

    def fire_when_training():
        while trainer.state.step < 1:
            time.sleep(0.02)
        os.kill(os.getpid(), signal.SIGTERM)

    t = threading.Thread(target=fire_when_training, daemon=True)
    t.start()
    history = trainer.fit(train_loader, val_loader, epochs=1000)
    t.join(5)
    assert len(history) < 1000 and len(at_log) == 1
    writers, files = at_log[0]
    assert writers == {} and "last" in files and "last.staging" not in files
    fresh = Trainer(cfg, device="cpu", log=quiet, eval_only=True)
    state = CheckpointIO(ckpt_dir).restore(os.path.join(ckpt_dir, "last"),
                                           fresh.state)
    assert state.step == trainer.state.step > 0


# ---- backbone_pretrained: the partial weight load -----------------------------

@dataclasses.dataclass
class _PodtpuState:
    """What podtpu's npz functions read and replace of a train state."""
    params: dict
    batch_stats: dict
    ema: object = None

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def _partial_npz(tmp_path, cfg):
    """podtpu's ``save_npz_weights`` file with the heads' keys dropped and
    a key the model does not have added."""
    flat = podtpu_flat_weights(cfg, seed=5)
    full = str(tmp_path / "full.npz")
    podtpu_save_npz(_PodtpuState(**flax_variables(flat)), full)
    with np.load(full) as data:
        kept = {k: data[k] for k in data.files if "_head" not in k}
    assert 0 < len(kept) < len(flat)
    kept["params::extra_neck::conv::kernel"] = np.ones((1, 1, 3, 3),
                                                       np.float32)
    path = str(tmp_path / "backbone.npz")
    np.savez(path, **kept)
    return path, kept


def _sgd_cfg():
    return yolo_cfg("float32", 64, optimizer="sgd",
                    optimizer_options={"lr": 1e-3, "momentum": 0.9,
                                       "nesterov": True}, scheduler=None)


def test_backbone_pretrained_loads_what_the_file_has(tmp_path, capsys):
    cfg = _sgd_cfg()
    path, kept = _partial_npz(tmp_path, cfg)
    init = _PodtpuState(**flax_variables(podtpu_flat_weights(cfg, seed=6)))
    capsys.readouterr()
    podtpu_load_npz(init, path, allow_partial=True)
    want_line = capsys.readouterr().out.strip()
    assert want_line.startswith("partial load: ")

    torch.manual_seed(0)
    state = create_train_state(dict(cfg, backbone_pretrained=path), "cpu")
    got_line = capsys.readouterr().out.strip()
    assert got_line == want_line
    torch.manual_seed(0)
    fresh = flat_from_state_dict(create_train_state(cfg, "cpu").model)
    got = flat_from_state_dict(state.model)
    assert set(got) == set(fresh)
    n_loaded = 0
    for key, value in got.items():
        if key in kept:
            np.testing.assert_array_equal(value, kept[key], err_msg=key)
            n_loaded += 1
        else:
            np.testing.assert_array_equal(value, fresh[key], err_msg=key)
    assert re.match(rf"partial load: {n_loaded}/{len(got)} leaves", got_line)


def test_partial_load_checks_shapes_and_strict_load_raises(tmp_path):
    cfg = _sgd_cfg()
    path, kept = _partial_npz(tmp_path, cfg)
    model = create_train_state(cfg, "cpu").model
    with pytest.raises(KeyError, match="missing"):
        load_npz_weights(model, path)
    full = flat_from_state_dict(model)
    with pytest.raises(KeyError, match="no place"):
        load_npz_weights_from(tmp_path / "extra.npz",
                              dict(full, **{"params::x::kernel": kept[
                                  "params::extra_neck::conv::kernel"]}),
                              model)
    key = next(k for k in kept if k.endswith("conv::kernel"))
    bad = dict(kept, **{key: kept[key][..., :1]})
    with pytest.raises(ValueError, match="shape mismatch"):
        load_npz_weights_from(tmp_path / "bad.npz", bad, model,
                              allow_partial=True)


def load_npz_weights_from(path, flat, model, allow_partial=False):
    np.savez(path, **flat)
    return load_npz_weights(model, str(path), allow_partial=allow_partial)


# ---- the step profile ----------------------------------------------------

def test_step_profile_attributes_the_step_on_the_cpu():
    cfg = dict(_sgd_cfg(), max_annots=8, device_augment=True,
               device_geom=True, device_hsv="exact")
    out = profile_steps(cfg, "cpu", batch=2, iters=2, warmup=1)
    assert out["device"] == "cpu" and out["iters"] == 2
    assert out["coverage"] >= 0.99 and out["fallback_ms_per_step"] == 0.0
    rows = sum(out["parts_ms_per_step"].values())
    assert rows + out["unattributed_ms_per_step"] == pytest.approx(
        out["total_ms_per_step"], rel=1e-6)
    assert set(out["parts_ms_per_step"]) >= {"augment", "forward", "loss",
                                             "backward", "optimizer"}
    back = out["backward_by_node_ms_per_step"]
    assert {"conv", "bn", "activation", "loss"} <= set(back)
    assert sum(back.values()) == pytest.approx(
        out["parts_ms_per_step"]["backward"], rel=1e-6)
    assert sum(out["forward_by_module_ms_per_step"].values()) == \
        pytest.approx(out["parts_ms_per_step"]["forward"], rel=1e-6)
    assert "backbone" in out["forward_by_module_ms_per_step"]
    assert 0.0 <= out["idle_share"] < 1.0
    assert len(out["top_kernels"]) == 30 and np.isfinite(out["loss"])
