"""SWA in the port against podtpu (CPU): the forward-only BN-statistics
step (``make_stats_step``), ``Trainer.recalibrate_bn`` and a 2-epoch
``Trainer.fit`` with cfg ``swa``, on configs/yolov3_voc.yaml's recipe at
64 px in float32 from the same seeded weights (tests/torch_parity.py);
then the ``swa`` checkpoint's staging and the average itself.

podtpu's side runs once: its stats step is jitted once for every podtpu
caller here, its train states are built once per config."""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import podtpu.train.state as jstate_mod
import podtpu.train.steps as jsteps
from podtpu.data import Loader as JLoader
from podtpu.data import build_datasets as podtpu_build_datasets
from podtpu.train.trainer import Trainer as JTrainer
from podtpu_torch.export.weights import SEP, flat_key, load_flat_weights
from podtpu_torch.train.run import make_loaders
from podtpu_torch.train.state import create_train_state
from podtpu_torch.train.steps import make_stats_step
from podtpu_torch.train.trainer import _STATE_FILE, CheckpointIO, Trainer
from tests.torch_parity import (  # noqa: F401  (fixtures)
    RecordingWriter,
    cached_podtpu_states,
    flax_variables,
    podtpu_flat_weights,
    recipe_cfg,
    synth,
)

quiet = lambda *_: None  # noqa: E731

# Batch statistics, the port against podtpu, per channel: the two forwards
# sum in other orders (XLA's and PyTorch's CPU convs), var = E[x^2] -
# mean^2 cancels, and the deepest layers see 16 values a channel (2x2 at
# B=4), so the parts grow with depth: observed up to 5.6e-4 of
# max(|value|, 1) on one batch, 9.0e-4 averaged over two, 1.44e-3 after the
# SWA fit (where podtpu also inverts its EWMA from trained running
# statistics, (new - 0.9 old) / 0.1, adding up to ~3e-6 here). Limit 3e-3:
# a dropped Bessel factor (n / (n - 1) = 1.067 at n = 16) still fails.
STATS_RTOL = 3e-3


@pytest.fixture(autouse=True)
def drop_checkpoints(tmp_path):
    """A checkpoint of the 64 px model is ~280 MB: each test's files go
    when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def jax_stats_step():
    """podtpu's ``make_stats_step`` jitted once for every podtpu caller of
    this module (``recalibrate_bn`` builds one per call)."""
    built = {}
    orig = jsteps.make_stats_step

    def cached(cfg, mesh=None, **kw):
        if "fn" not in built:
            built["fn"] = orig(cfg, mesh, **kw)
        return built["fn"]

    mp = pytest.MonkeyPatch()
    mp.setattr(jsteps, "make_stats_step", cached)
    yield cached
    mp.undo()


def _flat_of(tree: dict, collection: str) -> dict:
    return {SEP.join((collection,) + k): np.asarray(v)
            for k, v in flatten_dict(tree).items()}


def _jax_state(cfg, flat, zero_stats: bool = False):
    """podtpu's train state holding ``flat``. ``zero_stats``: running
    statistics of 0, which train mode never reads: podtpu's stats step then
    inverts ``new = 0.1 * batch``, and its result carries the batch
    statistics' own rounding, not ten times the running ones'. (The
    port's stats step takes the batch statistics directly.)"""
    variables = flax_variables(flat)
    state = jstate_mod.create_train_state(cfg, jax.random.PRNGKey(0))
    stats = variables["batch_stats"]
    if zero_stats:
        stats = jax.tree_util.tree_map(jnp.zeros_like, stats)
    return state.replace(params=variables["params"], batch_stats=stats)


def _stats_err(got: np.ndarray, want: np.ndarray) -> float:
    """Largest |got - want| / max(|want|, 1) over the channels."""
    return float((np.abs(got - want) / np.maximum(np.abs(want), 1.0)).max())


# ---- make_stats_step ------------------------------------------------------

def _train_batch(cfg):
    batch = next(iter(make_loaders(cfg)[0]))
    batch.pop("n_valid")
    return batch


def test_stats_step_matches_podtpu_and_leaves_the_state(
        synth, tmp_path, jax_stats_step, cached_podtpu_states):
    """This batch's per-layer mean and unbiased variance, within
    STATS_RTOL; the state untouched, bit for bit, its modes included."""
    cfg = recipe_cfg(synth, tmp_path)
    flat = podtpu_flat_weights(cfg, seed=3)
    batch = _train_batch(cfg)
    want = _flat_of(jax_stats_step(cfg)(
        _jax_state(cfg, flat, zero_stats=True),
        {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0)), "batch_stats")

    state = create_train_state(cfg, "cpu", weights=flat)
    model = state.model
    model.eval()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    modes = {n: m.training for n, m in model.named_modules()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = make_stats_step(cfg)(state, tbatch)
    n_bn = sum(k.endswith("running_mean") for k in model.state_dict())
    assert len(got) == len(want) == 2 * n_bn and n_bn > 20
    for name, t in got.items():
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        err = _stats_err(t.numpy(), want[flat_key(name)])
        assert err <= STATS_RTOL, (name, err)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert {n: m.training for n, m in model.named_modules()} == modes
    assert state.step == 0 and not state.optimizer.state
    # from train mode: train mode again, and the same statistics
    model.train()
    again = make_stats_step(cfg)(state, tbatch)
    assert all(m.training for m in model.modules())
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for k, v in got.items():
        assert torch.equal(again[k], v), k


# ---- recalibrate_bn -------------------------------------------------------

def test_recalibrate_bn_matches_podtpu(synth, tmp_path, jax_stats_step,
                                       cached_podtpu_states):
    """From the same averaged weights over the same 2 train batches: the
    cumulative mean of the raw batch statistics in every BN buffer, within
    STATS_RTOL; the parameters untouched."""
    cfg = recipe_cfg(synth, tmp_path)
    a, b = podtpu_flat_weights(cfg, seed=3), podtpu_flat_weights(cfg, seed=4)
    flat = {k: ((a[k] + b[k]) / 2).astype(np.float32) for k in a}
    jtrainer = JTrainer(cfg, log=quiet, use_mesh=False, eval_only=True)
    train_ds, _ = podtpu_build_datasets(cfg)
    jloader = JLoader(train_ds, batch_size=4, shuffle=True, max_annots=8,
                      workers=2, seed=cfg["seed"])
    jstate = jtrainer.recalibrate_bn(_jax_state(cfg, flat, zero_stats=True),
                                     jloader, 2)
    want = _flat_of(jstate.batch_stats, "batch_stats")

    trainer = Trainer(cfg, device="cpu", log=quiet, eval_only=True)
    load_flat_weights(trainer.state.model, flat)
    params = {k: v.clone() for k, v in
              trainer.state.model.named_parameters()}
    state = trainer.recalibrate_bn(trainer.state, make_loaders(cfg)[0], 2)
    assert state is trainer.state
    buffers = dict(state.model.named_buffers())
    assert len(buffers) == len(want)
    for name, t in buffers.items():
        err = _stats_err(t.numpy(), want[flat_key(name)])
        assert err <= STATS_RTOL, (name, err)
        assert not np.array_equal(t.numpy(), flat[flat_key(name)]), name
    for k, p in state.model.named_parameters():
        assert torch.equal(p, params[k]), k
    # a loader with no batches leaves the state alone
    empty = make_loaders(recipe_cfg(synth, tmp_path, batch_size=16))[0]
    assert len(empty) == 0  # 8 train images, drop_last
    before = {k: v.clone() for k, v in buffers.items()}
    assert trainer.recalibrate_bn(state, empty, 2) is state
    for k, v in state.model.named_buffers():
        assert torch.equal(v, before[k]), k


# ---- SWA in fit -----------------------------------------------------------

@pytest.fixture(scope="module")
def podtpu_swa(synth, tmp_path_factory, jax_stats_step,
               cached_podtpu_states):
    """podtpu's 2-epoch ``fit`` with ``swa: {start_epoch: 0,
    bn_recal_batches: 2}``; its checkpoints are captured, not written."""
    runs = tmp_path_factory.mktemp("podtpu_swa")
    cfg = recipe_cfg(synth, runs, swa={"start_epoch": 0,
                                       "bn_recal_batches": 2})
    flat = podtpu_flat_weights(cfg, seed=3)
    trainer = JTrainer(cfg, log=quiet, use_mesh=False)
    trainer._writer = RecordingWriter()
    variables = flax_variables(flat)
    trainer.state = trainer.state.replace(
        params=variables["params"], batch_stats=variables["batch_stats"])
    saved = {}

    def capture(name, st):
        saved[name] = {**_flat_of(st.params, "params"),
                       **_flat_of(st.batch_stats, "batch_stats")}

    trainer.ckpt.save = capture
    train_ds, val_ds = podtpu_build_datasets(cfg)
    history = trainer.fit(
        JLoader(train_ds, batch_size=4, shuffle=True, max_annots=8,
                workers=2, seed=cfg["seed"]),
        JLoader(val_ds, batch_size=4, shuffle=False, max_annots=8,
                workers=2), epochs=2)
    yield cfg, flat, saved, history
    shutil.rmtree(runs, ignore_errors=True)


def _saves(trainer, monkeypatch, write=("swa",)) -> dict:
    """Record each checkpoint save's model tensors (clones) by name, in
    order; only the names in ``write`` reach the disk (a 64 px checkpoint
    is ~280 MB)."""
    saved = {}
    save = trainer.ckpt.save

    def record(name, st):
        saved.setdefault(name, []).append(
            {k: v.detach().clone() for k, v in st.model.state_dict().items()})
        if name in write:
            save(name, st)

    monkeypatch.setattr(trainer.ckpt, "save", record)
    return saved


def _load_ckpt(path):
    return torch.load(os.path.join(CheckpointIO._resolve(path), _STATE_FILE),
                      map_location="cpu", weights_only=True)


def test_swa_fit_matches_podtpu(podtpu_swa, tmp_path, monkeypatch):
    """The ``swa`` checkpoint against podtpu's: parameters at the fit
    tolerance of test_torch_trainer.py (1e-4 of max(|value|, 1)); BN
    buffers within STATS_RTOL; the history rows as that file holds them; ``self.state`` stays the last
    trained weights."""
    cfg, flat, j_saved, j_hist = podtpu_swa
    cfg = dict(cfg, save_dir=str(tmp_path))
    trainer = Trainer(cfg, device="cpu", log=quiet)
    load_flat_weights(trainer.state.model, flat)
    logs = []
    trainer.log = logs.append
    trainer._writer = RecordingWriter()
    saved = _saves(trainer, monkeypatch)
    hist = trainer.fit(*make_loaders(cfg), epochs=2)
    assert len(hist) == len(j_hist) == 2
    for got, want in zip(hist, j_hist):
        assert got["step"] == want["step"] and got["lr"] == want["lr"]
        assert got["train_loss"] == pytest.approx(want["train_loss"],
                                                  rel=1e-4)
        assert got["val_loss"] == pytest.approx(want["val_loss"], rel=1e-4)
    assert sorted(saved) == ["best", "last", "swa"]
    swa = _load_ckpt(os.path.join(trainer.run_dir, "checkpoints", "swa"))
    assert swa["step"] == 4 and swa["optimizer"]["state"]
    want = j_saved["swa"]
    for name, t in swa["model"].items():
        key = flat_key(name)
        if "running_" in name:
            assert _stats_err(t.numpy(), want[key]) <= STATS_RTOL, name
            continue
        w = want[key]
        if name.endswith("conv.weight"):
            w = np.transpose(w, (3, 2, 0, 1))
        err = np.abs(t.numpy() - w) / np.maximum(np.abs(w), 1.0)
        assert err.max() <= 1e-4, (name, err.max())
    last = saved["last"][-1]
    for k, v in trainer.state.model.state_dict().items():
        assert torch.equal(v, last[k]), k
    assert all(not torch.equal(swa["model"][k], last[k])
               for k in last if "running_" in k)
    assert logs[-2] == ("saved SWA weights (averaged over 2 epochs, BN "
                        "recalibrated over 2 batches)")


def test_swa_is_the_epoch_mean_and_not_an_alias(synth, tmp_path,
                                                monkeypatch):
    """The average is float32 and never the live tensors: at a constant
    lr the weights move each epoch, and the ``swa`` parameters are the
    mean of the two epoch-end sets within 2^-22 (|p0| + |p1|), the
    rounding of ``p0 + (p1 - p0) / 2``; recalibration runs once, over
    cfg ``bn_recal_batches`` batches, on a copy of the model."""
    cfg = recipe_cfg(synth, tmp_path, scheduler=None,
                     swa={"start_epoch": 0, "bn_recal_batches": 1},
                     trainer_options={"check_val_every_n_epoch": 100})
    trainer = Trainer(cfg, device="cpu", log=quiet)
    trainer._writer = RecordingWriter()
    saved = _saves(trainer, monkeypatch)
    calls = []
    recal = trainer.recalibrate_bn
    monkeypatch.setattr(
        trainer, "recalibrate_bn",
        lambda st, loader, n: calls.append((st.model, n)) or recal(
            st, loader, n))
    trainer.fit(*make_loaders(cfg), epochs=2)
    assert len(calls) == 1 and calls[0][1] == 1
    assert calls[0][0] is not trainer.state.model
    ends = saved["last"]
    assert len(ends) == 2
    swa = _load_ckpt(os.path.join(trainer.run_dir, "checkpoints",
                                  "swa"))["model"]
    for k, _ in trainer.state.model.named_parameters():
        p0, p1 = ends[0][k], ends[1][k]
        assert swa[k].dtype == torch.float32
        mean = (p0.double() + p1.double()) / 2
        bound = 2.0 ** -22 * (p0.abs() + p1.abs()).double()
        assert ((swa[k].double() - mean).abs() <= bound).all(), k
    assert any(not torch.equal(ends[0][k], ends[1][k])
               for k, _ in trainer.state.model.named_parameters())


def test_swa_start_epoch_after_the_run_saves_nothing(synth, tmp_path,
                                                     monkeypatch):
    cfg = recipe_cfg(synth, tmp_path, epochs=1,
                     swa={"start_epoch": 5, "bn_recal_batches": 1})
    trainer = Trainer(cfg, device="cpu", log=quiet)
    trainer._writer = RecordingWriter()
    saved = _saves(trainer, monkeypatch)
    trainer.fit(*make_loaders(cfg))
    assert sorted(saved) == ["best", "last"]


def _touch_ckpt(path):
    os.makedirs(path)
    open(os.path.join(path, _STATE_FILE), "w").close()


def test_swa_checkpoint_is_staged_and_never_pruned(synth, tmp_path):
    """``swa`` is overwritten like ``last``: a leftover ``swa.staging``
    (a save killed before its swap) is swapped in, then the new save lands
    in staging and is renamed over it; ``prune_periodic`` keeps it."""
    cfg = recipe_cfg(synth, tmp_path)
    trainer = Trainer(cfg, device="cpu", log=quiet)
    d = os.path.join(trainer.run_dir, "checkpoints")
    trainer.ckpt.save("swa", trainer.state)
    _touch_ckpt(os.path.join(d, "swa.staging"))
    assert CheckpointIO._resolve(os.path.join(d, "swa")).endswith(
        "swa.staging")
    trainer.state.step = 9
    trainer.ckpt.save("swa", trainer.state)
    assert sorted(os.listdir(d)) == ["swa"]
    assert _load_ckpt(os.path.join(d, "swa"))["step"] == 9
    for name in ("epoch_0001", "epoch_0002", "last"):
        os.makedirs(os.path.join(d, name))
    trainer.ckpt.prune_periodic(1)
    assert sorted(os.listdir(d)) == ["epoch_0002", "last", "swa"]
