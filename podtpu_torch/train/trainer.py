"""Training orchestration (``podtpu/train/trainer.py``), the functional
analog of the reference's Lightning stack (pl.Trainer + callbacks,
train_yolov3.py:50-74):

* the train step per batch (loss logged as ``train_loss``), losses kept on
  the device and reduced once an epoch; with cfg ``steps_per_dispatch: K``
  a group of K batches is stacked, copied to the device at once and run
  by ``make_multi_train_step``, the ragged tail of an epoch by the single
  step;
* validation every ``check_val_every_n_epoch`` epochs -> ``val_loss`` +
  ``val_mAP`` (module/yolov3_detector.py:33-47);
* checkpoints (``torch.save`` of the model's and the optimizer's
  ``state_dict``, the counts, the gradient accumulator and the EMA shadow,
  one directory each): ``last`` every epoch, ``best`` on min val_loss,
  periodic every ``save_freq``;
* with cfg ``ema`` (``ema.eval``, the default) validation and ``best``
  on the shadow's weights;
* early stopping on val_loss with patience counted in validation rounds
  (EarlyStopping(patience=30), train_yolov3.py:57-61);
* SWA (cfg ``swa``): parameters averaged over the epochs from
  ``start_epoch`` on, BN recalibrated over train batches, saved as ``swa``;
* TensorBoard scalars incl. the learning rate under
  ``<save_dir>/<model>_<dataset>/version_N/`` (utils/utility.py:13-14),
  and with cfg ``log_images: N`` the first val batch's detections drawn.

Under a process group (``parallel/mesh.py``; ``train/run.py
--distributed``) each data rank trains on its rows of the global batch:
data parallelism with global BatchNorm, with cfg
``parallel_options.spatial`` / ``.tensor`` the spatial and tensor
layouts (``parallel/layouts.py``), and with ``.fsdp`` FSDP2, composed as
in ``podtpu``. Rank 0 makes the run directory, writes the checkpoints (in
the one-process layout: gathered whole under FSDP and the tensor layout,
so that they load in any topology) and the TensorBoard scalars;
``validate`` scores every data rank's rows on every rank (the global mAP)
and averages the val loss over the ranks; a SIGTERM or early stop on one
rank stops every rank at the same step. Without a group the options are
the one-process step (``fsdp`` over one rank is the plain step, as
``podtpu`` runs it).
"""

from __future__ import annotations

import copy
import os
import shutil
import sys
import threading
import time
from typing import Callable

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from podtpu_torch import resolve_device
from podtpu_torch.config import make_model_name
from podtpu_torch.metrics import MeanAveragePrecision
from podtpu_torch.models.factory import build_model
from podtpu_torch.parallel.mesh import (
    any_rank,
    barrier,
    broadcast_object,
    full_tree,
    gather_model,
    gather_rows,
    is_distributed,
    load_full_state,
    mean_over_ranks,
    parallel_options,
    rank,
    setup_layout,
    shard_like,
    world,
)
from podtpu_torch.train.state import (
    TrainState,
    create_train_state,
    ema_options,
    param_count,
    total_notfinite,
)
from podtpu_torch.train.steps import (
    make_eval_step,
    make_multi_train_step,
    make_stats_step,
    make_train_step,
)

_STATE_FILE = "state.pt"
# checkpoints overwritten in place: staged, then rename-swapped
_STAGED = ("last", "best", "swa")


def make_run_dir(cfg: dict) -> str:
    base = os.path.join(cfg.get("save_dir", "./saved"), make_model_name(cfg))
    os.makedirs(base, exist_ok=True)
    n = 0
    while os.path.exists(os.path.join(base, f"version_{n}")):
        n += 1
    run = os.path.join(base, f"version_{n}")
    os.makedirs(os.path.join(run, "checkpoints"), exist_ok=True)
    return run


# the TrainState's counts, saved beside the model and the optimizer
_COUNTS = ("step", "count", "mini_step", "notfinite_count",
           "total_notfinite")


class CheckpointIO:
    """Save/restore of the train state: ``{"model": state_dict,
    "optimizer": state_dict, "step", "count", "mini_step", "acc",
    "notfinite_count", "total_notfinite"}`` and with cfg ``ema`` the
    shadow under ``"ema"``, by ``torch.save`` into one directory per
    checkpoint.

    A checkpoint directory is written whole under a temporary name and
    renamed into place, so a directory under a checkpoint's name is always
    complete. Overwrites of the named targets ("last"/"best"/"swa") are
    crash-safe: the new checkpoint lands in ``<name>.staging`` and is
    rename-swapped over the old one, so a kill at any point leaves a
    complete checkpoint under ``name``, ``name.staging`` or ``name.old``
    (``restore`` resolves the leftovers, preferring the newest).

    Every write runs on a writer thread, one a target ("last", "best",
    "swa", and one for the periodic ``epoch_<n>`` saves): a save first
    drains its own target's pending write, while other targets' writes
    keep overlapping. ``wait`` drains every target and swaps the staged
    ones into place; it runs before any ``restore`` and at the end of
    ``Trainer.fit``. A writer's error is raised at the next ``save`` or
    ``wait``. By default ``save`` ends in ``wait``, so the checkpoint is
    on disk when it returns.

    ``async_save=True`` (cfg ``async_checkpoint``) returns before the disk
    write: ``save`` first copies the state into one set of host buffers
    (pinned for a card's tensors; one copy a tensor, waited for), so the
    next in-place update cannot reach what is saved. Saves of a state no
    tensor of which changed since the last copy (``last``, ``best`` and
    ``epoch_<n>`` at one step) share that copy; a changed state first
    drains the writers still reading the buffers.
    """

    def __init__(self, ckpt_dir: str, async_save: bool = False,
                 writes: bool = True):
        self._ckpt_dir = os.path.abspath(ckpt_dir)
        self._writes = bool(writes)  # rank 0 writes, the others wait
        if self._writes:
            os.makedirs(self._ckpt_dir, exist_ok=True)
        self._async = bool(async_save)
        self._writers: dict[str, threading.Thread] = {}  # target -> writer
        # the host copy: its buffers, the (storage, version) of each tensor
        # it holds (and the tensors, so no storage is freed and reused
        # while the stamp names it), and the targets whose writers read it
        self._host: dict = {"buffers": [], "stamp": None, "sources": [],
                            "readers": set()}
        self._staged: set[str] = set()  # named targets written, not swapped
        self._errors: list = []  # (path, exception) from the writers

    def _path(self, name: str) -> str:
        return os.path.join(self._ckpt_dir, name)

    def _finalize(self, name: str):
        """Swap a complete ``<name>.staging`` into place (rename-based, so
        a crash at any point leaves a complete checkpoint under ``name``,
        ``name.staging``, or ``name.old``; ``_resolve`` finds it)."""
        final = self._path(name)
        staging = final + ".staging"
        if not os.path.isdir(staging):
            return
        old = final + ".old"
        shutil.rmtree(old, ignore_errors=True)
        if os.path.isdir(final):
            os.rename(final, old)
        os.rename(staging, final)
        shutil.rmtree(old, ignore_errors=True)

    @staticmethod
    def _resolve(path: str) -> str:
        """Resolve a named-target path against crash leftovers: a complete
        ``.staging`` is newer than the main dir; ``.old`` only exists if a
        swap died between its two renames (main dir absent)."""
        for candidate in (path + ".staging", path, path + ".old"):
            if os.path.isdir(candidate):
                return candidate
        return path

    @staticmethod
    def _write(target: str, payload: dict):
        """Write ``payload`` as the directory ``target``: into a temporary
        sibling first, renamed over ``target`` once complete."""
        tmp = f"{target}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(payload, os.path.join(tmp, _STATE_FILE))
        shutil.rmtree(target, ignore_errors=True)
        os.rename(tmp, target)

    def _raise_errors(self):
        if self._errors:
            path, exc = self._errors.pop(0)
            raise RuntimeError(f"the checkpoint write of {path} failed") \
                from exc

    def _drain(self, key: str):
        writer = self._writers.pop(key, None)
        if writer is not None:
            writer.join()

    def wait(self):
        """Block until every pending write is on disk, swap the staged
        named targets into place, and raise a writer's error. Under a
        process group every rank then meets at a barrier, so a checkpoint
        rank 0 wrote is on disk for all of them."""
        for key in list(self._writers):
            self._drain(key)
        for name in list(self._staged):
            self._staged.discard(name)
            self._finalize(name)
        self._raise_errors()
        barrier()

    def _to_host(self, key: str, payload: dict) -> dict:
        """``payload`` with every tensor in the host buffers, which ``key``'s
        writer then reads: copied there (the copies waited for) unless they
        already hold these tensors at their current version."""
        leaves, spec = tree_flatten(payload)
        tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
        stamp = [(t.device, t.data_ptr(), t._version) for t in tensors]
        host = self._host
        if stamp != host["stamp"]:
            for reader in host["readers"]:
                self._drain(reader)
            host["readers"].clear()
            if [(b.shape, b.dtype) for b in host["buffers"]] != [
                    (t.shape, t.dtype) for t in tensors]:
                host["buffers"] = [
                    torch.empty(t.shape, dtype=t.dtype,
                                pin_memory=t.device.type == "cuda")
                    for t in tensors]
            for buf, t in zip(host["buffers"], tensors):
                buf.copy_(t.detach(), non_blocking=t.device.type == "cuda")
            if any(t.device.type == "cuda" for t in tensors):
                torch.cuda.synchronize()
            host["stamp"], host["sources"] = stamp, tensors
        host["readers"].add(key)
        it = iter(host["buffers"])
        return tree_unflatten([next(it) if isinstance(x, torch.Tensor)
                               else x for x in leaves], spec)

    def _write_in_background(self, key: str, target: str, payload: dict):
        def run():
            try:
                self._write(target, payload)
            except BaseException as exc:  # raised at the next save or wait
                self._errors.append((target, exc))

        writer = threading.Thread(target=run, name=f"checkpoint-{key}",
                                  daemon=True)
        self._writers[key] = writer
        writer.start()

    def save(self, name: str, state: TrainState):
        self._raise_errors()
        payload = {
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            **{k: int(getattr(state, k)) for k in _COUNTS},
            "acc": state.acc,
        }
        if state.ema is not None:
            payload["ema"] = state.ema
        # the one-process layout: FSDP's shards and the tensor layout's
        # blocks gathered whole (every rank takes part), written by rank 0
        # alone
        payload = whole_payload(state, full_tree(payload))
        if not self._writes:
            if not self._async:
                self.wait()
            return
        staged = name in _STAGED
        key = name if staged else "periodic"
        # this target's pending write must end before its files are reused
        self._drain(key)
        self._raise_errors()
        if staged:
            # the previous (or a leftover) staging dir is complete: swap it
            # in, then stage the new save over it
            self._staged.discard(name)
            self._finalize(name)
        target = self._path(name) + (".staging" if staged else "")
        if self._async:
            host = self._to_host(key, payload)
            # the module tree's version tags, which load_state_dict reads
            host["model"]._metadata = getattr(payload["model"], "_metadata",
                                              {})
            payload = host
        self._write_in_background(key, target, payload)
        if staged:
            self._staged.add(name)
        if not self._async:
            self.wait()

    def prune_periodic(self, keep: int):
        """Keep only the newest ``keep`` periodic ``epoch_<n>`` checkpoints
        (cfg ``keep_checkpoints``; ``last``/``best``/``swa`` are never
        pruned). Only complete directories count: a write in flight is a
        temporary ``*.tmp-*`` directory, never deleted or counted, so under
        ``async_checkpoint`` up to ``keep + 1`` periodic directories exist
        until it lands. Newness is the parsed epoch number, not the
        name string (lexicographic order inverts past epoch 9999)."""
        import re

        if keep <= 0 or not self._writes:
            return
        committed = []
        for d in os.listdir(self._ckpt_dir):
            m = re.fullmatch(r"epoch_(\d+)", d)
            if m and os.path.isdir(os.path.join(self._ckpt_dir, d)):
                committed.append((int(m.group(1)), d))
        for _, d in sorted(committed)[:-keep]:
            shutil.rmtree(os.path.join(self._ckpt_dir, d),
                          ignore_errors=True)

    def restore(self, path: str, state: TrainState) -> TrainState:
        """Restore parameters, BN statistics, the optimizer's state (momentum
        buffers onto the parameters' device), the counts, the accumulator
        and the EMA shadow into ``state``, after every pending write has
        landed. A checkpoint from before these were saved has taken one
        update a step; an EMA state restoring one without a shadow
        reseeds it from the restored weights."""
        self.wait()
        payload = _load_payload(path, state)
        # whole tensors; under FSDP each rank keeps its shards of them
        load_full_state(state.model, payload["model"])
        params = state.params()
        osd = payload["optimizer"]
        osd["state"] = {i: {k: shard_like(v, params[i])
                            if torch.is_tensor(v) and v.dim() else v
                            for k, v in s.items()}
                        for i, s in osd["state"].items()}
        state.optimizer.load_state_dict(osd)
        state.step = int(payload["step"])
        state.count = int(payload.get("count", state.step))
        for k in ("mini_step", "notfinite_count", "total_notfinite"):
            setattr(state, k, int(payload.get(k, 0)))
        acc = payload.get("acc")
        state.acc = (None if acc is None else
                     [shard_like(a, p) for a, p in zip(acc, params)])
        if state.ema is not None:
            if "ema" in payload:
                state.ema = {k: shard_like(v.float(), state.ema[k])
                             for k, v in payload["ema"].items()}
            else:
                state.init_ema()
        return state


def whole_payload(state: TrainState, payload: dict) -> dict:
    """``payload`` (a checkpoint's, FSDP's shards already gathered) with
    the tensor layout's blocks of the split kernels gathered whole over
    ``model``: in the model, the EMA shadow, the optimizer's state and the
    accumulator. Every rank calls it, in the same order."""
    keys = getattr(state.model, "tp_keys", None)
    if not keys:
        return payload
    out = dict(payload)
    for tree in ("model", "ema"):
        if out.get(tree) is not None:
            out[tree] = type(out[tree])(out[tree])
            for k in sorted(keys):
                out[tree][k] = gather_model(out[tree][k])
    split = [i for i, s in enumerate(state.split or ()) if s]
    osd = out.get("optimizer")
    if osd is not None:
        osd = dict(osd)
        osd["state"] = {i: {k: gather_model(v) if i in split
                            and torch.is_tensor(v) and v.dim() else v
                            for k, v in st.items()}
                        for i, st in osd["state"].items()}
        out["optimizer"] = osd
    if out.get("acc") is not None:
        out["acc"] = [gather_model(a) if i in split else a
                      for i, a in enumerate(out["acc"])]
    return out


def _load_payload(path: str, state: TrainState) -> dict:
    resolved = CheckpointIO._resolve(os.path.abspath(path))
    device = next(state.model.parameters()).device
    return torch.load(os.path.join(resolved, _STATE_FILE),
                      map_location=device, weights_only=True)


def make_preempt_handler(preempt):
    """SIGTERM handler for preemption-safe training (``save_on_signal``).

    First SIGTERM only sets the flag: the step loop saves a durable
    ``last`` checkpoint at the next step boundary and returns cleanly. A
    SECOND SIGTERM escalates to the default action (immediate exit), so
    schedulers (or plain ``timeout``) can still kill the process with a
    repeat signal.
    """
    import signal

    def _on_sigterm(signum, frame):
        if preempt.is_set():
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            signal.raise_signal(signal.SIGTERM)
        preempt.set()

    return _on_sigterm


def restore_weights(path: str, state: TrainState,
                    use_ema: bool = False) -> TrainState:
    """Weights-only restore (parameters + BN statistics) into ``state``, for
    eval/inference; the optimizer and the counts stay as they were.

    ``use_ema=True`` loads the checkpoint's EMA shadow as the weights
    (``ValueError`` when it has none). Either way the state keeps no
    shadow afterwards: it carries only the weights chosen."""
    payload = _load_payload(path, state)
    if use_ema:
        if "ema" not in payload:
            raise ValueError(
                f"--use-ema: checkpoint {path} carries no EMA shadow (was "
                "it trained with cfg `ema`?)")
        weights = dict(payload["model"])
        weights.update(payload["ema"])
    else:
        weights = payload["model"]
    load_full_state(state.model, weights)
    state.ema = None
    return state


def restore_eval_weights(path: str, state: TrainState, cfg: dict,
                         use_ema: bool | None = None) -> TrainState:
    """CLI-facing restore: the weights evaluation should see.

    ``use_ema=None`` (auto) does what the Trainer did: with cfg
    ``ema.eval`` on, validation scored and ``best`` was chosen on the
    shadow, so the shadow is loaded, and the raw weights where the
    checkpoint has none; an explicit ``use_ema=True`` raises instead."""
    auto = use_ema is None
    if auto:
        eo = ema_options(cfg)
        use_ema = bool(eo and eo["eval"] and state.ema is not None)
    try:
        return restore_weights(path, state, use_ema=use_ema)
    except ValueError:
        if not auto:
            raise
        return restore_weights(path, state, use_ema=False)


def put_batch(batch: dict, device: torch.device) -> dict:
    """The host batch's arrays as tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def put_group(batches: list[dict], device: torch.device) -> dict:
    """K host batches as ``[K, B, ...]`` tensors on ``device``: each key
    stacked once on the host, into pinned memory when the device is a
    card, and copied over in one non-blocking transfer."""
    pin = device.type == "cuda"
    out = {}
    for k in batches[0]:
        first = np.asarray(batches[0][k])
        host = torch.empty((len(batches),) + first.shape,
                           dtype=torch.from_numpy(first).dtype,
                           pin_memory=pin)
        np.stack([b[k] for b in batches], out=host.numpy())
        out[k] = host.to(device, non_blocking=pin)
    return out


class _NullWriter:
    def add_scalar(self, *a, **k):
        pass

    def add_image(self, *a, **k):
        pass

    def flush(self):
        pass


class Trainer:
    def __init__(self, cfg: dict, run_dir: str | None = None,
                 log: Callable[[str], None] = print,
                 device: str | torch.device | None = None,
                 eval_only: bool = False):
        self.cfg = cfg
        self.log = log
        self.device = resolve_device(device)
        # cfg parallel_options (podtpu's _pick_mesh): under a process group
        # the mesh of the spatial and tensor layouts, FSDP over it; without
        # one the plain step, as podtpu's mesh of one device runs them
        self._fsdp = parallel_options(cfg)["fsdp"] and is_distributed()
        mesh = setup_layout(cfg, self.device.type)
        self._replica = None  # the whole model FSDP's evaluation runs on
        # seeded init without touching the caller's global RNG
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(int(cfg.get("seed", 0)))
            self.state = create_train_state(
                cfg, self.device, fsdp_mesh=mesh if self._fsdp else None)
        self.train_step = make_train_step(cfg)
        # cfg ``steps_per_dispatch: K``: K optimizer steps a call over a
        # stacked group of K batches; ragged epoch tails run the single step
        self._spd = max(1, int(cfg.get("steps_per_dispatch") or 1))
        self.multi_step = (make_multi_train_step(cfg)
                           if self._spd > 1 and not eval_only else None)
        self.eval_step = make_eval_step(cfg)
        eopts = ema_options(cfg)
        self._ema_eval = bool(eopts and eopts["eval"])
        self._ema_model = None  # the model evaluation loads the shadow into
        self.map_metric = MeanAveragePrecision(
            cfg["num_classes"], cfg["input_size"]
        )
        # eval-only consumers don't create run directories or checkpoints;
        # under a process group rank 0 makes the one run directory
        if not eval_only and run_dir is None:
            run_dir = broadcast_object(make_run_dir(cfg) if rank() == 0
                                       else None)
        self.run_dir = None if eval_only else run_dir
        self.ckpt = (None if eval_only else
                     CheckpointIO(os.path.join(self.run_dir, "checkpoints"),
                                  bool(cfg.get("async_checkpoint", False)),
                                  writes=rank() == 0))
        self._writer = None
        self.history: list[dict] = []
        self.log(
            f"model={cfg['model']} params={param_count(self.state.model):,}"
            + (f" run_dir={self.run_dir}" if self.run_dir else "")
        )

    @property
    def writer(self):
        if self._writer is None and rank() != 0:
            self._writer = _NullWriter()  # rank 0 writes the scalars
        if self._writer is None:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._writer = SummaryWriter(self.run_dir)
            except Exception:  # tensorboard unavailable -> no-op writer
                self._writer = _NullWriter()
        return self._writer

    def fit(self, train_loader, val_loader, epochs: int | None = None,
            start_epoch: int = 0):
        cfg = self.cfg
        epochs = epochs if epochs is not None else cfg["epochs"]
        val_every = int(cfg.get("trainer_options", {}).get(
            "check_val_every_n_epoch", 1))
        patience = int(cfg.get("early_stopping_patience", 30))
        save_freq = int(cfg.get("save_freq", 5))

        # SWA (the reference's commented experimental callback,
        # configs/yolov3_voc.yaml:73-75): average the parameters over the
        # epochs from ``swa: {start_epoch: N}``; saved as checkpoint "swa"
        swa_cfg = cfg.get("swa") or {}
        swa_start = int(swa_cfg.get("start_epoch", -1)) if swa_cfg else -1
        swa_params = None
        swa_count = 0

        best_val = float("inf")
        bad_rounds = 0
        t_start = time.time()

        # Preemption-safe training (cfg ``save_on_signal``, default on):
        # SIGTERM requests a graceful stop. The handler only sets a flag;
        # the step loop notices it at the next step boundary, saves a
        # durable ``last`` checkpoint, and returns normally, so
        # ``--resume <run>/checkpoints/last`` continues the run.
        import signal
        import threading

        preempt = threading.Event()
        prev_handler, installed = None, False
        if bool(cfg.get("save_on_signal", True)):
            try:
                prev_handler = signal.signal(
                    signal.SIGTERM, make_preempt_handler(preempt))
                installed = True
            except ValueError:  # not the main thread - no handler, no flag
                pass
        # in-epoch progress line (opt-out: progress: false); only when
        # stdout is a tty so logs/CI stay clean
        progress = bool(cfg.get("progress", True)) and sys.stdout.isatty()
        steps_per_epoch = len(train_loader)
        stop = False

        try:
            for epoch in range(start_epoch, epochs):
                train_loader.set_epoch(epoch)
                losses = []  # device scalars: one sync an epoch
                t_epoch = time.time()
                n_images = 0
                pending = []  # host batches buffered for one K-step group
                for i, batch in enumerate(train_loader):
                    n_images += batch.pop("n_valid", batch["img"].shape[0])
                    if self.multi_step is not None:
                        pending.append(batch)
                        if len(pending) < self._spd:
                            continue
                        self.state, metrics = self.multi_step(
                            self.state, put_group(pending, self.device))
                        pending = []
                        losses.extend(metrics["loss"].unbind(0))
                    else:
                        self.state, metrics = self.train_step(
                            self.state, put_batch(batch, self.device))
                        losses.append(metrics["loss"])
                    # a SIGTERM on any rank stops every rank at this step
                    stop = any_rank(preempt.is_set())
                    if stop:
                        break
                    if progress and (i % 10 == 9 or i + 1 == steps_per_epoch):
                        # float() syncs on the newest loss (tty only)
                        rate = n_images / max(time.time() - t_epoch, 1e-9)
                        sys.stdout.write(
                            f"\repoch {epoch}: {i + 1}/{steps_per_epoch} "
                            f"loss={float(losses[-1]):.4g} {rate:.1f} img/s   ")
                        sys.stdout.flush()
                # ragged tail (< K batches left, or a preempt mid-group):
                # the single step, so that no sample is lost
                for batch in pending:
                    self.state, metrics = self.train_step(
                        self.state, put_batch(batch, self.device))
                    losses.append(metrics["loss"])
                if progress:
                    sys.stdout.write("\r\033[K")
                if stop:
                    self.ckpt.save("last", self.state)
                    self.ckpt.wait()  # durable before the process may end
                    self.log(f"SIGTERM: saved preemption checkpoint 'last' at "
                             f"step {self.state.step}; stopping "
                             f"(resume with --resume .../checkpoints/last)")
                    break
                if not losses:
                    raise RuntimeError("empty train loader")
                # the global batch's loss: the mean of the ranks'
                train_loss = mean_over_ranks(
                    float(torch.stack(losses).mean()))
                n_images *= world()
                step = self.state.step
                # podtpu's logged lr: the schedule at step // accum_steps
                lr = float(self.state.schedule(step // self.state.accum))
                dt = time.time() - t_epoch
                ips = n_images / dt if dt > 0 else 0.0
                self.writer.add_scalar("train_loss", train_loss, step)
                self.writer.add_scalar("lr", lr, step)
                self.writer.add_scalar("images_per_sec", ips, step)
                row = {"epoch": epoch, "step": step, "train_loss": train_loss,
                       "lr": lr, "images_per_sec": ips}
                skipped = total_notfinite(self.state)
                if skipped is not None:
                    self.writer.add_scalar("skipped_nonfinite_updates",
                                           skipped, step)
                    row["skipped_updates"] = skipped
                    if skipped:
                        self.log(f"WARNING: {skipped} non-finite update(s) "
                                 "dropped so far (optimizer_options."
                                 "skip_nonfinite guard)")

                if (epoch + 1) % val_every == 0:
                    val = self.validate(val_loader)
                    row.update(val)
                    n_img = int(cfg.get("log_images", 0))
                    if n_img:
                        self._log_val_images(val_loader, n_img, step)
                    self.writer.add_scalar("val_loss", val["val_loss"], step)
                    self.writer.add_scalar("val_mAP", val["val_mAP"], step)
                    # per-class AP scalars; result_per_class rows are
                    # [AP, TP, FP, FN]
                    for name, row_c in zip(self._class_names(),
                                           self.map_metric.result_per_class()):
                        self.writer.add_scalar(f"val_AP/{name}",
                                               float(row_c[0]), step)
                    if val["val_loss"] < best_val:
                        best_val = val["val_loss"]
                        bad_rounds = 0
                        self.ckpt.save("best", self.state)
                    else:
                        bad_rounds += 1

                if swa_start >= 0 and epoch >= swa_start:
                    swa_count += 1
                    swa_params = self._swa_update(swa_params, swa_count)

                self.ckpt.save("last", self.state)
                if (epoch + 1) % save_freq == 0:
                    self.ckpt.save(f"epoch_{epoch:04d}", self.state)
                    self.ckpt.prune_periodic(int(cfg.get("keep_checkpoints", 0)))

                self.history.append(row)
                self.log(
                    f"epoch {epoch}: " + " ".join(
                        f"{k}={v:.5g}" for k, v in row.items() if k != "epoch"
                    )
                )
                if any_rank(bad_rounds >= patience):
                    self.log(f"early stopping after {bad_rounds} stale rounds")
                    break
        finally:
            if installed:
                signal.signal(
                    signal.SIGTERM,
                    prev_handler if prev_handler is not None
                    else signal.SIG_DFL)
        if swa_params is not None:
            # the averaged weights in a copy of the model: ``self.state``
            # stays the last trained weights. Averaging shifts every layer's
            # activations, so BN is recalibrated with a forward-only sweep
            # over the train loader (torch.optim.swa_utils.update_bn role)
            if self._fsdp:
                swa_model = self._whole_model(full_tree(swa_params))
            else:
                swa_model = copy.deepcopy(self.state.model)
                with torch.no_grad():
                    for name, p in swa_model.named_parameters():
                        p.copy_(swa_params[name])
            swa_state = TrainState(swa_model, self.state.optimizer,
                                   self.state.schedule, self.state.step,
                                   split=self.state.split)
            n_recal = int(swa_cfg.get("bn_recal_batches", 20))
            swa_state = self.recalibrate_bn(swa_state, train_loader, n_recal)
            self.ckpt.save("swa", swa_state)
            self.log(f"saved SWA weights (averaged over {swa_count} epochs, "
                     f"BN recalibrated over {n_recal} batches)")
        self.ckpt.wait()  # drain any pending asynchronous checkpoint write
        self.writer.flush()
        self.log(f"fit done in {time.time() - t_start:.1f}s")
        return self.history

    def _swa_update(self, avg: dict | None, count: int) -> dict:
        """The running mean of the parameters after ``count`` epochs:
        float32 clones, never the live tensors (the optimizer updates
        those in place)."""
        params = dict(self.state.model.named_parameters())
        with torch.no_grad():
            if avg is None:
                return {k: p.detach().float().clone()
                        for k, p in params.items()}
            w = 1.0 / count
            for k, a in avg.items():
                a.add_((params[k].detach().float() - a) * w)
        return avg

    def recalibrate_bn(self, state: TrainState, loader,
                       num_batches: int = 20) -> TrainState:
        """Replace ``state``'s BN running statistics with the cumulative
        average of raw batch statistics over ``num_batches`` batches of
        ``loader`` (the SWA ``update_bn`` pass: forward only, no gradient,
        ``train/steps.py::make_stats_step``)."""
        stats_step = make_stats_step(self.cfg)
        loader.set_epoch(0)
        acc = None
        n = 0
        for batch in loader:
            if n >= num_batches:
                break
            batch.pop("n_valid", None)
            raw = stats_step(state, put_batch(batch, self.device))
            n += 1
            if acc is None:
                acc = raw
            else:
                w = 1.0 / n
                acc = {k: a + (raw[k] - a) * w for k, a in acc.items()}
        if acc is None:
            return state
        buffers = dict(state.model.named_buffers())
        with torch.no_grad():
            for k, v in acc.items():
                buffers[k].copy_(v)
        return state

    def _log_val_images(self, val_loader, n_img: int, step: int):
        """Tagged-detection images to TensorBoard: GT red, predictions green
        (the reference's inference window, inference_yolov3.py:86-90, as TB
        panels). Opt-in via cfg ``log_images: N``."""
        from podtpu_torch.utils.viz import annots_to_boxes, draw_boxes

        names = self._class_names()
        size = self.cfg["input_size"]
        val_loader.set_epoch(0)
        batch = next(iter(val_loader))
        batch.pop("n_valid", None)
        _, dets, valid = self.eval_step(self._eval_state(),
                                        put_batch(batch, self.device))
        dets, valid = dets.cpu().numpy(), valid.cpu().numpy()
        imgs = np.asarray(batch["img"][:n_img])
        if imgs.dtype != np.uint8:
            imgs = (imgs * 255).astype(np.uint8)
        for i in range(min(n_img, imgs.shape[0])):
            img = np.ascontiguousarray(imgs[i])
            img = draw_boxes(img, annots_to_boxes(batch["annot"][i], size),
                             names, color=(255, 0, 0))
            img = draw_boxes(img, dets[i][valid[i]], names,
                             color=(0, 255, 0))
            self.writer.add_image(f"val_detections/{i}", img, step,
                                  dataformats="HWC")

    def _class_names(self) -> list[str]:
        names_path = self.cfg.get("names")
        n = self.cfg["num_classes"]
        try:
            with open(names_path) as f:
                names = [l.strip() for l in f if l.strip()]
            if len(names) >= n:
                return names[:n]
        except (TypeError, OSError):
            pass
        return [f"class{i}" for i in range(n)]

    def _eval_state(self) -> TrainState:
        """The state evaluation runs on: with cfg ``ema.eval`` a copy of
        the model holding the EMA shadow's weights, else the training
        state itself."""
        use_ema = self._ema_eval and self.state.ema is not None
        if self._fsdp:
            return TrainState(self._whole_model(
                full_tree(self.state.ema) if use_ema else None),
                self.state.optimizer, self.state.schedule, self.state.step)
        if not use_ema:
            return self.state
        if self._ema_model is None:
            self._ema_model = copy.deepcopy(self.state.model)
        weights = self._ema_model.state_dict()
        weights.update(self.state.ema)
        self._ema_model.load_state_dict(weights)
        return TrainState(self._ema_model, self.state.optimizer,
                          self.state.schedule, self.state.step)

    def _one_process(self, tree: dict) -> dict:
        """A ``state_dict``-keyed tree of FSDP-gathered tensors with the
        tensor layout's blocks gathered whole."""
        return whole_payload(self.state, {"model": tree})["model"]

    def _whole_model(self, override: dict | None = None):
        """Under FSDP: a plain model on this rank's device holding the
        whole weights (gathered: every rank calls it), with ``override``'s
        entries in place of theirs; evaluation, the EMA's and SWA's
        weights run on it."""
        weights = self._one_process(full_tree(self.state.model.state_dict()))
        if override:
            weights.update(self._one_process(override))
        if self._replica is None:
            devices = [self.device] if self.device.type == "cuda" else []
            with torch.random.fork_rng(devices=devices):
                self._replica = build_model(self.cfg, self.device,
                                            train=True)
        self._replica.load_state_dict(weights)
        return self._replica

    def validate(self, val_loader) -> dict:
        """val_loss + val_mAP over the full validation set, on
        :meth:`_eval_state`.

        Under a process group each rank's loader holds its shard (equal
        batch counts), every rank's (annot, dets, valid, n_valid) rows are
        gathered to every rank, so each scores the global mAP as
        ``podtpu``'s hosts do, and the val loss is the mean over the
        ranks."""
        self.map_metric.reset_states()
        losses = []
        val_loader.set_epoch(0)
        eval_state = self._eval_state()
        for batch in val_loader:
            n_valid = batch.pop("n_valid", batch["img"].shape[0])
            loss, dets, valid = self.eval_step(
                eval_state, put_batch(batch, self.device))
            losses.append(float(loss))
            rows = (batch["annot"], dets.cpu().numpy(), valid.cpu().numpy(),
                    int(n_valid))
            for ann, det, val, nv in gather_rows(rows):
                # a padded final batch repeats its last sample: slice them
                self.map_metric.update_state(ann[:nv], det[:nv], val[:nv])
        val_loss = mean_over_ranks(float(np.mean(losses)) if losses
                                   else float("nan"))
        val_map = self.map_metric.result()
        return {"val_loss": val_loss, "val_mAP": val_map}
