"""The multi-process training run on the CPU: ``python -m
torch.distributed.run --nproc_per_node 2 -m podtpu_torch.train.run
--distributed --backend gloo --device cpu`` (``train.py --distributed``'s
counterpart) against one process.

Two jobs, each two ranks meeting through a file store under the test's
temporary directory (``--init-method file://``; torchrun's own agent runs
``--standalone``, on a port the system picks):

1. data parallelism, one epoch of ``tests/torch_parity.py::recipe_cfg``
   (YOLOv3 at 64 px, float32, global batch 4) on synthetic JPEGs: held
   against a one-process ``Trainer.fit`` fed the same global batches (the
   two ranks' loader shards, stacked), its checkpoint resumed in one
   process, its validation against a one-process ``validate``;
2. FSDP (``parallel_options.fsdp``) resuming the one-process fit's
   checkpoint, stopped by a SIGTERM to one of its ranks: both stop at the
   same step and exit 0, and the checkpoint they leave resumes in one
   process.

TensorBoard runs without TensorFlow in the jobs (its own stub,
``tensorboard.compat.notf``; importing TensorFlow costs ~15 s a process).
"""

from __future__ import annotations

import os
import re
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import yaml

from tests.torch_parity import (  # noqa: F401  (fixture)
    RecordingWriter,
    recipe_cfg,
    recording_writer,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOB_TIMEOUT_S = 240
EPOCH = re.compile(r"^epoch (\d+): (.*)$")
# both ranks print it, into one output, so two may share a line
ENDED = re.compile(r"rank (\d) of 2: fit ended at step (\d+)")


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """8 train and 8 val synthetic JPEGs at 80 px: two steps an epoch and
    two val batches of two a rank."""
    from podtpu_torch.data.synthetic import generate

    out = tmp_path_factory.mktemp("synth8")
    return generate(str(out), n_train=8, n_val=8, size=80, num_classes=20,
                    max_objects=3, seed=1)


def _cfg(synth, save_dir) -> dict:
    """recipe_cfg (global batch 4) for one epoch, a loader thread a rank."""
    return recipe_cfg(synth, save_dir, workers=1, epochs=1)


def _write_cfg(cfg, path) -> str:
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def _env(tmp) -> dict:
    site = os.path.join(tmp, "site")
    os.makedirs(site, exist_ok=True)
    with open(os.path.join(site, "sitecustomize.py"), "w") as f:
        f.write("import sys, types\n"
                "sys.modules.setdefault('tensorboard.compat.notf', "
                "types.ModuleType('tensorboard.compat.notf'))\n")
    env = dict(os.environ, PYTHONUNBUFFERED="1", OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join([site, REPO]))
    env.pop("RANK", None)
    return env


def _torchrun(tmp, name, cfg_path, *extra):
    """Start a two-rank run of ``train.run``; its output goes to a file."""
    log = open(os.path.join(tmp, f"{name}.log"), "w")
    store = os.path.join(tmp, f"{name}.store")
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "podtpu_torch.train.run",
         "--cfg", cfg_path, "--device", "cpu", "--distributed",
         "--backend", "gloo", "--init-method", f"file://{store}", *extra],
        cwd=REPO, env=_env(tmp), stdout=log, stderr=subprocess.STDOUT,
        start_new_session=True)
    return proc, log


def _finish(proc, log, timeout=JOB_TIMEOUT_S) -> str:
    """Wait for the run (killing its whole process group on a timeout) and
    return its output; no process outlives this."""
    try:
        proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        log.close()
    with open(log.name) as f:
        out = f.read()
    assert proc.returncode == 0, out[-4000:]
    return out


def _epochs(out: str) -> dict:
    """{epoch: {key: value}} from rank 0's epoch lines."""
    rows = {}
    for line in out.splitlines():
        m = EPOCH.match(line.strip())
        if m:
            rows[int(m.group(1))] = {k: float(v) for k, v in (
                kv.split("=") for kv in m.group(2).split())}
    return rows


def _workers(pid: int) -> list[int]:
    with open(f"/proc/{pid}/task/{pid}/children") as f:
        return [int(p) for p in f.read().split()]


class _Stacked:
    """One process's loader of the global batches a two-rank run sees:
    both ranks' shards, rank 0's rows first."""

    def __init__(self, cfg, which: int):
        from podtpu_torch.train.run import make_loaders

        self.parts = [make_loaders(cfg, host_id=r, host_count=2)[which]
                      for r in range(2)]

    def set_epoch(self, epoch):
        for p in self.parts:
            p.set_epoch(epoch)

    def __len__(self):
        return len(self.parts[0])

    def __iter__(self):
        for a, b in zip(*self.parts):
            out = {k: np.concatenate([a[k], b[k]]) for k in ("img", "annot")}
            assert a["n_valid"] == len(a["img"]) == b["n_valid"]
            out["n_valid"] = a["n_valid"] + b["n_valid"]
            yield out


@pytest.fixture(scope="module")
def runs(synth, tmp_path_factory):
    """Job 1 (DP, one epoch) beside the one-process fit of its global
    batches, then job 2 (FSDP from the one-process fit's ``last``, SIGTERM
    to a rank after its first epoch)."""
    from podtpu_torch.train.trainer import Trainer

    tmp = str(tmp_path_factory.mktemp("parallel_fit"))
    save_dir = os.path.join(tmp, "saved")
    cfg = _cfg(synth, save_dir)
    dp_cfg = _write_cfg(cfg, os.path.join(tmp, "dp.yaml"))
    proc, log = _torchrun(tmp, "dp", dp_cfg)
    try:
        # meanwhile, one process on the same global batches
        one_dir = os.path.join(tmp, "one")
        mp = pytest.MonkeyPatch()
        mp.setattr(Trainer, "writer", property(lambda t: RecordingWriter()))
        try:
            one = Trainer(cfg, run_dir=one_dir, device="cpu",
                          log=lambda _m: None)
            history = one.fit(_Stacked(cfg, 0), _Stacked(cfg, 1))
        finally:
            mp.undo()
    finally:
        dp_out = _finish(proc, log)
    dp_run = os.path.join(save_dir, "yolov3_voc", "version_0")
    last = os.path.join(one_dir, "checkpoints", "last")

    fsdp_cfg = _write_cfg(dict(cfg, epochs=40,
                               parallel_options={"fsdp": True}),
                          os.path.join(tmp, "fsdp.yaml"))
    proc, log = _torchrun(tmp, "fsdp", fsdp_cfg, "--resume", last)
    signalled = None
    try:
        deadline = time.time() + JOB_TIMEOUT_S
        while time.time() < deadline and proc.poll() is None:
            with open(log.name) as f:
                if _epochs(f.read()):
                    workers = _workers(proc.pid)
                    signalled = workers[-1]
                    os.kill(signalled, signal.SIGTERM)
                    break
            time.sleep(0.2)
    finally:
        fsdp_out = _finish(proc, log)
    yield {"cfg": cfg, "save_dir": save_dir, "dp_out": dp_out,
           "dp_run": dp_run, "history": history, "fsdp_out": fsdp_out,
           "signalled": signalled}
    # ~2 GB of checkpoints (280 MB each at 64 px): the suite shares its disk
    shutil.rmtree(tmp, ignore_errors=True)


def _trainer(cfg, **kw):
    from podtpu_torch.train.trainer import Trainer

    return Trainer(cfg, device="cpu", log=lambda _m: None, **kw)


@pytest.mark.parametrize("key", ["train_loss", "val_loss", "val_mAP"])
def test_two_rank_fit_matches_one_process(runs, key):
    """Job 1's epoch (rank 0's line, 5 significant digits) against one
    process fed the same global batches: the train loss (the mean of the
    ranks' losses, averaged over the ranks), the val loss (the ranks'
    mean) and the val mAP scored over every rank's rows."""
    got = _epochs(runs["dp_out"])
    assert list(got) == [0]
    want = runs["history"][0][key]
    assert np.isfinite(want)
    assert got[0][key] == pytest.approx(want, rel=1e-4, abs=1e-5)


@pytest.mark.parametrize("key", ["val_loss", "val_mAP"])
def test_two_rank_validate_equals_one_process_validate(runs, recording_writer,
                                                       key):
    """Job 1's global val loss and mAP (every rank's detections gathered
    to every rank) equal a one-process ``validate`` of the weights it
    saved, on the whole val set."""
    from podtpu_torch.train.run import make_loaders
    from podtpu_torch.train.trainer import restore_weights

    cfg = runs["cfg"]
    trainer = _trainer(cfg, eval_only=True)
    restore_weights(os.path.join(runs["dp_run"], "checkpoints", "last"),
                    trainer.state)
    want = trainer.validate(make_loaders(cfg)[1])[key]
    assert _epochs(runs["dp_out"])[0][key] == pytest.approx(
        want, rel=1e-4, abs=1e-5)


def test_one_run_directory_and_one_set_of_checkpoints(runs):
    """Rank 0 made the run directory and wrote the checkpoints: one
    ``version_N`` a job (job 2 is ``version_1``), ``last`` and ``best``
    once, no staging or temporary leftovers."""
    base = os.path.join(runs["save_dir"], "yolov3_voc")
    assert sorted(os.listdir(base)) == ["version_0", "version_1"]
    ckpts = os.path.join(runs["dp_run"], "checkpoints")
    assert sorted(os.listdir(ckpts)) == ["best", "last"]
    assert os.listdir(os.path.join(ckpts, "last")) == ["state.pt"]


@pytest.mark.parametrize("job", ["dp", "fsdp"])
def test_checkpoint_resumes_in_one_process(runs, recording_writer, job):
    """A checkpoint written by two ranks (job 1's DP ``last``; job 2's
    FSDP ``last``, gathered whole) resumes in one process: the weights,
    the momentum and the step are the file's, and a train step goes on
    from them."""
    cfg = runs["cfg"]
    if job == "dp":
        path = os.path.join(runs["dp_run"], "checkpoints", "last")
    else:
        path = os.path.join(runs["save_dir"], "yolov3_voc", "version_1",
                            "checkpoints", "last")
    payload = torch.load(os.path.join(path, "state.pt"), weights_only=True)
    trainer = _trainer(cfg, run_dir=os.path.join(runs["save_dir"],
                                                 f"resume_{job}"))
    state = trainer.ckpt.restore(path, trainer.state)
    assert state.step == payload["step"] >= 2
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, payload["model"][k]), k
    momentum = payload["optimizer"]["state"]
    assert len(momentum) == len(state.params())
    for i, p in enumerate(state.params()):
        assert torch.equal(state.optimizer.state[p]["momentum_buffer"],
                           momentum[i]["momentum_buffer"])
    from podtpu_torch.train.run import make_loaders
    from podtpu_torch.train.trainer import put_batch

    batch = next(iter(make_loaders(cfg)[0]))
    batch.pop("n_valid")
    state, metrics = trainer.train_step(state, put_batch(batch, "cpu"))
    assert np.isfinite(float(metrics["loss"]))
    assert state.step == payload["step"] + 1 and state.count == \
        payload["count"] + 1


def test_fsdp_job_resumed_the_one_process_checkpoint(runs):
    """Job 2 (FSDP over the two ranks) took the one-process fit's
    checkpoint at step 2, every rank its shards of it."""
    assert "resumed from" in runs["fsdp_out"]
    assert "at step 2 (epoch 1)" in runs["fsdp_out"]


@pytest.mark.parametrize("part", ["same_step", "checkpoint"])
def test_sigterm_to_one_rank_stops_both(runs, part):
    """A SIGTERM to one rank of job 2 stops both at the same step (the
    flag is agreed every step): both report that step, the job exits 0
    well before its 40 epochs, and ``last`` holds that step."""
    out = runs["fsdp_out"]
    assert runs["signalled"] is not None
    ended = dict(ENDED.findall(out))
    assert sorted(ended) == ["0", "1"]
    assert ended["0"] == ended["1"]
    step = int(ended["0"])
    if part == "same_step":
        assert "SIGTERM: saved preemption checkpoint 'last'" in out
        assert 2 < step < 2 * 40
    else:
        path = os.path.join(runs["save_dir"], "yolov3_voc", "version_1",
                            "checkpoints", "last", "state.pt")
        assert torch.load(path, weights_only=True)["step"] == step
