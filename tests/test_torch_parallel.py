"""Data parallelism and FSDP in the port (``podtpu_torch/parallel/``) on the
CPU, against ``podtpu``'s mesh and against the port's one-process run of
the global batch.

One two-rank ``gloo`` job (``tests/torch_parallel_job.py``, two child
processes meeting through a file store under the test's temporary
directory) runs every check and writes its results; this process, which
never joins a process group, computes the references while the job runs:
``podtpu``'s YOLOv3 train step on a 2-device mesh of the virtual CPU
devices (``tests/conftest.py``), its RetinaNet loss, and the port's
one-process runs. Each check is then a test of its own on those results.

Tolerances: a two-rank run sums the same float32 numbers in another order
than one process does, so outputs are held to 1e-5 relative and gradients
(a backward of those sums) to 1e-4 of their scale. A train step's loss is
held to 1e-5 relative, as ``podtpu``'s own DP check
(``tests/test_train.py::test_multichip_dp_mesh``) holds it. Its update is
not held to that check's rtol 2e-4 / atol 1e-6 on the parameters: at
these random weights the update of full-width YOLOv3 is ill-conditioned
(``tests/test_torch_train.py::test_two_train_steps_match_podtpu``);
``podtpu``'s own step on 2 devices lands 3.5% of the update's norm from
its step on 1 device, with 79 leaves outside rtol 2e-4 (its own check
passes because its first step's learning rate is 0, a ``yolo_lr``
burn-in). So an update is held within 5% of the reference update's norm
with cosine 0.999, as that test holds a first step (measured: 3.1% from
``podtpu``'s mesh step, 1.4% from the port's one-process step).
"""

from __future__ import annotations

import hashlib
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_parallel_job as job
from tests.torch_parity import (  # noqa: F401  (fixture)
    cached_podtpu_states,
    flax_variables,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
JOB_TIMEOUT_S = 300
LOSS_REL = 1e-5
PARAM_TOL = dict(rtol=2e-4, atol=1e-6)


def _flat_of_jax(jstate) -> dict:
    out = {}
    for coll in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                getattr(jstate, coll))[0]:
            out["::".join([coll] + [str(p.key) for p in path])] = \
                np.asarray(leaf)
    return out


def _launch(tmp):
    """Start the job's ranks; their outputs and logs go to ``tmp``."""
    store = os.path.join(tmp, "store")
    procs = []
    for r in range(WORLD):
        log = open(os.path.join(tmp, f"rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "tests.torch_parallel_job", str(r),
             str(WORLD), store, os.path.join(tmp, f"rank{r}.npz")],
            cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
            start_new_session=True), log))
    return procs


def _wait(procs, tmp):
    """Wait for every rank (killing all on a timeout or a failure) and
    return their exit codes; no child outlives this."""
    codes = []
    try:
        for p, _ in procs:
            codes.append(p.wait(timeout=JOB_TIMEOUT_S))
    finally:
        for p, log in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
            log.close()
    if codes != [0] * WORLD:
        logs = "\n".join(open(os.path.join(tmp, f"rank{r}.log")).read()[-3000:]
                         for r in range(WORLD))
        raise AssertionError(f"the two-rank job failed {codes}:\n{logs}")
    return codes


def _podtpu_mesh_step(cfg, flat, b):
    """``podtpu``'s train step on a 2-device mesh of the global batch."""
    from podtpu.parallel.mesh import (
        make_mesh,
        replicated_sharding,
        shard_batch,
    )
    from podtpu.train.state import create_train_state
    from podtpu.train.steps import make_train_step

    mesh = make_mesh(jax.devices()[:WORLD])
    state = create_train_state(cfg, jax.random.PRNGKey(0))
    v = flax_variables(flat)
    state = state.replace(params=v["params"], batch_stats=v["batch_stats"])
    state = jax.device_put(state, replicated_sharding(mesh))
    batch = shard_batch({k: jnp.asarray(a) for k, a in b.items()}, mesh)
    state, m = make_train_step(cfg, mesh, donate=False)(
        state, batch, jax.random.PRNGKey(1))
    return float(m["loss"]), _flat_of_jax(state)


def _podtpu_retina(x):
    """``podtpu``'s RetinaNet loss on the global heads, and its gradient."""
    from podtpu.ops import retina as jretina

    heads = [(jnp.asarray(x[f"retina_cls{i}"]), jnp.asarray(x[f"retina_box{i}"]))
             for i in range(5)]
    loss, grads = jax.jit(jax.value_and_grad(
        lambda hs: jretina.retinanet_loss(
            hs, jnp.asarray(x["retina_annot"]), job.C, 64)))(heads)
    out = {"loss": float(loss)}
    for i, (gc, gb) in enumerate(grads):
        out[f"gcls{i}"], out[f"gbox{i}"] = np.asarray(gc), np.asarray(gb)
    return out


def _one_process(x, flat, flat_v1):
    """The port's runs of the global inputs in this process (no group)."""
    torch.set_num_threads(2)
    whole = lambda b: b  # noqa: E731
    opts = [job.batch(x, 0), job.batch(x, 1), job.nan_batch(x)]
    ref = {
        "bn": job.bn_run(x),
        "stem": job.stem_run(x),
        "dp": job.steps_run(job.yolo_cfg(), flat, [job.batch(x, 0)], whole),
        "augment": job.steps_run(job.yolo_cfg(device_augment=True), flat,
                                 [job.batch(x, 1)], whole),
        "options": job.steps_run(job.options_cfg(), flat, opts, whole,
                                 keep=(1, 2)),
        "yolov1": job.steps_run(job.yolov1_cfg(), flat_v1,
                                [job.batch(x, 0)], whole),
        "stats": job.stats_run(job.yolo_cfg(), flat, job.batch(x, 2)),
        "dropout": job.dropout_run(x),
    }
    return ref


@pytest.fixture(scope="module")
def parallel(tmp_path_factory, cached_podtpu_states):
    """The job's results by rank (``{key: array}``), and the references."""
    tmp = str(tmp_path_factory.mktemp("parallel"))
    procs = _launch(tmp)
    cfg = job.yolo_cfg()
    threads = torch.get_num_threads()
    try:
        x = job.inputs()
        # seeded weights in podtpu's layout (He-normal kernels, non-trivial
        # BN affine and statistics): PyTorch's default init leaves deep BN
        # layers with a variance E[x^2] - mean^2 that float32 rounding
        # dominates
        flat = job.seeded_flat(cfg, 3)
        flat_v1 = job.seeded_flat(job.yolov1_cfg(), 4)
        ref = _one_process(x, flat, flat_v1)
        ref["podtpu_loss"], ref["podtpu"] = _podtpu_mesh_step(
            cfg, flat, job.batch(x, 0))
        ref["podtpu_retina"] = _podtpu_retina(x)
    finally:
        torch.set_num_threads(threads)
        _wait(procs, tmp)
    ranks = []
    for r in range(WORLD):
        path = os.path.join(tmp, f"rank{r}.npz")
        with np.load(path) as f:
            ranks.append({k: f[k] for k in f.files})
        os.remove(path)  # ~0.5 GB: the suite shares its disk
    return ranks, ref, flat, flat_v1


def _sub(res: dict, prefix: str) -> dict:
    n = len(prefix) + 1
    return {k[n:]: v for k, v in res.items() if k.startswith(prefix + "/")}


def _rows(res_by_rank, key):
    return np.concatenate([r[key] for r in res_by_rank])


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def _update(after: dict, before: dict, keys) -> np.ndarray:
    return np.concatenate([(np.asarray(after[k]) - before[k]).ravel()
                           for k in keys])


def _assert_update_near(got: dict, want: dict, before: dict, rel: float):
    """The update ``got - before`` within ``rel`` of ``want - before``'s
    norm, with cosine 0.999."""
    keys = sorted(k for k in want if k.startswith("params"))
    assert set(keys) == {k for k in got if k.startswith("params")}
    ug, uw = _update(got, before, keys), _update(want, before, keys)
    assert np.linalg.norm(ug - uw) <= rel * np.linalg.norm(uw)
    assert ug @ uw >= 0.999 * np.linalg.norm(ug) * np.linalg.norm(uw)


def _assert_stats_near(got: dict, want: dict):
    """BN running statistics (a forward's, well conditioned): rtol 1e-4
    and 1e-4 of the leaf's scale."""
    for k, w in want.items():
        if "batch_stats" in k or "running" in k:
            w = np.asarray(w)
            _close(got[k], w, 1e-4, 1e-4 * max(1.0, float(np.abs(w).max())),
                   k)


# ---- BatchNorm and the stem ------------------------------------------------

@pytest.mark.parametrize("part", ["out", "gx", "gw", "gb", "running"])
def test_batchnorm_takes_the_global_batch_statistics(parallel, part):
    """``BatchNormMixed`` in train mode on two rows a rank equals one
    process on the four: the output and the input's gradient row by row,
    the parameters' gradients as the sum of the ranks' shares, the running
    statistics (Bessel's correction with the global count) on both."""
    ranks, ref, _, _ = parallel
    want = ref["bn"]
    if part in ("out", "gx"):
        _close(_rows(ranks, f"bn/{part}"), want[part].detach(), 1e-4, 1e-6,
               part)
    elif part in ("gw", "gb"):
        scale = float(np.abs(want[part].numpy()).max())
        _close(sum(r[f"bn/{part}"] for r in ranks), want[part], 1e-4,
               1e-5 * scale, part)
    else:
        for r in ranks:
            _close(r["bn/mean"], want["mean"], 1e-5, 1e-6, "mean")
            _close(r["bn/var"], want["var"], 1e-5, 1e-6, "var")


@pytest.mark.parametrize("part", ["out", "gw", "gscale", "gbias", "running"])
def test_stem_op_under_dp_matches_one_process(parallel, part):
    """The fused stem op on the CPU under a group runs the plain versions
    of its four passes through ``StemPoolFunction``, with the stats sums
    and a copy of the backward sums all-reduced between them: the pooled
    output row by row, dW and the BN gradients (each rank's share, summed
    by the gradient reduction) and the running statistics equal one
    process's whole-op plain version on the global batch."""
    ranks, ref, _, _ = parallel
    want = ref["stem"]
    if part == "out":
        _close(_rows(ranks, "stem/out"), want["out"], 1e-5, 1e-6, part)
    elif part == "running":
        for r in ranks:
            _close(r["stem/mean"], want["mean"], 1e-5, 1e-6, "mean")
            _close(r["stem/var"], want["var"], 1e-5, 1e-6, "var")
    else:
        # sums over 1,024 pixels in another order: off by float32 rounding
        # of the tensor's scale
        scale = float(np.abs(want[part].numpy()).max())
        _close(sum(r[f"stem/{part}"] for r in ranks), want[part], 1e-4,
               1e-5 * scale, part)


# ---- the train step --------------------------------------------------------

def _mean_loss(ranks, prefix, i=0):
    return float(np.mean([r[f"{prefix}/loss/{i}"] for r in ranks]))


def _params(flat: dict) -> dict:
    return {k: v for k, v in flat.items() if k.startswith("params")}


@pytest.mark.parametrize("part", ["loss", "update", "batch_stats"])
def test_dp_step_matches_podtpu_mesh_step(parallel, part):
    """One YOLOv3 train step (64 px, float32) on two ranks against
    ``podtpu``'s step on a 2-device mesh of the same global batch and
    weights: the mean of the ranks' losses (the YOLO losses divide by the
    batch) to 1e-5; the update within 5% of its norm with cosine 0.999;
    the BN running statistics, moved once from the global batch, to
    1e-4."""
    ranks, ref, flat, _ = parallel
    got = job.expand(ranks[0], "dp/flat0", flat)
    if part == "loss":
        assert _mean_loss(ranks, "dp") == pytest.approx(ref["podtpu_loss"],
                                                        rel=LOSS_REL)
    elif part == "update":
        _assert_update_near(got, ref["podtpu"], flat, rel=0.05)
    else:
        _assert_stats_near(got, ref["podtpu"])


@pytest.mark.parametrize("run", ["dp", "augment", "yolov1"])
def test_dp_step_matches_one_process_step(parallel, run):
    """The two-rank step against the port's own step on the global batch
    in one process: YOLOv3, YOLOv3 with ``device_augment`` (the gains and
    flips drawn for the global batch, each rank keeping its rows), and
    YOLOv1 with its dropout on (the masks
    drawn likewise). The loss to 1e-5 (YOLOv1 to 1e-4: its 1x1 head maps
    give each BatchNorm four values a channel), the update within 5% of
    its norm with cosine 0.999, the running statistics to 1e-4."""
    ranks, ref, flat, flat_v1 = parallel
    want = ref[run]
    assert _mean_loss(ranks, run) == pytest.approx(
        want["loss"][0], rel=1e-4 if run == "yolov1" else LOSS_REL)
    before = flat_v1 if run == "yolov1" else flat
    got = job.expand(ranks[0], f"{run}/flat0", before)
    _assert_update_near(got, want["flat"][0], before, rel=0.05)
    _assert_stats_near(got, want["flat"][0])


@pytest.mark.parametrize("run", ["dp", "fsdp", "options_fsdp", "augment",
                                 "yolov1"])
def test_ranks_end_with_the_same_state(parallel, run):
    """Both ranks hold the same weights bit for bit after their steps (the
    averaged gradients and the global statistics are the same numbers on
    each), and took as many steps."""
    ranks, _, _, _ = parallel
    keys = [k for k in ranks[0] if k.startswith(f"{run}/digest")]
    assert keys
    for k in keys:
        assert ranks[0][k] == ranks[1][k], k
    assert int(ranks[0][f"{run}/step"]) == int(ranks[1][f"{run}/step"])


@pytest.mark.parametrize("part", ["sharded", "weights", "loss"])
def test_fsdp_step_matches_dp_step(parallel, part):
    """``parallel_options.fsdp`` (FSDP2 over the two ranks): at least 10
    parameter leaves sharded, as ``podtpu``'s dry run asks, the loss and
    the updated weights those of the DP step (rtol 2e-4, atol 1e-6)."""
    ranks, _, _, _ = parallel
    for r in ranks:
        if part == "sharded":
            assert int(r["fsdp/sharded"]) >= 10
            assert int(r["dp/sharded"]) == 0
        elif part == "weights":
            assert float(r["fsdp/vs_dp"]) <= 1.0
        else:
            assert float(r["fsdp/loss/0"]) == pytest.approx(
                float(r["dp/loss/0"]), rel=LOSS_REL)


@pytest.mark.parametrize("part", ["update", "clip_norm", "ema", "skip"])
def test_train_options_under_fsdp(parallel, part):
    """``accum_steps: 2`` with ``clip_grad_norm`` (exceeded), ``ema`` and
    ``skip_nonfinite`` over three steps on two FSDP ranks (DTensor
    gradients, shards of the accumulator, the shadow and the norm) against
    one process: the one update after two micro-steps, the clip's global
    norm reduced over the shards (1e-3: the norm of an ill-conditioned
    gradient, measured 3e-4), the EMA shadow, and a third step with a NaN
    in the second rank's rows only, which both ranks skip (the weights
    unchanged, one non-finite step counted, as one process counts it)."""
    ranks, ref, flat, _ = parallel
    want = ref["options"]
    name = "options_fsdp"
    if part == "update":
        got = job.expand(ranks[0], f"{name}/flat1", flat)
        _assert_update_near(got, want["flat"][1], flat, rel=0.05)
        _assert_stats_near(got, want["flat"][1])
    elif part == "ema":
        before = want["ema0"]
        got = job.expand(ranks[0], f"{name}/ema", before)
        # the shadow's move from its start, every entry
        tag = lambda d: {f"params/{k}": v for k, v in d.items()}  # noqa: E731
        _assert_update_near(tag(got), tag(want["ema"]), tag(before),
                            rel=0.05)
        assert str(ranks[0][f"{name}/ema_digest"]) == str(
            ranks[1][f"{name}/ema_digest"])
    for r in ranks:
        if part == "clip_norm":
            assert len(want["norms"]) == 1 and want["norms"][0] > 5.0
            assert float(r[f"{name}/norms/0"]) == pytest.approx(
                want["norms"][0], rel=1e-3)
        elif part == "skip":
            assert np.isnan(float(r[f"{name}/loss/2"]))
            assert bool(r[f"{name}/nan_step_unchanged"])
            assert (int(r[f"{name}/step"]), int(r[f"{name}/count"]),
                    int(r[f"{name}/notfinite"])) == (
                        want["step"], want["count"], want["notfinite"]) \
                == (3, 1, 1)
    if part == "skip":
        assert job.digest(want["flat"][2]) == job.digest(want["flat"][1])


def test_dropout_masks_are_the_global_batch_rows(parallel):
    """``SeededDropout`` under data parallelism draws the global batch's
    mask and keeps the rank's rows: the ranks' outputs stacked are one
    process's, bit for bit."""
    ranks, ref, _, _ = parallel
    got = np.concatenate([r["dropout"] for r in ranks])
    np.testing.assert_array_equal(got, ref["dropout"].numpy())
    assert 0 < (got == 0).mean() < 1


@pytest.mark.parametrize("part", ["loss", "grads"])
def test_retinanet_loss_uses_the_global_positive_count(parallel, part):
    """RetinaNet's loss on two rows a rank divides by the global batch's
    positives (all-reduced, no gradient through it): the mean of the
    ranks' losses is ``podtpu``'s loss on the global heads to 1e-6, and
    each rank's head gradients, over the ranks (the gradient average),
    are ``podtpu``'s rows."""
    ranks, ref, _, _ = parallel
    want = ref["podtpu_retina"]
    if part == "loss":
        got = float(np.mean([float(r["retina/loss"]) for r in ranks]))
        assert got == pytest.approx(want["loss"], rel=1e-6)
        return
    for i in range(5):
        for k in ("gcls", "gbox"):
            got = _rows(ranks, f"retina/{k}{i}") / WORLD
            _close(got, want[f"{k}{i}"], 1e-5, 1e-7, f"{k}{i}")


def test_stats_step_returns_global_statistics(parallel):
    """``make_stats_step`` (SWA's recalibration pass) under data
    parallelism gives every rank the global batch's statistics."""
    ranks, ref, _, _ = parallel
    want = ref["stats"]
    for r in ranks:
        got = _sub(r, "stats")
        assert set(got) == set(want)
        _assert_stats_near(got, {k: w.numpy() for k, w in want.items()})


@pytest.mark.parametrize("part", ["finite", "sharded", "fsdp_vs_dp"])
def test_dryrun_runs_dp_and_fsdp(parallel, part):
    """``podtpu_torch/parallel/dryrun.py`` (``dryrun_multichip``'s
    counterpart) on the two ranks: a DP and an FSDP step, a K=2 group and
    the TTA eval step with device augmentation, the warp and the EMA on;
    FSDP shards at least 10 leaves and ends where DP ends."""
    ranks, _, _, _ = parallel
    for r in ranks:
        if part == "finite":
            for k in ("dp_loss", "fsdp_loss", "val_loss"):
                assert np.isfinite(float(r[f"dryrun/{k}"])), k
        elif part == "sharded":
            assert int(r["dryrun/fsdp_sharded_leaves"]) >= 10
        else:
            assert float(r["dryrun/fsdp_vs_dp"]) <= 1e-5


# ---- in this process: options, refusals, the one-process path --------------

@pytest.mark.parametrize("key", ["tensor", "spatial"])
def test_tensor_and_spatial_layouts_raise(key):
    """``parallel_options.tensor`` / ``.spatial`` > 1 raise
    ``NotImplementedError`` naming item 9, in ``Trainer`` too (where
    ``podtpu``'s ``_pick_mesh`` stood): no cfg key is ignored."""
    from podtpu_torch.parallel.mesh import parallel_options
    from podtpu_torch.train.trainer import Trainer

    cfg = job.yolo_cfg(parallel_options={key: 2})
    with pytest.raises(NotImplementedError, match="item 9"):
        parallel_options(cfg)
    with pytest.raises(NotImplementedError, match="item 9"):
        Trainer(cfg, device="cpu", eval_only=True)
    assert parallel_options(job.yolo_cfg(parallel_options={key: 1})) is False


def test_fsdp_without_a_group_raises():
    from podtpu_torch.train.trainer import Trainer

    with pytest.raises(ValueError, match="process group"):
        Trainer(job.yolo_cfg(parallel_options={"fsdp": True}), device="cpu",
                eval_only=True)


@pytest.mark.parametrize("case", ["no_env", "cpu_nccl", "no_card",
                                  "bad_backend"])
def test_init_distributed_refuses_without_falling_back(monkeypatch, case):
    """``init_distributed`` raises before it joins anything: outside
    torchrun, for the CPU under nccl, for a rank with no card, and for an
    unknown backend. No group is made in this process."""
    import torch.distributed as dist

    from podtpu_torch.parallel.mesh import init_distributed

    env = {"RANK": "0", "WORLD_SIZE": "2", "LOCAL_RANK": "0",
           "MASTER_ADDR": "localhost", "MASTER_PORT": "1"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if case == "no_env":
        monkeypatch.delenv("RANK")
        with pytest.raises(RuntimeError, match="torchrun"):
            init_distributed("gloo", device="cpu")
    elif case == "cpu_nccl":
        with pytest.raises(ValueError, match="gloo"):
            init_distributed("nccl", device="cpu")
    elif case == "no_card":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_distributed()
    else:
        with pytest.raises(ValueError, match="nccl or gloo"):
            init_distributed("mpi")
    assert not dist.is_initialized()


# the one-process YOLOv3 train step as it was before data parallelism was
# ported (taken on that tree): the two losses' float32 bits and a digest of
# every state_dict tensor after them
FROZEN_LOSSES = ["0x1.34228c0000000p+7", "0x1.95bdc40000000p+6"]
FROZEN_STATE = ("33be47720a3d1d884ae8947e66d2059e3aea1290dc5f4bc7568c5e397fde"
                "3469")


def test_single_process_step_is_bit_for_bit_unchanged():
    """Without a process group the train step (the fused stem's plain
    version, ``ConvBnAct`` blocks, BatchNorm's statistics, the update)
    gives the bits it gave before: two YOLOv3 steps at 64 px float32 on
    one thread from a seeded init."""
    from podtpu_torch.data.loader import pad_annotations
    from podtpu_torch.train.state import create_train_state
    from podtpu_torch.train.steps import make_train_step

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = job.yolo_cfg()
        del cfg["seed"], cfg["conf_threshold"], cfg["nms_iou_threshold"]
        del cfg["top_k_candidates"], cfg["max_detections"]
        r = np.random.default_rng(11)
        img = r.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
        boxes = [np.asarray([[*r.uniform(0.2, 0.8, 2),
                              *r.uniform(0.1, 0.6, 2), r.integers(0, 20)]
                             for _ in range(4)], np.float32)
                 for _ in range(2)]
        annot = pad_annotations(boxes, 8)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(5)
            state = create_train_state(cfg, "cpu")
        step = make_train_step(cfg)
        batch = {"img": torch.from_numpy(img),
                 "annot": torch.from_numpy(annot)}
        losses = []
        for _ in range(2):
            state, m = step(state, batch)
            losses.append(float(m["loss"]).hex())
        h = hashlib.sha256()
        for k, v in sorted(state.model.state_dict().items()):
            h.update(k.encode())
            h.update(v.detach().contiguous().numpy().tobytes())
    finally:
        torch.set_num_threads(threads)
    assert losses == FROZEN_LOSSES
    assert h.hexdigest() == FROZEN_STATE
