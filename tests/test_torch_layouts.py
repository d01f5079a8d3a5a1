"""The layouts' compositions, the tensor layout's leaf rule, and the
autobatch and box tooling of the port, against ``podtpu``.

One four-rank ``gloo`` job (``tests/torch_parallel_job.py four``, four
child processes meeting through a file store under the test's temporary
directory) runs one YOLOv3 train step at 64 px float32 under FSDP on a
``(data=2, space=2)`` mesh and on a ``(data=2, model=2)`` mesh, while this
process, which never joins a process group, runs the same global batch in
one process. Each composition is held as the two-rank layouts are
(``tests/test_torch_parallel.py``): the loss to 1e-5 relative, the update
within 5% of its norm with cosine 0.999, the BN running statistics to
1e-4.
"""

from __future__ import annotations

import functools
import os
import signal
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_parallel_job as job

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 4
JOB_TIMEOUT_S = 300
LOSS_REL = 1e-5


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    """The four-rank job's results by rank, and the one-process step."""
    tmp = str(tmp_path_factory.mktemp("four"))
    store = os.path.join(tmp, "store")
    procs = []
    for r in range(RANKS):
        log = open(os.path.join(tmp, f"rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "tests.torch_parallel_job", str(r),
             str(RANKS), store, os.path.join(tmp, f"rank{r}.npz"), "four"],
            cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
            start_new_session=True), log))
    threads = torch.get_num_threads()
    codes = []
    try:
        torch.set_num_threads(2)
        x = job.inputs()
        flat = job.seeded_flat(job.yolo_cfg(), 3)
        ref = job.steps_run(job.yolo_cfg(), flat, [job.batch(x, 0)],
                            lambda b: b)
        for p, _ in procs:
            codes.append(p.wait(timeout=JOB_TIMEOUT_S))
    finally:
        torch.set_num_threads(threads)
        for p, log in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
            log.close()
    if codes != [0] * RANKS:
        logs = "\n".join(open(os.path.join(tmp, f"rank{r}.log")).read()[-3000:]
                         for r in range(RANKS))
        raise AssertionError(f"the four-rank job failed {codes}:\n{logs}")
    ranks = []
    for r in range(RANKS):
        path = os.path.join(tmp, f"rank{r}.npz")
        with np.load(path) as f:
            ranks.append({k: f[k] for k in f.files})
        os.remove(path)
    return ranks, ref, flat


@pytest.mark.parametrize("layout", ["spatial", "tensor"])
@pytest.mark.parametrize("part", ["mesh", "loss", "update", "batch_stats"])
def test_four_rank_composition_with_fsdp(four, layout, part):
    """``(data=2, space=2)`` and ``(data=2, model=2)`` under FSDP: the mesh
    and FSDP's ranks (``data x space``), the global loss (the mean of the
    data ranks'), and rank 0's gathered weights after the step against one
    process; every rank ends with the same weights."""
    from tests.test_torch_parallel import (
        _assert_stats_near,
        _assert_update_near,
    )

    ranks, ref, flat = four
    pre = f"four/{layout}"
    if part == "mesh":
        shape = (2, 2, 1) if layout == "spatial" else (2, 1, 2)
        for r in ranks:
            assert tuple(int(r[f"{pre}/shape/{i}"]) for i in range(3)) == shape
            assert int(r[f"{pre}/fsdp_ranks"]) == (4 if layout == "spatial"
                                                   else 2)
            assert int(r[f"{pre}/sharded"]) >= 10
            assert r[f"{pre}/digest"] == ranks[0][f"{pre}/digest"]
    elif part == "loss":
        for r in ranks:
            assert float(r[f"{pre}/loss"]) == pytest.approx(ref["loss"][0],
                                                            rel=LOSS_REL)
    else:
        got = job.expand(ranks[0], f"{pre}/flat", flat)
        if part == "update":
            _assert_update_near(got, ref["flat"][0], flat, rel=0.05)
        else:
            _assert_stats_near(got, ref["flat"][0])


# ---- the tensor layout's leaf rule ------------------------------------------

@functools.lru_cache(maxsize=None)
def _podtpu_flat(classes: int) -> dict:
    return job.seeded_flat(job.yolo_cfg(num_classes=classes), 3)


@pytest.mark.parametrize("tensor", [2, 4])
@pytest.mark.parametrize("classes", [20, 80])
def test_tensor_leaf_rule_matches_podtpu(tensor, classes):
    """``podtpu``'s ``_leaf_spec(tensor=True)`` over its YOLOv3 parameter
    tree (the flat weights' HWIO shapes) splits the same leaves as the
    port's ``apply_tensor_layout`` over the port's tree, each on its output
    channels (``podtpu``'s last dim, the port's first), and keeps the BN
    vectors, the stem's 864-element kernel and the odd heads whole."""
    from podtpu.parallel.mesh import MODEL_AXIS, _leaf_spec
    from podtpu_torch.export.weights import conv_paths, flat_key
    from podtpu_torch.models.factory import build_model
    from podtpu_torch.parallel.layouts import apply_tensor_layout

    cfg = job.yolo_cfg(num_classes=classes)
    flat = _podtpu_flat(classes)
    theirs = set()
    for k, v in flat.items():
        if not k.startswith("params"):
            continue
        spec = tuple(_leaf_spec(v.shape, 1, tensor, False, True, 2 ** 14))
        if MODEL_AXIS in spec:
            assert spec[-1] == MODEL_AXIS and spec.count(MODEL_AXIS) == 1, k
            theirs.add(k)
    model = build_model(cfg, torch.device("meta"), train=True)
    convs = conv_paths(model)
    apply_tensor_layout(model, tensor, 0)
    ours = {flat_key(k, convs) for k in model.tp_keys}
    assert ours == theirs
    assert not any("bn" in k or "stem" in k or "pred" in k for k in ours)
    assert len(ours) >= 20


def test_mesh_refuses_a_layout_that_does_not_divide():
    """``make_mesh`` raises as ``podtpu``'s ``_pick_mesh`` does when the
    layouts do not divide the ranks (one process: one rank)."""
    from podtpu_torch.parallel.mesh import make_mesh, parallel_options

    with pytest.raises(ValueError, match="does not divide 1 devices"):
        make_mesh("cpu", spatial=2)
    assert parallel_options(job.yolo_cfg(parallel_options={
        "spatial": 2, "fsdp": True})) == {"fsdp": True, "spatial": 2,
                                           "tensor": 1}


def test_batch_that_does_not_split_over_the_data_ranks_raises():
    """A deviation from ``podtpu``, whose ``_pick_mesh`` leaves devices out
    until the data axis divides the batch: torchrun fixes the port's rank
    count, so ``make_loaders`` raises before it reads any file."""
    from podtpu_torch.train.run import make_loaders

    with pytest.raises(ValueError, match="does not split over 3 ranks"):
        make_loaders({"batch_size": 4}, host_id=0, host_count=3)


# ---- the box tooling and autobatch ------------------------------------------

@pytest.mark.parametrize("fn", ["xywhn_to_xyxy", "xyxy_to_xywhn",
                                "xyxy_to_xywhn_clip"])
def test_box_conversions_match_podtpu(fn):
    """``podtpu_torch.ops.xywhn_to_xyxy`` / ``xyxy_to_xywhn`` against
    ``podtpu``'s on seeded boxes (with the letterbox padding, and with
    ``clip`` and ``eps`` on boxes reaching outside the image), within
    1e-6 of the pixel scale."""
    import podtpu.ops as jops

    import podtpu_torch.ops as tops

    r = np.random.default_rng(7)
    w, h = 640.0, 480.0
    if fn == "xywhn_to_xyxy":
        boxes = r.uniform(0.0, 1.0, (3, 50, 4)).astype(np.float32)
        got = tops.xywhn_to_xyxy(torch.from_numpy(boxes), w, h, 8.0, 16.0)
        want = jops.xywhn_to_xyxy(jnp.asarray(boxes), w, h, 8.0, 16.0)
        scale = w
    else:
        boxes = r.uniform(-40.0, 700.0, (3, 50, 4)).astype(np.float32)
        kw = {"clip": True, "eps": 1e-3} if fn.endswith("clip") else {}
        got = tops.xyxy_to_xywhn(torch.from_numpy(boxes), w, h, **kw)
        want = jops.xyxy_to_xywhn(jnp.asarray(boxes), w, h, **kw)
        scale = 1.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6 * scale)


@pytest.fixture(scope="module")
def podtpu_autobatch():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import autobatch
    finally:
        sys.path.pop(0)
    return autobatch


@pytest.mark.parametrize("limit,frac", [(22, 1.0), (100, 1.0), (22, 0.5),
                                        (18, 0.5), (40, 1.0), (0, 0.9)])
def test_autobatch_recommend_matches_podtpu(podtpu_autobatch, limit, frac):
    """``recommend`` keeps ``podtpu``'s rule: the largest batch whose peak
    fits ``frac`` of the limit, or None."""
    from podtpu_torch.cli.autobatch import recommend

    rows = [{"batch": 8, "peak": 10}, {"batch": 16, "peak": 19},
            {"batch": 32, "peak": 40}, {"batch": 64, "peak": 41}]
    want = podtpu_autobatch.recommend(rows, limit_bytes=limit, frac=frac)
    assert recommend(rows, limit_bytes=limit, frac=frac) == want
    if limit in (0, 18):
        assert want is None


def test_autobatch_measures_on_the_card_only():
    """The CPU has no peak-memory reading: ``measure_memory`` raises there;
    the card's memory comes from ``--mem-gb`` when given."""
    from podtpu_torch.cli.autobatch import device_memory_bytes, measure_memory

    with pytest.raises(ValueError, match="CUDA allocator"):
        measure_memory(job.yolo_cfg(), 2, device="cpu")
    assert device_memory_bytes(80.0, device="cpu") == 80 * (1 << 30)
    assert device_memory_bytes(None, device="cpu") is None
