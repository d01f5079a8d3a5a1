"""The port's YOLOv2 and YOLOv1 families against podtpu (CPU): the models and
their weight carry-over, ``passthrough_reorg``, YOLOv1's targets, both
decoders and losses (value and gradient), one train step, the serving
graph, and a 2-epoch run through the per-family entry points.

Inputs are numpy-seeded; weights are podtpu's flat layout carried into the
port by ``podtpu_torch.export.weights`` (tests/torch_parity.py); float32 at
64 px, and 96 px where YOLOv1's flatten must see more than one cell.
"""

import functools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from podtpu.losses import yolov1_loss as podtpu_yolov1_loss
from podtpu.losses import yolov2_loss_v2 as podtpu_yolov2_loss_v2
from podtpu.models import factory as podtpu_factory
from podtpu.models.layers import passthrough_reorg as podtpu_reorg
from podtpu.ops.assign import encode_yolov1_targets as podtpu_encode_v1
from podtpu.ops.decode import decode_yolov1 as podtpu_decode_yolov1
from podtpu.ops.decode import decode_yolov2 as podtpu_decode_yolov2
from podtpu.train.optim import build_optimizer as podtpu_build_optimizer
from podtpu.train.state import TrainState as PodtpuTrainState
from podtpu.train.steps import make_serve_fn as podtpu_make_serve_fn
from podtpu.train.steps import make_train_step as podtpu_make_train_step
from podtpu_torch.config import get_configs
from podtpu_torch.data.loader import pad_annotations
from podtpu_torch.export.weights import (
    flat_from_state_dict,
    load_flat_weights,
    state_dict_from_flat,
)
from podtpu_torch.losses import build_loss
from podtpu_torch.models import factory
from podtpu_torch.models.factory import build_model
from podtpu_torch.models.layers import SeededDropout, passthrough_reorg
from podtpu_torch.ops.assign import encode_yolov1_targets
from podtpu_torch.ops.decode import decode_yolov1, decode_yolov2
from podtpu_torch.serve import Engine
from podtpu_torch.train.state import create_train_state
from podtpu_torch.train.steps import (
    _as_input,
    make_decoder,
    make_serve_fn,
    make_train_step,
)
from tests.helpers import VOC_SCALED_ANCHORS, make_targets, nchw_to_nhwc, normal
from tests.torch_parity import (  # noqa: F401  (fixtures)
    SEP,
    flax_variables,
    image_batch,
    podtpu_flat_weights,
    recording_writer,
    synth,
    yolo_cfg,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C = 20
FAMILY = {"yolov2": dict(scaled_anchors=VOC_SCALED_ANCHORS),
          "yolov1": dict(num_boxes=2)}


def family_cfg(model: str, size: int = 64, **extra) -> dict:
    cfg = yolo_cfg("float32", size, model=model, **FAMILY[model])
    del cfg["anchors"]
    cfg.update(extra)
    return cfg


@pytest.fixture
def no_dropout(monkeypatch):
    """Both packages build YOLOv1 with dropout rate 0, which switches it
    off in train mode too (podtpu's own parity tests do the same)."""
    from podtpu.models.yolov1 import YoloV1 as JYoloV1
    from podtpu_torch.models.yolov1 import YoloV1

    monkeypatch.setattr(podtpu_factory, "YoloV1",
                        functools.partial(JYoloV1, dropout_rate=0.0))
    monkeypatch.setattr(factory, "YoloV1",
                        functools.partial(YoloV1, dropout_rate=0.0))


_FLAT: dict = {}


def _flat(cfg):
    """podtpu's seeded flat weights for ``cfg``, made once per shape."""
    key = (cfg["model"], cfg["input_size"])
    if key not in _FLAT:
        _FLAT[key] = podtpu_flat_weights(cfg, seed=0)
    return _FLAT[key]


def _podtpu_apply(cfg, flat, x, train):
    out = podtpu_factory.build_model(cfg).apply(
        flax_variables(flat), jnp.asarray(x), train=train,
        mutable=["batch_stats"] if train else False)
    return np.asarray(out[0] if train else out)


# ---- models ---------------------------------------------------------------

@pytest.mark.parametrize("model,size", [("yolov2", 64), ("yolov1", 64),
                                        ("yolov1", 96)])
def test_eval_forward_matches_podtpu(model, size):
    cfg = family_cfg(model, size)
    flat = _flat(cfg)
    x = image_batch(cfg, batch=2).astype(np.float32) / 255.0
    want = _podtpu_apply(cfg, flat, x, train=False)
    net = load_flat_weights(build_model(cfg, device="cpu"), flat)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert torch.is_tensor(got) and got.dtype == torch.float32
    assert got.shape == want.shape == (
        (2, size // 32, size // 32, 125) if model == "yolov2"
        else (2, 7 * 7 * 30))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("model,size", [("yolov2", 64), ("yolov1", 64),
                                        ("yolov1", 96)])
def test_train_forward_matches_podtpu(no_dropout, model, size):
    """Train-mode BN normalizes by the batch's variance, taken as
    E[x^2] - mean^2 in float32 by both packages; where a channel's mean
    is many times its spread that cancels, and the forward amplifies one
    rounding of the input ~300-fold (64 px, B=2: podtpu moves by 1.9e-4
    at most under a 1e-7 relative perturbation of the input, and by 0.12
    in YOLOv1's 64 px head, whose BN sees 2 values a channel). Held to
    rtol 1e-4 / atol 1e-5 beyond 8x that witness, taken in the test
    (measured: the port is 2.4-4.6x the witness away)."""
    cfg = family_cfg(model, size)
    flat = _flat(cfg)
    x = image_batch(cfg, batch=2).astype(np.float32) / 255.0
    want = _podtpu_apply(cfg, flat, x, train=True)
    nudge = np.random.default_rng(1).standard_normal(x.shape) * 1e-7
    witness = np.abs(_podtpu_apply(
        cfg, flat, (x * (1 + nudge)).astype(np.float32), train=True) - want)
    net = load_flat_weights(build_model(cfg, device="cpu", train=True), flat)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 + 8.0 * float(witness.max()))


def test_passthrough_reorg_is_the_raw_nchw_view():
    r = np.random.default_rng(2)
    x = r.normal(size=(2, 6, 8, 5)).astype(np.float32)  # NHWC
    want = np.asarray(podtpu_reorg(jnp.asarray(x)))
    nchw = torch.from_numpy(x).permute(0, 3, 1, 2)  # channels_last strides
    assert nchw.is_contiguous(memory_format=torch.channels_last)
    got = passthrough_reorg(nchw)
    assert got.shape == (2, 20, 3, 4)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    # the reference's .view of a contiguous NCHW buffer
    ref = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().view(2, 20, 3, 4)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("model", ["yolov2", "yolov1"])
def test_weights_round_trip_every_key(model):
    cfg = family_cfg(model)
    flat = _flat(cfg)
    net = load_flat_weights(build_model(cfg, device="cpu"), flat)
    back = flat_from_state_dict(net)
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    sd = state_dict_from_flat(net, back)
    for k, v in net.state_dict().items():
        assert torch.equal(sd[k], v), k
    if model == "yolov1":
        # podtpu's Dense kernel [in, out] is fc.weight transposed
        np.testing.assert_array_equal(
            net.fc.weight.detach().numpy().T, flat["params::fc::kernel"])
        missing = dict(flat)
        del missing["params::fc::bias"]
        with pytest.raises(KeyError, match="missing"):
            load_flat_weights(build_model(cfg, device="cpu"), missing)


def test_seeded_dropout_masks_follow_the_seed():
    drop = SeededDropout(0.5).train()
    x = torch.ones(4, 256)
    drop.reseed(7)
    a = drop(x)
    drop.reseed(7)
    assert torch.equal(drop(x), a)
    drop.reseed(8)
    assert not torch.equal(drop(x), a)
    # flax's inverted dropout: kept values scaled by 1 / (1 - rate)
    assert set(a.unique().tolist()) == {0.0, 2.0}
    assert 0.4 < float((a == 0).float().mean()) < 0.6
    assert torch.equal(drop.eval()(x), x)
    assert torch.equal(SeededDropout(0.0).train()(x), x)


# ---- targets --------------------------------------------------------------

def _collisions():
    """A seeded batch crowded onto a few cells: same-cell GTs everywhere."""
    r = np.random.default_rng(21)
    t = -np.ones((3, 12, 5), np.float32)
    for b in range(3):
        n = int(r.integers(6, 13))
        cells = r.integers(0, 7, (n, 2)) % 3 + 2
        xy = (cells + r.uniform(0.05, 0.95, (n, 2))) / 7.0
        t[b, :n] = np.concatenate(
            [xy, r.uniform(0.05, 0.6, (n, 2)), r.integers(0, C, (n, 1))], -1)
    return t


def _first_gt_wins():
    t = -np.ones((1, 3, 5), np.float32)
    t[0, 0] = [0.5, 0.5, 0.2, 0.2, 4]
    t[0, 1] = [0.51, 0.51, 0.3, 0.3, 9]  # same cell: ignored
    return t


@pytest.mark.parametrize("case", ["first_gt_wins", "random", "collisions"])
def test_yolov1_targets_bit_identical(case):
    target = {"first_gt_wins": _first_gt_wins,
              "random": lambda: make_targets(4, 9, C, seed=5),
              "collisions": _collisions}[case]()
    got = encode_yolov1_targets(torch.from_numpy(target), C, 7)
    for backend in ("dense", "scan"):
        want = podtpu_encode_v1(jnp.asarray(target), C, 7, backend=backend)
        for name, g, w in zip(got._fields, got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"{name} ({backend})")
    if case == "first_gt_wins":
        assert got.tcls[0, 3, 3, 4] == 1.0 and got.tcls[0, 3, 3, 9] == 0.0
    if case == "collisions":
        valid = (target.sum(-1) > 0).sum()
        assert 0 < int(got.mask.sum()) < valid  # cells were shared


# ---- decoders -------------------------------------------------------------

def test_decode_yolov2_matches_podtpu():
    pred = (normal((2, 13, 13, 125), 31) * 2.0).astype(np.float32)
    want = np.asarray(podtpu_decode_yolov2(jnp.asarray(pred), C,
                                           VOC_SCALED_ANCHORS, 416))
    got = decode_yolov2(torch.from_numpy(pred), C,
                        torch.tensor(VOC_SCALED_ANCHORS), 416).numpy()
    assert got.shape == (2, 13 * 13 * 5, 6)
    np.testing.assert_array_equal(got[..., 5], want[..., 5])
    np.testing.assert_allclose(got[..., :5], want[..., :5], rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(make_decoder(family_cfg("yolov2", 416))(
        torch.from_numpy(pred)), torch.from_numpy(got))


def test_decode_yolov1_matches_podtpu_with_ties():
    pred = (normal((2, 7 * 7 * 30), 32) * 2.0).astype(np.float32)
    cells = pred.reshape(2, 7, 7, 30)
    # a tie of both boxes' confidence (box 0 must win) whose boxes differ
    cells[0, 1, 2, 20] = cells[0, 1, 2, 25] = 1.5
    cells[0, 1, 2, 21:25] = [0.1, 0.2, 0.3, 0.4]
    cells[0, 1, 2, 26:30] = [-0.4, -0.3, -0.2, -0.1]
    # saturated confidences and class scores: distinct logits, equal
    # sigmoids (1.0 in float32), so the first index wins in both
    cells[1, 4, 4, 20], cells[1, 4, 4, 25] = 20.0, 30.0
    cells[1, 4, 4, :20] = 0.0
    cells[1, 4, 4, 3], cells[1, 4, 4, 7] = 20.0, 30.0
    want = np.asarray(podtpu_decode_yolov1(jnp.asarray(pred), C, 2, 448))
    got = decode_yolov1(torch.from_numpy(pred), C, 2, 448).numpy()
    assert got.shape == (2, 49, 6)
    np.testing.assert_array_equal(got[..., 5], want[..., 5])
    np.testing.assert_allclose(got[..., :5], want[..., :5], rtol=1e-5,
                               atol=1e-5)
    tied, saturated = got[0, 1 * 7 + 2], got[1, 4 * 7 + 4]
    sig = lambda v: 1.0 / (1.0 + np.exp(-v))  # noqa: E731
    assert tied[0] == pytest.approx((sig(0.1) + 2) * 64.0, rel=1e-6)
    assert saturated[5] == 3.0 and saturated[4] == 1.0
    assert torch.equal(make_decoder(family_cfg("yolov1", 448))(
        torch.from_numpy(pred)), torch.from_numpy(got))


def test_yolov1_multi_label_raises_podtpus_error():
    with pytest.raises(ValueError, match="multi_label"):
        make_serve_fn(family_cfg("yolov1",
                                 nms_options={"multi_label": True}),
                      lambda x: x)


# ---- losses ---------------------------------------------------------------

def _v2_inputs():
    pred = nchw_to_nhwc(normal((4, 5 * (5 + C), 13, 13), 100))
    return np.ascontiguousarray(pred), make_targets(4, 8, C, 7)


def _v1_inputs():
    return normal((4, 7 * 7 * (2 * 5 + C)), 300), make_targets(4, 8, C, 13)


@pytest.mark.parametrize("model,golden", [("yolov2", 322.930908203125),
                                          ("yolov1", 123.91336822509766)])
def test_loss_value_and_gradient_match_podtpu(model, golden):
    """The golden scalars of tests/test_losses.py (the reference's torch
    losses on the same inputs), podtpu's value, and the gradient with
    respect to the raw head, which for YOLOv1 flows through the IoU that
    is the objectness target."""
    pred, target = _v2_inputs() if model == "yolov2" else _v1_inputs()
    if model == "yolov2":
        def jloss(p):
            return podtpu_yolov2_loss_v2(p, jnp.asarray(target), C,
                                         VOC_SCALED_ANCHORS)
    else:
        def jloss(p):
            return podtpu_yolov1_loss(p, jnp.asarray(target), C, 2)
    want, wgrad = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(pred))
    tp = torch.tensor(pred, requires_grad=True)
    got = build_loss(family_cfg(model, 416))(tp, torch.from_numpy(target))
    got.backward()
    got = float(got.detach())
    assert got == pytest.approx(golden, rel=1e-4)
    assert got == pytest.approx(float(want), rel=1e-5)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(wgrad), rtol=1e-4,
                               atol=1e-6)


# ---- the step and the serving graph ---------------------------------------

def _step_batch(cfg):
    r = np.random.default_rng(9)
    boxes = [np.asarray([[*r.uniform(0.2, 0.8, 2), *r.uniform(0.1, 0.6, 2),
                          r.integers(0, C)] for _ in range(5)], np.float32)
             for _ in range(2)]
    return image_batch(cfg, batch=2, seed=9), pad_annotations(boxes, 8)


def _jax_flat(jstate):
    out = {}
    for coll in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                getattr(jstate, coll))[0]:
            out[SEP.join([coll] + [str(p.key) for p in path])] = \
                np.asarray(leaf)
    return out


def _update(after, before):
    return np.concatenate([(after[k] - before[k]).ravel()
                           for k in sorted(before) if k.startswith("params")])


@pytest.mark.parametrize("model", ["yolov2", "yolov1"])
def test_train_step_matches_podtpu(no_dropout, model):
    """One update of each family's recipe (nesterov SGD, decay on every
    parameter) from podtpu's weights, held as tests/test_torch_train.py
    holds YOLOv3's first step: loss 1e-4, BN statistics 1e-4, the update
    within 5% of its norm and cosine 0.999."""
    cfg = family_cfg(model, 96 if model == "yolov1" else 64,
                     optimizer="sgd", scheduler=None, max_annots=8,
                     optimizer_options={"lr": 1e-3, "momentum": 0.9,
                                        "weight_decay": 5e-3,
                                        "nesterov": True})
    flat = _flat(cfg)
    img, annot = _step_batch(cfg)
    variables = flax_variables(flat)
    tx = podtpu_build_optimizer(cfg, variables["params"])
    jstate = PodtpuTrainState(
        step=0, apply_fn=podtpu_factory.build_model(cfg).apply,
        params=variables["params"], tx=tx,
        opt_state=tx.init(variables["params"]),
        batch_stats=variables["batch_stats"])
    jstate, m = podtpu_make_train_step(cfg)(
        jstate, {"img": jnp.asarray(img), "annot": jnp.asarray(annot)},
        jax.random.PRNGKey(1))
    want_loss, want = float(m["loss"]), _jax_flat(jstate)

    state = create_train_state(cfg, "cpu", weights=flat)
    state, m = make_train_step(cfg)(state, {"img": torch.from_numpy(img),
                                            "annot": torch.from_numpy(annot)})
    got_loss, got = float(m["loss"]), flat_from_state_dict(state.model)
    assert state.step == 1 and set(got) == set(want)
    assert got_loss == pytest.approx(want_loss, rel=1e-4)
    for k in want:
        if k.startswith("batch_stats"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5,
                                       err_msg=k)
    up_t, up_j = _update(got, flat), _update(want, flat)
    assert np.linalg.norm(up_t - up_j) <= 0.05 * np.linalg.norm(up_j)
    assert up_t @ up_j >= 0.999 * np.linalg.norm(up_t) * np.linalg.norm(up_j)


def test_dropout_follows_seed_and_step():
    """With dropout on, two fresh YOLOv1 states take the same first step;
    the mask of step 1 differs from step 0's."""
    cfg = family_cfg("yolov1", optimizer="sgd", scheduler=None,
                     max_annots=8, optimizer_options={"lr": 1e-3})
    img, annot = _step_batch(cfg)
    batch = {"img": torch.from_numpy(img), "annot": torch.from_numpy(annot)}
    step, flat = make_train_step(cfg), _flat(cfg)
    losses = []
    for _ in range(2):
        state = create_train_state(cfg, "cpu", weights=flat)
        assert state.model.dropout.rate == 0.5
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[0] == losses[1]
    drop = state.model.dropout
    x = torch.ones(1, 64)
    masks = []
    for s in (0, 1):
        drop.reseed(s)
        masks.append(drop(x))
    assert not torch.equal(*masks)


@pytest.mark.parametrize("model", ["yolov2", "yolov1"])
def test_serve_fn_matches_podtpu(model):
    cfg = family_cfg(model)
    flat = _flat(cfg)
    x = image_batch(cfg, batch=2, seed=3)
    jmodel = podtpu_factory.build_model(cfg)
    variables = flax_variables(flat)
    want = podtpu_make_serve_fn(
        cfg, lambda v: jmodel.apply(variables, v, train=False))(
            jnp.asarray(x, jnp.float32) / 255.0)
    net = load_flat_weights(build_model(cfg, device="cpu"), flat)
    got = make_serve_fn(cfg, net)(_as_input(torch.from_numpy(x)))
    assert got[0].shape == (2, 100, 6)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for g, w, v in zip(got[0].numpy(), np.asarray(want[0]), got[1].numpy()):
        assert v.sum() > 0
        np.testing.assert_array_equal(g[v, 5], w[v, 5])
        np.testing.assert_allclose(g[v, :4], w[v, :4], rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(g[v, 4], w[v, 4], atol=1e-5)
    # the HTTP server's engine on the same weights: the same detections
    engine = Engine(cfg, flat, device="cpu")
    rows = engine.predict_array(x[0])["detections"]
    assert len(rows) == int(got[1][0].sum())
    assert sorted(r["class_id"] for r in rows) == sorted(
        got[0][0, got[1][0], 5].int().tolist())


# ---- the per-family entry points on the CPU -------------------------------

@pytest.mark.parametrize("version", [1, 2])
def test_family_trains_and_scores_through_its_entry_points(
        version, synth, tmp_path, recording_writer, capsys):
    """``python -m podtpu_torch.cli.train_yolov{1,2}`` on a 64 px float32
    copy of the family's config (B=4, 2 epochs of 2 steps, validated each
    epoch) on synthetic files, then ``cli.test_yolov{1,2}`` on its
    ``best``: the same val_loss and val_mAP as ``fit`` recorded."""
    from importlib import import_module

    train_cli = import_module(f"podtpu_torch.cli.train_yolov{version}")
    test_cli = import_module(f"podtpu_torch.cli.test_yolov{version}")
    cfg = get_configs(os.path.join(REPO, "configs",
                                   f"yolov{version}_voc.yaml"))
    cfg.update(input_size=64, compute_dtype="float32", batch_size=4,
               workers=2, max_annots=8, epochs=2, save_freq=100,
               trainer_options={"check_val_every_n_epoch": 1},
               train_list=synth["train_list"], val_list=synth["val_list"],
               names=synth["names"], save_dir=str(tmp_path / "runs"))
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    try:
        trainer = train_cli.main(["--cfg", str(path), "--device", "cpu"])
        rows = trainer.history
        assert [r["epoch"] for r in rows] == [0, 1]
        assert all(np.isfinite(r["val_mAP"]) and 0.0 <= r["val_mAP"] <= 1.0
                   and np.isfinite(r["train_loss"]) for r in rows)
        best_row = min(rows, key=lambda r: r["val_loss"])
        best = os.path.join(trainer.run_dir, "checkpoints", "best")
        assert os.path.isdir(best)
        got = test_cli.main(["--cfg", str(path), "--ckpt", best,
                             "--device", "cpu"])
        assert got["val_loss"] == pytest.approx(best_row["val_loss"],
                                                rel=1e-6)
        assert got["val_mAP"] == best_row["val_mAP"]
        assert f"val_mAP: {got['val_mAP']:.5f}" in capsys.readouterr().out
    finally:
        shutil.rmtree(tmp_path / "runs", ignore_errors=True)
