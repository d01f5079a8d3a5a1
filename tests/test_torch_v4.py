"""The port's YOLOv4-tiny and YOLOv4 families against podtpu (CPU): the
layers they add (``ConvBnAct``'s activations, ``V4TinyBlock``, SPP's
same-padded pools), both models in eval and train mode with their weight
carry-over, the loss and decoder they share with YOLOv3, the K-step train
group (``make_multi_train_step``) against K single steps, ``Trainer.fit``
with ``steps_per_dispatch`` against podtpu's, the per-family CLIs against
the root scripts, and every shipped config of the two families.

Inputs are numpy-seeded; weights are podtpu's flat layout carried into the
port by ``podtpu_torch.export.weights`` (tests/torch_parity.py); float32
at 64 px. Each podtpu model is built and applied once per module.
"""

import os
import runpy
import shutil
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from podtpu.data import Loader as JLoader
from podtpu.data import build_datasets as podtpu_build_datasets
from podtpu.losses import build_loss as podtpu_build_loss
from podtpu.models import factory as podtpu_factory
from podtpu.models import layers as jlayers
from podtpu.models import yolov4 as jyolov4
from podtpu.train.steps import make_decoder as podtpu_make_decoder
from podtpu.train.steps import make_serve_fn as podtpu_make_serve_fn
from podtpu.train.trainer import Trainer as JTrainer
from podtpu_torch.config import get_configs
from podtpu_torch.data.synthetic import generate
from podtpu_torch.export.weights import (
    flat_from_state_dict,
    load_flat_weights,
    state_dict_from_flat,
)
from podtpu_torch.losses import build_loss
from podtpu_torch.models.factory import build_model
from podtpu_torch.models.layers import ConvBnAct, V4TinyBlock, leaky01, mish
from podtpu_torch.models.yolov4 import _maxpool_same
from podtpu_torch.serve import Engine
from podtpu_torch.train.run import make_loaders
from podtpu_torch.train.state import create_train_state
from podtpu_torch.train.steps import (
    _as_input,
    make_decoder,
    make_multi_train_step,
    make_serve_fn,
    make_train_step,
)
from podtpu_torch.train.trainer import Trainer, put_group
from tests.helpers import make_targets, normal
from tests.torch_parity import (  # noqa: F401  (fixtures)
    SEP,
    cached_podtpu_states,
    flax_variables,
    image_batch,
    module_flat_weights,
    podtpu_flat_weights,
    recording_writer,
    yolo_cfg,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C = 20
MODELS = ("yolov4-tiny", "yolov4")
quiet = lambda *_: None  # noqa: E731


def _anchors(model):
    name = "yolov4-tiny_voc" if model == "yolov4-tiny" else "yolov4_voc"
    return get_configs(os.path.join(REPO, "configs", f"{name}.yaml"))["anchors"]


def family_cfg(model: str, size: int = 64, **extra) -> dict:
    return yolo_cfg("float32", size, model=model, anchors=_anchors(model),
                    **extra)


# ---- layers ---------------------------------------------------------------

def _stats_flat(batch_stats) -> dict:
    """A flax ``batch_stats`` tree as flat ``batch_stats::...`` keys."""
    return {SEP.join(["batch_stats"] + [str(p.key) for p in path]):
            np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(batch_stats)[0]}


def _layer_parity(jmodule, tmodule, x, train):
    """(port out, podtpu out, port running stats, podtpu running stats) of
    one forward from the same seeded weights; x is NHWC."""
    flat = module_flat_weights(jmodule, jnp.asarray(x), seed=4)
    out = jmodule.apply(flax_variables(flat), jnp.asarray(x), train=train,
                        mutable=["batch_stats"] if train else False)
    want, jstats = (out[0], out[1]["batch_stats"]) if train else (out, {})
    load_flat_weights(tmodule, flat).train(train)
    with torch.no_grad():
        got = tmodule(torch.from_numpy(x).permute(0, 3, 1, 2))
    jflat = _stats_flat(jstats)
    tflat = {k: v for k, v in flat_from_state_dict(tmodule).items()
             if train and k.startswith("batch_stats")}
    return (got.permute(0, 2, 3, 1).numpy(), np.asarray(want), tflat, jflat)


_ACTS = {"relu": (jax.nn.relu, torch.relu), "mish": (jyolov4.mish, mish),
         "leaky01": (jyolov4.leaky01, leaky01), "linear": (None, None)}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("act", list(_ACTS))
def test_conv_bn_act_matches_podtpu(act, train):
    """A stride-2 3x3 ConvBnAct with each activation: float32 rounding of
    a 72-term conv and the BN multiply-add (batch statistics over 128
    values a channel in train mode, then moved into the running ones)."""
    jact, tact = _ACTS[act]
    x = normal((2, 16, 16, 8), 11)
    got, want, tstats, jstats = _layer_parity(
        jlayers.ConvBnAct(16, 3, strides=2, act=jact),
        ConvBnAct(8, 16, 3, strides=2, act=tact), x, train)
    assert got.shape == want.shape == (2, 8, 8, 16)
    if act == "relu":
        assert (got == 0).any() and (got > 0).any()
    elif act != "linear":
        assert (got < 0).any()  # mish and leaky pass negatives
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert set(tstats) == set(jstats) == (
        {"batch_stats::bn::mean", "batch_stats::bn::var"} if train else set())
    for k in jstats:
        np.testing.assert_allclose(tstats[k], jstats[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_v4_tiny_block_matches_podtpu(train):
    """V4TinyBlock: the concat is [conv2 out, conv1 out]."""
    x = normal((2, 8, 8, 12), 12)
    got, want, tstats, jstats = _layer_parity(
        jlayers.V4TinyBlock(6), V4TinyBlock(12, 6), x, train)
    assert got.shape == want.shape == (2, 8, 8, 12)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert set(tstats) == set(jstats)
    for k in jstats:
        np.testing.assert_allclose(tstats[k], jstats[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("size", [2, 5])
def test_spp_pools_pad_with_minus_infinity(size):
    """Stride-1 k x k pools with symmetric pad k // 2 at maps smaller than
    the window, on all-negative inputs: a zero pad would show."""
    x = -np.abs(normal((2, size, size, 3), 13)) - 1.0
    for k in (5, 9, 13):
        want = np.asarray(jyolov4._maxpool_same(jnp.asarray(x), k))
        got = _maxpool_same(torch.from_numpy(x).permute(0, 3, 1, 2), k)
        got = got.permute(0, 2, 3, 1).numpy()
        assert got.shape == x.shape
        np.testing.assert_array_equal(got, want)
        assert (got < 0).all()


# ---- the models -----------------------------------------------------------

_FLAT: dict = {}
_HEADS: dict = {}


def _flat(model):
    if model not in _FLAT:
        _FLAT[model] = podtpu_flat_weights(family_cfg(model), seed=0)
    return _FLAT[model]


_APPLY: dict = {}


def _podtpu_apply(model, x, train):
    """podtpu's forward, jitted once per (model, mode): a third of the
    op-by-op time on the CPU."""
    if (model, train) not in _APPLY:
        net = podtpu_factory.build_model(family_cfg(model))
        _APPLY[model, train] = jax.jit(lambda v, x: net.apply(
            v, x, train=train, mutable=["batch_stats"] if train else False))
    out = _APPLY[model, train](flax_variables(_flat(model)), jnp.asarray(x))
    return out if train else (out, None)


def _eval_heads(model):
    """podtpu's eval-mode heads on image_batch(seed=0), once per model."""
    if model not in _HEADS:
        x = image_batch(family_cfg(model), batch=2).astype(np.float32) / 255.0
        _HEADS[model] = [np.asarray(h) for h in
                         _podtpu_apply(model, x, train=False)[0]]
    return _HEADS[model]


@pytest.mark.parametrize("model", MODELS)
def test_eval_forward_matches_podtpu(model):
    """Eval-mode heads at 64 px: float32 rounding through the depth, so
    held to 1e-5 of the head's largest value (YOLOv4's heads reach ~2e3 at
    He-normal random weights through its residual chains; measured: 3.5e-6
    of it) and rtol 1e-4."""
    cfg = family_cfg(model)
    x = image_batch(cfg, batch=2).astype(np.float32) / 255.0
    want = _eval_heads(model)
    net = load_flat_weights(build_model(cfg, device="cpu"), _flat(model))
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want] == [
        (2, s, s, 75) for s in (8, 4, 2)]
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * max(1.0, float(np.abs(w).max())))


@pytest.mark.parametrize("model", MODELS)
def test_train_forward_matches_podtpu(model):
    """Train-mode heads and the BN running statistics after one forward.
    Both packages take the batch variance as E[x^2] - mean^2 in float32,
    which cancels where a channel's mean is many times its spread (p5 and
    the SPP see 2x2 maps at 64 px); a 1e-7 relative perturbation of the
    input moves podtpu's own heads by up to 4e-5 (YOLOv4-tiny) and 7e-3
    (YOLOv4). The heads are held to rtol 1e-4 / atol 1e-5 beyond 8x that
    witness, taken in the test (measured: the port is 4.0-4.3x it away);
    the running statistics, one EWMA step from the same start, to rtol
    1e-4 / atol 1e-4 beyond 8x their own witness under the same
    perturbation (measured: 2.4-3.4x)."""
    cfg = family_cfg(model)
    x = image_batch(cfg, batch=2).astype(np.float32) / 255.0
    want, jvars = _podtpu_apply(model, x, train=True)
    nudge = np.random.default_rng(1).standard_normal(x.shape) * 1e-7
    nudged, nvars = _podtpu_apply(
        model, (x * (1 + nudge)).astype(np.float32), train=True)
    witness = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                  for a, b in zip(nudged, want))
    net = load_flat_weights(build_model(cfg, device="cpu", train=True),
                            _flat(model))
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5 + 8.0 * witness)
    jstats, nstats = (_stats_flat(v["batch_stats"]) for v in (jvars, nvars))
    stats_witness = max(float(np.abs(nstats[k] - v).max())
                        for k, v in jstats.items())
    tstats = {k: v for k, v in flat_from_state_dict(net).items()
              if k.startswith("batch_stats")}
    assert set(tstats) == set(jstats)
    moved = 0
    for k in jstats:
        np.testing.assert_allclose(tstats[k], jstats[k], rtol=1e-4,
                                   atol=1e-4 + 8.0 * stats_witness,
                                   err_msg=k)
        moved += not np.array_equal(tstats[k], _flat(model)[k])
    assert moved == len(jstats)


@pytest.mark.parametrize("model,keys", [
    ("yolov4-tiny", ["params::tiny_block2::conv3::conv::kernel",
                     "params::stem::conv::kernel",
                     "batch_stats::b5_route::bn::var"]),
    ("yolov4", ["params::backbone::stage3::res5::c1::conv::kernel",
                "params::backbone::stage1::split_route::bn::scale",
                "params::td_block4::c3::conv::kernel",
                "batch_stats::bu_down3::bn::mean",
                "params::p5_pred::conv::kernel"]),
])
def test_weights_round_trip_every_key(model, keys):
    """podtpu's flat tree loads with every key mapped and none left over,
    by path (no family-specific rule), and comes back bit for bit."""
    flat = _flat(model)
    assert set(keys) <= set(flat)
    net = load_flat_weights(build_model(family_cfg(model), device="cpu"),
                            flat)
    back = flat_from_state_dict(net)
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    sd = state_dict_from_flat(net, back)
    for k, v in net.state_dict().items():
        assert torch.equal(sd[k], v), k
    missing = dict(flat)
    del missing[keys[0]]
    with pytest.raises(KeyError, match="missing"):
        load_flat_weights(build_model(family_cfg(model), device="cpu"),
                          missing)


# ---- loss and decoder -----------------------------------------------------

def _heads_416(seed):
    return [(normal((2, s, s, 75), seed + i) * 1.5).astype(np.float32)
            for i, s in enumerate((52, 26, 13))]


@pytest.mark.parametrize("model", MODELS)
def test_loss_value_and_gradient_match_podtpu(model):
    """``build_loss`` (yolov3_loss_v2 with the family's anchors) on 416 px
    heads: the value and the gradient with respect to each head, as
    tests/test_torch_train.py holds YOLOv3's (float32 sums over ~10^4
    terms in another order)."""
    cfg = family_cfg(model, 416)
    heads = _heads_416(40)
    annots = make_targets(2, 12, C, seed=41)
    jloss = podtpu_build_loss(cfg)
    want, wgrads = jax.jit(jax.value_and_grad(
        lambda hs: jloss(hs, jnp.asarray(annots))))(
            [jnp.asarray(h) for h in heads])
    theads = [torch.tensor(h, requires_grad=True) for h in heads]
    got = build_loss(cfg)(theads, torch.from_numpy(annots))
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    for t, g in zip(theads, wgrads):
        assert float(t.grad.abs().max()) > 0
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("model", MODELS)
def test_decoder_matches_podtpu(model):
    """``make_decoder`` decodes both families as YOLOv3 with their own
    anchors: classes exactly, boxes and scores to float32 rounding."""
    cfg = family_cfg(model, 416)
    heads = _heads_416(50)
    want = np.asarray(podtpu_make_decoder(cfg)([jnp.asarray(h)
                                                for h in heads]))
    got = make_decoder(cfg)([torch.from_numpy(h) for h in heads]).numpy()
    assert got.shape == want.shape == (2, 3 * (52 ** 2 + 26 ** 2 + 13 ** 2), 6)
    np.testing.assert_array_equal(got[..., 5], want[..., 5])
    np.testing.assert_allclose(got[..., :5], want[..., :5], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("model", MODELS)
def test_serve_fn_and_engine_match_podtpu(model):
    """The serving graph on podtpu's own heads for the same images (its
    forward is held by test_eval_forward_matches_podtpu), and the HTTP
    server's engine on the same weights. The detections carry the heads'
    difference ``dh``: w and h are exp(t) * anchor (relative error dh),
    the centres (sigmoid + cell) * stride (at most 8 * dh at stride 32),
    the scores a product of two sigmoids (dh / 2)."""
    cfg = family_cfg(model)
    x = image_batch(cfg, batch=2)
    heads = _eval_heads(model)
    want = podtpu_make_serve_fn(cfg, lambda v: [jnp.asarray(h)
                                                for h in heads])(None)
    net = load_flat_weights(build_model(cfg, device="cpu"), _flat(model))
    xt = _as_input(torch.from_numpy(x))
    with torch.no_grad():
        dh = max(float(np.abs(t.numpy() - h).max())
                 for t, h in zip(net(xt), heads))
    got = make_serve_fn(cfg, net)(xt)
    assert got[0].shape == (2, 100, 6)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for g, w, v in zip(got[0].numpy(), np.asarray(want[0]), got[1].numpy()):
        assert v.sum() > 0
        np.testing.assert_array_equal(g[v, 5], w[v, 5])
        np.testing.assert_allclose(g[v, :4], w[v, :4], rtol=1e-4 + 2 * dh,
                                   atol=1e-3 + 8 * dh)
        np.testing.assert_allclose(g[v, 4], w[v, 4], atol=1e-5 + dh / 2)
    engine = Engine(cfg, _flat(model), device="cpu")
    rows = engine.predict_array(x[0])["detections"]
    assert sorted(r["class_id"] for r in rows) == sorted(
        got[0][0, got[1][0], 5].int().tolist())


# ---- the K-step train group -----------------------------------------------

def _step_cfg():
    """configs/yolov4-tiny_voc.yaml's recipe at 64 px with a burn-in of 4
    updates, so that every step of the group runs at its own lr."""
    cfg = get_configs(os.path.join(REPO, "configs", "yolov4-tiny_voc.yaml"))
    cfg.update(input_size=64, compute_dtype="float32", max_annots=8,
               scheduler_options={"burn_in": 4, "steps": [40000],
                                  "scales": [0.1]},
               optimizer_options=dict(cfg["optimizer_options"], lr=1e-2))
    return cfg


def _state_tensors(state):
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            {k: v["momentum_buffer"].clone()
             for k, v in state.optimizer.state_dict()["state"].items()})


def test_multi_train_step_equals_sequential_steps():
    """K=3 steps in one group against 3 single train steps from the same
    state on the same batches: parameters, BN statistics, momentum, the
    step and each loss bit for bit, with each update at its own lr."""
    cfg = _step_cfg()
    k = 3
    assert cfg["steps_per_dispatch"] == 8  # the recipe's own group
    flat = podtpu_flat_weights(cfg, seed=2)
    r = np.random.default_rng(7)
    img = r.integers(0, 256, (k, 2, 64, 64, 3), dtype=np.uint8)
    annot = np.stack([make_targets(2, 8, C, seed=30 + i) for i in range(k)])
    singles = create_train_state(cfg, "cpu", weights=flat)
    step = make_train_step(cfg)
    losses, lrs = [], []
    for i in range(k):
        singles, m = step(singles, {"img": torch.from_numpy(img[i]),
                                    "annot": torch.from_numpy(annot[i])})
        losses.append(m["loss"])
        lrs.append(singles.optimizer.param_groups[0]["lr"])
    group = create_train_state(cfg, "cpu", weights=flat)
    group, m = make_multi_train_step(cfg)(
        group, {"img": torch.from_numpy(img),
                "annot": torch.from_numpy(annot)})
    assert m["loss"].shape == (k,) and not m["loss"].requires_grad
    assert torch.equal(m["loss"], torch.stack(losses))
    assert group.step == singles.step == k
    assert len(set(lrs)) == k  # the burn-in: a new lr every update
    assert group.optimizer.param_groups[0]["lr"] == lrs[-1]
    (g_sd, g_mom), (s_sd, s_mom) = _state_tensors(group), _state_tensors(
        singles)
    assert set(g_sd) == set(s_sd) and set(g_mom) == set(s_mom)
    for key in s_sd:
        assert torch.equal(g_sd[key], s_sd[key]), key
    for key in s_mom:
        assert torch.equal(g_mom[key], s_mom[key]), key
    assert not torch.equal(g_sd["stem.conv.weight"],
                           torch.from_numpy(flat["params::stem::conv::kernel"])
                           .permute(3, 2, 0, 1))


# ---- Trainer.fit with steps_per_dispatch ----------------------------------

@pytest.fixture(scope="module")
def spd_synth(tmp_path_factory):
    """10 train and 4 val synthetic JPEGs: at B=2 an epoch of 5 steps, two
    groups of 2 and a ragged step, and 2 val batches."""
    out = tmp_path_factory.mktemp("spd_synth")
    return generate(str(out), n_train=10, n_val=4, size=80, num_classes=20,
                    max_objects=3, seed=3)


def _fit_cfg(synth, save_dir):
    cfg = get_configs(os.path.join(REPO, "configs", "yolov4-tiny_voc.yaml"))
    cfg.update(input_size=64, compute_dtype="float32", batch_size=2,
               workers=2, max_annots=8, epochs=1, save_freq=100,
               steps_per_dispatch=2,
               trainer_options={"check_val_every_n_epoch": 1},
               train_list=synth["train_list"], val_list=synth["val_list"],
               names=synth["names"], save_dir=str(save_dir))
    return cfg


def _record_losses(owner, names, out):
    """Wrap ``owner``'s step callables so that each step's loss lands in
    ``out`` in the order run (a group's K losses as K entries)."""
    for name in names:
        fn = getattr(owner, name)

        def wrapped(*args, _fn=fn, _name=name):
            state, m = _fn(*args)
            out.extend((_name, float(v)) for v in
                       np.asarray(m["loss"]).reshape(-1))
            return state, m

        setattr(owner, name, wrapped)


@pytest.fixture(scope="module")
def podtpu_spd_fit(spd_synth, tmp_path_factory, cached_podtpu_states):
    runs = tmp_path_factory.mktemp("podtpu_spd")
    cfg = _fit_cfg(spd_synth, runs)
    flat = podtpu_flat_weights(cfg, seed=5)
    trainer = JTrainer(cfg, log=quiet, use_mesh=False)
    trainer._writer = types.SimpleNamespace(add_scalar=lambda *a: None,
                                            flush=lambda: None)
    variables = flax_variables(flat)
    trainer.state = trainer.state.replace(
        params=variables["params"], batch_stats=variables["batch_stats"])
    train_ds, val_ds = podtpu_build_datasets(cfg)
    train_l = JLoader(train_ds, batch_size=2, shuffle=True, max_annots=8,
                      workers=2, seed=cfg["seed"])
    val_l = JLoader(val_ds, batch_size=2, shuffle=False, max_annots=8,
                    workers=2)
    steps = []
    _record_losses(trainer, ("multi_step", "train_step"), steps)
    history = trainer.fit(train_l, val_l, epochs=1)
    yield cfg, flat, history, steps
    shutil.rmtree(runs, ignore_errors=True)


def test_fit_with_steps_per_dispatch_matches_podtpu(podtpu_spd_fit,
                                                    tmp_path,
                                                    recording_writer):
    """One epoch of 5 steps with ``steps_per_dispatch: 2`` (two groups,
    then the ragged fifth step through the single step), against podtpu's
    fit from the same weights on the same files: the same steps in the
    same programs, each loss, the epoch's row and the val metrics to the
    limits of tests/test_torch_trainer.py (train and val loss 1e-4
    relative, val_mAP 1e-6; step and lr exactly)."""
    cfg, flat, j_hist, j_steps = podtpu_spd_fit
    trainer = Trainer(dict(cfg, save_dir=str(tmp_path)), device="cpu",
                      log=quiet)
    load_flat_weights(trainer.state.model, flat)
    steps = []
    _record_losses(trainer, ("multi_step", "train_step"), steps)
    train_loader, val_loader = make_loaders(trainer.cfg)
    assert len(train_loader) == 5
    hist = trainer.fit(train_loader, val_loader, epochs=1)
    kinds = ["multi_step"] * 4 + ["train_step"]
    assert [s[0] for s in steps] == [s[0] for s in j_steps] == kinds
    for (_, got), (_, want) in zip(steps, j_steps):
        assert got == pytest.approx(want, rel=1e-4)
    (got,), (want,) = hist, j_hist
    assert got["step"] == want["step"] == 5 == trainer.state.step
    assert got["lr"] == want["lr"]
    assert got["train_loss"] == pytest.approx(want["train_loss"], rel=1e-4)
    assert got["val_loss"] == pytest.approx(want["val_loss"], rel=1e-4)
    assert got["val_mAP"] == pytest.approx(want["val_mAP"], abs=1e-6)
    assert ("train_loss", got["train_loss"], 5) in recording_writer[0].scalars


def test_put_group_stacks_host_batches():
    r = np.random.default_rng(0)
    batches = [{"img": r.integers(0, 256, (2, 4, 4, 3), dtype=np.uint8),
                "annot": r.normal(size=(2, 3, 5)).astype(np.float32)}
               for _ in range(3)]
    out = put_group(batches, torch.device("cpu"))
    for k in ("img", "annot"):
        assert out[k].dtype == torch.from_numpy(batches[0][k]).dtype
        np.testing.assert_array_equal(out[k].numpy(),
                                      np.stack([b[k] for b in batches]))


# ---- the per-family CLIs --------------------------------------------------

# wrapper -> (the root script's callee module and name, extra argv, the
# callee's positional arguments after cfg)
_WRAPPERS = {
    "train": ("train", "train", ["--resume", "r", "--epochs", "3"], None),
    "test": ("test", "evaluate", ["--ckpt", "c"], None),
    "inference": ("inference", "inference",
                  ["--ckpt", "c", "--out", "o", "--show", "--limit", "2"],
                  None),
    "make_video": ("make_video", "run",
                   ["--ckpt", "c", "--input", "i.mp4", "--output", "o.mp4"],
                   ["--input", "i.mp4", "--output", "o.mp4"]),
}


def _record_call(calls):
    def callee(*args, **kwargs):
        calls.append((args, kwargs))
    return callee


@pytest.mark.parametrize("name", list(_WRAPPERS))
def test_v4_tiny_cli_parses_as_the_root_script(name, monkeypatch):
    """``python -m podtpu_torch.cli.<name>_yolov4_tiny`` against the root
    ``<name>_yolov4-tiny.py`` loaded by path, with what each calls
    recorded: the same config by default and the same arguments, plus
    ``device='cuda'`` unless ``--device`` says otherwise."""
    import importlib

    import podtpu.config

    mod_name, fn, full, required = _WRAPPERS[name]
    port = importlib.import_module(f"podtpu_torch.cli.{name}_yolov4_tiny")
    root_calls, port_calls = [], []
    monkeypatch.setitem(sys.modules, mod_name, types.SimpleNamespace(
        **{fn: _record_call(root_calls)}))
    monkeypatch.setattr(podtpu.config, "get_configs", lambda p: p)
    monkeypatch.setattr(podtpu.config, "setup_platform", lambda p: None)
    monkeypatch.setattr(port, fn, _record_call(port_calls))
    monkeypatch.setattr(port, "get_configs", lambda p: p)
    script = os.path.join(REPO, f"{name}_yolov4-tiny.py")
    for argv in (required or [], full):
        monkeypatch.setattr(sys, "argv", [script] + argv)
        runpy.run_path(script, run_name="__main__")
        port.main(argv)
    port.main(full + ["--device", "cpu"])
    assert len(root_calls) == 2 and len(port_calls) == 3
    for (r_args, r_kw), (p_args, p_kw) in zip(root_calls, port_calls):
        assert p_args == r_args
        assert p_kw == dict(r_kw, device="cuda")
    assert root_calls[0][0][0] == "configs/yolov4-tiny_voc.yaml"
    assert port_calls[2][1]["device"] == "cpu"


# ---- the shipped configs --------------------------------------------------

_SHIPPED = sorted(f for f in os.listdir(os.path.join(REPO, "configs"))
                  if f.startswith("yolov4"))


@pytest.mark.parametrize("name", _SHIPPED)
def test_shipped_configs_build_a_trainer(name, tmp_path):
    """Every shipped config of the two families builds a ``Trainer`` (full
    width, nothing run), with the K-step group where the config sets
    ``steps_per_dispatch`` (yolov4_synth.yaml with its ``device_augment``
    too)."""
    cfg = get_configs(os.path.join(REPO, "configs", name))
    trainer = Trainer(cfg, device="cpu", log=quiet, run_dir=str(tmp_path))
    spd = int(cfg.get("steps_per_dispatch") or 1)
    assert trainer._spd == spd
    assert (trainer.multi_step is not None) == (spd > 1)
    assert Trainer(cfg, device="cpu", log=quiet,
                   eval_only=True).multi_step is None
