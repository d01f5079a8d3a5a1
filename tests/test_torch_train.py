"""The port's training slice against podtpu (CPU): train-mode BN, targets,
boxes, loss, schedules, optimizer, and two whole train steps.

Inputs are numpy-seeded; weights are podtpu's flat layout carried into the
port by ``podtpu_torch.export.weights`` (tests/torch_parity.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from podtpu.data.loader import pad_annotations as podtpu_pad_annotations
from podtpu.export.weights import load_npz_weights as podtpu_load_npz
from podtpu.losses import build_loss as podtpu_build_loss
from podtpu.models.layers import BatchNormMixed as FlaxBatchNormMixed
from podtpu.ops import boxes as jboxes
from podtpu.ops.assign import encode_anchor_targets as podtpu_encode
from podtpu.train import schedule as jsched
from podtpu.train.optim import build_optimizer as podtpu_build_optimizer
from podtpu.train.state import create_train_state as podtpu_create_state
from podtpu.train.steps import make_train_step as podtpu_make_train_step
from podtpu_torch.data.loader import pad_annotations
from podtpu_torch.export.weights import flat_from_state_dict
from podtpu_torch.losses import build_loss
from podtpu_torch.models.layers import BatchNormMixed, ConvBnAct
from podtpu_torch.ops import boxes as tboxes
from podtpu_torch.ops.assign import encode_anchor_targets
from podtpu_torch.train import schedule as tsched
from podtpu_torch.train.optim import build_optimizer, decay_policy
from podtpu_torch.train.state import TrainState, create_train_state
from podtpu_torch.train.steps import make_train_step
from tests.helpers import VOC_ANCHORS, VOC_SCALED_ANCHORS, make_targets
from tests.test_assign import oracle_v2, oracle_v3_layer
from tests.torch_parity import (
    SEP,
    flax_variables,
    image_batch,
    podtpu_flat_weights,
    yolo_cfg,
)

C = 20


# ---- train-mode BatchNormMixed --------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_train_matches_podtpu(dtype):
    r = np.random.default_rng(0)
    x = (r.normal(size=(4, 6, 5, 16)) * 2.0 + 0.5).astype(np.float32)
    scale = r.uniform(0.5, 1.5, 16).astype(np.float32)
    bias = r.normal(0, 0.1, 16).astype(np.float32)
    ra_mean = r.normal(0, 0.1, 16).astype(np.float32)
    ra_var = r.uniform(0.5, 2.0, 16).astype(np.float32)
    variables = {"params": {"scale": jnp.asarray(scale),
                            "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(ra_mean),
                                 "var": jnp.asarray(ra_var)}}
    jx = jnp.asarray(x).astype(dtype)
    want, upd = FlaxBatchNormMixed(dtype=jnp.dtype(dtype)).apply(
        variables, jx, train=True, mutable=["batch_stats"])

    bn = BatchNormMixed(16, dtype=getattr(torch, dtype)).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(ra_mean))
        bn.running_var.copy_(torch.from_numpy(ra_var))
    got = bn(torch.from_numpy(x).to(getattr(torch, dtype)).permute(0, 3, 1, 2))
    got = got.detach().permute(0, 2, 3, 1).float().numpy()
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        # same bf16 input; mul/add fold in f32 (sums in another order) and
        # round to bf16: at most one bf16 ulp of the largest output
        assert np.abs(got - want).max() <= 2.0 ** -7 * np.abs(want).max()
    # running statistics: decay 0.9, Bessel-corrected batch variance
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-5, atol=1e-6)
    n = 4 * 6 * 5
    xb = torch.from_numpy(x).to(getattr(torch, dtype)).float().numpy()
    np.testing.assert_allclose(
        bn.running_var.numpy(),
        0.9 * ra_var + 0.1 * xb.var(axis=(0, 1, 2)) * n / (n - 1), rtol=1e-4)


def test_batchnorm_grads_flow_through_batch_stats():
    """The backward includes the batch-statistic terms: a per-channel
    constant shift of the input changes nothing downstream."""
    bn = BatchNormMixed(3).train()
    x = torch.randn(2, 3, 4, 4, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    bn(x).sum().backward()
    # d/dx of sum over a normalized channel is 0 (mean-subtraction term)
    assert x.grad.abs().max() < 1e-5


# ---- targets --------------------------------------------------------------

def _encode_both(target, *args, **kw):
    want = podtpu_encode(target, *args, backend="dense", **kw)
    got = encode_anchor_targets(torch.from_numpy(target), *args, **kw)
    return got, want


def _assert_bit_identical(got, want):
    for name, g, w in zip(got._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("case", ["random", "same_slot"])
def test_v2_targets_bit_identical(case):
    if case == "random":
        target = make_targets(6, 12, C, seed=3)
    else:  # two GTs on one (cell, anchor) slot: later box, both class bits
        target = -np.ones((1, 4, 5), np.float32)
        target[0, 0] = [0.5, 0.5, 0.30, 0.30, 2]
        target[0, 1] = [0.52, 0.52, 0.32, 0.32, 7]
    got, want = _encode_both(target, C, VOC_SCALED_ANCHORS, 13, 13, 0.5,
                             cls_accumulate=True)
    _assert_bit_identical(got, want)
    for g, o in zip(got, oracle_v2(target, C, VOC_SCALED_ANCHORS, 13, 13)):
        np.testing.assert_allclose(g.numpy(), o, atol=1e-5)


@pytest.mark.parametrize("accumulate", [True, False])
@pytest.mark.parametrize("layer_idx,hw", [(0, 52), (1, 26), (2, 13)])
def test_v3_targets_bit_identical(accumulate, layer_idx, hw):
    target = make_targets(5, 10, C, seed=4)
    scaled = np.asarray(VOC_ANCHORS, np.float32)[
        3 * layer_idx:3 * layer_idx + 3] * (hw / 416.0)
    got, want = _encode_both(
        target, C, scaled, hw, hw, 0.5, match_anchors=VOC_ANCHORS,
        layer_anchor_slice=(3 * layer_idx, 3 * layer_idx + 3),
        match_scale=(416.0, 416.0), cls_accumulate=accumulate)
    _assert_bit_identical(got, want)
    oracle = oracle_v3_layer(target, C, VOC_ANCHORS, 416, layer_idx, hw, hw,
                             cls_accumulate=accumulate)
    for g, o in zip(got, oracle):
        np.testing.assert_allclose(g.numpy(), o, atol=1e-5)


def test_v3_label_smoothing_bit_identical():
    target = make_targets(4, 16, C, seed=7)
    got, want = _encode_both(
        target, C, np.asarray(VOC_ANCHORS, np.float32)[6:9] * (13 / 416.0),
        13, 13, 0.5, match_anchors=VOC_ANCHORS, layer_anchor_slice=(6, 9),
        match_scale=(416.0, 416.0), cls_pos=0.995, cls_neg=0.005)
    _assert_bit_identical(got, want)
    assert (got.tcls.numpy() == np.float32(0.995)).any()


# ---- boxes ----------------------------------------------------------------

@pytest.mark.parametrize("kind", ["iou", "giou", "diou", "ciou"])
def test_bbox_iou_matches_podtpu(kind):
    r = np.random.default_rng(11)
    b1 = np.concatenate([r.uniform(0, 1, (64, 2)), r.uniform(0.1, 3, (64, 2))],
                        -1).astype(np.float32)
    b2 = np.concatenate([r.uniform(0, 1, (64, 2)), r.uniform(0.1, 3, (64, 2))],
                        -1).astype(np.float32)
    kw = {"giou": {"GIoU": True}, "diou": {"DIoU": True},
          "ciou": {"CIoU": True}}.get(kind, {})

    def jloss(a):
        return jnp.sum(jboxes.bbox_iou(a, jnp.asarray(b2), **kw))

    want = np.asarray(jboxes.bbox_iou(jnp.asarray(b1), jnp.asarray(b2), **kw))
    wgrad = np.asarray(jax.grad(jloss)(jnp.asarray(b1)))
    t1 = torch.tensor(b1, requires_grad=True)
    got = tboxes.bbox_iou(t1, torch.from_numpy(b2), **kw)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-6)
    # CIoU's alpha takes no gradient on either side
    np.testing.assert_allclose(t1.grad.numpy(), wgrad, rtol=1e-4, atol=1e-5)


def test_wh_iou_and_converters_match_podtpu():
    r = np.random.default_rng(12)
    wh1 = r.uniform(1, 50, (7, 2)).astype(np.float32)
    wh2 = np.asarray(VOC_ANCHORS, np.float32)
    np.testing.assert_array_equal(
        tboxes.wh_iou(torch.from_numpy(wh1), torch.from_numpy(wh2)).numpy(),
        np.asarray(jboxes.wh_iou(jnp.asarray(wh1), jnp.asarray(wh2))))
    xyxy = np.sort(r.uniform(0, 9, (5, 2, 2)), axis=1).transpose(0, 2, 1) \
        .reshape(5, 4)[:, [0, 2, 1, 3]].astype(np.float32)
    np.testing.assert_allclose(
        tboxes.xyxy_to_cxcywh(torch.from_numpy(xyxy)).numpy(),
        np.asarray(jboxes.xyxy_to_cxcywh(jnp.asarray(xyxy))), rtol=1e-6)


# ---- loss -----------------------------------------------------------------

def test_yolov3_loss_v2_value_and_head_gradients():
    cfg = yolo_cfg("float32", 128)
    r = np.random.default_rng(5)
    heads = [(r.normal(0, 1, (3, s, s, 75)) * 0.5).astype(np.float32)
             for s in (16, 8, 4)]
    annots = make_targets(3, 12, C, seed=6)
    jloss = podtpu_build_loss(cfg)
    want, wgrads = jax.value_and_grad(
        lambda hs: jloss(hs, jnp.asarray(annots)))([jnp.asarray(h) for h in heads])
    theads = [torch.tensor(h, requires_grad=True) for h in heads]
    got = build_loss(cfg)(theads, torch.from_numpy(annots))
    got.backward()
    # the same targets; float32 sums over ~10^5 terms in another order
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    for t, g in zip(theads, wgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-4,
                                   atol=1e-6)


# ---- schedules and optimizer ----------------------------------------------

@pytest.mark.parametrize("name,opts", [
    ("yolo_lr", {"burn_in": 3, "steps": [4, 6], "scales": [0.1, 0.5]}),
    ("multi_step", {"milestones": [2, 5], "gamma": 0.3}),
    ("cosine_annealing_warm_restarts", {"T_0": 3, "T_mult": 2}),
    ("cosine_annealing_warm_restarts", {"T_0": 3}),
    ("cosine_annealing_warm_up_restarts", {"T_0": 4, "T_mult": 2, "T_up": 1,
                                           "gamma": 0.5, "eta_max": 0.05}),
    (None, {}),
])
def test_schedules_match_podtpu(name, opts):
    cfg = {"optimizer_options": {"lr": 1e-3}, "scheduler": name,
           "scheduler_options": opts}
    want, got = jsched.build_schedule(cfg), tsched.build_schedule(cfg)
    for step in range(12):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-6,
                                          abs=1e-12), step


def _tiny_block():
    torch.manual_seed(0)
    return ConvBnAct(2, 3, 3)


@pytest.mark.parametrize("policy", [None, "all"])
def test_sgd_with_yolo_lr_matches_optax_over_five_steps(policy):
    """Five updates of nesterov SGD with coupled decay under ``yolo_lr``
    (burn_in 3: lr 0 at update 0, burn-in at 1-2, full lr at 3, decayed at
    4) against podtpu's optax chain on the same parameters and gradients."""
    opts = {"lr": 0.1, "momentum": 0.9, "nesterov": True,
            "weight_decay": 0.05}
    if policy:
        opts["decay_policy"] = policy
    cfg = {"model": "yolov3", "optimizer": "sgd", "optimizer_options": opts,
           "scheduler": "yolo_lr",
           "scheduler_options": {"burn_in": 3, "steps": [4], "scales": [0.1]}}
    block = _tiny_block()
    # the block's leaves under podtpu's names
    names = {"conv.weight": ("conv", "kernel"), "bn.weight": ("bn", "scale"),
             "bn.bias": ("bn", "bias")}
    to_j = {"conv.weight": lambda t: t.permute(2, 3, 1, 0)}
    params = {"conv": {}, "bn": {}}
    for n, p in block.named_parameters():
        a, leaf = names[n]
        params[a][leaf] = jnp.asarray(to_j.get(n, lambda t: t)(p.detach()).numpy())
    tx = podtpu_build_optimizer(cfg, params)
    opt_state = tx.init(params)
    state = TrainState(block, build_optimizer(cfg, block),
                       tsched.build_schedule(cfg))
    r = np.random.default_rng(1)
    for step in range(5):
        grads = {n: r.normal(size=p.shape).astype(np.float32)
                 for n, p in block.named_parameters()}
        jg = {"conv": {}, "bn": {}}
        for n, g in grads.items():
            a, leaf = names[n]
            jg[a][leaf] = jnp.asarray(
                to_j.get(n, lambda t: t)(torch.from_numpy(g)).numpy())
        upd, opt_state = tx.update(jg, opt_state, params)
        params = optax.apply_updates(params, upd)
        for n, p in block.named_parameters():
            p.grad = torch.from_numpy(grads[n])
        state.apply_gradients()
        for n, p in block.named_parameters():
            a, leaf = names[n]
            np.testing.assert_allclose(
                to_j.get(n, lambda t: t)(p.detach()).numpy(),
                np.asarray(params[a][leaf]), rtol=1e-6, atol=1e-6,
                err_msg=f"{n} after update {step}")
    assert state.step == 5


@pytest.mark.parametrize("model,policy", [("yolov3", "kernels"),
                                          ("yolov1", "all"),
                                          ("yolov2", "all")])
def test_decay_policy_family_defaults(model, policy):
    assert decay_policy({"model": model}) == policy


@pytest.mark.parametrize("opts", [{"optimizer": "adam"},
                                  {"optimizer": "radam"},
                                  {"optimizer_options": {"lr": 1, "flat": True}},
                                  {"optimizer_options": {"lr": 1,
                                                         "accum_steps": 2}},
                                  {"optimizer_options": {"lr": 1,
                                                         "skip_nonfinite": 3}}])
def test_unported_optimizer_options_raise(opts):
    cfg = {"model": "yolov3", "optimizer": "sgd",
           "optimizer_options": {"lr": 1}, **opts}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_optimizer(cfg, _tiny_block())


@pytest.mark.parametrize("extra", [{"device_augment": True},
                                   {"device_geom": True},
                                   {"remat_policy": "conv_out"},
                                   {"ema": True}])
def test_unported_train_step_options_raise(extra):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_train_step(yolo_cfg(**extra))


def test_pad_annotations_matches_podtpu():
    r = np.random.default_rng(3)
    boxes = [r.uniform(0, 1, (n, 5)).astype(np.float32) for n in (0, 3, 9)]
    np.testing.assert_array_equal(pad_annotations(boxes, 6),
                                  podtpu_pad_annotations(boxes, 6))


# ---- the whole slice: two train steps -------------------------------------

def _slice_cfg():
    return yolo_cfg("float32", 64, optimizer="sgd",
                    optimizer_options={"lr": 1e-3, "momentum": 0.9,
                                       "weight_decay": 1e-2, "nesterov": True},
                    scheduler=None, max_annots=8)


def _slice_batch(cfg):
    r = np.random.default_rng(9)
    boxes = []
    for _ in range(2):
        rows = [[*r.uniform(0.2, 0.8, 2), *r.uniform(0.1, 0.6, 2),
                 r.integers(0, C)] for _ in range(5)]
        boxes.append(np.asarray(rows, np.float32))
    return image_batch(cfg, batch=2, seed=9), pad_annotations(boxes, 8)


def _jax_flat(jstate):
    out = {}
    for coll in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                getattr(jstate, coll))[0]:
            out[SEP.join([coll] + [str(p.key) for p in path])] = \
                np.asarray(leaf)
    return out


@pytest.fixture(scope="module")
def trained():
    """podtpu's and the port's losses and flat states after each of two
    train steps from the same weights on the same batch (podtpu's step is
    jitted once here)."""
    cfg = _slice_cfg()
    flat = podtpu_flat_weights(cfg, seed=3)
    img, annot = _slice_batch(cfg)
    variables = flax_variables(flat)
    jstate = podtpu_create_state(cfg, jax.random.PRNGKey(0))
    jstate = jstate.replace(params=variables["params"],
                            batch_stats=variables["batch_stats"])
    jstep = podtpu_make_train_step(cfg)
    jbatch = {"img": jnp.asarray(img), "annot": jnp.asarray(annot)}
    state = create_train_state(cfg, "cpu", weights=flat)
    step = make_train_step(cfg)
    batch = {"img": torch.from_numpy(img), "annot": torch.from_numpy(annot)}
    want, got = [], []
    for _ in range(2):
        jstate, m = jstep(jstate, jbatch, jax.random.PRNGKey(1))
        want.append((float(m["loss"]), _jax_flat(jstate)))
        state, m = step(state, batch)
        got.append((float(m["loss"]), flat_from_state_dict(state.model)))
    return cfg, flat, want, got, state


def _update(after, before):
    return np.concatenate([(after[k] - before[k]).ravel()
                           for k in sorted(before) if k.startswith("params")])


def test_two_train_steps_match_podtpu(trained):
    """Two steps at 64 px, float32, constant lr 1e-3, from podtpu's weights.

    The first step's forward is well conditioned: its loss and the BN
    statistics it records match to the convs' float32 summation order.

    The update is less so, at these random weights: the loss gradient is
    dominated by the no-object term, nearly uniform over positions, which
    every train-mode BN removes (mean subtraction), leaving a residue that
    ReLU decisions within rounding distance of 0 flip: a float64-compute
    run of the port's same two steps lands as far from its float32 run as
    podtpu's float32 run does. So the first update (one gradient,
    measured 1.8% apart) is held to 5% of its norm and cosine 0.999, the
    two-step update (measured 12%) to 30% and cosine 0.95, the second loss
    (0.9%) to 5% and the final statistics (3.4%) to 15% of their scale;
    the parts are held tightly in the other tests of this file and in
    test_torch_stem.py."""
    cfg, flat, want, got, state = trained
    assert state.step == 2
    (jl1, jf1), (jl2, jf2) = want
    (tl1, tf1), (tl2, tf2) = got
    assert set(tf2) == set(jf2)
    assert tl1 == pytest.approx(jl1, rel=1e-4)
    for k in jf1:
        if k.startswith("batch_stats"):
            np.testing.assert_allclose(tf1[k], jf1[k], rtol=1e-4, atol=1e-5,
                                       err_msg=k)
    up_t, up_j = _update(tf1, flat), _update(jf1, flat)
    assert np.linalg.norm(up_t - up_j) <= 0.05 * np.linalg.norm(up_j)
    assert up_t @ up_j >= 0.999 * np.linalg.norm(up_t) * np.linalg.norm(up_j)
    assert tl2 == pytest.approx(jl2, rel=5e-2)
    assert tl2 < tl1 and jl2 < jl1
    up_t, up_j = _update(tf2, flat), _update(jf2, flat)
    assert np.linalg.norm(up_t - up_j) <= 0.3 * np.linalg.norm(up_j)
    assert up_t @ up_j >= 0.95 * np.linalg.norm(up_t) * np.linalg.norm(up_j)
    for k in jf2:
        if k.startswith("batch_stats"):
            scale = np.abs(jf2[k]).max()
            assert np.abs(tf2[k] - jf2[k]).max() <= 0.15 * scale, k


def test_trained_weights_round_trip_through_podtpu_npz(trained, tmp_path):
    """state_dict -> podtpu's flat .npz -> podtpu's loader: every leaf
    arrives unchanged."""
    cfg, _, _, _, state = trained
    flat = flat_from_state_dict(state.model)
    path = tmp_path / "w.npz"
    np.savez(path, **flat)
    jstate = podtpu_create_state(cfg, jax.random.PRNGKey(0))
    jstate = podtpu_load_npz(jstate, str(path))
    for coll in ("params", "batch_stats"):
        for p, leaf in jax.tree_util.tree_flatten_with_path(
                getattr(jstate, coll))[0]:
            key = SEP.join([coll] + [str(q.key) for q in p])
            np.testing.assert_array_equal(np.asarray(leaf), flat[key],
                                          err_msg=key)
