"""The port's RetinaNet (ResNet-50 + FPN, dense anchor assignment, focal
loss, decoder) and the ``clip_grad_norm`` option against podtpu (CPU).

Inputs are numpy-seeded; weights are podtpu's flat layout carried into the
port by ``podtpu_torch.export.weights`` (tests/torch_parity.py), made from
``jax.eval_shape`` of podtpu's model (no init); float32 at 64 px unless a
case says otherwise. Each podtpu model, and its train step, is built and
jitted once for the module.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from podtpu.losses import focal_loss as podtpu_focal_loss
from podtpu.models import factory as podtpu_factory
from podtpu.ops import retina as jretina
from podtpu.train.optim import build_optimizer as podtpu_build_optimizer
from podtpu.train.state import TrainState as PodtpuTrainState
from podtpu.train.steps import make_decoder as podtpu_make_decoder
from podtpu.train.steps import make_serve_fn as podtpu_make_serve_fn
from podtpu.train.steps import make_train_step as podtpu_make_train_step
from podtpu_torch.cli import test as test_cli
from podtpu_torch.config import get_configs
from podtpu_torch.data.loader import pad_annotations
from podtpu_torch.export.weights import (
    _leaf,
    conv_paths,
    flat_from_state_dict,
    flat_key,
    load_flat_weights,
    state_dict_from_flat,
)
from podtpu_torch.losses import build_loss
from podtpu_torch.losses.focal import focal_loss
from podtpu_torch.models.factory import build_model
from podtpu_torch.models.layers import ConvBnAct
from podtpu_torch.models.resnet import resnet50
from podtpu_torch.models.retinanet import PRIOR_PI, RetinaNet
from podtpu_torch.ops import retina
from podtpu_torch.serve import Engine
from podtpu_torch.train.optim import build_optimizer, clip_by_global_norm_
from podtpu_torch.train.run import make_loaders
from podtpu_torch.train.schedule import build_schedule
from podtpu_torch.train.state import TrainState, create_train_state
from podtpu_torch.train.steps import (
    _as_input,
    make_decoder,
    make_serve_fn,
    make_train_step,
)
from podtpu_torch.train.trainer import Trainer
from tests.helpers import VOC_ANCHORS, VOC_SCALED_ANCHORS, make_targets, normal
from tests.torch_parity import (  # noqa: F401  (fixtures)
    SEP,
    flax_variables,
    image_batch,
    module_flat_weights,
    recording_writer,
    synth,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "retinanet_voc.yaml")
C = 20
quiet = lambda *_: None  # noqa: E731


@pytest.fixture(scope="module", autouse=True)
def warm_cpu_math():
    """Call each transcendental op once on a large tensor before the
    comparisons. The CPU build of torch these tests run on can return one
    thread's chunk of the first multithreaded call of such an op in a
    process up to 4e-5 off (``torch.log`` on [3, 49,104, 2]: ~1 fresh
    process in 10-30 under load; the second call is exact); later calls
    agree with float64 to an ulp. Not the port's arithmetic: the same
    ``torch.log`` call on the same array differs between processes."""
    x = torch.rand(1 << 20) + 0.5
    for op in (torch.log, torch.log1p, torch.exp, torch.sigmoid,
               torch.rsqrt):
        op(x)


def retina_cfg(size: int = 64, **extra) -> dict:
    """configs/retinanet_voc.yaml's recipe (nesterov SGD, clip_grad_norm
    10, multi_step) at ``size`` px, float32."""
    cfg = get_configs(CONFIG)
    cfg.update(input_size=size, compute_dtype="float32", max_annots=8)
    cfg.update(extra)
    return cfg


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def _to_port(heads) -> list:
    """podtpu's NHWC (cls, box) levels as the port's NCHW ones."""
    return [tuple(torch.from_numpy(np.asarray(h)).permute(0, 3, 1, 2)
                  for h in level) for level in heads]


# podtpu's anchors, jitted (eager, each op of the grid is its own program)
_jax_anchors = jax.jit(jretina.all_anchors, static_argnums=(0, 1))


def _heads(size: int, seed: int, batch: int = 2) -> list:
    """Seeded NHWC (cls, box) levels for ``size`` px, podtpu's layout."""
    out = []
    for i, s in enumerate(retina.STRIDES):
        hw = -(-size // s)
        out.append((normal((batch, hw, hw, 9 * C), seed + 2 * i) * 2.0,
                    normal((batch, hw, hw, 36), seed + 2 * i + 1) * 0.5))
    return out


# ---- anchors and assignment ------------------------------------------------

@pytest.mark.parametrize("size", [64, 128, 512])
def test_anchors_match_podtpu(size):
    """Every anchor bit for bit, with ceil-divided level sizes (at 64 px P6
    and P7 are 1x1); 49,104 anchors at 512 px."""
    got = retina.all_anchors(size).numpy()
    want = np.asarray(_jax_anchors(size, retina.STRIDES))
    assert got.shape == want.shape == (
        9 * sum((-(-size // s)) ** 2 for s in retina.STRIDES), 4)
    if size == 512:
        assert got.shape[0] == 49104
    np.testing.assert_array_equal(got, want)
    cached = retina.anchors_on(torch.device("cpu"), size)
    assert cached is retina.anchors_on("cpu", size)
    assert torch.equal(cached, torch.from_numpy(want.copy()))


def _assign_batch() -> np.ndarray:
    """[3, 8, 5] at 512 px: image 0 random GTs and padding rows, image 1
    empty, image 2 two overlapping GTs that share anchors, an exact
    duplicate of the first with another class (a tie the first index
    wins), and padding."""
    t = -np.ones((3, 8, 5), np.float32)
    t[0, :5] = make_targets(1, 5, C, seed=21)[0, :5]
    t[0, :5, 4] = np.arange(5)
    r = np.random.default_rng(22)
    t[0, :5, :4] = np.column_stack([r.uniform(0.1, 0.9, (5, 2)),
                                    r.uniform(0.05, 0.5, (5, 2))])
    t[2, 0] = [0.40, 0.45, 0.30, 0.25, 7]
    t[2, 1] = [0.43, 0.47, 0.28, 0.27, 11]
    t[2, 2] = [0.40, 0.45, 0.30, 0.25, 13]
    return t


def test_assign_targets_matches_podtpu():
    """The batched assignment against podtpu's vmapped one: pos, valid and
    the one-hot identical, the deltas within 1e-6. The seeded data keeps
    every anchor's best IoU at least 1e-6 (16 float32 ulps) from both
    thresholds (checked first: the closest is 1.6e-5), so no IoU sits
    where XLA and torch may round it across a threshold."""
    size, t = 512, _assign_batch()
    anchors = _jax_anchors(size, retina.STRIDES)
    want = jax.jit(jax.vmap(lambda tt: jretina.assign_targets(
        anchors, tt, C, size)))(jnp.asarray(t))
    iou = np.asarray(jax.jit(jax.vmap(lambda tt: jnp.where(
        jnp.sum(tt, -1)[None] > 0,
        jretina._iou_cxcywh(anchors, tt[:, :4] * size), -1.0).max(-1)))(
            jnp.asarray(t)))
    assert np.abs(iou - retina.POS_IOU).min() > 1e-6
    assert np.abs(iou - retina.NEG_IOU).min() > 1e-6
    got = retina.assign_targets(retina.all_anchors(size),
                                torch.from_numpy(t), C, size)
    cls_t, box_t, pos, valid = (np.asarray(w) for w in want)
    np.testing.assert_array_equal(got[2].numpy(), pos)
    np.testing.assert_array_equal(got[3].numpy(), valid)
    np.testing.assert_array_equal(got[0].numpy(), cls_t)
    np.testing.assert_allclose(got[1].numpy(), box_t, rtol=1e-6, atol=1e-6)
    assert np.isfinite(got[1].numpy()).all()
    # image 0 has positives of several GTs, image 1 none and every anchor
    # negative, image 2's shared anchors go to class 7 (not 13, its twin)
    assert len(set(np.argmax(cls_t[0][pos[0] > 0], -1))) >= 3
    assert pos[1].sum() == 0 and valid[1].all()
    won = set(np.argmax(got[0][2].numpy()[pos[2] > 0], -1))
    assert won == {7, 11}


@pytest.mark.parametrize("reduction", ["sum", "mean", "none"])
def test_focal_loss_matches_podtpu(reduction):
    logits = normal((4, 7, 5), 30) * 3.0
    targets = (np.random.default_rng(31).random((4, 7, 5)) < 0.2).astype(
        np.float32)
    want = np.asarray(podtpu_focal_loss(jnp.asarray(logits),
                                        jnp.asarray(targets),
                                        reduction=reduction))
    got = focal_loss(torch.from_numpy(logits), torch.from_numpy(targets),
                     reduction=reduction).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_loss_value_and_gradient_match_podtpu():
    """``build_loss`` at 128 px (3,069 anchors) on seeded heads: the value
    (rel 1e-5) and the gradient with respect to each of the ten heads
    (rtol 1e-4, atol 1e-6), as tests/test_torch_train.py holds YOLOv3's.
    The port's heads are NCHW views of the same arrays, so a wrong
    anchor order in the flattening shows here."""
    cfg = retina_cfg(128)
    heads = _heads(128, 40)
    annots = make_targets(2, 12, C, seed=41)
    pos = retina.assign_targets(retina.all_anchors(128),
                                torch.from_numpy(annots), C, 128)[2]
    assert pos.sum(1).min() > 0
    want, wgrads = jax.jit(jax.value_and_grad(
        lambda hs: jretina.retinanet_loss(hs, jnp.asarray(annots), C, 128)))(
            [tuple(jnp.asarray(h) for h in level) for level in heads])
    leaves = [tuple(torch.tensor(h, requires_grad=True) for h in level)
              for level in heads]
    got = build_loss(cfg)([tuple(h.permute(0, 3, 1, 2) for h in level)
                           for level in leaves], torch.from_numpy(annots))
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    for level, wlevel in zip(leaves, wgrads):
        for t, g in zip(level, wlevel):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                       rtol=1e-4, atol=1e-6)
    # every class head has a gradient; the box heads only where positives
    # fell (the smooth-L1 counts positives alone)
    assert all(float(level[0].grad.abs().max()) > 0 for level in leaves)
    assert float(leaves[0][1].grad.abs().max()) > 0


def test_decoder_matches_podtpu():
    """``make_decoder`` at 128 px: classes exactly (the first of tied
    probabilities), boxes and scores to float32 rounding."""
    cfg = retina_cfg(128)
    heads = _heads(128, 50)
    want = np.asarray(jax.jit(podtpu_make_decoder(cfg))(
        [tuple(jnp.asarray(h) for h in level) for level in heads]))
    got = make_decoder(cfg)(_to_port(heads)).numpy()
    assert got.shape == want.shape == (2, 3069, 6)
    np.testing.assert_array_equal(got[..., 5], want[..., 5])
    np.testing.assert_allclose(got[..., :5], want[..., :5], rtol=1e-5,
                               atol=1e-5)


def test_multi_label_raises():
    with pytest.raises(ValueError, match="single-label"):
        make_serve_fn(retina_cfg(nms_options={"multi_label": True}),
                      lambda x: x)


# ---- the models -----------------------------------------------------------

_CACHE: dict = {}


def _flat():
    """Seeded weights for RetinaNet at 64 px in podtpu's flat layout: every
    bias N(0, 0.1), which replaces the class prior, so candidates pass the
    threshold."""
    if "flat" not in _CACHE:
        net = podtpu_factory.build_model(retina_cfg())
        _CACHE["flat"] = module_flat_weights(
            net, jnp.zeros((1, 64, 64, 3), jnp.float32), seed=0)
    return _CACHE["flat"]


def _variables():
    """``_flat()`` as Flax variables, converted once."""
    if "variables" not in _CACHE:
        _CACHE["variables"] = flax_variables(_flat())
    return _CACHE["variables"]


def _podtpu_apply(x, train):
    """podtpu's RetinaNet forward, jitted once per mode: (heads, the BN
    statistics) in train mode, (heads, the ResNet's C3..C5) in eval mode."""
    key = ("apply", train)
    if key not in _CACHE:
        net = podtpu_factory.build_model(retina_cfg())
        if train:
            _CACHE[key] = jax.jit(lambda v, x: net.apply(
                v, x, train=True, mutable=["batch_stats"]))
        else:
            def features(mdl, method):
                return mdl.name == "backbone"

            _CACHE[key] = jax.jit(lambda v, x: net.apply(
                v, x, train=False, capture_intermediates=features,
                mutable=["intermediates"]))
    heads, extra = _CACHE[key](_variables(), jnp.asarray(x))
    if not train:
        extra = extra["intermediates"]["backbone"]["__call__"][0]
    return heads, extra


def _images():
    return image_batch(retina_cfg(), batch=2).astype(np.float32) / 255.0


def _eval_heads():
    """podtpu's eval-mode heads and ResNet features on ``_images()``."""
    if "heads" not in _CACHE:
        heads, feats = _podtpu_apply(_images(), train=False)
        _CACHE["heads"] = [tuple(np.asarray(h) for h in level)
                           for level in heads]
        _CACHE["feats"] = [np.asarray(f) for f in feats]
    return _CACHE["heads"]


def test_resnet50_features_match_podtpu():
    """ResNet-50 alone in eval mode, a ``resnet50()`` with the backbone's
    weights against podtpu's ``backbone`` output in the same forward as
    the heads: C3, C4, C5 (strides 8, 16, 32; the stem's 7x7 stride-2 conv
    and its -inf padded pool) to float32 rounding of 50 layers."""
    _eval_heads()
    want = _CACHE["feats"]
    prefix = "backbone" + SEP
    flat = {k.replace(prefix, "", 1): v for k, v in _flat().items()
            if k.split(SEP)[1] == "backbone"}
    net = load_flat_weights(resnet50(), flat).eval()
    with torch.no_grad():
        got = net(torch.from_numpy(_images()).permute(0, 3, 1, 2))
    assert [tuple(g.shape) for g in got] == [(2, 512, 8, 8), (2, 1024, 4, 4),
                                             (2, 2048, 2, 2)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(_nhwc(g), w, rtol=1e-4,
                                   atol=1e-5 * max(1.0, np.abs(w).max()))


def test_eval_forward_matches_podtpu():
    """Eval-mode heads at 64 px, every level, held to 1e-5 of the head's
    largest value and rtol 1e-4 (float32 rounding through ~70 layers)."""
    want = _eval_heads()
    net = load_flat_weights(build_model(retina_cfg(), device="cpu"), _flat())
    with torch.no_grad():
        got = net(torch.from_numpy(_images()))
    assert [tuple(h.shape) for level in got for h in level] == [
        (2, ch, s, s) for s in (8, 4, 2, 1, 1) for ch in (180, 36)]
    for level, wlevel in zip(got, want):
        for g, w in zip(level, wlevel):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(
                _nhwc(g), w, rtol=1e-4,
                atol=1e-5 * max(1.0, float(np.abs(w).max())))


def _stats_flat(batch_stats) -> dict:
    return {SEP.join(["batch_stats"] + [str(p.key) for p in path]):
            np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(batch_stats)[0]}


def test_train_forward_matches_podtpu():
    """Train-mode heads and the BN running statistics after one forward,
    held to rtol 1e-4 / atol 1e-5 (1e-4 for the statistics) beyond 8x
    podtpu's own change under a 1e-7 relative perturbation of the input
    (the E[x^2] - mean^2 batch variance of tests/test_torch_families.py;
    C5 is 2x2 at 64 px)."""
    x = _images()
    want, jvars = _podtpu_apply(x, train=True)
    nudge = np.random.default_rng(1).standard_normal(x.shape) * 1e-7
    nudged, nvars = _podtpu_apply((x * (1 + nudge)).astype(np.float32),
                                  train=True)
    witness = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                  for la, lb in zip(nudged, want) for a, b in zip(la, lb))
    net = load_flat_weights(build_model(retina_cfg(), device="cpu",
                                        train=True), _flat())
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    for level, wlevel in zip(got, want):
        for g, w in zip(level, wlevel):
            np.testing.assert_allclose(_nhwc(g), np.asarray(w), rtol=1e-4,
                                       atol=1e-5 + 8.0 * witness)
    jstats, nstats = (_stats_flat(v["batch_stats"]) for v in (jvars, nvars))
    stats_witness = max(float(np.abs(nstats[k] - v).max())
                        for k, v in jstats.items())
    tstats = {k: v for k, v in flat_from_state_dict(net).items()
              if k.startswith("batch_stats")}
    assert set(tstats) == set(jstats) and len(jstats) == 2 * 53
    for k in jstats:
        np.testing.assert_allclose(tstats[k], jstats[k], rtol=1e-4,
                                   atol=1e-4 + 8.0 * stats_witness,
                                   err_msg=k)
        assert not np.array_equal(tstats[k], _flat()[k]), k


def test_fresh_model_has_the_class_prior():
    """The class subnet's last bias starts at -log((1 - pi) / pi), pi =
    0.01, in the port's own init, and the box subnet's at 0, as podtpu's
    constant bias inits (the other layers keep PyTorch's), so a fresh
    model's class probabilities are ~0.01."""
    torch.manual_seed(0)
    net = RetinaNet(num_classes=4).eval()
    prior = -np.log((1 - PRIOR_PI) / PRIOR_PI)
    assert torch.equal(net.cls_subnet.pred.bias,
                       torch.full((36,), prior, dtype=torch.float32))
    assert torch.equal(net.box_subnet.pred.bias, torch.zeros(36))
    assert float(net.cls_subnet.conv0.bias.detach().abs().min()) > 0
    with torch.no_grad():
        heads = net(torch.rand(1, 64, 64, 3))
    probs = torch.sigmoid(retina._flatten_heads(heads, 4)[0])
    assert abs(float(probs.mean()) - PRIOR_PI) < 5e-3


# ---- the weight bridge ----------------------------------------------------

def test_weights_round_trip_every_key():
    """podtpu's flat tree loads with every key mapped, by path: the bare
    biased convs (FPN and subnets) by module type, the ResNet's by the
    ConvBnAct rows; back bit for bit; a missing or unknown key raises."""
    flat = _flat()
    assert {"params::lateral3::kernel", "params::p7::bias",
            "params::cls_subnet::conv0::kernel",
            "params::cls_subnet::pred::bias",
            "params::backbone::stem::conv::kernel",
            "params::backbone::stage2_block0::downsample::bn::scale",
            "batch_stats::backbone::stage4_block2::conv3::bn::var"} <= set(flat)
    net = load_flat_weights(build_model(retina_cfg(), device="cpu"), flat)
    back = flat_from_state_dict(net)
    assert set(back) == set(flat) and len(flat) == 301
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    sd = state_dict_from_flat(net, back)
    for k, v in net.state_dict().items():
        assert torch.equal(sd[k], v), k
    assert torch.equal(net.smooth4.weight.permute(2, 3, 1, 0),
                       torch.from_numpy(flat["params::smooth4::kernel"]))
    missing = dict(flat)
    del missing["params::box_subnet::pred::bias"]
    with pytest.raises(KeyError, match="missing"):
        state_dict_from_flat(net, missing)
    with pytest.raises(KeyError, match="no podtpu counterpart"):
        flat_key("smooth4.weight")  # a bare conv's key needs the conv paths


def _old_rule(name):
    """The name-suffix mapping before the bare-conv rule: (flat key,
    layout)."""
    table = {"conv.weight": "params::conv::kernel",
             "bn.weight": "params::bn::scale", "bn.bias": "params::bn::bias",
             "bn.running_mean": "batch_stats::bn::mean",
             "bn.running_var": "batch_stats::bn::var",
             "fc.weight": "params::fc::kernel", "fc.bias": "params::fc::bias"}
    for leaf, key in table.items():
        if name == leaf or name.endswith("." + leaf):
            coll, rest = key.split(SEP, 1)
            path = name[:-len(leaf)].rstrip(".").replace(".", SEP)
            layout = {"conv.weight": "conv", "fc.weight": "fc"}.get(leaf)
            return SEP.join(p for p in (coll, path, rest) if p), layout
    raise KeyError(name)


@pytest.mark.parametrize("model", ["yolov1", "yolov2", "yolov3",
                                   "yolov4-tiny", "yolov4"])
def test_other_families_map_as_before(model):
    """Every state_dict key of the five YOLO families maps to the flat key
    and layout of the name rule alone: the bare-conv rule never fires."""
    extra = {"yolov1": dict(num_boxes=2),
             "yolov2": dict(scaled_anchors=VOC_SCALED_ANCHORS),
             }.get(model, dict(anchors=VOC_ANCHORS))
    net = build_model(dict(model=model, num_classes=C, input_size=64,
                           **extra), device="meta")
    convs = conv_paths(net)
    names = list(net.state_dict())
    assert convs and names
    for name in names:
        assert _leaf(name, convs) == _old_rule(name), name


# ---- clip_grad_norm ---------------------------------------------------------

@pytest.mark.parametrize("engaged", [True, False], ids=["engaged", "idle"])
def test_clip_grad_norm_matches_optax_over_three_updates(engaged):
    """``optimizer_options.clip_grad_norm`` in ``TrainState.apply_gradients``
    against podtpu's chain (clip_by_global_norm, then coupled decay, then
    nesterov SGD) over three updates on the same gradients, with the global
    norm 10-30x over the limit or under it. Below it the gradients pass
    bit for bit."""
    max_norm = 1.0 if engaged else 1e3
    opts = {"lr": 0.1, "momentum": 0.9, "nesterov": True,
            "weight_decay": 0.05, "clip_grad_norm": max_norm}
    cfg = {"model": "retinanet", "optimizer": "sgd",
           "optimizer_options": opts, "scheduler": None}
    torch.manual_seed(0)
    block = ConvBnAct(2, 3, 3)
    names = {"conv.weight": ("conv", "kernel"), "bn.weight": ("bn", "scale"),
             "bn.bias": ("bn", "bias")}

    def to_j(n, t):
        return jnp.asarray((t.permute(2, 3, 1, 0) if n == "conv.weight"
                            else t).detach().numpy())

    params = {"conv": {}, "bn": {}}
    for n, p in block.named_parameters():
        params[names[n][0]][names[n][1]] = to_j(n, p)
    tx = podtpu_build_optimizer(cfg, params)
    opt_state = jax.jit(tx.init)(params)
    update = jax.jit(tx.update)
    state = TrainState(block, build_optimizer(cfg, block),
                       build_schedule(cfg), clip_norm=max_norm)
    r = np.random.default_rng(1)
    for step in range(3):
        grads = {n: (r.normal(size=p.shape) * 3).astype(np.float32)
                 for n, p in block.named_parameters()}
        norm = np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                           for g in grads.values()))
        assert (norm > 10 * max_norm) if engaged else (norm < max_norm)
        jg = {"conv": {}, "bn": {}}
        for n, g in grads.items():
            jg[names[n][0]][names[n][1]] = to_j(n, torch.from_numpy(g))
        upd, opt_state = update(jg, opt_state, params)
        params = optax.apply_updates(params, upd)
        for n, p in block.named_parameters():
            p.grad = torch.from_numpy(grads[n].copy())
        state.apply_gradients()
        for n, p in block.named_parameters():
            if not engaged:
                assert np.array_equal(p.grad.numpy(), grads[n]), n
            np.testing.assert_allclose(
                to_j(n, p), np.asarray(params[names[n][0]][names[n][1]]),
                rtol=1e-6, atol=1e-6, err_msg=f"{n} after update {step}")
    assert state.step == 3


def test_clip_by_global_norm_is_optax():
    """The clip alone: the norm before it, and each clipped gradient within
    float32 rounding of optax's; the norm after it is the limit."""
    grads = [normal(s, 70 + i) for i, s in enumerate([(3, 4), (5,), (2, 2, 2)])]
    want, want_norm = jax.jit(lambda gs: (optax.clip_by_global_norm(
        2.0).update(gs, optax.EmptyState())[0], optax.global_norm(gs)))(
            [jnp.asarray(g) for g in grads])
    got = [torch.from_numpy(g.copy()) for g in grads]
    norm = clip_by_global_norm_(got, 2.0)
    assert float(norm) == pytest.approx(float(want_norm), rel=1e-6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)
    after = torch.linalg.vector_norm(torch.cat([g.ravel() for g in got]))
    assert float(after) == pytest.approx(2.0, rel=1e-6)


# ---- the steps, serving and the config --------------------------------------

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


def test_train_step_matches_podtpu():
    """One update of configs/retinanet_voc.yaml's recipe (nesterov SGD,
    decay on kernels, the clip at 10 engaged: the raw gradient's norm is
    checked to be over it) from podtpu's weights, against podtpu's step.

    As tests/test_torch_train.py finds for YOLOv3, the update at random
    weights is ill-conditioned: the class loss is dominated by negatives
    nearly uniform over positions, which train-mode BN removes, and the
    clip passes the residue's direction on at a fixed norm. A 1e-7
    relative perturbation of the input moves podtpu's own update by 2.2%
    of its norm (and its BN statistics by 1.5e-4). So the loss is held to
    1e-4, the BN statistics to rtol 1e-4 / atol 1e-4 beyond 8x their
    witness and the update to 8x its witness (measured: the port is 3.3x
    it away, 7.3% of the norm)."""
    cfg = retina_cfg()
    flat = _flat()
    r = np.random.default_rng(9)
    boxes = [np.asarray([[*r.uniform(0.3, 0.7, 2), *r.uniform(0.3, 0.7, 2),
                          r.integers(0, C)] for _ in range(4)], np.float32)
             for _ in range(2)]
    img = image_batch(cfg, batch=2, seed=9).astype(np.float32) / 255.0
    annot = pad_annotations(boxes, 8)
    variables = _variables()
    tx = podtpu_build_optimizer(cfg, variables["params"])
    opt_state = jax.jit(tx.init)(variables["params"])
    jstep = podtpu_make_train_step(cfg, donate=False)
    apply_fn = podtpu_factory.build_model(cfg).apply  # one trace for both
    nudge = np.random.default_rng(1).standard_normal(img.shape) * 1e-7
    want = []
    for x in (img, (img * (1 + nudge)).astype(np.float32)):
        jstate = PodtpuTrainState(
            step=0, apply_fn=apply_fn,
            params=variables["params"], tx=tx, opt_state=opt_state,
            batch_stats=variables["batch_stats"])
        jstate, m = jstep(jstate, {"img": jnp.asarray(x),
                                   "annot": jnp.asarray(annot)},
                          jax.random.PRNGKey(1))
        want.append((float(m["loss"]), _jax_flat(jstate)))
    (want_loss, want), (_, nudged) = want

    state = create_train_state(cfg, "cpu", weights=flat)
    assert state.clip_norm == 10.0
    norms = []
    apply_gradients = state.apply_gradients

    def spy():
        norms.append(float(torch.linalg.vector_norm(torch.stack(
            [p.grad.norm() for p in state.model.parameters()]))))
        apply_gradients()

    state.apply_gradients = spy
    state, m = make_train_step(cfg)(state, {"img": torch.from_numpy(img),
                                            "annot": torch.from_numpy(annot)})
    assert norms[0] > 10.0
    got_loss, got = float(m["loss"]), flat_from_state_dict(state.model)
    assert state.step == 1 and set(got) == set(want)
    assert got_loss == pytest.approx(want_loss, rel=1e-4)
    stats = [k for k in want if k.startswith("batch_stats")]
    stats_witness = max(float(np.abs(nudged[k] - want[k]).max())
                        for k in stats)
    for k in stats:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                   atol=1e-4 + 8.0 * stats_witness,
                                   err_msg=k)
    up_t, up_j = _update(got, flat), _update(want, flat)
    witness = np.linalg.norm(_update(nudged, flat) - up_j)
    assert 0 < witness <= 0.05 * np.linalg.norm(up_j)
    assert np.linalg.norm(up_t - up_j) <= 8.0 * witness


def test_serve_fn_and_engine_match_podtpu():
    """The serving graph on podtpu's own heads for the same images, and the
    HTTP server's engine on the same weights. The detections carry the
    heads' difference ``dh``: w and h are exp(t) * anchor (relative error
    dh), the centres anchor + t * anchor (at most dh times the largest
    anchor, 1,149 px at stride 128), the scores a sigmoid (dh / 4)."""
    cfg = retina_cfg()
    x = image_batch(cfg, batch=2)
    heads = _eval_heads()
    serve = podtpu_make_serve_fn(cfg, lambda v: [
        tuple(jnp.asarray(h) for h in level) for level in heads])
    want = jax.jit(lambda: serve(None))()
    net = load_flat_weights(build_model(cfg, device="cpu"), _flat())
    xt = _as_input(torch.from_numpy(x))
    with torch.no_grad():
        dh = max(float(np.abs(_nhwc(t) - h).max())
                 for level, hl in zip(net(xt), heads)
                 for t, h in zip(level, hl))
    got = make_serve_fn(cfg, net)(xt)
    assert got[0].shape == (2, 100, 6)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    big = float(retina.all_anchors(64)[:, 2:].max())
    for g, w, v in zip(got[0].numpy(), np.asarray(want[0]), got[1].numpy()):
        assert v.sum() > 0
        np.testing.assert_array_equal(g[v, 5], w[v, 5])
        np.testing.assert_allclose(g[v, :2], w[v, :2], rtol=1e-5,
                                   atol=1e-3 + big * dh)
        np.testing.assert_allclose(g[v, 2:4], w[v, 2:4], rtol=1e-4 + 2 * dh,
                                   atol=1e-3)
        np.testing.assert_allclose(g[v, 4], w[v, 4], atol=1e-5 + dh / 4)
    engine = Engine(cfg, _flat(), device="cpu")
    rows = engine.predict_array(x[0])["detections"]
    assert sorted(r["class_id"] for r in rows) == sorted(
        got[0][0, got[1][0], 5].int().tolist())


def test_config_builds_unchanged(tmp_path):
    """configs/retinanet_voc.yaml as shipped (512 px, bf16, 20 classes,
    clip_grad_norm 10, multi_step): model, loss, decoder, train state and
    a Trainer build on the CPU and none raises (nothing is run)."""
    cfg = get_configs(CONFIG)
    assert (cfg["input_size"], cfg["compute_dtype"], cfg["batch_size"]) == (
        512, "bfloat16", 32)
    model = build_model(cfg, device="cpu")
    assert isinstance(model, RetinaNet) and not model.training
    assert model.cls_subnet.pred.dtype == torch.bfloat16
    assert 36e6 < sum(p.numel() for p in model.parameters()) < 37e6
    assert callable(build_loss(cfg)) and callable(make_decoder(cfg))
    state = create_train_state(cfg, "cpu")
    assert state.clip_norm == 10.0 and state.model.training
    sgd = state.optimizer.param_groups[0]
    assert sgd["nesterov"] and sgd["momentum"] == 0.9
    assert state.schedule(29999) == pytest.approx(1e-2)
    assert state.schedule(30000) == pytest.approx(1e-3)
    Trainer(cfg, device="cpu", log=quiet, run_dir=str(tmp_path))


def test_fit_one_epoch_then_test(synth, tmp_path, recording_writer):
    """A 1-epoch ``Trainer.fit`` of the recipe at 64 px, B=4, on the
    synthetic files (2 steps, 2 val batches), then ``cli.test`` on its
    ``best``: finite losses, mAP in [0, 1], the checkpoints, and the same
    val_loss and val_mAP from the checkpoint as ``fit`` recorded."""
    cfg = retina_cfg(batch_size=4, workers=2, epochs=1, save_freq=100,
                     trainer_options={"check_val_every_n_epoch": 1},
                     train_list=synth["train_list"],
                     val_list=synth["val_list"], names=synth["names"],
                     save_dir=str(tmp_path))
    trainer = Trainer(cfg, device="cpu", log=quiet)
    train_loader, val_loader = make_loaders(trainer.cfg)
    (row,) = trainer.fit(train_loader, val_loader, epochs=1)
    assert row["step"] == 2 == trainer.state.step
    assert np.isfinite([row["train_loss"], row["val_loss"]]).all()
    assert 0.0 <= row["val_mAP"] <= 1.0
    ckpt = os.path.join(trainer.run_dir, "checkpoints")
    assert {"last", "best"} <= set(os.listdir(ckpt))
    res = test_cli.evaluate(cfg, os.path.join(ckpt, "best"), device="cpu")
    assert res["val_loss"] == pytest.approx(row["val_loss"], rel=1e-5)
    assert res["val_mAP"] == pytest.approx(row["val_mAP"], abs=1e-6)
