"""Backbone pretraining and the inactive loss variants, the port against
podtpu (CPU, 64 px, float32): ``generate_classification``, both
classifiers (eval forward, one pretrain step with podtpu's dropout mask
handed across), the cosine schedule, ``cli.pretrain_darknet``'s ``.npz``
loaded into a detector by both packages, and ``yolov2_loss``,
``yolov3_loss`` and ``yolov3_loss_v3``."""

import filecmp
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import struct

from podtpu.data.synthetic import (
    generate_classification as podtpu_generate_classification,
)
from podtpu.export.weights import load_npz_weights as podtpu_load_npz
from podtpu.losses import yolov2 as jyolov2
from podtpu.losses import yolov3 as jyolov3
from podtpu.models.darknet import Darknet19Classifier as JDarknet19Classifier
from podtpu.models.yolov4 import (
    CSPDarknet53Classifier as JCSPDarknet53Classifier,
)
from podtpu_torch.cli import pretrain_darknet
from podtpu_torch.data.synthetic import generate_classification
from podtpu_torch.export.weights import flat_from_tensors, load_flat_weights
from podtpu_torch.losses import yolov2_loss, yolov3_loss, yolov3_loss_v3
from podtpu_torch.models.darknet import Darknet19Classifier
from podtpu_torch.models.yolov4 import CSPDarknet53Classifier
from podtpu_torch.train.schedule import cosine_decay_schedule
from podtpu_torch.train.state import create_train_state
from tests.helpers import VOC_ANCHORS, VOC_SCALED_ANCHORS, make_targets
from tests.torch_parity import (
    SEP,
    flax_variables,
    module_flat_weights,
    podtpu_flat_weights,
    yolo_cfg,
)

NUM_CLASSES = 10
SIZE = 64
CLASSIFIERS = {
    "darknet19": (JDarknet19Classifier, Darknet19Classifier),
    "cspdarknet53": (JCSPDarknet53Classifier, CSPDarknet53Classifier),
}


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Six workers share the cores: two intra-op threads each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_generate_classification_writes_podtpus_files(tmp_path):
    got = generate_classification(str(tmp_path / "port"), n_per_class=3,
                                  size=SIZE, num_classes=4, seed=5)
    want = podtpu_generate_classification(str(tmp_path / "jax"),
                                          n_per_class=3, size=SIZE,
                                          num_classes=4, seed=5)
    assert got == want == [f"class{i:02d}" for i in range(4)]
    for cls in got:
        names = sorted(os.listdir(tmp_path / "port" / cls))
        assert names == sorted(os.listdir(tmp_path / "jax" / cls))
        assert len(names) == 3
        match, mismatch, errors = filecmp.cmpfiles(
            tmp_path / "port" / cls, tmp_path / "jax" / cls, names,
            shallow=False)
        assert match == names and not mismatch and not errors


@pytest.fixture(scope="module")
def classifiers():
    """Per classifier: the seeded flat weights, podtpu's module and the
    port's model holding them (train mode), and a batch."""
    out = {}
    x = np.random.default_rng(2).uniform(0, 1, (4, SIZE, SIZE, 3)).astype(
        np.float32)
    for name, (jcls, tcls) in CLASSIFIERS.items():
        jmodel = jcls(num_classes=NUM_CLASSES)
        flat = module_flat_weights(jmodel, jnp.zeros((1, SIZE, SIZE, 3)),
                                   seed=7)
        model = load_flat_weights(tcls(num_classes=NUM_CLASSES), flat)
        out[name] = (flat, jmodel, model, x)
    return out


@pytest.mark.parametrize("name", list(CLASSIFIERS))
def test_classifier_eval_forward_matches_podtpu(classifiers, name):
    flat, jmodel, model, x = classifiers[name]
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        flax_variables(flat), jnp.asarray(x)))
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (4, NUM_CLASSES)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def _keep_mask(shape_nhwc, seed=3) -> np.ndarray:
    return np.random.default_rng(seed).uniform(size=shape_nhwc) < 0.5


@pytest.mark.parametrize("name", list(CLASSIFIERS))
def test_pretrain_step_matches_podtpu(classifiers, name):
    """One train-mode step, float32: podtpu's value_and_grad of the mean
    softmax cross-entropy against the port's backward, with the same
    dropout mask on both sides (podtpu's ``nn.Dropout`` intercepted).
    Held as tests/test_torch_train.py holds a first step: the loss to
    1e-4, the BN statistics to 1e-4 / 1e-5, the gradient to 5% of its
    norm with cosine 0.999."""
    flat, jmodel, model, x = classifiers[name]
    labels = np.arange(4) % NUM_CLASSES
    keep = _keep_mask((4, 2, 2, 1024))

    def dropout(next_fun, args, kwargs, context):
        if isinstance(context.module, nn.Dropout) and \
                context.method_name == "__call__":
            return jnp.where(jnp.asarray(keep), args[0] / 0.5, 0.0)
        return next_fun(*args, **kwargs)

    variables = flax_variables(flat)

    def loss_fn(params):
        with nn.intercept_methods(dropout):
            logits, upd = jmodel.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                jnp.asarray(x), train=True, mutable=["batch_stats"],
                rngs={"dropout": jax.random.PRNGKey(0)})
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(labels)).mean()
        return loss, upd

    (jloss, upd), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])

    model.train()
    mask = torch.from_numpy(keep).permute(0, 3, 1, 2)
    model.dropout.forward = lambda t: torch.where(mask, t / 0.5, 0.0)
    model.zero_grad(set_to_none=True)
    try:
        logits = model(torch.from_numpy(x))
        loss = pretrain_darknet.softmax_cross_entropy(
            logits, torch.from_numpy(labels)).mean()
        loss.backward()
    finally:
        del model.dropout.forward
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-4)

    got = flat_from_tensors({k: p.grad for k, p in model.named_parameters()})
    got.update({k: v for k, v in flat_from_tensors(
        model.state_dict()).items() if k.startswith("batch_stats")})
    want = {}
    for coll, tree in (("params", jgrads), ("batch_stats",
                                            upd["batch_stats"])):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            want[SEP.join([coll] + [str(p.key) for p in path])] = \
                np.asarray(leaf)
    assert set(got) == set(want)
    for k in want:
        if k.startswith("batch_stats"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5,
                                       err_msg=k)
    g = np.concatenate([got[k].ravel() for k in sorted(want)
                        if k.startswith("params")])
    w = np.concatenate([want[k].ravel() for k in sorted(want)
                        if k.startswith("params")])
    assert np.linalg.norm(g - w) <= 0.05 * np.linalg.norm(w)
    assert g @ w >= 0.999 * np.linalg.norm(g) * np.linalg.norm(w)


@pytest.mark.parametrize("lr,steps", [(0.1, 10), (0.05, 37), (0.37, 1000)])
def test_cosine_schedule_matches_optax(lr, steps):
    want = optax.cosine_decay_schedule(lr, steps)
    got = cosine_decay_schedule(lr, steps)
    for t in (0, steps // 2, steps, steps + 5):
        assert got(t) == float(want(t)), t


@struct.dataclass
class _Variables:
    """What podtpu's ``load_npz_weights`` reads of a train state."""
    params: dict
    batch_stats: dict
    ema: object = None


def test_pretrained_npz_loads_into_both_packages(tmp_path):
    """``cli.pretrain_darknet``'s run (1 epoch, 64 px, float32) on a
    3-class set;
    its ``.npz`` loads through cfg ``backbone_pretrained`` into the port's
    YOLOv3 and through ``load_npz_weights(allow_partial=True)`` into
    podtpu's: every backbone tensor bit for bit, the rest as it was."""
    generate_classification(str(tmp_path / "cls"), n_per_class=4, size=SIZE,
                            num_classes=3, seed=0)
    out = str(tmp_path / "pre.npz")
    res = pretrain_darknet.pretrain(
        str(tmp_path / "cls"), size=SIZE, batch=4, epochs=1, out=out,
        val_data=str(tmp_path / "cls"), device="cpu", dtype="float32")
    assert [r["steps"] for r in res["epochs"]] == [3]
    assert 0.0 <= res["epochs"][0]["val_top1"] <= 1.0
    with np.load(out) as data:
        saved = {k: data[k] for k in data.files}
    assert "params::classifier::conv::kernel" in saved
    backbone = {k: v for k, v in saved.items() if "::backbone::" in k}
    assert len(backbone) == 18 * 5  # 18 blocks: kernel, BN affine + stats

    cfg = yolo_cfg("float32", SIZE, backbone_pretrained=out,
                   optimizer_options={"lr": 1e-3})
    state = create_train_state(cfg, "cpu")
    from podtpu_torch.export.weights import flat_from_state_dict

    port = flat_from_state_dict(state.model)
    for k, v in backbone.items():
        np.testing.assert_array_equal(port[k], v, err_msg=k)

    flat = podtpu_flat_weights(yolo_cfg("float32", SIZE), seed=1)
    variables = flax_variables(flat)
    jstate = podtpu_load_npz(_Variables(variables["params"],
                                        variables["batch_stats"]), out,
                             allow_partial=True)
    loaded = {}
    for coll in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                getattr(jstate, coll))[0]:
            loaded[SEP.join([coll] + [str(p.key) for p in path])] = \
                np.asarray(leaf)
    assert set(loaded) == set(flat)
    for k, v in loaded.items():
        np.testing.assert_array_equal(v, backbone.get(k, flat[k]), err_msg=k)


LOSSES = {
    "yolov2_loss": (
        lambda p, t: jyolov2.yolov2_loss(p, t, 20, VOC_SCALED_ANCHORS),
        lambda p, t: yolov2_loss(p, t, 20, VOC_SCALED_ANCHORS), (13,), 125),
    "yolov3_loss": (
        lambda p, t: jyolov3.yolov3_loss(p, t, 20, VOC_ANCHORS, 128),
        lambda p, t: yolov3_loss(p, t, 20, VOC_ANCHORS, 128), (16, 8, 4), 75),
    "yolov3_loss_v3": (
        lambda p, t: jyolov3.yolov3_loss_v3(p, t, 20, VOC_ANCHORS, 128),
        lambda p, t: yolov3_loss_v3(p, t, 20, VOC_ANCHORS, 128), (16, 8, 4),
        75),
}


@pytest.mark.parametrize("name", list(LOSSES))
def test_inactive_loss_variants_match_podtpu(name):
    """Value and head gradients within 1e-5 (relative; the gradients also
    1e-5 of their largest entry)."""
    jfn, tfn, sides, ch = LOSSES[name]
    r = np.random.default_rng(5)
    heads = [(r.normal(0, 1, (3, s, s, ch)) * 0.5).astype(np.float32)
             for s in sides]
    annots = make_targets(3, 12, 20, seed=6)
    single = len(sides) == 1
    jheads = jnp.asarray(heads[0]) if single else [jnp.asarray(h)
                                                   for h in heads]
    want, wgrads = jax.jit(jax.value_and_grad(jfn))(jheads,
                                                    jnp.asarray(annots))
    theads = [torch.tensor(h, requires_grad=True) for h in heads]
    got = tfn(theads[0] if single else theads, torch.from_numpy(annots))
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    for t, g in zip(theads, [wgrads] if single else wgrads):
        g = np.asarray(g)
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=1e-5,
                                   atol=1e-5 * np.abs(g).max())
