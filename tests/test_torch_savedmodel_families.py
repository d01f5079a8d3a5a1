"""Forward parity of the hand-written SavedModel export for every family
beside YOLOv3 (which ``tests/test_torch_savedmodel.py`` holds): YOLOv2,
YOLOv1, YOLOv4-tiny, YOLOv4 and RetinaNet from their shipped configs at
64 px, float32, seeded weights from podtpu's flat layout. Each SavedModel
runs on TensorFlow's ``serving_default`` signature against podtpu's
``model.apply`` on JAX:CPU, and through the port's reader on the CPU
against TensorFlow. RetinaNet's heads are NCHW in the port
(``models/retinanet.py``) and NHWC in podtpu: the file keeps the port's
layout."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from podtpu.models.factory import build_model as podtpu_build_model
from podtpu_torch.config import get_configs
from podtpu_torch.export.savedmodel import (
    export_savedmodel,
    inspect_savedmodel,
    load_savedmodel,
)
from podtpu_torch.export.weights import load_flat_weights
from podtpu_torch.models.factory import build_model
from tests.test_torch_tflite_families import _bound
from tests.torch_parity import flax_variables, podtpu_flat_weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# family config -> a TF operator its file must hold (what it adds to
# YOLOv3's)
FAMILIES = {
    "yolov2_voc": "Transpose",       # the passthrough reorg
    "yolov1_voc": "MatMul",          # its fully connected layers
    "yolov4-tiny_voc": "Conv2D",     # stride 2, its pads explicit
    "yolov4_voc": "Tanh",            # mish as x tanh(log(1 + exp x))
    "retinanet_voc": "AddV2",        # the residual adds and the FPN
}


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Six workers share the cores: two intra-op threads each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def tf():
    return pytest.importorskip("tensorflow")


@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_forward_savedmodel_matches_podtpu(name, tf, tmp_path):
    """The family's forward SavedModel at B=1: TensorFlow's heads
    against podtpu's at atol 1e-4, or 1e-5 of the head's scale where that
    is larger (``tests/test_torch_tflite_families.py::_bound``); the
    reader's against TensorFlow's at the same bound; no ``Pad`` left
    before a ``Conv2D`` (merged into its explicit padding)."""
    cfg = get_configs(os.path.join(REPO, "configs", f"{name}.yaml"))
    cfg.update(input_size=64, compute_dtype="float32")
    if cfg["model"] == "yolov1":
        cfg["dropout_rate"] = 0.0
    flat = podtpu_flat_weights(cfg, seed=11)
    model = load_flat_weights(build_model(cfg, "cpu"), flat).eval()
    x = np.random.default_rng(1).uniform(0, 1, (1, 64, 64, 3)).astype(
        np.float32)
    path = export_savedmodel(model, cfg, (1, 64, 64, 3),
                             str(tmp_path / f"{name}.savedmodel"))
    del model
    ops = inspect_savedmodel(path)["ops"]
    assert FAMILIES[name] in ops and "Pad" not in ops
    fn = tf.saved_model.load(path).signatures["serving_default"]
    out = fn(image=tf.constant(x))
    got = [out[f"output_{i}"].numpy() for i in range(len(out))]
    jmodel = podtpu_build_model(cfg)
    want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        flax_variables(flat), jnp.asarray(x))
    want = [np.asarray(w) for w in jax.tree_util.tree_leaves(want)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if cfg["model"] == "retinanet":
            w = np.moveaxis(w, -1, 1)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= _bound(w), name
    read = load_savedmodel(path, "cpu")(torch.from_numpy(x))
    read = read if isinstance(read, tuple) else (read,)
    assert len(read) == len(got)
    for r, g in zip(read, got):
        assert np.abs(r.numpy() - g).max() <= _bound(g), name
