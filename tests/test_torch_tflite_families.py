"""Forward parity of the hand-written TFLite export for every family
beside YOLOv3 (which ``tests/test_torch_tflite.py`` holds): YOLOv2,
YOLOv1, YOLOv4-tiny, YOLOv4 and RetinaNet from their shipped configs at
64 px, float32, seeded weights from podtpu's flat layout. Each file runs
on TensorFlow's interpreter against podtpu's ``model.apply`` on JAX:CPU,
and through the port's reader on the CPU against the interpreter.
RetinaNet's heads are NCHW in the port (``models/retinanet.py``) and NHWC
in podtpu: the file keeps the port's layout."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from podtpu.models.factory import build_model as podtpu_build_model
from podtpu_torch.config import get_configs
from podtpu_torch.export.tflite import export_tflite, inspect_tflite, \
    load_tflite
from podtpu_torch.export.weights import load_flat_weights
from podtpu_torch.models.factory import build_model
from tests.torch_parity import flax_variables, podtpu_flat_weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# family config -> an op its file must hold (what it adds to YOLOv3's)
FAMILIES = {
    "yolov2_voc": "TRANSPOSE",       # the passthrough reorg's reshape
    "yolov1_voc": "FULLY_CONNECTED",
    "yolov4-tiny_voc": "PAD",        # its stride-2 convolutions
    "yolov4_voc": "TANH",            # mish as x tanh(log(1 + exp x))
    "retinanet_voc": "ADD",          # the residual adds and the FPN
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


def _bound(want: np.ndarray) -> float:
    """atol 1e-4 (podtpu's YOLOv3 bound), or 1e-5 of the head's largest
    magnitude where that is larger: YOLOv4's heads reach ~2e3 at random
    weights, where float32's spacing alone is 1.2e-4."""
    return max(1e-4, 1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_forward_tflite_matches_podtpu(name, tf, tmp_path):
    cfg = get_configs(os.path.join(REPO, "configs", f"{name}.yaml"))
    cfg.update(input_size=64, compute_dtype="float32")
    if cfg["model"] == "yolov1":
        cfg["dropout_rate"] = 0.0
    flat = podtpu_flat_weights(cfg, seed=11)
    model = load_flat_weights(build_model(cfg, "cpu"), flat).eval()
    x = np.random.default_rng(1).uniform(0, 1, (1, 64, 64, 3)).astype(
        np.float32)
    path = export_tflite(model, cfg, (1, 64, 64, 3),
                         str(tmp_path / f"{name}.tflite"))
    assert FAMILIES[name] in inspect_tflite(path)["ops"]
    it = tf.lite.Interpreter(model_path=path)
    it.allocate_tensors()
    it.set_tensor(it.get_input_details()[0]["index"], x)
    it.invoke()
    got = [it.get_tensor(d["index"]) for d in it.get_output_details()]
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
    read = load_tflite(path, "cpu")(torch.from_numpy(x))
    read = read if isinstance(read, tuple) else (read,)
    assert len(read) == len(got)
    for r, g in zip(read, got):
        assert np.abs(r.numpy() - g).max() <= _bound(g), name
    os.remove(path)
