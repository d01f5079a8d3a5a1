"""Forward parity of the hand-written TFLite export for every family
beside YOLOv3 (which ``tests/test_torch_tflite.py`` holds): YOLOv2,
YOLOv1, YOLOv4-tiny, YOLOv4 and RetinaNet from their shipped configs at
64 px, float32, seeded weights from podtpu's flat layout. Each file runs
on TensorFlow's interpreter against podtpu's ``model.apply`` on JAX:CPU,
and through the port's reader on the CPU against the interpreter. Each
family is traced once; its int8 and dynamic-range files are written from
the same trace and held to the interpreter's reference kernels.
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
from podtpu_torch.export.tflite import (
    inspect_tflite,
    load_tflite,
    lower_model,
    read_tflite,
    write_tflite,
)
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


# each family traced once, for its float file, then its int8 and dynamic
# files
_LOWERED: dict = {}


def _lowered(name):
    """``(cfg, flat, lowered subgraph)`` of a family at 64 px, cached for
    the int8 test that follows the float one."""
    if name not in _LOWERED:
        cfg = get_configs(os.path.join(REPO, "configs", f"{name}.yaml"))
        cfg.update(input_size=64, compute_dtype="float32")
        if cfg["model"] == "yolov1":
            cfg["dropout_rate"] = 0.0
        flat = podtpu_flat_weights(cfg, seed=11)
        model = load_flat_weights(build_model(cfg, "cpu"), flat).eval()
        _LOWERED[name] = (cfg, flat, lower_model(model, cfg, (1, 64, 64, 3)))
    return _LOWERED[name]


def _input(seed=1):
    return np.random.default_rng(seed).uniform(0, 1, (1, 64, 64, 3)).astype(
        np.float32)


def _interpret(tf, path, x, resolver="AUTO"):
    it = tf.lite.Interpreter(
        model_path=path, experimental_op_resolver_type=getattr(
            tf.lite.experimental.OpResolverType, resolver))
    it.allocate_tensors()
    it.set_tensor(it.get_input_details()[0]["index"], x)
    it.invoke()
    return [it.get_tensor(d["index"]) for d in it.get_output_details()]


@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_forward_tflite_matches_podtpu(name, tf, tmp_path):
    cfg, flat, lowered = _lowered(name)
    x = _input()
    path = write_tflite(lowered, str(tmp_path / f"{name}.tflite"))
    assert FAMILIES[name] in inspect_tflite(path)["ops"]
    got = _interpret(tf, path, x)
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
    if name not in INT8_FAMILIES:
        _LOWERED.pop(name)


# what the int8 file of a family adds to YOLOv3's int8 operators
INT8_FAMILIES = {
    "yolov2_voc": "CONV_2D",
    "yolov1_voc": "FULLY_CONNECTED",  # int8, its requantization rounded once
    "yolov4_voc": "TANH",             # Mish in float between (de)quantizes
    "retinanet_voc": "ADD",           # int8 residual adds, ReLU fused
}


@pytest.mark.parametrize("name", list(INT8_FAMILIES))
def test_family_int8_tflite_reader_equals_interpreter(name, tf, tmp_path):
    """The family's int8 forward file (calibrated on two batches through
    the reader), from the trace of its float test: the reader's
    dequantized heads equal the interpreter's with the reference kernels
    (the same int8 codes)."""
    cfg, _, lowered = _lowered(name)
    rng = np.random.default_rng(2)
    rep = [rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
           for _ in range(2)]
    path = write_tflite(lowered, str(tmp_path / f"{name}_int8.tflite"),
                        "int8", rep, "cpu")
    ops = inspect_tflite(path)["ops"]
    assert INT8_FAMILIES[name] in ops and ops["QUANTIZE"] >= 1
    x = _input()
    want = _interpret(tf, path, x, "BUILTIN_REF")
    read = load_tflite(path, "cpu")(torch.from_numpy(x))
    read = read if isinstance(read, tuple) else (read,)
    assert len(read) == len(want)
    for r, w in zip(read, want):
        np.testing.assert_array_equal(r.numpy(), w)
    if name == "yolov1_voc":
        f = read_tflite(path)
        fc = [op for op in f.ops if op[0] == "FULLY_CONNECTED"][0]
        assert f.tensors[fc[1][0]][2] == "INT8"
    os.remove(path)


@pytest.mark.parametrize("name", list(INT8_FAMILIES))
def test_family_dynamic_tflite_reader_matches_interpreter(name, tf,
                                                          tmp_path):
    """The family's dynamic-range forward file, from the same trace, on
    the interpreter (reference kernels) and the reader: heads within 1e-5
    of their scale (measured 0 to 1.3e-7). YOLOv4's float Mish before each
    hybrid convolution rounds apart in the two runtimes by an ulp, which
    moves a code of the next layer's per-image input quantization: its
    heads are held to 0.1 of their scale (measured 0.033-0.056), the
    bound of quantized heads against float ones."""
    _, _, lowered = _lowered(name)
    del _LOWERED[name]
    path = write_tflite(lowered, str(tmp_path / f"{name}_dynamic.tflite"),
                        "dynamic")
    assert inspect_tflite(path)["tensor_types"]["INT8"] > 0
    x = _input()
    want = _interpret(tf, path, x, "BUILTIN_REF")
    read = load_tflite(path, "cpu")(torch.from_numpy(x))
    read = read if isinstance(read, tuple) else (read,)
    bound = 0.1 if name == "yolov4_voc" else 1e-5
    assert len(read) == len(want)
    for r, w in zip(read, want):
        assert np.abs(r.numpy() - w).max() <= bound * np.abs(w).max(), name
    os.remove(path)
