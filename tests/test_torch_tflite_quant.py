"""Quantized TFLite files written by hand (``export/tflite_quant.py``) and
the reader's integer arithmetic (``export/tflite_int8.py``), on the CPU.

The oracle is TensorFlow's ``tf.lite.Interpreter`` with the reference
kernels (``OpResolverType.BUILTIN_REF``): the reader must give its int8
codes exactly. YOLOv3 at 64 px on 3 classes is traced once for the
forward and once for the serving unit (``lower_model``), and each file is
written from those (``write_tflite``). Against ``podtpu``: the YOLOv4-tiny
config of ``tests/test_export_tflite.py`` with podtpu's own bounds, and
the int8 filters of podtpu's dynamic-range file from TensorFlow's
converter. Planted cases pin the rounding, the saturation, ``ADD`` of two
scales, ``LEAKY_RELU``'s alpha side and a SAME convolution's border under
a non-zero input zero point; two planted faults must fail them. The card
against the CPU: ``tests/test_torch_cuda.py`` (a file without JAX)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from podtpu_torch.export import tflite_int8, tflite_schema
from podtpu_torch.export.tflite import (
    TFLiteFile,
    inspect_tflite,
    load_tflite,
    lower_model,
    read_tflite,
    write_tflite,
)
from podtpu_torch.export.tflite_lower import Builder, lower_program
from podtpu_torch.export.tflite_quant import calibrate, full_integer
from podtpu_torch.export.weights import load_flat_weights
from podtpu_torch.models.factory import build_model
from podtpu_torch.ops.kernels.nms_kernel import greedy_suppress
from tests.torch_parity import (
    fake_voc_run,
    flax_variables,
    podtpu_flat_weights,
    yolo_cfg,
)

CFG = yolo_cfg(num_classes=3)
B = 2
# dets: the reader's bound against the interpreter on the float files
# (tests/test_torch_tflite.py)
BOX_RTOL = 1e-5


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


def _interpret(tf, path, *xs, resolver="BUILTIN_REF"):
    """The file's outputs on TensorFlow's interpreter with the given op
    resolver (the reference kernels by default)."""
    kind = getattr(tf.lite.experimental.OpResolverType, resolver)
    it = tf.lite.Interpreter(model_path=path,
                             experimental_op_resolver_type=kind)
    it.allocate_tensors()
    for d, x in zip(it.get_input_details(), xs):
        it.set_tensor(d["index"], np.asarray(x))
    it.invoke()
    return [it.get_tensor(d["index"]) for d in it.get_output_details()]


def _read(path, *xs):
    out = load_tflite(path, "cpu")(*[torch.from_numpy(np.asarray(x))
                                     for x in xs])
    return [o.numpy() for o in (out if isinstance(out, tuple) else (out,))]


@pytest.fixture(scope="module")
def yolo(tmp_path_factory):
    """YOLOv3 traced once as a forward and once as a serving unit; its
    float, int8 and dynamic files; an input batch and two calibration
    batches."""
    root = tmp_path_factory.mktemp("quant")
    flat = podtpu_flat_weights(CFG, seed=3)
    model = load_flat_weights(build_model(CFG, "cpu"), flat).eval()
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (B, 64, 64, 3)).astype(np.float32)
    rep = [rng.uniform(0, 1, (B, 64, 64, 3)).astype(np.float32)
           for _ in range(2)]
    files = {}
    for kind, post in (("fwd", False), ("srv", True)):
        lowered = lower_model(model, CFG, (B, 64, 64, 3), post)
        for q in (None, "int8", "dynamic"):
            if post and q is None:
                continue
            files[kind, q] = write_tflite(
                lowered, str(root / f"{kind}_{q}.tflite"), q, rep, "cpu")
    return {"x": x, "files": files, "root": root}


# ---- (a) the file -----------------------------------------------------------

def test_quantization_round_trip():
    """A tensor's scales, zero points and axis written by ``Builder`` and
    read back by the parser, per tensor and per channel; the int8 and
    int32 constants' data."""
    b = Builder()
    x = b.tensor((1, 4), "FLOAT32", "x")
    scale = np.array([0.5, 0.25, 2.0**-20, 3.0], np.float32)
    zp = np.array([0, -7, 127, -128], np.int64)
    w = b.const(np.arange(-8, 8, dtype=np.int8).reshape(4, 4), "INT8",
                quant=(scale, zp, 1))
    bias = b.const(np.array([-(2**31), 2**31 - 1, 0, 5], np.int32), "INT32",
                   quant=(scale * 2, np.zeros(4, np.int64), 0))
    q = b.tensor((1, 4), "INT8", "q", quant=(
        np.array([0.1], np.float32), np.array([3], np.int64), 0))
    b.ops.append(["QUANTIZE", [x], [q], {}])
    # the parser reads operands whatever their operator
    b.ops.append(["DEQUANTIZE", [q, w, bias],
                  [b.tensor((1, 4), "FLOAT32")], {}])
    b.inputs, b.outputs = [x], [b.ops[-1][2][0]]
    f = TFLiteFile(bytes(b.serialize()))
    assert set(f.quant) == {q, w, bias}
    s, z, d = f.quant[q]
    assert s.tolist() == [np.float32(0.1)] and z.tolist() == [3] and d == 0
    np.testing.assert_array_equal(f.quant[w][0], scale)
    np.testing.assert_array_equal(f.quant[w][1], zp)
    assert f.quant[w][2] == 1 and f.quant[bias][2] == 0
    np.testing.assert_array_equal(f.quant[bias][0], scale * 2)
    np.testing.assert_array_equal(f.tensors[w][3], np.arange(
        -8, 8, dtype=np.int8).reshape(4, 4))
    assert f.tensors[bias][3].tolist() == [-(2**31), 2**31 - 1, 0, 5]
    assert f.tensors[w][2] == "INT8" and f.tensors[bias][2] == "INT32"


def test_quantized_file_read_through_tensorflows_schema(yolo, tf):
    """The int8 serving file read with TensorFlow's generated schema
    module: every tensor's type, scales, zero points and axis as the
    port's parser reads them, the operator versions the converter writes
    (``tflite_schema.INT8_OP_VERSION``), and the dynamic file's hybrid
    versions."""
    from tensorflow.lite.python import schema_py_generated as schema

    type_names = {v: k for k, v in vars(schema.TensorType).items()
                  if not k.startswith("_")}
    op_names = {v: k for k, v in vars(schema.BuiltinOperator).items()
                if not k.startswith("_")}
    for key in (("srv", "int8"), ("fwd", "dynamic")):
        with open(yolo["files"][key], "rb") as f:
            buf = f.read()
        ours = TFLiteFile(buf)
        m = schema.Model.GetRootAs(buf, 0)
        sg = m.Subgraphs(0)
        n_quant = 0
        for i, (_, _, ttype, _) in enumerate(ours.tensors):
            t = sg.Tensors(i)
            assert type_names[t.Type()] == ttype
            q = t.Quantization()
            if i not in ours.quant:
                assert q is None or q.ScaleLength() == 0
                continue
            n_quant += 1
            scale, zp, dim = ours.quant[i]
            np.testing.assert_array_equal(q.ScaleAsNumpy(), scale)
            np.testing.assert_array_equal(q.ZeroPointAsNumpy(), zp)
            assert q.QuantizedDimension() == dim
        versions = {}
        for i in range(m.OperatorCodesLength()):
            oc = m.OperatorCodes(i)
            versions[op_names[max(oc.BuiltinCode(),
                                  oc.DeprecatedBuiltinCode())]] = oc.Version()
        if key[1] == "int8":
            assert n_quant > 100 and "INT8" in {t[2] for t in ours.tensors}
            for name in ("QUANTIZE", "DEQUANTIZE", "CONV_2D",
                         "CONCATENATION", "MAX_POOL_2D",
                         "RESIZE_NEAREST_NEIGHBOR"):
                assert versions[name] == tflite_schema.INT8_OP_VERSION[name]
        else:
            assert versions["CONV_2D"] == 5
            assert 0 < n_quant < sum(op[0] == "CONV_2D" for op in ours.ops)


# ---- (b) int8 YOLOv3 against the interpreter --------------------------------

def _steps(path, got, want):
    """Each output's largest difference in steps of its int8 scale: an
    int8 output's codes, or the scale of the tensor a float output's
    DEQUANTIZE reads."""
    f = read_tflite(path)
    made = {outs[0]: ins[0] for name, ins, outs, _ in f.ops
            if name == "DEQUANTIZE"}
    steps = []
    for t, g, w in zip(f.outputs, got, want):
        s = float(f.quant[made.get(t, t)][0][0]) if t in made else 1.0
        steps.append(float(np.abs(g.astype(np.float64) - w).max() / s))
    return steps


def test_int8_forward_reader_equals_interpreter(yolo, tf):
    """The int8 forward file: the reader's dequantized heads equal the
    interpreter's (the same int8 codes); the file holds one QUANTIZE and
    a DEQUANTIZE a head. The default resolver (XNNPACK, which requantizes
    in float) differs from the reference kernels by one step an operator
    at most (``test_planted_case_reader_equals_interpreter``); through 35
    convolutions that reaches the heads as a few steps, which this test
    reports (measured 3, 4 and 5 steps on the three heads)."""
    path = yolo["files"]["fwd", "int8"]
    want = _interpret(tf, path, yolo["x"])
    got = _read(path, yolo["x"])
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    ops = inspect_tflite(path)["ops"]
    assert ops["QUANTIZE"] == 1 and ops["DEQUANTIZE"] == 3
    assert "RELU" not in ops  # fused into the convolutions
    steps = _steps(path, _interpret(tf, path, yolo["x"], resolver="AUTO"),
                   want)
    print(f"default resolver against the reference kernels: {steps} steps")


def test_int8_serving_reader_matches_interpreter(yolo, tf):
    """The int8 serving file: ``dets`` / ``valid`` keep their names, types
    and order; valid equal, dets within the float files' bound of the reader
    against the interpreter (atol 1e-5, boxes also 1e-5 of their size)."""
    path = yolo["files"]["srv", "int8"]
    (idets, ivalid) = _interpret(tf, path, yolo["x"])
    dets, valid = _read(path, yolo["x"])
    info = inspect_tflite(path)
    assert info["out_names"] == ["dets", "valid"]
    assert info["out_specs"] == [f"float32[{B},100,6]", f"bool[{B},100]"]
    np.testing.assert_array_equal(valid, ivalid)
    assert valid.any() and not valid.all()
    np.testing.assert_array_equal(dets[..., 5], idets[..., 5])
    np.testing.assert_allclose(dets[..., 4], idets[..., 4], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(dets[..., :4], idets[..., :4], atol=1e-5,
                               rtol=BOX_RTOL)
    assert info["ops"]["NON_MAX_SUPPRESSION_V5"] == B


def test_reader_suppresses_once_a_call(yolo, monkeypatch):
    """The int8 serving file's B suppressions go to ``greedy_suppress``
    once a call, as one batch."""
    import podtpu_torch.ops.kernels.nms_kernel as nk

    calls = []

    def spy(boxes, valid, thr):
        calls.append(tuple(boxes.shape))
        return greedy_suppress(boxes, valid, thr)

    monkeypatch.setattr(nk, "greedy_suppress", spy)
    load_tflite(yolo["files"]["srv", "int8"], "cpu")(
        torch.from_numpy(yolo["x"]))
    assert len(calls) == 1 and calls[0][0] == B


# ---- (d) dynamic range ------------------------------------------------------

def test_dynamic_reader_matches_interpreter(yolo, tf):
    """The dynamic-range forward file (int8 filters of at least 1,024
    elements, float compute): the hybrid reader against the interpreter,
    within 1e-5 of each head's scale (measured 0: the per-image input
    quantization is the interpreter's, rounding included), and the float
    serving file against the dynamic one's valid masks on the
    interpreter."""
    path = yolo["files"]["fwd", "dynamic"]
    want = _interpret(tf, path, yolo["x"])
    got = _read(path, yolo["x"])
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()
    srv = yolo["files"]["srv", "dynamic"]
    (idets, ivalid), (dets, valid) = _interpret(tf, srv, yolo["x"]), \
        _read(srv, yolo["x"])
    np.testing.assert_array_equal(valid, ivalid)
    np.testing.assert_allclose(dets[..., :4], idets[..., :4], atol=1e-5,
                               rtol=BOX_RTOL)


# the int8 and dynamic files' heads against the float file's, of each
# head's scale; chip_smoke.py holds the card's YOLOv3-416 files to it
QUANT_SHARE = 0.1


def test_quantized_heads_near_the_float_file(yolo):
    """The reader's int8 and dynamic heads against the float file's on the
    same input, within 0.1 of each head's largest magnitude (measured
    0.044 and 0.047 at most)."""
    want = _read(yolo["files"]["fwd", None], yolo["x"])
    for q in ("int8", "dynamic"):
        got = _read(yolo["files"]["fwd", q], yolo["x"])
        share = [float(np.abs(g - w).max() / np.abs(w).max())
                 for g, w in zip(got, want)]
        print(f"{q}: heads {share} of their scale from the float file's")
        assert len(share) == 3 and max(share) <= QUANT_SHARE


def test_file_sizes(yolo):
    """int8 and dynamic files are under 0.3x the float file (int8 filters
    are a quarter of float32 ones)."""
    size = {k: os.path.getsize(p) for k, p in yolo["files"].items()}
    assert size["fwd", "int8"] < 0.3 * size["fwd", None]
    assert size["fwd", "dynamic"] < 0.3 * size["fwd", None]


# ---- (c) against podtpu ----------------------------------------------------

V4T = {  # tests/test_export_tflite.py's config
    "model": "yolov4-tiny", "num_classes": 3, "input_size": 64,
    "in_channels": 3, "compute_dtype": "float32",
    "anchors": [[4, 5], [6, 8], [10, 9], [12, 16], [18, 14], [20, 24],
                [32, 28], [40, 44], [56, 52]],
    "conf_threshold": 0.05, "nms_iou_threshold": 0.45,
    "top_k_candidates": 64, "max_detections": 10, "optimizer": "sgd",
    "optimizer_options": {"lr": 1e-3}}
SHAPE = (1, 64, 64, 3)


def _int8_filters(tf, path):
    """The shapes of a file's int8 filters, as the interpreter lists
    them (sorted)."""
    it = tf.lite.Interpreter(model_path=path)
    return sorted(tuple(d["shape"]) for d in it.get_tensor_details()
                  if d["dtype"] == np.int8 and len(d["shape"]) >= 2)


def test_against_podtpu_yolov4_tiny(tf, tmp_path):
    """podtpu's own bounds on its YOLOv4-tiny 64 px config
    (``tests/test_export_tflite.py``): the port's int8 and dynamic heads
    within 0.15 of podtpu's float ``model.apply`` (and the interpreter's
    within 1e-5 of their scale of the reader's: measured 0), the int8
    file under half the float file; the dynamic file's int8 filters the
    same as in the dynamic file podtpu's converter writes."""
    from podtpu.export.tflite import export_tflite as podtpu_export
    from podtpu.models.factory import build_model as podtpu_build_model

    flat = podtpu_flat_weights(V4T, seed=4)
    variables = flax_variables(flat)
    jmodel = podtpu_build_model(V4T)
    model = load_flat_weights(build_model(V4T, "cpu"), flat).eval()
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 1, SHAPE).astype(np.float32)
    rep = [rng.uniform(0, 1, SHAPE).astype(np.float32) for _ in range(4)]
    want = [np.asarray(w) for w in jax.jit(
        lambda v, x: jmodel.apply(v, x, train=False))(variables,
                                                      jnp.asarray(x))]
    lowered = lower_model(model, V4T, SHAPE)
    paths = {q: write_tflite(lowered, str(tmp_path / f"{q}.tflite"), q, rep,
                             "cpu") for q in (None, "int8", "dynamic")}
    for q in ("int8", "dynamic"):
        got = _read(paths[q], x)
        errs = [float(np.abs(g - w).max()) for g, w in zip(got, want)]
        print(f"{q}: heads against podtpu's float apply {errs}")
        assert len(got) == 3 and max(errs) < 0.15
        # the interpreter runs the file and gives the reader's heads
        for g, i in zip(got, _interpret(tf, paths[q], x)):
            assert np.abs(g - i).max() <= 1e-5 * np.abs(i).max()
    assert os.path.getsize(paths["int8"]) < 0.5 * os.path.getsize(
        paths[None])
    theirs = podtpu_export(jmodel, variables, SHAPE,
                           str(tmp_path / "podtpu_dynamic.tflite"), cfg=V4T,
                           quantize="dynamic")
    mine = _int8_filters(tf, paths["dynamic"])
    assert mine == _int8_filters(tf, theirs) and mine
    assert (32, 3, 3, 3) not in mine  # the 864-element stem stays float


# ---- (e) planted cases ------------------------------------------------------

def _write(b: Builder, path) -> str:
    with open(path, "wb") as f:
        f.write(b.serialize())
    return str(path)


def _quantize_file(path) -> str:
    """float [1, 12] -> QUANTIZE (scale 0.5, zero point 3) -> int8: x / s
    at exact .5 ties of both signs, and saturation at both ends."""
    b = Builder()
    x = b.tensor((1, 12), "FLOAT32", "x")
    q = b.tensor((1, 12), "INT8", "q", quant=(
        np.array([0.5], np.float32), np.array([3], np.int64), 0))
    b.ops.append(["QUANTIZE", [x], [q], {}])
    b.versions["QUANTIZE"] = 1
    b.inputs, b.outputs = [x], [q]
    return _write(b, path)


TIES = np.array([[0.25, -0.25, 0.75, -0.75, 1.25, -1.25, 2.25, -2.25,
                  -65.25, 62.25, 1e3, -1e3]], np.float32)


class _Conv(torch.nn.Module):
    def __init__(self, k, cin, cout, seed, scale=1.0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.c = torch.nn.Conv2d(cin, cout, k, padding=k // 2)
        with torch.no_grad():
            self.c.weight.copy_(torch.randn(self.c.weight.shape, generator=g)
                                * scale)
            self.c.bias.copy_(torch.randn(cout, generator=g))

    def forward(self, x):
        return self.c(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class _Add(torch.nn.Module):
    def forward(self, x, y):
        return x + y


class _Leaky(torch.nn.Module):
    def forward(self, x):
        return torch.nn.functional.leaky_relu(x, 0.1)


def _planted(name, tmp_path):
    """(path, inputs) of a planted case: an int8 file of a small module,
    calibrated on one set of inputs and read on another."""
    rng = np.random.default_rng(7)
    if name == "quantize_ties":
        return _quantize_file(tmp_path / "ties.tflite"), [TIES]
    if name == "saturation":
        # calibrated on small inputs, read on large ones: the input and
        # the output saturate at both ends, some channels' multipliers
        # exceed 1 (a left shift)
        module = _Conv(1, 4, 8, 0, scale=20.0)
        calib = [rng.uniform(-0.1, 0.1, (1, 4, 4, 4)).astype(np.float32)]
        xs = [rng.uniform(-3, 3, (1, 4, 4, 4)).astype(np.float32)]
    elif name == "add_two_scales":
        module = _Add()
        calib = [rng.uniform(-1, 2, (1, 6, 6, 8)).astype(np.float32),
                 rng.uniform(-7, 0.5, (1, 6, 6, 8)).astype(np.float32)]
        xs = [rng.uniform(-1, 2, (1, 6, 6, 8)).astype(np.float32),
              rng.uniform(-7, 0.5, (1, 6, 6, 8)).astype(np.float32)]
    elif name == "leaky_alpha_side":
        module = _Leaky()
        calib = [rng.uniform(-3, 1, (1, 6, 6, 8)).astype(np.float32)]
        xs = [rng.uniform(-3, 1, (1, 6, 6, 8)).astype(np.float32)]
    else:  # same_conv_border: input zero point 64 - 128
        module = _Conv(3, 8, 16, 1)
        calib = [rng.uniform(-1, 3, (1, 6, 6, 8)).astype(np.float32)]
        xs = [rng.uniform(-1, 3, (1, 6, 6, 8)).astype(np.float32)]
    ep = torch.export.export(module, tuple(torch.from_numpy(c)
                                           for c in calib))
    b = lower_program(ep, name)
    full_integer(b, calibrate(b, [calib], "cpu"))
    return _write(b, tmp_path / f"{name}.tflite"), xs


def test_calibration_takes_the_exports_shape():
    """A calibration batch of another shape than the export's raises."""
    ep = torch.export.export(_Leaky(), (torch.zeros(1, 4, 4, 8),))
    b = lower_program(ep, "leaky")
    with pytest.raises(ValueError, match="input shape"):
        calibrate(b, [np.zeros((2, 4, 4, 8), np.float32)], "cpu")
    with pytest.raises(ValueError, match="representative"):
        calibrate(b, [], "cpu")


PLANTED = ["quantize_ties", "saturation", "add_two_scales",
           "leaky_alpha_side", "same_conv_border"]


@pytest.mark.parametrize("name", PLANTED)
def test_planted_case_reader_equals_interpreter(name, tf, tmp_path):
    """Each planted file on the interpreter and the reader: the same int8
    codes (dequantized outputs equal), and what each case plants is
    there. The default resolver differs from the reference kernels by at
    most one step on each of these one-operator files."""
    path, xs = _planted(name, tmp_path)
    want = _interpret(tf, path, *xs)
    got = _read(path, *xs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    steps = _steps(path, _interpret(tf, path, *xs, resolver="AUTO"), want)
    print(f"{name}: default resolver {steps} steps from the reference")
    assert max(steps) <= 1.0 + 1e-6
    f = read_tflite(path)
    ops = [op[0] for op in f.ops]
    if name == "quantize_ties":
        # std::round: ties away from zero; then the zero point and clamp
        assert want[0].tolist() == [[4, 2, 5, 1, 6, 0, 8, -2, -128, 127,
                                     127, -128]]
    elif name == "saturation":
        q = _interpret(tf, path, *xs)[0]
        s = f.quant[[op for op in f.ops if op[0] == "CONV_2D"][0][2][0]]
        codes = np.round(q / s[0][0]).astype(int) + int(s[1][0])
        assert codes.min() == -128 and codes.max() == 127
    elif name == "add_two_scales":
        add = [op for op in f.ops if op[0] == "ADD"][0]
        assert f.tensors[add[1][0]][2] == "INT8"
        assert f.quant[add[1][0]][0][0] != f.quant[add[1][1]][0][0]
    elif name == "leaky_alpha_side":
        assert "LEAKY_RELU" in ops and (xs[0] < 0).any()
        assert (want[0] < 0).any()
    else:
        conv = [op for op in f.ops if op[0] == "CONV_2D"][0]
        assert conv[3]["padding"] == tflite_schema.PADDING["SAME"]
        assert int(f.quant[conv[1][0]][1][0]) != 0


def _half_even(x):
    return torch.round(x)


def _im2col_zero_pad(x, kh, kw, stride, dilation, pads, pad_value):
    from podtpu_torch.ops.int8_conv import int8_im2col_nhwc

    return int8_im2col_nhwc(x, kh, kw, stride, dilation, pads, 0)


@pytest.mark.parametrize("fault,case,attr,fn", [
    ("half_to_even", "quantize_ties", "round_half_away", _half_even),
    ("im2col_zero_pad", "same_conv_border", "int8_im2col_nhwc",
     _im2col_zero_pad)])
def test_planted_faults_fail(fault, case, attr, fn, tf, tmp_path,
                             monkeypatch):
    """Half-to-even rounding in ``QUANTIZE`` and an im2col padded with 0
    under a non-zero input zero point: the reader then disagrees with the
    interpreter (at the ties; at the convolution's border pixels only)."""
    path, xs = _planted(case, tmp_path)
    want = _interpret(tf, path, *xs)
    monkeypatch.setattr(tflite_int8, attr, fn)
    got = _read(path, *xs)
    diff = np.abs(got[0].astype(np.float64) - want[0]) > 0
    assert diff.any()
    if fault == "im2col_zero_pad":
        inner = diff[:, 1:-1, 1:-1, :]
        assert not inner.any()


# ---- (g) the CLI ------------------------------------------------------------

@pytest.mark.parametrize("mode", ["int8", "dynamic"])
def test_cli_export_quantized_then_test_artifact(mode, tmp_path, capsys):
    """``cli.export_model --format tflite --with-postprocess --quantize
    int8 --calib-batches 2`` (or ``dynamic``) on fabricated VOC data, then
    ``cli.test --artifact q.tflite --device cpu``: it runs and prints its
    mAP beside ``--ckpt``'s."""
    from podtpu_torch.cli import export_model as cli_export
    from podtpu_torch.cli import test as cli_test

    cfg_path, ckpt, root = fake_voc_run(tmp_path)
    art = str(tmp_path / "q.tflite")
    extra = ["--calib-batches", "2"] if mode == "int8" else []
    cli_export.main(["--cfg", cfg_path, "--ckpt", ckpt, "--format",
                     "tflite", "--with-postprocess", "--batch", "2",
                     "--quantize", mode, "--out", art, "--device", "cpu",
                     "--inspect"] + extra)
    out = capsys.readouterr().out
    assert '"NON_MAX_SUPPRESSION_V5": 2' in out and '"INT8"' in out
    assert ("int8 PTQ: calibrated on 2 batches" in out) == (mode == "int8")
    assert read_tflite(art).meta["quantize"] == mode
    got = cli_test.main(["--cfg", cfg_path, "--artifact", art, "--device",
                         "cpu"])
    want = cli_test.main(["--cfg", cfg_path, "--ckpt", ckpt, "--device",
                          "cpu"])
    print(f"{mode} artifact val_mAP {got['val_mAP']} beside --ckpt "
          f"{want['val_mAP']}")
    assert 0.0 <= got["val_mAP"] <= 1.0 and 0.0 <= want["val_mAP"] <= 1.0
