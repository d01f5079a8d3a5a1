"""The hand-written TFLite export and the port's reader (CPU, float32,
YOLOv3 at 64 px on 3 classes, seeded weights from podtpu's flat layout).

TensorFlow's ``tf.lite.Interpreter`` is the oracle of the file: it runs
the port's ``.tflite`` against podtpu's ``model.apply`` and
``make_postprocess`` on JAX:CPU (podtpu's own tolerances,
``tests/test_export_tflite.py``), and the port's reader
(``load_tflite(device="cpu")``) against the interpreter on the same file.
TensorFlow is imported once, in one fixture; the tests that do not need
it do not ask for it."""

import os
import struct

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from podtpu.models.factory import build_model as podtpu_build_model
from podtpu.train.steps import make_postprocess
from podtpu_torch.export import flatbuf, tflite_schema
from podtpu_torch.export.runner import artifact_runner
from podtpu_torch.export.tflite import (
    TFLiteFile,
    export_tflite,
    inspect_tflite,
    load_tflite,
    read_tflite,
)
from podtpu_torch.export.tflite_lower import lower_program
from podtpu_torch.export.weights import load_flat_weights
from podtpu_torch.models.factory import build_model
from podtpu_torch.ops.kernels.nms_kernel import (
    greedy_suppress,
    greedy_suppress_reference,
)
from podtpu_torch.train.steps import make_serve_fn
from tests.torch_parity import (
    fake_voc_run,
    flax_variables,
    podtpu_flat_weights,
    yolo_cfg,
)

CFG = yolo_cfg(num_classes=3)
B = 2


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Six workers share the cores: two intra-op threads each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def tf():
    tf = pytest.importorskip("tensorflow")
    return tf


def _interpret(tf, path, *xs):
    """Run a ``.tflite`` on TensorFlow's interpreter: its outputs in the
    file's order, and their names."""
    it = tf.lite.Interpreter(model_path=path)
    it.allocate_tensors()
    for d, x in zip(it.get_input_details(), xs):
        it.set_tensor(d["index"], np.asarray(x))
    it.invoke()
    outs = it.get_output_details()
    return [it.get_tensor(d["index"]) for d in outs], [d["name"] for d in
                                                       outs]


@pytest.fixture(scope="module")
def yolo(tmp_path_factory):
    """podtpu's model and variables, the port's model on the same seeded
    weights, an input batch, and the forward and serving ``.tflite``
    files."""
    root = tmp_path_factory.mktemp("tflite")
    flat = podtpu_flat_weights(CFG, seed=3)
    model = load_flat_weights(build_model(CFG, "cpu"), flat).eval()
    x = np.random.default_rng(0).uniform(0, 1, (B, 64, 64, 3)).astype(
        np.float32)
    fwd = export_tflite(model, CFG, (B, 64, 64, 3), str(root / "f.tflite"))
    srv = export_tflite(model, CFG, (B, 64, 64, 3), str(root / "s.tflite"),
                        with_postprocess=True)
    jmodel = podtpu_build_model(CFG)
    heads = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        flax_variables(flat), jnp.asarray(x))
    return {"model": model, "x": x, "fwd": fwd, "srv": srv, "heads": heads,
            "root": root}


# ---- (a) the flatbuffer -----------------------------------------------------

def test_flatbuf_round_trip():
    """Every kind the writer has, read back: scalars of each width,
    vectors (a 16-byte-aligned one among them), strings, nested tables
    and a vector of tables; an absent slot reads as its default."""
    big = np.arange(1000, dtype=np.float32) / 7
    inner = [flatbuf.Table({0: flatbuf.String(f"t{i}"),
                            1: flatbuf.Scalar("int32", -i)}) for i in range(3)]
    root = flatbuf.Table({
        0: flatbuf.Scalar("uint32", 3), 1: flatbuf.Scalar("int8", -5),
        2: flatbuf.Scalar("bool", True), 3: flatbuf.Scalar("float32", 0.25),
        4: flatbuf.Scalar("int64", -(1 << 40)),
        5: flatbuf.Vector(big, align=16), 6: flatbuf.Vector([1, -2, 3],
                                                             np.int32),
        7: flatbuf.String("héllo"), 8: inner,
        9: flatbuf.Table({0: flatbuf.Scalar("uint8", 7)}),
        11: flatbuf.Vector(np.zeros(0, np.int32))})
    buf = bytes(flatbuf.serialize(root, b"TEST"))
    v = flatbuf.root(buf, b"TEST")
    assert v.scalar(0, "uint32") == 3 and v.scalar(1, "int8") == -5
    assert v.scalar(2, "bool") is True and v.scalar(3, "float32") == 0.25
    assert v.scalar(4, "int64") == -(1 << 40)
    got = v.vector(5, np.float32)
    np.testing.assert_array_equal(got, big)
    assert struct.unpack_from("<I", buf, v._deref(v._at(5)))[0] == 1000
    assert (v._deref(v._at(5)) + 4) % 16 == 0
    assert v.vector(6, np.int32).tolist() == [1, -2, 3]
    assert v.string(7) == "héllo"
    assert [(t.string(0), t.scalar(1, "int32")) for t in v.tables(8)] == [
        ("t0", 0), ("t1", -1), ("t2", -2)]
    assert v.table(9).scalar(0, "uint8") == 7
    assert v.vector(11, np.int32).size == 0
    assert not v.has(10) and v.scalar(10, "int32", 42) == 42
    assert v.scalar(40, "int32", -1) == -1  # past the vtable
    with pytest.raises(ValueError, match="TFL3"):
        flatbuf.root(buf, b"TFL3")


def _camel(name: str) -> str:
    return "".join(p.capitalize() for p in name.split("_"))


def test_file_read_through_tensorflows_schema(yolo, tf):
    """The serving file read field by field with TensorFlow's generated
    schema module (an independent reader of the slots and codes): model
    version, operator codes, every tensor's shape, type, buffer and name,
    every operator's inputs, outputs, options table and option fields,
    the metadata, as the port's reader sees them."""
    from tensorflow.lite.python import schema_py_generated as schema

    with open(yolo["srv"], "rb") as f:
        buf = f.read()
    ours = TFLiteFile(buf)
    assert schema.Model.ModelBufferHasIdentifier(buf, 0)
    m = schema.Model.GetRootAs(buf, 0)
    assert m.Version() == ours.version == 3
    codes = [max(m.OperatorCodes(i).BuiltinCode(),
                 m.OperatorCodes(i).DeprecatedBuiltinCode())
             for i in range(m.OperatorCodesLength())]
    sg = m.Subgraphs(0)
    assert sg.TensorsLength() == len(ours.tensors)
    type_names = {v: k for k, v in vars(schema.TensorType).items()
                  if not k.startswith("_")}
    for i, (name, shape, ttype, data) in enumerate(ours.tensors):
        t = sg.Tensors(i)
        assert t.Name().decode() == name
        assert tuple(t.ShapeAsNumpy()) == shape if shape else \
            t.ShapeLength() == 0
        assert type_names[t.Type()] == ttype
        raw = m.Buffers(t.Buffer())
        if data is None:
            assert raw.DataLength() == 0
        else:
            np.testing.assert_array_equal(
                raw.DataAsNumpy().view(data.dtype).reshape(shape), data)
    assert sg.InputsAsNumpy().tolist() == ours.inputs
    assert sg.OutputsAsNumpy().tolist() == ours.outputs
    op_names = {v: k for k, v in vars(schema.BuiltinOperator).items()
                if not k.startswith("_")}
    opt_names = {v: k for k, v in vars(schema.BuiltinOptions).items()
                 if not k.startswith("_")}
    assert sg.OperatorsLength() == len(ours.ops)
    seen = set()
    for i, (name, ins, outs, opts) in enumerate(ours.ops):
        op = sg.Operators(i)
        assert op_names[codes[op.OpcodeIndex()]] == name
        assert op.InputsAsNumpy().tolist() == ins
        assert op.OutputsAsNumpy().tolist() == outs
        table = tflite_schema.OP_OPTIONS[name]
        if table is None:
            assert op.BuiltinOptionsType() == 0
            continue
        assert opt_names[op.BuiltinOptionsType()] == table
        gen = getattr(schema, table)()
        gen.Init(op.BuiltinOptions().Bytes, op.BuiltinOptions().Pos)
        for field, value in opts.items():
            assert getattr(gen, _camel(field))() == value, (name, field)
        seen.add(name)
    assert {"CONV_2D", "MAX_POOL_2D", "STRIDED_SLICE", "TOPK_V2",
            "NON_MAX_SUPPRESSION_V5", "GATHER_ND", "ARG_MAX"} <= {
                op[0] for op in ours.ops}
    assert {"CONV_2D", "MAX_POOL_2D", "STRIDED_SLICE", "ARG_MAX"} <= seen
    md = {m.Metadata(i).Name().decode(): m.Metadata(i).Buffer()
          for i in range(m.MetadataLength())}
    assert ours.meta["kind"] == "serving" and "podtpu_torch" in md


# ---- (b)-(d) YOLOv3 against podtpu and the interpreter ----------------------

def test_forward_tflite_matches_podtpu(yolo, tf):
    """The forward file on the interpreter against podtpu's
    ``model.apply`` on JAX:CPU, atol 1e-4 (podtpu's own bound); its
    heads come out NHWC, named, in podtpu's order."""
    outs, names = _interpret(tf, yolo["fwd"], yolo["x"])
    want = yolo["heads"]
    assert names == ["head0", "head1", "head2"] and len(want) == 3
    for g, w in zip(outs, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-4)


@pytest.fixture(scope="module")
def served(yolo, tf):
    """The serving file on the interpreter, podtpu's postprocess on its
    own forward, and the port's reader on the CPU."""
    got, names = _interpret(tf, yolo["srv"], yolo["x"])
    want = jax.jit(make_postprocess(CFG))(yolo["heads"])
    return {"interp": got, "names": names,
            "podtpu": [np.asarray(a) for a in want],
            "reader": [a.numpy() for a in load_tflite(
                yolo["srv"], "cpu")(torch.from_numpy(yolo["x"]))]}


# Boxes reach 2.6e3 px at these random weights (exp of the wh logits),
# where float32's spacing is 2.4e-4 and the two forwards' rounding (about
# 1e-5 in a logit) moves a box by a few 1e-3: box coordinates are also
# held to 1e-5 of their size (measured 5.0e-6 against podtpu, 4.8e-6
# between the reader and the interpreter). Scores and classes are held
# to the absolute bound alone.
BOX_RTOL = 1e-5


def _dets_close(got, want, atol):
    np.testing.assert_array_equal(got[..., 5], want[..., 5])
    np.testing.assert_allclose(got[..., 4], want[..., 4], atol=atol, rtol=0)
    np.testing.assert_allclose(got[..., :4], want[..., :4], atol=atol,
                               rtol=BOX_RTOL)


def test_serving_tflite_matches_podtpu(served):
    """dets ``[B, max_det, 6]`` float32 first, valid ``[B, max_det]`` bool
    second, against podtpu's ``make_postprocess(model.apply)``: valid
    exact, dets atol 1e-3 (podtpu's own bounds; boxes also 1e-5 of their
    size, :data:`BOX_RTOL`)."""
    (dets, valid), (wd, wv) = served["interp"], served["podtpu"]
    assert served["names"] == ["dets", "valid"]
    assert dets.shape == (B, 100, 6) and dets.dtype == np.float32
    assert valid.shape == (B, 100) and valid.dtype == np.bool_
    assert valid.any() and not valid.all()
    np.testing.assert_array_equal(valid, wv)
    _dets_close(dets, wd, 1e-3)


def test_reader_matches_interpreter_and_in_process(yolo, served):
    """``load_tflite(device="cpu")`` on the same file: against the
    interpreter, atol 1e-5 and valid exact; against the port's in-process
    ``make_serve_fn``, likewise (boxes also 1e-5 of their size,
    :data:`BOX_RTOL`)."""
    (dets, valid), (idets, ivalid) = served["reader"], served["interp"]
    np.testing.assert_array_equal(valid, ivalid)
    _dets_close(dets, idets, 1e-5)
    wd, wv = make_serve_fn(CFG, yolo["model"])(torch.from_numpy(yolo["x"]))
    np.testing.assert_array_equal(valid, wv.numpy())
    _dets_close(dets, wd.numpy(), 1e-5)


def test_reader_runs_the_suppression_through_greedy_suppress(yolo,
                                                             monkeypatch):
    """The B suppressions of one call go to ``greedy_suppress`` once, as
    one batch of B images."""
    import podtpu_torch.ops.kernels.nms_kernel as nk

    calls = []

    def spy(boxes, valid, thr):
        calls.append(tuple(boxes.shape))
        return greedy_suppress(boxes, valid, thr)

    monkeypatch.setattr(nk, "greedy_suppress", spy)
    prog = load_tflite(yolo["srv"], "cpu")
    prog(torch.from_numpy(yolo["x"]))
    assert len(calls) == 1 and calls[0][0] == B
    ops = inspect_tflite(yolo["srv"])["ops"]
    assert ops["NON_MAX_SUPPRESSION_V5"] == B


def test_fold_and_layout(yolo, tf):
    """The file holds one CONV_2D a conv (BN's multiply-add folded into
    its filter and bias) and no TRANSPOSE in the forward; unfolded, the
    interpreter's heads move by at most 5e-6 of their scale (measured
    2.2e-6: the folding's error is the size of the two forwards')."""
    info = inspect_tflite(yolo["fwd"])
    assert info["ops"]["CONV_2D"] == 35 and "MUL" not in info["ops"]
    assert "TRANSPOSE" not in info["ops"]
    assert info["in_specs"] == [f"float32[{B},64,64,3]"]
    from podtpu_torch.export.program import export_forward
    from podtpu_torch.export.tflite_lower import _Lowerer

    unfolded = _Lowerer(export_forward(yolo["model"], (B, 64, 64, 3))[0],
                        "yolov3").run()
    unfolded.prune()
    assert sum(op[0] == "MUL" for op in unfolded.ops) == 32
    ep_path = str(yolo["root"] / "unfolded.tflite")
    with open(ep_path, "wb") as f:
        f.write(unfolded.serialize())
    folded, _ = _interpret(tf, yolo["fwd"], yolo["x"])
    plain, _ = _interpret(tf, ep_path, yolo["x"])
    for a, b in zip(folded, plain):
        assert np.abs(a - b).max() <= 5e-6 * np.abs(b).max()
    os.remove(ep_path)


# ---- (f) planted suppression and ties ---------------------------------------

class _Suppress(torch.nn.Module):
    def __init__(self, thr):
        super().__init__()
        self.thr = thr

    def forward(self, boxes, valid):
        return greedy_suppress(boxes, valid, self.thr)


def _suppression_file(path, boxes, valid, thr):
    ep = torch.export.export(_Suppress(thr), (boxes, valid))
    b = lower_program(ep, "nms")
    with open(path, "wb") as f:
        f.write(b.serialize())
    return path


def _planted():
    """[2, 6] candidates, score-sorted xyxy: image 0 has a pair at IoU
    exactly 0.5 (4 x 1 and 2 x 1 boxes sharing a side), a pair above it,
    two identical zero-area boxes and a box inside another; image 1 has
    two valid candidates that overlap and four invalid ones."""
    boxes = torch.tensor([
        [[0, 0, 4, 1], [0, 0, 2, 1], [10, 10, 20, 20], [11, 10, 20, 20],
         [30, 30, 30, 35], [30, 30, 30, 35]],
        [[0, 0, 10, 10], [1, 1, 10, 10], [0, 0, 10, 10], [50, 50, 60, 60],
         [0, 0, 1, 1], [0, 0, 1, 1]]], dtype=torch.float32)
    valid = torch.tensor([[True] * 6, [True, True] + [False] * 4])
    return boxes, valid


@pytest.mark.parametrize("thr", [0.5, 0.45, 0.9])
def test_planted_suppression_on_the_interpreter(tf, tmp_path, thr):
    """The lowered suppression on the interpreter against
    ``greedy_suppress_reference``: a pair at IoU exactly 0.5 (kept at
    0.5, TFLite's ``>=`` against the float after the threshold; removed
    at 0.45), identical zero-area boxes (never suppressed), a second
    image with 2 valid of 6, and an image with none; the reader gives
    the same masks."""
    boxes, valid = _planted()
    path = _suppression_file(str(tmp_path / "nms.tflite"), boxes, valid, thr)
    want = greedy_suppress_reference(boxes, valid, thr)
    (got,), _ = _interpret(tf, path, boxes.numpy(), valid.numpy())
    np.testing.assert_array_equal(got, want.numpy())
    assert bool(want[0, 1]) == (thr >= 0.5)
    assert want[0, 4] and want[0, 5]  # zero area: both kept
    np.testing.assert_array_equal(load_tflite(path, "cpu")(
        boxes, valid).numpy(), want.numpy())
    none = torch.zeros_like(valid)
    (got,), _ = _interpret(tf, path, boxes.numpy(), none.numpy())
    assert not got.any()


def test_suppression_deviation_at_the_union_epsilon(tf, tmp_path):
    """Where the file and the port differ, as ``export/tflite.py`` says:
    two identical boxes of area 1e-6 have IoU 1 for TFLite and
    1e-6 / (1e-6 + 1e-6) = 0.5 for the port (its 1e-6 in the union), so
    at a threshold of 0.6 the interpreter suppresses the second and the
    port keeps it; the reader gives the port's answer."""
    boxes = torch.tensor([[[0, 0, 1e-3, 1e-3], [0, 0, 1e-3, 1e-3]]],
                         dtype=torch.float32)
    valid = torch.ones((1, 2), dtype=torch.bool)
    path = _suppression_file(str(tmp_path / "eps.tflite"), boxes, valid, 0.6)
    (got,), _ = _interpret(tf, path, boxes.numpy(), valid.numpy())
    want = greedy_suppress_reference(boxes, valid, 0.6)
    assert got.tolist() == [[True, False]]
    assert want.tolist() == [[True, True]]
    assert torch.equal(load_tflite(path, "cpu")(boxes, valid), want)


class _TopK(torch.nn.Module):
    def forward(self, x):
        values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
        return values[..., :4], idx[..., :4]


def test_topk_keeps_the_lower_index_on_ties(tf, tmp_path):
    """``sort(stable) + [..., :k]`` lowers to one ``TOPK_V2``; with planted
    equal scores the interpreter and the reader keep the lower index
    first, as the port's ``_top``."""
    x = torch.tensor([[0.5, 0.9, 0.5, 0.9, 0.1, 0.5, -1.0, -1.0],
                      [-1.0] * 8])
    ep = torch.export.export(_TopK(), (x,))
    b = lower_program(ep, "topk")
    assert [op[0] for op in b.ops] == ["TOPK_V2"]
    path = str(tmp_path / "topk.tflite")
    with open(path, "wb") as f:
        f.write(b.serialize())
    want = _TopK()(x)
    (vals, idx), _ = _interpret(tf, path, x.numpy())
    np.testing.assert_array_equal(vals, want[0].numpy())
    np.testing.assert_array_equal(idx, want[1].numpy())
    assert idx[0].tolist() == [1, 3, 0, 2] and idx[1].tolist() == [0, 1, 2, 3]
    got = load_tflite(path, "cpu")(x)
    assert torch.equal(got[1].long(), want[1])


# ---- (g) the runner and the CLIs --------------------------------------------

def test_artifact_runner_takes_tflite(yolo, served):
    """``artifact_runner`` runs a serving ``.tflite`` on the device it is
    given and rejects the forward file."""
    run, batch = artifact_runner(yolo["srv"], "cpu")
    dets, valid = run(yolo["x"])
    assert batch == B
    np.testing.assert_array_equal(valid, served["reader"][1])
    np.testing.assert_array_equal(dets, served["reader"][0])
    with pytest.raises(ValueError, match="with-postprocess"):
        artifact_runner(yolo["fwd"], "cpu")


def test_refusals(yolo, tmp_path):
    """``--quantize`` now writes a quantized file (item 10b; the files
    themselves: ``tests/test_torch_tflite_quant.py``); ``--batch dyn``
    refused for TFLite (a static batch, as podtpu), an unknown mode and an
    int8 export without calibration batches refused, a ``.savedmodel``
    refused, a file that is not TFLite refused, and an unlowered ATen
    target named."""
    from podtpu_torch.cli import export_model as cli_export
    from podtpu_torch.export.runner import TFLITE_UNPORTED

    x = yolo["x"][:1]
    q = export_tflite(yolo["model"], CFG, (1, 64, 64, 3),
                      str(tmp_path / "q.tflite"), quantize="int8",
                      rep_batches=[x])
    assert "INT8" in inspect_tflite(q)["tensor_types"]
    with pytest.raises(ValueError, match="rep_batches"):
        export_tflite(yolo["model"], CFG, (1, 64, 64, 3), "x.tflite",
                      quantize="int8")
    with pytest.raises(ValueError, match="unknown quantize mode"):
        export_tflite(yolo["model"], CFG, (1, 64, 64, 3), "x.tflite",
                      quantize="int4")
    with pytest.raises(ValueError, match="static batch"):
        export_tflite(yolo["model"], CFG, (None, 64, 64, 3), "x.tflite")
    for argv in (["--batch", "dyn"], ["--batch", "dyn", "--quantize",
                                      "dynamic"]):
        with pytest.raises(SystemExit):
            cli_export.main(["--cfg", "configs/yolov3_voc.yaml", "--format",
                             "tflite", "--out", "x.tflite"] + argv)
    with pytest.raises(NotImplementedError, match="SavedModel"):
        cli_export.main(["--cfg", "configs/yolov3_voc.yaml", "--format",
                         "savedmodel"])
    with pytest.raises(NotImplementedError, match="SavedModel"):
        artifact_runner("m.savedmodel")
    assert "10c" in TFLITE_UNPORTED and "quantized" not in TFLITE_UNPORTED
    bad = tmp_path / "bad.tflite"
    bad.write_bytes(b"\x08\0\0\0NOPE" + b"\0" * 16)
    with pytest.raises(ValueError, match="TFL3"):
        read_tflite(str(bad))

    class Odd(torch.nn.Module):
        def forward(self, x):
            return torch.cummax(x, 1)[0]

    ep = torch.export.export(Odd(), (torch.zeros(1, 4),))
    with pytest.raises(NotImplementedError, match="odd: ATen target "
                                                  "aten.cummax"):
        lower_program(ep, "odd")


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    """A fabricated VOCdevkit converted to YOLO lists, a YOLOv4-tiny
    config at 64 px on it, and a checkpoint of seeded weights."""
    return fake_voc_run(tmp_path_factory.mktemp("voc"))


def test_cli_export_tflite_then_test_artifact(voc, capsys, monkeypatch):
    """``cli.export_model --format tflite --with-postprocess --fold-bn``
    then ``cli.test --artifact x.tflite --device cpu`` on the fabricated
    VOC val images, against ``cli.test --ckpt`` on the same weights: the
    val mAP to 1e-6, and each batch both hand the host mAP (annotations
    equal, valid masks equal, detections as :func:`_dets_close` at
    1e-5), some of them valid; ``cli.exported_inference`` times it."""
    from podtpu_torch.cli import export_model as cli_export
    from podtpu_torch.cli import exported_inference as cli_bench
    from podtpu_torch.cli import test as cli_test
    from podtpu_torch.metrics.map import MeanAveragePrecision

    cfg_path, ckpt, root = voc
    art = str(root / "v4tiny.tflite")
    cli_export.main(["--cfg", cfg_path, "--ckpt", ckpt, "--format", "tflite",
                     "--with-postprocess", "--fold-bn", "--batch", "2",
                     "--out", art, "--device", "cpu", "--inspect"])
    assert '"NON_MAX_SUPPRESSION_V5": 2' in capsys.readouterr().out
    real = MeanAveragePrecision.update_state
    fed = {"artifact": [], "ckpt": []}

    def recording(into):
        def update_state(self, annots, dets, valid):
            into.append([np.array(a) for a in (annots, dets, valid)])
            return real(self, annots, dets, valid)
        return update_state

    monkeypatch.setattr(MeanAveragePrecision, "update_state",
                        recording(fed["artifact"]))
    got = cli_test.main(["--cfg", cfg_path, "--artifact", art, "--device",
                         "cpu"])
    monkeypatch.setattr(MeanAveragePrecision, "update_state",
                        recording(fed["ckpt"]))
    want = cli_test.main(["--cfg", cfg_path, "--ckpt", ckpt, "--device",
                          "cpu"])
    assert got["val_mAP"] == pytest.approx(want["val_mAP"], abs=1e-6)
    assert len(fed["artifact"]) == len(fed["ckpt"]) == 2
    for (ga, gd, gv), (wa, wd, wv) in zip(fed["artifact"], fed["ckpt"]):
        np.testing.assert_array_equal(ga, wa)
        np.testing.assert_array_equal(gv, wv)
        _dets_close(gd[gv], wd[wv], 1e-5)
    assert sum(int(v.sum()) for _, _, v in fed["artifact"]) > 0
    res = cli_bench.bench(art, iters=2, warmup=1, device="cpu")
    assert res["batch"] == 2 and res["device"] == "cpu" and res["ms"] > 0


@pytest.mark.cuda
def test_reader_on_the_card_launches_the_kernel_once(yolo):
    """On the card the reader's suppression is the CUDA kernel, one
    launch a call, and its masks and boxes are the CPU reader's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    x = torch.from_numpy(yolo["x"])
    prog = load_tflite(yolo["srv"])
    assert prog.device.type == "cuda"
    before = greedy_suppress.launches
    dets, valid = prog(x)
    torch.cuda.synchronize()
    assert greedy_suppress.launches == before + 1
    cd, cv = load_tflite(yolo["srv"], "cpu")(x)
    assert torch.equal(valid.cpu(), cv)
    torch.testing.assert_close(dets.cpu(), cd, atol=1e-4, rtol=0)
