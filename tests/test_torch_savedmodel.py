"""The hand-written TF SavedModel export and the port's reader (CPU,
float32, YOLOv3 at 64 px on 3 classes, seeded weights from podtpu's flat
layout).

TensorFlow is the oracle of the file: its own protos parse the bytes,
``tf.saved_model.load(...).signatures["serving_default"]`` runs the
port's SavedModel against podtpu's ``model.apply`` and
``make_postprocess`` on JAX:CPU (podtpu's own tolerance,
``tests/test_export_tflite.py``), and the port's reader
(``load_savedmodel(device="cpu")``) runs against TensorFlow on the same
file. podtpu's own ``export_savedmodel`` is run once, for its signature
and the reader's refusal. TensorFlow is imported once, in one fixture."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from podtpu.models.factory import build_model as podtpu_build_model
from podtpu.train.steps import make_postprocess
from podtpu_torch.export import protobuf
from podtpu_torch.export import savedmodel_schema as S
from podtpu_torch.export.runner import artifact_runner
from podtpu_torch.export.savedmodel import (
    export_savedmodel,
    inspect_savedmodel,
    load_savedmodel,
    read_savedmodel,
    write_savedmodel,
)
from podtpu_torch.export.tflite_lower import lower_program
from podtpu_torch.export.weights import load_flat_weights
from podtpu_torch.models.factory import build_model
from podtpu_torch.ops.kernels.nms_kernel import (
    greedy_suppress,
    greedy_suppress_reference,
)
from podtpu_torch.train.steps import make_serve_fn
from tests.test_torch_tflite import _TopK, _dets_close, _planted, _Suppress
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
    return pytest.importorskip("tensorflow")


def _serve(tf, path, **inputs):
    """The ``serving_default`` signature of the SavedModel at ``path`` on
    TensorFlow: its outputs in ``output_i`` order."""
    fn = tf.saved_model.load(path).signatures["serving_default"]
    out = fn(**{k: tf.constant(v) for k, v in inputs.items()})
    keys = sorted(out, key=lambda k: int(k.rsplit("_", 1)[1]))
    return [out[k].numpy() for k in keys], keys


@pytest.fixture(scope="module")
def yolo(tmp_path_factory):
    """podtpu's heads, the port's model on the same seeded weights, an
    input batch, and the forward and serving SavedModels."""
    root = tmp_path_factory.mktemp("savedmodel")
    flat = podtpu_flat_weights(CFG, seed=3)
    model = load_flat_weights(build_model(CFG, "cpu"), flat).eval()
    x = np.random.default_rng(0).uniform(0, 1, (B, 64, 64, 3)).astype(
        np.float32)
    fwd = export_savedmodel(model, CFG, (B, 64, 64, 3), str(root / "f"))
    srv = export_savedmodel(model, CFG, (B, 64, 64, 3),
                            str(root / "s.savedmodel"), with_postprocess=True)
    jmodel = podtpu_build_model(CFG)
    variables = flax_variables(flat)
    heads = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        variables, jnp.asarray(x))
    return {"model": model, "x": x, "fwd": fwd, "srv": srv, "heads": heads,
            "root": root, "jmodel": jmodel, "variables": variables}


# ---- (a) the wire format ----------------------------------------------------

def test_protobuf_round_trip():
    """Every kind the writer has, read back by the port's reader:
    varints (a negative int64 as ten bytes), zigzag, floats, strings,
    a numpy array taken as a ``bytes`` field without a copy, packed
    repeated fields, nested messages and a map; absent fields read as
    their defaults; a record cut short refused."""
    big = np.arange(1000, dtype=np.float32) / 7
    inner = protobuf.Message().varint(1, 7).bytes(2, "héllo")
    m = (protobuf.Message().varint(1, 150).varint(2, -3)
         .varint(3, protobuf.zigzag(-2)).float(4, 0.25).bytes(5, big)
         .packed(6, [1, -2, 300]).packed(7, []).message(8, inner)
         .message(8, protobuf.Message()).entry(9, "k", inner)
         .bool(10, True))
    assert any(np.shares_memory(np.frombuffer(c, np.uint8), big)
               for c in m.chunks if isinstance(c, memoryview))
    buf = m.tobytes()
    assert len(buf) == m.size
    assert protobuf.varint(150) == b"\x96\x01"
    assert len(protobuf.varint(-3)) == 10
    assert [protobuf.zigzag(n) for n in (0, -1, 1, -2)] == [0, 1, 2, 3]
    assert protobuf.unzigzag(protobuf.zigzag(-(1 << 40))) == -(1 << 40)
    f = protobuf.Fields(buf)
    assert f.int(1) == 150 and f.int(2) == -3
    assert protobuf.unzigzag(f.int(3)) == -2
    assert f.float(4) == 0.25 and f.bool(10)
    got = np.frombuffer(f.bytes(5), np.float32)
    np.testing.assert_array_equal(got, big)
    assert f.ints(6) == [1, -2, 300] and not f.has(7)
    a, b = f.messages(8)
    assert a.int(1) == 7 and a.str(2) == "héllo" and not b.has(1)
    assert f.map(9)["k"].int(1) == 7
    assert f.int(11, 42) == 42 and f.message(11) is None
    for bad in (b"\x2a\x05abc", b"\x25ab", b"\x08\x96"):
        with pytest.raises(ValueError, match="runs past"):
            protobuf.parse(bad)


def test_port_bytes_parsed_by_tensorflows_protos(yolo, tf):
    """The serving file parsed with TensorFlow's own ``saved_model_pb2``:
    one meta graph tagged ``serve``, the ``serving_default`` signature's
    names, dtypes and full shapes, every node's name, op and inputs and
    every ``Const``'s data as the port's reader sees them."""
    from tensorflow.core.protobuf import saved_model_pb2

    with open(os.path.join(yolo["srv"], "saved_model.pb"), "rb") as f:
        sm = saved_model_pb2.SavedModel.FromString(f.read())
    assert sm.saved_model_schema_version == 1 and len(sm.meta_graphs) == 1
    mg = sm.meta_graphs[0]
    assert list(mg.meta_info_def.tags) == ["serve"]
    sig = mg.signature_def["serving_default"]
    assert sig.method_name == "tensorflow/serving/predict"
    specs = {k: (v.name, v.dtype, [d.size for d in v.tensor_shape.dim])
             for side in (sig.inputs, sig.outputs) for k, v in side.items()}
    assert specs == {"image": ("image:0", 1, [B, 64, 64, 3]),
                     "output_0": ("output_0:0", 1, [B, 100, 6]),
                     "output_1": ("output_1:0", 10, [B, 100])}
    gd = mg.graph_def
    assert gd.versions.producer == S.GRAPH_DEF_VERSION
    ours = read_savedmodel(yolo["srv"])
    assert sum(ours.graph_ops.values()) == len(gd.node)
    ops = {}
    for node in gd.node:
        ops[node.op] = ops.get(node.op, 0) + 1
        assert len(node.attr["_output_shapes"].list.shape) >= 1, node.name
        if node.op == "Const":
            t = node.attr["value"].tensor
            got = ours.value(node.name)
            want = np.frombuffer(t.tensor_content, got.dtype).reshape(
                [d.size for d in t.tensor_shape.dim])
            np.testing.assert_array_equal(got, want)
    assert ops == ours.graph_ops
    conv = next(n for n in gd.node if n.op == "Conv2D")
    assert conv.attr["data_format"].s == b"NHWC"
    assert list(conv.attr["strides"].list.i) == [1, 1, 1, 1]
    assert conv.attr["padding"].s == b"EXPLICIT"
    assert list(conv.attr["explicit_paddings"].list.i) == [0, 0, 1, 1, 1, 1,
                                                           0, 0]


def test_tensorflow_bytes_read_by_the_port(tf):
    """A SavedModel built with TensorFlow's protos (a negative int64 in
    a shape, a constant's ``tensor_content``, a list attr, two
    meta graphs) read field by field by ``export/protobuf.py``."""
    from tensorflow.core.framework import attr_value_pb2, node_def_pb2
    from tensorflow.core.protobuf import saved_model_pb2

    sm = saved_model_pb2.SavedModel(saved_model_schema_version=1)
    sm.meta_graphs.add().meta_info_def.tags.append("train")
    mg = sm.meta_graphs.add()
    mg.meta_info_def.tags.extend(["serve", "gpu"])
    node = mg.graph_def.node.add(name="c", op="Const")
    t = node.attr["value"].tensor
    t.dtype = 1
    t.tensor_shape.dim.add(size=3)
    t.tensor_content = np.array([1.5, -2.0, 4.0], np.float32).tobytes()
    node.attr["dtype"].type = 1
    node2 = node_def_pb2.NodeDef(name="p", op="Placeholder", input=["c:0",
                                                                    "^c"])
    node2.attr["shape"].shape.dim.add(size=-1)
    node2.attr["k"].CopyFrom(attr_value_pb2.AttrValue(
        list=attr_value_pb2.AttrValue.ListValue(i=[1, -2, 3])))
    mg.graph_def.node.append(node2)
    info = mg.signature_def["serving_default"].inputs["x"]
    info.name, info.dtype = "p:0", 3
    f = protobuf.Fields(sm.SerializeToString())
    graphs = f.messages(S.SAVED_MODEL["meta_graphs"])
    assert len(graphs) == 2
    tags = graphs[1].message(S.META_GRAPH_DEF["meta_info_def"]).strs(
        S.META_INFO_DEF["tags"])
    assert tags == ["serve", "gpu"]
    gd = graphs[1].message(S.META_GRAPH_DEF["graph_def"])
    c, p = gd.messages(S.GRAPH_DEF["node"])
    assert c.str(S.NODE_DEF["name"]) == "c" and p.strs(
        S.NODE_DEF["input"]) == ["c:0", "^c"]
    tensor = c.map(S.NODE_DEF["attr"])["value"].message(
        S.ATTR_VALUE["tensor"])
    from podtpu_torch.export.savedmodel import _tensor_value

    np.testing.assert_array_equal(_tensor_value(tensor), [1.5, -2.0, 4.0])
    attrs = p.map(S.NODE_DEF["attr"])
    dim = attrs["shape"].message(S.ATTR_VALUE["shape"]).messages(
        S.TENSOR_SHAPE["dim"])[0]
    assert dim.int(S.DIM["size"]) == -1
    assert attrs["k"].message(S.ATTR_VALUE["list"]).ints(
        S.LIST_VALUE["i"]) == [1, -2, 3]
    sig = graphs[1].map(S.META_GRAPH_DEF["signature_def"])["serving_default"]
    x = sig.map(S.SIGNATURE_DEF["inputs"])["x"]
    assert x.str(S.TENSOR_INFO["name"]) == "p:0" and x.int(
        S.TENSOR_INFO["dtype"]) == S.DATA_TYPE["DT_INT32"]


# ---- (b)-(d) YOLOv3 against podtpu and TensorFlow ---------------------------

def test_forward_savedmodel_matches_podtpu(yolo, tf):
    """The forward SavedModel on TensorFlow against podtpu's
    ``model.apply`` on JAX:CPU, atol 1e-4 (podtpu's own bound); its heads
    come out NHWC as ``output_0..2`` in podtpu's order; the reader on the
    CPU gives TensorFlow's heads within 1e-6 of their scale."""
    outs, keys = _serve(tf, yolo["fwd"], image=yolo["x"])
    want = yolo["heads"]
    assert keys == ["output_0", "output_1", "output_2"] and len(want) == 3
    for g, w in zip(outs, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-4)
    read = load_savedmodel(yolo["fwd"], "cpu")(torch.from_numpy(yolo["x"]))
    for r, g in zip(read, outs):
        assert np.abs(r.numpy() - g).max() <= 1e-6 * np.abs(g).max()


@pytest.fixture(scope="module")
def served(yolo, tf):
    """The serving SavedModel on TensorFlow, podtpu's postprocess on its
    own forward, and the port's reader on the CPU."""
    got, keys = _serve(tf, yolo["srv"], image=yolo["x"])
    want = jax.jit(make_postprocess(CFG))(yolo["heads"])
    return {"tf": got, "keys": keys,
            "podtpu": [np.asarray(a) for a in want],
            "reader": [a.numpy() for a in load_savedmodel(
                yolo["srv"], "cpu")(torch.from_numpy(yolo["x"]))]}


def test_serving_savedmodel_matches_podtpu(served):
    """``output_0`` dets ``[B, max_det, 6]`` float32, ``output_1`` valid
    ``[B, max_det]`` bool, against podtpu's
    ``make_postprocess(model.apply)``: valid exact, dets atol 1e-3
    (podtpu's own bounds; boxes also 1e-5 of their size, as the TFLite
    file's)."""
    (dets, valid), (wd, wv) = served["tf"], served["podtpu"]
    assert served["keys"] == ["output_0", "output_1"]
    assert dets.shape == (B, 100, 6) and dets.dtype == np.float32
    assert valid.shape == (B, 100) and valid.dtype == np.bool_
    assert valid.any() and not valid.all()
    np.testing.assert_array_equal(valid, wv)
    _dets_close(dets, wd, 1e-3)


def test_reader_matches_tensorflow_and_in_process(yolo, served):
    """``load_savedmodel(device="cpu")`` on the same file: against
    TensorFlow, atol 1e-5 and valid exact; against the port's in-process
    ``make_serve_fn``, likewise (boxes also 1e-5 of their size)."""
    (dets, valid), (tdets, tvalid) = served["reader"], served["tf"]
    np.testing.assert_array_equal(valid, tvalid)
    _dets_close(dets, tdets, 1e-5)
    wd, wv = make_serve_fn(CFG, yolo["model"])(torch.from_numpy(yolo["x"]))
    np.testing.assert_array_equal(valid, wv.numpy())
    _dets_close(dets, wd.numpy(), 1e-5)


def test_reader_runs_the_suppression_through_greedy_suppress(yolo,
                                                             monkeypatch):
    """The B ``NonMaxSuppressionV5`` nodes of one call go to
    ``greedy_suppress`` once, as one batch of B images; ``inspect``
    reports the file."""
    import podtpu_torch.ops.kernels.nms_kernel as nk

    calls = []

    def spy(boxes, valid, thr):
        calls.append((tuple(boxes.shape), thr))
        return greedy_suppress(boxes, valid, thr)

    monkeypatch.setattr(nk, "greedy_suppress", spy)
    prog = load_savedmodel(yolo["srv"], "cpu")
    prog(torch.from_numpy(yolo["x"]))
    assert len(calls) == 1 and calls[0][0][0] == B
    assert calls[0][1] == float(np.float32(CFG["nms_iou_threshold"]))
    info = inspect_savedmodel(yolo["srv"])
    assert info["ops"]["NonMaxSuppressionV5"] == B
    assert info["ops"]["Conv2D"] == info["ops"]["BiasAdd"] == 35
    assert "Mul" not in inspect_savedmodel(yolo["fwd"])["ops"]
    assert info["kind"] == "serving" and info["MB"] > 1
    assert info["in_specs"] == [f"float32[{B},64,64,3]"]
    assert info["out_specs"] == [f"float32[{B},100,6]", f"bool[{B},100]"]


# ---- (e) podtpu's own SavedModel --------------------------------------------

@pytest.fixture(scope="module")
def podtpu_savedmodel(yolo, tf):
    """podtpu's ``export_savedmodel`` of the same weights, the serving
    unit at B=1 (jax2tf: one ``XlaCallModule``)."""
    from podtpu.export.tflite import export_savedmodel as podtpu_export

    path = str(yolo["root"] / "podtpu_sm")
    podtpu_export(yolo["jmodel"], yolo["variables"], (1, 64, 64, 3), path,
                  cfg=CFG, with_postprocess=True)
    ours = export_savedmodel(yolo["model"], CFG, (1, 64, 64, 3),
                             str(yolo["root"] / "ours_b1"),
                             with_postprocess=True)
    return path, ours


def _signature(tf, path):
    fn = tf.saved_model.load(path).signatures["serving_default"]
    _, ins = fn.structured_input_signature
    return ({k: (v.dtype.name, tuple(v.shape)) for k, v in ins.items()},
            {k: (v.dtype.name, tuple(v.shape))
             for k, v in fn.structured_outputs.items()})


@pytest.mark.parametrize("check", ["signature", "refused"])
def test_podtpu_savedmodel(podtpu_savedmodel, tf, check):
    """podtpu's own serving SavedModel: the port's signature has its
    keys, shapes and dtypes; the reader refuses podtpu's file (a
    ``StatefulPartitionedCall`` over one ``XlaCallModule``) naming item
    10d."""
    theirs, ours = podtpu_savedmodel
    if check == "signature":
        assert _signature(tf, ours) == _signature(tf, theirs) == (
            {"image": ("float32", (1, 64, 64, 3))},
            {"output_0": ("float32", (1, 100, 6)),
             "output_1": ("bool", (1, 100))})
        return
    with pytest.raises(NotImplementedError, match="item 10d") as e:
        load_savedmodel(theirs, "cpu")
    assert "XlaCallModule" in str(e.value)
    with pytest.raises(NotImplementedError, match="10d"):
        artifact_runner(theirs, "cpu")


# ---- (f) planted suppression and ties ---------------------------------------

def _suppression_savedmodel(path, boxes, valid, thr):
    ep = torch.export.export(_Suppress(thr), (boxes, valid))
    return write_savedmodel((lower_program(ep, "nms", "SavedModel"),
                             {"kind": "nms"}), path)


@pytest.mark.parametrize("step", [-1, 0, 1])
def test_planted_suppression_on_tensorflow(tf, tmp_path, step):
    """The lowered suppression on TensorFlow's ``NonMaxSuppressionV5``,
    a pair at IoU exactly 0.5 (4 x 1 and 2 x 1 boxes sharing a side) at
    a threshold of 0.5 and one float either side: TensorFlow suppresses
    at ``iou > t``, so it keeps the pair at 0.5 and above and removes the
    second box one float below. The port's IoU, with 1e-6 in its union,
    is 0.4999999 and keeps the pair at all three (the union-epsilon
    deviation of ``export/savedmodel.py``); the reader gives the port's
    masks. Two identical zero-area boxes are both selected by TensorFlow,
    once each, as the port keeps them; image 1 has 2 valid of 6; an
    input with nothing valid keeps nothing."""
    boxes, valid = _planted()
    thr = float(np.float32(0.5) if step == 0 else np.nextafter(
        np.float32(0.5), np.float32(step * np.inf)))
    path = _suppression_savedmodel(str(tmp_path / "nms"), boxes, valid, thr)
    want = greedy_suppress_reference(boxes, valid, thr)
    (got,), _ = _serve(tf, path, image=boxes.numpy(), valid=valid.numpy())
    assert bool(want[0, 1])
    assert bool(got[0, 1]) == (step >= 0)
    mask = torch.ones_like(valid)
    mask[0, 1] = False
    np.testing.assert_array_equal(got[mask.numpy()], want[mask].numpy())
    assert got[0, 4] and got[0, 5]  # zero area: both kept
    np.testing.assert_array_equal(load_savedmodel(path, "cpu")(
        boxes, valid).numpy(), want.numpy())
    (got,), _ = _serve(tf, path, image=boxes.numpy(),
                       valid=np.zeros_like(valid.numpy()))
    assert not got.any()


def test_topk_keeps_the_lower_index_on_ties(tf, tmp_path):
    """``sort(stable) + [..., :k]`` lowers to one ``TopKV2``; with planted
    equal scores TensorFlow and the reader keep the lower index first, as
    the port's ``_top``."""
    x = torch.tensor([[0.5, 0.9, 0.5, 0.9, 0.1, 0.5, -1.0, -1.0],
                      [-1.0] * 8])
    ep = torch.export.export(_TopK(), (x,))
    path = write_savedmodel((lower_program(ep, "topk", "SavedModel"), {}),
                            str(tmp_path / "topk"))
    assert read_savedmodel(path).graph_ops["TopKV2"] == 1
    want = _TopK()(x)
    (vals, idx), _ = _serve(tf, path, image=x.numpy())
    np.testing.assert_array_equal(vals, want[0].numpy())
    np.testing.assert_array_equal(idx, want[1].numpy())
    assert idx[0].tolist() == [1, 3, 0, 2] and idx[1].tolist() == [0, 1, 2, 3]
    got = load_savedmodel(path, "cpu")(x)
    assert torch.equal(got[1].long(), want[1])


# ---- (g) the runner, the CLIs and the refusals ------------------------------

@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    """A fabricated VOCdevkit converted to YOLO lists, a YOLOv4-tiny
    config at 64 px on it, and a checkpoint of seeded weights."""
    return fake_voc_run(tmp_path_factory.mktemp("voc_sm"))


def test_cli_export_savedmodel_then_test_artifact(voc, tf, capsys,
                                                  monkeypatch):
    """``cli.export_model --format savedmodel --with-postprocess`` writes
    a directory TensorFlow loads; ``cli.test --artifact x.savedmodel
    --device cpu`` on the fabricated VOC val images scores as ``cli.test
    --ckpt`` on the same weights: the val mAP to 1e-6, and each batch both
    hand the host mAP (annotations equal, valid masks equal, detections
    at 1e-5), some of them valid; ``cli.exported_inference`` times it."""
    from podtpu_torch.cli import export_model as cli_export
    from podtpu_torch.cli import exported_inference as cli_bench
    from podtpu_torch.cli import test as cli_test
    from podtpu_torch.metrics.map import MeanAveragePrecision

    cfg_path, ckpt, root = voc
    art = str(root / "v4tiny.savedmodel")
    cli_export.main(["--cfg", cfg_path, "--ckpt", ckpt, "--format",
                     "savedmodel", "--with-postprocess", "--batch", "2",
                     "--out", art, "--device", "cpu", "--inspect"])
    assert '"NonMaxSuppressionV5": 2' in capsys.readouterr().out
    x = np.random.default_rng(1).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    (tdets, tvalid), _ = _serve(tf, art, image=x)
    rdets, rvalid = artifact_runner(art, "cpu")[0](x)
    np.testing.assert_array_equal(rvalid, tvalid)
    _dets_close(rdets, tdets, 1e-5)
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


def test_refusals(yolo, tmp_path, monkeypatch):
    """``--quantize`` and ``--batch dyn`` refused for a SavedModel (as
    podtpu), a symbolic batch refused by the export, a forward file
    refused by the runner, a directory without ``saved_model.pb`` and a
    file that is no SavedModel refused, an unlowered ATen target named
    with the format, and a graph over protobuf's 2 GiB refused."""
    from podtpu_torch.cli import export_model as cli_export

    for argv in (["--quantize", "int8"], ["--quantize", "dynamic"],
                 ["--batch", "dyn"]):
        with pytest.raises(SystemExit):
            cli_export.main(["--cfg", "configs/yolov3_voc.yaml", "--format",
                             "savedmodel"] + argv)
    with pytest.raises(ValueError, match="SavedModel artifact takes a "
                                         "static batch"):
        export_savedmodel(yolo["model"], CFG, (None, 64, 64, 3), "x")
    with pytest.raises(ValueError, match="with-postprocess"):
        artifact_runner(yolo["fwd"], "cpu")
    with pytest.raises(FileNotFoundError):
        load_savedmodel(str(tmp_path / "none.savedmodel"), "cpu")
    (tmp_path / "bad").mkdir()
    (tmp_path / "bad" / "saved_model.pb").write_bytes(b"\x12\x02\x0a")
    with pytest.raises(ValueError):
        load_savedmodel(str(tmp_path / "bad"), "cpu")

    class Odd(torch.nn.Module):
        def forward(self, x):
            return torch.cummax(x, 1)[0]

    ep = torch.export.export(Odd(), (torch.zeros(1, 4),))
    with pytest.raises(NotImplementedError, match="odd: ATen target "
                       "aten.cummax has no SavedModel lowering"):
        lower_program(ep, "odd", "SavedModel")
    monkeypatch.setattr(S, "MAX_MESSAGE_BYTES", 1 << 20)
    with pytest.raises(ValueError, match="2 GiB"):
        export_savedmodel(yolo["model"], CFG, (1, 64, 64, 3),
                          str(tmp_path / "big"))


@pytest.mark.cuda
def test_reader_on_the_card_launches_the_kernel_once(yolo):
    """On the card the reader's suppression is the CUDA kernel, one
    launch a call, and its masks and boxes are the CPU reader's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    x = torch.from_numpy(yolo["x"])
    prog = load_savedmodel(yolo["srv"])
    assert prog.device.type == "cuda"
    before = greedy_suppress.launches
    dets, valid = prog(x)
    torch.cuda.synchronize()
    assert greedy_suppress.launches == before + 1
    cd, cv = load_savedmodel(yolo["srv"], "cpu")(x)
    assert torch.equal(valid.cpu(), cv)
    torch.testing.assert_close(dets.cpu(), cd, atol=1e-4, rtol=0)
