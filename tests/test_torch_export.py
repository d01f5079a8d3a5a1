"""The export path, the port against podtpu (CPU, float32): int8 PTQ on
tests/test_export.py's config (YOLOv4-tiny, 3 classes, 64 px), BN
folding, ``torch.export`` artifacts with the suppression operator inside,
the NPU checks, and the reference-weight mapping of ``torch_port``.

podtpu's in-process ``apply`` is the oracle (its own export tests are
marked slow); the port's artifacts are held to its in-process serving."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from podtpu.export.npu import fold_batchnorm as podtpu_fold_batchnorm
from podtpu.export.quantize import (
    build_quant_variables as podtpu_build_quant,
    calibrate as podtpu_calibrate,
)
from podtpu.export.torch_port import podtpu_to_torch
from podtpu.models.darknet import Darknet19Classifier as JDarknet19Classifier
from podtpu.models.factory import build_model as podtpu_build_model
from podtpu_torch.export import npu, program, quantize, runner, torch_port
from podtpu_torch.export.weights import (
    flat_from_tensors,
    load_flat_weights,
    state_dict_from_flat,
)
from podtpu_torch.models.darknet import Darknet19Classifier
from podtpu_torch.models.factory import build_model
from podtpu_torch.models.layers import ConvBnAct
from podtpu_torch.ops.int8_conv import int8_conv2d
from podtpu_torch.ops.kernels.nms_kernel import greedy_suppress
from podtpu_torch.train.steps import make_serve_fn
from tests.helpers import VOC_ANCHORS, VOC_SCALED_ANCHORS
from tests.torch_parity import (
    SEP,
    flax_variables,
    module_flat_weights,
    podtpu_flat_weights,
)

CFG = {
    "model": "yolov4-tiny",
    "num_classes": 3,
    "input_size": 64,
    "in_channels": 3,
    "compute_dtype": "float32",
    "anchors": [[4, 5], [6, 8], [10, 9], [12, 16], [18, 14],
                [20, 24], [32, 28], [40, 44], [56, 52]],
    "conf_threshold": 0.25, "nms_iou_threshold": 0.45,
    "top_k_candidates": 512, "max_detections": 100,
}


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Six workers share the cores: two intra-op threads each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def v4tiny():
    """Seeded weights in both packages, calibration batches, podtpu's
    calibration statistics and quant variables."""
    flat = podtpu_flat_weights(CFG, seed=4)
    variables = flax_variables(flat)
    jmodel = podtpu_build_model(CFG)
    model = load_flat_weights(build_model(CFG, "cpu"), flat)
    rng = np.random.default_rng(0)
    batches = [rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
               for _ in range(3)]
    stats = podtpu_calibrate(jmodel, variables, [jnp.asarray(b)
                                                 for b in batches])
    qvars = podtpu_build_quant(variables, stats)
    return flat, variables, jmodel, model, batches, stats, qvars


def _paths(tree, prefix=()):
    """{slash path of a quant block: its leaves} of podtpu's nested tree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) and "w_int8" in v:
            out["/".join(prefix + (k,))] = {n: np.asarray(a)
                                            for n, a in v.items()}
        elif isinstance(v, dict):
            out.update(_paths(v, prefix + (k,)))
    return out


def test_calibration_matches_podtpu(v4tiny):
    """The same 21 blocks calibrated; each abs-max to 1e-5 of its size
    (the float32 forwards round apart: measured 2.1e-6 at most)."""
    _, _, _, model, batches, stats, _ = v4tiny
    got = quantize.calibrate(model, batches)["quant_stats"]
    want = {"/".join(str(p.key) for p in path[:-1]): float(np.asarray(v))
            for path, v in jax.tree_util.tree_leaves_with_path(
                stats["quant_stats"])}
    assert set(got) == set(want) and len(got) == 21
    for p, v in want.items():
        assert float(got[p]) == pytest.approx(v, rel=1e-5), p
    assert float(got["stem"]) == want["stem"]  # the image: exact


def test_quant_variables_bit_for_bit(v4tiny):
    """From podtpu's statistics: the same 21 blocks, and ``w_int8`` (OIHW
    here, HWIO there), ``w_scale`` and ``x_scale`` bit for bit."""
    _, _, _, model, _, stats, qvars = v4tiny
    want = _paths(qvars["quant"])
    got = quantize.build_quant_variables(model, {"quant_stats": {
        p: np.asarray(v["x_absmax"]) for p, v in _stat_paths(
            stats["quant_stats"]).items()}})["quant"]
    assert set(got) == set(want) and len(got) == 21
    for p, w in want.items():
        g = got[p]
        assert g["w_int8"].dtype == torch.int8
        np.testing.assert_array_equal(g["w_int8"].permute(2, 3, 1, 0).numpy(),
                                      w["w_int8"], err_msg=p)
        np.testing.assert_array_equal(g["w_scale"].numpy(), w["w_scale"])
        assert g["x_scale"].numpy().tobytes() == w["x_scale"].tobytes(), p


def _stat_paths(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) and "x_absmax" in v:
            out["/".join(prefix + (k,))] = v
        elif isinstance(v, dict):
            out.update(_stat_paths(v, prefix + (k,)))
    return out


def _port_quant(qvars) -> dict:
    """podtpu's quant tree as the port's (OIHW int8 kernels)."""
    return {p: {"w_int8": torch.from_numpy(v["w_int8"].copy()).permute(
                    3, 2, 0, 1),
                "w_scale": torch.from_numpy(v["w_scale"].copy()),
                "x_scale": torch.from_numpy(v["x_scale"].copy())}
            for p, v in _paths(qvars["quant"]).items()}


def test_int32_accumulators_bit_for_bit(v4tiny):
    """Every quantized block's int32 accumulator, given the same int8
    input, equals XLA's ``conv_general_dilated(..., int32)``."""
    _, _, _, model, batches, _, qvars = v4tiny
    inputs = {}
    blocks = {n.replace(".", "/"): m for n, m in model.named_modules()
              if isinstance(m, ConvBnAct)}
    hooks = [b.register_forward_pre_hook(
        lambda m, a, p=p: inputs.__setitem__(p, m.quantize_input(a[0])))
        for p, b in blocks.items()]
    try:
        with quantize.quant_scope(model, _port_quant(qvars)), \
                torch.no_grad():
            model.eval()(torch.from_numpy(batches[1]))
    finally:
        for h in hooks:
            h.remove()
    assert len(inputs) == 21
    for p, x8 in inputs.items():
        block = blocks[p]
        w8 = torch.from_numpy(_paths(qvars["quant"])[p]["w_int8"].copy())
        got = int8_conv2d(x8, w8.permute(3, 2, 0, 1), block.conv.stride[0],
                          block.conv.padding[0])
        pad = block.conv.padding[0]
        want = jax.lax.conv_general_dilated(
            jnp.asarray(x8.permute(0, 2, 3, 1).numpy()), jnp.asarray(w8),
            window_strides=block.conv.stride, padding=((pad, pad),) * 2,
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.int32)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                      np.asarray(want), err_msg=p)


def test_quantized_forward_matches_podtpu(v4tiny):
    """The whole int8 forward on podtpu's quant variables against podtpu's
    quantized apply. Measured: relative max error 3.9e-7 on the three
    heads (no block input rounded across a quantization step), correlation
    1 - 2e-14; held to 1e-5 and 0.99999."""
    _, variables, jmodel, model, batches, _, qvars = v4tiny
    x = batches[0]
    want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        {**variables, **qvars}, jnp.asarray(x))
    with quantize.quant_scope(model, _port_quant(qvars)), torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert np.isfinite(g).all()
        rel = np.abs(g - w).max() / np.abs(w).max()
        corr = np.corrcoef(g.ravel(), w.ravel())[0, 1]
        assert rel <= 1e-5, rel
        assert corr > 0.99999, corr


def test_skip_keeps_the_stem_float(v4tiny):
    _, _, _, model, batches, _, _ = v4tiny
    stats = quantize.calibrate(model, batches[:1])
    q = quantize.build_quant_variables(
        model, stats, skip=lambda p: p.startswith("stem"))["quant"]
    assert "stem" not in q and len(q) == 20
    with quantize.quant_scope(model, q):
        assert not model.stem.quantized and model.layer1_0.quantized


def test_float_state_dict_is_unchanged_by_quantization(v4tiny):
    """A float model's keys carry no quant buffers; quantizing adds three
    a block, and removing the state gives the keys back (the counterpart
    of ``test_int8_quant_init_is_clean``)."""
    _, _, _, model, batches, _, _ = v4tiny
    fresh = set(build_model(CFG, "cpu").state_dict())
    assert set(model.state_dict()) == fresh
    assert not any(k.endswith(ConvBnAct.QUANT_BUFFERS) for k in fresh)
    q = quantize.quantize_for_serving(model, batches[:1])["quant"]
    try:
        assert len(set(model.state_dict()) - fresh) == 3 * len(q) == 63
    finally:
        quantize.clear_quant(model)
    assert set(model.state_dict()) == fresh


def test_fold_batchnorm_matches_podtpu(v4tiny):
    """Folded weights within 1e-6 of podtpu's ``fold_batchnorm`` on the
    same weights; the folded model's eval forward within 1e-5 of the
    unfolded one (relative to the heads' scale)."""
    flat, variables, _, model, batches, _, _ = v4tiny
    folded = npu.fold_batchnorm(model.state_dict())
    got = flat_from_tensors(folded)
    jf = podtpu_fold_batchnorm(variables)
    for coll in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(jf[coll])[0]:
            key = SEP.join([coll] + [str(p.key) for p in path])
            np.testing.assert_allclose(got[key], np.asarray(leaf), rtol=1e-6,
                                       atol=1e-6, err_msg=key)
    twin = build_model(CFG, "cpu")
    twin.load_state_dict(folded)
    x = torch.from_numpy(batches[2])
    with torch.no_grad():
        for g, w in zip(twin(x), model.eval()(x)):
            scale = w.abs().max()
            assert float((g - w).abs().max() / scale) < 1e-5


@pytest.fixture(scope="module")
def artifacts(v4tiny, tmp_path_factory):
    """A forward artifact at B=1 and a serving one with a symbolic batch,
    exported on the CPU, and their programs loaded back."""
    _, _, _, model, _, _, _ = v4tiny
    root = tmp_path_factory.mktemp("pt2")
    fwd = program.export_program(model, (1, 64, 64, 3), str(root / "f.pt2"))
    srv = program.export_serving(model, CFG, (None, 64, 64, 3),
                                 str(root / "s.pt2"))
    return fwd, srv, program.load_program(fwd), program.load_program(srv)


def test_serving_artifact_matches_in_process_serving(v4tiny, artifacts):
    """The loaded ``.pt2`` serving program, at B=3 on a symbolic batch,
    gives the in-process ``make_serve_fn``'s detections exactly; its one
    suppression node runs the registered operator."""
    _, _, _, model, batches, _, _ = v4tiny
    _, srv, _, _ = artifacts
    run, batch = runner.artifact_runner(srv)
    assert batch is None
    x = np.concatenate([batches[0], batches[1][:1]])
    dets, valid = run(x)
    want_dets, want_valid = make_serve_fn(CFG, model.eval())(
        torch.from_numpy(x))
    assert dets.shape == (3, 100, 6) and valid.any()
    np.testing.assert_array_equal(valid, want_valid.numpy())
    np.testing.assert_array_equal(dets, want_dets.numpy())
    info = program.inspect_exported(srv)
    assert info["ops"]["podtpu_torch.greedy_suppress"] == 1
    assert info["kind"] == "serving" and info["batch"] is None
    assert info["out_specs"][1].startswith("bool[")


def test_runner_rejects_a_forward_artifact_and_tflite(artifacts):
    fwd, _, _, _ = artifacts
    with pytest.raises(ValueError, match="--with-postprocess"):
        runner.artifact_runner(fwd)
    # a SavedModel and a .tflite are read (here: no such file); a directory
    # holding a saved_model.pb is a SavedModel whatever its name
    with pytest.raises(FileNotFoundError):
        runner.artifact_runner("model.savedmodel", "cpu")
    assert runner.is_savedmodel("model.savedmodel/")
    assert not runner.is_savedmodel(fwd)
    assert runner.artifact_device("model.savedmodel", "cpu").type == "cpu"
    with pytest.raises(FileNotFoundError):
        runner.artifact_runner("model.tflite", "cpu")
    info = program.inspect_exported(fwd)
    assert info["in_specs"] == ["float32[1,64,64,3]"]
    assert len(info["out_specs"]) == 3


def test_npu_validation_passes_forward_fails_serving(artifacts, tmp_path):
    """As in podtpu: the forward graph is all whitelisted, the serving one
    is not (its sort, gather and suppression operator); the annotation
    map has the 24 convolutions (21 blocks, 3 heads) and 3 pools."""
    fwd, _, fwd_ep, srv_ep = artifacts
    report = npu.validate_for_npu(fwd)
    assert report["ok"] and not report["unsupported"]
    with pytest.raises(npu.NPUValidationError) as ei:
        npu.validate_for_npu(srv_ep)
    assert "podtpu_torch.greedy_suppress" in ei.value.unsupported
    assert {"aten.sort", "aten.gather"} <= set(ei.value.unsupported)
    assert not npu.validate_for_npu(srv_ep, strict=False)["ok"]
    ann = npu.annotate_for_npu(fwd_ep, str(tmp_path / "ann.json"))
    convs = [l for l in ann["layers"] if l["op"] == "aten.conv2d"]
    pools = [l for l in ann["layers"] if l["op"] == "aten.max_pool2d"]
    assert (len(convs), len(pools)) == (24, 3)
    assert all(l["name"].isidentifier() for l in ann["layers"])
    assert not any(l["pool_at_pad"] for l in pools)


def test_suppress_operator_is_one_node_and_counts_nothing_on_the_cpu():
    boxes = torch.rand(2, 16, 4) * 10
    boxes[..., 2:] += boxes[..., :2]
    valid = torch.ones(2, 16, dtype=torch.bool)
    before = greedy_suppress.launches
    keep = torch.ops.podtpu_torch.greedy_suppress(boxes, valid, 0.45)
    assert keep.dtype == torch.bool and keep.shape == (2, 16)
    assert greedy_suppress.launches == before


def test_export_leaves_the_anchor_cache_untouched():
    """RetinaNet's anchor cache is neither read nor filled by a trace: the
    program bakes the anchors in, and the cache keeps only real tensors."""
    from podtpu_torch.ops import retina

    class Shift(torch.nn.Module):
        def forward(self, x):
            return x + retina.anchors_on(x.device, 96)

    before = dict(retina._ANCHORS)
    ep = torch.export.export(Shift(), (torch.zeros(1, 4),))
    assert retina._ANCHORS == before
    x = torch.rand(1, 4)
    assert torch.equal(ep.module()(x), Shift()(x))
    assert all(type(t) is torch.Tensor for t in retina._ANCHORS.values())


# ---- torch_port -------------------------------------------------------------

PORT_MODELS = {
    "yolov1": dict(model="yolov1", num_classes=20, num_boxes=2,
                   input_size=448, compute_dtype="float32"),
    "yolov2": dict(model="yolov2", num_classes=20,
                   scaled_anchors=VOC_SCALED_ANCHORS, input_size=64,
                   compute_dtype="float32"),
    "yolov3": dict(model="yolov3", num_classes=20, anchors=VOC_ANCHORS,
                   input_size=64, compute_dtype="float32"),
    "yolov4-tiny": dict(model="yolov4-tiny", num_classes=20,
                        anchors=VOC_ANCHORS, input_size=64,
                        compute_dtype="float32"),
}


def _port_case(name):
    """The port's model on the meta device (shapes only: the mapping
    reads no values) and seeded flat weights for it."""
    if name == "darknet19":
        with torch.device("meta"):
            model = Darknet19Classifier(num_classes=10)
        flat = module_flat_weights(JDarknet19Classifier(num_classes=10),
                                   jnp.zeros((1, 64, 64, 3)), seed=2)
        return model, flat
    cfg = PORT_MODELS[name]
    with torch.device("meta"):
        model = build_model(cfg, "meta")
    return model, podtpu_flat_weights(cfg, seed=2)


@pytest.mark.parametrize("name", list(PORT_MODELS) + ["darknet19"])
def test_torch_port_maps_the_reference_names(name):
    """podtpu's ``podtpu_to_torch`` of a variable tree, then the port's
    reference -> port map, equals the port's load of the same tree bit for
    bit (YOLOv1's ``fc`` through the NCHW <-> NHWC flatten permutation);
    and the port -> reference map equals ``podtpu_to_torch``."""
    model, flat = _port_case(name)
    ref = podtpu_to_torch(flax_variables(flat), name)
    lightning = {"model." + k: torch.from_numpy(np.array(v))
                 for k, v in ref.items()}
    got = torch_port.torch_to_port(lightning, name)
    want = state_dict_from_flat(model, flat)
    assert set(got) == set(model.state_dict())
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    back = torch_port.port_to_torch(want, name)
    assert list(back) == list(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(v),
                                      err_msg=k)
    assert flat_from_tensors(got).keys() == flat.keys()


def test_torch_port_rejects_unmapped_and_missing_keys():
    model, flat = _port_case("yolov4-tiny")
    ref = podtpu_to_torch(flax_variables(flat), "yolov4-tiny")
    with pytest.raises(KeyError, match="unmapped"):
        torch_port.torch_to_port({**ref, "extra.weight": np.zeros(1)},
                                 "yolov4-tiny")
    ref.pop("stem.0.conv.weight")
    with pytest.raises(KeyError, match="missing"):
        torch_port.torch_to_port(ref, "yolov4-tiny")


@pytest.mark.skipif(
    not (torch_port.REFERENCE_ROOT
         and __import__("os").path.isdir(torch_port.REFERENCE_ROOT)),
    reason="no reference checkout: PODTPU_REFERENCE_ROOT is unset or absent")
def test_reference_module_loads_ported_weights():
    """The reference's YOLOv4-tiny, imported through the shims, takes the
    port's weights with ``load_state_dict(strict=True)``."""
    det = torch_port.import_reference("models.detector.yolov4_tiny")
    ref = det.YoloV4TinyV4(num_classes=20, num_anchors=9)
    _, flat = _port_case("yolov4-tiny")
    model = load_flat_weights(build_model(PORT_MODELS["yolov4-tiny"], "cpu"),
                              flat)
    ref.load_state_dict(torch_port.port_to_torch(model.state_dict(),
                                                 "yolov4-tiny"))
