"""The port's serving path against podtpu's (CPU): postprocess on identical
heads, the whole serve function on identical weights, the micro-batching
engine, device resolution, the config loader, and the port's import ban."""

import ast
import glob
import http.client
import json
import os
import threading
from http.server import ThreadingHTTPServer

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import podtpu_torch
from podtpu.config import get_configs as podtpu_get_configs
from podtpu.models.factory import build_model as podtpu_build_model
from podtpu.train.steps import make_postprocess as podtpu_make_postprocess
from podtpu.train.steps import make_serve_fn as podtpu_make_serve_fn
from podtpu_torch.config import get_configs
from podtpu_torch.export.weights import load_flat_weights
from podtpu_torch.models.factory import build_model
from podtpu_torch.serve import Engine, make_handler
from podtpu_torch.train.steps import _as_input, make_postprocess, make_serve_fn
from tests.torch_parity import (
    flax_variables,
    image_batch,
    podtpu_flat_weights,
    yolo_cfg,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def flat():
    return podtpu_flat_weights(yolo_cfg(), seed=1)


def _det_rows(dets, valid):
    """Each image's valid detections, sorted by (class, cx, cy)."""
    out = []
    for d, v in zip(np.asarray(dets), np.asarray(valid)):
        d = d[v]
        out.append(d[np.lexsort((d[:, 1], d[:, 0], d[:, 5]))])
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_postprocess_matches_podtpu(seed):
    cfg = yolo_cfg()
    rng = np.random.default_rng(seed)
    heads = [rng.normal(0.0, 2.0, (2, s, s, 75)).astype(np.float32)
             for s in (8, 4, 2)]
    want = podtpu_make_postprocess(cfg)([jnp.asarray(h) for h in heads])
    got = make_postprocess(cfg)([torch.from_numpy(h) for h in heads])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    # sigmoid/exp may differ by an ulp between the frameworks
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-6, atol=1e-5)
    assert got[1].numpy().sum() > 0


def test_serve_fn_matches_podtpu_end_to_end(flat):
    cfg = yolo_cfg()
    x = image_batch(cfg, batch=2, seed=3)
    variables = flax_variables(flat)
    jmodel = podtpu_build_model(cfg)
    want = podtpu_make_serve_fn(
        cfg, lambda v: jmodel.apply(variables, v, train=False))(
            jnp.asarray(x, jnp.float32) / 255.0)
    model = load_flat_weights(build_model(cfg, device="cpu"), flat)
    got = make_serve_fn(cfg, model)(_as_input(torch.from_numpy(x)))
    assert got[0].shape == (2, 100, 6) and got[1].dtype == torch.bool
    np.testing.assert_array_equal(got[1].numpy().sum(1),
                                  np.asarray(want[1]).sum(1))
    for g, w in zip(_det_rows(*got), _det_rows(*want)):
        assert len(g) > 0
        np.testing.assert_array_equal(g[:, 5], w[:, 5])  # class ids
        # boxes: f32 heads agree to ~1e-5 (conv summation order), and the
        # decode scales them by strides up to 32 px and exp()
        np.testing.assert_allclose(g[:, :4], w[:, :4], rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(g[:, 4], w[:, 4], atol=1e-5)


def test_engine_micro_batches_concurrent_requests(flat):
    cfg = yolo_cfg()
    engine = Engine(cfg, flat, device="cpu", max_batch=4, window_ms=50.0)
    try:
        images = image_batch(cfg, batch=6, seed=4)
        results = [None] * len(images)

        def worker(i):
            results[i] = engine.predict_array(images[i])

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(images))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        dets, valid = engine.run(images)
        for i, res in enumerate(results):
            assert res["num_detections"] == int(valid[i].sum()) > 0
            got = np.array([r["box_cxcywh_input"] + [r["class_id"]]
                            for r in res["detections"]])
            want = dets[i][valid[i]][:, [0, 1, 2, 3, 5]]
            np.testing.assert_allclose(got, want, atol=0.01)
        snap = engine.stats.snapshot()
        assert snap["requests"] == 6 and snap["errors"] == 0
        assert sum(n * c for n, c in snap["batch_fill"].items()) == 6
        assert max(snap["batch_fill"]) <= 4
    finally:
        engine.close()
    assert not engine.batcher._thread.is_alive()


def test_engine_rejects_wrong_image_shape(flat):
    engine = Engine(yolo_cfg(), flat, device="cpu")
    with pytest.raises(ValueError, match="uint8 image"):
        engine.predict_array(np.zeros((32, 32, 3), np.uint8))
    assert engine.stats.snapshot()["errors"] == 1


def test_http_server_answers_predict(flat):
    engine = Engine(yolo_cfg(), flat, device="cpu")
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(engine))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        # a 48x96 image: letterboxed into 64x64 without upscaling
        img = image_batch(yolo_cfg(size=96), batch=1, seed=5)[0][:48]
        body = cv2.imencode(".png", img)[1].tobytes()

        def call(method, path, data=None):
            conn = http.client.HTTPConnection("127.0.0.1",
                                              server.server_address[1],
                                              timeout=30)
            conn.request(method, path, body=data)
            resp = conn.getresponse()
            out = resp.status, resp.read()
            conn.close()
            return out

        assert call("GET", "/healthz")[0] == 200
        status, payload = call("POST", "/predict", body)
        assert status == 200
        rows = json.loads(payload)["detections"]
        assert rows and all(len(r["box_cxcywh_image"]) == 4 for r in rows)
        assert call("POST", "/predict", b"not an image")[0] == 400
        assert call("GET", "/nope")[0] == 404
        snap = engine.stats.snapshot()
        assert snap["requests"] == 1 and snap["errors"] == 1
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


def test_resolve_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        podtpu_torch.resolve_device()
    with pytest.raises(RuntimeError):
        build_model(yolo_cfg())
    assert podtpu_torch.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize(
    "path", sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml"))),
    ids=os.path.basename)
def test_config_loader_matches_podtpu(path):
    assert get_configs(path, validate=False) == podtpu_get_configs(
        path, validate=False)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_podtpu():
    files = glob.glob(os.path.join(REPO, "podtpu_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(REPO, "chip_smoke.py")]
    banned = ("jax", "jaxlib", "flax", "optax", "orbax", "podtpu",
              "tensorflow", "flatbuffers", "tflite_runtime", "ai_edge_litert")
    assert len(files) > 10
    for path in files:
        for mod in _imported_modules(path):
            assert mod.split(".")[0] not in banned, f"{path} imports {mod}"
