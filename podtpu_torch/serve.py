"""HTTP serving of a YOLO model on the card (the port's ``tools/serve.py``).

Where ``podtpu`` serves an exported StableHLO artifact, the port serves the
model itself: an :class:`Engine` builds it from the experiment config, loads
``podtpu``-layout ``.npz`` weights (``podtpu/export/weights.py`` writes
them), and runs ``make_serve_fn`` — forward, decode and NMS on the device.

    python -m podtpu_torch.serve --cfg configs/yolov3_voc.yaml \
        --weights weights.npz [--max-batch 8] [--port 8000]

    curl -s -X POST --data-binary @dog.jpg localhost:8000/predict

Responses are JSON rows with boxes in both the network's input pixels and
the original image's pixels. ``GET /`` returns the engine's metadata,
``GET /healthz`` liveness, ``GET /stats`` request/error counts, latency
percentiles and the micro-batch fill histogram. ``--max-batch N`` turns on
micro-batching: requests that arrive within ``--window-ms`` share one
dispatch padded to N rows. ``cv2`` is imported only to decode and resize
posted images.
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from podtpu_torch import resolve_device
from podtpu_torch.export.weights import load_flat_weights, load_npz_weights
from podtpu_torch.models.factory import build_model
from podtpu_torch.train.steps import _as_input, make_serve_fn


class Stats:
    """Thread-safe serving metrics: request/error counts, latency
    percentiles over a sliding window, and the micro-batch fill histogram
    (how full each device dispatch was: fill 1/N means paying for N rows of
    work per image)."""

    def __init__(self, window: int = 1000):
        self._lock = threading.Lock()
        self._lat = deque(maxlen=window)
        self.requests = 0
        self.errors = 0
        self.fills: dict[int, int] = {}
        self.t0 = time.monotonic()

    def record(self, latency_s: float):
        with self._lock:
            self.requests += 1
            self._lat.append(latency_s)

    def record_error(self):
        with self._lock:
            self.errors += 1

    def record_fill(self, n: int):
        with self._lock:
            self.fills[n] = self.fills.get(n, 0) + 1

    def snapshot(self) -> dict:
        with self._lock:
            lat = sorted(self._lat)
            fills = dict(sorted(self.fills.items()))
            reqs, errs = self.requests, self.errors
        pct = (lambda q: round(lat[min(len(lat) - 1,
                                       int(q * len(lat)))] * 1000, 2)
               if lat else None)
        dispatches = sum(fills.values())
        images = sum(n * c for n, c in fills.items())
        return {
            "uptime_s": round(time.monotonic() - self.t0, 1),
            "requests": reqs,
            "errors": errs,
            "latency_ms": {"p50": pct(0.50), "p90": pct(0.90),
                           "p99": pct(0.99)},
            "batch_fill": fills or None,
            "mean_fill": (round(images / dispatches, 2)
                          if dispatches else None),
        }


class MicroBatcher:
    """Coalesce concurrent single-image requests into one device dispatch.

    A single worker thread collects submissions; a batch launches when
    ``batch`` rows are pending or ``window_ms`` has passed since the first
    arrival, padded with zero rows to exactly ``batch`` so every dispatch
    has one shape. Results fan back out through per-request events.
    :meth:`close` stops the worker once the pending requests are served.
    """

    def __init__(self, run, batch: int, window_ms: float,
                 stats: Stats | None = None, timeout_s: float = 30.0):
        self.run = run  # [batch, H, W, 3] -> (dets, valid)
        self.batch = batch
        self.window = window_ms / 1000.0
        self.stats = stats
        self.timeout_s = timeout_s
        self._cv = threading.Condition()
        self._pending: list[list] = []  # [x_row, result, event, t_arrival]
        self._closed = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, x_row: np.ndarray):
        slot = [x_row, None, threading.Event(), time.monotonic()]
        with self._cv:
            if self._closed:
                raise RuntimeError("micro-batcher is closed")
            self._pending.append(slot)
            self._cv.notify()
        # bounded wait: a wedged device dispatch (or a dead worker thread)
        # must surface as a 503, not hang the handler thread forever
        if not slot[2].wait(timeout=self.timeout_s):
            with self._cv:  # don't let a late dispatch run it pointlessly
                if slot in self._pending:
                    self._pending.remove(slot)
            raise TimeoutError(
                f"micro-batch dispatch exceeded {self.timeout_s:.0f}s")
        if isinstance(slot[1], Exception):
            raise slot[1]
        return slot[1]

    def close(self, timeout_s: float = 30.0):
        with self._cv:
            self._closed = True
            self._cv.notify()
        self._thread.join(timeout_s)

    def _loop(self):
        while True:
            with self._cv:
                while not self._pending and not self._closed:
                    self._cv.wait()
                if not self._pending:
                    return
                # the window counts from the OLDEST pending arrival, so a
                # request left over from an overflowed batch doesn't wait a
                # fresh full window on top of the dispatch it already sat
                # through
                deadline = self._pending[0][3] + self.window
                while len(self._pending) < self.batch and not self._closed:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self._cv.wait(timeout=left)
                todo = self._pending[: self.batch]
                self._pending = self._pending[self.batch:]
            if self.stats is not None:
                self.stats.record_fill(len(todo))
            try:
                x = np.stack([s[0] for s in todo])
                if len(todo) < self.batch:
                    x = np.concatenate(
                        [x, np.zeros((self.batch - len(todo),) + x.shape[1:],
                                     x.dtype)])
                dets, valid = self.run(x)
                for i, s in enumerate(todo):
                    s[1] = (dets[i], valid[i])
            except Exception as e:  # fan the failure out to every waiter
                for s in todo:
                    s[1] = e
            for s in todo:
                s[2].set()


class Engine:
    """A built model with its weights and its serving function, shared
    across request threads (one dispatch at a time reaches the device).

    ``weights`` is a ``podtpu``-layout ``.npz`` path or the same flat
    mapping of arrays already in memory.
    """

    def __init__(self, cfg: dict, weights: str | dict[str, np.ndarray],
                 device: str | torch.device | None = None,
                 preprocess: str = "letterbox", names: list[str] = (),
                 max_batch: int = 1, window_ms: float = 5.0,
                 max_body_bytes: int = 20 << 20, timeout_s: float = 30.0):
        self.device = resolve_device(device)
        self.model = build_model(cfg, self.device)
        if isinstance(weights, str):
            load_npz_weights(self.model, weights)
            self.weights = os.path.basename(weights)
        else:
            load_flat_weights(self.model, weights)
            self.weights = "<in memory>"
        self.cfg = cfg
        self.serve = make_serve_fn(cfg, self.model)
        self.size = int(cfg["input_size"])
        self.preprocess = preprocess
        self.names = list(names)
        self._lock = threading.Lock()
        self.stats = Stats()
        self.max_body_bytes = max_body_bytes
        self.timeout_s = timeout_s
        self.batcher = None
        if max_batch > 1:
            self.batcher = MicroBatcher(self.run, max_batch, window_ms,
                                        stats=self.stats,
                                        timeout_s=timeout_s)

    def run(self, x: np.ndarray):
        """[B, size, size, 3] uint8 (or [0, 1] float) -> numpy (dets, valid)."""
        with self._lock:
            xt = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
            dets, valid = self.serve(_as_input(xt))
            return dets.cpu().numpy(), valid.cpu().numpy()

    def close(self):
        if self.batcher is not None:
            self.batcher.close()

    def _prep(self, im: np.ndarray):
        import cv2

        from podtpu_torch.data.augment import letterbox

        h0, w0 = im.shape[:2]
        if self.preprocess == "letterbox":
            # scaleup=False: eval-time letterboxing does not upscale
            im, (r, _), (dw, dh) = letterbox(im, self.size, scaleup=False)
            # invert with the integer pads letterbox actually applied
            left, top = int(round(dw - 0.1)), int(round(dh - 0.1))
            inv = lambda cx, cy, w, h: (  # noqa: E731
                (cx - left) / r, (cy - top) / r, w / r, h / r)
        else:
            im = cv2.resize(im, (self.size, self.size),
                            interpolation=cv2.INTER_LINEAR)
            sx, sy = w0 / self.size, h0 / self.size
            inv = lambda cx, cy, w, h: (cx * sx, cy * sy, w * sx, h * sy)  # noqa: E731
        return im, inv

    def _timed(self, fn, *args):
        t0 = time.monotonic()
        try:
            out = fn(*args)
        except Exception:
            self.stats.record_error()
            raise
        self.stats.record(time.monotonic() - t0)
        return out

    def predict(self, img_bytes: bytes) -> dict:
        """An encoded image (JPEG, PNG, ...) -> detections."""
        return self._timed(self._predict, img_bytes)

    def predict_array(self, im: np.ndarray) -> dict:
        """A preprocessed [size, size, 3] uint8 RGB image -> detections
        (boxes in the image's own pixels)."""
        return self._timed(self._detect, im, lambda cx, cy, w, h: (cx, cy, w, h))

    def _predict(self, img_bytes: bytes) -> dict:
        import cv2

        raw = cv2.imdecode(np.frombuffer(img_bytes, np.uint8),
                           cv2.IMREAD_COLOR)
        if raw is None:
            raise ValueError("could not decode image")
        im, inv = self._prep(cv2.cvtColor(raw, cv2.COLOR_BGR2RGB))
        return self._detect(im, inv)

    def _detect(self, im: np.ndarray, inv) -> dict:
        if im.shape != (self.size, self.size, 3) or im.dtype != np.uint8:
            raise ValueError(f"expected a [{self.size}, {self.size}, 3] uint8 "
                             f"image, got {im.shape} {im.dtype}")
        if self.batcher is not None:
            det0, valid0 = self.batcher.submit(im)
        else:
            dets, valid = self.run(im[None])
            det0, valid0 = dets[0], valid[0]
        rows = []
        for cx, cy, w, h, conf, cls in det0[valid0]:
            ox, oy, ow, oh = inv(cx, cy, w, h)
            cls = int(cls)
            rows.append({
                "class_id": cls,
                "class_name": (self.names[cls] if cls < len(self.names)
                               else str(cls)),
                "confidence": round(float(conf), 4),
                "box_cxcywh_input": [round(float(v), 2)
                                     for v in (cx, cy, w, h)],
                "box_cxcywh_image": [round(float(v), 2)
                                     for v in (ox, oy, ow, oh)],
            })
        return {"detections": rows, "num_detections": len(rows)}

    def info(self):
        return {"model": self.cfg["model"], "weights": self.weights,
                "device": str(self.device), "input_size": self.size,
                "preprocess": self.preprocess,
                "micro_batch": (self.batcher.batch if self.batcher else 1),
                "num_classes": self.cfg["num_classes"]}


def make_handler(engine: Engine):
    class Handler(BaseHTTPRequestHandler):
        # socket-level guard: a client that stalls mid-body can't pin a
        # handler thread past the request timeout
        timeout = engine.timeout_s

        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = self.path.rstrip("/")
            if path in ("", "/info"):
                self._send(200, engine.info())
            elif path == "/healthz":
                # the server only binds after the warmup dispatch, so
                # liveness == readiness here
                self._send(200, {"status": "ok"})
            elif path == "/stats":
                self._send(200, engine.stats.snapshot())
            else:
                self._send(404, {"error": "GET /, /healthz, /stats; "
                                          "POST /predict"})

        def do_POST(self):
            if self.path.rstrip("/") != "/predict":
                self._send(404, {"error": "POST /predict"})
                return
            length = self.headers.get("Content-Length")
            if length is None:
                self._send(411, {"error": "Content-Length required"})
                return
            try:
                n = int(length)
                if n < 0:
                    raise ValueError(length)
            except ValueError:
                engine.stats.record_error()
                self._send(400, {"error": f"bad Content-Length: {length!r}"})
                return
            if n == 0:
                engine.stats.record_error()
                self._send(400, {"error": "empty body"})
                return
            if n > engine.max_body_bytes:
                engine.stats.record_error()
                # drain in bounded chunks (never buffering the oversized
                # body) so the client sees a clean 413 instead of a reset
                # pipe mid-upload
                left = n
                while left > 0:
                    got = self.rfile.read(min(left, 1 << 16))
                    if not got:
                        break
                    left -= len(got)
                self._send(413, {"error": f"body {n} bytes exceeds limit "
                                          f"{engine.max_body_bytes}"})
                return
            try:
                self._send(200, engine.predict(self.rfile.read(n)))
            except ValueError as e:  # undecodable/garbage image payloads
                self._send(400, {"error": str(e)})
            except TimeoutError as e:  # wedged dispatch — retryable
                self._send(503, {"error": str(e)})
            except Exception as e:  # anything else is ours, not theirs
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *args):  # quiet
            pass

    return Handler


def load_names(names_path: str) -> list[str]:
    with open(names_path, "r") as f:
        return [line.strip() for line in f if line.strip()]


def main(argv=None):
    from podtpu_torch.config import get_configs

    ap = argparse.ArgumentParser()
    ap.add_argument("--cfg", required=True, help="experiment YAML")
    ap.add_argument("--weights", required=True,
                    help="podtpu-layout .npz (save_npz_weights)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) | cuda:N | cpu")
    ap.add_argument("--preprocess", choices=["resize", "letterbox"],
                    default="letterbox")
    ap.add_argument("--names", default="", help="class-names file")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max-batch", type=int, default=1,
                    help="micro-batching: coalesce up to N concurrent "
                         "requests into one padded device dispatch")
    ap.add_argument("--window-ms", type=float, default=5.0,
                    help="micro-batching window after the first arrival")
    ap.add_argument("--max-body-bytes", type=int, default=20 << 20,
                    help="reject request bodies larger than this (413)")
    ap.add_argument("--request-timeout-s", type=float, default=30.0,
                    help="socket + micro-batch dispatch timeout")
    args = ap.parse_args(argv)

    cfg = get_configs(args.cfg)
    names = load_names(args.names) if args.names else []
    engine = Engine(cfg, args.weights, device=args.device,
                    preprocess=args.preprocess, names=names,
                    max_batch=args.max_batch, window_ms=args.window_ms,
                    max_body_bytes=args.max_body_bytes,
                    timeout_s=args.request_timeout_s)
    # warm once so the first request doesn't pay for the kernel build
    engine.predict_array(np.zeros((engine.size, engine.size, 3), np.uint8))
    server = ThreadingHTTPServer((args.host, args.port), make_handler(engine))
    # graceful shutdown: SIGTERM/SIGINT stop accepting, in-flight requests
    # finish, final stats go to stdout for the log collector
    import signal

    def _stop(*_):
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    print(f"serving {engine.info()} on http://{args.host}:{args.port}")
    server.serve_forever()
    engine.close()
    print(f"shutdown; final stats: {json.dumps(engine.stats.snapshot())}")


if __name__ == "__main__":
    main()
