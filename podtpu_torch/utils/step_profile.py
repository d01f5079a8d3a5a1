"""Where a train step's device time goes: a ``torch.profiler`` trace of a
few steps, read back into four views.

    python -m podtpu_torch.utils.step_profile --cfg configs/yolov3_voc.yaml \\
        [--batch B] [--iters N] [--from-files] [--device cpu]

Over ``N`` train steps (``make_train_step``, after 3 unprofiled ones):

(a) the top 30 device kernels by self time;
(b) the device's busy ms a step (the union of its kernels' and copies'
    intervals), the window's ms a step (host clock over ``N`` more steps
    run without the profiler, ending in a synchronize: tracing every
    operator slows the host) and the idle share, 1 - busy / window;
(c) the backward's device time by the autograd node that launched it:
    convolution backward (cuDNN), the autograd of ``BatchNormMixed``, the
    activations, the loss's nodes, the fused stem's backward kernels, and
    other (with the nodes it holds);
(d) the rest of the step by part (``augment``, ``forward``, ``loss``,
    ``optimizer`` and, fed from files, ``input``), the forward by top-level
    module.

Every kernel's time lands in exactly one row of (c) or (d); what the tool
cannot attribute is its own row (``unattributed``), so the rows add up to
the total and ``coverage`` is the attributed share of it. A kernel is
attributed through the operator that launched it and that operator's
enclosing ranges: the step's own (``train/steps.py``), ``bn`` and
``forward/<child>`` ranges that forward hooks open while profiling, and the
autograd engine's ``evaluate_function: <node>`` ranges. A backward node
belongs to the forward range of the operator that created it (the two
share a sequence number). Where the profiler dropped the launching
operator's event, a fallback takes the innermost operator around the
launch on its thread; ``fallback_ms_per_step`` is the time it placed.

The batch is synthetic and already on the device (uint8 images, 8 boxes
each, and with cfg ``device_geom`` random warp rows), or with
``--from-files`` the config's train list through the host ``Loader``, as
``Trainer.fit`` feeds it, so the idle share includes the loader. On the
CPU (``--device cpu``) the "kernels" are the leaf operators on the host:
the views and their coverage, not a device time.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from podtpu_torch import resolve_device
from podtpu_torch.models.layers import BatchNormMixed

_EVAL = "autograd::engine::evaluate_function: "
_PARTS = ("augment", "forward", "loss", "backward", "optimizer", "input")
# backward nodes of the activations the models use
_ACT_NODES = ("ReluBackward", "LeakyReluBackward", "MishBackward",
              "SiluBackward", "ThresholdBackward", "HardswishBackward",
              "SigmoidBackward", "TanhBackward")


def synthetic_batch(cfg: dict, batch: int, device) -> dict:
    """A batch on ``device``: uniform uint8 images, 8 boxes an image
    (padded with -1 to ``max_annots``), and with cfg ``device_geom`` warp
    rows (scale 0.75-1.25, a shift of up to 10% of the side)."""
    r = np.random.default_rng(0)
    size, t = cfg["input_size"], int(cfg.get("max_annots", 64))
    annot = np.full((batch, t, 5), -1.0, np.float32)
    n = min(8, t)
    annot[:, :n, :4] = r.uniform(0.2, 0.6, (batch, n, 4))
    annot[:, :n, 4] = r.integers(0, cfg["num_classes"], (batch, n))
    out = {"img": r.integers(0, 256, (batch, size, size, 3), dtype=np.uint8),
           "annot": annot}
    if cfg.get("device_geom"):
        s = r.uniform(0.75, 1.25, (batch, 1))
        shift = r.uniform(-0.1, 0.1, (batch, 2)) * size
        out["geom"] = np.concatenate([s, s, shift], 1).astype(np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


class _ModuleRanges:
    """Forward hooks that open a ``record_function`` range around each
    top-level child of the model (``forward/<name>``) and each
    ``BatchNormMixed`` (``bn``) while the profile runs."""

    def __init__(self, model: torch.nn.Module):
        self.handles = []
        for name, child in model.named_children():
            self._hook(child, f"forward/{name}")
        for m in model.modules():
            if isinstance(m, BatchNormMixed):
                self._hook(m, "bn")

    def _hook(self, module, label):
        stack = []

        def pre(mod, args):
            rf = record_function(label)
            rf.__enter__()
            stack.append(rf)

        def post(mod, args, out):
            stack.pop().__exit__(None, None, None)

        self.handles += [module.register_forward_pre_hook(pre),
                         module.register_forward_hook(post)]

    def remove(self):
        for h in self.handles:
            h.remove()


def _ancestors(e):
    while e is not None:
        yield e
        e = e.cpu_parent


def _union_ms(intervals) -> float:
    total, end = 0.0, -np.inf
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def _backward_row(node: str, fwd_labels: set) -> str:
    if "Convolution" in node:
        return "conv"
    if "bn" in fwd_labels:
        return "bn"
    if "loss" in fwd_labels:
        return "loss"
    if node.startswith(_ACT_NODES):
        return "activation"
    if node.startswith("StemPoolFunction"):
        return "stem"
    return "other"


def _label(name: str) -> bool:
    return name in _PARTS or name == "bn" or name.startswith("forward/")


def _annotation(e) -> bool:
    """A ``record_function`` range (on the host, or its device-side span
    in a CUDA trace): a label, not work."""
    return bool(getattr(e, "is_user_annotation", False)) or \
        "user_annotation" in str(getattr(e, "activity_type", "") or "") \
        or _label(e.name)


def _device_events(kineto, trace_start_ns: int) -> list[tuple]:
    """(name, start us, end us, linked operator id) of each kernel, copy
    and set on the card, from the profiler's raw records (their link to
    the launching operator is there in every torch version; the
    ``record_function`` ranges' device-side spans are left out). Times
    are from the trace's start, as the operators' are."""
    out = []
    for k in kineto:
        if k.device_type() != DeviceType.CUDA or _label(k.name()) or (
                hasattr(k, "is_user_annotation") and k.is_user_annotation()):
            continue
        out.append((k.name(), (k.start_ns() - trace_start_ns) / 1e3,
                    (k.end_ns() - trace_start_ns) / 1e3,
                    k.linked_correlation_id()))
    return out


def _device_work(cpu, dev, kineto, trace_start_ns) -> tuple[list, float]:
    """([(launching operator, device us)], us placed by the fallback): each
    device event once, at the host operator its correlation id names;
    where two host records share an id (the profiler's own ones do), the
    innermost operator. Where the id names a raw host record that has no
    operator event (the profiler drops some), the fallback: the innermost
    operator around that record on its thread. A device event with neither
    stays unattributed."""
    ops, depth = {}, {}
    for e in cpu:
        if _annotation(e) or e.is_async:
            continue
        depth[id(e)] = len(list(_ancestors(e)))
        prev = ops.get(e.id)
        if prev is None or (prev.name.startswith("aten::"),
                            depth[id(prev)]) < (e.name.startswith("aten::"),
                                                depth[id(e)]):
            ops[e.id] = e
    raw = {k.correlation_id(): k for k in kineto
           if k.device_type() == DeviceType.CPU}
    by_thread = defaultdict(list)
    for e in cpu:
        if id(e) in depth:
            by_thread[e.thread].append(e)
    spans = {t: (np.array([e.time_range.start for e in es]),
                 np.array([e.time_range.end for e in es]),
                 np.array([depth[id(e)] for e in es]))
             for t, es in by_thread.items()}

    def enclosing(link):
        k = raw.get(link)
        if k is None or k.start_thread_id() not in spans:
            return None
        t = (k.start_ns() - trace_start_ns) / 1e3
        starts, ends, deep = spans[k.start_thread_id()]
        inside = np.flatnonzero((starts <= t) & (ends >= t))
        if not len(inside):
            return None
        return by_thread[k.start_thread_id()][inside[deep[inside].argmax()]]

    work, fallback = [], 0.0
    for _, start, end, link in dev:
        op = ops.get(link)
        if op is None:
            op = enclosing(link)
            fallback += (end - start) if op is not None else 0.0
        if op is not None:
            work.append((op, end - start))
    return work, fallback


def attribute(events, kineto=None, trace_start_ns: int = 0) -> dict:
    """The views (a)-(d) from a profile's ``events()`` (and, from a CUDA
    trace, its raw ``kineto`` records: the device's work), in ms over the
    whole window (:func:`profile_steps` divides by the steps)."""
    on_cuda = kineto is not None
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    # forward range labels of each autograd sequence number
    fwd = {}
    for e in cpu:
        if e.sequence_nr >= 0 and not e.name.startswith(_EVAL) \
                and "Backward" not in e.name:
            labels = {a.name for a in _ancestors(e)}
            fwd.setdefault(e.sequence_nr, labels)

    parts = defaultdict(float)
    by_module = defaultdict(float)
    backward = defaultdict(float)
    other_nodes = defaultdict(float)
    kernels = defaultdict(lambda: [0.0, 0])
    attributed = fallback = 0.0
    if on_cuda:
        dev = _device_events(kineto, trace_start_ns)
        work, fallback = _device_work(cpu, dev, kineto, trace_start_ns)
        how = "linked_correlation_id"
    else:  # the leaf operators' own host time
        how = "leaf operators"
        work = [(e, e.cpu_time_total) for e in cpu
                if not e.cpu_children and e.name.startswith("aten::")]
        for e, us in work:
            kernels[e.name][0] += us
            kernels[e.name][1] += 1
    for e, us in work:
        if not us:
            continue
        chain = list(_ancestors(e))
        names = [a.name for a in chain]
        evals = [i for i, n in enumerate(names) if n.startswith(_EVAL)]
        if evals:
            i = evals[0]
            node = names[i][len(_EVAL):]
            seq = next((a.sequence_nr for a in chain[:i] if a.name == node),
                       chain[i].sequence_nr)
            row = _backward_row(node, fwd.get(seq, set()))
            backward[row] += us
            if row == "other":
                other_nodes[node] += us
            parts["backward"] += us
            attributed += us
            continue
        part = next((n for n in names if n in _PARTS), None)
        if part is None:
            continue
        parts[part] += us
        attributed += us
        if part == "backward":  # the engine's own work, outside a node
            backward["other"] += us
            other_nodes["(engine)"] += us
        elif part == "forward":
            mod = next((n for n in names if n.startswith("forward/")),
                       "forward/(model)")
            by_module[mod[len("forward/"):]] += us

    if on_cuda:
        total = sum(end - start for _, start, end, _ in dev)
        busy = _union_ms((start, end) for _, start, end, _ in dev)
        for name, start, end, _ in dev:
            kernels[name][0] += end - start
            kernels[name][1] += 1
    else:
        leaves = [e for e in cpu if not e.cpu_children
                  and e.name.startswith("aten::")]
        total = sum(e.cpu_time_total for e in leaves)
        busy = _union_ms((e.time_range.start, e.time_range.end)
                         for e in leaves)
    ms = lambda d: {k: v / 1e3 for k, v in  # noqa: E731
                    sorted(d.items(), key=lambda kv: -kv[1])}
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:30]
    return {
        "total_ms": total / 1e3,
        "busy_ms": busy,
        "parts_ms": ms(parts),
        "forward_by_module_ms": ms(by_module),
        "backward_by_node_ms": ms(backward),
        "backward_other_nodes_ms": dict(list(ms(other_nodes).items())[:15]),
        "unattributed_ms": (total - attributed) / 1e3,
        "coverage": attributed / total if total else 0.0,
        "attributed_by": how,
        "fallback_ms": fallback / 1e3,
        "top_kernels": [{"name": n, "ms": v[0] / 1e3, "calls": v[1]}
                        for n, v in top],
    }


def profile_steps(cfg: dict, device=None, batch: int | None = None,
                  iters: int = 5, warmup: int = 3,
                  from_files: bool = False) -> dict:
    """Profile ``iters`` train steps of ``cfg`` (after ``warmup``) from
    its seeded init and return the views, per step."""
    from podtpu_torch.train.state import create_train_state
    from podtpu_torch.train.steps import make_train_step
    from podtpu_torch.train.trainer import put_batch

    device = resolve_device(device)
    on_cuda = device.type == "cuda"
    cfg = dict(cfg)
    if batch is not None:
        cfg["batch_size"] = batch
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(int(cfg.get("seed", 0)))
        state = create_train_state(cfg, device)
    step = make_train_step(cfg)

    if from_files:
        from podtpu_torch.train.run import make_loaders

        loader = make_loaders(cfg)[0]

        def batches():
            epoch = 0
            while True:
                loader.set_epoch(epoch)
                it = iter(loader)
                try:
                    for b in it:
                        b.pop("n_valid", None)
                        yield b
                finally:
                    it.close()  # joins the loader's producer
                epoch += 1

        feed = batches()

        def next_batch():
            host = next(feed)
            with record_function("input"):
                return put_batch(host, device)
    else:
        fixed = synthetic_batch(cfg, cfg["batch_size"], device)
        feed = None

        def next_batch():
            return fixed

    def sync():
        if on_cuda:
            torch.cuda.synchronize(device)

    ranges = None
    try:
        for _ in range(warmup):
            state, _ = step(state, next_batch())
        sync()
        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_cuda else [])
        ranges = _ModuleRanges(state.model)
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                state, metrics = step(state, next_batch())
            sync()
            profiled_ms = (time.perf_counter() - t0) * 1e3
        ranges.remove()
        ranges = None
        t0 = time.perf_counter()
        for _ in range(iters):
            state, _ = step(state, next_batch())
        sync()
        window_ms = (time.perf_counter() - t0) * 1e3
    finally:
        if ranges is not None:
            ranges.remove()
        if feed is not None:
            feed.close()
    results = prof.profiler.kineto_results
    views = (attribute(prof.events(), results.events(),
                       results.trace_start_ns()) if on_cuda
             else attribute(prof.events()))
    per = lambda v: (  # noqa: E731
        {k: per(x) for k, x in v.items()} if isinstance(v, dict) else v / iters)
    out = {
        "model": cfg["model"], "input_size": cfg["input_size"],
        "batch": cfg["batch_size"], "compute_dtype": cfg.get("compute_dtype"),
        "device": (torch.cuda.get_device_name(device) if on_cuda else "cpu"),
        "from_files": from_files, "iters": iters,
        "device_augment": bool(cfg.get("device_augment")),
        "device_geom": bool(cfg.get("device_geom")),
        "loss": float(metrics["loss"]),
        "window_ms_per_step": window_ms / iters,
        "profiled_window_ms_per_step": profiled_ms / iters,
        "busy_ms_per_step": views["busy_ms"] / iters,
        "idle_share": 1.0 - views["busy_ms"] / window_ms,
        "total_ms_per_step": views["total_ms"] / iters,
        "unattributed_ms_per_step": views["unattributed_ms"] / iters,
        "coverage": views["coverage"],
        "attributed_by": views["attributed_by"],
        # of the attributed time, what the fallback placed
        "fallback_ms_per_step": views["fallback_ms"] / iters,
        "parts_ms_per_step": per(views["parts_ms"]),
        "forward_by_module_ms_per_step": per(views["forward_by_module_ms"]),
        "backward_by_node_ms_per_step": per(views["backward_by_node_ms"]),
        "backward_other_nodes_ms_per_step": per(
            views["backward_other_nodes_ms"]),
        "top_kernels": [dict(k, ms_per_step=k["ms"] / iters,
                             calls_per_step=k["calls"] / iters)
                        for k in views["top_kernels"]],
    }
    for k in out["top_kernels"]:
        del k["ms"], k["calls"]
    return out


def main(argv=None) -> dict:
    from podtpu_torch.config import get_configs

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cfg", required=True, help="experiment yaml")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--from-files", action="store_true",
                    help="feed the steps from the config's train list")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    out = profile_steps(get_configs(args.cfg), args.device, args.batch,
                        args.iters, from_files=args.from_files)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
