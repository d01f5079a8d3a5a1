#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``podtpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line and raising on failure:

1. environment: torch/CUDA versions, the card's name and power limit;
2. build: every ``podtpu_torch/csrc/*.cu`` built with nvcc from the
   checkout, with the build's seconds and ptxas' resource report;
3. kernels: the suppression kernels held against their plain PyTorch
   version (keep masks must be identical) at the path's shapes (random and
   real YOLOv3 candidates, B=8 and 64) and at the edges of the design
   (ragged words, K = 300 and 513; K = ``MAX_K`` at B=2; nothing valid; a
   dense cluster with long chains), then timed: through the wrapper back to
   back (``ms``), on the device alone from a CUDA graph of 100 calls
   (``device_ms``), each of the two kernels alone (``mask_ms``,
   ``scan_ms``), at B=8 and B=64, with the kept boxes and the steps of
   the scan's dependent chain (counted on the host);
4. slice: YOLOv3-416, bf16, 20 VOC classes, seeded random weights carried
   in through the port's weight loader, served through ``Engine`` and
   ``MicroBatcher`` (batch 8) from several threads. The kernel counters are
   zeroed just before and read just after; every dispatch must have
   launched the suppression kernel, and no tensor of the path may lie on
   the CPU. Then forward / decode / NMS / total ms per batch at B=8 and 64;
5. reference: a 64 px float32 model on the card against the same model on
   the CPU (TF32 off), heads and detections;
6. stem kernels: the four kernels of the fused stem (``csrc/stem_fused.cu``)
   against their plain versions at 416 px, B=8, in bf16 and float32 (TF32
   off), each kernel on the same inputs and the whole op forward and
   backward from one seeded cotangent, with planted backward faults that
   must fail those checks; in bf16 forward and backward must agree
   exactly on which pool windows are positive (all four kernels share one
   conv core); then at the train step's B=64 in bf16 each kernel checked
   again and timed beside its bound, its plain version and the stock
   composition conv2d -> batch_norm(training) -> relu -> max_pool2d;
7. train: ``configs/yolov3_voc.yaml`` unchanged (416 px, bf16, batch 64),
   seeded weights carried in through the weight loader, a synthetic batch
   (uniform images, 8 boxes each), ``create_train_state`` and
   ``make_train_step``: 3 warm-up and 10 timed steps with the kernel
   counters zeroed around them (exactly one launch per stem kernel per
   step), no CPU tensor on a step, a finite loss, moving BN statistics;
   ms per step, img/s and the forward / loss / backward / optimizer split;
8. train reference: two 64 px float32 train steps on the card (the stem's
   kernels) against the same steps on the CPU (the plain version), the
   second also from the card's state; beside them the card with the
   stem's plain version, as a witness of the card's rounding alone.

The line before the last is ``nvidia-smi``'s name and power limit; the last
line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or without
the rest of the repository beside it, the script exits non-zero and prints
no result.
"""

from __future__ import annotations

import copy
import json
import os
import re
import subprocess
import sys
import threading
import time
from contextlib import nullcontext

import numpy as np
import torch
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): HBM3 bytes/s, the
# float32 rate outside the tensor cores, the bf16 tensor-core rate
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
# operations per IoU pair in the suppression loop: 2 min, 2 max, 2 sub,
# 2 clamps, 1 mul, 3 add/sub, 1 div, 1 compare
IOU_OPS = 14
SEED = 0
# the TPU kernel greedy_suppress replaces (pallas_greedy_suppress)
REPLACES = "podtpu/ops/pallas/nms_kernel.py:88"
# the stem kernels: the TPU kernel each replaces (make_fused_stem's calls),
# and the float32 operations each does per conv output beside the conv:
# stats sum, square-add (3); emit mul, add, relu, pool max (4); bwd_sums
# mul, add, relu and routing compares (4), xhat (2), two accumulations (3);
# bwd_dw mul, add, routing (4), xhat (2), d_pre (4)
STEM_REPLACES = {
    "stats": "podtpu/ops/pallas/stem_fused.py:314",
    "emit": "podtpu/ops/pallas/stem_fused.py:326",
    "bwd_sums": "podtpu/ops/pallas/stem_fused.py:339",
    "bwd_dw": "podtpu/ops/pallas/stem_fused.py:352",
}
STEM_EPILOGUE_OPS = {"stats": 3, "emit": 4, "bwd_sums": 9, "bwd_dw": 10}


def emit(obj):
    print(json.dumps(obj), flush=True)


def ptxas_report(log: str) -> dict:
    """{kernel: {"registers", "smem_bytes", "spill_bytes"}} from the output
    of ``nvcc -Xptxas -v``; the kernel's name is cut out of the mangled
    entry name, with its template arguments as ptxas spells them."""
    report, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            k = re.search(r"\d([a-z][a-z_]*_kernel)(I\w+?E)?E", m.group(1))
            name = (k.group(1) + (k.group(2) or "")) if k else m.group(1)
            report[name] = {}
        elif name and "spill" in ln:
            report[name]["spill_bytes"] = sum(
                int(v) for v in re.findall(r"(\d+) bytes spill", ln))
        elif name and "registers" in ln:
            report[name]["registers"] = int(
                re.search(r"Used (\d+) registers", ln).group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            report[name]["smem_bytes"] = int(sm.group(1)) if sm else 0
    return report


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device ms of ``fn()`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def random_weights(model, seed: int) -> dict[str, np.ndarray]:
    """Seeded weights in podtpu's flat layout for ``model``'s keys:
    He-normal kernels, non-trivial BN affine and running statistics."""
    from podtpu_torch.export.weights import flat_key

    rng = np.random.default_rng(seed)
    flat = {}
    for name, t in model.state_dict().items():
        key, shape = flat_key(name), tuple(t.shape)
        if key.endswith("kernel"):  # HWIO
            o, i, kh, kw = shape
            arr = rng.normal(0.0, np.sqrt(2.0 / (i * kh * kw)), (kh, kw, i, o))
        elif key.endswith("scale"):
            arr = rng.uniform(0.5, 1.5, shape)
        elif key.endswith("var"):
            arr = rng.uniform(0.5, 2.0, shape)
        else:
            arr = rng.normal(0.0, 0.1, shape)
        flat[key] = arr.astype(np.float32)
    return flat


def suppress_bound(boxes, valid, thr):
    """(bound_ms, bound_by, bytes, ops) of greedy suppression on these
    inputs: each input read once and the keep mask written once, and the
    IoU pairs this data's greedy loop needs (kept i against the j > i still
    kept at step i)."""
    from podtpu_torch.ops.boxes import pairwise_iou

    sup = (pairwise_iou(boxes, boxes) > thr).cpu().numpy()
    keep = valid.cpu().numpy().copy()
    pairs = 0
    for i in range(keep.shape[1]):
        alive = keep[:, i]
        if not alive.any():
            continue
        rest = keep[alive, i + 1:]
        pairs += int(rest.sum())
        keep[alive, i + 1:] = rest & ~sup[alive, i, i + 1:]
    nbytes = boxes.numel() * 4 + valid.numel() + valid.numel()
    ops = IOU_OPS * pairs
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def dense_cluster(rng, b, k, device):
    """Overlapping boxes of one class, all valid. In the first half of the
    batch 10 px squares 3 px apart: each removes the next and not the one
    after, so greedy keeps every other box, each decided by the one removed
    before it (a chain as long as the image, across every word). In the
    second half boxes packed into a 60 px square (long runs of removals)."""
    x = np.arange(k, dtype=np.float32) * np.float32(3.0)
    z = np.zeros(k, np.float32)
    slide = np.stack([x, z, x + 10, z + 10], -1)
    c = rng.uniform(0, 60, (b - b // 2, k, 2))
    wh = rng.uniform(20, 60, (b - b // 2, k, 2))
    packed = np.concatenate([c - wh / 2, c + wh / 2], -1)
    boxes = np.concatenate([np.broadcast_to(slide, (b // 2, k, 4)), packed])
    return (torch.from_numpy(boxes.astype(np.float32)).to(device),
            torch.ones((b, k), dtype=torch.bool, device=device))


def yolo_candidates(model, decoder, cfg, images):
    """{b: (boxes, valid)}: what the serving path hands suppression for
    ``images`` (score-sorted class-offset boxes and their validity)."""
    from podtpu_torch.ops.nms import _select_candidates
    from podtpu_torch.train.steps import _as_input

    out = {}
    with torch.inference_mode():
        for b, x in images.items():
            cand = _select_candidates(decoder(model(_as_input(x))),
                                      float(cfg["conf_threshold"]),
                                      int(cfg["top_k_candidates"]))
            out[b] = (cand[2].contiguous(), cand[1])
    return out


def graph_ms(fn, calls: int = 100, replays: int = 5) -> float:
    """Device ms of one ``fn()``: ``calls`` calls captured in one CUDA graph
    and replayed, so that the host's enqueue is not in the time."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def profiler_ms(fn, calls: int = 100) -> float:
    """Device ms of one ``fn()``: its kernels' times in a ``torch.profiler``
    trace of ``calls`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return us / 1e3 / calls


def device_ms(fn, calls: int = 100) -> tuple[float, str]:
    """(ms, how): from a CUDA graph, or where capture fails from the
    profiler's kernel times."""
    try:
        return graph_ms(fn, calls), "cuda_graph"
    except RuntimeError as exc:
        return profiler_ms(fn, calls), f"torch.profiler ({exc})"


def suppress_halves(boxes, valid, thr):
    """(mask_ms, scan_ms, keep): ``csrc/nms_suppress.cu``'s two kernels
    through their own C entry points on scratch made once, each timed by
    :func:`device_ms`, and the keep mask the two give."""
    from podtpu_torch.ops.kernels import nms_kernel as nk

    b, k = valid.shape
    mask = torch.empty((b, k, nk.mask_words(k)), dtype=torch.int64,
                       device=boxes.device)
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)

    def call(name, *args):
        err = nk._kernel(name)(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"podtpu_nms_{name}: cudaError {err}")

    def run_mask():
        call("iou_mask", boxes.data_ptr(), mask.data_ptr(), b, k, thr)

    def run_scan():
        call("scan", mask.data_ptr(), valid.data_ptr(), keep.data_ptr(), b, k)

    mask_ms, scan_ms = device_ms(run_mask)[0], device_ms(run_scan)[0]
    run_mask()
    run_scan()
    return mask_ms, scan_ms, keep


def chain_steps(boxes, valid, thr) -> dict:
    """The dependent steps of ``csrc/nms_suppress.cu``'s scan on these
    inputs, counted on the host: in each 64-box word the chain takes, in
    index order, the boxes still alive whose row meets a box of the word
    alive when the word began; the other kept boxes cost no step. Returns
    the total and the largest count per image (the images run side by
    side, so the largest is the one the time sees)."""
    from podtpu_torch.ops.boxes import pairwise_iou

    sup = (pairwise_iou(boxes, boxes) > thr).cpu().numpy()
    sup &= np.triu(np.ones(sup.shape[1:], bool), 1)
    steps = []
    for img, ok in zip(sup, valid.cpu().numpy()):
        removed, n = ~ok, 0
        for w0 in range(0, len(ok), 64):
            word = slice(w0, w0 + 64)
            alive0 = ~removed[word]
            meet = (img[word, word] & alive0[None, :]).any(1)
            for t in np.flatnonzero(alive0 & meet):
                if not removed[w0 + t]:
                    n += 1
                    removed[word] |= img[w0 + t, word]
            kept = np.flatnonzero(~removed[word]) + w0
            removed[w0 + 64:] |= img[kept, w0 + 64:].any(0)
        steps.append(n)
    return {"total": int(sum(steps)), "max_per_image": int(max(steps))}


def offset_boxes(rng, b, k, device):
    """Seeded class-offset xyxy boxes: 20 classes at podtpu's stride."""
    c = rng.uniform(0, 416, (b, k, 2))
    wh = rng.uniform(8, 160, (b, k, 2))
    cls = rng.integers(0, 20, (b, k, 1)).astype(np.float32)
    xyxy = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    boxes = (xyxy + cls * np.float32(16385.0)).astype(np.float32)
    valid = np.arange(k)[None, :] < rng.integers(k // 2, k + 1, (b, 1))
    return (torch.from_numpy(boxes).to(device),
            torch.from_numpy(valid).to(device))


def stem_bound(kind, b, h, w, itemsize):
    """(bound_ms, bound_by, {term: ms}) of one stem kernel at [b, h, w, 3]:
    the largest of the times of the resources that run at once. Bytes: x
    read once, the weights and vectors, the pooled output or cotangent
    once. Tensor cores (bf16): the conv's multiply-adds, twice for dW.
    float32 pipes: the epilogue's operations, and in float32 the conv's."""
    px = b * h * w
    nbytes = px * 3 * itemsize + 27 * 32 * 4
    if kind != "stats":
        nbytes += (px // 4) * 32 * itemsize + 7 * 32 * 4
    conv = 2 * 27 * 32 * px * (2 if kind == "bwd_dw" else 1)
    f32_ops = STEM_EPILOGUE_OPS[kind] * px * 32
    terms = {"bytes": nbytes / PEAK_BYTES_S * 1e3}
    if itemsize == 2:
        terms["conv_tensor_cores"] = conv / PEAK_BF16_FLOPS * 1e3
    else:
        f32_ops += conv
    terms["float32_pipes"] = f32_ops / PEAK_F32_FLOPS * 1e3
    by = max(terms, key=terms.get)
    return terms[by], "bytes" if by == "bytes" else "operations", terms


def stem_inputs(b, dtype, dev, seed):
    """Seeded stem operands at 416 px: images in [0, 1), He-normal HWIO
    weights, BN affine, and a random normal pooled cotangent."""
    r = np.random.default_rng(seed)
    x = torch.from_numpy(r.random((b, 416, 416, 3), np.float32))
    w = r.normal(0.0, np.sqrt(2.0 / 27), (3, 3, 3, 32)).astype(np.float32)
    scale = r.uniform(0.5, 1.5, 32).astype(np.float32)
    bias = r.normal(0.0, 0.1, 32).astype(np.float32)
    g = r.normal(0.0, 1.0, (b, 208, 208, 32)).astype(np.float32)
    as_t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return (x.to(dev).to(dtype), as_t(w), as_t(scale), as_t(bias),
            as_t(g).to(dtype))


def rel_err(got, want):
    """max |got - want| / max |want|."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()).clamp_min(1e-30))


def pooled_check(got, want, dtype):
    """(ok, stats) of a pooled output against its plain version: float32
    within 1e-5 of the output's scale (mean and var summed in another
    order scale it by a few 1e-6); bf16 differing on at most 1e-3 of the
    elements, each by at most 2^-7 of the largest (the conv's summation
    order differs from cuDNN's, so a pre-activation may round to the
    neighbouring bf16 value)."""
    diff = (got.float() - want.float()).abs()
    frac, mx = float((diff > 0).float().mean()), float(diff.max())
    if dtype == torch.float32:
        ok = mx <= 1e-5 * max(1.0, float(want.float().abs().max()))
    else:
        ok = frac <= 1e-3 and mx <= 2.0 ** -7 * float(want.float().abs().max())
    return ok, {"max_abs": mx, "differing": frac}


# per-kernel limits against the plain version in the same dtype, and the
# whole op's gradient limit (bf16: cosine with the plain version in float32)
STEM_TOL = {torch.float32: {"stats": 1e-4, "bwd": 1e-4},
            torch.bfloat16: {"stats": 1e-3, "bwd_cos": 0.995, "bwd_rel": 2e-3,
                             "op": 0.99}}


def stem_kernel_checks(sk, x, w, scale, bias, g, eps):
    """Each stem kernel against its plain version on the same inputs.

    Returns (ok, checks, max_abs_err per kernel, the [32] vectors the
    backward kernels took, the plain dW)."""
    dtype, t = x.dtype, STEM_TOL[x.dtype]
    n = x.shape[0] * x.shape[1] * x.shape[2]
    s_k, s_r = sk.stem_stats(x, w), sk.stem_stats_reference(x, w)
    c = {"stats_rel": rel_err(s_k, s_r),
         "stats_deterministic": bool(torch.equal(s_k, sk.stem_stats(x, w)))}
    mean = s_r[0] / n
    var = (s_r[1] / n - mean * mean).clamp_min(0.0)
    rinv = torch.rsqrt(var + eps)
    inv = rinv * scale
    mul = inv.to(dtype).float()
    add = (bias - mean * inv).to(dtype).float()
    p_k = sk.stem_emit(x, w, mul, add)
    ok_emit, c["emit"] = pooled_check(
        p_k, sk.stem_emit_reference(x, w, mul, add), dtype)
    c["emit_deterministic"] = bool(torch.equal(
        p_k, sk.stem_emit(x, w, mul, add)))
    u_k = sk.stem_bwd_sums(x, w, mul, add, mean, rinv, g)
    u_r = sk.stem_bwd_sums_reference(x, w, mul, add, mean, rinv, g)
    c0, c1 = u_r[0] / n, u_r[1] / n
    vecs = (mul, add, mean, rinv, inv, c0, c1)
    d_k = sk.stem_bwd_dw(x, w, *vecs, g)
    d_r = sk.stem_bwd_dw_reference(x, w, *vecs, g)
    c["bwd_sums_rel"], c["bwd_dw_rel"] = rel_err(u_k, u_r), rel_err(d_k, d_r)
    c["bwd_sums_cos"], c["bwd_dw_cos"] = cosine(u_k, u_r), cosine(d_k, d_r)
    c["bwd_sums_deterministic"] = bool(torch.equal(
        u_k, sk.stem_bwd_sums(x, w, mul, add, mean, rinv, g)))
    c["bwd_dw_deterministic"] = bool(torch.equal(
        d_k, sk.stem_bwd_dw(x, w, *vecs, g)))
    agree = True
    if dtype == torch.bfloat16:
        # with a cotangent of ones, bwd_sums' first row counts the pool
        # windows of a channel whose max is positive (an integer below
        # 2^24, exact in float32): the windows emit wrote as positive,
        # since both kernels make pre and y by one instruction sequence
        positive = sk.stem_bwd_sums(x, w, mul, add, mean, rinv,
                                    torch.ones_like(g))[0]
        emitted = (p_k > 0).sum(dim=(0, 1, 2)).float()
        c["forward_backward_agree"] = {
            "channels_differing": int((positive != emitted).sum()),
            "windows_differing": float((positive - emitted).abs().sum()),
            "windows_positive": float(emitted.sum())}
        agree = c["forward_backward_agree"]["channels_differing"] == 0
    torch.cuda.synchronize()
    bwd_rel = max(c["bwd_sums_rel"], c["bwd_dw_rel"])
    if dtype == torch.float32:
        bwd_ok = bwd_rel <= t["bwd"]
    else:
        bwd_ok = (bwd_rel <= t["bwd_rel"] and
                  min(c["bwd_sums_cos"], c["bwd_dw_cos"]) >= t["bwd_cos"])
    ok = (ok_emit and bwd_ok and agree and c["stats_deterministic"]
          and c["emit_deterministic"] and c["bwd_sums_deterministic"] and c["bwd_dw_deterministic"]
          and c["stats_rel"] <= t["stats"])
    err = {"stats": float((s_k - s_r).abs().max()),
           "emit": c["emit"]["max_abs"],
           "bwd_sums": float((u_k - u_r).abs().max()),
           "bwd_dw": float((d_k - d_r).abs().max())}
    return ok, c, err, vecs, d_r


def dw_routed_last(sk, x, w, mul, add, mean, rinv, inv, c0, c1, g):
    """A planted fault: the plain dW with the pooled cotangent sent to the
    last window position holding the max instead of the first. Flipping
    both spatial axes reverses the order within every 2x2 window, so the
    first match of the flipped map is the last match of the map."""
    pre = sk._conv(x, w)
    y = sk._affine(pre, mul, add)
    d = sk._routed(y.flip(2, 3), g.flip(1, 2)).flip(2, 3)
    v = lambda t: t[:, None, None]  # noqa: E731
    dpre = (v(inv) * (d - v(c0) - sk._xhat(pre, mean, rinv) * v(c1))).to(x.dtype)
    dw = torch.nn.grad.conv2d_weight(x.permute(0, 3, 1, 2).float(),
                                     (32, 3, 3, 3), dpre.float(), padding=1)
    return dw.permute(2, 3, 1, 0)


def stem_phase(dev, card):
    """Phase 6; returns the kernels-line entries of the four stem kernels."""
    from podtpu_torch.ops.kernels import stem_kernel as sk

    n_eps = 1e-5
    checks = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        t = STEM_TOL[dtype]
        x, w, scale, bias, g = stem_inputs(8, dtype, dev, SEED + 3)
        ok_k, c, _, vecs, d_r = stem_kernel_checks(sk, x, w, scale, bias, g,
                                                   n_eps)
        # the whole op: kernels (autograd.Function) against plain autograd,
        # in the compute dtype and, for bf16, in float32 on the same
        # bf16-valued inputs: the plain bf16 autograd rounds each partial
        # gradient of the batch norm to bf16 before they cancel in
        # d - mean(d) - xhat * mean(d * xhat), which at this n loses dW.
        # Pool windows that tie after bf16 rounding route the cotangent to
        # another pixel than in float32, a random O(1) term each, which
        # bounds any bf16 dW's cosine with float32 near 0.99
        outs = {}
        for impl in ("kernels", "plain", "plain_f32"):
            if impl == "plain_f32" and dtype == torch.float32:
                continue
            w0 = w.to(dtype).float() if impl == "plain_f32" else w
            tw, ts, tb = (t_.clone().requires_grad_(True)
                          for t_ in (w0, scale, bias))
            if impl == "kernels":
                pooled, m, v = sk.StemPoolFunction.apply(x, tw, ts, tb, n_eps)
            else:
                pdt = torch.float32 if impl == "plain_f32" else dtype
                pooled, m, v = sk.stem_pool_reference_torch(
                    x.to(pdt), tw, ts, tb, n_eps, pdt)
            (pooled.float() * g.float()).sum().backward()
            outs[impl] = (pooled.detach(), m.detach(), v.detach(), tw.grad,
                          ts.grad, tb.grad)
        kp, km, kv, kdw, kds, kdb = outs["kernels"]
        pp, pm, pv, pdw, pds, pdb = outs["plain"]
        ok_op, c["op_pooled"] = pooled_check(kp, pp, dtype)
        c["op_mean_rel"], c["op_var_rel"] = rel_err(km, pm), rel_err(kv, pv)
        ref = outs["plain_f32" if dtype == torch.bfloat16 else "plain"]
        grads = {"dw": (kdw, ref[3]), "dscale": (kds, ref[4]),
                 "dbias": (kdb, ref[5])}
        c["op_grad_rel"] = {k: rel_err(a, b) for k, (a, b) in grads.items()}
        c["op_grad_cos"] = {k: cosine(a, b) for k, (a, b) in grads.items()}
        if dtype == torch.float32:
            op_ok = max(c["op_grad_rel"].values()) <= t["bwd"]
        else:
            op_ok = min(c["op_grad_cos"].values()) >= t["op"]
            plain = {"dw": pdw, "dscale": pds, "dbias": pdb}
            c["plain_bf16_grad_cos_vs_f32"] = {
                k: cosine(plain[k], b) for k, (_, b) in grads.items()}
            c["kernels_grad_cos_vs_plain_bf16"] = {
                k: cosine(a, plain[k]) for k, (a, _) in grads.items()}
            # planted faults: each must fail the check meant to catch it,
            # or that check's limit is too loose to tell a wrong backward
            mul, add, mean, rinv, inv, c0, c1 = vecs
            zero = torch.zeros_like(c0)
            no_c0 = sk.stem_bwd_dw(x, w, mul, add, mean, rinv, inv, zero, c1, g)
            no_c1 = sk.stem_bwd_dw(x, w, mul, add, mean, rinv, inv, c0, zero, g)
            last = dw_routed_last(sk, x, w, *vecs, g)
            faults = {
                "dw_without_c0": {"op_dw_cos": cosine(no_c0, ref[3])},
                "dw_without_c1": {"op_dw_cos": cosine(no_c1, ref[3])},
                "dw_routed_to_last_max": {
                    "op_dw_cos": cosine(last, ref[3]),
                    "bwd_dw_cos": cosine(last, d_r),
                    "bwd_dw_rel": rel_err(last, d_r)}}
            for f in faults.values():
                f["caught"] = (f["op_dw_cos"] < t["op"]
                               or f.get("bwd_dw_cos", 1.0) < t["bwd_cos"]
                               or f.get("bwd_dw_rel", 0.0) > t["bwd_rel"])
            c["planted_faults"] = faults
            if not all(f["caught"] for f in faults.values()):
                raise AssertionError(f"a planted stem backward fault passes "
                                     f"the checks: {faults}")
        torch.cuda.synchronize()
        ok = (ok_k and ok_op and op_ok
              and max(c["op_mean_rel"], c["op_var_rel"]) <= t["stats"])
        checks[name] = c
        if not ok:
            raise AssertionError(f"stem kernels differ from their plain "
                                 f"versions in {name}: {c}")

    # at the train step's shape (B=64, 416 px, bf16): the same per-kernel
    # checks, then each kernel timed
    x, w, scale, bias, g = stem_inputs(64, torch.bfloat16, dev, SEED + 4)
    ok, checks["bfloat16_B64"], max_err, vecs, _ = stem_kernel_checks(
        sk, x, w, scale, bias, g, n_eps)
    if not ok:
        raise AssertionError(f"stem kernels differ from their plain versions "
                             f"at B=64 bf16: {checks['bfloat16_B64']}")
    mul, add, mean, rinv = vecs[:4]
    args = {"stats": (x, w), "emit": (x, w, mul, add),
            "bwd_sums": (x, w, mul, add, mean, rinv, g),
            "bwd_dw": (x, w, *vecs, g)}
    kern = {"stats": sk.stem_stats, "emit": sk.stem_emit,
            "bwd_sums": sk.stem_bwd_sums, "bwd_dw": sk.stem_bwd_dw}
    plain = {"stats": sk.stem_stats_reference, "emit": sk.stem_emit_reference,
             "bwd_sums": sk.stem_bwd_sums_reference,
             "bwd_dw": sk.stem_bwd_dw_reference}
    timing = {}
    for k in STEM_REPLACES:
        bound_ms, bound_by, terms = stem_bound(k, 64, 416, 416, 2)
        timing[k] = {"ms": cuda_ms(lambda: kern[k](*args[k]), 20),
                     "plain_ms": cuda_ms(lambda: plain[k](*args[k]), 5),
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "bound_terms_ms": terms}

    # the whole op, forward + backward: kernels, plain, stock composition
    def op(fn):
        tw, ts, tb = (t.clone().requires_grad_(True) for t in (w, scale, bias))
        pooled = fn(tw, ts, tb)
        pooled.backward(g if pooled.shape == g.shape
                        else g.permute(0, 3, 1, 2))

    def stock(tw, ts, tb):
        pre = torch.nn.functional.conv2d(
            x.permute(0, 3, 1, 2), tw.to(torch.bfloat16).permute(3, 2, 0, 1),
            padding=1)
        y = torch.nn.functional.batch_norm(pre, None, None, ts, tb,
                                           training=True, eps=n_eps)
        return torch.nn.functional.max_pool2d(torch.relu(y), 2, 2)

    whole = {
        "kernels_fwd_bwd_ms": cuda_ms(lambda: op(lambda tw, ts, tb: sk.StemPoolFunction.apply(x, tw, ts, tb, n_eps)[0]), 10),
        "plain_fwd_bwd_ms": cuda_ms(lambda: op(lambda tw, ts, tb: sk.stem_pool_reference_torch(x, tw, ts, tb, n_eps, torch.bfloat16)[0]), 5),
        "stock_composition_fwd_ms": cuda_ms(lambda: stock(w, scale, bias), 10),
        "stock_composition_fwd_bwd_ms": cuda_ms(lambda: op(stock), 10),
    }
    emit({"phase": "stem_kernels", "checks": checks, "tolerance": {
        "float32": "stats, mean, var, sums, dW and the op's grads <= 1e-4 of "
                   "their max; pooled <= 1e-5 of its max",
        "bfloat16": "stats, mean, var <= 1e-3 of their max; pooled differs "
                    "on <= 1e-3 of elements by <= 2^-7 of its max; sums "
                    "and dW cosine >= 0.995 and <= 2e-3 of their max; the "
                    "op's grads cosine >= 0.99 with the plain version in "
                    "float32 on the same bf16 inputs (bf16 pool ties); "
                    "each planted fault must fail one of these; the "
                    "windows emit wrote as positive equal those bwd_sums "
                    "counts under a cotangent of ones, in every channel"},
        "timing_B64_bf16": timing,
        "whole_op_B64_bf16": whole,
        "library_note": "no single PyTorch call computes the fused stem; "
                        "the stock composition is conv2d -> batch_norm("
                        "training) -> relu -> max_pool2d",
        "card": card})
    return [{
        "name": f"stem_{k}", "route": "cuda",
        "source": "podtpu_torch/csrc/stem_fused.cu",
        "replaces": STEM_REPLACES[k], "launches": None,
        "max_abs_err": max_err[k], "ms": timing[k]["ms"],
        "plain_ms": timing[k]["plain_ms"], "bound_ms": timing[k]["bound_ms"],
        "bound_by": timing[k]["bound_by"], "library_ms": None,
        "library_note": "no single PyTorch call computes this pass of the "
                        "fused stem (see stock_composition in phase "
                        "stem_kernels)",
    } for k in STEM_REPLACES]


def synthetic_annotations(cfg, batch, seed):
    """8 boxes per image as tools/bench_family.py draws them, padded."""
    from podtpu_torch.data.loader import pad_annotations

    r = np.random.default_rng(seed)
    boxes = []
    for _ in range(batch):
        rows = []
        for _ in range(min(8, cfg["max_annots"])):
            cx, cy = r.uniform(0.1, 0.9, 2)
            w, h = r.uniform(0.05, 0.4, 2)
            rows.append([cx, cy, w, h, r.integers(0, cfg["num_classes"])])
        boxes.append(np.asarray(rows, np.float32))
    return pad_annotations(boxes, cfg["max_annots"])


def train_phase(cfg, flat, dev, card):
    """Phase 7; returns the stem kernels' launch counts of the timed run."""
    from podtpu_torch.losses import build_loss
    from podtpu_torch.ops.kernels.nms_kernel import greedy_suppress
    from podtpu_torch.ops.kernels.stem_kernel import stem_fused
    from podtpu_torch.train.state import create_train_state
    from podtpu_torch.train.steps import make_train_step

    b = int(cfg["batch_size"])
    if (b, cfg["max_annots"], cfg["optimizer"], cfg["scheduler"]) != (
            64, 64, "sgd", "yolo_lr"):
        raise AssertionError("configs/yolov3_voc.yaml is not the batch-64 "
                             "nesterov-SGD yolo_lr recipe")
    torch.cuda.reset_peak_memory_stats()
    state = create_train_state(cfg, dev, weights=flat)
    step = make_train_step(cfg)
    r = np.random.default_rng(SEED + 5)
    size = int(cfg["input_size"])
    img = torch.from_numpy(r.random((b, size, size, 3), np.float32)).to(dev)
    annot = torch.from_numpy(synthetic_annotations(cfg, b, SEED)).to(dev)
    batch = {"img": img, "annot": annot}
    bns = {k: v.clone() for k, v in state.model.state_dict().items()
           if k in ("backbone.stage0.conv0.bn.running_mean",
                    "backbone.stage0.conv0.bn.running_var",
                    "p3_head.expand.bn.running_var")}
    losses = []
    for _ in range(3):
        state, m = step(state, batch)
        losses.append(m["loss"])
    spy = _CpuTensorSpy()
    with spy:
        state, m = step(state, batch)
    losses.append(m["loss"])
    if spy.cpu_ops:
        raise AssertionError(f"CPU tensors on the train step: "
                             f"{sorted(set(spy.cpu_ops))}")
    torch.cuda.synchronize()
    for k in stem_fused.launches:
        stem_fused.launches[k] = 0
    greedy_suppress.launches = 0
    iters = 10
    t0 = time.perf_counter()
    for _ in range(iters):
        state, m = step(state, batch)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / iters
    launches = dict(stem_fused.launches)
    if any(v != iters for v in launches.values()) or greedy_suppress.launches:
        raise AssertionError(f"{iters} train steps launched the stem kernels "
                             f"{launches} times and the suppression kernel "
                             f"{greedy_suppress.launches} times")
    loss_vals = [float(v) for v in losses]
    if not all(np.isfinite(loss_vals)):
        raise AssertionError(f"non-finite train loss: {loss_vals}")
    moved = {k: float((state.model.state_dict()[k] - v).abs().max())
             for k, v in bns.items()}
    if min(moved.values()) <= 0.0:
        raise AssertionError(f"BN running statistics did not move: {moved}")

    # forward / loss / backward / optimizer split, CUDA events between them
    loss_fn = build_loss(cfg)
    x = img
    split = {"forward": 0.0, "loss": 0.0, "backward": 0.0, "optimizer": 0.0}
    reps = 3
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        preds = state.model(x)
        ev[1].record()
        loss = loss_fn(preds, annot)
        ev[2].record()
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        ev[3].record()
        state.apply_gradients()
        ev[4].record()
        torch.cuda.synchronize()
        for i, k in enumerate(split):
            split[k] += ev[i].elapsed_time(ev[i + 1]) / reps
    emit({"phase": "train", "model": "yolov3", "input_size": size,
          "compute_dtype": cfg["compute_dtype"], "batch": b,
          "timed_steps": iters, "launches": launches,
          "loss_first_last": [loss_vals[0], loss_vals[-1]],
          "bn_stats_moved": moved, "ms_per_step": step_ms,
          "img_per_s": b * 1e3 / step_ms, "split_ms": split,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "card": card})
    return launches


def _update(after, before):
    """The parameter update between two flat states, as one vector."""
    return np.concatenate([(after[k] - before[k]).ravel()
                           for k in sorted(before) if k.startswith("params")])


def _distance(got, want, start):
    """How far one train step's result lies from another's: the loss, the
    BN statistics, the parameter update from ``start`` and the raw
    gradient. ``got`` and ``want`` are (loss, flat state, gradient)."""
    (gl, gf, gg), (wl, wf, wg) = got, want
    ug, uw = _update(gf, start), _update(wf, start)
    nrm = np.linalg.norm
    return {
        "loss_rel": abs(gl - wl) / abs(wl),
        "stats_rel": max(rel_err(torch.from_numpy(gf[k]),
                                 torch.from_numpy(wf[k]))
                         for k in wf if k.startswith("batch_stats")),
        "update_rel_norm": float(nrm(ug - uw) / nrm(uw)),
        "update_cos": float(ug @ uw / (nrm(ug) * nrm(uw))),
        "grad_rel_norm": float(nrm(gg - wg) / nrm(wg)),
        "grad_cos": float(gg @ wg / (nrm(gg) * nrm(wg))),
    }


class _PlainStem:
    """Within it the model's fused stem runs its plain version on the card
    too (the witness run of phase 8)."""

    def __enter__(self):
        from podtpu_torch.models import stem
        from podtpu_torch.ops.kernels.stem_kernel import (
            stem_pool_reference_torch)

        self._stem, self._fused = stem, stem.stem_fused
        stem.stem_fused = stem_pool_reference_torch

    def __exit__(self, *exc):
        self._stem.stem_fused = self._fused


def train_reference_phase(cfg, dev):
    """Phase 8: two 64 px float32 train steps on the card against the same
    steps on the CPU, and a witness of what the card's rounding alone does.

    Runs, each two steps from the carried weights: ``cpu`` (the stem's
    plain version), ``cuda`` (the stem's kernels) and ``cuda_plain_stem``
    (the card with the stem's plain version). Held to the limits: step 1 of
    ``cuda`` against ``cpu``, and step 2 of ``cuda`` against a CPU step
    from the card's state after step 1 (parameters, BN statistics,
    momentum). Printed beside them, the two free-running steps of both card
    runs against the CPU and against each other: the update at random
    weights is ill-conditioned in float32 (tests/test_torch_train.py), so
    one step's rounding differences grow in the next."""
    from podtpu_torch.export.weights import flat_from_state_dict
    from podtpu_torch.models.factory import build_model
    from podtpu_torch.train.state import create_train_state
    from podtpu_torch.train.steps import make_train_step

    small = dict(cfg, input_size=64, compute_dtype="float32", scheduler=None,
                 batch_size=4)
    flat = random_weights(build_model(small, "cpu"), SEED + 6)
    r = np.random.default_rng(SEED + 7)
    img = torch.from_numpy(r.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8))
    annot = torch.from_numpy(synthetic_annotations(small, 4, SEED + 8))
    step = make_train_step(small)

    def run_step(state, d):
        state, m = step(state, {"img": img.to(d), "annot": annot.to(d)})
        grad = np.concatenate([p.grad.detach().double().cpu().numpy().ravel()
                               for p in state.model.parameters()])
        return state, (float(m["loss"]), flat_from_state_dict(state.model),
                       grad)

    runs, after1 = {}, None
    for name, d in (("cpu", "cpu"), ("cuda", dev), ("cuda_plain_stem", dev)):
        state = create_train_state(small, d, weights=flat)
        with _PlainStem() if name == "cuda_plain_stem" else nullcontext():
            state, out1 = run_step(state, d)
            if name == "cuda":
                after1 = (copy.deepcopy(state.model.state_dict()),
                          copy.deepcopy(state.optimizer.state_dict()))
            state, out2 = run_step(state, d)
        runs[name] = (out1, out2)
    same = create_train_state(small, "cpu", weights=flat)
    same.model.load_state_dict(after1[0])
    same.optimizer.load_state_dict(after1[1])
    same.step = 1
    _, same2 = run_step(same, "cpu")

    start1 = runs["cuda"][0][1]
    pairs = (("cuda", "cpu"), ("cuda_plain_stem", "cpu"),
             ("cuda", "cuda_plain_stem"))
    res = {
        "step1": {f"{a}_vs_{b}": _distance(runs[a][0], runs[b][0], flat)
                  for a, b in pairs},
        "step2_same_state": {"cuda_vs_cpu": _distance(runs["cuda"][1], same2,
                                                      start1)},
        "step2_free_running": {f"{a}_vs_{b}": _distance(runs[a][1],
                                                        runs[b][1], flat)
                               for a, b in pairs},
    }
    emit({"phase": "train_reference", "input_size": 64, "dtype": "float32",
          "tf32": False, "lr": small["optimizer_options"]["lr"], **res,
          "tolerance": "cuda_vs_cpu at step 1 and at step 2 from the same "
                       "state: loss <= 1e-4 rel, BN statistics <= 1e-4 of "
                       "their max, update <= 10% of its norm with cosine >= "
                       "0.995 (float32 gradients at random weights: "
                       "tests/test_torch_train.py); cuda_vs_cpu's step-1 "
                       "update distance <= 2x cuda_plain_stem_vs_cpu's; "
                       "the free-running steps are readings"})
    held = (res["step1"]["cuda_vs_cpu"], res["step2_same_state"]["cuda_vs_cpu"])
    if not all(v["loss_rel"] <= 1e-4 and v["stats_rel"] <= 1e-4
               and v["update_rel_norm"] <= 0.1 and v["update_cos"] >= 0.995
               for v in held):
        raise AssertionError(f"card and CPU train steps disagree: {res}")
    # the kernels may take the card's first update no further from the
    # CPU's than the card's rounding alone takes it, within a factor 2
    s1 = res["step1"]
    if (s1["cuda_vs_cpu"]["update_rel_norm"]
            > 2.0 * s1["cuda_plain_stem_vs_cpu"]["update_rel_norm"]):
        raise AssertionError(f"the stem kernels move the first update "
                             f"further from the CPU than the card's "
                             f"rounding: {s1}")


class _CpuTensorSpy(TorchDispatchMode):
    """Records every op that takes or returns a CPU tensor (0-dim scalars
    aside)."""

    def __init__(self):
        super().__init__()
        self.cpu_ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        flat = tree_leaves((args, kwargs, out))
        if any(isinstance(t, torch.Tensor) and t.device.type == "cpu"
               and t.dim() > 0 for t in flat):
            self.cpu_ops.append(str(func))
        return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1

    from podtpu_torch.config import get_configs
    from podtpu_torch.export.weights import load_flat_weights
    from podtpu_torch.models.factory import build_model
    from podtpu_torch.ops.kernels import build
    from podtpu_torch.ops.kernels.nms_kernel import (
        MAX_K,
        greedy_suppress,
        greedy_suppress_reference,
    )
    from podtpu_torch.ops.kernels.stem_kernel import stem_fused
    from podtpu_torch.serve import Engine
    from podtpu_torch.train.steps import _as_input, _decoder_and_nms

    dev = torch.device("cuda")

    # 1. environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    card = f"{torch.cuda.get_device_name(0)} ({smi})"
    emit({"phase": "environment", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "device_count": torch.cuda.device_count()})

    # 2. build
    t0 = time.perf_counter()
    libs = build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {name: ptxas_report(build.build_log(name)) for name in libs}
    emit({"phase": "build", "seconds": round(build_s, 3),
          "libraries": {n: os.path.relpath(p, REPO) for n, p in libs.items()},
          "ptxas": ptxas})
    tc = {k: v for k, v in ptxas["stem_fused"].items() if "_tc_kernel" in k}
    if len(tc) != 4 or any(v.get("spill_bytes", 1) for v in tc.values()):
        raise AssertionError(f"the stem's tensor-core kernels spill, or are "
                             f"not four: {tc}")

    # the slice's config, model and weights (used by phases 3 and 4)
    cfg = get_configs(os.path.join(REPO, "configs", "yolov3_voc.yaml"))
    if (cfg["input_size"], cfg["num_classes"], cfg["compute_dtype"]) != (
            416, 20, "bfloat16"):
        raise AssertionError("configs/yolov3_voc.yaml is not YOLOv3-416 "
                             "bf16 on 20 classes")
    flat = random_weights(build_model(cfg, dev), SEED)
    engine = Engine(cfg, flat, device=dev, max_batch=8, window_ms=20.0)
    decoder, nms = _decoder_and_nms(cfg)
    thr = float(cfg["nms_iou_threshold"])
    top_k = int(cfg["top_k_candidates"])
    rng = np.random.default_rng(SEED)
    images = {b: torch.from_numpy(rng.integers(
        0, 256, (b, 416, 416, 3), dtype=np.uint8)).to(dev) for b in (8, 64)}

    # 3. the suppression kernels against their plain version, at the path's
    # shapes and at the edges of the design
    real = yolo_candidates(engine.model, decoder, cfg, images)
    with torch.inference_mode():
        cases = {f"random_B{b}": offset_boxes(rng, b, top_k, dev)
                 for b in (8, 64)}
        cases.update({f"yolov3_B{b}": real[b] for b in (8, 64)})
        cases.update({f"random_K{k}_B8": offset_boxes(rng, 8, k, dev)
                      for k in (300, 513)})
        cases[f"random_K{MAX_K}_B2"] = offset_boxes(rng, 2, MAX_K, dev)
        boxes = offset_boxes(rng, 8, top_k, dev)[0]
        cases["all_invalid_B8"] = (boxes, torch.zeros_like(boxes[..., 0],
                                                           dtype=torch.bool))
        cases["dense_cluster_B8"] = dense_cluster(rng, 8, top_k, dev)
        before = greedy_suppress.launches
        checks, max_abs_err, kept = [], 0.0, {}
        for name, (boxes, valid) in cases.items():
            got = greedy_suppress(boxes, valid, thr)
            torch.cuda.synchronize()
            want = greedy_suppress_reference(boxes, valid, thr)
            mismatches = int((got != want).sum())
            max_abs_err = max(max_abs_err, float(
                (got.float() - want.float()).abs().max()))
            kept[name] = {"total": int(got.sum()),
                          "max_per_image": int(got.sum(1).max())}
            checks.append({"case": name, "shape": list(boxes.shape),
                           "valid": int(valid.sum()), "kept": kept[name],
                           "mismatches": mismatches})
            if mismatches:
                raise AssertionError(f"greedy_suppress differs from its plain "
                                     f"version on {name}: {checks[-1]}")
        if greedy_suppress.launches != before + len(cases):
            raise AssertionError("greedy_suppress's launch counter did not "
                                 "move with its launches")
        # timed at the serving path's own shapes: real candidates, B=8, 64
        timing = {}
        for b in (8, 64):
            boxes, valid = real[b]
            run = lambda: greedy_suppress(boxes, valid, thr)  # noqa: E731
            t = timing[f"B{b}"] = {
                "ms": cuda_ms(run, 200 if b == 8 else 100, warmup=10)}
            t["device_ms"], t["device_ms_by"] = device_ms(run)
            t["mask_ms"], t["scan_ms"], halves = suppress_halves(boxes, valid,
                                                                 thr)
            t["kept"] = kept[f"yolov3_B{b}"]
            t["chain_steps"] = chain_steps(boxes, valid, thr)
            if not torch.equal(halves, greedy_suppress_reference(
                    boxes, valid, thr)):
                raise AssertionError(f"the two halves of the suppression "
                                     f"differ from the plain version at B={b}")
        boxes, valid = real[8]
        kernel_ms, dev_ms = timing["B8"]["ms"], timing["B8"]["device_ms"]
        plain_ms = cuda_ms(
            lambda: greedy_suppress_reference(boxes, valid, thr), 5)
        bound_ms, bound_by, nbytes, nops = suppress_bound(boxes, valid, thr)
        b64_ms = timing["B64"]["ms"]
    emit({"phase": "kernels", "checks": checks, "tolerance": "exact keep masks",
          "greedy_suppress": {"replaces": REPLACES, "launches": len(cases),
                              "mismatches": sum(c["mismatches"] for c in checks),
                              "shape": list(boxes.shape), "ms": kernel_ms,
                              "device_ms": dev_ms, "ms_B64": b64_ms,
                              "timing": timing, "plain_ms": plain_ms,
                              "bound_ms": bound_ms, "bound_by": bound_by,
                              "bytes": nbytes, "ops": nops, "card": card}})

    # 4. the slice: serve requests through Engine + MicroBatcher
    n_threads, per_thread = 4, 6
    reqs = rng.integers(0, 256, (n_threads * per_thread, 416, 416, 3),
                        dtype=np.uint8)
    results = [None] * len(reqs)

    def client(t):
        for i in range(t, len(reqs), n_threads):
            results[i] = engine.predict_array(reqs[i])

    engine.predict_array(reqs[0])  # warm-up dispatch, outside the count
    fills_before = sum(engine.stats.fills.values())
    greedy_suppress.launches = 0
    for k in stem_fused.launches:
        stem_fused.launches[k] = 0
    threads = [threading.Thread(target=client, args=(t,))
               for t in range(n_threads)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    serve_s = time.perf_counter() - t0
    launches = greedy_suppress.launches
    stem_launches = sum(stem_fused.launches.values())
    dispatches = sum(engine.stats.fills.values()) - fills_before
    engine.close()
    if any(t.is_alive() for t in threads) or any(r is None for r in results):
        raise AssertionError("not every request was answered")
    if launches == 0 or launches != dispatches:
        raise AssertionError(f"greedy_suppress launched {launches} times "
                             f"for {dispatches} dispatches")
    if stem_launches:
        raise AssertionError(f"serving (eval mode) launched the train-mode "
                             f"stem kernels {stem_launches} times")
    n_det = [r["num_detections"] for r in results]
    for r in results:
        for d in r["detections"]:
            box = np.array(d["box_cxcywh_input"] + [d["confidence"]])
            if not (np.isfinite(box).all() and 0 < d["confidence"] <= 1
                    and 0 <= d["class_id"] < 20):
                raise AssertionError(f"bad detection {d}")
    if not 0 < max(n_det) <= cfg["max_detections"]:
        raise AssertionError(f"detections per request out of range: {n_det}")

    serve = engine.serve
    spy = _CpuTensorSpy()
    with spy:
        dets, valid = serve(_as_input(images[8]))
    if spy.cpu_ops or dets.device.type != "cuda":
        raise AssertionError(f"CPU tensors on the serving path: "
                             f"{sorted(set(spy.cpu_ops))}")
    if dets.shape != (8, 100, 6) or not torch.isfinite(dets).all():
        raise AssertionError("serve output is not finite [8, 100, 6]")

    timings = {}
    with torch.inference_mode():
        for b, x in images.items():
            xf = _as_input(x)
            preds = engine.model(xf)
            cands = decoder(preds)
            iters = 20 if b == 8 else 5
            timings[f"B{b}"] = {
                "forward_ms": cuda_ms(lambda: engine.model(xf), iters),
                "decode_ms": cuda_ms(lambda: decoder(preds), iters),
                "nms_ms": cuda_ms(lambda: nms(cands), iters),
                "total_ms": cuda_ms(lambda: serve(xf), iters),
            }
    emit({"phase": "slice", "model": "yolov3", "input_size": 416,
          "compute_dtype": cfg["compute_dtype"], "num_classes": 20,
          "requests": len(reqs), "threads": n_threads, "micro_batch": 8,
          "dispatches": dispatches, "launches": {"greedy_suppress": launches},
          "detections_per_request": [min(n_det), max(n_det)],
          "serve_seconds": round(serve_s, 3),
          "latency_ms": engine.stats.snapshot()["latency_ms"],
          "ms_per_batch": timings, "card": card})

    # 5. a small float32 model on the card against the same on the CPU
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    small = dict(cfg, input_size=64, compute_dtype="float32")
    sflat = random_weights(build_model(small, "cpu"), SEED + 1)
    x = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    outs = {}
    for d in ("cpu", "cuda"):
        m = load_flat_weights(build_model(small, d), sflat)
        dec, nms_d = _decoder_and_nms(small)
        with torch.inference_mode():
            heads = m(_as_input(torch.from_numpy(x).to(d)))
            outs[d] = ([h.cpu() for h in heads],
                       [t.cpu() for t in nms_d(dec(heads))])
    head_err = max(float((a - b).abs().max())
                   for a, b in zip(outs["cpu"][0], outs["cuda"][0]))
    same_valid = torch.equal(outs["cpu"][1][1], outs["cuda"][1][1])
    det_err = float((outs["cpu"][1][0] - outs["cuda"][1][0]).abs().max())
    emit({"phase": "reference", "input_size": 64, "dtype": "float32",
          "tf32": False, "head_max_abs_err": head_err,
          "valid_equal": same_valid, "det_max_abs_err": det_err,
          "tolerance": "heads 1e-3 abs (conv summation order), "
                       "detections 1e-2 px with equal valid masks"})
    if head_err > 1e-3 or not same_valid or det_err > 1e-2:
        raise AssertionError("card and CPU disagree on the 64 px f32 model")

    # 6.-8. the training slice (TF32 stays off from phase 5)
    stem_entries = stem_phase(dev, card)
    train_launches = train_phase(cfg, flat, dev, card)
    for e in stem_entries:
        e["launches"] = train_launches[e["name"][len("stem_"):]]
    train_reference_phase(cfg, dev)

    emit({"kernels": [{
        "name": "greedy_suppress",
        "route": "cuda",
        "source": "podtpu_torch/csrc/nms_suppress.cu",
        "replaces": REPLACES,
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "device_ms": dev_ms,
        "ms_B64": b64_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "library_note": "no single PyTorch call computes greedy NMS "
                        "(torchvision.ops.nms is not installed)",
    }] + stem_entries})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
