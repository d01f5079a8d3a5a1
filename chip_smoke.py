#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``podtpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line (phases 12 and 13 one a family) and
raising on failure:

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
   stem's plain version, as a witness of the card's rounding alone;
9. fit: the training run through its entry point
   (``podtpu_torch.train.run.train``) on ``configs/yolov3_voc.yaml``
   (416 px, bf16, B=64, 8 loader workers) fed from JPEG files written by
   ``podtpu_torch.data.synthetic`` (128 train and 72 val images at 480 px):
   2 epochs validated each, then a resume from ``last`` to epoch 3. The
   kernel counters are zeroed before each run: every train step launches
   each stem kernel once, every val batch the suppression once, no
   ``validate`` launches a stem kernel; no CPU tensor in one train and one
   eval step; ``last``, ``best`` and both ``epoch_NNNN`` are written, and
   ``best`` restored into a fresh eval-only ``Trainer`` validates to the
   same ``val_loss`` and ``val_mAP``. Printed with the card: the loader's
   img/s alone, ``fit``'s img/s and the share of each epoch blocked on the
   loader, beside phase 7's step on a batch already on the card;
   ``validate``'s seconds and eval-step ms per batch, the host mAP ms, each
   checkpoint save's ms and the native matcher's build seconds;
10. consume: phase 9's ``best`` through the CLIs' entry points
   (``podtpu_torch.cli``): ``test.evaluate`` with its report (the same
   ``val_loss`` and ``val_mAP`` as phase 9 recorded; the table, and the
   confusion matrix's GT columns equal to its TP + FN; the PNGs where
   matplotlib is installed), ``inference`` of 16 images at B=1 (16 JPEGs,
   per-image ms p50 / p90), ``make_pred_files`` (one file a val image, one
   line a valid detection), ``yolo2coco_pred_file.run`` on a COCO file
   built from the first 24 val images and their labels (the records'
   schema, AP / AP50 / AP75 in [0, 1]) and ``make_video`` on a 16-frame
   ``mp4v`` video of val JPEGs (16 frames out). Per CLI, with the counters zeroed around it:
   suppression once an eval step, no stem kernel, no CPU tensor entering
   an eval step. At B=1 the suppression's keep masks are held bit for bit
   against the plain version (the first val image's candidates, and a
   frame with none) and timed;
11. swa: a fresh 2-epoch run through ``train.run.train`` with ``swa:
   {start_epoch: 0, bn_recal_batches: 2}``: ``swa`` written, its
   parameters the mean of the two epoch-end sets, its BN buffers finite
   and not ``last``'s; inside ``recalibrate_bn`` the stem's forward
   kernels once a batch and its backward never; each ``make_stats_step``
   leaves the state bit for bit; one recalibration batch held against the
   stem's plain version on the card; seconds a recalibration batch;
12. families: ``configs/yolov2_voc.yaml`` (416 px) and
   ``configs/yolov1_voc.yaml`` (448 px) unchanged (bf16, 20 classes,
   B=64), seeded weights carried in through the weight loader. Each:
   requests through ``Engine`` and ``MicroBatcher`` (suppression once a
   dispatch, no stem launch, no CPU tensor), forward / decode / NMS / total
   ms at B=8 and 64; suppression on the model's own candidates (K = 512 of
   845; K = 49, a partial mask word) bit-equal to the plain version at B=8
   and 64, timed beside its bound; phase 7's train step (each stem kernel
   once a step); a float32 model on the card against the CPU (heads
   <= 1e-3); for YOLOv1 the stem kernels at 448 px (14 column tiles)
   against their plain versions with phase 6's tolerances and planted
   faults, and timed at B=64; then one epoch of 2 steps and ``validate``
   through ``python -m podtpu_torch.cli.train_<model>`` on phase 9's files
   and ``cli.test_<model>`` on its ``best`` (the same val_loss and
   val_mAP), with the launch counts, no CPU tensor in a steady-state step,
   the checkpoints written and then deleted;
13. v4_families: ``configs/yolov4-tiny_voc.yaml`` (B=64,
   ``steps_per_dispatch: 8``) and ``configs/yolov4_voc.yaml`` (B=32)
   unchanged (416 px, bf16, 20 classes), seeded weights carried in through
   the weight loader. Each: serving as phase 12 (suppression once a
   dispatch, no stem launch, keep masks on the model's own candidates, K =
   512 of 10,647, bit-equal at B=8 and 64 and timed), phase 7's train step
   with no stem launch, a 64 px float32 model on the card against the CPU;
   for YOLOv4-tiny the K=8 group (``make_multi_train_step``) with no host
   synchronisation inside it (``torch.cuda.set_sync_debug_mode("error")``),
   timed in turns with 8 single steps on the same batches beside the
   host's stack-and-copy ms and the card's busy time a step (a
   ``torch.profiler`` trace), and at 64 px float32 no further from 8
   single steps than they are from themselves; then one epoch from phase
   9's files
   (YOLOv4-tiny through ``cli.train_yolov4_tiny`` at B=14: one group of 8
   and a ragged step; YOLOv4 through ``train.run`` at B=32) and
   ``cli.test_yolov4_tiny`` / ``cli.test`` on its ``best`` (the same
   val_loss and val_mAP), the checkpoints deleted;
14. retinanet: ``configs/retinanet_voc.yaml`` unchanged (RetinaNet-
   ResNet50, 512 px, bf16, 20 classes, B=32, ``clip_grad_norm: 10``),
   seeded weights carried in through the weight loader (every bias N(0,
   0.1), so the class prior is gone and K = 512 is full at B=8): serving
   as phase 12 (suppression once a dispatch, no stem launch; keep masks on
   the model's own candidates, K = 512 of 49,104, bit-equal at B=8 and 64
   and timed beside the bound); the train step (3 warm-up and 10 timed
   steps, no stem launch, no CPU tensor, no host synchronisation under
   ``torch.cuda.set_sync_debug_mode("error")``, BN statistics moving, the
   forward / targets + loss / backward / clip + optimizer split with the
   targets alone and the loss's own peak memory, and a step with a
   planted gradient whose norm the clip brings to 10); a 64 px float32
   model on the card against the CPU (heads, detections, loss); one epoch
   from phase 9's files through ``train.run`` at B=32 and ``cli.test`` on
   its ``best`` (the same val_loss and val_mAP), the checkpoints deleted.

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
    He-normal kernels, non-trivial BN affine and running statistics, every
    bias N(0, 0.1) (RetinaNet's class prior included)."""
    from podtpu_torch.export.weights import conv_paths, flat_key

    rng = np.random.default_rng(seed)
    flat, convs = {}, conv_paths(model)
    for name, t in model.state_dict().items():
        key, shape = flat_key(name, convs), tuple(t.shape)
        if key.endswith("kernel") and len(shape) == 4:  # HWIO
            o, i, kh, kw = shape
            arr = rng.normal(0.0, np.sqrt(2.0 / (i * kh * kw)), (kh, kw, i, o))
        elif key.endswith("kernel"):  # a Dense kernel, [in, out]
            o, i = shape
            arr = rng.normal(0.0, np.sqrt(2.0 / i), (i, o))
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


def stem_inputs(b, dtype, dev, seed, size=416):
    """Seeded stem operands at ``size`` px: images in [0, 1), He-normal
    HWIO weights, BN affine, and a random normal pooled cotangent."""
    r = np.random.default_rng(seed)
    x = torch.from_numpy(r.random((b, size, size, 3), np.float32))
    w = r.normal(0.0, np.sqrt(2.0 / 27), (3, 3, 3, 32)).astype(np.float32)
    scale = r.uniform(0.5, 1.5, 32).astype(np.float32)
    bias = r.normal(0.0, 0.1, 32).astype(np.float32)
    g = r.normal(0.0, 1.0, (b, size // 2, size // 2, 32)).astype(np.float32)
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


def stem_dtype_checks(sk, dtype, dev, size, seed):
    """The stem's kernels against their plain versions at B=8, ``size`` px
    in ``dtype``: each kernel on the same inputs, and the whole op forward
    and backward from one seeded cotangent; in bf16 also the planted
    backward faults, each of which must fail these checks. Returns the
    checks; raises where one fails."""
    n_eps = 1e-5
    t = STEM_TOL[dtype]
    x, w, scale, bias, g = stem_inputs(8, dtype, dev, seed, size)
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
                                 f"the checks at {size} px: {faults}")
    torch.cuda.synchronize()
    ok = (ok_k and ok_op and op_ok
          and max(c["op_mean_rel"], c["op_var_rel"]) <= t["stats"])
    if not ok:
        raise AssertionError(f"stem kernels differ from their plain "
                             f"versions in {dtype} at {size} px: {c}")
    return c


def stem_timing(sk, dev, size, seed):
    """At the train step's shape (B=64, ``size`` px, bf16): the per-kernel
    checks again, then each kernel timed beside its bound and its plain
    version. Returns (checks, max_abs_err per kernel, timing, operands)."""
    x, w, scale, bias, g = stem_inputs(64, torch.bfloat16, dev, seed, size)
    ok, checks, max_err, vecs, _ = stem_kernel_checks(
        sk, x, w, scale, bias, g, 1e-5)
    if not ok:
        raise AssertionError(f"stem kernels differ from their plain versions "
                             f"at B=64 bf16, {size} px: {checks}")
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
        bound_ms, bound_by, terms = stem_bound(k, 64, size, size, 2)
        timing[k] = {"ms": cuda_ms(lambda: kern[k](*args[k]), 20),
                     "plain_ms": cuda_ms(lambda: plain[k](*args[k]), 5),
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "bound_terms_ms": terms}
    return checks, max_err, timing, (x, w, scale, bias, g)


def stem_phase(dev, card):
    """Phase 6; returns the kernels-line entries of the four stem kernels."""
    from podtpu_torch.ops.kernels import stem_kernel as sk

    n_eps = 1e-5
    checks = {str(dtype).split(".")[-1]: stem_dtype_checks(
        sk, dtype, dev, 416, SEED + 3)
        for dtype in (torch.bfloat16, torch.float32)}
    checks["bfloat16_B64"], max_err, timing, (x, w, scale, bias, g) = (
        stem_timing(sk, dev, 416, SEED + 4))

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


def train_phase(cfg, flat, dev, card, batch=64, stem_per_step=1):
    """Phase 7 for ``cfg``'s model: returns the stem kernels' launch counts
    of the timed run, its img/s and the phase's record. ``batch``: the
    config's own batch; ``stem_per_step``: launches of each stem kernel a
    step (0 where the model has no fusable stem)."""
    from podtpu_torch.losses import build_loss
    from podtpu_torch.ops.kernels.nms_kernel import greedy_suppress
    from podtpu_torch.ops.kernels.stem_kernel import stem_fused
    from podtpu_torch.train.state import create_train_state
    from podtpu_torch.train.steps import make_train_step

    b = int(cfg["batch_size"])
    if (b, cfg["max_annots"], cfg["optimizer"], cfg["scheduler"]) != (
            batch, 64, "sgd", "yolo_lr"):
        raise AssertionError(f"the {cfg['model']} config is not the "
                             f"batch-{batch} nesterov-SGD yolo_lr recipe")
    torch.cuda.reset_peak_memory_stats()
    state = create_train_state(cfg, dev, weights=flat)
    step = make_train_step(cfg)
    r = np.random.default_rng(SEED + 5)
    size = int(cfg["input_size"])
    img = torch.from_numpy(r.random((b, size, size, 3), np.float32)).to(dev)
    annot = torch.from_numpy(synthetic_annotations(cfg, b, SEED)).to(dev)
    batch = {"img": img, "annot": annot}
    # the stem's BN statistics and the last BN layer's
    last_bn = [k for k in state.model.state_dict()
               if k.endswith("bn.running_var")][-1]
    bns = {k: v.clone() for k, v in state.model.state_dict().items()
           if k in ("backbone.stage0.conv0.bn.running_mean",
                    "backbone.stage0.conv0.bn.running_var", last_bn)}
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
    if (any(v != iters * stem_per_step for v in launches.values())
            or greedy_suppress.launches):
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
    record = {"model": cfg["model"], "input_size": size,
              "compute_dtype": cfg["compute_dtype"], "batch": b,
              "timed_steps": iters, "launches": launches,
              "loss_first_last": [loss_vals[0], loss_vals[-1]],
              "bn_stats_moved": moved, "ms_per_step": step_ms,
              "img_per_s": b * 1e3 / step_ms, "split_ms": split,
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
              "card": card}
    return launches, b * 1e3 / step_ms, record


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


class _TimedLoader:
    """A train loader seen from its consumer: per epoch, the batches, the
    wall seconds of the iteration and the seconds ``fit`` was blocked in
    ``next()`` waiting for the loader."""

    def __init__(self, loader, epochs: list):
        self._loader, self.epochs = loader, epochs

    def __len__(self):
        return len(self._loader)

    def set_epoch(self, epoch):
        self._loader.set_epoch(epoch)

    def __iter__(self):
        t_start, blocked, n = time.perf_counter(), 0.0, 0
        it = iter(self._loader)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                break
            blocked += time.perf_counter() - t0
            n += 1
            yield batch
        wall = time.perf_counter() - t_start
        self.epochs.append({"batches": n, "seconds": wall, "blocked_s": blocked,
                            "blocked_share": blocked / wall})


class _FitProbes:
    """Within it, ``train.run.train``'s train loader is a
    :class:`_TimedLoader`, and each ``Trainer.validate``, each
    ``CheckpointIO.save`` and the mAP scoring are timed; ``validate`` also
    records the kernel launches inside it. Only this script's view: the
    port is not instrumented."""

    def __init__(self):
        self.epochs, self.validations, self.saves = [], [], []

    def __enter__(self):
        from podtpu_torch.ops.kernels.nms_kernel import greedy_suppress
        from podtpu_torch.ops.kernels.stem_kernel import stem_fused
        from podtpu_torch.train import run
        from podtpu_torch.train.trainer import CheckpointIO, Trainer

        probes = self
        self._saved = [(run, "make_loaders", run.make_loaders),
                       (Trainer, "validate", Trainer.validate),
                       (CheckpointIO, "save", CheckpointIO.save)]
        make_loaders, validate, save = (v for _, _, v in self._saved)

        def timed_loaders(cfg):
            train_loader, val_loader = make_loaders(cfg)
            return _TimedLoader(train_loader, probes.epochs), val_loader

        def timed_validate(trainer, loader):
            stem0 = sum(stem_fused.launches.values())
            nms0 = greedy_suppress.launches
            step, metric = trainer.eval_step, trainer.map_metric
            events, host = [], {"update_ms": 0.0, "result_ms": 0.0}

            def eval_step(state, batch):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                out = step(state, batch)
                ev[1].record()
                events.append(ev)
                return out

            def timed(fn, key):
                def call(*a):
                    t0 = time.perf_counter()
                    out = fn(*a)
                    host[key] += (time.perf_counter() - t0) * 1e3
                    return out
                return call

            trainer.eval_step = eval_step
            metric.update_state = timed(metric.update_state, "update_ms")
            metric.result = timed(metric.result, "result_ms")
            t0 = time.perf_counter()
            try:
                out = validate(trainer, loader)
            finally:
                trainer.eval_step = step
                del metric.update_state, metric.result
            seconds = time.perf_counter() - t0
            torch.cuda.synchronize()
            ms = [a.elapsed_time(b) for a, b in events]
            probes.validations.append({
                "seconds": seconds, "batches": len(ms),
                "eval_step_ms": ms, "map_host_ms": host,
                "stem_launches": sum(stem_fused.launches.values()) - stem0,
                "suppress_launches": greedy_suppress.launches - nms0})
            return out

        def timed_save(io, name, state):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            save(io, name, state)
            probes.saves.append({"name": name, "ms": (time.perf_counter()
                                                      - t0) * 1e3})

        run.make_loaders = timed_loaders
        Trainer.validate = timed_validate
        CheckpointIO.save = timed_save
        return self

    def __exit__(self, *exc):
        for owner, name, value in self._saved:
            setattr(owner, name, value)


def fit_phase(dev, card, step_img_s, tmp):
    """Phase 9: the training run through its entry point,
    ``podtpu_torch.train.run.train``, on ``configs/yolov3_voc.yaml``
    (416 px, bf16, B=64, 8 workers) fed from JPEG files written under
    ``tmp``: 2 epochs, then a resume from ``last`` to epoch 3. Returns
    each kernel's launches on this path, and what phases 10 and 11 build
    on: the config, the data, the first run's ``best`` and its row."""
    from podtpu_torch.config import get_configs
    from podtpu_torch.data.synthetic import generate
    from podtpu_torch.native import build as native_build
    from podtpu_torch.train.run import make_loaders, train
    from podtpu_torch.train.trainer import Trainer, restore_eval_weights

    native_built_here = not os.path.exists(native_build._target())
    t0 = time.perf_counter()
    native_build.get_lib()
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    info = generate(os.path.join(tmp, "data"), n_train=128, n_val=72,
                    size=480, num_classes=20, max_objects=8, seed=SEED)
    data_s = time.perf_counter() - t0
    cfg = get_configs(os.path.join(REPO, "configs", "yolov3_voc.yaml"))
    cfg.update(train_list=info["train_list"], val_list=info["val_list"],
               names=info["names"], save_dir=os.path.join(tmp, "runs"),
               epochs=2, save_freq=1,
               trainer_options={"check_val_every_n_epoch": 1})
    if (cfg["input_size"], cfg["compute_dtype"], cfg["batch_size"],
            cfg["workers"]) != (416, "bfloat16", 64, 8):
        raise AssertionError("configs/yolov3_voc.yaml is not 416 px "
                             "bf16, B=64, 8 workers")

    # the loader alone: one epoch with no device work
    train_loader, _ = make_loaders(cfg)
    t0 = time.perf_counter()
    n_img = sum(b["n_valid"] for b in train_loader)
    loader_img_s = n_img / (time.perf_counter() - t0)

    runs = {}
    with _FitProbes() as probes:
        torch.cuda.synchronize()
        _zero_counts()
        t0 = time.perf_counter()
        first = train(cfg, device="cuda")
        torch.cuda.synchronize()
        runs["fit"] = {"seconds": time.perf_counter() - t0,
                       "launches": _counts()}
        ckpt_dir = os.path.join(first.run_dir, "checkpoints")
        found = sorted(os.listdir(ckpt_dir))
        _zero_counts()
        t0 = time.perf_counter()
        resumed = train(cfg, resume=os.path.join(ckpt_dir, "last"),
                        epochs=3, device="cuda")
        torch.cuda.synchronize()
        runs["resume"] = {"seconds": time.perf_counter() - t0,
                          "launches": _counts()}
        n_fit_validations = len(probes.validations)

        # no CPU tensor inside one train step and one eval step
        batch = resumed._put({k: v for k, v in next(iter(
            make_loaders(cfg)[0])).items() if k != "n_valid"})
        spies = {}
        for name, fn in (("train_step", resumed.train_step),
                         ("eval_step", resumed.eval_step)):
            spies[name] = _CpuTensorSpy()
            with spies[name]:
                fn(resumed.state, batch)
        torch.cuda.synchronize()

        # best, restored into a fresh eval-only Trainer
        rows = first.history
        best_row = min(rows, key=lambda r: r["val_loss"])
        fresh = Trainer(cfg, device="cuda", eval_only=True)
        restore_eval_weights(os.path.join(ckpt_dir, "best"), fresh.state,
                             cfg)
        again = fresh.validate(make_loaders(cfg)[1])

    history = first.history + resumed.history
    steps_per_epoch = -(-128 // 64)
    checks = {
        "rows": [r["epoch"] for r in first.history] == [0, 1]
        and [r["epoch"] for r in resumed.history] == [2],
        "finite": all(np.isfinite([r["train_loss"], r["val_loss"]]).all()
                      for r in history),
        "val_mAP_in_0_1": all(0.0 <= r["val_mAP"] <= 1.0 for r in history),
        "stem_once_per_step": all(
            runs[k]["launches"][f"stem_{n}"] == e * steps_per_epoch
            for k, e in (("fit", 2), ("resume", 1)) for n in STEM_REPLACES),
        "suppress_once_per_val_batch": all(
            v["suppress_launches"] == v["batches"] == 2
            for v in probes.validations)
        and runs["fit"]["launches"]["greedy_suppress"] == 4
        and runs["resume"]["launches"]["greedy_suppress"] == 2,
        "no_stem_in_validate": all(v["stem_launches"] == 0
                                   for v in probes.validations),
        "no_cpu_tensors": not any(s.cpu_ops for s in spies.values()),
        "checkpoints": {"last", "best", "epoch_0000",
                        "epoch_0001"} <= set(found),
        "best_restore": abs(again["val_loss"] - best_row["val_loss"])
        <= 1e-5 * abs(best_row["val_loss"])
        and abs(again["val_mAP"] - best_row["val_mAP"]) <= 1e-6,
    }
    fit_val = probes.validations[:n_fit_validations]
    eval_ms = [m for v in fit_val for m in v["eval_step_ms"]]
    fit_img_s = [r["images_per_sec"] for r in history]
    emit({"phase": "fit", "config": "configs/yolov3_voc.yaml",
          "data": {"n_train": 128, "n_val": 72, "size": 480,
                   "num_classes": 20, "max_objects": 8,
                   "generate_s": data_s},
          "checks": checks, "history": history,
          "best": {"epoch": best_row["epoch"],
                   "fit_val_loss": best_row["val_loss"],
                   "restored_val_loss": again["val_loss"],
                   "fit_val_mAP": best_row["val_mAP"],
                   "restored_val_mAP": again["val_mAP"]},
          "runs": runs, "checkpoints": found,
          "cpu_ops": {k: sorted(set(s.cpu_ops)) for k, s in spies.items()},
          "loader_alone_img_per_s": loader_img_s,
          "fit_img_per_s": fit_img_s,
          "epochs": probes.epochs,
          "validate": fit_val,
          "validate_s": [v["seconds"] for v in fit_val],
          "eval_step_ms_per_batch": float(np.mean(eval_ms)),
          "map_host_ms": [v["map_host_ms"] for v in fit_val],
          "checkpoint_save_ms": probes.saves,
          "native_matcher_build_and_load_s": native_s,
          "native_matcher_built_here": native_built_here,
          "train_step_on_card_img_per_s": step_img_s,
          "fit_over_on_card_step": [v / step_img_s for v in fit_img_s],
          "card": card})
    if not all(checks.values()):
        raise AssertionError(f"the fit phase failed its checks: "
                             f"{ {k: v for k, v in checks.items() if not v} }")
    launches = {k: runs["fit"]["launches"][k]
                + runs["resume"]["launches"][k]
                for k in runs["fit"]["launches"]}
    return launches, {"cfg": cfg, "data": info, "best_row": best_row,
                      "best": os.path.join(ckpt_dir, "best")}


def _zero_counts():
    from podtpu_torch.ops.kernels.nms_kernel import greedy_suppress
    from podtpu_torch.ops.kernels.stem_kernel import stem_fused

    for k in stem_fused.launches:
        stem_fused.launches[k] = 0
    greedy_suppress.launches = 0


def _counts() -> dict:
    from podtpu_torch.ops.kernels.nms_kernel import greedy_suppress
    from podtpu_torch.ops.kernels.stem_kernel import stem_fused

    return {**{f"stem_{k}": v for k, v in stem_fused.launches.items()},
            "greedy_suppress": greedy_suppress.launches}


class _EvalProbe:
    """Within it, every eval step a ``Trainer`` builds is watched: its
    calls, the valid detections of each image, any input (batch tensor,
    parameter or buffer) not on the card, and the ops on CPU tensors
    (:class:`_CpuTensorSpy`) inside the first two calls after each
    :meth:`reset`: the first builds the decoder's anchor constants from
    the config's lists on the host, once; the second is the steady state.
    Only this script's view: the port is not instrumented."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.calls, self.valid_counts, self.cpu_inputs = 0, [], []
        self.cpu_ops = []  # per spied call

    def __enter__(self):
        from podtpu_torch.train import trainer

        self._trainer, self._make = trainer, trainer.make_eval_step
        probe = self

        def make_eval_step(cfg, *a, **kw):
            step = probe._make(cfg, *a, **kw)

            def eval_step(state, batch):
                probe.calls += 1
                model = state.model
                probe.cpu_inputs += [
                    k for k, v in [*batch.items(),
                                   *model.named_parameters(),
                                   *model.named_buffers()]
                    if v.device.type != "cuda"]
                if probe.calls <= 2:
                    spy = _CpuTensorSpy()
                    with spy:
                        out = step(state, batch)
                    probe.cpu_ops.append(sorted(set(spy.cpu_ops)))
                else:
                    out = step(state, batch)
                probe.valid_counts += out[2].sum(1).tolist()
                return out

            return eval_step

        trainer.make_eval_step = make_eval_step
        return self

    def __exit__(self, *exc):
        self._trainer.make_eval_step = self._make


def _coco_annotations(val_list: str, path: str, n: int) -> int:
    """A COCO annotation file for the first ``n`` images of ``val_list``
    and their YOLO labels, beside them; returns the number of boxes."""
    import cv2

    from podtpu_torch.data.dataset import label_path_for, read_yolo_labels

    with open(val_list) as f:
        imgs = [l for l in f.read().splitlines() if l.strip()][:n]
    images, anns = [], []
    for i, p in enumerate(imgs):
        h, w = cv2.imread(p).shape[:2]
        images.append({"id": i + 1, "width": w, "height": h,
                       "file_name": os.path.relpath(p, os.path.dirname(path))})
        for cls, cx, cy, bw, bh in read_yolo_labels(label_path_for(p)):
            anns.append({"id": len(anns) + 1, "image_id": i + 1,
                         "category_id": int(cls) + 1, "iscrowd": 0,
                         "area": float(bw * w * bh * h),
                         "bbox": [float((cx - bw / 2) * w),
                                  float((cy - bh / 2) * h),
                                  float(bw * w), float(bh * h)]})
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": c + 1, "name": str(c)}
                                  for c in range(20)]}, f)
    return len(anns)


def _video_from(val_list: str, path: str, frames: int) -> int:
    """An ``mp4v`` video of the first ``frames`` val JPEGs; returns the
    frames cv2 reads back from it."""
    import cv2

    with open(val_list) as f:
        imgs = [l for l in f.read().splitlines() if l.strip()][:frames]
    h, w = cv2.imread(imgs[0]).shape[:2]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10,
                             (w, h))
    if not writer.isOpened():
        raise AssertionError("cv2.VideoWriter (mp4v) did not open")
    for p in imgs:
        writer.write(cv2.resize(cv2.imread(p), (w, h)))
    writer.release()
    return _frames_in(path)


def _frames_in(path: str) -> int:
    import cv2

    cap = cv2.VideoCapture(path)
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


class _ConfusionRecorder:
    """Within it, ``write_eval_report``'s confusion matrix is recorded; its
    PNGs are drawn only where matplotlib is installed (host code that never
    touches the card)."""

    def __init__(self, have_matplotlib: bool):
        self.have_matplotlib, self.matrix = have_matplotlib, None

    def __enter__(self):
        from podtpu_torch.metrics import plots

        self._plots = plots
        self._saved = (plots.plot_pr_curves, plots.plot_confusion_matrix)
        rec = self

        def confusion(matrix, names, out_path):
            rec.matrix = np.array(matrix)
            if rec.have_matplotlib:
                return rec._saved[1](matrix, names, out_path)
            return None

        plots.plot_confusion_matrix = confusion
        if not self.have_matplotlib:
            plots.plot_pr_curves = lambda *a: None
        return self

    def __exit__(self, *exc):
        (self._plots.plot_pr_curves,
         self._plots.plot_confusion_matrix) = self._saved


def consume_phase(fit: dict, dev, card, tmp: str) -> dict:
    """Phase 10: what users do with the ``best`` checkpoint of phase 9,
    through the CLIs' entry points at B=1 (``cli.test`` at the config's
    B=64): the score and its report, drawn images with per-image latency,
    VOC prediction files, COCO results scored, an annotated video. Per CLI
    the kernel counters are zeroed before and read after: suppression once
    an eval step, no stem kernel; no CPU tensor enters an eval step. At
    B=1 the suppression's keep masks are held bit for bit against the
    plain version on the first val image's candidates and on a frame with
    none. Returns the launches of the phase."""
    import importlib.util

    from podtpu_torch.cli import eval_trainer
    from podtpu_torch.cli import inference as cli_inference
    from podtpu_torch.cli import make_pred_file as cli_pred
    from podtpu_torch.cli import make_video as cli_video
    from podtpu_torch.cli import test as cli_test
    from podtpu_torch.cli import yolo2coco_pred_file as cli_coco
    from podtpu_torch.data.dataset import build_datasets
    from podtpu_torch.data.loader import Loader
    from podtpu_torch.ops.kernels.nms_kernel import (
        greedy_suppress,
        greedy_suppress_reference,
    )
    from podtpu_torch.train.steps import _as_input, _decoder_and_nms

    cfg, best, best_row = fit["cfg"], fit["best"], fit["best_row"]
    val_list = fit["data"]["val_list"]
    out = os.path.join(tmp, "consume")
    os.makedirs(out)
    have_mpl = importlib.util.find_spec("matplotlib") is not None
    # the COCO run takes the first 24 val images (its evaluator's Python
    # matching over ~100 detections an image is the phase's slowest part)
    n_coco, n_video = 24, 16
    n_boxes = _coco_annotations(val_list, os.path.join(
        os.path.dirname(val_list), "annotations.json"), n_coco)
    video_in = os.path.join(out, "in.mp4")
    frames_in = _video_from(val_list, video_in, n_video)
    _, val_ds = build_datasets(cfg)

    t_phase = time.perf_counter()
    runs, res = {}, {}
    with _EvalProbe() as probe:
        def run(name, fn):
            probe.reset()
            torch.cuda.synchronize()
            _zero_counts()
            t0 = time.perf_counter()
            res[name] = fn()
            torch.cuda.synchronize()
            runs[name] = {"seconds": time.perf_counter() - t0,
                          "launches": _counts(), "eval_steps": probe.calls,
                          "cpu_inputs": sorted(set(probe.cpu_inputs)),
                          "cpu_ops": probe.cpu_ops,
                          "valid_counts": probe.valid_counts}

        with _ConfusionRecorder(have_mpl) as confusion:
            run("test", lambda: cli_test.evaluate(
                cfg, best, os.path.join(out, "report"), device=dev))
        run("inference", lambda: cli_inference.inference(
            cfg, best, os.path.join(out, "vis"), limit=16, device=dev))
        run("make_pred_file", lambda: cli_pred.make_pred_files(
            cfg, best, os.path.join(out, "pred"), device=dev))
        run("yolo2coco_pred_file", lambda: cli_coco.run(
            cfg, best, os.path.join(os.path.dirname(val_list),
                                    "annotations.json"),
            os.path.join(out, "results.json"), device=dev))
        run("make_video", lambda: cli_video.run(
            cfg, best, video_in, os.path.join(out, "out.mp4"),
            device=dev))
    launches = {k: sum(r["launches"][k] for r in runs.values())
                for k in runs["test"]["launches"]}

    # the report: its table, and the confusion matrix's GT columns against
    # the table's TP + FN
    with open(os.path.join(out, "report", "per_class.txt")) as f:
        table = f.read().splitlines()
    rows = [l.split() for l in table[1:21]]
    n_gt = sum(float(r[2]) + float(r[4]) for r in rows)
    pngs = sorted(p for p in os.listdir(os.path.join(out, "report"))
                  if p.endswith(".png"))
    # the prediction files: one a val image, one line a valid detection
    pred_lines = []
    for img in val_ds.imgs:
        stem = os.path.splitext(os.path.basename(img))[0]
        with open(os.path.join(out, "pred", stem + ".txt")) as f:
            pred_lines.append(len(f.read().splitlines()))
    with open(os.path.join(out, "results.json")) as f:
        results = json.load(f)
    coco = res["yolo2coco_pred_file"]
    vis = sorted(os.listdir(os.path.join(out, "vis")))
    ms = res["inference"]
    frames_out = _frames_in(os.path.join(out, "out.mp4"))

    # where a B=1 eval step's time goes: each stage over 20 calls back to
    # back, the stages of the serve graph and the whole step (its loss the
    # rest)
    trainer = eval_trainer(cfg, best, dev)
    batch = next(iter(Loader(val_ds, batch_size=1, shuffle=False,
                             max_annots=cfg["max_annots"], workers=1)))
    batch.pop("n_valid")
    on_card = trainer._put(batch)
    split = {"eval_step_ms": cuda_ms(
        lambda: trainer.eval_step(trainer.state, on_card), 20)}
    model = trainer.state.model.eval()
    decoder, nms = _decoder_and_nms(cfg)
    with torch.inference_mode():
        x = _as_input(on_card["img"])
        preds = model(x)
        cands = decoder(preds)
        split["forward_ms"] = cuda_ms(lambda: model(x), 20)
        split["decode_ms"] = cuda_ms(lambda: decoder(preds), 20)
        split["nms_ms"] = cuda_ms(lambda: nms(cands), 20)
    split["loss_and_rest_ms"] = split["eval_step_ms"] - (
        split["forward_ms"] + split["decode_ms"] + split["nms_ms"])

    # suppression at B=1: the first val image's candidates and an empty frame
    real = yolo_candidates(model, decoder, cfg, {1: on_card["img"]})[1]
    thr = float(cfg["nms_iou_threshold"])
    b1 = {"real_B1": real, "all_invalid_B1": (
        real[0], torch.zeros_like(real[1]))}
    keep = {}
    with torch.inference_mode():
        for name, (boxes, valid) in b1.items():
            got = greedy_suppress(boxes, valid, thr)
            torch.cuda.synchronize()
            want = greedy_suppress_reference(boxes, valid, thr)
            keep[name] = {"valid": int(valid.sum()), "kept": int(got.sum()),
                          "mismatches": int((got != want).sum())}
        boxes, valid = real
        suppress_b1 = {"ms": cuda_ms(lambda: greedy_suppress(
            boxes, valid, thr), 200, warmup=10)}
        suppress_b1["device_ms"], suppress_b1["device_ms_by"] = device_ms(
            lambda: greedy_suppress(boxes, valid, thr))
        suppress_b1["plain_ms"] = cuda_ms(
            lambda: greedy_suppress_reference(boxes, valid, thr), 5)
        (suppress_b1["bound_ms"], suppress_b1["bound_by"], _,
         _) = suppress_bound(boxes, valid, thr)

    steps = {"test": 2, "inference": 16, "make_pred_file": 72,
             "yolo2coco_pred_file": n_coco, "make_video": n_video}
    checks = {
        "test_matches_fit_best": abs(res["test"]["val_loss"]
                                     - best_row["val_loss"])
        <= 1e-5 * abs(best_row["val_loss"])
        and abs(res["test"]["val_mAP"] - best_row["val_mAP"]) <= 1e-6,
        "report_table": table[0].split() == ["class", "AP", "TP", "FP", "FN"]
        and len(table) == 22 and table[-1].startswith("mAP"),
        "report_confusion_counts": confusion.matrix is not None
        and int(confusion.matrix[:, :20].sum()) == int(n_gt) > 0,
        "report_pngs": pngs == ["confusion_matrix.png", "pr_curves.png"]
        if have_mpl else pngs == [],
        "inference_16_jpegs": vis == [f"{i:05d}.jpg" for i in range(16)]
        and len(ms) == 16 and min(ms) > 0,
        "pred_file_per_image": len(pred_lines) == len(val_ds) == 72
        and pred_lines == runs["make_pred_file"]["valid_counts"],
        "coco_results": len(results) == coco["n_detections"]
        == sum(runs["yolo2coco_pred_file"]["valid_counts"])
        and all(set(r) == {"image_id", "category_id", "bbox", "score"}
                and 1 <= r["category_id"] <= 20 and len(r["bbox"]) == 4
                and 1 <= r["image_id"] <= n_coco for r in results)
        and all(0.0 <= coco[k] <= 1.0 for k in ("AP", "AP50", "AP75")),
        "video_frames": frames_in == n_video == res["make_video"]["frames"]
        == frames_out,
        "eval_steps": all(runs[k]["eval_steps"] == n for k, n in
                          steps.items()),
        "suppress_once_per_eval_step": all(
            r["launches"]["greedy_suppress"] == r["eval_steps"] > 0
            for r in runs.values()),
        "no_stem_kernel": all(r["launches"][f"stem_{k}"] == 0
                              for r in runs.values() for k in STEM_REPLACES),
        "no_cpu_tensors": all(not r["cpu_inputs"] and r["cpu_ops"][1:] == [[]]
                              for r in runs.values()),
        "suppress_B1_keep_masks_equal": all(v["mismatches"] == 0
                                            for v in keep.values())
        and keep["real_B1"]["valid"] > 0
        and keep["all_invalid_B1"]["kept"] == 0,
    }
    emit({"phase": "consume", "checkpoint": "phase fit's best",
          "seconds": time.perf_counter() - t_phase,
          "checks": checks, "matplotlib": have_mpl,
          "evaluator": coco["evaluator"],
          "test": {**res["test"], "fit_best_val_loss": best_row["val_loss"],
                   "fit_best_val_mAP": best_row["val_mAP"]},
          "coco": {k: coco[k] for k in ("AP", "AP50", "AP75",
                                        "n_detections")},
          "coco_images": n_coco, "coco_boxes": n_boxes,
          "inference_ms": {"p50": float(np.percentile(ms, 50)),
                           "p90": float(np.percentile(ms, 90)),
                           "first": ms[0], "all": ms},
          "video": res["make_video"], "frames_in": frames_in,
          "frames_out": frames_out,
          "runs": {k: {kk: v for kk, v in r.items() if kk != "valid_counts"}
                   for k, r in runs.items()},
          "detections_per_image": [min(pred_lines), max(pred_lines)],
          "eval_step_B1_split_ms": split,
          "suppress_B1": {"keep": keep, **suppress_b1},
          "tolerance": "test vs fit's best: val_loss 1e-5 rel, val_mAP "
                       "1e-6; keep masks exact",
          "card": card})
    if not all(checks.values()):
        raise AssertionError(f"the consume phase failed its checks: "
                             f"{ {k: v for k, v in checks.items() if not v} }")
    return launches, suppress_b1


# the raw batch statistics of one recalibration batch, the stem's kernels
# against its plain version on the card (bf16): per channel |a - b| over
# max(|b|, 1). The two round the stem's bf16 pre-activations by other
# summation orders, and the deeper layers carry it on: 3.3e-3 observed on
# an NVIDIA H100 80GB HBM3 at 700 W (worst layer stage5.conv0's var), so
# the limit is 1e-2.
RECAL_TOL = 1e-2


def swa_phase(fit: dict, dev, card, tmp: str) -> dict:
    """Phase 11: SWA. A fresh 2-epoch run through ``train.run.train`` with
    ``swa: {start_epoch: 0, bn_recal_batches: 2}`` on phase 9's files:
    ``swa`` is written, its parameters are the mean of the two epoch-end
    sets, its BN buffers are finite and recalibrated; inside
    ``recalibrate_bn`` the stem's two forward kernels launch once a batch
    and its backward never, and ``make_stats_step`` leaves the state bit
    for bit as it was. One recalibration batch is held against the stem's
    plain version on the card. Returns the launches of the phase."""
    from podtpu_torch.ops.kernels.stem_kernel import stem_fused
    from podtpu_torch.train import trainer as trainer_mod
    from podtpu_torch.train.run import train
    from podtpu_torch.train.steps import make_stats_step
    from podtpu_torch.train.trainer import CheckpointIO, Trainer

    cfg = dict(fit["cfg"], save_dir=os.path.join(tmp, "runs_swa"), epochs=2,
               swa={"start_epoch": 0, "bn_recal_batches": 2})
    ends, recals, stats_calls, first = [], [], [], {}
    saved = (CheckpointIO.save, Trainer.recalibrate_bn,
             trainer_mod.make_stats_step)

    def save(io, name, state):
        if name == "last":
            ends.append({k: p.detach().clone()
                         for k, p in state.model.named_parameters()})
        saved[0](io, name, state)

    def recalibrate_bn(self, state, loader, num_batches=20):
        torch.cuda.synchronize()
        c0 = dict(stem_fused.launches)
        t0 = time.perf_counter()
        out = saved[1](self, state, loader, num_batches)
        torch.cuda.synchronize()
        recals.append({"seconds": time.perf_counter() - t0,
                       "batches": num_batches,
                       "launches": {k: stem_fused.launches[k] - c0[k]
                                    for k in c0}})
        first["state"] = state
        return out

    def stats_factory(cfg_):
        step = saved[2](cfg_)

        def stats_step(state, batch):
            model = state.model
            before = {k: v.clone() for k, v in model.state_dict().items()}
            modes = [m.training for m in model.modules()]
            raw = step(state, batch)
            stats_calls.append(
                all(torch.equal(v, before[k])
                    for k, v in model.state_dict().items())
                and modes == [m.training for m in model.modules()])
            first.setdefault("batch", {k: v.clone()
                                       for k, v in batch.items()})
            first.setdefault("raw", raw)
            return raw

        return stats_step

    t_phase = time.perf_counter()
    CheckpointIO.save, Trainer.recalibrate_bn = save, recalibrate_bn
    trainer_mod.make_stats_step = stats_factory
    try:
        torch.cuda.synchronize()
        _zero_counts()
        t0 = time.perf_counter()
        trainer = train(cfg, device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _counts()
    finally:
        (CheckpointIO.save, Trainer.recalibrate_bn,
         trainer_mod.make_stats_step) = saved

    ckpt_dir = os.path.join(trainer.run_dir, "checkpoints")
    load = lambda n: torch.load(  # noqa: E731
        os.path.join(ckpt_dir, n, "state.pt"), map_location=dev,
        weights_only=True)
    swa, last = load("swa")["model"], load("last")["model"]
    # the average against the epoch mean: p0 + (p1 - p0) / 2 in float32
    # rounds within 2^-22 (|p0| + |p1|)
    mean_err = 0.0 if len(ends) == 2 else float("inf")
    for k, p1 in (ends[1].items() if len(ends) == 2 else ()):
        p0 = ends[0][k]
        bound = 2.0 ** -22 * (p0.abs() + p1.abs()).double()
        dev_ = (swa[k].double() - (p0.double() + p1.double()) / 2).abs()
        mean_err = max(mean_err, float((dev_ - bound).max()))
    bn = [k for k in swa if "running_" in k]

    # one recalibration batch: the stem's kernels against its plain
    # version on the card, same weights, same batch
    state, batch = first["state"], first["batch"]
    with _PlainStem():
        plain = make_stats_step(cfg)(state, batch)
    kern = make_stats_step(cfg)(state, batch)
    recal_err = {k: float(((kern[k] - plain[k]).abs()
                           / plain[k].abs().clamp_min(1.0)).max())
                 for k in kern}
    worst = max(recal_err, key=recal_err.get)
    same_bits = all(torch.equal(kern[k], first["raw"][k]) for k in kern)

    (recal,) = recals
    checks = {
        "swa_written": {"last", "best", "swa"} <= set(os.listdir(ckpt_dir)),
        "swa_is_epoch_mean": mean_err <= 0.0,
        "swa_buffers_finite": all(torch.isfinite(swa[k]).all() for k in bn),
        "swa_buffers_differ_from_last": all(not torch.equal(swa[k], last[k])
                                            for k in bn),
        "state_is_last": all(torch.equal(v, last[k]) for k, v in
                             trainer.state.model.state_dict().items()),
        "recal_launches": recal["launches"] == {"stats": 2, "emit": 2,
                                                "bwd_sums": 0, "bwd_dw": 0},
        "stats_step_leaves_state": stats_calls == [True, True],
        "recal_kernels_vs_plain": recal_err[worst] <= RECAL_TOL,
        "run_launches": launches == {
            "stem_stats": 6, "stem_emit": 6, "stem_bwd_sums": 4,
            "stem_bwd_dw": 4, "greedy_suppress": 4},
    }
    emit({"phase": "swa", "config": "configs/yolov3_voc.yaml + swa: "
                                    "{start_epoch: 0, bn_recal_batches: 2}",
          "checks": checks, "history": trainer.history, "seconds": seconds,
          "phase_seconds": time.perf_counter() - t_phase,
          "launches": launches, "recalibrate_bn": recal,
          "recalibrate_bn_s_per_batch": recal["seconds"] / recal["batches"],
          "swa_mean_excess_over_bound": mean_err,
          "recal_kernels_vs_plain": {"max": recal_err[worst],
                                     "layer": worst, "tolerance": RECAL_TOL,
                                     "per_layer": recal_err},
          "stats_step_same_bits_as_in_recalibrate_bn": same_bits,
          "card": card})
    if not all(checks.values()):
        raise AssertionError(f"the swa phase failed its checks: "
                             f"{ {k: v for k, v in checks.items() if not v} }")
    return launches, recal


# the families of phase 12: (model, config's input size, candidates a
# serving image hands suppression)
FAMILIES = (("yolov2", 416, 512), ("yolov1", 448, 49))


def _add_counts(total: dict, part: dict) -> dict:
    return {k: total.get(k, 0) + part.get(k, 0) for k in {**total, **part}}


def serve_requests(engine, reqs, n_threads):
    """Answer the images ``reqs`` through ``engine`` from ``n_threads``
    client threads, after one warm-up dispatch outside the count; the
    kernel counters are zeroed just before the requests and read just
    after. Returns (results, launches, dispatches, seconds)."""
    results = [None] * len(reqs)

    def client(t):
        for i in range(t, len(reqs), n_threads):
            results[i] = engine.predict_array(reqs[i])

    engine.predict_array(reqs[0])  # warm-up dispatch, outside the count
    fills_before = sum(engine.stats.fills.values())
    torch.cuda.synchronize()
    _zero_counts()
    threads = [threading.Thread(target=client, args=(t,))
               for t in range(n_threads)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    seconds = time.perf_counter() - t0
    launches = _counts()
    dispatches = sum(engine.stats.fills.values()) - fills_before
    engine.close()
    return results, launches, dispatches, seconds


def serving_checks(engine, results, launches, dispatches, batch8, dev):
    """Every request answered with finite detections in range, suppression
    once a dispatch, no stem launch (eval mode), and no CPU tensor on the
    serve graph at B=8 (its output finite [8, 100, 6])."""
    from podtpu_torch.train.steps import _as_input

    max_det = engine.cfg["max_detections"]
    num_classes = engine.cfg["num_classes"]
    n_det = [r["num_detections"] for r in results if r is not None]
    rows = [d for r in results if r is not None for d in r["detections"]]
    spy = _CpuTensorSpy()
    with spy:
        dets, _ = engine.serve(_as_input(batch8))
    return {
        "answered": len(n_det) == len(results),
        "suppress_once_a_dispatch":
            launches["greedy_suppress"] == dispatches > 0,
        "no_stem_kernel": all(launches[f"stem_{k}"] == 0
                              for k in STEM_REPLACES),
        "detections": all(
            np.isfinite(d["box_cxcywh_input"]).all()
            and 0 < d["confidence"] <= 1 and 0 <= d["class_id"] < num_classes
            for d in rows) and 0 < max(n_det, default=0) <= max_det,
        "no_cpu_tensors": not spy.cpu_ops and dets.device.type == dev.type,
        "serve_output": dets.shape == (8, max_det, 6)
        and bool(torch.isfinite(dets).all()),
    }


def stage_ms(engine, decoder, nms, images):
    """{"B<b>": forward / decode / NMS / total ms} of the serve graph on
    ``images`` (mean of 20 calls at B=8, 5 at B=64, after warm-up)."""
    from podtpu_torch.train.steps import _as_input

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
                "total_ms": cuda_ms(lambda: engine.serve(xf), iters),
            }
    return timings


def family_serving(cfg, flat, dev, rng, k_own):
    """Serving of one family: requests through ``Engine`` and
    ``MicroBatcher`` (suppression once a dispatch, no stem launch, no CPU
    tensor on the path), the forward / decode / NMS / total ms at B=8 and
    64, and suppression on the model's own candidates (K = ``k_own``) held
    bit for bit against the plain version and timed. Returns (record,
    launches of the requests, the suppression's timing at B=8)."""
    from podtpu_torch.ops.kernels.nms_kernel import (
        greedy_suppress,
        greedy_suppress_reference,
    )
    from podtpu_torch.serve import Engine
    from podtpu_torch.train.steps import _decoder_and_nms

    size = int(cfg["input_size"])
    engine = Engine(cfg, flat, device=dev, max_batch=8, window_ms=20.0)
    decoder, nms = _decoder_and_nms(cfg)
    thr = float(cfg["nms_iou_threshold"])
    images = {b: torch.from_numpy(rng.integers(
        0, 256, (b, size, size, 3), dtype=np.uint8)).to(dev) for b in (8, 64)}
    reqs = rng.integers(0, 256, (16, size, size, 3), dtype=np.uint8)
    results, launches, dispatches, _ = serve_requests(engine, reqs, 4)
    checks = serving_checks(engine, results, launches, dispatches,
                            images[8], dev)
    n_det = [r["num_detections"] for r in results if r is not None]
    timings = stage_ms(engine, decoder, nms, images)

    # suppression on the model's own candidates
    real = yolo_candidates(engine.model, decoder, cfg, images)
    keep, suppress = {}, {}
    with torch.inference_mode():
        for b, (boxes, valid) in real.items():
            got = greedy_suppress(boxes, valid, thr)
            torch.cuda.synchronize()
            want = greedy_suppress_reference(boxes, valid, thr)
            keep[f"B{b}"] = {"shape": list(boxes.shape),
                             "valid": int(valid.sum()),
                             "kept": int(got.sum()),
                             "mismatches": int((got != want).sum())}
            run = lambda: greedy_suppress(boxes, valid, thr)  # noqa: E731
            t = suppress[f"B{b}"] = {
                "ms": cuda_ms(run, 200 if b == 8 else 100, warmup=10)}
            t["device_ms"], t["device_ms_by"] = device_ms(run)
            t["plain_ms"] = cuda_ms(
                lambda: greedy_suppress_reference(boxes, valid, thr), 5)
            (t["bound_ms"], t["bound_by"], t["bytes"],
             t["ops"]) = suppress_bound(boxes, valid, thr)
    checks["suppress_keep_masks_equal"] = all(
        v["mismatches"] == 0 and v["shape"][1] == k_own and v["valid"] > 0
        for v in keep.values())
    record = {"requests": len(reqs), "dispatches": dispatches,
              "serve_launches": launches,
              "detections_per_request": [min(n_det, default=0),
                                         max(n_det, default=0)],
              "latency_ms": engine.stats.snapshot()["latency_ms"],
              "ms_per_batch": timings, "suppress_keep": keep,
              "suppress": suppress}
    del engine
    return checks, record, launches, suppress["B8"]


def card_vs_cpu(cfg, size, seed, rng, dev, rel_tol=None, annot=None):
    """``cfg``'s model at ``size`` px in float32 on the card against the
    same on the CPU (TF32 off): the heads and the detections, and with
    ``annot`` ([2, T, 5]) the loss. Returns (ok, record). ``rel_tol``
    (heads, detections): hold each to its own scale (the largest value on
    the CPU) instead of 1e-3 and 1e-2 px, for a model whose random-weight
    heads reach thousands; the loss to 1e-4 relative."""
    from podtpu_torch.export.weights import load_flat_weights
    from podtpu_torch.losses import build_loss
    from podtpu_torch.models.factory import build_model
    from podtpu_torch.train.steps import _as_input, _decoder_and_nms

    small = dict(cfg, input_size=size, compute_dtype="float32")
    sflat = random_weights(build_model(small, "cpu"), seed)
    x = rng.integers(0, 256, (2, size, size, 3), dtype=np.uint8)
    outs, losses = [], []
    for d in ("cpu", dev):
        m = load_flat_weights(build_model(small, d), sflat)
        dec, nms_d = _decoder_and_nms(small)
        with torch.inference_mode():
            raw = m(_as_input(torch.from_numpy(x).to(d)))
            dets = [t.cpu() for t in nms_d(dec(raw))]
            if annot is not None:
                losses.append(float(build_loss(small)(
                    raw, torch.from_numpy(annot).to(d))))
            outs.append(([h.cpu() for h in tree_leaves(raw)], dets))
    (cpu_heads, (cpu_dets, cpu_valid)), (heads, (dets, valid)) = outs
    rec = {"input_size": size,
           "head_max_abs_err": max(float((a - b).abs().max())
                                   for a, b in zip(cpu_heads, heads)),
           "valid_equal": torch.equal(cpu_valid, valid),
           "det_max_abs_err": float((cpu_dets - dets).abs().max())}
    if annot is not None:
        rec.update(loss_cpu=losses[0], loss_card=losses[1],
                   loss_rel_err=abs(losses[1] - losses[0]) / abs(losses[0]))
    if rel_tol is None:
        ok = (rec["head_max_abs_err"] <= 1e-3 and rec["valid_equal"]
              and rec["det_max_abs_err"] <= 1e-2)
        return ok, rec
    rec.update(head_rel_err=max(rel_err(b, a)
                                for a, b in zip(cpu_heads, heads)),
               det_rel_err=rel_err(dets, cpu_dets), rel_tol=list(rel_tol))
    ok = (rec["head_rel_err"] <= rel_tol[0] and rec["valid_equal"]
          and rec["det_rel_err"] <= rel_tol[1]
          and rec.get("loss_rel_err", 0.0) <= 1e-4)
    return ok, rec


class _StepCounter:
    """Within it, the train steps and K-step groups of every ``Trainer``
    built are counted (``steps``, ``groups``)."""

    def __enter__(self):
        import podtpu_torch.train.trainer as tr

        self._tr, self.steps, self.groups = tr, 0, 0
        self._make = (tr.make_train_step, tr.make_multi_train_step)

        def counted(make, attr):
            def build(cfg):
                fn = make(cfg)

                def run(*args):
                    setattr(self, attr, getattr(self, attr) + 1)
                    return fn(*args)
                return run
            return build

        tr.make_train_step = counted(self._make[0], "steps")
        tr.make_multi_train_step = counted(self._make[1], "groups")
        return self

    def __exit__(self, *exc):
        self._tr.make_train_step, self._tr.make_multi_train_step = self._make


def family_fit(cfg, fit, dev, tmp, train_main=None, test_main=None,
               n_steps=2, n_val=2, stem_per_step=1, **overrides):
    """A short run from files through the family's own entry points: its
    config with phase 9's synthetic JPEGs (and ``overrides``), one epoch
    (``n_steps`` train steps, ``n_val`` val batches) and ``validate``
    through ``train_main`` (``cli.train_<model>``'s by default), then
    ``test_main`` (``cli.test_<model>``'s) on its ``best``. Returns
    (checks, record, launches of both runs)."""
    import importlib
    import shutil

    import yaml

    from podtpu_torch.train.run import make_loaders

    name = cfg["model"].replace("-", "_")
    train_main = train_main or importlib.import_module(
        f"podtpu_torch.cli.train_{name}").main
    test_main = test_main or importlib.import_module(
        f"podtpu_torch.cli.test_{name}").main
    runs = os.path.join(tmp, f"runs_{name}")
    fcfg = dict(cfg, train_list=fit["data"]["train_list"],
                val_list=fit["data"]["val_list"], names=fit["data"]["names"],
                save_dir=runs, epochs=1,
                trainer_options={"check_val_every_n_epoch": 1}, **overrides)
    path = os.path.join(tmp, f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(fcfg, f)
    spd = int(fcfg.get("steps_per_dispatch") or 1)
    try:
        torch.cuda.synchronize()
        _zero_counts()
        t0 = time.perf_counter()
        with _StepCounter() as counted:
            trainer = train_main(["--cfg", path, "--device", str(dev)])
        torch.cuda.synchronize()
        fit_s, fit_launches = time.perf_counter() - t0, _counts()
        groups, steps = counted.groups, counted.steps
        ckpt_dir = os.path.join(trainer.run_dir, "checkpoints")
        found = sorted(os.listdir(ckpt_dir))
        # no CPU tensor inside a steady-state train step and eval step
        batch = trainer._put({k: v for k, v in next(iter(
            make_loaders(fcfg)[0])).items() if k != "n_valid"})
        spies = {}
        for step_name, fn in (("train_step", trainer.train_step),
                              ("eval_step", trainer.eval_step)):
            spies[step_name] = _CpuTensorSpy()
            with spies[step_name]:
                fn(trainer.state, batch)
        torch.cuda.synchronize()
        (row,) = trainer.history
        del trainer
        _zero_counts()
        t0 = time.perf_counter()
        res = test_main(["--cfg", path, "--device", str(dev), "--ckpt",
                         os.path.join(ckpt_dir, "best")])
        torch.cuda.synchronize()
        test_s, test_launches = time.perf_counter() - t0, _counts()
    finally:
        shutil.rmtree(runs, ignore_errors=True)
    checks = {
        "fit_stem_per_step": all(
            fit_launches[f"stem_{k}"] == n_steps * stem_per_step
            for k in STEM_REPLACES),
        "fit_suppress_once_per_val_batch":
            fit_launches["greedy_suppress"] == n_val,
        "fit_groups_and_steps": (groups, steps) == (
            divmod(n_steps, spd) if spd > 1 else (0, n_steps))
        and row["step"] == n_steps,
        "test_suppress_only": test_launches["greedy_suppress"] == n_val
        and all(test_launches[f"stem_{k}"] == 0 for k in STEM_REPLACES),
        "no_cpu_tensors": not any(s.cpu_ops for s in spies.values()),
        "checkpoints": {"last", "best"} <= set(found),
        "finite": bool(np.isfinite([row["train_loss"], row["val_loss"]]).all())
        and 0.0 <= row["val_mAP"] <= 1.0,
        "test_matches_fit": abs(res["val_loss"] - row["val_loss"])
        <= 1e-5 * abs(row["val_loss"])
        and abs(res["val_mAP"] - row["val_mAP"]) <= 1e-6,
    }
    record = {"fit_row": row, "test": res, "checkpoints": found,
              "batch_size": fcfg["batch_size"], "steps_per_dispatch": spd,
              "groups": groups, "single_steps": steps,
              "fit_seconds": fit_s, "test_seconds": test_s,
              "fit_launches": fit_launches, "test_launches": test_launches,
              "cpu_ops": {k: sorted(set(s.cpu_ops))
                          for k, s in spies.items()}}
    return checks, record, _add_counts(fit_launches, test_launches)


def families_phase(fit, dev, card, tmp):
    """Phase 12: YOLOv2-416 and YOLOv1-448, each config unchanged (bf16,
    20 classes, B=64) with seeded weights carried in through the weight
    loader: serving, suppression on the model's own candidates (K = 512 of
    845; K = 49), the train step, a float32 card-against-CPU check, at
    448 px the stem kernels against their plain versions (planted faults
    included) and timed, and a short run from phase 9's files through the
    family's entry points. Returns the launches on these paths, the
    suppression's timings at each family's K and the stem's at 448 px."""
    from podtpu_torch.config import get_configs
    from podtpu_torch.models.factory import build_model
    from podtpu_torch.ops.kernels import stem_kernel as sk

    launches, suppress, stem448 = {}, {}, None
    for i, (name, size, k_own) in enumerate(FAMILIES):
        t_family = time.perf_counter()
        cfg = get_configs(os.path.join(REPO, "configs", f"{name}_voc.yaml"))
        if (cfg["input_size"], cfg["num_classes"], cfg["compute_dtype"],
                cfg["batch_size"]) != (size, 20, "bfloat16", 64):
            raise AssertionError(f"configs/{name}_voc.yaml is not {size} px "
                                 f"bf16 on 20 classes at B=64")
        rng = np.random.default_rng(SEED + 10 + i)
        flat = random_weights(build_model(cfg, dev), SEED + 10 + i)
        checks, serving, serve_launches, suppress[name] = family_serving(
            cfg, flat, dev, rng, k_own)
        train_launches, _, train = train_phase(cfg, flat, dev, card)
        del flat
        # YOLOv1 at 96 px, so that its flatten sees a 2x2 map
        ok_ref, reference = card_vs_cpu(
            cfg, 96 if name == "yolov1" else 64, SEED + 21, rng, dev)
        checks["card_vs_cpu_float32"] = ok_ref
        record = {"phase": "families", "config": f"configs/{name}_voc.yaml",
                  "serving": serving, "train": train,
                  "reference": reference}
        if name == "yolov1":
            record["stem_448"] = {
                str(dt).split(".")[-1]: stem_dtype_checks(sk, dt, dev, size,
                                                          SEED + 12)
                for dt in (torch.bfloat16, torch.float32)}
            (record["stem_448"]["bfloat16_B64"], err, timing,
             _) = stem_timing(sk, dev, size, SEED + 13)
            stem448 = {"max_abs_err": err, "timing": timing}
            record["stem_448"]["timing_B64_bf16"] = timing
        fit_checks, record["fit"], fit_launches = family_fit(cfg, fit, dev,
                                                             tmp)
        checks.update(fit_checks)
        launches = _add_counts(launches, _add_counts(
            _add_counts(serve_launches, fit_launches),
            {f"stem_{k}": v for k, v in train_launches.items()}))
        record.update(checks=checks, seconds=time.perf_counter() - t_family,
                      tolerance="keep masks exact; heads 1e-3 abs, "
                                "detections 1e-2 px with equal valid masks "
                                "(float32 card vs CPU); test vs fit: "
                                "val_loss 1e-5 rel, val_mAP 1e-6; the stem "
                                "as phase stem_kernels",
                      card=card)
        emit(record)
        if not all(checks.values()):
            raise AssertionError(f"the families phase failed its checks for "
                                 f"{name}: "
                                 f"{ {k: v for k, v in checks.items() if not v} }")
        torch.cuda.empty_cache()
    return launches, suppress, stem448


# the families of phase 13: (model, config, its batch, fit's batch so
# that an epoch of phase 9's 128 files is one K-step group and a ragged
# step where the config sets steps_per_dispatch, val batches of 72)
V4_FAMILIES = (("yolov4-tiny", "yolov4-tiny_voc", 64, 14, 9, 6),
               ("yolov4", "yolov4_voc", 32, 32, 4, 3))


def _state_diff(a, b) -> float:
    """Largest |difference| between two train states' model tensors."""
    sa, sb = a.model.state_dict(), b.model.state_dict()
    return max(float((sa[k].double() - sb[k].double()).abs().max())
               for k in sa)


def train_group(cfg, flat, dev):
    """The K-step group (``make_multi_train_step``, K = the config's
    ``steps_per_dispatch``) at the config's shape: the host's stack and
    copy of K uint8 batches (``trainer.put_group``), the group under
    ``torch.cuda.set_sync_debug_mode("error")`` (no host synchronisation
    inside it), then the group timed in turns with K single steps on the
    same batches (3 rounds each), and each's device busy time a step from
    a ``torch.profiler`` trace. Returns (checks, record)."""
    from podtpu_torch.train.state import create_train_state
    from podtpu_torch.train.steps import make_multi_train_step, make_train_step
    from podtpu_torch.train.trainer import put_group

    k, b = int(cfg["steps_per_dispatch"]), int(cfg["batch_size"])
    size = int(cfg["input_size"])
    r = np.random.default_rng(SEED + 30)
    host = [{"img": r.integers(0, 256, (b, size, size, 3), dtype=np.uint8),
             "annot": synthetic_annotations(cfg, b, SEED + 31 + i)}
            for i in range(k)]
    copy = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        group = put_group(host, dev)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        copy.append({"host_ms": (t1 - t0) * 1e3,
                     "on_card_ms": (time.perf_counter() - t0) * 1e3})
    nbytes = sum(v.numel() * v.element_size() for v in group.values())
    state = create_train_state(cfg, dev, weights=flat)
    multi, single = make_multi_train_step(cfg), make_train_step(cfg)
    batches = [{n: v[i] for n, v in group.items()} for i in range(k)]

    def singles(st):
        losses = []
        for bt in batches:
            st, m = single(st, bt)
            losses.append(m["loss"])
        return st, losses

    state, _ = multi(state, group)  # warm-up
    state, _ = singles(state)
    torch.cuda.synchronize()
    _zero_counts()
    sync_error = None
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, m = multi(state, group)
    except RuntimeError as e:  # a synchronising call inside the group
        sync_error = str(e)[:300]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    launches = _counts()
    timing = {"group": [], "singles": []}
    for _ in range(3):
        for name, fn in (("group", lambda st: multi(st, group)),
                         ("singles", singles)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, out = fn(state)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            timing[name].append({"ms_per_step": (t2 - t0) * 1e3 / k,
                                 "host_queue_ms_per_step":
                                     (t1 - t0) * 1e3 / k})
    # the card's busy time a step: its kernels' and copies' times in a
    # profiler trace (the rest of the wall time it waits on the host)
    box = [state]

    def run_group():
        box[0], _ = multi(box[0], group)

    def run_singles():
        box[0], _ = singles(box[0])

    busy = {"group": profiler_ms(run_group, calls=2) / k,
            "singles": profiler_ms(run_singles, calls=2) / k}
    state = box[0]
    summary = {}
    for name, runs in timing.items():
        ms = float(np.mean([t["ms_per_step"] for t in runs]))
        summary[name] = {"ms_per_step": ms, "img_per_s": b * 1e3 / ms,
                         "host_queue_ms_per_step": float(np.mean(
                             [t["host_queue_ms_per_step"] for t in runs])),
                         # None: the trace held no device time
                         "device_busy_ms_per_step": busy[name] or None,
                         "device_idle_share":
                             1.0 - busy[name] / ms if busy[name] else None}
    loss = [float(v) for v in m["loss"]] if sync_error is None else []
    checks = {
        "group_no_host_sync": sync_error is None,
        "group_losses_finite": len(loss) == k and bool(np.isfinite(loss).all()),
        "group_no_kernel_launch": not any(launches.values()),
    }
    record = {"k": k, "batch": b, "stack_and_copy": copy,
              "stack_and_copy_bytes": nbytes, "sync_error": sync_error,
              "group_launches": launches, "rounds": timing, **summary,
              "group_over_singles": summary["group"]["ms_per_step"]
              / summary["singles"]["ms_per_step"]}
    del state, group
    return checks, record


def group_vs_singles_small(cfg, dev):
    """At 64 px float32 (TF32 off, cuDNN deterministic), the K-step group
    against K single steps from the same state on the same batches, and
    beside it K single steps run twice (what the card alone varies).
    Returns (ok, record): the group may be no further from the singles
    than the singles are from themselves."""
    from podtpu_torch.models.factory import build_model
    from podtpu_torch.train.state import create_train_state
    from podtpu_torch.train.steps import make_multi_train_step, make_train_step

    small = dict(cfg, input_size=64, compute_dtype="float32", batch_size=4)
    k = int(cfg["steps_per_dispatch"])
    sflat = random_weights(build_model(small, "cpu"), SEED + 32)
    r = np.random.default_rng(SEED + 33)
    group = {"img": torch.from_numpy(r.integers(
        0, 256, (k, 4, 64, 64, 3), dtype=np.uint8)).to(dev),
             "annot": torch.from_numpy(np.stack([
                 synthetic_annotations(small, 4, SEED + 34 + i)
                 for i in range(k)])).to(dev)}
    single = make_train_step(small)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = []
        for _ in range(2):
            st = create_train_state(small, dev, weights=sflat)
            losses = []
            for i in range(k):
                st, m = single(st, {n: v[i] for n, v in group.items()})
                losses.append(m["loss"])
            runs.append((st, torch.stack(losses)))
        st = create_train_state(small, dev, weights=sflat)
        st, m = make_multi_train_step(small)(st, group)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (s1, l1), (s2, l2) = runs
    rec = {"input_size": 64, "dtype": "float32", "k": k, "batch": 4,
           "group_vs_singles_state": _state_diff(st, s1),
           "group_vs_singles_loss": float((m["loss"] - l1).abs().max()),
           "singles_vs_singles_state": _state_diff(s2, s1),
           "singles_vs_singles_loss": float((l2 - l1).abs().max()),
           "steps": [st.step, s1.step]}
    ok = (st.step == s1.step == k
          and rec["group_vs_singles_state"]
          <= rec["singles_vs_singles_state"]
          and rec["group_vs_singles_loss"] <= rec["singles_vs_singles_loss"])
    return ok, rec


def v4_families_phase(fit, dev, card, tmp):
    """Phase 13: YOLOv4-tiny and YOLOv4, each config unchanged (416 px,
    bf16, 20 classes; B=64 and 32) with seeded weights carried in through
    the weight loader: serving (suppression on the model's own candidates,
    K = 512 of 10,647), the train step with no stem launch, a float32
    card-against-CPU check, for YOLOv4-tiny the K=8 group, and one epoch
    from phase 9's files through the family's entry points. Returns the
    launches on these paths and the suppression's timings."""
    from podtpu_torch.cli import test as test_cli
    from podtpu_torch.config import get_configs
    from podtpu_torch.models.factory import build_model
    from podtpu_torch.train import run

    launches, suppress = {}, {}
    for i, (name, config, batch, fit_batch, n_steps, n_val) in enumerate(
            V4_FAMILIES):
        t_family = time.perf_counter()
        cfg = get_configs(os.path.join(REPO, "configs", f"{config}.yaml"))
        if (cfg["input_size"], cfg["num_classes"], cfg["compute_dtype"],
                cfg["batch_size"]) != (416, 20, "bfloat16", batch):
            raise AssertionError(f"configs/{config}.yaml is not 416 px bf16 "
                                 f"on 20 classes at B={batch}")
        rng = np.random.default_rng(SEED + 40 + i)
        flat = random_weights(build_model(cfg, dev), SEED + 40 + i)
        checks, serving, serve_launches, suppress[name] = family_serving(
            cfg, flat, dev, rng, 512)
        train_launches, _, train = train_phase(cfg, flat, dev, card,
                                               batch=batch, stem_per_step=0)
        record = {"phase": "v4_families", "config": f"configs/{config}.yaml",
                  "serving": serving, "train": train}
        if cfg.get("steps_per_dispatch"):
            group_checks, record["group"] = train_group(cfg, flat, dev)
            checks.update(group_checks)
            checks["group_equals_singles_64px"], record["group_64px"] = (
                group_vs_singles_small(cfg, dev))
        del flat
        torch.cuda.empty_cache()
        checks["card_vs_cpu_float32"], record["reference"] = card_vs_cpu(
            cfg, 64, SEED + 41, rng, dev,
            rel_tol=None if name == "yolov4-tiny" else (1e-4, 1e-3))
        if name == "yolov4-tiny":
            fit_checks, record["fit"], fit_launches = family_fit(
                cfg, fit, dev, tmp, n_steps=n_steps, n_val=n_val,
                stem_per_step=0, batch_size=fit_batch)
        else:
            fit_checks, record["fit"], fit_launches = family_fit(
                cfg, fit, dev, tmp, train_main=run.main,
                test_main=test_cli.main, n_steps=n_steps, n_val=n_val,
                stem_per_step=0)
        checks.update(fit_checks)
        launches = _add_counts(launches, _add_counts(
            _add_counts(serve_launches, fit_launches),
            {f"stem_{k}": v for k, v in train_launches.items()}))
        record.update(checks=checks, seconds=time.perf_counter() - t_family,
                      tolerance="keep masks exact; float32 card vs CPU: "
                                "YOLOv4-tiny heads 1e-3 abs and detections "
                                "1e-2 px, YOLOv4 (heads ~1e3 at random "
                                "weights) heads 1e-4 and detections 1e-3 "
                                "of their largest value, valid masks "
                                "equal; the group no further from K single "
                                "steps than K single steps from "
                                "themselves; test vs fit: val_loss 1e-5 "
                                "rel, val_mAP 1e-6",
                      card=card)
        emit(record)
        if not all(checks.values()):
            raise AssertionError(f"the v4_families phase failed its checks "
                                 f"for {name}: "
                                 f"{ {k: v for k, v in checks.items() if not v} }")
        torch.cuda.empty_cache()
    return launches, suppress


RETINA_CONFIG = "configs/retinanet_voc.yaml"


def _grad_norm(model) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack(
        [p.grad.norm() for p in model.parameters() if p.grad is not None]))


def retinanet_train(cfg, flat, dev, card):
    """Phase 14's train step: ``configs/retinanet_voc.yaml`` unchanged
    (B=32, clip_grad_norm 10) on a batch on the card: 3 warm-up steps, a
    step watched for CPU tensors, a step under
    ``torch.cuda.set_sync_debug_mode("error")``, 10 timed steps with the
    kernel counters zeroed around them, the forward / targets + loss /
    backward / clip + optimizer split with the targets alone and the
    loss's own peak memory, and last a step with a planted gradient 1e4
    times the raw one, whose global norm after the clip must be 10.
    Returns (checks, record, launches of the timed steps)."""
    from podtpu_torch.losses import build_loss
    from podtpu_torch.ops.retina import anchors_on, assign_targets
    from podtpu_torch.train.state import create_train_state
    from podtpu_torch.train.steps import make_train_step

    b, size = int(cfg["batch_size"]), int(cfg["input_size"])
    if (b, cfg["max_annots"], cfg["optimizer"], cfg["scheduler"],
            cfg["optimizer_options"].get("clip_grad_norm")) != (
                32, 64, "sgd", "multi_step", 10.0):
        raise AssertionError("configs/retinanet_voc.yaml is not the B=32 "
                             "nesterov-SGD multi_step recipe with "
                             "clip_grad_norm 10")
    torch.cuda.reset_peak_memory_stats()
    state = create_train_state(cfg, dev, weights=flat)
    step = make_train_step(cfg)
    r = np.random.default_rng(SEED + 51)
    img = torch.from_numpy(r.random((b, size, size, 3), np.float32)).to(dev)
    annot = torch.from_numpy(synthetic_annotations(cfg, b, SEED + 52)).to(dev)
    batch = {"img": img, "annot": annot}
    keys = ("backbone.stem.bn.running_mean", "backbone.stem.bn.running_var",
            "backbone.stage4_block2.conv3.bn.running_var")
    bns = {k: state.model.state_dict()[k].clone() for k in keys}
    losses = []
    for _ in range(3):
        state, m = step(state, batch)
        losses.append(m["loss"])
    spy = _CpuTensorSpy()
    with spy:
        state, m = step(state, batch)
    losses.append(m["loss"])
    torch.cuda.synchronize()
    sync_error = None
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, m = step(state, batch)
        losses.append(m["loss"])
    except RuntimeError as e:  # a synchronising call inside the step
        sync_error = str(e)[:300]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    _zero_counts()
    iters = 10
    t0 = time.perf_counter()
    for _ in range(iters):
        state, m = step(state, batch)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / iters
    launches = _counts()
    loss_vals = [float(v) for v in losses]
    moved = {k: float((state.model.state_dict()[k] - v).abs().max())
             for k, v in bns.items()}

    # the split, CUDA events between the parts; the targets alone and the
    # loss's own peak above what the forward left allocated
    loss_fn = build_loss(cfg)
    anchors = anchors_on(dev, size)
    split = {"forward": 0.0, "targets_and_loss": 0.0, "backward": 0.0,
             "clip_and_optimizer": 0.0}
    reps, loss_peak = 3, 0.0
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ev[0].record()
        preds = state.model(img)
        ev[1].record()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ev[2].record()
        loss = loss_fn(preds, annot)
        ev[3].record()
        torch.cuda.synchronize()
        loss_peak = max(loss_peak, torch.cuda.max_memory_allocated() - base)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        ev[4].record()
        state.apply_gradients()
        ev[5].record()
        torch.cuda.synchronize()
        for k, (a, z) in zip(split, ((0, 1), (2, 3), (3, 4), (4, 5))):
            split[k] += ev[a].elapsed_time(ev[z]) / reps
    del preds, loss
    targets_ms = cuda_ms(lambda: assign_targets(
        anchors, annot, cfg["num_classes"], size), 10)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # the clip engaged: a gradient 1e4 times the raw one
    state.optimizer.zero_grad(set_to_none=True)
    loss_fn(state.model(img), annot).backward()
    raw_norm = float(_grad_norm(state.model))
    grads = [p.grad for p in state.model.parameters()]
    torch._foreach_mul_(grads, 1e4)
    planted = float(_grad_norm(state.model))
    # the norm the optimizer is handed (its foreach nesterov update then
    # adds the momentum into the gradients of a group without decay)
    seen = []
    hook = state.optimizer.register_step_pre_hook(
        lambda *_: seen.append(float(_grad_norm(state.model))))
    try:
        state.apply_gradients()
    finally:
        hook.remove()
    (clipped,) = seen
    checks = {
        "train_losses_finite": len(loss_vals) == 15
        and bool(np.isfinite(loss_vals).all()),
        "train_bn_stats_moved": min(moved.values()) > 0.0,
        "train_no_stem_kernel": not any(v for k, v in launches.items()
                                        if k.startswith("stem_")),
        "train_no_suppress_kernel": launches["greedy_suppress"] == 0,
        "train_no_cpu_tensors": not spy.cpu_ops,
        "train_no_host_sync": sync_error is None,
        "clip_engaged": planted > 10.0 and abs(clipped - 10.0) <= 1e-5 * 10.0,
    }
    record = {"model": "retinanet", "input_size": size,
              "compute_dtype": cfg["compute_dtype"], "batch": b,
              "timed_steps": iters, "launches": launches,
              "loss_first_last": [loss_vals[0], loss_vals[-1]],
              "bn_stats_moved": moved, "ms_per_step": step_ms,
              "img_per_s": b * 1e3 / step_ms, "split_ms": split,
              "targets_ms": targets_ms,
              "iou_tensor_mb": b * anchors.shape[0] * cfg["max_annots"] * 4
              / 1e6,
              "loss_peak_memory_gb": loss_peak / 1e9,
              "peak_memory_gb": peak_gb,
              "raw_grad_norm": raw_norm,
              "clip_planted_norm": planted, "clip_after_norm": clipped,
              "sync_error": sync_error, "cpu_ops": sorted(set(spy.cpu_ops)),
              "card": card}
    del state, img, batch
    return checks, record, launches


def retinanet_phase(fit, dev, card, tmp):
    """Phase 14: ``configs/retinanet_voc.yaml`` unchanged (512 px, bf16,
    20 classes, B=32, clip_grad_norm 10) with seeded weights carried in
    through the weight loader: serving (suppression once a dispatch, no
    stem launch; keep masks on the model's own candidates, K = 512 of
    49,104, full at B=8, bit-equal at B=8 and 64 and timed), the train step
    (:func:`retinanet_train`), a 64 px float32 model and its loss on the
    card against the CPU, and one epoch from phase 9's files through
    ``train.run`` scored by ``cli.test`` on its ``best``. Returns the
    launches on these paths and the suppression's timings."""
    from podtpu_torch.cli import test as test_cli
    from podtpu_torch.config import get_configs
    from podtpu_torch.models.factory import build_model
    from podtpu_torch.ops.retina import all_anchors
    from podtpu_torch.train import run

    t_phase = time.perf_counter()
    cfg = get_configs(os.path.join(REPO, RETINA_CONFIG))
    if (cfg["input_size"], cfg["num_classes"], cfg["compute_dtype"],
            cfg["batch_size"]) != (512, 20, "bfloat16", 32):
        raise AssertionError(f"{RETINA_CONFIG} is not 512 px bf16 on 20 "
                             "classes at B=32")
    n_anchors = int(all_anchors(512).shape[0])
    rng = np.random.default_rng(SEED + 50)
    flat = random_weights(build_model(cfg, dev), SEED + 50)
    checks, serving, serve_launches, suppress = family_serving(
        cfg, flat, dev, rng, 512)
    checks["suppress_K_full_at_B8"] = (
        serving["suppress_keep"]["B8"]["valid"] == 8 * 512)
    train_checks, train, train_launches = retinanet_train(cfg, flat, dev,
                                                          card)
    checks.update(train_checks)
    del flat
    torch.cuda.empty_cache()
    small = dict(cfg, max_annots=8)
    checks["card_vs_cpu_float32"], reference = card_vs_cpu(
        small, 64, SEED + 53, rng, dev, rel_tol=(1e-4, 1e-3),
        annot=synthetic_annotations(small, 2, SEED + 54))
    fit_checks, fit_record, fit_launches = family_fit(
        cfg, fit, dev, tmp, train_main=run.main, test_main=test_cli.main,
        n_steps=4, n_val=3, stem_per_step=0)
    checks.update(fit_checks)
    launches = _add_counts(_add_counts(serve_launches, fit_launches),
                           train_launches)
    emit({"phase": "retinanet", "config": RETINA_CONFIG,
          "anchors": n_anchors, "serving": serving, "train": train,
          "reference": reference, "fit": fit_record, "checks": checks,
          "seconds": time.perf_counter() - t_phase,
          "tolerance": "keep masks exact; float32 card vs CPU: heads 1e-4 "
                       "and detections 1e-3 of their largest value, valid "
                       "masks equal, loss 1e-4 rel; the clipped norm 1e-5 "
                       "rel of 10; test vs fit: val_loss 1e-5 rel, val_mAP "
                       "1e-6",
          "card": card})
    if not all(checks.values()):
        raise AssertionError(f"the retinanet phase failed its checks: "
                             f"{ {k: v for k, v in checks.items() if not v} }")
    torch.cuda.empty_cache()
    return launches, suppress


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1

    from podtpu_torch.config import get_configs
    from podtpu_torch.models.factory import build_model
    from podtpu_torch.ops.kernels import build
    from podtpu_torch.ops.kernels.nms_kernel import (
        MAX_K,
        greedy_suppress,
        greedy_suppress_reference,
    )
    from podtpu_torch.serve import Engine
    from podtpu_torch.train.steps import _decoder_and_nms

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
    n_threads = 4
    reqs = rng.integers(0, 256, (n_threads * 6, 416, 416, 3), dtype=np.uint8)
    results, launches, dispatches, serve_s = serve_requests(engine, reqs,
                                                            n_threads)
    checks = serving_checks(engine, results, launches, dispatches,
                            images[8], dev)
    if not all(checks.values()):
        raise AssertionError(f"the slice phase failed its checks: "
                             f"{ {k: v for k, v in checks.items() if not v} }")
    n_det = [r["num_detections"] for r in results]
    timings = stage_ms(engine, decoder, nms, images)
    emit({"phase": "slice", "model": "yolov3", "input_size": 416,
          "compute_dtype": cfg["compute_dtype"], "num_classes": 20,
          "requests": len(reqs), "threads": n_threads, "micro_batch": 8,
          "dispatches": dispatches,
          "launches": {"greedy_suppress": launches["greedy_suppress"]},
          "detections_per_request": [min(n_det), max(n_det)],
          "serve_seconds": round(serve_s, 3),
          "latency_ms": engine.stats.snapshot()["latency_ms"],
          "ms_per_batch": timings, "card": card})

    # 5. a small float32 model on the card against the same on the CPU
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ok, rec = card_vs_cpu(cfg, 64, SEED + 1, rng, dev)
    emit({"phase": "reference", "dtype": "float32", "tf32": False, **rec,
          "tolerance": "heads 1e-3 abs (conv summation order), "
                       "detections 1e-2 px with equal valid masks"})
    if not ok:
        raise AssertionError("card and CPU disagree on the 64 px f32 model")

    # 6.-8. the training slice (TF32 stays off from phase 5)
    stem_entries = stem_phase(dev, card)
    train_launches, step_img_s, record = train_phase(cfg, flat, dev, card)
    emit({"phase": "train", **record})
    for e in stem_entries:
        e["launches"] = train_launches[e["name"][len("stem_"):]]
    train_reference_phase(cfg, dev)

    # 9.-11. the training run from files through its entry point, then
    # what users do with its checkpoint, and SWA, on the same files
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="podtpu_fit_")
    try:
        fit_launches, fit = fit_phase(dev, card, step_img_s, tmp)
        consume_launches, suppress_b1 = consume_phase(fit, dev, card, tmp)
        swa_launches, recal = swa_phase(fit, dev, card, tmp)
        # 12. the YOLOv2 and YOLOv1 families on the same files
        family_launches, family_suppress, stem448 = families_phase(
            fit, dev, card, tmp)
        # 13. the YOLOv4-tiny and YOLOv4 families on the same files
        v4_launches, v4_suppress = v4_families_phase(fit, dev, card, tmp)
        # 14. RetinaNet-ResNet50 on the same files
        retina_launches, retina_suppress = retinanet_phase(fit, dev, card,
                                                           tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for e in stem_entries:
        e["launches_fit"] = fit_launches[e["name"]]
        e["launches_consume"] = consume_launches[e["name"]]
        e["launches_swa"] = swa_launches[e["name"]]
        e["launches_recalibrate_bn"] = recal["launches"][
            e["name"][len("stem_"):]]
        e["launches_families"] = family_launches[e["name"]]
        e["launches_v4_families"] = v4_launches[e["name"]]
        e["launches_retinanet"] = retina_launches[e["name"]]
        t448 = stem448["timing"][e["name"][len("stem_"):]]
        e.update(ms_448=t448["ms"], plain_ms_448=t448["plain_ms"],
                 bound_ms_448=t448["bound_ms"],
                 max_abs_err_448=stem448["max_abs_err"][
                     e["name"][len("stem_"):]])
    v1, v2 = family_suppress["yolov1"], family_suppress["yolov2"]

    emit({"kernels": [{
        "name": "greedy_suppress",
        "route": "cuda",
        "source": "podtpu_torch/csrc/nms_suppress.cu",
        "replaces": REPLACES,
        "launches": launches["greedy_suppress"],
        "launches_fit": fit_launches["greedy_suppress"],
        "launches_consume": consume_launches["greedy_suppress"],
        "launches_swa": swa_launches["greedy_suppress"],
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "device_ms": dev_ms,
        "ms_B64": b64_ms,
        "ms_B1": suppress_b1["ms"],
        "device_ms_B1": suppress_b1["device_ms"],
        "plain_ms_B1": suppress_b1["plain_ms"],
        "bound_ms_B1": suppress_b1["bound_ms"],
        "launches_families": family_launches["greedy_suppress"],
        "ms_K49": v1["ms"], "device_ms_K49": v1["device_ms"],
        "plain_ms_K49": v1["plain_ms"], "bound_ms_K49": v1["bound_ms"],
        "ms_v2": v2["ms"], "device_ms_v2": v2["device_ms"],
        "plain_ms_v2": v2["plain_ms"], "bound_ms_v2": v2["bound_ms"],
        "launches_v4_families": v4_launches["greedy_suppress"],
        **{f"{k}_{tag}": v4_suppress[m][k]
           for m, tag in (("yolov4-tiny", "v4tiny"), ("yolov4", "v4"))
           for k in ("ms", "device_ms", "plain_ms", "bound_ms")},
        "launches_retinanet": retina_launches["greedy_suppress"],
        **{f"{k}_retina": retina_suppress[k]
           for k in ("ms", "device_ms", "plain_ms", "bound_ms")},
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
