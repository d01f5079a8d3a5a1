#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``podtpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line (phases 12 and 13 one a family,
phase 17 one a profile) and
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
   its ``best`` (the same val_loss and val_mAP), the checkpoints deleted;
15. device_aug: the device augmentation's apply (``data/device_aug.py``)
   at B=64, 416 px on the card against the same function on the CPU with
   the same draws (made on the card): the exact HSV path bit for bit, the
   approximate one within 1e-5, the warp within 1e-4 (TF32 off); each
   timed beside its bound and phase 7's step. Then
   ``configs/yolov4_synth.yaml`` as shipped (``device_augment: true``) on
   a generated 4-class 256 px set (64 + 16 images), 2 epochs through
   ``train.run``'s entry point and ``cli.test`` on ``last``; one more step
   with no host synchronisation and no CPU tensor;
16. fit, two more ways: phase 9's run with ``device_augment: true``, and
   with ``device_geom`` and ``device_hsv: exact`` as well (the stem's four
   kernels every step), each beside phase 9's: the loader alone, ``fit``'s
   img/s, the share blocked on the loader and the augmentation's ms a
   step; then a checkpoint saved synchronously and asynchronously, each
   save's blocking ms, both restored equal;
17. profile: ``podtpu_torch.utils.step_profile`` over 3 steps of
   YOLOv3 (B=64), YOLOv4-tiny (B=64), YOLOv4 (B=32) and RetinaNet (B=32)
   on a batch on the card, and of YOLOv3 fed from phase 9's files with
   and without device augmentation: the top kernels, busy and window ms
   and the idle share, the backward by autograd node, the step by part
   and the forward by module; it fails where these cover less than 99%
   of the kernels' time.
18. options: the serving and train-step options on
   ``configs/yolov3_voc.yaml`` (416 px, bf16) with phase 3's weights.
   Serving at B=8 and 64, one serve call each of ``nms_options`` merge,
   agnostic, classes [0, 14], multi-label and ``tta`` (hflip, scales 0.83
   and 0.67): the suppression launched once, its keep mask on the
   option's own candidates equal to the plain version, the detections
   of the card's NMS against the CPU's on the same candidates (valid
   masks exactly, boxes within 1e-3: the merge's float32 product), ms
   beside plain serving. Training at B=64, 1 + 3 steps each of the plain
   recipe, adam, radam, adamw, SGD with ``flat``, ``accum_steps: 2``,
   ``ema: true`` (the shadow against a float64 recomputation of the
   blend), ``remat_policy`` conv_out and no_post_act and
   ``remat_backbone`` (gradients and running statistics against the
   plain step; conv_out and remat_backbone must lower the step's peak)
   and ``qat`` (the stem launched 0 times), each with its stem launches,
   ms and peak GB; ``skip_nonfinite: 2`` with a NaN pixel (the state bit
   for bit, the count, the third bad step in a row applied, the BN
   statistics kept finite) and its cost: ms and host synchronisations a
   step with and without the guard. Then one epoch of phase 9's run with
   ``ema: true`` and ``accum_steps: 2`` through ``train.run.train`` and
   ``cli.test --use-ema`` on its ``best`` (the fit's own val_loss).
19. pretrain: ``cli.pretrain_darknet`` (``pretrain``) for one epoch at
   64 px, B=128, on a generated 20 x 16-image classification set (the
   stem's four kernels once a step), Darknet-19 classifier steps at 224
   and 64 px (B=128) and CSPDarknet53's at 224 px (B=32, no stem launch),
   each with ms, img/s, the card's idle share, launches and peak GB; the
   stem kernels against their plain versions at both sizes (B=8 with the
   planted faults, B=128 timed beside the bound); the written ``.npz`` loaded into
   ``configs/yolov3_voc.yaml`` through ``backbone_pretrained``, every
   backbone tensor bit for bit.
20. export: YOLOv3-416 on phase 3's weights exported as ``.pt2`` serving
   artifacts at B=8 and with a symbolic batch, loaded and held to the
   in-process ``make_serve_fn`` (valid masks equal, boxes and scores
   within 1e-4), the suppression launched once a call from inside the
   loaded program, ms against in-process serving; a forward artifact
   through ``validate_for_npu`` (the serving one must fail);
   ``fold_batchnorm`` in float32; int8 PTQ calibrated on 4 val batches of
   phase 9's files: every block's int32 accumulator in the quantized eval
   step equal to the plain float64 version's, int8 against bf16 forward
   ms, the score drift; ``cli.export_model`` then ``cli.test --artifact``
   on phase 9's ``best`` against ``cli.test --ckpt`` (val_mAP within
   1e-6, and each batch's detections handed to the host mAP held as the
   artifacts above). Then (PR 17) the TFLite files written by hand
   (``export/tflite.py``): YOLOv3-416 float32 serving ``.tflite`` at B=1
   and B=8 run by the port's reader on the card against the float32
   in-process ``make_serve_fn`` as the artifacts above, the suppression
   launched once a call from inside the reader, a forward file's heads
   against the model's (a planted transposed 3x3 filter must fail that
   check), export s, MB and load s, ms a batch against a float32 ``.pt2``
   and in-process serving; ``cli.export_model --format tflite`` and
   ``cli.test --artifact x.tflite`` on phase 9's ``best`` against
   ``--ckpt``, both float32 at B=8. Then the quantized files
   (``export/tflite_quant.py``) of phase 9's ``best`` in float32: int8
   (calibrated on 4 val batches) and dynamic range serving files at B=1
   and B=8 read on a fifth val batch, the card's reader against the
   CPU's on the same file (int8: every int8 code equal, detections paired
   as above; dynamic: heads within 0.1 of their scale), one suppression
   launch a call, the heads against the float file's (within 0.1 of
   their scale, the CPU tests' bound), MB (int8 under half the float
   file), export s and ms a batch of the float, int8 and dynamic readers;
   ``cli.export_model --quantize int8`` and ``cli.test --artifact`` on
   it, one launch a batch, its val mAP beside the float file's.

21. parallel: data parallelism with global BatchNorm through the fused
   stem's kernels, FSDP, and the multi-process run (``parallel/``). Two
   ranks share the card over gloo (CUDA tensors): YOLOv3-416 at full width
   and depth, 16 images, 8 a rank, one float32 and one bf16 DP step and a
   float32 FSDP step, each rank launching each stem kernel once a step,
   held against one process's step on the 16 (bf16 by the loss, the
   statistics and the update's norm, which a planted summed-gradient step
   must fail); the fused stem op alone under the two ranks in both dtypes
   against one process; rank 0 times the stem kernels at its 8 rows. Then a two-rank ``train.run --distributed``
   under torchrun for one epoch of phase 9's files, whose gathered
   ``validate`` must give each image the detections, and the val mAP, of
   one process's ``validate`` of the same weights; then one rank under
   nccl: the B=64 DP and FSDP steps beside the plain step (ms a step, peak
   GB). Two ranks on one card check correctness; they are no scaling
   number. Every process it starts has a hard timeout.
22. layouts: the tensor-parallel and spatial layouts (``parallel/
   layouts.py``). Two ranks share the card over gloo as one data row:
   YOLOv3-416 as shipped at 8 images on a ``(model=2)`` mesh, then a
   ``(space=2)`` mesh (the stem's four kernels on blocks of 208 rows with
   their halo), a float32 (TF32 off) and a bf16 train step and the
   float32 eval step against one process's (``LAYOUTS_TOL``), with ms a
   step and peak GB beside the plain step's; meanwhile the halo stem
   kernels against their plain twins and the whole-image kernels in both
   dtypes (a halo of zeros must fail), timed on a block of 208 rows;
   then ``cli/autobatch.py`` on YOLOv3-416 at batches 32, 64 and 128.

The line before the last is ``nvidia-smi``'s name and power limit; the last
line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or without
the rest of the repository beside it, the script exits non-zero and prints
no result.
"""

from __future__ import annotations

import copy
import functools
import json
import os
import re
import subprocess
import sys
import threading
import time
import types
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


def stem_bound(kind, b, h, w, itemsize, halo=False):
    """(bound_ms, bound_by, {term: ms}) of one stem kernel at [b, h, w, 3]
    (with ``halo``, [b, h + 2, w, 3] computing h rows): the largest of the
    times of the resources that run at once. Bytes: x read once, the
    weights and vectors, the pooled output or cotangent once. Tensor cores
    (bf16): the conv's multiply-adds, twice for dW. float32 pipes: the
    epilogue's operations, and in float32 the conv's."""
    px = b * h * w
    nbytes = b * (h + 2 * int(halo)) * w * 3 * itemsize + 27 * 32 * 4
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


def stem_timing(sk, dev, size, seed, b=64):
    """At the train step's shape (B=``b``, ``size`` px, bf16): the
    per-kernel checks again, then each kernel timed beside its bound and
    its plain version. Returns (checks, max_abs_err per kernel, timing,
    operands)."""
    x, w, scale, bias, g = stem_inputs(b, torch.bfloat16, dev, seed, size)
    ok, checks, max_err, vecs, _ = stem_kernel_checks(
        sk, x, w, scale, bias, g, 1e-5)
    if not ok:
        raise AssertionError(f"stem kernels differ from their plain versions "
                             f"at B={b} bf16, {size} px: {checks}")
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
        bound_ms, bound_by, terms = stem_bound(k, b, size, size, 2)
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
    from podtpu_torch.train.trainer import (Trainer, put_batch,
                                            restore_eval_weights)

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
        batch = put_batch({k: v for k, v in next(iter(
            make_loaders(cfg)[0])).items() if k != "n_valid"},
            resumed.device)
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
    from podtpu_torch.train.trainer import put_batch

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
    on_card = put_batch(batch, trainer.device)
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
            boxes, valid, thr), 200, warmup=10), "op_ms": cuda_ms(
            lambda: torch.ops.podtpu_torch.greedy_suppress(
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
    from podtpu_torch.train.trainer import put_batch

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
        batch = put_batch({k: v for k, v in next(iter(
            make_loaders(fcfg)[0])).items() if k != "n_valid"},
            trainer.device)
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


# ---- phases 15-17: device augmentation, the fit three ways, the profile ----

AUG_TOL = {"exact": 0.0, "approx": 1e-5, "warp": 1e-4}


def aug_bound_ms(kind, b, h, w):
    """(bound ms, by): the larger of the bytes the function must move (the
    images read once and written once: uint8 in and float32 out for the
    jitter, float32 both ways for the warp) over the card's memory rate,
    and its float32 operations over the card's float32 rate (TF32 off).
    The warp's two batched products make B * 3 * (H*H*W + H*W*W)
    multiply-adds, two operations each."""
    px = b * h * w * 3
    if kind == "warp":
        nbytes, ops = px * 8, 2 * b * 3 * (h * h * w + h * w * w)
    else:
        nbytes, ops = px * (1 + 4), 0
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def device_aug_checks(dev, b=64, size=416, seed=SEED):
    """The apply on the card against the same function on the CPU with the
    same draws (made on the card, copied over), for ``exact``, ``approx``
    and the warp, each timed with CUDA events. Returns (checks, record)."""
    from podtpu_torch.data import device_aug as T

    r = np.random.default_rng(seed + 15)
    img = torch.from_numpy(r.integers(0, 256, (b, size, size, 3),
                                      dtype=np.uint8))
    annot = torch.from_numpy(synthetic_annotations(
        {"max_annots": 64, "num_classes": 20}, b, seed))
    s = r.uniform(0.75, 1.25, (b, 1))
    geom = torch.from_numpy(np.concatenate(
        [s, s, r.uniform(-0.1, 0.1, (b, 2)) * size], 1).astype(np.float32))
    gen = torch.Generator(device=dev).manual_seed(seed)
    gains, flips = T.draw_augment(b, gen)
    img_d, annot_d, geom_d = img.to(dev), annot.to(dev), geom.to(dev)
    checks, err, ms = {}, {}, {}
    for hsv in ("exact", "approx"):
        got = T.apply_augment(img_d, annot_d, gains, flips, hsv)
        want = T.apply_augment(img, annot, gains.cpu(), flips.cpu(), hsv)
        err[hsv] = float((got[0].cpu() - want[0]).abs().max())
        checks[f"{hsv}_images"] = err[hsv] <= AUG_TOL[hsv]
        checks[f"{hsv}_boxes"] = torch.equal(got[1].cpu(), want[1])
        ms[hsv] = cuda_ms(lambda: T.apply_augment(  # noqa: B023
            img_d, annot_d, gains, flips, hsv), 10)
    x = img.float() / 255.0
    x_d = x.to(dev)
    tf32 = bool(torch.backends.cuda.matmul.allow_tf32)
    err["warp"] = float((T.separable_affine(x_d, geom_d).cpu()
                         - T.separable_affine(x, geom)).abs().max())
    checks["warp"] = err["warp"] <= AUG_TOL["warp"]
    ms["warp"] = cuda_ms(lambda: T.separable_affine(x_d, geom_d), 10)
    ms["draw"] = cuda_ms(lambda: T.draw_augment(b, gen), 20)
    checks["draws_on_the_card"] = (gains.device.type == flips.device.type
                                   == "cuda")
    bound = {k: aug_bound_ms(k, b, size, size)
             for k in ("exact", "approx", "warp")}
    bound = {"bound_ms": {k: v[0] for k, v in bound.items()},
             "bound_by": {k: v[1] for k, v in bound.items()}}
    return checks, {"batch": b, "input_size": size, "max_abs_err": err,
                    "tolerance": AUG_TOL, "ms": ms, **bound,
                    "matmul_allow_tf32": tf32}


def yolov4_synth_run(dev, tmp):
    """``configs/yolov4_synth.yaml`` as shipped (``device_augment: true``),
    its three paths pointed at a generated 4-class 256 px set (64 train and
    16 val images) and its epochs cut to 2: ``train.run``'s entry point,
    then ``cli.test``'s on ``last``; one more step under
    ``set_sync_debug_mode("error")`` and the CPU-tensor spy. Returns
    (checks, record, launches of the two runs)."""
    import shutil

    import yaml

    from podtpu_torch.cli import test as test_cli
    from podtpu_torch.config import get_configs
    from podtpu_torch.data.synthetic import generate
    from podtpu_torch.train import run
    from podtpu_torch.train.trainer import put_batch

    shipped = get_configs(os.path.join(REPO, "configs", "yolov4_synth.yaml"))
    data = generate(os.path.join(tmp, "synth4"), n_train=64, n_val=16,
                    size=256, num_classes=4, max_objects=8, seed=SEED)
    cfg = dict(shipped, train_list=data["train_list"],
               val_list=data["val_list"], names=data["names"], epochs=2,
               save_dir=os.path.join(tmp, "runs_synth"))
    path = os.path.join(tmp, "yolov4_synth.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    try:
        torch.cuda.synchronize()
        _zero_counts()
        t0 = time.perf_counter()
        trainer = run.main(["--cfg", path])
        torch.cuda.synchronize()
        fit_s, fit_launches = time.perf_counter() - t0, _counts()
        last = os.path.join(trainer.run_dir, "checkpoints", "last")
        # one more step on a batch from the files: no host sync, no CPU op
        batch = put_batch({k: v for k, v in next(iter(
            run.make_loaders(cfg)[0])).items() if k != "n_valid"},
            trainer.device)
        trainer.train_step(trainer.state, batch)
        torch.cuda.synchronize()
        spy, sync_error = _CpuTensorSpy(), None
        torch.cuda.set_sync_debug_mode("error")
        try:
            with spy:
                trainer.train_step(trainer.state, batch)
        except RuntimeError as e:  # a synchronising call inside the step
            sync_error = str(e)[:300]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        rows = trainer.history
        del trainer
        _zero_counts()
        t0 = time.perf_counter()
        res = test_cli.main(["--cfg", path, "--ckpt", last])
        torch.cuda.synchronize()
        test_s, test_launches = time.perf_counter() - t0, _counts()
    finally:
        shutil.rmtree(cfg["save_dir"], ignore_errors=True)
    n_val = -(-16 // int(cfg["batch_size"]))
    checks = {
        "as_shipped": shipped["device_augment"] is True
        and (shipped["input_size"], shipped["num_classes"]) == (256, 4),
        "two_epochs": [r["epoch"] for r in rows] == [0, 1]
        and rows[-1]["step"] == 2 * (64 // int(cfg["batch_size"])),
        "finite": all(np.isfinite(r["train_loss"]) for r in rows),
        "no_host_sync_in_a_step": sync_error is None,
        "no_cpu_tensors": not spy.cpu_ops,
        "test_scores": np.isfinite(res["val_loss"])
        and 0.0 <= res["val_mAP"] <= 1.0,
        "test_suppress_once_per_val_batch":
            test_launches["greedy_suppress"] == n_val,
    }
    return checks, {"config": "configs/yolov4_synth.yaml", "epochs": 2,
                    "history": rows, "test": res, "fit_seconds": fit_s,
                    "test_seconds": test_s, "sync_error": sync_error,
                    "cpu_ops": sorted(set(spy.cpu_ops)),
                    "fit_launches": fit_launches,
                    "test_launches": test_launches}, _add_counts(
                        fit_launches, test_launches)


def device_aug_phase(dev, card, step_ms, tmp):
    """Phase 15: the augmentation's apply at B=64, 416 px on the card
    against the CPU, timed beside phase 7's train step, then
    ``configs/yolov4_synth.yaml`` through its entry points. Returns the
    launches of the yolov4_synth run."""
    t_phase = time.perf_counter()
    checks, record = device_aug_checks(dev)
    synth_checks, synth, launches = yolov4_synth_run(dev, tmp)
    checks.update({f"yolov4_synth_{k}": v for k, v in synth_checks.items()})
    emit({"phase": "device_aug", "checks": checks, **record,
          "train_step_ms": step_ms, "yolov4_synth": synth,
          "seconds": time.perf_counter() - t_phase, "card": card})
    if not all(checks.values()):
        raise AssertionError(f"the device_aug phase failed its checks: "
                             f"{ {k: v for k, v in checks.items() if not v} }")
    return launches


class _AugTimer:
    """Within it, the train steps a ``make_train_step`` builds time their
    warp and their jitter with CUDA events (the script's view)."""

    def __init__(self):
        self.events = {"warp": [], "jitter": []}

    def _timed(self, fn, key):
        def call(*a):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = fn(*a)
            ev[1].record()
            self.events[key].append(ev)
            return out
        return call

    def __enter__(self):
        from podtpu_torch.train import steps

        self._saved = (steps.separable_affine, steps.make_device_augment)
        warp, make = self._saved
        timer = self

        def make_timed(cfg):
            aug = make(cfg)
            return None if aug is None else timer._timed(aug, "jitter")

        steps.separable_affine = self._timed(warp, "warp")
        steps.make_device_augment = make_timed
        return self

    def __exit__(self, *exc):
        from podtpu_torch.train import steps

        steps.separable_affine, steps.make_device_augment = self._saved

    def ms(self) -> dict:
        torch.cuda.synchronize()
        return {k: [a.elapsed_time(b) for a, b in v]
                for k, v in self.events.items()}


FIT_WAYS = {
    "host": {},
    "device_augment": {"device_augment": True},
    "device_geom_exact": {"device_augment": True, "device_geom": True,
                          "device_hsv": "exact"},
}


def fit_ways_phase(fit, dev, card, tmp):
    """Phase 16: ``train.run.train`` on phase 9's files three ways (host
    augmentation as in phase 9; ``device_augment: true``; with
    ``device_geom`` and ``device_hsv: exact`` as well), 2 epochs validated
    each, run in the order ABC CBA after one unmeasured pass of the loader
    (the files in the page cache), so each way has a reading early and
    late. For each run: the loader alone, ``fit``'s img/s, the share
    blocked on the loader, the augmentation's ms a step and the stem's
    launches (every step). Then checkpoints of the last run's state after
    a train step each, saved synchronously and asynchronously: the
    blocking ms of each, and the two restored equal. Returns the launches
    of the six runs."""
    from podtpu_torch.train.run import make_loaders, train
    from podtpu_torch.train.trainer import CheckpointIO, Trainer, put_batch

    t_phase = time.perf_counter()
    sum(1 for _ in make_loaders(dict(fit["cfg"]))[0])  # warms the cache
    order = list(FIT_WAYS) + list(FIT_WAYS)[::-1]
    ways = {way: [] for way in FIT_WAYS}
    launches, checks = [], {}
    steps_per_epoch = -(-128 // 64)
    n_steps = 2 * steps_per_epoch
    for i, way in enumerate(order):
        extra = FIT_WAYS[way]
        cfg = dict(fit["cfg"], save_dir=os.path.join(tmp, f"runs_{way}"),
                   **extra)
        loader = make_loaders(cfg)[0]
        t0 = time.perf_counter()
        n_img = sum(b["n_valid"] for b in loader)
        loader_img_s = n_img / (time.perf_counter() - t0)
        trainer = None  # the previous run's, freed before the next
        with _FitProbes() as probes, _AugTimer() as timer:
            torch.cuda.synchronize()
            _zero_counts()
            trainer = train(cfg, device="cuda")
            torch.cuda.synchronize()
            counts = _counts()
        launches.append(counts)
        aug_ms = timer.ms()
        run = f"{way}_run{i}"
        checks[f"{run}_stem_every_step"] = all(
            counts[f"stem_{k}"] == n_steps for k in STEM_REPLACES)
        checks[f"{run}_suppress_per_val_batch"] = \
            counts["greedy_suppress"] == 4
        checks[f"{run}_augmented_every_step"] = (
            len(aug_ms["jitter"]) == (n_steps if extra else 0)
            and len(aug_ms["warp"]) == (n_steps if "device_geom" in extra
                                        else 0))
        checks[f"{run}_finite"] = all(
            np.isfinite([r["train_loss"], r["val_loss"]]).all()
            for r in trainer.history)
        fit_img_s = [r["images_per_sec"] for r in trainer.history]
        ways[way].append({
            "run": i,
            "loader_alone_img_per_s": loader_img_s,
            "fit_img_per_s": fit_img_s,
            "fit_img_per_s_mean": float(np.mean(fit_img_s)),
            "blocked_share": [e["blocked_share"] for e in probes.epochs],
            # CUDA events around the warp and the jitter inside each step:
            # the device's time between them, the host's enqueue gaps
            # included (the profile phase has the kernels' own time);
            # each epoch's first step also waits on its first batch
            "device_augment_ms_per_step": {
                k: float(np.median([x for j, x in enumerate(v)
                                    if j % steps_per_epoch])) if v else 0.0
                for k, v in aug_ms.items()},
            "epochs": probes.epochs, "launches": counts,
            "history": trainer.history})
    # each device way's mean img/s over the host way's, in the same half
    # of the order (ABC, then CBA): paired readings, two of each
    paired = {way: [ways[way][h]["fit_img_per_s_mean"]
                    / ways["host"][h]["fit_img_per_s_mean"]
                    for h in range(2)] for way in FIT_WAYS if way != "host"}

    # the checkpoint's blocking ms, off and on: a train step, then the
    # state saved both ways and landed, three times (the first async save
    # allocates its pinned buffers); the last saves restored equal
    batch = put_batch({k: v for k, v in next(iter(loader)).items()
                       if k != "n_valid"}, trainer.device)
    ios = {mode: CheckpointIO(os.path.join(tmp, f"ckpt_{mode}"), is_async)
           for mode, is_async in (("sync", False), ("async", True))}
    saves = {mode: {"blocking_ms": [], "wait_ms": []} for mode in ios}
    for _ in range(3):
        trainer.state, _ = trainer.train_step(trainer.state, batch)
        for mode, io in ios.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            io.save("last", trainer.state)
            t1 = time.perf_counter()
            io.wait()
            saves[mode]["blocking_ms"].append((t1 - t0) * 1e3)
            saves[mode]["wait_ms"].append((time.perf_counter() - t1) * 1e3)
    restored = []
    for mode in ios:
        fresh = Trainer(trainer.cfg, device="cuda", eval_only=True)
        CheckpointIO(os.path.join(tmp, f"ckpt_{mode}")).restore(
            os.path.join(tmp, f"ckpt_{mode}", "last"), fresh.state)
        restored.append(fresh.state)
    a, b = restored
    checks["async_restores_equal_to_sync"] = a.step == b.step and all(
        torch.equal(v, b.model.state_dict()[k])
        for k, v in a.model.state_dict().items()) and all(
        torch.equal(v["momentum_buffer"],
                    b.optimizer.state_dict()["state"][k]["momentum_buffer"])
        for k, v in a.optimizer.state_dict()["state"].items())
    emit({"phase": "fit", "part": "three ways", "order": order,
          "checks": checks, "ways": ways,
          "fit_img_per_s_over_host": paired,
          "checkpoint_blocking_ms": saves,
          "seconds": time.perf_counter() - t_phase, "card": card})
    if not all(checks.values()):
        raise AssertionError(f"the fit phase's three ways failed: "
                             f"{ {k: v for k, v in checks.items() if not v} }")
    return functools.reduce(_add_counts, launches)


# the families profiled on a batch on the card: (config, batch)
PROFILES = (("yolov3_voc", 64), ("yolov4-tiny_voc", 64), ("yolov4_voc", 32),
            ("retinanet_voc", 32))


def profile_phase(fit, dev, card):
    """Phase 17: the step profile (``podtpu_torch.utils.step_profile``) of
    each family's train step on a batch on the card, and of YOLOv3 fed
    from phase 9's files with and without device augmentation. One line
    each with (a) the top kernels, (b) busy / window ms and the idle
    share, (c) the backward by node, (d) the step by part and the forward
    by module; fails where the attribution covers less than 99%."""
    import gc

    from podtpu_torch.config import get_configs
    from podtpu_torch.utils.step_profile import profile_steps

    runs = [(name, b, None) for name, b in PROFILES]
    runs += [("yolov3_voc", None, {}),
             ("yolov3_voc", None, {"device_augment": True})]
    failed = []
    t_phase = time.perf_counter()
    for name, b, files in runs:
        cfg = get_configs(os.path.join(REPO, "configs", f"{name}.yaml"))
        if files is not None:
            cfg.update(train_list=fit["data"]["train_list"],
                       val_list=fit["data"]["val_list"], **files)
        t0 = time.perf_counter()
        out = profile_steps(cfg, dev, batch=b, iters=3, warmup=2,
                            from_files=files is not None)
        out["top_kernels"] = out["top_kernels"][:30]
        emit({"phase": "profile", "config": f"configs/{name}.yaml",
              **out, "seconds": time.perf_counter() - t0, "card": card})
        if out["coverage"] < 0.99:
            failed.append((name, files, out["coverage"]))
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "profile", "runs": len(runs),
          "seconds": time.perf_counter() - t_phase, "card": card})
    if failed:
        raise AssertionError(f"the step profile covers less than 99% of "
                             f"the busy time: {failed}")


OPTION_SERVING = (
    ("merge", {"nms_options": {"merge": True}}),
    ("agnostic", {"nms_options": {"agnostic": True}}),
    ("classes", {"nms_options": {"classes": [0, 14]}}),
    ("multi_label", {"nms_options": {"multi_label": True}}),
    ("tta", {"tta": {"hflip": True, "scales": [0.83, 0.67]}}),
)
# the merged boxes: a float32 [K, K] @ [K, 4] product, summed in another
# order on the card than on the CPU
MERGE_TOL = 1e-3


def options_serving(cfg, flat, dev, images):
    """Phase 18's serving: each option of ``OPTION_SERVING`` at B=8 and 64.
    Returns (record, the launches of one serve call of each)."""
    from podtpu_torch.export.weights import load_flat_weights
    from podtpu_torch.models.factory import build_model
    from podtpu_torch.ops.kernels.nms_kernel import (
        greedy_suppress,
        greedy_suppress_reference,
    )
    from podtpu_torch.ops.nms import _select_candidates
    from podtpu_torch.train.steps import (
        _as_input,
        _decoder_and_nms,
        make_candidates_fn,
        make_serve_fn,
    )

    model = load_flat_weights(build_model(cfg, dev), flat)
    thr = float(cfg["nms_iou_threshold"])
    conf, top_k = float(cfg["conf_threshold"]), int(cfg["top_k_candidates"])
    plain = make_serve_fn(cfg, model)
    record, launches = {}, _counts()
    for k in launches:
        launches[k] = 0
    for name, extra in OPTION_SERVING:
        ocfg = dict(cfg, **extra)
        nopts = ocfg.get("nms_options") or {}
        classes = tuple(nopts["classes"]) if nopts.get("classes") else None
        serve = make_serve_fn(ocfg, model)
        decoder, nms = _decoder_and_nms(ocfg)
        candidates = make_candidates_fn(ocfg, model, decoder)
        for b, x8 in images.items():
            x = _as_input(x8)
            torch.cuda.synchronize()
            _zero_counts()
            dets, valid = serve(x)
            torch.cuda.synchronize()
            launches = _add_counts(launches, _counts())
            calls = _counts()["greedy_suppress"]
            with torch.inference_mode():
                _, cands = candidates(x)
                _, ok, boxes = _select_candidates(
                    cands, conf, top_k, bool(nopts.get("agnostic")), classes)
                boxes = boxes.contiguous()
                keep = greedy_suppress(boxes, ok, thr)
                want = greedy_suppress_reference(boxes, ok, thr)
                got_d, got_v = nms(cands)
                twin_d, twin_v = nms(cands.cpu())
            iters = 10 if b == 8 else 3
            rec = record.setdefault(name, {})[f"B{b}"] = {
                "candidates": list(cands.shape), "valid": int(ok.sum()),
                "kept": int(keep.sum()), "detections": int(valid.sum()),
                "keep_mismatches": int((keep != want).sum()),
                "valid_equal_twin": bool(torch.equal(got_v.cpu(), twin_v)),
                "max_abs_err_twin": float(
                    (got_d.cpu() - twin_d).abs().max()),
                "suppress_launches": calls,
                "finite": bool(torch.isfinite(dets).all()),
                "ms": cuda_ms(lambda: serve(x), iters),
                "plain_ms": cuda_ms(lambda: plain(x), iters),
            }
            rec["ok"] = (rec["keep_mismatches"] == 0 and rec["valid"] > 0
                         and rec["valid_equal_twin"]
                         and rec["max_abs_err_twin"] <= MERGE_TOL
                         and calls == 1 and rec["finite"]
                         and (name != "classes" or bool(
                             torch.isin(dets[valid][:, 5].cpu(),
                                        torch.tensor([0.0, 14.0])).all())))
    del model
    return record, launches


OPTION_TRAINING = (
    ("plain", {}),
    ("adam", {"optimizer": "adam"}),
    ("radam", {"optimizer": "radam"}),
    ("adamw", {"optimizer": "adamw"}),
    ("sgd_flat", {"optimizer_options": {"flat": True}}),
    ("accum_steps_2", {"optimizer_options": {"accum_steps": 2}}),
    ("ema", {"ema": True}),
    ("remat_conv_out", {"remat_policy": "conv_out"}),
    ("remat_no_post_act", {"remat_policy": "no_post_act"}),
    ("remat_backbone", {"remat_backbone": True}),
    ("qat", {"qat": True}),
)


def _option_cfg(cfg, extra):
    out = dict(cfg, **{k: v for k, v in extra.items()
                       if k != "optimizer_options"})
    out["optimizer_options"] = dict(cfg["optimizer_options"],
                                    **extra.get("optimizer_options", {}))
    return out


def _sync_count(fn) -> int:
    """Host synchronisations in ``fn()``, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in seen)


def options_training(cfg, flat, dev, steps=3):
    """Phase 18's training: YOLOv3-416 bf16 at B=64, a few steps of each
    ``OPTION_TRAINING`` entry and of ``skip_nonfinite``. Returns (record,
    launches)."""
    import gc

    from podtpu_torch.train.state import create_train_state, total_notfinite
    from podtpu_torch.train.steps import make_train_step

    b, size = int(cfg["batch_size"]), int(cfg["input_size"])
    r = np.random.default_rng(SEED + 7)
    img = torch.from_numpy(r.random((b, size, size, 3), np.float32)).to(dev)
    annot = torch.from_numpy(synthetic_annotations(cfg, b, SEED)).to(dev)
    batch = {"img": img, "annot": annot}
    record, launches, ref = {}, None, {}

    def stats_of(state):
        return {k: v.clone() for k, v in state.model.state_dict().items()
                if "running" in k}

    for name, extra in OPTION_TRAINING:
        ocfg = _option_cfg(cfg, extra)
        gc.collect()
        torch.cuda.empty_cache()
        state = create_train_state(ocfg, dev, weights=flat)
        step = make_train_step(ocfg)
        first = {}
        apply = state.apply_gradients

        def spy(finite=True, state=state, first=first, apply=apply):
            if "grads" not in first:
                first["grads"] = torch.cat([
                    p.grad.detach().float().reshape(-1)
                    for p in state.params()])
            return apply(finite)

        state.apply_gradients = spy
        shadow0 = ({k: v.double().cpu() for k, v in state.ema.items()}
                   if state.ema is not None else None)
        state, m = step(state, batch)
        torch.cuda.synchronize()
        first["stats"] = stats_of(state)
        rec = record[name] = {"loss": float(m["loss"])}
        if shadow0 is not None:
            o = state.ema_opts
            d = o["decay"] * (1.0 - np.exp(-state.step / o["tau"]))
            sd = state.model.state_dict()
            # |got - want| beyond rtol 1e-5 (tests/test_ema.py's atol 1e-6)
            rec["ema_excess_err"] = max(float(
                ((state.ema[k].double().cpu() - want).abs()
                 - 1e-5 * want.abs()).max())
                for k, e in shadow0.items()
                for want in [e * d + sd[k].double().cpu() * (1.0 - d)])
        state.apply_gradients = apply
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        _zero_counts()
        t0 = time.perf_counter()
        for _ in range(steps):
            state, m = step(state, batch)
        torch.cuda.synchronize()
        rec["ms_per_step"] = (time.perf_counter() - t0) * 1e3 / steps
        counts = _counts()
        launches = counts if launches is None else _add_counts(launches,
                                                               counts)
        rec["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        # what a step adds over the tensors held between steps
        rec["step_peak_gb"] = (torch.cuda.max_memory_allocated() - held) / 1e9
        rec["stem_launches"] = {k: counts[f"stem_{k}"] for k in STEM_REPLACES}
        rec["loss_last"] = float(m["loss"])
        per_step = 0 if name == "qat" else steps
        rec["ok"] = (np.isfinite([rec["loss"], rec["loss_last"]]).all()
                     and all(v == per_step
                             for v in rec["stem_launches"].values())
                     and counts["greedy_suppress"] == 0)
        if name == "plain":
            ref = first
        elif name.startswith("remat"):
            g0, g1 = ref["grads"], first["grads"]
            rec["grad_rel_err"] = float((g1 - g0).norm() / g0.norm())
            rec["running_stats_bit_equal"] = all(
                torch.equal(v, ref["stats"][k])
                for k, v in first["stats"].items())
            rec["ok"] &= (rec["grad_rel_err"] <= 1e-2
                          and rec["running_stats_bit_equal"]
                          and (name == "remat_no_post_act"
                               or rec["step_peak_gb"]
                               < record["plain"]["step_peak_gb"]))
        if name == "accum_steps_2":
            rec["ok"] &= (state.step, state.count) == (1 + steps,
                                                       (1 + steps) // 2)
        if name == "ema":
            rec["ok"] &= rec["ema_excess_err"] <= 1e-6
        if name in ("plain", "sgd_flat"):
            rec["syncs_per_step"] = _sync_count(lambda: step(state, batch))
        del state, step, first
    ref.clear()

    # skip_nonfinite: a NaN pixel, then three bad steps in a row
    ocfg = _option_cfg(cfg, {"optimizer_options": {"skip_nonfinite": 2}})
    gc.collect()
    torch.cuda.empty_cache()
    state = create_train_state(ocfg, dev, weights=flat)
    step = make_train_step(ocfg)
    state, _ = step(state, batch)
    bad = dict(batch, img=img.clone())
    bad["img"][0, 7, 7, 0] = float("nan")
    sd = {k: v.clone() for k, v in state.model.state_dict().items()}
    mom = [t.clone() for s in state.optimizer.state.values()
           for t in s.values() if isinstance(t, torch.Tensor)]
    torch.cuda.synchronize()
    _zero_counts()
    state, m = step(state, bad)
    torch.cuda.synchronize()
    unchanged = (all(torch.equal(v, state.model.state_dict()[k])
                     for k, v in sd.items())
                 and all(torch.equal(a, t) for a, t in zip(mom, [
                     t for s in state.optimizer.state.values()
                     for t in s.values() if isinstance(t, torch.Tensor)])))
    rec = record["skip_nonfinite_2"] = {
        "rejected_loss": float(m["loss"]),
        "state_unchanged_bit_for_bit": unchanged,
        "total_notfinite_after_one": total_notfinite(state),
        "counts_after_one": [state.step, state.count]}
    for _ in range(2):
        state, m = step(state, bad)
    params = torch.cat([p.detach().reshape(-1)
                        for p in state.model.parameters()])
    rec["third_bad_applied"] = bool(torch.isnan(params).any())
    rec["bn_stats_kept_finite"] = all(
        torch.isfinite(v).all() for k, v in state.model.state_dict().items()
        if "running" in k)
    rec["counts_after_three"] = [state.step, state.count,
                                 total_notfinite(state)]
    launches = _add_counts(launches, _counts())
    # the guard's cost: finite steps with and without it
    state = create_train_state(ocfg, dev, weights=flat)
    plain = create_train_state(cfg, dev, weights=flat)
    plain_step = make_train_step(cfg)
    for s, fn in ((state, step), (plain, plain_step)):
        fn(s, batch)
    torch.cuda.synchronize()
    ms = {"guard": [], "plain": []}
    for _ in range(6):
        for key, s, fn in (("guard", state, step),
                           ("plain", plain, plain_step)):
            t0 = time.perf_counter()
            fn(s, batch)
            torch.cuda.synchronize()
            ms[key].append((time.perf_counter() - t0) * 1e3)
    rec["guard_ms_per_step"] = float(np.median(ms["guard"]))
    rec["plain_ms_per_step"] = float(np.median(ms["plain"]))
    rec["guard_syncs_per_step"] = _sync_count(lambda: step(state, batch))
    rec["plain_syncs_per_step"] = _sync_count(
        lambda: plain_step(plain, batch))
    rec["ok"] = (unchanged and rec["total_notfinite_after_one"] == 1
                 and rec["counts_after_one"] == [2, 1]
                 and rec["third_bad_applied"] and rec["bn_stats_kept_finite"]
                 and rec["counts_after_three"] == [4, 2, 3]
                 and rec["guard_syncs_per_step"]
                 == rec["plain_syncs_per_step"] + 1)
    del state, plain, step, plain_step
    return record, launches


def options_fit(fit, dev, tmp):
    """Phase 18's fit: phase 9's run for one epoch with ``ema: true`` and
    ``accum_steps: 2`` through ``train.run.train``, then ``cli.test
    --use-ema`` on its ``best``: the fit's own val numbers."""
    import shutil

    from podtpu_torch.cli import test as test_cli
    from podtpu_torch.train.run import train

    cfg = _option_cfg(fit["cfg"], {"optimizer_options": {"accum_steps": 2}})
    cfg.update(ema=True, epochs=1, save_freq=100,
               save_dir=os.path.join(tmp, "options_runs"))
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    trainer = train(cfg, device="cuda")
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = _counts()
    row = trainer.history[-1]
    best = os.path.join(trainer.run_dir, "checkpoints", "best")
    _zero_counts()
    got = test_cli.main(["--cfg", _write_yaml(cfg, tmp), "--ckpt", best,
                         "--device", "cuda", "--use-ema"])
    torch.cuda.synchronize()
    test_launches = _counts()
    rec = {"seconds": fit_s, "row": row, "test_use_ema": got,
           "steps_counts": [trainer.state.step, trainer.state.count],
           "launches_fit": fit_launches, "launches_test": test_launches}
    rec["ok"] = (abs(got["val_loss"] - row["val_loss"])
                 <= 1e-5 * abs(row["val_loss"])
                 and rec["steps_counts"] == [2, 1]
                 and all(fit_launches[f"stem_{k}"] == 2
                         for k in STEM_REPLACES)
                 and fit_launches["greedy_suppress"] == 2
                 and test_launches["greedy_suppress"] == 2)
    shutil.rmtree(cfg["save_dir"], ignore_errors=True)
    return rec, _add_counts(fit_launches, test_launches)


def _write_yaml(cfg, tmp, name="options.yaml"):
    import yaml

    path = os.path.join(tmp, name)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def options_phase(cfg, flat, dev, card, fit, images, tmp):
    """Phase 18: the serving and train-step options on YOLOv3-416 bf16
    with phase 3's weights. Returns the kernels' launches of the phase."""
    t0 = time.perf_counter()
    serving, serve_launches = options_serving(cfg, flat, dev, images)
    training, train_launches = options_training(cfg, flat, dev)
    fitted, fit_launches = options_fit(fit, dev, tmp)
    launches = _add_counts(_add_counts(serve_launches, train_launches),
                           fit_launches)
    seconds = time.perf_counter() - t0
    emit({"phase": "options", "config": "configs/yolov3_voc.yaml",
          "serving": serving, "training": training, "fit": fitted,
          "launches": launches, "merge_tolerance": MERGE_TOL,
          "seconds": seconds, "card": card})
    failed = [f"serving {n} {b}" for n, v in serving.items()
              for b, r in v.items() if not r["ok"]]
    failed += [f"training {n}" for n, r in training.items() if not r["ok"]]
    failed += ["fit"] if not fitted["ok"] else []
    if failed:
        raise AssertionError(f"the options phase failed its checks: {failed}")
    return launches


# ---- phase 19: backbone pretraining ----------------------------------------

# (px, batch) of the pretraining shapes: pretrain_darknet's default 224 px
# at B=128, and generate_classification's 64 px images at the same batch
PRETRAIN_SHAPES = ((224, 128), (64, 128))


def classifier_steps(name, size, batch, steps, dev, seed):
    """``steps`` pretrain steps (``cli/pretrain_darknet.py::
    make_pretrain_step``, bf16) of a 20-class classifier on a batch on the
    card, after 2 warm-up steps; the kernel counters zeroed just before the
    timed steps and read just after. Returns ms a step (CUDA events),
    img/s, the card's busy ms a step and idle share (a profiled run of as
    many steps after them), the launches, peak GB and the last loss."""
    from podtpu_torch.cli import pretrain_darknet as pd
    from podtpu_torch.train.schedule import cosine_decay_schedule

    torch.manual_seed(seed)
    model = pd.build_classifier(name, 20, torch.bfloat16, dev)
    step = pd.make_pretrain_step(model, pd.make_optimizer(model, 0.1),
                                 cosine_decay_schedule(0.1, 100))
    r = np.random.default_rng(seed)
    imgs = torch.from_numpy(r.random((batch, size, size, 3),
                                     np.float32)).to(dev)
    labels = torch.from_numpy(r.integers(0, 20, batch)).to(dev)
    for i in range(2):
        step(imgs, labels, i)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    _zero_counts()
    start.record()
    for i in range(steps):
        loss, acc = step(imgs, labels, 2 + i)
    end.record()
    end.synchronize()
    launches = _counts()
    ms = start.elapsed_time(end) / steps
    # the card's busy time a step, from a profiler trace of as many steps:
    # what the step's wall time holds beyond it is the card waiting
    it = iter(range(2 + steps, 3 + 2 * steps))
    busy_ms = profiler_ms(lambda: step(imgs, labels, next(it)), steps)
    rec = {"model": name, "size": size, "batch": batch, "steps": steps,
           "ms_per_step": ms, "img_per_s": batch * 1e3 / ms,
           "device_busy_ms_per_step": busy_ms,
           "device_idle_share": max(0.0, 1.0 - busy_ms / ms),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "loss": float(loss), "acc": float(acc), "launches": launches}
    del model, step
    torch.cuda.empty_cache()
    return rec


def pretrain_phase(dev, card, tmp):
    """Phase 19: ``cli.pretrain_darknet`` for 1 epoch at 64 px on a
    generated 20 x 16-image set, Darknet-19 steps at 224 and 64 px (B=128)
    and CSPDarknet53 steps at 224 px (B=32), the stem kernels against
    their plain versions at both sizes, and the written ``.npz`` through
    cfg ``backbone_pretrained`` into configs/yolov3_voc.yaml. Returns the
    launches of the main path and the stem kernels' numbers at both
    sizes."""
    from podtpu_torch.cli import pretrain_darknet as pd
    from podtpu_torch.config import get_configs
    from podtpu_torch.data.synthetic import generate_classification
    from podtpu_torch.export.weights import flat_from_state_dict
    from podtpu_torch.ops.kernels import stem_kernel as sk
    from podtpu_torch.train.state import create_train_state

    t_phase = time.perf_counter()
    data = os.path.join(tmp, "classification")
    generate_classification(data, n_per_class=16, size=64, num_classes=20,
                            seed=SEED)
    out = os.path.join(tmp, "darknet19_pretrained.npz")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    res = pd.pretrain(data, size=64, batch=128, epochs=1, lr=0.1, out=out,
                      model_name="darknet19", device=dev,
                      log=lambda *a: None)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    cli_launches = _counts()
    epoch = res["epochs"][0]
    cli = {"images": 320, "steps": epoch["steps"], "seconds": cli_s,
           "epoch_seconds": epoch["seconds"],
           "ms_per_step_with_loading": epoch["seconds"] * 1e3
           / max(1, epoch["steps"]),
           "img_per_s_with_loading": 128 * epoch["steps"]
           / epoch["seconds"], "loss": epoch["loss"], "acc": epoch["acc"],
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": cli_launches}
    del res
    torch.cuda.empty_cache()

    steps = {f"darknet19_{size}px_B{b}": classifier_steps(
        "darknet19", size, b, 5, dev, SEED + size) for size, b in
        PRETRAIN_SHAPES}
    steps["cspdarknet53_224px_B32"] = classifier_steps(
        "cspdarknet53", 224, 32, 3, dev, SEED + 1)

    # the stem kernels against their plain versions at both sizes: B=8
    # with the planted faults, the train step's B=128 with the timing
    stem = {}
    for size, b in PRETRAIN_SHAPES:
        checks_b8 = stem_dtype_checks(sk, torch.bfloat16, dev, size,
                                      SEED + 30 + size)
        checks, max_err, timing, _ = stem_timing(sk, dev, size,
                                                 SEED + 31 + size, b=b)
        stem[size] = {"batch": b, "checks_B8": checks_b8,
                      f"checks_B{b}": checks, "max_abs_err": max_err,
                      "timing": timing}
        torch.cuda.empty_cache()

    # the .npz into a detector config, bit for bit
    with np.load(out) as npz:
        saved = {k: npz[k] for k in npz.files}
    backbone = {k: v for k, v in saved.items() if "::backbone::" in k}
    cfg3 = get_configs(os.path.join(REPO, "configs", "yolov3_voc.yaml"))
    cfg3["backbone_pretrained"] = out
    state = create_train_state(cfg3, dev)
    loaded = flat_from_state_dict(state.model)
    differing = [k for k, v in backbone.items()
                 if not np.array_equal(loaded[k], v)]
    del state, loaded
    torch.cuda.empty_cache()

    checks = {
        "cli_one_launch_per_step": all(
            cli_launches[f"stem_{k}"] == epoch["steps"] == 2
            for k in STEM_REPLACES),
        "cli_no_suppression": cli_launches["greedy_suppress"] == 0,
        "cli_loss_finite": bool(np.isfinite(epoch["loss"])),
        "darknet19_one_launch_per_step": all(
            r["launches"][f"stem_{k}"] == r["steps"]
            for n, r in steps.items() if n.startswith("darknet19")
            for k in STEM_REPLACES),
        "cspdarknet53_no_stem": not any(
            steps["cspdarknet53_224px_B32"]["launches"].values()),
        "losses_finite": all(np.isfinite(r["loss"]) for r in steps.values()),
        "npz_backbone_tensors": len(backbone) == 90,
        "backbone_bit_for_bit": not differing,
    }
    emit({"phase": "pretrain", "cli": cli, "steps": steps,
          "stem_kernels": {str(k): v for k, v in stem.items()},
          "backbone_pretrained": {"config": "configs/yolov3_voc.yaml",
                                  "tensors": len(backbone),
                                  "differing": differing},
          "checks": checks, "seconds": time.perf_counter() - t_phase,
          "card": card})
    if not all(checks.values()):
        raise AssertionError(f"the pretrain phase failed its checks: "
                             f"{ {k: v for k, v in checks.items() if not v} }")
    launches = cli_launches
    for r in steps.values():
        launches = _add_counts(launches, r["launches"])
    return launches, stem


# ---- phase 20: the export path ----------------------------------------------

ARTIFACT_TOL = 1e-4


def _dets_close(got, want):
    """(ok, stats): valid masks equal; boxes within 1e-4 of their size and
    scores within 1e-4 on the valid rows (float32)."""
    (gd, gv), (wd, wv) = got, want
    same_valid = bool(torch.equal(gv, wv))
    if not same_valid:
        return False, {"valid_equal": False}
    g, w = gd[gv].double(), wd[wv].double()
    box = float(((g[:, :4] - w[:, :4]).abs()
                 / w[:, :4].abs().clamp_min(1.0)).max()) if len(g) else 0.0
    score = float((g[:, 4] - w[:, 4]).abs().max()) if len(g) else 0.0
    cls = bool(torch.equal(g[:, 5], w[:, 5]))
    return (box <= ARTIFACT_TOL and score <= ARTIFACT_TOL and cls), {
        "valid_equal": True, "valid": int(gv.sum()), "box_rel": box,
        "score_abs": score, "classes_equal": cls}


def _dets_match(got, want, tol=ARTIFACT_TOL):
    """(ok, stats): valid masks equal, and each image's valid detections
    paired one to one with the other's (same class, score within ``tol``,
    box within ``tol`` of its size, at least 1 px), so that two
    detections whose scores lie within rounding of each other may come in
    either order: two float32 programs that round apart can swap them.
    A detection left unpaired on either side must score within ``tol`` of
    the image's last kept score: where ``max_detections`` cuts a run of
    scores tied within rounding (many sit within 1e-7 of 1), the two may
    keep different members of it."""
    (gd, gv), (wd, wv) = got, want
    same_valid = bool(torch.equal(gv.cpu(), wv.cpu()))  # score-sorted
    box = score = 0.0
    unmatched = cut_swaps = 0
    for b in range(gd.shape[0]):
        g = gd[b][gv[b]].double().cpu()
        w = wd[b][wv[b]].double().cpu()
        free = torch.ones(len(w), dtype=torch.bool)
        alone = []
        for row in g:
            rel = ((w[:, :4] - row[:4]).abs()
                   / w[:, :4].abs().clamp_min(1.0)).amax(-1)
            ds = (w[:, 4] - row[4]).abs()
            fits = free & (w[:, 5] == row[5]) & (ds <= tol) & (rel <= tol)
            if not fits.any():
                alone.append(float(row[4]))
                continue
            j = int(torch.where(fits, rel, torch.inf).argmin())
            free[j] = False
            box, score = max(box, float(rel[j])), max(score, float(ds[j]))
        alone += w[free, 4].tolist()
        cut = min(g[:, 4].min().item(), w[:, 4].min().item()) if len(g) \
            else 0.0
        at_cut = sum(abs(a - cut) <= tol for a in alone)
        cut_swaps += at_cut
        unmatched += len(alone) - at_cut
    ok = same_valid and unmatched == 0
    return ok, {"valid_equal": same_valid, "valid": int(gv.sum()),
                "unmatched": unmatched, "swapped_at_the_cut": cut_swaps,
                "box_rel": box, "score_abs": score,
                "same_order": bool(torch.equal(gv, wv) and torch.equal(
                    gd, wd))}


def cli_test_batches(cli_test, argv_artifact, argv_ckpt, counted,
                     close=None):
    """``cli.test --artifact`` and ``cli.test --ckpt`` on the same val
    files, each batch they hand the host mAP recorded: ``(got, want,
    per_batch, ok, launches)``. ``ok`` holds the annotations equal, the
    detections within ``close`` (default :func:`_dets_close`), batch for
    batch, and some detection valid, so that agreeing maps of nothing
    fail. ``counted`` wraps the artifact's run and returns its result and
    launch counts."""
    from podtpu_torch.metrics.map import MeanAveragePrecision

    real = MeanAveragePrecision.update_state
    fed = {"artifact": [], "ckpt": []}

    def recording(into):
        def update_state(self, annots, detections, valid):
            into.append(tuple(np.array(a) for a in (annots, detections,
                                                     valid)))
            return real(self, annots, detections, valid)
        return update_state

    try:
        MeanAveragePrecision.update_state = recording(fed["artifact"])
        got, launches = counted(lambda: cli_test.main(argv_artifact))
        MeanAveragePrecision.update_state = recording(fed["ckpt"])
        want = cli_test.main(argv_ckpt)
    finally:
        MeanAveragePrecision.update_state = real
    per_batch = []
    ok = len(fed["artifact"]) == len(fed["ckpt"]) > 0
    for (ga, gd, gv), (wa, wd, wv) in zip(fed["artifact"], fed["ckpt"]):
        same, stats = (close or _dets_close)(
            (torch.from_numpy(gd), torch.from_numpy(gv)),
            (torch.from_numpy(wd), torch.from_numpy(wv)))
        stats["annots_equal"] = bool(np.array_equal(ga, wa))
        per_batch.append(stats)
        ok = ok and same and stats["annots_equal"]
    ok = ok and sum(s.get("valid", 0) for s in per_batch) > 0
    return got, want, per_batch, ok, launches


# the forward file's heads, of their scale: float32 with TF32 off, the BN
# epilogue folded into the filters (4.9e-6 measured on the card)
TFLITE_TOL = 2e-5


def _planted_transposed_filter(path, dev):
    """The forward file with its first non-symmetric 3x3 filter's H and W
    swapped (a layout fault), loaded on ``dev``."""
    from podtpu_torch.export.tflite import TFLiteProgram, read_tflite

    f = read_tflite(path)
    for name, ins, _, _ in f.ops:
        w = f.tensors[ins[1]][3] if name == "CONV_2D" else None
        if w is not None and w.shape[1:3] == (3, 3) and not np.array_equal(
                w, w.transpose(0, 2, 1, 3)):
            n, shape, ttype, _ = f.tensors[ins[1]]
            f.tensors[ins[1]] = (n, shape, ttype, np.ascontiguousarray(
                w.transpose(0, 2, 1, 3)))
            return TFLiteProgram(f, dev)
    raise AssertionError("no 3x3 filter to plant a fault in")


def tflite_checks(cfg, flat, dev, fit, images, tmp):
    """Phase 20's TFLite part: YOLOv3-416 as float32 ``.tflite`` serving
    files at B=1 and B=8 and a forward file, written by
    ``export/tflite.py`` and run by its reader on the card: held to the
    in-process float32 ``make_serve_fn`` (the detections paired as
    :func:`_dets_match`) and the model's raw heads, the
    suppression launched once a call from inside the reader, a planted
    transposed filter failing the heads check, ms a batch against a
    float32 ``.pt2`` and in-process serving; then ``cli.export_model
    --format tflite`` and ``cli.test --artifact`` on phase 9's ``best``
    against ``cli.test --ckpt`` in float32. Returns ``(launches, record,
    checks)``."""
    from podtpu_torch.cli import export_model as cli_export
    from podtpu_torch.cli import test as cli_test
    from podtpu_torch.export import program, tflite
    from podtpu_torch.export.weights import load_flat_weights
    from podtpu_torch.models.factory import build_model
    from podtpu_torch.train.steps import make_serve_fn

    cfg32 = dict(cfg, compute_dtype="float32")
    size = cfg["input_size"]
    m32 = load_flat_weights(build_model(cfg32, dev), flat).eval()
    serve32 = make_serve_fn(cfg32, m32)
    launches, checks, rec = {k: 0 for k in _counts()}, {}, {}
    pt2 = os.path.join(tmp, "yolov3_serving_f32_dyn.pt2")
    t0 = time.perf_counter()
    program.export_serving(m32, cfg32, (None, size, size, 3), pt2)
    rec["pt2_f32_export_s"] = time.perf_counter() - t0
    pt2_fn = program.load_exported(pt2)
    for b in (1, 8):
        x = images[8][:b].float() / 255.0
        path = os.path.join(tmp, f"yolov3_serving_B{b}.tflite")
        t0 = time.perf_counter()
        tflite.export_tflite(m32, cfg32, (b, size, size, 3), path,
                             with_postprocess=True)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        prog = tflite.load_tflite(path, dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        want = serve32(x)
        torch.cuda.synchronize()
        _zero_counts()
        got = prog(x)
        torch.cuda.synchronize()
        one = _counts()
        again = prog(x)
        torch.cuda.synchronize()
        two = _counts()
        launches = _add_counts(launches, two)
        close, stats = _dets_match(got, want)
        on_card = all(t.device.type == "cuda" for t in got + again)
        r = {"export_s": export_s, "MB": os.path.getsize(path) / 2**20,
             "load_s": load_s, "vs_in_process": stats,
             "launches_one_call": one, "launches_two_calls": two,
             "repeat_equal": bool(torch.equal(got[0], again[0])
                                  and torch.equal(got[1], again[1])),
             "outputs_on_card": on_card,
             "ops": tflite.inspect_tflite(path)["ops"]}
        r["ms_reader"] = cuda_ms(lambda: prog(x), 10)
        r["ms_pt2_f32"] = cuda_ms(lambda: pt2_fn(x), 10)
        r["ms_in_process_f32"] = cuda_ms(lambda: serve32(x), 10)
        r["device_busy_ms_reader"] = profiler_ms(lambda: prog(x), 5)
        checks[f"tflite_B{b}"] = (
            close and on_card and r["repeat_equal"]
            and one["greedy_suppress"] == 1
            and two["greedy_suppress"] == 2
            and not any(v for k, v in two.items() if k.startswith("stem")))
        rec[f"B{b}"] = r
        del prog
    # the forward file against the model's raw heads; a planted
    # transposed filter must fail the same check
    x1 = images[8][:1].float() / 255.0
    fwd = os.path.join(tmp, "yolov3_forward_B1.tflite")
    t0 = time.perf_counter()
    tflite.export_tflite(m32, cfg32, (1, size, size, 3), fwd)
    fwd_s = time.perf_counter() - t0
    with torch.inference_mode():
        heads = [h.float() for h in m32(x1)]
    got = tflite.load_tflite(fwd, dev)(x1)
    errs = [rel_err(g, w) for g, w in zip(got, heads)]
    bad = _planted_transposed_filter(fwd, dev)(x1)
    planted = [rel_err(g, w) for g, w in zip(bad, heads)]
    rec["forward"] = {"export_s": fwd_s, "MB": os.path.getsize(fwd) / 2**20,
                      "heads_rel_err": errs, "planted_rel_err": planted,
                      "out_specs": [f"{tuple(g.shape)}" for g in got]}
    checks["tflite_forward_heads"] = (
        len(got) == len(heads) == 3 and max(errs) <= TFLITE_TOL
        and all(g.shape == w.shape for g, w in zip(got, heads)))
    checks["tflite_planted_filter_fails"] = max(planted) > TFLITE_TOL
    del got, bad
    for f in (fwd, pt2, os.path.join(tmp, "yolov3_serving_B1.tflite")):
        os.remove(f)
    # cli.export_model --format tflite, cli.test --artifact against --ckpt
    fit_cfg = dict(fit["cfg"], compute_dtype="float32", batch_size=8)
    yaml_path = _write_yaml(fit_cfg, tmp, "export_fit_f32.yaml")
    art = os.path.join(tmp, "best_serving_B8.tflite")
    cli_export.main(["--cfg", yaml_path, "--ckpt", fit["best"], "--format",
                     "tflite", "--with-postprocess", "--batch", "8",
                     "--out", art, "--device", dev.type])

    def counted(run):
        torch.cuda.synchronize()
        _zero_counts()
        out = run()
        torch.cuda.synchronize()
        return out, _counts()

    got, want, per_batch, same, test_launches = cli_test_batches(
        cli_test, ["--cfg", yaml_path, "--artifact", art, "--device",
                   dev.type],
        ["--cfg", yaml_path, "--ckpt", fit["best"], "--device", dev.type],
        counted, close=_dets_match)
    launches = _add_counts(launches, test_launches)
    rec["cli_test"] = {"artifact_val_mAP": got["val_mAP"],
                       "ckpt_val_mAP": want["val_mAP"],
                       "per_batch": per_batch,
                       "launches_test_artifact": test_launches}
    # float32 through two programs: a score 1e-6 apart may reorder two
    # detections of the precision-recall sweep (the batches are held above)
    checks["tflite_cli_test_mAP"] = \
        abs(got["val_mAP"] - want["val_mAP"]) <= 1e-4
    checks["tflite_cli_test_batches"] = same
    checks["tflite_cli_test_launches"] = \
        test_launches["greedy_suppress"] == len(per_batch)
    del m32, serve32, pt2_fn
    torch.cuda.empty_cache()
    return launches, rec, checks


# the int8 and dynamic files' heads against the float file's, of each
# head's scale: tests/test_torch_tflite_quant.py::QUANT_SHARE, the bound
# the CPU tests pin (measured there 0.044 / 0.047)
TFLITE_QUANT_SHARE = 0.1
# the layers after which no convolution comes: the heads
_HEAD_READERS = {"RESHAPE", "TRANSPOSE", "STRIDED_SLICE"}


def _head_tensors(f) -> list[int]:
    """The float file's head convolutions' outputs: each read only by the
    decode (reshapes and slices), never by an activation or a layer."""
    readers = {}
    for name, ins, _, _ in f.ops:
        for t in ins:
            readers.setdefault(t, set()).add(name)
    return [outs[0] for name, _, outs, _ in f.ops if name == "CONV_2D"
            and readers.get(outs[0], set()) <= _HEAD_READERS]


def _quant_run(prog, x, names):
    """``prog(x)`` with every int8 tensor it makes (on the host) and the
    tensors named ``names`` (float: dequantized if int8)."""
    f = prog.file
    codes, heads = {}, {}

    def observe(t, v):
        if v.dtype == torch.int8:
            codes[t] = v.cpu()
        if f.tensors[t][0] in names:
            if v.dtype == torch.int8:
                s, zp, _ = f.quant[t]
                v = (v.double() - float(zp[0])) * float(s[0])
            heads[f.tensors[t][0]] = v.double().cpu()
    out = prog.run([x], observe)
    return out, codes, heads


def tflite_quant_checks(cfg, dev, fit, tmp, float_rec):
    """Phase 20's quantized TFLite part: YOLOv3-416 from phase 9's
    ``best`` (float32) as int8 (calibrated on 4 val batches) and dynamic
    range serving files at B=1 and B=8, written by
    ``export/tflite_quant.py`` and run by the reader on the card against
    the reader on the CPU on the same file (int8: every int8 code equal,
    the detections paired as :func:`_dets_match`; dynamic: the heads
    within :data:`TFLITE_QUANT_SHARE` of their scale, since its float
    stem rounds apart on the two devices and moves the next layer's
    per-image quantization), one suppression launch a reader call, the
    heads against the float file of the same trace, MB, export s and ms
    a batch of the three readers; then ``cli.export_model --quantize int8`` and ``cli.test
    --artifact`` on the int8 file, one launch a batch, its val mAP beside
    the float file's. Every file reads a fifth val batch. Returns
    ``(launches, record, checks)``."""
    from podtpu_torch.cli import eval_trainer
    from podtpu_torch.cli import export_model as cli_export
    from podtpu_torch.cli import test as cli_test
    from podtpu_torch.export import tflite

    fit_cfg = dict(fit["cfg"], compute_dtype="float32", batch_size=8)
    yaml_path = _write_yaml(fit_cfg, tmp, "export_quant_f32.yaml")
    model = eval_trainer(fit_cfg, fit["best"], dev).state.model.eval()
    size = cfg["input_size"]
    launches, checks, rec = {k: 0 for k in _counts()}, {}, {}
    for b in (1, 8):
        shape = (b, size, size, 3)
        # four val batches calibrate, a fifth is read
        rep = cli_export._calibration_batches(fit_cfg, shape, 5)
        if len(rep) != 5:
            raise AssertionError(f"{len(rep)} val batches of {b}, not 5")
        rep, x = rep[:4], torch.from_numpy(rep[4]).to(dev)
        t0 = time.perf_counter()
        lowered = tflite.lower_model(model, fit_cfg, shape, True)
        lower_s = time.perf_counter() - t0
        ffile = os.path.join(tmp, f"best_serving_float_B{b}.tflite")
        tflite.write_tflite(lowered, ffile)
        fprog = tflite.load_tflite(ffile, dev)
        heads = [fprog.file.tensors[t][0] for t in _head_tensors(
            fprog.file)]
        _, _, fheads = _quant_run(fprog, x, set(heads))
        r = {"calibration_batches": len(rep), "lower_s": lower_s,
             "float_MB": os.path.getsize(ffile) / 2**20, "heads": heads}
        progs = {"float": fprog}
        for mode in ("int8", "dynamic"):
            path = os.path.join(tmp, f"yolov3_serving_{mode}_B{b}.tflite")
            t0 = time.perf_counter()
            tflite.write_tflite(lowered, path, mode, rep, dev)
            m = {"write_s": time.perf_counter() - t0,
                 "MB": os.path.getsize(path) / 2**20,
                 "ops": tflite.inspect_tflite(path)["ops"]}
            prog = progs[mode] = tflite.load_tflite(path, dev)
            torch.cuda.synchronize()
            _zero_counts()
            got, codes, qheads = _quant_run(prog, x, set(heads))
            torch.cuda.synchronize()
            one = _counts()
            launches = _add_counts(launches, one)
            m["launches_one_call"] = one
            m["heads_share_vs_float"] = [
                float((qheads[n] - fheads[n]).abs().max()
                      / fheads[n].abs().max()) for n in heads]
            checks[f"tflite_{mode}_B{b}_heads_vs_float"] = (
                len(heads) == 3 and len(qheads) == 3
                and max(m["heads_share_vs_float"]) <= TFLITE_QUANT_SHARE)
            checks[f"tflite_{mode}_B{b}_one_launch"] = (
                one["greedy_suppress"] == 1 and not any(
                    v for k, v in one.items() if k.startswith("stem")))
            on_card = all(t.device.type == "cuda" for t in got)
            if b == 1:  # the reader on the CPU, on the same file
                cpu = tflite.load_tflite(path, "cpu")
                cgot, ccodes, cheads = _quant_run(cpu, x.cpu(), set(heads))
                same_codes = codes.keys() == ccodes.keys() and all(
                    torch.equal(codes[t], ccodes[t]) for t in codes)
                close, stats = _dets_match(tuple(t.cpu() for t in got),
                                           cgot)
                share = max(float((qheads[n] - cheads[n]).abs().max()
                                  / cheads[n].abs().max()) for n in heads)
                m["card_vs_cpu"] = {"int8_tensors": len(codes),
                                    "codes_equal": same_codes,
                                    "heads_share": share, "dets": stats}
                checks[f"tflite_{mode}_card_vs_cpu"] = on_card and (
                    same_codes and len(codes) > 0 and close
                    if mode == "int8" else share <= TFLITE_QUANT_SHARE)
                del cpu
            r[mode] = m
        for mode in ("float", "int8", "dynamic"):
            r.setdefault(mode, {})["ms_reader"] = cuda_ms(
                lambda: progs[mode](x), 10)
        checks[f"tflite_int8_B{b}_size"] = r["int8"]["MB"] < 0.5 * r[
            "float_MB"]
        rec[f"B{b}"] = r
        del progs, fprog, prog, lowered
    # cli.export_model --quantize int8, then cli.test --artifact on it
    art = os.path.join(tmp, "best_serving_int8_B8.tflite")
    t0 = time.perf_counter()
    cli_export.main(["--cfg", yaml_path, "--ckpt", fit["best"], "--format",
                     "tflite", "--with-postprocess", "--batch", "8",
                     "--quantize", "int8", "--calib-batches", "4", "--out",
                     art, "--device", dev.type])
    export_s = time.perf_counter() - t0
    with open(fit_cfg["val_list"]) as f:
        n_val = len(f.read().split())
    torch.cuda.synchronize()
    _zero_counts()
    got = cli_test.main(["--cfg", yaml_path, "--artifact", art, "--device",
                         dev.type])
    torch.cuda.synchronize()
    test_launches = _counts()
    launches = _add_counts(launches, test_launches)
    rec["cli_test"] = {
        "export_s": export_s, "MB": os.path.getsize(art) / 2**20,
        "int8_val_mAP": got["val_mAP"],
        "float_val_mAP": float_rec["cli_test"]["artifact_val_mAP"],
        "batches": -(-n_val // 8), "launches_test_artifact": test_launches}
    checks["tflite_int8_cli_test_launches"] = \
        test_launches["greedy_suppress"] == -(-n_val // 8)
    checks["tflite_int8_cli_test_mAP_finite"] = \
        0.0 <= got["val_mAP"] <= 1.0
    for f in os.listdir(tmp):
        if f.endswith(".tflite"):
            os.remove(os.path.join(tmp, f))
    del model
    torch.cuda.empty_cache()
    return launches, rec, checks


def export_phase(cfg, flat, dev, card, fit, images, tmp):
    """Phase 20: the export path on YOLOv3-416 with phase 3's weights:
    serving artifacts at B=8 and with a symbolic batch against the
    in-process ``make_serve_fn`` (the suppression launched once a call
    from inside the loaded program), artifact against in-process ms, the
    NPU checks, BN folding, int8 PTQ (every block's int32 accumulator on
    the card against the plain float64 version, int8 against bf16 forward
    ms, the score drift) and ``cli.test --artifact`` against ``--ckpt`` on
    phase 9's files. Returns the launches of the main path."""
    from podtpu_torch.cli import export_model as cli_export
    from podtpu_torch.cli import test as cli_test
    from podtpu_torch.data.dataset import build_datasets
    from podtpu_torch.data.loader import Loader
    from podtpu_torch.export import npu, program, quantize
    from podtpu_torch.export.weights import load_flat_weights
    from podtpu_torch.models.factory import build_model
    from podtpu_torch.models.layers import ConvBnAct
    from podtpu_torch.ops import int8_conv
    from podtpu_torch.train.steps import make_eval_step, make_serve_fn

    t_phase = time.perf_counter()
    model = load_flat_weights(build_model(cfg, dev), flat).eval()
    x8 = images[8].float() / 255.0
    serve = make_serve_fn(cfg, model)
    want8, want3 = serve(x8), serve(x8[:3])
    artifacts, launches, checks = {}, {k: 0 for k in _counts()}, {}
    for tag, shape in (("B8", (8, 416, 416, 3)), ("dyn", (None, 416, 416,
                                                          3))):
        path = os.path.join(tmp, f"yolov3_serving_{tag}.pt2")
        t0 = time.perf_counter()
        program.export_serving(model, cfg, shape, path)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        fn = program.load_exported(path)
        load_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        _zero_counts()
        got = fn(x8)
        torch.cuda.synchronize()
        one = _counts()
        got_again = fn(x8)
        torch.cuda.synchronize()
        two = _counts()
        launches = _add_counts(launches, two)
        ok8, close8 = _dets_close(got, want8)
        rec = {"export_s": export_s, "load_s": load_s,
               "bytes": os.path.getsize(path), "B8": close8,
               "launches_one_call": one, "launches_two_calls": two,
               "repeat_equal": bool(torch.equal(got[0], got_again[0]))}
        ok = (ok8 and one["greedy_suppress"] == 1
              and two["greedy_suppress"] == 2
              and not any(v for k, v in two.items() if k.startswith("stem")))
        if tag == "dyn":
            ok3, rec["B3"] = _dets_close(fn(x8[:3]), want3)
            ok = ok and ok3
        rec["ms_artifact_B8"] = cuda_ms(lambda: fn(x8), 10)
        rec["ms_in_process_B8"] = cuda_ms(lambda: serve(x8), 10)
        # the card's busy ms a call (profiler): the rest of the wall time
        # is the card waiting on the host
        rec["device_busy_ms_artifact_B8"] = profiler_ms(lambda: fn(x8), 10)
        rec["device_busy_ms_in_process_B8"] = profiler_ms(
            lambda: serve(x8), 10)
        rec["info"] = {k: v for k, v in program.inspect_exported(
            path).items() if k != "ops"}
        checks[f"artifact_{tag}"] = ok
        artifacts[tag] = rec
    ops = program.inspect_exported(os.path.join(
        tmp, "yolov3_serving_B8.pt2"))["ops"]

    # the NPU checks: a forward artifact passes, the serving one fails
    fwd = program.export_program(model, (1, 416, 416, 3),
                                 os.path.join(tmp, "yolov3_forward.pt2"))
    report = npu.validate_for_npu(fwd)
    try:
        npu.validate_for_npu(os.path.join(tmp, "yolov3_serving_B8.pt2"))
        serving_unsupported = None
    except npu.NPUValidationError as e:
        serving_unsupported = e.unsupported
    ann = npu.annotate_for_npu(fwd)
    checks["npu_forward_passes"] = report["ok"]
    checks["npu_serving_fails"] = bool(
        serving_unsupported
        and "podtpu_torch.greedy_suppress" in serving_unsupported)

    # BN folding, float32 (TF32 off since phase 5)
    cfg32 = dict(cfg, compute_dtype="float32")
    m32 = load_flat_weights(build_model(cfg32, dev), flat).eval()
    folded = build_model(cfg32, dev).eval()
    folded.load_state_dict(npu.fold_batchnorm(m32.state_dict()))
    with torch.inference_mode():
        fold_rel = max(rel_err(a, b) for a, b in zip(folded(x8[:2]),
                                                     m32(x8[:2])))
    checks["fold_batchnorm"] = fold_rel <= 1e-5
    del m32, folded
    torch.cuda.empty_cache()

    # int8: calibrate on 4 val batches of phase 9's files
    fit_cfg = dict(fit["cfg"])
    _, val_ds = build_datasets(fit_cfg)
    calib = []
    for batch in Loader(val_ds, batch_size=8, shuffle=False,
                        max_annots=fit_cfg["max_annots"], workers=4):
        calib.append(batch["img"].astype(np.float32) / 255.0)
        if len(calib) == 4:
            break
    t0 = time.perf_counter()
    qvars = quantize.build_quant_variables(model, quantize.calibrate(
        model, calib))
    calib_s = time.perf_counter() - t0
    n_blocks = sum(isinstance(m, ConvBnAct) for m in model.modules())
    # every block's accumulator in the quantized eval step (B=1), recorded
    # where the block calls the int8 convolution, against the plain
    # float64 version on the same int8 operands on the host
    seen = []
    real = int8_conv.int8_conv2d

    def record(x, w, stride=1, padding=0):
        acc = real(x, w, stride, padding)
        seen.append((x, w, stride, padding, acc))
        return acc

    batch1 = {"img": images[8][:1],
              "annot": -torch.ones((1, cfg["max_annots"], 5), device=dev)}
    step = make_eval_step(cfg, extra_variables=qvars)
    state = types.SimpleNamespace(model=model)
    int8_conv.int8_conv2d = record
    try:
        _zero_counts()
        step(state, batch1)
        torch.cuda.synchronize()
        step_launches = _counts()
    finally:
        int8_conv.int8_conv2d = real
    launches = _add_counts(launches, step_launches)
    t0 = time.perf_counter()
    acc_mismatch = {}
    for i, (x, w, s_, p_, acc) in enumerate(seen):
        ref = int8_conv.int8_conv2d_reference(x.cpu(), w.cpu(), s_, p_)
        n_bad = int((acc.cpu() != ref).sum())
        if n_bad or acc.dtype != torch.int32:
            acc_mismatch[i] = n_bad
    exact_s = time.perf_counter() - t0
    checks["int8_blocks"] = len(seen) == len(qvars["quant"]) == n_blocks
    checks["int8_accumulators_exact"] = not acc_mismatch
    checks["int8_step_one_suppression"] = \
        step_launches["greedy_suppress"] == 1
    q_dev = {p: {k: v.to(dev) for k, v in q.items()}
             for p, q in qvars["quant"].items()}
    with torch.inference_mode():
        bf16_ms = cuda_ms(lambda: model(x8), 10)
        float_heads = [h.clone() for h in model(x8)]
        float_dets = serve(x8)
        with quantize.quant_scope(model, q_dev):
            int8_ms = cuda_ms(lambda: model(x8), 10)
            int8_heads = model(x8)
            int8_dets = serve(x8)
    drift = []
    for b in range(8):
        fs = float_dets[0][b][float_dets[1][b]][:, 4].sort(
            descending=True).values
        qs = int8_dets[0][b][int8_dets[1][b]][:, 4].sort(
            descending=True).values
        n = min(len(fs), len(qs))
        drift.append(float((fs[:n] - qs[:n]).abs().mean()) if n else 0.0)
    int8 = {"blocks": len(qvars["quant"]), "calibration_s": calib_s,
            "calibration_batches": 4,
            "accumulators_checked": len(seen),
            "accumulator_mismatches": acc_mismatch,
            "exactness_check_s": exact_s,
            "forward_ms_B8": {"int8": int8_ms, "bf16": bf16_ms},
            "heads_rel_err_vs_bf16": [rel_err(a, b) for a, b in
                                      zip(int8_heads, float_heads)],
            "score_drift_mean_abs_per_image": drift,
            "valid_float_vs_int8": [int(float_dets[1].sum()),
                                    int(int8_dets[1].sum())],
            "launches_eval_step": step_launches}

    # cli.test --artifact against --ckpt on phase 9's files
    yaml_path = _write_yaml(fit_cfg, tmp, "export_fit.yaml")
    art = cli_export.main(["--cfg", yaml_path, "--ckpt", fit["best"],
                           "--with-postprocess", "--batch", "dyn", "--out",
                           os.path.join(tmp, "best_serving.pt2"),
                           "--device", dev.type])
    def counted(run):
        torch.cuda.synchronize()
        _zero_counts()
        out = run()
        torch.cuda.synchronize()
        return out, _counts()

    got, want, per_batch, same_batches, test_launches = cli_test_batches(
        cli_test, ["--cfg", yaml_path, "--artifact", art],
        ["--cfg", yaml_path, "--ckpt", fit["best"], "--device", dev.type],
        counted)
    launches = _add_counts(launches, test_launches)
    scored = {"artifact_val_mAP": got["val_mAP"],
              "ckpt_val_mAP": want["val_mAP"], "per_batch": per_batch,
              "launches_test_artifact": test_launches}
    checks["cli_test_artifact_mAP"] = \
        abs(got["val_mAP"] - want["val_mAP"]) <= 1e-6
    checks["cli_test_artifact_batches"] = same_batches
    checks["cli_test_artifact_launches"] = \
        test_launches["greedy_suppress"] == 2
    # the TFLite files, written by hand and run by the port's reader
    t_tflite = time.perf_counter()
    tflite_launches, tflite_rec, tflite_ok = tflite_checks(
        cfg, flat, dev, fit, images, tmp)
    tflite_rec["seconds"] = time.perf_counter() - t_tflite
    launches = _add_counts(launches, tflite_launches)
    checks.update(tflite_ok)
    # the quantized TFLite files, and TFLite's integer arithmetic
    t_quant = time.perf_counter()
    quant_launches, quant_rec, quant_ok = tflite_quant_checks(
        cfg, dev, fit, tmp, tflite_rec)
    quant_rec["seconds"] = time.perf_counter() - t_quant
    launches = _add_counts(launches, quant_launches)
    checks.update(quant_ok)
    emit({"phase": "export", "config": "configs/yolov3_voc.yaml",
          "artifacts": artifacts, "serving_ops": ops,
          "tflite": tflite_rec, "launches_tflite": tflite_launches,
          "tflite_quant": quant_rec,
          "launches_tflite_quant": quant_launches,
          "npu": {"forward_ok": report["ok"],
                  "forward_distinct_ops": len(report["ops"]),
                  "serving_unsupported": serving_unsupported,
                  "forward_layers": ann["num_layers"]},
          "fold_batchnorm_rel_err_f32": fold_rel, "int8": int8,
          "cli_test": scored, "tolerance": {
              "artifact": "valid masks and classes equal, boxes within "
                          "1e-4 of their size (at least 1 px), scores "
                          "within 1e-4",
              "fold_batchnorm": "heads within 1e-5 of their max, float32",
              "int8": "every int32 accumulator equal to the float64 "
                      "plain version's",
              "cli_test": "artifact val_mAP within 1e-6 of --ckpt's; "
                          "each batch's detections fed to the host mAP as "
                          "the artifact check above, some valid",
              "tflite": "float32 files against float32 in-process "
                        "serving: valid masks equal, each image's valid "
                        "detections paired one to one (class equal, box "
                        "within 1e-4 of its size, score within 1e-4), an "
                        "unpaired one only within 1e-4 of the last kept "
                        "score; the forward "
                        "file's heads within 2e-5 of their max (TF32 off), "
                        "which a transposed 3x3 filter must exceed; "
                        "cli.test batches as above, val_mAP within 1e-4, "
                        "in float32",
              "tflite_quant": "int8 file, card against CPU reader: every "
                              "int8 code equal, detections paired as the "
                              "float32 files; dynamic file, card against "
                              "CPU: heads within 0.1 of their scale; "
                              "int8 and dynamic heads within 0.1 of the "
                              "float file's scale (the CPU tests' bound); "
                              "int8 file under half the float file"},
          "checks": checks, "launches": launches,
          "seconds": time.perf_counter() - t_phase, "card": card})
    if not all(checks.values()):
        raise AssertionError(f"the export phase failed its checks: "
                             f"{ {k: v for k, v in checks.items() if not v} }")
    del model, serve
    torch.cuda.empty_cache()
    artifacts["tflite"] = tflite_rec
    artifacts["launches_tflite"] = tflite_launches
    artifacts["tflite_quant"] = quant_rec
    artifacts["launches_tflite_quant"] = quant_launches
    return launches, artifacts


# ---- phase 21: data parallelism, FSDP and the multi-process run -------------

PARALLEL_B = 16  # the two-rank steps' global batch: 8 a rank
PARALLEL_TIMEOUT_S = 300


def parallel_cfg(dtype: str) -> dict:
    """``configs/yolov3_voc.yaml`` as shipped (416 px, full width and depth)
    in ``dtype`` at a constant lr (its ``yolo_lr`` burn-in gives step 0 an
    lr of 0, which would update nothing)."""
    from podtpu_torch.config import get_configs

    cfg = get_configs(os.path.join(REPO, "configs", "yolov3_voc.yaml"))
    return dict(cfg, compute_dtype=dtype, scheduler=None)


def parallel_batch(cfg, b: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"img": rng.integers(0, 256, (b, 416, 416, 3), dtype=np.uint8),
            "annot": synthetic_annotations(cfg, b, seed)}


def _flat_digest(flat: dict) -> str:
    import hashlib

    h = hashlib.sha256()
    for k in sorted(flat):
        h.update(k.encode())
        h.update(np.ascontiguousarray(flat[k]).tobytes())
    return h.hexdigest()


def parallel_step(cfg, flat, host: dict, dev, fsdp: bool = False) -> dict:
    """One train step from ``flat`` on this rank's rows of ``host`` (all of
    it without a group): the loss, the updated flat weights, the stem's
    launches."""
    from podtpu_torch.export.weights import flat_from_state_dict
    from podtpu_torch.parallel import mesh
    from podtpu_torch.train.state import create_train_state
    from podtpu_torch.train.steps import make_train_step

    state = create_train_state(
        cfg, dev, weights=flat,
        fsdp_mesh=mesh.make_mesh("cuda") if fsdp else None)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in mesh.shard_batch(host).items()}
    _zero_counts()
    state, m = make_train_step(cfg)(state, batch)
    torch.cuda.synchronize()
    out = {"loss": float(m["loss"]), "launches": _counts(),
           "flat": flat_from_state_dict(state.model),
           "sharded_leaves": mesh.sharded_leaves(state.model)}
    del state
    torch.cuda.empty_cache()
    return out


def _update_check(got: dict, want: dict, before: dict, rel: float,
                  cos: float) -> dict:
    """The update ``got - before`` against ``want - before``: its distance
    over the norm (<= ``rel``), the cosine (>= ``cos``), and as a reading
    the elements outside rtol 2e-4 / atol 1e-6 (podtpu's DP check)."""
    keys = sorted(k for k in want if k.startswith("params"))
    ug = np.concatenate([(got[k] - before[k]).ravel() for k in keys])
    uw = np.concatenate([(want[k] - before[k]).ravel() for k in keys])
    nw = float(np.linalg.norm(uw))
    rec = {"update_rel_dist": float(np.linalg.norm(ug - uw)) / nw,
           "update_cosine": float(ug @ uw) / (float(np.linalg.norm(ug)) * nw),
           "update_norm_ratio": float(np.linalg.norm(ug)) / nw,
           "params_outside_rtol2e-4_atol1e-6": int(sum(
               (~np.isclose(got[k], want[k], rtol=2e-4, atol=1e-6)).sum()
               for k in keys)),
           "params": int(sum(want[k].size for k in keys))}
    stats = [k for k in want if k.startswith("batch_stats")]
    rec["stats_max_err_of_scale"] = max(
        float(np.abs(got[k] - want[k]).max()
              / max(1.0, float(np.abs(want[k]).max()))) for k in stats)
    rec["ok"] = (rec["update_rel_dist"] <= rel
                 and rec["update_cosine"] >= cos)
    return rec


def parallel_stem_inputs(b: int, size: int, seed: int) -> dict:
    """The fused stem op's inputs for its check under data parallelism:
    OIHW He-normal weights, a BN affine, images whose brightness rises
    from 0.1 to 1 over the global batch and a cotangent whose mean runs
    from -1 to 1, so that each rank's half has sums far from the global
    batch's (a rank that used its own in place of the all-reduced ones
    would be off by a large part of the result)."""
    r = np.random.default_rng(seed)
    gain = np.linspace(0.1, 1.0, b, dtype=np.float32)[:, None, None, None]
    shift = np.linspace(-1.0, 1.0, b, dtype=np.float32)[:, None, None, None]
    return {
        "w": r.normal(0.0, np.sqrt(2 / 27), (32, 3, 3, 3)).astype(np.float32),
        "scale": r.uniform(0.5, 1.5, 32).astype(np.float32),
        "bias": r.normal(0.0, 0.1, 32).astype(np.float32),
        "rows": {"x": r.random((b, size, size, 3), dtype=np.float32) * gain,
                 "cot": r.normal(0.0, 1.0, (b, 32, size // 2, size // 2))
                 .astype(np.float32) + shift}}


def parallel_stem_run(inp: dict, dtype, dev) -> dict:
    """``models/stem.py::fused_stem_pool`` forward and backward on this
    rank's rows of ``inp`` (all of them without a group): the output, this
    rank's gradients (the train step's reduction adds them up) and the BN
    running statistics, as float32 arrays."""
    from podtpu_torch.models.layers import ConvBnAct
    from podtpu_torch.models.stem import fused_stem_pool
    from podtpu_torch.parallel import mesh

    rows = mesh.shard_batch(inp["rows"])
    block = ConvBnAct(3, 32, dtype=dtype).to(dev)
    with torch.no_grad():
        block.conv.weight.copy_(torch.from_numpy(inp["w"]))
        block.bn.weight.copy_(torch.from_numpy(inp["scale"]))
        block.bn.bias.copy_(torch.from_numpy(inp["bias"]))
    x = torch.from_numpy(rows["x"]).to(dev).permute(0, 3, 1, 2)
    out = fused_stem_pool(block, x)
    (out.float() * torch.from_numpy(rows["cot"]).to(dev)).sum().backward()
    got = {"out": out, "gw": block.conv.weight.grad,
           "gscale": block.bn.weight.grad, "gbias": block.bn.bias.grad,
           "mean": block.bn.running_mean, "var": block.bn.running_var}
    return {k: v.detach().float().cpu().numpy() for k, v in got.items()}


# the stem op under two ranks against one process, each as a share of the
# one process's largest magnitude: the rows' outputs, the gradients added
# over the ranks, each rank's running statistics. The passes see the same
# pixels either way; the sums differ in order alone, which moves float32
# by ~1e-7 and can flip a bf16 rounding of ``mul`` / ``add``, of an output
# or of a ``d_pre`` (one bf16 ulp is 3.9e-3 of the value): bf16 is given
# a few ulps. A rank that took its own sums, or returned the all-reduced
# ones as its gradients (counted twice), is off by a large part of the
# result.
STEM_DP_TOL = {"float32": {"out": 1e-5, "grads": 1e-4, "stats": 1e-4},
               "bfloat16": {"out": 1e-2, "grads": 1e-2, "stats": 1e-4}}


def _stem_dp_check(ranks: list[dict], one: dict, tol: dict) -> dict:
    def err(a, b):
        return float(np.abs(a - b).max()
                     / max(float(np.abs(b).max()), 1e-30))

    rec = {"out": err(np.concatenate([r["out"] for r in ranks]), one["out"])}
    for k in ("gw", "gscale", "gbias"):
        rec[k] = err(sum(r[k] for r in ranks), one[k])
    for k in ("mean", "var"):
        rec[k] = max(err(r[k], one[k]) for r in ranks)
    rec["ok"] = (rec["out"] <= tol["out"]
                 and max(rec[k] for k in ("gw", "gscale", "gbias"))
                 <= tol["grads"]
                 and max(rec["mean"], rec["var"]) <= tol["stats"])
    return rec


def _summed_gradients(params, *_model_axis):
    """A planted fault for the bf16 step's check: the ranks' gradients
    summed, not averaged (in place of ``average_gradients``)."""
    from podtpu_torch.parallel import mesh

    for g in mesh.gradients_of(params):
        torch.distributed.all_reduce(g)


def parallel_rank_main(argv) -> int:
    """``chip_smoke.py --parallel-rank R W STORE OUT``: one of two ranks
    sharing the card over gloo (CUDA tensors): the float32 and bf16 DP
    steps, the bf16 step again with its gradients summed over the ranks (a
    planted fault its check must reject) and the float32 FSDP step on its
    8 rows of the 16 images; the fused stem op alone on its rows in both
    dtypes; rank 0 then times the stem kernels at its B=8 while rank 1
    waits. Writes its record to ``OUT.json``, its stem op's results to
    ``OUT.stem.npz`` (and rank 0 its weights to ``OUT.npz``)."""
    from podtpu_torch.models.factory import build_model
    from podtpu_torch.ops.kernels import stem_kernel as sk
    from podtpu_torch.parallel import mesh
    from podtpu_torch.train import steps

    rank, world, store, out = int(argv[0]), int(argv[1]), argv[2], argv[3]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh.join("gloo", torch.device("cuda", 0), rank, world,
                    f"file://{store}", timeout_s=PARALLEL_TIMEOUT_S)
    rec, weights, stem = {"rank": rank, "device": str(dev)}, {}, {}
    average = steps.average_gradients
    try:
        for name, dtype, fsdp in (("f32", "float32", False),
                                  ("bf16", "bfloat16", False),
                                  ("bf16_summed", "bfloat16", False),
                                  ("fsdp_f32", "float32", True)):
            cfg = parallel_cfg(dtype)
            flat = random_weights(build_model(cfg, "cpu"), SEED)
            print(f"rank {rank}: {name} step", flush=True)
            if name == "bf16_summed":
                steps.average_gradients = _summed_gradients
            try:
                r = parallel_step(cfg, flat, parallel_batch(
                    cfg, PARALLEL_B, SEED + 7), dev, fsdp)
            finally:
                steps.average_gradients = average
            weights[name] = r.pop("flat")
            r["digest"] = _flat_digest(weights[name])
            rec[name] = r
        inp = parallel_stem_inputs(PARALLEL_B, 416, SEED + 11)
        for dtype in STEM_DP_TOL:
            stem.update({f"{dtype}/{k}": v for k, v in parallel_stem_run(
                inp, getattr(torch, dtype), dev).items()})
        if rank == 0:
            _, max_err, timing, _ = stem_timing(sk, dev, 416, SEED + 3,
                                                b=PARALLEL_B // world)
            rec["stem_B8"] = {"timing": timing, "max_abs_err": max_err}
        mesh.barrier()
    finally:
        mesh.shutdown()
    with open(out + ".json", "w") as f:
        json.dump(rec, f)
    np.savez(out + ".stem.npz", **stem)
    if rank == 0:
        np.savez(out + ".npz", **{f"{n}/{k}": v for n, w in weights.items()
                                  for k, v in w.items()})
    return 0


def parallel_fit_rank_main(argv) -> int:
    """``chip_smoke.py --parallel-fit-rank CFG OUT`` under torchrun: the
    user's entry point, ``podtpu_torch.train.run`` with ``--distributed
    --backend gloo``; records the rows every ``validate`` hands the mAP
    (every rank's, gathered) and the kernels' launches."""
    from podtpu_torch.metrics.map import MeanAveragePrecision
    from podtpu_torch.train import run

    cfg_path, out = argv
    rows = []
    update = MeanAveragePrecision.update_state

    def recording(self, annot, dets, valid):
        rows.append((np.asarray(annot), np.asarray(dets), np.asarray(valid)))
        return update(self, annot, dets, valid)

    MeanAveragePrecision.update_state = recording
    _zero_counts()
    trainer = run.main(["--cfg", cfg_path, "--distributed", "--backend",
                        "gloo"])
    rank = int(os.environ["RANK"])
    with open(f"{out}.rank{rank}.json", "w") as f:
        json.dump({"launches": _counts(), "step": trainer.state.step,
                   "history": trainer.history}, f)
    if rank == 0:
        np.savez(f"{out}.rows.npz", **{
            f"{i}/{k}": v for i, row in enumerate(rows)
            for k, v in zip(("annot", "dets", "valid"), row)})
    return 0


def parallel_nccl_main(argv) -> int:
    """``chip_smoke.py --parallel-nccl STORE OUT``: YOLOv3-416 bf16 B=64 as
    shipped (constant lr): the plain step with no group, then one rank
    under nccl: the DP step and the FSDP step; each from the same weights,
    one step compared, then timed (host clock over 5 steps ending in a
    synchronize) with its peak memory."""
    from podtpu_torch.models.factory import build_model
    from podtpu_torch.parallel import mesh
    from podtpu_torch.train.state import create_train_state
    from podtpu_torch.train.steps import make_train_step

    store, out = argv
    dev = torch.device("cuda", 0)
    cfg = parallel_cfg("bfloat16")
    flat = random_weights(build_model(cfg, "cpu"), SEED)
    host = parallel_batch(cfg, 64, SEED + 9)
    rec, weights = {}, {}
    for name in ("plain", "dp", "fsdp"):
        if name == "dp":
            mesh.join("nccl", dev, 0, 1, f"file://{store}",
                      timeout_s=PARALLEL_TIMEOUT_S)
        r = parallel_step(cfg, flat, host, dev, fsdp=name == "fsdp")
        weights[name] = r.pop("flat")
        r["digest"] = _flat_digest(weights[name])
        state = create_train_state(
            cfg, dev, weights=flat,
            fsdp_mesh=mesh.make_mesh("cuda") if name == "fsdp" else None)
        step = make_train_step(cfg)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        for _ in range(2):
            state, _m = step(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(5):
            state, _m = step(state, batch)
        torch.cuda.synchronize()
        r["ms_per_step"] = (time.perf_counter() - t0) * 1e3 / 5
        r["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        rec[name] = r
        del state, step, batch
        torch.cuda.empty_cache()
    mesh.shutdown()
    rec["dp_bit_equal_plain"] = rec["dp"]["digest"] == rec["plain"]["digest"]
    rec["fsdp_vs_plain"] = _update_check(weights["fsdp"], weights["plain"],
                                         flat, 0.05, 0.999)
    rec["fsdp_loss_rel_err"] = abs(rec["fsdp"]["loss"] - rec["plain"][
        "loss"]) / abs(rec["plain"]["loss"])
    with open(out, "w") as f:
        json.dump(rec, f)
    return 0


def _start_procs(cmds, tmp, name, env=None):
    """Start ``cmds`` side by side, each in its own process group, with its
    output in ``tmp/<name><i>.log``."""
    procs = []
    env = dict(env or os.environ, PYTHONUNBUFFERED="1")
    for i, cmd in enumerate(cmds):
        log = open(os.path.join(tmp, f"{name}{i}.log"), "w")
        procs.append((subprocess.Popen(cmd, cwd=REPO, stdout=log, env=env,
                                       stderr=subprocess.STDOUT,
                                       start_new_session=True), log))
    return procs


def _finish_procs(procs, name) -> list[str]:
    """Wait for ``procs`` with a hard timeout, kill every one left on a
    failure or a timeout, and raise unless all exited 0; returns their
    output."""
    import signal

    try:
        for p, _ in procs:
            p.wait(timeout=PARALLEL_TIMEOUT_S)
    finally:
        for p, log in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
            log.close()
    outs = [open(log.name).read() for _, log in procs]
    codes = [p.returncode for p, _ in procs]
    if any(codes):
        raise AssertionError(f"phase parallel: {name} failed {codes}:\n"
                             + "\n".join(o[-3000:] for o in outs))
    return outs


def parallel_phase(dev, card, fit, tmp) -> dict:
    """Phase 21. (a) Two ranks sharing the card over gloo: YOLOv3-416 at
    full width and depth, 16 images, 8 a rank, one float32 and one bf16 DP
    step against one process's step on the 16, each rank launching each
    stem kernel once a step, a bf16 step with its gradients summed over the
    ranks that the bf16 check must reject, and the fused stem op alone (its
    output, gradients and statistics) in both dtypes; (c) the float32 FSDP
    step of the same two
    ranks against their DP step; then a two-rank ``train.run
    --distributed`` of one epoch from phase 9's files (B=16), whose
    ``validate`` (every rank's rows gathered) must give every image the
    detections and the val mAP that one process's ``validate`` of the same
    weights gives. (b) One rank under nccl: the B=64 DP and FSDP steps
    beside the plain step, ms a step and peak GB. Two ranks on one card
    check correctness; they are no scaling number. Returns the kernels'
    launches and the stem's device ms at 8 a rank."""
    from podtpu_torch.models.factory import build_model
    from podtpu_torch.train.run import make_loaders
    from podtpu_torch.train.trainer import Trainer, restore_weights

    t_phase = time.perf_counter()
    me = os.path.abspath(__file__)
    py = sys.executable
    checks, rec = {}, {"card": card}
    # (a) + (c): the ranks, and meanwhile one process's steps on the 16
    store = os.path.join(tmp, "parallel_store")
    out = [os.path.join(tmp, f"parallel_rank{r}") for r in range(2)]
    procs = _start_procs([[py, me, "--parallel-rank", str(r), "2", store,
                           out[r]] for r in range(2)], tmp, "parallel_rank")
    try:
        # one process on the 16 images, and a witness of how far rounding
        # alone moves its update (a reading): float32 the two halves of
        # the batch swapped (the same sums in another order), bf16 every
        # other pixel nudged by one bf16 ulp
        one, witness, flats = {}, {}, {}
        for name, dtype in (("f32", "float32"), ("bf16", "bfloat16")):
            cfg = parallel_cfg(dtype)
            flats[name] = random_weights(build_model(cfg, "cpu"), SEED)
            host = parallel_batch(cfg, PARALLEL_B, SEED + 7)
            one[name] = parallel_step(cfg, flats[name], host, dev)
            if name == "f32":
                half = PARALLEL_B // 2
                moved = {k: np.concatenate([v[half:], v[:half]])
                         for k, v in host.items()}
            else:
                img = host["img"].astype(np.float32) / np.float32(255.0)
                nudge = np.random.default_rng(SEED).random(img.shape) < 0.5
                moved = {"img": np.where(nudge, img * np.float32(1 + 2.0 ** -8),
                                         img), "annot": host["annot"]}
            witness[name] = parallel_step(cfg, flats[name], moved, dev)["flat"]
        # the stem op alone on the 16 images
        inp = parallel_stem_inputs(PARALLEL_B, 416, SEED + 11)
        stem_one = {dtype: parallel_stem_run(inp, getattr(torch, dtype), dev)
                    for dtype in STEM_DP_TOL}
    finally:
        _finish_procs(procs, "the two-rank steps")
    ranks = [json.load(open(o + ".json")) for o in out]
    with np.load(out[0] + ".npz") as f:
        got = {n: {k[len(n) + 1:]: f[k] for k in f.files
                   if k.startswith(n + "/")}
               for n in ("f32", "bf16", "bf16_summed", "fsdp_f32")}
    stem_ranks = []
    for o in out:
        with np.load(o + ".stem.npz") as f:
            stem_ranks.append({k: f[k] for k in f.files})
    # float32: the update within 5% of one process's norm and at cosine
    # 0.999 (the CPU tests' bound). bf16: the update's direction is not
    # checked, since one bf16 ulp on the input moves it by about its own
    # norm (the witness); its norm is (a summed gradient doubles it), and
    # the stem op under DP is checked alone below, where the comparison is
    # well conditioned
    tol = {"f32": {"loss": 1e-5, "stats": 1e-4},
           "bf16": {"loss": 1e-2, "stats": 1e-2}}
    norm_ratio = (0.8, 1.25)
    steps = {}
    for name in ("f32", "bf16"):
        loss = float(np.mean([r[name]["loss"] for r in ranks]))
        s = _update_check(got[name], one[name]["flat"], flats[name], 0.05,
                          0.999)
        s.update(loss_two_ranks=loss, loss_one_process=one[name]["loss"],
                 loss_rel_err=abs(loss - one[name]["loss"])
                 / abs(one[name]["loss"]),
                 launches_by_rank=[r[name]["launches"] for r in ranks],
                 launches_one_process=one[name]["launches"])
        ok = s.pop("ok")
        if name == "f32":
            checks["f32_update"] = ok
        checks[f"{name}_update_norm"] = (norm_ratio[0] <= s[
            "update_norm_ratio"] <= norm_ratio[1])
        checks[f"{name}_loss"] = s["loss_rel_err"] <= tol[name]["loss"]
        checks[f"{name}_running_stats"] = (s["stats_max_err_of_scale"]
                                           <= tol[name]["stats"])
        wit = _update_check(witness[name], one[name]["flat"], flats[name],
                            0.05, 0.999)
        s["witness"] = {k: wit[k] for k in (
            "update_rel_dist", "update_cosine", "update_norm_ratio",
            "stats_max_err_of_scale")}
        checks[f"{name}_ranks_equal"] = (ranks[0][name]["digest"]
                                         == ranks[1][name]["digest"])
        checks[f"{name}_stem_once_a_rank"] = all(
            all(v == 1 for k, v in r[name]["launches"].items()
                if k.startswith("stem_")) for r in ranks)
        steps[name] = s
    summed = _update_check(got["bf16_summed"], one["bf16"]["flat"],
                           flats["bf16"], 0.05, 0.999)
    steps["bf16_summed_gradients"] = {k: summed[k] for k in (
        "update_rel_dist", "update_cosine", "update_norm_ratio")}
    checks["bf16_update_norm_rejects_summed_gradients"] = not (
        norm_ratio[0] <= summed["update_norm_ratio"] <= norm_ratio[1])
    stem_dp = {}
    for dtype, t in STEM_DP_TOL.items():
        stem_dp[dtype] = _stem_dp_check(
            [{k[len(dtype) + 1:]: v for k, v in r.items()
              if k.startswith(dtype + "/")} for r in stem_ranks],
            stem_one[dtype], t)
        checks[f"stem_op_dp_{dtype}"] = stem_dp[dtype].pop("ok")
    fsdp = _update_check(got["fsdp_f32"], got["f32"], flats["f32"], 0.05,
                         0.999)
    fsdp.update(loss_rel_err=abs(ranks[0]["fsdp_f32"]["loss"]
                                 - ranks[0]["f32"]["loss"])
                / abs(ranks[0]["f32"]["loss"]),
                sharded_leaves=ranks[0]["fsdp_f32"]["sharded_leaves"],
                launches_by_rank=[r["fsdp_f32"]["launches"] for r in ranks])
    checks["fsdp_update"] = fsdp.pop("ok")
    checks["fsdp_loss"] = fsdp["loss_rel_err"] <= 1e-5
    checks["fsdp_sharded"] = fsdp["sharded_leaves"] >= 10
    checks["fsdp_stem_once_a_rank"] = all(
        all(v == 1 for k, v in r["fsdp_f32"]["launches"].items()
            if k.startswith("stem_")) for r in ranks)
    rec.update(steps=steps, stem_op_dp_B8_a_rank=stem_dp,
               fsdp_two_ranks=fsdp,
               tolerance={"f32": "loss 1e-5 relative; the update within 5% "
                                 "of one process's norm, cosine >= 0.999 "
                                 "(the CPU tests' bound: at random weights "
                                 "a step's update is ill-conditioned, and "
                                 "podtpu's own 2- and 1-device CPU steps "
                                 "differ by 3.5% of its norm), its norm "
                                 f"ratio in {list(norm_ratio)}; BN running "
                                 "statistics 1e-4 of their scale",
                          "bf16": "loss 1e-2 relative (bf16's unit "
                                  "roundoff 3.9e-3); the update's norm "
                                  f"ratio in {list(norm_ratio)} (the "
                                  "planted summed-gradient step must fail "
                                  "it); its direction not checked (the "
                                  "one-ulp witness moves it by about its "
                                  "norm); BN running statistics 1e-2 of "
                                  "their scale",
                          "stem_op_dp": {
                              "measure": "max |two ranks - one process| "
                                         "over the one process's max |.|; "
                                         "gradients added over the ranks",
                              **STEM_DP_TOL},
                          "fsdp": "loss 1e-5, the update within 5% and "
                                  "cosine 0.999, against the two ranks' DP "
                                  "step"})
    stem_b8 = ranks[0]["stem_B8"]

    # the two-rank run through the user's entry point, from phase 9's files
    cfg = dict(fit["cfg"], save_dir=os.path.join(tmp, "runs_parallel"),
               epochs=1, batch_size=PARALLEL_B, workers=4, save_freq=100)
    cfg_path = _write_yaml(cfg, tmp, "parallel.yaml")
    fit_out = os.path.join(tmp, "parallel_fit")
    t0 = time.perf_counter()
    _finish_procs(_start_procs([[
        py, "-m", "torch.distributed.run", "--standalone",
        "--nproc_per_node", "2", me, "--parallel-fit-rank", cfg_path,
        fit_out]], tmp, "parallel_fit"), "the two-rank run")
    fit_s = time.perf_counter() - t0
    fit_ranks = [json.load(open(f"{fit_out}.rank{r}.json")) for r in range(2)]
    with np.load(f"{fit_out}.rows.npz") as f:
        n_rows = len({k.split("/")[0] for k in f.files})
        rows = [tuple(f[f"{i}/{k}"] for k in ("annot", "dets", "valid"))
                for i in range(n_rows)]
    runs_dir = os.path.join(cfg["save_dir"], "yolov3_voc")
    checks["fit_one_run_dir"] = os.listdir(runs_dir) == ["version_0"]
    last = os.path.join(runs_dir, "version_0", "checkpoints", "last")
    # one process's validate of the weights the run ended with (its last
    # validate ran on them), the same rows recorded
    trainer = Trainer(dict(cfg, batch_size=PARALLEL_B // 2), device=dev,
                      eval_only=True, log=lambda _m: None)
    restore_weights(last, trainer.state)
    one_rows = []
    update = trainer.map_metric.update_state

    def recording(annot, dets, valid):
        one_rows.append((np.asarray(annot), np.asarray(dets),
                         np.asarray(valid)))
        return update(annot, dets, valid)

    trainer.map_metric.update_state = recording
    val_one = trainer.validate(make_loaders(trainer.cfg)[1])
    # the run's rows in its order (per batch, rank 0's then rank 1's) are
    # images 0, 2, 4, ... and 1, 3, 5, ...: put them in image order
    n_val = sum(len(r[0]) for r in one_rows)
    per_rank = n_val // 2
    order = []
    for b in range(-(-per_rank // (PARALLEL_B // 2))):
        for r in range(2):
            shard = np.arange(n_val)[r::2]
            order.extend(shard[b * 8:(b + 1) * 8].tolist())
    dp = [np.concatenate([row[i] for row in rows]) for i in range(3)]
    one_cat = [np.concatenate([row[i] for row in one_rows]) for i in range(3)]
    inv = np.argsort(np.asarray(order))
    dp = [a[inv] for a in dp]
    history = fit_ranks[0]["history"][-1]
    fit_rec = {
        "seconds": fit_s, "steps": fit_ranks[0]["step"],
        "launches_by_rank": [r["launches"] for r in fit_ranks],
        "val_mAP_two_ranks": history["val_mAP"],
        "val_mAP_one_process": val_one["val_mAP"],
        "val_loss_two_ranks": history["val_loss"],
        "val_loss_one_process": val_one["val_loss"],
        "images": n_val,
        "valid_equal": bool(np.array_equal(dp[2], one_cat[2])),
        "annot_equal": bool(np.array_equal(dp[0], one_cat[0])),
        "det_max_abs_err": float(np.abs(
            np.where(one_cat[2][..., None], dp[1] - one_cat[1], 0)).max()),
        "detections": int(one_cat[2].sum())}
    checks["fit_annot_order"] = fit_rec["annot_equal"]
    checks["fit_valid_equal"] = fit_rec["valid_equal"]
    checks["fit_dets"] = fit_rec["det_max_abs_err"] <= 1e-2
    checks["fit_val_mAP"] = abs(fit_rec["val_mAP_two_ranks"]
                                - fit_rec["val_mAP_one_process"]) <= 1e-6
    # the val losses differ by their padding: each rank fills its last
    # batch (4 of 36 images) with repeats of its last image, which the
    # loss counts, as podtpu's hosts do; one process at B=8 pads nothing
    fit_rec["val_loss_note"] = "the ranks' last batches are padded"
    n_steps = len(make_loaders(cfg, 0, 2)[0])
    checks["fit_stem_every_step"] = all(
        all(v == n_steps for k, v in r["launches"].items()
            if k.startswith("stem_")) for r in fit_ranks)
    rec["fit"] = fit_rec
    del trainer

    # (b) one rank under nccl
    nccl_out = os.path.join(tmp, "parallel_nccl.json")
    _finish_procs(_start_procs([[
        py, me, "--parallel-nccl", os.path.join(tmp, "parallel_nccl_store"),
        nccl_out]], tmp, "parallel_nccl"), "the nccl rank")
    nccl = json.load(open(nccl_out))
    checks["nccl_dp_bit_equal_plain"] = nccl["dp_bit_equal_plain"]
    checks["nccl_fsdp_update"] = nccl["fsdp_vs_plain"]["ok"]
    checks["nccl_fsdp_loss"] = nccl["fsdp_loss_rel_err"] <= 1e-5
    rec["nccl_B64_bf16"] = {k: {m: v[m] for m in ("loss", "ms_per_step",
                                                  "peak_gb", "launches",
                                                  "sharded_leaves")}
                            for k, v in nccl.items()
                            if k in ("plain", "dp", "fsdp")}
    rec["nccl_B64_bf16"]["fsdp_vs_plain"] = nccl["fsdp_vs_plain"]
    emit({"phase": "parallel", "config": "configs/yolov3_voc.yaml",
          "two_ranks_share_one_card": "a correctness run, not a scaling "
                                      "number",
          **rec, "stem_B8_per_rank": stem_b8["timing"], "checks": checks,
          "seconds": time.perf_counter() - t_phase})
    if not all(checks.values()):
        raise AssertionError(f"the parallel phase failed its checks: "
                             f"{ {k: v for k, v in checks.items() if not v} }")
    launches = {f"rank{r}": {k: sum(ranks[r][n]["launches"][k]
                                    for n in ("f32", "bf16", "fsdp_f32"))
                             + fit_ranks[r]["launches"][k]
                             for k in ranks[r]["f32"]["launches"]}
                for r in range(2)}
    return launches, stem_b8

# ---- phase 22: the tensor and spatial layouts ------------------------------

LAYOUTS_B = 8  # the layouts' global batch: every rank holds all 8 images
# the layouts' checks against one process, as a share of the one
# process's largest magnitude. float32 with TF32 off: the loss to 1e-5
# (its sums reassociated by the channel gathers and the row blocks); the
# update within 5% of its norm at cosine 0.999 (the CPU tests' bound: at
# random weights a step's update is ill-conditioned); BN running
# statistics to 1e-4; the eval heads to 1e-4 (cuDNN picks other
# algorithms for a channel slice or a row block, which sum a conv's
# products in another order; the CPU tests hold 1e-5), equal valid masks
# and detections to rtol 1e-4 / atol 1e-4 (podtpu's
# test_spatial_eval_matches_single_device: an absolute 1e-2 px fails on
# random-weight boxes thousands of px wide by their float32 rounding,
# 0.023 px). bf16 as phase 21 holds it:
# the loss and statistics to 1e-2, the update's norm ratio in [0.8, 1.25]
# (its direction moves by about its norm under a one-ulp nudge).
LAYOUTS_TOL = {"float32": {"loss": 1e-5, "stats": 1e-4, "heads": 1e-4,
                           "dets_rtol": 1e-4, "update_rel": 0.05,
                           "update_cos": 0.999},
               "bfloat16": {"loss": 1e-2, "stats": 1e-2,
                            "norm_ratio": (0.8, 1.25)}}
LAYOUTS_AXES = {"tensor": "model", "spatial": "space"}


def layouts_step(cfg, flat, host, dev, timed=True) -> dict:
    """One train step from ``flat`` on every row of ``host`` in the
    process's layout (no group: the plain step): the loss, the whole
    updated flat weights and the kernels' launches; with ``timed`` a
    second step's ms (host clock ending in a synchronize) and the peak
    GB allocated over it."""
    from podtpu_torch.export.weights import flat_from_state_dict
    from podtpu_torch.train.state import create_train_state
    from podtpu_torch.train.steps import make_train_step

    state = create_train_state(cfg, dev, weights=flat)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    step = make_train_step(cfg)
    _zero_counts()
    state, m = step(state, batch)
    torch.cuda.synchronize()
    out = {"loss": float(m["loss"]), "launches": _counts(),
           "flat": flat_from_state_dict(state.model),
           "split_kernels": len(getattr(state.model, "tp_keys", ()))}
    if timed:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        out["ms_per_step"] = (time.perf_counter() - t0) * 1e3
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del state, step
    torch.cuda.empty_cache()
    return out


def layouts_eval(cfg, flat, host, dev) -> dict:
    """The eval step (loss, detections) and the eval-mode heads of a state
    holding ``flat``, in the process's layout, as float32 arrays; with
    the suppression's launches."""
    from podtpu_torch.parallel.layouts import layout_scope, space_rows
    from podtpu_torch.train.state import create_train_state
    from podtpu_torch.train.steps import _as_input, make_eval_step

    state = create_train_state(cfg, dev, weights=flat)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    _zero_counts()
    loss, dets, valid = make_eval_step(cfg)(state, batch)
    torch.cuda.synchronize()
    launches = _counts()
    model = state.model.eval()
    with torch.no_grad(), layout_scope(model):
        heads = model(space_rows(_as_input(batch["img"]), model))
    out = {"loss": loss, "dets": dets, "valid": valid,
           **{f"head{i}": h for i, h in enumerate(heads)}}
    out = {k: v.detach().float().cpu().numpy() for k, v in out.items()}
    del state
    torch.cuda.empty_cache()
    return out, launches


def layouts_rank_main(argv) -> int:
    """``chip_smoke.py --layouts-rank R W STORE OUT``: one of two ranks
    sharing the card over gloo (CUDA tensors), as one data row: on a
    ``(model=2)`` mesh, then a ``(space=2)`` mesh, YOLOv3-416 as shipped
    at 8 images (every rank holds all of them): a float32 and a bf16 train
    step, each timed again, and the float32 eval step. Writes its record
    to ``OUT.json`` and (rank 0) its weights and eval arrays to
    ``OUT.npz``."""
    from podtpu_torch.models.factory import build_model
    from podtpu_torch.parallel import mesh

    rank, world, store, out = int(argv[0]), int(argv[1]), argv[2], argv[3]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh.join("gloo", torch.device("cuda", 0), rank, world,
                    f"file://{store}", timeout_s=PARALLEL_TIMEOUT_S)
    rec, arrays = {"rank": rank, "device": str(dev)}, {}
    flat = random_weights(build_model(parallel_cfg("float32"), "cpu"), SEED)
    try:
        for key, axis in LAYOUTS_AXES.items():
            mesh.make_mesh("cuda", **{key: 2})
            for dtype in LAYOUTS_TOL:
                cfg = parallel_cfg(dtype)
                host = parallel_batch(cfg, LAYOUTS_B, SEED + 7)
                print(f"rank {rank}: {axis} {dtype} step", flush=True)
                r = layouts_step(cfg, flat, host, dev)
                weights = r.pop("flat")
                r["digest"] = _flat_digest(weights)
                if dtype == "float32":
                    ev, r["eval_launches"] = layouts_eval(cfg, flat, host,
                                                          dev)
                    arrays.update({f"{axis}_eval/{k}": v
                                   for k, v in ev.items()})
                if rank == 0:
                    arrays.update({f"{axis}_{dtype}/{k}": v
                                   for k, v in weights.items()})
                rec[f"{axis}_{dtype}"] = r
        mesh.barrier()
    finally:
        mesh.shutdown()
    with open(out + ".json", "w") as f:
        json.dump(rec, f)
    if rank == 0:
        np.savez(out + ".npz", **arrays)
    return 0


def halo_blocks(x, n=2, zero_halo=False):
    """The n row blocks of NHWC ``x``, each with one row of the block above
    and one of the block below (zeros at the image's edge, or in place of
    every neighbour row with ``zero_halo``): the halo kernels' input."""
    xp = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 1, 1)).to(x.dtype)
    k = x.shape[1] // n
    out = []
    for i in range(n):
        blk = xp[:, i * k:i * k + k + 2].clone()
        if zero_halo:
            blk[:, 0].zero_()
            blk[:, -1].zero_()
        out.append(blk.contiguous())
    return out


def halo_stem_checks(sk, dtype, dev, b, seed, timed=False):
    """The four stem kernels with ``halo`` on the two row blocks of a
    416 px batch (208 rows each): each against its plain twin with the
    halo on the same block (the per-kernel limits of phase 6), and the
    blocks together against the whole-image kernels: the pooled rows bit
    for bit, the stats, sums and dW added over the blocks to the limits
    of the plain checks. A halo of zeros in place of the neighbour rows
    must change the pooled rows. With ``timed`` each kernel is timed on
    one block beside its plain twin and its bound. Returns (checks,
    max_abs_err per kernel, timing)."""
    t = STEM_TOL[dtype]
    x, w, scale, bias, g = stem_inputs(b, dtype, dev, seed)
    n = x.shape[0] * x.shape[1] * x.shape[2]
    s_whole = sk.stem_stats(x, w)
    mean = s_whole[0] / n
    var = (s_whole[1] / n - mean * mean).clamp_min(0.0)
    rinv = torch.rsqrt(var + 1e-5)
    inv = rinv * scale
    mul, add = inv.to(dtype).float(), (bias - mean * inv).to(dtype).float()
    u_whole = sk.stem_bwd_sums(x, w, mul, add, mean, rinv, g)
    vecs = (mul, add, mean, rinv, inv, u_whole[0] / n, u_whole[1] / n)
    blocks, gs = halo_blocks(x), [c.contiguous() for c in g.chunk(2, dim=1)]
    kern = {"stats": lambda blk, gi: sk.stem_stats(blk, w, halo=True),
            "emit": lambda blk, gi: sk.stem_emit(blk, w, mul, add, halo=True),
            "bwd_sums": lambda blk, gi: sk.stem_bwd_sums(
                blk, w, *vecs[:4], gi, halo=True),
            "bwd_dw": lambda blk, gi: sk.stem_bwd_dw(blk, w, *vecs, gi,
                                                     halo=True)}
    plain = {"stats": lambda blk, gi: sk.stem_stats_reference(
                 blk, w, halo=True),
             "emit": lambda blk, gi: sk.stem_emit_reference(
                 blk, w, mul, add, halo=True),
             "bwd_sums": lambda blk, gi: sk.stem_bwd_sums_reference(
                 blk, w, *vecs[:4], gi, halo=True),
             "bwd_dw": lambda blk, gi: sk.stem_bwd_dw_reference(
                 blk, w, *vecs, gi, halo=True)}
    got = {k: [f(blk, gi) for blk, gi in zip(blocks, gs)]
           for k, f in kern.items()}
    want = {k: [f(blk, gi) for blk, gi in zip(blocks, gs)]
            for k, f in plain.items()}
    c, err, ok = {}, {}, True
    for k in kern:
        r_ = want[k]
        if k == "emit":
            ok_e, c["emit"] = pooled_check(torch.cat(got[k], dim=1),
                                           torch.cat(r_, dim=1), dtype)
            ok &= ok_e
            err[k] = c["emit"]["max_abs"]
            continue
        c[f"{k}_rel"] = max(rel_err(p, q) for p, q in zip(got[k], r_))
        c[f"{k}_cos"] = min(cosine(p, q) for p, q in zip(got[k], r_))
        err[k] = max(float((p - q).abs().max()) for p, q in zip(got[k], r_))
        if k == "stats" or dtype == torch.float32:
            ok &= c[f"{k}_rel"] <= t["stats" if k == "stats" else "bwd"]
        else:
            ok &= (c[f"{k}_rel"] <= t["bwd_rel"]
                   and c[f"{k}_cos"] >= t["bwd_cos"])
    c["deterministic"] = all(torch.equal(kern[k](blocks[0], gs[0]),
                                         got[k][0]) for k in kern)
    whole = {"stats": s_whole, "bwd_sums": u_whole,
             "bwd_dw": sk.stem_bwd_dw(x, w, *vecs, g)}
    c["vs_whole"] = {
        "emit_bit_equal": bool(torch.equal(
            torch.cat(got["emit"], dim=1), sk.stem_emit(x, w, mul, add))),
        **{f"{k}_rel": rel_err(got[k][0] + got[k][1], v)
           for k, v in whole.items()}}
    lim = {"stats": t["stats"],
           "bwd_sums": t.get("bwd", t.get("bwd_rel")),
           "bwd_dw": t.get("bwd", t.get("bwd_rel"))}
    ok &= c["vs_whole"]["emit_bit_equal"] and c["deterministic"]
    ok &= all(c["vs_whole"][f"{k}_rel"] <= lim[k] for k in whole)
    zeroed = torch.cat([sk.stem_emit(blk, w, mul, add, halo=True)
                        for blk in halo_blocks(x, zero_halo=True)], dim=1)
    zero_ok, c["zero_halo_fault"] = pooled_check(
        zeroed, sk.stem_emit(x, w, mul, add), dtype)
    c["zero_halo_fault"]["caught"] = not zero_ok
    ok &= not zero_ok
    torch.cuda.synchronize()
    if not ok:
        raise AssertionError(f"the halo stem kernels fail their checks in "
                             f"{dtype} at B={b}: {c}")
    timing = {}
    if timed:
        size = x.shape[2]
        for k in kern:
            bound_ms, bound_by, terms = stem_bound(
                k, b, size // 2, size, x.element_size(), halo=True)
            timing[k] = {
                "ms": cuda_ms(lambda: kern[k](blocks[0], gs[0]), 20),
                "plain_ms": cuda_ms(lambda: plain[k](blocks[0], gs[0]), 5),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "bound_terms_ms": terms,
                "shape": [b, size // 2 + 2, size, 3]}
    return c, err, timing


def autobatch_run(cfg_path, batches=(32, 64, 128)) -> dict:
    """``cli/autobatch.py``'s measurement of the config as shipped at each
    batch on the card, and its recommendation for the card's memory."""
    from podtpu_torch.cli.autobatch import (
        device_memory_bytes,
        measure_memory,
        recommend,
    )
    from podtpu_torch.config import get_configs

    cfg = get_configs(cfg_path)
    rows = [measure_memory(cfg, b) for b in batches]
    limit = device_memory_bytes()
    return {"rows": rows, "memory_bytes": limit, "frac": 0.9,
            "recommended": recommend(rows, limit, 0.9),
            "peak_grows": all(a["peak"] < b["peak"]
                              for a, b in zip(rows, rows[1:]))}


def layouts_phase(dev, card, tmp) -> dict:
    """Phase 22. (a) Two ranks sharing the card over gloo, one data row:
    YOLOv3-416 as shipped (full width and depth) at 8 images, on a
    ``(model=2)`` mesh then a ``(space=2)`` mesh: float32 (TF32 off) and
    bf16 train steps and the float32 eval step against one process's,
    with their ms and peak GB beside the plain step's (one process runs
    first, the ranks after it). Then (b) the halo stem kernels at two
    blocks of 208 rows against their plain twins and the whole-image
    kernels, float32 and bf16, timed at B=8 and 64 on the idle card, and
    (c) ``cli/autobatch.py`` on YOLOv3-416 at 32, 64 and 128. Two
    ranks on one card check correctness; they are no scaling number.
    Returns the kernels' launches under the layouts and the halo
    kernels' records."""
    from podtpu_torch.models.factory import build_model
    from podtpu_torch.ops.kernels import stem_kernel as sk

    t_phase = time.perf_counter()
    checks = {}
    # one process first, the card to itself (its ms are the plain step's)
    flat = random_weights(build_model(parallel_cfg("float32"), "cpu"), SEED)
    one = {}
    for dtype in LAYOUTS_TOL:
        cfg = parallel_cfg(dtype)
        host = parallel_batch(cfg, LAYOUTS_B, SEED + 7)
        one[dtype] = layouts_step(cfg, flat, host, dev)
        if dtype == "float32":
            one["eval"], one["eval_launches"] = layouts_eval(cfg, flat, host,
                                                             dev)
    me = os.path.abspath(__file__)
    store = os.path.join(tmp, "layouts_store")
    out = [os.path.join(tmp, f"layouts_rank{r}") for r in range(2)]
    _finish_procs(_start_procs([[sys.executable, me, "--layouts-rank", str(r),
                                 "2", store, out[r]] for r in range(2)], tmp,
                               "layouts_rank"), "the layouts' ranks")
    # the halo kernels once the ranks are gone (their ms on an idle card)
    halo = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        halo[name] = {}
        for b in (8, 64):
            c, err, timing = halo_stem_checks(
                sk, dtype, dev, b, SEED + 13,
                timed=dtype == torch.bfloat16 or b == 8)
            halo[name][f"B{b}"] = {"checks": c, "max_abs_err": err,
                                   "timing": timing}
    ranks = [json.load(open(o + ".json")) for o in out]
    with np.load(out[0] + ".npz") as f:
        arrays = {k: f[k] for k in f.files}
    steps = {}
    for key, axis in LAYOUTS_AXES.items():
        for dtype, tol in LAYOUTS_TOL.items():
            tag = f"{axis}_{dtype}"
            got = {k[len(tag) + 1:]: v for k, v in arrays.items()
                   if k.startswith(tag + "/")}
            s = _update_check(got, one[dtype]["flat"], flat,
                              tol.get("update_rel", 1.0),
                              tol.get("update_cos", -1.0))
            ok = s.pop("ok")
            loss = ranks[0][tag]["loss"]
            s.update(loss=loss, loss_one_process=one[dtype]["loss"],
                     loss_rel_err=abs(loss - one[dtype]["loss"])
                     / abs(one[dtype]["loss"]),
                     ms_per_step_by_rank=[r[tag]["ms_per_step"]
                                          for r in ranks],
                     peak_gb_by_rank=[r[tag]["peak_gb"] for r in ranks],
                     ms_per_step_one_process=one[dtype]["ms_per_step"],
                     peak_gb_one_process=one[dtype]["peak_gb"],
                     launches_by_rank=[r[tag]["launches"] for r in ranks],
                     split_kernels=ranks[0][tag]["split_kernels"])
            checks[f"{tag}_loss"] = s["loss_rel_err"] <= tol["loss"]
            checks[f"{tag}_stats"] = s["stats_max_err_of_scale"] <= tol[
                "stats"]
            checks[f"{tag}_ranks_equal"] = (ranks[0][tag]["digest"]
                                            == ranks[1][tag]["digest"])
            checks[f"{tag}_stem_once_a_rank"] = all(
                all(v == 1 for k, v in r[tag]["launches"].items()
                    if k.startswith("stem_")) for r in ranks)
            if dtype == "float32":
                checks[f"{tag}_update"] = ok
                ev = {k[len(axis) + 6:]: v for k, v in arrays.items()
                      if k.startswith(f"{axis}_eval/")}
                s["eval"] = {
                    "loss_rel_err": abs(float(ev["loss"] - one["eval"][
                        "loss"])) / abs(float(one["eval"]["loss"])),
                    "heads_err_of_scale": max(
                        float(np.abs(ev[f"head{i}"] - one["eval"][f"head{i}"])
                              .max() / np.abs(one["eval"][f"head{i}"]).max())
                        for i in range(3)),
                    "valid_equal": bool(np.array_equal(ev["valid"],
                                                       one["eval"]["valid"])),
                    "dets_max_abs_px": float(np.abs(np.where(
                        one["eval"]["valid"][..., None],
                        ev["dets"] - one["eval"]["dets"], 0)).max()),
                    # <= 1 where allclose(rtol=atol=dets_rtol) holds
                    "dets_closeness": float((np.abs(
                        ev["dets"] - one["eval"]["dets"])
                        / (tol["dets_rtol"] * (1.0 + np.abs(
                            one["eval"]["dets"]))))[
                                one["eval"]["valid"].astype(bool)].max()),
                    "dets_largest_px": float(np.abs(one["eval"]["dets"][
                        ..., :4]).max()),
                    "detections": int(one["eval"]["valid"].sum()),
                    "launches_by_rank": [r[tag]["eval_launches"]
                                         for r in ranks]}
                checks[f"{axis}_eval_loss"] = s["eval"]["loss_rel_err"] <= \
                    tol["loss"]
                checks[f"{axis}_eval_heads"] = s["eval"][
                    "heads_err_of_scale"] <= tol["heads"]
                checks[f"{axis}_eval_valid"] = s["eval"]["valid_equal"]
                checks[f"{axis}_eval_dets"] = s["eval"]["dets_closeness"] \
                    <= 1.0
                checks[f"{axis}_eval_suppress_once_a_rank"] = all(
                    r[tag]["eval_launches"]["greedy_suppress"] == 1
                    for r in ranks)
            else:
                lo, hi = tol["norm_ratio"]
                checks[f"{tag}_update_norm"] = lo <= s[
                    "update_norm_ratio"] <= hi
            steps[tag] = s
    checks["tensor_splits_kernels"] = steps["model_float32"][
        "split_kernels"] >= 20
    for name, by_b in halo.items():
        for b, r in by_b.items():
            checks[f"halo_{name}_{b}_zero_fault_caught"] = r["checks"][
                "zero_halo_fault"]["caught"]
    t0 = time.perf_counter()
    auto = autobatch_run(os.path.join(REPO, "configs", "yolov3_voc.yaml"))
    auto["seconds"] = time.perf_counter() - t0
    checks["autobatch_peak_grows"] = auto["peak_grows"]
    print(f"autobatch: recommended per-card batch {auto['recommended']} "
          f"for {auto['memory_bytes'] / 2 ** 30:.1f} GiB on {card}",
          flush=True)
    emit({"phase": "layouts", "config": "configs/yolov3_voc.yaml",
          "two_ranks_share_one_card": "a correctness run, not a scaling "
                                      "number",
          "steps_B8": steps, "halo_stem_kernels": halo,
          "autobatch": auto, "tolerance": {
              "float32": "loss 1e-5 relative; the update within 5% of one "
                         "process's norm at cosine 0.999; BN running "
                         "statistics 1e-4 and eval heads 1e-4 of their "
                         "scale (other cuDNN algorithms for a channel "
                         "slice or a row block); equal valid masks, "
                         "detections rtol 1e-4 / atol 1e-4",
              "bfloat16": "loss and BN statistics 1e-2; the update's norm "
                          "ratio in [0.8, 1.25]",
              "halo_stem_kernels": "each kernel against its plain twin with "
                                   "the halo at phase 6's limits; the two "
                                   "blocks' pooled rows bit for bit the "
                                   "whole image's, their stats, sums and "
                                   "dW added within the same limits of "
                                   "the whole-image kernels; a halo of "
                                   "zeros must fail"},
          "checks": checks, "seconds": time.perf_counter() - t_phase})
    if not all(checks.values()):
        raise AssertionError(f"the layouts phase failed its checks: "
                             f"{ {k: v for k, v in checks.items() if not v} }")
    launches = {f"rank{r}": {k: sum(ranks[r][f"{axis}_{d}"]["launches"][k]
                                    for axis in LAYOUTS_AXES.values()
                                    for d in LAYOUTS_TOL)
                             + sum(ranks[r][f"{axis}_float32"][
                                 "eval_launches"][k]
                                   for axis in LAYOUTS_AXES.values())
                             for k in ranks[r]["model_float32"]["launches"]}
                for r in range(2)}
    launches["spatial_rank0"] = {k: sum(
        ranks[0][f"space_{d}"]["launches"][k] for d in LAYOUTS_TOL)
        for k in ranks[0]["space_float32"]["launches"]}
    return launches, halo


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
            # what a call from inside an exported program pays: the
            # registered operator's dispatch around the same launch
            t["op_ms"] = cuda_ms(
                lambda: torch.ops.podtpu_torch.greedy_suppress(
                    boxes, valid, thr), 200 if b == 8 else 100, warmup=10)
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
        # 15. device augmentation, and configs/yolov4_synth.yaml
        synth_launches = device_aug_phase(dev, card, 64e3 / step_img_s, tmp)
        # 16. phase 9's run three ways: host, device augmentation, warp
        ways_launches = fit_ways_phase(fit, dev, card, tmp)
        # 17. the step profile of each family and of the run from files
        profile_phase(fit, dev, card)
        # 18. the serving and train-step options on YOLOv3-416
        options_launches = options_phase(cfg, flat, dev, card, fit, images,
                                         tmp)
        # 19. backbone pretraining through the fused stem
        pretrain_launches, pretrain_stem = pretrain_phase(dev, card, tmp)
        # 20. the export path: artifacts, NPU checks, int8, cli.test
        export_launches, export_artifacts = export_phase(
            cfg, flat, dev, card, fit, images, tmp)
        # 21. data parallelism, FSDP and the multi-process run
        parallel_launches, stem_dp = parallel_phase(dev, card, fit, tmp)
        # 22. the tensor and spatial layouts, the halo stem kernels and
        # autobatch
        layouts_launches, halo = layouts_phase(dev, card, tmp)
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
        e["launches_yolov4_synth"] = synth_launches[e["name"]]
        e["launches_fit_ways"] = ways_launches[e["name"]]
        e["launches_options"] = options_launches[e["name"]]
        e["launches_pretrain"] = pretrain_launches[e["name"]]
        e["launches_export"] = export_launches[e["name"]]
        for r in ("rank0", "rank1"):
            e[f"launches_parallel_{r}"] = parallel_launches[r][e["name"]]
            e[f"launches_layouts_{r}"] = layouts_launches[r][e["name"]]
        kind = e["name"][len("stem_"):]
        # the halo kernels: launched under the spatial layout (rank 0's
        # float32 and bf16 steps), timed on a block of 208 of 416 rows
        e["launches_spatial_rank0"] = layouts_launches["spatial_rank0"][
            e["name"]]
        for b in ("B8", "B64"):
            t_h = halo["bfloat16"][b]["timing"][kind]
            e.update({f"ms_halo_208_{b}": t_h["ms"],
                      f"plain_ms_halo_208_{b}": t_h["plain_ms"],
                      f"bound_ms_halo_208_{b}": t_h["bound_ms"]})
        e["ms_halo_208_B8_f32"] = halo["float32"]["B8"]["timing"][kind]["ms"]
        e["max_abs_err_halo"] = max(halo[d][b]["max_abs_err"][kind]
                                    for d in halo for b in halo[d])
        t_dp = stem_dp["timing"][e["name"][len("stem_"):]]
        e.update(ms_dp_B8_per_rank=t_dp["ms"],
                 plain_ms_dp_B8_per_rank=t_dp["plain_ms"],
                 bound_ms_dp_B8_per_rank=t_dp["bound_ms"],
                 max_abs_err_dp_B8=stem_dp["max_abs_err"][
                     e["name"][len("stem_"):]])
        for size, rec in pretrain_stem.items():
            t = rec["timing"][e["name"][len("stem_"):]]
            tag = f"{size}px_B{rec['batch']}"
            e.update({f"ms_{tag}": t["ms"], f"plain_ms_{tag}": t["plain_ms"],
                      f"bound_ms_{tag}": t["bound_ms"],
                      f"max_abs_err_{tag}": rec["max_abs_err"][
                          e["name"][len("stem_"):]]})
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
        "op_ms": timing["B8"]["op_ms"],
        "op_ms_B1": suppress_b1["op_ms"],
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
        "launches_yolov4_synth": synth_launches["greedy_suppress"],
        "launches_fit_ways": ways_launches["greedy_suppress"],
        "launches_options": options_launches["greedy_suppress"],
        "launches_pretrain": pretrain_launches["greedy_suppress"],
        "launches_export": export_launches["greedy_suppress"],
        "launches_parallel_rank0": parallel_launches["rank0"][
            "greedy_suppress"],
        "launches_parallel_rank1": parallel_launches["rank1"][
            "greedy_suppress"],
        "launches_layouts_rank0": layouts_launches["rank0"][
            "greedy_suppress"],
        "launches_layouts_rank1": layouts_launches["rank1"][
            "greedy_suppress"],
        "ms_artifact_B8": export_artifacts["B8"]["ms_artifact_B8"],
        "ms_in_process_B8": export_artifacts["B8"]["ms_in_process_B8"],
        "launches_export_tflite": export_artifacts["launches_tflite"][
            "greedy_suppress"],
        **{f"ms_tflite_reader_B{b}": export_artifacts["tflite"][f"B{b}"][
            "ms_reader"] for b in (1, 8)},
        "launches_export_tflite_quant": export_artifacts[
            "launches_tflite_quant"]["greedy_suppress"],
        **{f"ms_tflite_{m}_reader_B{b}": export_artifacts["tflite_quant"][
            f"B{b}"][m]["ms_reader"] for b in (1, 8)
           for m in ("float", "int8", "dynamic")},
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


# the processes phases parallel and layouts start: chip_smoke.py MODE ARGS...
_RANK_MODES = {"--parallel-rank": parallel_rank_main,
               "--parallel-fit-rank": parallel_fit_rank_main,
               "--parallel-nccl": parallel_nccl_main,
               "--layouts-rank": layouts_rank_main}


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] in _RANK_MODES:
        import faulthandler

        faulthandler.enable()
        sys.exit(_RANK_MODES[sys.argv[1]](sys.argv[2:]))
    sys.exit(main())
