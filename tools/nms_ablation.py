#!/usr/bin/env python3
"""Where the suppression kernels' time goes, by ablation, and the kernels
against other revisions of their source, timed in turns on one card (for
machines where ``ncu`` and ``nsys`` cannot run).

    python3 tools/nms_ablation.py                      # on the card; needs nvcc
    python3 tools/nms_ablation.py --baseline other/nms_suppress.cu [--baseline ...]

Builds ``podtpu_torch/csrc/nms_suppress.cu`` as it is (the bitmask kernel
and the one-warp scan, C entry point ``podtpu_nms_suppress`` with eight
arguments) and, with ``--baseline`` (repeatable), other revisions of it
(say the parent commit's, unpacked into a directory that ``.gitignore``
lists): with this entry point, or with the one-block-per-image design's
seven arguments (boxes, valid, keep, b, k, thr, stream), told apart by the
source's signature; and variants of this source that each cut one part
out (a variant's keep masks are wrong on purpose: only its time is read).
One ``nvcc`` each, started together, into
``podtpu_torch/_build/nms_ablation/``. The inputs are ``chip_smoke.py``'s
phase 3: the real YOLOv3-416 candidates of seeded images under seeded
random weights, and seeded random class-offset boxes, at B=8 and B=64,
K=512. For each input the builds are timed in turns (in order, then in
reverse), each through its C entry point on
scratch made once: ``ms`` back to back (the host's enqueue may set the
pace) and ``device_ms`` from a CUDA graph of 100 calls. One JSON line per
input gives the times, the keep masks' agreement with the plain version
and of the baselines with this build, the kept boxes, and this build's
two kernels alone
(``mask_ms``, ``scan_ms``); one line gives ptxas' registers and shared
memory of each build. The last line is ``nvidia-smi``'s name and power
limit.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from podtpu_torch.ops.kernels import build  # noqa: E402
from podtpu_torch.ops.kernels import nms_kernel as nk  # noqa: E402

OUT = os.path.join(build.BUILD_DIR, "nms_ablation")
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the entry point's arguments by their number: this design's (boxes,
# valid, mask scratch, keep, b, k, thr, stream) and the first design's
ARGTYPES = {8: [_P, _P, _P, _P, _I, _I, _F, _P],
            7: [_P, _P, _P, _I, _I, _F, _P]}

# name -> (what it shows, [(old, new), ...]), each old text once in the
# source; a patch that no longer applies raises, so the tool cannot
# silently time the wrong thing
PATCHES = {
    "scan_returns_at_once": ("the scan's launch alone", [(
        "  const int lane = threadIdx.x;\n",
        "  const int lane = threadIdx.x;\n  if (k > 0) return;\n")]),
    "scan_init_only": ("the scan without its walk: launch, removed = "
                       "~valid, keep bytes out", [(
        "  Piece ahead{0, 0};", "  last = -1;\n  Piece ahead{0, 0};")]),
    "scan_no_chain": ("the diagonal chunks resolve nothing: what the "
                      "chains cost", [(
        "      Word left = alive & meet;", "      Word left = 0 & meet;")]),
    "scan_no_propagation": ("the chunks (w, c > w) are staged and waited "
                            "for but not reduced: what the ORs cost", [(
        "    if (mine) {\n", "    if (false) {\n")]),
    "mask_returns_at_once": ("the mask kernel's launch alone", [(
        "  const int tid = threadIdx.x;\n",
        "  const int tid = threadIdx.x;\n  if (k > 0) return;\n")]),
    "mask_computes_nothing": ("the mask kernel's blocks stage their boxes "
                              "and store zero words: launch, loads, "
                              "barrier and stores", [(
        "  unsigned int bits = 0;\n  if (i < k) {",
        "  unsigned int bits = 0;\n  if (i < 0) {")]),
    "mask_divides_every_pair": ("the division for every pair, as if every "
                                "pair intersected", [(
        "const bool every = !(thr >= 0.0f);", "const bool every = true;")]),
}


def variants(text: str) -> dict[str, str]:
    """{name: source} of each patched variant of ``text``."""
    out = {}
    for name, (_, patches) in PATCHES.items():
        v = text
        for old, new in patches:
            if v.count(old) != 1:
                raise RuntimeError(f"{name}: patch does not apply once")
            v = v.replace(old, new)
        out[name] = v
    return out


def build_libs(baselines: list[str]) -> tuple[dict, dict]:
    """({name: entry point}, {name: ptxas report}) of this source
    ("current"), the baselines ("baseline", "baseline2", ...) and the
    variants, built side by side."""
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(build.CSRC_DIR, "nms_suppress.cu")) as f:
        texts = {"current": f.read()}
    for n, path in enumerate(baselines):
        with open(path) as f:
            texts["baseline" + (str(n + 1) if n else "")] = f.read()
    texts.update(variants(texts["current"]))
    procs, arity = {}, {}
    for name, text in texts.items():
        sig = re.search(r"int podtpu_nms_suppress\(([^)]*)\)", text)
        arity[name] = sig.group(1).count(",") + 1
        path = os.path.join(OUT, name + ".cu")
        with open(path, "w") as g:
            g.write(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", path[:-3] + ".so", path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns, ptxas = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        ptxas[name] = cs.ptxas_report(log)
        fn = ctypes.CDLL(os.path.join(OUT, name + ".so")).podtpu_nms_suppress
        fn.restype, fn.argtypes = ctypes.c_int, ARGTYPES[arity[name]]
        fns[name] = fn
    return fns, ptxas


def runner(name, fn, boxes, valid, thr):
    """(call, keep): one launch of build ``name`` on scratch made once."""
    b, k = valid.shape
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    mask = torch.empty((b, k, nk.mask_words(k)), dtype=torch.int64,
                       device=boxes.device)
    scratch = [mask.data_ptr()] if len(fn.argtypes) == 8 else []

    def call():
        err = fn(boxes.data_ptr(), valid.data_ptr(), *scratch, keep.data_ptr(),
                 b, k, thr, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: cudaError {err}")

    return call, keep


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", metavar="SOURCE", action="append",
                    default=[], help="another revision of nms_suppress.cu to "
                    "time in turns with this one (repeatable)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("nms_ablation: no CUDA device", file=sys.stderr)
        return 1
    fns, ptxas = build_libs(args.baseline)

    from podtpu_torch.config import get_configs
    from podtpu_torch.export.weights import load_flat_weights
    from podtpu_torch.models.factory import build_model
    from podtpu_torch.train.steps import _decoder_and_nms

    dev = torch.device("cuda")
    cfg = get_configs(os.path.join(REPO, "configs", "yolov3_voc.yaml"))
    thr, top_k = float(cfg["nms_iou_threshold"]), int(cfg["top_k_candidates"])
    model = build_model(cfg, dev)
    load_flat_weights(model, cs.random_weights(model, cs.SEED))
    # chip_smoke.py's inputs, drawn in its order
    rng = np.random.default_rng(cs.SEED)
    images = {b: torch.from_numpy(rng.integers(
        0, 256, (b, 416, 416, 3), dtype=np.uint8)).to(dev) for b in (8, 64)}
    cases = {f"random_B{b}": cs.offset_boxes(rng, b, top_k, dev)
             for b in (8, 64)}
    real = cs.yolo_candidates(model, _decoder_and_nms(cfg)[0], cfg, images)
    cases.update({f"yolov3_B{b}": real[b] for b in (8, 64)})

    order = list(fns) + list(fns)[::-1]
    with torch.inference_mode():
        for case, (boxes, valid) in cases.items():
            runs = {name: runner(name, fns[name], boxes, valid, thr)
                    for name in fns}
            ms = {f"{n}_ms": [] for n in fns}
            dms = {f"{n}_device_ms": [] for n in fns}
            for name in order:
                call = runs[name][0]
                ms[f"{name}_ms"].append(cs.cuda_ms(call, 200, warmup=10))
                dms[f"{name}_device_ms"].append(cs.device_ms(call)[0])
            want = nk.greedy_suppress_reference(boxes, valid, thr)
            keeps = {n: r[1] for n, r in runs.items()}
            mask_ms, scan_ms, _ = cs.suppress_halves(boxes, valid, thr)
            cs.emit({"case": case, "shape": list(boxes.shape),
                     "valid": int(valid.sum()),
                     "kept": {"total": int(want.sum()),
                              "max_per_image": int(want.sum(1).max())},
                     "chain_steps": cs.chain_steps(boxes, valid, thr),
                     **ms, **dms, "current_mask_ms": mask_ms,
                     "current_scan_ms": scan_ms,
                     "equal_to_plain": {n: bool(torch.equal(k, want))
                                        for n, k in keeps.items()},
                     "baselines_agree": all(
                         torch.equal(k, keeps["current"])
                         for n, k in keeps.items() if n not in PATCHES)})
    cs.emit({"ptxas": ptxas, "order": order,
             "variants": {n: PATCHES[n][0] for n in fns if n in PATCHES}})
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
