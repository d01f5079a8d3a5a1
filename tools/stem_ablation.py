#!/usr/bin/env python3
"""Where the stem's tensor-core kernels spend their time, by ablation (for
machines where ``ncu`` and ``nsys`` cannot run).

    python3 tools/stem_ablation.py            # on the card; needs nvcc
    python3 tools/stem_ablation.py --baseline other/stem_fused.cu

Builds ``podtpu_torch/csrc/stem_fused.cu`` as it is and in variants that
each cut one part out of the bf16 kernels (a variant's results are wrong on
purpose: only its time is read), one ``nvcc`` each, all started together,
into ``podtpu_torch/_build/ablation/``. ``--baseline`` adds a build of
another revision of the source (say, the parent commit's, unpacked with
``git archive``) under the name ``baseline``, to time two revisions in turns
on one card. Then times ``stem_stats``, ``stem_emit``, ``stem_bwd_sums`` and
``stem_bwd_dw`` of every build at the train step's shape (B=64, 416 px,
bf16; ``chip_smoke.py``'s inputs), 20 launches each, in two passes (the
builds in order, then in reverse), and prints one JSON line per build with
ptxas' registers, the times, whether its results equal the unchanged
build's bit for bit, and on how many pool windows its forward and backward
disagree (the windows ``emit`` wrote as positive against those ``bwd_sums``
counts under a cotangent of ones). Before them, one line with what
``cuobjdump -sass`` shows of the unchanged build: the instructions of each
kernel's loop over units (the innermost loop around its ``HMMA``), per unit,
by opcode; and one with the time of each C entry point alone, without its
wrapper's small launches. The last line is ``nvidia-smi``'s name and power
limit.

Each variant is a textual patch of the source; a patch that no longer
applies raises, so the tool cannot silently time the wrong thing.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import os
import re
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from podtpu_torch.ops.kernels import build  # noqa: E402
from podtpu_torch.ops.kernels import stem_kernel as sk  # noqa: E402

OUT = os.path.join(build.BUILD_DIR, "ablation")
KERNELS = ("stats", "emit", "bwd_sums", "bwd_dw")

# the backward's epilogue, from the first use of the accumulators to product 2
EPILOGUE_FROM = "        // pre and y exactly as emit_tc_kernel makes them"
EPILOGUE_TO = "      // product 2: slots 8 nt .. 8 nt + 7 are row ky"
NO_EPILOGUE = '''        float pre[4], y[4];
        if constexpr (kDw) {
          af[m][hf] = pack_bf16x2(acc[m][0][2 * hf] + gv, acc[m][0][2 * hf + 1]);
          af[m][2 + hf] = pack_bf16x2(acc[m][1][2 * hf], acc[m][1][2 * hf + 1]);
        } else {
          sum_d[i] += acc[m][0][2 * hf] + acc[m][1][2 * hf + 1] + gv;
          sum_dx[i] += acc[m][0][2 * hf + 1] + acc[m][1][2 * hf];
        }
        (void)pre; (void)y; (void)inside;
      }

'''
# the forward kernels' epilogues, and what stands in for them
STATS_EPILOGUE = '''          const unsigned int p2 =
              bf162_bits(round_pre(acc[i >> 1][dy], i & 1)) & keep;
          const float lo = __uint_as_float(p2 << 16);
          const float hi = __uint_as_float(p2 & 0xffff0000u);
          sum[i] += lo;
          sq[i] = fmaf(lo, lo, sq[i]);  // f32: pre^2 does not fit bf16
          sum[i] += hi;
          sq[i] = fmaf(hi, hi, sq[i]);
'''
NO_STATS_EPILOGUE = '''          sum[i] += acc[i >> 1][dy][2 * (i & 1)];
          sq[i] += acc[i >> 1][dy][2 * (i & 1) + 1];
          (void)keep;
'''
EMIT_EPILOGUE_FROM = "        __nv_bfloat162 col[2];\n"
EMIT_EPILOGUE_TO = "        os[out_stage_index(p, gid + 16 * m)] = "
NO_EMIT_EPILOGUE = '''        const __nv_bfloat162 top = __floats2bfloat162_rn(
            acc[m][0][0] + acc[m][1][3], acc[m][0][1] + acc[m][1][2]);
        (void)mul2; (void)add2; (void)zero2;
'''
STAGE = "    stage_tile(x, s, tl, raw + stage * kRawBytes, xa, xb);"

# name -> (what it shows, [(old, new, times it must apply), ...]); a
# callable in place of the list cuts a span out
PATCHES = {
    "unchanged": ("the kernels as they are", []),
    "units_unrolled_alike": ("two units of a warp in flight in bwd_dw "
                             "too (as in bwd_sums)", [(
        "#pragma unroll(kDw ? 1 : 2)\n    for (int u = 0; u < 8; ++u)",
        "#pragma unroll 2\n    for (int u = 0; u < 8; ++u)", 1)]),
    "no_epilogue": ("the accumulators go straight into the sums, the "
                    "output stage or product 2: what each epilogue costs",
                    None),
    "no_product_1": ("the conv's mma replaced by one add: what product 1 "
                     "costs", [(
        "        mma_bf16(acc[m][dy], wf[m][ky], nb[dy + ky][0], "
        "nb[dy + ky][1]);",
        "        acc[m][dy][ky] += __uint_as_float((nb[dy + ky][0] ^ "
        "wf[m][ky][1]) & 0x3fffffffu);", 1)]),
    "no_product_2": ("dW's mma replaced by one add: what product 2 costs", [(
        "            mma_bf16(dw[m][nt], af[m], tb[nt >> 1][nt & 1],\n"
        "                     tb[(nt >> 1) + 1][nt & 1]);",
        "            dw[m][nt][0] += __uint_as_float(af[m][nt & 3] ^ "
        "tb[nt >> 1][nt & 1]);", 1)]),
    "no_store": ("emit's pooled tile is staged but never leaves shared "
                 "memory: what the global store costs", [(
        "    if (py < s.ph && px < s.pw)\n      *reinterpret_cast<uint4*>(",
        "    if (py < s.ph && px < s.pw && s.b < 0)\n"
        "      *reinterpret_cast<uint4*>(", 1)]),
    "seven_blocks": ("stats and emit compiled for 7 blocks an SM (72 "
                     "registers)", [
        ("__launch_bounds__(kThreads)\nstats_tc_kernel",
         "__launch_bounds__(kThreads, 7)\nstats_tc_kernel", 1),
        ("__launch_bounds__(kThreads)\nemit_tc_kernel",
         "__launch_bounds__(kThreads, 7)\nemit_tc_kernel", 1)]),
    "units_in_flight_halved": ("four units of a warp in flight in stats "
                               "(not eight) and two in emit (not four)", [
        ("#pragma unroll 4\n    for (int u = 0; u < 8; ++u)",
         "#pragma unroll 2\n    for (int u = 0; u < 8; ++u)", 1),
        ("#pragma unroll 8\n    for (int u = 0; u < 8; ++u)",
         "#pragma unroll 4\n    for (int u = 0; u < 8; ++u)", 1)]),
    "emit_eight_units_in_flight": ("all eight units of a warp in flight in "
                                   "emit too", [
        ("#pragma unroll 4\n    for (int u = 0; u < 8; ++u)",
         "#pragma unroll 8\n    for (int u = 0; u < 8; ++u)", 1)]),
    "stage_first_tile_only": ("raw rows -> 4-channel copies only once a "
                              "block: what the staging pass costs", [
        (STAGE, "    if (t == static_cast<int>(blockIdx.x)) " + STAGE.strip(),
         2)]),
    "load_first_tile_only": ("no cp.async after a block's first tiles: what "
                             "the loads cost beyond what compute hides", [
        ("    if (t + gridDim.x < s.tiles) {\n      nx = next_tile",
         "    if (false) {\n      nx = next_tile", 1),
        ("    if (t + gridDim.x < s.tiles) {\n      const Tile nx",
         "    if (false) {\n      const Tile nx", 1)]),
}


def _cut(src: str, start: str, end: str, put: str, head: str = "") -> str:
    """``src`` with the span from ``start`` (and ``head`` just before it) up
    to ``end`` replaced by ``put``."""
    if src.count(start) != 1 or src.count(end) != 1:
        raise RuntimeError(f"no_epilogue: {start!r} or {end!r} moved")
    a, b = src.index(start), src.index(end)
    if not src[:a].endswith(head):
        raise RuntimeError(f"no_epilogue: the lines before {start!r} moved")
    return src[:a - len(head)] + put + src[b:]


def _no_epilogue(src: str) -> str:
    src = _cut(src, EPILOGUE_FROM, EPILOGUE_TO, NO_EPILOGUE,
               head="        float pre[4], y[4];\n")
    src = _cut(src, EMIT_EPILOGUE_FROM, EMIT_EPILOGUE_TO, NO_EMIT_EPILOGUE)
    if src.count(STATS_EPILOGUE) != 1:
        raise RuntimeError("no_epilogue: stats' epilogue moved")
    return src.replace(STATS_EPILOGUE, NO_STATS_EPILOGUE)


def variants() -> dict[str, str]:
    with open(os.path.join(build.CSRC_DIR, "stem_fused.cu")) as f:
        src = f.read()
    out = {}
    for name, (_, patches) in PATCHES.items():
        text = src
        if patches is None:
            text = _no_epilogue(src)
        else:
            for old, new, times in patches:
                if text.count(old) != times:
                    raise RuntimeError(f"{name}: patch does not apply "
                                       f"{times} time(s)")
                text = text.replace(old, new)
        out[name] = text
    return out


def unit_loop_sass(lib_path: str) -> dict:
    """{kernel: {"per_unit", "units_per_iteration", "by_opcode"}}: the SASS
    instructions in the innermost loop that holds all of a tensor-core
    kernel's HMMA (its loop over units), divided by the units an iteration
    handles (24 HMMA a unit in bwd_dw, 12 in the others)."""
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    names = {"stats_tc_kernel": "stats", "emit_tc_kernel": "emit",
             "bwd_tc_kernelILb0E": "bwd_sums", "bwd_tc_kernelILb1E": "bwd_dw"}
    out = {}
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        name = fn.split("\n", 1)[0]
        kernel = next((v for k, v in names.items() if k in name), None)
        if kernel is None:
            continue
        ins = [(int(a, 16), op, rest) for a, op, rest in re.findall(
            r"/\*([0-9a-f]{4,6})\*/\s+(?:@!?U?P\d+\s+)?([A-Z0-9_.]+)([^;]*);",
            fn)]
        hmma = [a for a, op, _ in ins if op.startswith("HMMA")]
        loops = []
        for a, op, rest in ins:
            to = re.search(r"0x([0-9a-f]+)", rest) if op.startswith("BRA") else None
            if to and int(to.group(1), 16) <= hmma[0] and a >= hmma[-1]:
                loops.append((a - int(to.group(1), 16), int(to.group(1), 16), a))
        _, first, last = min(loops)
        body = [op.split(".")[0] for a, op, _ in ins if first <= a <= last]
        units = len(hmma) // (24 if kernel == "bwd_dw" else 12)
        out[kernel] = {
            "per_unit": len(body) / units, "units_per_iteration": units,
            "by_opcode": {k: v / units for k, v in
                          collections.Counter(body).most_common(14)}}
    return out


def entry_point_ms(lib, x, w, vecs, g) -> dict:
    """ms of each C entry point of a build on its own (the kernel and its
    fixed-order reduction): operands and scratch are made once, so the
    wrappers' small launches (weight conversion, stacking the vectors) and
    allocations stay out of the time."""
    b, h, wd, _ = x.shape
    wk, vec = sk._wk(w, x.dtype), sk._vec7(*vecs)
    partials = torch.empty((sk.MAX_BLOCKS, 27 * sk.CO), device=x.device)
    out = torch.empty((27 * sk.CO,), device=x.device)
    pooled = torch.empty_like(g)
    tail = (b, h, wd, 1, 0, torch.cuda.current_stream().cuda_stream)
    scratch = (partials.data_ptr(), sk.MAX_BLOCKS, out.data_ptr())
    args = {"stats": (x.data_ptr(), wk.data_ptr(), *scratch),
            "emit": (x.data_ptr(), wk.data_ptr(), vec.data_ptr(),
                     pooled.data_ptr()),
            "bwd_sums": (x.data_ptr(), wk.data_ptr(), vec.data_ptr(),
                         g.data_ptr(), *scratch),
            "bwd_dw": (x.data_ptr(), wk.data_ptr(), vec.data_ptr(),
                       g.data_ptr(), *scratch)}
    ms = {}
    for k in KERNELS:
        fn = getattr(lib, f"podtpu_stem_{k}")
        fn.restype, fn.argtypes = ctypes.c_int, sk._ARGTYPES[k]
        ms[k] = cs.cuda_ms(lambda: fn(*args[k], *tail), 50)
    return ms


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", metavar="SOURCE", help="another revision "
                    "of stem_fused.cu to build and time beside this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("stem_ablation: no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(OUT, exist_ok=True)
    texts = variants()
    shows = {name: PATCHES[name][0] for name in texts}
    if args.baseline:
        with open(args.baseline) as f:
            texts["baseline"] = f.read()
        shows["baseline"] = f"another revision of the source: {args.baseline}"
    procs = {}
    for name, text in texts.items():
        path = os.path.join(OUT, name + ".cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", path[:-3] + ".so", path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, regs = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        # what bf16 launches: the tensor-core kernels, or in a revision
        # from before them the first-generation kernels' bf16 instances
        regs[name] = {k: v for k, v in cs.ptxas_report(log).items()
                      if "_tc_kernel" in k or "bfloat16" in k}
        libs[name] = ctypes.CDLL(os.path.join(OUT, name + ".so"))

    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    x, w, scale, bias, g = cs.stem_inputs(64, torch.bfloat16, dev, cs.SEED + 4)
    n = x.shape[0] * x.shape[1] * x.shape[2]
    s_r = sk.stem_stats_reference(x, w)
    mean = s_r[0] / n
    var = (s_r[1] / n - mean * mean).clamp_min(0.0)
    rinv = torch.rsqrt(var + 1e-5)
    inv = rinv * scale
    mul, add = inv.to(x.dtype).float(), (bias - mean * inv).to(x.dtype).float()
    u_r = sk.stem_bwd_sums_reference(x, w, mul, add, mean, rinv, g)
    vecs = (mul, add, mean, rinv, inv, u_r[0] / n, u_r[1] / n)
    ones = torch.ones_like(g)

    def use(name):  # point the wrappers at this build's entry points
        for k in KERNELS:
            fn = getattr(libs[name], f"podtpu_stem_{k}")
            fn.restype, fn.argtypes = ctypes.c_int, sk._ARGTYPES[k]
            sk._FNS[k] = fn

    run = {"stats": lambda: sk.stem_stats(x, w),
           "emit": lambda: sk.stem_emit(x, w, mul, add),
           "bwd_sums": lambda: sk.stem_bwd_sums(x, w, *vecs[:4], g),
           "bwd_dw": lambda: sk.stem_bwd_dw(x, w, *vecs, g)}
    ms = {name: {f"{k}_ms": [] for k in KERNELS} for name in libs}
    outs, differ = {}, {}
    for name in list(libs) + list(libs)[::-1]:
        use(name)
        for k in KERNELS:
            ms[name][f"{k}_ms"].append(cs.cuda_ms(run[k], 20))
        outs[name] = [run[k]() for k in KERNELS]
        positive = sk.stem_bwd_sums(x, w, *vecs[:4], ones)[0]
        emitted = (outs[name][1] > 0).sum(dim=(0, 1, 2)).float()
        differ[name] = {
            "channels": int((positive != emitted).sum()),
            "windows": float((positive - emitted).abs().sum()),
            "of_windows_positive": float(emitted.sum())}
    cs.emit({"unit_loop_sass": unit_loop_sass(
        os.path.join(OUT, "unchanged.so"))})
    cs.emit({"entry_point_ms": {name: entry_point_ms(libs[name], x, w, vecs, g)
                                for name in ("unchanged", "baseline")
                                if name in libs}})
    for name in libs:
        same = [bool(torch.equal(a, b))
                for a, b in zip(outs[name], outs["unchanged"])]
        rel = [cs.rel_err(a, b) for a, b in zip(outs[name], outs["unchanged"])]
        cs.emit({"variant": name, "shows": shows[name], **ms[name],
                 "equal_to_unchanged": dict(zip(KERNELS, same)),
                 "rel_to_unchanged": dict(zip(KERNELS, rel)),
                 "forward_backward_differ": differ[name],
                 "ptxas": regs[name]})
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
